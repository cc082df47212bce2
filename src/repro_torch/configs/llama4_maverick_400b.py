"""llama4-maverick-400b-a17b — interleaved dense/MoE decoder, 128 routed
experts top-1 + 1 shared [hf:meta-llama/Llama-4-Scout-17B-16E family card].

Early-fusion multimodality is a STUB (text-token path only; the assignment's
modality carve-out).  Maverick interleaves dense and MoE FFN layers 1:1.
"""
from repro_torch.configs.base import ArchConfig, LayerSpec, MoEConfig, Stage

_DENSE = LayerSpec(kind="attn", ffn="dense")
_MOE = LayerSpec(kind="attn", ffn="moe")

CONFIG = ArchConfig(
    name="llama4-maverick-400b-a17b",
    family="moe",
    citation="hf:meta-llama/Llama-4-Scout-17B-16E (Llama 4 model card)",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=202048,
    stages=(Stage((_DENSE, _MOE), 24),),
    rope_theta=500_000.0,
    moe=MoEConfig(n_experts=128, top_k=1, d_expert=8192, n_shared=1,
                  capacity_factor=1.25),
    norm="rmsnorm",
    act="silu",
    tie_embeddings=False,
    moment_dtype="bfloat16",   # 400B params: fp32 moments would not fit v5e
)

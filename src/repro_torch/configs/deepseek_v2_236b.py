"""deepseek-v2-236b — MLA attention + fine-grained MoE [arXiv:2405.04434].

MLA: kv_lora_rank=512, decoupled RoPE key dim 64, q_lora_rank=1536.
MoE: 160 routed experts top-6 + 2 shared, expert width 1536 (the assignment's
``d_ff=1536`` denotes the MoE intermediate size; the single dense prologue
layer — DeepSeek-V2's ``first_k_dense_replace=1`` — reuses it).
"""
from repro_torch.configs.base import ArchConfig, LayerSpec, MLAConfig, MoEConfig, Stage

CONFIG = ArchConfig(
    name="deepseek-v2-236b",
    family="moe",
    citation="arXiv:2405.04434 (DeepSeek-V2)",
    n_layers=60,
    d_model=5120,
    n_heads=128,
    n_kv_heads=128,
    head_dim=128,
    d_ff=1536,
    vocab_size=102400,
    stages=(
        Stage((LayerSpec(kind="attn", ffn="dense"),), 1),       # dense prologue
        Stage((LayerSpec(kind="attn", ffn="moe"),), 59),
    ),
    rope_theta=10000.0,
    mla=MLAConfig(kv_lora_rank=512, q_lora_rank=1536,
                  qk_nope_dim=128, qk_rope_dim=64, v_head_dim=128),
    moe=MoEConfig(n_experts=160, top_k=6, d_expert=1536, n_shared=2,
                  capacity_factor=1.25),
    norm="rmsnorm",
    act="silu",
    tie_embeddings=False,
    moment_dtype="bfloat16",
)

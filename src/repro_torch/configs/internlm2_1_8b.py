"""internlm2-1.8b — dense GQA decoder [arXiv:2403.17297]."""
from repro_torch.configs.base import ArchConfig, LayerSpec, Stage

CONFIG = ArchConfig(
    name="internlm2-1.8b",
    family="dense",
    citation="arXiv:2403.17297 (InternLM2 Technical Report)",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=92544,
    stages=(Stage((LayerSpec(kind="attn", ffn="dense"),), 24),),
    rope_theta=1_000_000.0,
    norm="rmsnorm",
    act="silu",
    tie_embeddings=False,
)

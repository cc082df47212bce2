"""qwen2-7b — dense GQA decoder with QKV bias [arXiv:2407.10671]."""
from repro_torch.configs.base import ArchConfig, LayerSpec, Stage

CONFIG = ArchConfig(
    name="qwen2-7b",
    family="dense",
    citation="arXiv:2407.10671 (Qwen2 Technical Report)",
    n_layers=28,
    d_model=3584,
    n_heads=28,
    n_kv_heads=4,
    head_dim=128,
    d_ff=18944,
    vocab_size=152064,
    stages=(Stage((LayerSpec(kind="attn", ffn="dense"),), 28),),
    rope_theta=1_000_000.0,
    qkv_bias=True,
    norm="rmsnorm",
    act="silu",
    tie_embeddings=False,
)

"""gemma2-2b — dense, alternating local/global attention, logit softcaps
[arXiv:2408.00118]."""
from repro_torch.configs.base import ArchConfig, LayerSpec, Stage

_LOCAL = LayerSpec(kind="attn", window=4096, ffn="dense")
_GLOBAL = LayerSpec(kind="attn", window=-1, ffn="dense")

CONFIG = ArchConfig(
    name="gemma2-2b",
    family="dense",
    citation="arXiv:2408.00118 (Gemma 2)",
    n_layers=26,
    d_model=2304,
    n_heads=8,
    n_kv_heads=4,
    head_dim=256,
    d_ff=9216,
    vocab_size=256000,
    stages=(Stage((_LOCAL, _GLOBAL), 13),),
    rope_theta=10000.0,
    attn_softcap=50.0,
    final_softcap=30.0,
    norm="rmsnorm",
    act="gelu",
    tie_embeddings=True,
)

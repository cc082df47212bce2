"""jamba-v0.1-52b — hybrid Mamba + attention (1:7 attn:mamba), MoE every 2nd
layer, 16 experts top-2 [arXiv:2403.19887].

Period of 8 layers with attention at index 4 (Jamba's published block
layout); odd layer indices carry MoE FFNs, even indices dense FFNs.  Jamba
uses no explicit positional encoding (``use_rope=False``).
"""
from repro_torch.configs.base import ArchConfig, LayerSpec, MambaConfig, MoEConfig, Stage


def _l(kind, ffn):
    return LayerSpec(kind=kind, ffn=ffn)

_PERIOD = (
    _l("mamba", "dense"), _l("mamba", "moe"),
    _l("mamba", "dense"), _l("mamba", "moe"),
    _l("attn", "dense"), _l("mamba", "moe"),
    _l("mamba", "dense"), _l("mamba", "moe"),
)

CONFIG = ArchConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    citation="arXiv:2403.19887 (Jamba)",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=65536,
    stages=(Stage(_PERIOD, 4),),
    use_rope=False,
    moe=MoEConfig(n_experts=16, top_k=2, d_expert=14336, capacity_factor=1.25),
    mamba=MambaConfig(d_state=16, d_conv=4, expand=2, chunk=256),
    norm="rmsnorm",
    act="silu",
    tie_embeddings=False,
    moment_dtype="bfloat16",
)

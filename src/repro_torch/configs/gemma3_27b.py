"""gemma3-27b — dense, 5 local : 1 global attention, 128k context
[hf:google/gemma-3-1b-pt family card, scaled per assignment]."""
from repro_torch.configs.base import ArchConfig, LayerSpec, Stage

_L = LayerSpec(kind="attn", window=1024, ffn="dense")
_G = LayerSpec(kind="attn", window=-1, ffn="dense")

CONFIG = ArchConfig(
    name="gemma3-27b",
    family="dense",
    citation="hf:google/gemma-3-1b-pt (Gemma 3 model card)",
    n_layers=62,
    d_model=5376,
    n_heads=32,
    n_kv_heads=16,
    head_dim=128,
    d_ff=21504,
    vocab_size=262144,
    # every 6th layer global; 62 = 6*10 + 2 trailing locals
    stages=(Stage((_L, _L, _L, _L, _L, _G), 10), Stage((_L, _L), 1)),
    rope_theta=1_000_000.0,
    norm="rmsnorm",
    act="gelu",
    tie_embeddings=True,
)

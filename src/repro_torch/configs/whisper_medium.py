"""whisper-medium — encoder-decoder speech backbone [arXiv:2212.04356].

The mel-spectrogram + conv frontend is a STUB per the assignment carve-out:
``input_specs()`` supplies precomputed frame embeddings of shape
``(batch, 1500, d_model)``.  We implement the 24-layer encoder and 24-layer
decoder (cross-attention) transformer backbone.  Positional encoding
adaptation: RoPE instead of Whisper's learned/sinusoidal absolute positions
(long-context decode shapes make absolute tables impractical; noted in
DESIGN.md).
"""
from repro_torch.configs.base import ArchConfig, EncoderConfig, LayerSpec, Stage

CONFIG = ArchConfig(
    name="whisper-medium",
    family="audio",
    citation="arXiv:2212.04356 (Whisper)",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    head_dim=64,
    d_ff=4096,
    vocab_size=51865,
    stages=(Stage((LayerSpec(kind="attn", ffn="dense", cross_attn=True),), 24),),
    encoder=EncoderConfig(n_layers=24, n_ctx=1500, causal=False),
    norm="layernorm",
    act="gelu",
    tie_embeddings=True,
)

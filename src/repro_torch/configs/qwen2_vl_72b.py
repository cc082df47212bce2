"""qwen2-vl-72b — VLM language backbone with M-RoPE [arXiv:2409.12191].

The SigLIP-style vision encoder + projector is a STUB per the assignment
carve-out: ``input_specs()`` supplies token embeddings; M-RoPE consumes
(temporal, height, width) position ids, which collapse to the text position
for pure-text streams.
"""
from repro_torch.configs.base import ArchConfig, LayerSpec, Stage

CONFIG = ArchConfig(
    name="qwen2-vl-72b",
    family="vlm",
    citation="arXiv:2409.12191 (Qwen2-VL)",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=29568,
    vocab_size=152064,
    stages=(Stage((LayerSpec(kind="attn", ffn="dense"),), 80),),
    rope_theta=1_000_000.0,
    mrope_sections=(16, 24, 24),
    qkv_bias=True,
    norm="rmsnorm",
    act="silu",
    tie_embeddings=False,
)

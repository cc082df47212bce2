"""Model configurations (port of ``repro.configs``).

``get_config(arch_id)`` returns the configs whose every feature the port's
transformer runs: the dense GQA decoders ``internlm2-1.8b``, ``qwen2-7b``
(QKV bias), ``gemma2-2b`` (soft-caps, sliding windows, tied and scaled
embeddings, GeLU) and ``gemma3-27b`` (five local layers of window 1,024 to
one global, the sliding-window and chunked score paths past 2,048 tokens),
``qwen2-vl-72b`` (M-RoPE over (temporal, height, width) positions; its
vision tower is a stub in the reference), the recurrent ``xlstm-125m``
(mLSTM and sLSTM blocks, layer norms with biases, no feed-forward
sublayer), the hybrid ``jamba-v0.1-52b`` (Mamba and attention blocks,
dense and mixture-of-experts feed-forward layers),
``llama4-maverick-400b-a17b`` (dense and MoE layers interleaved, 128
routed experts top-1 and a shared expert) and ``deepseek-v2-236b`` (MLA
attention, a dense prologue layer, then 160 routed experts top-6 and 2
shared) and the encoder-decoder ``whisper-medium`` (24 non-causal
encoder layers over 1,500 stub frame embeddings, and 24 decoder layers with
cross-attention to them).  The configs are the reference's as they are,
with what they leave out of the published models.
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import (INPUT_SHAPES, ArchConfig,
                                      EncoderConfig, InputShape, LayerSpec,
                                      MLAConfig, MambaConfig, MoEConfig,
                                      Stage, XLSTMConfig, reduced)

_ARCH_MODULES = {
    "internlm2-1.8b": "internlm2_1_8b",
    "gemma2-2b": "gemma2_2b",
    "qwen2-7b": "qwen2_7b",
    "jamba-v0.1-52b": "jamba_v01_52b",
    "xlstm-125m": "xlstm_125m",
    "llama4-maverick-400b-a17b": "llama4_maverick_400b",
    "gemma3-27b": "gemma3_27b",
    "qwen2-vl-72b": "qwen2_vl_72b",
    "deepseek-v2-236b": "deepseek_v2_236b",
    "whisper-medium": "whisper_medium",
}

ARCH_IDS = tuple(_ARCH_MODULES)


def get_config(name: str) -> ArchConfig:
    if name not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {name!r}; known: "
                       f"{sorted(_ARCH_MODULES)}")
    mod = importlib.import_module(
        f"repro_torch.configs.{_ARCH_MODULES[name]}")
    return mod.CONFIG


__all__ = [
    "ArchConfig", "EncoderConfig", "LayerSpec", "MLAConfig", "MambaConfig",
    "MoEConfig", "Stage", "XLSTMConfig", "ARCH_IDS", "INPUT_SHAPES",
    "InputShape", "get_config", "reduced",
]

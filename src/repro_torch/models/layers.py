"""Shared neural-net building blocks (port of ``repro.models.layers``).

Conventions, as in the reference:

- ``init_*`` functions return nested dicts of tensors, drawn on a
  ``torch.Generator`` and placed on its device; the leaf names are the
  reference's, so JAX weights load through ``weights.params_from_numpy``.
- ``apply`` functions take ``params`` first and accept any leading
  batch/sequence prefix.
- Matrix products run in ``compute_dtype`` (bfloat16 at full width);
  softmax, norms and losses run in float32.

Means whose value the reference computes under ``jax.jit`` (the RMS norm's
variance, the signature's buckets) multiply a float32 sum by the
float32 reciprocal of the count (:func:`repro_torch.core.aggregate.f32_mean`).
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.aggregate import f32_mean
from repro_torch.sharding import dtensor

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def torch_dtype(name: str) -> torch.dtype:
    """The torch dtype of a config's dtype name."""
    return _DTYPES[name]


# ---------------------------------------------------------------------------
# init helpers
# ---------------------------------------------------------------------------


def _normal(generator: torch.Generator, shape) -> torch.Tensor:
    return torch.randn(shape, generator=generator, device=generator.device,
                       dtype=torch.float32)


def dense_init(generator, d_in: int, d_out: int, dtype,
               scale: Optional[float] = None) -> torch.Tensor:
    scale = scale if scale is not None else 1.0 / math.sqrt(d_in)
    return (_normal(generator, (d_in, d_out)) * scale).to(dtype)


def embed_init(generator, vocab: int, d: int, dtype) -> torch.Tensor:
    return (_normal(generator, (vocab, d)) * 0.02).to(dtype)


# ---------------------------------------------------------------------------
# normalisation
# ---------------------------------------------------------------------------


def init_norm(kind: str, d: int, dtype, device=None) -> dict:
    p = {"scale": torch.ones((d,), dtype=dtype, device=device)}
    if kind != "rmsnorm":
        p["bias"] = torch.zeros((d,), dtype=dtype, device=device)
    return p


def apply_norm(params, x: torch.Tensor, kind: str,
               eps: float = 1e-6) -> torch.Tensor:
    x = dtensor.whole_features(x)
    xf = x.float()
    if kind == "rmsnorm":
        var = f32_mean(xf.square(), dim=-1, keepdim=True)
        y = xf * torch.rsqrt(var + eps)
        return (y * params["scale"].float()).to(x.dtype)
    mean = f32_mean(xf, dim=-1, keepdim=True)
    var = f32_mean((xf - mean).square(), dim=-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    y = y * params["scale"].float() + params["bias"].float()
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# activations
# ---------------------------------------------------------------------------


def activation(name: str):
    if name == "silu":
        return F.silu
    if name == "gelu":
        return lambda x: F.gelu(x, approximate="tanh")
    raise ValueError(name)


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    """Gemma-2 style logit soft-capping: cap * tanh(x / cap)."""
    if cap <= 0:
        return x
    return cap * torch.tanh(x / cap)


# ---------------------------------------------------------------------------
# gated MLP (SwiGLU / GeGLU)
# ---------------------------------------------------------------------------


def init_mlp(generator, d: int, d_ff: int, dtype) -> dict:
    return {
        "wg": dense_init(generator, d, d_ff, dtype),
        "wi": dense_init(generator, d, d_ff, dtype),
        "wdown": dense_init(generator, d_ff, d, dtype),
    }


def apply_mlp(params, x: torch.Tensor, act: str, compute_dtype):
    xc = x.to(compute_dtype)
    g = xc @ params["wg"].to(compute_dtype)
    h = xc @ params["wi"].to(compute_dtype)
    a = activation(act)(g) * h
    out = a @ params["wdown"].to(compute_dtype)
    return out.to(x.dtype), a


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    half = head_dim // 2
    exponent = torch.arange(half, dtype=torch.float32, device=device) / half
    return 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32,
                                        device=device), exponent)


def _rotate_half(x: torch.Tensor) -> torch.Tensor:
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([-x2, x1], dim=-1)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
               mrope_sections: Optional[Tuple[int, int, int]] = None
               ) -> torch.Tensor:
    """Rotary embedding.  x: (..., S, n_heads, head_dim); positions: (B, S)
    integers, or (3, B, S) for M-RoPE (temporal, height and width ids;
    without sections the first row is used).

    M-RoPE (Qwen2-VL): section i of the half-dim frequencies (16, 24 and
    24 of qwen2-vl-72b's 64) turns with position row i; (B, S) positions
    (a text-only stream) turn all three alike, which is plain RoPE."""
    inv = rope_freqs(x.shape[-1], theta, x.device)          # (half,)
    if mrope_sections is None:
        pos = positions if positions.dim() == 2 else positions[0]
        ang = pos[..., None].float() * inv                  # (B, S, half)
    else:
        if positions.dim() == 2:                            # text only
            positions = positions[None].expand(3, *positions.shape)
        parts, start = [], 0
        for sec, p in zip(mrope_sections, positions):
            parts.append(p[..., None].float() * inv[start:start + sec])
            start += sec
        ang = torch.cat(parts, dim=-1)                      # (B, S, half)
    ang = torch.cat([ang, ang], dim=-1)                     # (B, S, hd)
    cos = torch.cos(ang)[..., None, :]                      # (B, S, 1, hd)
    sin = torch.sin(ang)[..., None, :]
    xf = x.float()
    return (xf * cos + _rotate_half(xf) * sin).to(x.dtype)


# ---------------------------------------------------------------------------
# embedding / unembedding
# ---------------------------------------------------------------------------


def init_embedding(generator, vocab: int, d: int, dtype, tied: bool) -> dict:
    p = {"embedding": embed_init(generator, vocab, d, dtype)}
    if not tied:
        p["unembed"] = dense_init(generator, d, vocab, dtype, scale=0.02)
    return p


# ---------------------------------------------------------------------------
# step loops
# ---------------------------------------------------------------------------

# the fold a dry run's count sets while it runs
# (``launch.cost_analysis.folded``), else None
LOOP_FOLD = None


def step_loop(run, inputs, seq_in, seq_out):
    """``run(*inputs)``, a loop over dim 1 of the inputs marked in
    ``seq_in`` whose outputs marked in ``seq_out`` stack its steps on dim
    1; while a dry run's count runs, folded by it."""
    if LOOP_FOLD is None:
        return run(*inputs)
    return LOOP_FOLD(run, inputs, seq_in, seq_out)


def embed_tokens(params, tokens: torch.Tensor, compute_dtype) -> torch.Tensor:
    # gather first, then cast: the same values as casting the whole table
    return F.embedding(tokens.long(), params["embedding"]).to(compute_dtype)


def unembed(params, x: torch.Tensor, compute_dtype,
            final_cap: float = 0.0) -> torch.Tensor:
    xc = x.to(compute_dtype)
    if "unembed" in params:
        logits = xc @ params["unembed"].to(compute_dtype)
    else:
        logits = xc @ params["embedding"].to(compute_dtype).T
    return softcap(logits.float(), final_cap)


# ---------------------------------------------------------------------------
# feature signatures (paper Eq. 3-4, transformer adaptation)
# ---------------------------------------------------------------------------


def activation_signature(h: torch.Tensor, n_sig: int = 64,
                         tau: float = 0.05) -> torch.Tensor:
    """Threshold-zero fraction of hidden activations, bucketed to n_sig dims.

    The paper's Eq. 3 counts exact zeros of post-ReLU conv maps; GeLU/SiLU
    emit no exact zeros, so the transformer adaptation uses |a| < tau,
    compared in float32.  h: (..., d) -> (n_sig,) f32, averaged over all
    leading axes.  The plain form of ``kernels.ops.signature``.
    """
    d = h.shape[-1]
    pad = (-d) % n_sig
    flags = (h.float().abs() < float(np.float32(tau))).float()
    flags = flags.reshape(-1, d)
    if pad:
        flags = F.pad(flags, (0, pad))
    flags = flags.reshape(flags.shape[0], n_sig, -1)
    return f32_mean(flags, dim=(0, 2))

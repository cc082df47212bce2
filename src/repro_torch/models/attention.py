"""GQA attention blocks (port of ``repro.models.attention``, GQA path).

Two score paths:

- ``_dense_attn``: materialised scores, for sequences up to 2048 tokens,
  under autograd (local training) and wherever the kernel is not asked for;
- the flash attention kernel (``kernels.ops.flash_attention``), which
  ``scaled_attention`` takes with ``runtime.use_kernels`` for causal
  self-attention: the no-grad eval and signature forwards.

The reference's score einsums keep float32 outputs from bfloat16 inputs
(``preferred_element_type``).  A bfloat16 ``torch.matmul`` rounds its output
to bfloat16, so ``_sdpa`` multiplies the bfloat16 values as float32: the
products of two bfloat16 values are exact in float32, so this is the
reference's arithmetic up to the order of the sums.

Decode (``attn_decode``, one new token against the KV cache) takes the
dense scores over the cache, as the reference computes it outside any
kernel.  The new key and value are written into the cache in place: the
serving loop owns its caches (``launch.serve.greedy_decode``), and the
reference's functional update gives the same values.

Not ported (they raise ``NotImplementedError``): the chunked and banded
score paths beyond 2048 tokens, MLA and cross-attention.
"""
from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ArchConfig, LayerSpec
from repro_torch.kernels import ops
from repro_torch.models.layers import (apply_rope, dense_init, softcap,
                                      torch_dtype)

_NEG = -2.0e9
_DENSE_MAX = 2048          # above this the reference takes chunked/banded


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def init_attn(generator, cfg: ArchConfig, spec: LayerSpec, dtype) -> dict:
    if cfg.mla is not None:
        raise NotImplementedError("MLA attention is not ported")
    if spec.cross_attn:
        raise NotImplementedError("cross-attention is not ported")
    d = cfg.d_model
    p = {
        "wq": dense_init(generator, d, cfg.q_dim, dtype),
        "wk": dense_init(generator, d, cfg.kv_dim, dtype),
        "wv": dense_init(generator, d, cfg.kv_dim, dtype),
        "wo": dense_init(generator, cfg.q_dim, d, dtype),
    }
    if cfg.qkv_bias:
        device = generator.device
        p["bq"] = torch.zeros((cfg.q_dim,), dtype=dtype, device=device)
        p["bk"] = torch.zeros((cfg.kv_dim,), dtype=dtype, device=device)
        p["bv"] = torch.zeros((cfg.kv_dim,), dtype=dtype, device=device)
    return p


# The KV-cache layout spec: number of trailing dims AFTER the sequence axis
# for each cache entry ("k"/"v": (n_kv_heads, head_dim); MLA "ckv"/"krope":
# (rank,)).  Any number of leading axes may be stacked in front (the layer
# axis of a stage, or none at all), so code that grows a cache along its
# sequence axis derives the axis from this spec, counting from the END.
KV_CACHE_TRAILING_DIMS = {"k": 2, "v": 2, "ckv": 1, "krope": 1}


def cache_seq_axis(key: str, ndim: int) -> int:
    """Sequence axis of a KV-cache entry, for any number of leading axes."""
    return ndim - 1 - KV_CACHE_TRAILING_DIMS[key]


def init_kv_cache(cfg: ArchConfig, spec: LayerSpec, batch: int,
                  max_seq: int, dtype=None, leading: tuple = (),
                  device=None) -> dict:
    """Zero cache for one attention layer (stacked over ``leading``), in
    ``cfg.cache_dtype`` unless ``dtype`` is given."""
    if cfg.mla is not None:
        raise NotImplementedError("MLA attention is not ported")
    dtype = torch_dtype(cfg.cache_dtype) if dtype is None else dtype
    shape = tuple(leading) + (batch, max_seq, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


# ---------------------------------------------------------------------------
# masks and score paths
# ---------------------------------------------------------------------------


def _mask_bias(q_pos: torch.Tensor, k_pos: torch.Tensor, causal: bool,
               window: int) -> torch.Tensor:
    """(Sq, Sk) additive float32 bias from 1-D position vectors."""
    diff = q_pos[:, None] - k_pos[None, :]
    ok = torch.ones(diff.shape, dtype=torch.bool, device=diff.device)
    if causal:
        ok &= diff >= 0
    if window > 0:
        ok &= diff < window
    zero = torch.zeros((), dtype=torch.float32, device=diff.device)
    return torch.where(ok, zero, _NEG)


def _sdpa(q, k, v, bias, cap: float) -> torch.Tensor:
    """q (B,Sq,H,hd) k,v (B,Sk,K,hd) bias (Sq,Sk) -> (B,Sq,H,hd)."""
    B, Sq, H, hd = q.shape
    K = k.shape[2]
    G = H // K
    qs = (q.float() * (1.0 / math.sqrt(hd))).to(k.dtype)
    qs = qs.reshape(B, Sq, K, G, hd)
    scores = torch.einsum("bqkgd,bskd->bkgqs", qs.float(), k.float())
    scores = softcap(scores, cap)
    scores = scores + bias
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", w.to(v.dtype).float(), v.float())
    return out.reshape(B, Sq, H, hd).to(q.dtype)


def _dense_attn(q, k, v, q_pos, k_pos, causal: bool, window: int,
                cap: float) -> torch.Tensor:
    return _sdpa(q, k, v, _mask_bias(q_pos, k_pos, causal, window), cap)


def scaled_attention(q, k, v, q_pos, k_pos, *, causal: bool, window: int,
                     cap: float, runtime=None) -> torch.Tensor:
    """Dispatch over score paths (and the kernel when asked for).

    q (B,Sq,H,hd); k, v (B,Sk,K,hd); q_pos (Sq,), k_pos (Sk,): 1-D global
    sequence positions.
    """
    Sq, Sk = q.shape[1], k.shape[1]
    if runtime is not None and runtime.use_kernels and causal and Sq == Sk:
        return ops.flash_attention(q, k, v, causal=True, window=window,
                                   softcap=cap)
    if max(Sq, Sk) > _DENSE_MAX and Sq == Sk:
        raise NotImplementedError(
            f"attention over {Sq} tokens needs the reference's chunked or "
            f"banded path, which is not ported (dense up to {_DENSE_MAX})")
    return _dense_attn(q, k, v, q_pos, k_pos, causal, window, cap)


# ---------------------------------------------------------------------------
# GQA attention layer (full sequence and decode)
# ---------------------------------------------------------------------------


def _project_qkv(params, x, cfg: ArchConfig, compute_dtype):
    xc = x.to(compute_dtype)
    q = xc @ params["wq"].to(compute_dtype)
    k = xc @ params["wk"].to(compute_dtype)
    v = xc @ params["wv"].to(compute_dtype)
    if "bq" in params:
        q = q + params["bq"].to(compute_dtype)
        k = k + params["bk"].to(compute_dtype)
        v = v + params["bv"].to(compute_dtype)
    B, S = x.shape[:2]
    q = q.reshape(B, S, cfg.n_heads, cfg.head_dim)
    k = k.reshape(B, S, cfg.n_kv_heads, cfg.head_dim)
    v = v.reshape(B, S, cfg.n_kv_heads, cfg.head_dim)
    return q, k, v


def attn_forward(params, x, *, cfg: ArchConfig, spec: LayerSpec, positions,
                 window: int, runtime=None):
    """Full-sequence self-attention (train / eval / prefill).  Returns
    (out, {"k", "v"}): the roped keys and the values in
    ``cfg.cache_dtype``, the layer's KV cache for decode."""
    if cfg.mla is not None:
        raise NotImplementedError("MLA attention is not ported")
    compute = torch_dtype(cfg.compute_dtype)
    q, k, v = _project_qkv(params, x, cfg, compute)
    if cfg.use_rope:
        q = apply_rope(q, positions, cfg.rope_theta, cfg.mrope_sections)
        k = apply_rope(k, positions, cfg.rope_theta, cfg.mrope_sections)
    pos1d = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
    out = scaled_attention(q, k, v, pos1d, pos1d, causal=True, window=window,
                           cap=cfg.attn_softcap, runtime=runtime)
    out = out.reshape(x.shape[0], x.shape[1], cfg.q_dim)
    out = (out.to(compute) @ params["wo"].to(compute)).to(x.dtype)
    cache_dt = torch_dtype(cfg.cache_dtype)
    return out, {"k": k.to(cache_dt), "v": v.to(cache_dt)}


def attn_decode(params, x, cache, pos: int, *, cfg: ArchConfig,
                spec: LayerSpec, window: int, runtime=None):
    """One-token decode against a cache.  x (B,1,d); ``pos`` a Python int,
    the new token's position.  The new key and value are written into
    ``cache`` at ``pos`` in place; the scores mask the slots not yet
    written and those outside the window.  Returns (out (B,1,d), cache)."""
    if cfg.mla is not None:
        raise NotImplementedError("MLA attention is not ported")
    compute = torch_dtype(cfg.compute_dtype)
    B = x.shape[0]
    S = cache["k"].shape[1]
    q, k_new, v_new = _project_qkv(params, x, cfg, compute)
    positions = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
    if cfg.use_rope:
        q = apply_rope(q, positions, cfg.rope_theta, cfg.mrope_sections)
        k_new = apply_rope(k_new, positions, cfg.rope_theta,
                           cfg.mrope_sections)
    k, v = cache["k"], cache["v"]
    k[:, pos] = k_new[:, 0].to(k.dtype)
    v[:, pos] = v_new[:, 0].to(v.dtype)
    k_pos = torch.arange(S, device=x.device)
    valid = k_pos <= pos
    if window > 0:
        valid &= k_pos > pos - window
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    bias = torch.where(valid, zero, _NEG)
    out = _sdpa(q, k, v, bias[None], cfg.attn_softcap)
    out = out.reshape(B, 1, cfg.q_dim)
    out = (out.to(compute) @ params["wo"].to(compute)).to(x.dtype)
    return out, {"k": k, "v": v}

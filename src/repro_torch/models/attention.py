"""Attention blocks (port of ``repro.models.attention``): GQA (windowed,
soft-capped, biased, M-RoPE) and MLA.

Score paths, dispatched in the reference's order (``scaled_attention``):

- the flash attention kernel (``kernels.ops.flash_attention``), which
  ``scaled_attention`` takes with ``runtime.use_kernels`` for causal
  self-attention at any length: the no-grad eval, signature and prefill
  forwards;
- ``_banded_attn``: sliding-window causal layers past 2,048 tokens, over
  query blocks of 512 against a static KV band of ``window + 512``;
- ``_dense_attn``: materialised scores, up to 2,048 tokens or when the
  query and key lengths differ;
- ``_chunked_attn``: an online-softmax pass over KV chunks of 1,024, for
  the rest (full causal attention past 2,048 tokens).

The two long paths run under autograd (local training) and in plain
forwards.  Under autograd each query block or KV chunk runs under
``torch.utils.checkpoint`` (non-reentrant), so only the block's inputs are
kept for the backward and the paths hold O(S * block) memory, as they are
meant to; the values are the same.  Inside ``torch.func.vmap`` an input's
``requires_grad`` reads False and every block is kept (a checkpoint's
backward would recompute it outside the vmap), as in ``models.mamba``.

The reference's score einsums keep float32 outputs from bfloat16 inputs
(``preferred_element_type``).  A bfloat16 ``torch.matmul`` rounds its output
to bfloat16, so the score paths multiply the bfloat16 values as float32:
the products of two bfloat16 values are exact in float32, so this is the
reference's arithmetic up to the order of the sums.

Decode (``attn_decode``, one new token against the KV cache) takes the
dense scores over the cache, as the reference computes it outside any
kernel; MLA decodes in the absorbed form (``_mla_decode``: scores and
values in the latent space over the ``ckv`` and ``krope`` caches).  The new
entries are written into the cache in place: the serving loop owns its
caches (``launch.serve.greedy_decode``), and the reference's functional
update gives the same values.

Cross-attention (whisper's decoder): ``cross_kv`` projects the encoder's
output to keys and values and rounds them to ``cfg.cache_dtype`` (the
decoder's ``xk`` and ``xv`` caches, and the values the training forward
attends to as well), and ``cross_attn_forward`` attends the decoder's
queries to them through the dense scores with a zero bias, outside any
kernel, as the reference does.
"""
from __future__ import annotations

import math

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig, LayerSpec
from repro_torch.kernels import ops
from repro_torch.models.layers import (apply_norm, apply_rope, at_use,
                                       dense_init, init_norm, softcap,
                                       torch_dtype)
from repro_torch.sharding import dtensor
from repro_torch.sharding.dtensor import merge_heads, split_heads

_NEG = -2.0e9
_DENSE_MAX = 2048          # above this, the chunked and banded paths
_KV_CHUNK = 1024
_Q_BLOCK = 512
_FAR = 10 ** 9             # the position of a padded key or query


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def init_attn(generator, cfg: ArchConfig, spec: LayerSpec, dtype) -> dict:
    d = cfg.d_model
    if cfg.mla is not None:
        m = cfg.mla
        q_head = m.qk_nope_dim + m.qk_rope_dim
        device = generator.device
        p = {}
        if m.q_lora_rank:
            p["wq_a"] = dense_init(generator, d, m.q_lora_rank, dtype)
            p["q_norm"] = init_norm(cfg.norm, m.q_lora_rank, dtype, device)
            p["wq_b"] = dense_init(generator, m.q_lora_rank,
                                   cfg.n_heads * q_head, dtype)
        else:
            p["wq"] = dense_init(generator, d, cfg.n_heads * q_head, dtype)
        p["wkv_a"] = dense_init(generator, d, m.kv_lora_rank + m.qk_rope_dim,
                                dtype)
        p["kv_norm"] = init_norm(cfg.norm, m.kv_lora_rank, dtype, device)
        p["wkv_b"] = dense_init(generator, m.kv_lora_rank,
                                cfg.n_heads * (m.qk_nope_dim + m.v_head_dim),
                                dtype)
        p["wo"] = dense_init(generator, cfg.n_heads * m.v_head_dim, d, dtype)
        return p
    p = {
        "wq": dense_init(generator, d, cfg.q_dim, dtype),
        "wk": dense_init(generator, d, cfg.kv_dim, dtype),
        "wv": dense_init(generator, d, cfg.kv_dim, dtype),
        "wo": dense_init(generator, cfg.q_dim, d, dtype),
    }
    if cfg.qkv_bias:
        device = generator.device
        bias = at_use(dtype)
        p["bq"] = torch.zeros((cfg.q_dim,), dtype=bias, device=device)
        p["bk"] = torch.zeros((cfg.kv_dim,), dtype=bias, device=device)
        p["bv"] = torch.zeros((cfg.kv_dim,), dtype=bias, device=device)
    if spec.cross_attn:
        p["xwq"] = dense_init(generator, d, cfg.q_dim, dtype)
        p["xwk"] = dense_init(generator, d, cfg.kv_dim, dtype)
        p["xwv"] = dense_init(generator, d, cfg.kv_dim, dtype)
        p["xwo"] = dense_init(generator, cfg.q_dim, d, dtype)
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
    dtype = torch_dtype(cfg.cache_dtype) if dtype is None else dtype
    lead = tuple(leading) + (batch, max_seq)
    if cfg.mla is not None:
        m = cfg.mla
        return {"ckv": torch.zeros(lead + (m.kv_lora_rank,), dtype=dtype,
                                   device=device),
                "krope": torch.zeros(lead + (m.qk_rope_dim,), dtype=dtype,
                                     device=device)}
    shape = lead + (cfg.n_kv_heads, cfg.head_dim)
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


def _tracked(*tensors) -> bool:
    """Whether a long path's blocks run under ``torch.utils.checkpoint``:
    under autograd, outside ``torch.func.vmap``."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def _pad_seq(x: torch.Tensor, n: int) -> torch.Tensor:
    """``n`` zero rows after the sequence axis 1 of (B, S, ...)."""
    return torch.cat([x, x.new_zeros((x.shape[0], n) + x.shape[2:])], dim=1)


def _pad_pos(pos: torch.Tensor, n: int, value: int) -> torch.Tensor:
    return torch.cat([pos, pos.new_full((n,), value)])


def _chunk_step(qf, kb, vb, q_pos, pb, m, l, acc, causal: bool, cap: float):
    """One KV chunk of the online softmax: (m, l, acc) carried on."""
    s = torch.einsum("bqkgd,bckd->bkgqc", qf.float(), kb.float())
    s = softcap(s, cap) + _mask_bias(q_pos, pb, causal, -1)     # (Sq,C)
    m_new = torch.maximum(m, s.amax(dim=-1))
    p = torch.exp(s - m_new[..., None])
    corr = torch.exp(m - m_new)
    l_new = l * corr + p.sum(dim=-1)
    acc_new = acc * corr[..., None] + torch.einsum(
        "bkgqc,bckd->bkgqd", p.to(vb.dtype).float(), vb.float())
    return m_new, l_new, acc_new


def _chunked_attn(q, k, v, q_pos, k_pos, causal: bool, cap: float,
                  chunk: int = _KV_CHUNK) -> torch.Tensor:
    """Online-softmax pass over KV chunks; O(S * chunk) memory.  Padded
    keys sit at position 1e9, where the causal mask removes them."""
    B, Sq, H, hd = q.shape
    Sk, K = k.shape[1], k.shape[2]
    G = H // K
    n_chunks = -(-Sk // chunk)
    pad = n_chunks * chunk - Sk
    if pad:
        k, v = _pad_seq(k, pad), _pad_seq(v, pad)
        k_pos = _pad_pos(k_pos, pad, _FAR)
    qf = ((q.float() * (1.0 / math.sqrt(hd))).to(k.dtype)
          .reshape(B, Sq, K, G, hd))
    m = torch.full((B, K, G, Sq), -math.inf, device=q.device)
    l = torch.zeros((B, K, G, Sq), device=q.device)
    acc = torch.zeros((B, K, G, Sq, hd), device=q.device)
    track = _tracked(q, k, v)
    for c in range(0, n_chunks * chunk, chunk):
        args = (qf, k[:, c:c + chunk], v[:, c:c + chunk], q_pos,
                k_pos[c:c + chunk], m, l, acc, causal, cap)
        if track:
            m, l, acc = checkpoint(_chunk_step, *args, use_reentrant=False)
        else:
            m, l, acc = _chunk_step(*args)
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, hd).to(q.dtype)


def _band_block(qb, kb, vb, qpb, pb, window: int, cap: float):
    return _sdpa(qb, kb, vb, _mask_bias(qpb, pb, True, window), cap)


def _banded_attn(q, k, v, q_pos, k_pos, window: int, cap: float,
                 q_block: int = _Q_BLOCK) -> torch.Tensor:
    """Sliding-window causal attention over query blocks, each against a
    static KV band of ``window + q_block`` keys that ends with the block
    (clamped to ``[0, Sk - band]``).  Padded queries and keys sit at
    position -1e9."""
    B, Sq, H, hd = q.shape
    Sk = k.shape[1]
    band = window + q_block
    nq = -(-Sq // q_block)
    pad_q = nq * q_block - Sq
    if pad_q:
        q = _pad_seq(q, pad_q)
        q_pos = _pad_pos(q_pos, pad_q, -_FAR)
    if Sk < band:
        k, v = _pad_seq(k, band - Sk), _pad_seq(v, band - Sk)
        k_pos = _pad_pos(k_pos, band - Sk, -_FAR)
        Sk = band
    track = _tracked(q, k, v)
    outs = []
    for i in range(nq):
        start = min(max(i * q_block + q_block - band, 0), Sk - band)
        rows = slice(i * q_block, (i + 1) * q_block)
        keys = slice(start, start + band)
        args = (q[:, rows], k[:, keys], v[:, keys], q_pos[rows],
                k_pos[keys], window, cap)
        outs.append(checkpoint(_band_block, *args, use_reentrant=False)
                    if track else _band_block(*args))
    return torch.cat(outs, dim=1)[:, :Sq]


def scaled_attention(q, k, v, q_pos, k_pos, *, causal: bool, window: int,
                     cap: float, runtime=None) -> torch.Tensor:
    """Dispatch over score paths (and the kernel when asked for), in the
    reference's order; on DTensors, on each chip's block
    (``sharding.dtensor.attention_on_chips``).

    q (B,Sq,H,hd); k, v (B,Sk,K,hd); q_pos (Sq,), k_pos (Sk,): 1-D global
    sequence positions.
    """
    if dtensor.is_dtensor(q):
        return dtensor.attention_on_chips(lambda *a: scaled_attention(
            *a, causal=causal, window=window, cap=cap, runtime=runtime),
            q, k, v, q_pos, k_pos)
    Sq, Sk = q.shape[1], k.shape[1]
    if runtime is not None and runtime.use_kernels and causal and Sq == Sk:
        return ops.flash_attention(q, k, v, causal=True, window=window,
                                   softcap=cap)
    if window > 0 and causal and Sq == Sk and Sq > _DENSE_MAX:
        return _banded_attn(q, k, v, q_pos, k_pos, window, cap)
    if max(Sq, Sk) <= _DENSE_MAX or Sq != Sk:
        return _dense_attn(q, k, v, q_pos, k_pos, causal, window, cap)
    return _chunked_attn(q, k, v, q_pos, k_pos, causal, cap)


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
    q = split_heads(q, B, S, cfg.n_heads, cfg.head_dim)
    k = split_heads(k, B, S, cfg.n_kv_heads, cfg.head_dim)
    v = split_heads(v, B, S, cfg.n_kv_heads, cfg.head_dim)
    return q, k, v


def attn_forward(params, x, *, cfg: ArchConfig, spec: LayerSpec, positions,
                 window: int, runtime=None):
    """Full-sequence self-attention (train / eval / prefill).  Returns
    (out, {"k", "v"}): the roped keys and the values in
    ``cfg.cache_dtype``, the layer's KV cache for decode (MLA: its
    ``ckv`` and ``krope`` latents)."""
    if cfg.mla is not None:
        return _mla_forward(params, x, cfg=cfg, positions=positions,
                            window=window, runtime=runtime)
    compute = torch_dtype(cfg.compute_dtype)
    q, k, v = _project_qkv(params, x, cfg, compute)
    if cfg.use_rope:
        q = apply_rope(q, positions, cfg.rope_theta, cfg.mrope_sections)
        k = apply_rope(k, positions, cfg.rope_theta, cfg.mrope_sections)
    pos1d = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
    out = scaled_attention(q, k, v, pos1d, pos1d, causal=True, window=window,
                           cap=cfg.attn_softcap, runtime=runtime)
    out = merge_heads(out, x.shape[0], x.shape[1], cfg.q_dim)
    out = (out.to(compute) @ params["wo"].to(compute)).to(x.dtype)
    cache_dt = torch_dtype(cfg.cache_dtype)
    return out, {"k": k.to(cache_dt), "v": v.to(cache_dt)}


def _sdpa_split_keys(q, k, v, bias, cap: float) -> torch.Tensor:
    """:func:`_sdpa` for keys whose sequence is sharded (a decode step on
    the dry run's mesh), as a partitioner takes it: each chip's scores
    over its keys, then the softmax's max and sum and the weighted values
    reduced across the keys' shards (``exp(s - m) @ v / sum exp(s - m)``,
    one all-reduce each), not the scores gathered.  On plain tensors, the
    same arithmetic on one block."""
    B, Sq, H, hd = q.shape
    K = k.shape[2]
    qs = (q.float() * (1.0 / math.sqrt(hd))).to(k.dtype)
    qs = qs.reshape(B, Sq, K, H // K, hd)
    scores = torch.einsum("bqkgd,bskd->bkgqs", qs.float(), k.float())
    scores = softcap(scores, cap) + bias
    p = torch.exp(scores - scores.detach().amax(dim=-1, keepdim=True))
    out = torch.einsum("bkgqs,bskd->bqkgd", p.to(v.dtype).float(), v.float())
    out = out / p.sum(dim=-1).permute(0, 3, 1, 2)[..., None]
    return out.reshape(B, Sq, H, hd).to(q.dtype)


def attn_decode(params, x, cache, pos: int, *, cfg: ArchConfig,
                spec: LayerSpec, window: int, runtime=None):
    """One-token decode against a cache.  x (B,1,d); ``pos`` a Python int,
    the new token's position.  The new key and value are written into
    ``cache`` at ``pos`` in place; the scores mask the slots not yet
    written and those outside the window.  Returns (out (B,1,d), cache)."""
    if cfg.mla is not None:
        return _mla_decode(params, x, cache, pos, cfg=cfg, window=window)
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
    dtensor.write_slot(k, pos, k_new[:, 0])
    dtensor.write_slot(v, pos, v_new[:, 0])
    k_pos = torch.arange(S, device=x.device)
    valid = k_pos <= pos
    if window > 0:
        valid &= k_pos > pos - window
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    bias = torch.where(valid, zero, _NEG)
    cap = cfg.attn_softcap
    if dtensor.seq_sharded(k):
        out = _sdpa_split_keys(dtensor.gathered_where_keys_split(q, k), k,
                               v, bias[None], cap)
    else:
        out = dtensor.attention_on_chips(
            lambda q, k, v, b: _sdpa(q, k, v, b, cap), q, k, v, bias[None])
    out = merge_heads(out, B, 1, cfg.q_dim)
    out = (out.to(compute) @ params["wo"].to(compute)).to(x.dtype)
    return out, {"k": k, "v": v}


# ---------------------------------------------------------------------------
# cross-attention (whisper decoder)
# ---------------------------------------------------------------------------


def cross_attn_forward(params, x, enc_k, enc_v, *, cfg: ArchConfig):
    """The decoder's queries x (B,S,d) against the encoder's keys and
    values (B,Sk,K,hd): dense scores, a zero (S, Sk) bias, no cap."""
    compute = torch_dtype(cfg.compute_dtype)
    B, S = x.shape[:2]
    q = split_heads(x.to(compute) @ params["xwq"].to(compute),
                    B, S, cfg.n_heads, cfg.head_dim)
    bias = torch.zeros((S, enc_k.shape[1]), dtype=torch.float32,
                       device=x.device)
    out = merge_heads(dtensor.attention_on_chips(
        lambda *a: _sdpa(*a, 0.0), q, enc_k, enc_v, bias), B, S, cfg.q_dim)
    return (out.to(compute) @ params["xwo"].to(compute)).to(x.dtype)


def cross_kv(params, enc_out, *, cfg: ArchConfig):
    """The encoder output's keys and values (B,Sk,K,hd), rounded to
    ``cfg.cache_dtype`` right after the products (under autograd too)."""
    compute = torch_dtype(cfg.compute_dtype)
    B, S = enc_out.shape[:2]
    e = enc_out.to(compute)
    k = split_heads(e @ params["xwk"].to(compute), B, S, cfg.n_kv_heads,
                    cfg.head_dim)
    v = split_heads(e @ params["xwv"].to(compute), B, S, cfg.n_kv_heads,
                    cfg.head_dim)
    cache_dt = torch_dtype(cfg.cache_dtype)
    return k.to(cache_dt), v.to(cache_dt)


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V2)
# ---------------------------------------------------------------------------


def _mla_q(params, x, cfg: ArchConfig, compute):
    m = cfg.mla
    B, S = x.shape[:2]
    xc = x.to(compute)
    if "wq_a" in params:
        qa = xc @ params["wq_a"].to(compute)
        qa = apply_norm(params["q_norm"], qa, cfg.norm, cfg.norm_eps)
        q = qa.to(compute) @ params["wq_b"].to(compute)
    else:
        q = xc @ params["wq"].to(compute)
    q = split_heads(q, B, S, cfg.n_heads, m.qk_nope_dim + m.qk_rope_dim)
    return q[..., :m.qk_nope_dim], q[..., m.qk_nope_dim:]


def _mla_latents(params, x, cfg: ArchConfig, positions, compute):
    """The compressed KV latent ``ckv`` (B,S,r), normed, and the shared
    roped key ``krope`` (B,S,rd)."""
    m = cfg.mla
    kv_a = x.to(compute) @ params["wkv_a"].to(compute)
    ckv = apply_norm(params["kv_norm"], kv_a[..., :m.kv_lora_rank],
                     cfg.norm, cfg.norm_eps)
    krope = kv_a[..., m.kv_lora_rank:]
    krope = apply_rope(krope[:, :, None, :], positions,
                       cfg.rope_theta)[:, :, 0]
    return ckv, krope


def _mla_wkvb_split(params, cfg: ArchConfig, compute):
    """``wkv_b`` as its key (r,H,nd) and value (r,H,vd) halves."""
    m = cfg.mla
    w = split_heads(params["wkv_b"].to(compute), m.kv_lora_rank,
                    cfg.n_heads, m.qk_nope_dim + m.v_head_dim)
    return w[..., :m.qk_nope_dim], w[..., m.qk_nope_dim:]


def _mla_forward(params, x, *, cfg: ArchConfig, positions, window: int,
                 runtime=None):
    """Full-sequence MLA: keys and values expanded from the latent per
    head, the shared roped key broadcast over the heads, v padded to the
    q/k head dim (nope + rope) for ``scaled_attention`` (and the kernel),
    then stripped.  Returns (out, {"ckv", "krope"})."""
    m = cfg.mla
    compute = torch_dtype(cfg.compute_dtype)
    B, S = x.shape[:2]
    q_nope, q_rope = _mla_q(params, x, cfg, compute)
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)
    ckv, krope = _mla_latents(params, x, cfg, positions, compute)
    wk, wv = _mla_wkvb_split(params, cfg, compute)
    k_nope = torch.einsum("bsr,rhd->bshd", ckv, wk)
    v = torch.einsum("bsr,rhd->bshd", ckv, wv)
    k = torch.cat([k_nope, krope[:, :, None, :].expand(
        B, S, cfg.n_heads, m.qk_rope_dim)], dim=-1)
    q = torch.cat([q_nope, q_rope], dim=-1)
    pos1d = torch.arange(S, dtype=torch.int32, device=x.device)
    vd, hd = m.v_head_dim, q.shape[-1]
    v_pad = dtensor.pad(v, -1, 0, hd - vd) if hd > vd else v
    out = scaled_attention(q, k, v_pad, pos1d, pos1d, causal=True,
                           window=window, cap=0.0, runtime=runtime)
    out = merge_heads(out[..., :vd], B, S, cfg.n_heads * vd)
    out = (out.to(compute) @ params["wo"].to(compute)).to(x.dtype)
    cache_dt = torch_dtype(cfg.cache_dtype)
    return out, {"ckv": ckv.to(cache_dt), "krope": krope.to(cache_dt)}


def _mla_decode(params, x, cache, pos: int, *, cfg: ArchConfig,
                window: int):
    """Absorbed MLA decode: the query absorbs ``wkv_b``'s key half, so the
    scores and the values stay in the latent space over the ``ckv`` and
    ``krope`` caches (no per-head keys); the value half expands the
    result.  The new latents are written at ``pos`` in place."""
    m = cfg.mla
    compute = torch_dtype(cfg.compute_dtype)
    B = x.shape[0]
    S = cache["ckv"].shape[1]
    positions = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
    q_nope, q_rope = _mla_q(params, x, cfg, compute)        # (B,1,H,*)
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)
    ckv_new, krope_new = _mla_latents(params, x, cfg, positions, compute)
    ckv, krope = cache["ckv"], cache["krope"]
    dtensor.write_slot(ckv, pos, ckv_new[:, 0])
    dtensor.write_slot(krope, pos, krope_new[:, 0])
    split = dtensor.seq_sharded(ckv)
    if split:
        q_nope, q_rope = (dtensor.gathered_where_keys_split(t, ckv)
                          for t in (q_nope, q_rope))
    wk, wv = _mla_wkvb_split(params, cfg, compute)
    # absorb: q_eff[h, r] = sum_d q_nope[h, d] wk[r, h, d]
    q_eff = torch.einsum("bqhd,rhd->bqhr", q_nope.float(), wk.float())
    scale = 1.0 / math.sqrt(m.qk_nope_dim + m.qk_rope_dim)
    s_lat = torch.einsum("bqhr,bsr->bhqs", q_eff.to(ckv.dtype).float(),
                         ckv.float())
    s_rope = torch.einsum("bqhd,bsd->bhqs", q_rope.to(krope.dtype).float(),
                          krope.float())
    scores = (s_lat + s_rope) * scale
    k_pos = torch.arange(S, device=x.device)
    valid = k_pos <= pos
    if window > 0:
        valid &= k_pos > pos - window
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    scores = scores + torch.where(valid, zero, _NEG)
    if split:
        # the softmax across the keys' shards (``_sdpa_split_keys``)
        p = torch.exp(scores - scores.detach().amax(dim=-1, keepdim=True))
        out_lat = torch.einsum("bhqs,bsr->bqhr", p.to(ckv.dtype).float(),
                               ckv.float())
        out_lat = out_lat / p.sum(dim=-1).transpose(1, 2)[..., None]
    else:
        w = torch.softmax(scores, dim=-1)
        out_lat = torch.einsum("bhqs,bsr->bqhr", w.to(ckv.dtype).float(),
                               ckv.float())
    out = torch.einsum("bqhr,rhd->bqhd", out_lat.to(wv.dtype).float(),
                       wv.float())
    out = merge_heads(out, B, 1, cfg.n_heads * m.v_head_dim).to(compute)
    out = (out @ params["wo"].to(compute)).to(x.dtype)
    return out, {"ckv": ckv, "krope": krope}

"""Chunkwise mLSTM: the CUDA kernel and its plain version.

Port of ``repro.kernels.mlstm.mlstm_chunkwise_bshd`` (a Pallas TPU kernel).
For q, k ``(B, S, H, dk)``, v ``(B, S, H, dv)`` and the raw gates
``i_gate, f_gate (B, S, H)`` it runs the stabilised mLSTM from a fresh
state (``C = 0, n = 0, m = -1e30``) in chunks: within a chunk the
``(L, L)`` decay-masked product ``q kᵀ``, across chunks the matrix memory
``C (dk, dv)``, the normaliser ``n (dk)`` and the stabiliser ``m``, with
``h = num / max(|den|, exp(-m_t))``.  It returns ``h (B, S, H, dv)`` in
float32 and the last state ``{C, n, m}``.

:func:`mlstm_chunk` is one chunk of that math; the model's own chunkwise
form (``models.xlstm.mlstm_chunkwise``) runs it too.  The chunkwise form is
exact at any chunk length, so the chunk changes the result only in
rounding: the plain version walks the caller's ``chunk``, the kernel its
own ``KERNEL_CHUNK`` steps.  The kernel splits the work in two passes over
the chunks (all chunks' scores and states first, then all outputs), and
:func:`mlstm_two_pass_plain` is the plain version of that arithmetic.

A CPU tensor takes :func:`mlstm_chunkwise_plain` (the TPU kernel's chunk
loop in torch, with its masking of the padded steps: ``log sigmoid(f) = 0``
and ``i = -1e30``); CUDA tensors launch the kernel (``csrc/mlstm.cu``) or
raise.  The kernel reads q, k, v (float32 or bfloat16) and the gates
(float32) through their strides, so the views that ``models.xlstm`` splits
out of its projections go in without a copy.  There is no gradient: the
wrapper raises when grad mode is on and an input requires grad.
``launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch
import torch.nn.functional as F

from repro_torch.kernels import build

launches = 0

MAX_DK = 256        # the output kernel keeps one chunk's n in shared memory
KERNEL_CHUNK = 64   # csrc/mlstm.cu's steps per chunk
_NEG = -1e30


def _check_shapes(q, k, v, i_gate, f_gate) -> None:
    if q.dim() != 4 or k.shape != q.shape:
        raise ValueError(f"mLSTM takes q, k (B,S,H,dk); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}")
    B, S, H, _ = q.shape
    if v.dim() != 4 or v.shape[:3] != (B, S, H):
        raise ValueError(f"v {tuple(v.shape)} is not (B,S,H,dv) with "
                         f"(B,S,H) = {(B, S, H)}")
    for name, g in (("i_gate", i_gate), ("f_gate", f_gate)):
        if g.shape != (B, S, H):
            raise ValueError(f"{name} {tuple(g.shape)} is not (B,S,H) = "
                             f"{(B, S, H)}")


def mlstm_chunk(C, n, m, q, k, v, i_gate, logf):
    """One chunk of the stabilised mLSTM.  q (already scaled by
    ``1/sqrt(dk)``), k ``(B,H,L,dk)``, v ``(B,H,L,dv)``, float32;
    ``i_gate`` and ``logf = log sigmoid(f)`` ``(B,H,L)``; the state C
    ``(B,H,dk,dv)``, n ``(B,H,dk)``, m ``(B,H)``.  Returns
    ``(h (B,H,L,dv), (C, n, m))``."""
    L = q.shape[-2]
    b = torch.cumsum(logf, dim=-1)
    g = b[..., -1]
    # intra-chunk decay D[t,s] = b_t - b_s + i_s  (s <= t)
    D = b[..., :, None] - b[..., None, :] + i_gate[..., None, :]
    tri = torch.ones((L, L), dtype=torch.bool, device=q.device).tril()
    D = torch.where(tri, D, float("-inf"))
    m_intra = D.amax(dim=-1)
    m_t = torch.maximum(b + m[..., None], m_intra)
    w_inter = torch.exp(b + m[..., None] - m_t)
    num_inter = (q @ C) * w_inter[..., None]
    den_inter = (q @ n[..., None])[..., 0] * w_inter
    logits = q @ k.transpose(-1, -2)
    decay = torch.where(tri, torch.exp(D - m_t[..., None]), 0.0)
    Wn = decay * logits
    num = num_inter + Wn @ v
    den = den_inter + Wn.sum(dim=-1)
    h = num / torch.maximum(den.abs(), torch.exp(-m_t))[..., None]
    m_next = torch.maximum(g + m, (g[..., None] - b + i_gate).amax(dim=-1))
    w_c = torch.exp(g + m - m_next)
    w_s = torch.exp(g[..., None] - b + i_gate - m_next[..., None])
    kw = k * w_s[..., None]
    C = C * w_c[..., None, None] + kw.transpose(-1, -2) @ v
    n = n * w_c[..., None] + kw.sum(dim=-2)
    return h, (C, n, m_next)


def mlstm_chunkwise_plain(q, k, v, i_gate, f_gate, chunk: int = 128):
    """Plain version of :func:`mlstm_chunkwise_bshd`, in chunks of
    ``min(chunk, S)`` steps."""
    _check_shapes(q, k, v, i_gate, f_gate)
    B, S, H, dk = q.shape
    dv = v.shape[-1]
    dev = q.device
    L = max(min(chunk, S), 1)
    n_chunks = -(-S // L)
    pad = n_chunks * L - S
    scale = 1.0 / math.sqrt(dk)
    # (B, H, S, *) float32, padded to whole chunks
    qt = F.pad(q.float().transpose(1, 2) * scale, (0, 0, 0, pad))
    kt = F.pad(k.float().transpose(1, 2), (0, 0, 0, pad))
    vt = F.pad(v.float().transpose(1, 2), (0, 0, 0, pad))
    valid = torch.arange(n_chunks * L, device=dev) < S
    it = torch.where(valid, F.pad(i_gate.float().transpose(1, 2), (0, pad)),
                     _NEG)
    lf = torch.where(valid, F.logsigmoid(F.pad(
        f_gate.float().transpose(1, 2), (0, pad))), 0.0)
    C = torch.zeros((B, H, dk, dv), device=dev)
    n = torch.zeros((B, H, dk), device=dev)
    m = torch.full((B, H), _NEG, device=dev)
    hs = []
    for s0 in range(0, n_chunks * L, L):
        sl = slice(s0, s0 + L)
        h, (C, n, m) = mlstm_chunk(C, n, m, qt[:, :, sl], kt[:, :, sl],
                                   vt[:, :, sl], it[:, :, sl], lf[:, :, sl])
        hs.append(h)
    h = torch.cat(hs, 2)[:, :, :S] if hs else vt
    return h.transpose(1, 2), {"C": C, "n": n, "m": m}


def mlstm_two_pass_plain(q, k, v, i_gate, f_gate, chunk: int = KERNEL_CHUNK):
    """Plain version of the kernel's arithmetic: the chunkwise form in two
    passes.  First, per chunk, the cumulative log sigmoid ``b``, the
    intra-chunk maxima ``m_intra_t = max_{s<=t} D[t,s]`` and the scores
    ``W'[t,s] = exp(D[t,s] - m_intra_t) q_t.k_s``; the carry from chunk to
    chunk, keeping the state ``(C, n, m)`` that enters every chunk.  Then
    all outputs at once, with ``m_t = max(b_t + m, m_intra_t)``,
    ``w_t = exp(b_t + m - m_t)`` and ``r_t = exp(m_intra_t - m_t)``:
    ``h_t = (w_t q_t C + r_t W'_t v) / max(|w_t q_t n + r_t sum W'_t|,
    exp(-m_t))``.  Equal to :func:`mlstm_chunkwise_plain` up to float32
    rounding."""
    _check_shapes(q, k, v, i_gate, f_gate)
    B, S, H, dk = q.shape
    dv = v.shape[-1]
    dev = q.device
    L = chunk
    nch = -(-S // L)
    pad = nch * L - S
    scale = 1.0 / math.sqrt(dk)

    def chunks(x):  # (B, S, H, *) -> (B, H, nch, L, *), padded with zeros
        x = F.pad(x.float().transpose(1, 2), (0, 0, 0, pad))
        return x.reshape(B, H, nch, L, x.shape[-1])

    qc, kc, vc = chunks(q) * scale, chunks(k), chunks(v)
    valid = (torch.arange(nch * L, device=dev) < S).reshape(nch, L)
    it = torch.where(valid, F.pad(i_gate.float().transpose(1, 2),
                                  (0, pad)).reshape(B, H, nch, L), _NEG)
    lf = torch.where(valid, F.logsigmoid(F.pad(
        f_gate.float().transpose(1, 2), (0, pad))).reshape(B, H, nch, L),
        0.0)
    b = torch.cumsum(lf, dim=-1)
    tri = torch.ones((L, L), dtype=torch.bool, device=dev).tril()
    D = torch.where(tri, b[..., :, None] - b[..., None, :]
                    + it[..., None, :], float("-inf"))
    m_intra = D.amax(dim=-1)
    Wp = torch.where(tri, torch.exp(D - m_intra[..., None])
                     * (qc @ kc.transpose(-1, -2)), 0.0)
    # the carry, keeping the state that enters each chunk
    g = b[..., -1]
    u = g[..., None] - b + it
    m_loc = u.amax(dim=-1)
    C = torch.zeros((B, H, dk, dv), device=dev)
    n = torch.zeros((B, H, dk), device=dev)
    m = torch.full((B, H), _NEG, device=dev)
    Cs, ns, ms = [], [], []
    for c in range(nch):
        Cs.append(C)
        ns.append(n)
        ms.append(m)
        m_next = torch.maximum(g[..., c] + m, m_loc[..., c])
        w_c = torch.exp(g[..., c] + m - m_next)
        w_s = torch.exp(u[..., c, :] - m_next[..., None])
        kw = kc[:, :, c] * w_s[..., None]
        C = C * w_c[..., None, None] + kw.transpose(-1, -2) @ vc[:, :, c]
        n = n * w_c[..., None] + kw.sum(dim=-2)
        m = m_next
    if nch == 0:
        return q.new_zeros((B, S, H, dv), dtype=torch.float32), {
            "C": C, "n": n, "m": m}
    Cb, nb, mb = torch.stack(Cs, 2), torch.stack(ns, 2), torch.stack(ms, 2)
    # all outputs
    m_t = torch.maximum(b + mb[..., None], m_intra)
    w_t = torch.exp(b + mb[..., None] - m_t)
    r_t = torch.exp(m_intra - m_t)
    num = (qc @ Cb) * w_t[..., None] + (Wp @ vc) * r_t[..., None]
    den = (qc @ nb[..., None])[..., 0] * w_t + Wp.sum(dim=-1) * r_t
    h = num / torch.maximum(den.abs(), torch.exp(-m_t))[..., None]
    h = h.reshape(B, H, nch * L, dv)[:, :, :S]
    return h.transpose(1, 2), {"C": C, "n": n, "m": m}


def mlstm_chunkwise_bshd(q, k, v, i_gate, f_gate, chunk: int = 128):
    """q, k (B,S,H,dk); v (B,S,H,dv), float32 or bfloat16; gates (B,S,H)
    float32 -> (h (B,S,H,dv) float32, {C (B,H,dk,dv), n (B,H,dk),
    m (B,H)}).  ``chunk`` is the plain version's; the kernel walks its
    own."""
    _check_shapes(q, k, v, i_gate, f_gate)
    inputs = (q, k, v, i_gate, f_gate)
    if all(t.device.type == "cpu" for t in inputs):
        return mlstm_chunkwise_plain(*inputs, chunk=chunk)
    return _launch(*inputs)


@functools.cache
def _library() -> ctypes.CDLL:
    lib = build.load("mlstm")
    fn = lib.repro_mlstm_chunkwise
    fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 6
                   + [ctypes.c_float, ctypes.POINTER(ctypes.c_longlong),
                      ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.repro_mlstm_scratch_floats.argtypes = [ctypes.c_int] * 5
    lib.repro_mlstm_scratch_floats.restype = ctypes.c_longlong
    lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
    lib.repro_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _launch(q, k, v, i_gate, f_gate):
    global launches
    inputs = (q, k, v, i_gate, f_gate)
    if torch.is_grad_enabled() and any(t.requires_grad for t in inputs):
        raise RuntimeError("the mLSTM kernel has no gradient: call it under "
                           "torch.no_grad or inference_mode")
    if q.dtype not in (torch.float32, torch.bfloat16) or \
            k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"the mLSTM kernel takes q, k, v of one type, "
                        f"float32 or bfloat16; got {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    if i_gate.dtype != torch.float32 or f_gate.dtype != torch.float32:
        raise TypeError(f"the mLSTM kernel takes float32 gates, got "
                        f"{i_gate.dtype}, {f_gate.dtype}")
    B, S, H, dk = q.shape
    dv = v.shape[-1]
    if dk > MAX_DK:
        raise ValueError(f"head dim dk={dk} is above the kernel's {MAX_DK}")
    if not all(t.is_cuda for t in inputs):
        raise ValueError("mLSTM takes CPU or CUDA tensors, got "
                         + ", ".join(str(t.device) for t in inputs))
    if len({t.device for t in inputs}) != 1:
        raise ValueError("mLSTM inputs lie on different cards")
    h = torch.empty((B, S, H, dv), dtype=torch.float32, device=q.device)
    C = torch.empty((B, H, dk, dv), dtype=torch.float32, device=q.device)
    n = torch.empty((B, H, dk), dtype=torch.float32, device=q.device)
    m = torch.empty((B, H), dtype=torch.float32, device=q.device)
    state = {"C": C, "n": n, "m": m}
    if B * H * dk * dv == 0:
        return h, state
    strides = (ctypes.c_longlong * 18)(*q.stride(), *k.stride(), *v.stride(),
                                       *i_gate.stride(), *f_gate.stride())
    lib = _library()
    # the chunks' scores, gate terms and entering states, between the passes
    scratch = torch.empty(lib.repro_mlstm_scratch_floats(B, S, H, dk, dv),
                          dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.repro_mlstm_chunkwise(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), i_gate.data_ptr(),
            f_gate.data_ptr(), h.data_ptr(), C.data_ptr(), n.data_ptr(),
            m.data_ptr(), scratch.data_ptr(), B, S, H, dk, dv,
            int(q.dtype == torch.bfloat16), 1.0 / math.sqrt(dk), strides,
            stream)
    if err != 0:
        raise RuntimeError("mLSTM kernel launch failed: "
                           + lib.repro_cuda_error_string(err).decode())
    launches += 1
    return h, state

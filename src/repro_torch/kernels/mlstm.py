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
own 32 steps.

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

MAX_DK = 256        # the kernel's q and k chunk tiles and C fit in 227 KB
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
    fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 6
                   + [ctypes.c_float, ctypes.POINTER(ctypes.c_longlong),
                      ctypes.c_void_p])
    fn.restype = ctypes.c_int
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
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.repro_mlstm_chunkwise(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), i_gate.data_ptr(),
            f_gate.data_ptr(), h.data_ptr(), C.data_ptr(), n.data_ptr(),
            m.data_ptr(), B, S, H, dk, dv, int(q.dtype == torch.bfloat16),
            1.0 / math.sqrt(dk), strides, stream)
    if err != 0:
        raise RuntimeError("mLSTM kernel launch failed: "
                           + lib.repro_cuda_error_string(err).decode())
    launches += 1
    return h, state

"""Forward flash attention: the CUDA kernel and its plain version.

Port of ``repro.kernels.flash_attention.flash_attention_bhsd`` (a Pallas TPU
kernel): q ``(B, H, S, hd)``, k and v ``(B, K, S, hd)`` with ``H % K == 0``
(GQA, query head h reads KV head ``h // (H // K)``), ``Sq == Sk``; causal
masking, a sliding window and a tanh soft-cap; q scaled by the float32
value of ``1/sqrt(hd)``; masked scores ``-2e9``; float32 accumulation; the
output in q's dtype (float32 or bfloat16).

A CPU tensor takes :func:`flash_attention_plain`; a CUDA tensor launches
the kernel (``csrc/flash_attention.cu``) or raises.  The kernel reads its
inputs through their strides (the head dimension contiguous), so a
``(B, S, H, hd)`` tensor viewed as ``(B, H, S, hd)`` goes in without a copy,
and the output has the strides of q.  There is no gradient: the wrapper
raises when grad mode is on and an input requires grad.  ``launches``
counts kernel launches.
"""
from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch

from repro_torch.kernels import build

launches = 0

_NEG = -2.0e9
HEAD_DIMS = (32, 64, 128, 256)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _scale(head_dim: int) -> float:
    """``1/sqrt(hd)`` as the float32 the reference multiplies q by."""
    return float(np.float32(1.0 / math.sqrt(head_dim)))


def _check_shapes(q, k, v) -> None:
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4:
        raise ValueError(f"flash attention takes q (B,H,S,hd) and k, v "
                         f"(B,K,S,hd); got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, H, S, hd = q.shape
    if (k.shape[0], k.shape[2], k.shape[3]) != (B, S, hd):
        raise ValueError(f"k and v {tuple(k.shape)} do not match q "
                         f"{tuple(q.shape)} (Sq must equal Sk)")
    if H % k.shape[1]:
        raise ValueError(f"{H} query heads over {k.shape[1]} KV heads")


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True, window: int = -1,
                          softcap: float = 0.0) -> torch.Tensor:
    """Plain version of :func:`flash_attention_bhsd`: the KV heads
    repeated, float32 scores from the scaled q, the soft-cap, then the
    ``-2e9`` mask, a softmax, times v, cast to q's dtype."""
    _check_shapes(q, k, v)
    S, hd = q.shape[2], q.shape[3]
    G = q.shape[1] // k.shape[1]
    kf = k.float().repeat_interleave(G, dim=1)
    vf = v.float().repeat_interleave(G, dim=1)
    s = (q.float() * _scale(hd)) @ kf.transpose(-1, -2)
    if softcap > 0:
        s = softcap * torch.tanh(s / softcap)
    rows = torch.arange(S, device=q.device)[:, None]
    cols = torch.arange(S, device=q.device)[None, :]
    ok = torch.ones((S, S), dtype=torch.bool, device=q.device)
    if causal:
        ok &= rows >= cols
    if window > 0:
        ok &= (rows - cols) < window
    s = torch.where(ok, s, _NEG)
    return (torch.softmax(s, dim=-1) @ vf).to(q.dtype)


def flash_attention_bhsd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True, window: int = -1,
                         softcap: float = 0.0) -> torch.Tensor:
    """q (B,H,S,hd); k, v (B,K,S,hd) -> (B,H,S,hd) in q.dtype."""
    _check_shapes(q, k, v)
    if q.device.type == "cpu" and k.device.type == "cpu" \
            and v.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     softcap=softcap)
    return _launch(q, k, v, causal, window, softcap)


@functools.cache
def _library() -> ctypes.CDLL:
    lib = build.load("flash_attention")
    fn = lib.repro_flash_attention
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.POINTER(ctypes.c_longlong), ctypes.c_float,
                   ctypes.c_int, ctypes.c_int, ctypes.c_float,
                   ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
    lib.repro_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _launch(q, k, v, causal: bool, window: int, softcap: float):
    global launches
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError("the flash attention kernel has no gradient: "
                           "call it under torch.no_grad or inference_mode")
    if not (q.is_cuda and k.is_cuda and v.is_cuda):
        raise ValueError("flash attention takes CPU or CUDA tensors, got "
                         f"{q.device}, {k.device}, {v.device}")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise TypeError(f"the flash attention kernel takes float32 or "
                        f"bfloat16, got {q.dtype}, {k.dtype}, {v.dtype}")
    B, H, S, hd = q.shape
    if hd not in HEAD_DIMS:
        raise ValueError(f"head_dim {hd} is not one of {HEAD_DIMS}")
    out = torch.empty_like(q)
    if any(t.stride(-1) != 1 for t in (q, k, v, out)):
        raise ValueError("flash attention needs a contiguous head dimension")
    if out.numel() == 0:
        return out
    strides = (ctypes.c_longlong * 12)(*(
        s for t in (q, k, v, out) for s in (t.stride(0), t.stride(2),
                                            t.stride(1))))
    vec = 16 // q.element_size()      # elements in one 16-byte load
    aligned = all(t.data_ptr() % 16 == 0 and t.stride(0) % vec == 0
                  and t.stride(1) % vec == 0 and t.stride(2) % vec == 0
                  for t in (q, k, v))
    lib = _library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.repro_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            _DTYPE_CODES[q.dtype], B, H, k.shape[1], S, hd, strides,
            _scale(hd), int(causal), int(window),
            float(np.float32(softcap)), int(aligned), stream)
    if err != 0:
        raise RuntimeError("flash attention kernel launch failed: "
                           + lib.repro_cuda_error_string(err).decode())
    launches += 1
    return out

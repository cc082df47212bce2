"""Forward flash attention: the CUDA kernels and their plain versions.

Port of ``repro.kernels.flash_attention.flash_attention_bhsd`` (a Pallas TPU
kernel): q ``(B, H, S, hd)``, k and v ``(B, K, S, hd)`` with ``H % K == 0``
(GQA, query head h reads KV head ``h // (H // K)``), ``Sq == Sk``; causal
masking, a sliding window and a tanh soft-cap; scores scaled by the float32
value of ``1/sqrt(hd)``; masked scores ``-2e9``; float32 accumulation; the
output in q's dtype (float32 or bfloat16).

A CPU tensor takes :func:`flash_attention_plain`; a CUDA tensor launches a
kernel or raises.  Which kernel is fixed before the launch by dtype and
strides alone (:func:`route`), and a failed launch is never retried on
the other:

- ``"sm90"`` (``csrc/flash_attention_sm90.cu``): bfloat16 whose bases and
  strides are multiples of 16 bytes, as the tensor maps of its TMA loads
  need.  wgmma tensor-core products, float32 accumulation, P rounded to
  bfloat16 before P.V; :func:`flash_attention_tc_plain` repeats that
  arithmetic.
- ``"fma"`` (``csrc/flash_attention.cu``): float32, whose 2e-5 tolerance
  needs IEEE float32 products (float32 FMAs on the CUDA cores), and
  bfloat16 that TMA cannot address.

Both kernels read their inputs through their strides (the head dimension
contiguous), so a ``(B, S, H, hd)`` tensor viewed as ``(B, H, S, hd)`` goes
in without a copy, and the output has the strides of q.  There is no
gradient: the wrapper raises when grad mode is on and an input requires
grad.  ``launches`` counts kernel launches, ``launches_sm90`` and
``launches_fma`` those of each route, and ``launches_by_window`` those of
each sliding window (-1 for none).
"""
from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch

from repro_torch.kernels import build

launches = 0
launches_sm90 = 0
launches_fma = 0
launches_by_window: dict = {}

_NEG = -2.0e9
_LOG2E = float(np.float32(1.4426950408889634))
HEAD_DIMS = (32, 64, 128, 192, 256)   # 192: MLA's nope 128 + rope 64
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
    hd = q.shape[3]
    G = q.shape[1] // k.shape[1]
    kf = k.float().repeat_interleave(G, dim=1)
    vf = v.float().repeat_interleave(G, dim=1)
    s = (q.float() * _scale(hd)) @ kf.transpose(-1, -2)
    if softcap > 0:
        s = softcap * torch.tanh(s / softcap)
    s = _mask(s, causal, window)
    return (torch.softmax(s, dim=-1) @ vf).to(q.dtype)


def flash_attention_tc_plain(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, *, causal: bool = True,
                             window: int = -1,
                             softcap: float = 0.0) -> torch.Tensor:
    """Plain version of the ``"sm90"`` kernel's arithmetic: float32 scores
    from the unscaled bfloat16 q and k (their products are exact), then
    taken to base 2: times the float32 ``scale * log2 e``, or soft-capped
    and then times ``log2 e``; the ``-2e9`` mask; ``P = 2^(s - m)`` with m
    the row max, rounded to bfloat16 before ``P @ v``; ``l`` the sum of the
    float32 P; ``P @ v`` times the float32 ``1 / max(l, 1e-30)``, cast to
    q's dtype.  The kernel's P is relative to the running max and its
    ``2^x`` is the card's approximate one, so the two differ by about one
    bfloat16 rounding of P and of the output."""
    _check_shapes(q, k, v)
    hd = q.shape[3]
    G = q.shape[1] // k.shape[1]
    kf = k.float().repeat_interleave(G, dim=1)
    vf = v.float().repeat_interleave(G, dim=1)
    s = q.float() @ kf.transpose(-1, -2)
    if softcap > 0:
        s = softcap * torch.tanh(s * _scale(hd) / softcap) * _LOG2E
    else:
        s = s * float(np.float32(_scale(hd)) * np.float32(_LOG2E))
    s = _mask(s, causal, window)
    p = torch.exp2(s - s.amax(dim=-1, keepdim=True))
    inv = torch.reciprocal(p.sum(dim=-1, keepdim=True).clamp_min(1e-30))
    return ((p.to(torch.bfloat16).float() @ vf) * inv).to(q.dtype)


def _mask(s: torch.Tensor, causal: bool, window: int) -> torch.Tensor:
    """``-2e9`` where the causal mask or the window takes a score out."""
    S = s.shape[-1]
    rows = torch.arange(S, device=s.device)[:, None]
    cols = torch.arange(S, device=s.device)[None, :]
    ok = torch.ones((S, S), dtype=torch.bool, device=s.device)
    if causal:
        ok &= rows >= cols
    if window > 0:
        ok &= (rows - cols) < window
    return torch.where(ok, s, _NEG)


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


def route(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
          out: torch.Tensor) -> str:
    """The kernel a non-CPU call takes, from dtype and strides alone:
    ``"sm90"`` for bfloat16 whose bases and (batch, sequence, head) strides
    are all multiples of 16 bytes (the rule of the TMA tensor maps through
    which that kernel loads q, k, v and stores the output), else
    ``"fma"``."""
    if q.dtype != torch.bfloat16:
        return "fma"
    size = q.element_size()
    aligned = all(t.data_ptr() % 16 == 0
                  and all(st * size % 16 == 0 for st in t.stride()[:3])
                  for t in (q, k, v, out))
    return "sm90" if aligned else "fma"


# B, H, K, S, hd, the 12 strides, scale, causal, window, softcap
_SHAPE_ARGS = [ctypes.c_int] * 5 + [ctypes.POINTER(ctypes.c_longlong),
                                    ctypes.c_float, ctypes.c_int,
                                    ctypes.c_int, ctypes.c_float]
_PTRS = [ctypes.c_void_p] * 4             # q, k, v, out
_ENTRIES = {   # route: source, C entry, its arguments (the stream last)
    "fma": ("flash_attention", "repro_flash_attention",
            _PTRS + [ctypes.c_int] + _SHAPE_ARGS + [ctypes.c_int,
                                                    ctypes.c_void_p]),
    "sm90": ("flash_attention_sm90", "repro_flash_attention_sm90",
             _PTRS + _SHAPE_ARGS + [ctypes.c_void_p]),
}


@functools.cache
def _library(which: str):
    """A route's built library and its C entry."""
    name, entry, argtypes = _ENTRIES[which]
    lib = build.load(name)
    fn = getattr(lib, entry)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
    lib.repro_cuda_error_string.restype = ctypes.c_char_p
    return lib, fn


def _launch(q, k, v, causal: bool, window: int, softcap: float):
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
    return _dispatch(q, k, v, out, route(q, k, v, out), causal, window,
                     softcap)


def _dispatch(q, k, v, out, which: str, causal: bool, window: int,
              softcap: float):
    """Launch route ``which``'s kernel into ``out``; raise if it fails.
    The port passes :func:`route`'s choice; the FMA kernel also takes the
    inputs of the ``"sm90"`` route, so the two can be timed on the same
    bfloat16 inputs, but not the other way round."""
    global launches, launches_sm90, launches_fma
    if which == "sm90" and route(q, k, v, out) != "sm90":
        raise ValueError("the sm90 flash kernel takes bfloat16 with 16-byte "
                         "aligned bases and strides only")
    B, H, S, hd = q.shape
    strides = (ctypes.c_longlong * 12)(*(
        s for t in (q, k, v, out) for s in (t.stride(0), t.stride(2),
                                            t.stride(1))))
    lib, fn = _library(which)
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr())
    shape = (B, H, k.shape[1], S, hd, strides, _scale(hd), int(causal),
             int(window), float(np.float32(softcap)))
    if which == "sm90":
        args = (*ptrs, *shape)
    else:
        vec = 16 // q.element_size()      # elements in one 16-byte load
        aligned = all(t.data_ptr() % 16 == 0 and t.stride(0) % vec == 0
                      and t.stride(1) % vec == 0 and t.stride(2) % vec == 0
                      for t in (q, k, v))
        args = (*ptrs, _DTYPE_CODES[q.dtype], *shape, int(aligned))
    with torch.cuda.device(q.device):
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash attention kernel ({which}) launch "
                           "failed: "
                           + lib.repro_cuda_error_string(err).decode())
    launches += 1
    w = int(window) if window > 0 else -1
    launches_by_window[w] = launches_by_window.get(w, 0) + 1
    if which == "sm90":
        launches_sm90 += 1
    else:
        launches_fma += 1
    return out

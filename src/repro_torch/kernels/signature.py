"""Eq. 3 threshold-zero counts: the CUDA kernel and its plain version.

Port of ``repro.kernels.signature.signature_td`` (a Pallas TPU kernel).
:func:`signature_counts` takes a batch ``x (N, T, C)`` and folds the
reference's ``vmap`` over samples (``ops.signature_per_channel``) into the
kernel's grid; :func:`signature_td` is the reference's single ``(T, d)``
form.  Per channel it counts ``x == 0`` (``tau <= 0``, the CNN's ReLU kill
count) or ``|x| < tau`` (``tau > 0``), against the float32 value of tau.
``x`` is float32 or bfloat16; a bfloat16 value converts to float32
exactly, so both compare as the reference's ``|x.astype(f32)| < tau``.
Counts are exact integers in float32 up to 2**24 rows; ``mean=True`` scales
them by the float32 reciprocal of T, as the reference's ``acc / total_t``
does once XLA has compiled it.

A CPU tensor takes the plain version; a CUDA tensor launches the kernel
(``csrc/signature.cu``) or raises.  The kernel has two routes, and
:func:`route` picks one before the launch from dtype, strides and
alignment alone: ``"vec"`` (16-byte loads along contiguous channels, T
split over blocks, the blocks' integer counts joined with atomics in a
zeroed int32 scratch that the launch leaves zero) or ``"strided"`` (any
strides, one element a lane).  Both give the same bits.  ``launches``
counts kernel launches, ``launches_vec`` and ``launches_strided`` each
route's.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from repro_torch.kernels import build

launches = 0
launches_vec = 0
launches_strided = 0

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _f32(value: float) -> float:
    """``value`` rounded to float32, as the reference compares in f32."""
    return float(np.float32(value))


def _reciprocal(n: int) -> float:
    return float(np.float32(1) / np.float32(n))


def signature_counts_plain(x: torch.Tensor, tau: float = 0.0, *,
                           mean: bool = False) -> torch.Tensor:
    """Plain version of :func:`signature_counts`."""
    if tau <= 0.0:
        flags = x == 0
    else:
        flags = x.float().abs() < _f32(tau)
    counts = flags.sum(dim=1, dtype=torch.int32).float()
    return counts * _reciprocal(x.shape[1]) if mean else counts


def signature_counts(x: torch.Tensor, tau: float = 0.0, *,
                     mean: bool = False) -> torch.Tensor:
    """x (N, T, C) -> per-sample per-channel counts (N, C) float32."""
    if x.dim() != 3:
        raise ValueError(f"signature_counts takes (N, T, C), got {x.shape}")
    if x.device.type == "cpu":
        return signature_counts_plain(x, tau, mean=mean)
    return _launch(x, tau, mean)


def signature_td_plain(x: torch.Tensor, *, tau: float = 0.05,
                       mean: bool = True) -> torch.Tensor:
    """Plain version of :func:`signature_td`."""
    return signature_counts_plain(x[None], tau, mean=mean)[0]


def signature_td(x: torch.Tensor, *, tau: float = 0.05,
                 mean: bool = True) -> torch.Tensor:
    """x (T, d) -> per-channel fraction (``mean``) or count (d,) float32."""
    if x.dim() != 2:
        raise ValueError(f"signature_td takes (T, d), got {x.shape}")
    return signature_counts(x[None], tau, mean=mean)[0]


@functools.cache
def _library() -> ctypes.CDLL:
    lib = build.load("signature")
    fn = lib.repro_signature_counts
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,
                   ctypes.c_float, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
    lib.repro_cuda_error_string.restype = ctypes.c_char_p
    return lib


def route(x: torch.Tensor) -> str:
    """The kernel route a non-CPU ``x (N, T, C)`` takes, from dtype,
    strides and alignment alone: ``"vec"`` when the channels are contiguous,
    C is a multiple of one 16-byte vector (8 bfloat16 or 4 float32) and the
    base and the sample and row strides of every axis longer than 1 are
    multiples of 16 bytes, so that every row's channels load as whole
    16-byte vectors; else ``"strided"``."""
    size = x.element_size()
    vec = 16 // size
    aligned = (x.shape[2] % vec == 0 and x.stride(2) == 1
               and x.data_ptr() % 16 == 0
               and all(st * size % 16 == 0
                       for n, st in zip(x.shape[:2], x.stride()[:2]) if n > 1))
    return "vec" if aligned else "strided"


# the "vec" route's int32 scratch, zero between launches, by device and
# stream: launches on one stream run in order, so none sees another's
# partial counts
_scratch: dict = {}


def _zeroed_scratch(device: torch.device, stream: int,
                    ints: int) -> torch.Tensor:
    """The vec route's scratch for launches on ``stream`` of ``device``,
    at least ``ints`` int32 long.

    One buffer is kept for each (device, raw stream handle) the process
    has launched the vec route on, for the life of the process: a raw
    handle does not say when its stream is gone, so no entry is dropped.
    Each buffer grows to the largest launch on its stream (N * C counts
    plus N tickets per group of channels). It is zeroed once, here; every
    launch leaves it all zero again, and the next launch relies on that
    (``tests/test_torch_cuda.py`` sums every buffer after its launches)."""
    key = (device, stream)
    buf = _scratch.get(key)
    if buf is None or buf.numel() < ints:
        buf = torch.zeros(ints, dtype=torch.int32, device=device)
        _scratch[key] = buf
    return buf


def _launch(x: torch.Tensor, tau: float, mean: bool) -> torch.Tensor:
    if not x.is_cuda:
        raise ValueError(f"signature_counts takes a CPU or CUDA tensor, "
                         f"got one on {x.device}")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"the signature kernel takes float32 or bfloat16, "
                        f"got {x.dtype}")
    n, t, c = x.shape
    out = torch.empty((n, c), dtype=torch.float32, device=x.device)
    if out.numel() == 0:
        return out
    return _dispatch(x, out, route(x), tau, mean)


def _dispatch(x: torch.Tensor, out: torch.Tensor, which: str, tau: float,
              mean: bool) -> torch.Tensor:
    """Launch route ``which``'s kernel into ``out``; raise if it fails.
    The port passes :func:`route`'s choice; the strided kernel also takes
    the inputs of the ``"vec"`` route, so the two can be compared on the
    same inputs, but not the other way round."""
    global launches, launches_vec, launches_strided
    if which == "vec" and route(x) != "vec":
        raise ValueError("the vec signature kernel takes contiguous "
                         "channels on 16-byte aligned rows only")
    n, t, c = x.shape
    lib = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        scratch, ints = None, 0
        if which == "vec":
            # n * c counts and one ticket for each (sample, group of 32
            # vectors of channels)
            ints = n * c + n * -(-c * x.element_size() // 512)
            scratch = _zeroed_scratch(x.device, stream, ints).data_ptr()
        err = lib.repro_signature_counts(
            x.data_ptr(), out.data_ptr(), _DTYPE_CODES[x.dtype], n, t, c,
            *x.stride(), _f32(tau), int(mean), int(which == "vec"), scratch,
            ints, stream)
    if err != 0:
        raise RuntimeError(f"signature kernel ({which}) launch failed: "
                           + lib.repro_cuda_error_string(err).decode())
    launches += 1
    if which == "vec":
        launches_vec += 1
    else:
        launches_strided += 1
    return out

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
(``csrc/signature.cu``) or raises.  ``launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from repro_torch.kernels import build

launches = 0

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
                   ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
    lib.repro_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _launch(x: torch.Tensor, tau: float, mean: bool) -> torch.Tensor:
    global launches
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
    lib = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.repro_signature_counts(
            x.data_ptr(), out.data_ptr(), _DTYPE_CODES[x.dtype], n, t, c,
            *x.stride(), _f32(tau), int(mean), stream)
    if err != 0:
        raise RuntimeError("signature kernel launch failed: "
                           + lib.repro_cuda_error_string(err).decode())
    launches += 1
    return out

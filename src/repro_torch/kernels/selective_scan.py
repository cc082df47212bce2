"""Mamba selective scan: the CUDA kernel and its plain version.

Port of ``repro.kernels.selective_scan.selective_scan_bsd`` (a Pallas TPU
kernel).  For x, dt ``(B, S, d_in)``, A ``(d_in, N)``, Bc, Cc ``(B, S, N)``
and h0 ``(B, d_in, N)``, all float32, it runs the recurrence

    h <- exp(dt_t * A) * h + (dt_t * x_t) (outer) B_t,   y_t = sum_N h * C_t

over S and returns ``y (B, S, d_in)`` and the last state ``h_last``.  The
reference's ``chunk`` is its TPU tiling and does not change the result, so
there is none here.

A CPU tensor takes :func:`selective_scan_plain`, a plain loop over S (the
port of ``repro.kernels.ref.selective_scan_seq_ref``); CUDA tensors launch
the kernel (``csrc/selective_scan.cu``) or raise.
:func:`selective_scan_split_plain` repeats the kernel's own arithmetic
(``exp(dt*A)`` as a power of 2, ``y`` summed in two halves of the states);
nothing on the model's path calls it.  The kernel reads Bc and
Cc through their strides, so the views that ``models.mamba`` splits out of
one projection go in without a copy.  There is no gradient: the wrapper
raises when grad mode is on and an input requires grad.  ``launches``
counts kernel launches.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

launches = 0

STATE_SIZES = (2, 4, 8, 16)     # the kernel's template instances of N
LOG2E = 1.4426950408889634


def _check_shapes(x, dt, A, Bc, Cc, h0) -> None:
    if x.dim() != 3 or dt.shape != x.shape:
        raise ValueError(f"selective scan takes x, dt (B,S,d_in); got "
                         f"{tuple(x.shape)}, {tuple(dt.shape)}")
    B, S, d_in = x.shape
    if A.dim() != 2 or A.shape[0] != d_in:
        raise ValueError(f"A {tuple(A.shape)} is not (d_in={d_in}, N)")
    N = A.shape[1]
    if Bc.shape != (B, S, N) or Cc.shape != (B, S, N):
        raise ValueError(f"Bc {tuple(Bc.shape)} and Cc {tuple(Cc.shape)} "
                         f"are not (B,S,N) = {(B, S, N)}")
    if h0.shape != (B, d_in, N):
        raise ValueError(f"h0 {tuple(h0.shape)} is not (B,d_in,N) = "
                         f"{(B, d_in, N)}")


def selective_scan_plain(x, dt, A, Bc, Cc, h0):
    """Plain version of :func:`selective_scan_bsd`: one step per position,
    in float32."""
    _check_shapes(x, dt, A, Bc, Cc, h0)
    h = h0
    ys = []
    for t in range(x.shape[1]):
        dtt = dt[:, t]
        da = torch.exp(dtt[..., None] * A)
        h = da * h + (dtt * x[:, t])[..., None] * Bc[:, t, None, :]
        ys.append((h * Cc[:, t, None, :]).sum(-1))
    y = torch.stack(ys, 1) if ys else torch.zeros_like(x)
    return y, h


def selective_scan_split_plain(x, dt, A, Bc, Cc, h0):
    """The CUDA kernel's arithmetic in plain PyTorch: ``exp(dt*A)`` as
    ``2**(dt*A2)``, with ``A2 = A*log2(e)`` rounded once to float32, and
    ``y`` as the kernel sums it: two threads carry half of the N states
    each (N >= 4), each sums its half in order, then the halves are added.
    The kernel's power of 2 is the card's ``ex2.approx`` (2 ulp) and its
    products feed fused multiply-adds, so the two agree to rounding."""
    _check_shapes(x, dt, A, Bc, Cc, h0)
    B, S, d_in = x.shape
    N = A.shape[1]
    split = 2 if N >= 4 else 1
    A2 = (A.double() * LOG2E).float()
    h = h0
    ys = []
    for t in range(S):
        dtt = dt[:, t]
        da = torch.exp2(dtt[..., None] * A2)
        h = da * h + (dtt * x[:, t])[..., None] * Bc[:, t, None, :]
        terms = (h * Cc[:, t, None, :]).reshape(B, d_in, split, N // split)
        acc = terms[..., 0]
        for n in range(1, N // split):
            acc = acc + terms[..., n]
        ys.append(acc[..., 0] + acc[..., 1] if split == 2 else acc[..., 0])
    y = torch.stack(ys, 1) if ys else torch.zeros_like(x)
    return y, h


def selective_scan_bsd(x, dt, A, Bc, Cc, h0):
    """x, dt (B,S,d_in); A (d_in,N); Bc, Cc (B,S,N); h0 (B,d_in,N), all
    float32 -> (y (B,S,d_in), h_last (B,d_in,N))."""
    _check_shapes(x, dt, A, Bc, Cc, h0)
    inputs = (x, dt, A, Bc, Cc, h0)
    if all(t.device.type == "cpu" for t in inputs):
        return selective_scan_plain(*inputs)
    return _launch(*inputs)


@functools.cache
def _library() -> ctypes.CDLL:
    lib = build.load("selective_scan")
    fn = lib.repro_selective_scan
    fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 4
                   + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
    lib.repro_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _launch(x, dt, A, Bc, Cc, h0):
    global launches
    inputs = (x, dt, A, Bc, Cc, h0)
    if torch.is_grad_enabled() and any(t.requires_grad for t in inputs):
        raise RuntimeError("the selective scan kernel has no gradient: "
                           "call it under torch.no_grad or inference_mode")
    if any(t.dtype != torch.float32 for t in inputs):
        raise TypeError("the selective scan kernel takes float32, got "
                        + ", ".join(str(t.dtype) for t in inputs))
    B, S, d_in = x.shape
    N = A.shape[1]
    if N not in STATE_SIZES:
        raise ValueError(f"state size N={N} is not one of {STATE_SIZES}")
    if not all(t.is_cuda for t in inputs):
        raise ValueError("selective scan takes CPU or CUDA tensors, got "
                         + ", ".join(str(t.device) for t in inputs))
    if len({t.device for t in inputs}) != 1:
        raise ValueError("selective scan inputs lie on different cards")
    x, dt, A, h0 = (t.contiguous() for t in (x, dt, A, h0))
    y = torch.empty_like(x)
    h_last = torch.empty_like(h0)
    if y.numel() == 0 and h_last.numel() == 0:
        return y, h_last
    strides = (ctypes.c_longlong * 6)(*Bc.stride(), *Cc.stride())
    lib = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.repro_selective_scan(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bc.data_ptr(),
            Cc.data_ptr(), h0.data_ptr(), y.data_ptr(), h_last.data_ptr(),
            B, S, d_in, N, strides, stream)
    if err != 0:
        raise RuntimeError("selective scan kernel launch failed: "
                           + lib.repro_cuda_error_string(err).decode())
    launches += 1
    return y, h_last

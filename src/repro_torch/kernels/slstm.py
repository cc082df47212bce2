"""sLSTM recurrence: the CUDA kernel and its plain version.

Port of ``repro.kernels.slstm.slstm_scan_bsd`` (a Pallas TPU kernel).  For
``gates_x (B, S, 4d)`` (the input side ``x @ W + b``, hoisted out of the
loop by the caller), ``R (d, 4d)`` and the states ``c0, n0, h0, m0
(B, d)``, all float32, it runs the recurrence

    gates = gates_x[:, t] + h @ R          (i, f, z, o: d columns each)
    m' = max(f + m, i);  i' = exp(i - m');  f' = exp(f + m - m')
    c <- f' c + i' tanh(z);  n <- f' n + i';  h <- sigmoid(o) c / max(n, 1e-6)

over S and returns ``hs (B, S, d)`` and the last ``(c, n, h, m)``.  The
reference's ``chunk`` is its TPU tiling and does not change the result, so
there is none here.

A CPU tensor takes :func:`slstm_scan_plain`, one :func:`slstm_step` per
position (the port of ``repro.kernels.ref.slstm_scan_ref``); CUDA tensors
launch the kernel (``csrc/slstm.cu``) or raise.  The kernel takes any
batch: :func:`row_plan` fits as many rows into one launch as the block's
shared memory holds (up to 423 rows at xlstm-125m's width), and larger
batches go in slices, one launch each (rows are independent, so the result
is the same).  There is no gradient: the wrapper raises when grad mode is
on and an input requires grad.  ``launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

launches = 0

SMEM_LIMIT = 232_448            # shared memory one block may take (227 KB)
MAX_D = 1024                    # the widest d the kernel's k split covers


def units_per_block(d: int, sms: int) -> int:
    """The hidden units a block of the persistent grid owns: the fewest of
    2, 4, 6 and 8 that need no more blocks than the card has SMs (the most,
    8, where none does)."""
    return next((u for u in (2, 4, 6) if -(-d // u) <= sms), 8)


def smem_bytes(units: int, rows: int, d: int) -> int:
    """Shared memory of one block (``csrc/slstm.cu`` ``smem_floats``): R's
    4U columns over the 256 lanes' k, each warp's tile of 8 rows of h, the
    warps' partial sums of two passes, and per row two steps of gates_x and
    the four states."""
    kpt = next(k for k, top in ((4, 256), (8, 512), (12, 768), (16, MAX_D))
               if d <= top)
    pitch = kpt if (kpt // 4) % 2 else kpt + 4
    return 4 * (256 * kpt * units + 512 * pitch + 512 * units
                + rows * 12 * units)


def row_plan(B: int, d: int, units: int) -> int:
    """The batch rows one launch takes: as many as the block's shared
    memory holds beside R's columns (a larger batch goes in slices of that
    many rows, one launch each)."""
    if d > MAX_D:
        raise ValueError(f"the sLSTM kernel takes d <= {MAX_D}; got d={d}")
    rows = (SMEM_LIMIT - smem_bytes(units, 0, d)) // (
        smem_bytes(units, 1, d) - smem_bytes(units, 0, d))
    if rows < 1:
        raise ValueError(f"the sLSTM kernel cannot hold R's columns at "
                         f"d={d} ({units} units per block) in {SMEM_LIMIT} "
                         f"bytes of shared memory")
    return min(B, rows)


def _check_shapes(gates_x, R, c0, n0, h0, m0) -> None:
    if gates_x.dim() != 3 or gates_x.shape[-1] % 4:
        raise ValueError(f"sLSTM takes gates_x (B,S,4d); got "
                         f"{tuple(gates_x.shape)}")
    B, _, d4 = gates_x.shape
    d = d4 // 4
    if R.shape != (d, d4):
        raise ValueError(f"R {tuple(R.shape)} is not (d, 4d) = {(d, d4)}")
    for name, t in zip("cnhm", (c0, n0, h0, m0)):
        if t.shape != (B, d):
            raise ValueError(f"{name}0 {tuple(t.shape)} is not (B,d) = "
                             f"{(B, d)}")


def slstm_step(c, n, h, m, gx_t, R):
    """One position of the recurrence: the states (B, d) and ``gx_t``
    (B, 4d) -> the new ``(c, n, h, m)``."""
    gates = gx_t + h @ R
    i_t, f_t, z_t, o_t = gates.chunk(4, dim=-1)
    m_new = torch.maximum(f_t + m, i_t)
    iprime = torch.exp(i_t - m_new)
    fprime = torch.exp(f_t + m - m_new)
    c = fprime * c + iprime * torch.tanh(z_t)
    n = fprime * n + iprime
    h = torch.sigmoid(o_t) * c / torch.clamp(n, min=1e-6)
    return c, n, h, m_new


def slstm_scan_plain(gates_x, R, c0, n0, h0, m0):
    """Plain version of :func:`slstm_scan_bsd`: one step per position."""
    _check_shapes(gates_x, R, c0, n0, h0, m0)
    state, hs = (c0, n0, h0, m0), []
    for t in range(gates_x.shape[1]):
        state = slstm_step(*state, gates_x[:, t], R)
        hs.append(state[2])
    hs = torch.stack(hs, 1) if hs else gates_x.new_zeros(
        gates_x.shape[:2] + (R.shape[0],))
    return hs, state


def slstm_scan_bsd(gates_x, R, c0, n0, h0, m0):
    """gates_x (B,S,4d); R (d,4d); c0, n0, h0, m0 (B,d), all float32 ->
    (hs (B,S,d), (c, n, h, m) each (B,d))."""
    _check_shapes(gates_x, R, c0, n0, h0, m0)
    inputs = (gates_x, R, c0, n0, h0, m0)
    if all(t.device.type == "cpu" for t in inputs):
        return slstm_scan_plain(*inputs)
    return _launch(*inputs)


def exchange_floor(gates_x, R, c0, n0, h0, m0):
    """The kernel's grid and step loop without the ``h @ R`` products (the
    gates are ``gates_x`` alone) on CUDA tensors: what the exchange of h
    between blocks costs by itself.  A measurement, not the recurrence:
    ``launches`` does not count it."""
    _check_shapes(gates_x, R, c0, n0, h0, m0)
    return _launch(gates_x, R, c0, n0, h0, m0, products=False)


@functools.cache
def _library() -> ctypes.CDLL:
    lib = build.load("slstm")
    fn = lib.repro_slstm_scan
    fn.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 5 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
    lib.repro_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _launch(gates_x, R, c0, n0, h0, m0, products=True):
    inputs = (gates_x, R, c0, n0, h0, m0)
    if torch.is_grad_enabled() and any(t.requires_grad for t in inputs):
        raise RuntimeError("the sLSTM kernel has no gradient: call it under "
                           "torch.no_grad or inference_mode")
    if any(t.dtype != torch.float32 for t in inputs):
        raise TypeError("the sLSTM kernel takes float32, got "
                        + ", ".join(str(t.dtype) for t in inputs))
    if not all(t.is_cuda for t in inputs):
        raise ValueError("sLSTM takes CPU or CUDA tensors, got "
                         + ", ".join(str(t.device) for t in inputs))
    if len({t.device for t in inputs}) != 1:
        raise ValueError("sLSTM inputs lie on different cards")
    gates_x, R, c0, n0, h0, m0 = (t.contiguous() for t in inputs)
    d = R.shape[0]
    props = torch.cuda.get_device_properties(gates_x.device)
    return _run(gates_x, R, c0, n0, h0, m0,
                units_per_block(d, props.multi_processor_count), products)


def _run(gates_x, R, c0, n0, h0, m0, units: int, products: bool = True):
    """The launches for contiguous float32 inputs on one card, ``units``
    hidden units a block: the batch in slices of :func:`row_plan`'s rows,
    one launch each."""
    global launches
    B, S, d4 = gates_x.shape
    d = d4 // 4
    rows = row_plan(B, d, units)
    hs = gates_x.new_empty((B, S, d))
    out = [c0.new_empty((B, d)) for _ in range(4)]
    if B * d == 0:
        return hs, tuple(out)
    # the exchange of h between blocks: tagged 64-bit words, zeroed before
    # each launch so that no tag of an earlier one is read
    xchg = torch.empty(2 * rows * d, dtype=torch.int64,
                       device=gates_x.device)
    lib = _library()
    with torch.cuda.device(gates_x.device):
        stream = torch.cuda.current_stream().cuda_stream
        for r0 in range(0, B, rows):
            part = slice(r0, min(B, r0 + rows))
            xchg.zero_()
            err = lib.repro_slstm_scan(
                gates_x[part].data_ptr(), R.data_ptr(),
                *(t[part].data_ptr() for t in (c0, n0, h0, m0, hs, *out)),
                xchg.data_ptr(), part.stop - r0, S, d, units // 2,
                int(products), stream)
            if err != 0:
                raise RuntimeError("sLSTM kernel launch failed: "
                                   + lib.repro_cuda_error_string(err)
                                   .decode())
            launches += products
    return hs, tuple(out)

"""Model-facing wrappers over the port's kernels (port of
``repro.kernels.ops``).

There is no policy layer: the tensor's device decides.  A CPU tensor takes
a kernel's plain version, a CUDA tensor the kernel.

Bit-stability contract for ``signature`` and ``signature_per_channel``: the
Eq. 3 signatures feed tip selection through the similarity contract, so a
1-ulp drift changes which parents a client approves and therefore the DAG
topology.  The kernel emits exact per-channel counts; ``signature`` sums
them into buckets exactly, and both normalise with ``counts * r``, ``r``
the float32 reciprocal of the count of flags averaged: the same
multiply-by-reciprocal the reference applies, so the port's signatures
equal the reference's bit for bit.  Neither ``torch.mean`` nor a division
reproduces those bits.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.flash_attention import flash_attention_bhsd
from repro_torch.kernels.mlstm import mlstm_chunkwise_bshd
from repro_torch.kernels.selective_scan import selective_scan_bsd
from repro_torch.kernels.signature import _reciprocal, signature_counts
from repro_torch.kernels.slstm import slstm_scan_bsd


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = -1,
                    softcap: float = 0.0) -> torch.Tensor:
    """(B,S,H,hd) layout wrapper used by ``models.attention``.  The kernel
    takes the (B,H,S,hd) views through their strides: nothing is copied,
    and on the card the output is a contiguous (B,S,H,hd) tensor."""
    out = flash_attention_bhsd(q.transpose(1, 2), k.transpose(1, 2),
                               v.transpose(1, 2), causal=causal,
                               window=window, softcap=softcap)
    return out.transpose(1, 2)


def selective_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                   Bc: torch.Tensor, Cc: torch.Tensor, h0: torch.Tensor):
    """Drop-in for ``models.mamba.selective_scan_ref``: x, dt (B,S,d_in),
    A (d_in,N), Bc, Cc (B,S,N), h0 (B,d_in,N), float32 -> (y, h_last).
    The reference's ``chunk`` is its TPU tiling and does not change the
    result, so there is none here."""
    return selective_scan_bsd(x, dt, A, Bc, Cc, h0)


def _bucket_sums(counts: torch.Tensor, n_sig: int):
    """Per-channel counts (..., d) -> (exact bucket sums (..., n_sig), the
    bucket width w): zero-padded tail channels (``d % n_sig != 0``) add
    zero counts."""
    pad = (-counts.shape[-1]) % n_sig
    if pad:
        counts = F.pad(counts, (0, pad))
    w = counts.shape[-1] // n_sig
    return counts.unflatten(-1, (n_sig, w)).sum(dim=-1), w


def signature(x: torch.Tensor, *, tau: float = 0.05,
              n_sig: int = 64) -> torch.Tensor:
    """Activation (..., d) -> bucketed Eq. 3 signature vector (n_sig,).

    The kernel counts flags per channel over ``x.reshape(-1, d)`` in one
    ``(1, T, d)`` call; exact bucket sums are scaled by the float32
    reciprocal of ``T * w``.  Bit-identical to
    ``models.layers.activation_signature``.
    """
    flat = x.reshape(-1, x.shape[-1])
    return signature_of_counts(signature_counts(flat[None], tau)[0],
                               flat.shape[0], n_sig=n_sig)


def signature_of_counts(counts: torch.Tensor, rows: int, *,
                        n_sig: int = 64) -> torch.Tensor:
    """The bucketed signature (n_sig,) of exact per-channel flag
    ``counts`` (d,) over ``rows`` rows: :func:`signature` after its
    kernel call."""
    sums, w = _bucket_sums(counts, n_sig)
    return sums * _reciprocal(rows * w)


def signature_buckets(h: torch.Tensor, *, tau: float = 0.05,
                      n_sig: int = 64):
    """Per-sample bucketed Eq. 3 counts of ``h`` (B, S, d): (exact bucket
    sums (B, n_sig), the float32 reciprocal of ``S * w`` that makes them
    fractions).  One launch of the kernel over ``h`` as (B, S, d)."""
    sums, w = _bucket_sums(signature_counts(h, tau), n_sig)
    return sums, _reciprocal(h.shape[1] * w)


def signature_per_sample(h: torch.Tensor, *, tau: float = 0.05,
                         n_sig: int = 64) -> torch.Tensor:
    """Per-sample Eq. 3 signature rows (B, n_sig) of ``h`` (B, S, d): each
    row the bits of ``signature`` on that sample alone."""
    sums, scale = signature_buckets(h, tau=tau, n_sig=n_sig)
    return sums * scale


def signature_per_channel(x: torch.Tensor, *, tau: float = 0.0
                          ) -> torch.Tensor:
    """Per-sample per-channel threshold fractions: (N, ..., C) -> (N, C).

    The CNN's Eq. 3 rows: for each sample the fraction of exact zeros
    (ReLU kill rate) over the spatial axes, per channel.  Channels-last
    activations reshape to ``(N, HW, C)`` without a copy.
    """
    flat = x.reshape(x.shape[0], -1, x.shape[-1])
    return signature_counts(flat, tau) * _reciprocal(flat.shape[1])


def slstm_scan(gates_x: torch.Tensor, R: torch.Tensor, c0: torch.Tensor,
               n0: torch.Tensor, h0: torch.Tensor, m0: torch.Tensor):
    """The sLSTM recurrence (inference path): gates_x (B,S,4d), R (d,4d),
    states (B,d), float32 -> (hs (B,S,d), (c, n, h, m)).  The reference's
    ``chunk`` is its TPU tiling and does not change the result, so there is
    none here."""
    return slstm_scan_bsd(gates_x, R, c0, n0, h0, m0)


def mlstm_chunkwise(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    i_gate: torch.Tensor, f_gate: torch.Tensor, *,
                    chunk: int = 128, h_dtype: torch.dtype = None):
    """Chunkwise mLSTM from a fresh state (inference path): q, k
    (B,S,H,dk), v (B,S,H,dv), gates (B,S,H) -> (h (B,S,H,dv), {C, n, m}).
    ``h`` comes in ``h_dtype``, by default ``q.dtype`` as the reference's;
    the kernel computes it in float32."""
    h, state = mlstm_chunkwise_bshd(q, k, v, i_gate, f_gate, chunk=chunk)
    return h.to(h_dtype or q.dtype), state

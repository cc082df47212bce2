"""Model-facing wrappers over the port's kernels (port of
``repro.kernels.ops``).

There is no policy layer: the tensor's device decides.  A CPU tensor takes
a kernel's plain version, a CUDA tensor the kernel.

Bit-stability contract for ``signature_per_channel``: the Eq. 3 signatures
feed tip selection through the similarity contract, so a 1-ulp drift
changes which parents a client approves and therefore the DAG topology.
The kernel emits exact per-channel counts, and they are normalised with
``counts * r``, ``r`` the float32 reciprocal of the spatial size: the
same multiply-by-reciprocal the reference applies, so the port's
signatures equal the reference's bit for bit.  Neither ``torch.mean`` nor
a division reproduces those bits.  The bucketed ``ops.signature`` of the
LM path is not ported yet.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels.signature import signature_counts


def signature_per_channel(x: torch.Tensor, *, tau: float = 0.0
                          ) -> torch.Tensor:
    """Per-sample per-channel threshold fractions: (N, ..., C) -> (N, C).

    The CNN's Eq. 3 rows: for each sample the fraction of exact zeros
    (ReLU kill rate) over the spatial axes, per channel.  Channels-last
    activations reshape to ``(N, HW, C)`` without a copy.
    """
    flat = x.reshape(x.shape[0], -1, x.shape[-1])
    r = np.float32(1) / np.float32(flat.shape[1])
    return signature_counts(flat, tau) * float(r)

"""Device meshes (port of ``repro.launch.mesh``).

A :class:`Mesh` is an array of ``torch.device``s with one name per axis,
the counterpart of ``jax.sharding.Mesh``.  The port runs one controller,
as the reference does: one Python process drives every device of the
mesh, each client group (and, on a 2-D cohort mesh, each data slice)
runs the single-device program on its own device, and a sum across
devices (the reference's ``lax.psum``) is an explicit sum of the partial
terms in a fixed order.

The builders take the devices from ``devices=``: a list, which may repeat
one device (``[torch.device("cpu")] * 4`` is the counterpart of
``XLA_FLAGS=--xla_force_host_platform_device_count=4``; the groups then
run one after another on that device).  Without ``devices=`` they take
the visible CUDA cards, and raise where CUDA is absent, as
``runtime.resolve_device`` does: a mesh on the CPU has to be asked for.

Single pod: (16, 16) = 256 chips, axes ("data", "model").  Multi-pod:
(2, 16, 16) = 512 chips, axes ("pod", "data", "model"); the "pod" axis
joins "data" for batch and FSDP sharding.  The dry run builds these over
``meta`` devices (``launch.dryrun``).
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Optional, Sequence

import numpy as np
import torch


class Mesh:
    """``devices`` (an array of ``torch.device``, one dimension per axis)
    with ``axis_names``; ``shape`` maps each name to its size, in order."""

    def __init__(self, devices, axis_names: Sequence[str]):
        self.devices = np.frompyfunc(torch.device, 1, 1)(
            np.asarray(devices, dtype=object)).astype(object)
        self.axis_names = tuple(axis_names)
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(f"{self.devices.ndim}-D devices for axes "
                             f"{self.axis_names}")

    @property
    def shape(self) -> "OrderedDict[str, int]":
        return OrderedDict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def __repr__(self) -> str:
        return f"Mesh({dict(self.shape)}, {sorted(set(map(str, self.devices.flat)))})"


def _devices(devices: Optional[Sequence]) -> list:
    """``devices`` as ``torch.device``s, or the visible CUDA cards."""
    if devices is not None:
        return [torch.device(d) for d in devices]
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: pass devices=[...] "
                           "(e.g. [torch.device('cpu')] * 4) for a mesh on "
                           "the CPU")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_production_mesh(*, multi_pod: bool = False, devices=None) -> Mesh:
    """The (16, 16) or (2, 16, 16) production mesh; raises when fewer
    devices are given or visible."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = int(np.prod(shape))
    devs = _devices(devices)
    if len(devs) < n:
        raise RuntimeError(
            f"need {n} devices, found {len(devs)}; the dry run builds the "
            "mesh over meta devices (devices=[torch.device('meta')] * n)")
    return Mesh(np.asarray(devs[:n], dtype=object).reshape(shape), axes)


def make_host_mesh(data: int = 1, model: int = 1, strict: bool = True,
                   devices=None) -> Mesh:
    """Small (data, model) mesh over the devices there are (tests).

    ``strict=False`` degrades instead of raising: the ``data`` axis shrinks
    first (the ``model`` axis is kept while it fits); a ``model`` axis
    larger than the host shrinks too."""
    devs = _devices(devices)
    avail = len(devs)
    if data * model > avail:
        if strict:
            raise RuntimeError(f"need {data * model} devices, have {avail}")
        model = min(model, avail)
        data = max(avail // model, 1)
    arr = np.asarray(devs[:data * model], dtype=object).reshape(data, model)
    return Mesh(arr, ("data", "model"))


def make_cohort_mesh(n_clients: int, axis: str = "clients", data: int = 1,
                     data_axis: str = "data", devices=None) -> Mesh:
    """Client-axis mesh for the cohort engine, clamped to the devices there
    are: it never raises for lack of them.

    ``data=1`` builds the 1-D ``(clients,)`` mesh; ``data=D`` the 2-D
    ``(clients, data)`` mesh, on which each client group's training batch
    additionally splits ``D`` ways (``repro_torch.fl.cohort``).  The data
    axis shrinks to the devices first, then the clients axis to what
    remains, so one device always gives a one-device 1-D mesh, which the
    cohort engine treats as no mesh."""
    devs = _devices(devices)
    avail = len(devs)
    d = max(1, min(int(data), avail))
    c = max(1, min(int(n_clients), avail // d))
    if d == 1:
        # the 1-D mesh carries no size-1 data axis
        return Mesh(np.asarray(devs[:c], dtype=object).reshape(c), (axis,))
    return Mesh(np.asarray(devs[:c * d], dtype=object).reshape(c, d),
                (axis, data_axis))


# NVIDIA H100 SXM published peaks (data sheet, dense, at 700 W): the dry
# run's roofline constants
PEAK_FLOPS_BF16 = 989e12        # FLOP/s per card, bf16 tensor cores
HBM_BW = 3.35e12                # bytes / s per card
NVLINK_BW = 450e9               # bytes / s per card, each way

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

:func:`dtensor_mesh` is a second use of a mesh: a DTensor ``DeviceMesh``
of the same axes and shape over a ``"fake"`` process group of one rank
(rank 0) among ``mesh.size``, on the CPU.  No collective moves data, so
the dry run counts the sharded program of one chip without the chips.

:func:`run_on_chips` is the third: the same ``DeviceMesh`` over torch's
threaded process group, one thread a chip, each chip's blocks on its
entry of ``mesh.devices``, and collectives that move data between the
threads.  It runs the sharded step with values, the counterpart of the
reference's one controller driving its forced host devices.
"""
from __future__ import annotations

import contextlib
import inspect
import itertools
import threading
import time
from collections import OrderedDict
from typing import Callable, Optional, Sequence

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


def _device_mesh(mesh: Mesh, device_type: str):
    """The ``DeviceMesh`` of ``mesh``'s axis names and shape over the
    process group this thread has initialised, with the flattened meshes
    of every two or more of its axes made: one collective over several
    axes runs on one of them (``sharding.dtensor``), and a group is made
    by every rank at once, here, not inside a step."""
    from torch.distributed.device_mesh import init_device_mesh
    dmesh = init_device_mesh(device_type, tuple(mesh.devices.shape),
                             mesh_dim_names=mesh.axis_names)
    for n in range(2, dmesh.ndim + 1):
        for names in itertools.combinations(mesh.axis_names, n):
            dmesh[names]._flatten()
    return dmesh


@contextlib.contextmanager
def dtensor_mesh(mesh: Mesh):
    """A ``torch.distributed.device_mesh.DeviceMesh`` with ``mesh``'s axis
    names and shape, over a ``"fake"`` process group of ``mesh.size``
    ranks (this process is rank 0), on device type ``"cpu"``, with the
    flattened meshes of its axes made: the group is initialised on entry
    and destroyed on exit.  Raises if a process group is already
    initialised."""
    import torch.distributed as dist
    # registers the "fake" backend
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("a process group is already initialised")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=mesh.size)
    try:
        yield _device_mesh(mesh, "cpu")
    finally:
        dist.destroy_process_group()


class _Turns:
    """One chip thread runs at a time, and hands its turn on where it
    waits for the others (a collective, a group's store barrier).  Each
    torch operation lets go of the GIL, so eight threads that all run
    would pass it back and forth at every operation, at about ten times
    the cost of running one after another; one card runs the chips'
    kernels one after another on its stream anyway."""

    def __init__(self):
        self.lock = threading.Lock()
        self.holder = threading.local()

    @contextlib.contextmanager
    def turn(self):
        self.lock.acquire()
        self.holder.held = True
        try:
            yield
        finally:
            self.holder.held = False
            self.lock.release()

    def waiting(self, wait):
        """``wait`` made to give the turn up while it blocks."""
        def run(*args, **kwargs):
            if not getattr(self.holder, "held", False):
                return wait(*args, **kwargs)
            self.holder.held = False
            self.lock.release()
            try:
                return wait(*args, **kwargs)
            finally:
                self.lock.acquire()
                self.holder.held = True
        return run


# the torch internals the turns wrap, by the leading parameters they are
# known by: a torch that renames or reshapes one fails here, not in a run
# whose threads wait on a wait that no longer gives the turn up
_WAIT_PARAMS = {"join": ("self", "rank", "data"),
                "_store_based_barrier": ("rank", "store", "group_name")}


def _blocking_wait(owner, attr: str):
    """``owner.attr``, checked to be the blocking wait it is known as."""
    fn = getattr(owner, attr, None)
    want = _WAIT_PARAMS[attr]
    got = (tuple(inspect.signature(fn).parameters)[:len(want)]
           if callable(fn) else None)
    if got != want:
        raise RuntimeError(f"torch {torch.__version__}: "
                           f"{getattr(owner, '__name__', owner)}.{attr} is "
                           f"not the blocking wait that run_on_chips wraps "
                           f"(parameters {got}, expected {want})")
    return fn


@contextlib.contextmanager
def _threaded_world():
    """Torch's threaded process group installed for this process (each
    thread its own world and group registry), the threads taking turns
    (:class:`_Turns`, yielded: DTensor's sharding propagation is not
    thread-safe, and runs in one thread at a time), the models' step
    loops unfolded (a count's fold is process-wide, and a run with values
    steps through them), and all of it undone on exit."""
    import torch.distributed as dist
    from torch.testing._internal.distributed import multi_threaded_pg

    from repro_torch.models import layers

    if dist.is_initialized():
        raise RuntimeError("a process group is already initialised")
    c10d = torch._C._distributed_c10d
    fold = layers.LOOP_FOLD
    turns = _Turns()
    waits = [(multi_threaded_pg.Collective, "join"),
             (multi_threaded_pg, "_store_based_barrier"),
             (dist.distributed_c10d, "_store_based_barrier")]
    blocking = [_blocking_wait(owner, attr) for owner, attr in waits]
    if not hasattr(c10d, "_set_thread_isolation_mode"):
        raise RuntimeError(f"torch {torch.__version__} has no c10d "
                           "_set_thread_isolation_mode")
    c10d._set_thread_isolation_mode(True)
    world = type(multi_threaded_pg._install_threaded_pg())
    # some versions' c10d reads the world's ``comms``, which their
    # threaded world lacks: each thread's own, empty
    lacks_comms = not hasattr(world, "comms")
    if lacks_comms:
        world.comms = property(
            lambda self: self._get_world().__dict__.setdefault("comms", []))
    for (owner, attr), wait in zip(waits, blocking):
        setattr(owner, attr, turns.waiting(wait))
    layers.LOOP_FOLD = None
    try:
        yield multi_threaded_pg.ProcessLocalGroup, turns
    finally:
        layers.LOOP_FOLD = fold
        for (owner, attr), wait in zip(waits, blocking):
            setattr(owner, attr, wait)
        multi_threaded_pg.ProcessLocalGroup.reset()
        multi_threaded_pg._uninstall_threaded_pg()
        if lacks_comms:
            del world.comms
        c10d._set_thread_isolation_mode(False)


def run_on_chips(fn: Callable, mesh: Mesh, timeout: float = 600.0) -> list:
    """``fn(dmesh)`` on every chip of ``mesh``, one thread a chip: each
    thread is one rank of torch's threaded process group over
    ``mesh.size`` ranks, ``dmesh`` the ``DeviceMesh`` that
    :func:`dtensor_mesh` makes (axis names, shape, flattened meshes), and
    its collectives move data between the threads.  Rank ``r``'s device
    (``torch.cuda.set_device`` on a card) is ``mesh.devices.flat[r]``;
    every device of the mesh is of one type.  Returns every rank's
    result, in rank order.

    The threads take turns (:class:`_Turns`): one runs ``fn`` until it
    waits in a collective, so module-level counts (the kernels' launch
    counters) add up.  Each thread starts in the caller's grad mode.  An
    exception in any thread fails the call (the others, waiting in a
    collective, are woken and stop), and so does a thread still running
    ``timeout`` seconds after the start.  No process group is left
    initialised afterwards.  Raises if one is initialised before."""
    import torch.distributed as dist

    devices = list(mesh.devices.flat)
    kinds = {d.type for d in devices}
    if len(kinds) != 1:
        raise ValueError(f"a mesh of one device type, got {sorted(kinds)}")
    device_type = kinds.pop()
    n = mesh.size
    grad = torch.is_grad_enabled()
    results: list = [None] * n
    errors: list = []
    with _threaded_world() as (group, turns):
        store = dist.HashStore()

        def chip(rank: int) -> None:
            try:
                dist.init_process_group("threaded", rank=rank, world_size=n,
                                        store=store)
                try:
                    if device_type == "cuda":
                        torch.cuda.set_device(devices[rank])
                    dmesh = _device_mesh(mesh, device_type)
                    with turns.turn(), torch.set_grad_enabled(grad):
                        results[rank] = fn(dmesh)
                finally:
                    dist.destroy_process_group()
            except BaseException as exc:   # noqa: BLE001 -- reported below
                errors.append((rank, exc))
                group.exception_handle(exc)

        threads = [threading.Thread(target=chip, args=(r,), daemon=True,
                                    name=f"chip-{r}") for r in range(n)]
        for t in threads:
            t.start()
        deadline = time.monotonic() + timeout
        for t in threads:
            t.join(max(deadline - time.monotonic(), 0.0))
        late = [r for r, t in enumerate(threads) if t.is_alive()]
        if late:
            group.exception_handle(TimeoutError())
            for t in threads:
                t.join(5.0)
    if late:
        raise TimeoutError(f"chips {late} still running after {timeout} s")
    # the first failure, not the exits it caused in the other threads
    failures = sorted((r, e) for r, e in errors
                      if not isinstance(e, SystemExit)) or sorted(errors)
    if failures:
        rank, exc = failures[0]
        raise RuntimeError(f"chip {rank} of {n} failed: "
                           f"{type(exc).__name__}: {exc}") from exc
    return results


# NVIDIA H100 SXM published peaks (data sheet, dense, at 700 W): the dry
# run's roofline constants
PEAK_FLOPS_BF16 = 989e12        # FLOP/s per card, bf16 tensor cores
HBM_BW = 3.35e12                # bytes / s per card
HBM_BYTES = 80e9                # bytes of HBM per card
NVLINK_BW = 450e9               # bytes / s per card, each way

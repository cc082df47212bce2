"""Operation-by-operation cost count of eager PyTorch programs (the port's
counterpart of ``repro.launch.hlo_analysis``).

The reference parses the compiled HLO and multiplies each loop body by
its trip count.  The port has no compiled program: :class:`CostCount` is a
``TorchDispatchMode`` that sees every ATen operation as it runs, so a
Python loop counts each of its steps, and autograd's backward and
``torch.utils.checkpoint``'s recompute are counted as they run.  Under
``FakeTensorMode`` nothing is allocated or computed, so full-size models
are counted on the CPU.

The cost model is the reference's (matmul-centric, a TPU-style roofline):
  flops : a matrix product is 2 * prod(result) * contraction; a
          convolution 2 * prod(result) * prod(kernel spatial) *
          in_channels / groups (its backward, the products it makes);
          elementwise operations are ignored.
  bytes : operands and result of each product and convolution; the result
          of each gather (embedding lookups, indexing), of each indexed
          select (the counterpart of a ``dynamic-slice``: a layer's weights
          out of a stacked tree, a step's slice of a scanned input), of each
          reduction and scatter; and twice the bytes written by each copy
          into a view or indexed write (a cache update read and written).
          Views, elementwise chains and dtype casts carry no bytes.
  colls : the result bytes of each collective, by the reference's kind
          (``all-reduce``, ``all-gather``, ``reduce-scatter``,
          ``all-to-all``, ``collective-permute``: the port's
          ``repro_torch.collective_permute``, the blocks a fused
          projection's halves move, ``sharding.dtensor.halves``).

Sharded programs (``launch.dryrun``): on DTensors over a fake process
group the mode steps aside for each DTensor operation, so DTensor picks
its sharding and redistributions and the mode sees what one chip runs:
the local operations on the local shards and the functional collectives
(``_c10d_functional``; the ``wait_tensor`` that completes each is not
counted again).  Two things DTensor does are kept out of the count: the
fake runs at global shapes its sharding propagator makes to infer each
output's metadata (cached per schema, so counting them would make the
count depend on the cache), and the all-gather and chunk that stand in
for an all-to-all on a CPU mesh (Gloo has none): the count takes the
all-to-all that a mesh of cards runs.

Memory: the mode keeps the bytes of the storages created inside it that
are still alive (autograd's saved tensors included) and their peak,
``peak_bytes``: the counterpart of XLA's ``temp_size_in_bytes``, though
eager frees as references drop, not by XLA's buffer assignment.

Step loops (``models.mamba``, ``models.xlstm``, through
``models.layers.step_loop``) are folded while a count runs, which sets
``layers.LOOP_FOLD`` to :func:`folded`: the loop runs for two and for
three steps, forward and, in the backward, backward, and the count adds
the difference for every further step.  Every count is affine in the
steps, so the folded count equals the step-by-step one; outputs take the
full shape, copies of the first step, which costs nothing under fake
tensors.  The live bytes are affine from the second step on (each step
replaces the state the one before made), and are extrapolated the same
way.  On tensors that hold values, and outside a count, the loop runs as
it is.
"""
from __future__ import annotations

import contextlib
import gc
import weakref
from collections import Counter

import numpy as np
import torch
from torch._subclasses.fake_tensor import is_fake
from torch.utils._python_dispatch import (TorchDispatchMode,
                                          _get_current_dispatch_mode_stack)

from repro_torch.models import layers

try:
    from torch.distributed.tensor import DTensor as _DTensor
except ImportError:          # a build of torch without torch.distributed
    _DTensor = None

aten = torch.ops.aten

_MM = {aten.mm.default, aten.addmm.default, aten.bmm.default,
       aten.baddbmm.default}
_CONV = {aten.convolution.default}
_CONV_BACKWARD = {aten.convolution_backward.default}
_RESULT_BYTES = {
    # gathers
    aten.embedding.default, aten.index.Tensor, aten.gather.default,
    aten.index_select.default, aten.take_along_dim.default,
    # indexed selects (dynamic slices)
    aten.select.int,
    # reductions
    aten.sum.default, aten.sum.dim_IntList, aten.mean.default,
    aten.mean.dim, aten.amax.default, aten.amin.default,
    aten.max.default, aten.max.dim, aten.min.dim, aten.logsumexp.default,
    aten.prod.dim_int, aten.var_mean.correction, aten.cumsum.default,
    # scatters
    aten.scatter.src, aten.scatter.value, aten.scatter_add.default,
    aten.index_add.default, aten.index_put.default,
}
# functional collectives by the reference's kind names (prefixes of the
# op names of ``_c10d_functional``, its autograd twin, ``_dtensor`` and the
# port's own, ``repro_torch.collective_permute``)
_COLLECTIVE_KINDS = (("all_reduce", "all-reduce"),
                     ("all_gather", "all-gather"),
                     ("reduce_scatter", "reduce-scatter"),
                     ("all_to_all", "all-to-all"),
                     ("shard_dim_alltoall", "all-to-all"))
_COLLECTIVE_NAMESPACES = {"_c10d_functional", "_c10d_functional_autograd",
                          "_dtensor", "repro_torch"}
_UPDATES = {aten.copy_.default, aten.index_put_.default,
            aten.scatter_.src, aten.scatter_.value, aten.index_copy_.default}


def _nbytes(t) -> int:
    if isinstance(t, torch.Tensor):
        return t.numel() * t.element_size()
    if isinstance(t, (list, tuple)):
        return sum(_nbytes(x) for x in t)
    return 0


_COMPOSITE: dict = {}


def _composite(func) -> bool:
    """Whether ``func`` is an ATen operation made of others (``matmul``,
    ``einsum``), which reaches the mode whole under inference mode."""
    known = _COMPOSITE.get(func)
    if known is None:
        known = _COMPOSITE[func] = (
            func.namespace == "aten"
            and torch._C._dispatch_has_kernel_for_dispatch_key(
                func.name(), torch._C.DispatchKey.CompositeImplicitAutograd))
    return known


# storages a count tracks between its garbage-collector passes
_COLLECT_EVERY = 10_000


def _collective_kind(func):
    """The reference's kind of a functional collective, else None (also
    for ``wait_tensor``, which completes one)."""
    if func.namespace not in _COLLECTIVE_NAMESPACES:
        return None
    name = func._opname
    if name == "wait_tensor":
        return None
    if "permute" in name:
        return "collective-permute"
    for prefix, kind in _COLLECTIVE_KINDS:
        if name.startswith(prefix):
            return kind
    return None


def _partial(dst: torch.Tensor) -> bool:
    """Whether ``dst`` is part of a larger buffer (a write into it updates
    a slice, as a cache update does)."""
    return dst.numel() * dst.element_size() < dst.untyped_storage().nbytes()


def _numel(shape) -> float:
    return float(np.prod([int(d) for d in shape])) if len(shape) else 1.0


def _mm_flops(func, args, out) -> float:
    """2 * prod(result) * contraction of a (batched) matrix product."""
    a = args[1] if func in (aten.addmm.default, aten.baddbmm.default) \
        else args[0]
    return 2.0 * _numel(out.shape) * int(a.shape[-1])


def _conv_flops(out_shape, weight) -> float:
    """2 * prod(result) * prod(kernel spatial) * in_channels / groups, with
    ``weight`` (cout, cin / groups, *spatial)."""
    return 2.0 * _numel(out_shape) * _numel(weight.shape[1:])


class CostCount(TorchDispatchMode):
    """Counts ``flops`` and ``bytes`` of every operation run inside it,
    ``ops``, the operations by name, ``colls``, the collectives' result
    bytes by kind, and ``peak_bytes``, the most bytes that storages
    created inside it held at once.  Enter it inside ``FakeTensorMode`` to
    count shapes only."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.bytes = 0.0
        self.ops: Counter = Counter()
        self.colls: Counter = Counter()
        self.live_bytes = 0
        self.peak_bytes = 0
        self._live: dict = {}          # storage -> its bytes, while alive
        self._paused = 0
        self._untracked = 0
        self._depth = 0
        self._holds = 0
        self._hooks = None

    @property
    def collective_bytes(self) -> float:
        return float(sum(self.colls.values()))

    def __enter__(self):
        # DTensor re-enters the modes on the stack: the hooks go in at the
        # outermost entry and come out at its exit
        if self._depth == 0:
            self._hooks = contextlib.ExitStack()
            self._hooks.enter_context(_dtensor_hooks())
            self._hooks.enter_context(_no_cycle_collection())
            self._hooks.enter_context(_loops_folded())
        self._depth += 1
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            self._depth -= 1
            if self._depth == 0:
                self._hooks.close()

    @contextlib.contextmanager
    def paused(self, memory: bool = False):
        """Operations run inside this do not count, and with ``memory``
        False take no memory either."""
        self._paused += 1
        self._untracked += not memory
        try:
            yield
        finally:
            self._paused -= 1
            self._untracked -= not memory

    def _free(self, key) -> None:
        self.live_bytes -= self._live.pop(key)

    def hold(self, t, nbytes: int) -> None:
        """Counts ``nbytes`` live while ``t``'s storage is."""
        self._holds += 1
        if self._holds % _COLLECT_EVERY == 0:
            gc.collect()           # frees the storages cycles hold
        st = t.untyped_storage()
        self._live[st._cdata] = nbytes
        self.live_bytes += nbytes
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        weakref.finalize(st, self._free, st._cdata)

    def release(self, t) -> None:
        """Counts ``t``'s storage as freed now."""
        key = t.untyped_storage()._cdata
        self.live_bytes -= self._live.get(key, 0)
        if key in self._live:
            self._live[key] = 0

    def track(self, out, args=()) -> None:
        """Adds the storages of ``out`` that are new (in no tensor of
        ``args``) to the live bytes, until each is freed."""
        inputs = None
        for t in _tensors(out):
            if t.layout != torch.strided:
                continue
            st = t.untyped_storage()
            key = st._cdata
            if key in self._live:
                continue
            if inputs is None:
                inputs = {a.untyped_storage()._cdata for a in _tensors(args)
                          if a.layout == torch.strided}
            if key in inputs:
                continue
            self.hold(t, st.nbytes())

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if self._paused:
            out = func(*args, **kwargs)
            if not self._untracked:
                self.track(out, (args, kwargs))
            return out
        # a DTensor operation: DTensor shards it, and its local operations
        # and collectives come back through this mode
        if _DTensor is not None and any(issubclass(t, _DTensor)
                                        for t in types):
            return NotImplemented
        # under inference mode composite operations (matmul, einsum) arrive
        # whole: count the operations they are made of
        if _composite(func):
            with self:             # the parts come back through this mode
                return func.decompose(*args, **kwargs)
        out = func(*args, **kwargs)
        self.ops[func.__name__] += 1
        self.track(out, (args, kwargs))
        if func in _MM:
            self.flops += _mm_flops(func, args, out)
            self.bytes += _nbytes(list(args)) + _nbytes(out)
        elif func in _CONV:
            self.flops += _conv_flops(out.shape, args[1])
            self.bytes += _nbytes(list(args[:3])) + _nbytes(out)
        elif func in _CONV_BACKWARD:
            grad_out, x, weight = args[0], args[1], args[2]
            mask = args[-1]
            # the input gradient (a transposed convolution) and the weight
            # gradient each cost the forward's products
            self.flops += _conv_flops(grad_out.shape, weight) * (
                int(mask[0]) + int(mask[1]))
            self.bytes += (_nbytes([grad_out, x, weight])
                           + _nbytes([o for o in out if o is not None]))
        elif func in _RESULT_BYTES:
            self.bytes += _nbytes(out)
        elif func in _UPDATES and _partial(args[0]):
            src = args[1] if func is aten.copy_.default else args[-1]
            self.bytes += 2 * _nbytes(src)
        else:
            kind = _collective_kind(func)
            if kind is not None:
                self.colls[kind] += _nbytes(out)
        return out


@contextlib.contextmanager
def _no_cycle_collection():
    """The garbage collector's own cycle passes held off: storages kept
    by a reference cycle are freed when it runs, at moments that vary
    from run to run, so the live bytes and their peak would too.  The
    count runs a pass itself every ``_COLLECT_EVERY`` storages instead, at
    the same points every run."""
    enabled = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if enabled:
            gc.enable()


@contextlib.contextmanager
def _loops_folded():
    """The models' step loops folded (``layers.step_loop``) while the
    count runs."""
    before = layers.LOOP_FOLD
    layers.LOOP_FOLD = folded
    try:
        yield
    finally:
        layers.LOOP_FOLD = before


def _tensors(tree):
    return [t for t in torch.utils._pytree.tree_leaves(tree)
            if isinstance(t, torch.Tensor)]


def active_count():
    """The innermost :class:`CostCount` that is counting, else None."""
    for mode in reversed(_get_current_dispatch_mode_stack()):
        if isinstance(mode, CostCount):
            return mode
    return None


def _shard_dim_alltoall(input, gather_dim, shard_dim, mesh, mesh_dim):
    """DTensor's all-to-all between two shard dims as a mesh of cards runs
    it: the one ``_dtensor.shard_dim_alltoall`` operation (on a CPU mesh
    DTensor gathers and chunks instead)."""
    return torch.ops._dtensor.shard_dim_alltoall(
        input, gather_dim, shard_dim, mesh.get_group(mesh_dim).group_name)


@contextlib.contextmanager
def _dtensor_hooks():
    """While a count runs: DTensor's sharding propagation is paused in
    every count (its strategies trace decompositions on meta tensors and
    run each operation at global shapes for the output's metadata), and
    its all-to-all takes :func:`_shard_dim_alltoall`.  Nested counts
    install them once."""
    if _DTensor is None:
        yield
        return
    from torch.distributed.tensor import placement_types
    from torch.distributed.tensor._sharding_prop import ShardingPropagator

    names = ("propagate_op_sharding_non_cached",
             "_propagate_tensor_meta_non_cached")
    originals = {n: getattr(ShardingPropagator, n) for n in names}
    if any(getattr(f, "_paused_in_counts", False)
           for f in originals.values()):
        yield
        return

    def paused(fn):
        def run(self, op_schema):
            counts = [m for m in _get_current_dispatch_mode_stack()
                      if isinstance(m, CostCount)]
            with contextlib.ExitStack() as stack:
                for c in counts:
                    stack.enter_context(c.paused())
                return fn(self, op_schema)
        run._paused_in_counts = True
        return run

    alltoall = placement_types.shard_dim_alltoall
    for n, fn in originals.items():
        setattr(ShardingPropagator, n, paused(fn))
    placement_types.shard_dim_alltoall = _shard_dim_alltoall
    try:
        yield
    finally:
        for n, fn in originals.items():
            setattr(ShardingPropagator, n, fn)
        placement_types.shard_dim_alltoall = alltoall


# -- folded step loops -------------------------------------------------------


def _snapshot(c: CostCount) -> tuple:
    return c.flops, c.bytes, Counter(c.ops), Counter(c.colls)


def _extrapolate(c: CostCount, s0, s2, s3, n: int) -> None:
    """Sets ``c`` to ``s0 + d2 + (n - 2) * (d3 - d2)`` with ``d2 = s2 - s0``
    (two steps) and ``d3 = s3 - s2`` (three steps): the count of ``n``
    steps, each count affine in the steps."""
    def fold(a, b, z):
        return a + (b - a) + (n - 2) * ((z - b) - (b - a))

    c.flops = fold(s0[0], s2[0], s3[0])
    c.bytes = fold(s0[1], s2[1], s3[1])
    for attr, i in (("ops", 2), ("colls", 3)):
        keys = set(s0[i]) | set(s2[i]) | set(s3[i])
        setattr(c, attr, +Counter({k: fold(s0[i][k], s2[i][k], s3[i][k])
                                   for k in keys}))


def _first(c: CostCount, xs, seq, k: int, needs) -> list:
    """The inputs cut to their first ``k`` steps (dim 1 of those marked in
    ``seq``), detached, tracking a gradient where ``needs`` says."""
    with c.paused():
        out = []
        for x, s, nd in zip(xs, seq, needs):
            if isinstance(x, torch.Tensor):
                x = (x[:, :k] if s else x).detach().requires_grad_(nd)
            out.append(x)
        return out


def _widen(c: CostCount, ys, seq, n: int) -> tuple:
    """``ys`` with each output marked in ``seq`` given ``n`` steps on dim
    1 (a copy of its first step), new storage counted as live."""
    out = []
    with c.paused(), torch.no_grad():
        for y, s in zip(ys, seq):
            if y is None:
                out.append(y)
                continue
            if s:
                shape = list(y.shape)
                shape[1] = n
                y = y[:, :1].expand(shape).contiguous()
            out.append(y.detach())
    c.track([y for y in out if y is not None])
    return tuple(out)


def _measure(count: CostCount, n: int, attempt):
    """``attempt(k)`` for ``k`` = 2 and 3 steps, the count set to ``n``
    steps'.  Returns (the three-step result, the bytes kept after it
    above those live at its start, extrapolated to ``n`` steps); the
    peak takes the bytes live during it, extrapolated too.  From the
    second step on each step carries the state the one before made, so
    memory is affine from two steps (counts from one).  The two-step
    result is dropped before the three-step attempt runs."""
    s0 = _snapshot(count)
    live0, peak0 = count.live_bytes, count.peak_bytes
    rise, kept = [], []
    for k in (2, 3):
        count.peak_bytes = count.live_bytes
        out = attempt(k)
        rise.append(count.peak_bytes - live0)
        kept.append(count.live_bytes - live0)
        if k == 2:
            s2 = _snapshot(count)
            del out
    s3 = _snapshot(count)
    _extrapolate(count, s0, s2, s3, n)
    count.peak_bytes = max(peak0, live0 + rise[0]
                           + (n - 2) * (rise[1] - rise[0]))
    return out, live0 + kept[0] + (n - 2) * (kept[1] - kept[0])


class _Fold(torch.autograd.Function):
    """``run`` over ``n`` steps, counted from two and three (forward here,
    backward in :meth:`backward`).  Memory: the bytes the steps would
    keep for the backward beyond what the fold keeps are held as a
    saved tensor until the backward, which runs the forward again,
    uncounted, so that its peak sees them freed as the steps' backward
    goes."""

    @staticmethod
    def forward(ctx, count, run, seq_in, seq_out, n, grad, *inputs):
        ctx.fold = (count, run, seq_in, seq_out, n)
        ctx.set_materialize_grads(False)   # an unused output has no grad
        needs = [grad and isinstance(x, torch.Tensor) and x.requires_grad
                 for x in inputs]
        with torch.set_grad_enabled(grad):
            ys, kept = _measure(count, n, lambda k: run(*_first(
                count, inputs, seq_in, k, needs)))
        out = _widen(count, ys, seq_out, n)
        del ys
        # what the steps would keep beyond the fold, as the bytes of an
        # empty meta tensor saved as they would be (a checkpoint drops it)
        with count.paused():
            held = torch.empty(0, dtype=torch.uint8, device="meta")
        count.hold(held, max(kept - count.live_bytes, 0))
        ctx.save_for_backward(held, *inputs)
        return out

    @staticmethod
    def backward(ctx, *grads):
        count, run, seq_in, seq_out, n = ctx.fold
        held, *inputs = ctx.saved_tensors
        count.release(held)
        needs = ctx.needs_input_grad[6:]

        def attempt(k):
            with torch.enable_grad():
                xs = _first(count, inputs, seq_in, k, needs)
                # the forward again, uncounted; what it keeps is live
                with count.paused(memory=True):
                    ys = run(*xs)
                    pairs = [(y, g[:, :k] if s else g)
                             for y, g, s in zip(ys, grads, seq_out)
                             if g is not None and y.requires_grad]
                return torch.autograd.grad(
                    [y for y, _ in pairs],
                    [x for x, nd in zip(xs, needs) if nd],
                    [g for _, g in pairs], allow_unused=True)

        got, _ = _measure(count, n, attempt)
        got = iter(_widen(count, got,
                          [s for s, nd in zip(seq_in, needs) if nd], n))
        return (None,) * 6 + tuple(next(got) if nd else None
                                   for nd in needs)


def folded(run, inputs, seq_in, seq_out):
    """``run(*inputs)``, a loop over dim 1 of the inputs marked in
    ``seq_in`` whose outputs marked in ``seq_out`` stack its steps on dim
    1: on fake tensors under a :class:`CostCount` counted from two steps
    and three and extrapolated to all of them (module docstring), else
    run as it is."""
    count = active_count()
    n = next(x.shape[1] for x, s in zip(inputs, seq_in) if s)
    tensors = [x for x in inputs if isinstance(x, torch.Tensor)]
    if count is None or n <= 3 or not all(is_fake(x) for x in tensors):
        return run(*inputs)
    return _Fold.apply(count, run, tuple(seq_in), tuple(seq_out), n,
                       torch.is_grad_enabled(), *inputs)


def count(fn, *args, **kwargs):
    """``fn(*args, **kwargs)`` under a :class:`CostCount`; returns (the
    result, the count)."""
    with CostCount() as cost:
        out = fn(*args, **kwargs)
    return out, cost

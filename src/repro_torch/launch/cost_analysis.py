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
"""
from __future__ import annotations

from collections import Counter

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

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
    """Counts ``flops`` and ``bytes`` of every operation run inside it, and
    ``ops``, the operations by name.  Enter it inside ``FakeTensorMode`` to
    count shapes only."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.bytes = 0.0
        self.ops: Counter = Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        # under inference mode composite operations (matmul, einsum) arrive
        # whole: count the operations they are made of
        if _composite(func):
            with self:             # the parts come back through this mode
                return func.decompose(*args, **kwargs)
        out = func(*args, **kwargs)
        self.ops[func.__name__] += 1
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
        return out


def count(fn, *args, **kwargs):
    """``fn(*args, **kwargs)`` under a :class:`CostCount`; returns (the
    result, the count)."""
    with CostCount() as cost:
        out = fn(*args, **kwargs)
    return out, cost

"""Model trees and their aggregation (paper Eq. 6).

A model is a tree of nested dicts, lists and tuples whose leaves are
tensors.  ``tree_map``/``tree_leaves`` walk it in JAX's order (dict keys
sorted, sequences in order), so a tree carried over from the reference
lists its leaves as ``jax.tree_util.tree_leaves`` does.

Eq. 6 is a plain average over the N selected tip models; ``tree_weighted``
is the beyond-paper generalisation (staleness- or accuracy-weighted).

Port of ``repro.core.aggregate``.  ``tree_mean`` reproduces the reference's
bits on the CPU: the leaves are summed left to right in float32 and the
sum is multiplied by the float32 reciprocal of N, which is what XLA makes
of the reference's ``sum / n``.  :func:`f32_mean` applies the same rule
to a tensor's mean, as XLA compiles the reference's ``jnp.mean``.

The stacked forms serve the cohort engine: K models kept as one tree whose
leaves carry a leading client axis (:func:`tree_stack`), aggregated over
that axis in one reduction.  Over a device mesh
(``repro_torch.launch.mesh``) the stacked axis is zero-padded and cut into
contiguous blocks, one a device of the clients axis (of both axes on a 2-D
cohort mesh); each device sums (or einsums) its block and the partials are
added on the mesh's first device in device order, the reference's
``shard_map`` + ``lax.psum``.  Probed on XLA:CPU with forced host devices
(jaxlib 0.9.0): its all-reduce adds the device partials left to right in
device order, and the reference's eager ``/ k`` after the psum is a true
division, so the mesh mean divides where the single-device mean
multiplies by the reciprocal.
"""
from __future__ import annotations

from typing import Callable, List, Sequence

import numpy as np
import torch


def tree_map(fn: Callable, *trees):
    """Apply ``fn`` leaf-wise over congruent trees."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: tree_map(fn, *(t[k] for t in trees))
                for k in sorted(first)}
    if isinstance(first, (list, tuple)):
        return type(first)(tree_map(fn, *leaves) for leaves in zip(*trees))
    return fn(*trees)


def tree_leaves(tree) -> List:
    """The leaves of ``tree`` in ``tree_map`` order."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in tree_leaves(v)]
    return [tree]


TREE_WINDOW = 32      # XLA:CPU's tree reduction splits longer sums


def ordered_sum(z: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """Float32 sum along ``dim``, adding the rows left to right."""
    rows = z.movedim(dim, 0)
    acc = rows[0]
    for row in rows[1:]:
        acc = acc + row
    return acc


def _negative_zeros(x: torch.Tensor, axis: int, n: int) -> torch.Tensor:
    """-0.0 of ``x``'s shape with ``n`` entries on ``axis``."""
    return torch.full(x.shape[:axis] + (n,) + x.shape[axis + 1:], -0.0,
                      dtype=x.dtype, device=x.device)


def window_sums(x: torch.Tensor, axes: int = 1) -> torch.Tensor:
    """One level of XLA:CPU's tree reduction over the leading ``axes`` axes
    of ``x``: each of those axes longer than 32 is padded in front with
    half the zeros that fill whole windows of 32 and cut into them, a
    shorter one is one window; the elements of each window are added in
    row-major order, giving one sum a window.  The padding is -0.0, which
    leaves every float32 sum as it was."""
    lead, rest = x.shape[:axes], x.shape[axes:]
    shape = []
    for i, n in enumerate(lead):
        if n <= TREE_WINDOW:
            shape += [1, n]
            continue
        pad = -n % TREE_WINDOW
        x = torch.cat([_negative_zeros(x, i, pad // 2), x,
                       _negative_zeros(x, i, pad - pad // 2)], dim=i)
        shape += [(n + pad) // TREE_WINDOW, TREE_WINDOW]
    x = x.reshape(*shape, *rest).permute(
        *range(0, 2 * axes, 2), *range(1, 2 * axes, 2),
        *range(2 * axes, 2 * axes + len(rest)))
    return ordered_sum(x.flatten(axes, 2 * axes - 1), dim=axes)


def input_row_sum(x: torch.Tensor, axes: int = 1) -> torch.Tensor:
    """Float32 sum over the leading ``axes`` axes of a program input, in
    XLA:CPU's order for the reference's jitted ``jnp.sum``/``jnp.mean``
    over them (jaxlib 0.9.0 on x86-64 with AVX-512; one axis probed at
    every count from 1 to 69 and at eight counts to 5,000, 1 to 2,048
    columns; two axes, the MoE layer's (groups, tokens), at 1 to 40 groups
    of 1 to 5,000 tokens): while an axis is longer than 32, window sums
    (:func:`window_sums`); then the rest added left to right in row-major
    order."""
    while any(n > TREE_WINDOW for n in x.shape[:axes]):
        x = window_sums(x, axes)
    return ordered_sum(x.flatten(0, axes - 1) if axes > 1 else x)


def f32_mean(x: torch.Tensor, dim=None, keepdim: bool = False
             ) -> torch.Tensor:
    """Mean of ``x`` as the reference's jitted ``jnp.mean`` computes it: a
    float32 sum multiplied by the float32 reciprocal of the count.  A
    true division (``torch.mean``) is 1 ulp off on many counts, and these
    means reach the Eq. 7 digest (accuracies, signatures).  ``dim`` is one
    axis, a tuple of axes, or None for all.  A mean over the leading axis
    alone (``dim=0``, or all of a 1-D tensor) adds its rows in XLA:CPU's
    order (:func:`input_row_sum`); other axes take torch's sum."""
    x = x.float()
    if dim is None:
        dim = tuple(range(x.dim()))
    dims = tuple(d % max(x.dim(), 1) for d in
                 ((dim,) if isinstance(dim, int) else dim))
    n = int(np.prod([x.shape[d] for d in dims]))
    if dims == (0,) and n > 0:
        total = input_row_sum(x)
        if keepdim:
            total = total.unsqueeze(0)
    else:
        total = x.sum(dim=dims, keepdim=keepdim)
    return total * float(np.float32(1) / np.float32(n))


def leaf_mean(leaves: Sequence):
    """One leaf of Eq. 6 over k models' copies of it: the float32 sum left
    to right times the float32 reciprocal of k; a non-float leaf is the
    first model's."""
    if not leaves[0].is_floating_point():
        return leaves[0]
    acc = leaves[0].float()
    for leaf in leaves[1:]:
        acc = acc + leaf.float()
    return acc * float(np.float32(1) / np.float32(len(leaves)))


def tree_mean(models: Sequence):
    """Eq. 6: w = (1/N) * sum_i w_i  over a list of congruent trees."""
    return tree_map(lambda *leaves: leaf_mean(leaves), *models)


def tree_weighted(models: Sequence, weights: Sequence[float]):
    w = np.asarray(weights, np.float32)
    w = [float(wi) for wi in w / max(w.sum(), np.float32(1e-12))]

    def combine(*leaves):
        if not leaves[0].is_floating_point():
            return leaves[0]
        acc = w[0] * leaves[0].float()
        for wi, leaf in zip(w[1:], leaves[1:]):
            acc = acc + wi * leaf.float()
        return acc

    return tree_map(combine, *models)


def round_up_multiple(x: int, n: int) -> int:
    """Smallest multiple of ``n`` that is >= ``x``."""
    return -(-x // n) * n


def pad_leading(arr: torch.Tensor, target: int) -> torch.Tensor:
    """Zero-pad the leading axis of ``arr`` out to ``target`` rows."""
    if arr.shape[0] == target:
        return arr
    pad = arr.new_zeros((target - arr.shape[0],) + tuple(arr.shape[1:]))
    return torch.cat([arr, pad])


def next_pow2(x: int) -> int:
    """Smallest power of two >= ``x`` (>= 1)."""
    p = 1
    while p < x:
        p *= 2
    return p


def tree_stack(models: Sequence):
    """Stack K congruent trees into one with a leading K axis per leaf."""
    return tree_map(lambda *leaves: torch.stack(leaves), *models)


def tree_unstack(stacked) -> list:
    """Inverse of :func:`tree_stack`: the K trees, as views of its rows."""
    n = tree_leaves(stacked)[0].shape[0]
    return [tree_map(lambda leaf, i=i: leaf[i], stacked) for i in range(n)]


def _quantized_target(x: int, n: int) -> int:
    """Pad target of a stacked axis split over ``n`` devices: the next
    power of two >= ``x``, rounded up to a multiple of ``n`` (the
    reference's, which bounds its compiled reducers)."""
    return round_up_multiple(next_pow2(x), n)


def _mesh_axis_size(mesh, axis_name) -> int:
    if mesh is None or axis_name is None:
        return 1
    return int(mesh.shape.get(axis_name, 1))


def _reduce_axes(mesh, axis_name: str, data_axis) -> tuple:
    """Mesh axes a stacked reduction splits its leading dim over: the
    clients axis, joined by the data axis when the mesh has one larger
    than 1 (aggregation has no per-sample structure, so the models spread
    over every device of a 2-D cohort mesh)."""
    axes = (axis_name,)
    if _mesh_axis_size(mesh, data_axis) > 1:
        axes = axes + (data_axis,)
    return axes


def axis_devices(mesh, axes) -> list:
    """The devices along ``axes`` of ``mesh`` (row-major over them, in the
    order given), the first along every other axis: device ``i`` holds
    block ``i`` of an axis split over ``axes``."""
    arr = mesh.devices
    names = list(mesh.axis_names)
    arr = arr[tuple(slice(None) if a in axes else 0 for a in names)]
    kept = [a for a in names if a in axes]
    return list(arr.transpose([kept.index(a) for a in axes]).reshape(-1))


def block_slices(n: int, parts: int) -> list:
    """An axis of ``n`` rows (a multiple of ``parts``) cut into ``parts``
    equal contiguous blocks: block ``i`` goes to device ``i`` of a mesh
    axis, everywhere in the port."""
    if n % parts:
        raise ValueError(f"{n} rows do not split into {parts} blocks")
    per = n // parts
    return [slice(i * per, (i + 1) * per) for i in range(parts)]


def split_blocks(x: torch.Tensor, devices: Sequence, dim: int = 0,
                 to: Callable = torch.Tensor.to) -> list:
    """``x`` cut along ``dim`` into ``len(devices)`` blocks
    (:func:`block_slices`), block ``i`` placed on ``devices[i]`` by
    ``to(block, device)`` (a view where it already lies there)."""
    lead = (slice(None),) * dim
    return [to(x[lead + (rows,)], dev) for rows, dev in
            zip(block_slices(x.shape[dim], len(devices)), devices)]


def add_in_order(parts: Sequence[torch.Tensor], device) -> torch.Tensor:
    """The partials added left to right on ``device``: the reference's
    psum in XLA:CPU's device order."""
    acc = parts[0].to(device)
    for part in parts[1:]:
        acc = acc + part.to(device)
    return acc


def _fma_einsum(w: np.ndarray, x: torch.Tensor) -> torch.Tensor:
    """``einsum("km,m...->k...", w, x)`` in the order of the reference's
    per-device einsum on XLA:CPU: each output row a chain of fused
    multiply-adds over the models, left to right.  One ``addcmul_`` a
    model over all K rows, which is one FMA an element on the CPU and on
    the card."""
    w = torch.as_tensor(w, device=x.device)
    out = x.new_zeros((w.shape[0],) + x.shape[1:])
    rows = (w.shape[0],) + (1,) * (x.dim() - 1)
    for j in range(w.shape[1]):
        out.addcmul_(w[:, j].reshape(rows), x[j])
    return out


def stacked_mean(stacked, mesh=None, axis_name: str = "clients",
                 data_axis=None):
    """Eq. 6 over a stacked tree: the mean over the leading client axis.
    Non-float leaves take row 0.

    Without a mesh (or over one device), as the reference's jitted
    ``jnp.mean`` (:func:`f32_mean`).  With a ``mesh`` whose ``axis_name``
    axis (joined by ``data_axis`` on a 2-D cohort mesh) has more than one
    device, the axis is zero-padded to ``_quantized_target`` and split in
    blocks over the devices; each device sums its block as the reference
    sums a program input (:func:`input_row_sum`), the partials are added
    on the mesh's first device, and the total is divided by K (a true
    division).  The result is on the input's device."""
    axes = _reduce_axes(mesh, axis_name, data_axis)
    n = int(np.prod([_mesh_axis_size(mesh, a) for a in axes]))
    if n <= 1:
        return tree_map(lambda leaf: f32_mean(leaf, dim=0)
                        if leaf.is_floating_point() else leaf[0], stacked)
    devices = axis_devices(mesh, axes)
    k = int(tree_leaves(stacked)[0].shape[0])
    target = _quantized_target(k, n)

    def mean(leaf):
        if not leaf.is_floating_point():
            return leaf[0]
        parts = [input_row_sum(b) for b in
                 split_blocks(pad_leading(leaf.float(), target), devices)]
        total = add_in_order(parts, devices[0])
        return (total / torch.full((), k, dtype=torch.float32,
                                   device=total.device)).to(leaf.device)

    return tree_map(mean, stacked)


def stacked_weighted(stacked, weights, mesh=None, axis_name: str = "clients",
                     data_axis=None):
    """Weighted aggregation over a stacked tree's leading axis M.

    ``weights`` of shape (M,) gives one aggregate tree; shape (K, M) gives a
    stacked tree of K aggregates, one einsum per leaf: row k holds client
    k's weights over the M stacked models (the cohort window's Eq. 6).  Rows
    are normalised as the reference does, ``w / max(sum(w), 1e-12)`` by a
    true division, the sum in its order (:func:`input_row_sum`; torch's
    sum was one ulp off on 10 of 76 probed rows).  Non-float leaves take
    row 0 (broadcast to K rows).

    With a ``mesh`` (see :func:`stacked_mean`), M is zero-padded with zero
    weights and split in blocks over the devices; each device einsums its
    models against its weight columns and the partials are added on the
    mesh's first device.  The result is on the input's device."""
    w = torch.as_tensor(np.asarray(weights, np.float32))
    # the row sums in the order of the reference's eager ``jnp.sum``
    w = w / input_row_sum(w.movedim(-1, 0)).unsqueeze(-1).clamp_min(1e-12)
    batched = w.dim() == 2
    axes = _reduce_axes(mesh, axis_name, data_axis)
    n = int(np.prod([_mesh_axis_size(mesh, a) for a in axes]))
    devices = axis_devices(mesh, axes) if n > 1 else None
    if devices is not None:
        w2 = (w if batched else w[None]).numpy()
        m = int(tree_leaves(stacked)[0].shape[0])
        w2 = np.pad(w2, ((0, 0), (0, _quantized_target(m, n) - m)))
        w_blocks = [w2[:, cols] for cols in block_slices(w2.shape[1], n)]

    def combine(leaf):
        if not leaf.is_floating_point():
            if batched:
                return leaf[0].expand((w.shape[0],) + leaf.shape[1:])
            return leaf[0]
        if devices is None:
            wd = w.to(leaf.device)
            if batched:
                return torch.einsum("km,m...->k...", wd, leaf.float())
            return torch.einsum("m,m...->...", wd, leaf.float())
        x = pad_leading(leaf.float(), w2.shape[1])
        parts = [_fma_einsum(wb, xb) for wb, xb in
                 zip(w_blocks, split_blocks(x, devices))]
        out = add_in_order(parts, devices[0]).to(leaf.device)
        return out if batched else out[0]

    return tree_map(combine, stacked)


def fma_f32(c, x: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """``c * x + p`` in float32 with one rounding, as the fused multiply-add
    XLA makes of the reference's jitted ``c * x + p``.  The product of two
    float32 values is exact in float64; the float64 sum is rounded to odd
    (its exact error found by TwoSum) so that the one rounding to float32
    is the fused one's.  ``c`` is a float32 scalar or tensor broadcasting
    against ``x``."""
    prod = torch.as_tensor(c, dtype=torch.float32,
                           device=x.device).double() * x.double()
    p = p.double()
    s = prod + p
    bb = s - prod
    err = (prod - (s - bb)) + (p - bb)
    inexact_even = (err != 0) & ((s.view(torch.int64) & 1) == 0)
    toward = torch.where(err > 0, torch.inf, -torch.inf).to(s.dtype)
    return torch.where(inexact_even, torch.nextafter(s, toward), s).float()


def tree_interpolate(a, b, alpha: float):
    """FedAsync-style mixing: (1-alpha)*a + alpha*b, as the reference's
    jitted program computes it: alpha in float32, ``1 - alpha`` in float32,
    and the first product fused into the sum (:func:`fma_f32`)."""
    alpha32 = np.float32(alpha)
    keep = float(np.float32(1) - alpha32)

    def mix(x, y):
        if not x.is_floating_point():
            return x
        return fma_f32(keep, x.float(), float(alpha32) * y.float())

    return tree_map(mix, a, b)


def tree_size_bytes(model) -> int:
    """Bytes held by the tensor leaves of ``model``."""
    return sum(a.numel() * a.element_size() for a in tree_leaves(model)
               if isinstance(a, torch.Tensor))

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
that axis in one reduction.  Only the single-device forms are ported; the
reference's ``psum`` forms over a device mesh are not, and a ``mesh`` raises.
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


def tree_mean(models: Sequence):
    """Eq. 6: w = (1/N) * sum_i w_i  over a list of congruent trees."""
    scale = float(np.float32(1) / np.float32(len(models)))

    def mean(*leaves):
        if not leaves[0].is_floating_point():
            return leaves[0]
        acc = leaves[0].float()
        for leaf in leaves[1:]:
            acc = acc + leaf.float()
        return acc * scale

    return tree_map(mean, *models)


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


def _single_device(mesh) -> None:
    if mesh is not None:
        raise NotImplementedError(
            "stacked aggregation over a device mesh is not ported to the "
            "PyTorch package (only mesh=None)")


def stacked_mean(stacked, mesh=None):
    """Eq. 6 over a stacked tree: the mean over the leading client axis,
    as the reference's jitted ``jnp.mean`` (:func:`f32_mean`).  Non-float
    leaves take row 0."""
    _single_device(mesh)
    return tree_map(lambda leaf: f32_mean(leaf, dim=0)
                    if leaf.is_floating_point() else leaf[0], stacked)


def stacked_weighted(stacked, weights, mesh=None):
    """Weighted aggregation over a stacked tree's leading axis M.

    ``weights`` of shape (M,) gives one aggregate tree; shape (K, M) gives a
    stacked tree of K aggregates, one einsum per leaf: row k holds client
    k's weights over the M stacked models (the cohort window's Eq. 6).  Rows
    are normalised as the reference does, ``w / max(sum(w), 1e-12)`` by a
    true division.  Non-float leaves take row 0 (broadcast to K rows)."""
    _single_device(mesh)
    w = torch.as_tensor(np.asarray(weights, np.float32))
    w = w / w.sum(dim=-1, keepdim=True).clamp_min(1e-12)
    batched = w.dim() == 2

    def combine(leaf):
        if not leaf.is_floating_point():
            if batched:
                return leaf[0].expand((w.shape[0],) + leaf.shape[1:])
            return leaf[0]
        wd = w.to(leaf.device)
        if batched:
            return torch.einsum("km,m...->k...", wd, leaf.float())
        return torch.einsum("m,m...->...", wd, leaf.float())

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

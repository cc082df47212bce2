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
of the reference's ``sum / n``.  The stacked and ``psum`` forms belong to
the cohort engine and are not ported yet.
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


def tree_interpolate(a, b, alpha: float):
    """FedAsync-style mixing: (1-alpha)*a + alpha*b."""
    return tree_map(
        lambda x, y: ((1 - alpha) * x.float() + alpha * y.float())
        if x.is_floating_point() else x, a, b)


def tree_size_bytes(model) -> int:
    """Bytes held by the tensor leaves of ``model``."""
    return sum(a.numel() * a.element_size() for a in tree_leaves(model)
               if isinstance(a, torch.Tensor))

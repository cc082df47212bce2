"""Minimal optimizer library (port of ``repro.optim.optimizers``).

``Optimizer`` is an (init, update) pair over model trees, as in the
reference, but the port updates in place where the reference builds new
trees: ``update`` advances the momentum buffers in place, and
:func:`apply_updates` adds the updates into the parameters.  Call both
under ``torch.no_grad()`` on parameters that require grad.  AdamW and the
learning-rate schedules belong to the LM path and are not ported yet.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from repro_torch.core.aggregate import tree_map


class Optimizer(NamedTuple):
    init: Callable
    update: Callable   # (grads, state, params) -> (updates, state)


def sgd(lr: float, momentum: float = 0.0) -> Optimizer:
    """SGD with heavy-ball momentum: ``mu <- momentum*mu + g``,
    ``p <- p + (-lr*mu)``.  The reference's weight decay and learning-rate
    schedules are not ported: no caller of the port sets them."""

    def init(params):
        state = {"step": 0}
        if momentum != 0.0:
            state["mu"] = tree_map(
                lambda p: torch.zeros_like(p, dtype=torch.float32), params)
        return state

    def update(grads, state, params):
        step = state["step"] + 1
        if momentum == 0.0:
            return tree_map(lambda g: g.float() * -lr, grads), {"step": step}

        def advance(g, mu):
            mu.mul_(momentum).add_(g.float())
            return mu * -lr

        updates = tree_map(advance, grads, state["mu"])
        return updates, {"step": step, "mu": state["mu"]}

    return Optimizer(init, update)


def apply_updates(params, updates) -> None:
    """``p <- p + u`` in place, leaf by leaf."""
    tree_map(lambda p, u: p.add_(u.to(p.dtype)), params, updates)

"""Minimal optimizer library (port of ``repro.optim.optimizers``).

``Optimizer`` is an (init, update) pair over model trees, as in the
reference, but the port updates in place where the reference builds new
trees: ``update`` advances the moment buffers in place, and
:func:`apply_updates` adds the updates into the parameters.  Call both
under ``torch.no_grad()`` on parameters that require grad.

Arithmetic follows the reference's float32 order: learning rates and bias
corrections are float32 scalars (the schedules compute in float32, as the
reference's ``jnp`` scalars do), moments are kept in ``moment_dtype`` and
updated in float32 (Jamba's are bfloat16).  The step counter is a Python
int.
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch

from repro_torch.core.aggregate import tree_leaves, tree_map


class Optimizer(NamedTuple):
    init: Callable
    update: Callable   # (grads, state, params) -> (updates, state)


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


# ---------------------------------------------------------------------------
# schedules: step (int) -> learning rate (a float32 value)
# ---------------------------------------------------------------------------


def constant_schedule(lr: float):
    return lambda step: float(_f32(lr))


def cosine_schedule(lr: float, total_steps: int, final_frac: float = 0.1):
    def fn(step):
        t = torch.clamp(_f32(step) / max(total_steps, 1), max=1.0)
        cos = 0.5 * (1 + torch.cos(_f32(math.pi) * t))
        return float(_f32(lr) * (final_frac + (1 - final_frac) * cos))
    return fn


def warmup_cosine(lr: float, warmup: int, total_steps: int,
                  final_frac: float = 0.1):
    cos = cosine_schedule(lr, max(total_steps - warmup, 1), final_frac)

    def fn(step):
        if step < warmup:
            return float(_f32(lr) * _f32(step) / max(warmup, 1))
        return cos(step - warmup)
    return fn


# ---------------------------------------------------------------------------
# gradient clipping
# ---------------------------------------------------------------------------


def clip_by_global_norm(grads, max_norm: float):
    """(grads scaled to a global norm of at most ``max_norm``, the norm
    before clipping as a float32 tensor).  The leaves' float32 sums of
    squares are added in leaf order, as the reference's Python ``sum``."""
    leaves = tree_leaves(grads)
    total = leaves[0].float().square().sum()
    for g in leaves[1:]:
        total = total + g.float().square().sum()
    gnorm = torch.sqrt(total)
    scale = torch.clamp(max_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
    return tree_map(lambda g: g * scale.to(g.dtype), grads), gnorm


# ---------------------------------------------------------------------------
# SGD / AdamW
# ---------------------------------------------------------------------------


def sgd(lr, momentum: float = 0.0, weight_decay: float = 0.0) -> Optimizer:
    """SGD with heavy-ball momentum: ``mu <- momentum*mu + g``,
    ``p <- p + (-lr*mu)``; ``weight_decay`` adds ``wd * p`` to the
    gradient first."""
    lr_t = constant_schedule(lr)(0)

    def init(params):
        state = {"step": 0}
        if momentum != 0.0:
            state["mu"] = tree_map(
                lambda p: torch.zeros_like(p, dtype=torch.float32), params)
        return state

    def update(grads, state, params):
        step = state["step"] + 1

        def grad(g, p):
            g = g.float()
            return g + weight_decay * p.float() if weight_decay else g

        if momentum == 0.0:
            return (tree_map(lambda g, p: grad(g, p) * -lr_t, grads, params),
                    {"step": step})

        def advance(g, p, mu):
            mu.mul_(momentum).add_(grad(g, p))
            return mu * -lr_t

        updates = tree_map(advance, grads, params, state["mu"])
        return updates, {"step": step, "mu": state["mu"]}

    return Optimizer(init, update)


def adamw(lr, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.0,
          moment_dtype: torch.dtype = torch.float32) -> Optimizer:
    """AdamW with bias-corrected moments kept in ``moment_dtype``:
    ``u = -lr * (mhat / (sqrt(vhat) + eps) + wd * p)``, all in float32."""
    sched = lr if callable(lr) else constant_schedule(lr)

    def init(params):
        def zeros(p):
            return torch.zeros_like(p, dtype=moment_dtype)
        return {"step": 0, "m": tree_map(zeros, params),
                "v": tree_map(zeros, params)}

    def update(grads, state, params):
        step = state["step"] + 1
        lr_t = sched(step)
        # float32 values, held as Python floats (exactly)
        bc1 = float(1 - torch.pow(_f32(b1), _f32(step)))
        bc2 = float(1 - torch.pow(_f32(b2), _f32(step)))

        def upd(g, m, v, p):
            g = g.float()
            m_new = b1 * m.float() + (1 - b1) * g
            v_new = b2 * v.float() + (1 - b2) * g.square()
            mhat = m_new / bc1
            vhat = v_new / bc2
            u = -lr_t * (mhat / (torch.sqrt(vhat) + eps)
                         + weight_decay * p.float())
            m.copy_(m_new)
            v.copy_(v_new)
            return u

        updates = tree_map(upd, grads, state["m"], state["v"], params)
        return updates, {"step": step, "m": state["m"], "v": state["v"]}

    return Optimizer(init, update)


def apply_updates(params, updates) -> None:
    """``p <- p + u`` in place, leaf by leaf; a parameter of a narrower
    type takes the float32 sum rounded once."""
    def add(p, u):
        if p.dtype == torch.float32:
            p.add_(u)
        else:
            p.copy_(p.float() + u)
    tree_map(add, params, updates)

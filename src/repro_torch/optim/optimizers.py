"""Minimal optimizer library (port of ``repro.optim.optimizers``).

``Optimizer`` is an (init, update) pair over model trees, as in the
reference, but the port updates in place where the reference builds new
trees: ``update`` advances the moment buffers in place and returns the
step as :class:`Scaled` (a direction tree and the scale ``-lr``), and
:func:`apply_updates` adds it into the parameters.  Call both under
``torch.no_grad()`` on parameters that require grad.

Arithmetic follows the reference's jitted float32 programs bit for bit
(``tests/test_torch_train.py`` holds 4 steps against ``jax.jit`` of the
reference's update and ``apply_updates``):

- learning rates and bias corrections are float32 scalars (the schedules
  compute in float32), moments are kept in ``moment_dtype`` and updated
  in float32 (Jamba's are bfloat16); the step counter is a Python int;
- XLA:CPU fuses each ``a * b + c`` of the update into one FMA.  The port
  writes each as ``c.add(b, alpha=a)``, which both PyTorch's CPU kernel
  (an explicit ``fmadd``) and its CUDA kernel (contracted by nvcc)
  compute with one rounding: ``p + (-lr) * d``, ``g + wd * p``,
  ``mu * momentum + g``, ``d + wd * p`` and the moments.  Which product
  XLA fuses depends on the moments' type: float32 moments take
  ``fma(m, b1, (1 - b1) * g)``, bfloat16 ones ``fma(g, 1 - b1, m * b1)``,
  both in the update and in the stored moments, which are that float32
  value rounded once to bfloat16 (the optimized HLO holds the same
  ``m * b1 + g * (1 - b1)`` for both; LLVM's contraction picks the
  product, confirmed bit for bit);
- XLA rewrites ``mhat / (sqrt(vhat) + eps)`` as ``m / (bc1 * (sqrt(v /
  bc2) + eps))``; the divisions are true divisions by a tensor (on the
  card PyTorch divides by a host scalar as a multiply by its
  reciprocal), and ``sqrt`` is correctly rounded (PyTorch's vectorised
  float32 ``sqrt`` on the CPU is not: it is taken in float64 there).
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


class Scaled(NamedTuple):
    """An optimizer step: ``p <- p + scale * direction`` with one rounding
    (:func:`apply_updates`)."""
    direction: object        # a tree congruent with the parameters
    scale: float             # -lr, a float32 value


def _div(x: torch.Tensor, c: float) -> torch.Tensor:
    """``x / c`` as a true float32 division on any device: ``c`` as a
    0-dim tensor on ``x``'s device (filled there, no host copy)."""
    return x / torch.full((), c, dtype=torch.float32, device=x.device)


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 ``sqrt``: in float64 on the CPU, whose
    vectorised float32 ``sqrt`` is not."""
    if x.device.type == "cpu":
        return x.double().sqrt_().float()
    return x.sqrt()


# AdamW updates a leaf in pieces of at most this many elements, so that
# the update's float32 temporaries (eight a piece) stay small beside a
# multi-GB leaf (an MoE layer's experts: 3.76 GB each at Jamba's width)
_PIECE = 1 << 26


def _in_pieces(fn, g, m, v, p) -> torch.Tensor:
    """``fn(g, m, v, p)``, elementwise, over the flattened leaves in
    pieces of ``_PIECE`` elements, into one float32 leaf: the values of
    one call (``fn`` advances its ``m`` and ``v`` pieces in place)."""
    if p.numel() <= _PIECE:
        return fn(g, m, v, p)
    out = torch.empty(p.shape, dtype=torch.float32, device=p.device)
    flat = (out.view(-1), g.reshape(-1), m.view(-1), v.view(-1),
            p.reshape(-1))
    for i in range(0, p.numel(), _PIECE):
        piece, *args = (t[i:i + _PIECE] for t in flat)
        piece.copy_(fn(*args))
    return out


def sgd(lr, momentum: float = 0.0, weight_decay: float = 0.0) -> Optimizer:
    """SGD with heavy-ball momentum: ``mu <- momentum*mu + g``,
    ``p <- p + (-lr)*mu``; ``weight_decay`` adds ``wd * p`` to the
    gradient first.  Each ``a*b + c`` is one FMA, as XLA fuses it."""
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
            return g.add(p.float(), alpha=weight_decay) if weight_decay \
                else g

        if momentum == 0.0:
            return (Scaled(tree_map(grad, grads, params), -lr_t),
                    {"step": step})

        def advance(g, p, mu):
            return torch.add(grad(g, p), mu, alpha=momentum, out=mu)

        direction = tree_map(advance, grads, params, state["mu"])
        return Scaled(direction, -lr_t), {"step": step, "mu": state["mu"]}

    return Optimizer(init, update)


def adamw(lr, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.0,
          moment_dtype: torch.dtype = torch.float32) -> Optimizer:
    """AdamW with bias-corrected moments kept in ``moment_dtype``:
    ``p <- p + (-lr) * (mhat / (sqrt(vhat) + eps) + wd * p)``, in the
    jitted reference's float32 order (module docstring)."""
    sched = lr if callable(lr) else constant_schedule(lr)
    narrow = moment_dtype != torch.float32

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

        def direction(g, m, v, p):
            g = g.float()
            g2 = g.square()
            m32, v32 = m.float(), v.float()
            if narrow:
                # XLA fuses the other product of each moment
                m_new = (m32 * b1).add_(g, alpha=1 - b1)
                v_new = (v32 * b2).add_(g2, alpha=1 - b2)
            else:
                m_new = (g * (1 - b1)).add_(m32, alpha=b1)
                v_new = (g2 * (1 - b2)).add_(v32, alpha=b2)
            m.copy_(m_new)
            v.copy_(v_new)
            denom = _sqrt(_div(v_new, bc2)).add_(eps).mul_(bc1)
            d = m_new.div_(denom)
            return d.add_(p.float(), alpha=weight_decay) if weight_decay \
                else d

        updates = tree_map(lambda *leaves: _in_pieces(direction, *leaves),
                           grads, state["m"], state["v"], params)
        return (Scaled(updates, -lr_t),
                {"step": step, "m": state["m"], "v": state["v"]})

    return Optimizer(init, update)


def apply_updates(params, updates: Scaled) -> None:
    """``p <- p + scale * direction`` in place, leaf by leaf, as one fused
    multiply-add; a parameter of a narrower type takes the float32 result
    rounded once."""
    alpha = updates.scale

    def add(p, d):
        if p.dtype == torch.float32:
            p.add_(d, alpha=alpha)
        else:
            p.copy_(p.float().add_(d, alpha=alpha))
    tree_map(add, params, updates.direction)

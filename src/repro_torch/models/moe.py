"""Mixture-of-experts feed-forward layer with capacity-bounded one-hot
dispatch (port of ``repro.models.moe``).

Tokens are cut into groups of ``min(512, B*S)`` (the tail padded with zero
rows), routed greedily to their top-k experts with a per-group capacity of
C slots an expert, and dispatched, run and combined with one-hot einsums:
dispatch (G, S_g, E, C).  Tokens past an expert's capacity are dropped (the
routed experts give them zero; a shared expert, where there is one, still
runs).  The router carries a load-balance aux loss and a z-loss.

As in the reference, the padded rows are routed like real tokens: zero
logits give uniform probabilities, so ``argmax`` picks expert 0, and they
take expert-0 slots after every real token of their group and count in the
aux means.  Everything is vectorised with out-of-place updates and no
shape that depends on the data, so ``torch.func.vmap`` (the LM cohort
engine) takes the layer as it is.  The products stay ``torch.einsum`` in
the compute type, as the reference's ``jnp.einsum``: the reference has no
Pallas kernel here.

The tree keeps the reference's leaf names and shapes: ``router (d, E)``,
``we_gate`` and ``we_up (E, d, f)``, ``we_down (E, f, d)``, and ``shared``
(an ``init_mlp`` tree) with ``n_shared > 0``, so a JAX tree loads through
``weights.params_from_numpy`` unchanged.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig, MoEConfig
from repro_torch.core.aggregate import input_row_sum
from repro_torch.models.layers import (_normal, activation, apply_mlp,
                                       at_use, dense_init, init_mlp,
                                       torch_dtype)
from repro_torch.sharding import dtensor

_GROUP = 512


def init_moe(generator, cfg: ArchConfig, dtype) -> dict:
    mo = cfg.moe
    d = cfg.d_model
    p = {
        "router": dense_init(generator, d, mo.n_experts, dtype, scale=0.02),
        "we_gate": _expert_init(generator, mo.n_experts, d, mo.d_expert,
                                dtype),
        "we_up": _expert_init(generator, mo.n_experts, d, mo.d_expert, dtype),
        "we_down": _expert_init(generator, mo.n_experts, mo.d_expert, d,
                                dtype),
    }
    if mo.n_shared:
        p["shared"] = init_mlp(generator, d, mo.n_shared * mo.d_expert, dtype)
    return p


def _expert_init(generator, e: int, din: int, dout: int, dtype):
    # divided in place: one float32 draw of 5.4e9 elements (llama4's) held
    return _normal(generator, (e, din, dout)).div_(math.sqrt(din)).to(
        at_use(dtype))


def capacity(group: int, seq_len: int, mo: MoEConfig,
             generous_capacity: bool) -> int:
    """Slots an expert takes per group.  Serving (``generous_capacity``,
    or one token a row) gets 4x the balanced load, at least 8; training
    keeps Switch-style ``capacity_factor`` dropping."""
    E, k = mo.n_experts, mo.top_k
    if seq_len == 1 or generous_capacity:
        return min(group, max(8, -(-group * k * 4 // E)))
    return max(int(group * k / E * mo.capacity_factor), 1)


def topk_dispatch(probs: torch.Tensor, k: int, cap: int):
    """Greedy top-k dispatch with capacity: probs (G, S_g, E) float32 ->
    (gates (G, S_g, E) float32, dispatch (G, S_g, E, C) bool).  A token's
    slot is its place in its expert's queue in sequence order, after the
    slots the earlier choices filled; positions are float32 sums of
    one-hots (exact below 2^24)."""
    G, Sg, E = probs.shape
    experts = torch.arange(E, device=probs.device)
    slots = torch.arange(cap, device=probs.device)
    remaining = probs
    fill = torch.zeros((G, E), dtype=torch.int32, device=probs.device)
    gates = torch.zeros_like(probs)
    dispatch = torch.zeros((G, Sg, E, cap), dtype=torch.bool,
                           device=probs.device)
    for _ in range(k):
        idx = remaining.argmax(dim=-1)                       # (G, S_g)
        onehot = (idx[..., None] == experts).float()
        pos = torch.cumsum(onehot, dim=1) - 1.0 + fill[:, None, :].float()
        pos_tok = (pos * onehot).sum(dim=-1)                 # (G, S_g)
        keep = pos_tok < cap
        slot = pos_tok.to(torch.int32)[..., None] == slots   # (G, S_g, C)
        dispatch = dispatch | ((onehot[..., None] > 0)
                               & slot[:, :, None, :]
                               & keep[:, :, None, None])
        gates = gates + onehot * probs * keep[..., None].float()
        fill = fill + (onehot * keep[..., None]).sum(dim=1).to(torch.int32)
        remaining = remaining * (1.0 - onehot)
    denom = torch.clamp(gates.sum(dim=-1, keepdim=True), min=1e-9)
    return gates / denom, dispatch


def router_losses(probs: torch.Tensor, kept: torch.Tensor,
                  z: torch.Tensor, mo: MoEConfig) -> dict:
    """The router's aux losses from probs (G, S_g, E), the kept choices
    ``dispatch.any(-1)`` (G, S_g, E) and the logits' logsumexp z (G, S_g):
    ``moe_aux``, the Switch-style load balance ``E * sum(me * ce) * w``
    plus the z-loss ``mean(z^2) * w_z``; ``expert_load`` ce, the share of
    tokens each expert kept; ``router_prob`` me, the mean routing
    probability; and ``z_loss``.

    The means are the jitted reference's bits: float32 sums over (G, S_g)
    in XLA:CPU's order (``core.aggregate.input_row_sum``) times the float32
    reciprocal of G * S_g, with the constants folded as XLA folds them
    (``E * w`` into one float32, and ``w_z`` into the reciprocal).  XLA
    fuses the E products of ``sum(me * ce)`` and the last addition into
    fused multiply-adds; here they are rounded one by one, which can move
    ``moe_aux`` by an ulp."""
    E = mo.n_experts
    inv = np.float32(1) / np.float32(probs.shape[0] * probs.shape[1])
    me = input_row_sum(probs, 2) * float(inv)
    ce = input_row_sum(kept.float(), 2) * float(inv)
    aux_lb = input_row_sum(me * ce) * float(
        np.float32(E) * np.float32(mo.router_aux_weight))
    aux_z = input_row_sum(z.square(), 2) * float(
        inv * np.float32(mo.router_z_weight))
    return {"moe_aux": aux_lb + aux_z, "expert_load": ce,
            "router_prob": me, "z_loss": aux_z}


def moe_forward(params, x: torch.Tensor, *, cfg: ArchConfig,
                generous_capacity: bool = False):
    """x (B, S, d) -> (out (B, S, d), aux) with aux ``moe_aux`` (the router
    losses, a float32 scalar) and ``expert_load`` (E,) (the share of the
    group slots' tokens each expert kept: a routed choice that was dropped
    is missing from it).

    On a DTensor mesh (the dry run's) the routed experts run chip by chip
    (``sharding.dtensor.on_chips``): each chip routes its rows' tokens
    over every expert and runs the experts it holds, so the output is a
    partial sum over the experts' mesh dims, and the router's means are
    means over the batch's."""
    mo = cfg.moe
    compute = torch_dtype(cfg.compute_dtype)
    B, S, d = x.shape
    g_size = min(_GROUP, B * S)
    n_groups = -(-(B * S) // g_size)
    rows, means, spread = dtensor.expert_layout(x, n_groups)
    out, moe_aux, load = dtensor.on_chips(
        lambda *a: _routed(*a, cfg=cfg, S=S, g_size=g_size, spread=spread,
                           generous_capacity=generous_capacity),
        (x, params["router"], params["we_gate"], params["we_up"],
         params["we_down"]),
        (rows, {}, {"expert": 0}, {"expert": 0}, {"expert": 0}),
        ({**rows, "expert": "sum"}, means, means))
    if mo.n_shared:
        shared, _ = apply_mlp(params["shared"], x, cfg.act, compute)
        out = out + shared.reshape(B, S, d)
    return out.to(x.dtype), {"moe_aux": moe_aux, "expert_load": load}


def _routed(x, router, we_gate, we_up, we_down, *, cfg: ArchConfig, S: int,
            g_size: int, generous_capacity: bool, spread=None):
    """The routed experts over x (B, S, d) in groups of ``g_size`` tokens:
    (out (B, S, d) in the compute type, moe_aux, expert_load).  ``we_*``
    may hold a chip's block of the experts; every token is routed over
    all of them.  With ``spread`` (``sharding.dtensor.expert_layout``), x
    holds a chip's share of one group: its router logits are gathered to
    route the whole group, and the experts' inputs are its tokens'
    partial sums, then summed."""
    mo = cfg.moe
    compute = torch_dtype(cfg.compute_dtype)
    B, _, d = x.shape
    k = mo.top_k

    tokens = x.reshape(B * S, d)
    if spread is None:
        n_groups = (B * S) // g_size
        rem = B * S - n_groups * g_size
        if rem:                                   # pad to whole groups
            tokens = F.pad(tokens, (0, 0, 0, g_size - rem))
            n_groups += 1
        xg = tokens.reshape(n_groups, g_size, d).to(compute)
        logits = (xg @ router.to(compute)).float()
    else:
        xg = tokens[None].to(compute)
        logits = spread[0]((xg @ router.to(compute)).float())
    probs = torch.softmax(logits, dim=-1)                     # (G, S_g, E)
    cap = capacity(g_size, S, mo, generous_capacity)
    gates, dispatch = topk_dispatch(probs, k, cap)            # (G,S_g,E,C)
    held, gates_held = dispatch, gates
    if we_gate.shape[0] != mo.n_experts or spread is not None:
        held, gates_held = dtensor.chips_share(
            dispatch, gates, we_gate.shape[0],
            B * S if spread is not None else None)

    xe = torch.einsum("gsec,gsd->gecd", held.to(compute), xg)
    if spread is not None:
        xe = spread[1](xe)
    act = activation(cfg.act)
    h = act(torch.einsum("gecd,edf->gecf", xe, we_gate.to(compute)))
    h = h * torch.einsum("gecd,edf->gecf", xe, we_up.to(compute))
    ye = torch.einsum("gecf,efd->gecd", h, we_down.to(compute))
    combine = (held.float() * gates_held[..., None]).to(compute)
    out = torch.einsum("gsec,gecd->gsd", combine, ye)
    out = out.reshape(-1, d)[:B * S].reshape(B, S, d)

    losses = router_losses(probs, dispatch.any(dim=-1),
                           torch.logsumexp(logits, dim=-1), mo)
    return out, losses["moe_aux"], losses["expert_load"]

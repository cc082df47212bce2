"""xLSTM blocks: mLSTM (matrix memory, chunkwise-parallel) and sLSTM
(scalar memory, strictly recurrent), arXiv:2405.04517 (port of
``repro.models.xlstm``, used by xlstm-125m).

The parameter trees are the reference's, with ``b_if`` and ``b_gates`` in
float32 whatever the param dtype, so a JAX tree loads through
``weights.params_from_numpy`` unchanged.

Two paths for each recurrence, as in the Mamba block:

- ``runtime.use_kernels``: the kernels through ``kernels.ops``, on the card
  (their plain versions on the CPU).  No gradient: the eval and signature
  forwards.  :func:`mlstm_forward` calls ``ops.mlstm_chunkwise`` (with
  ``chunk = xlstm.chunk``, and ``h`` taken in float32 as the model's own
  form gives it) only from a fresh state, since the kernel starts from
  ``C = 0, n = 0, m = -1e30``; a carried state takes the model's form.
  :func:`slstm_forward` hoists ``gates_x = xconv @ W + b`` and ``R`` in
  float32 as :func:`_slstm_scan` does, then calls ``ops.slstm_scan``.
- otherwise the model's own forms, the path local training runs under
  autograd: :func:`mlstm_chunkwise` (the reference's chunkwise form, its
  padding of ``f_gate`` with 30.0 included) and :func:`_slstm_scan` (one
  ``slstm_step`` per position).

The reference's JAX model never reaches its two Pallas kernels (they are
reachable only through its ``ops`` entry points), although each kernel is
the forward path of exactly these functions; the port routes its no-grad
forwards through them, as it does the Mamba block's, which computes the
same function and adds no knob.

Memory of the model's mLSTM under autograd: a chunk keeps its ``(L, L)``
decay and score matrices and the ``(dk, dv)`` state products for its
backward.  The reference wraps each chunk in ``jax.checkpoint``; the port
runs each chunk under ``torch.utils.checkpoint`` (non-reentrant), which
keeps only the chunk-boundary states.

Decode: :func:`mlstm_decode` is one step of :func:`mlstm_recurrent_ref`
and :func:`slstm_decode` the full-sequence block over one token from the
carried state with no runtime (the model's step), in plain PyTorch as the
reference computes them in ``jnp``.  A prefill through the kernels hands
their final states (``C, n, m`` and ``c, n, h, m``) over as the decode
state.

With ``runtime.mesh`` and ``runtime.batch_axes``,
:func:`_slstm_scan_maybe_sharded` splits the recurrence's batch over the
devices of those axes, the reference's ``shard_map`` region: each device
runs its rows' recurrence (the kernel on the card, the model's own step on
the CPU) with its own copy of ``w_gates``, ``r_gates`` and ``b_gates``,
and the rows are joined on the input's device.  Autograd's device copies
add the copies' weight gradients once, after the loop, which is the
reference's psum hoisted out of the timestep loop.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.core.aggregate import axis_devices, split_blocks
from repro_torch.kernels import ops
from repro_torch.kernels.mlstm import mlstm_chunk
from repro_torch.kernels.slstm import slstm_step
from repro_torch.models.layers import (_normal, apply_norm, at_use,
                                       dense_init, init_norm, step_loop,
                                       torch_dtype)
from repro_torch.runtime import on_device
from repro_torch.sharding import dtensor
from repro_torch.sharding.dtensor import halves, merge_heads, split_heads


def _mdims(cfg: ArchConfig):
    xc = cfg.xlstm
    d_in = xc.m_expand * cfg.d_model
    d_qk = int(xc.m_qk_dim_factor * d_in)
    return xc, d_in, d_qk, cfg.n_heads


def _causal_conv(xp, conv_w, conv_b, S: int):
    """Depthwise causal conv over time of ``xp`` (B, S + s_conv - 1, C),
    then SiLU."""
    xconv = sum(xp[:, i:i + S] * conv_w[i] for i in range(conv_w.shape[0]))
    return F.silu(xconv + conv_b)


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------


def init_mlstm(generator, cfg: ArchConfig, dtype) -> dict:
    """Weights drawn on ``generator`` in the reference's order."""
    xc, d_in, d_qk, H = _mdims(cfg)
    device = generator.device
    up_proj = dense_init(generator, cfg.d_model, 2 * d_in, dtype)
    conv_w = (_normal(generator, (xc.s_conv, d_in))
              / math.sqrt(xc.s_conv)).to(at_use(dtype))
    wq = dense_init(generator, d_in, d_qk, dtype)
    wk = dense_init(generator, d_in, d_qk, dtype)
    wv = dense_init(generator, d_in, d_in, dtype)
    w_if = dense_init(generator, d_in, 2 * H, dtype, scale=0.01)
    down_proj = dense_init(generator, d_in, cfg.d_model, dtype)
    return {
        "up_proj": up_proj,
        "conv_w": conv_w,
        "conv_b": torch.zeros((d_in,), dtype=at_use(dtype), device=device),
        "wq": wq,
        "wk": wk,
        "wv": wv,
        "w_if": w_if,
        "b_if": torch.cat([torch.zeros((H,), device=device),
                           torch.full((H,), 3.0, device=device)]),
        "head_norm": init_norm("rmsnorm", d_in, dtype, device),
        "down_proj": down_proj,
    }


def init_mlstm_state(cfg: ArchConfig, batch: int, leading: tuple = (),
                     device=None) -> dict:
    """Fresh state and conv tail (stacked over ``leading``, as a stage's
    decode cache)."""
    xc, d_in, d_qk, H = _mdims(cfg)
    lead = tuple(leading) + (batch,)
    return {
        "C": torch.zeros(lead + (H, d_qk // H, d_in // H), device=device),
        "n": torch.zeros(lead + (H, d_qk // H), device=device),
        "m": torch.full(lead + (H,), -1e30, device=device),
        "conv": torch.zeros(lead + (xc.s_conv - 1, d_in), device=device),
    }


def _mlstm_qkvif(params, x, cfg: ArchConfig, compute):
    """x (B,S,d) -> q, k (B,S,H,dqk/H), v (B,S,H,d_in/H), i, f (B,S,H)
    float32 (views into one projection), z and xm (B,S,d_in)."""
    xc, d_in, d_qk, H = _mdims(cfg)
    B, S, _ = x.shape
    up = x.to(compute) @ params["up_proj"].to(compute)
    xm, z = halves(up)
    # causal conv + silu feeds q/k (the paper's block layout)
    xcn = _causal_conv(dtensor.pad(xm, 1, xc.s_conv - 1, 0),
                       params["conv_w"].to(compute),
                       params["conv_b"].to(compute), S)
    q = split_heads(xcn @ params["wq"].to(compute), B, S, H, d_qk // H)
    k = split_heads(xcn @ params["wk"].to(compute), B, S, H, d_qk // H)
    v = split_heads(xm @ params["wv"].to(compute), B, S, H, d_in // H)
    gif = (xm @ params["w_if"].to(compute)).float() + params["b_if"]
    i_gate, f_gate = gif.chunk(2, dim=-1)
    return q, k, v, i_gate, f_gate, z, xm


def mlstm_chunkwise(q, k, v, i_gate, f_gate, state, chunk: int = 256):
    """Stabilised chunkwise mLSTM (the model's own form).

    q, k (B,S,H,dk), v (B,S,H,dv); gates (B,S,H) raw (i pre-exp, f
    pre-logsigmoid); state {C (B,H,dk,dv), n (B,H,dk), m (B,H)}.  Returns
    (h (B,S,H,dv) float32, state).  S is padded to whole chunks with zero
    inputs and ``f_gate = 30`` (forget ~1), as in the reference.  Under
    autograd each chunk runs under ``torch.utils.checkpoint``; inside
    ``torch.func.vmap`` an input's ``requires_grad`` reads False and every
    chunk is kept (a checkpoint's backward would recompute it outside the
    vmap).
    """
    B, S, H, dk = q.shape
    L = min(chunk, S)
    n_chunks = -(-S // L)
    pad = n_chunks * L - S
    scale = 1.0 / math.sqrt(dk)
    track = torch.is_grad_enabled() and any(
        t.requires_grad for t in (q, k, v, i_gate, f_gate))
    # (B, H, S, *) float32
    qt = F.pad(q.float().transpose(1, 2) * scale, (0, 0, 0, pad))
    kt = F.pad(k.float().transpose(1, 2), (0, 0, 0, pad))
    vt = F.pad(v.float().transpose(1, 2), (0, 0, 0, pad))
    it = F.pad(i_gate.transpose(1, 2), (0, pad))
    lf = F.logsigmoid(F.pad(f_gate.transpose(1, 2), (0, pad), value=30.0))
    C, n, m = state["C"], state["n"], state["m"]
    hs = []
    for s0 in range(0, n_chunks * L, L):
        sl = slice(s0, s0 + L)
        args = (C, n, m, qt[:, :, sl], kt[:, :, sl], vt[:, :, sl],
                it[:, :, sl], lf[:, :, sl])
        if track:
            h, (C, n, m) = checkpoint(mlstm_chunk, *args, use_reentrant=False)
        else:
            h, (C, n, m) = mlstm_chunk(*args)
        hs.append(h)
    h = torch.cat(hs, 2)[:, :, :S].transpose(1, 2)
    return h, {"C": C, "n": n, "m": m}


def _on_heads(core, q, k, v, i_gate, f_gate, state):
    """``core(q, k, v, i_gate, f_gate, state)`` (the chunkwise form or
    the recurrent step); on a DTensor mesh chip by chip over its rows and
    heads (``sharding.dtensor.on_chips``)."""
    heads, state_heads = {"batch": 0, "head": 2}, {"batch": 0, "head": 1}

    def flat(q, k, v, i, f, C, n, m):
        h, new = core(q, k, v, i, f, {"C": C, "n": n, "m": m})
        return h, new["C"], new["n"], new["m"]

    h, C, n, m = dtensor.on_chips(
        flat, (q, k, v, i_gate, f_gate, state["C"], state["n"], state["m"]),
        (heads,) * 5 + (state_heads,) * 3, (heads,) + (state_heads,) * 3)
    return h, {"C": C, "n": n, "m": m}


def mlstm_recurrent_ref(q, k, v, i_gate, f_gate, state):
    """Step-by-step oracle (same signature, one step per position)."""
    B, S, H, dk = q.shape
    scale = 1.0 / math.sqrt(dk)
    C, n, m = state["C"], state["n"], state["m"]
    hs = []
    for t in range(S):
        qt = q[:, t].float() * scale                      # (B,H,dk)
        kt, vt = k[:, t].float(), v[:, t].float()
        it = i_gate[:, t]
        logf = F.logsigmoid(f_gate[:, t])
        m_new = torch.maximum(logf + m, it)
        fprime = torch.exp(logf + m - m_new)
        iprime = torch.exp(it - m_new)
        C = C * fprime[..., None, None] + iprime[..., None, None] * (
            kt[..., :, None] * vt[..., None, :])
        n = n * fprime[..., None] + iprime[..., None] * kt
        num = (qt[..., None, :] @ C)[..., 0, :]
        den = (qt * n).sum(dim=-1)
        hs.append(num / torch.maximum(den.abs(), torch.exp(-m_new))[..., None])
        m = m_new
    return torch.stack(hs, 1), {"C": C, "n": n, "m": m}


def mlstm_forward(params, x, *, cfg: ArchConfig, state=None, runtime=None):
    """Full-sequence mLSTM block.  x (B,S,d) -> (out (B,S,d), state with
    the conv tail kept for decode continuity)."""
    xc, d_in, _, _ = _mdims(cfg)
    compute = torch_dtype(cfg.compute_dtype)
    B, S, _ = x.shape
    fresh = state is None
    if fresh:
        state = init_mlstm_state(cfg, B, device=x.device)
    q, k, v, i_gate, f_gate, z, xm = _mlstm_qkvif(params, x, cfg, compute)
    if fresh and runtime is not None and runtime.use_kernels:
        # the kernel starts from the zero state
        h, core = _on_heads(
            lambda *a: ops.mlstm_chunkwise(*a[:5], chunk=xc.chunk,
                                           h_dtype=torch.float32),
            q, k, v, i_gate, f_gate, state)
    else:
        h, core = _on_heads(
            lambda *a: mlstm_chunkwise(*a, chunk=xc.chunk),
            q, k, v, i_gate, f_gate, state)
    h = apply_norm(params["head_norm"], merge_heads(h, B, S, d_in),
                   "rmsnorm")
    out = (h.to(compute) * F.silu(z)) @ params["down_proj"].to(compute)
    new_state = dict(core)
    tail = xc.s_conv - 1
    new_state["conv"] = xm[:, S - tail:].float() if S >= tail else \
        torch.cat([state["conv"][:, S:], xm.float()], dim=1)
    return out.to(x.dtype), new_state


def mlstm_decode(params, x, state, *, cfg: ArchConfig):
    """Single-step recurrent decode.  x (B,1,d) -> (out (B,1,d), state)."""
    xc, d_in, d_qk, H = _mdims(cfg)
    compute = torch_dtype(cfg.compute_dtype)
    B = x.shape[0]
    up = x[:, 0].to(compute) @ params["up_proj"].to(compute)
    xm, z = halves(up)
    window = torch.cat([state["conv"].to(compute), xm[:, None]], dim=1)
    conv_w = params["conv_w"].to(compute)
    xcn = F.silu((window * conv_w[None]).sum(dim=1)
                 + params["conv_b"].to(compute))
    q = split_heads(xcn @ params["wq"].to(compute), B, 1, H, d_qk // H)
    k = split_heads(xcn @ params["wk"].to(compute), B, 1, H, d_qk // H)
    v = split_heads(xm @ params["wv"].to(compute), B, 1, H, d_in // H)
    gif = (xm @ params["w_if"].to(compute)).float() + params["b_if"]
    i_gate, f_gate = gif[:, None].chunk(2, dim=-1)
    h, core = _on_heads(mlstm_recurrent_ref, q, k, v, i_gate, f_gate, state)
    h = apply_norm(params["head_norm"], merge_heads(h, B, 1, d_in),
                   "rmsnorm")
    out = (h[:, 0].to(compute) * F.silu(z)) @ params["down_proj"].to(compute)
    new_state = dict(core)
    new_state["conv"] = window[:, 1:].float()
    return out[:, None].to(x.dtype), new_state


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------


def init_slstm(generator, cfg: ArchConfig, dtype) -> dict:
    """Weights drawn on ``generator`` in the reference's order."""
    d = cfg.d_model
    xc = cfg.xlstm
    device = generator.device
    d_up = int(4 * d / 3) // 2 * 2
    conv_w = (_normal(generator, (xc.s_conv, d))
              / math.sqrt(xc.s_conv)).to(at_use(dtype))
    w_gates = dense_init(generator, d, 4 * d, dtype, cast_at_use=False)
    r_gates = dense_init(generator, d, 4 * d, dtype, scale=0.01,
                         cast_at_use=False)
    up_proj = dense_init(generator, d, 2 * d_up, dtype)
    down_proj = dense_init(generator, d_up, d, dtype)
    return {
        "conv_w": conv_w,
        "conv_b": torch.zeros((d,), dtype=at_use(dtype), device=device),
        "w_gates": w_gates,
        "r_gates": r_gates,
        "b_gates": torch.cat([torch.zeros((d,), device=device),
                              torch.full((d,), 3.0, device=device),
                              torch.zeros((2 * d,), device=device)]),
        "up_proj": up_proj,
        "down_proj": down_proj,
        "out_norm": init_norm("rmsnorm", d, dtype, device),
    }


def init_slstm_state(cfg: ArchConfig, batch: int, leading: tuple = (),
                     device=None) -> dict:
    """Fresh state and conv tail (stacked over ``leading``)."""
    d = cfg.d_model
    lead = tuple(leading) + (batch,)
    zeros = lambda: torch.zeros(lead + (d,), device=device)  # noqa: E731
    return {"c": zeros(), "n": zeros(), "h": zeros(),
            "m": torch.full(lead + (d,), -1e30, device=device),
            "conv": torch.zeros(lead + (cfg.xlstm.s_conv - 1, d),
                                device=device)}


def _slstm_inputs(params, xconv):
    """The input side of the gates, ``xconv @ W + b``, hoisted out of the
    loop as one product, and ``R``, both float32."""
    gates_x = (xconv.float() @ params["w_gates"].float()
               + params["b_gates"])
    return gates_x, params["r_gates"].float()


def _slstm_loop(gates_x, R, c, n, h, m):
    """One :func:`slstm_step` per position of ``gates_x`` (B,S,4d).
    Returns (hs (B,S,d), c, n, h, m)."""
    hs = []
    for t in range(gates_x.shape[1]):
        c, n, h, m = slstm_step(c, n, h, m, gates_x[:, t], R)
        hs.append(h)
    return torch.stack(hs, 1), c, n, h, m


def _slstm_scan(params, xconv, state):
    """xconv (B,S,d) -> (hs (B,S,d), {c, n, h, m}): the exponentially
    gated recurrence, one :func:`slstm_step` per position (the model's own
    form; its step loop folded under a dry run's count,
    ``layers.step_loop``)."""
    gates_x, R = _slstm_inputs(params, xconv)
    hs, c, n, h, m = step_loop(
        _slstm_loop, (gates_x, R) + tuple(state[k] for k in "cnhm"),
        (True,) + (False,) * 5, (True,) + (False,) * 4)
    return hs, {"c": c, "n": n, "h": h, "m": m}


def _slstm_recurrence(params, xconv, state, use_kernels: bool):
    """The recurrence over ``xconv`` (B,S,d): the kernel, or the model's
    own step."""
    if use_kernels:
        hs, (c, n, h, m) = ops.slstm_scan(
            *_slstm_inputs(params, xconv), state["c"], state["n"],
            state["h"], state["m"])
        return hs, {"c": c, "n": n, "h": h, "m": m}
    return _slstm_scan(params, xconv, state)


def _slstm_scan_maybe_sharded(params, xconv, state, runtime):
    """The recurrence with its batch split over the mesh's batch axes,
    when ``runtime`` has a mesh and they divide the batch; else on one
    device.  On a DTensor mesh (``runtime.dmesh``) the recurrence runs on
    each chip's rows (``sharding.dtensor.slstm_region``).

    Each device runs the recurrence of its rows with its own copies of
    the gate weights, and the rows are joined on ``xconv``'s device.  The
    weights' gradients come back through the copies and are added once,
    after the loop: the reference's reason for its ``shard_map`` region
    (without it GSPMD put the weight-gradient all-reduce inside the
    per-timestep backward loop)."""
    use_kernels = runtime is not None and runtime.use_kernels
    mesh = getattr(runtime, "mesh", None)
    dmesh = getattr(runtime, "dmesh", None)
    baxes = getattr(runtime, "batch_axes", None)
    B = xconv.shape[0]
    if ((mesh is None and dmesh is None) or not baxes
            or B % max(runtime.batch_axis_size, 1)):
        return _slstm_recurrence(params, xconv, state, use_kernels)
    if dmesh is not None:
        return dtensor.slstm_region(
            lambda *a: _slstm_recurrence(*a, use_kernels), params, xconv,
            state, runtime)
    devices = axis_devices(mesh, tuple(baxes))
    used = {k: params[k] for k in ("w_gates", "r_gates", "b_gates")}
    xs = split_blocks(xconv, devices)
    states = {k: split_blocks(state[k], devices) for k in ("c", "n", "h", "m")}
    outs = []
    for i, dev in enumerate(devices):
        with on_device(dev):
            outs.append(_slstm_recurrence(
                {k: v.to(dev) for k, v in used.items()}, xs[i],
                {k: s[i] for k, s in states.items()}, use_kernels))
    home = xconv.device
    hs = torch.cat([o[0].to(home) for o in outs])
    core = {k: torch.cat([o[1][k].to(home) for o in outs])
            for k in ("c", "n", "h", "m")}
    return hs, core


def slstm_forward(params, x, *, cfg: ArchConfig, state=None, runtime=None):
    """Full-sequence sLSTM block.  x (B,S,d) -> (out (B,S,d), state)."""
    xc = cfg.xlstm
    compute = torch_dtype(cfg.compute_dtype)
    B, S, _ = x.shape
    if state is None:
        state = init_slstm_state(cfg, B, device=x.device)
    xp = torch.cat([dtensor.placed_like(state["conv"].to(compute), x, 1),
                    x.to(compute)], dim=1)
    xconv = _causal_conv(xp, params["conv_w"].to(compute),
                         params["conv_b"].to(compute), S)
    hs, core = _slstm_scan_maybe_sharded(params, xconv, state, runtime)
    hs = apply_norm(params["out_norm"], hs.to(x.dtype), "rmsnorm")
    up = hs.to(compute) @ params["up_proj"].to(compute)
    a, g = halves(up)
    out = (F.gelu(a, approximate="tanh") * g) @ params["down_proj"].to(compute)
    new_state = dict(core)
    new_state["conv"] = xp[:, S:].float()
    return out.to(x.dtype), new_state


def slstm_decode(params, x, state, *, cfg: ArchConfig):
    """Single-step decode: the block over one token from ``state``, on
    the model's own step (no runtime, as the reference)."""
    return slstm_forward(params, x, cfg=cfg, state=state)

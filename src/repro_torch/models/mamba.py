"""Mamba-1 selective SSM block (port of ``repro.models.mamba``, used by
jamba-v0.1).

The parameter tree is the reference's (``in_proj``, ``conv_w``, ``conv_b``,
``x_proj``, ``dt_proj``, ``dt_bias``, ``A_log``, ``D``, ``out_proj``), with
``dt_bias``, ``A_log`` and ``D`` in float32 whatever the param dtype, so a
JAX tree loads through ``weights.params_from_numpy`` unchanged.

Two scan paths, as in the reference:

- ``runtime.use_kernels``: ``kernels.ops.selective_scan``, the selective
  scan kernel on the card (its plain version on the CPU).  No gradient: the
  eval and signature forwards;
- otherwise the model's own :func:`selective_scan_ref`, a loop over S in
  chunks of ``mamba.chunk`` steps, the path local training runs under
  autograd.

Memory of the model's scan under autograd: one step keeps a few
``(B, d_in, N)`` float32 tensors for its backward (``exp(dt*A)``, the state
it multiplied, the products), about 8-10 GB for the 512 steps of one
full-width Jamba layer at batch 8.  The reference wraps each chunk in
``jax.checkpoint`` so that only the chunk-boundary states are kept; the
port does the same with ``torch.utils.checkpoint`` (non-reentrant): the
forward keeps each chunk's inputs and outputs, and the backward recomputes
one chunk at a time, which bounds the saved steps to ``chunk`` of them.

``mamba_decode`` is the reference's single recurrent step against the
carried state (the scan state ``h`` and the conv tail), in plain PyTorch
as the reference computes it in ``jnp``; a prefill through the kernel
hands its final ``h`` over as that state.
"""
from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import (_normal, at_use, dense_init,
                                       step_loop, torch_dtype)
from repro_torch.sharding import dtensor


def _dims(cfg: ArchConfig):
    mc = cfg.mamba
    d_in = mc.expand * cfg.d_model
    dt_rank = mc.dt_rank or -(-cfg.d_model // 16)
    return mc, d_in, dt_rank


def init_mamba(generator, cfg: ArchConfig, dtype) -> dict:
    """Weights drawn on ``generator`` in the reference's order."""
    mc, d_in, dt_rank = _dims(cfg)
    device = generator.device
    a = torch.arange(1, mc.d_state + 1, dtype=torch.float32,
                     device=device)[None].repeat(d_in, 1)
    in_proj = dense_init(generator, cfg.d_model, 2 * d_in, dtype)
    conv_w = (_normal(generator, (mc.d_conv, d_in))
              / math.sqrt(mc.d_conv)).to(at_use(dtype))
    x_proj = dense_init(generator, d_in, dt_rank + 2 * mc.d_state, dtype)
    dt_proj = dense_init(generator, dt_rank, d_in, dtype, cast_at_use=False)
    out_proj = dense_init(generator, d_in, cfg.d_model, dtype)
    return {
        "in_proj": in_proj,
        "conv_w": conv_w,
        "conv_b": torch.zeros((d_in,), dtype=at_use(dtype), device=device),
        "x_proj": x_proj,
        "dt_proj": dt_proj,
        "dt_bias": torch.log(torch.expm1(torch.full(
            (d_in,), 0.01, dtype=torch.float32, device=device))),
        "A_log": torch.log(a),
        "D": torch.ones((d_in,), dtype=torch.float32, device=device),
        "out_proj": out_proj,
    }


def init_mamba_state(cfg: ArchConfig, batch: int, leading: tuple = (),
                     device=None) -> dict:
    """Zero scan state and conv tail (stacked over ``leading``, as a
    stage's decode cache)."""
    mc, d_in, _ = _dims(cfg)
    lead = tuple(leading)
    return {
        "h": torch.zeros(lead + (batch, d_in, mc.d_state),
                         dtype=torch.float32, device=device),
        "conv": torch.zeros(lead + (batch, mc.d_conv - 1, d_in),
                            dtype=torch.float32, device=device),
    }


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``logaddexp(x, 0)``."""
    return torch.logaddexp(x, x.new_zeros(()))


def _ssm_params(params, xb, cfg: ArchConfig, compute):
    """xb (..., d_in) conv-activated input -> dt (softplus), B, C.  Bc and
    Cc are views into one projection (row stride ``dt_rank + 2N``)."""
    mc, d_in, dt_rank = _dims(cfg)
    proj = xb.to(compute) @ params["x_proj"].to(compute)
    dt, Bc, Cc = proj.float().split([dt_rank, mc.d_state, mc.d_state],
                                    dim=-1)
    dt = dtensor.summed_onto_features(dt @ params["dt_proj"].float()) \
        + params["dt_bias"]
    return _softplus(dt), Bc, Cc


def mamba_forward(params, x, *, cfg: ArchConfig, state=None, runtime=None):
    """Full-sequence scan.  x (B,S,d) -> (out (B,S,d), final state)."""
    mc, d_in, _ = _dims(cfg)
    compute = torch_dtype(cfg.compute_dtype)
    B, S, _ = x.shape
    xz = x.to(compute) @ params["in_proj"].to(compute)
    xs, z = dtensor.halves(xz)                                # (B,S,d_in)

    if state is None:
        state = init_mamba_state(cfg, B, device=x.device)
    # causal depthwise conv over time (prepend the carried tail)
    tail = dtensor.placed_like(state["conv"].to(compute), xs, 1)
    xp = torch.cat([tail, xs], dim=1)                         # (B,S+dc-1,d_in)
    conv_w = params["conv_w"].to(compute)
    xconv = sum(xp[:, i:i + S] * conv_w[i] for i in range(mc.d_conv))
    xb = F.silu(xconv + params["conv_b"].to(compute))

    dt, Bc, Cc = _ssm_params(params, xb, cfg, compute)        # (B,S,*)
    A = -torch.exp(params["A_log"])                           # (d_in,N)
    xbf = xb.float()

    if runtime is not None and runtime.use_kernels:
        scan = ops.selective_scan
    else:
        scan = functools.partial(selective_scan_ref, chunk=mc.chunk)
    # on a DTensor mesh, chip by chip over its rows and channels
    y, h_last = dtensor.on_chips(
        scan, (xbf, dt, A, Bc, Cc, state["h"]),
        (_ROWS_CHANS, _ROWS_CHANS, {"chan": 0}, {"batch": 0},
         {"batch": 0}, {"batch": 0, "chan": 1}),
        (_ROWS_CHANS, {"batch": 0, "chan": 1}))
    y = y + xbf * params["D"]
    out = (y.to(compute) * F.silu(z)) @ params["out_proj"].to(compute)
    new_state = {"h": h_last, "conv": xp[:, -(mc.d_conv - 1):].float()}
    return out.to(x.dtype), new_state


_ROWS_CHANS = {"batch": 0, "chan": 2}


def _scan_chunk(h, A, x, dt, Bc, Cc):
    ys = []
    for t in range(x.shape[1]):
        dtt = dt[:, t]
        da = torch.exp(dtt[..., None] * A)                    # (B,d_in,N)
        h = da * h + (dtt * x[:, t])[..., None] * Bc[:, t, None, :]
        ys.append((h * Cc[:, t, None, :]).sum(-1))            # (B,d_in)
    return h, torch.stack(ys, 1)


def selective_scan_ref(x, dt, A, Bc, Cc, h0, chunk: int = 256):
    """Chunked sequential selective scan (the model's own path).

    x, dt (B,S,d_in) f32; A (d_in,N); Bc, Cc (B,S,N); h0 (B,d_in,N).
    Returns (y (B,S,d_in), h_last).  Under autograd each chunk runs under
    ``torch.utils.checkpoint``.  Inside ``torch.func.vmap`` (the cohort
    engine's training) an input's ``requires_grad`` reads False and the
    scan keeps every step: a checkpoint's backward would recompute the
    chunk outside the vmap.  The reference pads S to a multiple of the
    chunk; a padded step (dt = 0, x = 0, B = 0) leaves h exactly as it
    was, so the port stops at S instead.  Under a dry run's count each
    chunk's step loop is folded (``layers.step_loop``).
    """
    track = torch.is_grad_enabled() and any(
        t.requires_grad for t in (x, dt, A, Bc, Cc, h0))

    def run(*args):
        if track:
            return checkpoint(_scan_chunk, *args, use_reentrant=False)
        return _scan_chunk(*args)

    h, ys = h0, []
    for s0 in range(0, x.shape[1], chunk):
        args = (h, A) + tuple(a[:, s0:s0 + chunk] for a in (x, dt, Bc, Cc))
        h, y = step_loop(run, args,
                         (False, False, True, True, True, True),
                         (False, True))
        ys.append(y)
    y = torch.cat(ys, 1) if ys else torch.zeros_like(x)
    return y, h


def mamba_decode(params, x, state, *, cfg: ArchConfig):
    """Single-token recurrent step.  x (B,1,d) -> (out (B,1,d), state)."""
    mc, d_in, _ = _dims(cfg)
    compute = torch_dtype(cfg.compute_dtype)
    xz = x[:, 0].to(compute) @ params["in_proj"].to(compute)
    xs, z = dtensor.halves(xz)                               # (B,d_in)
    conv_w = params["conv_w"].to(compute)
    window = torch.cat([state["conv"].to(compute), xs[:, None]], dim=1)
    xconv = (window * conv_w[None]).sum(dim=1)
    xb = F.silu(xconv + params["conv_b"].to(compute))
    dt, Bc, Cc = _ssm_params(params, xb, cfg, compute)
    A = -torch.exp(params["A_log"])
    xbf = xb.float()
    da = torch.exp(dt[..., None] * A)
    h = da * state["h"] + (dt * xbf)[..., None] * Bc[:, None, :]
    y = (h * Cc[:, None, :]).sum(-1) + xbf * params["D"]
    out = (y.to(compute) * F.silu(z)) @ params["out_proj"].to(compute)
    return out[:, None].to(x.dtype), {"h": h, "conv": window[:, 1:].float()}

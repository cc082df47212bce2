"""Train and eval step builders used by the launcher (port of
``repro.train.step``).

``make_train_step`` folds the loss, its gradient, clipping, the optimizer
update and the DAG-AFL signature extraction into one call.  The reference
returns new parameter and optimizer trees from a jitted program; the port
updates them in place and returns the same trees.  Training runs the
plain attention and the models' own scans under autograd (the kernels
have no backward, as in the reference); the Eq. 3 signature in the
metrics comes from the signature kernel on the card, taken on the
detached final-norm output (``models.transformer.forward_hidden``).

``make_serve_prefill`` / ``make_serve_decode`` are the serving pair
(decode = ONE new token against the caches), run under
``torch.inference_mode()``; the prefill launches the kernels with
``runtime.use_kernels`` (``runtime.serve_runtime``), the decode step is
plain PyTorch, as the reference's.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.aggregate import f32_mean, tree_leaves, tree_map
from repro_torch.models import transformer as tfm
from repro_torch.models.layers import torch_dtype
from repro_torch.optim.optimizers import (Optimizer, adamw, apply_updates,
                                          clip_by_global_norm)
from repro_torch.runtime import Runtime
from repro_torch.sharding import dtensor


def default_optimizer(cfg: ArchConfig, lr: float = 3e-4) -> Optimizer:
    return adamw(lr, weight_decay=0.1,
                 moment_dtype=torch_dtype(cfg.moment_dtype))


def _split(key: str, leaf: torch.Tensor, n: int):
    """A batch leaf cut into ``n`` microbatches along its batch axis: axis
    1 of M-RoPE's (3, B, S) ``positions``, else axis 0.  The reference
    takes axis 1 of any 3-D leaf of 3 rows, so at batch 3 it would cut an
    encoder's ``enc_embed`` (3, n_ctx, d) over its frames; the port
    decides by the leaf's key.  A DTensor sharded on that axis (the dry
    run's) is cut chip by chip (``sharding.dtensor.microbatches``)."""
    axis = 1 if key == "positions" and leaf.dim() == 3 else 0
    if leaf.shape[axis] % n:
        raise ValueError(f"batch {leaf.shape[axis]} does not split into "
                         f"{n} microbatches")
    return dtensor.microbatches(leaf, axis, n)


def make_train_step(cfg: ArchConfig, optimizer: Optional[Optimizer] = None,
                    runtime: Runtime = Runtime(want_signature=True),
                    clip_norm: float = 1.0, microbatches: int = 1):
    """(train_step, optimizer).  ``train_step(params, opt_state, batch)``
    returns (params, opt_state, metrics) with ``loss``, ``ce_loss``,
    ``moe_aux``, ``grad_norm`` and, with ``runtime.want_signature``,
    ``signature``.  ``microbatches > 1`` splits the batch and accumulates
    the gradients in float32 (the masters' ``.grad``, in place), as the
    reference's scan does, and takes their mean by the float32
    reciprocal, as its jitted ``/ n``."""
    opt = optimizer or default_optimizer(cfg)
    compute = torch_dtype(cfg.compute_dtype)

    def cast_params(p):
        """Compute against a copy in the compute type (the reference's
        mixed precision); gradients reach the float32 masters."""
        return tree_map(lambda a: a.to(compute)
                        if a.is_floating_point() and a.dtype != compute
                        else a, p)

    def backward(params, batch):
        """The batch's loss backward: its float32 gradient added into the
        float32 masters' ``.grad``."""
        loss, aux = tfm.loss_fn(cast_params(params), batch, cfg, runtime)
        loss.backward()
        return loss.detach(), {k: v.detach() for k, v in aux.items()}

    def take_grads(params):
        grads = tree_map(lambda p: dtensor.gradient_placed(p.grad, p),
                         params)
        for p in tree_leaves(params):
            p.grad = None          # held by the tree alone: freed once used
        return grads

    def train_step(params, opt_state, batch):
        for p in tree_leaves(params):
            p.requires_grad_(True)
            p.grad = None
        if microbatches == 1:
            loss, aux = backward(params, batch)
            grads = take_grads(params)
        else:
            # each microbatch's gradient is added into ``.grad`` in place,
            # the reference's float32 ``gsum + g`` without a second tree
            pieces = {k: _split(k, v, microbatches)
                      for k, v in batch.items()}
            loss = torch.zeros((), device=tree_leaves(params)[0].device)
            aux_sum = {"ce_loss": torch.zeros_like(loss),
                       "moe_aux": torch.zeros_like(loss)}
            sigs = []
            for i in range(microbatches):
                mb = {k: v[i] for k, v in pieces.items()}
                mb_loss, mb_aux = backward(params, mb)
                loss = loss + mb_loss
                aux_sum = {k: aux_sum[k] + mb_aux[k] for k in aux_sum}
                if "signature" in mb_aux:
                    sigs.append(mb_aux["signature"])
            grads = take_grads(params)
            # the jitted reference's ``/ n`` is a multiply by the float32
            # reciprocal of n
            inv = float(np.float32(1) / np.float32(microbatches))
            grads = tree_map(lambda g: g.mul_(inv), grads)
            loss = loss * inv
            aux = {k: v * inv for k, v in aux_sum.items()}
            if sigs and runtime.want_signature:
                aux["signature"] = f32_mean(torch.stack(sigs), dim=0)
        with torch.no_grad():
            grads, gnorm = clip_by_global_norm(grads, clip_norm)
            updates, opt_state = opt.update(grads, opt_state, params)
            apply_updates(params, updates)
        metrics = {"loss": loss, "ce_loss": aux["ce_loss"],
                   "moe_aux": aux["moe_aux"], "grad_norm": gnorm}
        if "signature" in aux:
            metrics["signature"] = aux["signature"]
        return params, opt_state, metrics

    return train_step, opt


def make_serve_prefill(cfg: ArchConfig, runtime: Runtime = Runtime()):
    """``serve_prefill(params, batch)`` -> (last logits (B, V), caches)."""

    @torch.inference_mode()
    def serve_prefill(params, batch):
        last_logits, caches, _ = tfm.prefill(params, batch, cfg, runtime)
        return last_logits, caches

    return serve_prefill


def make_serve_decode(cfg: ArchConfig, runtime: Runtime = Runtime()):
    """``serve_decode(params, token, caches, pos)`` -> (next token (B,)
    int32, logits (B, V), caches updated in place); ``pos`` a Python
    int."""

    @torch.inference_mode()
    def serve_decode(params, token, caches, pos):
        logits, new_caches = tfm.decode_step(params, token, caches, pos, cfg,
                                             runtime)
        next_token = dtensor.greedy_token(logits)
        return next_token, logits, new_caches

    return serve_decode


def make_eval_step(cfg: ArchConfig, runtime: Runtime = Runtime()):
    """``eval_step(params, batch)`` -> {"accuracy"}: next-token accuracy of
    the logits over the batch's tokens, a float32 mean by the
    reciprocal."""

    @torch.inference_mode()
    def eval_step(params, batch):
        logits, _ = tfm.forward(params, batch, cfg, runtime, mode="prefill")
        pred = logits[:, :-1].argmax(-1)
        return {"accuracy": f32_mean(pred == batch["tokens"][:, 1:])}

    return eval_step

"""Carry model weights between the JAX reference and the port, and rest a
model's weights in its compute type.

The port keeps the reference's layouts in its parameter trees (HWIO conv
weights, ``(in, out)`` dense weights), so a JAX parameter tree, turned into
numpy with ``jax.tree_util.tree_map(np.asarray, params)``, loads unchanged.
Arrays are copied on the way in: JAX hands out read-only buffers, which
``torch.from_numpy`` would share.

A compute replica (``compute_replica``, ``draw_compute_replica``) is the
port's choice of where a serving or tip-selection model's weights rest,
not the reference's: the parameters stay float32 as drawn, and the leaves
that every use casts to ``cfg.compute_dtype`` rest in it.  Those are the
matrices and biases the products read (the embedding and unembedding, the
attention, MLA, MLP, router and expert weights and QKV biases, the Mamba
and xLSTM projections and convolutions): each use reads
``leaf.to(compute)``, which a leaf already in the compute type returns as
it is, so every forward, prefill and decode step gives the float32 tree's
values bit for bit (``F.embedding`` gathers rows and casts them after, the
same values as casting the table first).  Every other leaf stays as it is:
the norm scales and biases, Mamba's ``dt_proj``, ``dt_bias``, ``A_log``
and ``D``, and the xLSTM gates' ``b_if``, ``w_gates``, ``r_gates`` and
``b_gates``, which some use reads in float32.  The draw sites in
``models/`` mark which leaves are which (``layers.at_use``).  A replica is
for forwards only: training keeps float32 masters.  At llama4-maverick's
period (18,553,267,200 parameters) it is 37.11 GB against the float32
tree's 74.21.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.aggregate import tree_map
from repro_torch.models import layers
from repro_torch.models import transformer as tfm


def params_from_numpy(tree, device) -> dict:
    """Tree of numpy arrays -> the same tree of tensors on ``device``."""
    return tree_map(
        lambda a: torch.from_numpy(np.array(a, copy=True)).to(device), tree)


def params_to_numpy(params) -> dict:
    """Tree of tensors -> the same tree of numpy arrays (copies)."""
    return tree_map(lambda t: t.detach().cpu().numpy().copy(), params)


def draw_compute_replica(generator: torch.Generator, cfg) -> dict:
    """``compute_replica(models.transformer.init_params(generator, cfg),
    cfg)``, bit for bit, without the float32 tree: ``init_params`` draws
    in its own order, and each weight that every use casts to the compute
    type is cast to it as soon as it is drawn, so the peak is the replica
    and one float32 leaf."""
    token = layers.AT_USE_DTYPE.set(layers.torch_dtype(cfg.compute_dtype))
    try:
        return tfm.init_params(generator, cfg)
    finally:
        layers.AT_USE_DTYPE.reset(token)


def compute_replica(params, cfg) -> dict:
    """``params`` (a tree of ``cfg``'s layout) with the leaves that every
    use casts to ``cfg.compute_dtype`` cast to it, and every other leaf
    as it is (the same tensor).  Which leaves those are is read from a
    shape-only draw of the replica."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    compute = layers.torch_dtype(cfg.compute_dtype)
    with FakeTensorMode():
        rests = draw_compute_replica(torch.Generator(), cfg)
    return tree_map(lambda p, r: p.to(compute) if r.dtype == compute else p,
                    params, rests)

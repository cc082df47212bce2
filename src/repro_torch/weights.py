"""Carry model weights between the JAX reference and the port.

The port keeps the reference's layouts in its parameter trees (HWIO conv
weights, ``(in, out)`` dense weights), so a JAX parameter tree, turned into
numpy with ``jax.tree_util.tree_map(np.asarray, params)``, loads unchanged.
Arrays are copied on the way in: JAX hands out read-only buffers, which
``torch.from_numpy`` would share.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.aggregate import tree_map


def params_from_numpy(tree, device) -> dict:
    """Tree of numpy arrays -> the same tree of tensors on ``device``."""
    return tree_map(
        lambda a: torch.from_numpy(np.array(a, copy=True)).to(device), tree)


def params_to_numpy(params) -> dict:
    """Tree of tensors -> the same tree of numpy arrays (copies)."""
    return tree_map(lambda t: t.detach().cpu().numpy().copy(), params)

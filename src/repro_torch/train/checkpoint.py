"""Checkpointing: flat-key ``.npz`` snapshots of model trees (port of
``repro.train.checkpoint``).

Keys are the reference's tree paths, joined by ``/``: a dict key as
itself, a list or tuple index as ``[i]`` (``stages/[0]/l0/core/wq``), and
the step under ``__step__``, so a file written by either package loads in
the other.  Leaves keep their types; a bfloat16 tensor is stored as its
raw 2-byte words (numpy has no bfloat16: the reference's ``np.asarray``
of a bfloat16 array writes the same ``V2`` bytes) and read back as
bfloat16.  Python numbers in a tree (an optimizer's step) are stored as
numpy scalars and restored as Python numbers.
"""
from __future__ import annotations

import os
from typing import Tuple

import numpy as np
import torch


def _walk(tree, prefix=()):
    """(path, leaf) pairs in the reference's flatten order: dict keys
    sorted, sequences in order; None is an empty subtree."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _walk(tree[k], prefix + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _walk(v, prefix + (f"[{i}]",))
    elif tree is not None:
        yield "/".join(prefix), tree


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view("V2")
        return t.numpy()
    return np.asarray(leaf)


def _from_numpy(arr: np.ndarray, like):
    if not isinstance(like, torch.Tensor):
        return type(like)(arr.item())
    if arr.dtype.kind == "V" and arr.dtype.itemsize == 2:
        t = torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr, copy=True))
    return t.to(like.dtype).reshape(like.shape).to(like.device)


def save_checkpoint(path: str, tree, step: int = 0) -> str:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    flat = {key: _to_numpy(leaf) for key, leaf in _walk(tree)}
    flat["__step__"] = np.asarray(step)
    np.savez(path, **flat)
    return path


def load_checkpoint(path: str, like) -> Tuple[object, int]:
    """Restore into the structure of ``like`` (values replaced by the
    file's, on ``like``'s devices and in its types)."""
    if not path.endswith(".npz"):
        path = path + ".npz"
    data = np.load(path)
    step = int(data["__step__"]) if "__step__" in data else 0
    keys = dict(_walk(like))
    missing = [k for k in keys if k not in data.files]
    if missing:
        raise KeyError(f"checkpoint missing keys: {missing[:5]}...")
    values = {k: _from_numpy(data[k], leaf) for k, leaf in keys.items()}

    def rebuild(tree, prefix=()):
        if isinstance(tree, dict):
            return {k: rebuild(tree[k], prefix + (str(k),)) for k in tree}
        if isinstance(tree, (list, tuple)):
            return type(tree)(rebuild(v, prefix + (f"[{i}]",))
                              for i, v in enumerate(tree))
        if tree is None:
            return None
        return values["/".join(prefix)]

    return rebuild(like), step

"""Client training backend for DAG-AFL (port of ``repro.fl.backend``).

``CNNBackend`` is the paper-faithful path: VGG-family clients on image data
with exact Eq. 3 zero-count signatures, which go through the signature
kernel on the card.  It runs on the CUDA card unless ``device`` says
otherwise, and raises where there is no card and no device was given.
Batches are drawn with the reference's numpy RNG calls, so the same seed
gives the same batches.  The LM backend is not ported yet.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.configs.cnn import CNNConfig
from repro_torch.core.aggregate import tree_leaves, tree_map
from repro_torch.data.synthetic import Dataset
from repro_torch.models import cnn as cnn_mod
from repro_torch.optim.optimizers import apply_updates, sgd
from repro_torch.runtime import resolve_device


class CNNBackend:
    """VGG-family clients on image data (the paper's experimental setup)."""

    def __init__(self, cfg: CNNConfig, lr: float = 0.01,
                 local_epochs: int = 5, batch_size: int = 64, device=None):
        self.cfg = cfg
        self.lr = lr
        self.local_epochs = local_epochs
        self.batch_size = batch_size
        self.device = resolve_device(device)
        self.opt = sgd(lr, momentum=0.9)

    def _tensor(self, array: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(array).to(self.device)

    # -- public API ----------------------------------------------------------

    def init(self, generator: torch.Generator) -> dict:
        """A model drawn on ``generator``, placed on the backend's device."""
        return tree_map(lambda t: t.to(self.device),
                        cnn_mod.init_cnn(generator, self.cfg))

    def init_opt(self, params):
        return self.opt.init(params)

    def _batches(self, ds: Dataset, rng) -> tuple:
        """One epoch of batches as numpy arrays: xb (n_batches, B, H, W, C),
        yb (n_batches, B)."""
        n = (len(ds) // self.batch_size) * self.batch_size
        if n == 0:  # tiny shard: single batch with repetition
            idx = rng.integers(0, len(ds), self.batch_size)
            return ds.x[idx][None], ds.y[idx][None]
        idx = rng.permutation(len(ds))[:n]
        xb = ds.x[idx].reshape(-1, self.batch_size, *ds.x.shape[1:])
        yb = ds.y[idx].reshape(-1, self.batch_size)
        return xb, yb

    def train_local(self, params, ds: Dataset, seed: int = 0,
                    epochs: Optional[int] = None):
        """Local SGD epochs from ``params`` (left untouched); returns the
        trained model and the last epoch's mean loss."""
        rng = np.random.default_rng(seed)
        params = tree_map(lambda p: p.detach().clone().requires_grad_(True),
                          params)
        opt_state = self.init_opt(params)
        loss = torch.zeros(())
        for _ in range(epochs or self.local_epochs):
            xb, yb = self._batches(ds, rng)
            xb, yb = self._tensor(xb), self._tensor(yb)
            losses = []
            for x, y in zip(xb, yb):
                step_loss, _ = cnn_mod.cnn_loss(
                    params, {"images": x, "labels": y}, self.cfg)
                step_loss.backward()
                with torch.no_grad():
                    grads = tree_map(lambda p: p.grad, params)
                    updates, opt_state = self.opt.update(grads, opt_state,
                                                         params)
                    apply_updates(params, updates)
                for p in tree_leaves(params):
                    p.grad = None
                losses.append(step_loss.detach())
            loss = torch.stack(losses).mean()
        return tree_map(lambda p: p.detach(), params), float(loss)

    @torch.inference_mode()
    def evaluate(self, params, ds: Dataset, limit: int = 512) -> float:
        n = min(len(ds), limit)
        return float(cnn_mod.cnn_accuracy(params, self._tensor(ds.x[:n]),
                                          self._tensor(ds.y[:n]), self.cfg))

    @torch.inference_mode()
    def signature(self, params, ds: Dataset, limit: int = 128) -> np.ndarray:
        n = min(len(ds), limit)
        _, sig = cnn_mod.cnn_forward(params, self._tensor(ds.x[:n]),
                                     self.cfg, want_signature=True)
        return sig.cpu().numpy()

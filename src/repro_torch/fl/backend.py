"""Client training backends for DAG-AFL (port of ``repro.fl.backend``).

``CNNBackend`` is the paper-faithful path: VGG-family clients on image data
with exact Eq. 3 zero-count signatures, which go through the signature
kernel on the card.  ``LMBackend`` federates a transformer on token
streams (the dense GQA decoders, with sliding windows past 2,048 tokens
or M-RoPE, MLA over MoE layers, Jamba's hybrid of Mamba and attention
blocks, or xLSTM's mLSTM and sLSTM blocks): its eval and signature
forwards run the flash attention, selective scan, chunkwise mLSTM, sLSTM
and bucketed signature kernels on the card, and its local training runs
under autograd on the plain attention paths and the models' own scans
(the kernels have no gradient, as in the reference).

Both run on the CUDA card unless ``device`` says otherwise, and raise where
there is no card and no device was given.  Batches are drawn with the
reference's numpy RNG calls, so the same seed gives the same batches.
Accuracies are means as the reference's jitted ``jnp.mean`` computes them
(``core.aggregate.f32_mean``).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.configs.cnn import CNNConfig
from repro_torch.core.aggregate import f32_mean, tree_leaves, tree_map
from repro_torch.data.synthetic import Dataset
from repro_torch.models import cnn as cnn_mod
from repro_torch.models import transformer as tfm
from repro_torch.optim.optimizers import apply_updates, sgd
from repro_torch.runtime import Runtime, resolve_device


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
                del grads, updates       # not held through the next step
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


class LMBackend:
    """Transformer clients on token streams (framework-scale DAG-AFL)."""

    def __init__(self, cfg: ArchConfig, lr: float = 3e-3,
                 local_steps: int = 8, batch_size: int = 8, seq_len: int = 64,
                 device=None):
        self.cfg = cfg
        self.local_steps = local_steps
        self.batch_size = batch_size
        self.seq_len = seq_len
        self.device = resolve_device(device)
        self.opt = sgd(lr, momentum=0.9)
        # training runs the default runtime: plain attention and the
        # models' own scans under autograd, each period checkpointed
        # (remat), no signature.  Eval and signature forwards: the
        # kernels
        self.eval_runtime = Runtime(use_kernels=True)
        self.signature_runtime = Runtime(use_kernels=True,
                                         want_signature=True)

    def init(self, generator: torch.Generator) -> dict:
        """A model drawn on ``generator``, placed on the backend's device."""
        return tree_map(lambda t: t.to(self.device),
                        tfm.init_params(generator, self.cfg))

    def init_opt(self, params):
        return self.opt.init(params)

    def _sample(self, stream: np.ndarray, rng, n: int) -> np.ndarray:
        """n batches of windows: (n, B, seq_len + 1) tokens."""
        starts = rng.integers(0, len(stream) - self.seq_len - 1,
                              (n, self.batch_size))
        return np.stack([
            np.stack([stream[s:s + self.seq_len + 1] for s in row])
            for row in starts])

    def _batch(self, tokens: np.ndarray) -> dict:
        t = torch.from_numpy(tokens).to(self.device)
        return {"tokens": t[:, :-1], "labels": t[:, 1:]}

    def train_local(self, params, stream: np.ndarray, seed: int = 0,
                    epochs: Optional[int] = None):
        """``epochs`` (else ``local_steps``) SGD steps from ``params`` (left
        untouched); returns the trained model and the mean step loss."""
        rng = np.random.default_rng(seed)
        toks = self._sample(stream, rng, epochs or self.local_steps)
        params = tree_map(lambda p: p.detach().clone().requires_grad_(True),
                          params)
        opt_state = self.init_opt(params)
        losses = []
        for tb in toks:
            loss, _ = tfm.loss_fn(params, self._batch(tb), self.cfg)
            loss.backward()
            with torch.no_grad():
                grads = tree_map(lambda p: p.grad, params)
                updates, opt_state = self.opt.update(grads, opt_state, params)
                apply_updates(params, updates)
            # the step's gradients go with their ``.grad``: held through the
            # next step's backward they would be a fourth float32 copy of
            # the model beside the parameters, the next step's gradients and
            # SGD's momentum
            del grads, updates
            for p in tree_leaves(params):
                p.grad = None
            losses.append(loss.detach())
        return (tree_map(lambda p: p.detach(), params),
                float(f32_mean(torch.stack(losses))))

    @torch.inference_mode()
    def evaluate(self, params, stream: np.ndarray, seed: int = 1) -> float:
        """Next-token accuracy on one sampled batch."""
        rng = np.random.default_rng(seed)
        batch = self._batch(self._sample(stream, rng, 1)[0])
        logits, _ = tfm.forward(params, batch, self.cfg, self.eval_runtime,
                                mode="prefill")
        return float(f32_mean(logits.argmax(-1) == batch["labels"]))

    @torch.inference_mode()
    def signature(self, params, stream: np.ndarray,
                  seed: int = 2) -> np.ndarray:
        """The Eq. 3 signature (``signature_dims`` fractions) of the
        final-norm output on one sampled batch."""
        rng = np.random.default_rng(seed)
        batch = self._batch(self._sample(stream, rng, 1)[0])
        _, aux = tfm.forward_hidden(params, batch, self.cfg,
                                    self.signature_runtime, mode="prefill")
        return aux["signature"].cpu().numpy()

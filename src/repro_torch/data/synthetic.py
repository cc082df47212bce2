"""Synthetic datasets generated from a seed (no MNIST/CIFAR downloads).

PyTorch port of ``repro.data.synthetic``: numpy only, copied as it is, so
every dataset is bit-identical to the reference's.

``make_image_dataset`` builds class-conditional image data with learnable
structure: each class has a smooth prototype image; samples are prototype +
noise + random brightness.  A small CNN separates the classes well, so
accuracy curves behave like the paper's (centralized > federated > indep).

``make_lm_dataset`` builds token streams from a mixture of per-client Markov
chains so transformer clients also see heterogeneous, learnable data.
"""
from __future__ import annotations

import zlib
from dataclasses import dataclass
from typing import Dict, Tuple

import numpy as np


def _name_salt(name: str) -> int:
    """Stable per-dataset seed offset.  Builtin ``hash()`` is salted by
    ``PYTHONHASHSEED`` and would generate different data in every process;
    crc32 is stable across processes, platforms, and Python versions.

    The ``:v1`` suffix versions the derivation: bumping it re-rolls every
    synthetic dataset at once, the escape hatch if a draw ever lands
    pathologically (e.g. an untrained model scoring far above chance, which
    the bare ``crc32(name)`` draw for "mnist" did)."""
    return zlib.crc32(f"{name}:v1".encode("utf-8")) % (2 ** 16)


@dataclass
class Dataset:
    x: np.ndarray
    y: np.ndarray

    def __len__(self):
        return len(self.y)


def _prototypes(n_classes: int, size: int, channels: int, rng) -> np.ndarray:
    """Smooth per-class prototype images (low-frequency random fields)."""
    base = rng.normal(0, 1, (n_classes, size // 4 + 1, size // 4 + 1, channels))
    protos = np.zeros((n_classes, size, size, channels), np.float32)
    for c in range(n_classes):
        img = base[c]
        img = np.kron(img, np.ones((4, 4, 1)))[:size, :size]
        protos[c] = img
    protos /= np.maximum(np.abs(protos).max(axis=(1, 2, 3), keepdims=True), 1e-6)
    return protos.astype(np.float32)


def make_image_dataset(name: str, n_samples: int = 6000, n_classes: int = 10,
                       size: int = 16, channels: int = 1, noise: float = 0.35,
                       seed: int = 0) -> Dataset:
    rng = np.random.default_rng(seed + _name_salt(name))
    protos = _prototypes(n_classes, size, channels, rng)
    y = rng.integers(0, n_classes, n_samples)
    x = protos[y]
    x = x * rng.uniform(0.7, 1.3, (n_samples, 1, 1, 1)).astype(np.float32)
    x = x + rng.normal(0, noise, x.shape).astype(np.float32)
    return Dataset(x.astype(np.float32), y.astype(np.int32))


DATASET_SPECS = {
    # name: (classes, size, channels, noise) — difficulty ordered like the
    # paper's MNIST < CIFAR-10 < CIFAR-100
    "mnist": (10, 16, 1, 0.30),
    "cifar10": (10, 16, 3, 0.55),
    "cifar100": (20, 16, 3, 0.70),
}


def make_benchmark_dataset(name: str, n_samples: int = 6000, seed: int = 0
                           ) -> Dataset:
    n_classes, size, ch, noise = DATASET_SPECS[name]
    return make_image_dataset(name, n_samples, n_classes, size, ch, noise, seed)


def split_811(ds: Dataset, seed: int = 0) -> Dict[str, Dataset]:
    """Paper §IV-A: train/val/test at 8:1:1."""
    rng = np.random.default_rng(seed)
    idx = rng.permutation(len(ds))
    n = len(ds)
    n_tr, n_val = int(0.8 * n), int(0.1 * n)
    sl = {
        "train": idx[:n_tr],
        "val": idx[n_tr:n_tr + n_val],
        "test": idx[n_tr + n_val:],
    }
    return {k: Dataset(ds.x[v], ds.y[v]) for k, v in sl.items()}


def make_lm_dataset(vocab: int = 512, n_tokens: int = 200_000, order: float = 2.0,
                    seed: int = 0) -> np.ndarray:
    """Markov-chain token stream: learnable synthetic LM data."""
    rng = np.random.default_rng(seed)
    trans = rng.dirichlet(np.full(vocab, 1.0 / order), size=vocab)
    toks = np.zeros(n_tokens, np.int32)
    toks[0] = rng.integers(vocab)
    cum = np.cumsum(trans, axis=1)
    u = rng.random(n_tokens)
    for i in range(1, n_tokens):
        toks[i] = np.searchsorted(cum[toks[i - 1]], u[i])
    return np.clip(toks, 0, vocab - 1)

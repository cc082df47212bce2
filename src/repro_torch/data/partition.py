"""Client data partitioning: IID and Dirichlet non-IID (paper §IV-A).

Smaller beta => more heterogeneous label distributions and size deviation,
matching the paper's beta in {0.1, 0.05} settings.

PyTorch port of ``repro.data.partition``: numpy only, copied as it is, so
the partitions are bit-identical to the reference's.
"""
from __future__ import annotations

from typing import List

import numpy as np

from repro_torch.data.synthetic import Dataset


def partition_iid(ds: Dataset, n_clients: int, seed: int = 0) -> List[Dataset]:
    rng = np.random.default_rng(seed)
    idx = rng.permutation(len(ds))
    return [Dataset(ds.x[s], ds.y[s]) for s in np.array_split(idx, n_clients)]


def partition_dirichlet(ds: Dataset, n_clients: int, beta: float,
                        seed: int = 0, min_per_client: int = 8) -> List[Dataset]:
    """Label-Dirichlet partition: p(class c on client k) ~ Dir(beta).

    Clients below ``min_per_client`` rows are topped up by sampling the
    missing rows WITHOUT replacement from the global pool, excluding rows
    the client already owns — so a client never holds duplicate rows.
    Overlap semantics: topped-up rows may still be owned by OTHER clients
    (cross-client sharing is inherent to a top-up from a fixed pool); the
    Dirichlet split itself remains disjoint across clients."""
    rng = np.random.default_rng(seed)
    n_classes = int(ds.y.max()) + 1
    client_idx: List[List[int]] = [[] for _ in range(n_clients)]
    for c in range(n_classes):
        idx_c = np.where(ds.y == c)[0]
        rng.shuffle(idx_c)
        props = rng.dirichlet(np.full(n_clients, beta))
        cuts = (np.cumsum(props) * len(idx_c)).astype(int)[:-1]
        for k, part in enumerate(np.split(idx_c, cuts)):
            client_idx[k].extend(part.tolist())
    # ensure no client is starved (tiny random top-up, duplicate-free)
    for k in range(n_clients):
        missing = min_per_client - len(client_idx[k])
        if missing > 0:
            pool = np.setdiff1d(np.arange(len(ds)),
                                np.asarray(client_idx[k], dtype=int))
            extra = rng.choice(pool, size=min(missing, len(pool)),
                               replace=False)
            client_idx[k].extend(extra.tolist())
    out = []
    for k in range(n_clients):
        sel = np.asarray(client_idx[k])
        rng.shuffle(sel)
        out.append(Dataset(ds.x[sel], ds.y[sel]))
    return out


def label_distribution(parts: List[Dataset], n_classes: int) -> np.ndarray:
    dist = np.zeros((len(parts), n_classes))
    for k, p in enumerate(parts):
        for c in range(n_classes):
            dist[k, c] = np.sum(p.y == c)
    return dist

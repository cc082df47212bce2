"""Feature signatures and the similarity 'smart contract' (paper Eq. 3-5).

``cosine_similarity_matrix`` is Eq. 5 over the clients' posted signatures;
the :class:`SimilarityContract` mirrors the paper's on-chain contract that
stores a per-round client-similarity matrix for later queries.

Port of ``repro.core.signature``.  The contract holds host-side data (an
n_clients x n_clients matrix of float32), so it stays on the CPU, as the
reference keeps it in numpy.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch


def cosine_similarity_matrix(signatures: torch.Tensor) -> torch.Tensor:
    """signatures (n_clients, n_sig) -> (n_clients, n_clients) cosine sims."""
    s = signatures.float()
    norm = torch.linalg.vector_norm(s, dim=-1, keepdim=True)
    s = s / torch.clamp(norm, min=1e-12)
    return s @ s.T


def cosine_similarity(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a = a.float()
    b = b.float()
    denom = torch.clamp(torch.linalg.vector_norm(a)
                        * torch.linalg.vector_norm(b), min=1e-12)
    return torch.dot(a, b) / denom


class SimilarityContract:
    """Smart-contract stand-in: records similarity matrices per round and
    answers top-p most-similar queries (paper §III-B3)."""

    def __init__(self, n_clients: int):
        self.n_clients = n_clients
        self._rounds: Dict[int, np.ndarray] = {}
        self._latest_sig: Dict[int, np.ndarray] = {}

    def post_signature(self, client_id: int, signature) -> None:
        self._latest_sig[client_id] = np.asarray(signature, np.float32)

    def signatures_known(self) -> Sequence[int]:
        return sorted(self._latest_sig)

    def commit_round(self, round_idx: int) -> Optional[np.ndarray]:
        """Compute + store the similarity matrix from the latest signatures."""
        if len(self._latest_sig) < 2:
            return None
        ids = sorted(self._latest_sig)
        sigs = torch.stack([torch.from_numpy(self._latest_sig[i])
                            for i in ids])
        mat = cosine_similarity_matrix(sigs).numpy()
        full = np.full((self.n_clients, self.n_clients), np.nan, np.float32)
        for a, ia in enumerate(ids):
            for b, ib in enumerate(ids):
                full[ia, ib] = mat[a, b]
        self._rounds[round_idx] = full
        return full

    def query(self, round_idx: int, client_id: int) -> Optional[np.ndarray]:
        """Similarity row for ``client_id`` at the latest round <= round_idx."""
        rounds = [r for r in self._rounds if r <= round_idx]
        if not rounds:
            return None
        return self._rounds[max(rounds)][client_id]

    def most_similar(self, round_idx: int, client_id: int,
                     candidates: Sequence[int], p: int) -> Sequence[int]:
        row = self.query(round_idx, client_id)
        if row is None:
            return list(candidates)[:p]
        scored = sorted(candidates,
                        key=lambda c: -(row[c] if not np.isnan(row[c]) else -2.0))
        return scored[:p]

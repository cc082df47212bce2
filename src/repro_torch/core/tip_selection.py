"""Tip selection (paper §III-B): freshness + reachability + model accuracy.

The selection pipeline for client ``c`` choosing N tips:

  1. Alg. 1 BFS from c's latest transaction splits current tips into
     reachable / unreachable.
  2. N1 = round(lambda*N) reachable tips: validated directly on c's local
     validation set, ranked by ``freshness * accuracy``.
  3. N2 = N - N1 unreachable tips: the similarity contract pre-filters the
     p most signature-similar candidates (Eq. 5), only those are validated,
     and the top N2 by accuracy are kept — this is the paper's trick for
     avoiding accuracy evaluation of every tip.
  4. Shortfalls on either side spill over to the other; if the DAG has
     fewer than N tips, all of them are selected.

Eq. 2 as printed increases with dwell time, contradicting the paper's prose;
``literal_eq2=True`` reproduces the printed formula, the default implements
the prose (see DESIGN.md).

API
---
:class:`TipSelector` is the selection engine: construct it once per
(ledger, contract, config) and call :meth:`TipSelector.select` with a
:class:`TipSelectionRequest` and a :class:`TipEvaluator`.  The evaluator
protocol unifies the old ``evaluate_fn`` / ``evaluate_batch`` callable pair:
``evaluate(tx_id) -> accuracy`` validates one tip, ``warm(tx_ids)`` lets a
vectorized backend validate a whole candidate set in one batched dispatch
(the per-tip ``evaluate`` then serves from its cache).

PyTorch port of ``repro.core.tip_selection``, copied as it is; the
deprecated ``select_tips`` wrapper is left out.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import (Callable, List, Optional, Protocol, Sequence,
                    runtime_checkable)

from repro_torch.core.dag import LedgerView
from repro_torch.core.signature import SimilarityContract


@dataclass(frozen=True)
class TipSelectionConfig:
    n_select: int = 2            # N (paper default: two tips per transaction)
    lam: float = 0.5             # lambda: reachable fraction
    alpha: float = 0.1           # freshness dwell-time decay factor
    p_similar: int = 4           # p: candidates pre-filtered by similarity
    literal_eq2: bool = False    # reproduce the paper's printed Eq. 2
    use_freshness: bool = True
    use_similarity: bool = True  # ablation: disable signature pre-filter
    # at large populations, consider only this many FRESHEST tips as
    # candidates (served from the ledger's freshness-ordered tip index)
    # instead of scanning the whole tip set; None = consider every tip
    max_tip_candidates: Optional[int] = None


def tipc(cur_epoch: int, tip_epoch: int) -> float:
    """Eq. 1: epoch-gap factor, exp(-|T_cur - T_tip|) in (0, 1]."""
    return math.exp(-abs(cur_epoch - tip_epoch))


def freshness(cur_epoch: int, tip_epoch: int, now: float, tip_time: float,
              alpha: float, literal_eq2: bool = False) -> float:
    """Eq. 2 (prose semantics by default; see module docstring)."""
    t = tipc(cur_epoch, tip_epoch)
    dwell = max(now - tip_time, 0.0)
    decay = 1.0 / (1.0 + alpha * dwell)
    if literal_eq2:
        return 1.0 / max(t * decay, 1e-12)
    return t * decay


@dataclass
class TipScore:
    tx_id: str
    reachable: bool
    freshness: float
    accuracy: float
    score: float


@dataclass(frozen=True)
class TipSelectionRequest:
    """One client's selection query: who is asking, and when."""

    client_id: int
    cur_epoch: int
    now: float
    round_idx: int = 0


@runtime_checkable
class TipEvaluator(Protocol):
    """Validates candidate tips on the requesting client's local data.

    ``evaluate`` is the expensive per-tip step the similarity filter
    minimises; ``warm`` receives each candidate set before the per-tip
    loop so a vectorized backend can validate the whole set in one batched
    dispatch and serve ``evaluate`` from its cache — the set of evaluated
    tips (and therefore the simulated validation cost) is identical either
    way.
    """

    def evaluate(self, tx_id: str) -> float: ...

    def warm(self, tx_ids: Sequence[str]) -> None: ...


class FnTipEvaluator:
    """Adapter from the legacy ``evaluate_fn`` / ``evaluate_batch`` callable
    pair to the :class:`TipEvaluator` protocol."""

    def __init__(self, evaluate_fn: Callable[[str], float],
                 evaluate_batch: Optional[
                     Callable[[Sequence[str]], None]] = None):
        self._fn = evaluate_fn
        self._batch = evaluate_batch

    def evaluate(self, tx_id: str) -> float:
        return self._fn(tx_id)

    def warm(self, tx_ids: Sequence[str]) -> None:
        if self._batch is not None and tx_ids:
            self._batch(tx_ids)


class TipSelector:
    """The paper's §III-B selection engine over a :class:`LedgerView`."""

    def __init__(self, ledger: LedgerView,
                 contract: Optional[SimilarityContract],
                 cfg: TipSelectionConfig):
        self.ledger = ledger
        self.contract = contract
        self.cfg = cfg

    # -- candidate set -------------------------------------------------------

    def _candidate_tips(self) -> List[str]:
        cfg = self.cfg
        if cfg.max_tip_candidates is None:
            return self.ledger.tips()
        # index-backed: only the k freshest tips are considered, served
        # from the ledger's freshness-ordered tip index (sub-linear in the
        # tip count for a BoundedDAGLedger); re-sorted by id so downstream
        # iteration order matches the unrestricted path
        return sorted(self.ledger.tips_by_freshness(cfg.max_tip_candidates))

    def _fresh(self, req: TipSelectionRequest, tx_id: str) -> float:
        cfg = self.cfg
        if not cfg.use_freshness:
            return 1.0
        tx = self.ledger.get_tx(tx_id)
        return freshness(req.cur_epoch, tx.metadata.current_epoch, req.now,
                         tx.timestamp, cfg.alpha, cfg.literal_eq2)

    # -- selection -----------------------------------------------------------

    def select(self, req: TipSelectionRequest,
               evaluator: TipEvaluator) -> List[TipScore]:
        """Returns the selected tips with their diagnostic scores."""
        ledger, cfg = self.ledger, self.cfg
        all_tips = self._candidate_tips()
        # a client never selects its OWN transactions: the paper's reachable
        # set (Fig. 2) is peers who integrated your aggregate, and
        # P2P-fetching your own model is a no-op that silos training
        # (observed: self-selection via the accuracy rank costs ~10 accuracy
        # points under beta=0.1)
        tips = [t for t in all_tips
                if ledger.get_tx(t).metadata.client_id != req.client_id]
        if not tips:
            tips = all_tips
        n = min(cfg.n_select, len(tips))
        if n == 0:
            return []

        start = ledger.latest_of(req.client_id)
        # the split is restricted to the candidate set up front, so a
        # freshness-capped selection never pays an all-tips scan
        reachable, unreachable = ledger.reachable_tips(start, within=tips)

        fresh = lambda t: self._fresh(req, t)  # noqa: E731

        n1 = min(round(cfg.lam * n), len(reachable))
        n2 = min(n - n1, len(unreachable))
        n1 = min(n - n2, len(reachable))          # spill shortfall back

        chosen: List[TipScore] = []

        # -- reachable side: direct validation, freshness-weighted rank ----
        evaluator.warm(reachable)
        scored_r = []
        for t in reachable:
            acc = evaluator.evaluate(t)
            f = fresh(t)
            scored_r.append(TipScore(t, True, f, acc, f * acc))
        scored_r.sort(key=lambda s: -s.score)
        chosen.extend(scored_r[:n1])

        # -- unreachable side: similarity pre-filter, then validate --------
        if n2 > 0:
            cands = list(unreachable)
            if cfg.use_similarity and self.contract is not None:
                owners = {t: ledger.get_tx(t).metadata.client_id
                          for t in cands}
                p = max(cfg.p_similar, n2)
                owner_rank = self.contract.most_similar(
                    req.round_idx, req.client_id,
                    sorted(set(owners.values())), p)
                rank_pos = {cid: i for i, cid in enumerate(owner_rank)}
                cands.sort(
                    key=lambda t: rank_pos.get(owners[t], len(rank_pos)))
                cands = cands[:p]
            evaluator.warm(cands)
            scored_u = []
            for t in cands:
                acc = evaluator.evaluate(t)
                f = fresh(t)
                scored_u.append(TipScore(t, False, f, acc, f * acc))
            scored_u.sort(key=lambda s: -s.accuracy)
            chosen.extend(scored_u[:n2])

        # -- top-up if still short (tiny DAGs) -----------------------------
        if len(chosen) < n:
            chosen.extend(top_up_tips(
                chosen, tips, reachable, fresh, evaluator.evaluate,
                lambda ids: evaluator.warm(ids), n))
        return chosen


def top_up_tips(chosen: Sequence[TipScore], tips: Sequence[str],
                reachable: Sequence[str],
                fresh: Callable[[str], float],
                evaluate_fn: Callable[[str], float],
                evaluate_batch: Optional[Callable[[Sequence[str]], None]],
                n: int) -> List[TipScore]:
    """Fill a short selection from the not-yet-chosen tips.

    Ranks by the paper's ``freshness * accuracy`` score, exactly like the
    reachable side — ranking by freshness alone let stale-but-accurate
    garbage outrank good models.  The remainder set is batch-validated
    FIRST (when the caller has a vectorized backend), so the per-tip
    ``evaluate_fn`` serves from the warmed cache instead of paying one
    sequential dispatch per top-up tip, and freshness is computed once per
    candidate, not three times.
    """
    have = {c.tx_id for c in chosen}
    remaining = [t for t in tips if t not in have]
    if evaluate_batch is not None and remaining:
        evaluate_batch(remaining)
    reach_set = set(reachable)
    scored = []
    for t in remaining:
        f = fresh(t)                         # once per candidate
        acc = evaluate_fn(t)
        scored.append(TipScore(t, t in reach_set, f, acc, f * acc))
    scored.sort(key=lambda s: -s.score)
    return scored[: n - len(chosen)]

"""Live-traffic consensus serving: frontier -> replica publication (port of
``repro.fl.serving``).

DAG-AFL's deliverable at any instant is the Eq. 6 consensus over the current
tip frontier, but the frontier is a moving target — every client publish
reshapes it.  This module turns that moving target into something queryable
while training is still in flight:

* :class:`ConsensusPublisher` rides the event loop on a configurable cadence
  (``ServingConfig.every`` simulated seconds) and materializes the frontier
  into an immutable, versioned :class:`ServingReplica` — the Eq. 6 aggregate
  plus the exact tip tx-ids, pinned ModelStore refs, the ledger head seq and
  the sim-time stamp it was cut at.  Replicas live in a double buffer with an
  atomic active-index flip, so a query can never observe a half-written
  replica: the back slot is only made active once the replica object is
  fully formed, and the previous replica stays intact for readers that
  already grabbed it.
* Replica refs are protected from :class:`repro_torch.core.dag.
  BoundedDAGLedger` eviction the same way the coordinator protects
  pruned-while-latest models: the coordinator routes every prune-driven
  eviction through the publisher, which defers refs pinned by a live
  replica and releases them on the swap that unpins them.
* :class:`QueryStream` replays a deterministic seeded Poisson trace of
  batched queries against whatever replica is live, concurrently with
  training (same event heap, zero training-state mutation).  Per query it
  records staleness as BOTH a ledger-seq lag (``head_seq`` advances exactly
  once per publish, so these counters are deterministic event counts — the
  gateable quantity) and a sim-time lag (the paper-facing latency figure).

The host RNG streams are the reference's, call for call (the exponential
arrival gaps, the LM driver's prompt draws), so the counters equal the
reference's on the same event schedule.  An LM replica answers through
:mod:`repro_torch.launch.serve`: the prefill on the kernels, the greedy
KV-cache decode in plain PyTorch.  There is no kernel policy: the
replica's device decides between a kernel and its plain version.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.aggregate import tree_leaves


# -- configuration -----------------------------------------------------------


@dataclass(frozen=True)
class ServingConfig:
    """Knobs for the publisher + query stream (see module docstring).  The
    reference's ``kernel_policy`` has no counterpart: the device decides."""

    every: float = 5.0          # publish cadence, simulated seconds
    query_rate: float = 1.0     # Poisson arrivals per simulated second
    query_batch: int = 8        # requests folded into one batched dispatch
    seed: int = 1234            # query-trace RNG (independent of training)
    backend: str = "auto"       # "auto" | "cnn" | "lm"
    prompt_len: int = 16        # LM driver: prompt tokens per request
    new_tokens: int = 8         # LM driver: greedy-decoded continuation


# -- replica + parity helpers ------------------------------------------------


@dataclass(frozen=True)
class ServingReplica:
    """One immutable published snapshot of the consensus frontier."""

    version: int                      # 0-based publish ordinal
    params: object                    # Eq. 6 aggregate over the frontier
    frontier: Tuple[str, ...]         # tip tx-ids the aggregate was cut from
    model_refs: Tuple[str, ...]       # pinned ModelStore refs (one per tip)
    ledger_seq: int                   # ledger.head_seq() at materialization
    published_at: float               # simulated publish time


def consensus_over_refs(store, refs, device=None):
    """Eq. 6 over an explicit ref list (the replica's pinned frontier), on
    ``device`` where the store rests its models elsewhere (host memory):
    streamed from the store leaf by leaf, with ``tree_mean``'s bits."""
    return store.mean(refs, device)


def frontier_snapshot(ledger) -> Tuple[Tuple[str, ...], Tuple[str, ...]]:
    """(tip tx-ids, their model refs) for the CURRENT frontier."""
    tips = tuple(ledger.tips())
    return tips, tuple(ledger.get_tx(t).model_ref for t in tips)


def trees_bitwise_equal(a, b) -> bool:
    """Exact (bit-level) tree equality — the parity predicate: a replica
    IS the Eq. 6 aggregate, so recomputing over its pinned refs must match
    to the last bit, not to a tolerance.  Compared where the leaves live."""
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(
        x.shape == y.shape and x.dtype == y.dtype
        and torch.equal(x, y.to(x.device)) for x, y in zip(la, lb))


def replica_parity(replica: ServingReplica, store) -> bool:
    """Does the replica's params equal a fresh Eq. 6 over its own refs,
    computed on the replica's device?"""
    device = next((leaf.device for leaf in tree_leaves(replica.params)
                   if isinstance(leaf, torch.Tensor)), None)
    return trees_bitwise_equal(replica.params, consensus_over_refs(
        store, replica.model_refs, device))


# -- publisher ---------------------------------------------------------------


class ConsensusPublisher:
    """Materializes the tip frontier into double-buffered replicas.

    Single-writer (the event loop is serial), many-reader.  ``publish()``
    builds the new :class:`ServingReplica` completely in the back slot and
    only then flips ``_active`` — one reference assignment, so ``replica()``
    always returns either the old or the new snapshot, never a mixture.
    A publish tick that finds the frontier unchanged (``head_seq`` hasn't
    moved ⟺ no appends ⟺ identical tip set) is a counted no-op — the live
    replica already IS that frontier.
    """

    def __init__(self, ledger, store, loop, every: float,
                 stop: Optional[Callable[[], bool]] = None,
                 on_swap: Optional[Callable[[ServingReplica], None]] = None,
                 device=None):
        if every <= 0.0:
            raise ValueError(f"publish cadence must be > 0, got {every!r}")
        self.ledger = ledger
        self.store = store
        self.device = device          # where replicas are built
        self.loop = loop
        self.every = float(every)
        self._stop = stop
        self._on_swap = on_swap
        self._slots: List[Optional[ServingReplica]] = [None, None]
        self._active = 0
        # refs the coordinator asked to evict while a replica pinned them;
        # released (and actually evicted) by the first swap that unpins them
        self._deferred: set = set()
        self.publishes = 0            # replicas actually materialized
        self.publishes_noop = 0       # ticks that found the frontier unmoved
        self.evictions_deferred = 0
        self.evictions_released = 0

    # -- reader side ---------------------------------------------------------

    def replica(self) -> Optional[ServingReplica]:
        """The live replica (None only before the first publish)."""
        return self._slots[self._active]

    def pinned_refs(self) -> set:
        """ModelStore refs pinned by EITHER buffer slot: the back slot's
        previous replica stays readable until the next swap, so its refs
        are pinned too."""
        refs = set()
        for rep in self._slots:
            if rep is not None:
                refs.update(rep.model_refs)
        return refs

    # -- eviction protection --------------------------------------------------

    def guard_evict(self, ref: str) -> bool:
        """Coordinator hook: returns True iff the publisher takes ownership
        of evicting ``ref`` (it is pinned by a live replica); the caller
        must then NOT evict it itself."""
        if ref in self.pinned_refs():
            self._deferred.add(ref)
            self.evictions_deferred += 1
            return True
        return False

    def _release_unpinned(self) -> None:
        pinned = self.pinned_refs()
        for ref in sorted(self._deferred - pinned):
            self.store.evict(ref)
            self._deferred.discard(ref)
            self.evictions_released += 1

    # -- writer side ----------------------------------------------------------

    def publish(self) -> Optional[ServingReplica]:
        """Materialize the current frontier into the back slot and flip."""
        head = self.ledger.head_seq()
        live = self.replica()
        if live is not None and live.ledger_seq == head:
            self.publishes_noop += 1
            return None
        frontier, refs = frontier_snapshot(self.ledger)
        replica = ServingReplica(
            version=self.publishes,
            params=consensus_over_refs(self.store, refs, self.device),
            frontier=frontier, model_refs=refs,
            ledger_seq=head, published_at=self.loop.now)
        back = 1 - self._active
        self._slots[back] = replica       # fully formed before ...
        self._active = back               # ... the atomic flip
        self.publishes += 1
        self._release_unpinned()
        if self._on_swap is not None:
            self._on_swap(replica)
        return replica

    def start(self) -> None:
        """Publish v0 immediately (the genesis frontier — queries arriving
        before the first cadence tick must find A replica), then ride the
        event loop every ``self.every`` simulated seconds."""
        self.publish()
        self.loop.schedule_every(self.every, self.publish, stop=self._stop)

    def report(self) -> Dict:
        live = self.replica()
        return {
            "replica_versions": self.publishes,
            "publishes_noop": self.publishes_noop,
            "evictions_deferred": self.evictions_deferred,
            "evictions_released": self.evictions_released,
            "final_frontier_size": 0 if live is None else len(live.frontier),
            "final_replica_seq": -1 if live is None else live.ledger_seq,
        }


# -- query drivers -----------------------------------------------------------


class CNNQueryDriver:
    """Batched eval requests against the replica (CNN backend): each query
    scores a rotating deterministic window of the query pool."""

    def __init__(self, backend, query_ds, query_batch: int = 8):
        from repro_torch.data.synthetic import Dataset
        self.backend = backend
        self.ds = query_ds
        self.batch = max(1, min(int(query_batch), len(query_ds)))
        self._Dataset = Dataset
        self._cursor = 0
        self.queries = 0
        self.acc_sum = 0.0

    def serve(self, replica: ServingReplica) -> Dict:
        n = len(self.ds)
        start = (self._cursor * self.batch) % max(n - self.batch + 1, 1)
        self._cursor += 1
        window = self._Dataset(self.ds.x[start:start + self.batch],
                               self.ds.y[start:start + self.batch])
        acc = self.backend.evaluate(replica.params, window, limit=self.batch)
        self.queries += 1
        self.acc_sum += acc
        return {"accuracy": acc}

    def report(self) -> Dict:
        return {"driver": "cnn",
                "query_accuracy_mean":
                    self.acc_sum / self.queries if self.queries else 0.0}


class LMQueryDriver:
    """Prefill + KV-cache greedy decode against the replica (LM backend),
    through the same functions as ``repro_torch.launch.serve``: the
    prefill on the kernels where the replica lives on the card."""

    def __init__(self, cfg, query_batch: int = 4, prompt_len: int = 16,
                 new_tokens: int = 8, seed: int = 0):
        from repro_torch.launch.serve import greedy_decode, make_serving_fns
        self.cfg = cfg
        self.batch = int(query_batch)
        self.prompt_len = int(prompt_len)
        self.new_tokens = max(2, int(new_tokens))
        self.rng = np.random.default_rng(seed)
        self._greedy = greedy_decode
        self.prefill, self.decode = make_serving_fns(cfg)
        self.queries = 0
        self.tokens_generated = 0

    def make_batch(self, prompts: np.ndarray, device=None) -> Dict:
        """The prompts as a batch; a config with an encoder gets zero
        float32 frame embeddings (B, n_ctx, d), as in the reference."""
        b = {"tokens": torch.as_tensor(prompts, device=device)}
        if self.cfg.encoder is not None:
            b["enc_embed"] = torch.zeros(
                (prompts.shape[0], self.cfg.encoder.n_ctx, self.cfg.d_model),
                dtype=torch.float32, device=device)
        return b

    def decode_prompts(self, params, prompts: np.ndarray) -> np.ndarray:
        """Greedy continuation tokens for explicit prompts (also the parity
        probe: run the same prompts against a directly-aggregated model)."""
        device = tree_leaves(params)[0].device
        out = self._greedy(self.prefill, self.decode, self.cfg, params,
                           self.make_batch(prompts, device), self.new_tokens)
        return out["tokens"].cpu().numpy()

    def serve(self, replica: ServingReplica) -> Dict:
        prompts = self.rng.integers(
            0, self.cfg.vocab_size, (self.batch, self.prompt_len))
        tokens = self.decode_prompts(replica.params, prompts)
        self.queries += 1
        self.tokens_generated += int(tokens.size)
        return {"tokens": tokens}

    def report(self) -> Dict:
        return {"driver": "lm", "tokens_generated": self.tokens_generated}


def make_query_driver(scfg: ServingConfig, backend, query_data):
    """Build the right driver for ``scfg.backend`` ("auto" sniffs the
    backend type: LMBackend -> decode driver, anything else -> eval)."""
    kind = scfg.backend
    if kind == "auto":
        from repro_torch.fl.backend import LMBackend
        kind = "lm" if isinstance(backend, LMBackend) else "cnn"
    if kind == "lm":
        return LMQueryDriver(backend.cfg, query_batch=scfg.query_batch,
                             prompt_len=scfg.prompt_len,
                             new_tokens=scfg.new_tokens, seed=scfg.seed)
    if kind == "cnn":
        return CNNQueryDriver(backend, query_data,
                              query_batch=scfg.query_batch)
    raise ValueError(f"unknown serving backend {scfg.backend!r}")


# -- query stream ------------------------------------------------------------


class QueryStream:
    """Deterministic seeded Poisson query trace against the live replica.

    Arrival gaps are exponential draws from an own-seeded generator, pulled
    one at a time on the event loop (``EventLoop.schedule_stream``), so the
    trace is a pure function of (seed, rate) and the surrounding event
    schedule.  Serving is read-only: no training state, no shared RNG.
    """

    def __init__(self, publisher: ConsensusPublisher, driver, loop, ledger,
                 query_rate: float, seed: int,
                 stop: Optional[Callable[[], bool]] = None):
        if query_rate <= 0.0:
            raise ValueError(f"query_rate must be > 0, got {query_rate!r}")
        self.publisher = publisher
        self.driver = driver
        self.loop = loop
        self.ledger = ledger
        self.rate = float(query_rate)
        self.rng = np.random.default_rng(seed)
        self._stop = stop
        self.arrivals = 0
        self.queries = 0
        self.skipped = 0              # arrivals before any replica existed
        self.seq_lags: List[int] = []
        self.time_lags: List[float] = []
        self.version_hist: Dict[int, int] = {}
        self.wall_s = 0.0

    def start(self) -> None:
        self.loop.schedule_stream(
            lambda: self.rng.exponential(1.0 / self.rate),
            self._serve_one, stop=self._stop)

    def _serve_one(self) -> None:
        self.arrivals += 1
        rep = self.publisher.replica()
        if rep is None:
            self.skipped += 1
            return
        # staleness at ARRIVAL time: how far the frontier moved past the
        # replica, in append seqs (deterministic) and simulated seconds
        self.seq_lags.append(self.ledger.head_seq() - rep.ledger_seq)
        self.time_lags.append(self.loop.now - rep.published_at)
        self.version_hist[rep.version] = \
            self.version_hist.get(rep.version, 0) + 1
        # wall-clock spent INSIDE the driver only — reported as throughput,
        # never gated, and never fed back into simulated event times
        t0 = time.time()      # repro-lint: disable=DET003
        self.driver.serve(rep)
        self.wall_s += time.time() - t0   # repro-lint: disable=DET003
        self.queries += 1

    def report(self) -> Dict:
        lags = self.seq_lags
        return {
            "queries": self.queries,
            "arrivals": self.arrivals,
            "skipped": self.skipped,
            "replica_version_hist": {str(k): v for k, v in
                                     sorted(self.version_hist.items())},
            "distinct_versions_served": len(self.version_hist),
            "max_seq_lag": max(lags) if lags else 0,
            "mean_seq_lag": float(np.mean(lags)) if lags else 0.0,
            "max_time_lag": max(self.time_lags) if self.time_lags else 0.0,
            "mean_time_lag": (float(np.mean(self.time_lags))
                              if self.time_lags else 0.0),
            # wall-clock throughput: reported for eyeballing, NEVER gated
            "query_wall_s": self.wall_s,
            "queries_per_s": self.queries / self.wall_s if self.wall_s else 0.0,
            **self.driver.report(),
        }

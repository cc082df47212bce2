"""Event-driven asynchronous FL simulator.

*Simulated time* is the measurement substrate for the paper's Table III /
Fig. 3 claims: every client has a heterogeneity profile (compute speed, link
bandwidth, per-message latency); training, validation and transfer costs advance a
simulated clock through an event heap.  All algorithms (DAG-AFL and the 8
baselines) run on this same scheduler, so relative timings are comparable.

PyTorch port of ``repro.core.simulator``: numpy only, copied as it is, so
event order and cost draws are identical to the reference's.
"""
from __future__ import annotations

import heapq
import math
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np


@dataclass(frozen=True)
class ClientProfile:
    client_id: int
    speed: float            # local-step time multiplier (1.0 = reference)
    bandwidth: float        # bytes / second for model transfer
    latency: float          # per-message fixed latency (seconds)


def make_profiles(n_clients: int, heterogeneity: float = 0.6,
                  seed: int = 0) -> List[ClientProfile]:
    """Lognormal speed / bandwidth draws; ``heterogeneity`` is the sigma."""
    rng = np.random.default_rng(seed)
    profiles = []
    for c in range(n_clients):
        speed = float(np.exp(rng.normal(0.0, heterogeneity)))
        bw = float(50e6 * np.exp(rng.normal(0.0, heterogeneity)))
        lat = float(np.abs(rng.normal(0.05, 0.02)) + 0.01)
        profiles.append(ClientProfile(c, speed, bw, lat))
    return profiles


@dataclass
class CostModel:
    """Simulated cost of the primitive operations (reference-client seconds)."""

    local_epoch: float = 6.0        # one local epoch of training
    eval_batch: float = 0.4         # validate one model on the local val set
    signature: float = 0.15         # extract a feature signature
    chain_op: float = 0.02          # ledger append / metadata query
    model_bytes: int = 4_000_000    # serialized model size (metadata ~ 1e3)
    metadata_bytes: int = 1_024

    def train_time(self, p: ClientProfile, epochs: int, rng) -> float:
        jitter = float(np.exp(rng.normal(0.0, 0.1)))
        return self.local_epoch * epochs * p.speed * jitter

    def transfer_time(self, p: ClientProfile, nbytes: int) -> float:
        return p.latency + nbytes / p.bandwidth

    def eval_time(self, p: ClientProfile, n_models: int) -> float:
        return self.eval_batch * n_models * p.speed


class EventLoop:
    """Min-heap of (time, seq, callback)."""

    def __init__(self):
        self._heap: List[Tuple[float, int, Callable[[], None]]] = []
        self._seq = 0
        self.now = 0.0
        # negative-delay schedules clamped to "now" (observable: the cohort
        # path legitimately produces these when a round completes before its
        # window flushes — the publish lands at the flush time)
        self.clamped = 0
        # pending recurring-stream ticks (schedule_every / schedule_stream).
        # Streams re-arm only while NON-stream events remain — counting the
        # ticks themselves would let two concurrent cadences (e.g. ledger
        # checkpointing + serving publisher + query stream) keep a drained
        # simulation alive forever by each seeing the other's next tick.
        self._maintenance = 0

    def schedule(self, delay: float, fn: Callable[[], None]) -> None:
        if delay < 0.0:
            self.clamped += 1
            delay = 0.0
        t = self.now + delay
        # the clamp must hold: simulated time never runs backwards, and a
        # NaN delay would silently corrupt the heap order
        assert t >= self.now, f"schedule produced past/NaN time {t!r}"
        heapq.heappush(self._heap, (t, self._seq, fn))
        self._seq += 1

    def schedule_every(self, interval: float, fn: Callable[[], None],
                       stop: Optional[Callable[[], bool]] = None) -> None:
        """Recurring hook: run ``fn`` every ``interval`` simulated seconds
        until ``stop()`` returns True (checked before each firing) or no
        OTHER events remain — a maintenance cadence (e.g. ledger
        checkpointing) must never keep an otherwise-drained simulation
        alive.  Rides the simulated clock, not event counts."""
        if interval <= 0.0:
            raise ValueError(f"interval must be > 0, got {interval!r}")
        self.schedule_stream(lambda: interval, fn, stop=stop)

    def schedule_stream(self, next_delay: Callable[[], float],
                        fn: Callable[[], None],
                        stop: Optional[Callable[[], bool]] = None) -> None:
        """Generalized recurring hook: like :meth:`schedule_every`, but the
        gap before each firing is drawn from ``next_delay()`` (e.g. a seeded
        Poisson arrival process for a serving query stream).  Draws happen
        one at a time on the event loop, so a seeded generator stays
        deterministic.  Drain rule: the stream re-arms only while events
        OTHER than recurring-stream ticks remain pending, so any number of
        concurrent cadences wind down together once real work is done —
        two streams must not keep each other (and a finished simulation)
        alive by mutually observing the other's next tick."""

        def tick() -> None:
            self._maintenance -= 1
            if stop is not None and stop():
                return
            fn()
            if len(self._heap) > self._maintenance:   # real work pending
                self._maintenance += 1
                self.schedule(float(next_delay()), tick)

        self._maintenance += 1
        self.schedule(float(next_delay()), tick)

    def run(self, until: Optional[float] = None,
            stop: Optional[Callable[[], bool]] = None,
            max_events: int = 1_000_000) -> None:
        events = 0
        while self._heap and events < max_events:
            t, _, fn = heapq.heappop(self._heap)
            if until is not None and t > until:
                self.now = until
                return
            self.now = t
            fn()
            events += 1
            if stop is not None and stop():
                return


class CohortWindow:
    """Batches concurrent round-start requests for vectorized dispatch.

    Requests ``add()``-ed within ``window`` simulated seconds of the first
    one share a batch.  The batch flushes when it reaches ``capacity`` or,
    via a close-timer armed when the window opens, at window-end — so a
    request's dispatch (and therefore its tip staleness in DAG-AFL) is
    never deferred past ``window`` seconds, regardless of what other
    events pop in between.  ``flush_fn`` receives ``[(item, start_time)]``;
    ``stop_fn`` suppresses the timer flush after the simulation has
    converged (a mid-window stop leaves ``pending`` for the owner to
    discard).
    """

    def __init__(self, loop: EventLoop, capacity: int, window: float,
                 flush_fn: Callable, stop_fn: Callable[[], bool]):
        self.loop = loop
        self.capacity = capacity
        self.window = window
        self.flush_fn = flush_fn
        self.stop_fn = stop_fn
        self.pending: List = []
        self._gen = 0

    def add(self, item) -> None:
        self.pending.append((item, self.loop.now))
        if len(self.pending) == 1:           # window opener: arm the closer
            gen = self._gen
            self.loop.schedule(self.window, lambda: self._close(gen))
        if len(self.pending) >= self.capacity:
            self.flush()

    def _close(self, gen: int) -> None:
        if gen == self._gen and self.pending and not self.stop_fn():
            self.flush()

    def flush(self) -> None:
        batch, self.pending = self.pending, []
        self._gen += 1
        if batch:
            self.flush_fn(batch)


@dataclass
class ConvergenceTracker:
    """Validation-accuracy early stopping (paper: patience 5 on val avg)."""

    target_accuracy: Optional[float] = None
    patience: int = 5
    min_delta: float = 1e-4
    min_updates: int = 0          # never converge before this many updates
    history: List[Tuple[float, float]] = field(default_factory=list)
    best: float = -1.0
    stale_rounds: int = 0
    converged_at: Optional[float] = None

    def update(self, sim_time: float, val_acc: float) -> bool:
        self.history.append((sim_time, float(val_acc)))
        if val_acc > self.best + self.min_delta:
            self.best = float(val_acc)
            self.stale_rounds = 0
        else:
            self.stale_rounds += 1
        hit_target = (self.target_accuracy is not None
                      and val_acc >= self.target_accuracy)
        if (hit_target or self.stale_rounds >= self.patience) \
                and self.converged_at is None \
                and len(self.history) >= self.min_updates:
            self.converged_at = sim_time
        return self.converged_at is not None

    @property
    def done(self) -> bool:
        return self.converged_at is not None


@dataclass
class RunResult:
    name: str
    final_accuracy: float
    best_accuracy: float
    sim_time: float
    rounds: int
    history: List[Tuple[float, float]]
    extra: Dict = field(default_factory=dict)

    def row(self) -> str:
        return (f"{self.name:14s} acc={self.final_accuracy*100:6.2f}% "
                f"best={self.best_accuracy*100:6.2f}% "
                f"time={self.sim_time:8.1f}s rounds={self.rounds}")

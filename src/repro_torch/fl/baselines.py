"""The paper's eight competitors, all on the shared simulator substrate.

Each algorithm consumes the same (backend, client_data, global_test,
profiles, cost model) quintuple and returns a :class:`RunResult`, so the
Table II / Table III benchmark compares like with like.

  centralized   no privacy: one model on the pooled data (upper bound)
  independent   each client alone (lower bound)
  fedavg        McMahan et al. 2017 — synchronous rounds, barrier on slowest
  fedasync      Xie et al. 2019 — server mixes on every arrival, staleness-
                adaptive alpha
  fedat         Chai et al. 2021 — latency tiers: sync within, async across
  csafl         Zhang et al. 2021 — similarity clusters, semi-async groups
  fedhisyn      Li et al. 2022 — speed clusters, sequential ring inside a
                cluster then cross-cluster sync (slowest, like the paper)
  dagfl         Cao et al. 2021 — DAG ledger, but tips chosen by cumulative
                weight and EVERY candidate tip validated (no signature
                pre-filter, no freshness) — DAG-AFL's direct ancestor
  scalesfl      Madill et al. 2022 — sharded committee chain on top of
                synchronous FL (per-round consensus overhead)

Port of ``repro.fl.baselines``.  The host RNG draws (seeds, duration
jitter, join times) are the reference's, call for call, so with
convergence by patience switched off every method's simulated time and
round count are the reference's.  Two differences:

* every ``run_*`` takes the genesis model as ``init_model`` where the
  reference draws one from ``jax.random.PRNGKey(cfg.seed)``; None draws
  one from ``torch.Generator().manual_seed(cfg.seed)``;
* the scenarios' DP noise comes from ``torch.Generator``
  (``fl.cohort.perturb_update``) and matches the reference's
  ``jax.random`` noise in distribution only.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.core.aggregate import (tree_interpolate, tree_mean,
                                        tree_size_bytes, tree_weighted)
from repro_torch.core.simulator import (CohortWindow, ConvergenceTracker,
                                        CostModel, EventLoop, RunResult,
                                        make_profiles)
from repro_torch.core.tip_selection import TipSelectionConfig
from repro_torch.fl.cohort import build_cohort_engine, perturb_update
from repro_torch.fl.scenarios import as_scenario


@dataclass
class FLConfig:
    """The baselines' knobs: the port's :class:`DagAflConfig` ones only.

    The reference's ``kernel_policy`` is not ported: the tensors' device
    decides the kernels."""

    n_clients: int = 10
    max_rounds: int = 30
    local_epochs: int = 5
    target_accuracy: Optional[float] = None
    patience: int = 5
    heterogeneity: float = 0.6
    seed: int = 0
    # batched execution: up to this many concurrent client rounds on the
    # cohort engine (1 = sequential reference path)
    cohort_size: int = 1
    cohort_window: float = 1.0
    # cohort execution over a device mesh (see DagAflConfig.mesh):
    # "auto" | "CxD" | (clients, data) | None | Mesh
    mesh: object = "auto"
    clients_axis: str = "clients"
    data_axis: str = "data"
    # overlapped host pipeline (see DagAflConfig.overlap)
    overlap: bool = True
    # algorithm-specific knobs
    fedasync_alpha: float = 0.6
    fedasync_staleness: str = "poly"     # poly | constant
    n_tiers: int = 3                     # fedat / csafl / fedhisyn clusters
    dagfl_n_select: int = 2
    consensus_overhead: float = 1.5      # scalesfl per-round committee cost
    # DAG ledgers (dagfl / dagafl): > 0 switches to the bounded-frontier
    # BoundedDAGLedger, checkpointing every this many simulated seconds
    # (see DagAflConfig.ledger_checkpoint_every); 0 = append-only ledger
    ledger_checkpoint_every: float = 0.0
    # fault injection: None (honest), a repro_torch.fl.scenarios.
    # ScenarioConfig, a registry name or a prebuilt Scenario (see
    # DagAflConfig.scenario): the same scenarios attack the baselines and
    # the DAG coordinator, so a robustness run compares like with like
    scenario: object = None


class _Harness:
    """Common state for every baseline."""

    def __init__(self, backend, client_data, global_test, cfg: FLConfig,
                 cost=None, profiles=None):
        self.backend = backend
        self.scenario = as_scenario(cfg.scenario, cfg.n_clients)
        self._last_submitted: Dict[int, object] = {}
        if self.scenario is not None:
            client_data = self.scenario.poison_data(client_data)
        self.client_data = client_data
        self.global_test = global_test
        self.cfg = cfg
        self.cost = cost or CostModel()
        self.profiles = profiles or make_profiles(cfg.n_clients,
                                                  cfg.heterogeneity, cfg.seed)
        self.rng = np.random.default_rng(cfg.seed)
        self.tracker = ConvergenceTracker(cfg.target_accuracy, cfg.patience)
        # the registry decides: backends without a batched suite get no
        # engine and stay sequential
        self.cohort = build_cohort_engine(
            backend, cohort_size=cfg.cohort_size, mesh=cfg.mesh,
            clients_axis=cfg.clients_axis, data_axis=cfg.data_axis,
            overlap=cfg.overlap)
        self._val_sets = [client_data[c]["val"]
                          for c in range(cfg.n_clients)]

    def init_model(self, model=None):
        """The genesis model: ``model``, or one drawn from
        ``torch.Generator`` seeded with ``cfg.seed``."""
        if model is None:
            model = self.backend.init(
                torch.Generator().manual_seed(self.cfg.seed))
        self.cost.model_bytes = max(tree_size_bytes(model), 1)
        return model

    def train(self, model, client: int):
        out = self.backend.train_local(
            model, self.client_data[client]["train"],
            seed=int(self.rng.integers(2 ** 31)),
            epochs=self.cfg.local_epochs)[0]
        if self.scenario is not None:
            out = self._scenario_update(client, model, out)
        return out

    def _scenario_update(self, client: int, base, new):
        """Scenario fault injection on one submitted update (see
        fl/scenarios.py); lazy 'stale' free-riders resubmit whatever they
        last handed the server."""
        sc = self.scenario
        plan = sc.update_plan([client])
        if plan is not None and plan["affected"][0]:
            new = perturb_update(base, new, plan, 0)
        if sc.wants_stale(client):
            prev = self._last_submitted.get(client)
            if prev is not None:
                sc.updates_lazy += 1
                new = prev
            self._last_submitted[client] = new
        return new

    def drops(self, c: int) -> bool:
        """Scenario wireless dropout for this client's current publish."""
        return self.scenario is not None and self.scenario.drops_publish(c)

    def round_duration(self, c: int) -> float:
        """Simulated cost of one local round: train + up/down transfer."""
        t_train = self.cost.train_time(self.profiles[c],
                                       self.cfg.local_epochs, self.rng)
        if self.scenario is not None:
            t_train *= self.scenario.duration_multiplier(c)
        return (t_train
                + 2 * self.cost.transfer_time(self.profiles[c],
                                              self.cost.model_bytes))

    def train_many(self, model, clients):
        """Local rounds for several clients starting from one shared model;
        returns (local models, simulated durations).  With a cohort engine,
        capacity-sized groups run as single batched programs instead of
        len(clients) serial ``train_local`` calls.  The sequential path
        draws (seed, duration jitter) interleaved per client, and a group
        on the engine draws all its seeds first, as the reference does."""
        clients = list(clients)
        if self.cohort is None or len(clients) < 2:
            out, durs = [], []
            for c in clients:
                out.append(self.train(model, c))
                durs.append(self.round_duration(c))
            return out, durs
        out, durs = [], []
        cap = self.cfg.cohort_size
        for i in range(0, len(clients), cap):
            group = clients[i:i + cap]
            if len(group) == 1:
                out.append(self.train(model, group[0]))
                durs.append(self.round_duration(group[0]))
                continue
            seeds = [int(self.rng.integers(2 ** 31)) for _ in group]
            models, _ = self.cohort.train_cohort(
                [model] * len(group),
                [self.client_data[c]["train"] for c in group],
                seeds, epochs=self.cfg.local_epochs)
            if self.scenario is not None:
                models = [self._scenario_update(c, model, m)
                          for c, m in zip(group, models)]
            out.extend(models)
            durs.extend(self.round_duration(c) for c in group)
        return out, durs

    def val_acc(self, model, client: int) -> float:
        return self.backend.evaluate(model, self.client_data[client]["val"])

    def mean_val(self, model) -> float:
        """Mean validation accuracy over every client: on the cohort engine
        its window means (true divisions), else the backend's."""
        if self.cohort is not None:
            accs = self.cohort.evaluate_shared(model, self._val_sets)
        else:
            accs = [self.val_acc(model, c) for c in range(self.cfg.n_clients)]
        return float(np.mean(accs))

    def result(self, name, model, sim_time, rounds, extra=None) -> RunResult:
        acc = self.backend.evaluate(model, self.global_test)
        return RunResult(name=name, final_accuracy=acc,
                         best_accuracy=max(acc, self.tracker.best),
                         sim_time=sim_time, rounds=rounds,
                         history=self.tracker.history, extra=extra or {})


# ---------------------------------------------------------------------------
# bounds
# ---------------------------------------------------------------------------


def run_centralized(backend, client_data, global_test, cfg: FLConfig,
                    cost=None, profiles=None, pooled_train=None,
                    init_model=None) -> RunResult:
    h = _Harness(backend, client_data, global_test, cfg, cost, profiles)
    model = h.init_model(init_model)
    assert pooled_train is not None, "centralized needs the pooled train set"
    t = 0.0
    ref = h.profiles[0]
    for r in range(cfg.max_rounds):
        model, _ = backend.train_local(model, pooled_train, seed=r,
                                       epochs=cfg.local_epochs)
        t += h.cost.train_time(ref, cfg.local_epochs, h.rng)
        if h.tracker.update(t, h.mean_val(model)):
            break
    return h.result("Centralized", model, h.tracker.converged_at or t, r + 1)


def run_independent(backend, client_data, global_test, cfg: FLConfig,
                    cost=None, profiles=None, init_model=None) -> RunResult:
    h = _Harness(backend, client_data, global_test, cfg, cost, profiles)
    accs, times = [], []
    model0 = h.init_model(init_model)
    last = model0
    for c in range(cfg.n_clients):
        model = model0
        t = 0.0
        tr = ConvergenceTracker(cfg.target_accuracy, cfg.patience)
        for r in range(cfg.max_rounds):
            model = h.train(model, c)
            t += h.cost.train_time(h.profiles[c], cfg.local_epochs, h.rng)
            if tr.update(t, h.val_acc(model, c)):
                break
        accs.append(backend.evaluate(model, global_test))
        times.append(tr.converged_at or t)
        h.tracker.history.extend(tr.history)
        last = model
    res = h.result("Independent", last, float(np.mean(times)), cfg.max_rounds)
    res.final_accuracy = float(np.mean(accs))
    res.best_accuracy = float(np.max(accs))
    res.history = sorted(h.tracker.history)
    return res


# ---------------------------------------------------------------------------
# synchronous / asynchronous FL
# ---------------------------------------------------------------------------


def run_fedavg(backend, client_data, global_test, cfg: FLConfig,
               cost=None, profiles=None, name="FedAvg",
               round_overhead: float = 0.0, init_model=None) -> RunResult:
    h = _Harness(backend, client_data, global_test, cfg, cost, profiles)
    model = h.init_model(init_model)
    t = 0.0
    sizes = [len(client_data[c]["train"]) for c in range(cfg.n_clients)]
    for r in range(cfg.max_rounds):
        locals_, durations = h.train_many(model, range(cfg.n_clients))
        t += max(durations) + round_overhead      # synchronous barrier
        # scenario dropouts: the barrier still pays for the dropped
        # clients' rounds, but their updates never reach the server
        kept = [c for c in range(cfg.n_clients) if not h.drops(c)]
        if kept:
            model = tree_weighted([locals_[c] for c in kept],
                                  [sizes[c] for c in kept])
        if h.tracker.update(t, h.mean_val(model)):
            break
    return h.result(name, model, h.tracker.converged_at or t, r + 1)


def run_fedasync(backend, client_data, global_test, cfg: FLConfig,
                 cost=None, profiles=None, init_model=None) -> RunResult:
    h = _Harness(backend, client_data, global_test, cfg, cost, profiles)
    loop = EventLoop()
    state = {"model": h.init_model(init_model), "version": 0, "rounds": 0}

    def arrive(c: int, local, v: int):
        if not h.drops(c):      # scenario dropout: the update never arrives
            staleness = state["version"] - v
            alpha = cfg.fedasync_alpha
            if cfg.fedasync_staleness == "poly":
                alpha = alpha / (1.0 + staleness) ** 0.5
            state["model"] = tree_interpolate(state["model"], local, alpha)
            state["version"] += 1
        state["rounds"] += 1
        if state["rounds"] % cfg.n_clients == 0:
            h.tracker.update(loop.now, h.mean_val(state["model"]))
        if (not h.tracker.done
                and state["rounds"] < cfg.max_rounds * cfg.n_clients):
            loop.schedule(0.0, lambda: client_round(c))

    def client_round(c: int):
        """Sequential path: train at the round-start event from the model
        (and version) current at that event."""
        if h.tracker.done:
            return
        v = state["version"]
        local = h.train(state["model"], c)
        loop.schedule(h.round_duration(c), lambda: arrive(c, local, v))

    def flush(batch):
        """Cohort path: one batched program for the window's rounds
        (bounded staleness within cohort_window, as in the coordinator).
        The version is captured HERE, the moment state['model'] is read,
        so staleness discounting matches what each round trained from."""
        v = state["version"]
        locals_, durs = h.train_many(state["model"], [b[0] for b in batch])
        for (c_, t0_), local, dur in zip(batch, locals_, durs):
            loop.schedule(t0_ + dur - loop.now,
                          lambda c_=c_, local=local: arrive(c_, local, v))

    if h.cohort is not None:
        window = CohortWindow(loop, cfg.cohort_size, cfg.cohort_window,
                              flush, lambda: h.tracker.done)
        client_round = (lambda c: h.tracker.done or window.add(c))  # noqa: E731

    for c in range(cfg.n_clients):
        loop.schedule(float(h.rng.uniform(0, 1.0)),
                      lambda c=c: client_round(c))
    loop.run(stop=lambda: h.tracker.done)
    return h.result("FedAsync", state["model"],
                    h.tracker.converged_at or loop.now, state["rounds"])


# ---------------------------------------------------------------------------
# tiered / clustered semi-async
# ---------------------------------------------------------------------------


def _cluster_by(values: List[float], n_clusters: int) -> List[List[int]]:
    order = np.argsort(values)
    return [list(part) for part in np.array_split(order, n_clusters)]


def fedat_tier_weights(tier_updates: List[int],
                       ready: List[int]) -> List[float]:
    """FedAT's cross-tier aggregation weights (Chai et al. 2021, Eq. 4).

    Tier k's weight DECREASES in its update count T_k: straggler tiers
    update less often, so each of their (rarer) models carries more weight
    in the cross-tier average — without this, fast tiers dominate the
    global model and the stragglers' data is drowned out.  The paper's
    normalized form is p_k proportional to (sum_i T_i) - T_k; this is the
    rank-equivalent 1/T_k (both strictly decreasing in T_k, identical
    ordering).  ``tier_updates`` counts start at 1 (the init model counts
    as every tier's zeroth update), so the weights are always finite.
    """
    return [1.0 / tier_updates[i] for i in ready]


def run_fedat(backend, client_data, global_test, cfg: FLConfig,
              cost=None, profiles=None, init_model=None) -> RunResult:
    """Latency tiers: synchronous within a tier, async weighted across."""
    h = _Harness(backend, client_data, global_test, cfg, cost, profiles)
    tiers = _cluster_by([p.speed for p in h.profiles], cfg.n_tiers)
    loop = EventLoop()
    tier_models = {i: None for i in range(len(tiers))}
    state = {"model": h.init_model(init_model), "rounds": 0,
             "tier_updates": [1] * len(tiers)}

    def tier_round(ti: int, rnd: int):
        if h.tracker.done or rnd >= cfg.max_rounds:
            return
        members = tiers[ti]
        locals_, durs = h.train_many(state["model"], members)
        dur = max(durs)

        def arrive(ti=ti, locals_=locals_, rnd=rnd):
            tier_models[ti] = tree_mean(locals_)
            state["tier_updates"][ti] += 1
            # cross-tier weighted average: straggler tiers get MORE weight
            # (FedAT's inverse-frequency weighting, see fedat_tier_weights)
            ready = [i for i in tier_models if tier_models[i] is not None]
            inv = fedat_tier_weights(state["tier_updates"], ready)
            state["model"] = tree_weighted([tier_models[i] for i in ready],
                                           inv)
            state["rounds"] += 1
            h.tracker.update(loop.now, h.mean_val(state["model"]))
            if not h.tracker.done:
                loop.schedule(0.0, lambda: tier_round(ti, rnd + 1))

        loop.schedule(dur, arrive)

    for ti in range(len(tiers)):
        loop.schedule(0.0, lambda ti=ti: tier_round(ti, 0))
    loop.run(stop=lambda: h.tracker.done)
    return h.result("FedAT", state["model"],
                    h.tracker.converged_at or loop.now, state["rounds"],
                    extra={"tier_updates": list(state["tier_updates"]),
                           "tiers": [list(map(int, t)) for t in tiers]})


def run_csafl(backend, client_data, global_test, cfg: FLConfig,
              cost=None, profiles=None, init_model=None) -> RunResult:
    """Clustered semi-async: groups by data similarity (label histograms),
    sync inside a group, FedAsync-style mixing across groups."""
    h = _Harness(backend, client_data, global_test, cfg, cost, profiles)
    # group by label distribution similarity
    hists = []
    for c in range(cfg.n_clients):
        y = np.asarray(client_data[c]["train"].y)
        n_classes = int(max(y.max() for cd in [client_data[i]["train"]
                                               for i in range(cfg.n_clients)]
                            for y in [np.asarray(cd.y)])) + 1
        hist = np.bincount(y, minlength=n_classes).astype(float)
        hists.append(hist / max(hist.sum(), 1))
    proj = [float(np.argmax(hh)) + 0.01 * i for i, hh in enumerate(hists)]
    groups = _cluster_by(proj, cfg.n_tiers)
    loop = EventLoop()
    state = {"model": h.init_model(init_model), "rounds": 0, "version": 0}

    def group_round(gi: int, rnd: int, version: int):
        if h.tracker.done or rnd >= cfg.max_rounds:
            return
        members = groups[gi]
        locals_, durs = h.train_many(state["model"], members)
        dur = max(durs)

        def arrive(gi=gi, locals_=locals_, rnd=rnd, v=version):
            staleness = state["version"] - v
            alpha = cfg.fedasync_alpha / (1.0 + staleness) ** 0.5
            state["model"] = tree_interpolate(state["model"],
                                              tree_mean(locals_), alpha)
            state["version"] += 1
            state["rounds"] += 1
            h.tracker.update(loop.now, h.mean_val(state["model"]))
            if not h.tracker.done:
                loop.schedule(0.0, lambda: group_round(gi, rnd + 1,
                                                       state["version"]))

        loop.schedule(dur, arrive)

    for gi in range(len(groups)):
        loop.schedule(0.0, lambda gi=gi: group_round(gi, 0, 0))
    loop.run(stop=lambda: h.tracker.done)
    return h.result("CSAFL", state["model"],
                    h.tracker.converged_at or loop.now, state["rounds"])


def run_fedhisyn(backend, client_data, global_test, cfg: FLConfig,
                 cost=None, profiles=None, init_model=None) -> RunResult:
    """Hierarchical sync: speed clusters; inside a cluster the model is
    passed sequentially (ring), then clusters aggregate synchronously —
    sequential passes make it the slowest method, as in the paper.  The
    ring draws each member's duration jitter directly (no straggler
    multiplier), as the reference does."""
    h = _Harness(backend, client_data, global_test, cfg, cost, profiles)
    clusters = _cluster_by([p.speed for p in h.profiles], cfg.n_tiers)
    model = h.init_model(init_model)
    t = 0.0
    for r in range(cfg.max_rounds):
        cluster_models, durs = [], []
        for members in clusters:
            m = model
            dur = 0.0
            for c in members:                      # sequential ring
                m = h.train(m, c)
                dur += (h.cost.train_time(h.profiles[c], cfg.local_epochs,
                                          h.rng)
                        + 2 * h.cost.transfer_time(h.profiles[c],
                                                   h.cost.model_bytes))
            cluster_models.append(m)
            durs.append(dur)
        t += max(durs)                             # sync barrier on clusters
        sizes = [sum(len(client_data[c]["train"]) for c in members)
                 for members in clusters]
        model = tree_weighted(cluster_models, sizes)
        if h.tracker.update(t, h.mean_val(model)):
            break
    return h.result("FedHiSyn", model, h.tracker.converged_at or t, r + 1)


# ---------------------------------------------------------------------------
# blockchain-based competitors
# ---------------------------------------------------------------------------


def run_scalesfl(backend, client_data, global_test, cfg: FLConfig,
                 cost=None, profiles=None, init_model=None) -> RunResult:
    """Sharded committee chain over synchronous FL: FedAvg + per-round
    shard-consensus overhead (committee validation of every local update)."""
    h0 = CostModel() if cost is None else cost
    overhead = cfg.consensus_overhead + 0.2 * cfg.n_clients * h0.eval_batch
    return run_fedavg(backend, client_data, global_test, cfg, cost, profiles,
                      name="ScaleSFL", round_overhead=overhead,
                      init_model=init_model)


def _dag_run(backend, client_data, global_test, cfg: FLConfig, cost,
             profiles, init_model, **kw) -> RunResult:
    """One run of the port's DAG-AFL coordinator under a baseline config;
    ``kw`` sets the remaining DagAflConfig fields."""
    # imported here: the coordinator imports fl.cohort, whose package
    # imports this module
    from repro_torch.core.coordinator import DagAflConfig, DagAflCoordinator
    dcfg = DagAflConfig(
        n_clients=cfg.n_clients, max_rounds=cfg.max_rounds,
        local_epochs=cfg.local_epochs, target_accuracy=cfg.target_accuracy,
        patience=cfg.patience, heterogeneity=cfg.heterogeneity, seed=cfg.seed,
        cohort_size=cfg.cohort_size, cohort_window=cfg.cohort_window,
        mesh=cfg.mesh, clients_axis=cfg.clients_axis,
        data_axis=cfg.data_axis, overlap=cfg.overlap,
        ledger_checkpoint_every=cfg.ledger_checkpoint_every,
        scenario=cfg.scenario, **kw)
    coord = DagAflCoordinator(backend, client_data, global_test, dcfg,
                              cost, profiles)
    return coord.run(init_model)


def run_dagfl(backend, client_data, global_test, cfg: FLConfig,
              cost=None, profiles=None, init_model=None) -> RunResult:
    """DAG-FL (Cao et al.): DAG ledger, cumulative-weight tip selection,
    every candidate validated, no freshness / signature filter."""
    res = _dag_run(
        backend, client_data, global_test, cfg, cost, profiles, init_model,
        verify_paths=False,
        tip=TipSelectionConfig(n_select=cfg.dagfl_n_select, lam=0.0,
                               use_freshness=False, use_similarity=False,
                               p_similar=max(cfg.n_clients, 8)))
    res.name = "DAG-FL"
    return res


def run_dagafl(backend, client_data, global_test, cfg: FLConfig,
               cost=None, profiles=None, tip_cfg=None,
               init_model=None) -> RunResult:
    return _dag_run(backend, client_data, global_test, cfg, cost, profiles,
                    init_model, tip=tip_cfg or TipSelectionConfig())


ALGORITHMS = {
    "centralized": run_centralized,
    "independent": run_independent,
    "fedavg": run_fedavg,
    "fedasync": run_fedasync,
    "fedat": run_fedat,
    "csafl": run_csafl,
    "fedhisyn": run_fedhisyn,
    "scalesfl": run_scalesfl,
    "dagfl": run_dagfl,
    "dagafl": run_dagafl,
}

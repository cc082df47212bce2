"""DAG-AFL coordinator: task publisher + asynchronous task trainers (§III-A).

Wires the DAG ledger, tip selection, signature contract, verification and
aggregation into the event-driven simulator.  Each client runs its own
asynchronous loop:

  select tips -> P2P-fetch the selected models -> aggregate (Eq. 6) ->
  local train -> validate + extract signature -> publish metadata tx

The publisher only bootstraps (genesis), audits (hash verification) and
monitors convergence — it never trains, matching the paper.

Port of ``repro.core.coordinator``, sequential path: every client round is
its own sequence of backend calls (the reference's ``cohort_size=1``).  The
cohort engine, fault scenarios, live serving and meshes are not ported yet;
setting any of them raises ``NotImplementedError`` rather than being
ignored.  ``run(init_model=None)`` takes the genesis model itself where the
reference takes a JAX PRNG key.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.core.aggregate import tree_mean, tree_size_bytes
from repro_torch.core.dag import (BoundedDAGLedger, DAGLedger, ModelStore,
                                  TxMetadata)
from repro_torch.core.signature import SimilarityContract
from repro_torch.core.simulator import (ClientProfile, ConvergenceTracker,
                                        CostModel, EventLoop, RunResult,
                                        make_profiles)
from repro_torch.core.tip_selection import (TipSelectionConfig,
                                            TipSelectionRequest, TipSelector)
from repro_torch.core.verify import extract_path, verify_path


@dataclass
class DagAflConfig:
    n_clients: int = 10
    max_rounds: int = 30              # per-client global iterations
    local_epochs: int = 5
    target_accuracy: Optional[float] = None
    patience: int = 5
    tip: TipSelectionConfig = field(default_factory=TipSelectionConfig)
    heterogeneity: float = 0.6
    verify_paths: bool = True         # trainers audit their stored paths
    seed: int = 0
    # bounded-frontier ledger: > 0 switches to BoundedDAGLedger and folds
    # confirmed ancestry into checkpoints every this many SIMULATED seconds
    # (event-loop cadence), evicting pruned ModelStore entries.  Pruning
    # preserves tips/reachability/selection exactly (see DESIGN.md); the
    # run trajectory is identical to the unbounded ledger's, except that
    # with verify_paths=True the trainers' stored paths end at the pruned
    # boundary, so the (smaller) simulated audit cost shifts timings.
    # 0 keeps the append-only reference ledger.
    ledger_checkpoint_every: float = 0.0
    # not ported yet: each raises NotImplementedError when set
    cohort_size: int = 1
    mesh: object = "auto"
    scenario: object = None
    serve_every: float = 0.0
    serving: object = None


_UNPORTED = {"cohort_size": 1, "mesh": "auto", "scenario": None,
             "serve_every": 0.0, "serving": None}


class _ClientTipEvaluator:
    """:class:`repro_torch.core.tip_selection.TipEvaluator` for one client,
    served from the coordinator's accuracy cache."""

    def __init__(self, coord: "DagAflCoordinator", client: int):
        self.coord = coord
        self.client = client

    def evaluate(self, tx_id: str) -> float:
        return self.coord._evaluate_tip(self.client, tx_id)

    def warm(self, tx_ids) -> None:
        """Nothing to batch on the sequential path."""


class DagAflCoordinator:
    def __init__(self, backend, client_data: List[Dict], global_test,
                 cfg: DagAflConfig, cost: Optional[CostModel] = None,
                 profiles: Optional[List[ClientProfile]] = None):
        """client_data[k]: {"train": ..., "val": ..., "test": ...} per client
        (backend-specific containers)."""
        for name, default in _UNPORTED.items():
            if getattr(cfg, name) != default:
                raise NotImplementedError(
                    f"DagAflConfig.{name}={getattr(cfg, name)!r}: not ported "
                    f"to the PyTorch package yet (only {default!r})")
        self.backend = backend
        self.client_data = client_data
        self.global_test = global_test
        self.cfg = cfg
        self.cost = cost or CostModel()
        self.profiles = profiles or make_profiles(cfg.n_clients,
                                                  cfg.heterogeneity, cfg.seed)
        if cfg.ledger_checkpoint_every > 0:
            self.ledger = BoundedDAGLedger(evict_fn=self._on_prune)
        else:
            self.ledger = DAGLedger()
        self.store = ModelStore()
        # model refs whose tx was pruned while still being a client's
        # LATEST (needed by the final per-client sweep); evicted as soon as
        # the client publishes again
        self._deferred_evict: Dict[int, str] = {}
        self.contract = SimilarityContract(cfg.n_clients)
        self.selector = TipSelector(self.ledger, self.contract, cfg.tip)
        self.loop = EventLoop()
        self.tracker = ConvergenceTracker(cfg.target_accuracy, cfg.patience,
                                          min_updates=3)
        self.rng = np.random.default_rng(cfg.seed)
        self._acc_cache: Dict = {}
        self._client_rounds = [0] * cfg.n_clients
        self._client_val = [0.0] * cfg.n_clients
        self._evals_total = 0
        self._refs_issued = 0         # monotone ref keys (len() reuses slots
                                      # once pruning evicts store entries)
        self._verify_failures = 0
        self._rounds_done = 0
        self._t_last_round = 0.0

    # -- helpers -------------------------------------------------------------

    def _on_prune(self, tx) -> None:
        """BoundedDAGLedger eviction hook: drop a pruned transaction's
        ModelStore entry.  A model still referenced as some client's LATEST
        (the final per-client sweep needs it) is deferred until that client
        publishes again, so the bounded run's results match the unbounded
        ledger's exactly."""
        client = tx.metadata.client_id
        if self.ledger.latest_of(client) == tx.tx_id:
            self._deferred_evict[client] = tx.model_ref
        else:
            self.store.evict(tx.model_ref)

    def _evaluate_tip(self, client: int, tx_id: str) -> float:
        key = (client, tx_id)
        if key not in self._acc_cache:
            model = self.store.get(self.ledger.get_tx(tx_id).model_ref)
            acc = self.backend.evaluate(model, self.client_data[client]["val"])
            self._acc_cache[key] = acc
            self._evals_total += 1
        return self._acc_cache[key]

    def _publish(self, client: int, model, accuracy: float, sig, epoch: int,
                 parents) -> str:
        pending = self._deferred_evict.pop(client, None)
        if pending is not None:         # pruned-while-latest: safe to drop now
            self.store.evict(pending)
        ref = self.store.put(f"m{self._refs_issued:012d}", model)
        self._refs_issued += 1
        meta = TxMetadata(client_id=client,
                          signature=tuple(float(s) for s in np.ravel(sig)[:16]),
                          model_accuracy=float(accuracy),
                          current_epoch=epoch,
                          validation_node_id=client)
        tx = self.ledger.add_transaction(meta, parents, self.loop.now, ref)
        self.contract.post_signature(client, sig)
        self.contract.commit_round(epoch)
        return tx.tx_id

    def _start_round(self, delay: float, client: int) -> None:
        self.loop.schedule(delay, lambda: self._client_round(client))

    def _complete_round(self, client: int, model, acc: float, sig,
                        epoch: int, parents) -> None:
        """Publish at the round's simulated completion time."""
        self._publish(client, model, acc, sig, epoch, parents)
        self._client_rounds[client] += 1
        self._client_val[client] = acc
        self._rounds_done += 1
        self._t_last_round = self.loop.now
        # publisher monitors per GLOBAL round (n_clients publishes) by
        # validating the AGGREGATED tip model on every client's val set
        # — the same quantity the sync baselines track; per-client local
        # models would ace their own non-IID shards and stop too early
        if self._rounds_done % self.cfg.n_clients == 0:
            gm = self.global_model()
            accs = [self.backend.evaluate(gm, self.client_data[c]["val"])
                    for c in range(self.cfg.n_clients)]
            self.tracker.update(self.loop.now, float(np.mean(accs)))
        if (not self.tracker.done
                and self._client_rounds[client] < self.cfg.max_rounds):
            self._start_round(0.0, client)

    # -- round front half: tip selection + fetch + simulated costs ----------

    def _select_and_cost(self, client: int):
        """Tip selection, P2P fetch accounting and the path audit for one
        round; returns (model refs to aggregate, parents, t_select+t_fetch)."""
        cfgc, cost, prof = self.cfg, self.cost, self.profiles[client]
        epoch = self._client_rounds[client]

        n_evals_before = self._evals_total
        req = TipSelectionRequest(client_id=client, cur_epoch=epoch,
                                  now=self.loop.now, round_idx=epoch)
        scores = self.selector.select(req, _ClientTipEvaluator(self, client))
        n_evals = self._evals_total - n_evals_before
        t_select = cost.eval_time(prof, n_evals) + cost.chain_op * len(scores)

        refs = [self.ledger.get_tx(s.tx_id).model_ref for s in scores]
        t_fetch = sum(cost.transfer_time(prof, cost.model_bytes)
                      for _ in refs)
        if cfgc.verify_paths and scores:
            path = extract_path(self.ledger, scores[0].tx_id)
            ok, _ = verify_path(self.ledger, path)
            if not ok:
                self._verify_failures += 1
            t_fetch += cost.chain_op * len(path.records)

        if not refs:
            refs = [self.ledger.get_tx(self.ledger.genesis_id).model_ref]
        parents = tuple(s.tx_id for s in scores) or (self.ledger.genesis_id,)
        return refs, parents, epoch, t_select + t_fetch

    def _t_post(self, prof: ClientProfile) -> float:
        """Simulated cost of validate + signature + metadata publish."""
        cost = self.cost
        return (cost.eval_time(prof, 1) + cost.signature * prof.speed
                + cost.transfer_time(prof, cost.metadata_bytes))

    def _client_round(self, client: int) -> None:
        """One round: tip selection and the simulated-cost draws (seed,
        then train-time jitter, as the reference draws them), then
        aggregate, train, validate, sign, and schedule the publish at the
        round's own simulated completion time."""
        if self.tracker.done:
            return
        t_start = self.loop.now
        refs, parents, epoch, t_front = self._select_and_cost(client)
        seed = int(self.rng.integers(2 ** 31))
        t_train = self.cost.train_time(self.profiles[client],
                                       self.cfg.local_epochs, self.rng)
        agg = tree_mean([self.store.get(r) for r in refs])
        model, _ = self.backend.train_local(
            agg, self.client_data[client]["train"], seed=seed,
            epochs=self.cfg.local_epochs)
        acc = self.backend.evaluate(model, self.client_data[client]["val"])
        sig = self.backend.signature(model, self.client_data[client]["train"])
        total = t_front + t_train + self._t_post(self.profiles[client])
        self.loop.schedule(
            t_start + total - self.loop.now,
            lambda: self._complete_round(client, model, acc, sig, epoch + 1,
                                         parents))

    # -- run -------------------------------------------------------------------

    def global_model(self):
        """Average of the models at the current tips (publisher's view)."""
        tips = self.ledger.tips()
        models = [self.store.get(self.ledger.get_tx(t).model_ref)
                  for t in tips]
        return tree_mean(models) if models else None

    def run(self, init_model=None) -> RunResult:
        """Run to convergence or ``max_rounds``.  ``init_model`` is the
        genesis model; None draws one from ``torch.Generator`` seeded with
        ``cfg.seed``."""
        if init_model is None:
            init_model = self.backend.init(
                torch.Generator().manual_seed(self.cfg.seed))
        ref = self.store.put("genesis", init_model)
        self.cost.model_bytes = max(tree_size_bytes(init_model), 1)
        meta = TxMetadata(client_id=-1, signature=(0.0,) * 16,
                          model_accuracy=0.0, current_epoch=0,
                          validation_node_id=-1)
        self.ledger.add_genesis(meta, 0.0, ref)
        if self.cfg.ledger_checkpoint_every > 0:
            # simulated-clock checkpoint cadence: fold confirmed ancestry
            # and evict its models while the run is in flight
            self.loop.schedule_every(
                self.cfg.ledger_checkpoint_every,
                lambda: self.ledger.maybe_checkpoint(now=self.loop.now),
                stop=lambda: self.tracker.done)
        for c in range(self.cfg.n_clients):
            # staggered joins: asynchrony from the first event on
            self._start_round(float(self.rng.uniform(0, 2.0)), c)
        self.loop.run(stop=lambda: self.tracker.done)

        # paper Table II reports AVERAGE accuracy across participants:
        # evaluate each client's latest model on the global test set
        latest_models = []
        for c in range(self.cfg.n_clients):
            tx = self.ledger.latest_of(c)
            if tx is None:
                continue
            ref = (self._deferred_evict.get(c)
                   if not self.ledger.has_tx(tx)
                   else self.ledger.get_tx(tx).model_ref)
            if ref is None or ref not in self.store:
                continue
            latest_models.append(self.store.get(ref))
        client_accs = [self.backend.evaluate(m, self.global_test)
                       for m in latest_models]
        gm = self.global_model()
        tip_mean_acc = self.backend.evaluate(gm, self.global_test)
        client_mean = float(np.mean(client_accs)) if client_accs else 0.0
        # the publisher's deliverable is the aggregated model from the
        # current tips (the paper's 'global model'); per-client average in
        # extra for reference
        final_acc = max(tip_mean_acc, client_mean)
        return RunResult(
            name="DAG-AFL",
            final_accuracy=final_acc,
            best_accuracy=max(final_acc, self.tracker.best),
            # last ROUND completion, not loop.now: trailing maintenance
            # ticks (checkpoint cadence) are not training time
            sim_time=(self.tracker.converged_at or self._t_last_round
                      or self.loop.now),
            rounds=self._rounds_done,
            history=self.tracker.history,
            extra={
                "tip_mean_accuracy": tip_mean_acc,
                "client_mean_accuracy": client_mean,
                "tip_evaluations": self._evals_total,
                "chain_len": len(self.ledger),
                "verify_failures": self._verify_failures,
                "store_bytes_transferred": self.store.bytes_transferred,
            })

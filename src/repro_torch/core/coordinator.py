"""DAG-AFL coordinator: task publisher + asynchronous task trainers (§III-A).

Wires the DAG ledger, tip selection, signature contract, verification and
aggregation into the event-driven simulator.  Each client runs its own
asynchronous loop:

  select tips -> P2P-fetch the selected models -> aggregate (Eq. 6) ->
  local train -> validate + extract signature -> publish metadata tx

The publisher only bootstraps (genesis), audits (hash verification) and
monitors convergence — it never trains, matching the paper.

Port of ``repro.core.coordinator``.  ``cohort_size=1`` (default) runs every
client round as its own sequence of backend calls, the reference path.
``cohort_size=K`` drains the event heap in *cohort windows*: round starts
that fall within ``cohort_window`` simulated seconds of the window opener
are dispatched together on the cohort engine
(:class:`repro_torch.fl.cohort.CohortBackend`), whose batched programs
train, validate and sign the window's clients as one.  Each result is still
published at its own simulated completion time (clamped to the window's
flush time in the degenerate case of a round shorter than the window), so
simulated-time semantics are unchanged; a batched round's tip selection
may observe the DAG up to ``cohort_window`` simulated seconds away from
its own start.  Backends without a registered cohort suite stay
sequential.

Fault scenarios (``repro_torch.fl.scenarios``) attack the loop as in the
reference: poisoned shards at construction, the update transform before
validation and the signature, straggler durations, dropped publishes and
tampered metadata; a scenario with all rates zero is bit-identical to
``scenario=None``.  Live serving (``serve_every`` / ``serving``,
``repro_torch.fl.serving``) publishes the frontier's Eq. 6 replica and
replays a seeded query trace against it on the same event loop, on both
engines; it is read-only, so the training trajectory is bit-identical
with it on or off.  ``mesh`` spreads the cohort engine over a device mesh
(``repro_torch.fl.cohort``), and the window's Eq. 6 aggregation runs over
the same mesh (``core.aggregate.stacked_weighted``).
``run(init_model=None)`` takes the genesis model itself where the reference
takes a JAX PRNG key.

``store_device`` says where the published models rest
(:class:`repro_torch.core.dag.ModelStore`): ``None``, the reference's map,
keeps them where the backend made them; ``"cpu"`` keeps them in host
memory, the port's own choice for models that the card cannot hold beside
a training client.  Every read then copies a model to the backend's device
when the loop needs it, one at a time where the loop allows: a tip's
validation, Eq. 6 (streamed leaf by leaf, ``ModelStore.mean``), the
global model, and the final sweep, which on the sequential path fetches and
evaluates one client's model at a time.  A trained model moves to the
store's device as soon as it is validated and signed, ahead of its publish
time.  No value changes: the same float32 operations run in the same order
on the backend's device.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.core.aggregate import (stacked_weighted, tree_size_bytes,
                                        tree_stack, tree_unstack)
from repro_torch.core.dag import (BoundedDAGLedger, DAGLedger, ModelStore,
                                  TxMetadata)
from repro_torch.core.signature import SimilarityContract
from repro_torch.core.simulator import (ClientProfile, CohortWindow,
                                        ConvergenceTracker, CostModel,
                                        EventLoop, RunResult, make_profiles)
from repro_torch.core.tip_selection import (TipSelectionConfig,
                                            TipSelectionRequest, TipSelector)
from repro_torch.core.verify import extract_path, verify_path
from repro_torch.fl.cohort import build_cohort_engine, perturb_update
from repro_torch.fl.scenarios import as_scenario


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
    # batched execution: dispatch up to this many concurrent client rounds
    # on the cohort engine (1 = sequential reference path)
    cohort_size: int = 1
    # round starts within this many simulated seconds share a cohort window;
    # keep it below the typical round duration: a publish whose completion
    # time falls before the window flushes is clamped to the flush time
    cohort_window: float = 1.0
    # cohort execution over a device mesh: "auto" builds a clients-axis
    # mesh clamped to the devices (the visible cards for a backend on the
    # card, the backend's one device otherwise; 1 device => the exact
    # single-device engine), "CxD" (e.g. "4x2") or a (clients, data) tuple
    # (clients may be "auto") builds the 2-D (clients, data) mesh that also
    # splits each client group's training data, None forces one device, or
    # pass a repro_torch.launch.mesh.Mesh carrying ``clients_axis``
    mesh: object = "auto"
    clients_axis: str = "clients"
    data_axis: str = "data"
    # overlapped host pipeline: assemble each window's batches on a
    # background thread while the card computes (False = inline assembly,
    # bit-identical results)
    overlap: bool = True
    # fault injection: None (honest run), a repro_torch.fl.scenarios.
    # ScenarioConfig, a registry name ("poison", "lazy", ...) or a prebuilt
    # Scenario instance (pass the instance to read its event counters after
    # the run).  A scenario with all rates zero is bit-identical to None.
    scenario: object = None
    # live-traffic serving (repro_torch/fl/serving.py): > 0 publishes the
    # tip frontier's Eq. 6 aggregate into a versioned double-buffered
    # replica every this many SIMULATED seconds and replays a seeded
    # Poisson query trace against it concurrently with training.  Serving
    # is read-only: the training trajectory is bit-identical with it on or
    # off.  0 = off.
    serve_every: float = 0.0
    # query driver: "auto" sniffs the backend (LMBackend -> prefill+decode,
    # else batched eval); "cnn" / "lm" force one
    serve_backend: str = "auto"
    # full repro_torch.fl.serving.ServingConfig override (query rate/batch/
    # seed, prompt geometry); None derives one from the two knobs above
    serving: object = None


class _ClientTipEvaluator:
    """:class:`repro_torch.core.tip_selection.TipEvaluator` for one client,
    bridging the coordinator's accuracy cache and the cohort engine's
    batched validation."""

    def __init__(self, coord: "DagAflCoordinator", client: int):
        self.coord = coord
        self.client = client

    def evaluate(self, tx_id: str) -> float:
        return self.coord._evaluate_tip(self.client, tx_id)

    def warm(self, tx_ids) -> None:
        if self.coord.cohort is not None and tx_ids:
            self.coord._evaluate_tips_batch(self.client, tx_ids)


class DagAflCoordinator:
    def __init__(self, backend, client_data: List[Dict], global_test,
                 cfg: DagAflConfig, cost: Optional[CostModel] = None,
                 profiles: Optional[List[ClientProfile]] = None,
                 cohort_engine=None, store_device=None):
        """client_data[k]: {"train": ..., "val": ..., "test": ...} per client
        (backend-specific containers).  ``cohort_engine`` lets callers reuse
        one :class:`repro_torch.fl.cohort.CohortBackend` across runs.
        ``store_device``: where the published models rest (module
        docstring)."""
        self.backend = backend
        # where reads of the store put a model: the backend's device (a
        # backend without one reads models where they rest)
        self._device = getattr(backend, "device", None)
        self.scenario = as_scenario(cfg.scenario, cfg.n_clients)
        if self.scenario is not None:
            # poisoned shards exist before anything reads the data
            client_data = self.scenario.poison_data(client_data)
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
        self.store = ModelStore(store_device)
        # model refs whose tx was pruned while still being a client's
        # LATEST (needed by the final per-client sweep); evicted as soon as
        # the client publishes again
        self._deferred_evict: Dict[int, str] = {}
        # live-traffic serving (built in run() when serving is on); must
        # exist before the first _on_prune can fire
        self.publisher = None
        self.query_stream = None
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
        self._cohorts_dispatched = 0
        self._val_sets = [client_data[c]["val"] for c in range(cfg.n_clients)]
        self.cohort = None
        self._window: Optional[CohortWindow] = None
        if cfg.cohort_size > 1:
            # the registry decides: backends without a batched suite get no
            # engine and stay sequential
            self.cohort = cohort_engine or build_cohort_engine(
                backend, cohort_size=cfg.cohort_size, mesh=cfg.mesh,
                clients_axis=cfg.clients_axis, data_axis=cfg.data_axis,
                overlap=cfg.overlap)
            if self.cohort is not None:
                self._window = CohortWindow(
                    self.loop, cfg.cohort_size, cfg.cohort_window,
                    self._flush_cohort, lambda: self.tracker.done)

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
            self._evict_model(tx.model_ref)

    def _evict_model(self, ref: str) -> None:
        """Single chokepoint for prune-driven ModelStore evictions: a ref
        pinned by a live serving replica is handed to the publisher (which
        evicts it on the swap that unpins it) instead of being dropped out
        from under in-flight queries."""
        if self.publisher is not None and self.publisher.guard_evict(ref):
            return
        self.store.evict(ref)

    def _evaluate_tip(self, client: int, tx_id: str) -> float:
        key = (client, tx_id)
        if key not in self._acc_cache:
            model = self.store.get(self.ledger.get_tx(tx_id).model_ref,
                                   self._device)
            acc = self.backend.evaluate(model, self.client_data[client]["val"])
            self._acc_cache[key] = acc
            self._evals_total += 1
        return self._acc_cache[key]

    def _evaluate_tips_batch(self, client: int, tx_ids) -> None:
        """Validate every uncached candidate in one engine call; the per-tip
        ``_evaluate_tip`` then serves from the warmed cache."""
        missing = [t for t in tx_ids if (client, t) not in self._acc_cache]
        if not missing:
            return
        models = [self.store.get(self.ledger.get_tx(t).model_ref,
                                 self._device) for t in missing]
        accs = self.cohort.evaluate_many(models,
                                         self.client_data[client]["val"])
        for t, acc in zip(missing, accs):
            self._acc_cache[(client, t)] = acc
            self._evals_total += 1

    def _publish(self, client: int, model, accuracy: float, sig, epoch: int,
                 parents) -> str:
        pending = self._deferred_evict.pop(client, None)
        if pending is not None:         # pruned-while-latest: safe to drop now
            self._evict_model(pending)
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

    def _eval_global_on_vals(self, gm) -> List[float]:
        if self.cohort is not None:
            return self.cohort.evaluate_shared(gm, self._val_sets)
        return [self.backend.evaluate(gm, self.client_data[c]["val"])
                for c in range(self.cfg.n_clients)]

    def _start_round(self, delay: float, client: int) -> None:
        if self._window is not None:
            self.loop.schedule(delay, lambda: self._enqueue_round(client))
        else:
            self.loop.schedule(delay, lambda: self._client_round(client))

    def _complete_round(self, client: int, model, acc: float, sig,
                        epoch: int, parents) -> None:
        """Publish at the round's simulated completion time (both paths)."""
        if self.scenario is not None and self.scenario.drops_publish(client):
            # wireless dropout: the publish aborts mid-round (no tx, no
            # signature post); the attempt still counts against max_rounds
            # and the client retries with a fresh round
            self._client_rounds[client] += 1
            self._t_last_round = self.loop.now
            if (not self.tracker.done
                    and self._client_rounds[client] < self.cfg.max_rounds):
                self._start_round(0.0, client)
            return
        tx_id = self._publish(client, model, acc, sig, epoch, parents)
        if self.scenario is not None:
            self.scenario.maybe_tamper(self.ledger, tx_id)
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
            accs = self._eval_global_on_vals(gm)
            self.tracker.update(self.loop.now, float(np.mean(accs)))
        if (not self.tracker.done
                and self._client_rounds[client] < self.cfg.max_rounds):
            self._start_round(0.0, client)

    # -- round front half: tip selection + fetch + simulated costs ----------

    def _select_and_cost(self, client: int):
        """Tip selection, P2P fetch accounting and the path audit for one
        round; returns (model refs to aggregate, parents, t_select+t_fetch).
        Shared verbatim by the sequential and cohort paths."""
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

    def _front_half(self, client: int, t_start: float) -> Dict:
        """Tip selection and the round's simulated-cost draws, as one
        record.  RNG order (seed, then train-time jitter) is the
        reference's."""
        refs, parents, epoch, t_front = self._select_and_cost(client)
        seed = int(self.rng.integers(2 ** 31))
        t_train = self.cost.train_time(self.profiles[client],
                                       self.cfg.local_epochs, self.rng)
        if self.scenario is not None:
            # heavy-tailed straggler slowdown (x1.0 exactly for the others,
            # so the honest trajectory keeps its bits)
            t_train *= self.scenario.duration_multiplier(client)
        return {"client": client, "t_start": t_start, "refs": refs,
                "parents": parents, "epoch": epoch, "t_front": t_front,
                "t_train": t_train, "seed": seed}

    def _dispatch_one(self, rd: Dict) -> None:
        """Back half of ONE round on the backend's own calls: aggregate,
        train, validate, sign, and schedule the publish at the round's own
        simulated completion time.  Used by the sequential path and by
        cohort windows of one."""
        client = rd["client"]
        train = self.client_data[client]["train"]
        # the aggregate is kept only where a scenario reads it after
        # training; else it goes to train_local as a temporary and is
        # freed once cloned, before the gradients and the optimizer state
        # take the card's memory
        agg = (self.store.mean(rd["refs"], self._device)
               if self.scenario is not None else None)
        model, _ = self.backend.train_local(
            agg if agg is not None
            else self.store.mean(rd["refs"], self._device),
            train, seed=rd["seed"], epochs=self.cfg.local_epochs)
        if agg is not None:
            model = self._scenario_update_one(client, agg, model)
            del agg
        acc = self.backend.evaluate(model, self.client_data[client]["val"])
        sig = self.backend.signature(model, train)
        # the model waits for its publish time where the store keeps it
        model = self.store.rest(model)
        total = rd["t_front"] + rd["t_train"] + self._t_post(
            self.profiles[client])
        self.loop.schedule(
            rd["t_start"] + total - self.loop.now,
            lambda: self._complete_round(client, model, acc, sig,
                                         rd["epoch"] + 1, rd["parents"]))

    # -- fault injection (fl/scenarios.py) ------------------------------------

    def _scenario_update_one(self, client: int, agg, model):
        """Scenario update transform for ONE trained model (sequential path
        and windows of one), before validation and the signature, so the
        published artefacts describe the attacked model."""
        plan = self.scenario.update_plan([client])
        if plan is not None and plan["affected"][0]:
            model = perturb_update(agg, model, plan, 0)
        return self._scenario_stale(client, model)

    def _scenario_stale(self, client: int, model):
        """lazy_mode='stale' free-riders republish their previous model
        (a swap on the host; the first publish has nothing to replay)."""
        sc = self.scenario
        if not sc.wants_stale(client):
            return model
        prev = self.ledger.latest_of(client)
        if prev is not None and self.ledger.has_tx(prev):
            ref = self.ledger.get_tx(prev).model_ref
            if ref in self.store:
                sc.updates_lazy += 1
                return self.store.get(ref, self._device)
        return model

    def _scenario_update_cohort(self, rounds, agg_stacked, new_stacked):
        """Scenario update transforms for a whole window, on the cohort
        engine; unaffected rows keep their exact bits
        (``CohortBackend.perturb_cohort_stacked``)."""
        sc = self.scenario
        clients = [rd["client"] for rd in rounds]
        plan = sc.update_plan(clients)
        if plan is not None:
            new_stacked = self.cohort.perturb_cohort_stacked(
                agg_stacked, new_stacked, plan)
        stale = [k for k, c in enumerate(clients) if sc.wants_stale(c)]
        if stale:
            models = tree_unstack(new_stacked)
            for k in stale:
                models[k] = self._scenario_stale(clients[k], models[k])
            new_stacked = tree_stack(models)
        return new_stacked

    # -- sequential client round ---------------------------------------------

    def _client_round(self, client: int) -> None:
        if self.tracker.done:
            return
        self._dispatch_one(self._front_half(client, self.loop.now))

    # -- cohort-window client rounds ------------------------------------------

    def _enqueue_round(self, client: int) -> None:
        if not self.tracker.done:
            self._window.add(client)

    def _flush_cohort(self, batch) -> None:
        """Dispatch one window: ``batch`` is [(client, start_time)] from
        :class:`CohortWindow`.  Tip selection stays per client (its
        candidate validation is batched underneath), then training,
        validation and signatures run on the cohort engine and every result
        publishes at its own simulated completion time."""
        cfgc = self.cfg
        rounds = [self._front_half(client, t_start)
                  for client, t_start in batch]

        if len(rounds) == 1:
            # a window of one: the backend's own calls, no stacking
            self._dispatch_one(rounds[0])
            return

        # the window's membership and seeds are now fixed, so its batch
        # assembly can start on the assembler's thread and overlap the
        # stacking and the Eq. 6 reduction below
        train_sets = [self.client_data[rd["client"]]["train"] for rd in rounds]
        seeds = [rd["seed"] for rd in rounds]
        self.cohort.prefetch_window(train_sets, seeds,
                                    epochs=cfgc.local_epochs)

        # Eq. 6 for the whole cohort as ONE stacked reduction: stack the
        # union of selected models once, then a (K, M) weight matrix row per
        # client (uniform over its own selection, zero elsewhere)
        uniq = list(dict.fromkeys(r for rd in rounds for r in rd["refs"]))
        ref_pos = {r: i for i, r in enumerate(uniq)}
        weights = np.zeros((len(rounds), len(uniq)), np.float32)
        for k, rd in enumerate(rounds):
            for r in rd["refs"]:
                weights[k, ref_pos[r]] = 1.0
        # under a mesh the M stacked tip models spread over the mesh (both
        # axes of a 2-D one), and one sum of the devices' einsums gives
        # every client's Eq. 6 aggregate (see core/aggregate.py)
        stacked_tips = tree_stack([self.store.get(r, self._device)
                                   for r in uniq])
        agg_stacked = stacked_weighted(stacked_tips, weights,
                                       mesh=self.cohort.mesh,
                                       axis_name=self.cohort.clients_axis,
                                       data_axis=self.cohort.data_axis)
        del stacked_tips

        val_sets = [self.client_data[rd["client"]]["val"] for rd in rounds]
        new_stacked, _ = self.cohort.train_cohort_stacked(
            agg_stacked, train_sets, seeds, epochs=cfgc.local_epochs)
        if self.scenario is not None:
            new_stacked = self._scenario_update_cohort(rounds, agg_stacked,
                                                       new_stacked)
        del agg_stacked
        val_accs = self.cohort.evaluate_cohort_stacked(new_stacked, val_sets)
        sigs = self.cohort.signature_cohort_stacked(new_stacked, train_sets)
        new_models = tree_unstack(new_stacked)
        self._cohorts_dispatched += 1

        # publish each round at ITS OWN simulated completion time
        for rd, model, acc, sig in zip(rounds, new_models, val_accs, sigs):
            total = (rd["t_front"] + rd["t_train"]
                     + self._t_post(self.profiles[rd["client"]]))

            def finish(rd=rd, model=model, acc=acc, sig=sig):
                self._complete_round(rd["client"], model, acc, sig,
                                     rd["epoch"] + 1, rd["parents"])

            self.loop.schedule(rd["t_start"] + total - self.loop.now, finish)

    # -- run -------------------------------------------------------------------

    def global_model(self):
        """Average of the models at the current tips (publisher's view)."""
        refs = [self.ledger.get_tx(t).model_ref for t in self.ledger.tips()]
        return self.store.mean(refs, self._device) if refs else None

    def _serving_config(self):
        """The effective ServingConfig, or None when serving is off."""
        if self.cfg.serving is not None:
            return self.cfg.serving
        if self.cfg.serve_every > 0:
            from repro_torch.fl.serving import ServingConfig
            return ServingConfig(every=self.cfg.serve_every,
                                 backend=self.cfg.serve_backend)
        return None

    def _start_serving(self) -> None:
        """Bring up the replica publisher + query stream on the event loop
        (no-op when serving is off).  Runs after genesis so replica v0 is
        the genesis frontier."""
        scfg = self._serving_config()
        if scfg is None:
            return
        from repro_torch.fl.serving import (ConsensusPublisher, QueryStream,
                                            make_query_driver)
        done = lambda: self.tracker.done  # noqa: E731
        self.publisher = ConsensusPublisher(self.ledger, self.store,
                                            self.loop, scfg.every, stop=done,
                                            device=self._device)
        driver = make_query_driver(scfg, self.backend, self.global_test)
        self.query_stream = QueryStream(self.publisher, driver, self.loop,
                                        self.ledger, scfg.query_rate,
                                        scfg.seed, stop=done)
        self.publisher.start()
        self.query_stream.start()

    def run(self, init_model=None) -> RunResult:
        """Run to convergence or ``max_rounds``.  ``init_model`` is the
        genesis model; None draws one from ``torch.Generator`` seeded with
        ``cfg.seed``."""
        if init_model is None:
            init_model = self.backend.init(
                torch.Generator().manual_seed(self.cfg.seed))
        self.cost.model_bytes = max(tree_size_bytes(init_model), 1)
        ref = self.store.put("genesis", init_model)
        del init_model          # a store on the host keeps its own copy
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
        self._start_serving()
        for c in range(self.cfg.n_clients):
            # staggered joins: asynchrony from the first event on
            self._start_round(float(self.rng.uniform(0, 2.0)), c)
        self.loop.run(stop=lambda: self.tracker.done)
        if self._window is not None:
            self._window.pending.clear()  # tracker stopped us mid-window

        # paper Table II reports AVERAGE accuracy across participants:
        # evaluate each client's latest model on the global test set
        latest_refs = []
        for c in range(self.cfg.n_clients):
            tx = self.ledger.latest_of(c)
            if tx is None:
                continue
            ref = (self._deferred_evict.get(c)
                   if not self.ledger.has_tx(tx)
                   else self.ledger.get_tx(tx).model_ref)
            if ref is None or ref not in self.store:
                continue
            latest_refs.append(ref)
        if self.cohort is not None and latest_refs:
            client_accs = self.cohort.evaluate_many(
                [self.store.get(r, self._device) for r in latest_refs],
                self.global_test)
        else:
            # one client's model on the backend's device at a time
            client_accs = [self.backend.evaluate(
                self.store.get(r, self._device), self.global_test)
                for r in latest_refs]
        gm = self.global_model()
        tip_mean_acc = self.backend.evaluate(gm, self.global_test)
        client_mean = float(np.mean(client_accs)) if client_accs else 0.0
        # the publisher's deliverable is the aggregated model from the
        # current tips (the paper's 'global model'); per-client average in
        # extra for reference
        final_acc = max(tip_mean_acc, client_mean)
        extra_scenario = {}
        if self.scenario is not None:
            extra_scenario = {"scenario": self.scenario.cfg.name,
                              "scenario_counts": self.scenario.counts()}
        if self.query_stream is not None:
            extra_scenario["serving"] = {**self.publisher.report(),
                                         **self.query_stream.report()}
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
                "cohorts_dispatched": self._cohorts_dispatched,
                **extra_scenario,
            })

"""Adversarial & systems-heterogeneity fault injection (robustness suite).

The paper's headline differentiator is trusted verification on the DAG, so
this layer attacks it: a :class:`Scenario` injects faults into the federated
loop of both the DAG-AFL coordinator and every baseline harness —

  malicious   label-flipped shards (y -> C-1-y) and/or scaled-gradient model
              poisoning (``new' = agg + gamma * (new - agg)``, gamma < 0
              ascends the loss), optionally tampering published tx metadata
              AFTER the hash is recorded (what Eq. 7 must catch)
  lazy        free-riders (BLADE-FL): republish the Eq. 6 aggregate
              untouched (``lazy_mode="copy"``, gamma = 0) or their own
              previous model (``lazy_mode="stale"``)
  dp          Gaussian noise on every published update (sigma * N(0, I))
  straggler   heavy-tailed (Pareto) round-duration multipliers for a subset
              of clients
  dropout     wireless failures that abort a publish mid-round — the round's
              work is lost and the client retries

Determinism contract
--------------------
Every stochastic choice draws from a *private* ``np.random.default_rng``
keyed by ``(scenario seed, fault kind, client, per-client sequence)`` — never
from the host run's RNG — and injection sites skip entirely when no fault
applies, so a scenario whose rates are all zero is **bit-identical** to the
honest run (property-tested), and fault event counts at a fixed seed are
exactly reproducible (what the CI robustness gate pins).  The per-client
sequence counters advance in client-round order on both the sequential and
the cohort-batched engines, so counts do not depend on ``cohort_size``.

The update transforms themselves run on the batched cohort engine
(:meth:`repro_torch.fl.cohort.CohortBackend.perturb_cohort_stacked`): one
pass over the window's stacked leaves with a per-leaf ``where(affected,
...)`` select, so unaffected clients inside an attacked window keep their
exact bits.

Port of ``repro.fl.scenarios``: numpy only, copied as it is, so roles,
update plans, duration multipliers, dropout and tamper draws and every
count are the reference's.  Only the DP noise the transform adds
(``repro_torch.fl.cohort``) comes from ``torch.Generator`` where the
reference draws ``jax.random``: it matches in distribution, not in bits.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, FrozenSet, List, Optional, Sequence

import numpy as np

# stable sub-stream ids for the per-(seed, kind, client, seq) RNGs; renaming
# or renumbering these changes every scenario's event stream
_KIND = {"roles": 0, "duration": 1, "dropout": 2, "tamper": 3, "update": 4}


@dataclass(frozen=True)
class ScenarioConfig:
    """Knobs for one fault-injection scenario (all rates default honest)."""

    name: str = "honest"
    seed: int = 0
    # -- malicious / poisoning clients
    malicious_frac: float = 0.0
    attack: str = "label_flip"        # "label_flip" | "scale" | "label_flip+scale"
    scale_gamma: float = -4.0         # gamma for the "scale" model-poisoning
    tamper_rate: float = 0.0          # P(a malicious publish edits its stored
                                      # metadata after hashing)
    # -- lazy / free-riding clients
    lazy_frac: float = 0.0
    lazy_mode: str = "copy"           # "copy" (republish aggregate) | "stale"
    # -- differential-privacy noise on every published update
    dp_sigma: float = 0.0
    # -- stragglers: heavy-tailed round durations
    straggler_frac: float = 0.0
    straggler_tail: float = 1.3       # Pareto shape (lower = heavier tail)
    straggler_scale: float = 4.0      # multiplier scale on the Pareto draw
    straggler_cap: float = 50.0       # cap so one draw can't hide the rest
    # -- wireless dropouts: a publish aborts with this probability
    dropout_rate: float = 0.0


#: The benchmark/CI scenario matrix.  ``robustness.py --scenario <name>``
#: and ``run.py --scenario <name>`` resolve names here.
SCENARIOS: Dict[str, ScenarioConfig] = {
    "poison": ScenarioConfig(name="poison", malicious_frac=0.25,
                             attack="label_flip+scale", scale_gamma=-4.0,
                             tamper_rate=0.5),
    "lazy": ScenarioConfig(name="lazy", lazy_frac=0.25, lazy_mode="copy"),
    "dp": ScenarioConfig(name="dp", dp_sigma=0.05),
    "straggler": ScenarioConfig(name="straggler", straggler_frac=0.25),
    "dropout": ScenarioConfig(name="dropout", dropout_rate=0.3),
}


class Scenario:
    """Runtime fault injector + deterministic event-count bookkeeping.

    One instance belongs to ONE run (the counters are the run's audit
    trail); construct a fresh one per run — :func:`as_scenario` does this
    when handed a :class:`ScenarioConfig` or a registry name.
    """

    def __init__(self, cfg: ScenarioConfig, n_clients: int):
        self.cfg = cfg
        self.n_clients = n_clients
        order = [int(c) for c in
                 np.random.default_rng((cfg.seed, _KIND["roles"]))
                 .permutation(n_clients)]
        n_mal = int(round(cfg.malicious_frac * n_clients))
        n_lazy = int(round(cfg.lazy_frac * n_clients))
        n_strag = int(round(cfg.straggler_frac * n_clients))
        # malicious and lazy are disjoint (front of the permutation);
        # stragglers come off the back — a systems property that may
        # coincide with either behavioural role
        self.malicious: FrozenSet[int] = frozenset(order[:n_mal])
        self.lazy: FrozenSet[int] = frozenset(order[n_mal:n_mal + n_lazy])
        self.stragglers: FrozenSet[int] = frozenset(order[::-1][:n_strag])
        self._seq: Dict[tuple, int] = {}
        # event counters — deterministic at a fixed (seed, geometry), the
        # quantities the CI robustness gate compares across two runs
        self.updates_scaled = 0
        self.updates_lazy = 0
        self.updates_noised = 0
        self.publishes_dropped = 0
        self.straggler_draws = 0
        self.clients_poisoned = 0
        self.tampered: List[str] = []

    # -- private event streams ----------------------------------------------

    def _rng(self, kind: str, client: int) -> np.random.Generator:
        """Fresh generator for this (kind, client) pair's next event; the
        per-pair sequence counter makes draws independent of interleaving."""
        seq = self._seq.get((kind, client), 0)
        self._seq[(kind, client)] = seq + 1
        return np.random.default_rng(
            (self.cfg.seed, _KIND[kind], client, seq))

    # -- data poisoning (before any training) --------------------------------

    def poison_data(self, client_data: List[Dict]) -> List[Dict]:
        """Label-flip malicious clients' train+val shards (y -> C-1-y with
        the GLOBAL class count, so the flip is a consistent wrong task).
        Returns a new list; honest clients' entries are the same objects."""
        if not self.malicious or "label_flip" not in self.cfg.attack:
            return client_data
        ys = [np.asarray(cd["train"].y) for cd in client_data
              if hasattr(cd.get("train"), "y")]
        if not ys:          # token-stream backends: label flipping is a no-op
            return client_data
        n_classes = int(max(y.max() for y in ys)) + 1
        out = []
        for c, cd in enumerate(client_data):
            if c not in self.malicious:
                out.append(cd)
                continue
            flipped = dict(cd)
            for split in ("train", "val"):
                ds = cd.get(split)
                if ds is not None and hasattr(ds, "y"):
                    y = np.asarray(ds.y)
                    flipped[split] = dataclasses.replace(
                        ds, y=(n_classes - 1 - y).astype(y.dtype))
            out.append(flipped)
            self.clients_poisoned += 1
        return out

    # -- update transforms (after local training) ----------------------------

    def update_plan(self, clients: Sequence[int]) -> Optional[Dict]:
        """Per-client coefficients for ``new' = agg + gamma*(new - agg) +
        sigma*N(0,I)`` over one dispatch (a window on the cohort engine, a
        single round otherwise).  Returns None when NO client is affected —
        callers then skip the transform program entirely, which is what
        makes the zero-rate scenario bit-identical (gamma=1/sigma=0 is only
        the identity algebraically)."""
        cfg = self.cfg
        k = len(clients)
        gammas = np.ones(k, np.float32)
        sigmas = np.zeros(k, np.float32)
        affected = np.zeros(k, bool)
        seqs = np.zeros(k, np.int64)
        for i, c in enumerate(clients):
            seq = self._seq.get(("update", c), 0)
            self._seq[("update", c)] = seq + 1
            seqs[i] = seq
            if c in self.malicious and "scale" in cfg.attack:
                gammas[i] = cfg.scale_gamma
                affected[i] = True
                self.updates_scaled += 1
            if c in self.lazy and cfg.lazy_mode == "copy":
                gammas[i] = 0.0        # free-rider: republish the aggregate
                affected[i] = True
                self.updates_lazy += 1
            if cfg.dp_sigma > 0.0:
                sigmas[i] = cfg.dp_sigma
                affected[i] = True
                self.updates_noised += 1
        if not affected.any():
            return None
        return {"seed": cfg.seed, "clients": np.asarray(clients, np.int64),
                "seqs": seqs, "gammas": gammas, "sigmas": sigmas,
                "affected": affected}

    def wants_stale(self, client: int) -> bool:
        """lazy_mode='stale' free-riders republish their own previous model
        (host-side swap — there is nothing to compute)."""
        return client in self.lazy and self.cfg.lazy_mode == "stale"

    # -- systems faults -------------------------------------------------------

    def duration_multiplier(self, client: int) -> float:
        """Heavy-tailed slowdown for straggler clients' simulated round
        durations; exactly 1.0 (no draw, no float op) for everyone else."""
        if client not in self.stragglers:
            return 1.0
        cfg = self.cfg
        rng = self._rng("duration", client)
        self.straggler_draws += 1
        mult = 1.0 + cfg.straggler_scale * rng.pareto(cfg.straggler_tail)
        return float(min(mult, cfg.straggler_cap))

    def drops_publish(self, client: int) -> bool:
        """Wireless dropout: True aborts this publish (the caller discards
        the round's result and reschedules the client)."""
        if self.cfg.dropout_rate <= 0.0:
            return False
        if self._rng("dropout", client).random() < self.cfg.dropout_rate:
            self.publishes_dropped += 1
            return True
        return False

    # -- post-publish metadata tampering --------------------------------------

    def maybe_tamper(self, ledger, tx_id: str) -> bool:
        """A malicious client edits its just-published transaction's stored
        metadata (inflating model_accuracy) WITHOUT recomputing the Eq. 7
        hash — the attack trusted verification exists to catch.  Tip
        selection scores candidates by locally-measured accuracy, not the
        self-reported metadata field, so tampering never perturbs the run's
        trajectory: detection counts stay deterministic."""
        cfg = self.cfg
        if cfg.tamper_rate <= 0.0:
            return False
        tx = ledger.get_tx(tx_id)
        client = tx.metadata.client_id
        if client not in self.malicious:
            return False
        if self._rng("tamper", client).random() >= cfg.tamper_rate:
            return False
        tx.metadata = dataclasses.replace(
            tx.metadata,
            model_accuracy=min(0.999, tx.metadata.model_accuracy + 0.5))
        self.tampered.append(tx_id)
        return True

    # -- audit trail -----------------------------------------------------------

    def counts(self) -> Dict[str, int]:
        """Deterministic fault-event counts (the robustness gate compares
        these across two same-seed runs)."""
        return {"clients_malicious": len(self.malicious),
                "clients_lazy": len(self.lazy),
                "clients_straggler": len(self.stragglers),
                "clients_poisoned": self.clients_poisoned,
                "updates_scaled": self.updates_scaled,
                "updates_lazy": self.updates_lazy,
                "updates_noised": self.updates_noised,
                "publishes_dropped": self.publishes_dropped,
                "straggler_draws": self.straggler_draws,
                "txs_tampered": len(self.tampered)}


def as_scenario(obj, n_clients: int) -> Optional[Scenario]:
    """Coerce a config field to a live injector: None passes through, a
    registry name or :class:`ScenarioConfig` builds a fresh :class:`Scenario`
    and a prebuilt :class:`Scenario` is used as-is (callers that want to
    read the counters afterwards pass the instance)."""
    if obj is None or isinstance(obj, Scenario):
        return obj
    if isinstance(obj, str):
        obj = SCENARIOS[obj]
    return Scenario(obj, n_clients)


def dag_attack_metrics(ledger, scenario: Scenario) -> Dict[str, float]:
    """Post-run quarantine metrics over the (unpruned) DAG.

    * ``poisoned_tip_approval_rate`` — of all approval edges published by
      HONEST clients, the fraction pointing at a malicious client's tx: how
      often tip selection was fooled into building on a poisoned lineage.
    * ``orphaned_malicious_frac`` — fraction of malicious txs never approved
      by any honest tx (quarantined lineages).  ``orphaned_honest_frac`` is
      the same quantity for honest txs — the natural orphan floor (the last
      global round's txs have had no chance to be approved), so compare the
      two rather than reading either absolutely.

    Pruned txs aren't walkable, so run the robustness benchmark on the
    append-only ledger (``ledger_checkpoint_every=0``).
    """
    mal = scenario.malicious
    mal_ids, honest_ids = set(), set()
    for tx in ledger.transactions():
        c = tx.metadata.client_id
        if c < 0:
            continue                      # genesis
        (mal_ids if c in mal else honest_ids).add(tx.tx_id)
    honest_edges = edges_to_mal = 0
    approved_mal, approved_honest = set(), set()
    for tx in ledger.transactions():
        c = tx.metadata.client_id
        if c < 0 or c in mal:
            continue
        for p in tx.parents:
            honest_edges += 1
            if p in mal_ids:
                edges_to_mal += 1
                approved_mal.add(p)
            elif p in honest_ids:
                approved_honest.add(p)
    return {
        "malicious_published": len(mal_ids),
        "honest_published": len(honest_ids),
        "poisoned_tip_approval_rate": edges_to_mal / max(honest_edges, 1),
        "orphaned_malicious_frac": (1.0 - len(approved_mal)
                                    / max(len(mal_ids), 1)),
        "orphaned_honest_frac": (1.0 - len(approved_honest)
                                 / max(len(honest_ids), 1)),
    }

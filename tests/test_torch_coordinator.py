"""The port's sequential DAG-AFL coordinator against the JAX reference.

(A) One deterministic numpy stub backend drives both coordinators.  The
stub's arithmetic is numpy float32 and Eq. 6 aggregation is bit-identical
in the two packages, so the runs must agree exactly: the same transaction
for transaction tip decisions, the same Eq. 7 hashes, the same simulated
times and results, on the append-only and on the bounded ledger.

(B) Real VGG_TINY backends from the same JAX initial weights.  Training
differs in the last float32 bits between the frameworks, so the final
accuracies must agree within 0.05 (one or two validation samples of the
small shards); whether the tip decisions also match is reported.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs.cnn import vgg_for as j_vgg_for  # noqa: E402
from repro.core.coordinator import DagAflConfig as JConfig  # noqa: E402
from repro.core.coordinator import DagAflCoordinator as JCoord  # noqa: E402
from repro.core.verify import verify_full_dag as j_verify  # noqa: E402
from repro.data.partition import partition_dirichlet  # noqa: E402
from repro.data.synthetic import make_benchmark_dataset, split_811  # noqa: E402
from repro.fl.backend import CNNBackend as JBackend  # noqa: E402
from repro.models.cnn import init_cnn as j_init  # noqa: E402
from repro_torch.configs.cnn import vgg_for  # noqa: E402
from repro_torch.core.coordinator import DagAflConfig, DagAflCoordinator  # noqa: E402
from repro_torch.core.verify import verify_full_dag  # noqa: E402
from repro_torch.fl.backend import CNNBackend  # noqa: E402
from repro_torch.weights import params_from_numpy  # noqa: E402


def _tip_decisions(coord) -> list:
    """For every transaction in append order: the publishing
    ``(client, epoch)`` and the sorted ``(client, epoch)`` set of the
    parents its tip selection approved (as ``benchmarks/chain_perf.py``
    defines the trace; a parent pruned by a checkpoint appears by id)."""
    txs = sorted(coord.ledger.transactions(), key=lambda t: t.seq)
    who = {t.tx_id: (t.metadata.client_id, t.metadata.current_epoch)
           for t in txs}
    return [(who[t.tx_id],
             tuple(sorted((who.get(p, p) for p in t.parents), key=repr)))
            for t in txs]


def _hashes(coord) -> list:
    return [t.tx_hash for t in sorted(coord.ledger.transactions(),
                                      key=lambda t: t.seq)]


class StubBackend:
    """A deterministic numpy stand-in for a training backend.  A model is a
    small tree; training pulls it toward the client's target with seeded
    noise; accuracy and signature are functions of the weights."""

    def __init__(self, native):
        self.native = native          # numpy -> the package's array type

    def _tree(self, w, b):
        return {"w": self.native(w), "extra": [{"b": self.native(b)}]}

    def init(self, _rng):
        return self._tree(np.linspace(-1, 1, 8, dtype=np.float32),
                          np.zeros(3, np.float32))

    def train_local(self, params, ds, seed=0, epochs=None):
        rng = np.random.default_rng(seed)
        w = np.asarray(params["w"], np.float32)
        b = np.asarray(params["extra"][0]["b"], np.float32)
        noise = rng.normal(0.0, 0.05, w.shape).astype(np.float32)
        w = w + np.float32(0.5) * (ds["target"] - w) + noise
        b = b + np.float32(0.25)
        return self._tree(w, b), 0.0

    def evaluate(self, params, ds, limit=512):
        w = np.asarray(params["w"], np.float32)
        return float(np.float32(1) / (np.float32(1)
                                      + np.mean(np.abs(w - ds["target"]))))

    def signature(self, params, ds, limit=128):
        w = np.asarray(params["w"], np.float32)
        return np.abs(np.tanh(w * ds["scale"])).astype(np.float32)


def _stub_world(n_clients):
    rng = np.random.default_rng(42)
    data = []
    for _ in range(n_clients):
        part = {"target": rng.normal(0, 1, 8).astype(np.float32),
                "scale": np.float32(rng.uniform(0.5, 2.0))}
        data.append({"train": part, "val": part, "test": part})
    test = {"target": np.zeros(8, np.float32), "scale": np.float32(1.0)}
    return data, test


@pytest.mark.parametrize("checkpoint_every", [0.0, 4.0])
def test_stub_backend_runs_identically(checkpoint_every):
    data, test = _stub_world(5)
    kw = dict(n_clients=5, max_rounds=5, local_epochs=1, seed=3,
              ledger_checkpoint_every=checkpoint_every)
    ref = JCoord(StubBackend(jnp.asarray), data, test, JConfig(**kw))
    got = DagAflCoordinator(StubBackend(torch.from_numpy), data, test,
                            DagAflConfig(**kw))
    r_ref, r_got = ref.run(), got.run()
    assert _tip_decisions(got) == _tip_decisions(ref)
    assert _hashes(got) == _hashes(ref)
    assert len(_hashes(got)) > 10
    for field in ("final_accuracy", "best_accuracy", "sim_time", "rounds",
                  "history"):
        assert getattr(r_got, field) == getattr(r_ref, field), field
    for key in ("tip_mean_accuracy", "client_mean_accuracy",
                "tip_evaluations", "chain_len", "verify_failures",
                "store_bytes_transferred"):
        assert r_got.extra[key] == r_ref.extra[key], key
    assert verify_full_dag(got.ledger) == j_verify(ref.ledger) == (True, "ok")
    # the models each store still holds, and the bounded ledger's evictions
    # (a model pruned while still its client's latest waits in
    # ``_deferred_evict``)
    assert len(got.store) == len(ref.store)
    assert got._deferred_evict == ref._deferred_evict
    if checkpoint_every:
        assert got.ledger.checkpoints and \
            [c.root for c in got.ledger.checkpoints] == \
            [c.root for c in ref.ledger.checkpoints]
        assert got.ledger.n_pruned == ref.ledger.n_pruned > 0


def _cnn_world(n_clients):
    ds = make_benchmark_dataset("mnist", 600)
    splits = split_811(ds)
    parts = partition_dirichlet(splits["train"], n_clients, beta=1.0, seed=0)
    data = []
    for p in parts:
        s = split_811(p, seed=1)
        data.append({"train": s["train"], "val": s["val"], "test": s["test"]})
    return data, splits["test"]


def test_vgg_tiny_runs_agree():
    data, test = _cnn_world(3)
    kw = dict(n_clients=3, max_rounds=2, local_epochs=1, seed=0)
    init = j_init(jax.random.PRNGKey(0), j_vgg_for("mnist"))
    ref = JCoord(JBackend(j_vgg_for("mnist"), local_epochs=1, batch_size=32),
                 data, test, JConfig(**kw))
    got = DagAflCoordinator(
        CNNBackend(vgg_for("mnist"), local_epochs=1, batch_size=32,
                   device="cpu"), data, test, DagAflConfig(**kw))
    r_ref = ref.run(jax.random.PRNGKey(0))
    r_got = got.run(params_from_numpy(
        jax.tree_util.tree_map(np.asarray, init), "cpu"))
    assert r_got.rounds == r_ref.rounds == 6
    assert r_got.extra["chain_len"] == 7
    assert r_got.extra["verify_failures"] == 0
    assert verify_full_dag(got.ledger) == (True, "ok")
    assert abs(r_got.final_accuracy - r_ref.final_accuracy) <= 0.05
    same = _tip_decisions(got) == _tip_decisions(ref)
    print(f"VGG_TINY tip decisions identical: {same}; final accuracy "
          f"port {r_got.final_accuracy:.6f} reference "
          f"{r_ref.final_accuracy:.6f}")

"""The port's ``ModelStore`` with a resting device, the streamed Eq. 6 and
the coordinator over a store in host memory.

* ``ModelStore()`` hands back the objects it was given; ``ModelStore("cpu")``
  keeps its own models and returns copies with equal bits on the device
  asked for, and a copy changed in place leaves the stored model as it was;
* ``bytes_transferred`` equals the reference ``ModelStore``'s on the same
  sequence of ``put``, ``get`` and ``evict`` calls;
* ``ModelStore.mean`` (Eq. 6 streamed leaf by leaf) equals ``tree_mean``
  bit for bit for 1 to 4 models, float and non-float leaves (the first
  model's leaf is kept);
* ``PinnedStaging``'s chunked copies put every byte in place at chunk
  sizes that split the tensors anywhere (CPU buffers, no-op events);
* a reduced Jamba MoE coordinator run with ``store_device="cpu"`` gives
  the ledger, tips, accuracies and final model of the run with
  ``store_device=None``, and the aggregate each round trains from is gone
  before the optimizer state is made.

Everything runs on the CPU: the store's copies between host memory and a
card are checked on the card (``chip_smoke.py``, phase ``dag_large_path``).
"""
import dataclasses
import weakref

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core.dag import ModelStore as JModelStore  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.core.aggregate import (tree_leaves, tree_map,  # noqa: E402
                                        tree_mean, tree_size_bytes)
from repro_torch.core.coordinator import (DagAflConfig,  # noqa: E402
                                          DagAflCoordinator)
from repro_torch.core.dag import ModelStore, PinnedStaging  # noqa: E402
from repro_torch.core.verify import verify_full_dag  # noqa: E402
from repro_torch.data.synthetic import make_lm_dataset  # noqa: E402
from repro_torch.fl.backend import LMBackend  # noqa: E402
from test_torch_baselines import few_torch_threads  # noqa: E402,F401

KW = dict(lr=5e-3, local_steps=2, batch_size=8, seq_len=64)


def _np_model(seed: int) -> dict:
    """A tree with float32, bfloat16-sized and integer leaves."""
    rng = np.random.default_rng(seed)
    return {"w": rng.normal(0, 1, (5, 7)).astype(np.float32),
            "layers": [{"b": rng.normal(0, 1, (7,)).astype(np.float32)},
                       {"b": rng.normal(0, 1, (3, 2)).astype(np.float16)}],
            "step": rng.integers(0, 100, (4,)).astype(np.int32)}


def _torch_model(seed: int) -> dict:
    return tree_map(torch.from_numpy, _np_model(seed))


def _bit_equal(a, b) -> bool:
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and x.shape == y.shape and torch.equal(x, y)
        for x, y in zip(la, lb))


def test_store_without_device_hands_back_the_same_objects():
    store = ModelStore()
    model = _torch_model(0)
    store.put("a", model)
    assert store.get("a") is model
    assert store.get("a", "cpu") is model
    assert store.rest(model) is model
    assert _bit_equal(store.mean(["a"], "cpu"), tree_mean([model]))
    readings = store.readings()
    assert readings["in_bytes"] == readings["out_bytes"] == 0
    assert readings["resting_devices"] == ["cpu"]


def test_store_on_the_host_returns_equal_bits_on_the_device_asked():
    store = ModelStore("cpu")
    model = _torch_model(1)
    store.put("a", model)
    for device in (None, "cpu", torch.device("cpu")):
        got = store.get("a", device)
        assert _bit_equal(got, model)
        assert all(g.device == torch.device("cpu") and
                   g.data_ptr() != m.data_ptr()
                   for g, m in zip(tree_leaves(got), tree_leaves(model)))
    size = sum(t.numel() * t.element_size() for t in tree_leaves(model))
    readings = store.readings()
    assert readings["device"] == "cpu"
    assert readings["out_bytes"] == 3 * size
    assert readings["in_bytes"] == 0           # it rested there already
    assert readings["resting_bytes"] == readings["peak_resting_bytes"] \
        == size
    assert readings["resting_devices"] == ["cpu"]
    store.evict("a")
    assert "a" not in store and store.readings()["resting_bytes"] == 0


def test_a_fetched_model_changed_in_place_leaves_the_store_unchanged():
    store = ModelStore("cpu")
    store.put("a", _torch_model(2))
    got = store.get("a", "cpu")
    for leaf in tree_leaves(got):
        leaf.add_(1)
    store.mean(["a"], "cpu")["w"].mul_(3)
    store.get("a")["w"].sub_(2)
    assert _bit_equal(store.get("a", "cpu"), _torch_model(2))


@pytest.mark.parametrize("device", [None, "cpu"])
def test_bytes_transferred_equals_the_reference(device):
    ref, got = JModelStore(), ModelStore(device)
    steps = [("put", "a", 0), ("put", "b", 1), ("get", "a"), ("get", "b"),
             ("get", "a"), ("evict", "a"), ("put", "c", 2), ("get", "c"),
             ("evict", "missing"), ("get", "b"), ("mean", ("b", "c"))]
    for step in steps:
        if step[0] == "put":
            ref.put(step[1], jax.tree_util.tree_map(jnp.asarray,
                                                    _np_model(step[2])))
            got.put(step[1], _torch_model(step[2]))
        elif step[0] == "get":
            ref.get(step[1])
            got.get(step[1], "cpu")
        elif step[0] == "evict":
            ref.evict(step[1])
            got.evict(step[1])
        else:                          # Eq. 6 reads each ref once
            for r in step[1]:
                ref.get(r)
            got.mean(step[1], "cpu")
        assert got.bytes_transferred == ref.bytes_transferred, step
        assert len(got) == len(ref)
    assert ref.bytes_transferred > 0


@pytest.mark.parametrize("k", [1, 2, 3, 4])
@pytest.mark.parametrize("device", [None, "cpu"])
def test_streamed_mean_equals_tree_mean(k, device):
    store = ModelStore(device)
    refs = [store.put(f"m{i}", _torch_model(10 + i)) for i in range(k)]
    want = tree_mean([store.get(r, "cpu") for r in refs])
    got = store.mean(refs, "cpu")
    assert _bit_equal(got, want)
    # the non-float leaf is the first model's; float leaves are float32
    assert torch.equal(got["step"], _torch_model(10)["step"])
    assert got["layers"][1]["b"].dtype == torch.float32
    # and each leaf is the float32 sum left to right times 1/k in float32
    scale = np.float32(1) / np.float32(k)
    leaves = [_np_model(10 + i)["w"] for i in range(k)]
    acc = leaves[0].astype(np.float32)
    for leaf in leaves[1:]:
        acc = acc + leaf
    assert np.array_equal(got["w"].numpy(), acc * scale)
    assert store.bytes_transferred == 2 * sum(      # k gets, k reads
        tree_size_bytes(_torch_model(10 + i)) for i in range(k))


class _Event:
    def record(self):
        pass

    def synchronize(self):
        pass


@pytest.mark.parametrize("chunk", [1, 7, 64, 4096])
def test_pinned_staging_chunks_put_every_byte_in_place(chunk):
    staging = PinnedStaging(chunk)
    buffers = [torch.empty(chunk, dtype=torch.uint8) for _ in range(2)]
    rng = np.random.default_rng(chunk)
    for n in (1, 6, 7, 8, 13, 129, 4097):
        src = torch.from_numpy(rng.integers(0, 256, n).astype(np.uint8))
        for copy in (staging._to_host, staging._to_card):
            dst = torch.zeros(n, dtype=torch.uint8)
            copy(src, dst, buffers, [_Event(), _Event()])
            assert torch.equal(src, dst), (copy.__name__, n)


def _moe_world():
    cfg = dataclasses.replace(reduced(get_config("jamba-v0.1-52b"),
                                      d_model=64), vocab_size=128)
    streams = [make_lm_dataset(vocab=128, n_tokens=6000, order=2.0, seed=c)
               for c in range(3)]
    data = [{"train": s, "val": s, "test": s} for s in streams]
    test = make_lm_dataset(vocab=128, n_tokens=6000, order=2.0,
                           seed=10_000)
    return cfg, data, test


def _ledger(coord) -> list:
    """Per transaction in ledger order: id, Eq. 7 hash, parents, client,
    accuracy, signature and whether it is a tip."""
    tips = set(coord.ledger.tips())
    return [(t.tx_id, coord.ledger.hash_of(t.tx_id), t.parents,
             t.metadata.client_id, t.metadata.model_accuracy,
             t.metadata.signature, t.tx_id in tips)
            for t in sorted(coord.ledger.transactions(), key=lambda t: t.seq)]


def test_moe_coordinator_with_a_host_store_equals_the_default(monkeypatch):
    """Three clients, two rounds over the reduced Jamba MoE: the same
    transactions, hashes, tips, accuracies, signatures and results, every
    stored model and the final global model bit for bit; and in each round
    the aggregate is freed once ``train_local`` has its clone."""
    cfg, data, test = _moe_world()
    kw = dict(n_clients=3, max_rounds=2, local_epochs=2, seed=0)
    aggregates, freed = [], []
    inner_init_opt = LMBackend.init_opt

    def init_opt(self, params):
        freed.append(all(r() is None for r in aggregates[-1]))
        return inner_init_opt(self, params)

    runs = {}
    for device in (None, "cpu"):
        backend = LMBackend(cfg, device="cpu", **KW)
        genesis = backend.init(torch.Generator().manual_seed(0))
        coord = DagAflCoordinator(backend, data, test, DagAflConfig(**kw),
                                  store_device=device)
        if device == "cpu":
            def mean(*args, _inner=coord.store.mean):
                out = _inner(*args)
                aggregates.append([weakref.ref(leaf)
                                   for leaf in tree_leaves(out)])
                return out

            monkeypatch.setattr(coord.store, "mean", mean)
            monkeypatch.setattr(LMBackend, "init_opt", init_opt)
        runs[device] = (coord, coord.run(genesis))
    (c_none, r_none), (c_cpu, r_cpu) = runs[None], runs["cpu"]
    assert r_cpu.rounds == r_none.rounds == 6
    assert r_cpu.extra["chain_len"] == 7
    assert verify_full_dag(c_cpu.ledger) == (True, "ok")
    assert _ledger(c_cpu) == _ledger(c_none)
    assert r_cpu.extra == r_none.extra
    assert (r_cpu.final_accuracy, r_cpu.best_accuracy, r_cpu.sim_time,
            r_cpu.history) == (r_none.final_accuracy, r_none.best_accuracy,
                               r_none.sim_time, r_none.history)
    assert _bit_equal(c_cpu.global_model(), c_none.global_model())
    for tx in c_none.ledger.transactions():
        assert _bit_equal(c_cpu.store.get(tx.model_ref, "cpu"),
                          c_none.store.get(tx.model_ref))
    readings = c_cpu.store.readings()
    assert readings["resting_bytes"] == readings["peak_resting_bytes"] \
        == 7 * tree_size_bytes(genesis)
    assert readings["out_bytes"] > 0
    assert len(freed) == 6 and all(freed)


def test_serving_replica_over_a_host_store_equals_the_default():
    """``ConsensusPublisher`` over a store in host memory: its replica is
    the default store's bit for bit, on the device it was asked for, and
    equals a fresh Eq. 6 over its refs (``replica_parity``)."""
    from repro_torch.core.dag import DAGLedger, TxMetadata
    from repro_torch.core.simulator import EventLoop
    from repro_torch.fl.serving import (ConsensusPublisher,
                                        consensus_over_refs, replica_parity)
    meta = TxMetadata(client_id=0, signature=(0.0,) * 16,
                      model_accuracy=0.5, current_epoch=0,
                      validation_node_id=0)
    replicas = []
    for device in (None, "cpu"):
        store, ledger = ModelStore(device), DAGLedger()
        ledger.add_genesis(meta, 0.0, store.put("genesis", _torch_model(20)))
        for c in (1, 2, 3):                    # three tips off genesis
            ledger.add_transaction(meta, (ledger.genesis_id,), float(c),
                                   store.put(f"m{c}", _torch_model(20 + c)))
        pub = ConsensusPublisher(ledger, store, EventLoop(), every=1.0,
                                 device="cpu")
        replica = pub.publish()
        assert len(replica.frontier) == 3 and replica_parity(replica, store)
        assert _bit_equal(replica.params, consensus_over_refs(
            store, replica.model_refs, "cpu"))
        replicas.append(replica.params)
    assert _bit_equal(*replicas)

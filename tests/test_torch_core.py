"""The port's framework-free core against the JAX reference.

The ledger, hashing, verification, tip selection, event loop and synthetic
data are copies in the port, so on the same operation sequence they must
give the same answers exactly: identical Eq. 7 hashes and checkpoint roots,
tips, reachability splits, selections, event orders and dataset bytes.
Aggregation (Eq. 6) must reproduce the reference's float32 bits.
"""
import dataclasses
import hashlib
import zlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import aggregate as j_agg  # noqa: E402
from repro.core import dag as j_dag  # noqa: E402
from repro.core import signature as j_sig  # noqa: E402
from repro.core import simulator as j_sim  # noqa: E402
from repro.core import tip_selection as j_tip  # noqa: E402
from repro.core import verify as j_ver  # noqa: E402
from repro.data import partition as j_part  # noqa: E402
from repro.data import synthetic as j_syn  # noqa: E402
from repro_torch.core import aggregate as t_agg  # noqa: E402
from repro_torch.core import dag as t_dag  # noqa: E402
from repro_torch.core import signature as t_sig  # noqa: E402
from repro_torch.core import simulator as t_sim  # noqa: E402
from repro_torch.core import tip_selection as t_tip  # noqa: E402
from repro_torch.core import verify as t_ver  # noqa: E402
from repro_torch.data import partition as t_part  # noqa: E402
from repro_torch.data import synthetic as t_syn  # noqa: E402

REF = {"dag": j_dag, "tip": j_tip, "sig": j_sig, "ver": j_ver}
PORT = {"dag": t_dag, "tip": t_tip, "sig": t_sig, "ver": t_ver}
N_CLIENTS = 5


def _accuracy(tx_id: str) -> float:
    """A deterministic stand-in for validating a tip."""
    return (zlib.crc32(tx_id.encode()) % 1000) / 1000.0


def _drive_ledger(mods, bounded: bool, seed: int, steps: int = 48):
    """One seeded operation sequence: appends with random parents, posted
    signatures, a selection per step and, on the bounded ledger,
    checkpoints.  Returns everything a consumer could observe."""
    dag, tip, sig, ver = mods["dag"], mods["tip"], mods["sig"], mods["ver"]
    rng = np.random.default_rng(seed)
    ledger = dag.BoundedDAGLedger() if bounded else dag.DAGLedger()
    contract = sig.SimilarityContract(N_CLIENTS)
    selector = tip.TipSelector(
        ledger, contract,
        tip.TipSelectionConfig(max_tip_candidates=6 if bounded else None))
    genesis = dag.TxMetadata(client_id=-1, signature=(0.0,) * 16,
                             model_accuracy=0.0, current_epoch=0,
                             validation_node_id=-1)
    ledger.add_genesis(genesis, 0.0)
    trace = []
    for step in range(steps):
        client = int(rng.integers(N_CLIENTS))
        tips = ledger.tips()
        parents = sorted(rng.choice(tips, size=min(2, len(tips)),
                                    replace=False).tolist())
        signature = rng.random(8).astype(np.float32)
        meta = dag.TxMetadata(client_id=client,
                              signature=tuple(float(s) for s in signature),
                              model_accuracy=float(rng.random()),
                              current_epoch=step // N_CLIENTS,
                              validation_node_id=client)
        now = step + float(rng.random())
        tx = ledger.add_transaction(meta, parents, now)
        contract.post_signature(client, signature)
        contract.commit_round(step)
        asker = int(rng.integers(N_CLIENTS))
        picked = selector.select(
            tip.TipSelectionRequest(client_id=asker, cur_epoch=step // 3,
                                    now=now + 0.5, round_idx=step),
            tip.FnTipEvaluator(_accuracy))
        trace.append((
            tx.tx_id, tx.tx_hash, ledger.tips(),
            ledger.tips_by_freshness(3),
            [ledger.reachable_tips(ledger.latest_of(c))
             for c in range(N_CLIENTS)],
            [(s.tx_id, s.reachable, s.freshness, s.accuracy, s.score)
             for s in picked],
            contract.most_similar(step, asker, list(range(N_CLIENTS)), 3)))
        if bounded and step % 8 == 7:
            rec = ledger.checkpoint(now=now)
            trace.append(None if rec is None else
                         (rec.ckpt_id, rec.root, rec.leaf_ids, rec.n_pruned))
        if step % 12 == 11 and picked:
            path = ver.extract_path(ledger, picked[0].tx_id)
            trace.append((len(path.records), ver.verify_path(ledger, path)))
    trace.append(ver.verify_full_dag(ledger))
    trace.append(ver.detect_tampered(ledger))
    return trace


@pytest.mark.parametrize("bounded", [False, True])
@pytest.mark.parametrize("seed", [0, 1])
def test_ledger_sequence_matches_reference(bounded, seed):
    ref = _drive_ledger(REF, bounded, seed)
    got = _drive_ledger(PORT, bounded, seed)
    assert len(ref) == len(got)
    for i, (a, b) in enumerate(zip(ref, got)):
        assert a == b, f"entry {i} differs:\n{a}\n{b}"
    if bounded:
        assert any(isinstance(e, tuple) and len(e) == 4 and
                   str(e[0]).startswith("ckpt") for e in got), \
            "the bounded run must actually prune"


def test_hash_helpers_match_reference():
    meta = dict(client_id=3, signature=(0.125, 0.5, 1 / 3),
                model_accuracy=0.875, current_epoch=4, validation_node_id=3)
    parents = ["a" * 64, "b" * 64]
    assert (t_dag.compute_tx_hash(parents, t_dag.TxMetadata(**meta))
            == j_dag.compute_tx_hash(parents, j_dag.TxMetadata(**meta)))
    leaves = [("tx2", "h2"), ("tx1", "h1")]
    assert (t_dag.checkpoint_root(t_dag.GENESIS_ROOT, leaves)
            == j_dag.checkpoint_root(j_dag.GENESIS_ROOT, leaves))


def test_similarity_contract_matches_reference():
    rng = np.random.default_rng(3)
    sigs = rng.random((N_CLIENTS, 16)).astype(np.float32)
    ref, got = j_sig.SimilarityContract(N_CLIENTS), \
        t_sig.SimilarityContract(N_CLIENTS)
    for c in (0, 2, 3, 4):
        ref.post_signature(c, sigs[c])
        got.post_signature(c, sigs[c])
    a, b = ref.commit_round(0), got.commit_round(0)
    # the two frameworks reduce the norms and the product in their own
    # order: a few float32 ulps apart, the rankings must agree exactly
    np.testing.assert_allclose(b, a, rtol=1e-6, atol=1e-7)
    assert np.array_equal(np.isnan(a), np.isnan(b))
    for c in range(N_CLIENTS):
        cands = list(range(N_CLIENTS))
        assert (got.most_similar(0, c, cands, 3)
                == ref.most_similar(0, c, cands, 3))
    x = torch.from_numpy(sigs)
    np.testing.assert_allclose(
        t_sig.cosine_similarity(x[0], x[1]).item(),
        float(j_sig.cosine_similarity(jnp.asarray(sigs[0]),
                                      jnp.asarray(sigs[1]))), rtol=1e-6)


def _digest(*arrays) -> str:
    h = hashlib.sha256()
    for a in arrays:
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()


def _data_digests(syn, part) -> dict:
    out = {}
    for name in ("mnist", "cifar10", "cifar100"):
        ds = syn.make_benchmark_dataset(name, n_samples=160, seed=7)
        out[name] = _digest(ds.x, ds.y)
    big = syn.make_image_dataset("cifar10", 120, 10, size=32, channels=3,
                                 noise=0.55)
    out["cifar10-32"] = _digest(big.x, big.y)
    splits = syn.split_811(big, seed=2)
    out["split"] = _digest(*(a for k in ("train", "val", "test")
                             for a in (splits[k].x, splits[k].y)))
    for beta in (0.05, 1.0):
        parts = part.partition_dirichlet(splits["train"], 6, beta=beta,
                                         seed=4, min_per_client=8)
        out[f"dirichlet-{beta}"] = _digest(*(a for p in parts
                                             for a in (p.x, p.y)))
    parts = part.partition_iid(splits["train"], 4, seed=5)
    out["iid"] = _digest(*(a for p in parts for a in (p.x, p.y)))
    out["lm"] = _digest(syn.make_lm_dataset(vocab=64, n_tokens=2000, seed=7))
    return out


def test_datasets_and_partitions_bit_identical():
    assert _data_digests(t_syn, t_part) == _data_digests(j_syn, j_part)


def _drive_simulator(sim):
    """Profiles, cost draws, and an event loop with a recurring cadence
    and a stop condition: the firing order must match."""
    profiles = sim.make_profiles(6, 0.6, seed=9)
    cost = sim.CostModel()
    rng = np.random.default_rng(1)
    draws = [cost.train_time(p, 2, rng) for p in profiles]
    loop = sim.EventLoop()
    fired = []
    tracker = sim.ConvergenceTracker(patience=2, min_updates=3)
    for i, p in enumerate(profiles):
        loop.schedule(float(rng.uniform(0, 2.0)) + p.latency,
                      lambda i=i: fired.append((i, loop.now)))
    loop.schedule_every(0.7, lambda: fired.append(("tick", loop.now)))
    loop.schedule(-1.0, lambda: fired.append(("clamped", loop.now)))
    for t, acc in enumerate((0.1, 0.2, 0.2, 0.2, 0.2)):
        tracker.update(float(t), acc)
    loop.run(stop=lambda: len(fired) > 12)
    return ([dataclasses.astuple(p) for p in profiles], draws, fired,
            loop.clamped, tracker.history, tracker.converged_at)


def test_simulator_matches_reference():
    assert _drive_simulator(t_sim) == _drive_simulator(j_sim)


def _tree(rng):
    """A small model tree of float32 leaves, as numpy arrays."""
    def draw(*shape):
        return rng.normal(size=shape).astype(np.float32)
    return {"convs": [[{"w": draw(3, 3, 2, 4), "b": draw(4)}]],
            "fcs": [{"w": draw(8, 5), "b": draw(5)}]}


def _as(tree, fn):
    return jax.tree_util.tree_map(fn, tree)


@pytest.mark.parametrize("n", [1, 2, 3, 5, 7])
def test_tree_mean_bit_identical(n):
    rng = np.random.default_rng(n)
    trees = [_tree(rng) for _ in range(n)]
    ref = j_agg.tree_mean([_as(t, jnp.asarray) for t in trees])
    got = t_agg.tree_mean([_as(t, torch.from_numpy) for t in trees])
    for a, b in zip(jax.tree_util.tree_leaves(ref), t_agg.tree_leaves(got)):
        assert np.array_equal(np.asarray(a), b.numpy())


def test_tree_weighted_interpolate_and_size():
    rng = np.random.default_rng(11)
    trees = [_tree(rng) for _ in range(3)]
    jt = [_as(t, jnp.asarray) for t in trees]
    tt = [_as(t, torch.from_numpy) for t in trees]
    pairs = [(j_agg.tree_weighted(jt, [1.0, 2.0, 0.5]),
              t_agg.tree_weighted(tt, [1.0, 2.0, 0.5])),
             (j_agg.tree_interpolate(jt[0], jt[1], 0.3),
              t_agg.tree_interpolate(tt[0], tt[1], 0.3))]
    for ref, got in pairs:
        for a, b in zip(jax.tree_util.tree_leaves(ref),
                        t_agg.tree_leaves(got)):
            # XLA may fuse the weighted sum into multiply-adds: 1 ulp
            np.testing.assert_allclose(b.numpy(), np.asarray(a),
                                       rtol=2e-7, atol=1e-7)
    mixed = {"f": np.zeros((3, 5), np.float32), "i": [np.zeros(7, np.int32)],
             "h": np.zeros(4, np.float16)}
    assert (t_agg.tree_size_bytes(_as(mixed, torch.from_numpy))
            == j_agg.tree_size_bytes(_as(mixed, jnp.asarray)) == 96)

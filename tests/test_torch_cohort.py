"""The port's cohort engine against the JAX reference's, and against its own
sequential path.

VGG_TINY at 16x16, so the per-sample Eq. 3 rows are multiples of 1/256 and
their sums are exact in any order; weights and data come from a seed with
numpy, and the JAX initialisation is carried over with
``params_from_numpy``.  Tolerances and their reasons:

* stacked aggregation: 1e-6 -- float32 sums in another order;
* windows: bit for bit -- the same numpy RNG stream per seed;
* window means (accuracy, signature): bit for bit -- both divide an exact
  float32 sum by an exact count (a reciprocal multiply would not match);
* trained leaves: 5e-3, losses 5e-2 -- the reference's own ``ATOL`` between
  its im2col training and its convolutions (``tests/test_cohort.py``);
* accuracies: equal when the correct counts are, and the counts are
  asserted; signatures: equal, else the channels that differ are named.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs.cnn import vgg_for as j_vgg_for  # noqa: E402
from repro.core import aggregate as j_agg  # noqa: E402
from repro.core.coordinator import DagAflConfig as JConfig  # noqa: E402
from repro.core.coordinator import DagAflCoordinator as JCoord  # noqa: E402
from repro.data.synthetic import Dataset, make_benchmark_dataset, split_811  # noqa: E402
from repro.fl.backend import CNNBackend as JBackend  # noqa: E402
from repro.fl.cohort import CohortBackend as JCohort  # noqa: E402
from repro.models.cnn import init_cnn as j_init  # noqa: E402
from repro_torch.configs.cnn import vgg_for  # noqa: E402
from repro_torch.core import aggregate as agg  # noqa: E402
from repro_torch.core.coordinator import DagAflConfig, DagAflCoordinator  # noqa: E402
from repro_torch.core.verify import verify_full_dag  # noqa: E402
from repro_torch.fl import cohort  # noqa: E402
from repro_torch.fl.backend import CNNBackend  # noqa: E402
from repro_torch.weights import params_from_numpy, params_to_numpy  # noqa: E402
from test_torch_coordinator import (StubBackend, _cnn_world, _hashes,  # noqa: E402
                                    _stub_world, _tip_decisions)

ATOL = 5e-3


def _np_params(seed):
    return jax.tree_util.tree_map(
        np.array, j_init(jax.random.PRNGKey(seed), j_vgg_for("mnist")))


def _shards(train, sizes, seed):
    """Deliberately ragged shards (different batch counts per client)."""
    rng = np.random.default_rng(seed)
    out = []
    for s in sizes:
        idx = rng.choice(len(train), size=s, replace=False)
        out.append(Dataset(train.x[idx], train.y[idx]))
    return out


@pytest.fixture(scope="module")
def world():
    splits = split_811(make_benchmark_dataset("mnist", n_samples=900, seed=0))
    jb = JBackend(j_vgg_for("mnist"), local_epochs=2, batch_size=32)
    tb = CNNBackend(vgg_for("mnist"), local_epochs=2, batch_size=32,
                    device="cpu")
    return jb, tb, splits


def _leaves(tree):
    if isinstance(tree, dict) or isinstance(tree, list):
        return [np.asarray(a) for a in jax.tree_util.tree_leaves(tree)]
    return [np.asarray(a) for a in agg.tree_leaves(tree)]


# -- (a) stacking and stacked aggregation -----------------------------------


def _models(n):
    return [_np_params(i) for i in range(n)]


@pytest.mark.parametrize("kind", ["mean", "weighted_m", "weighted_km"])
def test_stacked_aggregates_match_reference(kind):
    models = _models(3)
    # a non-float leaf rides along and is broadcast, not averaged
    for i, m in enumerate(models):
        m["step"] = np.array([i + 1, 7], np.int32)
    j_stacked = j_agg.tree_stack(
        [jax.tree_util.tree_map(jnp.asarray, m) for m in models])
    t_stacked = agg.tree_stack([params_from_numpy(m, "cpu") for m in models])
    for a, b in zip(agg.tree_unstack(t_stacked), models):
        assert all(np.array_equal(x, y) for x, y in
                   zip(_leaves(a), jax.tree_util.tree_leaves(b)))
    if kind == "mean":
        want = j_agg.stacked_mean(j_stacked)
        got = agg.stacked_mean(t_stacked)
    else:
        w = (np.array([0.2, 0.3, 0.5], np.float32) if kind == "weighted_m"
             else np.array([[1.0, 1.0, 0.0], [0.2, 0.3, 0.5],
                            [0.0, 0.0, 2.0]], np.float32))
        want = j_agg.stacked_weighted(j_stacked, w)
        got = agg.stacked_weighted(t_stacked, w)
    want, got = jax.tree_util.tree_map(np.asarray, want), params_to_numpy(got)
    assert (jax.tree_util.tree_structure(got)
            == jax.tree_util.tree_structure(want))
    for a, b in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(want)):
        assert a.dtype == b.dtype and a.shape == b.shape
        if a.dtype == np.int32:
            assert np.array_equal(a, b)
        else:
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)


def test_pad_helpers_match_reference():
    x = np.arange(12, dtype=np.float32).reshape(3, 4)
    for target in (3, 5):
        assert np.array_equal(agg.pad_leading(torch.from_numpy(x),
                                              target).numpy(),
                              np.asarray(j_agg.pad_leading(jnp.asarray(x),
                                                           target)))
    for n in range(1, 40):
        assert agg.next_pow2(n) == j_agg.next_pow2(n)
        assert agg.round_up_multiple(n, 6) == j_agg.round_up_multiple(n, 6)
    # the stacked reductions take a mesh object: a spec string is not
    # resolved there, in either package
    with pytest.raises(AttributeError):
        agg.stacked_mean({"w": torch.zeros(2, 3)}, mesh="auto")
    with pytest.raises(AttributeError):
        j_agg.stacked_mean({"w": jnp.zeros((2, 3))}, mesh="auto")


# -- (b) window assembly ----------------------------------------------------


@pytest.mark.parametrize("sizes", [(40, 200, 90), (96, 96, 96)])
def test_window_matches_reference(world, sizes):
    """The same xb, yb, mask, steps and uniform as the reference's, bit for
    bit, over the clients and steps the port keeps (the reference pads the
    client axis to a power of two)."""
    jb, tb, splits = world
    shards = _shards(splits["train"], sizes, seed=11)
    seeds = [3, 1234, 99]
    want = JCohort(jb, capacity=4).assembler.assemble(shards, seeds, 2, 4)
    got = cohort.CohortBackend(tb, overlap=False).assembler.take(
        shards, seeds, 2)
    k, t = len(shards), max(got.steps)
    assert got.steps == want.steps and got.uniform == want.uniform
    assert got.uniform == (len(set(sizes)) == 1)
    assert got.xb.shape[:2] == got.mask.shape == (k, t)
    for name in ("xb", "yb", "mask"):
        ref = np.asarray(getattr(want, name))[:k, :t]
        assert np.array_equal(getattr(got, name).numpy(), ref), name


def test_prefetched_window_equals_inline(world):
    _, tb, splits = world
    shards = _shards(splits["train"], (40, 200, 90), seed=11)
    inline = cohort.CohortBackend(tb, overlap=False).assembler
    early = cohort.CohortBackend(tb, overlap=True).assembler
    early.prefetch(shards, [3, 4, 5], 2)
    assert early._pending is not None
    got = early.take(shards, [3, 4, 5], 2)
    assert early._pending is None
    want = inline.take(shards, [3, 4, 5], 2)
    # a stale prefetch is settled and replaced by an inline assembly
    early.prefetch(shards, [3, 4, 6], 2)
    stale = early.take(shards, [3, 4, 5], 2)
    for win in (got, stale):
        assert win.steps == want.steps and win.uniform == want.uniform
        for name in ("xb", "yb", "mask"):
            assert torch.equal(getattr(win, name), getattr(want, name))
    early.close()


# -- (c) window means: true division, bit for bit -----------------------------


def _rows_and_masks(k=64, n=128, c=64, seed=0):
    """Rows of fractions j/1024 and masks keeping 3..127 samples, as the
    per-sample Eq. 3 rows of VGG16 at 32x32 are."""
    rng = np.random.default_rng(seed)
    rows = (rng.integers(0, 1025, (k, n, c)) / 1024).astype(np.float32)
    counts = rng.integers(3, 128, k)
    masks = (np.arange(n)[None, :] < counts[:, None]).astype(np.float32)
    return rows, masks, counts


@pytest.mark.parametrize("what", ["signature", "accuracy"])
def test_window_means_are_the_reference_bits(world, what):
    jb, tb, _ = world
    rows, masks, counts = _rows_and_masks()
    engine = JCohort(jb, capacity=8)
    dummy = jnp.zeros((len(counts),))
    if what == "signature":
        engine.programs.sample_signature = lambda params, xs: xs
        want = np.asarray(engine._sig_jit(dummy, jnp.asarray(rows),
                                          jnp.asarray(masks)))
        got = np.stack([cohort._masked_mean(torch.from_numpy(r),
                                            torch.from_numpy(m)).numpy()
                        for r, m in zip(rows, masks)])
        sums = (rows * masks[:, :, None]).sum(axis=1)
    else:
        flags = (rows[:, :, 0] > 0.5).astype(np.float32)
        engine.programs.eval_terms = lambda p, xs, ys, ms: (
            jnp.sum(xs * ms), jnp.sum(ms))
        want = np.asarray(engine._eval_jit(dummy, jnp.asarray(flags), dummy,
                                           jnp.asarray(masks)))
        programs = cohort.CNNCohortPrograms(tb)
        programs.eval_terms = lambda p, xs, ys, ms: ((xs * ms).sum(),
                                                     ms.sum())
        got = np.stack([programs.masked_eval(None, torch.from_numpy(f), None,
                                             torch.from_numpy(m)).numpy()
                        for f, m in zip(flags, masks)])
        sums = (flags * masks).sum(axis=1)
    assert got.dtype == want.dtype == np.float32
    assert np.array_equal(got, want)
    # the reciprocal multiply is another number on some of these counts
    n = counts.astype(np.float32).reshape((-1,) + (1,) * (sums.ndim - 1))
    assert np.array_equal(got, sums / n)
    assert not np.array_equal(got, sums * (np.float32(1) / n))


# -- (d), (e) the engine against the reference's ----------------------------


@pytest.fixture(scope="module")
def trained(world):
    """Three ragged clients trained by both engines from the same stacked
    JAX weights and seeds (the reference pads its client axis to 4)."""
    jb, tb, splits = world
    shards = _shards(splits["train"], (40, 200, 90), seed=5)
    seeds = [7, 8, 9]
    starts = _models(3)
    j_engine = JCohort(jb, capacity=4)
    j_models, j_losses = j_engine.train_cohort(
        [jax.tree_util.tree_map(jnp.asarray, m) for m in starts], shards,
        seeds)
    t_engine = cohort.CohortBackend(tb)
    t_models, t_losses = t_engine.train_cohort(
        [params_from_numpy(m, "cpu") for m in starts], shards, seeds)
    return dict(shards=shards, j_engine=j_engine, t_engine=t_engine,
                j_models=j_models, t_models=t_models, j_losses=j_losses,
                t_losses=t_losses, starts=starts)


def test_train_cohort_matches_reference(trained):
    for k, (jm, tm) in enumerate(zip(trained["j_models"],
                                     trained["t_models"])):
        for a, b in zip(jax.tree_util.tree_leaves(jm), agg.tree_leaves(tm)):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0,
                                       atol=ATOL, err_msg=f"client {k}")
    np.testing.assert_allclose(trained["t_losses"], trained["j_losses"],
                               rtol=0, atol=5e-2)
    # the starting models are left as they were
    assert all(np.array_equal(a, b) for a, b in zip(
        jax.tree_util.tree_leaves(trained["starts"][0]),
        jax.tree_util.tree_leaves(_np_params(0))))


def _same_models(trained):
    """The reference's trained models, carried over to the port."""
    return [params_from_numpy(jax.tree_util.tree_map(np.asarray, m), "cpu")
            for m in trained["j_models"]]


def _assert_same_accuracies(got, want, ns):
    for g, w, n in zip(got, want, ns):
        assert round(g * n) == round(w * n), (got, want)      # the counts
        assert g == w, (got, want)


@pytest.mark.parametrize("call", ["evaluate_cohort", "evaluate_many_1",
                                  "evaluate_many_3", "evaluate_shared",
                                  "signature_cohort"])
def test_engine_calls_match_reference(world, trained, call):
    _, _, splits = world
    shards = trained["shards"]
    j_engine, t_engine = trained["j_engine"], trained["t_engine"]
    j_models, t_models = trained["j_models"], _same_models(trained)
    val = splits["val"]
    if call == "evaluate_cohort":
        _assert_same_accuracies(t_engine.evaluate_cohort(t_models, shards),
                                j_engine.evaluate_cohort(j_models, shards),
                                [len(s) for s in shards])
    elif call.startswith("evaluate_many"):
        m = int(call[-1])
        _assert_same_accuracies(
            t_engine.evaluate_many(t_models[:m], val),
            j_engine.evaluate_many(j_models[:m], val), [len(val)] * m)
    elif call == "evaluate_shared":
        _assert_same_accuracies(
            t_engine.evaluate_shared(t_models[1], shards),
            j_engine.evaluate_shared(j_models[1], shards),
            [len(s) for s in shards])
    else:
        got = t_engine.signature_cohort(t_models, shards)
        want = j_engine.signature_cohort(j_models, shards)
        assert got.shape == want.shape == (3, 16)
        diff = np.argwhere(got != want)
        assert not len(diff), "channels differ (client, channel): " + ", ".join(
            f"{tuple(i)} by {got[tuple(i)] - want[tuple(i)]:.3g}"
            for i in diff)


# -- (f) inside the port: the cohort equals the sequential path -------------


@pytest.mark.parametrize("n_clients", [2, 3, 4])
def test_cohort_train_matches_sequential(world, n_clients):
    _, tb, splits = world
    rng = np.random.default_rng(n_clients)
    shards = _shards(splits["train"],
                     [int(rng.integers(40, 200)) for _ in range(n_clients)],
                     seed=n_clients)
    params = [params_from_numpy(_np_params(i), "cpu")
              for i in range(n_clients)]
    seeds = [int(rng.integers(2 ** 31)) for _ in range(n_clients)]
    seq = [tb.train_local(p, d, seed=s)
           for p, d, s in zip(params, shards, seeds)]
    coh, losses = cohort.CohortBackend(tb).train_cohort(params, shards, seeds)
    for i in range(n_clients):
        for a, b in zip(agg.tree_leaves(seq[i][0]), agg.tree_leaves(coh[i])):
            assert torch.allclose(a, b, rtol=0, atol=ATOL), f"client {i}"
        assert losses[i] == pytest.approx(seq[i][1], abs=5e-2)


def test_padding_never_leaks(world):
    """A client trained beside a much larger one (so its step axis is padded
    with masked steps) gets the weights it gets trained alone; validation
    and signatures ignore the padded samples."""
    _, tb, splits = world
    small, large = _shards(splits["train"], [40, 420], seed=3)
    engine = cohort.CohortBackend(tb)
    p0, p1 = (params_from_numpy(_np_params(i), "cpu") for i in (0, 1))
    solo_small, _ = tb.train_local(p0, small, seed=7)
    solo_large, _ = tb.train_local(p1, large, seed=8)
    win = engine.assembler.take([small, large], [7, 8], 2)
    assert win.steps == [2, 26] and not win.uniform
    coh, _ = engine.train_cohort([p0, p1], [small, large], [7, 8])
    for solo, got in ((solo_small, coh[0]), (solo_large, coh[1])):
        for a, b in zip(agg.tree_leaves(solo), agg.tree_leaves(got)):
            assert torch.allclose(a, b, rtol=0, atol=ATOL)
    # beside a client of 4 steps the small one takes 2 masked steps, not
    # 24: its bits stay the same
    medium = _shards(splits["train"], [70], seed=4)[0]
    short, _ = engine.train_cohort([p0, p1], [small, medium], [7, 8])
    for a, b in zip(agg.tree_leaves(short[0]), agg.tree_leaves(coh[0])):
        assert torch.equal(a, b)
    accs = engine.evaluate_cohort(coh, [small, large])
    sigs = engine.signature_cohort(coh, [small, large])
    for k, ds in enumerate((small, large)):
        assert accs[k] == pytest.approx(tb.evaluate(coh[k], ds), abs=1e-6)
        np.testing.assert_allclose(sigs[k], tb.signature(coh[k], ds),
                                   rtol=1e-6, atol=0)


def test_evaluate_many_and_shared_match_sequential(world):
    _, tb, splits = world
    shards = _shards(splits["train"], [60, 90, 120], seed=5)
    engine = cohort.CohortBackend(tb)
    models = [tb.train_local(params_from_numpy(_np_params(i), "cpu"),
                             shards[i], seed=i)[0] for i in range(3)]
    for m in (1, 3):
        got = engine.evaluate_many(models[:m], splits["val"])
        for acc, model in zip(got, models):
            assert acc == pytest.approx(tb.evaluate(model, splits["val"]),
                                        abs=1e-6)
    shared = engine.evaluate_shared(models[0], shards)
    for acc, ds in zip(shared, shards):
        assert acc == pytest.approx(tb.evaluate(models[0], ds), abs=1e-6)
    assert engine.evaluate_many([], splits["val"]) == []


def test_eval_cache_keeps_its_bound(world):
    _, tb, splits = world
    shards = _shards(splits["train"], [30, 40, 50, 60], seed=2)
    engine = cohort.CohortBackend(tb, eval_cache_entries=2)
    model = params_from_numpy(_np_params(0), "cpu")
    engine.evaluate_shared(model, shards)       # one wide sweep keeps all
    assert len(engine._eval_data_cache) == 4
    engine.evaluate_shared(model, shards[:1])
    assert len(engine._eval_data_cache) == 2
    assert (id(shards[0]), 512, "eval") in engine._eval_data_cache


# -- (g), (h) coordinator runs ----------------------------------------------


def test_coordinator_cohort_run_matches_reference():
    data, test = _cnn_world(4)
    kw = dict(n_clients=4, max_rounds=2, local_epochs=1, seed=0,
              cohort_size=4, cohort_window=2.0)
    init = j_init(jax.random.PRNGKey(0), j_vgg_for("mnist"))
    ref = JCoord(JBackend(j_vgg_for("mnist"), local_epochs=1, batch_size=32),
                 data, test, JConfig(**kw))
    got = DagAflCoordinator(
        CNNBackend(vgg_for("mnist"), local_epochs=1, batch_size=32,
                   device="cpu"), data, test, DagAflConfig(**kw))
    assert isinstance(got.cohort, cohort.CohortBackend)
    r_ref = ref.run(jax.random.PRNGKey(0))
    r_got = got.run(params_from_numpy(
        jax.tree_util.tree_map(np.asarray, init), "cpu"))
    assert r_got.rounds == r_ref.rounds == 8
    assert r_got.extra["chain_len"] == 9
    assert r_got.extra["verify_failures"] == 0
    assert verify_full_dag(got.ledger) == (True, "ok")
    assert r_got.extra["cohorts_dispatched"] == \
        r_ref.extra["cohorts_dispatched"] >= 1
    assert abs(r_got.final_accuracy - r_ref.final_accuracy) <= 0.05
    assert _tip_decisions(got) == _tip_decisions(ref)


@pytest.mark.parametrize("checkpoint_every", [0.0, 4.0])
def test_stub_backend_stays_sequential(checkpoint_every):
    """``cohort_size=4`` with a backend that has no cohort suite runs the
    sequential path in both packages, with Parity A's exact hashes."""
    data, test = _stub_world(5)
    kw = dict(n_clients=5, max_rounds=5, local_epochs=1, seed=3,
              ledger_checkpoint_every=checkpoint_every, cohort_size=4)
    ref = JCoord(StubBackend(jnp.asarray), data, test, JConfig(**kw))
    got = DagAflCoordinator(StubBackend(torch.from_numpy), data, test,
                            DagAflConfig(**kw))
    assert got.cohort is None and ref.cohort is None
    r_ref, r_got = ref.run(), got.run()
    assert _hashes(got) == _hashes(ref) and len(_hashes(got)) > 10
    assert _tip_decisions(got) == _tip_decisions(ref)
    assert r_got.extra["cohorts_dispatched"] == 0
    for field in ("final_accuracy", "sim_time", "rounds", "history"):
        assert getattr(r_got, field) == getattr(r_ref, field), field


@pytest.mark.parametrize("backend,size,mesh,built", [
    ("cnn", 4, "auto", True), ("cnn", 4, None, True), ("cnn", 1, "auto", False),
    ("stub", 4, "auto", False)])
def test_build_cohort_engine(world, backend, size, mesh, built):
    tb = world[1] if backend == "cnn" else StubBackend(torch.from_numpy)
    engine = cohort.build_cohort_engine(tb, cohort_size=size, mesh=mesh)
    assert (engine is not None) == built
    assert cohort.CohortBackend.supports(tb) == (backend == "cnn")
    if not built and backend == "stub":
        with pytest.raises(TypeError, match="no CohortPrograms"):
            cohort.CohortBackend(tb)

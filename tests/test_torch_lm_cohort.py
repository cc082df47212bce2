"""The port's LM cohort suite (``LMCohortPrograms``) against the JAX
reference's ``CohortBackend(LMBackend(...))``, and against its own
sequential path.

Five reduced families in float32, from the JAX genesis
(``weights.params_from_numpy``): internlm2 at d_model 64, the Jamba hybrid
(one Mamba and one attention layer), the ``(mlstm, slstm)`` xLSTM, and the
MoE configs (Jamba's ``(mamba, dense)``, ``(mamba, moe)``; llama4's
``(attn, dense)``, ``(attn, moe)`` with its shared expert), each
at a 128-token vocabulary, 37 positions (not a power of two, so a
reciprocal multiply and a division give other bits) and batch 4.  The
reference runs its plain math (``kernel_policy="reference"``), the port
its kernels' plain versions on the CPU.  Tolerances and their reasons:

* trained leaves 1e-4 and losses 1e-5 -- the same SGD steps, gradients
  summed in another order (the reference's chunked cross-entropy);
* window means: bit for bit on the same correctness grid, padded as the
  reference engine pads it -- a row's accuracy multiplies by the float32
  reciprocal of S, the window's mean divides, and both add the rows in
  the same order; the signature means too, each row's scaling fused into
  the sum as XLA fuses it;
* accuracies of the engine calls: equal (the correct counts are);
* ``per_sample_signature``: bit for bit -- exact counts and bucket sums,
  one reciprocal;
* ``signature_cohort``: within 1/(S*w) per bucket -- one flag may sit on
  the other side of tau after float32 forwards in another order;
* padding: a client's bits do not depend on how many masked steps it
  takes;
* the coordinator run: the same tip decisions in the same windows.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.configs import reduced as j_reduced  # noqa: E402
from repro.configs.base import LayerSpec as JLayerSpec  # noqa: E402
from repro.configs.base import Stage as JStage  # noqa: E402
from repro.core.coordinator import DagAflConfig as JConfig  # noqa: E402
from repro.core.coordinator import DagAflCoordinator as JCoord  # noqa: E402
from repro.data import make_lm_dataset  # noqa: E402
from repro.fl.backend import LMBackend as JBackend  # noqa: E402
from repro.fl.cohort import CohortBackend as JCohort  # noqa: E402
from repro.models import transformer as j_tfm  # noqa: E402
from repro.runtime import Runtime as JRuntime  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.configs.base import LayerSpec, Stage  # noqa: E402
from repro_torch.core import aggregate as agg  # noqa: E402
from repro_torch.core.coordinator import DagAflConfig, DagAflCoordinator  # noqa: E402
from repro_torch.core.verify import verify_full_dag  # noqa: E402
from repro_torch.data.pipeline import AssembledWindow  # noqa: E402
from repro_torch.fl import cohort  # noqa: E402
from repro_torch.fl.backend import LMBackend  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.runtime import Runtime  # noqa: E402
from repro_torch.weights import params_from_numpy  # noqa: E402
from test_torch_baselines import few_torch_threads  # noqa: E402,F401
from test_torch_mamba import _tip_decisions  # noqa: E402

VOCAB = 128
SEQ = 37
KW = dict(lr=5e-3, local_steps=2, batch_size=4, seq_len=SEQ)
FAMILIES = ("internlm2", "hybrid", "xlstm", "jamba_moe", "llama4")
# the reduced configs' own first two layers: Jamba's (mamba, dense),
# (mamba, moe) and llama4's (attn, dense), (attn, moe)
_REDUCED = {"internlm2": "internlm2-1.8b", "jamba_moe": "jamba-v0.1-52b",
            "llama4": "llama4-maverick-400b-a17b"}


def _configs(family):
    """(JAX config, port config) of one reduced family, float32."""
    if family in _REDUCED:
        jc = j_reduced(j_get_config(_REDUCED[family]), d_model=64)
        tc = reduced(get_config(_REDUCED[family]), d_model=64)
    else:
        arch, kinds, ffn = (("jamba-v0.1-52b", ("mamba", "attn"), "dense")
                            if family == "hybrid" else
                            ("xlstm-125m", ("mlstm", "slstm"), "none"))

        def staged(cfg, spec, stage):
            return dataclasses.replace(cfg, n_layers=2, stages=(stage(
                tuple(spec(kind=k, ffn=ffn) for k in kinds), 1),))

        jc = staged(j_reduced(j_get_config(arch), d_model=64), JLayerSpec,
                    JStage)
        tc = staged(reduced(get_config(arch), d_model=64), LayerSpec, Stage)
    jc = dataclasses.replace(jc, vocab_size=VOCAB, compute_dtype="float32")
    tc = dataclasses.replace(tc, vocab_size=VOCAB, compute_dtype="float32")
    return jc, tc


def _streams(n, seed=0):
    return [make_lm_dataset(vocab=VOCAB, n_tokens=3000, order=2.0,
                            seed=seed + c) for c in range(n)]


def _np_params(jc, seed):
    return jax.tree_util.tree_map(
        np.array, j_tfm.init_params(jax.random.PRNGKey(seed), jc))


def _leaves(tree):
    return [np.asarray(a) for a in jax.tree_util.tree_leaves(tree)]


@pytest.fixture(scope="module", params=FAMILIES)
def world(request):
    """Both engines over one family, three ragged-free clients trained
    from the same genesis trees and seeds."""
    jc, tc = _configs(request.param)
    jb = JBackend(jc, kernel_policy="reference", **KW)
    tb = LMBackend(tc, device="cpu", **KW)
    streams = _streams(3)
    starts = [_np_params(jc, s) for s in range(3)]
    seeds = [7, 8, 9]
    j_engine = JCohort(jb, capacity=4)
    t_engine = cohort.CohortBackend(tb)
    j_models, j_losses = j_engine.train_cohort(
        [jax.tree_util.tree_map(jnp.asarray, m) for m in starts], streams,
        seeds)
    t_models, t_losses = t_engine.train_cohort(
        [params_from_numpy(m, "cpu") for m in starts], streams, seeds)
    return dict(family=request.param, jc=jc, tc=tc, jb=jb, tb=tb,
                streams=streams, starts=starts, seeds=seeds,
                j_engine=j_engine, t_engine=t_engine, j_models=j_models,
                t_models=t_models, j_losses=j_losses, t_losses=t_losses)


def _same_models(world):
    """The reference's trained models, carried over to the port."""
    return [params_from_numpy(jax.tree_util.tree_map(np.asarray, m), "cpu")
            for m in world["j_models"]]


# -- the suite is registered, and windows train as the reference's ---------


def test_lm_backend_gets_an_engine():
    _, tc = _configs("internlm2")
    engine = cohort.build_cohort_engine(LMBackend(tc, device="cpu", **KW),
                                        cohort_size=2)
    assert isinstance(engine.programs, cohort.LMCohortPrograms)
    assert engine.programs.default_epochs == KW["local_steps"]
    assert engine.programs.eval_many_min_batch == 3


def test_train_cohort_matches_reference(world):
    for k, (jm, tm) in enumerate(zip(world["j_models"], world["t_models"])):
        for a, b in zip(_leaves(jm), agg.tree_leaves(tm)):
            np.testing.assert_allclose(b.numpy(), a, rtol=0, atol=1e-4,
                                       err_msg=f"client {k}")
    np.testing.assert_allclose(world["t_losses"], world["j_losses"],
                               rtol=0, atol=1e-5)


def _ragged(engine, streams, seeds, steps):
    """The engine's window for ``streams`` with client k's steps cut to
    ``steps[k]``: its later steps masked, as a shorter shard's are."""
    full = engine.assembler.assemble(streams, seeds, max(steps))
    mask = (torch.arange(max(steps))[None, :]
            < torch.tensor(steps)[:, None]).float()
    return AssembledWindow(full.xb, full.yb, mask, list(steps),
                           len(set(steps)) == 1)


def test_ragged_window_matches_reference(world):
    """Masked steps: client 0 takes 1 of the window's 3 steps, client 1 all
    3, client 2 two; both engines from the same windows."""
    steps = [1, 3, 2]
    streams, seeds = world["streams"], world["seeds"]
    t_engine, j_engine = world["t_engine"], world["j_engine"]
    win = _ragged(t_engine, streams, seeds, steps)
    stacked = agg.tree_stack([params_from_numpy(m, "cpu")
                              for m in world["starts"]])
    got, t_losses = t_engine._train(stacked, win)
    j_stacked = jax.tree_util.tree_map(
        lambda *a: jnp.stack([jnp.asarray(x) for x in a]), *world["starts"])
    want, j_losses = j_engine._train_jit(
        j_stacked, jnp.asarray(win.xb.numpy()), jnp.asarray(win.yb.numpy()),
        jnp.asarray(win.mask.numpy()))
    for a, b in zip(_leaves(want), agg.tree_leaves(got)):
        np.testing.assert_allclose(b.numpy(), a, rtol=0, atol=1e-4)
    np.testing.assert_allclose(t_losses, np.asarray(j_losses), rtol=0,
                               atol=1e-5)
    assert np.all(t_losses[win.mask.numpy() == 0] == 0.0)


@pytest.mark.parametrize("family", FAMILIES)
def test_padding_never_leaks(family):
    """A client's trained bits do not depend on how many masked steps it
    takes beside a longer client, and equal its own step trained alone by
    the sequential path within float32 rounding."""
    jc, tc = _configs(family)
    tb = LMBackend(tc, device="cpu", **KW)
    engine = cohort.CohortBackend(tb)
    streams, seeds = _streams(2), [7, 8]
    starts = [_np_params(jc, s) for s in range(2)]
    stacked = agg.tree_stack([params_from_numpy(m, "cpu") for m in starts])
    short, losses = engine._train(stacked, _ragged(engine, streams, seeds,
                                                   [1, 2]))
    long, _ = engine._train(stacked, _ragged(engine, streams, seeds, [1, 3]))
    assert losses[0, 1] == 0.0 and losses[1, 1] > 0.0
    for a, b in zip(agg.tree_leaves(short), agg.tree_leaves(long)):
        assert torch.equal(a[0], b[0])
    solo, _ = tb.train_local(params_from_numpy(starts[0], "cpu"), streams[0],
                             seed=seeds[0], epochs=1)
    for a, b in zip(agg.tree_leaves(solo), agg.tree_leaves(short)):
        torch.testing.assert_close(a, b[0], rtol=0, atol=1e-6)


def test_cohort_train_matches_sequential(world):
    """Inside the port: the window's clients are the sequential path's."""
    streams, seeds, tb = world["streams"], world["seeds"], world["tb"]
    for k, model in enumerate(world["t_models"]):
        solo, loss = tb.train_local(params_from_numpy(world["starts"][k],
                                                      "cpu"),
                                    streams[k], seed=seeds[k])
        for a, b in zip(agg.tree_leaves(solo), agg.tree_leaves(model)):
            torch.testing.assert_close(a, b, rtol=0, atol=1e-6)
        assert world["t_losses"][k] == pytest.approx(loss, abs=1e-6)


@pytest.mark.parametrize("which", ["mamba", "mlstm"])
def test_model_scans_keep_every_chunk_under_vmap(monkeypatch, which):
    """Inside ``torch.func.vmap`` an input's ``requires_grad`` reads False,
    and the models' own scans keep every chunk rather than checkpoint it
    (a checkpoint's backward would recompute it outside the vmap); the
    vmapped gradient equals the per-client one."""
    from repro_torch.models import mamba, xlstm
    mod = mamba if which == "mamba" else xlstm
    calls = []
    inner = mod.checkpoint
    monkeypatch.setattr(mod, "checkpoint", lambda *a, **kw: (
        calls.append(1), inner(*a, **kw))[1])
    rng = np.random.default_rng(1)
    if which == "mamba":
        x, dt = (torch.from_numpy(rng.random((2, 1, 70, 4),
                                             dtype=np.float32))
                 for _ in range(2))
        A = -torch.ones((4, 2))
        Bc, Cc = (torch.ones((2, 1, 70, 2)) for _ in range(2))
        h0 = torch.zeros((1, 4, 2))

        def fn(x, dt):
            y, h = mamba.selective_scan_ref(x, dt, A, Bc[0], Cc[0], h0,
                                            chunk=32)
            return y.sum() + h.sum()
    else:
        x, dt = (torch.from_numpy(rng.normal(size=(2, 1, 70, 2, 4)).astype(
            np.float32)) for _ in range(2))
        gates = torch.from_numpy(rng.normal(size=(1, 70, 2)).astype(
            np.float32))
        state = {"C": torch.zeros((1, 2, 4, 4)), "n": torch.zeros((1, 2, 4)),
                 "m": torch.full((1, 2), -1e30)}

        def fn(x, dt):
            h, st = xlstm.mlstm_chunkwise(x, dt, x, gates, gates, state,
                                          chunk=32)
            return h.sum() + st["C"].sum()
    x.requires_grad_(True)
    torch.func.vmap(fn)(x, dt).sum().backward()
    assert calls == []
    for k in range(2):
        xk = x[k].detach().requires_grad_(True)
        fn(xk, dt[k]).backward()
        torch.testing.assert_close(x.grad[k], xk.grad, rtol=0, atol=1e-6)


# -- validation and signatures ----------------------------------------------


@pytest.mark.parametrize("call", ["evaluate_cohort", "evaluate_shared",
                                  "evaluate_many_2", "evaluate_many_4",
                                  "signature_cohort"])
def test_engine_calls_match_reference(world, call):
    streams = world["streams"]
    j_engine, t_engine = world["j_engine"], world["t_engine"]
    j_models, t_models = world["j_models"], _same_models(world)
    if call == "evaluate_cohort":
        got = t_engine.evaluate_cohort(t_models, streams)
        want = j_engine.evaluate_cohort(j_models, streams)
    elif call == "evaluate_shared":
        got = t_engine.evaluate_shared(t_models[1], streams)
        want = j_engine.evaluate_shared(j_models[1], streams)
    elif call.startswith("evaluate_many"):
        m = int(call[-1])
        pick = [0, 1, 2, 0][:m]
        got = t_engine.evaluate_many([t_models[i] for i in pick], streams[2])
        want = j_engine.evaluate_many([j_models[i] for i in pick],
                                      streams[2])
    else:
        got = t_engine.signature_cohort(t_models, streams)
        want = j_engine.signature_cohort(j_models, streams)
        assert got.shape == want.shape == (3, 64)
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1 / (KW["batch_size"] * SEQ))
        return
    assert all(isinstance(a, float) for a in got)
    n = KW["batch_size"] * SEQ
    assert [round(a * n) for a in got] == [round(a * n) for a in want]
    assert got == want


def _grid(k, n, seed):
    """A (k, n, SEQ) correctness grid and (k, n) row masks with a padded
    tail."""
    rng = np.random.default_rng(seed)
    grid = (rng.random((k, n, SEQ)) < 0.4).astype(np.float32)
    mask = (np.arange(n)[None, :] < rng.integers(2, n + 1, k)[:, None])
    return grid, mask.astype(np.float32)


def _padded(j_engine, *arrays):
    """The arrays' row axis (axis 1) zero-padded as the reference engine
    pads a shard (``_round_chunk``)."""
    n = arrays[0].shape[1]
    extra = j_engine._round_chunk(n) - n
    return [np.concatenate([a, np.zeros((a.shape[0], extra) + a.shape[2:],
                                        a.dtype)], axis=1) for a in arrays]


# XLA:CPU adds up to 32 rows in 4 or 8 vector lanes or left to right,
# and more in windows of 32 (split again past 1,024 rows); the reference
# engine pads a shard's rows to a power of two below 64
@pytest.mark.parametrize("rows", [4, 8, 12, 21, 24, 33, 40, 64, 1025])
@pytest.mark.parametrize("what", ["cohort", "shared", "many_2", "many_4"])
def test_window_means_are_the_reference_bits(what, rows):
    """The means of the jitted reference programs on one correctness grid,
    padded as the reference engine pads it, against the port's on the
    unpadded grid: the same bits, where a division of the same sums would
    not give them all."""
    jc, tc = _configs("internlm2")
    j_engine = JCohort(JBackend(jc, kernel_policy="reference", **KW),
                       capacity=4)
    programs = cohort.LMCohortPrograms(LMBackend(tc, device="cpu", **KW))
    k = 4 if what == "many_4" else 2 if what == "many_2" else 3
    grid, mask = _grid(k, rows, seed=k + len(what) + rows)
    j_grid, j_mask = (jnp.asarray(a) for a in _padded(j_engine, grid, mask))
    j_engine.programs._row_correct = lambda p, xs, ys: ys
    programs._row_correct = lambda p, xs, ys: ys
    dummy = jnp.zeros((k,))
    if what == "cohort":
        want = j_engine._eval_jit(dummy, j_grid, j_grid, j_mask)
        got = [programs.masked_eval(None, torch.from_numpy(g),
                                    torch.from_numpy(g), torch.from_numpy(m))
               for g, m in zip(grid, mask)]
    elif what == "shared":
        want = j_engine._eval_shared_jit(None, j_grid, j_grid, j_mask)
        got = programs.eval_shared(None, torch.from_numpy(grid),
                                   torch.from_numpy(grid),
                                   torch.from_numpy(mask))
    else:
        want = j_engine._eval_many_jit(dummy, j_grid[0], j_grid[0],
                                       j_mask[0])
        got = [programs.masked_eval(None, torch.from_numpy(grid[0]),
                                    torch.from_numpy(grid[0]),
                                    torch.from_numpy(mask[0]))] * k
    got = np.asarray([float(g) for g in got], np.float32)
    want = np.asarray(want, np.float32)
    assert np.array_equal(got, want), (got, want)
    # a row's accuracy by division, or the window's by a reciprocal, is
    # another number on some rows of these grids
    rows = grid.sum(-1) * (np.float32(1) / np.float32(SEQ))
    assert not np.array_equal(rows, grid.sum(-1) / np.float32(SEQ))


@pytest.mark.parametrize("rows", [2, 3, 4, 5, 8, 12, 16, 21, 32, 33, 40])
def test_signature_means_are_the_reference_bits(rows):
    """The reference's masked signature mean (``_sig_impl``) of the rows of
    one final-norm output, padded as its engine pads them, against the
    port's from the exact bucket counts: the same bits (the reference
    fuses each row's scaling into the sum up to 32 rows)."""
    jc, tc = _configs("internlm2")
    j_engine = JCohort(JBackend(jc, kernel_policy="reference", **KW),
                       capacity=4)
    programs = cohort.LMCohortPrograms(LMBackend(tc, device="cpu", **KW))
    rt = JRuntime(signature_tau=programs.sig_runtime.signature_tau)
    j_engine.programs.sample_signature = \
        lambda p, xs: j_tfm.per_sample_signature(xs, rt)
    programs._hidden = lambda p, xs: xs
    rng = np.random.default_rng(rows)
    h = (rng.standard_normal((3, rows, SEQ, 100)) * 0.06).astype(np.float32)
    mask = (np.arange(rows)[None, :] < rng.integers(1, rows + 1, 3)[:, None])
    mask = mask.astype(np.float32)
    want = np.asarray(j_engine._sig_jit(jnp.zeros((3,)),
                                         *_padded(j_engine, h, mask)))
    got = np.stack([programs.signature_mean(None, torch.from_numpy(x),
                                            torch.from_numpy(m)).numpy()
                    for x, m in zip(h, mask)])
    assert np.array_equal(got, want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,tau", [((4, 37, 64), 0.05),
                                       ((3, 29, 100), 0.05),
                                       ((2, 37, 200), 0.3)])
def test_per_sample_signature_bits_and_one_launch(monkeypatch, shape, tau,
                                                  dtype):
    rng = np.random.default_rng(sum(shape))
    h32 = (rng.standard_normal(shape) * 0.2).astype(np.float32)
    h = torch.from_numpy(h32).to(getattr(torch, dtype))
    calls = []
    inner = ops.signature_counts

    def counted(x, tau):
        calls.append(tuple(x.shape))
        return inner(x, tau)

    monkeypatch.setattr(ops, "signature_counts", counted)
    got = tfm.per_sample_signature(h, Runtime(signature_tau=tau))
    assert calls == [shape]
    want = j_tfm.per_sample_signature(
        jnp.asarray(h.float().numpy()).astype(dtype),
        JRuntime(signature_tau=tau))
    assert got.dtype == torch.float32 and got.shape == (shape[0], 64)
    assert np.array_equal(got.numpy(), np.asarray(want))


# -- the coordinator on the engine ------------------------------------------


def test_coordinator_cohort_run_matches_reference():
    """Four reduced-internlm2 clients, ``cohort_size=2``: the same windows,
    rounds and tip decisions in both packages."""
    jc, tc = _configs("internlm2")
    streams = _streams(4)
    data = [{"train": s, "val": s, "test": s} for s in streams]
    test = make_lm_dataset(vocab=VOCAB, n_tokens=3000, order=2.0,
                           seed=10_000)
    kw = dict(n_clients=4, max_rounds=2, local_epochs=2, seed=0,
              cohort_size=2, cohort_window=2.0)
    ref = JCoord(JBackend(jc, kernel_policy="reference", **KW), data, test,
                 JConfig(**kw))
    got = DagAflCoordinator(LMBackend(tc, device="cpu", **KW), data, test,
                            DagAflConfig(**kw))
    assert isinstance(got.cohort.programs, cohort.LMCohortPrograms)
    windows = {"ref": [], "got": []}
    for name, coord in (("ref", ref), ("got", got)):
        flush = coord._window.flush_fn
        coord._window.flush_fn = (lambda batch, f=flush, w=windows[name]:
                                  (w.append(len(batch)), f(batch))[1])
    r_ref = ref.run(jax.random.PRNGKey(0))
    r_got = got.run(params_from_numpy(_np_params(jc, 0), "cpu"))
    assert r_got.rounds == r_ref.rounds == 8
    assert r_got.extra["chain_len"] == 9
    assert r_got.extra["verify_failures"] == 0
    assert verify_full_dag(got.ledger) == (True, "ok")
    assert windows["got"] == windows["ref"] and max(windows["got"]) == 2
    assert r_got.extra["cohorts_dispatched"] == \
        r_ref.extra["cohorts_dispatched"] >= 1
    assert _tip_decisions(got) == _tip_decisions(ref)
    assert r_got.final_accuracy == r_ref.final_accuracy

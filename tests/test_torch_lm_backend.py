"""The port's ``LMBackend`` and the DAG-AFL loop over it, against the JAX
reference, from the same weights and token streams.

The world is ``benchmarks/chain_perf.py``'s LM world: reduced internlm2 at
d_model 64 with a 128-token vocabulary, batch 8, 64 positions.  Both sides
run in float32.  The reference runs its kernels in interpret mode, the port
its plain versions on the CPU.  Tolerances and their reasons:

* ``train_local``: parameters within 1e-6 absolute -- two SGD steps whose
  gradients differ in the last float32 bits;
* ``evaluate``: equal -- the accuracy counts argmax hits (logits agree to
  about 1e-6, far from a tie on these inputs) and multiplies by the same
  float32 reciprocal;
* ``signature``: equal -- exact flag counts and bucket sums (no activation
  of these inputs lies within rounding of tau);
* the coordinator run: the same tip decisions, the same accuracy and
  signature on every transaction, and the same final accuracy.
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
from repro.models import transformer as j_tfm  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.configs.base import LayerSpec, Stage  # noqa: E402
from repro_torch.core.aggregate import tree_leaves  # noqa: E402
from repro_torch.core.coordinator import DagAflConfig, DagAflCoordinator  # noqa: E402
from repro_torch.core.verify import verify_full_dag  # noqa: E402
from repro_torch.fl.backend import LMBackend  # noqa: E402
from repro_torch.weights import params_from_numpy  # noqa: E402
from test_torch_baselines import few_torch_threads  # noqa: E402,F401

KW = dict(lr=5e-3, local_steps=2, batch_size=8, seq_len=64)


# the MoE configs reduced: Jamba's (mamba, dense), (mamba, moe) and
# llama4's (attn, dense), (attn, moe) with its shared expert
MOE_ARCHS = ["jamba-v0.1-52b", "llama4-maverick-400b-a17b"]


def _configs(arch="internlm2-1.8b", **moe_kw):
    jc = dataclasses.replace(j_reduced(j_get_config(arch), d_model=64),
                             vocab_size=128)
    tc = dataclasses.replace(reduced(get_config(arch), d_model=64),
                             vocab_size=128)
    if moe_kw:
        jc = dataclasses.replace(jc, moe=dataclasses.replace(jc.moe,
                                                             **moe_kw))
        tc = dataclasses.replace(tc, moe=dataclasses.replace(tc.moe,
                                                             **moe_kw))
    return jc, tc


def _backends(arch="internlm2-1.8b", **moe_kw):
    jc, tc = _configs(arch, **moe_kw)
    return (JBackend(jc, kernel_policy="interpret", **KW),
            LMBackend(tc, device="cpu", **KW))


def _streams(n):
    return [make_lm_dataset(vocab=128, n_tokens=6000, order=2.0, seed=c)
            for c in range(n)]


def _jax_params(jc, seed=0):
    return jax.tree_util.tree_map(
        np.array, j_tfm.init_params(jax.random.PRNGKey(seed), jc))


def test_sample_draws_match_reference():
    jb, tb = _backends()
    stream = _streams(1)[0]
    for n in (1, 3):
        rj, rt = np.random.default_rng(4), np.random.default_rng(4)
        for _ in range(2):
            assert np.array_equal(np.asarray(jb._sample(stream, rj, n)),
                                  tb._sample(stream, rt, n))


def test_train_evaluate_signature_match_reference():
    _train_evaluate_signature_agree(*_backends())


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_train_evaluate_signature_match_reference(arch):
    _train_evaluate_signature_agree(*_backends(arch))


def _train_evaluate_signature_agree(jb, tb):
    np_params = _jax_params(jb.cfg)
    stream, other = _streams(2)
    j_new, j_loss = jb.train_local(
        jax.tree_util.tree_map(jnp.asarray, np_params), stream, seed=7)
    start = params_from_numpy(np_params, "cpu")
    t_new, t_loss = tb.train_local(start, stream, seed=7)
    for a, b in zip(tree_leaves(start), jax.tree_util.tree_leaves(np_params)):
        assert np.array_equal(a.numpy(), b)        # the caller's model kept
    for a, b in zip(jax.tree_util.tree_leaves(j_new), tree_leaves(t_new)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0,
                                   atol=1e-6)
    assert abs(t_loss - j_loss) <= 1e-5
    same = params_from_numpy(jax.tree_util.tree_map(np.asarray, j_new),
                             "cpu")
    for ds in (stream, other):
        assert tb.evaluate(same, ds) == jb.evaluate(j_new, ds)
        j_sig, t_sig = jb.signature(j_new, ds), tb.signature(same, ds)
        assert isinstance(t_sig, np.ndarray) and t_sig.shape == (64,)
        assert np.array_equal(t_sig, np.asarray(j_sig))


def _tip_decisions(coord) -> list:
    """Per transaction in ledger order: who published it, the parents it
    approved, and the accuracy and signature it carries."""
    txs = sorted(coord.ledger.transactions(), key=lambda t: t.seq)
    who = {t.tx_id: (t.metadata.client_id, t.metadata.current_epoch)
           for t in txs}
    return [(who[t.tx_id],
             tuple(sorted((who.get(p, p) for p in t.parents), key=repr)),
             float(t.metadata.model_accuracy),
             tuple(float(v) for v in t.metadata.signature))
            for t in txs]


def test_lm_coordinator_runs_agree():
    """Three clients, two rounds.  The port's coordinator is the one the
    CNN path runs: token streams go through it as opaque client data."""
    _coordinator_runs_agree(*_backends())


def test_moe_coordinator_runs_agree():
    """The same run over the reduced llama4 (its Jamba counterpart is
    ``test_torch_mamba.py``'s): training routes with the training
    capacity, the eval and signature forwards with the generous one."""
    _coordinator_runs_agree(*_backends("llama4-maverick-400b-a17b"))


def test_gemma2_coordinator_runs_agree():
    """The same run over a reduced gemma2: local layers of window 8, which
    the 64 positions pass, alternating with global layers (two periods),
    soft-caps of 50 on the scores and 30 on the logits, head dim 16; the
    eval and signature forwards on the reference's interpret-mode flash
    kernel with the window and the cap, and on the port's plain version."""
    jc, tc = _configs("gemma2-2b")
    jc = dataclasses.replace(jc, n_layers=4, stages=(JStage(
        (JLayerSpec(window=8), JLayerSpec()), 2),))
    tc = dataclasses.replace(tc, n_layers=4, stages=(Stage(
        (LayerSpec(window=8), LayerSpec()), 2),))
    assert (tc.attn_softcap, tc.final_softcap, tc.head_dim) == (50.0, 30.0,
                                                                16)
    _coordinator_runs_agree(JBackend(jc, kernel_policy="interpret", **KW),
                            LMBackend(tc, device="cpu", **KW))


def _coordinator_runs_agree(jb, tb):
    streams = _streams(3)
    data = [{"train": s, "val": s, "test": s} for s in streams]
    test = make_lm_dataset(vocab=128, n_tokens=6000, order=2.0, seed=10_000)
    kw = dict(n_clients=3, max_rounds=2, local_epochs=2, seed=0)
    ref = JCoord(jb, data, test, JConfig(kernel_policy="interpret", **kw))
    got = DagAflCoordinator(tb, data, test, DagAflConfig(**kw))
    r_ref = ref.run(jax.random.PRNGKey(0))
    r_got = got.run(params_from_numpy(_jax_params(jb.cfg), "cpu"))
    assert r_got.rounds == r_ref.rounds == 6
    assert r_got.extra["chain_len"] == 7
    assert r_got.extra["verify_failures"] == 0
    assert verify_full_dag(got.ledger) == (True, "ok")
    assert _tip_decisions(got) == _tip_decisions(ref)
    assert r_got.final_accuracy == r_ref.final_accuracy


def test_eval_and_signature_forwards_run_in_prefill_mode(monkeypatch):
    """On a reduced Jamba whose training capacity drops tokens (capacity
    factor 0.25), the evaluation forwards route with the generous capacity
    as the reference's do: ``evaluate``, ``signature``, the eval step and
    the cohort engine's validation and signature rows equal the
    reference's, while a training-mode forward gives other logits; and
    every such forward is called with ``mode="prefill"``."""
    from repro.fl.cohort import CohortBackend as JCohort
    from repro.train import step as jstep
    from repro_torch.fl import cohort
    from repro_torch.models import transformer as tfm
    from repro_torch.train import step as tstep
    jb, tb = _backends("jamba-v0.1-52b", capacity_factor=0.25)
    np_params = _jax_params(jb.cfg, seed=3)
    jp = jax.tree_util.tree_map(jnp.asarray, np_params)
    tp = params_from_numpy(np_params, "cpu")
    stream, other = _streams(2)
    tokens = torch.from_numpy(tb._sample(stream, np.random.default_rng(1),
                                         1)[0])
    with torch.no_grad():
        train_logits, _ = tfm.forward(tp, {"tokens": tokens[:, :-1]}, tb.cfg)
        eval_logits, _ = tfm.forward(tp, {"tokens": tokens[:, :-1]}, tb.cfg,
                                     mode="prefill")
    assert not torch.allclose(train_logits, eval_logits, atol=1e-3)
    modes = []
    for name in ("forward", "forward_hidden"):
        inner = getattr(tfm, name)
        monkeypatch.setattr(tfm, name, lambda *a, _f=inner, **kw: (
            modes.append(kw.get("mode")), _f(*a, **kw))[1])
    for ds in (stream, other):
        assert tb.evaluate(tp, ds) == jb.evaluate(jp, ds)
        assert np.array_equal(tb.signature(tp, ds),
                              np.asarray(jb.signature(jp, ds)))
    batch = {"tokens": tokens[:, :-1].numpy()}
    want = jstep.make_eval_step(jb.cfg)(jp, {"tokens": jnp.asarray(
        batch["tokens"])})
    got = tstep.make_eval_step(tb.cfg)(tp, {"tokens": tokens[:, :-1]})
    assert np.float32(got["accuracy"]) == np.float32(want["accuracy"])
    j_engine = JCohort(jb, capacity=4)
    t_engine = cohort.CohortBackend(tb)
    assert t_engine.evaluate_cohort([tp], [stream]) == \
        j_engine.evaluate_cohort([jp], [stream])
    np.testing.assert_allclose(
        t_engine.signature_cohort([tp], [stream]),
        j_engine.signature_cohort([jp], [stream]), rtol=0,
        atol=1 / (KW["batch_size"] * KW["seq_len"]))
    assert modes and set(modes) == {"prefill"}

"""The port's Mamba block and the Jamba hybrid against the JAX reference,
from the same weights and tokens.

The hybrid is jamba-v0.1-52b reduced in both packages to d_model 64 and
one period of its two dense-FFN block kinds, ``(mamba, dense)`` then
``(attn, dense)``; the MoE cut is the reduced config's own first two
layers, ``(mamba, dense)`` then ``(mamba, moe)``.  JAX weights are carried over
with ``params_from_numpy``.  Both sides run in float32; the reference runs
its kernels in interpret mode, the port its plain versions on the CPU.
Tolerances and their reasons:

* the Mamba block's output and state: 1e-5 absolute at a scale of about
  1, the scan's tolerance (float32 ``exp`` and sums differ in the last
  bits between the frameworks);
* logits: atol 2e-5, loss: 1e-5, ``moe_aux`` 1e-5 relative, as for the
  dense and MoE decoders (``test_torch_transformer.py``);
* loss gradients: atol 1e-6 (measured: at most 3.2e-7, on gradients of
  up to 0.18), the same float32 noise carried through the backward;
* signatures: bit-equal (exact counts and bucket sums; no activation of
  these inputs lies within rounding of tau);
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
from repro.models import mamba as j_mamba  # noqa: E402
from repro.models import transformer as j_tfm  # noqa: E402
from repro.runtime import Runtime as JRuntime  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.configs.base import LayerSpec, Stage  # noqa: E402
from repro_torch.core.aggregate import tree_leaves, tree_map  # noqa: E402
from repro_torch.core.coordinator import DagAflConfig, DagAflCoordinator  # noqa: E402
from repro_torch.core.verify import verify_full_dag  # noqa: E402
from repro_torch.fl.backend import LMBackend  # noqa: E402
from repro_torch.models import mamba  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.runtime import Runtime  # noqa: E402
from repro_torch.weights import params_from_numpy  # noqa: E402
from test_torch_baselines import few_torch_threads  # noqa: E402,F401

ARCH = "jamba-v0.1-52b"
# the full-width cut that the card runs: 2 of Jamba's 32 layers
FULL_CUT_PARAMS = 1_036_464_128


def _hybrid(cfg, layer_spec, stage):
    return dataclasses.replace(cfg, n_layers=2, stages=(stage(
        (layer_spec(kind="mamba", ffn="dense"),
         layer_spec(kind="attn", ffn="dense")), 1),))


def _configs(vocab=None):
    jc = _hybrid(j_reduced(j_get_config(ARCH), d_model=64), JLayerSpec,
                 JStage)
    tc = _hybrid(reduced(get_config(ARCH), d_model=64), LayerSpec, Stage)
    if vocab is not None:
        jc = dataclasses.replace(jc, vocab_size=vocab)
        tc = dataclasses.replace(tc, vocab_size=vocab)
    return jc, tc


def _jax_params(jc, seed=0):
    return jax.tree_util.tree_map(
        np.array, j_tfm.init_params(jax.random.PRNGKey(seed), jc))


def test_hybrid_configs_match_reference():
    jc, tc = _configs()
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    assert tc.mamba.d_state == 8 and tc.mamba.chunk == 32


def test_full_width_cut_size():
    """The card's cut at Jamba's published widths: the reference's tree
    holds 1,036,464,128 parameters.  ``param_count()`` (a copy of the
    reference's) counts ``2 * d_in * N`` for a Mamba layer where the tree
    holds ``d_in * N + 3 * d_in`` (``A_log``, ``D``, ``dt_bias``,
    ``conv_b``), and leaves out the norms."""
    jc = _hybrid(j_get_config(ARCH), JLayerSpec, JStage)
    tc = _hybrid(get_config(ARCH), LayerSpec, Stage)
    shapes = jax.eval_shape(lambda k: j_tfm.init_params(k, jc),
                            jax.random.PRNGKey(0))
    assert sum(int(np.prod(a.shape))
               for a in jax.tree_util.tree_leaves(shapes)) == FULL_CUT_PARAMS
    d, d_in, N = 4096, 8192, 16
    norms = d * (2 * 2 + 1)
    assert tc.param_count() == jc.param_count()
    assert tc.param_count() + norms - 2 * d_in * N + d_in * N + 3 * d_in \
        == FULL_CUT_PARAMS


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_mamba_tree_matches_reference(dtype):
    """Keys, shapes and dtypes; ``A_log``, ``D`` and ``dt_bias`` stay float32
    whatever the param dtype."""
    jc, tc = _configs()
    want = jax.eval_shape(
        lambda k: j_mamba.init_mamba(k, jc, jnp.dtype(dtype)),
        jax.random.PRNGKey(0))
    got = mamba.init_mamba(torch.Generator().manual_seed(0), tc,
                           getattr(torch, dtype))
    assert sorted(got) == sorted(want)
    for name, a in want.items():
        assert tuple(got[name].shape) == a.shape, name
        assert str(got[name].dtype).split(".")[-1] == str(a.dtype), name
    # the values that are not drawn
    j_vals = j_mamba.init_mamba(jax.random.PRNGKey(0), jc, jnp.float32)
    t_vals = mamba.init_mamba(torch.Generator().manual_seed(0), tc,
                              torch.float32)
    for name in ("conv_b", "dt_bias", "A_log", "D"):
        np.testing.assert_allclose(t_vals[name].numpy(),
                                   np.asarray(j_vals[name]), rtol=1e-6)


def test_init_params_tree_matches_reference():
    jc, tc = _configs()
    j_shapes = jax.eval_shape(lambda k: j_tfm.init_params(k, jc),
                              jax.random.PRNGKey(0))
    params = tfm.init_params(torch.Generator().manual_seed(0), tc)
    assert [tuple(a.shape) for a in tree_leaves(params)] == \
        [a.shape for a in jax.tree_util.tree_leaves(j_shapes)]
    loaded = params_from_numpy(_jax_params(jc), "cpu")
    assert [tuple(a.shape) for a in tree_leaves(loaded)] == \
        [tuple(a.shape) for a in tree_leaves(params)]


@pytest.mark.parametrize("kernels", [False, True])
def test_mamba_forward_matches_reference(kernels):
    """The block alone, from a non-zero carried state: output and the new
    state (scan state and conv tail)."""
    jc, tc = _configs()
    lp = _jax_params(jc)["stages"][0]["l0"]["core"]
    core = {k: v[0] for k, v in lp.items()}
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 45, 64)).astype(np.float32)
    d_in, N = 128, 8
    state = {"h": rng.normal(0, 0.1, (2, d_in, N)).astype(np.float32),
             "conv": rng.normal(size=(2, 3, d_in)).astype(np.float32)}
    j_rt = (JRuntime(use_pallas=True, kernel_policy="interpret") if kernels
            else None)
    j_out, j_state = j_mamba.mamba_forward(
        jax.tree_util.tree_map(jnp.asarray, core), jnp.asarray(x), cfg=jc,
        state=jax.tree_util.tree_map(jnp.asarray, state), runtime=j_rt)
    with torch.no_grad():
        out, new_state = mamba.mamba_forward(
            params_from_numpy(core, "cpu"), torch.from_numpy(x), cfg=tc,
            state=params_from_numpy(state, "cpu"),
            runtime=Runtime(use_kernels=kernels))
    np.testing.assert_allclose(out.numpy(), np.asarray(j_out), rtol=0,
                               atol=1e-5)
    for name in ("h", "conv"):
        np.testing.assert_allclose(new_state[name].numpy(),
                                   np.asarray(j_state[name]), rtol=0,
                                   atol=1e-5)


@pytest.mark.parametrize("kernels", [False, True])
def test_hybrid_forward_loss_signature_match_reference(kernels):
    jc, tc = _configs()
    np_params = _jax_params(jc)
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, jc.vocab_size, (2, 40)).astype(np.int32)
    labels = rng.integers(0, jc.vocab_size, (2, 40)).astype(np.int32)
    j_params = jax.tree_util.tree_map(jnp.asarray, np_params)
    j_rt = JRuntime(use_pallas=kernels, want_signature=True,
                    kernel_policy="interpret" if kernels else "reference")
    j_logits, j_aux, _ = j_tfm.forward(j_params,
                                       {"tokens": jnp.asarray(tokens)}, jc,
                                       j_rt)
    j_loss, _ = j_tfm.loss_fn(j_params, {"tokens": jnp.asarray(tokens),
                                         "labels": jnp.asarray(labels)}, jc)
    params = params_from_numpy(np_params, "cpu")
    with torch.no_grad():
        logits, aux = tfm.forward(params, {"tokens": torch.from_numpy(tokens)},
                                  tc, Runtime(use_kernels=kernels,
                                              want_signature=True))
        loss, _ = tfm.loss_fn(params, {"tokens": torch.from_numpy(tokens),
                                       "labels": torch.from_numpy(labels)},
                              tc)
    np.testing.assert_allclose(logits.numpy(), np.asarray(j_logits),
                               rtol=0, atol=2e-5)
    assert abs(float(loss) - float(j_loss)) <= 1e-5
    sig, j_sig = aux["signature"].numpy(), np.asarray(j_aux["signature"])
    assert sig.shape == (64,)
    assert np.array_equal(sig, j_sig), np.flatnonzero(sig != j_sig)


def test_hybrid_loss_gradient_matches_reference():
    """Through the model's chunked scan (two chunks of 32 over 40
    positions, each under ``torch.utils.checkpoint``) and the dense
    attention, as local training runs them."""
    jc, tc = _configs()
    np_params = _jax_params(jc)
    rng = np.random.default_rng(2)
    tokens = rng.integers(0, jc.vocab_size, (2, 40)).astype(np.int32)
    labels = rng.integers(0, jc.vocab_size, (2, 40)).astype(np.int32)
    j_grads = jax.grad(lambda p: j_tfm.loss_fn(
        p, {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels)},
        jc)[0])(jax.tree_util.tree_map(jnp.asarray, np_params))
    params = tree_map(lambda p: p.requires_grad_(True),
                      params_from_numpy(np_params, "cpu"))
    loss, _ = tfm.loss_fn(params, {"tokens": torch.from_numpy(tokens),
                                   "labels": torch.from_numpy(labels)}, tc)
    loss.backward()
    leaves = tree_leaves(params)
    j_leaves = jax.tree_util.tree_leaves(j_grads)
    assert len(leaves) == len(j_leaves)
    for p, g in zip(leaves, j_leaves):
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(g), rtol=0,
                                   atol=1e-6)


def test_model_scan_checkpoints_each_chunk_under_autograd(monkeypatch):
    """Under autograd the model's scan runs each chunk through
    ``torch.utils.checkpoint``; without grad it calls no checkpoint."""
    calls = []
    inner = mamba.checkpoint

    def counted(*args, **kwargs):
        calls.append(kwargs.get("use_reentrant"))
        return inner(*args, **kwargs)

    monkeypatch.setattr(mamba, "checkpoint", counted)
    rng = np.random.default_rng(0)
    x, dt = (torch.from_numpy(rng.random((1, 70, 4), dtype=np.float32))
             for _ in range(2))
    A = -torch.ones((4, 2))
    Bc, Cc = (torch.ones((1, 70, 2)) for _ in range(2))
    h0 = torch.zeros((1, 4, 2))
    with torch.no_grad():
        mamba.selective_scan_ref(x, dt, A, Bc, Cc, h0, chunk=32)
    assert calls == []
    y, h = mamba.selective_scan_ref(x.requires_grad_(True), dt, A, Bc, Cc,
                                    h0, chunk=32)
    assert calls == [False] * 3
    (y.sum() + h.sum()).backward()
    assert x.grad is not None and bool(torch.isfinite(x.grad).all())


def _moe_configs(vocab=None):
    """The reduced Jamba in both packages at d_model 64: its first two
    layers, ``(mamba, dense)`` and ``(mamba, moe)`` (4 experts, top-2)."""
    jc = j_reduced(j_get_config(ARCH), d_model=64)
    tc = reduced(get_config(ARCH), d_model=64)
    if vocab is not None:
        jc = dataclasses.replace(jc, vocab_size=vocab)
        tc = dataclasses.replace(tc, vocab_size=vocab)
    return jc, tc


def test_full_width_moe_cut_size():
    """The card's MoE cut at Jamba's published widths, layers 4 and 5 of
    its period, ``(attn, dense)`` and ``(mamba, moe)``: the dense cut less
    one dense FFN, plus 16 experts and a router, 3,678,941,184 in the
    reference's tree."""
    def cut(cfg, ls, st):
        return dataclasses.replace(cfg, n_layers=2, stages=(st(
            (ls(kind="attn", ffn="dense"), ls(kind="mamba", ffn="moe")),
            1),))
    jc = cut(j_get_config(ARCH), JLayerSpec, JStage)
    tc = cut(get_config(ARCH), LayerSpec, Stage)
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    shapes = jax.eval_shape(lambda k: j_tfm.init_params(k, jc),
                            jax.random.PRNGKey(0))
    d, f, E = 4096, 14336, 16
    want = FULL_CUT_PARAMS - 3 * d * f + E * 3 * d * f + d * E
    assert want == 3_678_941_184
    assert sum(int(np.prod(a.shape))
               for a in jax.tree_util.tree_leaves(shapes)) == want


@pytest.mark.parametrize("kernels", [False, True])
def test_moe_layers_match_reference(kernels):
    """The reduced Jamba's Mamba layer with an MoE feed-forward layer:
    logits and signature in the evaluation forward (``mode="prefill"``,
    the scan kernel's plain version with ``kernels``), and the training
    loss with its ``moe_aux``."""
    jc, tc = _moe_configs()
    np_params = _jax_params(jc)
    rng = np.random.default_rng(6)
    tokens = rng.integers(0, jc.vocab_size, (2, 40)).astype(np.int32)
    labels = rng.integers(0, jc.vocab_size, (2, 40)).astype(np.int32)
    j_params = jax.tree_util.tree_map(jnp.asarray, np_params)
    j_rt = JRuntime(use_pallas=kernels, want_signature=True,
                    kernel_policy="interpret" if kernels else "reference")
    j_logits, j_aux, _ = j_tfm.forward(j_params,
                                       {"tokens": jnp.asarray(tokens)}, jc,
                                       j_rt, mode="prefill")
    j_loss, j_loss_aux = j_tfm.loss_fn(
        j_params, {"tokens": jnp.asarray(tokens),
                   "labels": jnp.asarray(labels)}, jc)
    params = params_from_numpy(np_params, "cpu")
    with torch.no_grad():
        logits, aux = tfm.forward(
            params, {"tokens": torch.from_numpy(tokens)}, tc,
            Runtime(use_kernels=kernels, want_signature=True),
            mode="prefill")
        loss, loss_aux = tfm.loss_fn(
            params, {"tokens": torch.from_numpy(tokens),
                     "labels": torch.from_numpy(labels)}, tc)
    np.testing.assert_allclose(logits.numpy(), np.asarray(j_logits),
                               rtol=0, atol=2e-5)
    assert abs(float(loss) - float(j_loss)) <= 1e-5
    for a, b in ((aux, j_aux), (loss_aux, j_loss_aux)):
        assert float(a["moe_aux"]) == pytest.approx(float(b["moe_aux"]),
                                                    rel=1e-5)
    sig, j_sig = aux["signature"].numpy(), np.asarray(j_aux["signature"])
    assert np.array_equal(sig, j_sig), np.flatnonzero(sig != j_sig)


def test_moe_loss_gradient_matches_reference():
    """Through the MoE layer's router, experts and aux losses and the
    Mamba layer's chunked scan, as local training runs them."""
    jc, tc = _moe_configs()
    np_params = _jax_params(jc)
    rng = np.random.default_rng(7)
    tokens = rng.integers(0, jc.vocab_size, (2, 40)).astype(np.int32)
    labels = rng.integers(0, jc.vocab_size, (2, 40)).astype(np.int32)
    j_grads = jax.grad(lambda p: j_tfm.loss_fn(
        p, {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels)},
        jc)[0])(jax.tree_util.tree_map(jnp.asarray, np_params))
    params = tree_map(lambda p: p.requires_grad_(True),
                      params_from_numpy(np_params, "cpu"))
    loss, _ = tfm.loss_fn(params, {"tokens": torch.from_numpy(tokens),
                                   "labels": torch.from_numpy(labels)}, tc)
    loss.backward()
    leaves = tree_leaves(params)
    j_leaves = jax.tree_util.tree_leaves(j_grads)
    assert len(leaves) == len(j_leaves)
    for p, g in zip(leaves, j_leaves):
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(g), rtol=0,
                                   atol=1e-6)


KW = dict(lr=5e-3, local_steps=2, batch_size=8, seq_len=64)


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


def test_hybrid_coordinator_runs_agree():
    """Three clients, two rounds, over the reduced hybrid at a 128-token
    vocabulary: the port's plain versions against the reference's
    interpret-mode kernels in the eval and signature forwards, and the
    model's chunked scans in training on both sides."""
    _coordinator_runs_agree(*_configs(vocab=128))


def test_moe_coordinator_runs_agree():
    """The same run over the reduced Jamba's ``(mamba, dense)`` and
    ``(mamba, moe)`` layers: training routes with the training capacity,
    the eval and signature forwards with the generous one."""
    _coordinator_runs_agree(*_moe_configs(vocab=128))


def _coordinator_runs_agree(jc, tc):
    jb = JBackend(jc, kernel_policy="interpret", **KW)
    tb = LMBackend(tc, device="cpu", **KW)
    streams = [make_lm_dataset(vocab=128, n_tokens=6000, order=2.0, seed=c)
               for c in range(3)]
    data = [{"train": s, "val": s, "test": s} for s in streams]
    test = make_lm_dataset(vocab=128, n_tokens=6000, order=2.0, seed=10_000)
    kw = dict(n_clients=3, max_rounds=2, local_epochs=2, seed=0)
    ref = JCoord(jb, data, test, JConfig(kernel_policy="interpret", **kw))
    got = DagAflCoordinator(tb, data, test, DagAflConfig(**kw))
    r_ref = ref.run(jax.random.PRNGKey(0))
    r_got = got.run(params_from_numpy(_jax_params(jc), "cpu"))
    assert r_got.rounds == r_ref.rounds == 6
    assert r_got.extra["chain_len"] == 7
    assert r_got.extra["verify_failures"] == 0
    assert verify_full_dag(got.ledger) == (True, "ok")
    assert _tip_decisions(got) == _tip_decisions(ref)
    assert r_got.final_accuracy == r_ref.final_accuracy

"""The port's xLSTM blocks and xlstm-125m against the JAX reference, from
the same weights and tokens.

``reduced()`` keeps only the first two blocks of xlstm-125m's pattern, two
mLSTM blocks; so the tests replace the stages in both packages with one
period of ``(mlstm, slstm)``, both without a feed-forward sublayer, at
d_model 64, 4 heads, chunk 32.  JAX weights are carried over with
``params_from_numpy``.  Both sides run in float32; the reference's model
runs its own chunkwise mLSTM and sLSTM scan (it never reaches its Pallas
kernels), the port its plain kernel versions on the CPU when
``use_kernels`` is set and its own forms otherwise.  Tolerances and their
reasons:

* a block's output and state: 2e-5 absolute at a scale of about 1 (the
  sLSTM normaliser ``n`` grows to several units: 1e-4), float32 ``exp``,
  ``log sigmoid`` and matrix products differing in the last bits;
* logits: atol 2e-5, loss: 1e-5, as for the other decoders;
* loss gradients: atol 1e-6 (measured: at most 3.5e-7, on gradients of up
  to 0.31), the same noise carried through the backward;
* signatures: bit-equal (exact counts; no activation of these inputs lies
  within rounding of tau);
* the coordinator run: the same tip decisions, the same accuracy and
  signature on every transaction, and the same final accuracy.
"""
import dataclasses
from types import SimpleNamespace

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
from repro.models import xlstm as j_xlstm  # noqa: E402
from repro.runtime import Runtime as JRuntime  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.configs.base import LayerSpec, Stage  # noqa: E402
from repro_torch.core.aggregate import tree_leaves, tree_map  # noqa: E402
from repro_torch.core.coordinator import DagAflConfig, DagAflCoordinator  # noqa: E402
from repro_torch.core.verify import verify_full_dag  # noqa: E402
from repro_torch.fl.backend import LMBackend  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.models import xlstm  # noqa: E402
from repro_torch.runtime import Runtime  # noqa: E402
from repro_torch.weights import params_from_numpy  # noqa: E402

ARCH = "xlstm-125m"
# the reference's tree at full width and depth (jax.eval_shape)
FULL_PARAMS = 134_421_576
PARAM_COUNT = 126_517_248       # ArchConfig.param_count(), the miscount


def _staged(cfg, layer_spec, stage):
    return dataclasses.replace(cfg, n_layers=2, stages=(stage(
        (layer_spec(kind="mlstm", ffn="none"),
         layer_spec(kind="slstm", ffn="none")), 1),))


def _configs(vocab=None):
    jc = _staged(j_reduced(j_get_config(ARCH), d_model=64), JLayerSpec,
                 JStage)
    tc = _staged(reduced(get_config(ARCH), d_model=64), LayerSpec, Stage)
    if vocab is not None:
        jc = dataclasses.replace(jc, vocab_size=vocab)
        tc = dataclasses.replace(tc, vocab_size=vocab)
    return jc, tc


def _jax_params(jc, seed=0):
    return jax.tree_util.tree_map(
        np.array, j_tfm.init_params(jax.random.PRNGKey(seed), jc))


def _jnp(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


@pytest.mark.parametrize("which", ["full", "reduced", "staged"])
def test_configs_match_reference(which):
    """The full config (served by ``get_config``), ``reduced()``'s (two
    mLSTM blocks) and the tests' ``(mlstm, slstm)`` period."""
    if which == "full":
        jc, tc = j_get_config(ARCH), get_config(ARCH)
        assert [s.kind for s in tc.layer_specs()] == \
            ["mlstm"] * 3 + ["slstm"] + ["mlstm"] * 3 + ["slstm"] \
            + ["mlstm"] * 3 + ["slstm"]
        assert (tc.d_model, tc.n_heads, tc.vocab_size, tc.d_ff,
                tc.norm, tc.tie_embeddings) == (768, 4, 50304, 0,
                                                "layernorm", True)
    elif which == "reduced":
        jc, tc = j_reduced(j_get_config(ARCH)), reduced(get_config(ARCH))
        assert [s.kind for s in tc.layer_specs()] == ["mlstm", "mlstm"]
    else:
        jc, tc = _configs()
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    assert tc.param_count() == jc.param_count()


def test_full_size_counted_leaf_by_leaf():
    """xlstm-125m at full width and depth: the reference's tree holds
    134,421,576 parameters.  ``param_count()`` (a copy of the reference's)
    gives 126,517,248: its mLSTM branch leaves out ``conv_w``, ``conv_b``,
    ``w_if``, ``b_if`` and ``head_norm``, its sLSTM branch counts
    ``r_gates`` as d² where the tree holds d × 4d and miscounts the up and
    down projections, and no branch counts the norms."""
    jc, tc = j_get_config(ARCH), get_config(ARCH)
    shapes = jax.eval_shape(lambda k: j_tfm.init_params(k, jc),
                            jax.random.PRNGKey(0))
    assert sum(int(np.prod(a.shape))
               for a in jax.tree_util.tree_leaves(shapes)) == FULL_PARAMS
    assert tc.param_count() == jc.param_count() == PARAM_COUNT
    d, d_in, H, s_conv = 768, 1536, 4, 4
    d_up = int(4 * d / 3) // 2 * 2
    mlstm_leaves = (d * 2 * d_in + s_conv * d_in + d_in + 2 * d_in * d_in // 2
                    + d_in * d_in + d_in * 2 * H + 2 * H + d_in + d_in * d)
    slstm_leaves = (s_conv * d + d + 2 * d * 4 * d + 4 * d + d * 2 * d_up
                    + d_up * d + d)
    norms = 2 * d * (12 + 1)
    assert 50304 * d + 9 * mlstm_leaves + 3 * slstm_leaves + norms \
        == FULL_PARAMS


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_init_block_tree_matches_reference(kind, dtype):
    """Keys, shapes and dtypes (the gate biases stay float32), and the
    values that are not drawn."""
    jc, tc = _configs()
    j_init = getattr(j_xlstm, f"init_{kind}")
    init = getattr(xlstm, f"init_{kind}")
    want = jax.eval_shape(lambda k: j_init(k, jc, jnp.dtype(dtype)),
                          jax.random.PRNGKey(0))
    got = init(torch.Generator().manual_seed(0), tc, getattr(torch, dtype))
    assert sorted(got) == sorted(want)
    for (name, a), leaf in zip(jax.tree_util.tree_leaves_with_path(want),
                               tree_leaves(got)):
        assert tuple(leaf.shape) == a.shape, name
        assert str(leaf.dtype).split(".")[-1] == str(a.dtype), name
    j_vals = j_init(jax.random.PRNGKey(0), jc, jnp.float32)
    t_vals = init(torch.Generator().manual_seed(0), tc, torch.float32)
    fixed = ("conv_b", "b_if") if kind == "mlstm" else ("conv_b", "b_gates")
    for name in fixed:
        assert np.array_equal(t_vals[name].numpy(), np.asarray(j_vals[name]))


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
    layer = params["stages"][0]
    assert "ffn" not in layer["l0"] and "ffn" not in layer["l1"]
    assert sorted(layer["l0"]["norm1"]) == ["bias", "scale"]


def _block(kind, seed=0):
    """Layer ``kind``'s core weights from the JAX tree, and an input."""
    jc, tc = _configs()
    j = 0 if kind == "mlstm" else 1
    core = jax.tree_util.tree_map(
        lambda a: a[0], _jax_params(jc)["stages"][0][f"l{j}"]["core"])
    x = np.random.default_rng(seed).normal(size=(2, 45, 64)).astype(
        np.float32)
    return jc, tc, core, x


def _compare_state(new_state, j_state, tol):
    assert sorted(new_state) == sorted(j_state)
    for name in new_state:
        np.testing.assert_allclose(new_state[name].numpy(),
                                   np.asarray(j_state[name]), rtol=tol,
                                   atol=tol, err_msg=name)


@pytest.mark.parametrize("kernels", [False, True])
def test_mlstm_forward_matches_reference(kernels):
    """The block alone from a fresh state (where the kernel path applies),
    over a ragged second chunk: output and the new state (C, n, m and the
    conv tail)."""
    jc, tc, core, x = _block("mlstm")
    j_out, j_state = j_xlstm.mlstm_forward(_jnp(core), jnp.asarray(x),
                                           cfg=jc)
    with torch.no_grad():
        out, new_state = xlstm.mlstm_forward(
            params_from_numpy(core, "cpu"), torch.from_numpy(x), cfg=tc,
            runtime=Runtime(use_kernels=kernels))
    np.testing.assert_allclose(out.numpy(), np.asarray(j_out), rtol=0,
                               atol=2e-5)
    if kernels:
        # the kernel masks its padded steps (i = -1e30) where the model pads
        # with i = 0 and f = 30, which can raise the stabiliser m: both
        # hold the same memory C exp(m), n exp(m), so compare C and n
        # rescaled to the reference's m
        rescale = np.exp(new_state.pop("m").numpy() - np.asarray(
            j_state.pop("m")))
        for name, r in (("C", rescale[..., None, None]),
                        ("n", rescale[..., None])):
            np.testing.assert_allclose(new_state.pop(name).numpy() * r,
                                       np.asarray(j_state.pop(name)),
                                       rtol=2e-5, atol=2e-5, err_msg=name)
    _compare_state(new_state, j_state, 2e-5)


def test_mlstm_forward_from_carried_state_takes_the_model_form(monkeypatch):
    """A carried state never reaches the kernel entry (it starts from a
    fresh state): the model's form runs, as in the reference."""
    jc, tc, core, x = _block("mlstm", seed=1)
    rng = np.random.default_rng(2)
    d_in, H = 128, 4
    state = {"C": rng.normal(0, 0.3, (2, H, 16, 32)).astype(np.float32),
             "n": rng.normal(0, 0.3, (2, H, 16)).astype(np.float32),
             "m": rng.normal(size=(2, H)).astype(np.float32),
             "conv": rng.normal(size=(2, 3, d_in)).astype(np.float32)}
    monkeypatch.setattr(xlstm.ops, "mlstm_chunkwise", None)
    j_out, j_state = j_xlstm.mlstm_forward(_jnp(core), jnp.asarray(x), cfg=jc,
                                           state=_jnp(state))
    with torch.no_grad():
        out, new_state = xlstm.mlstm_forward(
            params_from_numpy(core, "cpu"), torch.from_numpy(x), cfg=tc,
            state=params_from_numpy(state, "cpu"),
            runtime=Runtime(use_kernels=True))
    np.testing.assert_allclose(out.numpy(), np.asarray(j_out), rtol=0,
                               atol=2e-5)
    _compare_state(new_state, j_state, 1e-4)


@pytest.mark.parametrize("kernels", [False, True])
def test_slstm_forward_matches_reference(kernels):
    """From a carried state (the kernel takes any initial state): output
    and the new state (c, n, h, m and the conv tail)."""
    jc, tc, core, x = _block("slstm", seed=3)
    rng = np.random.default_rng(4)
    state = {"c": rng.normal(size=(2, 64)).astype(np.float32),
             "n": (1.0 + rng.random((2, 64))).astype(np.float32),
             "h": rng.normal(0, 0.5, (2, 64)).astype(np.float32),
             "m": rng.normal(size=(2, 64)).astype(np.float32),
             "conv": rng.normal(size=(2, 3, 64)).astype(np.float32)}
    j_out, j_state = j_xlstm.slstm_forward(_jnp(core), jnp.asarray(x), cfg=jc,
                                           state=_jnp(state))
    with torch.no_grad():
        out, new_state = xlstm.slstm_forward(
            params_from_numpy(core, "cpu"), torch.from_numpy(x), cfg=tc,
            state=params_from_numpy(state, "cpu"),
            runtime=Runtime(use_kernels=kernels))
    np.testing.assert_allclose(out.numpy(), np.asarray(j_out), rtol=0,
                               atol=2e-5)
    _compare_state(new_state, j_state, 1e-4)


@pytest.mark.parametrize("kernels", [False, True])
def test_forward_loss_signature_match_reference(kernels):
    jc, tc = _configs()
    np_params = _jax_params(jc)
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, jc.vocab_size, (2, 70)).astype(np.int32)
    labels = rng.integers(0, jc.vocab_size, (2, 70)).astype(np.int32)
    j_params = _jnp(np_params)
    j_logits, j_aux, _ = j_tfm.forward(
        j_params, {"tokens": jnp.asarray(tokens)}, jc,
        JRuntime(use_pallas=kernels, want_signature=True,
                 kernel_policy="interpret" if kernels else "reference"))
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


def test_loss_gradient_matches_reference():
    """Through the model's chunkwise mLSTM (three chunks of 32 over 70
    positions, each under ``torch.utils.checkpoint``) and the sLSTM scan,
    as local training runs them."""
    jc, tc = _configs()
    np_params = _jax_params(jc)
    rng = np.random.default_rng(2)
    tokens = rng.integers(0, jc.vocab_size, (2, 70)).astype(np.int32)
    labels = rng.integers(0, jc.vocab_size, (2, 70)).astype(np.int32)
    j_grads = jax.grad(lambda p: j_tfm.loss_fn(
        p, {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels)},
        jc)[0])(_jnp(np_params))
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


def test_model_mlstm_checkpoints_each_chunk_under_autograd(monkeypatch):
    """Under autograd the model's chunkwise mLSTM runs each chunk through
    ``torch.utils.checkpoint``; without grad it calls no checkpoint."""
    calls = []
    inner = xlstm.checkpoint

    def counted(*args, **kwargs):
        calls.append(kwargs.get("use_reentrant"))
        return inner(*args, **kwargs)

    monkeypatch.setattr(xlstm, "checkpoint", counted)
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.normal(size=(1, 70, 2, 4)).astype(
        np.float32)) for _ in range(3))
    i, f = (torch.from_numpy(rng.normal(size=(1, 70, 2)).astype(np.float32))
            for _ in range(2))
    state = {"C": torch.zeros((1, 2, 4, 4)), "n": torch.zeros((1, 2, 4)),
             "m": torch.full((1, 2), -1e30)}
    with torch.no_grad():
        xlstm.mlstm_chunkwise(q, k, v, i, f, state, chunk=32)
    assert calls == []
    h, st = xlstm.mlstm_chunkwise(q.requires_grad_(True), k, v, i, f, state,
                                  chunk=32)
    assert calls == [False] * 3
    (h.sum() + st["C"].sum()).backward()
    assert q.grad is not None and bool(torch.isfinite(q.grad).all())


def test_unported_paths_raise():
    """The sharded sLSTM scan is ported: a runtime with a mesh but no
    batch axes falls back to the unsharded scan, as the reference's
    ``_slstm_scan_maybe_sharded`` does, and gives its result."""
    jc, tc, core, x = _block("slstm")
    params = params_from_numpy(core, "cpu")
    xt = torch.from_numpy(x[:1, :4])
    got, got_state = xlstm.slstm_forward(
        params, xt, cfg=tc, runtime=SimpleNamespace(mesh=object(),
                                                    use_kernels=False))
    want, want_state = xlstm.slstm_forward(params, xt, cfg=tc)
    assert torch.equal(got, want)
    assert all(torch.equal(got_state[k], want_state[k]) for k in want_state)
    j_out, _ = j_xlstm.slstm_forward(
        _jnp(core), jnp.asarray(x[:1, :4]), cfg=jc,
        runtime=SimpleNamespace(mesh=object(), batch_axes=None))
    np.testing.assert_allclose(got.numpy(), np.asarray(j_out), rtol=0,
                               atol=1e-5)


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_decode_steps_run(kind):
    """The decode steps replaced their raises: one step from a fresh state
    keeps the state's shapes (held against the reference in
    ``test_torch_decode.py``)."""
    jc, tc, core, x = _block(kind)
    params = params_from_numpy(core, "cpu")
    init = {"mlstm": xlstm.init_mlstm_state,
            "slstm": xlstm.init_slstm_state}[kind](tc, 1)
    decode = {"mlstm": xlstm.mlstm_decode,
              "slstm": xlstm.slstm_decode}[kind]
    out, state = decode(params, torch.ones((1, 1, 64)), init, cfg=tc)
    assert out.shape == (1, 1, 64) and bool(torch.isfinite(out).all())
    assert {k: v.shape for k, v in state.items()} == \
        {k: v.shape for k, v in init.items()}


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


def test_xlstm_coordinator_runs_agree():
    """Three clients, two rounds, over the reduced ``(mlstm, slstm)`` model
    at a 128-token vocabulary: the port's plain kernel versions in the eval
    and signature forwards against the reference's model forms (and its
    interpret-mode signature kernel); the model's own forms in training on
    both sides."""
    jc, tc = _configs(vocab=128)
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

"""The port's transformer path against the JAX reference, from the same
weights and tokens: the dense decoders, the MoE decoders (llama4's
dense/MoE interleave with a shared expert, Jamba's Mamba layers with MoE),
and whisper's encoder-decoder (its frame embeddings from a seed; the rest
of its cases are ``test_torch_whisper.py``'s).

JAX weights are carried over with ``params_from_numpy`` (torch cannot
reproduce JAX's PRNG bits).  The reduced configs run in float32 on both
sides.  Tolerances and their reasons:

* logits: atol 2e-5 at a scale of about 2 -- the two frameworks' float32
  matrix products and transcendental functions differ in the last bits;
* loss: 1e-5 absolute, for the same reason; ``moe_aux`` (the MoE layers'
  router losses, llama4 and Jamba): 1e-5 relative -- the router's float32
  products, and its sums fused otherwise by XLA;
* signatures: bit-equal where no activation lies within rounding of tau
  (the case for these inputs), counted flips otherwise;
* the bucketed ``ops.signature`` on the same activations: bit-equal, by
  construction (exact counts, exact bucket sums, one float32 multiply).
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
from repro.kernels import ops as j_ops  # noqa: E402
from repro.models import transformer as j_tfm  # noqa: E402
from repro.models.layers import activation_signature as j_act_sig  # noqa: E402
from repro.runtime import Runtime as JRuntime  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.configs.base import LayerSpec, Stage  # noqa: E402
from repro_torch.core.aggregate import tree_leaves  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.models.layers import activation_signature  # noqa: E402
from repro_torch.runtime import Runtime  # noqa: E402
from repro_torch.weights import params_from_numpy  # noqa: E402

ARCHS = ["internlm2-1.8b", "qwen2-7b", "gemma2-2b",
         "llama4-maverick-400b-a17b", "gemma3-27b", "qwen2-vl-72b",
         "deepseek-v2-236b", "whisper-medium"]


def _configs(arch, window=None):
    """The reduced config in both packages; ``window`` swaps gemma2's
    local:global pattern for one whose local window the sequence exceeds."""
    jc, tc = j_reduced(j_get_config(arch)), reduced(get_config(arch))
    if window is not None:
        jc = dataclasses.replace(jc, stages=(JStage(
            (JLayerSpec(window=window), JLayerSpec()), 1),))
        tc = dataclasses.replace(tc, stages=(Stage(
            (LayerSpec(window=window), LayerSpec()), 1),))
    return jc, tc


def _weights(jc, seed=0):
    params = jax.tree_util.tree_map(
        np.array, j_tfm.init_params(jax.random.PRNGKey(seed), jc))
    rng = np.random.default_rng(seed)
    for stage in params["stages"]:        # non-zero QKV biases (qwen2)
        for layer in stage.values():
            for name in ("bq", "bk", "bv"):
                if name in layer["core"]:
                    layer["core"][name] = rng.normal(
                        0, 0.1, layer["core"][name].shape).astype(np.float32)
    return params


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_match_reference(arch):
    assert dataclasses.asdict(get_config(arch)) == \
        dataclasses.asdict(j_get_config(arch))
    jc, tc = _configs(arch)
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    assert tc.param_count() == jc.param_count()


@pytest.mark.parametrize("d_model", [None, 64])
def test_jamba_config_matches_reference(d_model):
    """jamba-v0.1-52b: the config equals the reference's, full and
    reduced; the reduced config's two layers, ``(mamba, dense)`` and
    ``(mamba, moe)``, give the reference's logits, loss and ``moe_aux`` in
    both modes (training's capacity and the prefill's generous one)."""
    jc, tc = j_get_config("jamba-v0.1-52b"), get_config("jamba-v0.1-52b")
    if d_model is not None:
        jc, tc = j_reduced(jc, d_model=d_model), reduced(tc, d_model=d_model)
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    if d_model is None:
        return
    assert [s.ffn for s in tc.layer_specs()] == ["dense", "moe"]
    np_params = _weights(jc)
    rng = np.random.default_rng(4)
    tokens = rng.integers(0, jc.vocab_size, (2, 40)).astype(np.int32)
    labels = rng.integers(0, jc.vocab_size, (2, 40)).astype(np.int32)
    j_params = jax.tree_util.tree_map(jnp.asarray, np_params)
    params = params_from_numpy(np_params, "cpu")
    batch = {"tokens": torch.from_numpy(tokens),
             "labels": torch.from_numpy(labels)}
    j_batch = {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels)}
    for mode in ("train", "prefill"):
        j_logits, j_aux, _ = j_tfm.forward(j_params, j_batch, jc, mode=mode)
        with torch.no_grad():
            logits, aux = tfm.forward(params, batch, tc, mode=mode)
        np.testing.assert_allclose(logits.numpy(), np.asarray(j_logits),
                                   rtol=0, atol=2e-5)
        assert float(aux["moe_aux"]) > 0.0
        assert float(aux["moe_aux"]) == pytest.approx(
            float(j_aux["moe_aux"]), rel=1e-5)
    j_loss, j_loss_aux = j_tfm.loss_fn(j_params, j_batch, jc)
    with torch.no_grad():
        loss, loss_aux = tfm.loss_fn(params, batch, tc)
    assert abs(float(loss) - float(j_loss)) <= 1e-5
    assert float(loss_aux["moe_aux"]) == pytest.approx(
        float(j_loss_aux["moe_aux"]), rel=1e-5)


def test_full_width_cut_config_size():
    """The full-width internlm2 cut to 4 layers that the card runs."""
    cfg = get_config("internlm2-1.8b")
    cut = dataclasses.replace(cfg, n_layers=4, stages=(Stage(
        (LayerSpec(kind="attn", ffn="dense"),), 4),))
    assert cut.param_count() + 2048 * (2 * 4 + 1) == 630_736_896


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_tree_matches_reference(arch):
    jc, tc = _configs(arch)
    j_shapes = jax.eval_shape(lambda k: j_tfm.init_params(k, jc),
                              jax.random.PRNGKey(0))
    params = tfm.init_params(torch.Generator().manual_seed(0), tc)
    j_leaves, j_tree = jax.tree_util.tree_flatten(j_shapes)
    leaves = tree_leaves(params)
    assert [tuple(a.shape) for a in leaves] == [a.shape for a in j_leaves]
    assert all(a.dtype == torch.float32 for a in leaves)
    # and the reference's tree loads into the port's functions unchanged
    loaded = params_from_numpy(_weights(jc), "cpu")
    assert [tuple(a.shape) for a in tree_leaves(loaded)] == \
        [a.shape for a in j_leaves]


def _activations(shape, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 0.1, shape).astype(np.float32)
    x[np.abs(x) < 0.02] = 0.0
    x.reshape(-1)[::11] = np.float32(0.05)   # on the float32 tau
    return x


SIG_CASES = [(12, 128, 64), (7, 100, 64), (30, 64, 64), (5, 65, 64),
             (16, 33, 8), (1, 64, 64)]


@pytest.mark.parametrize("T,d,n_sig", SIG_CASES)
@pytest.mark.parametrize("tau", [0.0, 0.05])
def test_bucketed_signature_bit_equal(T, d, n_sig, tau):
    x = _activations((T, d), seed=d)
    want = np.asarray(j_ops.signature(jnp.asarray(x), tau=tau, n_sig=n_sig,
                                      policy="interpret"))
    got = ops.signature(torch.from_numpy(x), tau=tau, n_sig=n_sig).numpy()
    assert got.dtype == np.float32 and got.shape == (n_sig,)
    assert np.array_equal(got, want), np.flatnonzero(got != want)
    if tau > 0:
        plain = activation_signature(torch.from_numpy(x), n_sig=n_sig,
                                     tau=tau).numpy()
        assert np.array_equal(plain, want)
        assert np.array_equal(
            plain, np.asarray(j_act_sig(jnp.asarray(x), n_sig, tau)))


@pytest.mark.parametrize("tau", [0.0, 0.05])
def test_bucketed_signature_bf16_bit_equal(tau):
    """bfloat16 activations, as the full-width final norm emits them, in
    the (B, S, d) shape ``forward_hidden`` hands over."""
    x = _activations((2, 24, 100), seed=5)
    want = np.asarray(j_ops.signature(jnp.asarray(x, jnp.bfloat16), tau=tau,
                                      n_sig=64, policy="interpret"))
    got = ops.signature(torch.from_numpy(x).to(torch.bfloat16), tau=tau,
                        n_sig=64).numpy()
    assert np.array_equal(got, want), np.flatnonzero(got != want)


@pytest.mark.parametrize("arch,window", [(a, None) for a in ARCHS]
                         + [("gemma2-2b", 8)])
@pytest.mark.parametrize("kernels", [False, True])
def test_forward_loss_signature_match_reference(arch, window, kernels):
    jc, tc = _configs(arch, window)
    np_params = _weights(jc)
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, jc.vocab_size, (2, 40)).astype(np.int32)
    labels = rng.integers(0, jc.vocab_size, (2, 40)).astype(np.int32)
    inputs = {"tokens": tokens}
    if jc.encoder is not None:          # whisper: the frontend's frames
        inputs["enc_embed"] = rng.normal(
            0, 1, (2, jc.encoder.n_ctx, jc.d_model)).astype(np.float32)
    j_inputs = {k: jnp.asarray(v) for k, v in inputs.items()}
    t_inputs = {k: torch.from_numpy(v) for k, v in inputs.items()}
    j_params = jax.tree_util.tree_map(jnp.asarray, np_params)
    j_rt = JRuntime(use_pallas=kernels, want_signature=True,
                    kernel_policy="interpret" if kernels else "reference")
    j_logits, j_aux, _ = j_tfm.forward(j_params, j_inputs, jc, j_rt)
    j_loss, j_loss_aux = j_tfm.loss_fn(
        j_params, dict(j_inputs, labels=jnp.asarray(labels)), jc)
    params = params_from_numpy(np_params, "cpu")
    rt = Runtime(use_kernels=kernels, want_signature=True)
    with torch.no_grad():
        logits, aux = tfm.forward(params, t_inputs, tc, rt)
        loss, loss_aux = tfm.loss_fn(
            params, dict(t_inputs, labels=torch.from_numpy(labels)), tc)
    np.testing.assert_allclose(logits.numpy(), np.asarray(j_logits),
                               rtol=0, atol=2e-5)
    assert abs(float(loss) - float(j_loss)) <= 1e-5
    if jc.moe is None:
        assert float(loss_aux["moe_aux"]) == 0.0
    else:
        assert float(loss_aux["moe_aux"]) == pytest.approx(
            float(j_loss_aux["moe_aux"]), rel=1e-5)
    sig, j_sig = aux["signature"].numpy(), np.asarray(j_aux["signature"])
    assert sig.shape == (64,)
    assert np.array_equal(sig, j_sig), np.flatnonzero(sig != j_sig)


def test_loss_masks_labels():
    jc, tc = _configs("internlm2-1.8b")
    np_params = _weights(jc)
    rng = np.random.default_rng(2)
    tokens = rng.integers(0, jc.vocab_size, (2, 16)).astype(np.int32)
    mask = (rng.random((2, 16)) < 0.6).astype(np.float32)
    batch = {"tokens": tokens, "labels": np.roll(tokens, -1, axis=1),
             "mask": mask}
    j_loss, _ = j_tfm.loss_fn(jax.tree_util.tree_map(jnp.asarray, np_params),
                              {k: jnp.asarray(v) for k, v in batch.items()},
                              jc)
    with torch.no_grad():
        loss, _ = tfm.loss_fn(params_from_numpy(np_params, "cpu"),
                              {k: torch.from_numpy(v)
                               for k, v in batch.items()}, tc)
    assert abs(float(loss) - float(j_loss)) <= 1e-5


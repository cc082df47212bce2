"""Attention past 2,048 tokens against the JAX reference: the chunked and
banded score paths, ``scaled_attention``'s dispatch through a reduced
gemma3-27b, and the sequence-chunked cross-entropy.

Inputs are drawn with numpy from a seed and handed to both packages (JAX
weights through ``params_from_numpy``); both sides run in float32, the
reference's plain paths (no Pallas kernel is reached here: the kernel's
path is the port's plain flash version, held against the reference's
plain forward).  Tolerances and their reasons:

* the score paths: 2e-5 absolute, the reference's own tolerance between
  them and the dense path (``tests/test_attention_paths.py``): float32
  sums in another order;
* their input gradients: 1e-5 absolute on gradients of order 1;
* the reduced gemma3 at S = 2,500: logits 2e-5 and loss 1e-5, as for the
  other reduced decoders (``test_torch_transformer.py``); loss gradients
  1e-6 absolute (the same float32 noise carried through the backward);
  the signature bit for bit (exact counts);
* the chunked cross-entropy: loss 1e-5, gradients 1e-6; the chunk length
  equal to the reference's.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import repro.models.attention as JA  # noqa: E402
from repro.configs import get_config as j_get_config  # noqa: E402
from repro.configs import reduced as j_reduced  # noqa: E402
from repro.configs.base import LayerSpec as JLayerSpec  # noqa: E402
from repro.configs.base import Stage as JStage  # noqa: E402
from repro.models import transformer as j_tfm  # noqa: E402
from repro.runtime import Runtime as JRuntime  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.configs.base import LayerSpec, Stage  # noqa: E402
from repro_torch.core.aggregate import tree_leaves, tree_map  # noqa: E402
from repro_torch.models import attention as A  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.runtime import Runtime  # noqa: E402
from repro_torch.weights import params_from_numpy  # noqa: E402
from test_torch_baselines import few_torch_threads  # noqa: E402,F401


def _qkv(B=2, S=300, H=4, K=2, hd=32, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((B, S, n, hd)).astype(np.float32)
                 for n in (H, K, K))


def _pos(S):
    return jnp.arange(S, dtype=jnp.int32), torch.arange(S,
                                                        dtype=torch.int32)


@pytest.mark.parametrize("cap", [0.0, 30.0])
def test_chunked_matches_reference(cap):
    q, k, v = _qkv(seed=1)
    jp, tp = _pos(300)
    want = JA._chunked_attn(*map(jnp.asarray, (q, k, v)), jp, jp, True, cap,
                            chunk=64)
    got = A._chunked_attn(*map(torch.from_numpy, (q, k, v)), tp, tp, True,
                          cap, chunk=64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=2e-5)
    dense = A._dense_attn(*map(torch.from_numpy, (q, k, v)), tp, tp, True,
                          -1, cap)
    np.testing.assert_allclose(got.numpy(), dense.numpy(), rtol=0, atol=2e-5)


@pytest.mark.parametrize("window,q_block,cap", [(48, 32, 0.0),
                                                (100, 64, 0.0),
                                                (8, 16, 0.0),
                                                (100, 64, 30.0)])
def test_banded_matches_reference(window, q_block, cap):
    q, k, v = _qkv(seed=2)
    jp, tp = _pos(300)
    want = JA._banded_attn(*map(jnp.asarray, (q, k, v)), jp, jp, window,
                           cap, q_block=q_block)
    got = A._banded_attn(*map(torch.from_numpy, (q, k, v)), tp, tp, window,
                         cap, q_block=q_block)
    assert got.shape == (2, 300, 4, 32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=2e-5)
    dense = A._dense_attn(*map(torch.from_numpy, (q, k, v)), tp, tp, True,
                          window, cap)
    np.testing.assert_allclose(got.numpy(), dense.numpy(), rtol=0, atol=2e-5)


def test_banded_pads_a_band_longer_than_the_keys():
    """Sk < window + q_block: the keys are padded at -1e9 to one band."""
    q, k, v = _qkv(S=40, seed=3)
    jp, tp = _pos(40)
    want = JA._banded_attn(*map(jnp.asarray, (q, k, v)), jp, jp, 30, 0.0,
                           q_block=16)
    got = A._banded_attn(*map(torch.from_numpy, (q, k, v)), tp, tp, 30, 0.0,
                         q_block=16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=2e-5)


@pytest.mark.parametrize("path", ["chunked", "banded"])
def test_long_path_gradients_match_reference(monkeypatch, path):
    """The input gradients of a weighted sum of the output, each block
    under ``torch.utils.checkpoint`` (one call a block under autograd,
    none without grad)."""
    q, k, v = _qkv(S=200, seed=4)
    w = np.random.default_rng(5).standard_normal((2, 200, 4, 32)).astype(
        np.float32)
    jp, tp = _pos(200)
    if path == "chunked":
        def jf(q, k, v):
            return JA._chunked_attn(q, k, v, jp, jp, True, 30.0, chunk=64)

        def tf(q, k, v):
            return A._chunked_attn(q, k, v, tp, tp, True, 30.0, chunk=64)
        blocks = 4
    else:
        def jf(q, k, v):
            return JA._banded_attn(q, k, v, jp, jp, 48, 0.0, q_block=32)

        def tf(q, k, v):
            return A._banded_attn(q, k, v, tp, tp, 48, 0.0, q_block=32)
        blocks = 7
    want = jax.grad(lambda *a: jnp.sum(jf(*a) * w), argnums=(0, 1, 2))(
        *map(jnp.asarray, (q, k, v)))
    calls = []
    inner = A.checkpoint
    monkeypatch.setattr(A, "checkpoint", lambda *a, **kw: (
        calls.append(kw.get("use_reentrant")), inner(*a, **kw))[1])
    with torch.no_grad():
        tf(*map(torch.from_numpy, (q, k, v)))
    assert calls == []
    ins = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    (tf(*ins) * torch.from_numpy(w)).sum().backward()
    assert calls == [False] * blocks
    for t, g in zip(ins, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), rtol=0,
                                   atol=1e-5)


@pytest.mark.parametrize("Sq,Sk,window,want", [
    (2049, 2049, 100, "banded"), (2049, 2049, -1, "chunked"),
    (2048, 2048, 100, "dense"), (1, 3000, 100, "dense"),
    (3000, 3000, -1, "chunked")])
def test_dispatch_order(monkeypatch, Sq, Sk, window, want):
    """The reference's order: banded for a causal window past 2,048,
    dense up to 2,048 or when the lengths differ, else chunked; the
    kernel before all of them under ``use_kernels``."""
    taken = []
    for name in ("banded", "chunked", "dense"):
        monkeypatch.setattr(A, f"_{name}_attn",
                            lambda *a, _n=name, **kw: taken.append(_n))
    monkeypatch.setattr(A.ops, "flash_attention",
                        lambda *a, **kw: taken.append("kernel"))
    q = torch.zeros((1, Sq, 2, 8))
    k = torch.zeros((1, Sk, 2, 8))
    pos = torch.zeros(Sq, dtype=torch.int32)
    A.scaled_attention(q, k, k, pos, pos, causal=True, window=window,
                       cap=0.0)
    A.scaled_attention(q, k, k, pos, pos, causal=True, window=window,
                       cap=0.0, runtime=Runtime(use_kernels=True))
    assert taken == [want, "kernel" if Sq == Sk else want]


# -- the reduced gemma3 at S = 2,500 ------------------------------------------


def _gemma3():
    """gemma3-27b reduced in both packages to d_model 64, as one period
    of a local (window 1,024) and a global layer: ``reduced()`` keeps the
    trailing (local, local) stage, which would leave the chunked path
    out."""
    jc = j_reduced(j_get_config("gemma3-27b"), d_model=64)
    tc = reduced(get_config("gemma3-27b"), d_model=64)
    jc = dataclasses.replace(jc, stages=(JStage(
        (JLayerSpec(window=1024), JLayerSpec(window=-1)), 1),))
    tc = dataclasses.replace(tc, stages=(Stage(
        (LayerSpec(window=1024), LayerSpec(window=-1)), 1),))
    return jc, tc


def _batch(jc, B=1, S=2500, seed=6):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, jc.vocab_size, (B, S)).astype(np.int32),
            "labels": rng.integers(0, jc.vocab_size, (B, S)).astype(np.int32)}


@pytest.fixture(scope="module")
def gemma3_world():
    jc, tc = _gemma3()
    np_params = jax.tree_util.tree_map(
        np.array, j_tfm.init_params(jax.random.PRNGKey(0), jc))
    batch = _batch(jc)
    j_params = jax.tree_util.tree_map(jnp.asarray, np_params)
    j_batch = {k: jnp.asarray(v) for k, v in batch.items()}
    j_logits, j_aux, _ = j_tfm.forward(
        j_params, j_batch, jc, JRuntime(want_signature=True,
                                        kernel_policy="reference"))
    (j_loss, _), j_grads = jax.value_and_grad(
        lambda p: j_tfm.loss_fn(p, j_batch, jc), has_aux=True)(j_params)
    return dict(jc=jc, tc=tc, np_params=np_params, batch=batch,
                j_logits=np.asarray(j_logits),
                j_sig=np.asarray(j_aux["signature"]), j_loss=float(j_loss),
                j_grads=jax.tree_util.tree_leaves(j_grads))


def test_gemma3_config_matches_reference():
    jc, tc = j_get_config("gemma3-27b"), get_config("gemma3-27b")
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    assert [s.window for s in tc.layer_specs()[:6]] == [1024] * 5 + [-1]
    jc, tc = _gemma3()
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)


@pytest.mark.parametrize("kernels", [False, True])
def test_gemma3_forward_past_2048_matches_reference(monkeypatch,
                                                   gemma3_world, kernels):
    """The local layer takes the banded path and the global layer the
    chunked one (each once a forward); with ``use_kernels`` both take the
    kernel's plain version on the CPU."""
    w = gemma3_world
    taken = []
    for name in ("_banded_attn", "_chunked_attn", "_dense_attn"):
        inner = getattr(A, name)
        monkeypatch.setattr(A, name, lambda *a, _f=inner, _n=name, **kw: (
            taken.append(_n), _f(*a, **kw))[1])
    params = params_from_numpy(w["np_params"], "cpu")
    with torch.no_grad():
        logits, aux = tfm.forward(
            params, {"tokens": torch.from_numpy(w["batch"]["tokens"])},
            w["tc"], Runtime(use_kernels=kernels, want_signature=True))
    assert taken == ([] if kernels else ["_banded_attn", "_chunked_attn"])
    assert logits.shape == (1, 2500, w["jc"].vocab_size)
    np.testing.assert_allclose(logits.numpy(), w["j_logits"], rtol=0,
                               atol=2e-5)
    sig = aux["signature"].numpy()
    assert np.array_equal(sig, w["j_sig"]), np.flatnonzero(sig != w["j_sig"])


def test_gemma3_loss_and_gradient_past_2048_match_reference(gemma3_world):
    """Training's path: the banded and chunked attention and the chunked
    cross-entropy (625 chunks of 4 positions at S = 2,500), all under
    autograd."""
    w = gemma3_world
    params = tree_map(lambda p: p.requires_grad_(True),
                      params_from_numpy(w["np_params"], "cpu"))
    batch = {k: torch.from_numpy(v) for k, v in w["batch"].items()}
    assert tfm._ce_chunk(w["tc"], 1, 2500) == 4
    loss, aux = tfm.loss_fn(params, batch, w["tc"])
    assert abs(loss.item() - w["j_loss"]) <= 1e-5
    assert aux["ce_loss"].item() == loss.item()
    loss.backward()
    leaves = tree_leaves(params)
    assert len(leaves) == len(w["j_grads"])
    for p, g in zip(leaves, w["j_grads"]):
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(g), rtol=0,
                                   atol=1e-6)


# -- the chunked cross-entropy -----------------------------------------------


@pytest.mark.parametrize("B,S,vocab", [(1, 4096, 262144), (2, 8192, 262144),
                                       (8, 512, 92544), (2, 2500, 512),
                                       (3, 37, 128), (1, 96, 512),
                                       (64, 4096, 262144)])
def test_ce_chunk_matches_reference(B, S, vocab):
    jc = dataclasses.replace(j_get_config("gemma3-27b"), vocab_size=vocab)
    tc = dataclasses.replace(get_config("gemma3-27b"), vocab_size=vocab)
    assert tfm._ce_chunk(tc, B, S) == j_tfm._ce_chunk(jc, B, S)


@pytest.mark.parametrize("masked", [False, True])
def test_chunked_ce_matches_value_and_grad(monkeypatch, masked):
    """Reduced internlm2 at S = 96 (3 chunks of 32): the loss and its
    gradient against ``jax.value_and_grad`` of the reference's, each chunk
    under ``torch.utils.checkpoint``."""
    jc = j_reduced(j_get_config("internlm2-1.8b"), d_model=64)
    tc = reduced(get_config("internlm2-1.8b"), d_model=64)
    np_params = jax.tree_util.tree_map(
        np.array, j_tfm.init_params(jax.random.PRNGKey(1), jc))
    batch = _batch(jc, B=2, S=96, seed=7)
    if masked:
        batch["mask"] = (np.random.default_rng(8).random((2, 96)) < 0.5
                         ).astype(np.float32)
    (j_loss, _), j_grads = jax.value_and_grad(
        lambda p: j_tfm.loss_fn(p, {k: jnp.asarray(v)
                                    for k, v in batch.items()}, jc),
        has_aux=True)(jax.tree_util.tree_map(jnp.asarray, np_params))
    calls = {}
    inner = tfm.checkpoint
    monkeypatch.setattr(tfm, "checkpoint", lambda fn, *a, **kw: (
        calls.setdefault(fn.__name__, []).append(kw.get("use_reentrant")),
        inner(fn, *a, **kw))[1])
    params = tree_map(lambda p: p.requires_grad_(True),
                      params_from_numpy(np_params, "cpu"))
    loss, _ = tfm.loss_fn(params, {k: torch.from_numpy(v)
                                   for k, v in batch.items()}, tc)
    # the CE's three chunks, beside each period's checkpoint (remat)
    assert tfm._ce_chunk(tc, 2, 96) == 32
    assert calls == {"_ce_part": [False] * 3,
                     "period": [False] * tc.stages[0].repeats}
    assert abs(loss.item() - float(j_loss)) <= 1e-5
    loss.backward()
    for p, g in zip(tree_leaves(params), jax.tree_util.tree_leaves(j_grads)):
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(g), rtol=0,
                                   atol=1e-6)

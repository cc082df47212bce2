"""The port's MLA attention (DeepSeek-V2) against the JAX reference: the
reduced deepseek-v2-236b (MLA over MoE feed-forward layers), its absorbed
decode over the latent caches, the greedy decode loop, a coordinator run,
and the flash kernels' plain versions at MLA's head dim of 192.

JAX weights are carried over with ``params_from_numpy``; both sides run in
float32.  The reduced config has no query LoRA (``q_lora_rank`` 0, as
``reduced()`` makes it in both packages); the full config's ``wq_a``,
``q_norm`` and ``wq_b`` are covered by a variant with ``q_lora_rank`` 32.
Tolerances and their reasons:

* logits 2e-5 and loss 1e-5, ``moe_aux`` 1e-5 relative, as for the other
  reduced decoders (``test_torch_transformer.py``); loss gradients 1e-6
  absolute (float32 noise through the backward); signatures bit for bit;
* prefill and decode logits and caches: 2e-5 (``test_torch_decode.py``);
  greedy tokens equal;
* the coordinator run: the same tip decisions, accuracies and signatures;
* the flash plain versions against the interpret-mode Pallas kernel: the
  reference's 2e-5 in float32 and 2e-2 in bfloat16
  (``test_torch_flash_attention.py``).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.configs import reduced as j_reduced  # noqa: E402
from repro.kernels.flash_attention import flash_attention_bhsd as j_flash  # noqa: E402
from repro.models import attention as j_attn  # noqa: E402
from repro.models import transformer as j_tfm  # noqa: E402
from repro.runtime import Runtime as JRuntime  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.core.aggregate import tree_leaves, tree_map  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.models import attention as t_attn  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.runtime import Runtime  # noqa: E402
from repro_torch.weights import params_from_numpy  # noqa: E402
from test_torch_baselines import few_torch_threads  # noqa: E402,F401
from test_torch_decode import ATOL, _close, _world  # noqa: E402
from test_torch_decode import test_decode_steps_match_reference as _steps  # noqa: E402
from test_torch_decode import test_decode_tracks_full_forward as _tracks  # noqa: E402
from test_torch_decode import test_greedy_decode_tokens_match_reference as _greedy  # noqa: E402
from test_torch_decode import test_init_cache_matches_reference as _cache0  # noqa: E402
from test_torch_decode import test_prefill_matches_reference as _prefill  # noqa: E402
from test_torch_mamba import _coordinator_runs_agree  # noqa: E402

ARCH = "deepseek-v2-236b"


def _configs(q_lora=0, d_model=256, vocab=None):
    jc = j_reduced(j_get_config(ARCH), d_model=d_model)
    tc = reduced(get_config(ARCH), d_model=d_model)
    if q_lora:
        jc = dataclasses.replace(jc, mla=dataclasses.replace(
            jc.mla, q_lora_rank=q_lora))
        tc = dataclasses.replace(tc, mla=dataclasses.replace(
            tc.mla, q_lora_rank=q_lora))
    if vocab is not None:
        jc = dataclasses.replace(jc, vocab_size=vocab)
        tc = dataclasses.replace(tc, vocab_size=vocab)
    return jc, tc


def _jax_params(jc, seed=0):
    return jax.tree_util.tree_map(
        np.array, j_tfm.init_params(jax.random.PRNGKey(seed), jc))


def test_configs_match_reference():
    jc, tc = j_get_config(ARCH), get_config(ARCH)
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    assert tc.moment_dtype == "bfloat16" and tc.mla.q_lora_rank == 1536
    jc, tc = _configs()
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    m = tc.mla
    assert (m.kv_lora_rank, m.qk_nope_dim, m.qk_rope_dim, m.v_head_dim,
            m.q_lora_rank) == (64, 64, 32, 64, 0)


@pytest.mark.parametrize("q_lora", [0, 32])
def test_init_attn_keys_and_shapes_match_reference(q_lora):
    """The MLA tree: the reference's keys in its order, shapes and
    dtypes, layer by layer, and the whole model's leaves."""
    jc, tc = _configs(q_lora)
    spec = tc.stages[0].pattern[0]
    want = jax.eval_shape(lambda k: j_attn.init_attn(
        k, jc, jc.stages[0].pattern[0], jnp.float32), jax.random.PRNGKey(0))
    got = t_attn.init_attn(torch.Generator().manual_seed(0), tc, spec,
                           torch.float32)
    keys = ["wq_a", "q_norm", "wq_b"] if q_lora else ["wq"]
    assert list(got) == keys + ["wkv_a", "kv_norm", "wkv_b", "wo"]
    assert sorted(got) == sorted(want)
    for k in want:
        assert tree_map(lambda a: tuple(a.shape), got[k]) == \
            jax.tree_util.tree_map(lambda a: a.shape, want[k])
    j_shapes = jax.eval_shape(lambda k: j_tfm.init_params(k, jc),
                              jax.random.PRNGKey(0))
    params = tfm.init_params(torch.Generator().manual_seed(0), tc)
    assert [tuple(a.shape) for a in tree_leaves(params)] == \
        [a.shape for a in jax.tree_util.tree_leaves(j_shapes)]


@pytest.mark.parametrize("q_lora", [0, 32])
@pytest.mark.parametrize("kernels", [False, True])
def test_forward_loss_signature_match_reference(q_lora, kernels):
    """Logits (training and prefill capacities), loss, ``moe_aux`` and the
    signature; with kernels the reference runs its interpret-mode Pallas
    flash attention at head dim 96 (64 nope + 32 rope) and the port the
    kernel's plain version."""
    jc, tc = _configs(q_lora)
    np_params = _jax_params(jc)
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, jc.vocab_size, (2, 40)).astype(np.int32)
    labels = rng.integers(0, jc.vocab_size, (2, 40)).astype(np.int32)
    j_params = jax.tree_util.tree_map(jnp.asarray, np_params)
    params = params_from_numpy(np_params, "cpu")
    j_rt = JRuntime(use_pallas=kernels, want_signature=True,
                    kernel_policy="interpret" if kernels else "reference")
    rt = Runtime(use_kernels=kernels, want_signature=True)
    for mode in ("train", "prefill"):
        j_logits, j_aux, _ = j_tfm.forward(
            j_params, {"tokens": jnp.asarray(tokens)}, jc, j_rt, mode=mode)
        with torch.no_grad():
            logits, aux = tfm.forward(
                params, {"tokens": torch.from_numpy(tokens)}, tc, rt,
                mode=mode)
        np.testing.assert_allclose(logits.numpy(), np.asarray(j_logits),
                                   rtol=0, atol=2e-5)
        assert float(aux["moe_aux"]) == pytest.approx(
            float(j_aux["moe_aux"]), rel=1e-5)
        sig, j_sig = aux["signature"].numpy(), np.asarray(j_aux["signature"])
        assert np.array_equal(sig, j_sig), np.flatnonzero(sig != j_sig)
    batch = {"tokens": tokens, "labels": labels}
    j_loss, _ = j_tfm.loss_fn(j_params, {k: jnp.asarray(v)
                                         for k, v in batch.items()}, jc)
    with torch.no_grad():
        loss, _ = tfm.loss_fn(params, {k: torch.from_numpy(v)
                                       for k, v in batch.items()}, tc)
    assert abs(float(loss) - float(j_loss)) <= 1e-5


@pytest.mark.parametrize("q_lora", [0, 32])
def test_loss_gradient_matches_reference(q_lora):
    jc, tc = _configs(q_lora)
    np_params = _jax_params(jc)
    rng = np.random.default_rng(2)
    batch = {"tokens": rng.integers(0, jc.vocab_size, (2, 40))
             .astype(np.int32),
             "labels": rng.integers(0, jc.vocab_size, (2, 40))
             .astype(np.int32)}
    j_grads = jax.grad(lambda p: j_tfm.loss_fn(
        p, {k: jnp.asarray(v) for k, v in batch.items()}, jc)[0])(
        jax.tree_util.tree_map(jnp.asarray, np_params))
    params = tree_map(lambda p: p.requires_grad_(True),
                      params_from_numpy(np_params, "cpu"))
    loss, _ = tfm.loss_fn(params, {k: torch.from_numpy(v)
                                   for k, v in batch.items()}, tc)
    loss.backward()
    leaves, j_leaves = tree_leaves(params), jax.tree_util.tree_leaves(j_grads)
    assert len(leaves) == len(j_leaves)
    for p, g in zip(leaves, j_leaves):
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(g), rtol=0,
                                   atol=1e-6)


# -- serving: the latent caches and the absorbed decode ---------------------


def test_init_cache_holds_the_latents():
    """``ckv`` (r) and ``krope`` (rope dim) per position: no per-head
    keys or values."""
    _cache0(ARCH)
    _, tc, *_ = _world(ARCH)
    cache = tfm.init_cache(tc, 2, 9)
    for stage in cache:
        for layer in stage.values():
            assert sorted(layer) == ["ckv", "krope"]
            assert layer["ckv"].shape[-2:] == (9, tc.mla.kv_lora_rank)
            assert layer["krope"].shape[-2:] == (9, tc.mla.qk_rope_dim)


def test_prefill_matches_reference():
    _prefill(ARCH)


def test_absorbed_decode_steps_match_reference():
    """4 greedy decode steps: each step's logits and the ``ckv`` and
    ``krope`` caches after it, within 2e-5."""
    _steps(ARCH)


def test_absorbed_decode_tracks_full_forward():
    """The absorbed form against the expanded one inside the port."""
    _tracks(ARCH)


def test_greedy_decode_tokens_match_reference():
    _greedy(ARCH)


@pytest.mark.parametrize("window", [-1, 5])
def test_mla_decode_block_matches_reference(window):
    """One absorbed decode step of the layer from a random latent cache
    with 6 of 9 slots written, with and without a window."""
    jc, tc, np_params, *_ = _world(ARCH)
    core = jax.tree_util.tree_map(lambda a: a[0],
                                  np_params["stages"][0]["l0"]["core"])
    rng = np.random.default_rng(7)
    x = rng.normal(size=(2, 1, jc.d_model)).astype(np.float32)
    cache = {k: rng.normal(size=v.shape).astype(np.float32) for k, v in
             j_attn.init_kv_cache(jc, None, 2, 9).items()}
    jout, jnew = j_attn.attn_decode(
        jax.tree_util.tree_map(jnp.asarray, core), jnp.asarray(x),
        {k: jnp.asarray(v) for k, v in cache.items()}, 6, cfg=jc,
        spec=jc.stages[0].pattern[0], window=window)
    tout, tnew = t_attn.attn_decode(
        params_from_numpy(core, "cpu"), torch.from_numpy(x),
        {k: torch.from_numpy(v.copy()) for k, v in cache.items()}, 6, cfg=tc,
        spec=tc.stages[0].pattern[0], window=window)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), rtol=0,
                               atol=ATOL)
    assert sorted(tnew) == sorted(jnew) == ["ckv", "krope"]
    _close([tnew[k].numpy() for k in sorted(tnew)],
           [np.asarray(jnew[k]) for k in sorted(jnew)])


def test_coordinator_runs_agree():
    """Three clients, two rounds, over the reduced deepseek-v2 at d_model
    64 and a 128-token vocabulary: the port's plain versions against the
    reference's interpret-mode kernels in the eval and signature
    forwards."""
    _coordinator_runs_agree(*_configs(d_model=64, vocab=128))


# -- the flash kernels' plain versions at head dim 192 ----------------------

# B, H, K, S, hd, causal, window, softcap: MLA's one KV head per query
# head, a window, a soft-cap, non-causal, S not a multiple of the block
HD192_CASES = [(1, 4, 4, 200, 192, True, -1, 0.0),
               (2, 4, 2, 130, 192, True, 48, 0.0),
               (1, 2, 2, 100, 192, False, -1, 0.0),
               (1, 2, 1, 96, 192, True, -1, 30.0)]


def _inputs(shapes, dtype, seed):
    rng = np.random.default_rng(seed)
    arrays = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    return ([jnp.asarray(a, dtype=getattr(jnp, dtype)) for a in arrays],
            [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrays])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,H,K,S,hd,causal,window,cap", HD192_CASES)
def test_flash_plain_at_hd192_matches_interpret_kernel(
        B, H, K, S, hd, causal, window, cap, dtype):
    assert hd in fa.HEAD_DIMS
    tol = {"float32": 2e-5, "bfloat16": 2e-2}[dtype]
    (jq, jk, jv), (tq, tk, tv) = _inputs(
        [(B, H, S, hd), (B, K, S, hd), (B, K, S, hd)], dtype, seed=S)
    want = np.asarray(j_flash(jq, jk, jv, causal=causal, window=window,
                              softcap=cap, block_q=64, block_k=64,
                              interpret=True), np.float32)
    plains = [fa.flash_attention_bhsd]
    if dtype == "bfloat16":
        plains.append(fa.flash_attention_tc_plain)
    for fn in plains:
        got = fn(tq, tk, tv, causal=causal, window=window, softcap=cap)
        assert got.dtype == tq.dtype and got.shape == tq.shape
        np.testing.assert_allclose(got.float().numpy(), want, rtol=tol,
                                   atol=tol)

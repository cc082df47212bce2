"""The port's serving models against the JAX reference: KV-cache prefill
and one-token decode for all four block kinds, and the greedy decode loop
of the serve launcher.

JAX weights are carried over with ``params_from_numpy``; the reduced
configs run in float32 on both sides: internlm2, qwen2 (QKV biases),
gemma2 (a local window the decode passes, and soft-caps), qwen2-vl-72b
(M-RoPE sections and QKV biases; head_dim 128, so that its 64 half-dim
frequencies hold all three sections, as in ``test_torch_mrope.py``), the
Jamba cut of one Mamba and one attention layer, an ``(mlstm, slstm)`` xLSTM period, and
the MoE configs' reduced first two layers (Jamba's ``(mamba, dense)``,
``(mamba, moe)``; llama4's ``(attn, dense)``, ``(attn, moe)`` with a shared
expert): a prefill routes with the generous capacity, a decode step one
token a row.
Tolerances and their reasons:

* logits and caches: atol 2e-5 -- the two frameworks' float32 matrix
  products and transcendental functions differ in the last bits, and the
  port's prefill takes the kernels' plain versions (the reference's runs
  its own ``jnp`` forms);
* cache shapes and dtypes, greedy tokens: equal.
"""
import dataclasses
import functools
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
from repro.launch import serve as j_serve  # noqa: E402
from repro.models import attention as j_attn  # noqa: E402
from repro.models import mamba as j_mamba  # noqa: E402
from repro.models import transformer as j_tfm  # noqa: E402
from repro.models import xlstm as j_xlstm  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.configs.base import LayerSpec, Stage  # noqa: E402
from repro_torch.core.aggregate import tree_leaves, tree_map  # noqa: E402
from repro_torch.launch import serve as t_serve  # noqa: E402
from repro_torch.models import attention as t_attn  # noqa: E402
from repro_torch.models import mamba as t_mamba  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.models import xlstm as t_xlstm  # noqa: E402
from repro_torch.runtime import Runtime, serve_runtime  # noqa: E402
from repro_torch.train import step as tstep  # noqa: E402
from repro_torch.weights import params_from_numpy  # noqa: E402

ARCHS = ["internlm2-1.8b", "qwen2-7b", "gemma2-2b", "qwen2-vl-72b", "hybrid",
         "xlstm", "jamba-v0.1-52b", "llama4-maverick-400b-a17b"]
ATOL = 2e-5
B, PROMPT, STEPS = 2, 12, 4


def _configs(arch):
    """The reduced config in both packages (float32)."""
    if arch == "hybrid":
        def cut(cfg, ls, st):
            return dataclasses.replace(cfg, n_layers=2, stages=(st(
                (ls(kind="mamba", ffn="dense"),
                 ls(kind="attn", ffn="dense")), 1),))
        return (cut(j_reduced(j_get_config("jamba-v0.1-52b"), d_model=64),
                    JLayerSpec, JStage),
                cut(reduced(get_config("jamba-v0.1-52b"), d_model=64),
                    LayerSpec, Stage))
    if arch == "xlstm":
        def cut(cfg, ls, st):
            return dataclasses.replace(cfg, n_layers=2, stages=(st(
                (ls(kind="mlstm", ffn="none"),
                 ls(kind="slstm", ffn="none")), 1),))
        return (cut(j_reduced(j_get_config("xlstm-125m"), d_model=64),
                    JLayerSpec, JStage),
                cut(reduced(get_config("xlstm-125m"), d_model=64),
                    LayerSpec, Stage))
    jc, tc = j_reduced(j_get_config(arch)), reduced(get_config(arch))
    if arch == "qwen2-vl-72b":
        jc = dataclasses.replace(j_reduced(j_get_config(arch), d_model=64),
                                 head_dim=128)
        tc = dataclasses.replace(reduced(get_config(arch), d_model=64),
                                 head_dim=128)
    if arch == "gemma2-2b":
        # a local window of 5 that the prompt and every decode step pass
        jc = dataclasses.replace(jc, stages=(JStage(
            (JLayerSpec(window=5), JLayerSpec()), 1),))
        tc = dataclasses.replace(tc, stages=(Stage(
            (LayerSpec(window=5), LayerSpec()), 1),))
    return jc, tc


def _weights(jc, seed=0):
    params = jax.tree_util.tree_map(
        np.array, j_tfm.init_params(jax.random.PRNGKey(seed), jc))
    rng = np.random.default_rng(seed)
    for stage in params["stages"]:        # non-zero QKV biases (the qwen2s)
        for layer in stage.values():
            for name in ("bq", "bk", "bv"):
                if name in layer["core"]:
                    layer["core"][name] = rng.normal(
                        0, 0.1, layer["core"][name].shape).astype(np.float32)
    return params


def _np_leaves(tree):
    return [np.asarray(a) for a in jax.tree_util.tree_leaves(tree)]


def _t_leaves(tree):
    return [a.float().numpy().copy() for a in tree_leaves(tree)]


def _close(got, want, atol=ATOL):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=0, atol=atol)


@functools.lru_cache(maxsize=None)
def _world(arch):
    """The reference's prefill and 4 greedy decode steps, as numpy, and
    the same run in the port (prefill on the kernels' plain versions)."""
    jc, tc = _configs(arch)
    np_params = _weights(jc)
    jp = jax.tree_util.tree_map(jnp.asarray, np_params)
    tp = params_from_numpy(np_params, "cpu")
    tokens = np.random.default_rng(1).integers(
        0, jc.vocab_size, (B, PROMPT)).astype(np.int32)
    ref = {"cache0": _np_leaves(j_tfm.init_cache(jc, B, PROMPT + STEPS))}
    got = {"cache0": tfm.init_cache(tc, B, PROMPT + STEPS)}
    jl, jcache, _ = j_tfm.prefill(jp, {"tokens": jnp.asarray(tokens)}, jc)
    with torch.no_grad():
        tl, tcache, _ = tfm.prefill(tp, {"tokens": torch.from_numpy(tokens)},
                                    tc, serve_runtime())
    ref["prefill"] = (np.asarray(jl), _np_leaves(jcache))
    got["prefill"] = (tl.numpy(), _t_leaves(tcache))
    jcache = j_serve.extend_caches(jcache, jc, STEPS)
    tcache = t_serve.extend_caches(tcache, tc, STEPS)
    ref["extended"] = [a.shape for a in jax.tree_util.tree_leaves(jcache)]
    got["extended"] = [tuple(a.shape) for a in tree_leaves(tcache)]
    tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)[:, None]
    ref["steps"], got["steps"] = [], []
    for s in range(STEPS):
        jlog, jcache = j_tfm.decode_step(jp, jnp.asarray(tok), jcache,
                                         jnp.int32(PROMPT + s), jc)
        with torch.no_grad():
            tlog, tcache = tfm.decode_step(tp, torch.from_numpy(tok), tcache,
                                           PROMPT + s, tc)
        ref["steps"].append((np.asarray(jlog), _np_leaves(jcache)))
        got["steps"].append((tlog.numpy(), _t_leaves(tcache)))
        tok = np.asarray(jnp.argmax(jlog, -1)).astype(np.int32)[:, None]
    return jc, tc, np_params, tokens, ref, got


@pytest.mark.parametrize("arch", ARCHS)
def test_init_cache_matches_reference(arch):
    jc, tc, _, _, ref, got = _world(arch)
    want = ref["cache0"]
    have = tree_leaves(got["cache0"])
    assert [a.shape for a in want] == [tuple(a.shape) for a in have]
    assert [str(a.dtype) for a in want] == \
        [str(a.dtype).replace("torch.", "") for a in have]
    for a, b in zip(have, want):
        assert np.array_equal(a.float().numpy(), b.astype(np.float32))


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_matches_reference(arch):
    """The last logits and every layer's cache (roped keys and values,
    the recurrent blocks' final states, stacked on the stage axis), and
    the caches extended by the decode budget."""
    *_, ref, got = _world(arch)
    (jl, jc), (tl, tc) = ref["prefill"], got["prefill"]
    assert tl.shape == jl.shape
    np.testing.assert_allclose(tl, jl, rtol=0, atol=ATOL)
    _close(tc, jc)
    assert got["extended"] == ref["extended"]


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_steps_match_reference(arch):
    """4 greedy decode steps: each step's logits and the caches after it."""
    *_, ref, got = _world(arch)
    for (jl, jc), (tl, tc) in zip(ref["steps"], got["steps"]):
        np.testing.assert_allclose(tl, jl, rtol=0, atol=ATOL)
        _close(tc, jc)


@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_decode_tokens_match_reference(arch):
    """The launcher's loop in both packages: jitted reference programs,
    the port's prefill on the kernels' plain versions."""
    jc, tc, np_params, tokens, _, _ = _world(arch)
    jpre, jdec = j_serve.make_serving_fns(jc)
    want = j_serve.greedy_decode(
        jpre, jdec, jc, jax.tree_util.tree_map(jnp.asarray, np_params),
        {"tokens": jnp.asarray(tokens)}, STEPS + 2)
    tpre, tdec = t_serve.make_serving_fns(tc)
    got = t_serve.greedy_decode(tpre, tdec, tc,
                                params_from_numpy(np_params, "cpu"),
                                {"tokens": torch.from_numpy(tokens)},
                                STEPS + 2, keep_logits=True)
    assert got["tokens"].dtype == torch.int32
    assert np.array_equal(got["tokens"].numpy(), np.asarray(want["tokens"]))
    assert got["logits"].shape == (STEPS + 2, B, tc.vocab_size)
    assert got["prefill_s"] >= 0 and got["decode_s"] >= 0


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_tracks_full_forward(arch):
    """Inside the port: teacher-forced decode steps after a prefill equal
    the full forward's logits at those positions (2e-5, float32), the
    forward in the prefill's mode (an MoE layer's generous capacity)."""
    _, tc, np_params, tokens, _, _ = _world(arch)
    tp = params_from_numpy(np_params, "cpu")
    full = torch.from_numpy(np.concatenate(
        [tokens, np.random.default_rng(5).integers(
            0, tc.vocab_size, (B, STEPS)).astype(np.int32)], 1))
    with torch.no_grad():
        want, _ = tfm.forward(tp, {"tokens": full}, tc, mode="prefill")
        _, caches, _ = tfm.prefill(tp, {"tokens": full[:, :PROMPT]}, tc)
        caches = t_serve.extend_caches(caches, tc, STEPS)
        for s in range(STEPS):
            pos = PROMPT + s
            logits, caches = tfm.decode_step(tp, full[:, pos:pos + 1],
                                             caches, pos, tc)
            np.testing.assert_allclose(logits.numpy(),
                                       want[:, pos].numpy(), rtol=0,
                                       atol=ATOL)


# -- the blocks' decode steps -------------------------------------------------


def _layer(arch, j):
    """Layer ``j`` of the stage's first period: its params in both
    packages, the two configs and a (B, 1, d) input."""
    jc, tc, np_params, _, _, _ = _world(arch)
    core = jax.tree_util.tree_map(lambda a: a[0],
                                  np_params["stages"][0][f"l{j}"]["core"])
    x = np.random.default_rng(j).normal(size=(B, 1, jc.d_model)).astype(
        np.float32)
    return (jc, tc, jax.tree_util.tree_map(jnp.asarray, core),
            params_from_numpy(core, "cpu"), x)


def _state(np_state):
    return tree_map(lambda a: torch.from_numpy(np.array(a)), np_state)


@pytest.mark.parametrize("kind", ["attn", "mamba", "mlstm", "slstm"])
def test_block_decode_matches_reference(kind):
    """One decode step of each block kind from a carried state (attention:
    a random cache with 6 of 9 slots written; the recurrent blocks: the
    state a 7-token prefill leaves)."""
    arch, j = {"attn": ("hybrid", 1), "mamba": ("hybrid", 0),
               "mlstm": ("xlstm", 0), "slstm": ("xlstm", 1)}[kind]
    jc, tc, jcore, tcore, x = _layer(arch, j)
    rng = np.random.default_rng(7)
    if kind == "attn":
        jst = j_attn.init_kv_cache(jc, None, B, 9)
        jst = {k: jnp.asarray(rng.normal(size=v.shape).astype(np.float32))
               for k, v in jst.items()}
        spec = jc.stages[0].pattern[j]
        jout, jnew = j_attn.attn_decode(jcore, jnp.asarray(x), jst, 6,
                                        cfg=jc, spec=spec, window=-1)
        tout, tnew = t_attn.attn_decode(tcore, torch.from_numpy(x),
                                        _state(jst), 6, cfg=tc,
                                        spec=tc.stages[0].pattern[j],
                                        window=-1)
    else:
        # the state a 7-token prefill of the block leaves
        jfwd = {"mamba": j_mamba.mamba_forward,
                "mlstm": j_xlstm.mlstm_forward,
                "slstm": j_xlstm.slstm_forward}[kind]
        seq = rng.normal(size=(B, 7, jc.d_model)).astype(np.float32)
        _, jst = jfwd(jcore, jnp.asarray(seq), cfg=jc)
        jdec = {"mamba": j_mamba.mamba_decode, "mlstm": j_xlstm.mlstm_decode,
                "slstm": j_xlstm.slstm_decode}[kind]
        tdec = {"mamba": t_mamba.mamba_decode, "mlstm": t_xlstm.mlstm_decode,
                "slstm": t_xlstm.slstm_decode}[kind]
        jout, jnew = jdec(jcore, jnp.asarray(x), jst, cfg=jc)
        tout, tnew = tdec(tcore, torch.from_numpy(x), _state(jst), cfg=tc)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), rtol=0,
                               atol=ATOL)
    assert sorted(tnew) == sorted(jnew)
    for k in jnew:
        np.testing.assert_allclose(tnew[k].numpy(), np.asarray(jnew[k]),
                                   rtol=0, atol=ATOL)


@pytest.mark.parametrize("kind", ["mamba", "mlstm", "slstm"])
def test_recurrent_states_take_a_leading_axis(kind):
    jc, tc = _configs("hybrid" if kind == "mamba" else "xlstm")
    jfn = {"mamba": j_mamba.init_mamba_state,
           "mlstm": j_xlstm.init_mlstm_state,
           "slstm": j_xlstm.init_slstm_state}[kind]
    tfn = {"mamba": t_mamba.init_mamba_state,
           "mlstm": t_xlstm.init_mlstm_state,
           "slstm": t_xlstm.init_slstm_state}[kind]
    want, got = jfn(jc, 3, leading=(2,)), tfn(tc, 3, leading=(2,))
    assert sorted(got) == sorted(want)
    for k in want:
        assert tuple(got[k].shape) == want[k].shape
        assert np.array_equal(got[k].numpy(), np.asarray(want[k]))


# -- cache layout and the launcher -------------------------------------------


def test_cache_seq_axis_counts_from_trailing_end():
    for key, ndim in (("k", 4), ("v", 4), ("k", 5), ("v", 5), ("ckv", 3),
                      ("krope", 3), ("ckv", 4), ("krope", 4)):
        assert t_attn.cache_seq_axis(key, ndim) == \
            j_attn.cache_seq_axis(key, ndim)
    assert t_attn.KV_CACHE_TRAILING_DIMS == j_attn.KV_CACHE_TRAILING_DIMS


@pytest.mark.parametrize("leading", [(), (2,)])
def test_extend_caches_pads_the_sequence_axis(leading):
    """Unstacked (B, S, H, D) entries grow on axis 1, stacked ones on axis
    2; the written slots stay, the new ones are zero."""
    cfg = SimpleNamespace(stages=[
        SimpleNamespace(pattern=[SimpleNamespace(kind="attn")])])
    shape = leading + (2, 5, 3, 4)
    caches = [{"l0": {"k": torch.ones(shape), "v": torch.ones(shape),
                      "ckv": torch.ones(leading + (2, 5, 7))}}]
    out = t_serve.extend_caches(caches, cfg, extra=3)
    axis = len(leading) + 1
    for key in ("k", "v", "ckv"):
        a = out[0]["l0"][key]
        assert a.shape[axis] == 8
        assert bool((a.narrow(axis, 0, 5) == 1).all())
        assert bool((a.narrow(axis, 5, 3) == 0).all())


def test_serve_steps_run_under_inference_mode():
    _, tc = _configs("internlm2-1.8b")
    prefill = tstep.make_serve_prefill(tc, Runtime())
    decode = tstep.make_serve_decode(tc, Runtime())
    params = tfm.init_params(torch.Generator().manual_seed(0), tc)
    tokens = torch.randint(0, tc.vocab_size, (2, 5),
                           generator=torch.Generator().manual_seed(1))
    logits, caches = prefill(params, {"tokens": tokens})
    assert logits.is_inference() and logits.shape == (2, tc.vocab_size)
    caches = t_serve.extend_caches(caches, tc, 2)
    tok, step_logits, caches = decode(params, logits.argmax(-1)[:, None],
                                      caches, 5)
    assert tok.dtype == torch.int32 and tok.shape == (2,)
    assert torch.equal(tok, step_logits.argmax(-1).to(torch.int32))


def test_serve_launcher_on_the_cpu(capsys):
    """``python -m repro_torch.launch.serve --device cpu`` in-process:
    the reduced internlm2 in float32, weights and prompts from the seed,
    the same tokens twice."""
    r = t_serve.main(["--device", "cpu", "--batch", "2", "--prompt", "6",
                      "--new-tokens", "3"])
    assert r["tokens"].shape == (2, 3) and r["decode_tok_per_s"] > 0
    assert "arch=internlm2-1.8b-smoke" in capsys.readouterr().out
    again = t_serve.serve(dataclasses.replace(
        reduced(get_config("internlm2-1.8b")), compute_dtype="float32"),
        2, 6, 3, device="cpu")
    assert torch.equal(again["tokens"], r["tokens"])
    assert torch.equal(again["prompts"], r["prompts"])

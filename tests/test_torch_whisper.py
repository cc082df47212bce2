"""The port's encoder and decoder cross-attention (whisper-medium) against
the JAX reference, from the same weights and inputs.

JAX weights are carried over with ``params_from_numpy``, the encoder's
subtree with them; the reduced config (``reduced(whisper-medium)``: 2
decoder layers with cross-attention, 2 encoder layers over 16 frames,
d_model 256) runs in float32 on both sides, and the frame embeddings
``enc_embed`` are drawn from a seed with numpy.  Tolerances and their
reasons:

* logits, hidden states, caches, cross keys and values, the cross
  sublayer's output: atol 2e-5 -- the two frameworks' float32 matrix
  products and transcendental functions differ in the last bits (as
  ``test_torch_transformer.py``);
* loss and grad norm: 1e-5 absolute, for the same reason; the loss
  gradient: atol 1e-6 (it agrees to 2e-8); the parameters after one AdamW
  step: atol 1.5e-4 -- the first step moves an element by
  lr * g / (|g| + 1e-8), whose slope at |g| = 1e-8 is lr / 4e-8, so a
  gradient 2e-8 off moves an element whose gradient lies near 1e-8 (there
  are such among the weight matrices' entries) by up to
  3e-4 * 2e-8 / 4e-8 = 1.5e-4;
* greedy tokens, cache shapes and dtypes: equal; the cross caches across
  the decode steps: bit for bit;
* bfloat16 compute and caches: atol 2e-2, the reference's bfloat16
  attention bound (one bfloat16 rounding of a key or a value, 2^-8
  relative, may land on the other side in either framework).
"""
import dataclasses
import functools
import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.configs import reduced as j_reduced  # noqa: E402
from repro.fl import serving as j_serving  # noqa: E402
from repro.launch import serve as j_serve  # noqa: E402
from repro.models import attention as j_attn  # noqa: E402
from repro.models import transformer as j_tfm  # noqa: E402
from repro.runtime import Runtime as JRuntime  # noqa: E402
from repro.train import step as j_step  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.core.aggregate import tree_leaves, tree_map  # noqa: E402
from repro_torch.data.pipeline import TokenPipeline  # noqa: E402
from repro_torch.fl import serving as t_serving  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import serve as t_serve  # noqa: E402
from repro_torch.models import attention as t_attn  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.runtime import Runtime, serve_runtime  # noqa: E402
from repro_torch.train import step as t_step  # noqa: E402
from repro_torch.weights import params_from_numpy  # noqa: E402

ATOL = 2e-5
BF16_ATOL = 2e-2
STEP_ATOL = 1.5e-4          # the parameters after one AdamW step
B, PROMPT, STEPS = 2, 12, 4
REPO = Path(__file__).resolve().parent.parent


def _configs(dtype="float32", n_ctx=None, enc_layers=None):
    """The reduced config in both packages, in ``dtype`` compute and
    caches, with ``n_ctx`` encoder frames and ``enc_layers`` encoder
    layers if given."""
    jc = j_reduced(j_get_config("whisper-medium"))
    tc = reduced(get_config("whisper-medium"))
    jc = dataclasses.replace(jc, compute_dtype=dtype, cache_dtype=dtype)
    tc = dataclasses.replace(tc, compute_dtype=dtype, cache_dtype=dtype)
    if n_ctx is not None:
        jc = dataclasses.replace(jc, encoder=dataclasses.replace(
            jc.encoder, n_ctx=n_ctx))
        tc = dataclasses.replace(tc, encoder=dataclasses.replace(
            tc.encoder, n_ctx=n_ctx))
    if enc_layers is not None:
        jc = dataclasses.replace(jc, encoder=dataclasses.replace(
            jc.encoder, n_layers=enc_layers))
        tc = dataclasses.replace(tc, encoder=dataclasses.replace(
            tc.encoder, n_layers=enc_layers))
    return jc, tc


@functools.lru_cache(maxsize=None)
def _np_params(seed=0):
    jc, _ = _configs()
    return jax.tree_util.tree_map(
        np.array, j_tfm.init_params(jax.random.PRNGKey(seed), jc))


def _both(np_params):
    return (jax.tree_util.tree_map(jnp.asarray, np_params),
            params_from_numpy(np_params, "cpu"))


def _enc_embed(rows, n_ctx=16, seed=3):
    return (np.random.default_rng(seed).normal(0, 1, (rows, n_ctx, 256))
            .astype(np.float32))


def _tokens(rows, seq, seed=1, vocab=512):
    return np.random.default_rng(seed).integers(
        0, vocab, (rows, seq)).astype(np.int32)


def _batches(batch):
    return ({k: jnp.asarray(v) for k, v in batch.items()},
            {k: torch.from_numpy(v) for k, v in batch.items()})


def _np_leaves(tree):
    return [np.asarray(a, dtype=np.float32)
            for a in jax.tree_util.tree_leaves(tree)]


def _t_leaves(tree):
    return [a.detach().float().numpy() for a in tree_leaves(tree)]


def _close(got, want, atol=ATOL):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=0, atol=atol)


def test_config_and_tree_carry_over():
    """The config equals the reference's at full size and reduced, and the
    reference's tree (``encoder`` subtree included) loads leaf for leaf
    into the shapes the port draws."""
    assert dataclasses.asdict(get_config("whisper-medium")) == \
        dataclasses.asdict(j_get_config("whisper-medium"))
    jc, tc = _configs()
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    loaded = params_from_numpy(_np_params(), "cpu")
    drawn = tfm.init_params(torch.Generator().manual_seed(0), tc)
    assert sorted(loaded) == sorted(drawn) == ["embed", "encoder",
                                               "final_norm", "stages"]
    assert sorted(loaded["encoder"]) == ["final_norm", "layers"]
    assert sorted(loaded["stages"][0]["l0"]) == ["core", "ffn", "norm1",
                                                 "norm2", "xnorm"]
    assert {"xwq", "xwk", "xwv", "xwo"} <= set(loaded["stages"][0]["l0"]
                                               ["core"])
    j_shapes = [a.shape for a in jax.tree_util.tree_leaves(_np_params())]
    assert [tuple(a.shape) for a in tree_leaves(loaded)] == j_shapes
    assert [tuple(a.shape) for a in tree_leaves(drawn)] == j_shapes
    _close(_t_leaves(loaded), _np_leaves(_np_params()), atol=0)


def _tree_param_count():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.tree_param_count


@pytest.mark.parametrize("full", [False, True])
def test_leaf_by_leaf_parameter_count(full):
    """``chip_smoke.tree_param_count`` against the reference's tree,
    counted leaf by leaf from ``jax.eval_shape`` (no weights drawn): at
    full size 959,329,280, which ``param_count()`` misses by the 122
    layer norms it leaves out (2 x 1,024 each)."""
    jc = j_get_config("whisper-medium") if full else _configs()[0]
    tc = get_config("whisper-medium") if full else _configs()[1]
    shapes = jax.eval_shape(lambda k: j_tfm.init_params(k, jc),
                            jax.random.PRNGKey(0))
    want = sum(int(np.prod(a.shape))
               for a in jax.tree_util.tree_leaves(shapes))
    assert _tree_param_count()(tc) == want
    if full:
        assert want == 959_329_280
        assert want - tc.param_count() == 122 * 2 * 1024


@pytest.mark.parametrize("dtype,atol", [("float32", ATOL),
                                        ("bfloat16", BF16_ATOL)])
def test_cross_kv_and_cross_attn_forward(dtype, atol):
    """The cross sublayer alone on layer 0's weights: keys and values in
    the cache dtype, and the attention's output."""
    jc, tc = _configs(dtype)
    core = jax.tree_util.tree_map(lambda a: a[0],
                                  _np_params()["stages"][0]["l0"]["core"])
    rng = np.random.default_rng(7)
    enc = rng.normal(0, 1, (B, 16, 256)).astype(np.float32)
    x = rng.normal(0, 1, (B, PROMPT, 256)).astype(np.float32)
    jk, jv = j_attn.cross_kv(core, jnp.asarray(enc), cfg=jc)
    j_out = j_attn.cross_attn_forward(core, jnp.asarray(x), jk, jv, cfg=jc)
    tcore = params_from_numpy(core, "cpu")
    with torch.no_grad():
        tk, tv = t_attn.cross_kv(tcore, torch.from_numpy(enc), cfg=tc)
        t_out = t_attn.cross_attn_forward(tcore, torch.from_numpy(x), tk, tv,
                                          cfg=tc)
    assert tk.dtype == tv.dtype == getattr(torch, dtype)
    assert tuple(tk.shape) == jk.shape == (B, 16, 4, 64)
    _close([tk.float().numpy(), tv.float().numpy(), t_out.float().numpy()],
           [np.asarray(a, np.float32) for a in (jk, jv, j_out)], atol)


def test_encoder_forward():
    jc, tc = _configs()
    jp, tp = _both(_np_params())
    enc = _enc_embed(B)
    want = j_tfm._encoder_forward(jp, jnp.asarray(enc), jc, JRuntime())
    with torch.no_grad():
        got = tfm._encoder_forward(tp, torch.from_numpy(enc), tc, Runtime())
    assert tuple(got.shape) == want.shape == (B, 16, 256)
    _close([got.numpy()], [np.asarray(want)])


def test_encoder_never_takes_the_flash_kernel(monkeypatch):
    """With the kernels on, the decoder's causal self-attention takes the
    flash entry point once a layer; the encoder's non-causal attention
    never does (it takes the dense scores, as the reference's dispatch)."""
    _, tc = _configs()
    _, tp = _both(_np_params())
    calls = []
    inner = ops.flash_attention

    def counted(q, k, v, **kw):
        calls.append((q.shape[1], kw["causal"]))
        return inner(q, k, v, **kw)

    monkeypatch.setattr(ops, "flash_attention", counted)
    batch = {"tokens": torch.from_numpy(_tokens(B, PROMPT)),
             "enc_embed": torch.from_numpy(_enc_embed(B))}
    with torch.no_grad():
        tfm._encoder_forward(tp, batch["enc_embed"], tc, serve_runtime())
        assert calls == []
        tfm.prefill(tp, batch, tc, serve_runtime())
    assert calls == [(PROMPT, True)] * 2


@pytest.mark.parametrize("kernels", [False, True])
def test_forward_hidden_and_loss(kernels):
    """``forward_hidden`` (with the signature), the logits and
    ``loss_fn`` with ``enc_embed`` from a seed; with ``kernels`` the
    decoder's self-attention goes through the flash entry point (the
    interpret-mode Pallas kernel in the reference, the plain version
    here)."""
    jc, tc = _configs()
    jp, tp = _both(_np_params())
    tokens = _tokens(B, 40)
    batch = {"tokens": tokens, "enc_embed": _enc_embed(B),
             "labels": _tokens(B, 40, seed=2)}
    jb, tb = _batches(batch)
    j_rt = JRuntime(use_pallas=kernels, want_signature=True,
                    kernel_policy="interpret" if kernels else "reference")
    jh, j_aux, _ = j_tfm.forward_hidden(jp, jb, jc, j_rt)
    j_logits, _, _ = j_tfm.forward(jp, jb, jc, j_rt)
    j_loss, j_loss_aux = j_tfm.loss_fn(jp, jb, jc)
    rt = Runtime(use_kernels=kernels, want_signature=True)
    with torch.no_grad():
        th, t_aux = tfm.forward_hidden(tp, tb, tc, rt)
        t_logits, _ = tfm.forward(tp, tb, tc, rt)
        t_loss, t_loss_aux = tfm.loss_fn(tp, tb, tc)
    _close([th.numpy(), t_logits.numpy()],
           [np.asarray(jh), np.asarray(j_logits)])
    assert abs(float(t_loss) - float(j_loss)) <= 1e-5
    assert abs(float(t_loss_aux["ce_loss"])
               - float(j_loss_aux["ce_loss"])) <= 1e-5
    assert float(t_loss_aux["moe_aux"]) == 0.0
    assert np.array_equal(t_aux["signature"].numpy(),
                          np.asarray(j_aux["signature"]))


def test_loss_gradient_reaches_the_encoder():
    """The loss gradient, the encoder's and the cross projections'
    leaves among them, against ``jax.grad`` of the reference's loss."""
    jc, tc = _configs()
    jp, tp = _both(_np_params())
    batch = {"tokens": _tokens(B, 20), "enc_embed": _enc_embed(B),
             "labels": _tokens(B, 20, seed=2)}
    jb, tb = _batches(batch)
    j_grads = jax.grad(lambda p: j_tfm.loss_fn(p, jb, jc)[0])(jp)
    for leaf in tree_leaves(tp):
        leaf.requires_grad_(True)
    loss, _ = tfm.loss_fn(tp, tb, tc)
    loss.backward()
    got = [a.grad.numpy() for a in tree_leaves(tp)]
    want = _np_leaves(j_grads)
    assert all(np.abs(g).max() > 0 for g in
               _t_leaves(tree_map(lambda a: a.grad, tp["encoder"])))
    _close(got, want, atol=1e-6)


def _train_step_agree(jc, tc, batch, ref_microbatches, microbatches):
    np_params = _np_params()
    ref_step, ref_opt = j_step.make_train_step(
        jc, runtime=JRuntime(want_signature=True), clip_norm=1.0,
        microbatches=ref_microbatches)
    got_step, got_opt = t_step.make_train_step(
        tc, runtime=Runtime(want_signature=True), clip_norm=1.0,
        microbatches=microbatches)
    jp, tp = _both(np_params)
    jb, tb = _batches(batch)
    jp, _, jm = jax.jit(ref_step)(jp, ref_opt.init(jp), jb)
    tp, _, tm = got_step(tp, got_opt.init(tp), tb)
    for key in ("loss", "ce_loss", "grad_norm"):
        assert float(tm[key]) == pytest.approx(float(jm[key]), abs=1e-5)
    assert float(tm["grad_norm"]) > 0.0
    _close(_t_leaves(tp), _np_leaves(jp), atol=STEP_ATOL)


@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_step(microbatches):
    """One AdamW step (clip 1.0, the signature in the metrics) on a
    pipeline batch of 4 x 32 with ``enc_embed`` from a seed: loss, grad
    norm and every updated parameter."""
    jc, tc = _configs()
    pipe = TokenPipeline(512, 4, 32, n_tokens=5000, seed=1)
    batch = dict(pipe.batch_dict(next(iter(pipe))), enc_embed=_enc_embed(4))
    _train_step_agree(jc, tc, batch, microbatches, microbatches)


def test_microbatches_cut_enc_embed_on_its_batch_axis():
    """The reference's fault, and the port's way round it.  The
    reference's microbatch split takes axis 1 of any 3-D leaf of 3 rows
    (M-RoPE's positions), so at batch 3 it cuts ``enc_embed`` (3, n_ctx,
    d) over its frames: at 15 frames the microbatches pair one row of
    tokens with 3 rows of 5 frames, and its step fails.  The port's
    ``_split`` decides by the key: ``enc_embed`` is cut on axis 0, and 3
    microbatches give the reference's one-batch step."""
    jc, tc = _configs(n_ctx=15)
    enc = torch.from_numpy(_enc_embed(3, n_ctx=15))
    parts = t_step._split("enc_embed", enc, 3)
    assert [tuple(p.shape) for p in parts] == [(1, 15, 256)] * 3
    assert torch.equal(torch.cat(parts, dim=0), enc)
    pipe = TokenPipeline(512, 3, 32, n_tokens=5000, seed=1)
    batch = dict(pipe.batch_dict(next(iter(pipe))), enc_embed=enc.numpy())
    ref_step, ref_opt = j_step.make_train_step(jc, microbatches=3)
    jp, _ = _both(_np_params())
    with pytest.raises(TypeError, match="cannot reshape"):
        ref_step(jp, ref_opt.init(jp), _batches(batch)[0])
    _train_step_agree(jc, tc, batch, 1, 3)


def test_zero_frames_overflow_the_gradient_at_full_encoder_depth():
    """The reference's launcher feeds zero frame embeddings.  Each layer
    norm of a zero row scales the backward by 1/sqrt(1e-6), so at
    whisper-medium's 24 encoder layers the gradient overflows: after one
    AdamW step the grad norm is NaN and so is every parameter, in the
    reference (float32, here at reduced width) and in the port alike.
    ``train_single(enc_embed=...)`` trains on frames of the caller's."""
    import argparse

    from repro_torch.launch import train as t_train
    jc, tc = _configs(enc_layers=24)
    np_params = jax.tree_util.tree_map(
        np.array, j_tfm.init_params(jax.random.PRNGKey(0), jc))
    pipe = TokenPipeline(512, 2, 32, n_tokens=5000, seed=1)
    batch = dict(pipe.batch_dict(next(iter(pipe))),
                 enc_embed=np.zeros((2, 16, 256), np.float32))
    ref_step, ref_opt = j_step.make_train_step(jc)
    got_step, got_opt = t_step.make_train_step(tc)
    jp, tp = _both(np_params)
    jb, tb = _batches(batch)
    jp, _, jm = jax.jit(ref_step)(jp, ref_opt.init(jp), jb)
    tp, _, tm = got_step(tp, got_opt.init(tp), tb)
    assert np.isnan(float(jm["grad_norm"]))
    assert np.isnan(float(tm["grad_norm"]))
    assert abs(float(tm["loss"]) - float(jm["loss"])) <= 1e-5
    assert not any(np.isfinite(a).any() for a in _np_leaves(jp["encoder"]))
    assert not any(np.isfinite(a).any() for a in _t_leaves(tp["encoder"]))
    args = argparse.Namespace(steps=2, batch=2, seq=32, seed=0,
                              device="cpu", log_every=10, checkpoint="")
    for frames in (None, torch.from_numpy(_enc_embed(2)) * 0.1):
        history = []
        t_train.train_single(tc, args, pipe=pipe, history=history,
                             enc_embed=frames)
        norms = [h["grad_norm"] for h in history]
        assert np.isfinite(history[0]["loss"])
        assert np.isnan(norms[0]) if frames is None \
            else np.isfinite(norms).all()


def _world(dtype="float32"):
    """The reference's prefill and STEPS greedy decode steps, and the
    port's (prefill on the kernels' plain versions), as numpy; the port's
    cross caches after the prefill and after the steps."""
    jc, tc = _configs(dtype)
    jp, tp = _both(_np_params())
    batch = {"tokens": _tokens(B, PROMPT), "enc_embed": _enc_embed(B)}
    jb, tb = _batches(batch)
    jl, jcache, _ = j_tfm.prefill(jp, jb, jc)
    with torch.no_grad():
        tl, tcache, _ = tfm.prefill(tp, tb, tc, serve_runtime())
    ref = {"prefill": (np.asarray(jl, np.float32), _np_leaves(jcache))}
    got = {"prefill": (tl.float().numpy(), _t_leaves(tcache))}
    cross = [(c["xk"].clone(), c["xv"].clone()) for c in
             (s["l0"] for s in tcache)]
    jcache = j_serve.extend_caches(jcache, jc, STEPS)
    tcache = t_serve.extend_caches(tcache, tc, STEPS)
    tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)[:, None]
    ref["steps"], got["steps"] = [], []
    ttok = torch.from_numpy(tok)
    for i in range(STEPS):
        jl, jcache = j_tfm.decode_step(jp, jnp.asarray(tok), jcache,
                                       jnp.int32(PROMPT + i), jc)
        with torch.no_grad():
            tl, tcache = tfm.decode_step(tp, ttok, tcache, PROMPT + i, tc)
        ref["steps"].append(np.asarray(jl, np.float32))
        got["steps"].append(tl.float().numpy())
        tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)[:, None]
        ttok = tl.argmax(-1).to(torch.int32)[:, None]
        assert np.array_equal(ttok.numpy(), tok)
    ref["cache"], got["cache"] = _np_leaves(jcache), _t_leaves(tcache)
    got["cross"] = (cross, [(s["l0"]["xk"], s["l0"]["xv"]) for s in tcache])
    return ref, got


@functools.lru_cache(maxsize=None)
def _world_f32():
    return _world()


def test_prefill_logits_and_caches():
    """The last logits and every cache: the decoder layers' roped ``k``
    and ``v``, and the cross ``xk`` and ``xv`` over the encoder's frames."""
    ref, got = _world_f32()
    _close([got["prefill"][0]], [ref["prefill"][0]])
    _close(got["prefill"][1], ref["prefill"][1])


def test_decode_steps_logits_and_tokens():
    """4 greedy decode steps against the prefill's caches: each step's
    logits, the greedy tokens (asserted equal step by step) and the final
    caches."""
    ref, got = _world_f32()
    _close(got["steps"], ref["steps"])
    _close(got["cache"], ref["cache"])


def test_decode_never_writes_the_cross_caches():
    _, got = _world_f32()
    before, after = got["cross"]
    for (xk0, xv0), (xk1, xv1) in zip(before, after):
        assert torch.equal(xk0, xk1) and torch.equal(xv0, xv1)


def test_bfloat16_prefill_and_decode():
    """bfloat16 compute and caches on both sides: the prefill's logits
    and the decode steps' within the reference's bfloat16 bound."""
    ref, got = _world("bfloat16")
    _close([got["prefill"][0]] + got["steps"],
           [ref["prefill"][0]] + ref["steps"], BF16_ATOL)
    assert all(a.dtype == torch.bfloat16 for a, _ in got["cross"][0])


def test_init_cache_and_extend_caches():
    """``init_cache`` in the reference's shapes and dtypes; ``extend_caches``
    grows ``k`` and ``v`` and passes ``xk`` and ``xv`` through unpadded."""
    jc, tc = _configs("bfloat16")
    want = j_tfm.init_cache(jc, B, PROMPT)
    got = tfm.init_cache(tc, B, PROMPT)
    assert sorted(got[0]["l0"]) == ["k", "v", "xk", "xv"]
    assert [tuple(a.shape) for a in tree_leaves(got)] == \
        [a.shape for a in jax.tree_util.tree_leaves(want)]
    assert all(a.dtype == torch.bfloat16 and not a.any()
               for a in tree_leaves(got))
    assert tuple(got[0]["l0"]["xk"].shape) == (2, B, 16, 4, 64)
    grown = t_serve.extend_caches(got, tc, STEPS)
    j_grown = j_serve.extend_caches(want, jc, STEPS)
    assert [tuple(a.shape) for a in tree_leaves(grown)] == \
        [a.shape for a in jax.tree_util.tree_leaves(j_grown)]
    assert grown[0]["l0"]["k"].shape[2] == PROMPT + STEPS
    assert grown[0]["l0"]["xk"] is got[0]["l0"]["xk"]
    assert grown[0]["l0"]["xv"] is got[0]["l0"]["xv"]


def test_serve_equals_reference_greedy_decode():
    """The serve launcher with the reference's weights, prompts and frame
    embeddings against the reference's ``greedy_decode``: tokens equal;
    and ``serve``'s own draw of ``enc_embed`` (seeded, N(0, 1) * 0.1)."""
    jc, tc = _configs()
    jp, tp = _both(_np_params())
    tokens, enc = _tokens(B, PROMPT), _enc_embed(B)
    prefill, decode = j_serve.make_serving_fns(jc)
    want = j_serve.greedy_decode(prefill, decode, jc, jp,
                                 {"tokens": jnp.asarray(tokens),
                                  "enc_embed": jnp.asarray(enc)}, 6)
    got = t_serve.serve(tc, B, PROMPT, 6, device="cpu", params=tp,
                        prompts=torch.from_numpy(tokens),
                        enc_embed=torch.from_numpy(enc))
    assert np.array_equal(got["tokens"].numpy(), np.asarray(want["tokens"]))
    drawn = t_serve.serve(tc, B, PROMPT, 2, seed=5, device="cpu")
    gen = torch.Generator().manual_seed(5)
    tfm.init_params(gen, tc)
    torch.randint(0, tc.vocab_size, (B, PROMPT), generator=gen)
    expect = torch.randn((B, 16, 256), generator=gen) * 0.1
    assert torch.equal(drawn["enc_embed"], expect)


def test_query_driver_equals_reference():
    """``LMQueryDriver.decode_prompts`` (zero frame embeddings) against
    the reference's ``LMQueryDriver`` on the same prompts: tokens
    equal."""
    jc, tc = _configs()
    jp, tp = _both(_np_params())
    prompts = _tokens(3, PROMPT, seed=4)
    kw = dict(query_batch=3, prompt_len=PROMPT, new_tokens=5)
    want = j_serving.LMQueryDriver(jc, **kw).decode_prompts(jp, prompts)
    driver = t_serving.LMQueryDriver(tc, **kw)
    batch = driver.make_batch(prompts)
    assert batch["enc_embed"].dtype == torch.float32
    assert tuple(batch["enc_embed"].shape) == (3, 16, 256)
    assert not batch["enc_embed"].any()
    got = driver.decode_prompts(tp, prompts)
    assert np.array_equal(got, np.asarray(want))

"""The port's M-RoPE (Qwen2-VL) against the JAX reference: ``apply_rope``
with sections, a reduced qwen2-vl-72b under image-grid positions, a
prefill at grid positions with decode steps after it, and the train step
at two microbatches with (3, B, S) positions.

Positions are laid out as Qwen2-VL lays out an image (arXiv:2409.12191
§2.1): text tokens, then a patch grid whose (temporal, height, width) ids
start from the text's next position, then text that continues from the
grid's largest id + 1.  The reduced model takes head_dim 128, so that its
64 half-dim frequencies hold all three sections (16, 24, 24), as
qwen2-vl-72b's do; ``reduced()`` alone gives head_dim 16, which the first
section covers.  Both sides run in float32 from the same numpy inputs.
Tolerances and their reasons:

* ``apply_rope``: 1e-6 absolute on unit-scale inputs (float32 ``cos`` and
  ``sin`` of angles up to ~100 rad are other implementations, an ulp or
  two apart); text-only positions give plain RoPE bit for bit;
* logits 2e-5, loss 1e-5, loss gradients 1e-6, as for the other reduced
  decoders; a prefill's and each decode step's logits and caches 2e-5, as
  in ``test_torch_decode.py``;
* the train step: loss and grad norm 1e-5, the signature within one flag
  a bucket, parameters 3e-5 after 3 AdamW steps, as for the MoE configs
  in ``test_torch_train.py``: where a gradient entry is of the order of
  AdamW's eps (1e-8), its float32 noise moves the first update by lr
  times the noise over eps (``wq``, 1.2e-5 after one step).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.configs import reduced as j_reduced  # noqa: E402
from repro.launch import serve as j_serve  # noqa: E402
from repro.models import layers as j_layers  # noqa: E402
from repro.models import transformer as j_tfm  # noqa: E402
from repro.runtime import Runtime as JRuntime  # noqa: E402
from repro.train import step as jstep  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.core.aggregate import tree_leaves, tree_map  # noqa: E402
from repro_torch.launch import serve as t_serve  # noqa: E402
from repro_torch.models import layers  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.runtime import Runtime  # noqa: E402
from repro_torch.train import step as tstep  # noqa: E402
from repro_torch.weights import params_from_numpy  # noqa: E402
from test_torch_baselines import few_torch_threads  # noqa: E402,F401

ARCH = "qwen2-vl-72b"
SECTIONS = (16, 24, 24)


def grid_positions(B, text, grid_h, grid_w, tail):
    """(3, B, S) ids: ``text`` text tokens, an image of grid_h x grid_w
    patches at (t, h, w) = (p, p + row, p + col) from the next position
    p, then ``tail`` text tokens from the grid's largest id + 1."""
    ids = [np.repeat(np.arange(text)[None], 3, 0)]
    rows, cols = np.meshgrid(np.arange(grid_h), np.arange(grid_w),
                             indexing="ij")
    ids.append(np.stack([np.full(grid_h * grid_w, text),
                         text + rows.reshape(-1), text + cols.reshape(-1)]))
    start = text + max(grid_h, grid_w)
    ids.append(np.repeat(np.arange(start, start + tail)[None], 3, 0))
    pos = np.concatenate(ids, axis=1).astype(np.int32)
    return np.ascontiguousarray(np.broadcast_to(pos[:, None],
                                                (3, B, pos.shape[1])))


def test_grid_positions_follow_qwen2_vl():
    pos = grid_positions(2, 3, 2, 3, 2)
    assert pos.shape == (3, 2, 3 + 6 + 2)
    assert pos[:, 0, :3].tolist() == [[0, 1, 2]] * 3
    assert pos[:, 0, 3:9].tolist() == [[3] * 6, [3, 3, 3, 4, 4, 4],
                                       [3, 4, 5, 3, 4, 5]]
    assert pos[:, 0, 9:].tolist() == [[6, 7]] * 3


def _rope_inputs(seed=0, B=2, S=40, H=3, hd=128):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((B, S, H, hd)).astype(np.float32)


@pytest.mark.parametrize("theta", [1e6, 1e4])
def test_apply_rope_sections_match_reference(theta):
    x = _rope_inputs()
    pos = grid_positions(2, 10, 4, 6, 6)
    want = j_layers.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta,
                               SECTIONS)
    got = layers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                            theta, SECTIONS)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)
    # the sections act: the same x under text-only positions differs
    text = layers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos[0]),
                             theta, SECTIONS)
    assert not torch.allclose(text, got, atol=1e-3)


def test_text_positions_are_plain_rope():
    """(B, S) positions, and (3, B, S) with three equal rows, turn every
    section alike: plain RoPE, bit for bit, as in the reference."""
    x = torch.from_numpy(_rope_inputs(1))
    pos = torch.arange(40, dtype=torch.int32)[None].expand(2, 40)
    plain = layers.apply_rope(x, pos, 1e6)
    for p in (pos, pos[None].expand(3, 2, 40)):
        assert torch.equal(layers.apply_rope(x, p, 1e6, SECTIONS), plain)
    want = j_layers.apply_rope(jnp.asarray(x.numpy()),
                               jnp.asarray(pos.numpy()), 1e6, SECTIONS)
    np.testing.assert_allclose(plain.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)


def _configs(vocab=None):
    jc = dataclasses.replace(j_reduced(j_get_config(ARCH), d_model=64),
                             head_dim=128)
    tc = dataclasses.replace(reduced(get_config(ARCH), d_model=64),
                             head_dim=128)
    if vocab is not None:
        jc = dataclasses.replace(jc, vocab_size=vocab)
        tc = dataclasses.replace(tc, vocab_size=vocab)
    return jc, tc


def _weights(jc, seed=0):
    params = jax.tree_util.tree_map(
        np.array, j_tfm.init_params(jax.random.PRNGKey(seed), jc))
    rng = np.random.default_rng(seed)
    for stage in params["stages"]:        # non-zero QKV biases
        for layer in stage.values():
            for name in ("bq", "bk", "bv"):
                layer["core"][name] = rng.normal(
                    0, 0.1, layer["core"][name].shape).astype(np.float32)
    return params


def test_configs_match_reference():
    jc, tc = j_get_config(ARCH), get_config(ARCH)
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    assert tc.mrope_sections == SECTIONS and sum(SECTIONS) == tc.head_dim // 2
    jc, tc = _configs()
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)


def _batch(jc, B=2, seed=1):
    rng = np.random.default_rng(seed)
    pos = grid_positions(B, 10, 4, 6, 6)
    S = pos.shape[-1]
    return {"tokens": rng.integers(0, jc.vocab_size, (B, S)).astype(np.int32),
            "labels": rng.integers(0, jc.vocab_size, (B, S)).astype(np.int32),
            "positions": pos}


@pytest.mark.parametrize("kernels", [False, True])
def test_forward_under_grid_positions_matches_reference(kernels):
    """Logits, loss and signature under grid positions; the default
    positions are (3, B, S) and give the logits of text positions."""
    jc, tc = _configs()
    np_params = _weights(jc)
    batch = _batch(jc)
    j_params = jax.tree_util.tree_map(jnp.asarray, np_params)
    params = params_from_numpy(np_params, "cpu")
    j_rt = JRuntime(use_pallas=kernels, want_signature=True,
                    kernel_policy="interpret" if kernels else "reference")
    rt = Runtime(use_kernels=kernels, want_signature=True)
    j_logits, j_aux, _ = j_tfm.forward(
        j_params, {k: jnp.asarray(v) for k, v in batch.items()}, jc, j_rt)
    with torch.no_grad():
        logits, aux = tfm.forward(
            params, {k: torch.from_numpy(v) for k, v in batch.items()}, tc,
            rt)
        text, _ = tfm.forward(params, {"tokens": torch.from_numpy(
            batch["tokens"])}, tc, rt)
        loss, _ = tfm.loss_fn(params, {k: torch.from_numpy(v)
                                       for k, v in batch.items()}, tc)
    np.testing.assert_allclose(logits.numpy(), np.asarray(j_logits), rtol=0,
                               atol=2e-5)
    sig, j_sig = aux["signature"].numpy(), np.asarray(j_aux["signature"])
    assert np.array_equal(sig, j_sig), np.flatnonzero(sig != j_sig)
    j_loss, _ = j_tfm.loss_fn(j_params, {k: jnp.asarray(v)
                                         for k, v in batch.items()}, jc)
    assert abs(float(loss) - float(j_loss)) <= 1e-5
    # the sections act: text positions past the grid give other logits
    assert (text - logits).abs().max().item() > 1e-3
    j_text, _, _ = j_tfm.forward(j_params, {"tokens": jnp.asarray(
        batch["tokens"])}, jc, j_rt)
    np.testing.assert_allclose(text.numpy(), np.asarray(j_text), rtol=0,
                               atol=2e-5)


def test_default_positions_are_three_rows():
    _, tc = _configs()
    got = tfm._positions_for(tc, {}, 2, 5, "cpu")
    assert got.shape == (3, 2, 5)
    assert torch.equal(got[2, 1], torch.arange(5, dtype=torch.int32))


def test_loss_gradient_under_grid_positions_matches_reference():
    jc, tc = _configs()
    np_params = _weights(jc)
    batch = _batch(jc, seed=2)
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


def test_decode_after_a_grid_prefill_matches_reference():
    """A prompt prefilled at image-grid positions, then 4 greedy decode
    steps, each at the text position ``pos`` (the decode step turns the
    new query and key by ``pos`` in all three sections, as the
    reference's does): the prefill's last logits and caches, and each
    step's logits and caches."""
    jc, tc = _configs()
    np_params = _weights(jc)
    batch = _batch(jc)
    S, steps = batch["tokens"].shape[1], 4
    jp = jax.tree_util.tree_map(jnp.asarray, np_params)
    tp = params_from_numpy(np_params, "cpu")
    prompt = {k: batch[k] for k in ("tokens", "positions")}
    j_logits, j_cache, _ = j_tfm.prefill(
        jp, {k: jnp.asarray(v) for k, v in prompt.items()}, jc)
    with torch.no_grad():
        logits, cache, _ = tfm.prefill(
            tp, {k: torch.from_numpy(v) for k, v in prompt.items()}, tc)

    def agree(got, want, got_cache, want_cache):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=2e-5)
        a, b = tree_leaves(got_cache), jax.tree_util.tree_leaves(want_cache)
        assert len(a) == len(b)
        for x, y in zip(a, b):
            np.testing.assert_allclose(x.numpy(), np.asarray(y), rtol=0,
                                       atol=2e-5)

    agree(logits, j_logits, cache, j_cache)
    j_cache = j_serve.extend_caches(j_cache, jc, steps)
    cache = t_serve.extend_caches(cache, tc, steps)
    tok = np.asarray(jnp.argmax(j_logits, -1)).astype(np.int32)[:, None]
    for s in range(steps):
        j_logits, j_cache = j_tfm.decode_step(jp, jnp.asarray(tok), j_cache,
                                              jnp.int32(S + s), jc)
        with torch.no_grad():
            logits, cache = tfm.decode_step(tp, torch.from_numpy(tok), cache,
                                            S + s, tc)
        agree(logits, j_logits, cache, j_cache)
        tok = np.asarray(jnp.argmax(j_logits, -1)).astype(np.int32)[:, None]


def test_split_cuts_positions_on_axis_1():
    pos = torch.from_numpy(grid_positions(4, 2, 2, 2, 1))
    tokens = torch.zeros((4, pos.shape[-1]), dtype=torch.int32)
    parts = tstep._split("positions", pos, 2)
    assert [tuple(p.shape) for p in parts] == [(3, 2, pos.shape[-1])] * 2
    assert torch.equal(torch.cat(parts, dim=1), pos)
    assert [tuple(p.shape) for p in tstep._split("tokens", tokens, 2)] == \
        [(2, pos.shape[-1])] * 2
    with pytest.raises(ValueError, match="does not split"):
        tstep._split("positions", pos, 3)


def test_train_step_at_two_microbatches_matches_reference():
    """Three AdamW steps with clipping and the signature, each batch's
    (3, B, S) positions cut into two microbatches on axis 1."""
    jc, tc = _configs(vocab=128)
    np_params = _weights(jc)
    ref_step, ref_opt = jstep.make_train_step(
        jc, runtime=JRuntime(want_signature=True), clip_norm=1.0,
        microbatches=2)
    got_step, got_opt = tstep.make_train_step(
        tc, runtime=Runtime(want_signature=True), clip_norm=1.0,
        microbatches=2)
    jp = jax.tree_util.tree_map(jnp.asarray, np_params)
    tp = params_from_numpy(np_params, "cpu")
    js, ts = ref_opt.init(jp), got_opt.init(tp)
    ref_step = jax.jit(ref_step)
    for i in range(3):
        batch = _batch(jc, B=4, seed=10 + i)
        jp, js, jm = ref_step(jp, js, {k: jnp.asarray(v)
                                       for k, v in batch.items()})
        tp, ts, tm = got_step(tp, ts, {k: torch.from_numpy(v)
                                       for k, v in batch.items()})
        for key in ("loss", "ce_loss", "grad_norm"):
            assert float(tm[key]) == pytest.approx(float(jm[key]), abs=1e-5)
        S = batch["tokens"].shape[1]
        np.testing.assert_allclose(tm["signature"].numpy(),
                                   np.asarray(jm["signature"]), rtol=0,
                                   atol=1 / (2 * S) + 1e-7)
    for a, b in zip(tree_leaves(tp), jax.tree_util.tree_leaves(jp)):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), rtol=0,
                                   atol=3e-5)

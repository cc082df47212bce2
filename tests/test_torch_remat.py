"""``Runtime.remat``: each period of a training forward under autograd
runs under ``torch.utils.checkpoint``, as the reference wraps its scanned
period in ``jax.checkpoint``.

* the loss, ``moe_aux`` and every float32 gradient with remat equal those
  without it bit for bit, for each block kind: attention (internlm2, and
  gemma2's local and global layers with a window of 5 that bites), Jamba's
  attention, Mamba and MoE layers (capacity drops included: the recompute
  routes as the first forward did), the ``(mlstm, slstm)`` xLSTM period,
  MLA and whisper's decoder over its encoder;
* two configs' train steps with remat against the reference's
  ``make_train_step`` with its default ``Runtime`` (remat on), at
  ``tests/test_torch_train.py``'s tolerances: gemma2 at its dense 1e-5,
  xLSTM at its 3e-5 for AdamW's division by ``sqrt(v) + eps``, which
  carries float32 noise of small gradient entries into the update
  (measured 1.64e-5 on the first mLSTM's ``down_proj``, the same with
  remat off on both sides);
* the checkpoint engages: each layer's forward runs twice a training
  step with remat, once without it, and once under ``no_grad``, inference
  mode, a prefill, a decode step, ``torch.func.vmap`` and the cohort
  engine's batched training, whose window still equals its sequential
  calls at ``tests/test_torch_lm_cohort.py``'s 1e-6.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.configs import reduced as j_reduced  # noqa: E402
from repro.configs.base import LayerSpec as JLayerSpec  # noqa: E402
from repro.configs.base import Stage as JStage  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.configs.base import LayerSpec, Stage  # noqa: E402
from repro_torch.core.aggregate import tree_leaves, tree_map  # noqa: E402
from repro_torch.fl import cohort  # noqa: E402
from repro_torch.fl.backend import LMBackend  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.runtime import Runtime  # noqa: E402
from test_torch_baselines import few_torch_threads  # noqa: E402,F401
from test_torch_train import _train_steps_agree  # noqa: E402

VOCAB, B, S = 128, 2, 32
# each family: (arch, the period's blocks as (kind, window, ffn), repeats);
# None keeps the reduced config's own stages
FAMILIES = {
    "internlm2": ("internlm2-1.8b", None, 2),
    "gemma2": ("gemma2-2b", (("attn", 5, "dense"), ("attn", -1, "dense")), 2),
    "jamba_moe": ("jamba-v0.1-52b", (("attn", -1, "dense"),
                                     ("mamba", -1, "moe")), 2),
    "xlstm": ("xlstm-125m", (("mlstm", -1, "none"), ("slstm", -1, "none")),
              2),
    "mla": ("deepseek-v2-236b", None, None),
    "whisper": ("whisper-medium", None, None),
}


def _config(family, jax_side=False):
    arch, blocks, repeats = FAMILIES[family]
    spec, stage = (JLayerSpec, JStage) if jax_side else (LayerSpec, Stage)
    cfg = (j_reduced(j_get_config(arch), d_model=64) if jax_side
           else reduced(get_config(arch), d_model=64))
    if blocks is not None:
        cfg = dataclasses.replace(
            cfg, n_layers=len(blocks) * repeats, stages=(stage(tuple(
                spec(kind=k, window=w, ffn=f) for k, w, f in blocks),
                repeats),))
    elif repeats is not None:
        cfg = dataclasses.replace(cfg, n_layers=repeats, stages=(stage(
            cfg.stages[0].pattern, repeats),))
    if cfg.encoder is not None:
        cfg = dataclasses.replace(cfg, encoder=dataclasses.replace(
            cfg.encoder, n_ctx=16, n_layers=2))
    return dataclasses.replace(cfg, vocab_size=VOCAB)


def _batch(cfg, seed=1):
    rng = np.random.default_rng(seed)
    toks = torch.from_numpy(rng.integers(0, VOCAB, (B, S + 1))
                            .astype(np.int32))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.encoder is not None:
        batch["enc_embed"] = torch.from_numpy(rng.normal(
            0, 1, (B, cfg.encoder.n_ctx, cfg.d_model)).astype(np.float32))
    return batch


def _params(cfg, seed=0):
    return tfm.init_params(torch.Generator().manual_seed(seed), cfg)


class LayerCount:
    """Counts the decoder's (causal) ``_layer_forward`` calls in ``n`` and
    the periods run under ``torch.utils.checkpoint`` in ``periods``."""

    def __init__(self, monkeypatch):
        self.n = self.periods = 0
        layer, ckpt = tfm._layer_forward, tfm.checkpoint

        def counted(*a, **kw):
            self.n += kw.get("causal", True)
            return layer(*a, **kw)

        def checkpointed(fn, *a, **kw):
            self.periods += fn.__name__ == "period"
            return ckpt(fn, *a, **kw)
        monkeypatch.setattr(tfm, "_layer_forward", counted)
        monkeypatch.setattr(tfm, "checkpoint", checkpointed)

    def reset(self):
        self.n = self.periods = 0


def _grads(cfg, params, batch, remat):
    p = tree_map(lambda a: a.detach().clone().requires_grad_(True), params)
    loss, aux = tfm.loss_fn(p, batch, cfg, Runtime(remat=remat))
    loss.backward()
    return loss.detach(), aux["moe_aux"].detach(), [a.grad for a in
                                                    tree_leaves(p)]


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_remat_gradients_equal_bit_for_bit(monkeypatch, family):
    cfg = _config(family)
    params, batch = _params(cfg), _batch(cfg)
    count = LayerCount(monkeypatch)
    runs = {}
    for remat in (False, True):
        count.reset()
        runs[remat] = _grads(cfg, params, batch, remat)
        runs[remat] += (count.n, count.periods)
    (loss, maux, grads, n_plain, p_plain), (
        loss_r, maux_r, grads_r, n_remat, p_remat) = runs[False], runs[True]
    assert torch.equal(loss, loss_r) and torch.isfinite(loss)
    assert torch.equal(maux, maux_r)
    if cfg.moe is not None:
        assert float(maux) > 0.0
    assert len(grads) == len(grads_r) == len(tree_leaves(params))
    for a, b in zip(grads, grads_r):
        assert a is not None and torch.equal(a, b)
    # each layer's forward, and once more in its period's backward
    assert n_plain == cfg.n_layers and n_remat == 2 * cfg.n_layers
    assert p_plain == 0
    assert p_remat == sum(stage.repeats for stage in cfg.stages)


@pytest.mark.parametrize("family,atol", [("gemma2", 1e-5),
                                         ("xlstm", 3e-5)])
def test_train_steps_with_remat_match_reference(family, atol):
    """Three AdamW steps of the port (default runtime: remat on) against
    the reference's jitted steps (its default: remat on)."""
    assert Runtime().remat
    _train_steps_agree(_config(family, jax_side=True), _config(family), 1,
                       atol=atol)


def _forward_once(cfg, params, batch, how):
    if how == "no_grad":
        with torch.no_grad():
            tfm.loss_fn(params, batch, cfg)
    elif how == "inference_mode":
        with torch.inference_mode():
            tfm.loss_fn(params, batch, cfg)
    elif how == "prefill":
        tfm.prefill(params, batch, cfg)[0].sum().backward()
    elif how == "decode":               # updates its caches in place
        with torch.no_grad():
            tfm.decode_step(params, batch["tokens"][:, :1],
                            tfm.init_cache(cfg, B, S), 0, cfg)
    elif how == "vmap":
        stacked = tree_map(lambda a: torch.stack([a, a]).detach()
                           .requires_grad_(True), params)

        def one(p, t):
            return tfm.loss_fn(p, {"tokens": t, "labels": t}, cfg)[0]
        torch.func.vmap(one)(stacked, torch.stack(
            [batch["tokens"]] * 2)).sum().backward()
        assert all(a.grad is not None for a in tree_leaves(stacked))


@pytest.mark.parametrize("how", ["no_grad", "inference_mode", "prefill",
                                 "decode", "vmap"])
def test_checkpoint_stays_off_without_a_tracked_training_forward(
        monkeypatch, how):
    cfg = _config("jamba_moe")
    params = tree_map(lambda a: a.requires_grad_(True), _params(cfg))
    count = LayerCount(monkeypatch)
    _forward_once(cfg, params, _batch(cfg), how)
    # the decode step has its own block function: no full-sequence layer
    assert count.n == (0 if how == "decode" else cfg.n_layers)
    assert count.periods == 0


def test_cohort_window_trains_without_remat_and_equals_sequential(
        monkeypatch):
    """The engine's vmapped training runs each layer once a step; the
    sequential ``train_local`` (remat on) twice; the trained models and
    losses agree at the LM cohort suite's 1e-6."""
    cfg = _config("internlm2")
    backend = LMBackend(cfg, device="cpu", lr=5e-3, local_steps=2,
                        batch_size=4, seq_len=37)
    engine = cohort.CohortBackend(backend)
    assert engine.programs.train_runtime == Runtime(remat=False)
    rng = np.random.default_rng(0)
    streams = [rng.integers(0, VOCAB, 3000).astype(np.int32)
               for _ in range(2)]
    starts, seeds = [_params(cfg, s) for s in range(2)], [7, 8]
    count = LayerCount(monkeypatch)
    models, losses = engine.train_cohort(starts, streams, seeds)
    assert count.n == 2 * cfg.n_layers           # one forward a step
    assert count.periods == 0
    for k in range(2):
        count.reset()
        solo, loss = backend.train_local(starts[k], streams[k],
                                         seed=seeds[k])
        assert count.n == 2 * 2 * cfg.n_layers   # and its recompute
        assert count.periods == 2 * cfg.stages[0].repeats
        for a, b in zip(tree_leaves(solo), tree_leaves(models[k])):
            torch.testing.assert_close(a, b, rtol=0, atol=1e-6)
        assert losses[k] == pytest.approx(loss, abs=1e-6)

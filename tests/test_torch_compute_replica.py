"""The compute replica (``repro_torch.weights``): a model whose leaves that
every use casts to the compute type rest in it gives the float32 tree's
results bit for bit, for every family the port ships.

Families, each at ``reduced`` widths (d_model 64) in its full config's
compute and cache type, bfloat16: dense GQA with QKV biases (qwen2-7b),
MoE with a shared expert (llama4-maverick's ``(attn, dense), (attn,
moe)``), the hybrid (Jamba's ``(attn, dense), (mamba, moe)`` cut), xLSTM
(one ``(mlstm, slstm)`` period), MLA (deepseek-v2's MoE layer) and
whisper (an encoder and cross-attention).  Weights from a torch seed;
every comparison is ``torch.equal``:

* the tip-selection forwards (``LMBackend.evaluate`` and ``signature``,
  and the logits and signature of their ``mode="prefill"`` forward on the
  kernels' plain versions), the prefill and 4 greedy decode steps
  (logits, tokens and caches);
* the drawing form against the cast tree, leaf by leaf with dtypes;
* the leaves that stay float32, named here per family.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.configs.base import LayerSpec, Stage  # noqa: E402
from repro_torch.core.aggregate import tree_leaves  # noqa: E402
from repro_torch.fl.backend import LMBackend  # noqa: E402
from repro_torch.launch import serve as launch  # noqa: E402
from repro_torch.models import layers  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.runtime import Runtime  # noqa: E402
from repro_torch.sharding.rules import leaves_with_path  # noqa: E402
from repro_torch.weights import (compute_replica,  # noqa: E402
                                 draw_compute_replica)

B, PROMPT, STEPS = 2, 16, 5          # a prefill and 4 decode steps

# family: (arch, the pattern of its one-period cut, or None for reduced's)
FAMILIES = {
    "dense_gqa": ("qwen2-7b", None),
    "moe_shared": ("llama4-maverick-400b-a17b", None),
    "hybrid": ("jamba-v0.1-52b", (LayerSpec(kind="attn", ffn="dense"),
                                  LayerSpec(kind="mamba", ffn="moe"))),
    "xlstm": ("xlstm-125m", (LayerSpec(kind="mlstm", ffn="none"),
                             LayerSpec(kind="slstm", ffn="none"))),
    "mla": ("deepseek-v2-236b", None),
    "whisper": ("whisper-medium", None),
}
# the leaves that stay float32: some use reads them in float32
FLOAT32_LEAVES = {
    "dense_gqa": {"scale"},
    "moe_shared": {"scale"},
    "hybrid": {"scale", "dt_proj", "dt_bias", "A_log", "D"},
    "xlstm": {"scale", "bias", "b_if", "w_gates", "r_gates", "b_gates"},
    "mla": {"scale"},
    "whisper": {"scale", "bias"},
}


def _config(family):
    arch, pattern = FAMILIES[family]
    full = get_config(arch)
    cfg = dataclasses.replace(reduced(full, d_model=64),
                              compute_dtype=full.compute_dtype,
                              cache_dtype=full.cache_dtype)
    if pattern is not None:
        cfg = dataclasses.replace(cfg, n_layers=2,
                                  stages=(Stage(pattern, 1),))
    assert cfg.compute_dtype == "bfloat16"
    return cfg


def _trees(family):
    cfg = _config(family)
    params = tfm.init_params(torch.Generator().manual_seed(0), cfg)
    return cfg, params, compute_replica(params, cfg)


def _batch(cfg, rows, seq, seed=1):
    rng = np.random.default_rng(seed)
    batch = {"tokens": torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (rows, seq)).astype(np.int32))}
    if cfg.encoder is not None:
        batch["enc_embed"] = torch.from_numpy(rng.normal(
            0, 0.1, (rows, cfg.encoder.n_ctx, cfg.d_model)).astype(
                np.float32))
    return batch


def _equal(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and torch.equal(x, y)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_tip_selection_forwards_are_bit_equal(family):
    """The eval and signature forward (``mode="prefill"``, the kernels'
    plain versions on the CPU) and ``LMBackend.evaluate`` and
    ``signature`` give the float32 tree's logits, signature, accuracy
    and signature fractions."""
    cfg, params, replica = _trees(family)
    batch = _batch(cfg, B, 24)
    rt = Runtime(use_kernels=True, want_signature=True)
    with torch.inference_mode():
        want = tfm.forward(params, batch, cfg, rt, mode="prefill")
        got = tfm.forward(replica, batch, cfg, rt, mode="prefill")
    assert torch.equal(got[0], want[0])
    assert torch.equal(got[1]["signature"], want[1]["signature"])
    if cfg.encoder is None:        # the backend feeds no frames
        backend = LMBackend(cfg, batch_size=B, seq_len=24, device="cpu")
        stream = np.random.default_rng(2).integers(
            0, cfg.vocab_size, 500).astype(np.int32)
        assert (backend.evaluate(replica, stream)
                == backend.evaluate(params, stream))
        np.testing.assert_array_equal(backend.signature(replica, stream),
                                      backend.signature(params, stream))


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_prefill_and_decode_are_bit_equal(family):
    """A prefill and 4 greedy decode steps (``launch.serve``'s loop) give
    the float32 tree's logits, tokens and caches."""
    cfg, params, replica = _trees(family)
    batch = _batch(cfg, B, PROMPT)
    prefill, decode = launch.make_serving_fns(cfg)
    want = launch.greedy_decode(prefill, decode, cfg, params, batch, STEPS,
                                keep_logits=True)
    got = launch.greedy_decode(prefill, decode, cfg, replica, batch, STEPS,
                               keep_logits=True)
    assert torch.equal(got["logits"], want["logits"])
    assert torch.equal(got["tokens"], want["tokens"])
    _equal(got["caches"], want["caches"])


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_drawing_form_equals_the_cast_tree(family):
    """``draw_compute_replica`` draws ``compute_replica(init_params(...))``
    bit for bit, leaf by leaf with its dtype, and leaves the parameter
    type to later draws."""
    cfg = _config(family)
    drawn = draw_compute_replica(torch.Generator().manual_seed(0), cfg)
    assert layers.AT_USE_DTYPE.get() is None
    cast = compute_replica(
        tfm.init_params(torch.Generator().manual_seed(0), cfg), cfg)
    assert ([p for p, _ in leaves_with_path(drawn)]
            == [p for p, _ in leaves_with_path(cast)])
    _equal(drawn, cast)
    again = tfm.init_params(torch.Generator().manual_seed(0), cfg)
    assert all(a.dtype == torch.float32 for a in tree_leaves(again))


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_the_float32_leaves_are_named(family):
    """Every leaf rests in the compute type but those named in
    FLOAT32_LEAVES, which ``compute_replica`` hands back as the same
    tensors."""
    cfg, params, replica = _trees(family)
    kept = {p[-1] for p, a in leaves_with_path(replica)
            if a.dtype == torch.float32}
    assert kept == FLOAT32_LEAVES[family]
    assert all(a.dtype == torch.bfloat16 for p, a in leaves_with_path(replica)
               if p[-1] not in FLOAT32_LEAVES[family])
    before = dict(leaves_with_path(params))
    for path, leaf in leaves_with_path(replica):
        if path[-1] in FLOAT32_LEAVES[family]:
            assert leaf is before[path]

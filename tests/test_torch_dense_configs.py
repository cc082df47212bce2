"""gemma2-2b and qwen2-7b whole, qwen2-7b's training cut, and
xlstm-125m's one-period cut, as ``chip_smoke.py`` runs them on the card
(``dense_configs_path``; the xLSTM loop and cohort paths): the port's
trees, built shape-only under ``FakeTensorMode``, equal the
reference's ``jax.eval_shape(init_params)`` leaf by leaf (paths, shapes,
dtypes), and their counts equal ``chip_smoke``'s constants and its
``tree_param_count``.  ``ArchConfig.param_count()`` leaves out gemma2's
122,112 norm weights (2,304 x 53) and qwen2's 333,312 norm weights and
QKV biases (3,584 x 57 + 4,608 x 28).
"""
import dataclasses
import importlib.util
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
from torch._subclasses.fake_tensor import FakeTensorMode  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.configs.base import Stage as JStage  # noqa: E402
from repro.models import transformer as j_tfm  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
# arch: (leaves counted, what param_count() leaves out)
WHOLE = {"gemma2-2b": (2_614_222_080, 122_112),
         "qwen2-7b": (7_615_616_512, 333_312)}


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _paths(tree, prefix=""):
    """(keystr path, shape, dtype) of every leaf, as jax.tree_util names
    them."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree)
                for leaf in _paths(tree[k], f"{prefix}['{k}']")]
    if isinstance(tree, (list, tuple)):
        return [leaf for i, v in enumerate(tree)
                for leaf in _paths(v, f"{prefix}[{i}]")]
    return [(prefix, tuple(tree.shape), str(tree.dtype).split(".")[-1])]


def _port_tree(cfg):
    with FakeTensorMode():
        return _paths(tfm.init_params(torch.Generator(), cfg))


def _reference_tree(cfg):
    shapes = jax.eval_shape(lambda k: j_tfm.init_params(k, cfg),
                            jax.random.PRNGKey(0))
    return [(jax.tree_util.keystr(path), tuple(a.shape), str(a.dtype))
            for path, a in jax.tree_util.tree_leaves_with_path(shapes)]


def _count(leaves):
    return sum(int(torch.Size(shape).numel()) for _, shape, _ in leaves)


@pytest.mark.parametrize("arch", sorted(WHOLE))
def test_whole_tree_equals_reference_leaf_by_leaf(arch):
    cfg = get_config(arch)
    got, want = _port_tree(cfg), _reference_tree(j_get_config(arch))
    assert sorted(got) == sorted(want)
    count, left_out = WHOLE[arch]
    assert _count(got) == count
    assert count - cfg.param_count() == left_out
    cs = _chip_smoke()
    assert cs.tree_param_count(cfg) == count
    assert {"gemma2-2b": cs.GEMMA2_PARAMS,
            "qwen2-7b": cs.QWEN2_PARAMS}[arch] == count
    assert {"gemma2-2b": cs.gemma2_config,
            "qwen2-7b": cs.qwen2_config}[arch]() == cfg


def _cut(cfg, stage_cls, layers):
    """``cfg`` cut to ``layers`` layers: whole periods of its first
    stage's pattern."""
    pattern = cfg.stages[0].pattern
    repeats = layers // len(pattern)
    return dataclasses.replace(cfg, n_layers=layers, stages=(
        stage_cls(pattern, repeats),))


@pytest.mark.parametrize("cut", ["qwen2_train", "xlstm_loop"])
def test_card_cuts_equal_reference_leaf_by_leaf(cut):
    """The card's depth cuts: qwen2-7b's training cut and xlstm-125m's
    one period (the loop and cohort paths), against the reference's
    config cut alike."""
    cs = _chip_smoke()
    cfg, want_count = {
        "qwen2_train": (cs.qwen2_train_config(), cs.QWEN2_TRAIN_PARAMS),
        "xlstm_loop": (cs.xlstm_loop_config(), cs.XLSTM_LOOP_PARAMS)}[cut]
    arch = {"qwen2_train": "qwen2-7b", "xlstm_loop": "xlstm-125m"}[cut]
    whole = get_config(arch)
    assert cfg == _cut(whole, type(whole.stages[0]), cfg.n_layers)
    assert cfg.n_layers < whole.n_layers
    got = _port_tree(cfg)
    want = _reference_tree(_cut(j_get_config(arch), JStage, cfg.n_layers))
    assert sorted(got) == sorted(want)
    assert _count(got) == cs.tree_param_count(cfg) == want_count
    if cut == "qwen2_train":
        # the embedding and unembedding, the final norm, and each layer's
        per_layer = (WHOLE["qwen2-7b"][0] - 2 * 152_064 * 3_584 - 3_584) \
            // 28
        assert per_layer == 233_057_792
        assert want_count == (2 * 152_064 * 3_584 + 3_584
                              + cs.QWEN2_TRAIN_LAYERS * per_layer)

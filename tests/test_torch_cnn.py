"""The port's CNN path against the JAX reference, from the same weights.

The JAX initialisation is carried over through numpy with
``params_from_numpy``: torch cannot reproduce JAX's PRNG bits, and both
frameworks must start from identical weights for their outputs to be
comparable.  Tolerances and their reasons:

* logits: float32, rtol 1e-5 / atol 1e-5 -- the two frameworks' convolutions
  reduce in another order;
* per-sample zero fractions: bit-equal -- the Eq. 3 counts are exact and
  normalised with the same float32 multiply;
* batch-mean signature: bit-equal where it holds, else rtol 1e-6 -- the
  mean sums non-integer fractions over samples, and that sum depends on
  the order;
* one local epoch of SGD: rtol 1e-4 / atol 1e-5 -- each step's gradients
  differ in the last bits, and six momentum steps carry that forward.
"""
import dataclasses
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import repro.kernels.ops as j_ops  # noqa: E402
import repro_torch.kernels.ops as t_ops  # noqa: E402
from repro.configs.cnn import VGG16 as J_VGG16  # noqa: E402
from repro.configs.cnn import vgg_for as j_vgg_for  # noqa: E402
from repro.core.aggregate import tree_size_bytes as j_size  # noqa: E402
from repro.data.synthetic import make_benchmark_dataset, split_811  # noqa: E402
from repro.fl.backend import CNNBackend as JBackend  # noqa: E402
from repro.models.cnn import cnn_forward as j_forward  # noqa: E402
from repro.models.cnn import init_cnn as j_init  # noqa: E402
from repro_torch.configs.cnn import VGG16, vgg_for  # noqa: E402
from repro_torch.core.aggregate import tree_leaves, tree_size_bytes  # noqa: E402
from repro_torch.fl.backend import CNNBackend  # noqa: E402
from repro_torch.models.cnn import cnn_forward, init_cnn  # noqa: E402
from repro_torch.weights import params_from_numpy, params_to_numpy  # noqa: E402

DATASETS = ["mnist", "cifar10"]   # VGG_TINY at 1 and 3 input channels


def _jax_params(dataset, seed=0):
    params = j_init(jax.random.PRNGKey(seed), j_vgg_for(dataset))
    return jax.tree_util.tree_map(np.array, params)       # writable copies


def _capture(monkeypatch, module):
    """Record what ``module.signature_per_channel`` returns."""
    seen = []
    inner = module.signature_per_channel

    def spy(*args, **kwargs):
        out = inner(*args, **kwargs)
        seen.append(np.asarray(out))
        return out

    monkeypatch.setattr(module, "signature_per_channel", spy)
    return seen


@pytest.mark.parametrize("dataset", DATASETS)
def test_forward_and_signatures_match_reference(dataset, monkeypatch):
    cfg = vgg_for(dataset)
    np_params = _jax_params(dataset)
    x = make_benchmark_dataset(dataset, 48).x
    j_rows = _capture(monkeypatch, j_ops)
    t_rows = _capture(monkeypatch, t_ops)
    j_logits, j_sig = j_forward(jax.tree_util.tree_map(jnp.asarray,
                                                       np_params),
                                jnp.asarray(x), j_vgg_for(dataset),
                                want_signature=True, kernel_policy="interpret")
    with torch.no_grad():
        t_logits, t_sig = cnn_forward(params_from_numpy(np_params, "cpu"),
                                      torch.from_numpy(x), cfg,
                                      want_signature=True)
    np.testing.assert_allclose(t_logits.numpy(), np.asarray(j_logits),
                               rtol=1e-5, atol=1e-5)
    assert len(j_rows) == len(t_rows) == 1
    assert j_rows[0].shape == t_rows[0].shape == (48, cfg.conv_stacks[0][1])
    assert np.array_equal(j_rows[0], t_rows[0])
    j_sig, t_sig = np.asarray(j_sig), t_sig.numpy()
    if not np.array_equal(j_sig, t_sig):
        np.testing.assert_allclose(t_sig, j_sig, rtol=1e-6, atol=0)


def test_flatten_is_nhwc():
    """VGG_TINY's last feature map is 4x4x32: an NCHW flatten would feed
    the dense layer permuted features.  Shuffling one position's channels
    must move the logits exactly as the NHWC order says."""
    cfg = vgg_for("cifar10")
    params = params_from_numpy(_jax_params("cifar10"), "cpu")
    x = torch.from_numpy(make_benchmark_dataset("cifar10", 4).x)
    with torch.no_grad():
        base, _ = cnn_forward(params, x, cfg)
        w = params["fcs"][0]["w"]
        # feature index (h, w, c) of the NHWC flatten is (h*4 + w)*32 + c
        w[(1 * 4 + 2) * 32 + 5].zero_()
        moved, _ = cnn_forward(params, x, cfg)
    assert not torch.equal(base, moved)
    np_ref = _jax_params("cifar10")
    np_ref["fcs"][0]["w"][(1 * 4 + 2) * 32 + 5] = 0.0
    j_logits, _ = j_forward(jax.tree_util.tree_map(jnp.asarray, np_ref),
                            jnp.asarray(x.numpy()), j_vgg_for("cifar10"))
    np.testing.assert_allclose(moved.numpy(), np.asarray(j_logits),
                               rtol=1e-5, atol=1e-5)


def _client(dataset):
    ds = make_benchmark_dataset(dataset, n_samples=300, seed=3)
    return split_811(ds, seed=1)


@pytest.mark.parametrize("dataset", DATASETS)
def test_train_evaluate_signature_match_reference(dataset):
    np_params = _jax_params(dataset, seed=1)
    splits = _client(dataset)
    jb = JBackend(j_vgg_for(dataset), local_epochs=1, batch_size=32)
    tb = CNNBackend(vgg_for(dataset), local_epochs=1, batch_size=32,
                    device="cpu")
    j_new, j_loss = jb.train_local(
        jax.tree_util.tree_map(jnp.asarray, np_params), splits["train"],
        seed=5)
    start = params_from_numpy(np_params, "cpu")
    t_new, t_loss = tb.train_local(start, splits["train"], seed=5)
    # the caller's model is left as it was
    for a, b in zip(tree_leaves(start),
                    jax.tree_util.tree_leaves(np_params)):
        assert np.array_equal(a.numpy(), b)
    for a, b in zip(jax.tree_util.tree_leaves(j_new), tree_leaves(t_new)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a),
                                   rtol=1e-4, atol=1e-5)
    assert abs(t_loss - j_loss) < 1e-4
    # evaluation and signature from the SAME trained weights
    same = params_from_numpy(jax.tree_util.tree_map(np.asarray, j_new),
                             "cpu")
    for split in ("val", "train"):
        n = min(len(splits[split]), 512)
        j_acc = jb.evaluate(j_new, splits[split])
        t_acc = tb.evaluate(same, splits[split])
        # an argmax may flip on a logit near-tie (logits agree to 1e-5)
        assert abs(t_acc - j_acc) <= 1.0 / n + 1e-7
    j_sig = jb.signature(j_new, splits["train"])
    t_sig = tb.signature(same, splits["train"])
    assert isinstance(t_sig, np.ndarray) and t_sig.shape == j_sig.shape
    if not np.array_equal(j_sig, t_sig):
        np.testing.assert_allclose(t_sig, j_sig, rtol=1e-6, atol=0)


def test_batches_match_reference_draws():
    """``_batches`` must make the reference's numpy draws, including the
    tiny-shard branch that samples one batch with repetition."""
    splits = _client("mnist")
    jb = JBackend(j_vgg_for("mnist"), batch_size=32)
    tb = CNNBackend(vgg_for("mnist"), batch_size=32, device="cpu")
    tiny = dataclasses.replace(splits["val"], x=splits["val"].x[:5],
                               y=splits["val"].y[:5])
    for ds in (splits["train"], tiny):
        rj, rt = np.random.default_rng(9), np.random.default_rng(9)
        for _ in range(2):
            jx, jy = jb._batches(ds, rj)
            tx, ty = tb._batches(ds, rt)
            assert np.array_equal(np.asarray(jx), tx)
            assert np.array_equal(np.asarray(jy), ty)


@pytest.mark.parametrize("momentum", [0.0, 0.9])
def test_sgd_matches_reference(momentum):
    """Three steps from the same grads.  Both sides run op by op (the
    reference's update is not jitted here), so the float32 bits agree."""
    from repro.optim.optimizers import apply_updates as j_apply
    from repro.optim.optimizers import sgd as j_sgd
    from repro_torch.optim.optimizers import apply_updates, sgd
    rng = np.random.default_rng(int(momentum * 10))
    params = {"w": [rng.normal(size=(4, 3)).astype(np.float32)],
              "b": rng.normal(size=5).astype(np.float32)}
    grads = [jax.tree_util.tree_map(
        lambda a: rng.normal(size=a.shape).astype(np.float32), params)
        for _ in range(3)]
    j_opt, t_opt = j_sgd(0.05, momentum), sgd(0.05, momentum)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    tp = params_from_numpy(params, "cpu")
    js, ts = j_opt.init(jp), t_opt.init(tp)
    for g in grads:
        upd, js = j_opt.update(jax.tree_util.tree_map(jnp.asarray, g), js, jp)
        jp = j_apply(jp, upd)
        tupd, ts = t_opt.update(params_from_numpy(g, "cpu"), ts, tp)
        apply_updates(tp, tupd)
    assert ts["step"] == int(js["step"]) == 3
    for a, b in zip(jax.tree_util.tree_leaves(jp), tree_leaves(tp)):
        assert np.array_equal(np.asarray(a), b.numpy())


def test_vgg16_size_matches_reference():
    """``tree_size_bytes`` sets the simulated transfer times, and so the
    event order: it must be the reference's integer."""
    shapes = jax.eval_shape(lambda k: j_init(k, J_VGG16),
                            jax.random.PRNGKey(0))
    ref = j_size(shapes)
    params = init_cnn(torch.Generator().manual_seed(0), VGG16)
    assert tree_size_bytes(params) == ref
    n_params = sum(p.numel() for p in tree_leaves(params))
    assert 33_000_000 < n_params < 34_000_000          # about 33.6 M


def test_weights_round_trip_bit_exact():
    np_params = _jax_params("cifar10")
    read_only = jax.tree_util.tree_map(
        lambda a: np.asarray(jnp.asarray(a)), np_params)
    assert not jax.tree_util.tree_leaves(read_only)[0].flags.writeable
    with warnings.catch_warnings():
        warnings.simplefilter("error")            # no non-writable warning
        params = params_from_numpy(read_only, "cpu")
    back = params_to_numpy(params)
    assert (jax.tree_util.tree_structure(back)
            == jax.tree_util.tree_structure(np_params))
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(np_params)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    # the port's copy does not share memory with the numpy source
    leaf = tree_leaves(params)[0]
    leaf.add_(1.0)
    assert np.array_equal(jax.tree_util.tree_leaves(read_only)[0],
                          jax.tree_util.tree_leaves(np_params)[0])

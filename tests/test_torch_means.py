"""Means that reach the ledger, bit for bit against the JAX reference.

The reference's ``jnp.mean`` runs under ``jax.jit``, and XLA compiles it
into a float32 sum multiplied by the float32 reciprocal of the count.  A
true division gives another float32 on many counts (at n = 47, 47 correct
predictions give 1.0 by division and 0.99999994 in the reference).  The
digest rounds accuracies and signatures to 8 places, so such a bit can
change an Eq. 7 hash.  These tests hold the port's accuracy and the
signature's sample mean to the reference's bits, on counts chosen where
division and the reciprocal multiply disagree.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.configs.cnn import vgg_for as j_vgg_for  # noqa: E402
from repro.data.synthetic import make_benchmark_dataset  # noqa: E402
from repro.fl.backend import CNNBackend as JBackend  # noqa: E402
from repro.models.cnn import cnn_forward as j_forward  # noqa: E402
from repro.models.cnn import init_cnn as j_init  # noqa: E402
from repro_torch.configs.cnn import vgg_for  # noqa: E402
from repro_torch.core.aggregate import f32_mean  # noqa: E402
from repro_torch.fl.backend import CNNBackend  # noqa: E402
from repro_torch.weights import params_from_numpy  # noqa: E402


def _jax_params(seed=0):
    params = j_init(jax.random.PRNGKey(seed), j_vgg_for("mnist"))
    return jax.tree_util.tree_map(np.array, params)


def _division_differs(k: int, n: int) -> bool:
    return (np.float32(k) / np.float32(n)
            != np.float32(k) * (np.float32(1) / np.float32(n)))


@pytest.mark.parametrize("n,k", [(47, 47), (100, 99), (500, 498)])
def test_cnn_accuracy_equals_reference_bits(n, k):
    assert _division_differs(k, n)
    np_params = _jax_params()
    ds = make_benchmark_dataset("mnist", n, seed=4)
    logits, _ = j_forward(jax.tree_util.tree_map(jax.numpy.asarray,
                                                 np_params),
                          ds.x, j_vgg_for("mnist"))
    pred = np.asarray(logits).argmax(-1).astype(ds.y.dtype)
    labels = np.where(np.arange(n) < k, pred, (pred + 1) % 10)
    ds = type(ds)(ds.x, labels.astype(ds.y.dtype))
    j_acc = JBackend(j_vgg_for("mnist")).evaluate(
        jax.tree_util.tree_map(jax.numpy.asarray, np_params), ds)
    t_acc = CNNBackend(vgg_for("mnist"), device="cpu").evaluate(
        params_from_numpy(np_params, "cpu"), ds)
    assert np.float32(j_acc) == np.float32(k) * (np.float32(1)
                                                 / np.float32(n))
    assert np.float32(t_acc) == np.float32(j_acc), (t_acc, j_acc)


@pytest.mark.parametrize("n", [37, 100])
def test_signature_sample_mean_equals_reference_bits(n):
    np_params = _jax_params(seed=2)
    ds = make_benchmark_dataset("mnist", n, seed=5)
    j_sig = JBackend(j_vgg_for("mnist")).signature(
        jax.tree_util.tree_map(jax.numpy.asarray, np_params), ds)
    t_sig = CNNBackend(vgg_for("mnist"), device="cpu").signature(
        params_from_numpy(np_params, "cpu"), ds)
    assert t_sig.shape == j_sig.shape
    assert np.array_equal(t_sig, j_sig), np.flatnonzero(t_sig != j_sig)


@pytest.mark.parametrize("n", [37, 100, 500])
def test_f32_mean_equals_jitted_jnp_mean(n):
    """Fractions k/1024 (VGG16's signature rows at 32x32) sum exactly in
    any order, so the mean's bits depend only on how it divides.  (For
    general float32 values XLA's CPU reduction adds in another order than
    torch's sum; see ROADMAP Queue 3.)"""
    k = np.random.default_rng(n).integers(0, 1025, (n, 64))
    x = k.astype(np.float32) * np.float32(1 / 1024)
    got = f32_mean(torch.from_numpy(x), dim=0)
    want = np.asarray(jax.jit(lambda a: jax.numpy.mean(a, axis=0))(x))
    assert np.array_equal(got.numpy(), want)
    assert not torch.equal(torch.from_numpy(x).sum(0) / n, got)
    flags = torch.arange(47) < 47
    assert f32_mean(flags).item() == np.float32(47) * (np.float32(1)
                                                       / np.float32(47))


@pytest.mark.parametrize("den", [784, 1000])
@pytest.mark.parametrize("n", [37, 100, 128, 500])
def test_f32_mean_follows_xla_order(n, den):
    """Fractions k/784 and k/1000 do not add exactly, so the mean's bits
    depend on the order of the column sums too: rows that are a program
    input add left to right in windows of 32 (``input_row_sum``), as
    XLA:CPU's tree reduction adds them, bit for bit with jitted
    ``jnp.mean``.  torch's own ``sum`` is off in some columns."""
    k = np.random.default_rng(n + den).integers(0, den + 1, (n, 64))
    x = k.astype(np.float32) * np.float32(1 / den)
    want = np.asarray(jax.jit(lambda a: jax.numpy.mean(a, axis=0))(x))
    got = f32_mean(torch.from_numpy(x), dim=0)
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(f32_mean(torch.from_numpy(x[:, 0])).numpy(),
                          want[0])
    torch_sum = torch.from_numpy(x).sum(0) * float(np.float32(1) / n)
    assert not np.array_equal(torch_sum.numpy(), want)

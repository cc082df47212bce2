"""The port's Eq. 3 signature path against the JAX reference.

The signatures decide which tips a client approves, so the port must
reproduce the reference's bits, not merely come close: every comparison
here is ``np.array_equal``.  The JAX side runs its Pallas kernel through the
interpreter (``interpret=True`` / ``policy="interpret"``), as the JAX
package's own tests do on the CPU; the port's side takes the plain PyTorch
version, because its inputs lie on the CPU.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as kops  # noqa: E402
from repro.kernels.signature import signature_td as jax_signature_td  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import signature as tsig  # noqa: E402


def _activations(rng, shape, tau=0.05):
    """ReLU-like values with many exact zeros, a negative zero, and values
    at and on either side of the float32 tau, where the |x| < tau band
    decides."""
    x = np.maximum(rng.normal(0.0, 0.2, shape), 0.0).astype(np.float32)
    flat = x.reshape(-1)
    t32 = np.float32(tau)
    edge = np.array([t32, np.nextafter(t32, np.float32(0)),
                     np.nextafter(t32, np.float32(1)), -t32, np.float32(-0.0)],
                    np.float32)
    pick = rng.choice(flat.size, size=min(flat.size, 4 * edge.size),
                      replace=False)
    flat[pick] = np.resize(edge, pick.size)
    return x


def _equal(ref, got):
    ref, got = np.asarray(ref), np.asarray(got)
    assert ref.dtype == got.dtype and ref.shape == got.shape
    assert np.array_equal(ref, got), (
        f"max |diff| {np.max(np.abs(ref - got))} over "
        f"{np.sum(ref != got)}/{ref.size} entries")


# T below, at and above the reference's 256-row block; odd T and C.
TD_CASES = [(1, 1, 0.0), (7, 5, 0.05), (255, 63, 0.0), (256, 64, 0.05),
            (257, 33, 0.0), (600, 17, 0.05), (1000, 63, 0.0)]


@pytest.mark.parametrize("T,C,tau", TD_CASES)
@pytest.mark.parametrize("mean", [False, True])
def test_signature_td_matches_jax_interpret(T, C, tau, mean):
    x = _activations(np.random.default_rng(T * 131 + C), (T, C))
    ref = jax_signature_td(jnp.asarray(x), tau=tau, mean=mean,
                           interpret=True)
    _equal(ref, tsig.signature_td(torch.from_numpy(x), tau=tau, mean=mean))


@pytest.mark.parametrize("N,T,C,tau", [(3, 1000, 63, 0.0),
                                       (2, 300, 64, 0.05),
                                       (4, 17, 9, 0.0)])
def test_signature_counts_matches_jax_vmap(N, T, C, tau):
    """The batched form folds the reference's vmap over samples."""
    x = _activations(np.random.default_rng(N + T + C), (N, T, C))
    ref = jax.vmap(lambda row: jax_signature_td(
        row, tau=tau, mean=False, interpret=True))(jnp.asarray(x))
    _equal(ref, tsig.signature_counts(torch.from_numpy(x), tau))


@pytest.mark.parametrize("shape,tau", [((5, 16, 16, 16), 0.0),
                                       ((3, 17, 15, 7), 0.0),
                                       ((2, 9, 31, 5), 0.05)])
def test_signature_per_channel_matches_jax(shape, tau):
    x = _activations(np.random.default_rng(sum(shape)), shape)
    ref = kops.signature_per_channel(jnp.asarray(x), tau=tau,
                                     policy="interpret")
    _equal(ref, tops.signature_per_channel(torch.from_numpy(x), tau=tau))
    # the reference's policies agree with each other bit for bit too
    _equal(kops.signature_per_channel(jnp.asarray(x), tau=tau,
                                      policy="reference"), ref)


def test_plain_path_launches_no_kernel():
    before = tsig.launches
    x = torch.from_numpy(_activations(np.random.default_rng(0), (2, 64, 8)))
    tsig.signature_counts(x, 0.0)
    tsig.signature_td(x[0], tau=0.05)
    tops.signature_per_channel(x.reshape(2, 8, 8, 8))
    assert tsig.launches == before

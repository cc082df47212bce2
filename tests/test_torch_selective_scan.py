"""The port's selective scan against the JAX reference.

``selective_scan_plain`` (what a CPU tensor takes, and what the CUDA kernel
is held against on the card) and ``selective_scan_split_plain`` (the CUDA
kernel's own arithmetic: powers of 2, y summed in two halves of the
states) are compared with
``repro.kernels.selective_scan.selective_scan_bsd`` run in interpret mode,
and the model's own chunked ``selective_scan_ref`` (the path local
training runs under autograd) with ``repro.models.mamba.selective_scan_ref``,
forward and gradient, on the same inputs drawn with numpy.

Tolerances and their reasons:

* outputs and states: the reference's own 1e-5 (rtol and atol,
  ``tests/test_kernels.py``); the two differ in the last bits of float32
  ``exp`` and in the order of the sum over N;
* gradients: within 1e-6 of each gradient's largest magnitude (measured:
  at most 4.5e-7 of it).  A gradient entry is a float32 sum over up to 600
  positions and batch rows, of magnitude up to about 150 here, so an
  absolute 1e-5 would ask for more digits than float32 sums of that size
  carry; entries near zero differ by more than 1e-5 relative for the same
  reason.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.selective_scan import selective_scan_bsd as j_scan  # noqa: E402
from repro.models import mamba as j_mamba  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import selective_scan as ss  # noqa: E402
from repro_torch.models import mamba  # noqa: E402

# tests/test_kernels.py SCAN_CASES (B, S, d_in, N, chunk), and two chunks
# of 256 with a ragged second one
CASES = [(1, 64, 8, 4, 64), (2, 100, 16, 8, 32), (3, 37, 4, 2, 16),
         (2, 300, 64, 16, 256)]
TOL = dict(rtol=1e-5, atol=1e-5)


def _inputs(B, S, d_in, N, seed=0):
    """As the reference's kernel tests draw them: dt through a softplus,
    A negative, a small non-zero h0."""
    rng = np.random.default_rng(seed)

    def normal(*shape):
        return rng.normal(size=shape).astype(np.float32)

    x = normal(B, S, d_in)
    dt = np.logaddexp(normal(B, S, d_in), 0).astype(np.float32)
    A = -np.exp(normal(d_in, N) * 0.5).astype(np.float32)
    Bc, Cc = normal(B, S, N), normal(B, S, N)
    h0 = normal(B, d_in, N) * np.float32(0.1)
    return x, dt, A, Bc, Cc, h0


def _wide_inputs(B, S, d_in, N, seed=0):
    """dt up to 8 and A down to -8, so that |dt*A| reaches 64: about twice
    the largest that ``chip_smoke.py``'s draw at the hybrid path's shape
    (softplus of N(0, 1) times exp of N(0, 1)/2, 8 x 512 x 8192 x 16)
    reaches, 32-36 in numpy draws of that distribution; the model's own
    dt (softplus around log(expm1(0.01))) and A (-1..-16) stay far
    below."""
    x, _, _, Bc, Cc, h0 = _inputs(B, S, d_in, N, seed)
    rng = np.random.default_rng(seed + 1)
    dt = rng.uniform(0.0, 8.0, (B, S, d_in)).astype(np.float32)
    A = -rng.uniform(0.5, 8.0, (d_in, N)).astype(np.float32)
    dt[0, :, 0] = 8.0
    A[0, 0] = -8.0
    return x, dt, A, Bc, Cc, h0


def _torch(arrays, requires_grad=False):
    return tuple(torch.from_numpy(a.copy()).requires_grad_(requires_grad)
                 for a in arrays)


@pytest.mark.parametrize("B,S,d_in,N,chunk", CASES)
def test_plain_matches_interpret_kernel(B, S, d_in, N, chunk):
    arrays = _inputs(B, S, d_in, N)
    y_want, h_want = j_scan(*map(jnp.asarray, arrays), chunk=chunk,
                            interpret=True)
    y, h = ss.selective_scan_plain(*_torch(arrays))
    assert y.shape == (B, S, d_in) and h.shape == (B, d_in, N)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_want), **TOL)
    np.testing.assert_allclose(h.numpy(), np.asarray(h_want), **TOL)
    # the model-facing wrapper takes the plain version for CPU tensors
    y_ops, h_ops = ops.selective_scan(*_torch(arrays))
    assert torch.equal(y_ops, y) and torch.equal(h_ops, h)


# the reference's cases, a ragged S (not a multiple of the CUDA kernel's
# 8-step tile nor of the chunk) and the widest |dt*A|
SPLIT_CASES = [(c, _inputs) for c in CASES] + [
    ((2, 301, 24, 16, 64), _inputs), ((2, 45, 16, 16, 16), _wide_inputs),
    ((1, 40, 8, 2, 16), _wide_inputs)]


@pytest.mark.parametrize("case,draw", SPLIT_CASES,
                         ids=[f"{c}-{d.__name__}" for c, d in SPLIT_CASES])
def test_split_plain_matches_interpret_kernel(case, draw):
    """The CUDA kernel's arithmetic within the reference's 1e-5 (rtol and
    atol) of the interpret-mode Pallas kernel and of the plain version."""
    B, S, d_in, N, chunk = case
    arrays = draw(B, S, d_in, N, seed=5)
    y_want, h_want = j_scan(*map(jnp.asarray, arrays), chunk=chunk,
                            interpret=True)
    y, h = ss.selective_scan_split_plain(*_torch(arrays))
    assert y.shape == (B, S, d_in) and h.shape == (B, d_in, N)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_want), **TOL)
    np.testing.assert_allclose(h.numpy(), np.asarray(h_want), **TOL)
    y_plain, h_plain = ss.selective_scan_plain(*_torch(arrays))
    torch.testing.assert_close(y, y_plain, **TOL)
    torch.testing.assert_close(h, h_plain, **TOL)


def test_plain_state_continuation():
    """Scanning two halves with the carried state equals scanning the
    whole (``tests/test_kernels.py::test_selective_scan_state_continuation``)."""
    x, dt, A, Bc, Cc, _ = _torch(_inputs(1, 80, 8, 4, seed=4))
    h0 = torch.zeros((1, 8, 4))
    y_full, h_full = ss.selective_scan_plain(x, dt, A, Bc, Cc, h0)
    y1, h1 = ss.selective_scan_plain(x[:, :40], dt[:, :40], A, Bc[:, :40],
                                     Cc[:, :40], h0)
    y2, h2 = ss.selective_scan_plain(x[:, 40:], dt[:, 40:], A, Bc[:, 40:],
                                     Cc[:, 40:], h1)
    torch.testing.assert_close(torch.cat([y1, y2], 1), y_full, **TOL)
    torch.testing.assert_close(h2, h_full, **TOL)


@pytest.mark.parametrize("B,S,d_in,N,chunk", CASES)
def test_model_scan_matches_reference(B, S, d_in, N, chunk):
    arrays = _inputs(B, S, d_in, N, seed=1)
    y_want, h_want = j_mamba.selective_scan_ref(*map(jnp.asarray, arrays),
                                                chunk=chunk)
    with torch.no_grad():
        y, h = mamba.selective_scan_ref(*_torch(arrays), chunk=chunk)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_want), **TOL)
    np.testing.assert_allclose(h.numpy(), np.asarray(h_want), **TOL)


@pytest.mark.parametrize("B,S,d_in,N,chunk", [(2, 100, 16, 8, 32),
                                              (2, 300, 64, 16, 256)])
def test_model_scan_gradient_matches_reference(B, S, d_in, N, chunk):
    """The gradient of a weighted sum of y and h_last with respect to all
    six inputs, through the port's per-chunk checkpoint and through the
    reference's ``jax.checkpoint``."""
    arrays = _inputs(B, S, d_in, N, seed=2)
    rng = np.random.default_rng(3)
    wy = rng.normal(size=(B, S, d_in)).astype(np.float32)
    wh = rng.normal(size=(B, d_in, N)).astype(np.float32)

    def j_objective(*args):
        y, h = j_mamba.selective_scan_ref(*args, chunk=chunk)
        return jnp.sum(y * wy) + jnp.sum(h * wh)

    want = jax.grad(j_objective, argnums=tuple(range(6)))(
        *map(jnp.asarray, arrays))
    inputs = _torch(arrays, requires_grad=True)
    y, h = mamba.selective_scan_ref(*inputs, chunk=chunk)
    (torch.sum(y * torch.from_numpy(wy))
     + torch.sum(h * torch.from_numpy(wh))).backward()
    for name, t, g in zip(("x", "dt", "A", "Bc", "Cc", "h0"), inputs, want):
        g = np.asarray(g)
        np.testing.assert_allclose(t.grad.numpy(), g, rtol=0,
                                   atol=1e-6 * np.abs(g).max(),
                                   err_msg=name)

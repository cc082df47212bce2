"""The port's sLSTM recurrence against the JAX reference.

``slstm_scan_plain`` (what a CPU tensor takes, and what the CUDA kernel is
held against on the card) is compared with
``repro.kernels.slstm.slstm_scan_bsd`` run in interpret mode and with the
reference's oracle ``repro.kernels.ref.slstm_scan_ref``, on the same inputs
drawn with numpy.

Tolerances, the reference's own (``tests/test_kernels.py``): ``hs`` within
1e-5 (rtol and atol), the final states within 1e-4; the two frameworks'
float32 ``exp``, ``tanh`` and matrix products differ in the last bits, and
the normaliser ``n`` grows to several units over the sequence.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as j_ref  # noqa: E402
from repro.kernels.slstm import slstm_scan_bsd as j_scan  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import slstm  # noqa: E402

# tests/test_kernels.py SLSTM_CASES (B, S, d, chunk)
CASES = [(2, 100, 32, 16), (1, 64, 16, 64), (3, 50, 8, 7)]
HS_TOL = dict(rtol=1e-5, atol=1e-5)
STATE_TOL = dict(rtol=1e-4, atol=1e-4)


def _inputs(B, S, d, seed=0, fresh=True):
    """Gate inputs and R as the reference's kernel tests draw them (R
    scaled by 0.05); a fresh state (zeros, m = -1e30) or a carried one."""
    rng = np.random.default_rng(seed)
    gx = rng.normal(size=(B, S, 4 * d)).astype(np.float32)
    R = (rng.normal(size=(d, 4 * d)) * 0.05).astype(np.float32)
    if fresh:
        zeros = np.zeros((B, d), np.float32)
        return gx, R, zeros, zeros, zeros, np.full((B, d), -1e30, np.float32)
    c0 = rng.normal(size=(B, d)).astype(np.float32)
    n0 = (1.0 + rng.random((B, d))).astype(np.float32)
    h0 = (rng.normal(size=(B, d)) * 0.5).astype(np.float32)
    m0 = rng.normal(size=(B, d)).astype(np.float32)
    return gx, R, c0, n0, h0, m0


def _torch(arrays):
    return tuple(torch.from_numpy(a.copy()) for a in arrays)


def _assert_close(hs, state, hs_want, state_want):
    np.testing.assert_allclose(hs.numpy(), np.asarray(hs_want), **HS_TOL)
    for name, a, b in zip("cnhm", state, state_want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), err_msg=name,
                                   **STATE_TOL)


@pytest.mark.parametrize("B,S,d,chunk", CASES)
@pytest.mark.parametrize("fresh", [True, False])
def test_plain_matches_interpret_kernel(B, S, d, chunk, fresh):
    arrays = _inputs(B, S, d, fresh=fresh)
    hs_want, st_want = j_scan(*map(jnp.asarray, arrays), chunk=chunk,
                              interpret=True)
    hs, state = slstm.slstm_scan_plain(*_torch(arrays))
    assert hs.shape == (B, S, d) and all(t.shape == (B, d) for t in state)
    _assert_close(hs, state, hs_want, st_want)
    # the model-facing wrapper takes the plain version for CPU tensors
    hs_ops, st_ops = ops.slstm_scan(*_torch(arrays))
    assert torch.equal(hs_ops, hs)
    assert all(torch.equal(a, b) for a, b in zip(st_ops, state))


@pytest.mark.parametrize("B,S,d,chunk", CASES)
def test_plain_matches_reference_oracle(B, S, d, chunk):
    arrays = _inputs(B, S, d, seed=1)
    hs_want, st_want = j_ref.slstm_scan_ref(*map(jnp.asarray, arrays))
    hs, state = slstm.slstm_scan_plain(*_torch(arrays))
    _assert_close(hs, state, hs_want, st_want)


def test_plain_state_continuation():
    """Two calls carrying the state equal one over the whole
    (``tests/test_kernels.py::test_slstm_kernel_state_continuation``)."""
    gx, R, c0, n0, h0, m0 = _torch(_inputs(1, 80, 16, seed=12))
    hs_full, st_full = slstm.slstm_scan_plain(gx, R, c0, n0, h0, m0)
    hs1, st1 = slstm.slstm_scan_plain(gx[:, :40], R, c0, n0, h0, m0)
    hs2, st2 = slstm.slstm_scan_plain(gx[:, 40:], R, *st1)
    torch.testing.assert_close(torch.cat([hs1, hs2], 1), hs_full, **HS_TOL)
    for a, b in zip(st2, st_full):
        torch.testing.assert_close(a, b, **STATE_TOL)


def test_plain_checks_shapes():
    gx, R, c0, n0, h0, m0 = _torch(_inputs(2, 5, 8))
    with pytest.raises(ValueError, match="R"):
        slstm.slstm_scan_bsd(gx, R[:, :16], c0, n0, h0, m0)
    with pytest.raises(ValueError, match="h0"):
        slstm.slstm_scan_bsd(gx, R, c0, n0, h0[:1], m0)
    with pytest.raises(ValueError, match="4d"):
        slstm.slstm_scan_bsd(gx[..., :30], R, c0, n0, h0, m0)

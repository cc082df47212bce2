"""The port's chunkwise mLSTM against the JAX reference.

``mlstm_chunkwise_plain`` (what a CPU tensor takes, and what the CUDA
kernel is held against on the card) and ``mlstm_two_pass_plain`` (the
plain version of the kernel's two-pass arithmetic) are compared with
``repro.kernels.mlstm.mlstm_chunkwise_bshd`` run in interpret mode and with
the reference's step-by-step oracle ``mlstm_recurrent_ref``; the model's
own chunkwise form (``models.xlstm.mlstm_chunkwise``, the path local
training runs under autograd) with the reference's, forward and gradient.
Inputs are drawn with numpy.

Tolerances: 1e-4 (rtol and atol) for ``h`` and the states, the reference's
own (``tests/test_kernels.py``): float32 ``exp`` and ``log sigmoid`` differ
in the last bits between the frameworks, and the chunkwise and step-by-step
forms sum in different orders.  Gradients: within 1e-5 of each gradient's
largest magnitude, the same float32 noise carried through the backward.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.mlstm import mlstm_chunkwise_bshd as j_kernel  # noqa: E402
from repro.models import xlstm as j_xlstm  # noqa: E402
from repro_torch.kernels import mlstm  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import xlstm  # noqa: E402

# tests/test_kernels.py MLSTM_CASES (B, S, H, dk, dv, chunk), and two
# chunks of 256 with a ragged second one at xlstm-125m's head widths
CASES = [(2, 100, 2, 16, 24, 16), (1, 64, 4, 32, 32, 64),
         (2, 50, 1, 8, 8, 13), (1, 300, 1, 192, 384, 256)]
TOL = dict(rtol=1e-4, atol=1e-4)


def _inputs(B, S, H, dk, dv, seed=0):
    """As the reference's kernel tests draw them: forget gates shifted by
    +2 (sigmoid near 1)."""
    rng = np.random.default_rng(seed)

    def normal(*shape):
        return rng.normal(size=shape).astype(np.float32)

    return (normal(B, S, H, dk), normal(B, S, H, dk), normal(B, S, H, dv),
            normal(B, S, H), normal(B, S, H) + np.float32(2.0))


def _state(B, H, dk, dv, rng=None):
    """A fresh state, or a carried one drawn from ``rng``."""
    if rng is None:
        return {"C": np.zeros((B, H, dk, dv), np.float32),
                "n": np.zeros((B, H, dk), np.float32),
                "m": np.full((B, H), -1e30, np.float32)}
    return {"C": rng.normal(0, 0.3, (B, H, dk, dv)).astype(np.float32),
            "n": rng.normal(0, 0.3, (B, H, dk)).astype(np.float32),
            "m": rng.normal(size=(B, H)).astype(np.float32)}


def _torch(arrays):
    return tuple(torch.from_numpy(a.copy()) for a in arrays)


def _torch_state(state):
    return {k: torch.from_numpy(v.copy()) for k, v in state.items()}


@pytest.mark.parametrize("B,S,H,dk,dv,chunk", CASES)
def test_plain_matches_interpret_kernel_and_oracle(B, S, H, dk, dv, chunk):
    arrays = _inputs(B, S, H, dk, dv)
    jin = tuple(map(jnp.asarray, arrays))
    h_kernel, st_kernel = j_kernel(*jin, chunk=chunk, interpret=True)
    h_oracle, _ = j_xlstm.mlstm_recurrent_ref(
        *jin, {k: jnp.asarray(v) for k, v in _state(B, H, dk, dv).items()})
    h, state = mlstm.mlstm_chunkwise_plain(*_torch(arrays), chunk=chunk)
    assert h.shape == (B, S, H, dv) and h.dtype == torch.float32
    np.testing.assert_allclose(h.numpy(), np.asarray(h_kernel), **TOL)
    np.testing.assert_allclose(h.numpy(), np.asarray(h_oracle), **TOL)
    for name in ("C", "n", "m"):
        np.testing.assert_allclose(state[name].numpy(),
                                   np.asarray(st_kernel[name]), err_msg=name,
                                   **TOL)
    # the port's own oracle agrees too
    h_ref, _ = xlstm.mlstm_recurrent_ref(
        *_torch(arrays), _torch_state(_state(B, H, dk, dv)))
    np.testing.assert_allclose(h_ref.numpy(), np.asarray(h_oracle), **TOL)


@pytest.mark.parametrize("B,S,H,dk,dv,chunk", CASES + [
    (2, 130, 2, 20, 12, 64)])
def test_two_pass_plain_matches_interpret_kernel_and_oracle(B, S, H, dk, dv,
                                                            chunk):
    """The plain version of the CUDA kernel's arithmetic (chunk scores and
    states first, then all outputs, at the kernel's 64 steps) against the
    interpret-mode Pallas kernel at the case's chunk and the step-by-step
    oracle, at the reference's 1e-4; a ragged S over three chunks too."""
    arrays = _inputs(B, S, H, dk, dv, seed=S)
    jin = tuple(map(jnp.asarray, arrays))
    h_kernel, st_kernel = j_kernel(*jin, chunk=chunk, interpret=True)
    h_oracle, _ = j_xlstm.mlstm_recurrent_ref(
        *jin, {k: jnp.asarray(v) for k, v in _state(B, H, dk, dv).items()})
    h, state = mlstm.mlstm_two_pass_plain(*_torch(arrays))
    assert h.shape == (B, S, H, dv) and h.dtype == torch.float32
    np.testing.assert_allclose(h.numpy(), np.asarray(h_kernel), **TOL)
    np.testing.assert_allclose(h.numpy(), np.asarray(h_oracle), **TOL)
    for name in ("C", "n", "m"):
        np.testing.assert_allclose(state[name].numpy(),
                                   np.asarray(st_kernel[name]), err_msg=name,
                                   **TOL)


@pytest.mark.parametrize("chunk", [16, 64, 128])
def test_two_pass_plain_matches_chunk_loop(chunk):
    """The two passes at any chunk length against the chunk loop, in bf16
    q, k, v as the model feeds the kernel."""
    q, k, v, i, f = _torch(_inputs(2, 150, 2, 24, 40, seed=chunk))
    q, k, v = (t.to(torch.bfloat16) for t in (q, k, v))
    h, st = mlstm.mlstm_two_pass_plain(q, k, v, i, f, chunk=chunk)
    h_want, st_want = mlstm.mlstm_chunkwise_plain(q, k, v, i, f, chunk=100)
    torch.testing.assert_close(h, h_want, **TOL)
    for name in ("C", "n", "m"):
        torch.testing.assert_close(st[name], st_want[name], **TOL)


@pytest.mark.parametrize("S,chunk,carried", [(96, 32, False), (70, 32, True),
                                             (45, 64, True)])
def test_model_chunkwise_matches_reference(S, chunk, carried):
    """``tests/test_kernels.py::test_mlstm_kernel_matches_jax_chunkwise``'s
    shapes, a ragged S (the last chunk padded with ``f_gate = 30``) and a
    carried state: h and the state."""
    B, H, dk, dv = 1, 2, 16, 16
    arrays = _inputs(B, S, H, dk, dv, seed=22)
    state = _state(B, H, dk, dv, np.random.default_rng(3) if carried
                   else None)
    h_want, st_want = j_xlstm.mlstm_chunkwise(
        *map(jnp.asarray, arrays),
        {k: jnp.asarray(v) for k, v in state.items()}, chunk=chunk)
    with torch.no_grad():
        h, st = xlstm.mlstm_chunkwise(*_torch(arrays), _torch_state(state),
                                      chunk=chunk)
    np.testing.assert_allclose(h.numpy(), np.asarray(h_want), **TOL)
    for name in ("C", "n", "m"):
        np.testing.assert_allclose(st[name].numpy(), np.asarray(st_want[name]),
                                   err_msg=name, **TOL)


def test_model_chunkwise_gradient_matches_reference():
    """The gradient of a weighted sum of h and the final state with respect
    to q, k, v and both gates, through the port's per-chunk checkpoint and
    the reference's ``jax.checkpoint``."""
    B, S, H, dk, dv, chunk = 2, 70, 2, 8, 12, 32
    arrays = _inputs(B, S, H, dk, dv, seed=5)
    state = _state(B, H, dk, dv, np.random.default_rng(6))
    rng = np.random.default_rng(7)
    wh = rng.normal(size=(B, S, H, dv)).astype(np.float32)
    wc = rng.normal(size=(B, H, dk, dv)).astype(np.float32)

    def j_objective(*args):
        h, st = j_xlstm.mlstm_chunkwise(
            *args, {k: jnp.asarray(v) for k, v in state.items()}, chunk=chunk)
        return jnp.sum(h * wh) + jnp.sum(st["C"] * wc)

    want = jax.grad(j_objective, argnums=tuple(range(5)))(
        *map(jnp.asarray, arrays))
    inputs = tuple(t.requires_grad_(True) for t in _torch(arrays))
    h, st = xlstm.mlstm_chunkwise(*inputs, _torch_state(state), chunk=chunk)
    (torch.sum(h * torch.from_numpy(wh))
     + torch.sum(st["C"] * torch.from_numpy(wc))).backward()
    for name, t, g in zip(("q", "k", "v", "i", "f"), inputs, want):
        g = np.asarray(g)
        np.testing.assert_allclose(t.grad.numpy(), g, rtol=0,
                                   atol=1e-5 * np.abs(g).max(), err_msg=name)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ops_output_dtype(dtype):
    """``ops.mlstm_chunkwise`` returns h in q's dtype, as the reference's
    entry does, or in ``h_dtype``; the values are the float32 plain
    version's, rounded."""
    q, k, v, i, f = _torch(_inputs(1, 40, 2, 8, 8, seed=9))
    q, k, v = (t.to(dtype) for t in (q, k, v))
    want, st_want = mlstm.mlstm_chunkwise_plain(q, k, v, i, f, chunk=16)
    h, st = ops.mlstm_chunkwise(q, k, v, i, f, chunk=16)
    assert h.dtype == dtype and torch.equal(h, want.to(dtype))
    h32, _ = ops.mlstm_chunkwise(q, k, v, i, f, chunk=16,
                                 h_dtype=torch.float32)
    assert h32.dtype == torch.float32 and torch.equal(h32, want)
    assert all(torch.equal(st[n], st_want[n]) for n in ("C", "n", "m"))


def test_plain_checks_shapes():
    q, k, v, i, f = _torch(_inputs(2, 10, 2, 8, 4))
    with pytest.raises(ValueError, match="q, k"):
        mlstm.mlstm_chunkwise_bshd(q, k[..., :4], v, i, f)
    with pytest.raises(ValueError, match="v"):
        mlstm.mlstm_chunkwise_bshd(q, k, v[:, :5], i, f)
    with pytest.raises(ValueError, match="f_gate"):
        mlstm.mlstm_chunkwise_bshd(q, k, v, i, f[..., :1])

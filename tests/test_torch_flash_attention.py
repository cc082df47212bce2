"""The port's flash attention against the JAX reference's Pallas kernel.

``flash_attention_plain`` (what a CPU tensor takes, and what the CUDA
kernels are held against on the card) and ``flash_attention_tc_plain``
(the arithmetic of the bfloat16 tensor-core kernel: P rounded to bfloat16
before P.V) are compared with
``repro.kernels.flash_attention.flash_attention_bhsd`` run in interpret
mode, on the same inputs drawn with numpy.  Tolerances are the reference's
own (``tests/test_kernels.py``): 2e-5 for float32, where the two differ only
in the order of float32 sums; 2e-2 for bfloat16, where both round the
output to bfloat16 and a different order can land on the neighbouring
bfloat16 value.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as j_ops  # noqa: E402
from repro.kernels.flash_attention import flash_attention_bhsd as j_flash  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

# a subset of tests/test_kernels.py FLASH_CASES, and one head_dim-256 case:
# GQA, a window, a soft-cap, non-causal, S not a multiple of the block,
# bfloat16
CASES = [
    # B, H, K, S, hd, causal, window, softcap, dtype
    (2, 4, 2, 256, 64, True, -1, 0.0, "float32"),
    (1, 4, 4, 300, 32, True, 48, 0.0, "float32"),
    (2, 2, 1, 128, 64, True, -1, 30.0, "float32"),
    (1, 2, 2, 200, 64, False, -1, 0.0, "float32"),
    (2, 4, 2, 192, 64, True, -1, 0.0, "bfloat16"),
    (1, 2, 1, 130, 256, True, 40, 50.0, "bfloat16"),
    (1, 2, 1, 256, 256, True, 128, 50.0, "bfloat16"),
]
BF16_CASES = [c[:8] for c in CASES if c[8] == "bfloat16"]
TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _inputs(shapes, dtype, seed):
    rng = np.random.default_rng(seed)
    arrays = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    jx = [jnp.asarray(a, dtype=getattr(jnp, dtype)) for a in arrays]
    tx = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrays]
    return jx, tx


@pytest.mark.parametrize("B,H,K,S,hd,causal,window,cap,dtype", CASES)
def test_plain_matches_interpret_kernel(B, H, K, S, hd, causal, window, cap,
                                        dtype):
    (jq, jk, jv), (tq, tk, tv) = _inputs(
        [(B, H, S, hd), (B, K, S, hd), (B, K, S, hd)], dtype, seed=S + hd)
    want = j_flash(jq, jk, jv, causal=causal, window=window, softcap=cap,
                   block_q=64, block_k=64, interpret=True)
    got = fa.flash_attention_bhsd(tq, tk, tv, causal=causal, window=window,
                                  softcap=cap)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("B,H,K,S,hd,causal,window,cap", BF16_CASES)
def test_tc_plain_matches_interpret_kernel(B, H, K, S, hd, causal, window,
                                           cap):
    """The tensor-core kernel's arithmetic within the reference's bfloat16
    tolerance of the Pallas kernel."""
    (jq, jk, jv), (tq, tk, tv) = _inputs(
        [(B, H, S, hd), (B, K, S, hd), (B, K, S, hd)], "bfloat16",
        seed=S + hd)
    want = j_flash(jq, jk, jv, causal=causal, window=window, softcap=cap,
                   block_q=64, block_k=64, interpret=True)
    got = fa.flash_attention_tc_plain(tq, tk, tv, causal=causal,
                                      window=window, softcap=cap)
    assert got.dtype == torch.bfloat16 and got.shape == tq.shape
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=TOL["bfloat16"], atol=TOL["bfloat16"])


@pytest.mark.parametrize("B,H,K,S,hd,causal,window,cap", BF16_CASES)
def test_tc_plain_matches_plain(B, H, K, S, hd, causal, window, cap):
    (_, _, _), (tq, tk, tv) = _inputs(
        [(B, H, S, hd), (B, K, S, hd), (B, K, S, hd)], "bfloat16",
        seed=S + hd + 1)
    kw = dict(causal=causal, window=window, softcap=cap)
    np.testing.assert_allclose(
        fa.flash_attention_tc_plain(tq, tk, tv, **kw).float().numpy(),
        fa.flash_attention_plain(tq, tk, tv, **kw).float().numpy(),
        rtol=TOL["bfloat16"], atol=TOL["bfloat16"])


def test_bshd_wrapper_layout():
    """``ops.flash_attention`` takes (B,S,H,hd), as the reference's
    wrapper does (``tests/test_kernels.py::test_flash_bshd_wrapper_layout``)."""
    (jq, jk, jv), (tq, tk, tv) = _inputs(
        [(2, 130, 4, 32), (2, 130, 2, 32), (2, 130, 2, 32)], "float32", 2)
    want = j_ops.flash_attention(jq, jk, jv, interpret=True)
    got = ops.flash_attention(tq, tk, tv)
    assert got.shape == (2, 130, 4, 32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=2e-5, atol=2e-5)


def test_plain_rejects_mismatched_shapes():
    q = torch.zeros(1, 4, 8, 32)
    with pytest.raises(ValueError, match="Sq must equal Sk"):
        fa.flash_attention_plain(q, torch.zeros(1, 2, 9, 32),
                                 torch.zeros(1, 2, 9, 32))
    with pytest.raises(ValueError, match="KV heads"):
        fa.flash_attention_plain(q, torch.zeros(1, 3, 8, 32),
                                 torch.zeros(1, 3, 8, 32))

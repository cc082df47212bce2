"""The port's CUDA kernels on the card, against their plain versions.

Every test here needs an NVIDIA card with ``nvcc``: they carry the ``cuda``
marker and skip where CUDA is absent.  On the machine with the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import runtime  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.configs.base import LayerSpec, Stage  # noqa: E402
from repro_torch.configs.cnn import vgg_for  # noqa: E402
from repro_torch.core.aggregate import tree_map  # noqa: E402
from repro_torch.data.synthetic import make_lm_dataset  # noqa: E402
from repro_torch.fl.backend import CNNBackend, LMBackend  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import mlstm  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import selective_scan as ss  # noqa: E402
from repro_torch.kernels import signature as sig  # noqa: E402
from repro_torch.kernels import slstm  # noqa: E402
from repro_torch.data.synthetic import make_benchmark_dataset  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return runtime.resolve_device("cuda")


def _relu_like(shape, device, seed=0):
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.relu(torch.randn(shape, generator=g, device=device) * 0.2)
    x.view(-1)[::7] = 0.05             # stored as the float32 tau
    return x


@pytest.mark.parametrize("shape", [(128, 1024, 64), (3, 1000, 63),
                                   (1, 1, 1), (2, 5, 33), (70000, 2, 3)])
@pytest.mark.parametrize("tau", [0.0, 0.05])
@pytest.mark.parametrize("mean", [False, True])
def test_kernel_equals_plain(card, shape, tau, mean):
    x = _relu_like(shape, card)
    before = sig.launches
    got = sig.signature_counts(x, tau, mean=mean)
    torch.cuda.synchronize()
    assert sig.launches == before + 1
    assert torch.equal(got, sig.signature_counts_plain(x, tau, mean=mean))
    # any strides: the same values laid out channel-major
    strided = x.transpose(1, 2).contiguous().transpose(1, 2)
    assert torch.equal(sig.signature_counts(strided, tau, mean=mean), got)


def test_kernel_refuses_non_float32(card):
    """float32 and bfloat16 are taken (bfloat16 equal to the plain version
    on its float32 values); float16 and float64 are refused."""
    x = _relu_like((3, 257, 40), card).to(torch.bfloat16)
    for tau in (0.0, 0.05):
        assert torch.equal(sig.signature_counts(x, tau),
                           sig.signature_counts_plain(x.float(), tau))
    for dtype in (torch.float16, torch.float64):
        with pytest.raises(TypeError, match="float32 or bfloat16"):
            sig.signature_counts(torch.zeros((2, 3, 4), device=card,
                                             dtype=dtype), 0.0)


# the CNN path's shape, the LM-family paths' widths (xlstm-125m,
# internlm2-1.8b, jamba), and ragged shapes: C not a multiple of 64 (vec
# route), C not a multiple of 8 (strided), one row, rows past 2**16
SIG_ROUTE_CASES = [((128, 1024, 64), torch.float32),
                   ((1, 4096, 768), torch.bfloat16),
                   ((1, 4096, 2048), torch.bfloat16),
                   ((1, 4096, 4096), torch.bfloat16),
                   ((2, 300, 1000), torch.bfloat16),
                   ((2, 300, 1000), torch.float32),
                   ((3, 257, 100), torch.bfloat16),
                   ((5, 1, 16), torch.float32),
                   ((1, 70001, 8), torch.bfloat16)]


@pytest.mark.parametrize("shape,dtype", SIG_ROUTE_CASES)
@pytest.mark.parametrize("tau", [0.0, 0.05])
def test_signature_routes_equal_plain(card, shape, dtype, tau):
    """Both kernel routes bit for bit equal to the plain version, counts
    and means; the route counters move with their launches; the vec
    route's scratch is zero again after its launches."""
    x = _relu_like(shape, card).to(dtype)
    x.view(-1)[3::11] = -0.0
    which = sig.route(x)
    assert which == ("strided" if shape[2] % (16 // x.element_size())
                     else "vec")
    for mean in (False, True):
        want = sig.signature_counts_plain(x, tau, mean=mean)
        before = (sig.launches_vec, sig.launches_strided)
        got = sig.signature_counts(x, tau, mean=mean)
        assert (sig.launches_vec, sig.launches_strided) == (
            before[0] + (which == "vec"), before[1] + (which == "strided"))
        strided = sig._dispatch(x, torch.empty_like(want), "strided", tau,
                                mean)
        torch.cuda.synchronize()
        assert torch.equal(got, want) and torch.equal(strided, want)
    assert all(int(buf.abs().sum()) == 0 for buf in sig._scratch.values())


def test_signature_vec_route_on_views(card):
    """The vec route through padded rows and a base moved by 16 bytes;
    a base moved by 2 bytes takes the strided route; both exact."""
    base = _relu_like((2, 300, 1040), card).to(torch.bfloat16)
    for view, which in ((base[..., 8:1032], "vec"),
                        (base[..., 1:1025], "strided")):
        assert sig.route(view) == which
        assert torch.equal(sig.signature_counts(view, 0.05),
                           sig.signature_counts_plain(view, 0.05))


@pytest.mark.parametrize("shape", [(1, 4096, 2048), (2, 24, 100)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bucketed_signature_equals_plain(card, shape, dtype):
    x = _relu_like(shape, card).to(dtype)
    before = sig.launches
    got = ops.signature(x, tau=0.05, n_sig=64)
    assert sig.launches == before + 1
    want = ops.signature(x.cpu(), tau=0.05, n_sig=64)
    assert torch.equal(got.cpu(), want)


FLASH_CASES = [
    # B, H, K, S, hd, causal, window, softcap, dtype
    (2, 4, 2, 256, 64, True, -1, 0.0, torch.float32),
    (1, 4, 4, 300, 32, True, 48, 0.0, torch.float32),
    (1, 2, 2, 200, 64, False, -1, 0.0, torch.float32),
    (1, 8, 2, 256, 128, True, 128, 50.0, torch.float32),
    (2, 4, 2, 192, 64, True, -1, 0.0, torch.bfloat16),
    (1, 2, 1, 300, 256, True, 256, 50.0, torch.bfloat16),
    (8, 16, 8, 512, 128, True, -1, 0.0, torch.bfloat16),
    # MLA's head dim (128 nope + 64 rope), one KV head per query head
    (2, 4, 4, 300, 192, True, -1, 0.0, torch.float32),
    (1, 4, 2, 260, 192, True, 48, 30.0, torch.float32),
    (2, 4, 4, 300, 192, True, -1, 0.0, torch.bfloat16),
    # past the dense path's 2,048 tokens, ragged, with gemma3's window of
    # 1,024 and without
    (1, 4, 2, 4100, 128, True, 1024, 0.0, torch.float32),
    (1, 4, 2, 4100, 128, True, -1, 0.0, torch.float32),
    (1, 4, 2, 4100, 128, True, 1024, 0.0, torch.bfloat16),
    (1, 4, 2, 4100, 128, True, -1, 0.0, torch.bfloat16),
]


@pytest.mark.parametrize("B,H,K,S,hd,causal,window,cap,dtype", FLASH_CASES)
def test_flash_kernel_equals_plain(card, B, H, K, S, hd, causal, window, cap,
                                   dtype):
    """From (B,S,H,hd) storage, as the model hands it over; the plain
    version on the same card.  Tolerances as the reference's tests."""
    g = torch.Generator(device=card).manual_seed(S + hd)
    q, k, v = (torch.randn((B, S, n, hd), generator=g, device=card)
               .to(dtype) for n in (H, K, K))
    before = fa.launches
    got = ops.flash_attention(q, k, v, causal=causal, window=window,
                              softcap=cap)
    torch.cuda.synchronize()
    assert fa.launches == before + 1
    assert got.is_contiguous() and got.dtype == dtype
    want = fa.flash_attention_plain(q.transpose(1, 2), k.transpose(1, 2),
                                    v.transpose(1, 2), causal=causal,
                                    window=window, softcap=cap)
    tol = 2e-2 if dtype == torch.bfloat16 else 2e-5
    torch.testing.assert_close(got.float(), want.transpose(1, 2).float(),
                               rtol=tol, atol=tol)


FLASH_TC_TOL = {"atol": 2e-3, "rtol": 2 ** -7}     # as chip_smoke.py's
SM90_CASES = [c[:8] for c in FLASH_CASES if c[8] == torch.bfloat16] + [
    (1, 4, 2, 300, 128, True, -1, 0.0),            # ragged S
    (2, 4, 4, 77, 32, False, -1, 0.0),             # S under one tile
    (1, 4, 2, 260, 192, True, 48, 30.0),           # hd 192: window, cap
    (1, 2, 2, 100, 192, False, -1, 0.0),
    (2, 128, 128, 512, 192, True, -1, 0.0),        # MLA's shape, batch 2
]


def _sm90_against_both_plain_versions(q, k, v, causal, window, cap):
    before = (fa.launches_sm90, fa.launches_fma)
    got = ops.flash_attention(q, k, v, causal=causal, window=window,
                              softcap=cap)
    torch.cuda.synchronize()
    assert (fa.launches_sm90 - before[0], fa.launches_fma - before[1]) \
        == (1, 0)
    assert got.is_contiguous() and got.dtype == torch.bfloat16
    bhsd = [t.transpose(1, 2) for t in (q, k, v)]
    kw = dict(causal=causal, window=window, softcap=cap)
    want = fa.flash_attention_plain(*bhsd, **kw).transpose(1, 2).float()
    torch.testing.assert_close(got.float(), want, rtol=2e-2, atol=2e-2)
    tc = fa.flash_attention_tc_plain(*bhsd, **kw).transpose(1, 2).float()
    torch.testing.assert_close(got.float(), tc, rtol=FLASH_TC_TOL["rtol"],
                               atol=FLASH_TC_TOL["atol"])


@pytest.mark.parametrize("B,H,K,S,hd,causal,window,cap", SM90_CASES)
def test_flash_sm90_kernel_equals_both_plain_versions(card, B, H, K, S, hd,
                                                      causal, window, cap):
    """bfloat16 takes the Hopper kernel: within the reference's 2e-2 of the
    plain version, and within about one bfloat16 rounding of the plain
    version of its own arithmetic (P rounded to bfloat16 before P.V)."""
    g = torch.Generator(device=card).manual_seed(S + hd + 1)
    q, k, v = (torch.randn((B, S, n, hd), generator=g, device=card)
               .to(torch.bfloat16) for n in (H, K, K))
    _sm90_against_both_plain_versions(q, k, v, causal, window, cap)


def test_flash_sm90_kernel_reads_the_fused_qkv_view(card):
    """q, k and v as the strided views of one (B, S, H + 2K, hd)
    projection, as the model splits them: no copy, the Hopper route."""
    B, H, K, S, hd = 2, 8, 2, 320, 128
    g = torch.Generator(device=card).manual_seed(7)
    qkv = torch.randn((B, S, H + 2 * K, hd), generator=g,
                      device=card).to(torch.bfloat16)
    _sm90_against_both_plain_versions(qkv[:, :, :H], qkv[:, :, H:H + K],
                                      qkv[:, :, H + K:], True, -1, 0.0)


def test_flash_route_counters(card):
    """float32 and bfloat16 views that TMA cannot address (a base moved by
    2 bytes) take the FMA kernel; aligned bfloat16 the Hopper kernel; each
    launch moves its route's counter and the total, and its window's (-1
    for none, a window of 0 among them)."""
    g = torch.Generator(device=card).manual_seed(11)
    raw = torch.randn((1, 128, 6, 72), generator=g, device=card)
    views = {"sm90": raw[..., :64].to(torch.bfloat16),
             "fma": raw[..., :64]}
    shifted = raw.to(torch.bfloat16)[..., 1:65]
    assert shifted.data_ptr() % 16 == 2
    for want, x in [("sm90", views["sm90"]), ("fma", views["fma"]),
                    ("fma", shifted)]:
        q, k, v = x[:, :, :4], x[:, :, 4:5], x[:, :, 5:]
        before = (fa.launches, fa.launches_sm90, fa.launches_fma)
        got = ops.flash_attention(q, k, v)
        torch.cuda.synchronize()
        assert (fa.launches, fa.launches_sm90, fa.launches_fma) == (
            before[0] + 1, before[1] + (want == "sm90"),
            before[2] + (want == "fma"))
        want_out = fa.flash_attention_plain(
            *(t.transpose(1, 2) for t in (q, k, v))).transpose(1, 2)
        tol = 2e-2 if x.dtype == torch.bfloat16 else 2e-5
        torch.testing.assert_close(got.float(), want_out.float(), rtol=tol,
                                   atol=tol)
    q, k, v = (views["sm90"][:, :, i:j] for i, j in ((0, 4), (4, 5), (5, 6)))
    before = dict(fa.launches_by_window)
    for window in (16, 0, -1, 16):
        ops.flash_attention(q, k, v, window=window)
    torch.cuda.synchronize()
    moved = {w: n - before.get(w, 0) for w, n in
             fa.launches_by_window.items()}
    assert {w: n for w, n in moved.items() if n} == {16: 2, -1: 2}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernels_launch_on_every_card(card, dtype):
    """Both flash kernels (float32 FMA and bfloat16 Hopper) on every
    visible card, the first launch there included: the dynamic
    shared-memory limit is raised per device, so a launch on a second card
    runs with it.  Each card's output equals the plain version's within
    the route's tolerance.  Needs two cards."""
    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip(f"needs two cards, {n} visible")
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    route = "launches_fma" if dtype == torch.float32 else "launches_sm90"
    for i in reversed(range(n)):
        dev = torch.device("cuda", i)
        g = torch.Generator(device=dev).manual_seed(i)
        q, k, v = (torch.randn((1, 4, 256, 128), generator=g, device=dev)
                   .to(dtype) for _ in range(3))
        before = getattr(fa, route)
        got = fa.flash_attention_bhsd(q, k, v)
        torch.cuda.synchronize(dev)
        assert getattr(fa, route) - before == 1 and got.device == dev
        want = fa.flash_attention_plain(q, k, v)
        torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                                   atol=tol)


def test_flash_sm90_build_has_no_spills(card):
    """nvcc's -Xptxas -v report for the Hopper kernel: every head_dim's
    instantiation (32, 64, 128, 192, 256) without spills, and setmaxnreg
    not ignored."""
    from repro_torch.kernels import build
    build.build(["flash_attention_sm90"])
    log = build.log_path("flash_attention_sm90").read_text()
    spills = [line for line in log.splitlines() if "spill" in line]
    assert len(spills) == len(fa.HEAD_DIMS) == 5, log
    assert all("0 bytes spill stores, 0 bytes spill loads" in line
               for line in spills), log
    assert "setmaxnreg ignored" not in log, log


def test_flash_kernel_refuses_what_it_does_not_take(card):
    q = torch.zeros((1, 2, 8, 48), device=card)
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_attention_bhsd(q, q, q)
    h = torch.zeros((1, 2, 8, 32), device=card, dtype=torch.float16)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fa.flash_attention_bhsd(h, h, h)
    r = torch.zeros((1, 2, 8, 32), device=card, requires_grad=True)
    with pytest.raises(RuntimeError, match="no gradient"):
        fa.flash_attention_bhsd(r, r, r)


@pytest.mark.parametrize("path", ["banded", "chunked"])
def test_long_attention_paths_on_card_equal_cpu(card, path):
    """The plain score paths past 2,048 tokens in float32 on the card
    against the CPU's at S = 2,500 (ragged: a padded query block, a
    padded KV chunk): within the reference's 2e-5 between paths (float32
    sums in another order)."""
    from repro_torch.models import attention as A
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 2500, n, 64))
                                .astype(np.float32)) for n in (4, 2, 2))
    pos = torch.arange(2500, dtype=torch.int32)
    out = []
    for dev in ("cpu", card):
        args = [t.to(dev) for t in (q, k, v, pos, pos)]
        with torch.no_grad():
            out.append(A._banded_attn(*args, 1024, 0.0) if path == "banded"
                       else A._chunked_attn(*args, True, 0.0))
    assert out[1].is_cuda and out[1].shape == (1, 2500, 4, 64)
    torch.testing.assert_close(out[1].cpu(), out[0], rtol=0, atol=2e-5)


@pytest.mark.parametrize("path", ["banded", "chunked"])
def test_long_attention_path_gradients_on_card_equal_cpu(card, path):
    """The plain score paths' backward past 2,048 tokens (each query block
    or KV chunk under its checkpoint, as training runs them) in float32
    on the card against the CPU's at S = 2,500: the output and the
    gradients of q, k and v of a weighted sum, within 1e-4 (float32 sums
    over up to 2,500 keys, and over the query heads of a KV head, in
    another order)."""
    from repro_torch.models import attention as A
    rng = np.random.default_rng(5)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 2500, n, 64))
                                .astype(np.float32)) for n in (4, 2, 2))
    w = torch.from_numpy(rng.standard_normal((1, 2500, 4, 64))
                         .astype(np.float32))
    pos = torch.arange(2500, dtype=torch.int32)
    got = []
    for dev in ("cpu", card):
        leaves = [t.detach().to(dev).requires_grad_(True)
                  for t in (q, k, v)]
        args = (*leaves, pos.to(dev), pos.to(dev))
        out = (A._banded_attn(*args, 1024, 0.0) if path == "banded"
               else A._chunked_attn(*args, True, 0.0))
        (out * w.to(dev)).sum().backward()
        got.append([out.detach().cpu()] + [t.grad.cpu() for t in leaves])
    for name, a, b in zip(("out", "dq", "dk", "dv"), got[1], got[0]):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-4, msg=name)


def test_gemma3_cut_plain_forward_on_card_equals_cpu(card):
    """A reduced gemma3 of one local (window 1,024) and one global layer
    at S = 2,500 in float32: the banded and chunked paths, the card's
    logits within 1e-4 of the CPU's (two layers of float32 products in
    another order)."""
    from repro_torch.models import transformer as tfm
    cfg = dataclasses.replace(
        reduced(get_config("gemma3-27b"), d_model=64),
        stages=(Stage((LayerSpec(window=1024), LayerSpec()), 1),))
    params = tfm.init_params(torch.Generator().manual_seed(0), cfg)
    tokens = torch.from_numpy(np.random.default_rng(4).integers(
        0, cfg.vocab_size, (1, 2500)).astype(np.int32))
    out = []
    for dev in ("cpu", card):
        with torch.no_grad():
            logits, _ = tfm.forward(tree_map(lambda a: a.to(dev), params),
                                    {"tokens": tokens.to(dev)}, cfg)
        out.append(logits.cpu())
    torch.testing.assert_close(out[1], out[0], rtol=0, atol=1e-4)


def test_lm_backend_signature_launches_both_kernels(card):
    """One bucketed signature launch and one flash launch per attention
    layer for each signature call; evaluate launches flash only; training
    launches neither."""
    cfg = reduced(get_config("internlm2-1.8b"), d_model=256)
    backend = LMBackend(cfg, batch_size=4, seq_len=64, device=card)
    params = backend.init(torch.Generator(device=card).manual_seed(0))
    stream = make_lm_dataset(vocab=cfg.vocab_size, n_tokens=4000)
    f0, s0 = fa.launches, sig.launches
    params, _ = backend.train_local(params, stream, epochs=1)
    assert (fa.launches, sig.launches) == (f0, s0)
    out = backend.signature(params, stream)
    assert out.shape == (64,) and np.all((out >= 0) & (out <= 1))
    assert fa.launches == f0 + cfg.n_layers and sig.launches == s0 + 1
    acc = backend.evaluate(params, stream)
    assert 0.0 <= acc <= 1.0
    assert fa.launches == f0 + 2 * cfg.n_layers and sig.launches == s0 + 1
    cpu = LMBackend(cfg, batch_size=4, seq_len=64, device="cpu")
    cpu_sig = cpu.signature(tree_map(lambda p: p.cpu(), params), stream)
    assert np.sum(np.abs(cpu_sig - out) > 0) <= 4


def test_backend_signature_launches_the_kernel(card):
    """One kernel launch per signature call, and the card's signature
    agrees with the CPU's from the same weights (a ReLU sign may flip
    where the two convolutions round differently)."""
    cfg = vgg_for("cifar10")
    ds = make_benchmark_dataset("cifar10", 160)
    gpu = CNNBackend(cfg, device=card)
    cpu = CNNBackend(cfg, device="cpu")
    params = gpu.init(torch.Generator().manual_seed(0))
    before = sig.launches
    s_gpu = gpu.signature(params, ds)
    assert sig.launches == before + 1
    s_cpu = cpu.signature(tree_map(lambda p: p.cpu(), params), ds)
    assert sig.launches == before + 1
    np.testing.assert_allclose(s_gpu, s_cpu, rtol=0, atol=0.01)
    rows = ops.signature_per_channel(_relu_like((4, 8, 8, 16), card))
    assert rows.shape == (4, 16) and rows.is_cuda


# B, S, d_in, N: tests/test_kernels.py SCAN_CASES, the hybrid path's shape
# with Bc and Cc as strided views of one projection, and a ragged S (not a
# multiple of the kernel's 8-step tile)
SCAN_CASES = [(1, 64, 8, 4), (2, 100, 16, 8), (3, 37, 4, 2),
              (8, 512, 8192, 16), (2, 301, 200, 16)]


def _scan_inputs(B, S, d_in, N, device, seed=0):
    """As the reference's kernel tests draw them; Bc and Cc are views into
    one (B, S, dt_rank + 2N) projection, as ``models.mamba`` splits them."""
    g = torch.Generator(device=device).manual_seed(seed)

    def normal(*shape):
        return torch.randn(shape, generator=g, device=device)

    x = normal(B, S, d_in)
    dt = torch.nn.functional.softplus(normal(B, S, d_in))
    A = -torch.exp(normal(d_in, N) * 0.5)
    proj = normal(B, S, 5 + 2 * N)
    h0 = normal(B, d_in, N) * 0.1
    return x, dt, A, proj[..., 5:5 + N], proj[..., 5 + N:], h0


@pytest.mark.parametrize("B,S,d_in,N", SCAN_CASES)
def test_scan_kernel_equals_plain(card, B, S, d_in, N):
    """Within the reference's 1e-5 (rtol and atol), y and h_last, of the
    plain version and of the plain version of the kernel's own
    arithmetic."""
    inputs = _scan_inputs(B, S, d_in, N, card)
    assert not inputs[3].is_contiguous()
    before = ss.launches
    y, h = ops.selective_scan(*inputs)
    torch.cuda.synchronize()
    assert ss.launches == before + 1
    for plain in (ss.selective_scan_plain, ss.selective_scan_split_plain):
        y_want, h_want = plain(*inputs)
        torch.testing.assert_close(y, y_want, rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(h, h_want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("N", [2, 4, 8, 16])
def test_scan_kernel_state_continuation_at_every_state_size(card, N):
    """Three calls carrying the state (ragged lengths, channels past a
    block of 128) equal one call over the whole and the plain version."""
    x, dt, A, Bc, Cc, h0 = _scan_inputs(2, 101, 300, N, card, seed=N)
    y_full, h_full = ss.selective_scan_bsd(x, dt, A, Bc, Cc, h0)
    ys, h = [], h0
    for a, b in ((0, 13), (13, 64), (64, 101)):
        y, h = ss.selective_scan_bsd(x[:, a:b], dt[:, a:b], A, Bc[:, a:b],
                                     Cc[:, a:b], h)
        ys.append(y)
    torch.testing.assert_close(torch.cat(ys, 1), y_full, rtol=1e-5,
                               atol=1e-5)
    torch.testing.assert_close(h, h_full, rtol=1e-5, atol=1e-5)
    y_want, h_want = ss.selective_scan_plain(x, dt, A, Bc, Cc, h0)
    torch.testing.assert_close(y_full, y_want, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(h_full, h_want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("B,S,d_in,N,offset", [(2, 45, 130, 16, 0),
                                               (1, 37, 131, 2, 0),
                                               (2, 45, 96, 16, 1),
                                               (2, 45, 96, 8, 2)])
def test_scan_kernel_copies_one_float_at_a_time(card, B, S, d_in, N, offset):
    """Where x and dt cannot be copied in 16-byte pieces (d_in % 4 != 0, or
    contiguous x and dt that do not start on 16 bytes), the kernel copies
    one float at a time; within 1e-5 of the plain version."""
    x, dt, A, Bc, Cc, h0 = _scan_inputs(B, S, d_in, N, card, seed=d_in)
    if offset:
        moved = []
        for t in (x, dt):
            m = torch.empty(t.numel() + offset, device=card)[offset:]
            moved.append(m.view(t.shape).copy_(t))
        assert moved[0].is_contiguous() and moved[0].data_ptr() % 16
        x, dt = moved
    y, h = ss.selective_scan_bsd(x, dt, A, Bc, Cc, h0)
    y_want, h_want = ss.selective_scan_plain(x, dt, A, Bc, Cc, h0)
    torch.testing.assert_close(y, y_want, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(h, h_want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name,entries", [("selective_scan", 8),
                                          ("signature", 6)])
def test_scan_and_signature_builds_have_no_spills(card, name, entries):
    """nvcc's -Xptxas -v report for the scan (N = 2, 4, 8, 16, each with
    16-byte and one-float copies) and the signature kernels (the strided
    route in two types, the vec route in two types by two comparisons): no
    spills and no stack frame."""
    from repro_torch.kernels import build
    build.build([name])
    log = build.log_path(name).read_text()
    frames = [line for line in log.splitlines() if "stack frame" in line]
    assert len(frames) == entries, log
    assert all("0 bytes stack frame, 0 bytes spill stores, 0 bytes spill "
               "loads" in line for line in frames), log


def test_scan_kernel_state_continuation(card):
    """Two calls with the carried state equal one call over the whole."""
    x, dt, A, Bc, Cc, _ = _scan_inputs(1, 80, 8, 4, card, seed=4)
    h0 = torch.zeros((1, 8, 4), device=card)
    y_full, h_full = ss.selective_scan_bsd(x, dt, A, Bc, Cc, h0)
    y1, h1 = ss.selective_scan_bsd(x[:, :40], dt[:, :40], A, Bc[:, :40],
                                   Cc[:, :40], h0)
    y2, h2 = ss.selective_scan_bsd(x[:, 40:], dt[:, 40:], A, Bc[:, 40:],
                                   Cc[:, 40:], h1)
    torch.testing.assert_close(torch.cat([y1, y2], 1), y_full, rtol=1e-5,
                               atol=1e-5)
    torch.testing.assert_close(h2, h_full, rtol=1e-5, atol=1e-5)


def test_scan_kernel_refuses_what_it_does_not_take(card):
    inputs = list(_scan_inputs(1, 8, 4, 4, card))
    with pytest.raises(TypeError, match="float32"):
        ss.selective_scan_bsd(*(t.double() for t in inputs))
    wide = list(_scan_inputs(1, 8, 4, 32, card))
    with pytest.raises(ValueError, match="state size"):
        ss.selective_scan_bsd(*wide)
    inputs[0] = inputs[0].requires_grad_(True)
    with pytest.raises(RuntimeError, match="no gradient"):
        ss.selective_scan_bsd(*inputs)
    inputs[0] = inputs[0].detach().cpu()
    with pytest.raises(ValueError, match="CPU or CUDA"):
        ss.selective_scan_bsd(*inputs)


def test_hybrid_backend_signature_launches_all_three_kernels(card):
    """A reduced Jamba cut, one Mamba and one attention layer: a signature
    call launches the scan and flash kernels once each and the signature
    kernel once; training launches none of them."""
    cfg = reduced(get_config("jamba-v0.1-52b"), d_model=256)
    cfg = dataclasses.replace(cfg, n_layers=2, stages=(Stage(
        (LayerSpec(kind="mamba", ffn="dense"),
         LayerSpec(kind="attn", ffn="dense")), 1),))
    backend = LMBackend(cfg, batch_size=4, seq_len=64, device=card)
    params = backend.init(torch.Generator(device=card).manual_seed(0))
    stream = make_lm_dataset(vocab=cfg.vocab_size, n_tokens=4000)
    counts = lambda: (ss.launches, fa.launches, sig.launches)  # noqa: E731
    c0 = counts()
    params, _ = backend.train_local(params, stream, epochs=1)
    assert counts() == c0
    out = backend.signature(params, stream)
    assert out.shape == (64,) and np.all((out >= 0) & (out <= 1))
    assert counts() == (c0[0] + 1, c0[1] + 1, c0[2] + 1)
    cpu = LMBackend(cfg, batch_size=4, seq_len=64, device="cpu")
    cpu_sig = cpu.signature(tree_map(lambda p: p.cpu(), params), stream)
    assert np.sum(np.abs(cpu_sig - out) > 0) <= 4


# B, S, d, R's scale: tests/test_kernels.py SLSTM_CASES (R x 0.05), the
# xLSTM path's shape, and ragged widths (a partly filled last block) over
# an odd S, at 2 and 8 units per block.  Wide cases draw R at the model's
# 0.01 (models.xlstm.init_slstm): at 0.05 x sqrt(d) > 1 the recurrence
# expands and any two float32 orders of the h @ R sums drift apart
SLSTM_CASES = [(2, 100, 32, 0.05), (1, 64, 16, 0.05), (3, 50, 8, 0.05),
               (8, 512, 768, 0.01), (3, 301, 100, 0.05),
               (3, 301, 1001, 0.01)]


def _slstm_inputs(B, S, d, device, seed=0, fresh=True, r_scale=0.05):
    """As the reference's kernel tests draw them (R scaled by 0.05, or
    ``r_scale``); a fresh state or a carried one."""
    g = torch.Generator(device=device).manual_seed(seed)

    def normal(*shape):
        return torch.randn(shape, generator=g, device=device)

    gx, R = normal(B, S, 4 * d), normal(d, 4 * d) * r_scale
    if fresh:
        zeros = torch.zeros((B, d), device=device)
        return gx, R, zeros, zeros, zeros, torch.full((B, d), -1e30,
                                                      device=device)
    return (gx, R, normal(B, d), 1.0 + torch.rand((B, d), generator=g,
                                                  device=device),
            normal(B, d) * 0.5, normal(B, d))


@pytest.mark.parametrize("fresh", [True, False])
@pytest.mark.parametrize("B,S,d,r_scale", SLSTM_CASES)
def test_slstm_kernel_equals_plain(card, B, S, d, r_scale, fresh):
    """hs within the reference's 1e-5, the states within 1e-4 (rtol and
    atol)."""
    inputs = _slstm_inputs(B, S, d, card, fresh=fresh, r_scale=r_scale)
    before = slstm.launches
    hs, state = ops.slstm_scan(*inputs)
    torch.cuda.synchronize()
    assert slstm.launches == before + 1
    hs_want, st_want = slstm.slstm_scan_plain(*inputs)
    torch.testing.assert_close(hs, hs_want, rtol=1e-5, atol=1e-5)
    for a, b in zip(state, st_want):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)


def test_slstm_kernel_state_continuation(card):
    """Two calls with the carried state equal one call over the whole."""
    gx, R, c0, n0, h0, m0 = _slstm_inputs(2, 80, 96, card, seed=12)
    hs_full, st_full = slstm.slstm_scan_bsd(gx, R, c0, n0, h0, m0)
    hs1, st1 = slstm.slstm_scan_bsd(gx[:, :40], R, c0, n0, h0, m0)
    hs2, st2 = slstm.slstm_scan_bsd(gx[:, 40:], R, *st1)
    torch.testing.assert_close(torch.cat([hs1, hs2], 1), hs_full, rtol=1e-5,
                               atol=1e-5)
    for a, b in zip(st2, st_full):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("B", [43, 200])
def test_slstm_kernel_takes_any_batch(card, B):
    """Batches past the first kernel's limit (42 rows at xlstm-125m's
    width) in one launch, equal to the plain version: hs within 1e-5, the
    states within 1e-4."""
    inputs = _slstm_inputs(B, 32, 768, card, seed=B, fresh=False,
                           r_scale=0.01)
    before = slstm.launches
    hs, state = slstm.slstm_scan_bsd(*inputs)
    torch.cuda.synchronize()
    assert slstm.launches == before + 1
    hs_want, st_want = slstm.slstm_scan_plain(*inputs)
    torch.testing.assert_close(hs, hs_want, rtol=1e-5, atol=1e-5)
    for a, b in zip(state, st_want):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)


def test_slstm_kernel_refuses_what_it_does_not_take(card):
    inputs = list(_slstm_inputs(2, 8, 16, card))
    with pytest.raises(TypeError, match="float32"):
        slstm.slstm_scan_bsd(*(t.double() for t in inputs))
    with pytest.raises(ValueError, match="d <= 1024"):
        slstm.slstm_scan_bsd(*_slstm_inputs(2, 4, 1025, card))
    inputs[0] = inputs[0].requires_grad_(True)
    with pytest.raises(RuntimeError, match="no gradient"):
        slstm.slstm_scan_bsd(*inputs)
    inputs[0] = inputs[0].detach().cpu()
    with pytest.raises(ValueError, match="CPU or CUDA"):
        slstm.slstm_scan_bsd(*inputs)


# B, S, H, dk, dv, dtype: tests/test_kernels.py MLSTM_CASES, the xLSTM
# path's shape, and a ragged S with a partial v tile
MLSTM_CASES = [(2, 100, 2, 16, 24, torch.float32),
               (1, 64, 4, 32, 32, torch.float32),
               (2, 50, 1, 8, 8, torch.float32),
               (8, 512, 4, 192, 384, torch.bfloat16),
               (2, 301, 3, 64, 100, torch.float32),
               (2, 301, 3, 64, 100, torch.bfloat16)]


def _mlstm_inputs(B, S, H, dk, dv, dtype, device, seed=0):
    """As the reference's kernel tests draw them (forget gates shifted by
    +2); the gates as the two halves of one (B, S, 2H) projection, as
    ``models.xlstm`` splits them."""
    g = torch.Generator(device=device).manual_seed(seed)

    def normal(*shape):
        return torch.randn(shape, generator=g, device=device)

    q, k, v = (normal(B, S, H, n).to(dtype) for n in (dk, dk, dv))
    gif = normal(B, S, 2 * H)
    gif[..., H:] += 2.0
    i_gate, f_gate = gif.chunk(2, dim=-1)
    return q, k, v, i_gate, f_gate


@pytest.mark.parametrize("B,S,H,dk,dv,dtype", MLSTM_CASES)
def test_mlstm_kernel_equals_plain(card, B, S, H, dk, dv, dtype):
    """h and the last state within the reference's 1e-4 (rtol and atol) of
    the plain version at the model's 256-step chunk (the kernel walks its
    own 64), and of the plain version of the kernel's two-pass form."""
    inputs = _mlstm_inputs(B, S, H, dk, dv, dtype, card)
    assert not inputs[3].is_contiguous()
    before = mlstm.launches
    h, state = ops.mlstm_chunkwise(*inputs, chunk=256, h_dtype=torch.float32)
    torch.cuda.synchronize()
    assert mlstm.launches == before + 1
    for h_want, st_want in (mlstm.mlstm_chunkwise_plain(*inputs, chunk=256),
                            mlstm.mlstm_two_pass_plain(*inputs)):
        torch.testing.assert_close(h, h_want, rtol=1e-4, atol=1e-4)
        for name in ("C", "n", "m"):
            torch.testing.assert_close(state[name], st_want[name],
                                       rtol=1e-4, atol=1e-4)
    h_q, _ = ops.mlstm_chunkwise(*inputs, chunk=256)
    assert h_q.dtype == dtype and torch.equal(h_q, h.to(dtype))


@pytest.mark.parametrize("name,entries", [("slstm", 16), ("mlstm", 6)])
def test_xlstm_builds_have_no_spills(card, name, entries):
    """nvcc's -Xptxas -v report for the sLSTM kernel (4 units-per-block x 4
    k-per-lane instantiations) and the mLSTM kernels (scores, carry and
    outputs, float32 and bfloat16): no spills and no stack frame, so no
    array of the products' sums lives in local memory."""
    from repro_torch.kernels import build
    build.build([name])
    log = build.log_path(name).read_text()
    frames = [line for line in log.splitlines() if "stack frame" in line]
    assert len(frames) == entries, log
    assert all("0 bytes stack frame, 0 bytes spill stores, 0 bytes spill "
               "loads" in line for line in frames), log


def test_mlstm_kernel_refuses_what_it_does_not_take(card):
    inputs = list(_mlstm_inputs(1, 8, 2, 8, 8, torch.float32, card))
    with pytest.raises(TypeError, match="bfloat16"):
        mlstm.mlstm_chunkwise_bshd(*(t.half() for t in inputs))
    with pytest.raises(ValueError, match="dk=320"):
        mlstm.mlstm_chunkwise_bshd(*_mlstm_inputs(1, 8, 1, 320, 8,
                                                  torch.float32, card))
    inputs[0] = inputs[0].requires_grad_(True)
    with pytest.raises(RuntimeError, match="no gradient"):
        mlstm.mlstm_chunkwise_bshd(*inputs)
    inputs[0] = inputs[0].detach().cpu()
    with pytest.raises(ValueError, match="CPU or CUDA"):
        mlstm.mlstm_chunkwise_bshd(*inputs)


def test_xlstm_backend_signature_launches_the_kernels(card):
    """A reduced xlstm-125m, one mLSTM and one sLSTM layer: a signature call
    launches the mLSTM, sLSTM and signature kernels once each; training
    launches none of them."""
    cfg = reduced(get_config("xlstm-125m"), d_model=256)
    cfg = dataclasses.replace(cfg, n_layers=2, stages=(Stage(
        (LayerSpec(kind="mlstm", ffn="none"),
         LayerSpec(kind="slstm", ffn="none")), 1),))
    backend = LMBackend(cfg, batch_size=4, seq_len=64, device=card)
    params = backend.init(torch.Generator(device=card).manual_seed(0))
    stream = make_lm_dataset(vocab=cfg.vocab_size, n_tokens=4000)
    counts = lambda: (mlstm.launches, slstm.launches,  # noqa: E731
                      sig.launches)
    c0 = counts()
    params, _ = backend.train_local(params, stream, epochs=1)
    assert counts() == c0
    out = backend.signature(params, stream)
    assert out.shape == (64,) and np.all((out >= 0) & (out <= 1))
    assert counts() == (c0[0] + 1, c0[1] + 1, c0[2] + 1)
    cpu = LMBackend(cfg, batch_size=4, seq_len=64, device="cpu")
    cpu_sig = cpu.signature(tree_map(lambda p: p.cpu(), params), stream)
    assert np.sum(np.abs(cpu_sig - out) > 0) <= 4


def test_xlstm_backend_evaluates_batch_43(card):
    """``LMBackend(xlstm-125m, batch_size=43).evaluate`` on the card: the
    first sLSTM kernel refused batches above 42 at this width.  The kernel
    forward (3 sLSTM launches, one a layer) is finite and agrees with the
    plain forward on the same batch within the xLSTM path's tolerance
    (logits within 5% of the largest, with float32 products), and so do
    the two accuracies, up to the rows whose argmax differs."""
    from repro_torch.models import transformer as tfm
    from repro_torch.runtime import Runtime
    cfg = dataclasses.replace(get_config("xlstm-125m"),
                              compute_dtype="float32")
    backend = LMBackend(cfg, batch_size=43, seq_len=64, device=card)
    params = backend.init(torch.Generator(device=card).manual_seed(0))
    stream = make_lm_dataset(vocab=2048, n_tokens=20_000)
    before = slstm.launches
    acc = backend.evaluate(params, stream)
    assert slstm.launches == before + 3
    assert np.isfinite(acc) and 0.0 <= acc <= 1.0
    batch = backend._batch(backend._sample(stream, np.random.default_rng(1),
                                           1)[0])
    with torch.inference_mode():
        k_logits, _ = tfm.forward(params, batch, cfg, Runtime(
            use_kernels=True))
        p_logits, _ = tfm.forward(params, batch, cfg, Runtime())
    assert bool(torch.isfinite(k_logits).all())
    scale = p_logits.abs().max().item()
    assert (k_logits - p_logits).abs().max().item() <= 0.05 * scale
    plain_acc = float((p_logits.argmax(-1) == batch["labels"]).float()
                      .mean())
    differ = float((k_logits.argmax(-1) != p_logits.argmax(-1)).float()
                   .mean())
    assert abs(acc - plain_acc) <= differ + 1e-6


def _cohort_world(sizes=(40, 200, 90), seed=11):
    """VGG_TINY's ragged shards for the cohort engine (different batch
    counts per client, so the window has masked steps)."""
    from repro_torch.data.synthetic import Dataset, split_811
    train = split_811(make_benchmark_dataset("mnist", 900))["train"]
    rng = np.random.default_rng(seed)
    shards = []
    for s in sizes:
        idx = rng.choice(len(train), size=s, replace=False)
        shards.append(Dataset(train.x[idx], train.y[idx]))
    return shards


def test_cohort_train_equals_sequential_on_card(card):
    """The cohort's batched products against ``train_local``'s
    convolutions on the card, within the reference's 5e-3, on ragged
    shards; and the engine's validation against ``evaluate``."""
    from repro_torch.core.aggregate import tree_leaves
    from repro_torch.fl.cohort import CohortBackend
    backend = CNNBackend(vgg_for("mnist"), local_epochs=2, batch_size=32,
                         device=card)
    shards = _cohort_world()
    params = [backend.init(torch.Generator().manual_seed(i))
              for i in range(3)]
    seeds = [7, 8, 9]
    engine = CohortBackend(backend)
    coh, losses = engine.train_cohort(params, shards, seeds)
    for k, (p, ds, s) in enumerate(zip(params, shards, seeds)):
        solo, loss = backend.train_local(p, ds, seed=s)
        for a, b in zip(tree_leaves(solo), tree_leaves(coh[k])):
            assert b.is_cuda
            assert torch.allclose(a, b, rtol=0, atol=5e-3), f"client {k}"
        assert abs(losses[k] - loss) < 5e-2
    accs = engine.evaluate_cohort(coh, shards)
    for acc, model, ds in zip(accs, coh, shards):
        assert abs(acc - backend.evaluate(model, ds)) <= 1e-6


def test_cohort_signatures_launch_once_per_client_on_vec(card):
    """One signature launch per client of the window, every one on the vec
    route, no plain call; rows equal to the sequential path's."""
    from repro_torch.fl.cohort import CohortBackend
    from repro_torch.data.synthetic import make_image_dataset
    backend = CNNBackend(vgg_for("cifar10", tiny=False), device=card)
    ds = make_image_dataset("cifar10", 400, 10, 32, 3, 0.55)
    shards = [ds, type(ds)(ds.x[:300], ds.y[:300]),
              type(ds)(ds.x[:90], ds.y[:90])]
    params = [backend.init(torch.Generator().manual_seed(i))
              for i in range(3)]
    engine = CohortBackend(backend)
    before = (sig.launches, sig.launches_vec, sig.launches_strided)
    plain = sig.signature_counts_plain
    sig.signature_counts_plain = None          # any plain call fails
    try:
        got = engine.signature_cohort(params, shards)
    finally:
        sig.signature_counts_plain = plain
    after = (sig.launches, sig.launches_vec, sig.launches_strided)
    assert [a - b for a, b in zip(after, before)] == [3, 3, 0]
    for k, (p, d) in enumerate(zip(params, shards)):
        want = backend.signature(p, d)
        assert got[k].shape == want.shape == (64,)
        np.testing.assert_allclose(got[k], want, rtol=1e-6, atol=0)


def test_cohort_signature_launch_failure_raises(card, monkeypatch):
    """A failed kernel launch inside the window's signatures raises; no
    plain version takes over."""
    from repro_torch.fl.cohort import CohortBackend

    class Failing:
        def repro_signature_counts(self, *args):
            return 700

        def repro_cuda_error_string(self, err):
            return b"injected failure"

    backend = CNNBackend(vgg_for("mnist"), device=card)
    shards = _cohort_world()
    params = [backend.init(torch.Generator().manual_seed(i))
              for i in range(3)]
    engine = CohortBackend(backend)
    monkeypatch.setattr(sig, "_library", lambda: Failing())
    before = sig.launches
    with pytest.raises(RuntimeError, match="injected failure"):
        engine.signature_cohort(params, shards)
    assert sig.launches == before


def test_prefetched_window_equals_inline_on_card(card):
    """A window assembled on the worker thread and copied on the
    assembler's stream equals one assembled inline, bit for bit, and is
    ready on the consumer's stream."""
    from repro_torch.fl.cohort import CohortBackend
    backend = CNNBackend(vgg_for("mnist"), local_epochs=2, batch_size=32,
                         device=card)
    shards = _cohort_world()
    early = CohortBackend(backend, overlap=True).assembler
    inline = CohortBackend(backend, overlap=False).assembler
    early.prefetch(shards, [3, 4, 5], 2)
    got = early.take(shards, [3, 4, 5], 2)
    want = inline.take(shards, [3, 4, 5], 2)
    assert got.ready is not None and got.xb.is_cuda
    assert got.steps == want.steps and not got.uniform
    for name in ("xb", "yb", "mask"):
        assert torch.equal(getattr(got, name), getattr(want, name))
    early.close()


def test_scenario_transform_on_card(card):
    """The scenario update transform on the card: its noise generator lives
    there, a window equals the single calls bit for bit, the unaffected
    row and the integer leaves keep their bits."""
    from repro_torch.core.aggregate import tree_leaves, tree_stack
    from repro_torch.fl.cohort import (_perturb_generators,
                                       perturb_cohort_stacked_trees,
                                       perturb_update)
    gen, seeds = _perturb_generators(0, 1, 2, 3, card)
    assert gen.device.type == card.type and len(seeds) == 3
    backend = CNNBackend(vgg_for("cifar10"), device=card)
    models = [backend.init(torch.Generator().manual_seed(i))
              for i in range(5)]
    for m in models:
        m["steps"] = torch.arange(4, device=card, dtype=torch.int32)
    agg, news = models[0], models[1:]
    plan = {"seed": 3, "clients": np.array([0, 1, 2, 3]),
            "seqs": np.array([0, 1, 0, 5]),
            "gammas": np.array([-4.0, 0.0, 1.0, 1.0], np.float32),
            "sigmas": np.array([0.0, 0.01, 0.05, 0.0], np.float32),
            "affected": np.array([True, True, True, False])}
    window = perturb_cohort_stacked_trees(tree_stack([agg] * 4),
                                          tree_stack(news), plan)
    for k in range(3):
        single = perturb_update(agg, news[k], plan, k)
        for a, b in zip(tree_leaves(single), tree_leaves(window)):
            assert a.device.type == card.type and torch.equal(a, b[k])
    for a, b in zip(tree_leaves(news[3]), tree_leaves(window)):
        assert torch.equal(a, b[3])
    assert torch.equal(window["steps"],
                       torch.arange(4, device=card).repeat(4, 1).int())
    # the noise differs from the noiseless transform on the noised rows
    quiet = dict(plan, sigmas=np.zeros(4, np.float32))
    calm = perturb_cohort_stacked_trees(tree_stack([agg] * 4),
                                        tree_stack(news), quiet)
    assert not torch.equal(calm["fcs"][0]["w"][2], window["fcs"][0]["w"][2])
    assert torch.equal(calm["fcs"][0]["w"][0], window["fcs"][0]["w"][0])


@pytest.mark.parametrize("name,rounds", [("fedavg", 2), ("dagafl", 6)])
def test_baseline_on_the_cohort_engine_on_card(card, monkeypatch, name,
                                               rounds):
    """fedavg and DAG-AFL at VGG_TINY on the card's cohort engine
    (``cohort_size=3``): the expected rounds and windows, the models on
    the card."""
    from repro_torch.core.aggregate import tree_leaves
    from repro_torch.data.partition import partition_dirichlet
    from repro_torch.data.synthetic import split_811
    from repro_torch.fl import ALGORITHMS, FLConfig
    from repro_torch.fl.cohort import CohortBackend

    splits = split_811(make_benchmark_dataset("mnist", 900))
    data = []
    for p in partition_dirichlet(splits["train"], 3, beta=0.5, seed=0):
        s = split_811(p, seed=1)
        data.append({"train": s["train"], "val": s["val"],
                     "test": s["test"]})
    backend = CNNBackend(vgg_for("mnist"), local_epochs=1, batch_size=32,
                         device=card)
    windows, evaluated = [], []
    inner_train = CohortBackend.train_cohort_stacked
    inner_eval = backend.evaluate

    def train(self, stacked, datasets, *args, **kwargs):
        windows.append(len(datasets))
        return inner_train(self, stacked, datasets, *args, **kwargs)

    def evaluate(model, *args, **kwargs):
        evaluated.append(all(t.device.type == card.type
                             for t in tree_leaves(model)))
        return inner_eval(model, *args, **kwargs)

    monkeypatch.setattr(CohortBackend, "train_cohort_stacked", train)
    monkeypatch.setattr(backend, "evaluate", evaluate)
    res = ALGORITHMS[name](backend, data, splits["test"],
                           FLConfig(n_clients=3, max_rounds=2,
                                    local_epochs=1, patience=10 ** 6,
                                    cohort_size=3, cohort_window=2.0))
    assert res.rounds == rounds
    assert 0.0 <= res.final_accuracy <= 1.0
    assert evaluated and all(evaluated)
    if name == "fedavg":
        assert windows == [3, 3]
    else:
        assert res.extra["chain_len"] == 7
        assert res.extra["cohorts_dispatched"] == len(windows) >= 1


def _lm_cohort_config(family):
    """A reduced LM family at d_model 256 in float32: internlm2, the Jamba
    hybrid (one Mamba and one attention layer) or the ``(mlstm, slstm)``
    xLSTM."""
    if family == "internlm2":
        return reduced(get_config("internlm2-1.8b"), d_model=256)
    arch, kinds, ffn = (("jamba-v0.1-52b", ("mamba", "attn"), "dense")
                        if family == "hybrid" else
                        ("xlstm-125m", ("mlstm", "slstm"), "none"))
    return dataclasses.replace(
        reduced(get_config(arch), d_model=256), n_layers=2,
        stages=(Stage(tuple(LayerSpec(kind=k, ffn=ffn) for k in kinds), 1),))


@pytest.mark.parametrize("family", ["internlm2", "hybrid", "xlstm"])
def test_lm_cohort_window_equals_plain_on_card(card, family, monkeypatch):
    """An ``LMCohortPrograms`` window on the card: training (vmapped, under
    autograd) against ``train_local`` within 1e-4; validation and
    signatures on the kernels (one signature launch a client, each layer's
    kernel once a client) against the same window with every kernel entry
    point swapped for its plain version: the same correct counts up to
    argmax flips, signatures within two flags a bucket."""
    from repro_torch.core.aggregate import tree_leaves
    from repro_torch.fl.cohort import CohortBackend, LMCohortPrograms
    cfg = _lm_cohort_config(family)
    backend = LMBackend(cfg, local_steps=2, batch_size=4, seq_len=64,
                        device=card)
    engine = CohortBackend(backend)
    assert isinstance(engine.programs, LMCohortPrograms)
    streams = [make_lm_dataset(vocab=cfg.vocab_size, n_tokens=4000, seed=c)
               for c in range(3)]
    params = [backend.init(torch.Generator(device=card).manual_seed(i))
              for i in range(3)]
    seeds = [7, 8, 9]
    trained, losses = engine.train_cohort(params, streams, seeds)
    for k, (p, ds, s) in enumerate(zip(params, streams, seeds)):
        solo, loss = backend.train_local(p, ds, seed=s)
        for a, b in zip(tree_leaves(solo), tree_leaves(trained[k])):
            assert b.is_cuda
            torch.testing.assert_close(b, a, rtol=0, atol=1e-4)
        assert abs(losses[k] - loss) < 1e-5
    mods = (sig, fa, ss, mlstm, slstm)
    before = [m.launches for m in mods]
    accs = engine.evaluate_cohort(trained, streams)
    sigs = engine.signature_cohort(trained, streams)
    many = engine.evaluate_many(trained + trained[:1], streams[0])
    launched = [m.launches - b for m, b in zip(mods, before)]
    kinds = [spec.kind for spec in cfg.layer_specs()]
    forwards = 3 + 3 + 4                  # cohort, signatures, M = 4
    assert launched == [3, kinds.count("attn") * forwards,
                        kinds.count("mamba") * forwards,
                        kinds.count("mlstm") * forwards,
                        kinds.count("slstm") * forwards], launched
    for name, plain in (("signature_counts", sig.signature_counts_plain),
                        ("flash_attention_bhsd", fa.flash_attention_plain),
                        ("selective_scan_bsd", ss.selective_scan_plain),
                        ("mlstm_chunkwise_bshd", mlstm.mlstm_chunkwise_plain),
                        ("slstm_scan_bsd", slstm.slstm_scan_plain)):
        monkeypatch.setattr(ops, name, plain)
    plain_accs = engine.evaluate_cohort(trained, streams)
    plain_sigs = engine.signature_cohort(trained, streams)
    plain_many = engine.evaluate_many(trained + trained[:1], streams[0])
    assert [m.launches - b for m, b in zip(mods, before)] == launched
    n = 4 * 64
    for got, want in ((accs, plain_accs), (many, plain_many)):
        assert all(abs(a - b) * n <= 2.5 for a, b in zip(got, want))
    assert sigs.shape == plain_sigs.shape == (3, 64)
    flag = 1 / (n * cfg.d_model // 64)   # one flag of a bucket's mean
    assert np.abs(sigs - plain_sigs).max() <= 2 * flag + 1e-7


def _serve_config(family):
    """A reduced float32 member of each LM family with every block kind
    the serving path runs: attention (internlm2), Mamba and attention
    (the Jamba cut), mLSTM and sLSTM (xLSTM).  d_model 128 gives the
    attention layers a head_dim of 32, the flash kernels' smallest."""
    if family == "internlm2":
        cfg = reduced(get_config("internlm2-1.8b"), d_model=128)
    elif family == "hybrid":
        cfg = dataclasses.replace(
            reduced(get_config("jamba-v0.1-52b"), d_model=128), n_layers=2,
            stages=(Stage((LayerSpec(kind="mamba", ffn="dense"),
                           LayerSpec(kind="attn", ffn="dense")), 1),))
    else:
        cfg = dataclasses.replace(
            reduced(get_config("xlstm-125m"), d_model=64), n_layers=2,
            stages=(Stage((LayerSpec(kind="mlstm", ffn="none"),
                           LayerSpec(kind="slstm", ffn="none")), 1),))
    return dataclasses.replace(cfg, compute_dtype="float32",
                               cache_dtype="float32")


def _same_state(got: dict, want: dict, tol: float = 1e-4) -> None:
    """One layer's caches within ``tol`` (relative to the values).  The
    mLSTM state (C, n) is defined up to its stabiliser m, which depends on
    the chunking (the kernel's 64-step chunks, the model's own form's
    ``xlstm.chunk``): C and n are compared at the plain form's m."""
    scale = torch.exp(got["m"] - want["m"]) if "C" in got else None
    for key, b in want.items():
        a = got[key]
        if scale is not None and key == "m":
            continue
        if scale is not None and key in ("C", "n"):
            a = a * scale.reshape(scale.shape + (1,) * (a.dim()
                                                       - scale.dim()))
        assert a.shape == b.shape, key
        assert bool(((a - b).abs() <= tol + tol * b.abs()).all()), (
            key, (a - b).abs().max().item())


@pytest.mark.parametrize("family", ["internlm2", "hybrid", "xlstm"])
def test_serve_prefill_kernels_equal_plain_on_card(card, family):
    """Prefill on the kernels (flash, scan, mLSTM, sLSTM) against prefill
    on the plain versions, on the card: the last logits and every cache
    within 1e-4; then a decode step from each prefill's caches, within
    1e-4 of each other (the hand-over of the kernels' final states); each
    kernel launched once per layer of its kind (and flash on the float32
    FMA route)."""
    from repro_torch.launch.serve import extend_caches
    from repro_torch.models import transformer as tfm
    from repro_torch.runtime import Runtime, serve_runtime
    cfg = _serve_config(family)
    params = tfm.init_params(torch.Generator(device=card).manual_seed(0),
                             cfg)
    tokens = torch.randint(0, cfg.vocab_size, (3, 70), device=card,
                           generator=torch.Generator(device=card)
                           .manual_seed(1))
    kinds = [s.kind for s in cfg.layer_specs()]
    counters = {"attn": fa, "mamba": ss, "mlstm": mlstm, "slstm": slstm}
    before = {k: counters[k].launches for k in sorted(set(kinds))}
    fma = fa.launches_fma
    with torch.inference_mode():
        k_logits, k_caches, _ = tfm.prefill(params, {"tokens": tokens}, cfg,
                                            serve_runtime())
        torch.cuda.synchronize()
        for kind in sorted(set(kinds)):
            assert counters[kind].launches == before[kind] + kinds.count(kind)
        assert fa.launches_fma - fma == kinds.count("attn")
        p_logits, p_caches, _ = tfm.prefill(params, {"tokens": tokens}, cfg,
                                            Runtime())
        assert (k_logits - p_logits).abs().max().item() <= 1e-4
        for k_stage, p_stage in zip(k_caches, p_caches):
            assert sorted(k_stage) == sorted(p_stage)
            for name in k_stage:
                _same_state(k_stage[name], p_stage[name])
        tok = p_logits.argmax(-1)[:, None]
        steps = []
        for caches in (k_caches, p_caches):
            caches = extend_caches(caches, cfg, 1)
            logits, _ = tfm.decode_step(params, tok, caches, 70, cfg)
            steps.append(logits)
        assert bool(torch.isfinite(steps[0]).all())
        assert (steps[0] - steps[1]).abs().max().item() <= 1e-4


def test_whisper_prefill_and_decode_on_card_equal_cpu(card):
    """Reduced whisper-medium (2 encoder layers over 16 frames, 2 decoder
    layers with cross-attention) in float32: the prefill on the kernels
    and 4 greedy decode steps on the card against the same on the CPU
    (the plain versions): every step's logits and the caches, the cross
    caches among them, within 1e-4 (float32 products in another order),
    the greedy tokens equal; flash once a decoder layer on the FMA route,
    never in the encoder; the cross caches unchanged by the decode."""
    from repro_torch.launch.serve import extend_caches
    from repro_torch.models import transformer as tfm
    from repro_torch.runtime import serve_runtime
    cfg = reduced(get_config("whisper-medium"))
    params = tfm.init_params(torch.Generator().manual_seed(0), cfg)
    gen = torch.Generator().manual_seed(1)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 12),
                                     generator=gen),
             "enc_embed": torch.randn((2, cfg.encoder.n_ctx, cfg.d_model),
                                      generator=gen) * 0.1}
    runs = []
    for device in ("cpu", card):
        p = tree_map(lambda a: a.to(device), params)
        b = {k: v.to(device) for k, v in batch.items()}
        fma = fa.launches_fma
        with torch.inference_mode():
            logits, caches, _ = tfm.prefill(p, b, cfg, serve_runtime())
            if torch.device(device).type == "cuda":
                torch.cuda.synchronize()
                assert fa.launches_fma - fma == 2
            cross = [c["l0"][key].clone() for c in caches
                     for key in ("xk", "xv")]
            caches = extend_caches(caches, cfg, 4)
            steps, tokens = [logits], [logits.argmax(-1)]
            for i in range(4):
                logits, caches = tfm.decode_step(
                    p, tokens[-1].to(torch.int32)[:, None], caches, 12 + i,
                    cfg)
                steps.append(logits)
                tokens.append(logits.argmax(-1))
        assert all(torch.equal(a, c["l0"][key]) for a, (c, key) in zip(
            cross, [(c, key) for c in caches for key in ("xk", "xv")]))
        runs.append((torch.stack(steps).cpu(), torch.stack(tokens).cpu(),
                     [a.float().cpu() for c in caches
                      for a in c["l0"].values()]))
    (cpu_logits, cpu_tokens, cpu_caches), (got, tokens, caches) = runs
    assert (got - cpu_logits).abs().max().item() <= 1e-4
    assert torch.equal(tokens, cpu_tokens)
    for a, b in zip(caches, cpu_caches):
        assert a.shape == b.shape
        assert (a - b).abs().max().item() <= 1e-4


@pytest.mark.parametrize("name", ["sgd", "sgd_momentum", "adamw",
                                  "adamw_bf16"])
def test_optimizer_steps_on_card_equal_cpu(card, name):
    """Four optimizer steps on 4,096 float32 parameters on the card equal
    the same steps on the CPU bit for bit, the parameters and the stored
    moments (float32, and bfloat16 with ``adamw_bf16``; the CPU's equal
    the jitted reference's, ``test_torch_train.py``): CUDA's ``add`` with
    ``alpha`` is one fused multiply-add, as the CPU kernel's."""
    from repro_torch.optim import optimizers as topt
    make = {"sgd": lambda: topt.sgd(0.05),
            "sgd_momentum": lambda: topt.sgd(0.05, 0.9, 0.01),
            "adamw": lambda: topt.adamw(1e-2, weight_decay=0.1),
            "adamw_bf16": lambda: topt.adamw(
                1e-2, weight_decay=0.1, moment_dtype=torch.bfloat16)}[name]
    rng = np.random.default_rng(0)
    p0 = torch.from_numpy(rng.standard_normal(4096).astype(np.float32))
    grads = [torch.from_numpy((rng.standard_normal(4096) * 0.5)
                              .astype(np.float32)) for _ in range(4)]
    out = []
    for device in ("cpu", card):
        opt, p = make(), p0.clone().to(device)
        state = opt.init(p)
        for g in grads:
            upd, state = opt.update(g.to(device), state, p)
            topt.apply_updates(p, upd)
        out.append((p.cpu(), {k: v.cpu() for k, v in state.items()
                              if isinstance(v, torch.Tensor)}))
    (p_cpu, s_cpu), (p_card, s_card) = out
    assert torch.equal(p_cpu, p_card)
    # the stored moments too (bfloat16 with ``adamw_bf16``)
    assert sorted(s_cpu) == sorted(s_card)
    for key in s_cpu:
        assert s_card[key].dtype == s_cpu[key].dtype
        assert torch.equal(s_cpu[key], s_card[key]), key


@pytest.mark.parametrize("generous", [False, True])
def test_moe_layer_on_card_equals_cpu(card, generous):
    """The MoE layer at Jamba's width (d_model 4,096, 16 experts of
    14,336, top-2) on 2 x 40 tokens in float32: the card's routing equal
    to the CPU's (dispatch bit for bit, the same kept share), the output
    within 1e-4 and ``moe_aux`` within 1e-5 relative (float32 products in
    another order)."""
    from repro_torch.models import moe
    cfg = dataclasses.replace(get_config("jamba-v0.1-52b"),
                              compute_dtype="float32")
    params = moe.init_moe(torch.Generator(device=card).manual_seed(0), cfg,
                          torch.float32)
    x = torch.randn((2, 40, cfg.d_model), device=card,
                    generator=torch.Generator(device=card).manual_seed(1))
    routes = []
    inner = moe.topk_dispatch

    def kept(probs, k, cap):
        out = inner(probs, k, cap)
        routes.append(out[1].cpu())
        return out

    moe.topk_dispatch = kept
    try:
        with torch.no_grad():
            got, aux = moe.moe_forward(params, x, cfg=cfg,
                                       generous_capacity=generous)
            want, want_aux = moe.moe_forward(
                tree_map(lambda a: a.cpu(), params), x.cpu(), cfg=cfg,
                generous_capacity=generous)
    finally:
        moe.topk_dispatch = inner
    assert torch.equal(routes[0], routes[1])
    assert torch.equal(aux["expert_load"].cpu(), want_aux["expert_load"])
    assert (got.cpu() - want).abs().max().item() <= 1e-4
    assert float(aux["moe_aux"]) == pytest.approx(float(want_aux["moe_aux"]),
                                                  rel=1e-5)


@pytest.mark.parametrize("E", [4, 16, 128])
def test_argmax_takes_the_first_of_ties_on_card(card, E):
    """The MoE routing's tie rule on the card: ``argmax`` over the last
    axis returns the first largest index, as on the CPU and as
    ``jnp.argmax`` (uniform rows, the padded tokens', go to expert 0), over
    4,096 rows of ties at several places."""
    rows = torch.rand((4096, E), device=card) * 0.5
    rows[::3] = 1.0 / E                                # uniform
    tied = torch.arange(1, 4096, 3, device=card)
    first = (tied * 7) % E
    rows[tied] = 0.1
    rows[tied, first] = 0.6
    rows[tied, E - 1] = 0.6                            # and the last
    got = rows.argmax(-1).cpu()
    assert torch.equal(got, rows.cpu().argmax(-1))
    assert bool((got[::3] == 0).all())
    assert torch.equal(got[1::3], first.cpu())


@pytest.mark.parametrize("chunk", [1 << 10, 1 << 25])
def test_model_store_in_host_memory_round_trip_on_card(card, chunk):
    """A store in host memory: ``put`` copies a card model to the host
    through the pinned staging buffers (chunk sizes that split the leaves
    and that hold them whole), ``get`` copies it back to the card bit for
    bit, a changed copy leaves the stored model as it was, and the
    streamed Eq. 6 on the card equals ``tree_mean`` over the fetched
    models bit for bit."""
    from repro_torch.core.aggregate import tree_leaves, tree_mean
    from repro_torch.core.dag import ModelStore, PinnedStaging
    g = torch.Generator(device=card).manual_seed(3)
    models = [{"w": torch.randn(1000, 37, generator=g, device=card),
               "b": [torch.randn(3, generator=g, device=card),
                     torch.randint(0, 9, (5,), device=card)],
               "h": torch.randn(4, 4, generator=g, device=card).half()}
              for _ in range(3)]
    store = ModelStore("cpu")
    store._staging = PinnedStaging(chunk)
    refs = [store.put(f"m{i}", m) for i, m in enumerate(models)]
    assert store.readings()["resting_devices"] == ["cpu"]
    for ref, model in zip(refs, models):
        back = store.get(ref, card)
        assert all(a.device == b.device and torch.equal(a, b) for a, b in
                   zip(tree_leaves(back), tree_leaves(model)))
        for leaf in tree_leaves(back):
            leaf.add_(1)
        assert all(torch.equal(a.cpu(), b.cpu()) for a, b in zip(
            tree_leaves(store.get(ref, card)), tree_leaves(model)))
    want = tree_mean([store.get(r, card) for r in refs])
    got = store.mean(refs, card)
    assert all(a.device == b.device and torch.equal(a, b)
               for a, b in zip(tree_leaves(got), tree_leaves(want)))
    readings = store.readings()
    assert readings["in_bytes"] == readings["resting_bytes"] > 0
    assert readings["out_bytes"] > 0 and readings["out_s"] > 0
    # a store resting on the card ("cuda", no index) keeps the model it
    # was given and hands out copies
    on_card = ModelStore("cuda")
    on_card.put("m", models[0])
    assert on_card.readings()["in_bytes"] == 0
    assert on_card.readings()["resting_devices"] == [
        str(models[0]["w"].device)]
    got = on_card.get("m", "cuda")
    assert all(a.data_ptr() != b.data_ptr() and torch.equal(a, b)
               for a, b in zip(tree_leaves(got), tree_leaves(models[0])))

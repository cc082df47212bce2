"""Guards around the PyTorch port: what it may import, where it runs, and
that a CUDA tensor never takes a kernel's plain version.

These tests need no JAX: they read the port's sources and exercise its
device and build plumbing with fakes, so they run on any host.
"""
import ast
import os
import stat
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import runtime  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.configs.cnn import VGG_TINY  # noqa: E402
from repro_torch.core.coordinator import DagAflConfig, DagAflCoordinator  # noqa: E402
from repro_torch.fl.backend import CNNBackend, LMBackend  # noqa: E402
from repro_torch.fl.cohort import build_cohort_engine  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import mlstm  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import selective_scan as ss  # noqa: E402
from repro_torch.kernels import signature as sig  # noqa: E402
from repro_torch.kernels import slstm  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((REPO / "src" / "repro_torch").rglob("*.py")) + \
    [REPO / "chip_smoke.py"]
FORBIDDEN = {"jax", "jaxlib", "repro"}


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module \
                and node.level == 0:
            yield node.lineno, node.module.split(".")[0]


def test_port_imports_neither_jax_nor_reference_package():
    names = {p.name for p in PORT_FILES}
    assert len(PORT_FILES) >= 30
    assert {"attention.py", "transformer.py", "layers.py",
            "flash_attention.py", "internlm2_1_8b.py", "mamba.py",
            "selective_scan.py", "jamba_v01_52b.py", "xlstm.py",
            "mlstm.py", "slstm.py", "xlstm_125m.py", "cohort.py",
            "pipeline.py", "baselines.py", "scenarios.py"} <= names
    csrc = REPO / "src" / "repro_torch" / "kernels" / "csrc"
    assert {p.name for p in csrc.glob("*.cu")} == {
        f"{name}.cu" for name in build.SOURCES}
    assert "flash_attention_sm90.cu" in {p.name for p in csrc.glob("*.cu")}
    bad = [f"{p.relative_to(REPO)}:{line} imports {root}"
           for p in PORT_FILES for line, root in _imported_roots(p)
           if root in FORBIDDEN]
    assert not bad, "\n".join(bad)


def test_training_and_lm_cohort_modules_import_no_jax():
    """The launcher, the train step, the checkpoints, the optimizers, the
    token pipeline and the LM cohort suite are the port's own."""
    port = REPO / "src" / "repro_torch"
    files = [port / "launch" / "train.py", port / "train" / "step.py",
             port / "train" / "checkpoint.py",
             port / "optim" / "optimizers.py", port / "data" / "pipeline.py",
             port / "fl" / "cohort.py", port / "models" / "transformer.py"]
    assert all(p in PORT_FILES for p in files)
    bad = [f"{p.name}:{line} imports {root}" for p in files
           for line, root in _imported_roots(p) if root in FORBIDDEN]
    assert not bad, bad


def test_serving_modules_import_no_jax():
    """The serve launcher and live serving are the port's own."""
    port = REPO / "src" / "repro_torch"
    files = [port / "launch" / "serve.py", port / "fl" / "serving.py"]
    assert all(p in PORT_FILES for p in files)
    bad = [f"{p.name}:{line} imports {root}" for p in files
           for line, root in _imported_roots(p) if root in FORBIDDEN]
    assert not bad, bad


def test_serve_without_device_raises_where_cuda_is_absent(monkeypatch):
    """``launch.serve.serve`` runs on the card unless the CPU is asked
    for."""
    from repro_torch.launch import serve
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = reduced(get_config("internlm2-1.8b"), d_model=64)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.serve(cfg, 1, 4, 2)


@pytest.mark.parametrize("size,built", [(2, True), (1, False)])
def test_lm_backend_runs_on_the_cohort_engine(size, built):
    """An ``LMBackend`` gets the LM suite wherever ``cohort_size > 1``, and
    a coordinator over it takes the engine."""
    from repro_torch.fl.cohort import LMCohortPrograms
    cfg = reduced(get_config("internlm2-1.8b"), d_model=64)
    backend = LMBackend(cfg, device="cpu")
    engine = build_cohort_engine(backend, cohort_size=size)
    assert (engine is not None) == built
    if built:
        assert isinstance(engine.programs, LMCohortPrograms)
        stream = np.arange(2000, dtype=np.int32) % cfg.vocab_size
        coord = DagAflCoordinator(
            backend, [{"train": stream, "val": stream, "test": stream}] * 2,
            stream, DagAflConfig(n_clients=2, cohort_size=size))
        assert isinstance(coord.cohort.programs, LMCohortPrograms)


def test_backend_without_device_raises_where_cuda_is_absent(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        CNNBackend(VGG_TINY)
    assert CNNBackend(VGG_TINY, device="cpu").device == torch.device("cpu")


def test_lm_backend_without_device_raises_where_cuda_is_absent(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = reduced(get_config("internlm2-1.8b"), d_model=64)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LMBackend(cfg)
    assert LMBackend(cfg, device="cpu").device == torch.device("cpu")


def test_cuda_device_turns_tf32_off():
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    try:
        torch.backends.cudnn.allow_tf32 = True
        torch.backends.cuda.matmul.allow_tf32 = True
        assert runtime.resolve_device("cuda") == torch.device("cuda")
        assert not torch.backends.cudnn.allow_tf32
        assert not torch.backends.cuda.matmul.allow_tf32
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved


def test_non_cpu_tensor_goes_to_the_kernel(monkeypatch):
    """The wrapper picks the plain version only for a CPU tensor; any other
    tensor goes to the kernel's launcher (a meta tensor stands in for a
    CUDA one here)."""
    launched = []

    def plain(*args, **kwargs):
        raise AssertionError("plain version called for a non-CPU tensor")

    def launch(x, tau, mean):
        launched.append(x.device)
        return torch.empty((x.shape[0], x.shape[2]), device=x.device)

    monkeypatch.setattr(sig, "signature_counts_plain", plain)
    monkeypatch.setattr(sig, "_launch", launch)
    x = torch.empty((2, 64, 8), device="meta")
    sig.signature_counts(x, 0.0)
    sig.signature_td(x[0], tau=0.05)
    ops.signature_per_channel(x.reshape(2, 8, 8, 8))
    assert [d.type for d in launched] == ["meta"] * 3


def test_non_cpu_tensor_goes_to_the_flash_kernel(monkeypatch):
    """The BSHD wrapper hands non-CPU tensors to the kernel's launcher as
    (B,H,S,hd) views, never to the plain version."""
    launched = []

    def plain(*args, **kwargs):
        raise AssertionError("plain version called for a non-CPU tensor")

    def launch(q, k, v, causal, window, softcap):
        launched.append((q.device.type, q.shape, causal, window, softcap))
        return torch.empty_like(q)

    monkeypatch.setattr(fa, "flash_attention_plain", plain)
    monkeypatch.setattr(fa, "_launch", launch)
    q = torch.empty((2, 16, 4, 32), device="meta")
    kv = torch.empty((2, 16, 2, 32), device="meta")
    out = ops.flash_attention(q, kv, kv, window=8, softcap=30.0)
    assert out.shape == q.shape
    assert launched == [("meta", (2, 4, 16, 32), True, 8, 30.0)]


def test_flash_kernel_refuses_inputs_that_need_a_gradient():
    """The kernel has no backward: under grad mode a non-CPU input that
    requires grad raises before anything launches (a meta tensor stands in
    for a CUDA one); without grad mode it gets as far as the device check."""
    q = torch.empty((1, 2, 8, 32), device="meta", requires_grad=True)
    kv = torch.empty((1, 1, 8, 32), device="meta")
    with pytest.raises(RuntimeError, match="no gradient"):
        fa.flash_attention_bhsd(q, kv, kv)
    with torch.no_grad():
        with pytest.raises(ValueError, match="CPU or CUDA"):
            fa.flash_attention_bhsd(q, kv, kv)


def _meta_bshd(B=2, S=16, n=4, hd=32, dtype=torch.bfloat16, offset=0):
    """A (B,H,S,hd) view of (B,S,H,hd) storage on the meta device, its
    base moved by ``offset`` elements."""
    x = torch.empty((B, S, n, hd + offset), device="meta", dtype=dtype)
    return x[..., offset:].transpose(1, 2)


class _FakeEntry:
    """Stands in for a route's C entry: records its calls, the device that
    was current at each (None outside a device context) and the stream it
    was given; returns ``err``."""

    def __init__(self, devices, err=0):
        self.devices, self.err, self.calls = devices, err, []

    def __call__(self, *args):
        self.calls.append((self.devices[-1] if self.devices else None,
                           args[-1]))
        return self.err

    @staticmethod
    def repro_cuda_error_string(code):
        return b"fake failure %d" % code


def _fake_libraries(monkeypatch, sm90_err=0):
    """Fake C entries for both routes, and a ``torch.cuda.device`` context
    and current stream that work for meta tensors and record the device
    each launch ran under."""
    devices = []

    class device:
        def __init__(self, dev):
            self.dev = dev

        def __enter__(self):
            devices.append(self.dev)

        def __exit__(self, *exc):
            devices.pop()

    class stream:
        cuda_stream = 1234

    entries = {"sm90": _FakeEntry(devices, sm90_err),
               "fma": _FakeEntry(devices)}
    monkeypatch.setattr(fa, "_library", lambda which: (entries[which],
                                                      entries[which]))
    monkeypatch.setattr(torch.cuda, "device", device)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda: stream)
    monkeypatch.setattr(fa, "flash_attention_plain", _no_plain)
    monkeypatch.setattr(fa, "flash_attention_tc_plain", _no_plain)
    return entries


def _no_plain(*args, **kwargs):
    raise AssertionError("a plain version was called for a non-CPU tensor")


@pytest.mark.parametrize("dtype,offset,want", [
    (torch.bfloat16, 0, "sm90"),      # 16-byte bases and strides
    (torch.bfloat16, 8, "sm90"),      # moved by 16 bytes
    (torch.bfloat16, 1, "fma"),       # moved by 2 bytes: no tensor map
    (torch.float32, 0, "fma"),        # float32 needs IEEE products
])
def test_flash_route_is_fixed_by_dtype_and_strides(monkeypatch, dtype, offset,
                                                  want):
    """The route is chosen before the launch from dtype and strides, each
    route's counter moves with its launches, and no plain version runs."""
    entries = _fake_libraries(monkeypatch)
    q = _meta_bshd(n=4, dtype=dtype, offset=offset)
    kv = _meta_bshd(n=2, dtype=dtype, offset=offset)
    out = torch.empty_like(q)
    assert fa.route(q, kv, kv, out) == want
    before = (fa.launches, fa.launches_sm90, fa.launches_fma)
    assert fa._dispatch(q, kv, kv, out, fa.route(q, kv, kv, out), True, -1,
                        0.0) is out
    assert len(entries[want].calls) == 1
    assert entries["fma" if want == "sm90" else "sm90"].calls == []
    assert (fa.launches, fa.launches_sm90, fa.launches_fma) == (
        before[0] + 1, before[1] + (want == "sm90"),
        before[2] + (want == "fma"))


def test_flash_route_needs_aligned_strides_on_every_tensor():
    """One tensor whose sequence stride is not a multiple of 16 bytes (a
    head_dim-36 storage viewed at 32) sends the call to the FMA kernel."""
    q = _meta_bshd(n=4)
    odd = torch.empty((2, 16, 2, 36), device="meta",
                      dtype=torch.bfloat16)[..., :32].transpose(1, 2)
    assert fa.route(q, _meta_bshd(n=2), odd, torch.empty_like(q)) == "fma"
    assert fa.route(q, _meta_bshd(n=2), _meta_bshd(n=2),
                    torch.empty_like(q)) == "sm90"


def test_failed_sm90_launch_raises_without_fallback(monkeypatch):
    """An error code from the Hopper kernel's entry raises; neither the
    FMA kernel nor a plain version is tried, and no counter moves."""
    entries = _fake_libraries(monkeypatch, sm90_err=2)
    q, kv = _meta_bshd(n=4), _meta_bshd(n=2)
    before = (fa.launches, fa.launches_sm90, fa.launches_fma)
    with pytest.raises(RuntimeError, match=r"\(sm90\).*fake failure 2"):
        fa._dispatch(q, kv, kv, torch.empty_like(q), "sm90", True, -1, 0.0)
    assert len(entries["sm90"].calls) == 1 and entries["fma"].calls == []
    assert (fa.launches, fa.launches_sm90, fa.launches_fma) == before


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_launches_under_the_inputs_device(monkeypatch, dtype):
    """Each route's entry is called inside a device context for the
    inputs' device, with that context's current stream, so that a tensor
    on a card that is not the current one launches on its own card."""
    entries = _fake_libraries(monkeypatch)
    q, kv = _meta_bshd(n=4, dtype=dtype), _meta_bshd(n=2, dtype=dtype)
    out = torch.empty_like(q)
    which = fa.route(q, kv, kv, out)
    assert which == ("sm90" if dtype == torch.bfloat16 else "fma")
    fa._dispatch(q, kv, kv, out, which, True, -1, 0.0)
    assert entries[which].calls == [(q.device, 1234)]


def test_sm90_route_refuses_inputs_it_cannot_address(monkeypatch):
    """Only the FMA kernel may be asked for explicitly on inputs of the
    other route (to time the two on the same bfloat16 inputs): the sm90
    kernel asked for float32 or unaligned bfloat16 raises before its entry
    is called."""
    entries = _fake_libraries(monkeypatch)
    q, kv = _meta_bshd(n=4), _meta_bshd(n=2)
    out = torch.empty_like(q)
    assert fa._dispatch(q, kv, kv, out, "fma", True, -1, 0.0) is out
    for dtype, offset in ((torch.float32, 0), (torch.bfloat16, 1)):
        q = _meta_bshd(n=4, dtype=dtype, offset=offset)
        kv = _meta_bshd(n=2, dtype=dtype, offset=offset)
        with pytest.raises(ValueError, match="sm90"):
            fa._dispatch(q, kv, kv, torch.empty_like(q), "sm90", True, -1,
                         0.0)
    assert entries["sm90"].calls == [] and len(entries["fma"].calls) == 1


def _meta_ntc(shape, dtype=torch.float32, width=None, offset=0):
    """An (N, T, C) view on the meta device of rows ``width`` elements
    wide (C by default), its base moved by ``offset`` elements."""
    n, t, c = shape
    x = torch.empty((n, t, (width or c) + offset), device="meta",
                    dtype=dtype)
    return x[..., offset:offset + c]


@pytest.mark.parametrize("what,x,want", [
    ("float32, contiguous channels", _meta_ntc((128, 1024, 64)), "vec"),
    ("bfloat16, contiguous channels", _meta_ntc((1, 4096, 768),
                                                torch.bfloat16), "vec"),
    ("bfloat16 rows of 1000", _meta_ntc((2, 300, 1000), torch.bfloat16),
     "vec"),
    ("bfloat16, base moved by 16 bytes", _meta_ntc(
        (2, 16, 64), torch.bfloat16, offset=8), "vec"),
    ("bfloat16 rows padded to 72", _meta_ntc((2, 16, 64), torch.bfloat16,
                                             width=72), "vec"),
    ("float32, base moved by 4 bytes", _meta_ntc((2, 16, 64), offset=1),
     "strided"),
    ("bfloat16, base moved by 2 bytes", _meta_ntc(
        (2, 16, 64), torch.bfloat16, offset=1), "strided"),
    ("float32 rows of 66 (264 bytes)", _meta_ntc((2, 16, 64), width=66),
     "strided"),
    ("float32, C = 63", _meta_ntc((3, 1000, 63)), "strided"),
    ("bfloat16, C = 100 (not a multiple of 8)", _meta_ntc(
        (2, 24, 100), torch.bfloat16), "strided"),
    ("float32, C = 6 in rows of 8", _meta_ntc((2, 16, 6), width=8),
     "strided"),
    ("float32, channel-major", _meta_ntc((2, 64, 16)).transpose(1, 2)
     .contiguous().transpose(1, 2), "strided"),
])
def test_signature_route_is_fixed_by_dtype_strides_and_alignment(
        monkeypatch, what, x, want):
    """The route is chosen before the launch from dtype, strides and
    alignment; each route's counter moves with its launches, the vec route
    gets a zeroed scratch of N*C counts and one ticket per (sample, 32
    vectors of channels), the strided route none, and no plain version
    runs."""
    calls = []

    class Lib:
        @staticmethod
        def repro_signature_counts(*args):
            calls.append(args)
            return 0

    monkeypatch.setattr(sig, "_library", lambda: Lib)
    monkeypatch.setattr(sig, "_scratch", {})
    monkeypatch.setattr(sig, "signature_counts_plain", _no_plain)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: type("S", (), {"cuda_stream": 7}))
    monkeypatch.setattr(torch.cuda, "device", lambda dev: _NullContext())
    assert sig.route(x) == want
    before = (sig.launches, sig.launches_vec, sig.launches_strided)
    out = torch.empty((x.shape[0], x.shape[2]), device="meta")
    assert sig._dispatch(x, out, sig.route(x), 0.05, False) is out
    (args,) = calls
    n, _, c = x.shape
    vec_ints = n * c + n * -(-c * x.element_size() // 512)
    assert args[11:14] == ((1, 0, vec_ints) if want == "vec"
                           else (0, None, 0))
    assert args[6:9] == x.stride() and args[-1] == 7
    assert (sig.launches, sig.launches_vec, sig.launches_strided) == (
        before[0] + 1, before[1] + (want == "vec"),
        before[2] + (want == "strided"))


class _NullContext:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def test_signature_vec_route_refuses_what_it_cannot_load(monkeypatch):
    """Only the strided kernel may be asked for explicitly on inputs of the
    other route; the vec kernel asked for unaligned or channel-strided
    inputs raises before its entry is called."""
    called = []
    monkeypatch.setattr(sig, "_library", lambda: called.append(1))
    for x in (_meta_ntc((2, 16, 64), offset=1), _meta_ntc((3, 10, 63)),
              _meta_ntc((2, 64, 16)).transpose(1, 2)):
        with pytest.raises(ValueError, match="vec"):
            sig._dispatch(x, torch.empty((2, 16), device="meta"), "vec",
                          0.0, False)
    assert called == []


def test_failed_signature_launch_raises_without_fallback(monkeypatch):
    """An error code from the entry raises, naming the route; no plain
    version is tried and no counter moves."""
    class Lib:
        @staticmethod
        def repro_signature_counts(*args):
            return 3

        @staticmethod
        def repro_cuda_error_string(code):
            return b"fake failure %d" % code

    monkeypatch.setattr(sig, "_library", lambda: Lib)
    monkeypatch.setattr(sig, "_scratch", {})
    monkeypatch.setattr(sig, "signature_counts_plain", _no_plain)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: type("S", (), {"cuda_stream": 0}))
    monkeypatch.setattr(torch.cuda, "device", lambda dev: _NullContext())
    x = _meta_ntc((2, 16, 64))
    before = (sig.launches, sig.launches_vec, sig.launches_strided)
    with pytest.raises(RuntimeError, match=r"\(vec\).*fake failure 3"):
        sig._dispatch(x, torch.empty((2, 64), device="meta"), "vec", 0.0,
                      False)
    assert (sig.launches, sig.launches_vec, sig.launches_strided) == before


def test_signature_scratch_is_kept_per_device_and_stream(monkeypatch):
    """The vec route's zeroed scratch is made once for each (device,
    stream) and grows when a launch needs more; another stream gets its
    own."""
    monkeypatch.setattr(sig, "_scratch", {})
    dev = torch.device("meta")
    a = sig._zeroed_scratch(dev, 1, 100)
    assert a.dtype == torch.int32 and a.numel() == 100
    assert sig._zeroed_scratch(dev, 1, 60) is a
    b = sig._zeroed_scratch(dev, 1, 200)
    assert b is not a and b.numel() == 200
    assert sig._zeroed_scratch(dev, 2, 10) is not b
    assert sig._zeroed_scratch(dev, 1, 200) is b


def _scan_inputs(device, N=4, dtype=torch.float32, requires_grad=False,
                 B=2, S=16, d_in=8):
    shapes = [(B, S, d_in), (B, S, d_in), (d_in, N), (B, S, N), (B, S, N),
              (B, d_in, N)]
    return [torch.empty(s, device=device, dtype=dtype,
                        requires_grad=requires_grad) for s in shapes]


def test_non_cpu_tensor_goes_to_the_scan_kernel(monkeypatch):
    """``ops.selective_scan`` hands non-CPU tensors to the kernel's
    launcher, never to the plain version; so does one non-CPU input among
    CPU ones, which the launcher then refuses."""
    launched = []

    def plain(*args, **kwargs):
        raise AssertionError("plain version called for a non-CPU tensor")

    def launch(x, dt, A, Bc, Cc, h0):
        launched.append((x.device.type, tuple(x.shape), A.shape[1]))
        return torch.empty_like(x), torch.empty_like(h0)

    monkeypatch.setattr(ss, "selective_scan_plain", plain)
    monkeypatch.setattr(ss, "_launch", launch)
    y, h = ops.selective_scan(*_scan_inputs("meta", N=16))
    assert y.shape == (2, 16, 8) and h.shape == (2, 8, 16)
    mixed = _scan_inputs("cpu")
    mixed[3] = torch.empty((2, 16, 4), device="meta")
    ops.selective_scan(*mixed)
    assert launched == [("meta", (2, 16, 8), 16), ("cpu", (2, 16, 8), 4)]
    monkeypatch.undo()
    with pytest.raises(ValueError, match="CPU or CUDA"):
        ops.selective_scan(*mixed)


@pytest.mark.parametrize("what,inputs,error,match", [
    ("a gradient", dict(requires_grad=True), RuntimeError, "no gradient"),
    ("float64", dict(dtype=torch.float64), TypeError, "float32"),
    ("bfloat16", dict(dtype=torch.bfloat16), TypeError, "float32"),
    ("N = 32", dict(N=32), ValueError, "state size"),
    ("N = 3", dict(N=3), ValueError, "state size"),
])
def test_scan_launcher_refuses_what_the_kernel_does_not_take(
        what, inputs, error, match):
    """Checked before any launch (a meta tensor stands in for a CUDA
    one): inputs that need a gradient, other types than float32, and state
    sizes without a template instance of the kernel."""
    with pytest.raises(error, match=match):
        ss.selective_scan_bsd(*_scan_inputs("meta", **inputs))


def test_scan_shapes_are_checked():
    x, dt, A, Bc, Cc, h0 = _scan_inputs("cpu")
    with pytest.raises(ValueError, match="h0"):
        ss.selective_scan_bsd(x, dt, A, Bc, Cc, h0[:, :4])
    with pytest.raises(ValueError, match="Bc"):
        ss.selective_scan_bsd(x, dt, A, Bc[:, :8], Cc, h0)
    with pytest.raises(ValueError, match="A"):
        ss.selective_scan_bsd(x, dt, A.T, Bc, Cc, h0)


def _slstm_inputs(device, dtype=torch.float32, requires_grad=False, B=2,
                  S=16, d=8):
    shapes = [(B, S, 4 * d), (d, 4 * d)] + [(B, d)] * 4
    return [torch.empty(s, device=device, dtype=dtype,
                        requires_grad=requires_grad) for s in shapes]


def _mlstm_inputs(device, dtype=torch.float32, gate_dtype=torch.float32,
                  requires_grad=False, B=2, S=16, H=2, dk=8, dv=12):
    qkv = [torch.empty((B, S, H, n), device=device, dtype=dtype,
                       requires_grad=requires_grad) for n in (dk, dk, dv)]
    # the gates as the model splits them out of one (B, S, 2H) projection
    gif = torch.empty((B, S, 2 * H), device=device, dtype=gate_dtype)
    return qkv + list(gif.chunk(2, dim=-1))


def test_non_cpu_tensor_goes_to_the_xlstm_kernels(monkeypatch):
    """``ops.slstm_scan`` and ``ops.mlstm_chunkwise`` hand non-CPU tensors
    to the kernels' launchers (the gates as strided views), never to the
    plain versions; so does one non-CPU input among CPU ones, which the
    launchers then refuse."""
    launched = []

    def plain(*args, **kwargs):
        raise AssertionError("plain version called for a non-CPU tensor")

    def launch_s(gx, R, c0, n0, h0, m0):
        launched.append(("slstm", gx.device.type, tuple(gx.shape)))
        return torch.empty_like(gx[..., :R.shape[0]]), (c0, n0, h0, m0)

    def launch_m(q, k, v, i_gate, f_gate):
        launched.append(("mlstm", q.device.type, i_gate.stride()))
        return torch.empty(v.shape, device=v.device), {}

    monkeypatch.setattr(slstm, "slstm_scan_plain", plain)
    monkeypatch.setattr(slstm, "_launch", launch_s)
    monkeypatch.setattr(mlstm, "mlstm_chunkwise_plain", plain)
    monkeypatch.setattr(mlstm, "_launch", launch_m)
    hs, _ = ops.slstm_scan(*_slstm_inputs("meta"))
    assert hs.shape == (2, 16, 8)
    h, _ = ops.mlstm_chunkwise(*_mlstm_inputs("meta"), chunk=8)
    assert h.shape == (2, 16, 2, 12) and h.dtype == torch.float32
    mixed_s = _slstm_inputs("cpu")
    mixed_s[1] = torch.empty((8, 32), device="meta")
    ops.slstm_scan(*mixed_s)
    mixed_m = _mlstm_inputs("cpu")
    mixed_m[4] = torch.empty((2, 16, 2), device="meta")
    ops.mlstm_chunkwise(*mixed_m)
    assert launched == [("slstm", "meta", (2, 16, 32)),
                        ("mlstm", "meta", (64, 4, 1)),
                        ("slstm", "cpu", (2, 16, 32)),
                        ("mlstm", "cpu", (64, 4, 1))]
    monkeypatch.undo()
    with pytest.raises(ValueError, match="CPU or CUDA"):
        ops.slstm_scan(*mixed_s)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        ops.mlstm_chunkwise(*mixed_m)


@pytest.mark.parametrize("what,inputs,error,match", [
    ("a gradient", dict(requires_grad=True), RuntimeError, "no gradient"),
    ("float64", dict(dtype=torch.float64), TypeError, "float32"),
    ("bfloat16", dict(dtype=torch.bfloat16), TypeError, "float32"),
])
def test_slstm_launcher_refuses_what_the_kernel_does_not_take(
        what, inputs, error, match):
    """Checked before any launch (a meta tensor stands in for a CUDA one):
    inputs that need a gradient and other types than float32."""
    with pytest.raises(error, match=match):
        slstm.slstm_scan_bsd(*_slstm_inputs("meta", **inputs))


@pytest.mark.parametrize("what,inputs,error,match", [
    ("a gradient", dict(requires_grad=True), RuntimeError, "no gradient"),
    ("float16", dict(dtype=torch.float16), TypeError, "bfloat16"),
    ("float64", dict(dtype=torch.float64), TypeError, "bfloat16"),
    ("bfloat16 gates", dict(gate_dtype=torch.bfloat16), TypeError,
     "float32 gates"),
    ("dk = 320", dict(dk=320), ValueError, "dk=320"),
])
def test_mlstm_launcher_refuses_what_the_kernel_does_not_take(
        what, inputs, error, match):
    """Checked before any launch (a meta tensor stands in for a CUDA one):
    inputs that need a gradient, q, k, v other than float32 or bfloat16,
    gates other than float32, and head dims above the kernel's 256."""
    with pytest.raises(error, match=match):
        mlstm.mlstm_chunkwise_bshd(*_mlstm_inputs("meta", **inputs))


def test_xlstm_launchers_refuse_mixed_types_and_check_shapes():
    q, k, v, i, f = _mlstm_inputs("meta")
    with pytest.raises(TypeError, match="one type"):
        mlstm.mlstm_chunkwise_bshd(q, k.to(torch.bfloat16), v, i, f)
    with pytest.raises(ValueError, match="v"):
        mlstm.mlstm_chunkwise_bshd(q, k, v[:, :4], i, f)
    with pytest.raises(ValueError, match="i_gate"):
        mlstm.mlstm_chunkwise_bshd(q, k, v, i[..., :1], f)
    gx, R, c0, n0, h0, m0 = _slstm_inputs("meta")
    with pytest.raises(ValueError, match="R"):
        slstm.slstm_scan_bsd(gx, R.T, c0, n0, h0, m0)
    with pytest.raises(ValueError, match="m0"):
        slstm.slstm_scan_bsd(gx, R, c0, n0, h0, m0[:1])


@pytest.mark.parametrize("d,sms,units", [(768, 132, 6), (8, 132, 2),
                                         (300, 132, 4), (2048, 132, 8),
                                         (768, 114, 8)])
def test_slstm_grid_fits_the_card(d, sms, units):
    """The persistent grid's block owns the fewest units that need no more
    blocks than the card has SMs: 128 blocks of 6 units at xlstm-125m's
    768 on an H100's 132 SMs."""
    assert slstm.units_per_block(d, sms) == units


@pytest.mark.parametrize("B,d,units,rows", [
    (8, 768, 6, 8), (43, 768, 6, 43), (64, 768, 6, 64), (5000, 768, 6, 423),
    (300, 1001, 8, 114), (1, 16, 2, 1), (4000, 100, 2, 2208)])
def test_slstm_row_plan_fills_the_block(B, d, units, rows):
    """One launch takes every row that fits in the block's 227 KB beside
    R's columns, its warps' h tiles and the partial sums: xlstm-125m's
    batches up to 423 rows in one launch, and a larger batch in slices of
    the most that fit."""
    assert slstm.row_plan(B, d, units) == rows
    assert slstm.smem_bytes(units, rows, d) <= slstm.SMEM_LIMIT
    if rows < B:
        assert slstm.smem_bytes(units, rows + 1, d) > slstm.SMEM_LIMIT


def test_slstm_row_plan_refuses_widths_past_the_kernel():
    with pytest.raises(ValueError, match="d <= 1024"):
        slstm.row_plan(8, 1025, 8)


class _FakeSlstmLibrary:
    """A stand-in for the sLSTM library: records each launch's row-slice
    pointers and sizes, and returns ``err``."""

    def __init__(self, err=0):
        self.calls = []
        self.err = err

    def repro_slstm_scan(self, gx, R, c0, n0, h0, m0, hs, c, n, h, m, xchg,
                         B, S, d, cpw, products, stream):
        self.calls.append(dict(gx=gx, c0=c0, hs=hs, c=c, xchg=xchg, B=B,
                               S=S, d=d, cpw=cpw, products=products,
                               stream=stream))
        return self.err

    def repro_cuda_error_string(self, err):
        return f"fake failure {err}".encode()


def _fake_slstm(monkeypatch, err=0):
    lib = _FakeSlstmLibrary(err)

    class stream:
        cuda_stream = 1234

    class device:
        def __init__(self, dev):
            pass

        def __enter__(self):
            pass

        def __exit__(self, *exc):
            pass

    monkeypatch.setattr(slstm, "_library", lambda: lib)
    monkeypatch.setattr(torch.cuda, "device", device)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda: stream)
    monkeypatch.setattr(slstm, "slstm_scan_plain", _no_plain)
    return lib


@pytest.mark.parametrize("B,rows_per_launch,launches", [
    (43, None, 1), (64, None, 1), (64, 24, 3), (10, 4, 3)])
def test_slstm_batches_reach_the_kernel_row_by_row(monkeypatch, B,
                                                   rows_per_launch,
                                                   launches):
    """Batches past the first kernel's 42-row limit at xlstm-125m's width
    reach the kernel without a refusal; every row goes to exactly one
    launch, each launch's pointers at its first row, and ``launches``
    counts them.  Where the plan caps a launch's rows (forced here), the
    batch goes in slices."""
    lib = _fake_slstm(monkeypatch)
    if rows_per_launch is not None:
        monkeypatch.setattr(slstm, "row_plan",
                            lambda B, d, units: min(B, rows_per_launch))
    S, d = 3, 768
    inputs = [torch.zeros(s) for s in [(B, S, 4 * d), (d, 4 * d)]
              + [(B, d)] * 4]
    before = slstm.launches
    hs, state = slstm._run(*inputs, units=6)
    assert slstm.launches == before + launches
    assert len(lib.calls) == launches
    covered = []
    for call in lib.calls:
        r0 = (call["gx"] - inputs[0].data_ptr()) // (S * 4 * d * 4)
        assert call["gx"] == inputs[0].data_ptr() + r0 * S * 4 * d * 4
        assert call["c0"] == inputs[2].data_ptr() + r0 * d * 4
        assert call["hs"] == hs.data_ptr() + r0 * S * d * 4
        assert call["c"] == state[0].data_ptr() + r0 * d * 4
        assert (call["S"], call["d"], call["cpw"], call["products"],
                call["stream"]) == (S, d, 3, 1, 1234)
        covered += range(r0, r0 + call["B"])
    assert covered == list(range(B))


def test_slstm_exchange_floor_is_not_counted_and_failures_raise(
        monkeypatch):
    """The exchange floor runs the kernel with products = 0 and leaves
    ``launches`` alone; a failed launch raises, with no plain fallback."""
    lib = _fake_slstm(monkeypatch)
    inputs = [torch.zeros(s) for s in [(8, 3, 64), (16, 64)] + [(8, 16)] * 4]
    before = slstm.launches
    slstm._run(*inputs, units=2, products=False)
    assert slstm.launches == before and lib.calls[0]["products"] == 0
    lib.err = 2
    with pytest.raises(RuntimeError, match="fake failure 2"):
        slstm._run(*inputs, units=2)
    assert slstm.launches == before


@pytest.mark.parametrize("shape", [
    (128, 1024, 64), (1, 4096, 2048), (3, 1000, 63), (2, 5, 33), (1, 1, 1),
    (70000, 2, 3)])
@pytest.mark.parametrize("tau", [0.0, 0.05])
def test_signature_plain_counts_match_numpy(shape, tau):
    """The plain version (what a CPU tensor takes) counts exact zeros for
    tau <= 0 and ``|x| < f32(tau)`` otherwise, per sample and channel."""
    rng = np.random.default_rng(sum(shape))
    x = rng.normal(0, 0.1, shape).astype(np.float32)
    x[rng.random(shape) < 0.3] = 0.0
    flags = x == 0 if tau <= 0 else np.abs(x) < np.float32(tau)
    want = flags.sum(axis=1).astype(np.float32)
    got = sig.signature_counts(torch.from_numpy(x), tau)
    assert np.array_equal(got.numpy(), want)
    means = sig.signature_counts(torch.from_numpy(x), tau, mean=True)
    assert np.array_equal(means.numpy(),
                          want * (np.float32(1) / np.float32(shape[1])))


def test_launcher_refuses_what_the_kernel_does_not_take():
    with pytest.raises(ValueError, match="CPU or CUDA"):
        sig._launch(torch.empty((2, 3, 4), device="meta"), 0.0, False)
    with pytest.raises(ValueError, match=r"\(N, T, C\)"):
        sig.signature_counts(torch.zeros(3, 4), 0.0)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        fa._launch(*(torch.empty((1, 2, 8, 32), device="meta"),) * 3,
                   True, -1, 0.0)


def _fake_nvcc(tmp_path: Path, body: str) -> str:
    script = tmp_path / "nvcc"
    script.write_text("#!/bin/sh\n" + body)
    script.chmod(script.stat().st_mode | stat.S_IXUSR)
    return str(script)


def test_failed_build_raises_and_leaves_no_library(tmp_path, monkeypatch):
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(build, "_nvcc", lambda: _fake_nvcc(
        tmp_path, 'echo "signature.cu(3): error: fake"; exit 2\n'))
    with pytest.raises(RuntimeError, match="error: fake"):
        build.build(["signature", "flash_attention"])
    assert not build.library_path("signature").exists()
    assert not build.library_path("flash_attention").exists()


def test_build_compiles_once_and_keys_by_source(tmp_path, monkeypatch):
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    calls = tmp_path / "calls"
    # a stand-in compiler: logs its call and writes the -o file
    monkeypatch.setattr(build, "_nvcc", lambda: _fake_nvcc(tmp_path, (
        f'echo "$@" >> {calls}\n'
        'while [ "$1" != "-o" ]; do shift; done; echo lib > "$2"\n')))
    paths = build.build()
    assert set(paths) == {"signature", "flash_attention",
                          "flash_attention_sm90", "selective_scan", "mlstm",
                          "slstm"}
    path = paths["signature"]
    assert path.exists() and path.parent == tmp_path / "build"
    assert "arch=compute_90a,code=sm_90a" in calls.read_text()
    build.build(["signature"])
    assert len(calls.read_text().splitlines()) == 6     # cached by hash
    assert not [p for p in path.parent.iterdir() if p.suffix == ".tmp"]
    assert build.log_path("signature").exists()


def test_nvcc_missing_raises(monkeypatch):
    import torch.utils.cpp_extension as cpp
    monkeypatch.setattr(cpp, "CUDA_HOME", None)
    with pytest.raises(RuntimeError, match="nvcc"):
        build._nvcc()


@pytest.mark.parametrize("name,value", [("mesh", "2x2")])
def test_unported_options_raise(name, value):
    """``mesh`` left the unported options: a sequential coordinator
    (``cohort_size`` 1) keeps the spec and builds no engine, as the
    reference's does."""
    cfg = DagAflConfig(n_clients=2)
    setattr(cfg, name, value)
    data = [{"train": None, "val": None}] * 2
    coord = DagAflCoordinator(object(), data, None, cfg)
    assert coord.cohort is None and coord.cfg.mesh == value
    assert (cfg.clients_axis, cfg.data_axis) == ("clients", "data")


@pytest.mark.parametrize("name", ["serve_every", "serving"])
def test_serving_options_are_ported(name):
    """``serve_every`` and ``serving`` left the unported options: the
    coordinator builds, and its effective serving config carries them."""
    from repro_torch.fl.serving import ServingConfig
    value = 5.0 if name == "serve_every" else ServingConfig(every=2.5)
    cfg = DagAflConfig(n_clients=2, **{name: value})
    data = [{"train": None, "val": None}] * 2
    coord = DagAflCoordinator(object(), data, None, cfg)
    scfg = coord._serving_config()
    assert isinstance(scfg, ServingConfig)
    assert scfg.every == (5.0 if name == "serve_every" else 2.5)
    assert coord.publisher is None and coord.query_stream is None
    assert DagAflCoordinator(object(), data, None, DagAflConfig(
        n_clients=2))._serving_config() is None


@pytest.mark.parametrize("scenario", ["poison", "lazy", "dp", "straggler",
                                      "dropout"])
def test_scenarios_are_ported(scenario):
    """``scenario`` left the unported options: the coordinator builds its
    injector, and serves beside it."""
    data = [{"train": None, "val": None}] * 4
    coord = DagAflCoordinator(object(), data, None,
                              DagAflConfig(n_clients=4, scenario=scenario))
    assert coord.scenario.cfg.name == scenario
    both = DagAflCoordinator(object(), data, None, DagAflConfig(
        n_clients=4, scenario=scenario, serve_every=5.0))
    assert both.scenario.cfg.name == scenario
    assert both._serving_config().every == 5.0


@pytest.mark.parametrize("mesh,default", [(None, True), ("auto", True),
                                          ("4x2", False), (("auto", 2), False),
                                          ("8", False), ("AUTO", False)])
def test_mesh_takes_one_card_only(mesh, default):
    """On a backend on the CPU every spec builds the engine and clamps to
    the backend's one device, the single-device engine, as the
    reference's specs clamp on a one-device host; the specs parse as the
    reference's ``parse_mesh_spec`` parses them.  A mesh over more devices
    is asked for with a ``Mesh`` (``tests/test_torch_cohort_mesh.py``)."""
    cfg = DagAflConfig(n_clients=2, mesh=mesh, cohort_size=2)
    assert default == (mesh is None or mesh == DagAflConfig().mesh)
    data = [{"train": None, "val": None}] * 2
    backend = CNNBackend(VGG_TINY, device="cpu")
    coord = DagAflCoordinator(backend, data, None, cfg)
    assert coord.cohort is not None and coord.cohort.mesh is None
    engine = build_cohort_engine(backend, cohort_size=2, mesh=mesh)
    assert engine is not None and engine.mesh is None
    assert engine._grid.tolist() == [[backend.device]]
    if mesh is not None:
        from repro_torch.fl.cohort import parse_mesh_spec
        assert parse_mesh_spec(mesh) == {
            "auto": ("auto", 1), "4x2": (4, 2), ("auto", 2): ("auto", 2),
            "8": (8, 1), "AUTO": ("auto", 1)}[mesh]


def test_build_dir_is_ignored_by_git():
    ignored = (REPO / ".gitignore").read_text().split()
    rel = os.path.relpath(build.BUILD_DIR, REPO)
    assert rel.split(os.sep)[0] + "/" in ignored

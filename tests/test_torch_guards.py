"""Guards around the PyTorch port: what it may import, where it runs, and
that a CUDA tensor never takes a kernel's plain version.

These tests need no JAX: they read the port's sources and exercise its
device and build plumbing with fakes, so they run on any host.
"""
import ast
import os
import stat
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch import runtime  # noqa: E402
from repro_torch.configs.cnn import VGG_TINY  # noqa: E402
from repro_torch.core.coordinator import DagAflConfig, DagAflCoordinator  # noqa: E402
from repro_torch.fl.backend import CNNBackend  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import signature as sig  # noqa: E402

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
    assert len(PORT_FILES) >= 20
    bad = [f"{p.relative_to(REPO)}:{line} imports {root}"
           for p in PORT_FILES for line, root in _imported_roots(p)
           if root in FORBIDDEN]
    assert not bad, "\n".join(bad)


def test_backend_without_device_raises_where_cuda_is_absent(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        CNNBackend(VGG_TINY)
    assert CNNBackend(VGG_TINY, device="cpu").device == torch.device("cpu")


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


def test_launcher_refuses_what_the_kernel_does_not_take():
    with pytest.raises(ValueError, match="CPU or CUDA"):
        sig._launch(torch.empty((2, 3, 4), device="meta"), 0.0, False)
    with pytest.raises(ValueError, match=r"\(N, T, C\)"):
        sig.signature_counts(torch.zeros(3, 4), 0.0)


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
        build.build(["signature"])
    assert not build.library_path("signature").exists()


def test_build_compiles_once_and_keys_by_source(tmp_path, monkeypatch):
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    calls = tmp_path / "calls"
    # a stand-in compiler: logs its call and writes the -o file
    monkeypatch.setattr(build, "_nvcc", lambda: _fake_nvcc(tmp_path, (
        f'echo "$@" >> {calls}\n'
        'while [ "$1" != "-o" ]; do shift; done; echo lib > "$2"\n')))
    path = build.build(["signature"])["signature"]
    assert path.exists() and path.parent == tmp_path / "build"
    assert "arch=compute_90a,code=sm_90a" in calls.read_text()
    build.build(["signature"])
    assert len(calls.read_text().splitlines()) == 1     # cached by hash
    assert not [p for p in path.parent.iterdir() if p.suffix == ".tmp"]
    assert build.log_path("signature").exists()


def test_nvcc_missing_raises(monkeypatch):
    import torch.utils.cpp_extension as cpp
    monkeypatch.setattr(cpp, "CUDA_HOME", None)
    with pytest.raises(RuntimeError, match="nvcc"):
        build._nvcc()


@pytest.mark.parametrize("name,value", [("cohort_size", 4), ("mesh", None),
                                        ("scenario", "poison"),
                                        ("serve_every", 5.0),
                                        ("serving", object())])
def test_unported_options_raise(name, value):
    cfg = DagAflConfig(n_clients=2)
    setattr(cfg, name, value)
    with pytest.raises(NotImplementedError, match=name):
        DagAflCoordinator(object(), [{}, {}], None, cfg)


def test_build_dir_is_ignored_by_git():
    ignored = (REPO / ".gitignore").read_text().split()
    rel = os.path.relpath(build.BUILD_DIR, REPO)
    assert rel.split(os.sep)[0] + "/" in ignored

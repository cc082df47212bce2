"""Build the port's CUDA sources at first use and load them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled by
``nvcc`` for Hopper (``sm_90a``) into its own shared library under
``build/repro_torch/`` at the root of the checkout.  A library's file name
carries a hash of its source and flags, so an edited source rebuilds and an
unchanged one loads at once.  :func:`build` starts one ``nvcc`` for each
missing library, all together, and waits for all of them; each compiler's
output (with the ``-Xptxas -v`` register and shared-memory report) is kept
beside the library in a ``.log`` file.

There is no fallback: a missing ``nvcc`` or a failed build raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Dict, Sequence

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
SOURCES = ("signature", "flash_attention", "flash_attention_sm90",
           "selective_scan", "mlstm", "slstm")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (nvcc): the port's kernels "
                           "are built with nvcc on the machine with the card")
    nvcc = Path(CUDA_HOME) / "bin" / "nvcc"
    if not nvcc.exists():
        raise RuntimeError(f"nvcc not found at {nvcc}")
    return str(nvcc)


def library_path(name: str) -> Path:
    """Where the library built from ``csrc/<name>.cu`` lives."""
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def log_path(name: str) -> Path:
    """The compiler's output for the library built from ``name``."""
    return library_path(name).with_suffix(".log")


def build(names: Sequence[str] = SOURCES) -> Dict[str, Path]:
    """Compile every library of ``names`` that is missing, one ``nvcc``
    each, all started together; return the library paths."""
    paths = {name: library_path(name) for name in names}
    missing = [name for name, path in paths.items() if not path.exists()]
    if not missing:
        return paths
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    running = []
    try:
        for name in missing:
            tmp = paths[name].with_suffix(f".{os.getpid()}.tmp")
            with open(log_path(name), "w") as log:
                proc = subprocess.Popen(
                    [nvcc, *NVCC_FLAGS, "-o", str(tmp),
                     str(CSRC / f"{name}.cu")],
                    stdout=log, stderr=subprocess.STDOUT)
            running.append((name, proc, tmp))
    finally:
        failed = []
        for name, proc, tmp in running:
            if proc.wait() == 0:
                os.replace(tmp, paths[name])
            else:
                failed.append(f"{name}.cu:\n{log_path(name).read_text()}")
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return paths


def load(name: str) -> ctypes.CDLL:
    """The library built from ``csrc/<name>.cu``, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build([name])[name]))
        _loaded[name] = lib
    return lib

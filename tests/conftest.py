import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))
sys.path.insert(0, os.path.dirname(__file__))
# Repo root, so `import tools.repro_lint` resolves under pytest.
sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

# Hermetic containers may lack `hypothesis`; fall back to the bundled
# deterministic shim so property-test modules still collect and run.
import _hypothesis_fallback  # noqa: E402

_hypothesis_fallback.install()


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA card and nvcc; skips without CUDA")

"""The port's CUDA kernels on the card, against their plain versions.

Every test here needs an NVIDIA card with ``nvcc``: they carry the ``cuda``
marker and skip where CUDA is absent.  On the machine with the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import runtime  # noqa: E402
from repro_torch.configs.cnn import vgg_for  # noqa: E402
from repro_torch.core.aggregate import tree_map  # noqa: E402
from repro_torch.fl.backend import CNNBackend  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import signature as sig  # noqa: E402
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
    with pytest.raises(TypeError, match="float32"):
        sig.signature_counts(torch.zeros((2, 3, 4), device=card,
                                         dtype=torch.float16), 0.0)


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

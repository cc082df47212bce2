"""Device resolution for the port's entry points.

Entry points run on the CUDA card by default.  Where CUDA is absent they
raise instead of running on the CPU: a run on the CPU has to be asked for
with ``device="cpu"``.

On the card, float32 must stay real float32: cuDNN convolutions default to
TF32, which keeps about three decimal digits and moves the ReLU zero
patterns the Eq. 3 signatures count.  Both TF32 switches are turned off
whenever a device on the card is resolved.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> the CUDA card (raises without one); else ``device``."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available: pass device='cpu' to run on the CPU")
        device = "cuda"
    device = torch.device(device)
    if device.type == "cuda":
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    return device

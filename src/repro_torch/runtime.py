"""Device resolution and the runtime knobs of the port's model functions.

Entry points run on the CUDA card by default.  Where CUDA is absent they
raise instead of running on the CPU: a run on the CPU has to be asked for
with ``device="cpu"``.

On the card, float32 must stay real float32: cuDNN convolutions default to
TF32, which keeps about three decimal digits and moves the ReLU zero
patterns the Eq. 3 signatures count.  Both TF32 switches are turned off
whenever a device on the card is resolved.

:class:`Runtime` is the port of ``repro.runtime.Runtime``: the knobs that
model functions read.  It has no kernel policy: the tensor's device decides
between a kernel and its plain version.  ``remat`` checkpoints each
scanned period of a training forward under autograd
(``models.transformer``).  ``mesh`` with ``batch_axes`` splits the sLSTM
recurrence's batch over the devices of those axes (``models.xlstm``).
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Any, Optional, Tuple

import torch


@dataclass(frozen=True)
class Runtime:
    use_kernels: bool = False      # route hot spots through the kernels
    remat: bool = True             # checkpoint the periods in training
    want_signature: bool = False   # emit the Eq. 3 feature signature in aux
    signature_tau: float = 0.05
    signature_dims: int = 64
    # the batch's mesh axes and their total size, and the mesh
    # (repro_torch.launch.mesh.Mesh): the sLSTM scan splits its batch over
    # the devices of these axes (None: one device)
    batch_axes: Optional[Tuple[str, ...]] = None
    batch_axis_size: int = 1
    mesh: Optional[Any] = None


DEFAULT = Runtime()


def serve_runtime() -> Runtime:
    """Runtime for the serving path (prefill + KV-cache decode), the
    counterpart of the reference's ``serve_runtime``: no signature, the
    hot spots on the kernels.  The port has no kernel policy: on the card
    the prefill launches the kernels, on the CPU their plain versions
    (the tensor's device decides, as ``LMBackend.eval_runtime``)."""
    return Runtime(use_kernels=True)


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


def on_device(device):
    """The context for launches on ``device``: a card's kernels launch on
    the current card's stream."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()

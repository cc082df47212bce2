"""VGG-family CNN for the paper-faithful reproduction (MNIST/CIFAR clients).

Keeps the paper's Eq. 3 signature exactly: post-ReLU conv feature maps have
true zeros, and ``signature_layer`` selects which conv output provides the
zero-fraction 'kernel signatures' (one per output channel).

Port of ``repro.models.cnn``.  Parameters keep the reference's layouts
(HWIO conv weights, ``(in, out)`` dense weights) and the public functions
take NHWC images, so JAX weights load unchanged.  Inside, activations are
NCHW tensors in channels-last memory: the NHWC input viewed as NCHW, which
cuDNN takes as it is, and whose NHWC view reshapes to ``(N, HW, C)`` for the
signature kernel without a copy.  The last feature map is flattened in NHWC
order, as the reference does.  Means that reach the ledger (the sample
mean of the signature, the accuracy) multiply a float32 sum by the float32
reciprocal of the count, as the reference's jitted ``jnp.mean`` does.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.cnn import CNNConfig
from repro_torch.core.aggregate import f32_mean
from repro_torch.kernels import ops


def init_cnn(generator: torch.Generator, cfg: CNNConfig) -> dict:
    """He-normal weights and zero biases, drawn on ``generator``'s device."""
    device = generator.device
    params = {"convs": [], "fcs": []}
    in_ch = cfg.in_channels
    k = cfg.kernel_size
    size = cfg.image_size
    for stack in cfg.conv_stacks:
        stack_params = []
        for out_ch in stack:
            w = torch.randn((k, k, in_ch, out_ch), generator=generator,
                            device=device)
            w = w * math.sqrt(2.0 / (k * k * in_ch))
            stack_params.append({"w": w, "b": torch.zeros(out_ch,
                                                          device=device)})
            in_ch = out_ch
        params["convs"].append(stack_params)
        size //= 2
    d = in_ch * size * size
    for out_d in cfg.fc_dims + (cfg.n_classes,):
        w = torch.randn((d, out_d), generator=generator, device=device)
        w = w * math.sqrt(2.0 / d)
        params["fcs"].append({"w": w, "b": torch.zeros(out_d, device=device)})
        d = out_d
    return params


def cnn_forward(params: dict, images: torch.Tensor, cfg: CNNConfig,
                want_signature: bool = False):
    """images (B, H, W, C) -> (logits (B, n_classes), signature | None).

    The signature is the paper's Eq. 3-4: per-channel zero fraction of the
    ``signature_layer``-th conv feature map, averaged over the batch,
    computed by :func:`repro_torch.kernels.ops.signature_per_channel`.
    """
    x = images.permute(0, 3, 1, 2)            # NCHW view, channels-last
    sig = None
    conv_idx = 0
    for stack_params in params["convs"]:
        for p in stack_params:
            x = F.conv2d(x, p["w"].permute(3, 2, 0, 1), padding="same")
            x = F.relu(x + p["b"][:, None, None])
            if want_signature and conv_idx == cfg.signature_layer:
                # zero(F_k(x)) / (H*W), averaged over samples (Eq. 3-4)
                zero_frac = ops.signature_per_channel(
                    x.permute(0, 2, 3, 1), tau=0.0)
                sig = f32_mean(zero_frac, dim=0)       # (channels,)
            conv_idx += 1
        x = F.max_pool2d(x, 2)
    x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)   # NHWC flatten
    for p in params["fcs"][:-1]:
        x = F.relu(x @ p["w"] + p["b"])
    p = params["fcs"][-1]
    return x @ p["w"] + p["b"], sig


def cnn_loss(params: dict, batch: dict, cfg: CNNConfig,
             want_signature: bool = False):
    logits, sig = cnn_forward(params, batch["images"], cfg, want_signature)
    labels = batch["labels"].long()
    logz = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels[:, None])[:, 0]
    loss = (logz - ll).mean()
    return loss, {"signature": sig, "logits": logits}


def cnn_accuracy(params: dict, images: torch.Tensor, labels: torch.Tensor,
                 cfg: CNNConfig) -> torch.Tensor:
    logits, _ = cnn_forward(params, images, cfg)
    return f32_mean(logits.argmax(-1) == labels)

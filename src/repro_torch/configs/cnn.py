"""CNN configs for the paper-faithful reproduction (VGG16 on MNIST/CIFAR).

The paper trains VGG16 [arXiv:1409.1556] with 3x3 kernels on MNIST, CIFAR-10
and CIFAR-100.  ``VGG16`` is the faithful config; ``VGG_TINY`` is the reduced
variant used by CPU experiments and tests (same family: conv stacks + maxpool
+ classifier head, exact-zero ReLU feature-map signatures per Eq. 3).

PyTorch port of ``repro.configs.cnn``, copied as it is.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Tuple


@dataclass(frozen=True)
class CNNConfig:
    name: str
    citation: str
    # each entry = (out_channels per conv in the stack); maxpool after stack
    conv_stacks: Tuple[Tuple[int, ...], ...]
    fc_dims: Tuple[int, ...]
    n_classes: int = 10
    image_size: int = 32
    in_channels: int = 3
    kernel_size: int = 3
    # index of the conv layer whose feature maps provide Eq.3 signatures
    signature_layer: int = 1


VGG16 = CNNConfig(
    name="vgg16",
    citation="arXiv:1409.1556 (VGG); backbone used by DAG-AFL paper SIV-A",
    conv_stacks=((64, 64), (128, 128), (256, 256, 256),
                 (512, 512, 512), (512, 512, 512)),
    fc_dims=(4096, 4096),
    n_classes=10,
    image_size=32,
    in_channels=3,
)

VGG_TINY = CNNConfig(
    name="vgg-tiny",
    citation="reduced VGG family member for CPU-scale experiments",
    conv_stacks=((16, 16), (32, 32)),
    fc_dims=(128,),
    n_classes=10,
    image_size=16,
    in_channels=1,
    signature_layer=1,
)


def vgg_for(dataset: str, tiny: bool = True) -> CNNConfig:
    import dataclasses
    base = VGG_TINY if tiny else VGG16
    n_classes = {"mnist": 10, "cifar10": 10, "cifar100": 100}[dataset]
    in_ch = 1 if dataset == "mnist" else 3
    return dataclasses.replace(base, n_classes=n_classes, in_channels=in_ch)

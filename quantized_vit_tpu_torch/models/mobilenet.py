"""Depthwise-separable CNN, MobileNet-style (``quantized_vit_tpu/models/
mobilenet.py``), as ``nn.Module``s with flax's names, paths and layouts:
stem conv -> BN -> ReLU, then per block a depthwise 3x3 conv
(``QuantConv(feature_group_count=C)``, kernel [3, 3, 1, C]) -> BN -> ReLU
-> pointwise 1x1 conv -> BN -> ReLU, then global average pool -> head.

A depthwise conv cannot choose its own channels: its node group is merged
into the producing conv's (``graph/builders.py:mobilenet_node_groups``).
A compressed subnet is a config (``stem_width``, ``widths``). The
BatchNorm is flax's (``models/layers.py:BatchNorm``); ``forward(x,
deterministic=True)`` as ResNet's.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from ..device import resolve_device
from .layers import (BatchNorm, QuantConfig, QuantConv, QuantDense,
                     TreeModule, batch_stats_from_jax)


@dataclasses.dataclass(frozen=True)
class MobileNetConfig:
    widths: Tuple[int, ...] = (16, 32, 64)   # pointwise out-channels
    strides: Tuple[int, ...] = (1, 2, 2)     # depthwise stride per block
    stem_width: int = 8
    num_classes: int = 10
    in_channels: int = 3
    quant: QuantConfig = QuantConfig.off()


class MobileNet(TreeModule):
    """The MobileNet of ``cfg``; weights drawn from ``seed`` with flax's
    initializers, on ``device`` (the GPU unless the caller asks for the
    CPU)."""

    def __init__(self, cfg: MobileNetConfig, seed: int = 0, device="cuda"):
        super().__init__()
        dev = resolve_device(device)
        gen = torch.Generator().manual_seed(seed)
        self.cfg = cfg
        q = cfg.quant
        self.stem_conv = QuantConv(cfg.in_channels, cfg.stem_width, (3, 3),
                                   padding="SAME", config=q, use_bias=False,
                                   gen=gen, device=dev)
        self.stem_bn = BatchNorm(cfg.stem_width, device=dev)
        ch = cfg.stem_width
        for i, (width, stride) in enumerate(zip(cfg.widths, cfg.strides)):
            self.add_module(f"dw_{i}", QuantConv(
                ch, ch, (3, 3), strides=(stride, stride), padding="SAME",
                config=q, use_bias=False, feature_group_count=ch, gen=gen,
                device=dev))
            self.add_module(f"dw_bn_{i}", BatchNorm(ch, device=dev))
            self.add_module(f"pw_{i}", QuantConv(
                ch, width, (1, 1), padding="VALID", config=q, use_bias=False,
                gen=gen, device=dev))
            self.add_module(f"pw_bn_{i}", BatchNorm(width, device=dev))
            ch = width
        self.head = QuantDense(ch, cfg.num_classes, q, gen=gen, device=dev)

    def forward(self, x, deterministic: bool = True):
        train = not deterministic
        x = torch.relu(self.stem_bn(self.stem_conv(x), train))
        for i in range(len(self.cfg.widths)):
            x = torch.relu(getattr(self, f"dw_bn_{i}")(
                getattr(self, f"dw_{i}")(x), train))
            x = torch.relu(getattr(self, f"pw_bn_{i}")(
                getattr(self, f"pw_{i}")(x), train))
        return self.head(torch.mean(x, dim=(1, 2)))


def mobilenet_small(num_classes=10, quant=QuantConfig.off(), device="cuda"):
    return MobileNet(MobileNetConfig(num_classes=num_classes, quant=quant),
                     device=device)


def params_from_jax(tree, cfg: MobileNetConfig, batch_stats=None,
                    device="cuda") -> MobileNet:
    """A MobileNet of ``cfg`` holding copies of the JAX package's params
    tree (and, if given, its ``batch_stats`` tree), on ``device``."""
    model = MobileNet(cfg, device=device)
    model.load_param_tree(tree)
    if batch_stats is not None:
        batch_stats_from_jax(model, batch_stats)
    return model

"""Residual CNN, CIFAR-style BasicBlocks (``quantized_vit_tpu/models/
resnet.py``), as ``nn.Module``s with flax's names, paths and layouts:

- stem 3x3 conv -> BN -> ReLU;
- stages of BasicBlocks: conv1 (3x3, stride) -> BN -> ReLU -> conv2 (3x3)
  -> BN, plus an identity skip or a 1x1 downsample conv + BN where the
  stride or width changes; out = ReLU(skip + branch);
- global average pool -> dense head.

Every conv and the head are ``QuantConv`` / ``QuantDense``; the BatchNorm
is flax's (``models/layers.py:BatchNorm``), its running statistics the
``batch_stats`` tree (``stage1_block0/down_bn/mean``). A compressed
subnet is a config: ``widths`` per stage and ``inner_widths`` per block
(conv1's width). Inputs are NHWC; ``forward(x, deterministic=True)``
runs the BatchNorms on their running statistics, ``deterministic=False``
on the batch's, updating the running statistics in place.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
from torch import nn

from ..device import resolve_device
from .layers import (BatchNorm, QuantConfig, QuantConv, QuantDense,
                     TreeModule, batch_stats_from_jax)


@dataclasses.dataclass(frozen=True)
class ResNetConfig:
    stage_sizes: Tuple[int, ...] = (2, 2, 2)
    widths: Tuple[int, ...] = (16, 32, 64)
    stem_width: int = 16
    num_classes: int = 10
    in_channels: int = 3
    quant: QuantConfig = QuantConfig.off()
    # per-(stage, block) conv1 width of a compressed subnet; None: the
    # stream width (dense model)
    inner_widths: Optional[Tuple[Tuple[int, ...], ...]] = None

    def block_inner(self, s: int, b: int) -> int:
        if self.inner_widths is not None:
            return self.inner_widths[s][b]
        return self.widths[s]


def _conv(cin, cout, k, stride, padding, q, gen, dev):
    return QuantConv(cin, cout, (k, k), strides=(stride, stride),
                     padding=padding, config=q, use_bias=False, gen=gen,
                     device=dev)


class BasicBlock(nn.Module):
    def __init__(self, cfg: ResNetConfig, in_width: int, width: int,
                 inner: int, stride: int, downsample: bool, gen, device):
        super().__init__()
        q = cfg.quant
        self.conv1 = _conv(in_width, inner, 3, stride, "SAME", q, gen, device)
        self.bn1 = BatchNorm(inner, device=device)
        self.conv2 = _conv(inner, width, 3, 1, "SAME", q, gen, device)
        self.bn2 = BatchNorm(width, device=device)
        self.downsample = downsample
        if downsample:
            self.down_conv = _conv(in_width, width, 1, stride, "VALID", q,
                                   gen, device)
            self.down_bn = BatchNorm(width, device=device)

    def forward(self, x, deterministic: bool = True):
        train = not deterministic
        h = torch.relu(self.bn1(self.conv1(x), train))
        h = self.bn2(self.conv2(h), train)
        if self.downsample:
            x = self.down_bn(self.down_conv(x), train)
        return torch.relu(x + h)


class ResNet(TreeModule):
    """The ResNet of ``cfg``; weights drawn from ``seed`` with flax's
    initializers (not JAX's numbers), on ``device`` (the GPU unless the
    caller asks for the CPU)."""

    def __init__(self, cfg: ResNetConfig, seed: int = 0, device="cuda"):
        super().__init__()
        dev = resolve_device(device)
        gen = torch.Generator().manual_seed(seed)
        self.cfg = cfg
        q = cfg.quant
        self.stem_conv = _conv(cfg.in_channels, cfg.stem_width, 3, 1, "SAME",
                               q, gen, dev)
        self.stem_bn = BatchNorm(cfg.stem_width, device=dev)
        in_width = cfg.stem_width
        self.block_names = []
        for s, (n_blocks, width) in enumerate(zip(cfg.stage_sizes,
                                                  cfg.widths)):
            for b in range(n_blocks):
                stride = 2 if (s > 0 and b == 0) else 1
                down = stride != 1 or in_width != width
                name = f"stage{s}_block{b}"
                self.add_module(name, BasicBlock(
                    cfg, in_width, width, cfg.block_inner(s, b), stride,
                    down, gen, dev))
                self.block_names.append(name)
                in_width = width
        self.head = QuantDense(in_width, cfg.num_classes, q, gen=gen,
                               device=dev)

    def forward(self, x, deterministic: bool = True):
        x = torch.relu(self.stem_bn(self.stem_conv(x), not deterministic))
        for name in self.block_names:
            x = getattr(self, name)(x, deterministic)
        return self.head(torch.mean(x, dim=(1, 2)))


def resnet20(num_classes=10, quant=QuantConfig.off(), device="cuda"):
    """He et al. 2016 §4.2's CIFAR ResNet-20: 3 stages of 3 BasicBlocks,
    widths 16/32/64."""
    return ResNet(ResNetConfig(stage_sizes=(3, 3, 3), widths=(16, 32, 64),
                               num_classes=num_classes, quant=quant),
                  device=device)


def resnet8(num_classes=10, quant=QuantConfig.off(), device="cuda"):
    """The small variant of the tests: one block a stage."""
    return ResNet(ResNetConfig(stage_sizes=(1, 1, 1), widths=(16, 32, 64),
                               num_classes=num_classes, quant=quant),
                  device=device)


def params_from_jax(tree, cfg: ResNetConfig, batch_stats=None,
                    device="cuda") -> ResNet:
    """A ResNet of ``cfg`` holding copies of the JAX package's params tree
    (numpy leaves, flax paths and layouts) and, if given, of its
    ``batch_stats`` tree, on ``device``."""
    model = ResNet(cfg, device=device)
    model.load_param_tree(tree)
    if batch_stats is not None:
        batch_stats_from_jax(model, batch_stats)
    return model

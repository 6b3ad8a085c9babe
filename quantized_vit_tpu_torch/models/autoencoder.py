"""Conv autoencoder with transposed convs and GroupNorm
(``quantized_vit_tpu/models/autoencoder.py``), as ``nn.Module``s with
flax's names, paths and layouts:

- encoder: stages of [``QuantConv`` stride 2 -> GroupNorm -> GELU];
- decoder: stages of [``QuantConvTranspose`` stride 2 -> GroupNorm ->
  GELU], with ``skip_concat`` the U-Net skips (decoder stage i's output
  concatenated with the encoder feature of its resolution);
- a 1x1 ``QuantConv`` (with bias) back to the input's channels.

The GELU here is flax's default ``nn.gelu``, the tanh approximation (the
Transformer's is the exact one). Channels are pruned in whole GroupNorm
groups, so a compressed config carries the per-stage group counts
(``enc_norm_groups`` / ``dec_norm_groups``) and the decoder widths.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device
from .layers import (GroupNorm, QuantConfig, QuantConv, QuantConvTranspose,
                     TreeModule)


@dataclasses.dataclass(frozen=True)
class AutoencoderConfig:
    widths: Tuple[int, ...] = (16, 32)   # encoder stage widths
    norm_groups: int = 4                 # default GroupNorm groups a stage
    in_channels: int = 3
    kernel_size: int = 3
    quant: QuantConfig = QuantConfig.off()
    # U-Net skips: decoder stage i's output concatenated with the encoder
    # feature of its resolution before the next decoder conv
    skip_concat: bool = False
    # compressed-subnet overrides (None: the dense model)
    dec_widths: Optional[Tuple[int, ...]] = None
    enc_norm_groups: Optional[Tuple[int, ...]] = None
    dec_norm_groups: Optional[Tuple[int, ...]] = None

    @property
    def decoder_widths(self) -> Tuple[int, ...]:
        """One upsample per encoder downsample; mirrors the encoder by
        default, ending at widths[0] before the 1x1 output conv."""
        if self.dec_widths is not None:
            return self.dec_widths
        return tuple(reversed(self.widths[:-1])) + (self.widths[0],)

    def enc_groups(self, i: int) -> int:
        if self.enc_norm_groups is not None:
            return self.enc_norm_groups[i]
        return min(self.norm_groups, self.widths[i])

    def dec_groups(self, i: int) -> int:
        if self.dec_norm_groups is not None:
            return self.dec_norm_groups[i]
        return min(self.norm_groups, self.decoder_widths[i])


# sqrt(2/pi) rounded to f32, as jax.nn.gelu casts it to the input's dtype
_SQRT_2_OVER_PI = float(np.float32(math.sqrt(2 / math.pi)))


def gelu_tanh(x):
    """``jax.nn.gelu(approximate=True)``: x * 0.5 * (1 + tanh(sqrt(2/pi)
    * (x + 0.044715 x^3))), in JAX's operation order."""
    return x * (0.5 * (1.0 + torch.tanh(
        _SQRT_2_OVER_PI * (x + 0.044715 * (x ** 3)))))


class ConvAutoencoder(TreeModule):
    """The autoencoder of ``cfg``; weights drawn from ``seed`` with flax's
    initializers, on ``device`` (the GPU unless the caller asks for the
    CPU). ``forward(x)``: NHWC in, NHWC out at the input's size."""

    def __init__(self, cfg: AutoencoderConfig, seed: int = 0, device="cuda"):
        super().__init__()
        dev = resolve_device(device)
        gen = torch.Generator().manual_seed(seed)
        self.cfg = cfg
        q, ks = cfg.quant, (cfg.kernel_size, cfg.kernel_size)
        ch = cfg.in_channels
        for i, w in enumerate(cfg.widths):
            self.add_module(f"enc_{i}", QuantConv(
                ch, w, ks, strides=(2, 2), padding="SAME", config=q,
                use_bias=False, gen=gen, device=dev))
            self.add_module(f"enc_gn_{i}", GroupNorm(w, cfg.enc_groups(i),
                                                     device=dev))
            ch = w
        n_enc = len(cfg.widths)
        for i, w in enumerate(cfg.decoder_widths):
            self.add_module(f"dec_{i}", QuantConvTranspose(
                ch, w, ks, strides=(2, 2), padding="SAME", config=q,
                use_bias=False, gen=gen, device=dev))
            self.add_module(f"dec_gn_{i}", GroupNorm(w, cfg.dec_groups(i),
                                                     device=dev))
            ch = w
            mirror = n_enc - 2 - i
            if cfg.skip_concat and mirror >= 0:
                ch += cfg.widths[mirror]
        self.out_conv = QuantConv(ch, cfg.in_channels, (1, 1),
                                  padding="VALID", config=q, gen=gen,
                                  device=dev)

    def forward(self, x):
        c = self.cfg
        feats = []
        for i in range(len(c.widths)):
            x = gelu_tanh(getattr(self, f"enc_gn_{i}")(
                getattr(self, f"enc_{i}")(x)))
            feats.append(x)
        n_enc = len(c.widths)
        for i in range(len(c.decoder_widths)):
            x = gelu_tanh(getattr(self, f"dec_gn_{i}")(
                getattr(self, f"dec_{i}")(x)))
            mirror = n_enc - 2 - i
            if c.skip_concat and mirror >= 0:
                x = torch.cat([x, feats[mirror]], dim=-1)
        return self.out_conv(x)


def params_from_jax(tree, cfg: AutoencoderConfig,
                    device="cuda") -> ConvAutoencoder:
    """An autoencoder of ``cfg`` holding copies of the JAX package's
    params tree (numpy leaves, flax paths and layouts), on ``device``."""
    model = ConvAutoencoder(cfg, device=device)
    model.load_param_tree(tree)
    return model

"""UltraNet, the W4A4 DoReFa CNN with its YOLO head
(``quantized_vit_tpu/models/ultranet.py``), as ``nn.Module``s with flax's
names, paths and layouts.

- 8 blocks of [DoReFa 3x3 conv (W4) -> BatchNorm -> 4-bit activation
  quantizer], a 2x2 max pool after blocks 0-3, then a DoReFa 1x1 conv with
  bias to 36 channels (6 anchors of (20, 20), 6 outputs each);
- :func:`yolo_decode`: train mode returns the raw predictions
  [B, na, ny, nx, no]; eval mode also the decoded boxes (sigmoid xy plus
  the grid, exp wh times the anchors, rescaled by the stride, sigmoid
  confidences);
- :class:`UltraNetInt`: the folded-BN integer forward of the export
  artifact (integer conv levels, ``(inc, bias)`` requantization tables).

The BatchNorm is flax's ``nn.BatchNorm(momentum=0.9, epsilon=1e-5)``
(``models/layers.py:BatchNorm``, shared with ResNet and MobileNet), not
PyTorch's: batch statistics with the fast variance ``E[x^2] - E[x]^2``
(biased, clipped at 0), ``y = (x - mean) * (rsqrt(var + eps) * scale) +
bias``, and the running update ``ra = 0.9 * ra + 0.1 * batch``.

The public API takes NHWC input and keeps flax's parameter tree
(``conv_{i}/kernel`` HWIO, ``bn_{i}/{scale,bias}``, ``conv_8/bias``) and
its ``batch_stats`` tree (``bn_{i}/{mean,var}``, buffers here), so the node
groups, the subnet slicing and the export read the JAX package's paths and
axes; the convs run on NCHW/OIHW views inside.

``UltraNetInt`` accumulates each conv exactly: the levels are convolved in
f64 and rounded to int64 (the largest sum, 3*3*64*7*15 = 60,480, or
27*255*7 = 48,195 in the first layer, is far inside f64's exact range, so
any algorithm the library picks, a transform included, rounds back to the
integer XLA's int32 accumulation gives). There is no integer conv on the
card, and an f32 one can run in TF32.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..device import resolve_device
from ..quant.dorefa import (fold_batchnorm, fold_batchnorm_affine,
                            quantize_activation, quantize_weight)
from ..quant.integer import requantize_int
from .layers import (BatchNorm, TreeModule, _BNParams, _same_pads,
                     _trunc_normal, apply_variables, flatten_tree)

# (features, kernel, maxpool_after) per conv block
ULTRANET_LAYERS = (
    (16, 3, True),
    (32, 3, True),
    (64, 3, True),
    (64, 3, True),
    (64, 3, False),
    (64, 3, False),
    (64, 3, False),
    (64, 3, False),
)
ULTRANET_OUT_CHANNELS = 36
ULTRANET_ANCHORS = ((20.0, 20.0),) * 6
W_BIT = 4
A_BIT = 4

# flax's truncated-normal initializers: the untruncated std over the
# truncation's shrink factor
_TRUNC = 0.87962566103423978


def conv_nhwc(x, kernel_hwio, strides: int = 1, padding: Any = "SAME"):
    """``lax.conv_general_dilated`` with ("NHWC", "HWIO", "NHWC"), flax's
    padding ("SAME", "VALID", an int or ((top, bottom), (left, right)))."""
    xc = x.permute(0, 3, 1, 2)
    ks = kernel_hwio.shape[0]
    if padding == "SAME":
        (t, bo), (l, r) = (_same_pads(xc.shape[2], ks, strides),
                           _same_pads(xc.shape[3], ks, strides))
    elif padding == "VALID":
        t = bo = l = r = 0
    elif isinstance(padding, int):
        t = bo = l = r = padding
    else:
        (t, bo), (l, r) = padding
    y = F.conv2d(F.pad(xc, (l, r, t, bo)), kernel_hwio.permute(3, 2, 0, 1),
                 stride=strides)
    return y.permute(0, 2, 3, 1)


def max_pool_2x2(x):
    """flax ``nn.max_pool(x, (2, 2), strides=(2, 2))`` on NHWC (VALID: odd
    sizes floor)."""
    return F.max_pool2d(x.permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1)


class DoReFaConv(nn.Module):
    """Conv2d_Q: the HWIO kernel DoReFa-quantized each forward (flax
    ``kaiming_normal`` init)."""

    def __init__(self, in_channels: int, features: int, kernel_size: int,
                 w_bit: int = W_BIT, strides: int = 1, padding: Any = "SAME",
                 use_bias: bool = False, gen=None, device="cuda"):
        super().__init__()
        device = resolve_device(device)
        self.w_bit, self.strides, self.padding = w_bit, strides, padding
        fan_in = kernel_size * kernel_size * in_channels
        self.kernel = nn.Parameter(_trunc_normal(
            (kernel_size, kernel_size, in_channels, features),
            math.sqrt(2.0 / fan_in) / _TRUNC, gen, device))
        self.register_parameter("bias", nn.Parameter(torch.zeros(
            features, device=device)) if use_bias else None)

    def forward(self, x):
        y = conv_nhwc(x, quantize_weight(self.kernel, self.w_bit),
                      self.strides, self.padding)
        if self.bias is not None:
            y = y + self.bias
        return y


class DoReFaDense(nn.Module):
    """Linear_Q: a dense layer whose [in, out] kernel is DoReFa-quantized
    each forward (flax ``lecun_normal`` init); the input is not
    quantized."""

    def __init__(self, in_features: int, features: int, w_bit: int = W_BIT,
                 use_bias: bool = True, gen=None, device="cuda"):
        super().__init__()
        device = resolve_device(device)
        self.w_bit = w_bit
        self.kernel = nn.Parameter(_trunc_normal(
            (in_features, features), math.sqrt(1.0 / in_features) / _TRUNC,
            gen, device))
        self.register_parameter("bias", nn.Parameter(torch.zeros(
            features, device=device)) if use_bias else None)

    def forward(self, x):
        y = torch.matmul(x, quantize_weight(self.kernel, self.w_bit))
        if self.bias is not None:
            y = y + self.bias
        return y


class DoReFaBatchNorm(_BNParams):
    """BatchNorm2d_Q: gamma, beta and the RUNNING statistics folded into a
    quantized affine ``w_q * x + b_q``, in training as in eval; the
    running statistics are never updated (read-only, as the reference's
    layer leaves them)."""

    def __init__(self, features: int, w_bit: int = W_BIT, eps: float = 1e-5,
                 device="cuda"):
        super().__init__(features, device)
        self.w_bit, self.eps = w_bit, eps

    def forward(self, x):
        w_q, b_q = fold_batchnorm(self.scale, self.bias, self.mean, self.var,
                                  self.eps, self.w_bit)
        return x * w_q + b_q


class DoReFaBatchNorm1d(_BNParams):
    """BatchNorm1d_Q: the folded affine ``(w, b)``, unquantized (the
    reference computes a quantized ``w`` and passes the float one on). In
    training the input is normalized by its batch statistics (biased
    variance, eps 0) before the affine."""

    def __init__(self, features: int, w_bit: int = W_BIT, eps: float = 1e-5,
                 momentum: float = 0.1, device="cuda"):
        super().__init__(features, device)
        self.w_bit, self.eps, self.momentum = w_bit, eps, momentum

    def forward(self, x, train: bool = False):
        w, b = fold_batchnorm_affine(self.scale, self.bias, self.mean,
                                     self.var, self.eps)
        if train:
            axes = tuple(range(x.ndim - 1))
            bm = torch.mean(x, dim=axes)
            bv = torch.var(x, dim=axes, unbiased=False)
            return (x - bm) * torch.rsqrt(bv) * w + b
        return x * w + b


def yolo_decode(p, img_size, anchors=ULTRANET_ANCHORS, num_outputs: int = 6):
    """YOLOLayer decode. ``p`` [B, ny, nx, na*no] (NHWC conv output);
    returns ``(io, p_raw)``: io [B, na*ny*nx, no] (boxes in pixels,
    sigmoided confidences) and p_raw [B, na, ny, nx, no]."""
    b, ny, nx, _ = p.shape
    na, no = len(anchors), num_outputs
    stride = max(img_size) / max(nx, ny)
    p = p.reshape(b, ny, nx, na, no).permute(0, 3, 1, 2, 4)
    ys, xs = torch.meshgrid(torch.arange(ny, device=p.device),
                            torch.arange(nx, device=p.device), indexing="ij")
    grid_xy = torch.stack([xs, ys], dim=-1).to(p.dtype)
    anchor_wh = torch.tensor(anchors, dtype=p.dtype, device=p.device).reshape(
        1, na, 1, 1, 2) / stride
    xy = torch.sigmoid(p[..., :2]) + grid_xy
    wh = torch.exp(p[..., 2:4]) * anchor_wh
    boxes = torch.cat([xy, wh], dim=-1) * stride
    conf = torch.sigmoid(p[..., 4:])
    io = torch.cat([boxes, conf], dim=-1)
    return io.reshape(b, -1, no), p


def _widths(channels) -> Tuple[int, ...]:
    return tuple(int(channels[i]) if channels is not None else feat
                 for i, (feat, _, _) in enumerate(ULTRANET_LAYERS))


class UltraNet(TreeModule):
    """UltraNetQua, the W4A4 DoReFa QAT network. ``channels`` overrides the
    per-conv widths (a compressed subnet). Weights are drawn from ``seed``
    with flax's initializers (not JAX's numbers) on ``device`` (the GPU
    unless the caller asks for the CPU).

    ``forward(x, train=False)``: NHWC input; eval returns ``(io, p)``,
    train returns ``p`` and updates the running statistics in place."""

    def __init__(self, w_bit: int = W_BIT, a_bit: int = A_BIT,
                 channels: Optional[Sequence[int]] = None,
                 in_channels: int = 3, seed: int = 0, device="cuda"):
        super().__init__()
        dev = resolve_device(device)
        gen = torch.Generator().manual_seed(seed)
        self.w_bit, self.a_bit = w_bit, a_bit
        self.channels = _widths(channels)
        cin = in_channels
        for i, feat in enumerate(self.channels):
            ks = ULTRANET_LAYERS[i][1]
            self.add_module(f"conv_{i}", DoReFaConv(cin, feat, ks, w_bit,
                                                    gen=gen, device=dev))
            self.add_module(f"bn_{i}", BatchNorm(feat, device=dev))
            cin = feat
        self.add_module(f"conv_{len(ULTRANET_LAYERS)}", DoReFaConv(
            cin, ULTRANET_OUT_CHANNELS, 1, w_bit, padding="VALID",
            use_bias=True, gen=gen, device=dev))

    def forward(self, x, train: bool = False):
        img_size = tuple(x.shape[1:3])
        for i, (_, _, pool) in enumerate(ULTRANET_LAYERS):
            x = getattr(self, f"conv_{i}")(x)
            x = getattr(self, f"bn_{i}")(x, train)
            x = quantize_activation(x, self.a_bit)
            if pool:
                x = max_pool_2x2(x)
        x = getattr(self, f"conv_{len(ULTRANET_LAYERS)}")(x)
        if train:
            return yolo_decode(x, img_size)[1]
        return yolo_decode(x, img_size)

    @torch.no_grad()
    def load_trees(self, params, batch_stats=None) -> None:
        """Copy a params tree (and a ``batch_stats`` tree) of tensors or
        numpy arrays, flax paths and layouts, into the model; paths and
        shapes must match."""
        self.load_param_tree(params)
        if batch_stats is not None:
            self.load_batch_stats(batch_stats)


def ultranet_apply(model: UltraNet, params, batch_stats, x,
                   train: bool = False):
    """flax's ``model.apply({"params": params, "batch_stats": stats}, x,
    train=train, mutable=["batch_stats"] if train)``: eval returns
    ``(io, p)``; train returns ``(p, new_batch_stats)``, the given trees
    untouched. Gradients flow to the params tree's tensors."""
    return apply_variables(model, params, x, batch_stats=batch_stats,
                           mutable=train, train=train)


def channels_of(params) -> Tuple[int, ...]:
    """The per-conv widths of a params tree (a subnet's too)."""
    return tuple(int(params[f"conv_{i}"]["kernel"].shape[-1])
                 for i in range(len(ULTRANET_LAYERS)))


def params_from_jax(params, batch_stats, device="cuda", w_bit: int = W_BIT,
                    a_bit: int = A_BIT) -> UltraNet:
    """An UltraNet holding copies of a params and a ``batch_stats`` tree
    (the JAX package's, numpy leaves, or the port's tensors; flax paths:
    the HWIO kernels stay HWIO in the tree, which the node groups and the
    export index, and run as OIHW views), at the widths of their kernels
    (a compressed subnet's too), on ``device``."""
    model = UltraNet(w_bit, a_bit, channels=channels_of(params),
                     in_channels=int(params["conv_0"]["kernel"].shape[2]),
                     device=device)
    model.load_trees(params, batch_stats)
    return model


# ---------------------------------------------------------------------------
# the integer forward
# ---------------------------------------------------------------------------


def int_conv(x_levels, kernel_oihw, padding: int):
    """The exact integer accumulator (int64, NCHW) of a stride-1 conv of
    integer levels: f64 products and sums, rounded."""
    acc = F.conv2d(x_levels.to(torch.float64),
                   kernel_oihw.to(torch.float64), padding=padding)
    return torch.round(acc).to(torch.int64)


def max_pool_2x2_int(x):
    """2x2/2 max pool of NCHW integer levels (odd sizes floor)."""
    b, c, h, w = x.shape
    x = x[:, :, :h // 2 * 2, :w // 2 * 2]
    return x.reshape(b, c, h // 2, 2, w // 2, 2).amax(dim=(3, 5))


def int_param_shapes(in_channels: int = 3) -> Dict[str, Tuple[int, ...]]:
    """The integer tree's shapes as the JAX model declares them (HWIO
    kernels at ``ULTRANET_LAYERS``' widths)."""
    shapes: Dict[str, Tuple[int, ...]] = {}
    cin = in_channels
    for i, (feat, ks, _) in enumerate(ULTRANET_LAYERS):
        shapes[f"conv_{i}_kernel_int"] = (ks, ks, cin, feat)
        shapes[f"conv_{i}_inc"] = (feat,)
        shapes[f"conv_{i}_bias_int"] = (feat,)
        cin = feat
    n = len(ULTRANET_LAYERS)
    shapes[f"conv_{n}_kernel_int"] = (1, 1, cin, ULTRANET_OUT_CHANNELS)
    shapes[f"conv_{n}_bias"] = (ULTRANET_OUT_CHANNELS,)
    return shapes


class UltraNetInt(nn.Module):
    """The folded-BN integer UltraNet of the export artifact: conv levels
    in +-(2^(w_bit-1) - 1), exact integer accumulators, requantization by
    the ``(inc, bias)`` tables to unsigned ``a_bit`` levels (the first
    layer takes 8-bit image levels), and a last 1x1 conv dequantized to
    f32 for the YOLO head. ``forward(x_levels)`` takes NHWC levels and
    returns ``(io, p)``.

    The integer tree (``load_int_params``) is the JAX model's:
    ``conv_{i}_kernel_int`` HWIO int32 (held as OIHW), ``conv_{i}_inc``,
    ``conv_{i}_bias_int`` (i < 8), ``conv_8_kernel_int`` and the f32
    ``conv_8_bias``. The JAX model declares them at ``ULTRANET_LAYERS``'
    widths, so it refuses a pruned artifact; this one refuses it too."""

    def __init__(self, w_bit: int = W_BIT, a_bit: int = A_BIT,
                 in_bit_first: int = 8, l_shift: int = 8,
                 in_channels: int = 3, device="cuda"):
        super().__init__()
        dev = resolve_device(device)
        self.w_bit, self.a_bit = w_bit, a_bit
        self.in_bit_first, self.l_shift = in_bit_first, l_shift
        self.in_channels = in_channels
        self.shapes = int_param_shapes(in_channels)
        for name, shape in self.shapes.items():
            if name.endswith("kernel_int"):  # held as OIHW
                shape = (shape[3], shape[2], shape[0], shape[1])
            dtype = (torch.float32 if name.endswith("_bias")
                     and "bias_int" not in name else torch.int32)
            self.register_buffer(name, torch.zeros(shape, dtype=dtype,
                                                   device=dev))

    @torch.no_grad()
    def load_int_params(self, tree) -> "UltraNetInt":
        """Copy the integer tree (tensors or numpy arrays, HWIO kernels)
        in; a key or shape off the declared ones raises."""
        flat = flatten_tree(tree)
        if set(flat) != set(self.shapes):
            raise ValueError(
                f"integer tree differs from UltraNetInt's: missing "
                f"{sorted(set(self.shapes) - set(flat))[:5]}, unexpected "
                f"{sorted(set(flat) - set(self.shapes))[:5]}")
        for name, want in self.shapes.items():
            v = flat[name]
            if not isinstance(v, torch.Tensor):
                v = torch.from_numpy(np.array(v))
            if tuple(v.shape) != want:
                raise ValueError(
                    f"{name} has shape {tuple(v.shape)}, UltraNetInt "
                    f"declares {want} (ULTRANET_LAYERS' widths): a pruned "
                    "integer artifact is not served, as the JAX model "
                    "refuses it (ROADMAP.md, C2.3)")
            buf = getattr(self, name)
            if name.endswith("kernel_int"):
                v = v.permute(3, 2, 0, 1)
            buf.copy_(v.to(buf.dtype))
        return self

    def forward(self, x_levels):
        if x_levels.shape[-1] != self.in_channels:
            raise ValueError(f"input has {x_levels.shape[-1]} channels, the "
                             f"model {self.in_channels}")
        img_size = tuple(x_levels.shape[1:3])
        x = x_levels.to(torch.int32).permute(0, 3, 1, 2)
        for i, (_, ks, pool) in enumerate(ULTRANET_LAYERS):
            in_bit = self.in_bit_first if i == 0 else self.a_bit
            acc = int_conv(x, getattr(self, f"conv_{i}_kernel_int"), ks // 2)
            x = requantize_int(
                acc, getattr(self, f"conv_{i}_inc")[:, None, None],
                getattr(self, f"conv_{i}_bias_int")[:, None, None],
                w_bit=self.w_bit, in_bit=in_bit, out_bit=self.a_bit,
                l_shift=self.l_shift)
            if pool:
                x = max_pool_2x2_int(x)
        n = len(ULTRANET_LAYERS)
        acc = int_conv(x, getattr(self, f"conv_{n}_kernel_int"), 0)
        s_w = 1.0 / (2.0 ** (self.w_bit - 1) - 1.0)
        s_in = 1.0 / (2.0**self.a_bit - 1.0)
        out = (acc.to(torch.float32) * (s_w * s_in)
               + getattr(self, f"conv_{n}_bias")[:, None, None])
        return yolo_decode(out.permute(0, 2, 3, 1), img_size)


def int_params_from_jax(tree, device="cuda", **kw) -> UltraNetInt:
    """An UltraNetInt holding the JAX package's integer tree (numpy
    leaves, HWIO kernels, as ``export_ultranet_int`` returns it), on
    ``device``."""
    in_channels = int(np.shape(tree["conv_0_kernel_int"])[2])
    return UltraNetInt(in_channels=in_channels, device=device,
                       **kw).load_int_params(tree)

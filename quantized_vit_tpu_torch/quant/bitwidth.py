"""Bit-width algebra shared by the quant layers and the GETA optimizer
(``quantized_vit_tpu/quant/bitwidth.py``).

- bits(d, q_m, t) = log2(|q_m|^t / |d| + 1) + 1
- d(bits, q_m, t) = |q_m|^t / (2^(bits-1) - 1)
- clip(x, q_m, t): the float clip transform
- residual(x, d, q_m, t): the rounding residual in level space
"""

from __future__ import annotations

import torch

from .lsfq import _safe_pow


def bit_width(d, q_m, t=None):
    """bits = log2(|q_m|^t / |d| + 1) + 1. Float; round for int bits."""
    if t is None:
        t = 1.0
    qpow = _safe_pow(q_m.abs(), t)
    return torch.log2(qpow / d.abs() + 1.0) + 1.0


def d_for_bits(bits, q_m, t=None):
    """Step size achieving ``bits`` levels over |q_m|^t."""
    if t is None:
        t = 1.0
    q_abs = torch.clamp_min(q_m.abs(), 1e-10)
    return _safe_pow(q_abs, t) / (2.0**(bits - 1.0) - 1.0)


def init_quant_params(weight, num_bits: float, nonlinear: bool = False):
    """Initial (d, q_m[, t]): q_m = max|W|, d = q_m/(2^(b-1)-1), t = 1."""
    q_m = weight.abs().max()
    d = (q_m - 0.0) / (2.0 ** (float(num_bits) - 1.0) - 1.0)
    if nonlinear:
        return (d.reshape(1), q_m.reshape(1),
                torch.ones((1,), dtype=weight.dtype, device=weight.device))
    return d.reshape(1), q_m.reshape(1)


def clip_transform(x, q_m, t=None, q_s=0.0):
    """sign(x) * clip((|x|-q_s)^t, 0, (q_m-q_s)^t); the >= q_m clamp is
    applied after the <= q_s zeroing."""
    if t is None:
        t = 1.0
    x_abs = x.abs()
    range_pow = _safe_pow((q_m - q_s).abs(), t)
    input_pow = _safe_pow(x_abs - q_s, t)
    out = torch.where(x_abs <= q_s, 0.0, input_pow)
    out = torch.where(x_abs >= q_m, range_pow, out)
    return torch.sign(x) * out


def quant_residual(x, d, q_m, t=None, q_s=0.0):
    """sign(x) * (round(p/d) - p/d) with p the clipped power transform: the
    residual whose inner product with the gradient drives GETA's forget
    rate."""
    if t is None:
        t = 1.0
    x_abs = x.abs()
    range_pow = _safe_pow((q_m - q_s).abs(), t)
    input_pow = _safe_pow(x_abs - q_s, t)
    r = input_pow / d
    res = torch.round(r) - r
    r_top = range_pow / d
    res = torch.where(x_abs >= q_m, torch.round(r_top) - r_top, res)
    res = torch.where(x_abs <= q_s, 0.0, res)
    return torch.sign(x) * res


def quantize_simple(x, d, q_m, t=None, q_s=0.0):
    """Forward-only quantization: the value of lsfq_nonlinear without its
    custom backward or the +1e-6 range guard."""
    if t is None:
        t = 1.0
    x_abs = x.abs()
    range_pow = _safe_pow((q_m - q_s).abs(), t)
    input_pow = _safe_pow(x_abs - q_s, t)
    out = d * torch.round(input_pow / d)
    out = torch.where(x_abs <= q_s, 0.0, out)
    out = torch.where(x_abs >= q_m, d * torch.round(range_pow / d), out)
    return torch.sign(x) * out

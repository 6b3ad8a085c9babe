"""Integer export math of UltraNet: weight levels, the folded BN and the
integer ``(inc, bias)`` requantization tables
(``quantized_vit_tpu/quant/integer.py``).

The (BN + activation quantizer) pair after an integer conv is an
arithmetic progression of thresholds: hardware needs only the integer
``acc * inc + bias`` and a right shift, with ``inc`` and ``bias``
amplified by ``2^l_shift`` so the float scale survives the rounding.

The tables are computed in f32 in the JAX function's order, its Python
constants entering as f32 scalars (``(2^out_bit - 1) * n`` is a Python
float, then one f32 product with ``w``): f64 would move roundings at the
ties. :func:`requantize_int` computes in int64 on every device; the JAX
function does so only where x64 is on, and in int32 otherwise
(ROADMAP.md, C1.7).
"""

from __future__ import annotations

import torch

from .dorefa import _tanh_normalized, sqrt_f32


def uniform_quantize(x, bit: int = 2):
    """``round(x * n) / n`` with ``n = 2^bit - 1`` (no gradient rule: the
    export side)."""
    n = float(2**bit - 1)
    return torch.round(x * n) / n


def weight_quantize_float(x, bit: int = 2):
    """tanh, normalize, ``bit - 1``-bit levels as floats."""
    return uniform_quantize(_tanh_normalized(x), bit=bit - 1)


def weight_quantize_int(x, bit: int = 2):
    """tanh, normalize, round to int32 in +-(2^(bit-1) - 1)."""
    w = _tanh_normalized(x) * (2 ** (bit - 1) - 1)
    return torch.round(w).to(torch.int32)


def bn_act_w_bias_float(gamma, beta, mean, var, eps):
    """BN folded to float ``(w, b)``: ``w = gamma / (sqrt(var) + eps)``,
    ``b = beta - mean / (sqrt(var) + eps) * gamma`` (the reference's
    non-standard denominator, kept)."""
    denom = sqrt_f32(var) + eps
    w = gamma / denom
    b = beta - (mean / denom) * gamma
    return w, b


def bn_act_quantize_int(gamma, beta, mean, var, eps, w_bit=2, in_bit=4,
                        out_bit=4, l_shift=4):
    """Integer ``(inc, bias)`` of the fused BN + activation requantizer.

    With ``n = 2^(w_bit-1+in_bit+l_shift) / ((2^(w_bit-1)-1)(2^in_bit-1))``:
    ``inc = round((2^out_bit - 1) * n * w)`` and
    ``bias = round((2^(w_bit-1)-1)(2^in_bit-1)(2^out_bit-1) * n * b)``,
    int32, rounded half to even."""
    w, b = bn_act_w_bias_float(gamma, beta, mean, var, eps)
    n = 2 ** (w_bit - 1 + in_bit + l_shift) / (
        (2 ** (w_bit - 1) - 1) * (2**in_bit - 1))
    inc_q = torch.round((2**out_bit - 1) * n * w).to(torch.int32)
    bias_q = torch.round(
        (2 ** (w_bit - 1) - 1) * (2**in_bit - 1) * (2**out_bit - 1) * n * b
    ).to(torch.int32)
    return inc_q, bias_q


def requantize_int(acc, inc, bias, w_bit=4, in_bit=4, out_bit=4, l_shift=4):
    """The next layer's unsigned ``out_bit`` levels (int32) of an integer
    conv accumulator: ``clip(floor((acc * inc + bias + 2^(s-1)) / 2^s),
    0, 2^out_bit - 1)`` with ``s = w_bit - 1 + in_bit + l_shift``, in
    int64. ``inc``/``bias`` broadcast against ``acc``."""
    shift = w_bit - 1 + in_bit + l_shift
    scaled = (acc.to(torch.int64) * inc.to(torch.int64)
              + bias.to(torch.int64))
    denom = 2**shift
    out = torch.div(scaled + denom // 2, denom, rounding_mode="floor")
    return torch.clamp(out, 0, 2**out_bit - 1).to(torch.int32)

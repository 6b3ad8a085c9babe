"""DoReFa straight-through quantizers of the UltraNet 4-bit CNN
(``quantized_vit_tpu/quant/dorefa.py``).

- :func:`uniform_quantize`: ``round(x * n) / n`` with ``n = 2^k - 1`` and
  a straight-through gradient; ``k == 32`` is the identity, ``k == 1``
  the sign.
- :func:`quantize_weight`: tanh, divided by ``max|tanh(w)|`` (the
  gradient flows through the max, split evenly over tied positions, as
  ``torch.amax`` and JAX's reduction both do), then signed ``w_bit - 1``
  levels.
- :func:`quantize_activation`: clamp to [0, 1], then unsigned ``a_bit``
  levels.
- :func:`fold_batchnorm`: BN folded into an affine ``(w, b)`` with the
  reference's ``gamma / (sqrt(var) + eps)`` denominator, each clamped to
  [-1, 1] and quantized on the unsigned grid.

The straight-through estimator is the JAX package's expression,
``x + (q - x).detach()``: its value is that sum rounded in f32 (not
always ``q`` to the last bit), and the port computes the same sum.
Every op keeps the JAX function's order in f32, Python constants
entering as f32 scalars, as JAX's weak types do.
"""

from __future__ import annotations

import torch


def sqrt_f32(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded f32 square root (XLA's): taken in f64 and
    rounded once, which is exact for sqrt. PyTorch's vectorized f32 sqrt
    on the CPU can be an ulp off it."""
    return torch.sqrt(x.to(torch.float64)).to(x.dtype)


def _ste(x: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Value of ``q`` (as ``x + (q - x)``), gradient of the identity."""
    return x + (q - x).detach()


def uniform_quantize(x: torch.Tensor, k: int) -> torch.Tensor:
    """``round(x * (2^k - 1)) / (2^k - 1)`` with a straight-through
    gradient (round half to even)."""
    if k == 32:
        return x
    if k == 1:
        return _ste(x, torch.sign(x))
    n = float(2**k - 1)
    return _ste(x, torch.round(x * n) / n)


def _tanh_normalized(w: torch.Tensor) -> torch.Tensor:
    wt = torch.tanh(w)
    return wt / torch.amax(torch.abs(wt))


def quantize_weight(w: torch.Tensor, w_bit: int) -> torch.Tensor:
    """DoReFa weight quantizer: 32 bits pass through; 1 bit scales the
    sign by the (detached) mean |w|; otherwise tanh, normalize, signed
    ``w_bit - 1``-bit levels."""
    if w_bit == 32:
        return w
    if w_bit == 1:
        e = torch.mean(torch.abs(w)).detach()
        return (uniform_quantize(w / e, 1) + 1.0) / 2.0 * e
    return uniform_quantize(_tanh_normalized(w), w_bit - 1)


def quantize_activation(x: torch.Tensor, a_bit: int) -> torch.Tensor:
    """DoReFa activation quantizer: clamp to [0, 1], then unsigned
    ``a_bit`` levels."""
    if a_bit == 32:
        return x
    return uniform_quantize(torch.clamp(x, 0.0, 1.0), a_bit)


def quantize_weight_levels(w: torch.Tensor, w_bit: int) -> torch.Tensor:
    """Integer levels of :func:`quantize_weight`, int32 in
    +-(2^(w_bit-1) - 1)."""
    n = float(2 ** (w_bit - 1) - 1)
    return torch.round(_tanh_normalized(w) * n).to(torch.int32)


def quantize_activation_levels(x: torch.Tensor, a_bit: int) -> torch.Tensor:
    """Integer levels of :func:`quantize_activation`, int32 in
    [0, 2^a_bit - 1]."""
    n = float(2**a_bit - 1)
    return torch.round(torch.clamp(x, 0.0, 1.0) * n).to(torch.int32)


def fold_batchnorm_affine(gamma, beta, mean, var, eps):
    """BN(gamma, beta, mean, var, eps) as the affine ``w * x + b``, with
    the reference's ``sqrt(var) + eps`` denominator."""
    denom = sqrt_f32(var) + eps
    w = gamma / denom
    b = beta - (mean / denom) * gamma
    return w, b


def fold_batchnorm(gamma, beta, mean, var, eps, w_bit: int):
    """The quantized-BN fold: ``(w_q, b_q)`` such that the layer computes
    ``w_q * x + b_q``. The folded affine, each clamped to [-1, 1], mapped
    to [0, 1], quantized at ``w_bit`` unsigned levels and mapped back."""
    w, b = fold_batchnorm_affine(gamma, beta, mean, var, eps)
    w01 = torch.clamp(w, -1.0, 1.0) / 2.0 + 0.5
    b01 = torch.clamp(b, -1.0, 1.0) / 2.0 + 0.5
    w_q = 2.0 * uniform_quantize(w01, w_bit) - 1.0
    b_q = 2.0 * uniform_quantize(b01, w_bit) - 1.0
    return w_q, b_q

"""Plain PyTorch ports of ``quantized_vit_tpu/ops/reference.py``.

Integer products are exact: torch's ``int8 @ int8`` overflows in int8, and
float32 is not exact past 2**24 (127 * 127 * 3072 > 2**24), so the int32
accumulator comes from a float64 product, exact while every sum stays
below 2**53.
"""

from __future__ import annotations

import torch

from ..quant.packing import unpack_int4


def int_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact int32 ``a @ b`` of two integer-level tensors."""
    return torch.matmul(a.to(torch.float64), b.to(torch.float64)).to(
        torch.int32)


def int4_matmul_ref(x_levels: torch.Tensor, w_packed: torch.Tensor):
    """int32 accumulator of ``x_levels @ unpack(w_packed)``; x [M, K] int8,
    w_packed [K//2, N] packed int4."""
    return int_dot(x_levels, unpack_int4(w_packed, axis=0))


def int8_matmul_ref(x_levels: torch.Tensor, w_levels: torch.Tensor):
    """int32 accumulator of ``x_levels @ w_levels`` (both int8)."""
    return int_dot(x_levels, w_levels)


def quant_linear_ref(acc: torch.Tensor, scale, bias=None,
                     out_dtype=torch.float32):
    """Dequant epilogue: ``acc * scale + bias`` (scale scalar or [N])."""
    out = acc.to(torch.float32) * scale
    if bias is not None:
        out = out + bias
    return out.to(out_dtype)

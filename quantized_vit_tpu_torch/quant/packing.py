"""INT4 packing, byte-identical to ``quantized_vit_tpu/quant/packing.py``.

Two signed nibbles per int8 byte, packed along the contraction axis in
halves::

    packed[k, n] = (W[k, n] & 0xF) | (W[k + K/2, n] << 4)

The CUDA kernels unpack the same layout in shared memory: row ``k < K/2``
is the low nibble of packed row ``k``, row ``k >= K/2`` the high nibble of
packed row ``k - K/2``.
"""

from __future__ import annotations

import torch


def pack_int4(w: torch.Tensor, axis: int = 0) -> torch.Tensor:
    """Pack signed int4 values (in [-8, 7]) two-per-int8 along ``axis``."""
    k = w.shape[axis]
    if k % 2:
        raise ValueError(f"pack axis length must be even, got {k}")
    w = torch.movedim(w.to(torch.int8), axis, 0)
    lo = w[: k // 2]
    hi = w[k // 2:]
    packed = torch.bitwise_or(torch.bitwise_and(lo, 0x0F),
                              torch.bitwise_left_shift(hi, 4))
    return torch.movedim(packed, 0, axis).contiguous()


def unpack_int4(packed: torch.Tensor, axis: int = 0) -> torch.Tensor:
    """Inverse of :func:`pack_int4`: int8 out, axis length doubled."""
    p = torch.movedim(packed.to(torch.int8), axis, 0)
    lo = torch.bitwise_right_shift(torch.bitwise_left_shift(p, 4), 4)
    hi = torch.bitwise_right_shift(p, 4)
    return torch.movedim(torch.cat([lo, hi], dim=0), 0, axis).contiguous()

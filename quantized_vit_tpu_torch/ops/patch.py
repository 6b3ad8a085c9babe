"""Patch-embed finalization (kernel K4).

Replaces ``quantized_vit_tpu/ops/patch.py:patch_finalize`` (``pallas_call``
at patch.py:52). One pass writes the padded token stream::

  rows 0..P-1 : acc*scale + pos_patch   (conv bias folded into pos_patch)
  row  P      : cls_row (cls token + its positional row)
  rows P+1..  : 0

Kernel: ``csrc/patch_finalize.cu`` (CUDA C++). The plain version is the
layout of ``serve/vit_int4.py:244-250``. CPU tensors take the plain
version; CUDA tensors launch the kernel or raise.
"""

from __future__ import annotations

import torch

from . import _build
from .fused import _f32


def patch_finalize_plain(acc, pos_patch, cls_row, scale, *, n_pad: int,
                         out_dtype=torch.bfloat16):
    b, p, d = acc.shape
    body = acc * _f32(scale, acc.device) + pos_patch
    x = torch.cat([body, torch.broadcast_to(cls_row, (b, 1, d))],
                  dim=1).to(out_dtype)
    if n_pad != p + 1:
        x = torch.nn.functional.pad(x, (0, 0, 0, n_pad - p - 1))
    return x.reshape(b * n_pad, d)


def patch_finalize(acc, pos_patch, cls_row, scale, *, n_pad: int,
                   out_dtype=torch.bfloat16):
    """acc [B, P, D] f32 patch-embed accumulators -> [B*n_pad, D] padded
    token stream in ``out_dtype``. pos_patch: [P, D] f32 with the conv bias
    folded in; cls_row: [D]; scale: scalar dequant scale."""
    if acc.device.type == "cpu":
        return patch_finalize_plain(acc, pos_patch, cls_row, scale,
                                    n_pad=n_pad, out_dtype=out_dtype)
    _build.require_cuda("patch_finalize", acc, pos_patch, cls_row)
    b, p, d = acc.shape
    if n_pad < p + 1:
        raise ValueError(f"n_pad {n_pad} < {p} patches + cls")
    dev = acc.device
    acc = acc.to(torch.float32).contiguous()
    pos = torch.as_tensor(pos_patch, dtype=torch.float32,
                          device=dev).reshape(p, d).contiguous()
    cls = torch.as_tensor(cls_row, dtype=torch.float32,
                          device=dev).reshape(d).contiguous()
    sc = _f32(scale, dev).reshape(1)
    out = torch.empty((b * n_pad, d), dtype=out_dtype, device=dev)
    if out.numel() == 0:
        return out
    lib = _build.library("patch_finalize")
    fn = lib.qvt_patch_finalize
    P, I = _build.P, _build.I
    fn.argtypes = [P, P, P, P, P, I, I, I, I, I, P]
    fn.restype = I
    code = fn(acc.data_ptr(), pos.data_ptr(), cls.data_ptr(), sc.data_ptr(),
              out.data_ptr(), _build.dtype_code(out_dtype), b, p, d, n_pad,
              _build.stream())
    _build.check(code, "patch_finalize")
    _build.count_launch("patch_finalize")
    return out

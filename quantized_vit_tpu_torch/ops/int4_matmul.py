"""The first-generation integer GEMMs (kernels K10-K12) and their plain
versions.

Port of ``quantized_vit_tpu/ops/int4_matmul.py``. One CUDA GEMM with
three front ends (``csrc/int_matmul.cu``) replaces three TPU kernels:

- :func:`int4_matmul` (K10) replaces ``int4_matmul`` (``pallas_call`` at
  int4_matmul.py:193): int8 levels x packed int4 weights, ``acc * scale +
  bias``, or int8 levels of the next layer with ``requant_top``;
- :func:`int8_matmul` (K11) replaces ``int8_matmul`` (:273): the same with
  int8 weights;
- :func:`quant_matmul_fa` (K12) replaces ``quant_matmul_fa`` (:480): a
  float x quantized to LSFQ levels in the prologue, ``sign(x) *
  min(round(p / d), top)`` with ``p = |x|`` or ``|x|**t`` as
  ``exp(t*log(max(|x|, 1e-30)))``. The division is a true division, where
  K1's ``quant`` prologue multiplies by ``1/d`` (``fused._quantize_f32``):
  the two can differ by an ulp and flip a level at a rounding tie, so K1
  does not stand in for K12.

The integer sums are exact, so the result is the unpadded product: the
JAX wrappers pad K to 256 or 128 and M, N to their tiles, the kernel
masks its ragged edges instead. The epilogue is ``acc.f32 * scale`` then
``+ bias`` (two roundings); ``requant_top`` rounds half to even and clips.
``block_m``/``block_n`` are the TPU kernels' tile sizes: accepted, and the
result does not depend on them; the VMEM budget of ``_auto_blocks`` has no
counterpart. Each wrapper takes the plain version only for CPU tensors;
for CUDA tensors it plans (:func:`plan_int_matmul`: the weight copied
n-major once, the constants on the device) and launches
(:func:`run_int_matmul`, which counts the launch under the front end's
name).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from . import _build
from .fused import _f32
from .reference import int4_matmul_ref, int8_matmul_ref


def _check_int8(name, x, w):
    if x.dtype != torch.int8 or w.dtype != torch.int8:
        raise TypeError(f"{name}: x_levels and w must be int8")


def _k_of(w, fmt):
    """(K, N) of an int8 [K, N] or packed int4 [K/2, N] weight."""
    if fmt == "int4":
        return 2 * w.shape[0], w.shape[1]
    if fmt == "int8":
        return tuple(w.shape)
    raise ValueError(f"unknown weight format {fmt!r}")


def _check_k(x, k_w):
    if x.shape[-1] != k_w:
        raise ValueError(f"K mismatch: x has K={x.shape[-1]}, w has K={k_w}")


def _epilogue(acc, scale, bias, out_dtype, requant_top=None):
    """``acc.f32 * scale`` then ``+ bias`` in f32, cast to ``out_dtype`` or
    requantized to int8 (int4_matmul.py:96-104, :113-114)."""
    out = acc.to(torch.float32) * torch.broadcast_to(
        _f32(scale, acc.device), (acc.shape[-1],))
    if bias is not None:
        out = out + _f32(bias, acc.device)
    if requant_top is not None:
        top = float(requant_top)
        return torch.clamp(torch.round(out), -top, top).to(torch.int8)
    return out.to(out_dtype)


def fa_levels(x, act_d, act_t, act_top, act_pow: bool):
    """``_fa_quant`` (int4_matmul.py:326-343): int8 levels
    ``sign(x) * min(round(p / d), top)`` in f32, ``p = |x|`` or
    ``exp(t*log(max(|x|, 1e-30)))``, with a true division by ``d``."""
    x = x.to(torch.float32)
    dev = x.device
    ax = x.abs()
    if act_pow:
        p = torch.exp(_f32(act_t, dev)
                      * torch.log(torch.clamp_min(ax, 1e-30)))
    else:
        p = ax
    top = torch.as_tensor(act_top, device=dev).to(torch.int32).to(
        torch.float32)
    lv = torch.minimum(torch.round(p / _f32(act_d, dev)), top)
    return (torch.sign(x) * lv).to(torch.int8)


def int4_matmul_plain(x_levels, w_packed, scale, bias=None, *,
                      out_dtype=torch.float32, requant_top=None):
    """Plain PyTorch version of K10: ``(x_levels @ unpack(w_packed)) *
    scale + bias``, or its int8 requant with ``requant_top``."""
    _check_int8("int4_matmul", x_levels, w_packed)
    _check_k(x_levels, _k_of(w_packed, "int4")[0])
    return _epilogue(int4_matmul_ref(x_levels, w_packed), scale, bias,
                     out_dtype, requant_top)


def int8_matmul_plain(x_levels, w_levels, scale, bias=None, *,
                      out_dtype=torch.float32):
    """Plain PyTorch version of K11: ``(x_levels @ w_levels) * scale +
    bias`` in f32, cast to ``out_dtype``."""
    _check_int8("int8_matmul", x_levels, w_levels)
    _check_k(x_levels, w_levels.shape[0])
    return _epilogue(int8_matmul_ref(x_levels, w_levels), scale, bias,
                     out_dtype)


def quant_matmul_fa_plain(x, w, scale, bias, act_d, act_t, act_top, *,
                          fmt="int4", act_pow=True, out_dtype=torch.float32):
    """Plain PyTorch version of K12: :func:`fa_levels` of ``x``, then the
    int4 or int8 product and the epilogue."""
    _check_k(x, _k_of(w, fmt)[0])
    lv = fa_levels(x, act_d, act_t, act_top, act_pow)
    acc = int4_matmul_ref(lv, w) if fmt == "int4" else int8_matmul_ref(lv, w)
    return _epilogue(acc, scale, bias, out_dtype)


def int4_matmul_xla(x_levels, w_packed, scale, bias=None,
                    out_dtype=torch.float32):
    """Port of the XLA mirror ``int4_matmul_xla`` (int4_matmul.py:299-307):
    the plain version, without requant."""
    return int4_matmul_plain(x_levels, w_packed, scale, bias,
                             out_dtype=out_dtype)


def int8_matmul_xla(x_levels, w_levels, scale, bias=None,
                    out_dtype=torch.float32):
    """Port of the XLA mirror ``int8_matmul_xla`` (int4_matmul.py:310-318)."""
    return int8_matmul_plain(x_levels, w_levels, scale, bias,
                             out_dtype=out_dtype)


@dataclasses.dataclass(frozen=True)
class IntMatmulPlan:
    """One call site of K10-K12, prepared once by :func:`plan_int_matmul`:
    the weight in the kernels' layout, scale [N] and bias on the device,
    and for the float front end the quantizer (``prm`` = [d, t], ``top``
    int32)."""

    w_t: torch.Tensor
    int4: bool
    k: int
    n: int
    scale: torch.Tensor
    bias: Optional[torch.Tensor]
    prm: Optional[torch.Tensor]
    top: Optional[torch.Tensor]
    act_pow: bool

    @property
    def kernel(self) -> str:
        """The launch counter: the JAX function this call site replaces."""
        if self.prm is not None:
            return "quant_matmul_fa"
        return "int4_matmul" if self.int4 else "int8_matmul"


def plan_int_matmul(w, scale, bias=None, *, fmt="int4", act_d=None,
                    act_t=None, act_top=None, act_pow=False) -> IntMatmulPlan:
    """The layer-side work of K10-K12, done once: the weight copy into the
    kernels' layout, the constants on the device. ``act_d``/``act_t``/
    ``act_top`` make it a :func:`quant_matmul_fa` site (float x); without
    them x is int8 levels. ``w`` must lie on a CUDA device."""
    k, n = _k_of(w, fmt)
    if w.dtype != torch.int8:
        raise TypeError("int8 or packed int4 weights must be int8-typed")
    _build.require_cuda("int_matmul", w)
    dev = w.device
    prm = top = None
    if act_d is not None:
        t = 1.0 if act_t is None else act_t
        prm = torch.stack([_f32(act_d, dev).reshape(()),
                           _f32(t, dev).reshape(())])
        if not isinstance(act_top, torch.Tensor) and np.ndim(act_top) == 0:
            top = torch.full((1,), int(act_top), dtype=torch.int32,
                             device=dev)
        else:
            top = torch.as_tensor(act_top, device=dev).to(
                torch.int32).reshape(1)
    scale = torch.broadcast_to(_f32(scale, dev), (n,)).contiguous()
    bias = None if bias is None else _f32(bias, dev).contiguous()
    return IntMatmulPlan(w_t=_build.n_major(w), int4=fmt == "int4", k=k, n=n,
                         scale=scale, bias=bias, prm=prm, top=top,
                         act_pow=bool(act_pow))


def run_int_matmul(plan: IntMatmulPlan, x, *, out_dtype=torch.float32,
                   requant_top=None):
    """Launches the GEMM on ``x`` [M, K] for a prepared site: the only
    place that launches it. ``x`` is int8 levels, or f32/bf16 for a
    :func:`quant_matmul_fa` site."""
    name = plan.kernel
    _build.require_cuda(name, x)
    _check_k(x, plan.k)
    if (plan.prm is None) != (x.dtype == torch.int8):
        raise TypeError(f"{name}: x of dtype {x.dtype} does not fit this "
                        "site (int8 levels, or a float x for "
                        "quant_matmul_fa)")
    # the kernel writes f32, bf16 or requantized int8; any other dtype is
    # its f32 output cast, as the JAX wrappers cast (int4_matmul.py:104,
    # :296)
    kernel_dtype = (torch.int8 if requant_top is not None else out_dtype
                    if out_dtype in (torch.float32, torch.bfloat16)
                    else torch.float32)
    m = x.shape[0]
    x = x.contiguous()
    out = torch.empty((m, plan.n), device=x.device, dtype=kernel_dtype)
    if out.numel() == 0:
        return out if requant_top is not None else out.to(out_dtype)
    fn = _build.library("int_matmul").qvt_int_matmul
    P, I = _build.P, _build.I
    fn.argtypes = [P, I, P, I, P, P, P, P, P, I, I, I, I, I, I, I, P]
    fn.restype = I
    code = fn(
        x.data_ptr(), _build.dtype_code(x.dtype), plan.w_t.data_ptr(),
        int(plan.int4), plan.scale.data_ptr(), _build.ptr(plan.bias),
        _build.ptr(plan.prm), _build.ptr(plan.top), out.data_ptr(),
        _build.dtype_code(out.dtype), int(requant_top is not None),
        int(requant_top or 0), m, plan.k, plan.n, int(plan.act_pow),
        _build.stream())
    _build.check(code, name)
    _build.count_launch(name)
    return out if requant_top is not None else out.to(out_dtype)


def int4_matmul(x_levels, w_packed, scale, bias=None, *, block_m=None,
                block_n=None, out_dtype=torch.float32, requant_top=None):
    """``(x_levels @ unpack(w_packed)) * scale + bias`` (kernel K10).

    x_levels: [M, K] int8 levels (K = 2 * w_packed rows); w_packed:
    [K/2, N] packed int4 (halves layout, ``quant/packing.py``); scale:
    scalar or [N] f32; bias: [N] or None. ``requant_top``: int8 levels
    ``clip(round(acc*scale+bias), -top, top)`` instead of ``out_dtype``.
    ``block_m``/``block_n``: the TPU kernel's tiles, ignored (the result
    does not depend on them). CPU tensors take :func:`int4_matmul_plain`;
    CUDA tensors :func:`plan_int_matmul` then :func:`run_int_matmul`."""
    del block_m, block_n
    _check_int8("int4_matmul", x_levels, w_packed)
    _check_k(x_levels, _k_of(w_packed, "int4")[0])
    if x_levels.device.type == "cpu":
        return int4_matmul_plain(x_levels, w_packed, scale, bias,
                                 out_dtype=out_dtype, requant_top=requant_top)
    return run_int_matmul(plan_int_matmul(w_packed, scale, bias, fmt="int4"),
                          x_levels, out_dtype=out_dtype,
                          requant_top=requant_top)


def int8_matmul(x_levels, w_levels, scale, bias=None, *, block_m=None,
                block_n=None, out_dtype=torch.float32):
    """:func:`int4_matmul`'s contract with int8 weights [K, N] (kernel
    K11): the product in f32, cast to ``out_dtype``."""
    del block_m, block_n
    _check_int8("int8_matmul", x_levels, w_levels)
    _check_k(x_levels, w_levels.shape[0])
    if x_levels.device.type == "cpu":
        return int8_matmul_plain(x_levels, w_levels, scale, bias,
                                 out_dtype=out_dtype)
    return run_int_matmul(plan_int_matmul(w_levels, scale, bias, fmt="int8"),
                          x_levels, out_dtype=out_dtype)


def quant_matmul_fa(x, w, scale, bias, act_d, act_t, act_top, *, fmt="int4",
                    act_pow=True, block_m=None, block_n=None,
                    out_dtype=torch.float32):
    """Quantized matmul with the activation quantization fused in (kernel
    K12).

    x: [M, K] f32 or bf16, quantized to int8 levels in the prologue
    (:func:`fa_levels`); w: packed int4 [K/2, N] (``fmt='int4'``) or int8
    [K, N]; act_d/act_t/act_top: the scalar quantizer (``act_pow=False``
    skips the power map when t == 1). CPU tensors take
    :func:`quant_matmul_fa_plain`; CUDA tensors :func:`plan_int_matmul`
    then :func:`run_int_matmul`."""
    del block_m, block_n
    _check_k(x, _k_of(w, fmt)[0])
    if x.device.type == "cpu":
        return quant_matmul_fa_plain(x, w, scale, bias, act_d, act_t,
                                     act_top, fmt=fmt, act_pow=act_pow,
                                     out_dtype=out_dtype)
    return run_int_matmul(
        plan_int_matmul(w, scale, bias, fmt=fmt, act_d=act_d, act_t=act_t,
                        act_top=act_top, act_pow=act_pow), x,
        out_dtype=out_dtype)

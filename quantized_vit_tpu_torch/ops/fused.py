"""Fused quantized matmul (kernel K1) and whole-MLP block (kernel K2).

Port of ``quantized_vit_tpu/ops/fused.py``. The level math is the JAX
package's, op for op, in f32: round-half-to-even (``torch.round``), the
linear quantizer multiplies by ``1/d``, the pow quantizer is
``sign * min(round(exp(t*log(max(|x|,1e-30))) / d), top)``, LayerNorm uses
the fast-variance form, erf is the clamped odd polynomial, and GELU+quant
uses the folded form. Sums that a kernel takes in its own order (the
LayerNorm statistics here, the attention dots in ``attention.py``) run in
float64 and round once to f32, in the kernels and the plain versions
alike, so the two agree bit for bit. The constant folds (``1/d`` into
LayerNorm gamma/beta, ``1/d`` or ``2**-0.5`` into the dequant scale/bias)
run in f32, identically for the kernel (in its plan) and the plain
version.

Kernels:

- :func:`fused_quant_matmul` replaces ``ops/fused.py:_fused_quant_matmul``
  (``pallas_call`` at fused.py:556): :func:`run_matmul` (K1,
  ``csrc/fused_quant_matmul.cu``) runs the prologue once a row into a
  level scratch, then the GEMM on the int8 tensor cores at the work split
  of :func:`matmul_layout`, in one launch. Plain version:
  :func:`fused_quant_matmul_plain` (port of ``fused_quant_matmul_xla``).
- :func:`run_mlp` (K2, ``csrc/fused_mlp.cu``) replaces
  ``ops/fused.py:_fused_mlp`` (``pallas_call`` at fused.py:977): one
  cooperative launch of LayerNorm + quant once a row, then fc1 and fc2 on
  the int8 tensor cores through a hidden-level scratch, at the work split
  of :func:`mlp_layout`; any width.
- :func:`run_mlp_chunked` (K8, ``csrc/fused_mlp_chunked.cu``) replaces
  ``ops/fused.py:_fused_mlp_chunked`` (``pallas_call`` at fused.py:1065):
  the same function for int8 weights too big to stay resident (ViT-H),
  one cooperative launch whose GEMMs run on wgmma with the weights
  streamed through a TMA ring, at the work split of
  :func:`chunked_layout`; any width.
- :func:`fused_mlp` picks K2 or K8 as ``_fused_mlp`` does
  (:func:`mlp_auto_hid_block`). Plain version of both:
  :func:`fused_mlp_plain` (port of ``fused_mlp_xla``): the JAX package's
  resident and chunked kernels compute the same function, bit for bit
  (tests/ops/test_fused.py:245-283).

Each wrapper takes the plain version only for CPU tensors; for CUDA tensors
it launches its kernel or raises. A kernel call splits in two: the layer's
side, done once (``plan_*``: checks, the weight copy into the kernels'
n-major layout, the constant folds, the quantizer scalars on the device),
and the launch on an input (``run_*``, which counts the launch). The
wrapper does both per call; the forward keeps its plans
(``serve/vit_int4.py:prepare_kernels``). The artifact keeps the JAX
package's [K, N] layout.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Optional, Sequence

import numpy as np
import torch

from . import _build
from .reference import int4_matmul_ref, int8_matmul_ref

_SQRT2 = 2.0**0.5
_ERF_COEFS = (
    1.0820510812e+00, -2.8632930819e-01, 5.0755384214e-02,
    -4.6024812456e-03, 1.6343068626e-04,
)
_PROLOGUES = {None: 0, "quant": 1, "ln_quant": 2, "gelu_quant": 3}
_EPILOGUES = {None: 0, "residual": 1, "quant": 2, "gelu_quant": 3}
# K1 on int8 levels it cannot read in place (K % 16 != 0, or x off 16
# bytes): its first phase copies them into the level scratch
COPY_PROLOGUE = "copy"
_PRO_CODES = dict(_PROLOGUES, copy=4)


def _f32(v, device) -> torch.Tensor:
    """``v`` as an f32 tensor on ``device``. A Python or numpy scalar is
    filled on the device: a host-to-device copy would make the host wait
    for the stream and leave the card idle between launches."""
    if not isinstance(v, torch.Tensor) and np.ndim(v) == 0:
        return torch.full((), float(v), dtype=torch.float32, device=device)
    return torch.as_tensor(v, dtype=torch.float32, device=device)


def _quantize_f32(x, d, t, top, act_pow: bool, folded: bool = False):
    """LSFQ levels ``clip(round(|x|^t / d), -top, top) * sign`` in f32
    (fused.py:51-78). ``folded``: 1/d is already in x's affine producer."""
    x = x.to(torch.float32)
    top_f = float(top)
    if act_pow:
        p = torch.exp(t * torch.log(torch.clamp_min(x.abs(), 1e-30)))
        lv = torch.sign(x) * torch.clamp_max(torch.round(p / d), top_f)
    elif folded:
        lv = torch.clamp(torch.round(x), -top_f, top_f)
    else:
        lv = torch.clamp(torch.round(x * (1.0 / d)), -top_f, top_f)
    return lv.to(torch.int8)


def sum_f32(x, dim):
    """f32 sum over ``dim`` taken in float64 and rounded once: the port's
    kernels sum in another order than PyTorch does, and this makes both
    give the correctly rounded f32 sum, so they agree bit for bit. (The
    JAX package sums in f32; the port differs from it by that rounding
    error, which flips a level only at a rounding tie.)"""
    return torch.sum(x.to(torch.float64), dim=dim, keepdim=True).to(
        torch.float32)


def _layernorm_f32(x, gamma, beta, eps, k_real=None):
    """LayerNorm in f32, fast-variance form ``max(E[x^2] - mu^2, 0)``
    (fused.py:81-94), with the sums of :func:`sum_f32`. The inverse root
    is ``1/sqrt`` (correctly rounded division and square root), the form
    the CUDA kernels use too."""
    x32 = x.to(torch.float32)
    k = k_real if k_real is not None else x.shape[-1]
    inv_k = 1.0 / float(k)
    mu = sum_f32(x32, -1) * inv_k
    mean2 = sum_f32(x32 * x32, -1) * inv_k
    var = torch.clamp_min(mean2 - mu * mu, 0.0)
    return (x32 - mu) * (1.0 / torch.sqrt(var + eps)) * gamma + beta


def _erf_f32(x):
    """erf as the clamped odd polynomial of fused.py:106-127, Horner in
    f32 (never ``torch.erf``: the kernels and the JAX package use this)."""
    v = torch.clamp(x, -3.0, 3.0)
    v2 = v * v
    acc = torch.full_like(v, _ERF_COEFS[-1])
    for c in _ERF_COEFS[-2::-1]:
        acc = acc * v2 + c
    return acc * v


def _gelu_f32(x):
    return x * 0.5 * (1.0 + _erf_f32(x * (2.0**-0.5)))


def _gelu_quant_folded(z, d, top):
    """round(GELU(y)/d) levels from z = y/sqrt(2) (fused.py:138-152):
    ``c2 = sqrt2*0.5/d; w = z*c2; round(w + w*erf(z))``."""
    e = _erf_f32(z)
    # tensor / tensor: a Python float over a tensor would become
    # reciprocal(d) * c, which rounds differently from the f32 division
    c2 = _f32(_SQRT2 * 0.5, d.device) / d
    top_f = float(top)
    w = z * c2
    return torch.clamp(torch.round(w + w * e), -top_f, top_f).to(torch.int8)


def _check_tops(name, prologue, epilogue, act_d, act_top, out_top):
    # a missing/zero top would clip every level to 0 and emit all-zero
    # int8 output
    if (prologue in ("quant", "ln_quant", "gelu_quant") and act_d is not None
            and not (act_top or 0) >= 1):
        raise ValueError(f"{name}: {prologue!r} prologue needs a positive "
                         f"act_top, got {act_top!r}")
    if epilogue in ("quant", "gelu_quant") and not (out_top or 0) >= 1:
        raise ValueError(f"{name}: {epilogue!r} epilogue needs a positive "
                         f"out_top, got {out_top!r}")


def fold_ln(ln_scale, ln_bias, act_d, act_pow: bool, device):
    """LayerNorm gamma/beta in f32, with the quantizer's 1/d folded in when
    it is linear (fused.py:459-466): the LN + quant prologue then rounds
    LN(x) straight to levels. The one place this fold is made."""
    ln_scale, ln_bias = _f32(ln_scale, device), _f32(ln_bias, device)
    if not act_pow:
        inv_d = 1.0 / _f32(act_d, device)
        ln_scale = ln_scale * inv_d
        ln_bias = ln_bias * inv_d
    return ln_scale, ln_bias


def fold_gelu(scale, bias, device):
    """fc1's dequant scale/bias with 2**-0.5 folded in for the folded GELU
    + quant epilogue (fused.py:470-476, :885-891). The one place this fold
    is made."""
    f = _f32(2.0**-0.5, device)
    return scale * f, None if bias is None else bias * f


def _matmul_folds(device, n, scale, bias, prologue, act_d, act_pow,
                  ln_scale, ln_bias, epilogue, out_d, out_pow,
                  prefolded=False):
    """The wrapper-side constant folds of fused.py:459-476, in f32.
    Returns (scale [n], bias [n] or None, ln_scale, ln_bias, act_folded,
    out_folded). ``prefolded``: the constants carry the folds already (a
    folded block stack's operands); only the flags are set."""
    scale = torch.broadcast_to(_f32(scale, device), (n,))
    bias = None if bias is None else _f32(bias, device)
    act_folded = prologue == "ln_quant" and not act_pow
    out_folded = epilogue in ("quant", "gelu_quant") and not out_pow
    if prefolded:
        return scale, bias, ln_scale, ln_bias, act_folded, out_folded
    if prologue == "ln_quant":
        ln_scale, ln_bias = fold_ln(ln_scale, ln_bias, act_d, act_pow, device)
    if out_folded and epilogue == "gelu_quant":
        scale, bias = fold_gelu(scale, bias, device)
    elif out_folded:
        f = 1.0 / _f32(out_d, device)
        scale = scale * f
        if bias is not None:
            bias = bias * f
    return scale, bias, ln_scale, ln_bias, act_folded, out_folded


def _weight_kn(w, fmt):
    """(K, N) of a weight [K, N] int8 or packed int4 [K/2, N]."""
    if fmt == "int4":
        if w.dtype != torch.int8:
            raise TypeError("packed int4 weights must be int8-typed")
        return w.shape[0] * 2, w.shape[1]
    if fmt == "int8":
        return tuple(w.shape)
    raise ValueError(f"unknown weight format {fmt!r}")


def _matmul_options(w, fmt, prologue, ln_scale, ln_bias, epilogue, out_d,
                    act_d):
    k, n = _weight_kn(w, fmt)
    if prologue not in _PROLOGUES:
        raise ValueError(f"unknown prologue {prologue!r}")
    if epilogue not in _EPILOGUES:
        raise ValueError(f"unknown epilogue {epilogue!r}")
    if prologue == "ln_quant" and (ln_scale is None or ln_bias is None):
        raise ValueError("ln_quant prologue requires ln_scale/ln_bias")
    if epilogue in ("quant", "gelu_quant") and out_d is None:
        raise ValueError(f"{epilogue} epilogue requires out_d/out_t/out_top")
    if prologue == "gelu_quant" and act_d is None:
        raise ValueError("gelu_quant prologue requires act_d/act_top")
    return k, n


def _matmul_input(x, k, prologue, epilogue, residual):
    """Checks x [M, K] (and the residual) against the layer; returns M."""
    m, k_x = x.shape
    if k_x != k:
        raise ValueError(f"K mismatch: x {k_x} vs w {k}")
    if prologue is None and x.dtype != torch.int8:
        raise TypeError("prologue=None requires int8 level input")
    if epilogue == "residual" and residual is None:
        raise ValueError("residual epilogue requires residual array")
    return m


def fused_quant_matmul_plain(
    x, w, scale, bias=None, *, fmt="int4", prologue="quant",
    act_d=None, act_t=None, act_top=None, act_pow=False,
    ln_scale=None, ln_bias=None, ln_eps=1e-6,
    epilogue=None, residual=None,
    out_d=None, out_t=None, out_top=None, out_pow=False,
    out_dtype=torch.bfloat16, prefolded=False,
):
    """Plain PyTorch version of K1: a port of ``fused_quant_matmul_xla``
    (fused.py:1118-1179), the same f32 level math and folds
    (``prefolded``: the constants already carry them)."""
    _check_tops("fused_quant_matmul", prologue, epilogue, act_d, act_top,
                out_top)
    k, n = _matmul_options(w, fmt, prologue, ln_scale, ln_bias, epilogue,
                           out_d, act_d)
    _matmul_input(x, k, prologue, epilogue, residual)
    dev = x.device
    scale, bias, ln_scale, ln_bias, act_folded, out_folded = _matmul_folds(
        dev, n, scale, bias, prologue, act_d, act_pow, ln_scale, ln_bias,
        epilogue, out_d, out_pow, prefolded)
    if prologue is None:
        lv = x
    elif prologue == "gelu_quant":
        lv = _gelu_quant_folded(x.to(torch.float32), _f32(act_d, dev),
                                act_top)
    else:
        xx = x
        if prologue == "ln_quant":
            xx = _layernorm_f32(xx, ln_scale, ln_bias, ln_eps,
                                k_real=x.shape[-1])
        lv = _quantize_f32(xx, _f32(act_d, dev), _f32(act_t, dev), act_top,
                           act_pow, folded=act_folded)
    acc = int4_matmul_ref(lv, w) if fmt == "int4" else int8_matmul_ref(lv, w)
    out = acc.to(torch.float32) * scale
    if bias is not None:
        out = out + bias
    if epilogue == "residual":
        return (out + residual.to(torch.float32)).to(out_dtype)
    if epilogue == "gelu_quant" and out_folded:
        return _gelu_quant_folded(out, _f32(out_d, dev), out_top)
    if epilogue in ("quant", "gelu_quant"):
        if epilogue == "gelu_quant":
            out = _gelu_f32(out)
        return _quantize_f32(out, _f32(out_d, dev), _f32(out_t, dev),
                             out_top, out_pow, folded=out_folded)
    return out.to(out_dtype)


def _params4(device, a_d, a_t, b_d, b_t) -> torch.Tensor:
    """The kernels' four runtime quantizer scalars, one f32 device vector:
    [act_d, act_t, out_d, out_t] (a missing one is 1.0, never read)."""
    vals = [_f32(1.0 if v is None else v, device).reshape(())
            for v in (a_d, a_t, b_d, b_t)]
    return torch.stack(vals)


@dataclasses.dataclass(frozen=True)
class MatmulPlan:
    """One K1 call site, prepared once by :func:`plan_matmul`: the weight
    in the kernels' layout (:func:`~._build.n_major`; ``wk``: its depth
    there, K or, padded, K rounded up to 64), the constants folded, the
    quantizer scalars on the device, the static options."""

    w_t: torch.Tensor
    int4: bool
    k: int
    n: int
    wk: int
    scale: torch.Tensor
    bias: Optional[torch.Tensor]
    ln_scale: Optional[torch.Tensor]
    ln_bias: Optional[torch.Tensor]
    prm: torch.Tensor
    prologue: Optional[str]
    epilogue: Optional[str]
    act_pow: bool
    out_pow: bool
    act_top: int
    out_top: int
    ln_eps: float


def _weight_vec_ok(k: int, fmt: str) -> bool:
    """Whether a weight of depth ``k`` takes the kernels' 16-byte B path
    (``csrc/qvt_common.cuh:WeightT::vec_ok``)."""
    return k % 16 == 0 and (fmt != "int4" or (k // 2) % 16 == 0)


def padded_n_major(w, fmt: str, k: int, kp: int) -> torch.Tensor:
    """``w`` [K, N] (or packed int4 [K/2, N]) in the kernels' n-major
    layout at depth ``kp`` > K, zero levels past K. Packed int4 pairs k
    with k + depth/2, so the levels are unpacked, padded and packed again
    at ``kp``, not padded as bytes."""
    from ..quant.packing import pack_int4, unpack_int4

    lv = unpack_int4(w, axis=0) if fmt == "int4" else w
    lv = torch.cat([lv, lv.new_zeros((kp - k, lv.shape[1]))])
    return _build.n_major(pack_int4(lv, axis=0) if fmt == "int4" else lv)


def plan_matmul(w, scale, bias=None, *, fmt="int4", prologue="quant",
                act_d=None, act_t=None, act_top=None, act_pow=False,
                ln_scale=None, ln_bias=None, ln_eps=1e-6, epilogue=None,
                out_d=None, out_t=None, out_top=None,
                out_pow=False, w_t=None) -> MatmulPlan:
    """K1's layer-side work, done once: checks, the weight copy into the
    kernels' layout and the folds of fused.py:459-476. Arguments as
    :func:`fused_quant_matmul`; ``w`` must lie on a CUDA device. ``w_t``:
    ``w`` already in the kernels' layout (another plan's copy, shared
    instead of copied again; the kernel reads it byte by byte if its depth
    is off the 16-byte path). The plan's own copy of a weight whose depth
    is off that path (ViT-H/14's patch embed, K = 588) is made at K
    rounded up to 64 with zero levels (:func:`padded_n_major`), so the
    kernel loads it in 16-byte pieces; the result is the same."""
    _check_tops("fused_quant_matmul", prologue, epilogue, act_d, act_top,
                out_top)
    k, n = _matmul_options(w, fmt, prologue, ln_scale, ln_bias, epilogue,
                           out_d, act_d)
    _build.require_cuda("fused_quant_matmul", w)
    dev = w.device
    scale, bias, ln_scale, ln_bias, _, _ = _matmul_folds(
        dev, n, scale, bias, prologue, act_d, act_pow, ln_scale, ln_bias,
        epilogue, out_d, out_pow)
    wk = k
    if w_t is None and not _weight_vec_ok(k, fmt):
        wk = _round_up(k, 64)
        w_t = padded_n_major(w, fmt, k, wk)
    cont = lambda t: None if t is None else t.contiguous()  # noqa: E731
    return MatmulPlan(
        w_t=_build.n_major(w) if w_t is None else w_t,
        int4=fmt == "int4", k=k, n=n, wk=wk,
        scale=cont(scale), bias=cont(bias), ln_scale=cont(ln_scale),
        ln_bias=cont(ln_bias), prm=_params4(dev, act_d, act_t, out_d, out_t),
        prologue=prologue, epilogue=epilogue, act_pow=bool(act_pow),
        out_pow=bool(out_pow), act_top=int(act_top or 0),
        out_top=int(out_top or 0), ln_eps=float(ln_eps))


def run_matmul(plan: MatmulPlan, x, *, residual=None,
               out_dtype=torch.bfloat16, out=None):
    """Launches K1 on ``x`` [M, K] for a prepared layer at the work split
    :func:`matmul_layout` picks for the card (through
    :func:`_launch_matmul`, the one launch site). Int8 levels (prologue
    None) are read in place where the kernel can (K % 16 == 0, x 16-byte
    aligned), else copied by its first phase (:data:`COPY_PROLOGUE`).
    ``out``: a contiguous [M, N] tensor of the output's dtype to write
    into (the tensor-parallel forward's shared partials buffer)."""
    _build.require_cuda("fused_quant_matmul", x, residual, out)
    return _launch_matmul(plan, x, None, residual=residual,
                          out_dtype=out_dtype, out=out)


@functools.lru_cache(maxsize=None)
def _card_sms(index: int) -> int:
    """The SMs of CUDA device ``index`` (read once: a property read costs
    microseconds of host time a call)."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def _matmul_library():
    """K1's library, its entry point's C signature set on first use."""
    lib = _build.library("fused_quant_matmul")
    fn = lib.qvt_fused_quant_matmul
    if fn.argtypes is None:
        P, I, F = _build.P, _build.I, _build.F
        fn.argtypes = ([P, I, P, I, I] + [P] * 5 + [I] + [P] * 5
                       + [I] * 11 + [F] + [I] * 4 + [P])
        fn.restype = I
    return lib


# per (device, stream): K1's arrival counts of split tiles, zeroed once;
# each launch leaves them at zero (csrc/gemm_phases.cuh:split_reduce)
_SPLIT_COUNTS: dict = {}


def _split_counts(device, stream: int, n: int) -> torch.Tensor:
    key = (device.index, stream)
    counts = _SPLIT_COUNTS.get(key)
    if counts is None or counts.numel() < n:
        counts = torch.zeros((max(n, 4096),), dtype=torch.int32,
                             device=device)
        _SPLIT_COUNTS[key] = counts
    return counts


def _launch_matmul(plan: MatmulPlan, x, layout: Optional["MatmulLayout"],
                   *, residual=None, out_dtype=torch.bfloat16, out=None,
                   scratch=None):
    """K1 at ``layout`` (None: :func:`matmul_layout`'s for the card) on a
    CUDA ``x``: its scratch (one byte buffer holding the levels and, with
    a split, the int32 partial tiles: :meth:`MatmulLayout.scratch_bytes`,
    each part 16-byte aligned; ``scratch``: a uint8 buffer of at least
    that size to use instead, so a caller can read the levels phase 1
    wrote), the split tiles' arrival counts (:func:`_split_counts`) and
    the launch itself, counted under ``fused_quant_matmul``. ``out``: the
    output to write (else allocated). ``chip_smoke.py`` calls it at
    layouts other than the picker's."""
    m = _matmul_input(x, plan.k, plan.prologue, plan.epilogue, residual)
    n = plan.n
    x = x.contiguous()
    if plan.epilogue != "residual":
        residual = None
    elif residual.shape != (m, n):
        raise ValueError(f"residual {tuple(residual.shape)} vs ({m}, {n})")
    else:
        residual = residual.contiguous()
    out_int8 = plan.epilogue in ("quant", "gelu_quant")
    out_dt = torch.int8 if out_int8 else out_dtype
    if out is None:
        out = torch.empty((m, n), dtype=out_dt, device=x.device)
    elif (tuple(out.shape) != (m, n) or out.dtype != out_dt
          or not out.is_contiguous()):
        raise ValueError(f"out {tuple(out.shape)} {out.dtype} vs ({m}, {n}) "
                         f"{out_dt}, contiguous")
    if m == 0:
        return out
    if layout is None:
        prologue = plan.prologue
        if prologue is None and (plan.k % 16 or x.data_ptr() % 16):
            prologue = COPY_PROLOGUE
        layout = matmul_layout(m, plan.k, n, prologue, x.element_size(),
                               _card_sms(x.device.index))
    sizes = [_round_up(v, 16) for v in layout.scratch_bytes().values()]
    lv = part = cnt = None
    if sum(sizes):
        if scratch is None:
            scratch = torch.empty((sum(sizes),), dtype=torch.uint8,
                                  device=x.device)
        elif scratch.numel() < sum(sizes) or scratch.data_ptr() % 16:
            raise ValueError(f"scratch of {scratch.numel()} bytes < "
                             f"{sum(sizes)}, or off 16 bytes")
        lv = scratch.data_ptr() if sizes[0] else None
        part = scratch.data_ptr() + sizes[0] if sizes[1] else None
    stream = _build.stream()
    if layout.splits > 1:
        cnt = _split_counts(x.device, stream, layout.split_tiles).data_ptr()
    code = _matmul_library().qvt_fused_quant_matmul(
        x.data_ptr(), _build.dtype_code(x.dtype), plan.w_t.data_ptr(),
        int(plan.int4), plan.wk, plan.scale.data_ptr(),
        _build.ptr(plan.bias), _build.ptr(plan.ln_scale),
        _build.ptr(plan.ln_bias), _build.ptr(residual),
        _build.dtype_code(residual.dtype) if residual is not None else 0,
        plan.prm.data_ptr(), lv, part, cnt, out.data_ptr(),
        _build.dtype_code(out.dtype), m, plan.k, n, layout.kp,
        _PRO_CODES[layout.prologue], _EPILOGUES[plan.epilogue],
        int(plan.act_pow), int(plan.out_pow), plan.act_top, plan.out_top,
        plan.ln_eps, layout.ln_threads, layout.tile, layout.full,
        layout.splits, stream)
    _build.check(code, "fused_quant_matmul")
    _build.count_launch("fused_quant_matmul")
    return out


def fused_quant_matmul(
    x, w, scale, bias=None, *, fmt="int4", prologue="quant",
    act_d=None, act_t=None, act_top=None, act_pow=False,
    ln_scale=None, ln_bias=None, ln_eps=1e-6,
    epilogue=None, residual=None,
    out_d=None, out_t=None, out_top=None, out_pow=False,
    out_dtype=torch.bfloat16,
):
    """Fused quantized matmul (kernel K1).

    x: [M, K], float (prologue ``quant``/``ln_quant``/``gelu_quant``) or
    int8 levels (prologue None). w: [K//2, N] packed int4 (``fmt='int4'``)
    or [K, N] int8. scale: scalar or [N] dequant scale; bias: [N] or None.
    epilogue: None (``out_dtype``) | ``residual`` (+residual [M, N]) |
    ``quant`` | ``gelu_quant`` (int8 levels of the next layer's quantizer
    ``out_*``). CPU tensors take :func:`fused_quant_matmul_plain`; CUDA
    tensors :func:`plan_matmul` then :func:`run_matmul` (a caller that
    calls one layer repeatedly keeps the plan).
    """
    layer = dict(fmt=fmt, prologue=prologue, act_d=act_d, act_t=act_t,
                 act_top=act_top, act_pow=act_pow, ln_scale=ln_scale,
                 ln_bias=ln_bias, ln_eps=ln_eps, epilogue=epilogue,
                 out_d=out_d, out_t=out_t, out_top=out_top, out_pow=out_pow)
    if x.device.type == "cpu":
        return fused_quant_matmul_plain(x, w, scale, bias, residual=residual,
                                        out_dtype=out_dtype, **layer)
    return run_matmul(plan_matmul(w, scale, bias, **layer), x,
                      residual=residual, out_dtype=out_dtype)


# ---------------------------------------------------------------------------
# K1's LayerNorm + quant prologue alone: the levels of a process's rows in
# tensor-parallel serving, quantized before they are all-gathered
# ---------------------------------------------------------------------------


def ln_quant_levels_plain(x, ln_scale, ln_bias, *, act_d, act_t, act_top,
                          act_pow=False, ln_eps=1e-6):
    """Plain version of :func:`ln_quant_levels`: LayerNorm then the LSFQ
    quantizer in f32, 1/d folded into gamma/beta when the quantizer is
    linear (``serve/vit_tp.py:_ln_quant`` of the JAX package, lines
    201-218), the same ops as :func:`fused_quant_matmul_plain`'s
    ``ln_quant`` prologue."""
    _check_tops("ln_quant_levels", "ln_quant", None, act_d, act_top, None)
    dev = x.device
    gamma, beta = fold_ln(ln_scale, ln_bias, act_d, act_pow, dev)
    y = _layernorm_f32(x, gamma, beta, ln_eps, k_real=x.shape[-1])
    return _quantize_f32(y, _f32(act_d, dev), _f32(act_t, dev), act_top,
                         act_pow, folded=not act_pow)


@dataclasses.dataclass(frozen=True)
class LevelsPlan:
    """One :func:`ln_quant_levels` call site, prepared once by
    :func:`plan_ln_levels`: gamma/beta folded, the quantizer's scalars on
    the device, the static options."""

    ln_scale: torch.Tensor
    ln_bias: torch.Tensor
    prm: torch.Tensor
    k: int
    act_pow: bool
    act_top: int
    ln_eps: float


def plan_ln_levels(ln_scale, ln_bias, *, act_d, act_t, act_top,
                   act_pow=False, ln_eps=1e-6, device) -> LevelsPlan:
    """The levels launch's layer-side work, done once: the fold of
    :func:`fold_ln` (as :func:`plan_matmul` makes it for its ``ln_quant``
    prologue) and the scalars on the CUDA ``device``."""
    _check_tops("ln_quant_levels", "ln_quant", None, act_d, act_top, None)
    dev = torch.device(device)
    if dev.type != "cuda":
        raise ValueError(f"ln_quant_levels: the CUDA kernel needs a CUDA "
                         f"device, got {dev}")
    gamma, beta = fold_ln(ln_scale, ln_bias, act_d, act_pow, dev)
    gamma, beta = gamma.contiguous(), beta.contiguous()
    return LevelsPlan(ln_scale=gamma, ln_bias=beta,
                      prm=_params4(dev, act_d, act_t, None, None),
                      k=gamma.shape[-1], act_pow=bool(act_pow),
                      act_top=int(act_top), ln_eps=float(ln_eps))


def run_ln_levels(plan: LevelsPlan, x, *, out=None):
    """Launches the levels-only K1 entry (``csrc/fused_quant_matmul.cu:
    qvt_ln_quant_levels``: its phase 1 under the ``ln_quant`` prologue,
    alone) on ``x`` [M, K] (bf16 or f32), a row to :func:`_row_group`'s
    threads as K1's phase 1 takes it, into ``out`` [M, K] int8 (allocated
    when None); the only place that launches it, counted under
    ``ln_quant_levels``."""
    _build.require_cuda("ln_quant_levels", x, out)
    m, k = x.shape
    if k != plan.k:
        raise ValueError(f"K mismatch: x {k} vs LayerNorm {plan.k}")
    x = x.contiguous()
    if out is None:
        out = torch.empty((m, k), dtype=torch.int8, device=x.device)
    elif (tuple(out.shape) != (m, k) or out.dtype != torch.int8
          or not out.is_contiguous() or out.data_ptr() % 16):
        raise ValueError(f"levels out {tuple(out.shape)} {out.dtype}: "
                         f"({m}, {k}) int8, contiguous, 16-byte aligned")
    if m == 0:
        return out
    lib = _build.library("fused_quant_matmul")
    fn = lib.qvt_ln_quant_levels
    if fn.argtypes is None:
        P, I, F = _build.P, _build.I, _build.F
        fn.argtypes = [P, I, P, P, P, P, I, I, I, I, F, I, P]
        fn.restype = I
    code = fn(x.data_ptr(), _build.dtype_code(x.dtype),
              plan.ln_scale.data_ptr(), plan.ln_bias.data_ptr(),
              plan.prm.data_ptr(), out.data_ptr(), m, k, int(plan.act_pow),
              plan.act_top, plan.ln_eps,
              _row_group(m, k * x.element_size(), _card_sms(x.device.index)),
              _build.stream())
    _build.check(code, "ln_quant_levels")
    _build.count_launch("ln_quant_levels")
    return out


def ln_quant_levels(x, ln_scale, ln_bias, *, act_d, act_t, act_top,
                    act_pow=False, ln_eps=1e-6):
    """LayerNorm + quantize to int8 levels [M, K] of x [M, K]: K1's
    ``ln_quant`` prologue alone, so that the levels can be all-gathered
    before the column-parallel matmul (``serve/vit_tp.py``). CPU tensors
    take :func:`ln_quant_levels_plain`; CUDA tensors
    :func:`plan_ln_levels` then :func:`run_ln_levels`."""
    layer = dict(act_d=act_d, act_t=act_t, act_top=act_top,
                 act_pow=act_pow, ln_eps=ln_eps)
    if x.device.type == "cpu":
        return ln_quant_levels_plain(x, ln_scale, ln_bias, **layer)
    return run_ln_levels(plan_ln_levels(ln_scale, ln_bias, device=x.device,
                                        **layer), x)


# ---------------------------------------------------------------------------
# whole-MLP block: LN -> quant -> fc1 -> GELU -> quant -> fc2 -> +x
# ---------------------------------------------------------------------------


def mlp_chunked_kernel_limit(k: int, fmt: str = "int8",
                             fmt2: Optional[str] = None) -> Optional[str]:
    """Why K8 cannot take an MLP of width ``k`` with these weight formats,
    or None if it can: int8 weights only, as the JAX function (no width
    enters its registers or shared memory)."""
    if fmt != "int8" or (fmt2 or fmt) != "int8":
        return ("fused_mlp_chunked kernel: int8 weights only (packed int4 "
                "pairs hidden rows h and h + H/2 in one byte, fused.py:"
                "930-932)")
    return None


# The JAX package's MLP gate, shape arithmetic only (fused.py:330-343,
# :779-813, :916-929): which of its kernels, resident or hidden-chunked, a
# shape takes. The TPU's M tiles and VMEM budget decide the route; the
# CUDA kernels tile in their own way.
_BLOCK_M_CANDIDATES = (896, 832, 576, 448, 416, 288, 224, 128, 64, 32)
# a resident M tile under this streams the weights instead
BIG_WEIGHT_BM = 224


def _round_up(a: int, b: int) -> int:
    return -(-a // b) * b


def _pick_bm(cap: int, fits) -> int:
    """Largest fitting M tile, preferring tiles that divide ``cap``
    (fused.py:_pick_bm)."""
    for c in _BLOCK_M_CANDIDATES:
        if c <= cap and cap % c == 0 and fits(c):
            return c
    return next((c for c in _BLOCK_M_CANDIDATES if c <= cap and fits(c)),
                32)


def _mlp_auto_stripes(hid: int) -> int:
    """Hidden stripes of the resident TPU kernel (fused.py:779-783)."""
    return (8 if hid % (8 * 128) == 0 else
            4 if hid % (4 * 128) == 0 else (2 if hid % 256 == 0 else 1))


def _mlp_resident_fits(k: int, hid: int, fmt: str, x_itemsize: int,
                       out_itemsize: int, n_stripes: int):
    """The resident TPU kernel's VMEM fit predicate (fused.py:786-799)."""
    w_bytes = (k * hid + hid * k) * (1.5 if fmt == "int4" else 1)
    budget = 14 * 2**20

    def fits(bm):
        stream = 2 * (bm * k * x_itemsize + bm * k * out_itemsize)
        stack = bm * k * 4 * 2 + bm * (hid // n_stripes) * 4 * 2
        return stream + stack + w_bytes <= budget

    return fits


def fused_mlp_resident_bm(k: int, hid: int, fmt: str = "int8",
                          x_itemsize: int = 2, out_itemsize: int = 2) -> int:
    """The M tile the resident TPU kernel would pick at these widths,
    unconstrained by M (fused.py:802-813); under :data:`BIG_WEIGHT_BM` the
    MLP counts as big-weight (serve/vit_int4.py:338-343)."""
    fits = _mlp_resident_fits(k, hid, fmt, x_itemsize, out_itemsize,
                              _mlp_auto_stripes(hid))
    return next((c for c in _BLOCK_M_CANDIDATES if fits(c)), 32)


def mlp_auto_hid_block(m: int, k: int, hid: int, fmt: str = "int8",
                       x_itemsize: int = 2,
                       out_itemsize: int = 2) -> Optional[int]:
    """The hidden chunk with which ``_fused_mlp`` streams the weights when
    the caller pins neither ``block_m`` nor ``hid_block`` (fused.py:
    916-929): int8 weights whose resident M tile at ``m`` rows falls under
    :data:`BIG_WEIGHT_BM`. None: the resident kernel."""
    if fmt != "int8":
        return None
    fits = _mlp_resident_fits(k, hid, fmt, x_itemsize, out_itemsize,
                              _mlp_auto_stripes(hid))
    if _pick_bm(_round_up(m, 32), fits) >= BIG_WEIGHT_BM:
        return None
    for n_h in (4, 8, 2):
        hb = hid // n_h
        if hid % n_h == 0 and hb % 256 == 0:
            return hb
    return None


# csrc/fused_mlp.cu (K2) and csrc/fused_quant_matmul.cu (K1): their GEMM
# tiles (rows = columns), large then small, their k step, their threads a
# block, the threads a prologue row may take, and the blocks of their grid
# an SM (they launch at most two)
MLP_TILES = (128, 64)
MLP_BK = 128
MLP_THREADS = 256
MLP_LN_GROUPS = (8, 16, 32, 64, 128, 256)
MLP_BLOCKS_PER_SM = 2
_H100_SMS = 132


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@dataclasses.dataclass(frozen=True)
class MlpLayout:
    """K2's work split for M rows at widths K and H (:func:`mlp_layout`):
    threads a LayerNorm row, fc1's and fc2's output tiles (``tile1``,
    ``tile2`` rows and columns), fc2's tiles taken whole (``full2``, the
    first ones) and the splits of the hidden depth of each other fc2
    tile. Its methods enumerate each phase's work items in the kernel's
    order (``csrc/fused_mlp.cu``) and size its scratch."""

    m: int
    k: int
    hid: int
    ln_threads: int
    tile1: int
    tile2: int
    full2: int
    splits: int

    @property
    def kp(self) -> int:
        """The level scratch's row: K rounded up to 64."""
        return _round_up(self.k, 64)

    @property
    def hp(self) -> int:
        """The hidden scratch's row: H rounded up to 64."""
        return _round_up(self.hid, 64)

    @property
    def ln_items(self) -> int:
        """Phase 1's work items: groups of ``MLP_THREADS / ln_threads``
        rows, one a block at a time."""
        return _cdiv(self.m, MLP_THREADS // self.ln_threads)

    @property
    def fc2_tiles(self) -> int:
        return _cdiv(self.m, self.tile2) * _cdiv(self.k, self.tile2)

    @property
    def split_tiles(self) -> int:
        """fc2's tiles taken in ``splits`` pieces (none when 1)."""
        return 0 if self.splits == 1 else self.fc2_tiles - self.full2

    def fc1_tiles(self):
        """Phase 2's items: (row0, col0) of each tile1 x tile1 tile of the
        [M, H] hidden levels."""
        tn = _cdiv(self.hid, self.tile1)
        return [(t // tn * self.tile1, t % tn * self.tile1)
                for t in range(_cdiv(self.m, self.tile1) * tn)]

    def fc2_items(self):
        """Phase 3's items: (row0, col0, first, end) of each tile2 x tile2
        output tile taken whole, then of each split of the others, over
        the 128-deep steps [first, end) of the hidden depth."""
        t2, s = self.tile2, self.splits
        tn, nkt = _cdiv(self.k, t2), _cdiv(self.hp, MLP_BK)
        whole = [(t, 0, nkt) for t in range(self.full2)]
        split = [(t, p * nkt // s, (p + 1) * nkt // s)
                 for t in range(self.full2, self.fc2_tiles)
                 for p in range(s)]
        return [(t // tn * t2, t % tn * t2, first, end)
                for t, first, end in whole + split]

    def scratch_bytes(self):
        """Bytes of each scratch: the levels [M, Kp] int8, the hidden
        levels [M, Hp] int8, fc2's int32 partial tiles (one a split) and
        its arrival counts (one a split tile)."""
        n = self.split_tiles
        return {"levels": self.m * self.kp, "hidden": self.m * self.hp,
                "partials": 4 * n * self.splits * self.tile2**2,
                "counts": 4 * n}


@functools.lru_cache(maxsize=None)
def mlp_layout(m: int, k: int, hid: int, itemsize: int = 2,
               sms: int = _H100_SMS) -> MlpLayout:
    """K2's work split at ``m`` rows of widths ``k`` (model) and ``hid``
    (hidden), x of ``itemsize`` bytes, on a card of ``sms`` SMs, whose
    grid holds ``MLP_BLOCKS_PER_SM * sms`` blocks:

    - LayerNorm: the fewest threads a row, at most 12 16-byte pieces
      each (8, 16 or 32, K3's rule), whose row groups still give every SM
      one; else a block a row.
    - fc2: the 128 x 128 tile where its tiles fill the grid once, else
      64 x 64.
    - fc1: the 128 x 128 tile where its tiles give every SM one or fc2
      takes it (the kernel builds no small-fc1, large-fc2 pair), else 64
      x 64.
    - fc2 again: whole waves of tiles run whole; the tiles left over split
      their hidden depth into as many pieces as fill one more wave (at
      most its 128-deep steps), so no block runs a second whole tile
      while others idle.

    At ViT-B/16 batch 32 (6656 rows): 8 threads a row, both GEMMs in 128 x
    128 tiles, 264 of fc2's 312 tiles whole and 48 split 5 ways; at batch
    1 and 2 (208, 416 rows) 64 x 64 tiles, each fc2 tile split 5 and 3
    ways; at ViT-H/14 batch 1 and 2 (272, 544 rows) 2 ways and none."""
    slots = MLP_BLOCKS_PER_SM * sms

    def tiles(t, n):
        return _cdiv(m, t) * _cdiv(n, t)

    big, small = MLP_TILES
    t2 = big if tiles(big, k) >= slots else small
    t1 = big if t2 == big or tiles(big, hid) >= sms else small
    full, splits = _split_rest(tiles(t2, k),
                               _cdiv(_round_up(hid, 64), MLP_BK), slots)
    return MlpLayout(m, k, hid, _row_group(m, k * itemsize, sms), t1, t2,
                     full, splits)


def mlp_grid(layout: MlpLayout, sms: int = _H100_SMS) -> int:
    """The blocks of K2's launch at ``layout`` on a card of ``sms`` SMs:
    enough for its largest phase (row groups, fc1 tiles, fc2 items), at
    most ``MLP_BLOCKS_PER_SM`` an SM (``csrc/fused_mlp.cu:launch``)."""
    t1 = layout.tile1
    fc1 = _cdiv(layout.m, t1) * _cdiv(layout.hid, t1)
    fc2 = layout.full2 + layout.split_tiles * layout.splits \
        if layout.splits > 1 else layout.fc2_tiles
    return min(MLP_BLOCKS_PER_SM * sms, max(layout.ln_items, fc1, fc2))


# csrc/fused_mlp_chunked.cu (K8): the weight rows of an item (the wgmma
# M), the depth of a ring stage in bytes, the threads a block (two
# consumer warpgroups and the producer warp), the threads a LayerNorm row
# may take, the wgmma N it instantiates, its ring's stages at most, and
# the shared memory a block may take and what the ring leaves of it (the
# 1024-byte alignment, the barriers, static memory)
CHUNKED_ROWS = 64
# the weight rows of an fc1 item and of an fc2 item
CHUNKED_WR = (2 * CHUNKED_ROWS, CHUNKED_ROWS)
CHUNKED_BK = 128
CHUNKED_THREADS = 288
CHUNKED_LN_GROUPS = (8, 16, 32)
CHUNKED_NW = (32, 64, 128, 256)
CHUNKED_MAX_STAGES = 16
CHUNKED_SMEM = 232448
CHUNKED_SMEM_SLACK = 2048
@dataclasses.dataclass(frozen=True)
class ChunkedLayout:
    """K8's work split for M rows at widths K and H (:func:`chunked_layout`):
    threads a LayerNorm row; for each GEMM phase (fc1: suffix 1, fc2: 2)
    the token rows of a chunk (``nc``), the wgmma N it runs at (``nw`` >=
    ``nc``) and the token groups (``g``); the ring's stages. An fc1 item
    is 128 units, the two consumer warpgroups sharing one token chunk; an
    fc2 item 64 columns, the warpgroups sharing the weight tile, each its
    own chunk (:data:`CHUNKED_WR`). Its methods enumerate each phase's
    items in the kernel's order (``csrc/fused_mlp_chunked.cu``) and size
    its scratch and shared memory."""

    m: int
    k: int
    hid: int
    ln_threads: int
    nc1: int
    nw1: int
    g1: int
    nc2: int
    nw2: int
    g2: int
    stages: int

    @property
    def kp(self) -> int:
        """The level scratch's row: K rounded up to 128."""
        return _round_up(self.k, CHUNKED_BK)

    @property
    def hp(self) -> int:
        """The hidden scratch's row: H rounded up to 128."""
        return _round_up(self.hid, CHUNKED_BK)

    @property
    def m8(self) -> int:
        """The scratches' rows: M rounded up to 8."""
        return _round_up(self.m, 8)

    @property
    def ln_items(self) -> int:
        """Phase 1's work items: groups of ``256 / ln_threads`` rows (the
        consumer threads), one a block at a time."""
        return _cdiv(self.m, 256 // self.ln_threads)

    def phase(self, phase: int):
        """(weight rows, depth, weight rows an item, nc, nw, g) of GEMM
        phase ``phase``."""
        wr = CHUNKED_WR[phase - 1]
        if phase == 1:
            return self.hid, self.k, wr, self.nc1, self.nw1, self.g1
        return self.k, self.hid, wr, self.nc2, self.nw2, self.g2

    @property
    def stage_bytes(self) -> int:
        """A ring stage: the larger phase's weight rows and token rows
        (two chunks of N rows where the weight tile is shared), 128 bytes
        each."""
        return max(_chunked_stage(CHUNKED_WR[0], self.nw1),
                   _chunked_stage(CHUNKED_WR[1], self.nw2))

    @property
    def smem_bytes(self) -> int:
        """The launch's dynamic shared memory: the 1024-byte alignment,
        the ring, a full and an empty barrier a stage."""
        return (1024 + self.stages * self.stage_bytes
                + 16 * CHUNKED_MAX_STAGES)

    def items(self, phase: int):
        """Phase ``phase``'s (1: fc1, 2: fc2) items in the kernel's order,
        each the (first weight row, first token, tokens) of the two
        consumer warpgroups' tiles; tokens <= 0: no work."""
        rows, _, wr, nc, _, g = self.phase(phase)
        out = []
        for it in range(_cdiv(rows, wr) * g):
            rt, q = divmod(it, g)
            tiles = []
            for w in (0, 1):
                if wr == CHUNKED_ROWS:
                    r0, t0 = rt * CHUNKED_ROWS, (2 * q + w) * nc
                else:
                    r0, t0 = rt * wr + w * CHUNKED_ROWS, q * nc
                tiles.append((r0, t0, min(nc, self.m - t0) if r0 < rows
                              else 0))
            out.append(tiles)
        return out

    def l2_bytes(self, phase: int) -> int:
        """The bytes phase ``phase``'s items load into shared memory (from
        L2): each item's weight tiles and token tiles over the depth, once
        each where the two warpgroups share one."""
        _, depth, wr, nc, _, _ = self.phase(phase)
        steps, total = _cdiv(depth, CHUNKED_BK), 0
        for tiles in self.items(phase):
            live = sum(t[2] > 0 for t in tiles)
            n_w = 1 if wr == CHUNKED_ROWS else live
            n_t = live if wr == CHUNKED_ROWS else 1
            total += steps * CHUNKED_BK * (n_w * CHUNKED_ROWS + n_t * nc)
        return total

    def scratch_bytes(self):
        """Bytes of each scratch: the levels [M8, Kp] and the hidden levels
        [M8, Hp], int8."""
        return {"levels": self.m8 * self.kp, "hidden": self.m8 * self.hp}


def _chunked_stage(wr: int, nw: int) -> int:
    """A phase's ring stage: ``wr`` weight rows and its token rows (two
    chunks of ``nw`` rows where the weight tile is shared), 128 bytes
    each."""
    return (wr + (2 if wr == CHUNKED_ROWS else 1) * nw) * CHUNKED_BK


def _chunked_split(m: int, rows: int, wr: int, sms: int):
    """(nc, nw, g) of a K8 GEMM phase of ``rows`` weight rows at ``m``
    token rows on ``sms`` SMs, its items ``wr`` weight rows (64: two token
    chunks an item; 128: one): the most token groups whose items still
    take one wave of the grid (at least the groups that keep a chunk
    within 256 rows, at most those that keep it 8 rows or more; none
    without tokens once the chunk is rounded up to 8 rows)."""
    chunks = 2 if wr == CHUNKED_ROWS else 1
    g_min = _cdiv(m, chunks * CHUNKED_NW[-1])
    g = max(g_min, min(sms // _cdiv(rows, wr), _cdiv(m, 8 * chunks)))
    nc = _round_up(_cdiv(m, chunks * g), 8)
    return nc, next(v for v in CHUNKED_NW if v >= nc), _cdiv(m, chunks * nc)


@functools.lru_cache(maxsize=None)
def chunked_layout(m: int, k: int, hid: int, itemsize: int = 2,
                   sms: int = _H100_SMS) -> ChunkedLayout:
    """K8's work split at ``m`` rows of widths ``k`` (model) and ``hid``
    (hidden), x of ``itemsize`` bytes, on a card of ``sms`` SMs:

    - LayerNorm: K2's row group (:func:`_row_group`) at most 32 threads
      (the producer warp takes no part, so no block barrier is possible);
    - each GEMM phase: :func:`_chunked_split`, one wave of items (fc1's
      of 128 units sharing a token chunk, fc2's of 64 columns sharing the
      weight tile: the neighbours of these picks on an H100,
      ``tools/chunked_design.py``, are in PERF.md);
    - the ring: as many stages as fit the shared memory (3 to 16).

    At ViT-H/14 batch 1 (272 rows) fc1 runs 120 items of 128 units x 96
    rows (N 128) and fc2 120 items of 64 columns x 2 chunks of 24 rows (N
    32); at batch 2 (544 rows) 120 items of 128 units x 184 rows (N 256)
    and 120 of 64 columns x 2 x 48 (N 64)."""
    ln = min(CHUNKED_LN_GROUPS[-1], _row_group(m, k * itemsize, sms))
    p1 = _chunked_split(m, hid, CHUNKED_WR[0], sms)
    p2 = _chunked_split(m, k, CHUNKED_WR[1], sms)
    stage = max(_chunked_stage(CHUNKED_WR[0], p1[1]),
                _chunked_stage(CHUNKED_WR[1], p2[1]))
    return ChunkedLayout(m, k, hid, ln, *p1, *p2, chunked_stages(stage))


def chunked_stages(stage_bytes: int) -> int:
    """K8's ring stages of ``stage_bytes`` each: as many as fit the shared
    memory, at most :data:`CHUNKED_MAX_STAGES`."""
    return min(CHUNKED_MAX_STAGES,
               (CHUNKED_SMEM - CHUNKED_SMEM_SLACK - 16 * CHUNKED_MAX_STAGES)
               // stage_bytes)


def chunked_grid(layout: ChunkedLayout, sms: int = _H100_SMS) -> int:
    """The blocks of K8's launch at ``layout`` on a card of ``sms`` SMs:
    enough for its largest phase, one an SM
    (``csrc/fused_mlp_chunked.cu:qvt_mlp_chunked_prepare``)."""
    return min(sms, max(layout.ln_items, len(layout.items(1)),
                        len(layout.items(2))))


# K15's gather (csrc/copy_jobs.cuh): a chunk is a multiple of
# GATHER_CHUNK_ALIGN bytes (16 bytes a thread of a 256-thread block, and
# every chunk keeps its job's 16-byte alignment), at most
# GATHER_CHUNK_MAX
GATHER_CHUNK_ALIGN = 4096
GATHER_CHUNK_MAX = 65536


@dataclasses.dataclass(frozen=True)
class GatherSplit:
    """K15's copy jobs cut into chunks (:func:`gather_split`): ``chunk``
    bytes a chunk (a job's last one shorter), ``chunks`` in all."""

    chunk: int
    chunks: int


def gather_split(job_bytes: Sequence[int], grid: int) -> GatherSplit:
    """K15's chunks for copy jobs of ``job_bytes`` bytes each inside a
    launch of ``grid`` blocks (:func:`mlp_grid`): about one chunk a block
    (the bytes over the grid, rounded up to ``GATHER_CHUNK_ALIGN``), so
    that the copy in phase 1 spreads its bytes over every block, and at
    most ``GATHER_CHUNK_MAX``. At ViT-B/16's four int8 block weights
    (7.08 MB) on batch 32's 264 blocks: 28 KB chunks, 249 of them; at
    ViT-H/14's (19.7 MB): 64 KB, 300."""
    chunk = _round_up(_cdiv(max(1, sum(job_bytes)), max(1, grid)),
                      GATHER_CHUNK_ALIGN)
    chunk = max(GATHER_CHUNK_ALIGN, min(GATHER_CHUNK_MAX, chunk))
    return GatherSplit(chunk, sum(_cdiv(n, chunk) for n in job_bytes))


def _row_group(m: int, row_bytes: int, sms: int) -> int:
    """The threads a prologue row takes (K2's and K1's first phase): the
    fewest, at most 12 16-byte pieces each (8, 16 or 32, K3's rule),
    whose row groups still give every SM one; else a block a row."""
    pieces = _cdiv(row_bytes, 16)
    least = 8 if pieces <= 96 else 16 if pieces <= 192 else 32
    return next((t for t in MLP_LN_GROUPS if t >= least
                 and _cdiv(m, MLP_THREADS // t) >= sms), MLP_LN_GROUPS[-1])


def _split_rest(tiles: int, steps: int, slots: int):
    """(tiles taken whole, splits of each other tile) of a GEMM phase of
    ``tiles`` output tiles of ``steps`` 128-deep steps on a grid of
    ``slots`` blocks: whole waves of tiles run whole; the tiles left over
    split their depth into as many pieces as fill one more wave (at most
    their steps), so no block runs a second whole tile while others
    idle."""
    rest = tiles % slots
    splits = max(1, min(steps, slots // rest)) if rest else 1
    return (tiles - rest if splits > 1 else tiles), splits


@dataclasses.dataclass(frozen=True)
class MatmulLayout:
    """K1's work split for M rows of x [M, K] against a weight [K, N]
    (:func:`matmul_layout`): the prologue its first phase runs (None: x's
    levels are read in place, no first phase), the threads a prologue
    row, the output tile (``tile`` rows and columns), the tiles taken
    whole (``full``, the first ones) and the splits of the depth of each
    other tile. Its methods enumerate the work items in the kernel's
    order (``csrc/fused_quant_matmul.cu``) and size its scratch."""

    m: int
    k: int
    n: int
    prologue: Optional[str]
    ln_threads: int
    tile: int
    full: int
    splits: int

    @property
    def kp(self) -> int:
        """The level scratch's row: K rounded up to 64."""
        return _round_up(self.k, 64)

    @property
    def steps(self) -> int:
        """The GEMM's 128-deep steps: over the scratch's Kp columns, or
        over K when x is read in place."""
        return _cdiv(self.k if self.prologue is None else self.kp, MLP_BK)

    @property
    def row_items(self) -> int:
        """The first phase's work items: groups of ``MLP_THREADS /
        ln_threads`` rows, one a block at a time (none without it)."""
        if self.prologue is None:
            return 0
        return _cdiv(self.m, MLP_THREADS // self.ln_threads)

    @property
    def tiles(self) -> int:
        return _cdiv(self.m, self.tile) * _cdiv(self.n, self.tile)

    @property
    def split_tiles(self) -> int:
        """Tiles taken in ``splits`` pieces (none when 1)."""
        return 0 if self.splits == 1 else self.tiles - self.full

    def items(self):
        """The GEMM's items: (row0, col0, first, end) of each output tile
        taken whole, then of each split of the others, over the 128-deep
        steps [first, end) of the depth."""
        t, s, nkt = self.tile, self.splits, self.steps
        tn = _cdiv(self.n, t)
        whole = [(i, 0, nkt) for i in range(self.full if s > 1
                                            else self.tiles)]
        split = [(i, p * nkt // s, (p + 1) * nkt // s)
                 for i in range(self.full, self.tiles) for p in range(s)
                 if s > 1]
        return [(i // tn * t, i % tn * t, first, end)
                for i, first, end in whole + split]

    def scratch_bytes(self):
        """Bytes of each scratch: the levels [M, Kp] int8 (none when x is
        read in place) and the int32 partial tiles, one a split."""
        return {"levels": 0 if self.prologue is None else self.m * self.kp,
                "partials": 4 * self.split_tiles * self.splits
                * self.tile**2}


# K1's cost of splitting a tile's depth beyond the steps its splits take,
# in 128-deep steps: each split writes its int32 partial tile, and the
# last one to arrive reads the others' (tools/matmul_design.py, PERF.md)
MATMUL_SPLIT_STEPS = 6


@functools.lru_cache(maxsize=None)
def matmul_layout(m: int, k: int, n: int, prologue: Optional[str] = None,
                  itemsize: int = 2, sms: int = _H100_SMS) -> MatmulLayout:
    """K1's work split at ``m`` rows of x [m, k] (``itemsize`` bytes an
    element) against a weight [k, n], under ``prologue`` (None: x's int8
    levels read in place; :data:`COPY_PROLOGUE`: copied), on a card of
    ``sms`` SMs, whose grid holds ``MLP_BLOCKS_PER_SM * sms`` blocks:

    - the prologue's threads a row: K2's rule (:func:`_row_group`);
    - the 128 x 128 tile where its tiles fill the grid once, else 64 x 64;
    - the tiles left over after whole waves split their depth as K2's fc2
      does (:func:`_split_rest`) only where that shortens the longest
      block's work, in 128-deep steps, by more than a split costs
      (:data:`MATMUL_SPLIT_STEPS`); else every tile runs whole.

    At the 768-deep ViT-B sites a split never pays: 48 whole 64 x 64
    tiles of the batch-1 chain proj (208 x 768 x 768) beat 240 items that
    give every SM one. At ViT-H's 1280-deep chain qkv at batch 1 (272 x
    1280 x 3840) 264 of its 300 tiles run whole and 36 split 7 ways; fc1
    at batch 32 (8704 x 1280 x 5120) runs its 2720 128 x 128 tiles
    whole."""
    slots = MLP_BLOCKS_PER_SM * sms

    def tiles(t):
        return _cdiv(m, t) * _cdiv(n, t)

    big, small = MLP_TILES
    tile = big if tiles(big) >= slots else small
    steps = _cdiv(k if prologue is None else _round_up(k, 64), MLP_BK)
    n_t = tiles(tile)
    full, splits = _split_rest(n_t, steps, slots)
    whole = _cdiv(n_t, slots) * steps
    if (n_t // slots * steps + _cdiv(steps, splits) + MATMUL_SPLIT_STEPS
            >= whole):
        full, splits = n_t, 1
    return MatmulLayout(m, k, n, prologue, _row_group(m, k * itemsize, sms),
                        tile, full, splits)


def _mlp_shapes(w1, w2, fmt, fmt2, act_top, hid_top):
    """(K, hidden) of the MLP's weights, checked against each other."""
    for name, v in (("act_top", act_top), ("hid_top", hid_top)):
        if not (v or 0) >= 1:
            raise ValueError(f"fused_mlp: positive {name} required, got "
                             f"{v!r}")
    k, hid = _weight_kn(w1, fmt)
    h2, n2 = _weight_kn(w2, fmt2)
    if h2 != hid or n2 != k:
        raise ValueError(f"MLP shape mismatch: w1[{k},{hid}] w2[{h2},{n2}]")
    return k, hid


def _mlp_input(x, k):
    m, k_x = x.shape
    if k_x != k:
        raise ValueError(f"MLP shape mismatch: x[{m},{k_x}] vs K={k}")
    return m


def fused_mlp_plain(x, w1, scale1, bias1, w2, scale2, bias2, *,
                    ln_scale, ln_bias, ln_eps=1e-6,
                    act_d=None, act_t=None, act_top=None, act_pow=False,
                    hid_d=None, hid_t=None, hid_top=None, hid_pow=False,
                    fmt="int8", fmt2=None, out_dtype=torch.bfloat16,
                    prefolded=False):
    """Plain PyTorch version of K2: a port of ``fused_mlp_xla``
    (fused.py:1095-1110), fc1 with the GELU+quant epilogue then fc2 with
    the residual epilogue. ``fmt2``: w2's format (default ``fmt``).
    ``prefolded``: LN2 and fc1's scale/bias carry the folds of
    :func:`fold_ln` and :func:`fold_gelu` already."""
    fmt2 = fmt2 or fmt
    _mlp_input(x, _mlp_shapes(w1, w2, fmt, fmt2, act_top, hid_top)[0])
    hlv = fused_quant_matmul_plain(
        x, w1, scale1, bias1, fmt=fmt, prologue="ln_quant",
        act_d=act_d, act_t=act_t, act_top=act_top, act_pow=act_pow,
        ln_scale=ln_scale, ln_bias=ln_bias, ln_eps=ln_eps,
        epilogue="gelu_quant", out_d=hid_d, out_t=hid_t, out_top=hid_top,
        out_pow=hid_pow, prefolded=prefolded)
    return fused_quant_matmul_plain(
        hlv, w2, scale2, bias2, fmt=fmt2, prologue=None,
        epilogue="residual", residual=x, out_dtype=out_dtype)


@dataclasses.dataclass(frozen=True)
class MlpPlan:
    """One K2 or K8 call site, prepared once by :func:`plan_mlp` or
    :func:`plan_mlp_chunked` (as :class:`MatmulPlan`). ``launches``: K8's
    host state of each layout it has launched at (its weights' tensor maps,
    the grid), made once (:func:`_launch_mlp_chunked`)."""

    w1_t: torch.Tensor
    w2_t: torch.Tensor
    int4_1: bool
    int4_2: bool
    k: int
    hid: int
    scale1: torch.Tensor
    bias1: torch.Tensor
    scale2: torch.Tensor
    bias2: torch.Tensor
    ln_scale: torch.Tensor
    ln_bias: torch.Tensor
    prm: torch.Tensor
    act_pow: bool
    hid_pow: bool
    act_top: int
    hid_top: int
    ln_eps: float
    launches: dict = dataclasses.field(default_factory=dict, repr=False,
                                       compare=False)


def _plan_mlp(name, limit, w1, scale1, bias1, w2, scale2, bias2, *,
              ln_scale, ln_bias, ln_eps, act_d, act_t, act_top, act_pow,
              hid_d, hid_t, hid_top, hid_pow, fmt, fmt2, w1_t,
              w2_t) -> MlpPlan:
    """The layer-side work of K2 and K8 (``limit``: K8's width limit,
    :func:`mlp_chunked_kernel_limit`; None for K2, which has none)."""
    fmt2 = fmt2 or fmt
    k, hid = _mlp_shapes(w1, w2, fmt, fmt2, act_top, hid_top)
    if fmt2 == "int4" and hid % 2:
        raise ValueError("packed int4 w2 needs an even hidden width")
    err = limit and limit(k)
    if err:
        raise ValueError(err)
    _build.require_cuda(name, w1, w2)
    dev = w1.device
    scale1 = torch.broadcast_to(_f32(scale1, dev), (hid,))
    bias1 = (torch.zeros((hid,), dtype=torch.float32, device=dev)
             if bias1 is None else _f32(bias1, dev))
    scale2 = torch.broadcast_to(_f32(scale2, dev), (k,))
    bias2 = (torch.zeros((k,), dtype=torch.float32, device=dev)
             if bias2 is None else _f32(bias2, dev))
    ln_scale, ln_bias = fold_ln(ln_scale, ln_bias, act_d, act_pow, dev)
    if not hid_pow:
        scale1, bias1 = fold_gelu(scale1, bias1, dev)
    return MlpPlan(
        w1_t=_build.n_major(w1) if w1_t is None else w1_t,
        w2_t=_build.n_major(w2) if w2_t is None else w2_t,
        int4_1=fmt == "int4", int4_2=fmt2 == "int4", k=k, hid=hid,
        scale1=scale1.contiguous(), bias1=bias1.contiguous(),
        scale2=scale2.contiguous(), bias2=bias2.contiguous(),
        ln_scale=ln_scale.contiguous(), ln_bias=ln_bias.contiguous(),
        prm=_params4(dev, act_d, act_t, hid_d, hid_t),
        act_pow=bool(act_pow), hid_pow=bool(hid_pow), act_top=int(act_top),
        hid_top=int(hid_top), ln_eps=float(ln_eps))


def plan_mlp(w1, scale1, bias1, w2, scale2, bias2, *, ln_scale, ln_bias,
             ln_eps=1e-6, act_d=None, act_t=None, act_top=None,
             act_pow=False, hid_d=None, hid_t=None, hid_top=None,
             hid_pow=False, fmt="int8", fmt2=None, w1_t=None,
             w2_t=None) -> MlpPlan:
    """K2's layer-side work, done once: checks, both weight copies into
    the kernels' layout and the folds of fused.py:874-891. Arguments as
    :func:`fused_mlp`; the weights must lie on a CUDA device. ``w1_t`` /
    ``w2_t``: the weights already in the kernels' layout (another plan's
    copies, shared instead of copied again)."""
    return _plan_mlp("fused_mlp", None, w1, scale1, bias1, w2,
                     scale2, bias2, ln_scale=ln_scale, ln_bias=ln_bias,
                     ln_eps=ln_eps, act_d=act_d, act_t=act_t,
                     act_top=act_top, act_pow=act_pow, hid_d=hid_d,
                     hid_t=hid_t, hid_top=hid_top, hid_pow=hid_pow, fmt=fmt,
                     fmt2=fmt2, w1_t=w1_t, w2_t=w2_t)


def _chunked_copy(w_t: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    """An n-major weight ``w_t`` [rows, cols] as K8's tensor maps read it:
    [rows rounded up to 64, cols rounded up to 128] with zero levels in the
    padding, so that no TMA box leaves the copy (``w_t`` itself when it
    already has that shape: every ViT width)."""
    shape = (_round_up(rows, CHUNKED_ROWS), _round_up(cols, CHUNKED_BK))
    if tuple(w_t.shape) == shape:
        return w_t
    out = w_t.new_zeros(shape)
    out[:rows, :cols] = w_t
    return out


def plan_mlp_chunked(w1, scale1, bias1, w2, scale2, bias2, *, ln_scale,
                     ln_bias, ln_eps=1e-6, act_d=None, act_t=None,
                     act_top=None, act_pow=False, hid_d=None, hid_t=None,
                     hid_top=None, hid_pow=False, fmt="int8", fmt2=None,
                     w1_t=None, w2_t=None) -> MlpPlan:
    """K8's layer-side work, done once, as :func:`plan_mlp` (int8 weights
    only; any width). Its weights are the shared n-major copies, or its own
    copies padded with zeros where a width is off K8's tiles
    (:func:`_chunked_copy`)."""
    plan = _plan_mlp(
        "fused_mlp_chunked",
        lambda k: mlp_chunked_kernel_limit(k, fmt, fmt2), w1, scale1, bias1,
        w2, scale2, bias2, ln_scale=ln_scale, ln_bias=ln_bias, ln_eps=ln_eps,
        act_d=act_d, act_t=act_t, act_top=act_top, act_pow=act_pow,
        hid_d=hid_d, hid_t=hid_t, hid_top=hid_top, hid_pow=hid_pow, fmt=fmt,
        fmt2=fmt2, w1_t=w1_t, w2_t=w2_t)
    return dataclasses.replace(
        plan, w1_t=_chunked_copy(plan.w1_t, plan.hid, plan.k),
        w2_t=_chunked_copy(plan.w2_t, plan.k, plan.hid))


def run_mlp(plan: MlpPlan, x, *, out_dtype=torch.bfloat16):
    """Launches K2 on ``x`` [M, K] for a prepared MLP at the work split
    :func:`mlp_layout` picks for the card: the only place that launches
    it."""
    from .attention import _card_shape  # attention.py imports this module

    _build.require_cuda("fused_mlp", x)
    layout = mlp_layout(_mlp_input(x, plan.k), plan.k, plan.hid,
                        x.element_size(), _card_shape(x.device.index)[0])
    return _launch_mlp(plan, x, layout, out_dtype=out_dtype)


def _mlp_library():
    """K2's library (K15's too), its entry points' C signatures set on
    first use."""
    lib = _build.library("fused_mlp")
    if lib.qvt_fused_mlp.argtypes is None:
        P, I, F, LL = _build.P, _build.I, _build.F, _build.LL
        mlp = [P, I, P, I, P, P, P, I] + [P] * 10 + [I] * 15 + [F]
        lib.qvt_fused_mlp.argtypes = mlp + [P]
        lib.qvt_fused_mlp.restype = I
        lib.qvt_fused_mlp_gather.argtypes = mlp + [P, P, P, I, LL, I, P]
        lib.qvt_fused_mlp_gather.restype = I
    return lib


def _mlp_args(plan: MlpPlan, x, out, layout: MlpLayout):
    """K2's C arguments up to its stream, for ``x`` into ``out`` at
    ``layout``, and the scratch they point into (one byte buffer holding
    the levels, the hidden levels and, with a split, fc2's partial tiles
    and arrival counts: :meth:`MlpLayout.scratch_bytes`, each part
    16-byte aligned); K15 (``ring_gather.py``) passes the same."""
    sizes = [_round_up(v, 16) for v in layout.scratch_bytes().values()]
    scratch = torch.empty((sum(sizes),), dtype=torch.uint8, device=x.device)
    lv, hid, part, cnt = (scratch.data_ptr() + sum(sizes[:i])
                          for i in range(4))
    if layout.splits == 1:
        part = cnt = None
    return scratch, (
        x.data_ptr(), _build.dtype_code(x.dtype),
        plan.w1_t.data_ptr(), int(plan.int4_1), plan.scale1.data_ptr(),
        plan.bias1.data_ptr(), plan.w2_t.data_ptr(), int(plan.int4_2),
        plan.scale2.data_ptr(), plan.bias2.data_ptr(),
        plan.ln_scale.data_ptr(), plan.ln_bias.data_ptr(),
        plan.prm.data_ptr(), lv, hid, part, cnt, out.data_ptr(),
        _build.dtype_code(out.dtype), out.shape[0], plan.k, plan.hid,
        layout.kp, layout.hp, layout.ln_threads, layout.tile1, layout.tile2,
        layout.full2, layout.splits, int(plan.act_pow), int(plan.hid_pow),
        plan.act_top, plan.hid_top, plan.ln_eps)


def _launch_mlp(plan: MlpPlan, x, layout: MlpLayout, *,
                out_dtype=torch.bfloat16):
    """K2 at ``layout`` on a checked CUDA ``x``: its scratch
    (:func:`_mlp_args`) and the launch itself, counted under
    ``fused_mlp``. ``chip_smoke.py`` calls it at layouts other than the
    picker's."""
    m = _mlp_input(x, plan.k)
    x = x.contiguous()
    out = torch.empty((m, plan.k), dtype=out_dtype, device=x.device)
    if m == 0:
        return out
    scratch, args = _mlp_args(plan, x, out, layout)
    code = _mlp_library().qvt_fused_mlp(*args, _build.stream())
    _build.check(code, "fused_mlp")
    _build.count_launch("fused_mlp")
    return out


def run_mlp_chunked(plan: MlpPlan, x, *, out_dtype=torch.bfloat16):
    """Launches K8 on ``x`` [M, K] for a prepared int8 MLP at the work split
    :func:`chunked_layout` picks for the card."""
    from .attention import _card_shape  # attention.py imports this module

    _build.require_cuda("fused_mlp_chunked", x)
    layout = chunked_layout(_mlp_input(x, plan.k), plan.k, plan.hid,
                            x.element_size(), _card_shape(x.device.index)[0])
    return _launch_mlp_chunked(plan, x, layout, out_dtype=out_dtype)


def _chunked_library():
    """K8's library, its entry points' C signatures set on first use."""
    lib = _build.library("fused_mlp_chunked")
    if lib.qvt_fused_mlp_chunked.argtypes is None:
        P, I, F = _build.P, _build.I, _build.F
        lib.qvt_mlp_chunked_state_bytes.argtypes = []
        lib.qvt_mlp_chunked_state_bytes.restype = I
        lib.qvt_mlp_chunked_prepare.argtypes = [P, P, P] + [I] * 13
        lib.qvt_mlp_chunked_prepare.restype = I
        lib.qvt_fused_mlp_chunked.argtypes = (
            [P, P, I] + [P] * 10 + [I] * 5 + [F, P])
        lib.qvt_fused_mlp_chunked.restype = I
    return lib


def _chunked_state(plan: MlpPlan, layout: ChunkedLayout, lib):
    """K8's host state for ``plan`` at ``layout`` (the weights' tensor
    maps, the ring, the grid), made on first use and kept in the plan."""
    state = plan.launches.get(layout)
    if state is None:
        state = ctypes.create_string_buffer(lib.qvt_mlp_chunked_state_bytes())
        code = lib.qvt_mlp_chunked_prepare(
            ctypes.addressof(state), plan.w1_t.data_ptr(),
            plan.w2_t.data_ptr(), layout.m, plan.k, plan.hid,
            plan.w1_t.shape[1], plan.w2_t.shape[1], layout.ln_threads,
            layout.nc1, layout.nw1, layout.g1, layout.nc2, layout.nw2,
            layout.g2, layout.stages)
        _build.check(code, "fused_mlp_chunked")
        plan.launches[layout] = state
    return state


def _launch_mlp_chunked(plan: MlpPlan, x, layout: ChunkedLayout, *,
                        out_dtype=torch.bfloat16):
    """K8 at ``layout`` on a checked CUDA ``x``: its scratch (the levels
    and the hidden levels, one buffer) and the launch itself, counted
    under ``fused_mlp_chunked``: the only place that launches it.
    ``chip_smoke.py`` calls it at layouts other than the picker's."""
    if plan.int4_1 or plan.int4_2:
        raise ValueError(mlp_chunked_kernel_limit(plan.k, "int4"))
    m = _mlp_input(x, plan.k)
    x = x.contiguous()
    out = torch.empty((m, plan.k), dtype=out_dtype, device=x.device)
    if m == 0:
        return out
    lib = _chunked_library()
    state = _chunked_state(plan, layout, lib)
    sizes = [_round_up(v, 16) for v in layout.scratch_bytes().values()]
    scratch = torch.empty((sum(sizes),), dtype=torch.uint8, device=x.device)
    code = lib.qvt_fused_mlp_chunked(
        ctypes.addressof(state), x.data_ptr(), _build.dtype_code(x.dtype),
        plan.scale1.data_ptr(), plan.bias1.data_ptr(),
        plan.scale2.data_ptr(), plan.bias2.data_ptr(),
        plan.ln_scale.data_ptr(), plan.ln_bias.data_ptr(),
        plan.prm.data_ptr(), scratch.data_ptr(),
        scratch.data_ptr() + sizes[0], out.data_ptr(),
        _build.dtype_code(out.dtype), int(plan.act_pow), int(plan.hid_pow),
        plan.act_top, plan.hid_top, plan.ln_eps, _build.stream())
    _build.check(code, "fused_mlp_chunked")
    _build.count_launch("fused_mlp_chunked")
    return out


def fused_mlp(x, w1, scale1, bias1, w2, scale2, bias2, *,
              ln_scale, ln_bias, ln_eps=1e-6,
              act_d=None, act_t=None, act_top=None, act_pow=False,
              hid_d=None, hid_t=None, hid_top=None, hid_pow=False,
              fmt="int8", fmt2=None, out_dtype=torch.bfloat16,
              block_m=None, hid_block=None):
    """``x + fc2(quant(GELU(fc1(quant(LN(x))))))`` in one kernel: K2, or
    K8 for weights streamed in hidden chunks.

    x: [M, K] float residual stream. w1: [K, H] int8 or packed int4
    [K/2, H] (``fmt``); w2: [H, K] int8 or packed int4 [H/2, K] (``fmt2``,
    default ``fmt``: GETA mixed-precision exports mix them). act_*: fc1's
    input quantizer; hid_*: fc2's input quantizer on the GELU output.
    ``block_m`` / ``hid_block`` select the kernel as the JAX function's
    do (fused.py:916-942): an explicit ``hid_block`` (int8 only, dividing
    H) takes K8; with neither, int8 weights too big to stay resident at
    this M take K8 (:func:`mlp_auto_hid_block`); a ``block_m`` keeps K2.
    The CUDA kernels tile by their own sizes, not by these. CPU tensors
    take :func:`fused_mlp_plain`; CUDA tensors :func:`plan_mlp` then
    :func:`run_mlp`, or :func:`plan_mlp_chunked` then
    :func:`run_mlp_chunked`.
    """
    fmt2 = fmt2 or fmt
    k, hid = _mlp_shapes(w1, w2, fmt, fmt2, act_top, hid_top)
    if hid_block is None and block_m is None and fmt2 == fmt:
        hid_block = mlp_auto_hid_block(
            _mlp_input(x, k), k, hid, fmt, x.element_size(),
            torch.empty((), dtype=out_dtype).element_size())
    chunked = hid_block is not None and hid_block != hid
    if chunked:
        if fmt != "int8" or fmt2 != "int8":
            raise ValueError("hid_block chunking supports fmt='int8' only")
        if hid % hid_block:
            raise ValueError(f"hid_block={hid_block} must divide H={hid}")
    layer = dict(ln_scale=ln_scale, ln_bias=ln_bias, ln_eps=ln_eps,
                 act_d=act_d, act_t=act_t, act_top=act_top, act_pow=act_pow,
                 hid_d=hid_d, hid_t=hid_t, hid_top=hid_top, hid_pow=hid_pow,
                 fmt=fmt, fmt2=fmt2)
    if x.device.type == "cpu":
        return fused_mlp_plain(x, w1, scale1, bias1, w2, scale2, bias2,
                               out_dtype=out_dtype, **layer)
    args = (w1, scale1, bias1, w2, scale2, bias2)
    if chunked:
        return run_mlp_chunked(plan_mlp_chunked(*args, **layer), x,
                               out_dtype=out_dtype)
    return run_mlp(plan_mlp(*args, **layer), x, out_dtype=out_dtype)

"""Fused single-pass backward of the LSFQ nonlinear quantizer (kernel K7).

Replaces ``quantized_vit_tpu/ops/quant_vjp.py:lsfq_nonlinear_bwd_fused``
(``pallas_call`` at quant_vjp.py:172, ``_bwd_kernel`` :46). One read of
(x, g) gives grad_x (the clipped straight-through gradient) and the three
scalar gradients of the quantizer's (d, q_m, t), with the terms and mask
precedence of ``quant/lsfq.py:_nonlinear_bwd``.

Kernel: ``csrc/quant_bwd.cu`` (CUDA C++). It takes any shape: the JAX
package's ``quant_bwd_fits`` gate (a trailing dim that is a multiple of 128
and fits the TPU's VMEM) has no counterpart here, so on the card every
nonlinear quantizer site with ``QuantConfig.fused_vjp`` takes K7, the
ViT head's [768, 1000] weight included.

The plain version, :func:`lsfq_nonlinear_bwd_plain`, is the same backward
as a chain of PyTorch ops whose three sums are taken the way K7 takes them:
the same f32 terms, summed in f64 and rounded once to f32. It is the
backward of the non-fused quantizer (``fused_vjp=False``, the JAX default)
on any device, and K7's plain version on the CPU.
"""

from __future__ import annotations

import torch

from . import _build

_EPS = 1e-6          # quant/lsfq.py:_EPS
_LOG_GUARD = 1e-30   # _safe_pow's clamp
_THREADS = 256       # csrc/quant_bwd.cu:kThreads
_MAX_BLOCKS = 1024


def nonlinear_bwd_terms(x, g, d, q_m, t, *, clip_lo, clip_hi, q_s=0.0):
    """grad_x and the three f32 summands of (grad_d, grad_q_m, grad_t),
    elementwise (``quant/lsfq.py:_nonlinear_bwd``, :76-102). ``clip_lo``,
    ``clip_hi`` and ``q_s`` are floats or scalar tensors."""
    x_abs = x.abs()
    sgn = torch.sign(x)
    grad_x = torch.where((x >= clip_hi) | (x <= clip_lo), 0.0, g)

    range_abs = (q_m - q_s).abs() + _EPS
    log_range = torch.log(torch.clamp_min(range_abs, _LOG_GUARD))
    range_pow = torch.exp(t * log_range)
    range_pow_low = torch.exp((t - 1.0) * log_range)
    log_in = torch.log(torch.clamp_min(x_abs - q_s, _LOG_GUARD))
    input_pow = torch.exp(t * log_in)

    r = input_pow / d
    gd = torch.round(r) - r
    r_top = range_pow / d
    gd = torch.where(x_abs >= q_m, torch.round(r_top) - r_top, gd)
    gd = torch.where(x_abs <= q_s, 0.0, gd)

    gqm = torch.where(x_abs <= q_m, 0.0, sgn * (t * range_pow_low))

    gt = input_pow * log_in
    gt = torch.where(x_abs >= q_m, range_pow * log_range, gt)
    gt = torch.where(x_abs <= q_s, 0.0, gt)
    return grad_x, g * sgn * gd, g * gqm, g * sgn * gt


def sum_f32(term: torch.Tensor) -> torch.Tensor:
    """The f32 summands added in f64, rounded once to f32 (K7's sums)."""
    return term.sum(dtype=torch.float64).to(torch.float32)


def lsfq_nonlinear_bwd_plain(x, g, d, q_m, t, *, clip_lo, clip_hi,
                             q_s=0.0):
    """(grad_x, grad_d, grad_q_m, grad_t): grad_x like x, the rest f32
    scalars."""
    grad_x, td, tqm, tt = nonlinear_bwd_terms(
        x, g, d, q_m, t, clip_lo=clip_lo, clip_hi=clip_hi, q_s=q_s)
    return grad_x, sum_f32(td), sum_f32(tqm), sum_f32(tt)


def grid_blocks(n: int) -> int:
    """K7's grid: a function of the element count only, so the order of
    its sums is the same in every run."""
    return max(1, min(-(-n // (4 * _THREADS)), _MAX_BLOCKS))


def _library():
    """K7's library, its entry point's C signature set on first use."""
    lib = _build.library("quant_bwd")
    if lib.qvt_quant_bwd.argtypes is None:
        P, I, F = _build.P, _build.I, _build.F
        lib.qvt_quant_bwd.argtypes = [P, P, P, P, P, P, F, F, F, _build.LL,
                                      I, I, P, P, P]
        lib.qvt_quant_bwd.restype = I
    return lib


def lsfq_nonlinear_bwd_fused(x, g, d, q_m, t, *, clip_lo: float,
                             clip_hi: float, q_s: float = 0.0):
    """(grad_x, grad_d, grad_q_m, grad_t) in one pass over (x, g).

    x, g: f32, one shape, any rank. d, q_m, t: one-element f32 tensors,
    read by the kernel from device memory. clip_lo, clip_hi, q_s: floats.
    A CPU tensor takes :func:`lsfq_nonlinear_bwd_plain`; a CUDA tensor
    launches K7 (or raises)."""
    if x.device.type == "cpu":
        return lsfq_nonlinear_bwd_plain(x, g, d, q_m, t, clip_lo=clip_lo,
                                        clip_hi=clip_hi, q_s=q_s)
    _build.require_cuda("quant_bwd", x, g, d, q_m, t)
    if g.shape != x.shape:
        raise ValueError(f"quant_bwd: g {tuple(g.shape)} != x "
                         f"{tuple(x.shape)}")
    for name, v in (("x", x), ("g", g), ("d", d), ("q_m", q_m), ("t", t)):
        if v.dtype != torch.float32:
            raise TypeError(f"quant_bwd: {name} must be float32, got "
                            f"{v.dtype}")
    for name, v in (("d", d), ("q_m", q_m), ("t", t)):
        if v.numel() != 1:
            raise ValueError(f"quant_bwd: {name} must hold one value, got "
                             f"shape {tuple(v.shape)}")
    x = x.contiguous()
    g = g.contiguous()
    d, q_m, t = (v.contiguous() for v in (d, q_m, t))
    n = x.numel()
    grad_x = torch.empty_like(x)
    sums = torch.empty((3,), dtype=torch.float32, device=x.device)
    if n == 0:
        sums.zero_()
        return (grad_x, *sums.unbind())
    blocks = grid_blocks(n)
    partials = torch.empty((3 * blocks,), dtype=torch.float64,
                           device=x.device)
    xp, gp, gxp = x.data_ptr(), g.data_ptr(), grad_x.data_ptr()
    vec = int(xp % 16 == 0 and gp % 16 == 0 and gxp % 16 == 0)
    code = _library().qvt_quant_bwd(
        xp, gp, gxp, d.data_ptr(), q_m.data_ptr(), t.data_ptr(), q_s,
        clip_lo, clip_hi, n, vec, blocks, partials.data_ptr(),
        sums.data_ptr(), _build.stream())
    _build.check(code, "quant_bwd")
    _build.count_launch("quant_bwd")
    return (grad_x, *sums.unbind())

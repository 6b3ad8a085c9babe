"""LSFQ learned-scale symmetric quantizers as ``torch.autograd.Function``s
(``quantized_vit_tpu/quant/lsfq.py``).

- :func:`lsfq_nonlinear`: ``sign(x) * d * round(((|x|-q_s)^t)/d)``, zero at
  or below ``q_s``, the top level at or above ``q_m`` (that clamp applied
  last, so it wins where ``q_m <= q_s``); the hand-derived backward gives
  grad_x (clipped STE) and the gradients of the learnable ``d``, ``q_m``
  and ``t``, with the reference's mask precedence (the ``<= q_s`` zeroing
  applied last in the backward).
- :func:`lsfq_nonlinear_fused`: the same forward; its backward is one
  launch of kernel K7 on the card (``ops/quant_vjp.py``).
- :func:`lsfq_linear`: the same without the exponent ``t``.
- :func:`dge`: linear forward, smooth input gradient
  ``(1/k)|x - d/2|^(1/k-1)`` capped at +-3.

``d``, ``q_m``, ``t`` are one-element tensors (the layers' (1,) params);
their gradients are sums over x, reshaped to the param. Every sum is taken
as K7 takes it: f32 terms added in f64, rounded once to f32
(``ops/quant_vjp.py:sum_f32``).
"""

from __future__ import annotations

import torch

from ..ops import quant_vjp as _qv

_EPS = 1e-6  # the reference's log(|q_m - q_s| + 1e-6) guard


def _safe_pow(base, t):
    """exp(t*log(base)) with base clamped positive; callers mask invalid
    lanes."""
    return torch.exp(t * torch.log(torch.clamp_min(base, 1e-30)))


def _shaped(v, like):
    return v.reshape(like.shape).to(like.dtype)


def _clip_mask(x, clip_val):
    return (x >= clip_val[1]) | (x <= clip_val[0])


# ---------------------------------------------------------------------------
# nonlinear quantizer (learnable t)
# ---------------------------------------------------------------------------


def _nonlinear_fwd(x, d, q_m, t, q_s):
    x_abs = x.abs()
    range_pow = _safe_pow((q_m - q_s).abs() + _EPS, t)
    input_pow = _safe_pow(x_abs - q_s, t)
    base = d * torch.round(input_pow / d)
    top = d * torch.round(range_pow / d)
    y = torch.where(x_abs <= q_s, 0.0, base)
    y = torch.where(x_abs >= q_m, top, y)  # applied last -> wins on overlap
    return torch.sign(x) * y


class _Nonlinear(torch.autograd.Function):
    """The nonlinear quantizer; ``fused`` picks its backward: the single
    pass (K7 on a CUDA tensor) or the plain chain."""

    @staticmethod
    def forward(ctx, x, d, q_m, t, clip_lo, clip_hi, q_s, fused):
        ctx.save_for_backward(x, d, q_m, t)
        ctx.consts = (clip_lo, clip_hi, q_s, fused)
        return _nonlinear_fwd(x, d, q_m, t, q_s)

    @staticmethod
    def backward(ctx, g):
        x, d, q_m, t = ctx.saved_tensors
        clip_lo, clip_hi, q_s, fused = ctx.consts
        # No width gate: the JAX backward sends a trailing dim that is not
        # a multiple of 128, or too wide for the TPU's VMEM, to the jnp
        # chain (ops/quant_vjp.py:quant_bwd_fits). K7 takes any shape, so
        # on the card every fused site launches it, the ViT head's
        # [768, 1000] weight included.
        bwd = (_qv.lsfq_nonlinear_bwd_fused if fused
               else _qv.lsfq_nonlinear_bwd_plain)
        gx, gd, gqm, gt = bwd(x, g, d, q_m, t, clip_lo=clip_lo,
                              clip_hi=clip_hi, q_s=q_s)
        return (gx, _shaped(gd, d), _shaped(gqm, q_m), _shaped(gt, t),
                None, None, None, None)


def lsfq_nonlinear(x, d, q_m, t, clip_val, q_s=0.0):
    """Symmetric nonlinear quantizer. ``clip_val``: (lo, hi), a (2,)
    tensor or two floats; ``q_s`` a float or scalar tensor."""
    return _Nonlinear.apply(x, d, q_m, t, clip_val[0], clip_val[1], q_s,
                            False)


def lsfq_nonlinear_fused(x, d, q_m, t, clip_lo: float, clip_hi: float,
                         q_s: float = 0.0):
    """:func:`lsfq_nonlinear` with its backward in one pass (K7 on a CUDA
    tensor, the plain chain on a CPU tensor). ``clip_lo``/``clip_hi``/
    ``q_s`` are constants of the layer (floats); no gradient for them."""
    return _Nonlinear.apply(x, d, q_m, t, float(clip_lo), float(clip_hi),
                            float(q_s), True)


# ---------------------------------------------------------------------------
# linear quantizer (t == 1) and DGE
# ---------------------------------------------------------------------------


def _linear_fwd(x, d, q_m, q_s):
    x_abs = x.abs()
    range_lin = (q_m - q_s).abs()
    input_lin = x_abs - q_s
    base = d * torch.round(input_lin / d)
    top = d * torch.round(range_lin / d)
    y = torch.where(x_abs <= q_s, 0.0, base)
    y = torch.where(x_abs >= q_m, top, y)
    return torch.sign(x) * y


def _linear_scalar_grads(x, g, d, q_m, q_s):
    """(grad_d, grad_q_m) of the linear forward (quant_layers.py:185-187
    for q_m: sign(x) where |x| > q_m)."""
    x_abs = x.abs()
    sgn = torch.sign(x)
    range_lin = (q_m - q_s).abs()
    r = (x_abs - q_s) / d
    gd = torch.round(r) - r
    r_top = range_lin / d
    gd = torch.where(x_abs >= q_m, torch.round(r_top) - r_top, gd)
    gd = torch.where(x_abs <= q_s, 0.0, gd)
    gqm = torch.where(x_abs <= q_m, 0.0, sgn)
    return (_shaped(_qv.sum_f32(g * sgn * gd), d),
            _shaped(_qv.sum_f32(g * gqm), q_m))


class _Linear(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, d, q_m, clip_val, q_s):
        ctx.save_for_backward(x, d, q_m, clip_val)
        ctx.q_s = q_s
        return _linear_fwd(x, d, q_m, q_s)

    @staticmethod
    def backward(ctx, g):
        x, d, q_m, clip_val = ctx.saved_tensors
        gx = torch.where(_clip_mask(x, clip_val), 0.0, g)
        gd, gqm = _linear_scalar_grads(x, g, d, q_m, ctx.q_s)
        return gx, gd, gqm, None, None


def lsfq_linear(x, d, q_m, clip_val, q_s=0.0):
    """Symmetric linear quantizer (quant_layers.py:128-205)."""
    return _Linear.apply(x, d, q_m, clip_val, q_s)


class _Dge(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, d, q_m, clip_val, q_s, num_bits):
        ctx.save_for_backward(x, d, q_m, clip_val)
        ctx.q_s = q_s
        ctx.num_bits = num_bits
        return _linear_fwd(x, d, q_m, q_s)

    @staticmethod
    def backward(ctx, g):
        x, d, q_m, clip_val = ctx.saved_tensors
        k = 5.0 * (4.0 / ctx.num_bits)
        gx = torch.where(_clip_mask(x, clip_val), 0.0, g)
        grad_scale = (1.0 / k) * _safe_pow((x - d / 2.0).abs(), 1.0 / k - 1.0)
        gx = torch.clamp(gx * grad_scale, -3.0, 3.0)
        gd, gqm = _linear_scalar_grads(x, g, d, q_m, ctx.q_s)
        return gx, gd, gqm, None, None, None


def dge(x, d, q_m, clip_val, q_s=0.0, num_bits=4.0):
    """DGE quantizer: linear forward, smooth input gradient with
    ``k = 5 * 4 / num_bits`` (quant_layers.py:208-290). ``num_bits`` is a
    float."""
    return _Dge.apply(x, d, q_m, clip_val, q_s, float(num_bits))


# ---------------------------------------------------------------------------
# integer-level views of the same forward (export path)
# ---------------------------------------------------------------------------


def lsfq_levels(x, d, q_m, t, q_s=0.0):
    """int32 levels ``i`` with ``lsfq_nonlinear(x, ...) == d * i``."""
    x_abs = x.abs()
    range_pow = _safe_pow((q_m - q_s).abs() + _EPS, t)
    input_pow = _safe_pow(x_abs - q_s, t)
    lvl = torch.round(input_pow / d)
    top = torch.round(range_pow / d)
    lvl = torch.where(x_abs <= q_s, 0.0, lvl)
    lvl = torch.where(x_abs >= q_m, top, lvl)
    lvl = torch.minimum(lvl, top)  # never above the top level
    return (torch.sign(x) * lvl).to(torch.int32)


def lsfq_top_level(d, q_m, t, q_s=0.0):
    """Number of positive levels ``round(((|q_m-q_s|+eps)^t)/d)``."""
    range_pow = _safe_pow((q_m - q_s).abs() + _EPS, t)
    return torch.round(range_pow / d).to(torch.int32)


def lsfq_dequant(levels, d):
    """Exact inverse of :func:`lsfq_levels` into the float forward's
    codomain."""
    return levels.to(d.dtype) * d

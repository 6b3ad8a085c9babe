"""The repository's six timing ablations (kernels K16-K21), ported.

The root ``tools/exp_*.py`` scripts each time a TPU kernel written to ask
one question about K1's fc1 GEMM or K6's attention tile. They are no part
of a forward: each is its own tool path. Here each has a kernel written by
hand for Hopper, a plain PyTorch version written as the tool writes its
kernel body, and a wrapper per tool that takes the plain version for CPU
tensors and launches the kernel for CUDA tensors (never falling back),
counted in ``_build.LAUNCHES`` under the tool's name.

fc1 family (``csrc/fc1_ablation.cu``): x -> prologue levels -> int8 GEMM
(int8 or packed int4 weights) -> an epilogue variant -> int8 levels.

- K16 :func:`exp_pro` replaces ``tools/exp_pro.py:kernel`` (pallas_call
  at exp_pro.py:99): a prologue variant, then the erf-GELU quant epilogue.
- K17 :func:`exp_pro2` replaces ``tools/exp_pro2.py:kernel`` (:146): the
  LayerNorm fc1 with production features (vector scale, bias, runtime
  tops, K1's folded forms) added one at a time.
- K20 :func:`exp_epilogue` replaces ``tools/exp_epilogue.py:
  variant_kernel`` (:103): packed int4 weights, an epilogue variant.
- K21 :func:`exp_fc1` replaces ``tools/exp_fc1.py:kernel`` (:106): int8
  levels in, an epilogue variant.

Attention family (``csrc/attn_ablation.cu``):

- K18 :func:`exp_attn` replaces ``tools/exp_attn.py:kernel`` and
  ``kernel_v2`` (:111): one image's heads of qkv with the softmax's stages
  switched on or off.
- K19 :func:`exp_attn2` replaces ``tools/exp_attn2.py:kernel`` (:64): K6's
  attention (``ops/attention.py:attention_qkv_plain``'s function) with J
  images a thread block.

Numerics. The GEMMs are exact int32. Float sums that a kernel takes in its
own order (LayerNorm statistics, the attention dots, the row sums) run in
float64 and round once to f32, in the kernels and the plain versions
alike. Everything else is the tool's f32 arithmetic in the tool's order,
computed with separate roundings (``-fmad=false`` on the card). The
"magic" rounding ``(v + 1.5 * 2**23) - 1.5 * 2**23`` is kept as an add and
a subtract: round half to even for |v| < 2**22, on the CPU and on the
card. (XLA on the CPU folds it to ``v``; the TPU does not.) The bf16 erf
of ``gelu_bf16`` rounds to bf16 after every operation, as PyTorch's bf16
tensors do.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import torch

from . import _build
from .attention import (_card_shape, _n_keys, _qkv_head_dim,
                        _raise_if, attention_qkv_plain, plan_attention_qkv)
from .fused import (_ERF_COEFS, _SQRT2, _erf_f32, _f32, _gelu_f32,
                    _gelu_quant_folded, _layernorm_f32, _quantize_f32,
                    sum_f32)
from .reference import int_dot
from ..quant.packing import unpack_int4

# the tools' constants: the dequant scale, 1/d of the output quantizer,
# the top level, the LayerNorm epsilon, exp_pro2's quantizer d (folded),
# exp_attn2's score scale
SCALE = 1e-3
INV_D = 20.0
TOP = 7
LN_EPS = 1e-6
OUT_D = 0.05
SM_SCALE = 0.125
MAGIC = 1.5 * 2**23
_C2 = 2.0**-0.5
# exp_epilogue.py's gelu5: a degree-9 odd erf polynomial (5 coefficients)
_ERF5 = (1.128241e+00, -3.7356343e-01, 1.0320428e-01, -1.6230284e-02,
         1.0670409e-03)

# codes shared with csrc/fc1_ablation.cu
FC1_PROLOGUES = {"levels": 0, "quant": 1, "ln": 2}
FC1_EPILOGUES = {"trunc": 0, "round": 1, "magic": 2, "gelu_erf": 3,
                 "gelu_erf_magic": 4, "gelu_tanh": 5, "gelu_sig": 6,
                 "gelu_bf16": 7, "gelu7": 8, "gelu7_magic": 9, "gelu5": 10,
                 "folded": 11}
# the (prologue, epilogue) pairs the kernel is built for
FC1_BUILT = {("levels", e) for e in FC1_EPILOGUES if e != "folded"} | {
    ("quant", "gelu_erf"), ("ln", "gelu_erf"), ("ln", "folded")}


@dataclasses.dataclass(frozen=True)
class Fc1Variant:
    """The function one fc1 mode computes: its prologue, its epilogue,
    and whether the dequant scale is a vector and a bias is added."""

    prologue: str
    epilogue: str
    vscale: bool = False
    bias: bool = False


# Each tool's modes and the function each computes. Names that share a
# variant compute the same function: on the TPU they differed in schedule
# only (exp_pro's row chunks, which rows the LayerNorm statistics span at
# a time; exp_pro2's runtime scalars in SMEM against immediates: the card
# takes every top as a kernel argument).
EXP_FC1_MODES = {
    "none": Fc1Variant("levels", "trunc"),
    "round": Fc1Variant("levels", "round"),
    "magic": Fc1Variant("levels", "magic"),
    "gelu_erf": Fc1Variant("levels", "gelu_erf"),
    "gelu_magic": Fc1Variant("levels", "gelu_erf_magic"),
    "gelu_tanh": Fc1Variant("levels", "gelu_tanh"),
    "gelu_sig": Fc1Variant("levels", "gelu_sig"),
    "gelu_bf16": Fc1Variant("levels", "gelu_bf16"),
}
EXP_PRO_MODES = {
    "int8_in": Fc1Variant("levels", "gelu_erf"),
    "quant": Fc1Variant("quant", "gelu_erf"),
    "noln_f32": Fc1Variant("quant", "gelu_erf"),
    "ln_quant": Fc1Variant("ln", "gelu_erf"),
    "ln_quant_r2": Fc1Variant("ln", "gelu_erf"),
    "ln_sub": Fc1Variant("ln", "gelu_erf"),
}
EXP_PRO2_MODES = {
    "lean": Fc1Variant("ln", "gelu_erf"),
    "vscale": Fc1Variant("ln", "gelu_erf", vscale=True),
    "bias": Fc1Variant("ln", "gelu_erf", vscale=True, bias=True),
    "smem": Fc1Variant("ln", "gelu_erf", vscale=True, bias=True),
    # exp_pro2.py adds the bias in bias, smem and folded only
    "smem_hoist": Fc1Variant("ln", "gelu_erf", vscale=True),
    "smem_unused": Fc1Variant("ln", "gelu_erf", vscale=True),
    "folded": Fc1Variant("ln", "folded", vscale=True, bias=True),
}
EXP_EPILOGUE_MODES = {
    "none": Fc1Variant("levels", "trunc"),
    "quant_round": Fc1Variant("levels", "round"),
    "quant_magic": Fc1Variant("levels", "magic"),
    "gelu10": Fc1Variant("levels", "gelu7_magic"),
    "gelu5": Fc1Variant("levels", "gelu5"),
    "gelu_sig": Fc1Variant("levels", "gelu_sig"),
    "gelu7_split": Fc1Variant("levels", "gelu7"),
}
# exp_attn.py's modes (kernel: the first eight; kernel_v2: the last two)
EXP_ATTN_MODES = ("full", "no_mask", "no_max", "no_exp", "matmuls_only",
                  "sum_only", "recip", "no_sum", "mxu_sum", "transposed")
EXP_ATTN_CODES = {m: i for i, m in enumerate(EXP_ATTN_MODES)}
# exp_attn.py's key mask: columns below 197 (ViT-B/16's tokens)
ATTN_N_VALID = 197
# exp_attn2.py's images a program
EXP_ATTN2_J = (1, 2, 4)


def _mode(modes, tool, mode):
    if mode not in modes:
        raise ValueError(f"{tool}: unknown mode {mode!r}; modes: "
                         f"{', '.join(modes)}")
    return modes[mode] if isinstance(modes, dict) else mode


# ---------------------------------------------------------------------------
# fc1 family: plain versions
# ---------------------------------------------------------------------------


def magic_round(v):
    """``(v + 1.5 * 2**23) - 1.5 * 2**23`` in f32, two roundings: round
    half to even for |v| < 2**22."""
    return (v + MAGIC) - MAGIC


def _levels(r):
    return torch.clamp(r, -float(TOP), float(TOP)).to(torch.int8)


def fc1_prologue_plain(x, prologue, *, ln_g=None, ln_b=None):
    """The int8 levels of the fc1 ablations' prologues: ``levels`` (x as
    it is), ``quant`` (``clip(round(x), +-7)`` in f32) or ``ln``
    (``exp_pro.py``'s two-moment LayerNorm, ``(x - mu) * rsqrt(var +
    1e-6) * g + b``, then round and clip; this is ``_layernorm_f32``'s
    formula, with its f64 sums and ``1/sqrt``)."""
    if prologue == "levels":
        if x.dtype != torch.int8:
            raise TypeError("the levels prologue takes int8 levels")
        return x
    x32 = x.to(torch.float32)
    if prologue == "ln":
        x32 = _layernorm_f32(x32, ln_g, ln_b, LN_EPS)
    elif prologue != "quant":
        raise ValueError(f"unknown prologue {prologue!r}")
    return _quantize_f32(x32, None, None, TOP, False, folded=True)


def int_acc(lv, w, fmt="int8"):
    """The exact int32 ``lv @ W`` of int8 levels and int8 (or packed int4,
    ``quant/packing.py``'s layout) weights: ``torch._int_mm`` on the card
    where it takes the shape, else a float64 product."""
    wl = unpack_int4(w, axis=0) if fmt == "int4" else w
    m, k = lv.shape
    if lv.is_cuda and m > 16 and k % 8 == 0 and wl.shape[1] % 8 == 0:
        return torch._int_mm(lv.contiguous(), wl.contiguous())
    return int_dot(lv, wl)


def fc1_epilogue_plain(y, epilogue):
    """(pre, levels) of an fc1 epilogue on y = acc * scale (+ bias): the
    f32 value before the final rounding and the int8 levels, each as the
    tool writes it (``none``/``trunc``: the f32 -> int8 cast, truncation).
    """
    if epilogue == "trunc":
        return y, y.to(torch.int8)
    magic = epilogue in ("magic", "gelu_erf_magic", "gelu_tanh", "gelu_sig",
                         "gelu_bf16", "gelu7_magic", "gelu5")
    if epilogue in ("round", "magic"):
        pre = y * INV_D
    elif epilogue in ("gelu_erf", "gelu_erf_magic"):
        z = torch.clamp(y * _C2, -3.0, 3.0)
        e = _erf_f32(z)
        w = z * (_SQRT2 * 0.5) * INV_D
        pre = w + w * e
    elif epilogue == "gelu_tanh":
        # 0.5 y (1 + tanh(0.7978845608 (y + 0.044715 y^3)))
        y2 = y * y
        t = torch.tanh(y * (0.7978845608 + 0.7978845608 * 0.044715 * y2))
        pre = y * INV_D * 0.5 * (1.0 + t)
    elif epilogue == "gelu_sig":
        pre = y * torch.sigmoid(1.702 * y) * INV_D
    elif epilogue == "gelu_bf16":
        # the erf polynomial in bf16, each operation rounded to bf16
        z = torch.clamp(y * _C2, -3.0, 3.0).to(torch.bfloat16)
        z2 = z * z
        acc = torch.full_like(z, _ERF_COEFS[-1])
        for c in _ERF_COEFS[-2::-1]:
            acc = acc * z2 + torch.full_like(z, c)
        e = (acc * z).to(torch.float32)
        w = y * (0.5 * INV_D)
        pre = w + w * e
    elif epilogue in ("gelu7", "gelu7_magic"):
        pre = _gelu_f32(y) * INV_D
    elif epilogue == "gelu5":
        v = torch.clamp(y * _C2, -3.0, 3.0)
        v2 = v * v
        acc = torch.full_like(v, _ERF5[-1])
        for c in _ERF5[-2::-1]:
            acc = acc * v2 + c
        erf = torch.clamp(acc * v, -1.0, 1.0)
        pre = y * 0.5 * (1.0 + erf) * INV_D
    elif epilogue == "folded":
        # K1's folded GELU-quant on y as z (fused.py:_gelu_quant_folded)
        d = _f32(OUT_D, y.device)
        w = y * (_f32(_SQRT2 * 0.5, y.device) / d)
        pre = w + w * _erf_f32(y)
        return pre, _gelu_quant_folded(y, d, TOP)
    else:
        raise ValueError(f"unknown epilogue {epilogue!r}")
    return pre, _levels(magic_round(pre) if magic else torch.round(pre))


def fc1_ablation_plain(x, w, variant: Fc1Variant, *, fmt="int8",
                       scale=SCALE, bias=None, ln_g=None, ln_b=None,
                       with_pre=False):
    """Plain version of the fc1 ablations: int8 levels [M, N] of
    ``epilogue(prologue(x) @ W * scale (+ bias))``. x [M, K] (int8 levels,
    or bf16/f32 for the quant and ln prologues); w [K, N] int8 or packed
    int4 [K/2, N]; ``scale`` a number or an [N] f32 vector (``vscale``);
    ``bias`` [N] f32 (added where the variant has one). The tops, 1/d, the
    LayerNorm epsilon and the folded quantizer's d are the tools'
    (:data:`TOP`, :data:`INV_D`, :data:`LN_EPS`, :data:`OUT_D`).
    ``with_pre``: also the f32 value before the final rounding."""
    lv = fc1_prologue_plain(x, variant.prologue, ln_g=ln_g, ln_b=ln_b)
    y = int_acc(lv, w, fmt).to(torch.float32) * scale
    if variant.bias:
        y = y + bias
    pre, out = fc1_epilogue_plain(y, variant.epilogue)
    return (out, pre) if with_pre else out


# ---------------------------------------------------------------------------
# fc1 family: the kernel
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Fc1Plan:
    """An fc1 ablation call site of M rows, prepared once by
    :func:`plan_fc1`: the weight in the kernels' n-major layout
    (:func:`~._build.n_major`), the variant, its f32 vectors on the device
    (the scale vector, the bias, the LayerNorm g and b, where it has
    them), the level scratch (float prologues), the output every launch
    writes, and the card's SM count; so a launch is the library call."""

    w_t: torch.Tensor
    int4: bool
    m: int
    k: int
    n: int
    variant: Fc1Variant
    scale: float
    vec: Optional[torch.Tensor]
    bias: Optional[torch.Tensor]
    ln_g: Optional[torch.Tensor]
    ln_b: Optional[torch.Tensor]
    prm: torch.Tensor
    lv: Optional[torch.Tensor]
    out: torch.Tensor
    sms: int


def plan_fc1(w, variant: Fc1Variant, m: int, *, fmt="int8", scale=SCALE,
             bias=None, ln_g=None, ln_b=None) -> Fc1Plan:
    """The call site of ``variant`` on M rows with w [K, N] int8 (or
    packed int4 [K/2, N]) on the card; operands as
    :func:`fc1_ablation_plain`."""
    _build.require_cuda("fc1_ablation", w)
    if w.dtype != torch.int8 or fmt not in ("int8", "int4"):
        raise TypeError("fc1_ablation: int8 or packed int4 (int8-typed) "
                        "weights")
    pair = (variant.prologue, variant.epilogue)
    if pair not in FC1_BUILT:
        raise ValueError(f"fc1_ablation: no kernel built for {pair}")
    k = w.shape[0] * (2 if fmt == "int4" else 1)
    n = w.shape[1]
    _raise_if(fc1_kernel_limit(m, k, n, fmt))
    dev = w.device
    vec = None
    if variant.vscale:  # a number, [N] or the tools' [1, N]
        vec = torch.broadcast_to(_f32(scale, dev).reshape(-1),
                                 (n,)).contiguous()
    b = _f32(bias, dev).reshape(-1).contiguous() if variant.bias else None
    g = bb = lv = None
    if variant.prologue == "ln":
        g = _f32(ln_g, dev).reshape(-1).contiguous()
        bb = _f32(ln_b, dev).reshape(-1).contiguous()
    if variant.prologue != "levels":
        lv = torch.empty((m, k), dtype=torch.int8, device=dev)
    return Fc1Plan(
        w_t=_build.n_major(w), int4=fmt == "int4", m=m, k=k, n=n,
        variant=variant, scale=0.0 if variant.vscale else float(scale),
        vec=vec, bias=b, ln_g=g, ln_b=bb, prm=_unit_params(dev.index),
        lv=lv, out=torch.empty((m, n), dtype=torch.int8, device=dev),
        sms=_card_shape(dev.index)[0])


def fc1_kernel_limit(m: int, k: int, n: int, fmt: str) -> Optional[str]:
    """Why the fc1 ablation kernel cannot take these shapes, or None: it
    reads x's levels and the weight in 16-byte pieces (K % 16 == 0; packed
    int4 K/2 % 16 == 0) and stores four levels at a time (N % 4 == 0)."""
    if k % 16 or (fmt == "int4" and (k // 2) % 16) or n % 4 or m < 1:
        return (f"fc1_ablation: needs K % 16 == 0 (packed int4: K/2 % 16 == "
                f"0) and N % 4 == 0, got M {m}, K {k}, N {n} ({fmt})")
    return None


def _fc1_library():
    lib = _build.library("fc1_ablation")
    fn = lib.qvt_fc1_ablation
    if fn.argtypes is None:
        P, I, F = _build.P, _build.I, _build.F
        fn.argtypes = ([P, I, P, I, I] + [P] * 6 + [F] * 4 + [P]
                       + [I] * 7 + [P])
        fn.restype = I
    return lib


def run_fc1(plan: Fc1Plan, x, counter: str):
    """Launches the fc1 ablation kernel of ``plan`` on a CUDA x [M, K]
    (int8 levels, or bf16/f32 for a float prologue), counted under
    ``counter`` (the tool's name); returns the plan's int8 output [M, N],
    which the plan's next launch overwrites."""
    _build.require_cuda(counter, x)
    if tuple(x.shape) != (plan.m, plan.k):
        raise ValueError(f"{counter}: x {tuple(x.shape)} vs the plan's "
                         f"({plan.m}, {plan.k})")
    if (plan.variant.prologue == "levels") != (x.dtype == torch.int8) or (
            x.dtype not in (torch.int8, torch.bfloat16, torch.float32)):
        raise TypeError(f"{counter}: int8 levels for the levels prologue, "
                        f"bf16 or f32 x for a float prologue")
    x = x.contiguous()
    v = plan.variant
    code = _fc1_library().qvt_fc1_ablation(
        x.data_ptr(), _build.dtype_code(x.dtype), plan.w_t.data_ptr(),
        int(plan.int4), plan.k, _build.ptr(plan.vec), _build.ptr(plan.bias),
        _build.ptr(plan.ln_g), _build.ptr(plan.ln_b), plan.prm.data_ptr(),
        _build.ptr(plan.lv), plan.scale, INV_D, OUT_D, LN_EPS,
        plan.out.data_ptr(), plan.m, plan.n, FC1_PROLOGUES[v.prologue],
        FC1_EPILOGUES[v.epilogue], TOP, TOP, plan.sms, _build.stream())
    _build.check(code, counter)
    _build.count_launch(counter)
    return plan.out


@functools.lru_cache(maxsize=None)
def _unit_params(index: int) -> torch.Tensor:
    """d = t = 1 for the prologues' quantizer (csrc/gemm_phases.cuh:
    row_levels reads them from device memory): levels of x itself."""
    return torch.ones((2,), dtype=torch.float32,
                      device=torch.device("cuda", index))


def _fc1_wrapper(tool, modes, x, w, mode, fmt="int8", **kw):
    v = _mode(modes, tool, mode)
    if x.device.type == "cpu":
        return fc1_ablation_plain(x, w, v, fmt=fmt, **kw)
    _build.require_cuda(tool, x, w)
    return run_fc1(plan_fc1(w, v, x.shape[0], fmt=fmt, **kw), x, tool)


def exp_fc1(x, w, mode):
    """K21: fc1 from int8 levels x [M, K] and int8 w [K, N] with
    ``exp_fc1.py``'s epilogue ``mode`` (:data:`EXP_FC1_MODES`)."""
    return _fc1_wrapper("exp_fc1", EXP_FC1_MODES, x, w, mode)


def exp_pro(x, w, ln_g, ln_b, mode):
    """K16: fc1 with ``exp_pro.py``'s prologue ``mode``
    (:data:`EXP_PRO_MODES`) and the erf-GELU quant epilogue. x [M, K]
    (int8 levels for ``int8_in``, else bf16/f32); ln_g, ln_b [K]."""
    return _fc1_wrapper("exp_pro", EXP_PRO_MODES, x, w, mode, ln_g=ln_g,
                        ln_b=ln_b)


def exp_pro2(x, w, ln_g, ln_b, mode, *, scale, bias):
    """K17: ``exp_pro2.py``'s LayerNorm fc1 ``mode``
    (:data:`EXP_PRO2_MODES`): scale [N] (the ``lean`` mode takes the
    tool's scalar 1e-3 instead), bias [N]; the tops and the output
    quantizer's d (``folded``) are the tool's."""
    v = _mode(EXP_PRO2_MODES, "exp_pro2", mode)
    return _fc1_wrapper("exp_pro2", EXP_PRO2_MODES, x, w, mode, ln_g=ln_g,
                        ln_b=ln_b, scale=scale if v.vscale else SCALE,
                        bias=bias if v.bias else None)


def exp_epilogue(x, w_packed, mode):
    """K20: fc1 from int8 levels x [M, K] on packed int4 weights [K/2, N]
    with ``exp_epilogue.py``'s epilogue ``mode``
    (:data:`EXP_EPILOGUE_MODES`)."""
    return _fc1_wrapper("exp_epilogue", EXP_EPILOGUE_MODES, x, w_packed,
                        mode, fmt="int4")


# ---------------------------------------------------------------------------
# attention family: plain versions
# ---------------------------------------------------------------------------


def exp_attn_plain(x, mode, *, heads, n_keys, with_pre=False):
    """Plain version of ``exp_attn.py``: x [B, N, (3, H, hd)] bf16, the
    keys and values from its first ``n_keys`` rows; per head s = q k^T
    (no scale), keys at 197 (:data:`ATTN_N_VALID`) and past masked to
    -1e30, minus the row max, exp, p in x's dtype, o = p v, divided by
    sum(p); the levels ``clip(round(o * 20), +-7)`` [B, N, H*hd] int8. Each ``mode``
    switches the tool's stages off as the tool does; ``mxu_sum`` and
    ``transposed`` compute ``full``'s function. ``with_pre``: also
    ``o * 20`` before the rounding."""
    _mode(EXP_ATTN_MODES, "exp_attn", mode)
    b, n, width = x.shape
    hd = _qkv_head_dim(width, heads)
    xr = x.reshape(b, n, 3, heads, hd)
    q, k, v = xr[:, :, 0], xr[:, :n_keys, 1], xr[:, :n_keys, 2]
    s = torch.einsum("bnhd,bmhd->bhnm", q.to(torch.float64),
                     k.to(torch.float64)).to(torch.float32)
    if mode == "matmuls_only":
        p = s.to(x.dtype)
    else:
        if mode != "no_mask":
            col = torch.arange(n_keys, device=x.device)
            s = torch.where(col < ATTN_N_VALID, s,
                            torch.full_like(s, -1e30))
        if mode != "no_max":
            s = s - s.amax(dim=-1, keepdim=True)
        p = (s if mode == "no_exp" else torch.exp(s)).to(x.dtype)
    o = torch.einsum("bhnm,bmhd->bnhd", p.to(torch.float64),
                     v.to(torch.float64)).to(torch.float32)
    p_sum = sum_f32(p.to(torch.float32), -1).permute(0, 2, 1, 3)
    if mode == "sum_only":
        o = o + p_sum * 1e-30
    elif mode == "recip":
        o = o * (1.0 / p_sum)
    elif mode not in ("matmuls_only", "no_exp", "no_sum"):
        o = o / p_sum
    pre = (o * INV_D).reshape(b, n, heads * hd)
    out = _levels(torch.round(pre))
    return (out, pre) if with_pre else out


def exp_attn2_plain(qkv, d, *, heads, n_valid=ATTN_N_VALID):
    """Plain version of ``exp_attn2.py``: K6's function
    (:func:`~.attention.attention_qkv_plain`) at the tool's score scale
    0.125 with the proj quantizer's d, top 7 and t = 1; the same for
    every J."""
    return attention_qkv_plain(qkv, heads=heads, sm_scale=SM_SCALE,
                               n_valid=n_valid, out_d=d, out_t=1.0,
                               out_top=TOP)


# ---------------------------------------------------------------------------
# attention family: the kernels
# ---------------------------------------------------------------------------


ATTN_MAX_KEYS = 256
ATTN_MAX_HD = 64
# the most keys (rounded up to 16) whose K and V rows K18 keeps as f64 (its
# f64 instantiation holds a warp's scores of 26 key tiles of 8 in
# registers); past them the rows stay bf16
ATTN_F64_KEYS = 208


def attn_kernel_limit(n: int, n_keys: int, head_dim: int) -> Optional[str]:
    """Why ``exp_attn``'s kernel cannot take these shapes, or None: it
    keeps a head's keys and values whole in shared memory (at most 256
    keys) and takes heads of at most 64 in pieces of 8."""
    if (n_keys > ATTN_MAX_KEYS or n_keys > n or n_keys < 1
            or head_dim > ATTN_MAX_HD or head_dim % 8):
        return (f"exp_attn: needs 1 <= keys <= min(N, {ATTN_MAX_KEYS}) and "
                f"head_dim <= {ATTN_MAX_HD}, a multiple of 8; got N {n}, "
                f"keys {n_keys}, head_dim {head_dim}")
    return None


# the most image groups and heads K19's grid takes (its z and y extents)
ATTN2_MAX_GRID = 65535


def attn2_kernel_limit(b: int, n: int, n_valid: int, heads: int,
                       head_dim: int, j_imgs: int) -> Optional[str]:
    """Why ``exp_attn2``'s kernel cannot take these shapes, or None: heads
    of 8-64 in multiples of 8, n_valid <= N, J dividing B, at most
    :data:`ATTN2_MAX_GRID` image groups and heads. Its keys stream through
    a ring of 32-key slots, so any token and key count fits."""
    if (b < 1 or n < 1 or heads < 1 or head_dim < 8
            or head_dim > ATTN_MAX_HD or head_dim % 8 or n_valid > n):
        return (f"exp_attn2: needs head_dim 8-{ATTN_MAX_HD}, a multiple of "
                f"8, and n_valid <= N; got B {b}, N {n}, n_valid {n_valid}, "
                f"{heads} heads of {head_dim}")
    if j_imgs < 1 or b % j_imgs:
        return (f"exp_attn2: {b} images do not split into blocks of "
                f"{j_imgs}")
    if b // j_imgs > ATTN2_MAX_GRID or heads > ATTN2_MAX_GRID:
        return (f"exp_attn2: at most {ATTN2_MAX_GRID} image groups and "
                f"heads; got {b // j_imgs} and {heads}")
    return None


def _attn_library():
    lib = _build.library("attn_ablation")
    if lib.qvt_exp_attn.argtypes is None:
        P, I, F = _build.P, _build.I, _build.F
        lib.qvt_exp_attn.argtypes = [P, P, I, I, I, I, I, I, I, I, F, P]
        lib.qvt_exp_attn.restype = I
        lib.qvt_exp_attn2.argtypes = [P, P, P, I, I, I, I, I, I, I, F, I, P]
        lib.qvt_exp_attn2.restype = I
    return lib


def run_exp_attn(x, mode, *, heads, n_keys):
    """Launches ``exp_attn``'s kernel for ``mode`` on a CUDA x
    [B, N, 3*H*hd] bf16, counted under ``exp_attn``: one block a (head,
    image), both products on the FP64 tensor cores
    (``csrc/attn_ablation.cu``; K and V as f64 rows up to
    :data:`ATTN_F64_KEYS` keys, else bf16 rows)."""
    _build.require_cuda("exp_attn", x)
    code = EXP_ATTN_CODES[_mode(EXP_ATTN_MODES, "exp_attn", mode)]
    b, n, width = x.shape
    hd = _qkv_head_dim(width, heads)
    _raise_if(attn_kernel_limit(n, n_keys, hd))
    if x.dtype != torch.bfloat16:
        raise TypeError("exp_attn: bf16 qkv")
    x = x.contiguous()
    out = torch.empty((b, n, heads * hd), dtype=torch.int8, device=x.device)
    rc = _attn_library().qvt_exp_attn(
        x.data_ptr(), out.data_ptr(), b, n, n_keys, heads, hd,
        ATTN_N_VALID, code, TOP, INV_D, _build.stream())
    _build.check(rc, "exp_attn")
    _build.count_launch("exp_attn")
    return out


def exp_attn(x, mode, *, heads, n_keys):
    """K18: ``exp_attn.py``'s ablated attention on x [B, N, 3*H*hd] bf16
    (:func:`exp_attn_plain`); int8 [B, N, H*hd]."""
    if x.device.type == "cpu":
        return exp_attn_plain(x, mode, heads=heads, n_keys=n_keys)
    return run_exp_attn(x, mode, heads=heads, n_keys=n_keys)


def run_exp_attn2(plan, qkv, *, j_imgs, n_valid=ATTN_N_VALID):
    """Launches ``exp_attn2``'s kernel on a CUDA qkv [B, N, 3*H*hd] bf16
    for a call site prepared by :func:`plan_exp_attn2`, counted under
    ``exp_attn2`` (``csrc/attn_ablation.cu``): blocks of 4 warps, a block
    its share of the query tiles of ``j_imgs`` images of one head, one
    image after another; K and V raw in a ring of 32-key slots fed by
    TMA, read once per block; a warp streams a 16-row query tile over the
    keys with both products on the FP64 tensor cores (m16n8k8), p passed
    from registers, no block barrier in the key loop."""
    _build.require_cuda("exp_attn2", qkv)
    b, n, width = qkv.shape
    hd = _qkv_head_dim(width, plan.heads)
    if qkv.dtype != torch.bfloat16:
        raise TypeError("exp_attn2: bf16 qkv")
    _raise_if(attn2_kernel_limit(b, n, n_valid, plan.heads, hd, j_imgs))
    qkv = qkv.contiguous()
    if qkv.data_ptr() % 16:  # TMA reads from a 16-byte aligned base
        qkv = qkv.clone()
    out = torch.empty((b, n, plan.heads * hd), dtype=torch.int8,
                      device=qkv.device)
    rc = _attn_library().qvt_exp_attn2(
        qkv.data_ptr(), out.data_ptr(), plan.prm.data_ptr(), b, n,
        plan.heads, hd, n_valid, _n_keys(n, n_valid, 2), j_imgs,
        plan.q_mul, plan.out_top, _build.stream())
    _build.check(rc, "exp_attn2")
    _build.count_launch("exp_attn2")
    return out


def plan_exp_attn2(device, d, heads):
    """K19's call site: K6's (:func:`~.attention.plan_attention_qkv`) at
    the tool's score scale 0.125, the proj quantizer's d, top 7 and
    t = 1."""
    return plan_attention_qkv(device, heads=heads, sm_scale=SM_SCALE,
                              out_d=d, out_t=1.0, out_top=TOP)


def exp_attn2(qkv, d, *, j_imgs, heads, n_valid=ATTN_N_VALID):
    """K19: K6's attention with ``j_imgs`` images a block
    (:func:`exp_attn2_plain`); int8 [B, N, H*hd]."""
    if qkv.device.type == "cpu":
        return exp_attn2_plain(qkv, d, heads=heads, n_valid=n_valid)
    _build.require_cuda("exp_attn2", qkv)  # before planning on it
    return run_exp_attn2(plan_exp_attn2(qkv.device, d, heads), qkv,
                         j_imgs=j_imgs, n_valid=n_valid)

"""Whole attention residual branch (kernel K3) and its plain pieces.

Port of ``quantized_vit_tpu/ops/attention.py``. :func:`attention_block`
replaces ``_attention_block`` (``pallas_call`` at attention.py:667)::

    x + proj(quant(softmax(q k^T * s) v)),  q/k/v = qkv(quant(LN(x)))

Kernel design (``csrc/attention_block.cu``): one cooperative launch of a
persistent grid in three phases split by grid barriers: LN + quant once
per row into an int8 scratch [B*N, Dp]; the qkv GEMM on the int8 tensor
cores (a cp.async ring, ldmatrix fragments; dequant + bias, rounded to
``float_dtype`` as the TPU scratch is) into a q/k/v scratch in the
fused-qkv layout; then K6's attention (``csrc/qkv_attention.cuh``) over
(query tile, head, image) items, writing the int8 attention levels
[B*N, H*hd]. No token count enters shared memory. Then K1
(:func:`~.fused.run_matmul`, prologue None, epilogue residual) runs the
proj GEMM: one ``attention_block`` call is two launches. As in
``fused.py``, a call splits into the layer's side, prepared once
(``plan_*``), and the launches (``run_*``).

The attention numerics are attention.py:164-231: q pre-scaled by
``sm_scale*log2e`` in f32 and cast back to the qkv dtype, masked keys at
-1e30, ``p = exp2(min(s, 100))`` with no row-max subtraction, p cast to
the v dtype for AV, ``p_sum`` from f32 p plus 1e-30, and
``round(o_un * (1/(p_sum*d)))``.

``int_attention`` (int8 score and AV products with dynamic per-(image,
head) scales, attention.py:140-147) runs in the kernels as in the plain
versions.

:func:`attention_qkv` (kernel K6, ``csrc/attention_qkv.cu``) replaces
``_attention_qkv`` (``pallas_call`` at attention.py:859): the attention of
the batch 1-3 chain on the raw fused-qkv tensor a K1 ``ln_quant`` launch
wrote. :func:`attention_qkv_proj` (kernel K9, ``csrc/attention_proj.cu``)
replaces ``_attention_qkv_proj`` (``pallas_call`` at attention.py:770): the
same attention with the proj GEMM, dequant and residual in the same
launch, the int8 levels kept in shared memory. K6 and K9 stream K/V in
chunks onto the FP64 tensor cores and share their staging code
(``csrc/qkv_stream.cuh``); K3 and K5 run K6's tile
(``csrc/qkv_attention.cuh``) as a phase of their launches.

:func:`flash_attention` (kernel K13, ``csrc/flash_attention.cu``)
replaces ``_flash_attention`` (``pallas_call`` at attention.py:119):
softmax(q k^T * scale) v on q/k/v [B, H, N, hd] with the TPU kernel's own
numerics (the scale after the dot, ``exp`` of the row-max-shifted scores,
a true division by the row sum, p cast to v's dtype), not the core's; a
block per (image, head, tile of query rows). Plain version:
:func:`flash_attention_plain`.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Optional

import torch

from . import _build
from .fused import (MatmulPlan, _f32, _params4, _quantize_f32, fold_ln,
                    fused_quant_matmul_plain, plan_matmul, run_matmul,
                    sum_f32)
from .reference import int_dot

_LOG2E = 1.4426950408889634


def _dot_f32(a, b):
    """f32 product of float operands, accumulated in float64 and rounded
    once (bf16 and f32 products are exact there): the kernel sums in its
    own order, and both then give the correctly rounded f32 dot."""
    return torch.matmul(a.to(torch.float64), b.to(torch.float64)).to(
        torch.float32)


def _dyn_int8(x):
    """Dynamic symmetric per-tensor int8 quantization: (levels, scale)
    with levels = round(x/scale) in [-127, 127] (attention.py:140-147)."""
    x = x.to(torch.float32)
    scale = torch.clamp_min(x.abs().max(), 1e-30) * (1.0 / 127.0)
    lv = torch.clamp(torch.round(x * (1.0 / scale)), -127.0, 127.0)
    return lv.to(torch.int8), scale


def _n_keys(n: int, n_valid: int, itemsize: int) -> int:
    """Key rows: keys past ``n_valid`` are masked, so the k/v slice stops
    at the next 16-row (bf16) / 8-row (f32) boundary."""
    sub = 16 if itemsize == 2 else 8
    return min(n, -(-n_valid // sub) * sub)


def _score_one_head(q, k, sm_scale, int_attention):
    """Scores of one head in log2 units (attention.py:164-180)."""
    if int_attention:
        q_lv, q_s = _dyn_int8(q * sm_scale)
        k_lv, k_s = _dyn_int8(k)
        return int_dot(q_lv, k_lv.T).to(torch.float32) * (
            q_s * k_s * _LOG2E)
    qs = (q.to(torch.float32) * (sm_scale * _LOG2E)).to(q.dtype)
    return _dot_f32(qs, k.T)


def _softmax_av(s2, v, col, n_valid, int_attention):
    """Masked exp2 softmax with deferred normalization: (o_un, p_sum)
    (attention.py:183-231)."""
    if col is not None:
        s2 = torch.where(col < n_valid, s2, torch.full_like(s2, -1e30))
    if int_attention:
        p = torch.exp2(s2 - s2.amax(dim=-1, keepdim=True))
        p_lv = torch.round(p * 127.0).to(torch.int8)
        v_lv, v_s = _dyn_int8(v)
        o_un = int_dot(p_lv, v_lv).to(torch.float32) * v_s
        p_sum = p_lv.to(torch.float32).sum(dim=-1, keepdim=True)
        return o_un, p_sum
    p = torch.exp2(torch.clamp_max(s2, 100.0))
    pb = p.to(v.dtype)
    o_un = _dot_f32(pb, v)
    p_sum = sum_f32(p, -1) + 1e-30
    return o_un, p_sum


def attention_qkv_plain(qkv, *, heads, sm_scale, n_valid=None,
                        out_d=None, out_t=None, out_top=None, out_pow=False,
                        out_dtype=torch.bfloat16, int_attention=False):
    """Multi-head attention on the raw fused-qkv layout [B, N, (3, H, hd)]:
    a port of ``attention_qkv_xla`` (attention.py:887-947), vectorized over
    (batch, head). The float dots and ``p_sum`` accumulate in float64 and
    round once to f32 (see :func:`_dot_f32`). Returns [B, N, H*hd], int8
    levels of the proj quantizer when ``out_d`` is given."""
    b, n, three_hdim = qkv.shape
    head_dim = three_hdim // (3 * heads)
    if n_valid is None:
        n_valid = n
    nk = _n_keys(n, n_valid, qkv.element_size())
    x = qkv.reshape(b, n, 3, heads, head_dim)
    q, k, v = x[:, :, 0], x[:, :nk, 1], x[:, :nk, 2]  # [B, N|nk, H, hd]
    if int_attention:
        def dyn(z):  # per-(b, h) scale over the (n, hd) axes
            z = z.to(torch.float32)
            s = torch.clamp_min(z.abs().amax(dim=(1, 3), keepdim=True),
                                1e-30) * (1.0 / 127.0)
            lv = torch.clamp(torch.round(z * (1.0 / s)), -127.0, 127.0)
            return lv.to(torch.int8), s

        q_lv, q_s = dyn(q.to(torch.float32) * sm_scale)
        k_lv, k_s = dyn(k)
        s2 = torch.einsum("bnhd,bmhd->bhnm", q_lv.to(torch.float64),
                          k_lv.to(torch.float64)).to(torch.int32)
        s2 = s2.to(torch.float32) * (q_s.permute(0, 2, 1, 3)
                                     * k_s.permute(0, 2, 1, 3) * _LOG2E)
    else:
        qs = (q.to(torch.float32) * (sm_scale * _LOG2E)).to(q.dtype)
        s2 = torch.einsum("bnhd,bmhd->bhnm", qs.to(torch.float64),
                          k.to(torch.float64)).to(torch.float32)
    if n_valid < nk:
        col = torch.arange(nk, device=qkv.device)
        s2 = torch.where(col[None, None, None, :] < n_valid, s2,
                         torch.full_like(s2, -1e30))
    if int_attention:
        p = torch.exp2(s2 - s2.amax(dim=-1, keepdim=True))
        p_lv = torch.round(p * 127.0).to(torch.int8)
        v_lv, v_s = dyn(v)
        o_un = torch.einsum("bhnm,bmhd->bnhd", p_lv.to(torch.float64),
                            v_lv.to(torch.float64)).to(torch.int32)
        o_un = o_un.to(torch.float32) * v_s
        p_sum = p_lv.to(torch.float32).sum(dim=-1)
    else:
        p = torch.exp2(torch.clamp_max(s2, 100.0))
        pb = p.to(qkv.dtype)
        o_un = torch.einsum("bhnm,bmhd->bnhd", pb.to(torch.float64),
                            v.to(torch.float64)).to(torch.float32)
        p_sum = sum_f32(p, -1)[..., 0] + 1e-30
    p_sum = p_sum.permute(0, 2, 1)[..., None]
    dev = qkv.device
    if out_d is not None and not out_pow:
        top = float(out_top)
        lv = torch.clamp(
            torch.round(o_un * (1.0 / (p_sum * _f32(out_d, dev)))),
            -top, top)
        return lv.to(torch.int8).reshape(b, n, heads * head_dim)
    o = (o_un / p_sum).reshape(b, n, heads * head_dim)
    if out_d is not None:
        return _quantize_f32(o, _f32(out_d, dev), _f32(out_t, dev),
                             out_top, out_pow)
    return o.to(out_dtype)


def _heads_shapes(w_qkv, heads, fmt, act_top, out_top):
    """(D, 3*H*hd, hd) of the qkv weight with ``heads`` heads."""
    for name, v in (("act_top", act_top), ("out_top", out_top)):
        if not (v or 0) >= 1:
            raise ValueError(f"attention_block: positive {name} required")
    d_in = w_qkv.shape[0] * (2 if fmt == "int4" else 1)
    three = w_qkv.shape[1]
    if three % (3 * heads):
        raise ValueError(f"w_qkv {tuple(w_qkv.shape)} ({fmt}) does not "
                         f"split into {heads} heads")
    return d_in, three, three // (3 * heads)


def _heads_input(x, d_model):
    b, n, d_x = x.shape
    if d_x != d_model:
        raise ValueError(f"x {tuple(x.shape)} does not fit a qkv weight of "
                         f"input width {d_model}")
    return b, n


def _check_proj(w_proj, fmt_proj, hdim, d_model):
    p_in = w_proj.shape[0] * (2 if fmt_proj == "int4" else 1)
    if p_in != hdim or w_proj.shape[1] != d_model:
        raise ValueError(f"w_proj {tuple(w_proj.shape)} ({fmt_proj}) vs "
                         f"[{hdim}, {d_model}]")


def attention_heads_plain(
    x, w_qkv, qkv_scale, qkv_bias, *, ln_scale, ln_bias, ln_eps=1e-6,
    heads, sm_scale, n_valid=None, act_d=None, act_t=None, act_top=None,
    act_pow=False, out_d=None, out_t=None, out_top=None, out_pow=False,
    fmt="int8", out_dtype=torch.bfloat16, int_attention=False,
    prefolded=False,
):
    """Plain version of K3's launch: K1 with ``ln_quant`` (qkv in
    ``out_dtype``) then :func:`attention_qkv_plain` with the proj layer's
    quantizer. Returns the int8 attention levels [B*N, H*hd].
    ``prefolded``: LN1 carries the fold of ``fused.fold_ln`` already."""
    d_model, three, head_dim = _heads_shapes(w_qkv, heads, fmt, act_top,
                                             out_top)
    b, n = _heads_input(x, d_model)
    qkv = fused_quant_matmul_plain(
        x.reshape(b * n, d_model), w_qkv, qkv_scale, qkv_bias, fmt=fmt,
        prologue="ln_quant", act_d=act_d, act_t=act_t, act_top=act_top,
        act_pow=act_pow, ln_scale=ln_scale, ln_bias=ln_bias, ln_eps=ln_eps,
        out_dtype=out_dtype, prefolded=prefolded)
    alv = attention_qkv_plain(
        qkv.reshape(b, n, three), heads=heads, sm_scale=sm_scale,
        n_valid=n_valid, out_d=out_d, out_t=out_t, out_top=out_top,
        out_pow=out_pow, int_attention=int_attention)
    return alv.reshape(b * n, heads * head_dim)


# the widest head the attention kernels instantiate (K3, K6, K9: a head
# bound of 64 or 80)
MAX_HEAD_DIM = 80
SMEM_LIMIT = 232448  # bytes of shared memory a block can use on Hopper
# the H100 SXM's SMs and shared memory an SM (a block reserves 1 KB
# more): the tile pickers' defaults (flash_tile_rows, qkv_proj_layout), the
# launches pass the card's own
_H100_SMS = 132
_H100_SM_SMEM = 233472


@functools.lru_cache(maxsize=None)
def _card_shape(index: int):
    """The SMs and shared memory an SM of CUDA device ``index``."""
    prop = torch.cuda.get_device_properties(index)
    return prop.multi_processor_count, prop.shared_memory_per_multiprocessor


def _check_head_dim(kernel: str, head_dim: int) -> Optional[str]:
    if head_dim > MAX_HEAD_DIM or head_dim % 8:
        return (f"{kernel} kernel: head_dim {head_dim} must be a multiple "
                f"of 8 and <= {MAX_HEAD_DIM}")
    return None


def heads_kernel_limit(head_dim: int) -> Optional[str]:
    """Why K3 cannot take heads of ``head_dim``, or None if it can:
    head_dim <= 80, a multiple of 8. q/k/v go through a device-memory
    scratch and K/V stream in chunks, so any token count and either qkv
    dtype fit a block (:func:`heads_smem_bytes`)."""
    return _check_head_dim("attention_block", head_dim)


# csrc/attention_block.cu: the GEMM phase's three stages of 128 + 128 rows
# of 144 bytes; its attention phase is K6's tile
_HEADS_GEMM_SMEM = 3 * (128 + 128) * 144


def heads_smem_bytes(rows: int, head_dim: int, itemsize: int = 2) -> int:
    """K3's shared memory a block at ``rows`` query rows an attention item,
    as ``csrc/attention_block.cu:smem_bytes`` (plus the static arrays)
    computes it: the larger of the GEMM ring (110,592 bytes) and K6's tile
    (:func:`qkv_attn_smem_bytes`). No token count enters."""
    return max(_HEADS_GEMM_SMEM + _QKV_ATTN_STATIC,
               qkv_attn_smem_bytes(rows, head_dim, itemsize))


@functools.lru_cache(maxsize=None)
def heads_tile_rows(b: int, n: int, heads: int, head_dim: int,
                    itemsize: int = 2, sms: int = _H100_SMS,
                    sm_smem: int = _H100_SM_SMEM) -> int:
    """K3's query rows an attention item (one of :data:`QKV_ATTN_TILES`),
    by :func:`qkv_attn_tile_rows`'s rule on K3's shared memory
    (:func:`heads_smem_bytes`): of the tiles whose items (ceil(n / R) x
    heads x b) give every SM one, the one that keeps the most query rows
    on an SM; where none does, the smallest. 64 at ViT-B/16 and ViT-H/14
    from batch 4 on the H100."""
    return _pick_tile(lambda r: heads_smem_bytes(r, head_dim, itemsize),
                      b, n, heads, sms, sm_smem)


def _raise_if(limit: Optional[str]) -> None:
    if limit:
        raise ValueError(limit)


@dataclasses.dataclass(frozen=True)
class HeadsPlan:
    """One K3 call site, prepared once by :func:`plan_attention_heads`:
    the qkv weight in the kernels' layout, the folded constants, the
    quantizer scalars on the device, the static options."""

    wq_t: torch.Tensor
    int4: bool
    d_model: int
    heads: int
    head_dim: int
    qkv_scale: torch.Tensor
    qkv_bias: Optional[torch.Tensor]
    ln_scale: torch.Tensor
    ln_bias: torch.Tensor
    prm: torch.Tensor
    q_mul: float
    sm_scale: float
    act_pow: bool
    out_pow: bool
    act_top: int
    out_top: int
    ln_eps: float


def _f32_value(v: float) -> float:
    """A Python double rounded to f32, as JAX's weak-typed scalar is."""
    return float(torch.tensor(v, dtype=torch.float32))


def plan_attention_heads(
    w_qkv, qkv_scale, qkv_bias, *, ln_scale, ln_bias, ln_eps=1e-6, heads,
    sm_scale, act_d=None, act_t=None, act_top=None, act_pow=False,
    out_d=None, out_t=None, out_top=None, out_pow=False, fmt="int8",
    wq_t=None,
) -> HeadsPlan:
    """K3's layer-side work, done once: checks, the qkv weight copy into
    the kernels' layout, the fold of attention.py:598-602 and the q
    pre-scale. Arguments as :func:`attention_heads` (``int_attention`` is
    chosen per launch); ``w_qkv`` must lie on a CUDA device. ``wq_t``:
    ``w_qkv`` already in the kernels' layout (:func:`~._build.n_major`;
    another plan's copy, or a buffer a gather fills), used instead of a
    copy."""
    d_model, three, head_dim = _heads_shapes(w_qkv, heads, fmt, act_top,
                                             out_top)
    _raise_if(heads_kernel_limit(head_dim))
    _build.require_cuda("attention_block", w_qkv)
    dev = w_qkv.device
    qkv_scale = torch.broadcast_to(_f32(qkv_scale, dev), (three,))
    qkv_bias = None if qkv_bias is None else _f32(qkv_bias, dev).contiguous()
    ln_scale, ln_bias = fold_ln(ln_scale, ln_bias, act_d, act_pow, dev)
    return HeadsPlan(
        wq_t=_build.n_major(w_qkv) if wq_t is None else wq_t,
        int4=fmt == "int4", d_model=d_model,
        heads=heads, head_dim=head_dim, qkv_scale=qkv_scale.contiguous(),
        qkv_bias=qkv_bias, ln_scale=ln_scale.contiguous(),
        ln_bias=ln_bias.contiguous(),
        prm=_params4(dev, act_d, act_t, out_d, out_t),
        # q pre-scale: the Python double product rounded to f32
        q_mul=_f32_value(sm_scale * _LOG2E), sm_scale=_f32_value(sm_scale),
        act_pow=bool(act_pow), out_pow=bool(out_pow), act_top=int(act_top),
        out_top=int(out_top), ln_eps=float(ln_eps))


def _heads_library():
    """K3's library, its entry point's C signature set on first use."""
    lib = _build.library("attention_block")
    if lib.qvt_attention_heads.argtypes is None:
        P, I, F = _build.P, _build.I, _build.F
        lib.qvt_attention_heads.argtypes = (
            [P, I, P, I] + [P] * 8 + [I] * 9 + [F, F] + [I] * 6 + [F, P])
        lib.qvt_attention_heads.restype = I
    return lib


def run_attention_heads(plan: HeadsPlan, x, *, n_valid=None,
                        out_dtype=torch.bfloat16, int_attention=False):
    """Launches K3 on ``x`` [B, N, D] for a prepared layer, at the query
    tile :func:`heads_tile_rows` picks for the card; returns the int8
    attention levels [B*N, H*hd]."""
    _build.require_cuda("attention_block", x)
    b, n = _heads_input(x, plan.d_model)
    rows = heads_tile_rows(b, n, plan.heads, plan.head_dim,
                           out_dtype.itemsize, *_card_shape(x.device.index))
    return _launch_attention_heads(plan, x, rows, n_valid=n_valid,
                                   out_dtype=out_dtype,
                                   int_attention=int_attention)


def _launch_attention_heads(plan: HeadsPlan, x, rows, *, n_valid=None,
                            out_dtype=torch.bfloat16, int_attention=False):
    """K3 at ``rows`` query rows an attention item on a checked CUDA ``x``:
    its two scratch tensors (the levels [B*N, Dp], Dp = D rounded up to
    64; q/k/v [B*N, 3*H*hd] in ``out_dtype``) and the launch itself,
    counted under ``attention_block``. ``chip_smoke.py`` calls it at tiles
    other than the picker's."""
    b, n, d = x.shape
    if n_valid is None:
        n_valid = n
    x = x.contiguous()
    hdim = plan.heads * plan.head_dim
    alv = torch.empty((b * n, hdim), dtype=torch.int8, device=x.device)
    if alv.numel() == 0:
        return alv
    dp = -(-d // 64) * 64
    lv = torch.empty((b * n, dp), dtype=torch.int8, device=x.device)
    qkv = torch.empty((b * n, 3 * hdim), dtype=out_dtype, device=x.device)
    code = _heads_library().qvt_attention_heads(
        x.data_ptr(), _build.dtype_code(x.dtype), plan.wq_t.data_ptr(),
        int(plan.int4), plan.qkv_scale.data_ptr(), _build.ptr(plan.qkv_bias),
        plan.ln_scale.data_ptr(), plan.ln_bias.data_ptr(),
        plan.prm.data_ptr(), lv.data_ptr(), qkv.data_ptr(), alv.data_ptr(),
        b, n, d, dp, plan.heads, plan.head_dim, n_valid,
        _n_keys(n, n_valid, out_dtype.itemsize), rows, plan.q_mul,
        plan.sm_scale, int(int_attention), _build.dtype_code(out_dtype),
        int(plan.act_pow), int(plan.out_pow), plan.act_top, plan.out_top,
        plan.ln_eps, _build.stream())
    _build.check(code, "attention_block")
    _build.count_launch("attention_block")
    return alv


def attention_heads(
    x, w_qkv, qkv_scale, qkv_bias, *, ln_scale, ln_bias, ln_eps=1e-6,
    heads, sm_scale, n_valid=None, act_d=None, act_t=None, act_top=None,
    act_pow=False, out_d=None, out_t=None, out_top=None, out_pow=False,
    fmt="int8", out_dtype=torch.bfloat16, int_attention=False,
):
    """K3's launch: LN + quant once per row, the qkv GEMM, then the
    attention and int8 quantization per (query tile, head, image), writing
    the attention levels [B*N, H*hd]. CPU tensors take
    :func:`attention_heads_plain`; CUDA tensors
    :func:`plan_attention_heads` then :func:`run_attention_heads`."""
    layer = dict(ln_scale=ln_scale, ln_bias=ln_bias, ln_eps=ln_eps,
                 heads=heads, sm_scale=sm_scale, act_d=act_d, act_t=act_t,
                 act_top=act_top, act_pow=act_pow, out_d=out_d, out_t=out_t,
                 out_top=out_top, out_pow=out_pow, fmt=fmt)
    run = dict(n_valid=n_valid, out_dtype=out_dtype,
               int_attention=int_attention)
    if x.device.type == "cpu":
        return attention_heads_plain(x, w_qkv, qkv_scale, qkv_bias, **run,
                                     **layer)
    return run_attention_heads(
        plan_attention_heads(w_qkv, qkv_scale, qkv_bias, **layer), x, **run)


def attention_block_plain(
    x, w_qkv, qkv_scale, qkv_bias, w_proj, proj_scale, proj_bias, *,
    fmt_proj=None, **kw,
):
    """Plain PyTorch version of K3 with its proj: the chain the TPU kernel
    replaces (bench.py:200-210) — :func:`attention_heads_plain`, then K1
    with the ``residual`` epilogue. Keywords as :func:`attention_block`."""
    fmt_proj = fmt_proj or kw.get("fmt", "int8")
    b, n, d_model = x.shape
    _check_proj(w_proj, fmt_proj, w_qkv.shape[1] // 3, d_model)
    alv = attention_heads_plain(x, w_qkv, qkv_scale, qkv_bias, **kw)
    out = fused_quant_matmul_plain(
        alv, w_proj, proj_scale, proj_bias, fmt=fmt_proj, prologue=None,
        epilogue="residual", residual=x.reshape(b * n, d_model),
        out_dtype=kw.get("out_dtype", torch.bfloat16))
    return out.reshape(b, n, d_model)


@dataclasses.dataclass(frozen=True)
class AttentionPlan:
    """A prepared attention branch: K3 (:class:`HeadsPlan`) and its proj
    (K1, :class:`~.fused.MatmulPlan`)."""

    heads: HeadsPlan
    proj: MatmulPlan


def plan_attention_block(w_qkv, qkv_scale, qkv_bias, w_proj, proj_scale,
                         proj_bias, *, fmt_proj=None, wq_t=None, wp_t=None,
                         **layer):
    """:func:`plan_attention_heads` and the proj's :func:`plan_matmul`
    (prologue None, residual epilogue). Keywords as
    :func:`attention_block`, without ``n_valid``/``out_dtype``; ``wq_t``
    / ``wp_t``: the weights already in the kernels' layout (as
    :func:`~.fused.plan_mlp`'s ``w1_t``/``w2_t``)."""
    fmt_proj = fmt_proj or layer.get("fmt", "int8")
    heads = plan_attention_heads(w_qkv, qkv_scale, qkv_bias, wq_t=wq_t,
                                 **layer)
    _check_proj(w_proj, fmt_proj, w_qkv.shape[1] // 3, heads.d_model)
    return AttentionPlan(heads=heads, proj=plan_matmul(
        w_proj, proj_scale, proj_bias, fmt=fmt_proj, prologue=None,
        epilogue="residual", w_t=wp_t))


def run_attention_block(plan: AttentionPlan, x, *, n_valid=None,
                        out_dtype=torch.bfloat16, int_attention=False):
    """``x + proj(attn(...))`` for a prepared branch: two launches."""
    b, n, d_model = x.shape
    alv = run_attention_heads(plan.heads, x, n_valid=n_valid,
                              out_dtype=out_dtype,
                              int_attention=int_attention)
    out = run_matmul(plan.proj, alv, residual=x.reshape(b * n, d_model),
                     out_dtype=out_dtype)
    return out.reshape(b, n, d_model)


def attention_block(
    x, w_qkv, qkv_scale, qkv_bias, w_proj, proj_scale, proj_bias, *,
    ln_scale, ln_bias, ln_eps=1e-6, heads, sm_scale, n_valid=None,
    act_d=None, act_t=None, act_top=None, act_pow=False,
    out_d=None, out_t=None, out_top=None, out_pow=False,
    fmt="int8", fmt_proj=None, out_dtype=torch.bfloat16,
    int_attention=False,
):
    """``x + proj(attn(qkv(quant(LN(x)))))``: K3 (:func:`attention_heads`)
    then K1 for proj, two launches.

    x: [B, N, D]; w_qkv: [D, 3*H*hd] int8 or packed int4 (``fmt``);
    w_proj: [H*hd, D] (``fmt_proj``, default ``fmt``). act_*: the qkv
    layer's input quantizer; out_*: the proj layer's input quantizer.
    ``out_dtype`` is the residual-stream (and qkv) dtype. Returns
    [B, N, D]. CPU tensors take :func:`attention_block_plain`; CUDA
    tensors :func:`plan_attention_block` then :func:`run_attention_block`.
    """
    layer = dict(ln_scale=ln_scale, ln_bias=ln_bias, ln_eps=ln_eps,
                 heads=heads, sm_scale=sm_scale, act_d=act_d, act_t=act_t,
                 act_top=act_top, act_pow=act_pow, out_d=out_d, out_t=out_t,
                 out_top=out_top, out_pow=out_pow, fmt=fmt)
    args = (w_qkv, qkv_scale, qkv_bias, w_proj, proj_scale, proj_bias)
    run = dict(n_valid=n_valid, out_dtype=out_dtype,
               int_attention=int_attention)
    if x.device.type == "cpu":
        return attention_block_plain(x, *args, fmt_proj=fmt_proj, **run,
                                     **layer)
    return run_attention_block(
        plan_attention_block(*args, fmt_proj=fmt_proj, **layer), x, **run)


# ---------------------------------------------------------------------------
# K6: attention on the raw fused-qkv tensor (the batch 1-3 chain)
# ---------------------------------------------------------------------------


# csrc/attention_qkv.cu: a block per (image, head, tile of QKV_ATTN_TILES
# query rows), K and V streaming through three buffers of 64 keys; the
# head_dim bound is 64 or 80 (one instantiation each)
QKV_ATTN_TILES = (64, 32, 16)
_QKV_ATTN_STATIC = 3 * 8 * 4 + 8 * 4  # the scale reduction, the scales


def qkv_attn_smem_bytes(rows: int, head_dim: int, itemsize: int = 2) -> int:
    """K6's shared memory a block at ``rows`` query rows, for heads of
    ``head_dim`` and a qkv dtype of ``itemsize`` bytes, as
    ``csrc/qkv_attention.cuh:qkv_attn_smem`` (plus its static arrays; the
    tile is shared with K3) computes it: q as f32, three chunks of 64 keys
    in the qkv dtype, the f32 p tile and the per-warp row partials. No
    token count enters: K and V stream in chunks."""
    hdm = 64 if head_dim <= 64 else 80
    return (4 * rows * (hdm + 4) + 3 * 64 * (hdm + 8) * itemsize
            + 4 * rows * (64 + 4) + 12 * 8 * rows + _QKV_ATTN_STATIC)


@functools.lru_cache(maxsize=None)
def qkv_attn_tile_rows(b: int, n: int, heads: int, head_dim: int,
                       itemsize: int = 2, sms: int = _H100_SMS,
                       sm_smem: int = _H100_SM_SMEM) -> int:
    """K6's query rows a block, one of :data:`QKV_ATTN_TILES` (0 where no
    tile fits), for ``b`` images of ``n`` tokens, ``heads`` heads of
    ``head_dim`` and a qkv dtype of ``itemsize`` bytes, on a card of
    ``sms`` SMs with ``sm_smem`` bytes of shared memory each (default the
    H100 SXM's). K13's rule (:func:`flash_tile_rows`): of the fitting
    tiles whose grid (ceil(n / R) x heads x b) gives every SM a block, the
    one that keeps the most query rows on an SM (R times the blocks an SM
    holds by shared memory, at most two); on a tie the smaller tile. Where
    no tile's grid fills the SMs, the smallest fitting tile. On the H100
    that is 32 at ViT-B/16 batch 2 (168 blocks; 64 rows give 96) and
    ViT-H/14 batch 1 (144), 64 at ViT-H/14 batch 2 (160) and ViT-B/16
    batch 32 (1,536)."""
    return _pick_tile(lambda r: qkv_attn_smem_bytes(r, head_dim, itemsize),
                      b, n, heads, sms, sm_smem)


def _pick_tile(smem, b, n, heads, sms, sm_smem) -> int:
    """The rule of K6's and K3's tile pickers, on a block's shared memory
    ``smem(rows)``: of the fitting tiles whose blocks or items give every
    SM one, the most query rows resident on an SM (at most two blocks an
    SM), on a tie the smaller tile; else the smallest fitting tile; 0
    where none fits."""
    def per_sm(r):
        return min(2, sm_smem // (smem(r) + 1024))

    fits = [r for r in QKV_ATTN_TILES
            if smem(r) <= SMEM_LIMIT and per_sm(r) >= 1]
    full = [r for r in fits if -(-n // r) * heads * b >= sms]
    if not full:
        return fits[-1] if fits else 0
    return max(full, key=lambda r: (r * per_sm(r), -r))


def qkv_kernel_limit(head_dim: int) -> Optional[str]:
    """Why K6 cannot take heads of ``head_dim``, or None if it can:
    head_dim <= 80, a multiple of 8. K and V stream in chunks, so any token
    count and either qkv dtype fit a block (at most 112,768 bytes, a 64-row
    f32 tile at head_dim 80: :func:`qkv_attn_smem_bytes`)."""
    return _check_head_dim("attention_qkv", head_dim)


def _qkv_head_dim(qkv_width, heads):
    """head_dim of a fused-qkv tensor of width 3*H*hd."""
    if qkv_width % (3 * heads):
        raise ValueError(f"qkv width {qkv_width} does not split into "
                         f"3 x {heads} heads")
    return qkv_width // (3 * heads)


def _check_out_top(out_d, out_top):
    # attention.py:796-808: a missing top would clip every level to 0
    if out_d is not None and not (out_top or 0) >= 1:
        raise ValueError("attention_qkv: out_d given but out_top is "
                         f"{out_top!r}; the quantize epilogue needs the "
                         "layer's positive top level")


@dataclasses.dataclass(frozen=True)
class QkvAttentionPlan:
    """One K6 call site, prepared once by :func:`plan_attention_qkv`: the
    proj quantizer's scalars on the device and the static options."""

    heads: int
    prm: torch.Tensor  # out_d, out_t (1.0 without a quantizer)
    quantize: bool
    out_pow: bool
    out_top: int
    q_mul: float
    sm_scale: float


def plan_attention_qkv(device, *, heads, sm_scale, out_d=None, out_t=None,
                       out_top=None, out_pow=False) -> QkvAttentionPlan:
    """K6's layer-side work, done once. Arguments as
    :func:`attention_qkv`; ``device`` is the CUDA device it launches on."""
    dev = torch.device(device)
    if dev.type != "cuda":
        raise ValueError(f"attention_qkv: the CUDA kernel needs a CUDA "
                         f"device, got {dev}")
    _check_out_top(out_d, out_top)
    return QkvAttentionPlan(
        heads=int(heads), prm=_params4(dev, out_d, out_t, None, None),
        quantize=out_d is not None, out_pow=bool(out_pow),
        out_top=int(out_top or 0), q_mul=_f32_value(sm_scale * _LOG2E),
        sm_scale=_f32_value(sm_scale))


def _qkv_library():
    """K6's library, its entry point's C signature set on first use."""
    lib = _build.library("attention_qkv")
    if lib.qvt_attention_qkv.argtypes is None:
        P, I, F = _build.P, _build.I, _build.F
        lib.qvt_attention_qkv.argtypes = [P, I, P, I, I, P, I, I, I, I, I,
                                          I, I, F, F, I, I, P]
        lib.qvt_attention_qkv.restype = I
    return lib


def run_attention_qkv(plan: QkvAttentionPlan, qkv, *, n_valid=None,
                      out_dtype=torch.bfloat16, int_attention=False):
    """Launches K6 on ``qkv`` [B, N, 3*H*hd] for a prepared call site, at
    the query tile :func:`qkv_attn_tile_rows` picks for the card; returns
    [B, N, H*hd]."""
    _build.require_cuda("attention_qkv", qkv)
    b, n, width = qkv.shape
    hd = _qkv_head_dim(width, plan.heads)
    _raise_if(qkv_kernel_limit(hd))
    rows = qkv_attn_tile_rows(b, n, plan.heads, hd, qkv.element_size(),
                              *_card_shape(qkv.device.index))
    return _launch_attention_qkv(plan, qkv, rows, n_valid=n_valid,
                                 out_dtype=out_dtype,
                                 int_attention=int_attention)


def _launch_attention_qkv(plan: QkvAttentionPlan, qkv, rows, *,
                          n_valid=None, out_dtype=torch.bfloat16,
                          int_attention=False):
    """K6 at ``rows`` query rows a block on a checked CUDA ``qkv``: the
    launch itself, counted under ``attention_qkv``. ``chip_smoke.py``
    calls it at tiles other than the picker's."""
    b, n, width = qkv.shape
    hd = width // (3 * plan.heads)
    if n_valid is None:
        n_valid = n
    qkv = qkv.contiguous()
    out = torch.empty((b, n, plan.heads * hd),
                      dtype=torch.int8 if plan.quantize else out_dtype,
                      device=qkv.device)
    if out.numel() == 0:
        return out
    mode = (2 if not plan.quantize else 1 if plan.out_pow else 0)
    code = _qkv_library().qvt_attention_qkv(
        qkv.data_ptr(), _build.dtype_code(qkv.dtype), out.data_ptr(),
        _build.dtype_code(out.dtype), mode, plan.prm.data_ptr(), b, n,
        plan.heads, hd, n_valid, _n_keys(n, n_valid, qkv.element_size()),
        rows, plan.q_mul, plan.sm_scale, int(int_attention), plan.out_top,
        _build.stream())
    _build.check(code, "attention_qkv")
    _build.count_launch("attention_qkv")
    return out


def attention_qkv(qkv, *, heads, sm_scale, n_valid=None, out_d=None,
                  out_t=None, out_top=None, out_pow=False,
                  out_dtype=torch.bfloat16, int_attention=False):
    """Multi-head attention on the raw fused-qkv layout (kernel K6).

    qkv: [B, N, (3, H, hd)] in the residual dtype. Returns [B, N, H*hd]:
    the proj layer's int8 levels with ``out_d``/``out_t``/``out_top``
    (``out_pow``: the pow quantizer), else floats in ``out_dtype``. CPU
    tensors take :func:`attention_qkv_plain`; CUDA tensors
    :func:`plan_attention_qkv` then :func:`run_attention_qkv`."""
    _qkv_head_dim(qkv.shape[-1], heads)
    _check_out_top(out_d, out_top)
    quant = dict(out_d=out_d, out_t=out_t, out_top=out_top, out_pow=out_pow)
    run = dict(n_valid=n_valid, out_dtype=out_dtype,
               int_attention=int_attention)
    if qkv.device.type == "cpu":
        return attention_qkv_plain(qkv, heads=heads, sm_scale=sm_scale,
                                   **quant, **run)
    _build.require_cuda("attention_qkv", qkv)  # before planning on it
    return run_attention_qkv(
        plan_attention_qkv(qkv.device, heads=heads, sm_scale=sm_scale,
                           **quant), qkv, **run)


# ---------------------------------------------------------------------------
# K9: attention + proj on the raw fused-qkv tensor, one launch
# ---------------------------------------------------------------------------


def _check_qkv_proj(w, fmt, hdim, residual, b, n):
    """The proj weight [H*hd(/2), D] against the heads and the residual
    [B, N, D] (attention.py:732-739); returns D."""
    d_out = w.shape[1]
    _check_proj(w, fmt, hdim, d_out)
    if tuple(residual.shape) != (b, n, d_out):
        raise ValueError(f"residual {tuple(residual.shape)} vs ({b}, {n}, "
                         f"{d_out})")
    return d_out


def attention_qkv_proj_plain(qkv, w, scale, bias, residual, *, heads,
                             sm_scale, n_valid=None, out_d=None, out_t=None,
                             out_top=None, out_pow=False, fmt="int8",
                             out_dtype=torch.bfloat16, int_attention=False):
    """Plain PyTorch version of K9: the pair the TPU kernel replaces
    (bench.py:173-185): :func:`attention_qkv_plain` with the proj
    quantizer's levels, then K1's plain version with the ``residual``
    epilogue. Arguments as :func:`attention_qkv_proj`."""
    b, n, width = qkv.shape
    hdim = _qkv_head_dim(width, heads) * heads
    d_out = _check_qkv_proj(w, fmt, hdim, residual, b, n)
    alv = attention_qkv_plain(
        qkv, heads=heads, sm_scale=sm_scale, n_valid=n_valid, out_d=out_d,
        out_t=1.0 if out_t is None else out_t, out_top=out_top,
        out_pow=out_pow, int_attention=int_attention)
    out = fused_quant_matmul_plain(
        alv.reshape(b * n, hdim), w, scale, bias, fmt=fmt, prologue=None,
        epilogue="residual", residual=residual.reshape(b * n, d_out),
        out_dtype=out_dtype)
    return out.reshape(b, n, d_out)


# csrc/attention_proj.cu: a cluster of G blocks (G | H, G <= 8) takes one
# (image, tile of QKV_PROJ_TILES query rows), each block H/G heads; the
# head_dim bound is 64 or 80 (one instantiation each)
QKV_PROJ_TILES = (32, 16)
QKV_PROJ_MAX_CLUSTER = 8  # the portable cluster size
_QKV_PROJ_WBUF = 256 * 80  # a weight chunk: 256 columns x 80 B
_QKV_PROJ_STATIC = 3 * 8 * 4 + 2 * 8 * 4  # the scale reduction, two heads'


def qkv_proj_smem_bytes(rows: int, head_dim: int, hdim: int,
                        itemsize: int = 2) -> int:
    """K9's shared memory a block at ``rows`` query rows, for heads of
    ``head_dim``, H*hd = ``hdim`` and a qkv dtype of ``itemsize`` bytes, as
    ``csrc/attention_proj.cu:smem_bytes`` (plus its static arrays) computes
    it: the int8 level tile [rows, round_up(hdim, 64) + 16], then the
    larger of the attention's space (q as f32; chunks of 64 keys, 32 at 16
    rows, in the qkv dtype, three in bf16 and two in f32; the f32 p tile
    and the per-warp row partials) and the proj's weight buffers (three,
    two at 16 rows). No token count enters: K and V stream in chunks."""
    kc = 64 if rows >= 32 else 32
    hdm = 64 if head_dim <= 64 else 80
    kvb = 3 if itemsize == 2 else 2
    attn = (4 * rows * (hdm + 4) + kvb * kc * (hdm + 8) * itemsize
            + 4 * rows * (kc + 4) + 12 * 8 * rows)
    weights = (3 if rows >= 32 else 2) * _QKV_PROJ_WBUF
    return (rows * (-(-hdim // 64) * 64 + 16) + max(attn, weights)
            + _QKV_PROJ_STATIC)


def qkv_proj_kernel_limit(heads: int, head_dim: int) -> Optional[str]:
    """Why K9 cannot take ``heads`` heads of ``head_dim``, or None if it
    can. Any token count and qkv dtype: the limit is head_dim <= 80 (a
    multiple of 8) and a 16-row tile's levels [16, H*hd] beside the weight
    buffers (H*hd up to 11,904; the tile's attention space, f32 or bf16,
    is smaller than those buffers)."""
    err = _check_head_dim("attention_qkv_proj", head_dim)
    if err:
        return err
    smem = qkv_proj_smem_bytes(16, head_dim, heads * head_dim, 4)
    if smem > SMEM_LIMIT:
        return (f"attention_qkv_proj kernel: {heads} heads of {head_dim} "
                f"need {smem} B of shared memory > {SMEM_LIMIT} (a 16-row "
                "tile's int8 levels of every head stay in one block)")
    return None


@functools.lru_cache(maxsize=None)
def qkv_proj_layout(b: int, n: int, heads: int, head_dim: int,
                    itemsize: int = 2, sms: int = _H100_SMS,
                    sm_smem: int = _H100_SM_SMEM):
    """K9's (query rows R a cluster, blocks G a cluster) for ``b`` images
    of ``n`` tokens, ``heads`` heads of ``head_dim`` and a qkv dtype of
    ``itemsize`` bytes, on a card of ``sms`` SMs with ``sm_smem`` bytes of
    shared memory each (default the H100 SXM's); (0, 0) where no tile
    fits.

    R: 32 where two such blocks fit an SM's shared memory, else the
    largest of :data:`QKV_PROJ_TILES` that fits (16 rows stream 32-key
    chunks, slower at every cluster size). G (G | H, G <=
    :data:`QKV_PROJ_MAX_CLUSTER`): the fewest heads a block walks in turn
    over the whole grid, waves x H/G, a wave being the blocks that many
    SMs hold (two at most); on a tie the smaller cluster. On the H100 that
    is G 8 at ViT-H/14 batch 8 (576 blocks of 2 heads) and G 1 at ViT-B/16
    batch 32 (224 blocks already fill the SMs; every G walks 12 heads a
    wave): the fastest layouts of ``tools/qkv_proj_design.py`` there."""
    hdim = heads * head_dim

    def smem(r):
        return qkv_proj_smem_bytes(r, head_dim, hdim, itemsize)

    def per_sm(r):
        return min(2, sm_smem // (smem(r) + 1024))

    fits = [r for r in QKV_PROJ_TILES
            if smem(r) <= SMEM_LIMIT and per_sm(r) >= 1]
    if not fits:
        return (0, 0)
    two = [r for r in fits if per_sm(r) >= 2]
    rows = (two or fits)[0]
    slots = sms * per_sm(rows)

    def walk(g):
        return -(-(-(-n // rows) * b * g) // slots) * (heads // g)

    g = min((g for g in range(1, QKV_PROJ_MAX_CLUSTER + 1)
             if heads % g == 0), key=lambda g: (walk(g), g))
    return (rows, g)


@dataclasses.dataclass(frozen=True)
class QkvProjPlan:
    """One K9 call site, prepared once by :func:`plan_attention_qkv_proj`:
    the proj weight in the kernels' layout, its scale [D] and bias, the
    proj quantizer's scalars on the device and the static options."""

    heads: int
    w_t: torch.Tensor
    int4: bool
    hdim: int
    d_out: int
    scale: torch.Tensor
    bias: Optional[torch.Tensor]
    prm: torch.Tensor  # out_d, out_t
    out_pow: bool
    out_top: int
    q_mul: float
    sm_scale: float


def _check_qkv_proj_top(out_top):
    # attention.py:695-704: the levels need the proj layer's positive top
    if not (out_top or 0) >= 1:
        raise ValueError("attention_qkv_proj: positive out_top required")


def plan_attention_qkv_proj(w, scale, bias=None, *, heads, sm_scale,
                            out_d, out_t=None, out_top, out_pow=False,
                            fmt="int8") -> QkvProjPlan:
    """K9's layer-side work, done once: the proj weight copy into the
    kernels' layout, scale and bias on the device, the quantizer's scalars.
    Arguments as :func:`attention_qkv_proj`; ``w`` must lie on a CUDA
    device."""
    _check_qkv_proj_top(out_top)
    if w.dtype != torch.int8:
        raise TypeError("attention_qkv_proj: w_proj must be int8-typed")
    _build.require_cuda("attention_qkv_proj", w)
    dev = w.device
    d_out = w.shape[1]
    hdim = w.shape[0] * (2 if fmt == "int4" else 1)
    if hdim % heads:
        raise ValueError(f"w_proj {tuple(w.shape)} ({fmt}) does not split "
                         f"into {heads} heads")
    _raise_if(qkv_proj_kernel_limit(heads, hdim // heads))
    return QkvProjPlan(
        heads=int(heads), w_t=_build.n_major(w), int4=fmt == "int4",
        hdim=hdim, d_out=d_out,
        scale=torch.broadcast_to(_f32(scale, dev), (d_out,)).contiguous(),
        bias=None if bias is None else _f32(bias, dev).contiguous(),
        prm=_params4(dev, out_d, 1.0 if out_t is None else out_t, None,
                     None),
        out_pow=bool(out_pow), out_top=int(out_top),
        q_mul=_f32_value(sm_scale * _LOG2E), sm_scale=_f32_value(sm_scale))


def _qkv_proj_library():
    """K9's library, its entry points' C signatures set on first use."""
    lib = _build.library("attention_proj")
    if lib.qvt_attention_qkv_proj.argtypes is None:
        P, I, F = _build.P, _build.I, _build.F
        lib.qvt_attention_qkv_proj.argtypes = [
            P, I, P, I, P, P, P, I, P, P, I, I, I, I, I, I, I, I, I, I, F, F,
            I, I, I, P]
        lib.qvt_attention_qkv_proj.restype = I
        lib.qvt_attention_qkv_proj_clusters.argtypes = [
            I, I, I, I, I, ctypes.POINTER(I)]
        lib.qvt_attention_qkv_proj_clusters.restype = I
    return lib


@functools.lru_cache(maxsize=None)
def qkv_proj_clusters(index: int, dtype_code: int, heads: int,
                      head_dim: int, rows: int, cluster: int) -> int:
    """The clusters of K9's layout (``rows``, ``cluster``) that CUDA device
    ``index`` holds at once (``cudaOccupancyMaxActiveClusters``)."""
    with torch.cuda.device(index):
        got = ctypes.c_int(0)
        _build.check(_qkv_proj_library().qvt_attention_qkv_proj_clusters(
            dtype_code, heads, head_dim, rows, cluster, ctypes.byref(got)),
            "attention_qkv_proj")
        return got.value


def _check_qkv_proj_cluster(qkv, heads, head_dim, rows, cluster):
    """Raises, naming the layout, where the card of ``qkv`` cannot
    schedule K9's cluster (nothing else is launched in its place)."""
    if not qkv_proj_clusters(qkv.device.index, _build.dtype_code(qkv.dtype),
                             heads, head_dim, rows, cluster):
        smem = qkv_proj_smem_bytes(rows, head_dim, heads * head_dim,
                                   qkv.element_size())
        raise ValueError(
            f"attention_qkv_proj kernel: a cluster of {cluster} blocks of "
            f"{rows} query rows ({smem} B of shared memory each) cannot be "
            "scheduled on this card")


def run_attention_qkv_proj(plan: QkvProjPlan, qkv, residual, *,
                           n_valid=None, out_dtype=torch.bfloat16,
                           int_attention=False):
    """Launches K9 on ``qkv`` [B, N, 3*H*hd] and ``residual`` [B, N, D]
    for a prepared call site, at the layout :func:`qkv_proj_layout`
    picks; returns the new residual stream [B, N, D]."""
    _build.require_cuda("attention_qkv_proj", qkv, residual)
    b, n, width = qkv.shape
    hd = _qkv_head_dim(width, plan.heads)
    if hd * plan.heads != plan.hdim:
        raise ValueError(f"qkv width {width} vs the proj weight's "
                         f"{plan.hdim} inputs")
    if tuple(residual.shape) != (b, n, plan.d_out):
        raise ValueError(f"residual {tuple(residual.shape)} vs ({b}, {n}, "
                         f"{plan.d_out})")
    rows, cluster = qkv_proj_layout(b, n, plan.heads, hd,
                                    qkv.element_size(),
                                    *_card_shape(qkv.device.index))
    _check_qkv_proj_cluster(qkv, plan.heads, hd, rows, cluster)
    return _launch_qkv_proj(plan, qkv, residual, rows, cluster,
                            n_valid=n_valid, out_dtype=out_dtype,
                            int_attention=int_attention)


def _launch_qkv_proj(plan: QkvProjPlan, qkv, residual, rows, cluster, *,
                     n_valid=None, out_dtype=torch.bfloat16,
                     int_attention=False):
    """K9 at the layout (``rows`` query rows, ``cluster`` blocks a
    cluster) on checked CUDA operands: the launch itself, counted under
    ``attention_qkv_proj``. The layout sweeps of
    ``tools/qkv_proj_design.py`` and ``chip_smoke.py`` call it with
    layouts other than the picker's."""
    b, n, _ = qkv.shape
    hd = plan.hdim // plan.heads
    if n_valid is None:
        n_valid = n
    qkv, residual = qkv.contiguous(), residual.contiguous()
    out = torch.empty((b, n, plan.d_out), dtype=out_dtype, device=qkv.device)
    if out.numel() == 0:
        return out
    code = _qkv_proj_library().qvt_attention_qkv_proj(
        qkv.data_ptr(), _build.dtype_code(qkv.dtype), plan.w_t.data_ptr(),
        int(plan.int4), plan.scale.data_ptr(), _build.ptr(plan.bias),
        residual.data_ptr(), _build.dtype_code(residual.dtype),
        plan.prm.data_ptr(), out.data_ptr(), _build.dtype_code(out_dtype),
        b, n, plan.heads, hd, plan.d_out, n_valid,
        _n_keys(n, n_valid, qkv.element_size()), rows, cluster, plan.q_mul,
        plan.sm_scale, int(int_attention), int(plan.out_pow), plan.out_top,
        _build.stream())
    _build.check(code, "attention_qkv_proj")
    _build.count_launch("attention_qkv_proj")
    return out


def attention_qkv_proj(qkv, w, scale, bias, residual, *, heads, sm_scale,
                       n_valid=None, out_d=None, out_t=None, out_top=None,
                       out_pow=False, fmt="int8", out_dtype=torch.bfloat16,
                       int_attention=False):
    """Attention on the raw fused-qkv tensor, quantized to the proj
    layer's int8 levels, then the proj GEMM + dequant + residual: one
    launch (kernel K9).

    qkv: [B, N, (3, H, hd)] in the residual dtype; w: the proj weight
    [H*hd, D] int8 levels or packed int4 [H*hd/2, D] (``fmt``); scale:
    scalar or [D]; bias: [D] or None; residual: [B, N, D]. out_*: the proj
    layer's input quantizer (``out_top`` a positive int). Returns the new
    residual stream [B, N, D] in ``out_dtype``. CPU tensors take
    :func:`attention_qkv_proj_plain`; CUDA tensors
    :func:`plan_attention_qkv_proj` then :func:`run_attention_qkv_proj`."""
    if out_top is not None and not isinstance(out_top, int):
        out_top = int(out_top)
    _check_qkv_proj_top(out_top)
    b, n, width = qkv.shape
    _check_qkv_proj(w, fmt, _qkv_head_dim(width, heads) * heads, residual,
                    b, n)
    quant = dict(out_d=out_d, out_t=out_t, out_top=out_top, out_pow=out_pow)
    run = dict(n_valid=n_valid, out_dtype=out_dtype,
               int_attention=int_attention)
    if qkv.device.type == "cpu":
        return attention_qkv_proj_plain(qkv, w, scale, bias, residual,
                                        heads=heads, sm_scale=sm_scale,
                                        fmt=fmt, **quant, **run)
    return run_attention_qkv_proj(
        plan_attention_qkv_proj(w, scale, bias, heads=heads,
                                sm_scale=sm_scale, fmt=fmt, **quant),
        qkv, residual, **run)


# ---------------------------------------------------------------------------
# K13: standalone attention on q/k/v [B, H, N, hd]
# ---------------------------------------------------------------------------


# csrc/flash_attention.cu pads head_dim to a bound of 64, 80 or 128 (one
# instantiation each) and takes a tile of FLASH_TILES query rows a block,
# with K and V streaming in chunks of FLASH_KEY_CHUNK keys
FLASH_MAX_HEAD_DIM = 128
FLASH_TILES = (64, 32, 16)
FLASH_KEY_CHUNK = 64
# a block's most shared memory (csrc/flash_attention.cu:SMEM_MAX); a
# block's 256 threads take at most 128 registers each
# (__launch_bounds__(256, 2)), so an SM holds at most two blocks
_SMEM_MAX = 232448


def flash_smem_bytes(qt: int, n: int, hd: int) -> int:
    """K13's shared memory at ``qt`` query rows a block, all f32: the
    tile's q rows (the head bound + 4 floats apart), two key chunks (+ 8)
    and the tile's score rows (round8(n) + 4), as
    ``csrc/flash_attention.cu:smem_bytes`` computes it."""
    hdm = 64 if hd <= 64 else 80 if hd <= 80 else 128
    lds = -(-n // 8) * 8 + 4
    return 4 * (qt * (hdm + 4) + 2 * FLASH_KEY_CHUNK * (hdm + 8) + qt * lds)


@functools.lru_cache(maxsize=None)
def flash_tile_rows(b: int, h: int, n: int, hd: int, sms: int = _H100_SMS,
                    sm_smem: int = _H100_SM_SMEM) -> int:
    """K13's query rows a block, one of :data:`FLASH_TILES` (0 where no
    tile fits in a block's shared memory), on a card of ``sms`` SMs with
    ``sm_smem`` bytes of shared memory each (default the H100 SXM's). Of
    the fitting tiles whose grid (ceil(n / qt) x h x b) gives every SM a
    block, the one that keeps the most query rows on an SM: qt times the
    blocks an SM holds by shared memory, at most two; on a tie the smaller
    tile, for its warps. Where no tile's grid fills the SMs, the smallest
    fitting tile (the most blocks). On the H100 at ViT-B/16 batch 32 that
    is 64 (two 106-KB blocks an SM); at ViT-H/14 batch 8 and 1 it is 32
    (a 64-row block takes 134 KB and sits alone)."""
    fits = [qt for qt in FLASH_TILES
            if flash_smem_bytes(qt, n, hd) <= _SMEM_MAX]
    full = [qt for qt in fits if -(-n // qt) * h * b >= sms]
    if not full:
        return fits[-1] if fits else 0

    def rows_per_sm(qt):
        return qt * min(2, sm_smem // (flash_smem_bytes(qt, n, hd) + 1024))

    return max(full, key=lambda qt: (rows_per_sm(qt), -qt))


def flash_kernel_limit(head_dim: int,
                       n_tokens: Optional[int] = None) -> Optional[str]:
    """Why K13 cannot take ``head_dim`` (or ``n_tokens`` tokens), or None
    if it can. head_dim <= 128; the tokens are bounded by a 16-row tile's
    f32 score rows beside the q tile and two key chunks in a block's
    shared memory: up to 2,984 tokens at head_dim <= 64, 2,840 at <= 80,
    2,408 at <= 128."""
    if head_dim > FLASH_MAX_HEAD_DIM:
        return (f"flash_attention kernel: head_dim {head_dim} > "
                f"{FLASH_MAX_HEAD_DIM}")
    if (n_tokens is not None
            and flash_smem_bytes(16, n_tokens, head_dim) > _SMEM_MAX):
        return (f"flash_attention kernel: {n_tokens} tokens at head_dim "
                f"{head_dim} need {flash_smem_bytes(16, n_tokens, head_dim)}"
                f" bytes of shared memory at 16 query rows (> {_SMEM_MAX})")
    return None


def _check_flash(q, k, v, out_d, out_top):
    """Shape and dtype checks of flash_attention (and the ``out_top``
    check of attention.py:65-76)."""
    if not (q.dim() == 4 and q.shape == k.shape == v.shape):
        raise ValueError(f"flash_attention: q/k/v must share one shape "
                         f"[B, H, N, hd], got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    for t in (q, k, v):
        if t.dtype not in (torch.float32, torch.bfloat16):
            raise TypeError(f"flash_attention: q/k/v must be f32 or bf16, "
                            f"got {t.dtype}")
    if out_d is not None and not (out_top or 0) >= 1:
        raise ValueError(
            "flash_attention: out_d given but out_top is "
            f"{out_top!r}; the quantize epilogue needs the layer's positive "
            "top level (QLayerArtifact.top)")


def flash_attention_plain(q, k, v, *, sm_scale, n_valid=None, out_d=None,
                          out_t=None, out_top=None, out_pow=False,
                          out_dtype=torch.bfloat16):
    """Plain PyTorch version of K13: a port of ``flash_attention_xla``
    (attention.py:950-969) with the TPU kernel's cast of p to v's dtype
    (attention.py:55; the XLA mirror casts to q's: ROADMAP.md, faults of
    the reference the port must not copy). The dots and the row sum
    accumulate in float64 and round once to f32."""
    n = q.shape[2]
    s = _dot_f32(q, k.transpose(-1, -2)) * _f32_value(sm_scale)
    if n_valid is not None and n_valid < n:
        col = torch.arange(n, device=q.device)
        s = torch.where(col < n_valid, s, torch.full_like(s, -1e30))
    s = s - s.amax(dim=-1, keepdim=True)
    p = torch.exp(s)
    p = p / sum_f32(p, -1)
    o = _dot_f32(p.to(v.dtype), v)
    if out_d is not None:
        dev = q.device
        return _quantize_f32(o, _f32(out_d, dev), _f32(out_t, dev), out_top,
                             out_pow)
    return o.to(out_dtype)


def _flash_library():
    """K13's library, its entry point's C signature set on first use."""
    lib = _build.library("flash_attention")
    if lib.qvt_flash_attention.argtypes is None:
        P, I, F = _build.P, _build.I, _build.F
        lib.qvt_flash_attention.argtypes = [P, I, P, I, P, I, P, I, P, I, I,
                                            I, I, I, I, F, I, I, P]
        lib.qvt_flash_attention.restype = I
    return lib


def run_flash_attention(q, k, v, *, sm_scale, n_valid=None, out_d=None,
                        out_t=None, out_top=None, out_pow=False,
                        out_dtype=torch.bfloat16):
    """Launches K13 on CUDA q/k/v [B, H, N, hd] (the only place that
    launches it) at :func:`flash_tile_rows`' tile for the card; arguments
    as :func:`flash_attention`."""
    _build.require_cuda("flash_attention", q, k, v)
    _check_flash(q, k, v, out_d, out_top)
    b, h, n, hd = q.shape
    _raise_if(flash_kernel_limit(hd, n))
    quantize = out_d is not None
    out = torch.empty((b, h, n, hd),
                      dtype=torch.int8 if quantize else out_dtype,
                      device=q.device)
    if out.numel() == 0:
        return out
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    prm = (_params4(q.device, out_d, out_t, None, None) if quantize
           else None)
    code = _flash_library().qvt_flash_attention(
        q.data_ptr(), _build.dtype_code(q.dtype), k.data_ptr(),
        _build.dtype_code(k.dtype), v.data_ptr(), _build.dtype_code(v.dtype),
        out.data_ptr(), _build.dtype_code(out.dtype), _build.ptr(prm), b, h,
        n, hd, n if n_valid is None else int(n_valid),
        flash_tile_rows(b, h, n, hd, *_card_shape(q.device.index)),
        _f32_value(sm_scale),
        int(out_top or 0), int(out_pow), _build.stream())
    _build.check(code, "flash_attention")
    _build.count_launch("flash_attention")
    return out


def flash_attention(q, k, v, *, sm_scale, n_valid=None, out_d=None,
                    out_t=None, out_top=None, out_pow=False,
                    out_dtype=torch.bfloat16):
    """softmax(q k^T * sm_scale) v per (image, head) (kernel K13).

    q/k/v: [B, H, N, hd], f32 or bf16 (each its own). ``n_valid``: the
    real token count (keys at or past it are masked; default all).
    ``out_d``/``out_t``/``out_top`` (``out_pow``: the pow quantizer): the
    output is quantized to int8 LSFQ levels; ``out_top`` must then be a
    positive int (a ValueError otherwise, as attention.py:65-76). Returns
    [B, H, N, hd] in ``out_dtype``, or int8. CPU tensors take
    :func:`flash_attention_plain`; CUDA tensors launch the kernel
    (:func:`run_flash_attention`)."""
    if out_top is not None and not isinstance(out_top, int):
        out_top = int(out_top)
    kw = dict(sm_scale=sm_scale, n_valid=n_valid, out_d=out_d, out_t=out_t,
              out_top=out_top, out_pow=out_pow, out_dtype=out_dtype)
    if q.device.type == "cpu":
        _check_flash(q, k, v, out_d, out_top)
        return flash_attention_plain(q, k, v, **kw)
    return run_flash_attention(q, k, v, **kw)

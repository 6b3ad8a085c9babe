"""The integer GEMMs (kernels K10-K12) and their plain versions.

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
masks its ragged edges instead (its weight copy is padded with zero
levels to whole TMA rows once, in the plan). The epilogue is
``acc.f32 * scale`` then ``+ bias`` (two roundings); ``requant_top``
rounds half to even and clips. ``block_m``/``block_n`` are the TPU
kernels' tile sizes: accepted, and the result does not depend on them;
the VMEM budget of ``_auto_blocks`` has no counterpart; the kernel's
work split is :func:`int_matmul_layout`'s. Each wrapper takes the plain
version only for CPU tensors; for CUDA tensors it plans
(:func:`plan_int_matmul`: the kernel's weight copy once, the constants on
the device) and launches (:func:`run_int_matmul`, which counts the launch
under the front end's name).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Optional

import numpy as np
import torch

from . import _build
from .fused import (_H100_SMS, _card_sms, _cdiv, _f32, _round_up,
                    _row_group, _split_counts, padded_n_major)
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


# K10-K12's kernel (csrc/int_matmul.cu): output features an item (two
# warpgroups of 64), weight bytes a ring step, threads a block, the token
# tiles built for each weight format, phase 1's row groups, the ring's
# stages at most, the dynamic shared memory a block may take, the
# epilogue's stage (two warpgroups x 32 tokens x 68 int32), phase 1's codes
INT_MM_ROWS = 128
INT_MM_BK = 128
INT_MM_THREADS = 288
INT_MM_NW = (64, 96, 128)
INT_MM_LN_GROUPS = (8, 16, 32)
INT_MM_MAX_STAGES = 8
INT_MM_SMEM = 231424
INT_MM_EPI_BYTES = 2 * 32 * 68 * 4
INT_MM_PRO = {None: 0, "copy": 1, "fa": 2}


def weight_depth(k: int, int4: bool) -> int:
    """The depth, in levels, of the kernel's weight copy of a [K, N]
    weight: K where its n-major rows are whole 16-byte TMA pieces of at
    least 128 bytes (packed int4: K/2 bytes), else the least depth that
    makes them so, zero levels past K."""
    if int4:
        return k if k % 32 == 0 and k >= 256 else max(256, _round_up(k, 32))
    return k if k % 16 == 0 and k >= 128 else max(128, _round_up(k, 16))


def kernel_weight(w, fmt: str, k: int, n: int):
    """The kernel's copy of weight ``w`` ([K, N] int8 or packed int4 [K/2,
    N]): n-major (``_build.n_major``), its depth :func:`weight_depth` (a
    packed weight unpacked, padded with zero levels and packed again at
    that depth, so the halves pair k' with depth/2 + k'), its rows rounded
    up to a multiple of 128 with zeros, so that no TMA box of 128 rows or
    bytes leaves it. Returns (the copy [Np, Wb] int8, its depth in
    levels)."""
    kw = weight_depth(k, fmt == "int4")
    w_t = padded_n_major(w, fmt, k, kw) if kw != k else _build.n_major(w)
    np_ = _round_up(n, INT_MM_ROWS)
    if np_ != n:
        w_t = torch.cat([w_t, w_t.new_zeros((np_ - n, w_t.shape[1]))])
    return w_t, kw


@dataclasses.dataclass(frozen=True)
class IntMatmulLayout:
    """K10-K12's work split for M rows of x [M, K] against a weight [K, N]
    (:func:`int_matmul_layout`): the weight format and its copy's depth
    ``kw``; phase 1 (None: x's int8 levels read in place; ``copy``: int8
    levels copied into the scratch; ``fa``: K12's quantizer into it) and
    its threads a row; the token tile ``nw`` (an item is 128 features x
    ``nw`` tokens); the tiles taken whole (``full``, the first ones) and
    the splits of the depth of each other tile; the ring's stages. Its
    methods enumerate the work items in the kernel's order
    (``csrc/int_matmul.cu``) and size its scratch and shared memory."""

    m: int
    k: int
    n: int
    int4: bool
    kw: int
    prologue: Optional[str]
    ln_threads: int
    nw: int
    full: int
    splits: int
    stages: int

    @property
    def wb(self) -> int:
        """Bytes of a row of the weight copy."""
        return self.kw // 2 if self.int4 else self.kw

    @property
    def steps(self) -> int:
        """The GEMM's 128-byte steps of a weight row (packed int4: each
        step two depth ranges of 128 levels)."""
        return _cdiv(self.wb, INT_MM_BK)

    @property
    def tn(self) -> int:
        """Feature tiles (128 output columns each)."""
        return _cdiv(self.n, INT_MM_ROWS)

    @property
    def tiles(self) -> int:
        return self.tn * _cdiv(self.m, self.nw)

    @property
    def split_tiles(self) -> int:
        return 0 if self.splits == 1 else self.tiles - self.full

    @property
    def rows(self) -> int:
        """Rows of the token buffer TMA reads: M, at least a token tile."""
        return max(self.m, self.nw)

    @property
    def stage_bytes(self) -> int:
        """A ring stage: the weight tile and one token tile a depth range
        (two with packed int4), 128 bytes a row."""
        return (INT_MM_ROWS + (2 if self.int4 else 1) * self.nw) * INT_MM_BK

    @property
    def smem_bytes(self) -> int:
        """The launch's dynamic shared memory: the 1024-byte alignment,
        the ring, a full and an empty barrier a stage at most, the
        epilogue's stage."""
        return (1024 + self.stages * self.stage_bytes
                + 16 * INT_MM_MAX_STAGES + INT_MM_EPI_BYTES)

    @property
    def row_items(self) -> int:
        """Phase 1's work items: groups of ``256 / ln_threads`` rows (the
        consumer threads), none without it."""
        if self.prologue is None:
            return 0
        return _cdiv(self.m, 256 // self.ln_threads)

    def items(self):
        """The GEMM's items in the kernel's order: (first feature, first
        token, first step, end step) of each tile taken whole, then of
        each split of the others."""
        s, nkt, tn = self.splits, self.steps, self.tn
        out = []
        for it in range(self.full + (self.tiles - self.full) * s):
            q = it - self.full
            tile = it if it < self.full else self.full + q // s
            sp = 0 if it < self.full else q - (tile - self.full) * s
            first = 0 if it < self.full else sp * nkt // s
            end = nkt if it < self.full else (sp + 1) * nkt // s
            out.append((tile % tn * INT_MM_ROWS, tile // tn * self.nw, first,
                        end))
        return out

    def scratch_bytes(self):
        """Bytes of each scratch: the levels [rows, kw] int8 (none when
        x is read in place) and the int32 partials, 128 x nw a split
        item."""
        return {"levels": 0 if self.prologue is None
                else self.rows * self.kw,
                "partials": 4 * self.split_tiles * self.splits
                * INT_MM_ROWS * self.nw}


def int_mm_stages(int4: bool, nw: int) -> int:
    """The ring's stages at token tile ``nw``: as many as fit the shared
    memory beside the epilogue's stage, at most
    :data:`INT_MM_MAX_STAGES`."""
    stage = (INT_MM_ROWS + (2 if int4 else 1) * nw) * INT_MM_BK
    return min(INT_MM_MAX_STAGES,
               (INT_MM_SMEM - 1024 - 16 * INT_MM_MAX_STAGES
                - INT_MM_EPI_BYTES) // stage)


# The picker's model of an item's time on an SM, fitted to the whole-tile
# and split layouts at ViT-B/16's four sites on an H100
# (tools/int_matmul_design.py; PERF.md): its steps' bytes from L2
# into shared memory at INT_MM_L2_BYTES_US, or its products at
# INT_MM_MACS_US where those take longer; its output bytes at
# INT_MM_OUT_BYTES_US (every SM storing at once shares the memory's rate);
# a split item's partial tile written and the others' read by the last
# to arrive at the L2 rate; INT_MM_ITEM_US more an item.
INT_MM_L2_BYTES_US = 74_000
INT_MM_MACS_US = 7_000_000
INT_MM_OUT_BYTES_US = 20_000
INT_MM_ITEM_US = 0.75


def _item_us(steps: int, nw: int, int4: bool, out_size: int,
             splits: int) -> float:
    r = 2 if int4 else 1
    loads = steps * (INT_MM_ROWS + r * nw) * INT_MM_BK / INT_MM_L2_BYTES_US
    macs = steps * INT_MM_ROWS * nw * INT_MM_BK * r / INT_MM_MACS_US
    t = max(loads, macs) + INT_MM_ROWS * nw * out_size / INT_MM_OUT_BYTES_US
    if splits > 1:
        t += splits * INT_MM_ROWS * nw * 4 / INT_MM_L2_BYTES_US
    return t + INT_MM_ITEM_US


def _makespan(lay: IntMatmulLayout, out_size: int, sms: int) -> float:
    """The model's time of the busiest block of ``lay`` (items dealt to
    the grid's blocks in turn)."""
    items = lay.items()
    grid = min(sms, len(items))
    busy = [0.0] * grid
    for i, (_, _, first, end) in enumerate(items):
        busy[i % grid] += _item_us(end - first, lay.nw, lay.int4, out_size,
                                   1 if i < lay.full or lay.splits == 1
                                   else lay.splits)
    return max(busy)


@functools.lru_cache(maxsize=None)
def int_matmul_layout(m: int, k: int, n: int, int4: bool = True,
                      x_itemsize: int = 1, x_aligned: bool = True,
                      out_size: int = 4,
                      sms: int = _H100_SMS) -> IntMatmulLayout:
    """K10-K12's work split at ``m`` rows of x [m, k] (int8 levels when
    ``x_itemsize`` is 1, ``x_aligned``: 16-byte aligned; else a float x
    for K12) against a weight [k, n] (packed int4 or int8), out of
    ``out_size`` bytes an element, on a card of ``sms`` SMs, one block an
    SM:

    - phase 1: K12's quantizer for a float x; none where TMA reads x's
      levels in place (aligned, K the weight copy's depth, M at least a
      token tile), else a copy; its threads a row K8's (K2's rule at most
      32);
    - the token tile and the split of the depth: of every token tile, and
      every split (whole waves of tiles whole and the rest split, or every
      tile split), the one whose busiest block the model
      (:func:`_makespan`) finishes first, ties to the larger tile and the
      fewer splits;
    - the ring: as many stages as fit (:func:`int_mm_stages`)."""
    kw = weight_depth(k, int4)
    steps = _cdiv(kw // 2 if int4 else kw, INT_MM_BK)
    best = None
    for nw in sorted(INT_MM_NW, reverse=True):
        tiles = _cdiv(n, INT_MM_ROWS) * _cdiv(m, nw)
        cands = {(tiles, 1)}
        for s in range(2, min(steps, 16) + 1):
            cands.add((0, s))
            if tiles % sms:
                cands.add((tiles - tiles % sms, s))
        for full, s in sorted(cands, key=lambda c: (c[1], -c[0])):
            lay = IntMatmulLayout(m, k, n, int4, kw, None, 8, nw, full, s,
                                  int_mm_stages(int4, nw))
            t = _makespan(lay, out_size, sms)
            if best is None or t < best[0] * (1 - 1e-9):
                best = (t, lay)
    lay = best[1]
    if x_itemsize != 1:
        pro = "fa"
    elif x_aligned and k == kw and m >= lay.nw:
        pro = None
    else:
        pro = "copy"
    ln = min(INT_MM_LN_GROUPS[-1], _row_group(m, k * x_itemsize, sms))
    return dataclasses.replace(lay, prologue=pro, ln_threads=ln)


def int_matmul_variant(layout: IntMatmulLayout, nw: int, splits: int = 1,
                       full: Optional[int] = None) -> IntMatmulLayout:
    """``layout`` at token tile ``nw`` with the depth of its tiles in
    ``splits`` (``full``: the tiles taken whole, the first ones, at most
    all; all of them when ``splits`` is 1, else none unless given), the
    ring resized;
    x's levels read in place are copied instead where M is below the
    tile. For the design tool and ``chip_smoke.py``'s layout rows."""
    tiles = _cdiv(layout.n, INT_MM_ROWS) * _cdiv(layout.m, nw)
    full = tiles if splits == 1 else min(tiles, full or 0)
    pro = layout.prologue
    if pro is None and layout.m < nw:
        pro = "copy"
    return dataclasses.replace(layout, nw=nw, full=full, splits=splits,
                               stages=int_mm_stages(layout.int4, nw),
                               prologue=pro)


@dataclasses.dataclass(frozen=True)
class IntMatmulPlan:
    """One call site of K10-K12, prepared once by :func:`plan_int_matmul`:
    the kernel's weight copy (:func:`kernel_weight`; ``kw`` its depth),
    scale [N] and bias on the device, the quantizer scalars ``prm`` = [d,
    t] (1.0 for int8 levels, never read) and, for the float front end
    (``fa``), its clamp level ``top`` (int32 on the device). ``launches``:
    the kernel's host state of each layout it has launched at (the
    weight's tensor map, the ring, the grid), made once
    (:func:`_int_mm_state`)."""

    w_t: torch.Tensor
    int4: bool
    k: int
    n: int
    kw: int
    scale: torch.Tensor
    bias: Optional[torch.Tensor]
    prm: torch.Tensor
    top: Optional[torch.Tensor]
    act_pow: bool
    fa: bool
    launches: dict = dataclasses.field(default_factory=dict, repr=False,
                                       compare=False)

    @property
    def kernel(self) -> str:
        """The launch counter: the JAX function this call site replaces."""
        if self.fa:
            return "quant_matmul_fa"
        return "int4_matmul" if self.int4 else "int8_matmul"


def plan_int_matmul(w, scale, bias=None, *, fmt="int4", act_d=None,
                    act_t=None, act_top=None, act_pow=False) -> IntMatmulPlan:
    """The layer-side work of K10-K12, done once: the weight copy into the
    kernel's layout (:func:`kernel_weight`), the constants on the device.
    ``act_d``/``act_t``/``act_top`` make it a :func:`quant_matmul_fa` site
    (float x); without them x is int8 levels. ``w`` must lie on a CUDA
    device."""
    k, n = _k_of(w, fmt)
    if w.dtype != torch.int8:
        raise TypeError("int8 or packed int4 weights must be int8-typed")
    _build.require_cuda("int_matmul", w)
    dev = w.device
    fa = act_d is not None
    top = None
    if fa:
        if not isinstance(act_top, torch.Tensor) and np.ndim(act_top) == 0:
            top = torch.full((1,), int(act_top), dtype=torch.int32,
                             device=dev)
        else:
            top = torch.as_tensor(act_top, device=dev).to(
                torch.int32).reshape(1)
    prm = torch.stack([_f32(act_d if fa else 1.0, dev).reshape(()),
                       _f32(1.0 if act_t is None else act_t,
                            dev).reshape(())])
    scale = torch.broadcast_to(_f32(scale, dev), (n,)).contiguous()
    bias = None if bias is None else _f32(bias, dev).contiguous()
    w_t, kw = kernel_weight(w, fmt, k, n)
    return IntMatmulPlan(w_t=w_t, int4=fmt == "int4", k=k, n=n, kw=kw,
                         scale=scale, bias=bias, prm=prm, top=top,
                         act_pow=bool(act_pow), fa=fa)


def _library():
    """The kernel's library, its entry points' C signatures set on first
    use."""
    lib = _build.library("int_matmul")
    if lib.qvt_int_matmul.argtypes is None:
        P, I = _build.P, _build.I
        lib.qvt_int_mm_state_bytes.argtypes = []
        lib.qvt_int_mm_state_bytes.restype = I
        lib.qvt_int_mm_prepare.argtypes = [P, P] + [I] * 12
        lib.qvt_int_mm_prepare.restype = I
        lib.qvt_int_matmul.argtypes = [P, P, I] + [P] * 7 + [P, I, I, I, I, P]
        lib.qvt_int_matmul.restype = I
    return lib


def _int_mm_state(plan: IntMatmulPlan, layout: IntMatmulLayout, lib):
    """The kernel's host state for ``plan`` at ``layout`` (the weight's
    tensor map, the ring, the grid), made on first use and kept in the
    plan."""
    state = plan.launches.get(layout)
    if state is None:
        if (layout.k, layout.n, layout.int4, layout.kw) != (
                plan.k, plan.n, plan.int4, plan.kw):
            raise ValueError(f"layout {layout} does not fit the plan")
        state = ctypes.create_string_buffer(lib.qvt_int_mm_state_bytes())
        code = lib.qvt_int_mm_prepare(
            ctypes.addressof(state), plan.w_t.data_ptr(), int(plan.int4),
            plan.w_t.shape[1], plan.w_t.shape[0], layout.m, plan.k, plan.n,
            INT_MM_PRO[layout.prologue], layout.ln_threads, layout.nw,
            layout.full, layout.splits, layout.stages)
        _build.check(code, plan.kernel)
        plan.launches[layout] = state
    return state


def run_int_matmul(plan: IntMatmulPlan, x, *, out_dtype=torch.float32,
                   requant_top=None):
    """Launches the GEMM on ``x`` [M, K] for a prepared site at the work
    split :func:`int_matmul_layout` picks for the card (through
    :func:`_launch_int_matmul`, the one launch site). ``x`` is int8
    levels, or f32/bf16 for a :func:`quant_matmul_fa` site."""
    name = plan.kernel
    _build.require_cuda(name, x)
    _check_k(x, plan.k)
    if plan.fa != (x.dtype != torch.int8):
        raise TypeError(f"{name}: x of dtype {x.dtype} does not fit this "
                        "site (int8 levels, or a float x for "
                        "quant_matmul_fa)")
    x = x.contiguous()
    out_size = 1 if requant_top is not None else (
        2 if out_dtype == torch.bfloat16 else 4)
    layout = int_matmul_layout(
        x.shape[0], plan.k, plan.n, plan.int4, x.element_size(),
        x.data_ptr() % 16 == 0, out_size, _card_sms(x.device.index))
    return _launch_int_matmul(plan, x, layout, out_dtype=out_dtype,
                              requant_top=requant_top)


def _launch_int_matmul(plan: IntMatmulPlan, x, layout: IntMatmulLayout, *,
                       out_dtype=torch.float32, requant_top=None):
    """The kernel at ``layout`` on a checked, contiguous CUDA ``x``: its
    scratch (one byte buffer: the levels, then the int32 partials, each
    16-byte aligned), the split tiles' arrival counts (K1's,
    ``fused._split_counts``) and the launch itself, counted under the
    site's front end: the only place that launches it.
    ``chip_smoke.py`` and ``tools/int_matmul_design.py`` call it at
    layouts other than the picker's."""
    name = plan.kernel
    m = x.shape[0]
    # the kernel writes f32, bf16 or requantized int8; any other dtype is
    # its f32 output cast, as the JAX wrappers cast (int4_matmul.py:104,
    # :296)
    kernel_dtype = (torch.int8 if requant_top is not None else out_dtype
                    if out_dtype in (torch.float32, torch.bfloat16)
                    else torch.float32)
    out = torch.empty((m, plan.n), device=x.device, dtype=kernel_dtype)
    if out.numel() == 0:
        return out if requant_top is not None else out.to(out_dtype)
    if layout.m != m:
        raise ValueError(f"layout for {layout.m} rows, x has {m}")
    lib = _library()
    state = _int_mm_state(plan, layout, lib)
    sizes = [_round_up(v, 16) for v in layout.scratch_bytes().values()]
    lv = part = cnt = None
    if sum(sizes):
        scratch = torch.empty((sum(sizes),), dtype=torch.uint8,
                              device=x.device)
        lv = scratch.data_ptr() if sizes[0] else None
        part = scratch.data_ptr() + sizes[0] if sizes[1] else None
    stream = _build.stream()
    if layout.splits > 1:
        cnt = _split_counts(x.device, stream, layout.split_tiles).data_ptr()
    code = lib.qvt_int_matmul(
        ctypes.addressof(state), x.data_ptr(), _build.dtype_code(x.dtype),
        plan.scale.data_ptr(), _build.ptr(plan.bias), plan.prm.data_ptr(),
        _build.ptr(plan.top), lv, part, cnt, out.data_ptr(),
        _build.dtype_code(out.dtype), int(requant_top is not None),
        int(requant_top or 0), int(plan.act_pow), stream)
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

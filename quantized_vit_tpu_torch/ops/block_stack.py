"""Whole-depth block stack in one launch (kernel K5), for batch-1 latency.

Port of ``quantized_vit_tpu/ops/block_stack.py``. :func:`vit_block_stack`
replaces ``_vit_block_stack`` (``pallas_call`` at block_stack.py:341): the
residual stream ``x [j*n, D]`` through ``depth`` transformer blocks, each
with its own stacked weights and per-layer quantizer scalars, in one
kernel launch (``csrc/block_stack.cu``: a persistent cooperative grid, one
block an SM, its GEMMs on ``wgmma`` fed by a TMA ring, its attention on
K6's tile, five grid barriers a transformer block).

The operands are those of the JAX function: weights stacked along a
leading depth axis ([L, K(/2), N], int8 or packed int4), per-block
scale/bias/LayerNorm rows [L, N] (or [L, 1, N]) and per-layer quantizer
scalars [L]. LN1 gamma/beta carry 1/act_d when ``act_pow`` is False, LN2's
1/mlp_d when ``mlp_pow`` is False, and s1/b1 carry 2**-0.5 when
``hid_pow`` is False: the folds of ``fused.fold_ln``/``fused.fold_gelu``
(``serve/vit_int4.py:prepare_latency_artifact`` applies them). As
elsewhere, a call splits into the layer side made once
(:func:`plan_block_stack`: the weights stacked n-major, the kernel's
copies of them on its tiles, the vectors in one buffer, the scalars on
the device) and the launch (:func:`run_block_stack`, at the work split
:func:`stack_layout` picks).

:func:`vit_block_stack_plain` is the plain version the CPU runs and K5 is
held to: a loop over the depth of the per-block plain versions,
:func:`~.attention.attention_block_plain` and
:func:`~.fused.fused_mlp_plain`, fed each block's folded operands from the
plan (``prefolded``: they apply no fold a second time).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Dict, Optional, Tuple

import torch

from . import _build
from .attention import (MAX_HEAD_DIM, _H100_SMS, _LOG2E, _card_shape,
                        _f32_value, _n_keys, attention_block_plain)
from .fused import _f32, fused_mlp_plain

MAX_IMAGES = 4  # j_imgs, as the TPU kernel takes it

# the per-block vectors, in the order of K5's one f32 buffer
_VECS = ("qs", "qb", "l1g", "l1b", "ps", "pb", "l2g", "l2b", "s1", "b1",
         "s2", "b2")
# the per-layer quantizer scalars, the columns of the [L, 8] prm array
_SCALARS = ("act_d", "act_t", "out_d", "out_t", "mlp_d", "mlp_t", "hid_d",
            "hid_t")

# csrc/block_stack.cu: the weight rows a warpgroup (the wgmma M), the
# depth of a ring stage in bytes, the threads a block (two consumer
# warpgroups and the producer warp), the weight rows of an item in each
# GEMM phase (qkv, proj, fc1, fc2: proj's and fc2's warpgroups split the
# depth of one 64-row tile), the wgmma N it instantiates (proj's and
# fc2's at most 64: their epilogues hold residuals beside the
# accumulators), the attention's query tiles, the ring's stages at most,
# the shared memory a block may take and what the ring leaves of it (the
# 1024-byte alignment, static memory), and proj's and fc2's exchange of
# half their sums
STACK_ROWS = 64
STACK_BK = 128
STACK_THREADS = 288
STACK_WR = (2 * STACK_ROWS, STACK_ROWS, 2 * STACK_ROWS, STACK_ROWS)
STACK_NW = (32, 64, 128)
STACK_NW_SHARED = (32, 64)
STACK_ATT_TILES = (32, 16)
STACK_MAX_STAGES = 16
STACK_SMEM = 232448
STACK_SMEM_SLACK = 2048
STACK_XCHG = 2 * (STACK_NW_SHARED[-1] // 4) * 128 * 4
# the ring's bytes the picker aims at: the shared memory a launch leaves
# is the SM's L1 cache, which holds the kernel's register spills
STACK_RING = 131072


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _round_up(a: int, b: int) -> int:
    return _cdiv(a, b) * b


def stack_kernel_limit(d_model: int, hid: int, head_dim: int,
                       attn_width: Optional[int] = None) -> Optional[str]:
    """Why K5 cannot take this geometry, or None if it can: head_dim a
    multiple of 8 up to K6's tile's 80, and rows of 16 bytes for TMA (the
    widths D, H*hd = ``attn_width`` (default D) and hidden multiples of
    16). No token count and no width bound: K and V stream in chunks, the
    GEMMs cut features x tokens, LayerNorm takes a warp a row. The
    cooperative grid's residency is checked at launch."""
    if head_dim > MAX_HEAD_DIM or head_dim % 8:
        return (f"block_stack kernel: head_dim {head_dim} must be a "
                f"multiple of 8 and <= {MAX_HEAD_DIM}")
    width = d_model if attn_width is None else attn_width
    if d_model % 16 or width % 16 or hid % 16:
        return (f"block_stack kernel: widths D={d_model}, heads x head_dim"
                f"={width} and hidden {hid} must be multiples of 16 (rows "
                "of 16-byte pieces for its TMA copies)")
    return None


def stack_row_bytes(k: int, int4: bool) -> int:
    """Bytes of a K5 weight row of depth ``k`` (the plan's copies): int8 k
    rounded up to 128; packed int4 k rounded up to 256, halved, so the
    high nibbles' depth offset is a whole number of 128-byte steps."""
    return _round_up(k, 2 * STACK_BK) // 2 if int4 else _round_up(
        k, STACK_BK)


def _stack_stage(wr: int, nw: int, int4: bool) -> int:
    """A phase's ring stage: ``wr`` weight rows and a chunk's token tiles
    (two depth ranges with packed int4), 128 bytes a row."""
    return (wr + (2 if int4 else 1) * nw) * STACK_BK


def _stack_split(m: int, rows: int, wr: int, sms: int, nws):
    """(nc, nw, g) of a K5 GEMM phase of ``rows`` weight rows in items of
    ``wr`` at ``m`` token rows on ``sms`` SMs: K8's one-wave rule
    (``fused.py:_chunked_split``) with one token chunk an item, the most
    chunks whose items still take one wave (at least those that keep a
    chunk within the widest N of ``nws``, at most those that keep it 8
    rows or more)."""
    g_min = _cdiv(m, nws[-1])
    g = max(g_min, min(sms // _cdiv(rows, wr), _cdiv(m, 8)))
    nc = _round_up(_cdiv(m, g), 8)
    return nc, next(v for v in nws if v >= nc), _cdiv(m, nc)


def stack_att_smem(rows: int, head_dim: int, itemsize: int) -> int:
    """The attention tile's dynamic shared memory at ``rows`` query rows
    (``csrc/qkv_attention.cuh:qkv_attn_smem``, K6's and K3's)."""
    hdm = 64 if head_dim <= 64 else 80
    return (4 * rows * (hdm + 4) + 3 * 64 * (hdm + 8) * itemsize
            + 4 * rows * (64 + 4) + 12 * 8 * rows)


@dataclasses.dataclass(frozen=True)
class StackLayout:
    """K5's work split (:func:`stack_layout`) for ``j_imgs`` images of
    ``n`` rows (M = j n) at widths D, H*hd (``hdim``) and hidden, weights
    packed int4 or int8, a residual stream of ``itemsize`` bytes: query
    rows an attention item; per GEMM phase (qkv,
    proj, fc1, fc2) the token rows of a chunk (``nc``), the wgmma N it
    runs at (``nw`` >= nc) and the token groups (``g``); the ring's
    stages. A qkv or fc1 item is 128 features, each consumer warpgroup
    64 of them, against one token chunk; a proj or fc2 item 64 features,
    the warpgroups splitting the depth, against one chunk
    (:data:`STACK_WR`). Its methods enumerate each phase's items in the
    kernel's order (``csrc/block_stack.cu``) and size its scratch and
    shared memory."""

    m: int
    d: int
    hdim: int
    hid: int
    int4: bool
    itemsize: int
    j_imgs: int
    heads: int
    head_dim: int
    att_rows: int
    nc: Tuple[int, int, int, int]
    nw: Tuple[int, int, int, int]
    g: Tuple[int, int, int, int]
    stages: int

    @property
    def n(self) -> int:
        return self.m // self.j_imgs

    def widths(self, phase: int):
        """(output features, depth) of GEMM phase ``phase`` (0: qkv, 1:
        proj, 2: fc1, 3: fc2)."""
        return ((3 * self.hdim, self.d), (self.d, self.hdim),
                (self.hid, self.d), (self.d, self.hid))[phase]

    def row_bytes(self, phase: int) -> int:
        """Bytes of a row of the phase's weight copy
        (:func:`stack_row_bytes`)."""
        return stack_row_bytes(self.widths(phase)[1], self.int4)

    def steps(self, phase: int) -> int:
        """The phase's 128-byte ring steps an item."""
        return self.row_bytes(phase) // STACK_BK

    @property
    def stage_bytes(self) -> int:
        """A ring stage: the largest phase's weight and token tiles."""
        return max(_stack_stage(STACK_WR[p], self.nw[p], self.int4)
                   for p in range(4))

    @property
    def att_smem(self) -> int:
        return stack_att_smem(self.att_rows, self.head_dim, self.itemsize)

    @property
    def smem_bytes(self) -> int:
        """The launch's dynamic shared memory: the 1024-byte alignment,
        the ring or the attention tile (they share the bytes), proj's and
        fc2's exchange, a full and an empty barrier a stage."""
        return (1024 + _round_up(max(self.stages * self.stage_bytes,
                                     self.att_smem), 16)
                + STACK_XCHG + 16 * STACK_MAX_STAGES)

    def items(self, phase: int):
        """Phase ``phase``'s items in the kernel's order, each its output
        tiles (first weight row, first token, tokens): a qkv or fc1 item
        the two warpgroups' (tokens <= 0: no work), a proj or fc2 item the
        one both compute."""
        rows = self.widths(phase)[0]
        wr, nc, g = STACK_WR[phase], self.nc[phase], self.g[phase]
        out = []
        for it in range(_cdiv(rows, wr) * g):
            rt, q = divmod(it, g)
            cnt = min(nc, self.m - q * nc)
            out.append([(r0, q * nc, cnt if r0 < rows else 0)
                        for r0 in range(rt * wr, (rt + 1) * wr, STACK_ROWS)])
        return out

    @property
    def att_items(self) -> int:
        """The attention's (image, head, query tile) items."""
        return _cdiv(self.n, self.att_rows) * self.heads * self.j_imgs

    def l2_bytes(self, phase: int) -> int:
        """The bytes phase ``phase``'s items load into shared memory (from
        L2) a transformer block: each item's weight tiles and token tiles
        (both depth ranges with packed int4) over the depth, once each
        where the two warpgroups share one."""
        nc, kt = self.nc[phase], 2 if self.int4 else 1
        total = 0
        for tiles in self.items(phase):
            live = sum(t[2] > 0 for t in tiles)
            total += self.steps(phase) * STACK_BK * (
                live * STACK_ROWS + kt * nc)
        return total

    @property
    def groups(self) -> int:
        """The arrival counts: proj's (and fc2's) token groups."""
        return self.g[1]

    def scratch_bytes(self) -> int:
        """Bytes of the launch's scratch (``csrc/block_stack.cu:
        scratch_layout``, 256-byte pieces): x2 and q/k/v in the residual
        dtype, the levels, attention levels and hidden levels, the
        arrival counts."""
        m, e = self.m, self.itemsize
        sizes = (m * self.d * e, m * 3 * self.hdim * e, m * self.d,
                 m * self.hdim, m * self.hid, 4 * self.groups)
        return sum(_round_up(v, 256) for v in sizes)

    def grid(self, sms: int = _H100_SMS) -> int:
        """The blocks of the launch on a card of ``sms`` SMs: enough for
        its largest phase, one an SM (``qvt_block_stack_prepare``)."""
        return min(sms, max([self.att_items]
                            + [len(self.items(p)) for p in range(4)]))


def stack_stages(stage_bytes: int) -> int:
    """K5's ring stages of ``stage_bytes`` each: as many as fill
    :data:`STACK_RING` bytes, at least 3 (and as many as fit the shared
    memory), at most :data:`STACK_MAX_STAGES`."""
    fit = (STACK_SMEM - STACK_SMEM_SLACK - 16 * STACK_MAX_STAGES) \
        // stage_bytes
    return min(STACK_MAX_STAGES, fit, max(3, STACK_RING // stage_bytes))


@functools.lru_cache(maxsize=None)
def stack_layout(m: int, d: int, hdim: int, hid: int, int4: bool,
                 itemsize: int = 2, j_imgs: int = 1, heads: int = 12,
                 head_dim: int = 64, sms: int = _H100_SMS) -> StackLayout:
    """K5's work split at ``m`` = ``j_imgs`` x n token rows, widths ``d``,
    ``hdim`` (heads x head_dim) and ``hid``, on a card of ``sms`` SMs:

    - each GEMM phase: :func:`_stack_split` at K5's wgmma N
      (:data:`STACK_NW`; :data:`STACK_NW_SHARED` for proj and fc2), items
      of :data:`STACK_WR` features;
    - the attention: of :data:`STACK_ATT_TILES`, the fewest query rows
      a block takes in all (its waves of items x the tile's rows), on a
      tie the larger tile (K/V read fewer times);
    - the ring: :func:`stack_stages`.

    At ViT-B/16 batch 1 (208 rows, int4, bf16): qkv 18 items x 7 groups
    of 32 rows (N 32), proj and fc2 12 x 9 groups of 2 x 16 (N 32), fc1
    24 x 5 groups of 48 (N 64), attention 32 rows (84 items, one wave;
    16 rows take two waves of 156); at 384 px (592 rows) 32 rows (228
    items)."""
    splits = [_stack_split(m, rows, STACK_WR[p], sms,
                           STACK_NW_SHARED if p % 2 else STACK_NW)
              for p, rows in enumerate((3 * hdim, d, hid, d))]
    n = m // j_imgs
    att = min(STACK_ATT_TILES, key=lambda r: (
        _cdiv(_cdiv(n, r) * heads * j_imgs, sms) * r, -r))
    stage = max(_stack_stage(STACK_WR[p], s[1], int4)
                for p, s in enumerate(splits))
    return StackLayout(m, d, hdim, hid, bool(int4), itemsize, j_imgs, heads,
                       head_dim, att, tuple(s[0] for s in splits),
                       tuple(s[1] for s in splits),
                       tuple(s[2] for s in splits), stack_stages(stage))


def _stack_copy(w_t: torch.Tensor, n: int, k: int,
                int4: bool) -> torch.Tensor:
    """An n-major weight stack ``w_t`` [L, N, K(/2)] as K5's tensor maps
    read it: [L, N rounded up to 64, :func:`stack_row_bytes`] with zero
    levels in the padding, packed int4 unpacked and packed again at the
    padded depth (it pairs k with k + depth / 2); ``w_t`` itself where it
    already has that shape (every ViT width)."""
    from ..quant.packing import pack_int4, unpack_int4

    shape = (w_t.shape[0], _round_up(n, STACK_ROWS), stack_row_bytes(k, int4))
    if tuple(w_t.shape) == shape:
        return w_t
    lv = unpack_int4(w_t, axis=2) if int4 else w_t
    out = lv.new_zeros(shape[:2] + (2 * shape[2] if int4 else shape[2],))
    out[:, :n, :k] = lv
    return pack_int4(out, axis=2) if int4 else out


@dataclasses.dataclass(frozen=True)
class StackPlan:
    """A prepared block stack (:func:`plan_block_stack`): the weights
    stacked n-major ([L, N, K] or packed [L, N, K/2], the plain version's),
    the kernel's copies of them (``kern``: qkv, proj, fc1, fc2, each
    :func:`_stack_copy`), the per-block vectors as views of one f32
    buffer, the [L, 8] quantizer scalars, the static options."""

    wq_t: torch.Tensor
    wp_t: torch.Tensor
    w1_t: torch.Tensor
    w2_t: torch.Tensor
    kern: Tuple[torch.Tensor, ...]
    vecs: torch.Tensor
    vec: Dict[str, torch.Tensor]
    prm: torch.Tensor
    int4: bool
    depth: int
    d_model: int
    heads: int
    head_dim: int
    hid: int
    sm_scale: float
    q_mul: float
    act_pow: bool
    out_pow: bool
    mlp_pow: bool
    hid_pow: bool
    act_top: int
    out_top: int
    mlp_top: int
    hid_top: int
    ln_eps: float
    # per (layout, key rows, stream): the host state of the launches (the
    # tensor maps, the grid) and their scratch (_launch_block_stack)
    launch: Dict[tuple, tuple] = dataclasses.field(
        default_factory=dict, compare=False, repr=False)


def _tops(kw):
    # vit_block_stack (block_stack.py:210-218): positive static tops
    for k in ("act_top", "out_top", "mlp_top", "hid_top"):
        if not (kw.get(k) or 0) >= 1:
            raise ValueError(f"vit_block_stack: positive {k} required")
    return {k: int(kw[k]) for k in ("act_top", "out_top", "mlp_top",
                                    "hid_top")}


def plan_block_stack(wq, qs, qb, ln1_g, ln1_b, wp, ps, pb, ln2_g, ln2_b,
                     w1, s1, b1, w2, s2, b2, act_d, act_t, out_d, out_t,
                     mlp_d, mlp_t, hid_d, hid_t, *, heads, sm_scale,
                     fmt="int4", act_pow=False, out_pow=False, mlp_pow=False,
                     hid_pow=False, act_top=127, out_top=127, mlp_top=127,
                     hid_top=127, ln_eps=1e-6) -> StackPlan:
    """K5's layer-side work, done once: checks, the n-major weight stacks
    and the kernel's copies, the vectors in one buffer, the scalars on the
    device. Operands as :func:`vit_block_stack`. Works on any device (the
    plain version runs from the plan too)."""
    tops = _tops(dict(act_top=act_top, out_top=out_top, mlp_top=mlp_top,
                      hid_top=hid_top))
    if fmt not in ("int4", "int8"):
        raise ValueError(f"unknown weight format {fmt!r}")
    int4 = fmt == "int4"
    f = 2 if int4 else 1
    depth, d_model, three = wq.shape[0], wq.shape[1] * f, wq.shape[2]
    hid = w1.shape[2]
    if three % (3 * heads):
        raise ValueError(f"w_qkv width {three} does not split into "
                         f"{heads} heads")
    hdim = three // 3
    shapes = {"wp": (tuple(wp.shape), (depth, hdim // f, d_model)),
              "w1": (tuple(w1.shape), (depth, d_model // f, hid)),
              "w2": (tuple(w2.shape), (depth, hid // f, d_model))}
    for name, (got, want) in shapes.items():
        if got != want:
            raise ValueError(f"{name} {got} vs {want} ({fmt})")
    # packed int4 w2 pairs hidden rows h and h + hid/2
    # (block_stack.py:290-297)
    if int4 and (hid % 2 or hdim % 2 or d_model % 2):
        raise ValueError("packed int4 weights need even K widths")
    dev = wq.device
    widths = {"qs": three, "qb": three, "l1g": d_model, "l1b": d_model,
              "ps": d_model, "pb": d_model, "l2g": d_model, "l2b": d_model,
              "s1": hid, "b1": hid, "s2": d_model, "b2": d_model}
    vals = dict(zip(_VECS, (qs, qb, ln1_g, ln1_b, ps, pb, ln2_g, ln2_b, s1,
                            b1, s2, b2)))
    rows = [torch.broadcast_to(_f32(vals[k], dev).reshape(depth, -1),
                               (depth, widths[k])).reshape(-1)
            for k in _VECS]
    vecs = torch.cat(rows)
    vec, off = {}, 0
    for k in _VECS:
        vec[k] = vecs[off:off + depth * widths[k]].reshape(depth, widths[k])
        off += depth * widths[k]
    prm = torch.stack([_f32(v, dev).reshape(depth) for v in (
        act_d, act_t, out_d, out_t, mlp_d, mlp_t, hid_d, hid_t)], dim=1)
    w_t = [_build.n_major(w) for w in (wq, wp, w1, w2)]
    kern = tuple(_stack_copy(w, n, k, int4) for w, (n, k) in zip(
        w_t, ((three, d_model), (d_model, hdim), (hid, d_model),
              (d_model, hid))))
    return StackPlan(
        wq_t=w_t[0], wp_t=w_t[1], w1_t=w_t[2], w2_t=w_t[3], kern=kern,
        vecs=vecs, vec=vec, prm=prm.contiguous(), int4=int4, depth=depth,
        d_model=d_model, heads=int(heads), head_dim=hdim // heads, hid=hid,
        sm_scale=float(sm_scale), q_mul=_f32_value(sm_scale * _LOG2E),
        act_pow=bool(act_pow), out_pow=bool(out_pow),
        mlp_pow=bool(mlp_pow), hid_pow=bool(hid_pow), ln_eps=float(ln_eps),
        **tops)


def _stack_input(plan: StackPlan, x, n_valid, j_imgs):
    """(rows per image, n_valid) of x [j*n, D]; checks the images."""
    if not 1 <= j_imgs <= MAX_IMAGES:
        raise ValueError(f"vit_block_stack: j_imgs {j_imgs} not in "
                         f"1..{MAX_IMAGES}")
    r, d = x.shape
    if d != plan.d_model or r % j_imgs:
        raise ValueError(f"x {tuple(x.shape)} vs {j_imgs} images of width "
                         f"{plan.d_model}")
    n = r // j_imgs
    return n, n if n_valid is None else n_valid


def vit_block_stack_plain(plan: StackPlan, x, *, n_valid=None,
                          out_dtype=torch.bfloat16, j_imgs=1):
    """Plain PyTorch version of K5 on a prepared stack: per block,
    :func:`~.attention.attention_block_plain` then
    :func:`~.fused.fused_mlp_plain` on that block's operands in the plan
    (the weights viewed back to [K(/2), N]; the constants carry the folds
    already, ``prefolded``)."""
    n, n_valid = _stack_input(plan, x, n_valid, j_imgs)
    r, d = x.shape
    fmt = "int4" if plan.int4 else "int8"
    x = x.to(out_dtype)
    for i in range(plan.depth):
        v = {k: t[i] for k, t in plan.vec.items()}
        p = dict(zip(_SCALARS, plan.prm[i]))
        x = attention_block_plain(
            x.reshape(j_imgs, n, d), plan.wq_t[i].t(), v["qs"], v["qb"],
            plan.wp_t[i].t(), v["ps"], v["pb"], ln_scale=v["l1g"],
            ln_bias=v["l1b"], ln_eps=plan.ln_eps, heads=plan.heads,
            sm_scale=plan.sm_scale, n_valid=n_valid, act_d=p["act_d"],
            act_t=p["act_t"], act_top=plan.act_top, act_pow=plan.act_pow,
            out_d=p["out_d"], out_t=p["out_t"], out_top=plan.out_top,
            out_pow=plan.out_pow, fmt=fmt, out_dtype=out_dtype,
            prefolded=True).reshape(r, d)
        x = fused_mlp_plain(
            x, plan.w1_t[i].t(), v["s1"], v["b1"], plan.w2_t[i].t(),
            v["s2"], v["b2"], ln_scale=v["l2g"], ln_bias=v["l2b"],
            ln_eps=plan.ln_eps, act_d=p["mlp_d"], act_t=p["mlp_t"],
            act_top=plan.mlp_top, act_pow=plan.mlp_pow, hid_d=p["hid_d"],
            hid_t=p["hid_t"], hid_top=plan.hid_top, hid_pow=plan.hid_pow,
            fmt=fmt, out_dtype=out_dtype, prefolded=True)
    return x


def _library():
    """K5's library, its entry points' C signatures set on first use."""
    lib = _build.library("block_stack")
    if lib.qvt_block_stack.argtypes is None:
        P, I, F = _build.P, _build.I, _build.F
        lib.qvt_block_stack_state_bytes.argtypes = []
        lib.qvt_block_stack_state_bytes.restype = I
        lib.qvt_block_stack_scratch_bytes.argtypes = [P]
        lib.qvt_block_stack_scratch_bytes.restype = _build.LL
        lib.qvt_block_stack_prepare.argtypes = [P] * 7
        lib.qvt_block_stack_prepare.restype = I
        lib.qvt_block_stack.argtypes = [P] * 6 + [I, F] + [I] * 8 + [F, P]
        lib.qvt_block_stack.restype = I
    return lib


def stack_layout_for(plan: StackPlan, x, j_imgs: int) -> StackLayout:
    """:func:`stack_layout` for a launch of ``plan`` on ``x`` (on its
    card)."""
    return stack_layout(x.shape[0], plan.d_model, plan.heads * plan.head_dim,
                        plan.hid, plan.int4, x.element_size(), j_imgs,
                        plan.heads, plan.head_dim,
                        _card_shape(x.device.index)[0])


def _launch_state(plan: StackPlan, layout: StackLayout, nk: int, x):
    """(host state, scratch) of launches at ``layout`` and ``nk`` key rows
    on the current stream: the tensor maps of the weights, the ring and
    the grid, made once and kept on the plan, and the scratch (its
    arrival counts zeroed once: every launch leaves them zero; launches on
    one stream run in order, so they share it)."""
    stream = _build.stream()
    key = (layout, nk, stream)
    got = plan.launch.get(key)
    if got is None:
        lib = _library()
        state = ctypes.create_string_buffer(lib.qvt_block_stack_state_bytes())
        geo = [plan.depth, layout.j_imgs, layout.n, nk, plan.d_model,
               plan.heads, plan.head_dim, plan.hid,
               _build.dtype_code(x.dtype), int(plan.int4)]
        for w in plan.kern:
            geo += [w.shape[1], w.shape[2]]
        lay = [layout.att_rows, layout.stages]
        for p in range(4):
            lay += [layout.nc[p], layout.nw[p], layout.g[p]]
        geo_c = (ctypes.c_int * len(geo))(*geo)
        lay_c = (ctypes.c_int * len(lay))(*lay)
        code = lib.qvt_block_stack_prepare(
            ctypes.addressof(state), *(w.data_ptr() for w in plan.kern),
            ctypes.addressof(geo_c), ctypes.addressof(lay_c))
        _build.check(code, "block_stack")
        scratch = torch.zeros(
            (lib.qvt_block_stack_scratch_bytes(ctypes.addressof(state)),),
            dtype=torch.uint8, device=x.device)
        got = plan.launch[key] = (state, scratch)
    return got


def _launch_block_stack(plan: StackPlan, x, layout: StackLayout, *,
                        n_valid: int, nk: int):
    """K5 at ``layout`` on a checked, contiguous CUDA ``x`` in the residual
    dtype: the launch itself, counted under ``block_stack``: the only
    place that launches it. ``chip_smoke.py`` calls it at layouts other
    than the picker's."""
    out = torch.empty_like(x)
    if out.numel() == 0:
        return out
    state, scratch = _launch_state(plan, layout, nk, x)
    code = _library().qvt_block_stack(
        ctypes.addressof(state), x.data_ptr(), out.data_ptr(),
        plan.vecs.data_ptr(), plan.prm.data_ptr(), scratch.data_ptr(),
        n_valid, plan.q_mul, int(plan.act_pow), int(plan.out_pow),
        int(plan.mlp_pow), int(plan.hid_pow), plan.act_top, plan.out_top,
        plan.mlp_top, plan.hid_top, plan.ln_eps, _build.stream())
    _build.check(code, "block_stack")
    _build.count_launch("block_stack")
    return out


def run_block_stack(plan: StackPlan, x, *, n_valid=None,
                    out_dtype=torch.bfloat16, j_imgs=1):
    """Launches K5 on ``x`` [j*n, D] for a prepared stack at the work
    split :func:`stack_layout` picks for the card: one cooperative launch
    for the whole depth. Returns the residual stream after the last block,
    [j*n, D]."""
    _build.require_cuda("block_stack", x, plan.wq_t)
    n, n_valid = _stack_input(plan, x, n_valid, j_imgs)
    item = out_dtype.itemsize
    limit = stack_kernel_limit(plan.d_model, plan.hid, plan.head_dim,
                               attn_width=plan.heads * plan.head_dim)
    if limit:
        raise ValueError(limit)
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"block_stack kernel: residual dtype {out_dtype} "
                         "is not bf16 or f32")
    x = x.to(out_dtype).contiguous()
    return _launch_block_stack(plan, x, stack_layout_for(plan, x, j_imgs),
                               n_valid=n_valid,
                               nk=_n_keys(n, n_valid, item))


def vit_block_stack(x, wq, qs, qb, ln1_g, ln1_b, wp, ps, pb, ln2_g, ln2_b,
                    w1, s1, b1, w2, s2, b2, act_d, act_t, out_d, out_t,
                    mlp_d, mlp_t, hid_d, hid_t, *, heads, sm_scale,
                    n_valid=None, fmt="int4", act_pow=False, out_pow=False,
                    mlp_pow=False, hid_pow=False, act_top=127, out_top=127,
                    mlp_top=127, hid_top=127, ln_eps=1e-6,
                    out_dtype=torch.bfloat16, j_imgs=1):
    """The whole block stack (kernel K5; operands as the JAX
    ``vit_block_stack``, block_stack.py:248-262): x [j_imgs*n, D] token
    rows -> the residual stream after the last block, ``out_dtype``. CPU
    tensors take :func:`vit_block_stack_plain`; CUDA tensors
    :func:`plan_block_stack` then :func:`run_block_stack` (a caller that
    runs the stack repeatedly keeps the plan)."""
    plan = plan_block_stack(
        wq, qs, qb, ln1_g, ln1_b, wp, ps, pb, ln2_g, ln2_b, w1, s1, b1, w2,
        s2, b2, act_d, act_t, out_d, out_t, mlp_d, mlp_t, hid_d, hid_t,
        heads=heads, sm_scale=sm_scale, fmt=fmt, act_pow=act_pow,
        out_pow=out_pow, mlp_pow=mlp_pow, hid_pow=hid_pow, act_top=act_top,
        out_top=out_top, mlp_top=mlp_top, hid_top=hid_top, ln_eps=ln_eps)
    run = dict(n_valid=n_valid, out_dtype=out_dtype, j_imgs=j_imgs)
    if x.device.type == "cpu":
        return vit_block_stack_plain(plan, x, **run)
    return run_block_stack(plan, x, **run)

"""K10-K12's work split (``ops/int4_matmul.py:int_matmul_layout``), which
the CUDA kernel ``csrc/int_matmul.cu`` launches at: its constants against
the source; the work items covering every output once, their splits
partitioning the depth, at ViT-B/16's four layer shapes (M = 1664) for
each front end and at ragged shapes, on the H100's 132 SMs and smaller
cards; a mirror of the kernel's arithmetic (packed int4 halves as two
depth ranges of the token levels, split int32 partials summed by the last
split, the two-rounding epilogue) bit-equal to the plain versions; K12's
scratch levels equal to ``fa_levels``, at a constructed rounding tie
where ``x * (1/d)`` (K1's quant prologue) rounds apart from ``x / d``;
and the plan's padded weight copy. No JAX: the plain versions are held to
the JAX package in ``tests/test_torch_int_matmul.py``."""

import importlib
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from quantized_vit_tpu_torch.ops import fused as F
from quantized_vit_tpu_torch.ops.int4_matmul import (
    INT_MM_BK, INT_MM_EPI_BYTES, INT_MM_LN_GROUPS, INT_MM_MAX_STAGES,
    INT_MM_NW, INT_MM_PRO, INT_MM_ROWS, INT_MM_SMEM, INT_MM_THREADS,
    fa_levels, int4_matmul_plain, int8_matmul_plain, int_matmul_layout,
    int_matmul_variant, int_mm_stages, kernel_weight, weight_depth)
from quantized_vit_tpu_torch.quant import pack_int4, unpack_int4

# the module (``ops.int4_matmul`` is also a function of the package)
M = importlib.import_module("quantized_vit_tpu_torch.ops.int4_matmul")

torch.set_num_threads(1)

CSRC = Path(F.__file__).resolve().parent.parent / "csrc"
SMS = 132

# ViT-B/16's four layer shapes at M = 8 images x 208 padded tokens
# (tools/profile_kernels.py): name -> (M, K, N)
SITES = {"qkv": (1664, 768, 2304), "proj": (1664, 768, 768),
         "fc1": (1664, 768, 3072), "fc2": (1664, 3072, 768)}
# the three front ends: (int4 weights, x itemsize, out itemsize)
FRONTS = {"int4_matmul": (True, 1, 4), "int8_matmul": (False, 1, 4),
          "quant_matmul_fa": (True, 2, 2)}
SITE_CASES = [(s, f) for s in SITES for f in FRONTS]
# ragged shapes: (M, K, N, int4, x itemsize, x aligned)
RAGGED = [(50, 96, 72, True, 1, True), (50, 96, 72, False, 4, True),
          (197, 768, 768, True, 1, True), (7, 768, 2304, False, 1, True),
          (50, 40, 130, True, 2, True), (300, 200, 257, False, 1, True),
          (1664, 768, 768, False, 1, False), (1, 16, 4, True, 1, True),
          (8192, 3072, 768, True, 1, True), (208, 3072, 768, False, 1, True)]


def _ints(text, names):
    """The integer constants ``names`` of ``constexpr int`` declarations
    and enums (literal values only)."""
    env = {}
    for decl in re.findall(r"(?:constexpr int|enum \{)([^;}]+)[;}]", text):
        for part in decl.split(","):
            name, _, expr = part.partition("=")
            name, expr = name.strip(), expr.strip()
            if re.fullmatch(r"\d+", expr):
                env[name] = int(expr)
    return [env[n] for n in names]


def test_layout_constants_match_the_source():
    """The item's features, the ring step, the threads, phase 1's row
    groups, the stages, the shared memory, the epilogue's stage and the
    phase-1 codes are the kernel's; the token tiles are the instances
    ``kernel_of`` dispatches to; K12's quantizer is row_levels' ROWS_FA,
    the true division."""
    src = (CSRC / "int_matmul.cu").read_text()
    rows, wg_rows, bk, cwg, ln_min, ln_max, stages, smem, epi_t = _ints(
        src, ("ROWS", "WG_ROWS", "BK", "CWG", "LN_MIN_T", "LN_MAX_T",
              "MAX_STAGES", "SMEM_DYN", "EPI_T"))
    assert rows == INT_MM_ROWS == 2 * wg_rows and bk == INT_MM_BK
    assert "CT = 128 * CWG" in src and "NT = CT + 32" in src
    assert INT_MM_THREADS == 128 * cwg + 32
    assert (ln_min, ln_max) == (INT_MM_LN_GROUPS[0], INT_MM_LN_GROUPS[-1])
    assert stages == INT_MM_MAX_STAGES and smem == INT_MM_SMEM
    assert "EPI_RS = WG_ROWS + 4" in src
    assert INT_MM_EPI_BYTES == cwg * epi_t * (wg_rows + 4) * 4
    pro = _ints(src, ("PRO_NONE", "PRO_COPY", "PRO_FA"))
    assert pro == [INT_MM_PRO[p] for p in (None, "copy", "fa")]
    built = {(int(nw), w4 == "true") for nw, w4 in re.findall(
        r"return int_mm_kernel<(\d+), (true|false)>", src)}
    assert built == {(nw, w4) for w4 in (False, True) for nw in INT_MM_NW}
    # each token tile's wgmma shape, the header's or the kernel's own
    wg = (CSRC / "wgmma_int8.cuh").read_text() + src
    for nw in INT_MM_NW:
        assert f"m64n{nw}k32.s32.s8.s8" in wg
        assert re.search(rf"struct Mma<{nw}>", wg)
        assert re.search(rf"struct MmaR<{nw}>", wg)
    assert "qvt::row_levels<qvt::ROWS_FA, true, CT>" in src
    assert "qvt::row_levels<qvt::ROWS_COPY, false, CT>" in src
    common = (CSRC / "qvt_common.cuh").read_text()
    fa = common[common.index("int8_t fa_quant("):]
    assert "rintf(p / d)" in fa[:fa.index("}")]
    phases = (CSRC / "gemm_phases.cuh").read_text()
    assert "PRO == ROWS_FA" in phases and "ROWS_FA = 4" in phases


def _layout(m, k, n, int4, x_size, out_size=4, aligned=True, sms=SMS):
    return int_matmul_layout(m, k, n, int4, x_size, aligned, out_size, sms)


def _covers_once(lay):
    """Every [M, N] output in one item's tile, taken whole or in splits
    that take each 128-byte step of the weight rows once; the scratch, the
    ring and phase 1 as the kernel takes them."""
    m, n, nw = lay.m, lay.n, lay.nw
    steps = {}
    for f0, t0, first, end in lay.items():
        assert 0 <= first < end <= lay.steps
        assert f0 % INT_MM_ROWS == 0 and t0 % nw == 0
        assert f0 < n and t0 < m
        steps.setdefault((f0, t0), []).append((first, end))
    out = np.zeros((m, n), np.uint8)
    for (f0, t0), ranges in steps.items():
        ranges.sort()
        assert ranges[0][0] == 0 and ranges[-1][1] == lay.steps
        assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
        assert len(ranges) in (1, lay.splits)
        out[t0:t0 + nw, f0:f0 + INT_MM_ROWS] += 1
    assert (out == 1).all()
    whole = sum(len(v) == 1 for v in steps.values())
    assert whole == (lay.full if lay.splits > 1 else lay.tiles)
    assert 1 <= lay.splits <= lay.steps
    assert lay.nw in INT_MM_NW
    assert 2 <= lay.stages <= INT_MM_MAX_STAGES
    assert lay.stages == int_mm_stages(lay.int4, lay.nw)
    assert lay.smem_bytes <= INT_MM_SMEM
    assert lay.smem_bytes + lay.stage_bytes > INT_MM_SMEM or (
        lay.stages == INT_MM_MAX_STAGES)
    assert lay.kw == weight_depth(lay.k, lay.int4) >= lay.k
    sizes = lay.scratch_bytes()
    assert sizes["levels"] == (0 if lay.prologue is None
                               else max(m, nw) * lay.kw)
    assert sizes["partials"] == (4 * INT_MM_ROWS * nw * lay.splits
                                 * (lay.tiles - lay.full)
                                 if lay.splits > 1 else 0)
    if lay.prologue is None:  # x's levels read in place by TMA
        assert lay.k == lay.kw and m >= nw
    if lay.prologue is not None:
        per_block = 256 // lay.ln_threads
        assert lay.ln_threads in INT_MM_LN_GROUPS
        assert lay.row_items * per_block >= m > (lay.row_items - 1) * (
            per_block)


@pytest.mark.parametrize("site,front", SITE_CASES)
@pytest.mark.parametrize("sms", [SMS, 114, 66, 16])
def test_layout_covers_each_site_once(site, front, sms):
    """At each of the twelve sites, on the H100 and smaller cards: every
    output once, the depth split exactly, whole waves of items where the
    depth is split (no block runs a whole tile more than another), x's
    int8 levels read in place where aligned (no phase 1), K12's
    quantizer otherwise."""
    m, k, n = SITES[site]
    int4, xs, os_ = FRONTS[front]
    lay = _layout(m, k, n, int4, xs, os_, sms=sms)
    _covers_once(lay)
    assert lay.prologue == ("fa" if front == "quant_matmul_fa" else None)
    if lay.splits > 1:
        assert lay.full % sms == 0


@pytest.mark.parametrize("case", RAGGED)
def test_layout_covers_ragged_shapes_once(case):
    """Ragged M, K and N, K off the 16-byte TMA rows (a padded weight
    copy, the levels copied into the scratch), x off a 16-byte boundary,
    M below a token tile, and a deep K."""
    m, k, n, int4, xs, aligned = case
    lay = _layout(m, k, n, int4, xs, aligned=aligned)
    _covers_once(lay)
    if xs != 1:
        assert lay.prologue == "fa"
    elif not aligned or k != weight_depth(k, int4) or m < lay.nw:
        assert lay.prologue == "copy"


@pytest.mark.parametrize("nw_split", [(64, 1, None), (96, 1, None),
                                      (128, 1, None), (128, 2, 0),
                                      (64, 3, 132), (96, 4, 132),
                                      (128, 6, 0), (64, 12, 0)])
def test_layout_variants_cover_once(nw_split):
    """The design tool's and chip_smoke's layouts (any token tile, the
    depth split every tile or after whole waves) cover every output
    once."""
    nw, s, full = nw_split
    for int4 in (False, True):
        m, k, n = SITES["fc2"]
        lay = int_matmul_variant(_layout(m, k, n, int4, 1), nw, s, full)
        _covers_once(lay)
        if s > 1:
            assert lay.full == min(lay.tiles, full or 0)


# deep weights at few tiles: ViT-B/16's fc2 at batch 1 (208 rows, 12
# tiles of 128 x 128) and ViT-H/14's at batch 1 (272 rows)
DEEP = {"vitb_fc2_b1": (208, 3072, 768), "vith_fc2_b1": (272, 5120, 1280)}


@pytest.mark.parametrize("sms", [SMS, 114, 66])
def test_layout_is_the_models_best(sms):
    """The picked layout's busiest block is the model's shortest among
    every token tile at whole tiles and at each split; at ViT-B's four
    sites at M = 1664 that is whole tiles, of 128 tokens at qkv and fc1
    and of 96 at proj and fc2 (on an H100 the fastest of every token
    tile and split measured there, for each front end: PERF.md); where a
    deep weight gives few tiles, a split of the depth spreads them over
    more SMs of the H100."""
    for (m, k, n), fronts in [(v, FRONTS) for v in SITES.values()] + [
            (v, {"int8": (False, 1, 4), "int4": (True, 1, 4)})
            for v in DEEP.values()]:
        for int4, xs, os_ in fronts.values():
            lay = _layout(m, k, n, int4, xs, os_, sms=sms)
            best = M._makespan(lay, os_, sms)
            for nw in INT_MM_NW:
                for s in range(1, min(lay.steps, 16) + 1):
                    for full in {None, 0}:
                        v = int_matmul_variant(lay, nw, s, full)
                        assert M._makespan(v, os_, sms) >= best * (1 - 1e-9)
            if (m, k, n) in SITES.values() and sms == SMS:
                # 234 / 312 tiles of 128 tokens at qkv / fc1; 108 of 96 at
                # proj and fc2 (one wave, where 128 leaves 54 SMs idle)
                assert lay.splits == 1, lay
                assert lay.nw == (96 if n == 768 else 128), lay
            if (m, k, n) in DEEP.values() and sms == SMS:
                assert lay.splits > 1 and len(lay.items()) > lay.tiles


def _sext4(v):
    """Signed 4-bit values of the nibbles ``v`` (int64, 0..15)."""
    return torch.where(v >= 8, v - 16, v)


def _mirror(x, w_t, int4, lay, scale, bias, out_dtype, requant_top=None):
    """The kernel's arithmetic on the CPU, item by item in its order: the
    token levels as TMA reads them (x, or the scratch [rows, kw], zeros
    past K and past the rows), a packed step's low nibbles against
    columns [c, c + 128) and high nibbles against [kh + c, ...), the
    split items' int32 partial tiles summed by the last split to arrive,
    then the epilogue by rows: acc.f32 * scale, then + bias."""
    m, n, nw, kw = lay.m, lay.n, lay.nw, lay.kw
    rows = max(m, nw) + nw
    a = torch.zeros((rows, kw + 2 * INT_MM_BK), dtype=torch.int64)
    a[:m, :lay.k] = x.to(torch.int64)
    wb = w_t.shape[1]
    wpad = torch.zeros((w_t.shape[0], wb + INT_MM_BK), dtype=torch.int64)
    wpad[:, :wb] = w_t.to(torch.int64) & 0xFF
    kh = wb if int4 else 0
    acc = {}
    parts = {}
    for i, (f0, t0, first, end) in enumerate(lay.items()):
        d = torch.zeros((nw, INT_MM_ROWS), dtype=torch.int64)
        for ks in range(first, end):
            c = ks * INT_MM_BK
            wt = wpad[f0:f0 + INT_MM_ROWS, c:c + INT_MM_BK]
            if int4:
                lo, hi = _sext4(wt & 0xF), _sext4(wt >> 4)
                d += a[t0:t0 + nw, c:c + INT_MM_BK] @ lo.T
                d += a[t0:t0 + nw, kh + c:kh + c + INT_MM_BK] @ hi.T
            else:
                d += a[t0:t0 + nw, c:c + INT_MM_BK] @ (wt - 256 * (wt >= 128)).T
        d = d.to(torch.int32)  # the fragments' int32 sums
        if i < lay.full or lay.splits == 1:
            acc[(f0, t0)] = d
            continue
        parts.setdefault((f0, t0), []).append(d)
        if len(parts[(f0, t0)]) == lay.splits:  # the last to arrive
            tot = d.clone()
            for o in parts[(f0, t0)][:-1]:
                tot += o
            acc[(f0, t0)] = tot
    out = torch.zeros((m, n), dtype=torch.float32)
    sc = torch.broadcast_to(torch.as_tensor(scale, dtype=torch.float32),
                            (n,))
    for (f0, t0), d in acc.items():
        r1, c1 = min(m, t0 + nw), min(n, f0 + INT_MM_ROWS)
        y = d[:r1 - t0, :c1 - f0].to(torch.float32) * sc[f0:c1]
        if bias is not None:
            y = y + bias[f0:c1]
        out[t0:r1, f0:c1] = y
    if requant_top is not None:
        top = float(requant_top)
        return torch.clamp(torch.round(out), -top, top).to(torch.int8)
    return out.to(out_dtype)


MIRROR = [  # (M, K, N, int4, nw, splits, full)
    (300, 768, 300, True, 128, 3, 0), (300, 768, 300, False, 64, 2, 4),
    (50, 96, 72, True, 64, 1, None), (50, 96, 72, False, 128, 1, None),
    (77, 200, 130, False, 64, 2, 0), (77, 200, 130, True, 128, 1, None),
    (130, 3072, 140, True, 96, 6, 2), (33, 40, 24, False, 96, 1, None),
    (200, 768, 130, False, 96, 3, 0)]


@pytest.mark.parametrize("case", MIRROR)
@pytest.mark.parametrize("epi", ["f32", "bf16", "requant", "scalar"])
def test_kernel_mirror_equals_the_plain_version(case, epi):
    """The kernel's order of work, mirrored in torch at whole tiles and at
    split depths, packed int4 and int8, ragged shapes and padded weight
    copies, gives the plain version's bits for each epilogue."""
    m, k, n, int4, nw, s, full = case
    rng = np.random.default_rng(m * 7 + k + n)
    lo = 7 if int4 else 127
    x = torch.from_numpy(rng.integers(-lo, lo + 1, (m, k)).astype(np.int8))
    w = torch.from_numpy(rng.integers(-lo, lo + 1, (k, n)).astype(np.int8))
    w_in = pack_int4(w, axis=0) if int4 else w
    w_t, kw = kernel_weight(w_in, "int4" if int4 else "int8", k, n)
    lay = int_matmul_variant(_layout(m, k, n, int4, 1), nw, s, full)
    assert lay.kw == kw
    scale = (torch.tensor(2e-3) if epi == "scalar" else
             torch.from_numpy(rng.random(n).astype(np.float32) * 0.01
                              + 1e-3))
    bias = (None if epi == "scalar" else
            torch.from_numpy((rng.standard_normal(n) * 0.01).astype(
                np.float32)))
    odt = torch.bfloat16 if epi == "bf16" else torch.float32
    top = 7 if epi == "requant" else None
    got = _mirror(x, w_t, int4, lay, scale * (2.0 if top else 1.0), bias,
                  odt, top)
    if int4:
        want = int4_matmul_plain(x, w_in, scale * (2.0 if top else 1.0),
                                 bias, out_dtype=odt, requant_top=top)
    elif top is None:
        want = int8_matmul_plain(x, w_in, scale, bias, out_dtype=odt)
    else:  # the requant epilogue on int8 weights
        acc = x.to(torch.float64) @ w_in.to(torch.float64)
        y = acc.to(torch.int32).to(torch.float32) * (scale * 2.0) + bias
        want = torch.clamp(torch.round(y), -7, 7).to(torch.int8)
    assert got.dtype == want.dtype
    assert torch.equal(got, want)


def _scratch_levels(x, d, t, top, act_pow, kw):
    """The kernel's phase 1 under ROWS_FA, mirrored: each row's levels
    sign(x) * min(rint(p / d), top) in f32, then zeros to the scratch's
    kw columns."""
    x = x.to(torch.float32)
    ax = x.abs()
    p = (torch.exp(torch.tensor(t, dtype=torch.float32)
                   * torch.log(torch.clamp_min(ax, 1e-30))) if act_pow
         else ax)
    lv = torch.minimum(torch.round(p / torch.tensor(d, dtype=torch.float32)),
                       torch.tensor(float(top)))
    out = torch.zeros((x.shape[0], kw), dtype=torch.int8)
    out[:, :x.shape[1]] = (torch.sign(x) * lv).to(torch.int8)
    return out


@pytest.mark.parametrize("act_pow", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k12_scratch_levels_equal_fa_levels(act_pow, dtype):
    """Phase 1's levels (the true division) are ``fa_levels`` on random
    rows and at constructed rounding ties, zeros past K."""
    rng = np.random.default_rng(3)
    k = 200
    kw = weight_depth(k, True)
    x = torch.from_numpy((rng.standard_normal((9, k)) * 0.4).astype(
        np.float32))
    # ties: x/d lands on k + 1/2 give or take an ulp, where x * (1/d) and
    # x / d can round apart
    x[0, :6] = torch.tensor([0.75000006, 1.65, 0.775, 0.975, 1.55, -0.775])
    x = x.to(dtype)
    for d in (0.3, 0.05, 0.1):
        got = _scratch_levels(x, d, 1.08, 7, act_pow, kw)
        want = fa_levels(x, d, 1.08 if act_pow else 1.0, 7, act_pow)
        assert torch.equal(got[:, :k], want)
        assert not got[:, k:].any()


def test_k1_quant_prologue_rounds_a_tie_apart():
    """Why K1's quant prologue (``x * (1/d)``, ROWS_QUANT) cannot stand in
    for K12's: at x = 0.75000006, d = 0.3 the product rounds to 3 and the
    division to 2 (f32, half to even); at x = 0.775, d = 0.05 to 16 and
    15."""
    for xv, d, want_fa, want_k1 in ((0.75000006, 0.3, 2, 3),
                                    (0.775, 0.05, 15, 16)):
        x = torch.tensor([[xv, -xv]], dtype=torch.float32)
        fa = fa_levels(x, d, 1.0, 7 if want_k1 < 8 else 127, False)
        k1 = F._quantize_f32(x, F._f32(d, "cpu"), F._f32(1.0, "cpu"),
                             7 if want_k1 < 8 else 127, False)
        assert fa.tolist() == [[want_fa, -want_fa]]
        assert k1.to(torch.int8).tolist() == [[want_k1, -want_k1]]


@pytest.mark.parametrize("kn", [(40, 24), (200, 130), (768, 768),
                                (250, 2304), (96, 72), (3072, 300)])
@pytest.mark.parametrize("fmt", ["int4", "int8"])
def test_padded_weight_copy_holds_levels_then_zeros(kn, fmt):
    """The plan's weight copy: n-major, the levels then zero levels to the
    depth of whole 16-byte TMA rows of at least 128 bytes, rows rounded up
    to 128 with zeros; packed int4 pairs k' with depth/2 + k'."""
    k, n = kn
    rng = np.random.default_rng(k + n)
    lo = 7 if fmt == "int4" else 127
    w = torch.from_numpy(rng.integers(-lo, lo + 1, (k, n)).astype(np.int8))
    w_in = pack_int4(w, axis=0) if fmt == "int4" else w
    w_t, kw = kernel_weight(w_in, fmt, k, n)
    np_ = -(-n // 128) * 128
    wb = kw // 2 if fmt == "int4" else kw
    assert w_t.shape == (np_, wb) and w_t.dtype == torch.int8
    assert wb % 16 == 0 and wb >= 128 and kw >= k
    assert kw == k or kw == weight_depth(k, fmt == "int4") > k
    lv = unpack_int4(w_t.T, axis=0).T if fmt == "int4" else w_t
    assert lv.shape == (np_, kw)
    assert torch.equal(lv[:n, :k], w.T)
    assert not lv[:n, k:].any() and not lv[n:].any()
    if kw == k:  # no padding: the copy is the plain n-major transpose
        assert torch.equal(w_t[:n], w_in.T.contiguous())

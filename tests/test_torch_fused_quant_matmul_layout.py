"""K1's work split (``ops/fused.py:matmul_layout``), which the CUDA kernel
``csrc/fused_quant_matmul.cu`` launches at: its constants against the
source, the work items covering every output once with the splits
partitioning the depth, the scratch sizes, enough items to fill the
H100's SMs at every M >= 208 of the forwards unless a split of the depth
costs more than it saves; a mirror of the kernel's split GEMM (int32
partial tiles summed in the kernel's order, then the epilogue in f32)
bit-equal to the plain version for every prologue x epilogue; and the
padded weight copy of ViT-H/14's patch embed (K = 588).
No JAX: the plain version is held to the JAX package in
``tests/test_torch_fused.py``."""

import dataclasses
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from quantized_vit_tpu_torch.ops import fused as F
from quantized_vit_tpu_torch.quant import pack_int4, unpack_int4

torch.set_num_threads(1)

CSRC = Path(F.__file__).resolve().parent.parent / "csrc"
SMS = 132
BK = 128

# the sites of the forwards: name -> (rows an image, K, N, prologue,
# x itemsize, batches)
SITES = {
    "vitb_patch_embed": (196, 768, 768, "quant", 4, (32,)),
    "vitb_attn_proj": (208, 768, 768, None, 1, (1, 2, 3, 32)),
    "vitb_head": (1, 768, 1000, "quant", 4, (1, 2, 32)),
    "vitb_chain_qkv": (208, 768, 2304, "ln_quant", 2, (1, 2, 3)),
    "vith_patch_embed": (256, 588, 1280, "quant", 4, (32,)),
    "vith_chain_qkv": (272, 1280, 3840, "ln_quant", 2, (1, 2)),
    "vith_attn_proj": (272, 1280, 1280, None, 1, (1, 2, 32)),
    "vith_fc1": (272, 1280, 5120, "ln_quant", 2, (32,)),
    "vith_fc2": (272, 5120, 1280, None, 1, (32,)),
}
SITE_CASES = [(s, b) for s, v in SITES.items() for b in v[5]]
# ragged shapes: (M, K, N, prologue, itemsize)
RAGGED = [(1, 40, 72, "copy", 1), (50, 40, 72, "ln_quant", 2),
          (50, 96, 72, None, 1), (45, 588, 100, "quant", 4),
          (100, 320, 136, "gelu_quant", 4), (209, 768, 2304, "ln_quant", 2),
          (6657, 768, 770, None, 1), (8191, 588, 1280, "quant", 4),
          (300, 5120, 1, None, 1), (3, 16, 4000, "copy", 1)]


def _ints(text, names):
    """The integer constants ``names`` of ``constexpr int`` declarations
    and enums."""
    env = {}
    for decl in re.findall(r"(?:constexpr int|enum \{)([^;}]+)[;}]", text):
        for part in decl.split(","):
            name, _, expr = part.partition("=")
            name, expr = name.strip(), expr.strip()
            if re.fullmatch(r"\d+", expr):
                env[name] = int(expr)
    return [env[n] for n in names]


def test_layout_constants_match_the_source():
    """Tiles, threads, the smallest prologue group, the two blocks an SM
    and the prologue and epilogue codes: the picker's and the wrapper's
    constants are the kernel's, and its GEMM tile is K2's."""
    src = (CSRC / "fused_quant_matmul.cu").read_text()
    big, small, nt, ln_min = _ints(src, ("TILE_L", "TILE_S", "NT",
                                         "LN_MIN_T"))
    assert (big, small) == F.MLP_TILES and nt == F.MLP_THREADS
    assert ln_min == F.MLP_LN_GROUPS[0] and F.MLP_LN_GROUPS[-1] == nt
    assert "cached = std::min(v, 2);" in src and F.MLP_BLOCKS_PER_SM == 2
    assert "constexpr int BK = qvt::GT_BK;" in src
    pro = _ints(src, ("PRO_NONE", "PRO_QUANT", "PRO_LN", "PRO_GELU",
                      "PRO_COPY"))
    assert pro == [F._PRO_CODES[p] for p in (None, "quant", "ln_quant",
                                             "gelu_quant", "copy")]
    epi = _ints(src, ("EPI_NONE", "EPI_RES", "EPI_QUANT", "EPI_GELU"))
    assert epi == [F._EPILOGUES[e] for e in (None, "residual", "quant",
                                             "gelu_quant")]
    # K1 and K2 share the prologue rows and the stage; K1 sums its splits
    # from the stage
    for name in ("fused_quant_matmul.cu", "fused_mlp.cu"):
        text = (CSRC / name).read_text()
        assert '#include "gemm_phases.cuh"' in text
        assert "qvt::row_levels<" in text and "qvt::stage_acc<" in text
    assert "qvt::split_reduce<" in src


def _covers_once(lay):
    """Every [M, N] output in one tile, taken whole or in splits that take
    each 128-deep step of the depth once; the prologue's row groups cover
    every row once."""
    m, n, t = lay.m, lay.n, lay.tile
    nkt = lay.steps
    steps = {}
    for r0, c0, first, end in lay.items():
        assert 0 <= first < end <= nkt
        steps.setdefault((r0, c0), []).append((first, end))
    out = np.zeros((m, n), np.uint8)
    for (r0, c0), ranges in steps.items():
        ranges.sort()
        assert ranges[0][0] == 0 and ranges[-1][1] == nkt
        assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
        assert len(ranges) in (1, lay.splits)
        out[r0:r0 + t, c0:c0 + t] += 1
    assert (out == 1).all()
    whole = sum(len(v) == 1 for v in steps.values())
    assert whole == (lay.full if lay.splits > 1 else lay.tiles)
    assert 1 <= lay.splits <= nkt
    if lay.prologue is not None:
        per_block = F.MLP_THREADS // lay.ln_threads
        assert lay.row_items * per_block >= m > (lay.row_items - 1) * (
            per_block)
    sizes = lay.scratch_bytes()
    assert sizes["levels"] == (0 if lay.prologue is None
                               else m * (-(-lay.k // 64) * 64))
    assert sizes["partials"] == 4 * lay.split_tiles * lay.splits * t * t


def _fills_or_split_costs_more(lay, sms):
    """The GEMM phase has a work item for each of ``sms`` SMs, or the
    split that would give it more (K2's, of the tiles left after whole
    waves) shortens the longest block's work by no more than a split
    costs (``MATMUL_SPLIT_STEPS`` 128-deep steps), so the tiles run
    whole."""
    if len(lay.items()) >= sms:
        return True
    slots = F.MLP_BLOCKS_PER_SM * sms
    rest = lay.tiles % slots
    s = max(1, min(lay.steps, slots // rest)) if rest else 1
    whole = -(-lay.tiles // slots) * lay.steps
    split = (lay.tiles // slots * lay.steps + -(-lay.steps // s)
             + F.MATMUL_SPLIT_STEPS)
    return lay.splits == 1 and (s == 1 or split >= whole)


@pytest.mark.parametrize("site,batch", SITE_CASES)
def test_every_site_covers_its_outputs_once(site, batch):
    """At every K1 site of the forwards (ViT-B/16 and ViT-H/14, batch 1,
    2, 3 and 32 where the forward runs it): each output in one tile, the
    splits partition the depth; from 208 rows on the prologue has a row
    group for each of the 132 SMs, and the GEMM phase a work item for
    each, unless a split costs more than the idle SMs (the 768-deep ViT-B
    chain proj)."""
    rows, k, n, prologue, itemsize, _ = SITES[site]
    m = rows * batch
    lay = F.matmul_layout(m, k, n, prologue, itemsize, SMS)
    _covers_once(lay)
    if m >= 208:
        assert _fills_or_split_costs_more(lay, SMS)
        assert prologue is None or lay.row_items >= SMS


@pytest.mark.parametrize("m,k,n,prologue,itemsize", RAGGED)
def test_ragged_shapes_cover_their_outputs_once(m, k, n, prologue,
                                                itemsize):
    """Ragged M, N and K (K off 16 and 64, N of one column or of many
    tiles): the coverage holds and the scratch is as the kernel's note
    states."""
    _covers_once(F.matmul_layout(m, k, n, prologue, itemsize, SMS))


def test_layouts_at_the_forward_sites():
    """The picks the kernel's note, the docstring and PERF.md cite: every
    tile whole at the 768-deep ViT-B sites, ViT-H's embed and its MLP
    GEMMs; ViT-H's 1280-deep chain qkv splits the tiles left after a
    whole wave."""
    def pick(*args):
        lay = F.matmul_layout(*args)
        return lay.tile, lay.full, lay.splits, len(lay.items())

    assert pick(6272, 768, 768, "quant", 4) == (128, 294, 1, 294)
    assert pick(6656, 768, 768, None, 1) == (128, 312, 1, 312)
    assert pick(208, 768, 2304, "ln_quant", 2) == (64, 144, 1, 144)
    assert pick(208, 768, 768, None, 1) == (64, 48, 1, 48)
    assert pick(272, 1280, 3840, "ln_quant", 2) == (64, 264, 7, 516)
    assert pick(544, 1280, 3840, "ln_quant", 2) == (64, 528, 10, 648)
    assert pick(8704, 1280, 5120, "ln_quant", 2) == (128, 2720, 1, 2720)
    assert pick(8704, 5120, 1280, None, 1) == (128, 680, 1, 680)
    for m in (1, 32):  # the head: 16 tiles whole
        assert pick(m, 768, 1000, "quant", 4) == (64, 16, 1, 16)
    embed = F.matmul_layout(8192, 588, 1280, "quant", 4)
    assert (embed.kp, embed.steps, embed.splits) == (640, 5, 1)
    # the chain at batch 1: a block a row for the LayerNorm prologue
    assert F.matmul_layout(208, 768, 2304, "ln_quant", 2).ln_threads == 256


@pytest.mark.parametrize("sms", [16, 66, 114])
def test_layouts_follow_smaller_cards(sms):
    """The picker follows the card: on fewer SMs the batch-1 chain's
    sites cover their outputs once and fill the SMs, or run whole where a
    split would cost more."""
    for site in ("vitb_chain_qkv", "vitb_attn_proj", "vith_chain_qkv",
                 "vith_attn_proj"):
        rows, k, n, prologue, itemsize, _ = SITES[site]
        lay = F.matmul_layout(rows, k, n, prologue, itemsize, sms)
        _covers_once(lay)
        assert _fills_or_split_costs_more(lay, sms)


# -- the split GEMM, mirrored --------------------------------------------

def _layer(rng, m, k, n, fmt, pow_, prologue, epilogue):
    """Seeded inputs and the layer's keywords, as chip_smoke.py's K1
    rows make them."""
    if prologue is None:
        x = torch.from_numpy(rng.integers(-7, 8, (m, k)).astype(np.int8))
    elif prologue == "ln_quant":
        x = torch.from_numpy(rng.standard_normal((m, k)) * 0.5).to(
            torch.bfloat16)
    else:
        x = torch.from_numpy(rng.standard_normal((m, k)).astype(
            np.float32))
    lv = torch.from_numpy(rng.integers(-7, 8, (k, n)).astype(np.int8))
    w = pack_int4(lv) if fmt == "int4" else lv
    scale = torch.from_numpy((rng.random(n) * 0.01 + 1e-3).astype(
        np.float32))
    bias = torch.from_numpy((rng.standard_normal(n) * 0.1).astype(
        np.float32))
    kw = dict(fmt=fmt, prologue=prologue, epilogue=epilogue)
    if prologue is not None:
        kw.update(act_d=torch.tensor(0.05),
                  act_t=torch.tensor(1.08 if pow_ else 1.0),
                  act_top=127 if prologue == "ln_quant" else 7,
                  act_pow=pow_ and prologue != "gelu_quant")
    if prologue == "ln_quant":
        kw.update(ln_scale=torch.from_numpy(
            (rng.standard_normal(k) * 0.1 + 1).astype(np.float32)),
            ln_bias=torch.from_numpy(
                (rng.standard_normal(k) * 0.01).astype(np.float32)))
    if epilogue == "residual":
        kw["residual"] = torch.from_numpy(
            rng.standard_normal((m, n))).to(torch.bfloat16)
    if epilogue in ("quant", "gelu_quant"):
        kw.update(out_d=torch.tensor(0.5),
                  out_t=torch.tensor(0.93 if pow_ else 1.0), out_top=31,
                  out_pow=pow_)
    return x, w, scale, bias, kw


def _mirror(x, w, scale, bias, kw, lay, out_dtype):
    """K1's phases on the CPU in the kernel's order: the prologue's levels
    into a [M, Kp] scratch (zeros past K), the GEMM item by item as int32
    partial tiles over the layout's depth splits, summed, then the
    epilogue in f32: acc * scale (+ bias), then the residual, the
    quantizer or the GELU-quant (the plan's folds)."""
    fmt, prologue, epilogue = kw["fmt"], kw["prologue"], kw["epilogue"]
    get = kw.get
    k, n = F._weight_kn(w, fmt)
    m = x.shape[0]
    s, b, ln_s, ln_b, act_folded, out_folded = F._matmul_folds(
        x.device, n, scale, bias, prologue, get("act_d"), get("act_pow"),
        get("ln_scale"), get("ln_bias"), epilogue, get("out_d"),
        get("out_pow"))
    if prologue is None:
        lv = x
    elif prologue == "gelu_quant":
        lv = F._gelu_quant_folded(x.to(torch.float32), kw["act_d"],
                                  kw["act_top"])
    else:
        xx = x
        if prologue == "ln_quant":
            xx = F._layernorm_f32(x, ln_s, ln_b, 1e-6)
        lv = F._quantize_f32(xx, kw["act_d"], kw["act_t"], kw["act_top"],
                             kw["act_pow"], folded=act_folded)
    kp = lay.kp
    a = torch.zeros((m, kp), dtype=torch.int64)
    a[:, :k] = lv.to(torch.int64)
    wl = torch.zeros((kp, n), dtype=torch.int64)
    wl[:k] = (unpack_int4(w) if fmt == "int4" else w).to(torch.int64)
    acc = torch.zeros((m, n), dtype=torch.int32)
    t = lay.tile
    for r0, c0, first, end in lay.items():
        k0, k1 = first * BK, min(end * BK, kp)
        part = a[r0:r0 + t, k0:k1] @ wl[k0:k1, c0:c0 + t]
        acc[r0:r0 + t, c0:c0 + t] += part.to(torch.int32)
    v = acc.to(torch.float32) * s
    if b is not None:
        v = v + b
    if epilogue == "residual":
        return (v + kw["residual"].to(torch.float32)).to(out_dtype)
    if epilogue is None:
        return v.to(out_dtype)
    if epilogue == "gelu_quant" and out_folded:
        return F._gelu_quant_folded(v, kw["out_d"], kw["out_top"])
    if epilogue == "gelu_quant":
        v = F._gelu_f32(v)
    return F._quantize_f32(v, kw["out_d"], kw["out_t"], kw["out_top"],
                           kw["out_pow"], folded=out_folded)


@pytest.mark.parametrize("quant", ["lin", "pow"])
@pytest.mark.parametrize("fmt", ["int8", "int4"])
@pytest.mark.parametrize("epilogue", [None, "residual", "quant",
                                      "gelu_quant"])
@pytest.mark.parametrize("prologue", [None, "quant", "ln_quant",
                                      "gelu_quant"])
def test_split_gemm_mirror_equals_plain(prologue, epilogue, fmt, quant):
    """The kernel's split GEMM changes no bit: at 100 x 320 x 136 (ragged
    64 x 64 tiles, three 128-deep steps), two tiles whole and four split
    three ways, the mirror equals fused_quant_matmul_plain for each
    prologue x epilogue, weight format and quantizer."""
    m, k, n = 100, 320, 136
    seed = (list(F._PROLOGUES).index(prologue) * 16
            + list(F._EPILOGUES).index(epilogue) * 4
            + (fmt == "int4") * 2 + (quant == "pow"))
    rng = np.random.default_rng(seed)
    x, w, scale, bias, kw = _layer(rng, m, k, n, fmt, quant == "pow",
                                   prologue, epilogue)
    out_dtype = torch.bfloat16 if epilogue == "residual" else torch.float32
    want = F.fused_quant_matmul_plain(x, w, scale, bias,
                                      out_dtype=out_dtype, **kw)
    lay = dataclasses.replace(
        F.matmul_layout(m, k, n, prologue, x.element_size()), tile=64,
        full=2, splits=3)
    assert lay.steps == 3 and lay.split_tiles == 4
    got = _mirror(x, w, scale, bias, kw, lay, out_dtype)
    assert got.dtype == want.dtype and torch.equal(got, want)


# -- the padded embed weight ---------------------------------------------

@pytest.mark.parametrize("fmt", ["int8", "int4"])
@pytest.mark.parametrize("k", [588, 40])
def test_padded_weight_holds_the_levels_then_zeros(k, fmt):
    """ViT-H/14's patch embed weight (K = 588; and the 40-deep rows of
    chip_smoke.py) off the 16-byte path: the plan's copy at Kp (K rounded
    up to 64), re-packed there for int4, holds the same levels for k < K
    and zeros beyond, and takes the 16-byte path; the plain product with
    x padded by zero columns equals the unpadded one."""
    rng = np.random.default_rng(k + (fmt == "int4"))
    n, m = 72, 33
    assert not F._weight_vec_ok(k, fmt)
    kp = -(-k // 64) * 64
    lv = torch.from_numpy(rng.integers(-7, 8, (k, n)).astype(np.int8))
    w = pack_int4(lv) if fmt == "int4" else lv
    wt = F.padded_n_major(w, fmt, k, kp)
    assert wt.shape == (n, kp // 2 if fmt == "int4" else kp)
    assert wt.is_contiguous() and F._weight_vec_ok(kp, fmt)
    wp = wt.t()  # back to [Kp(/2), N]
    levels = unpack_int4(wp) if fmt == "int4" else wp
    assert torch.equal(levels[:k], lv)
    assert not levels[k:].any()
    x = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32))
    kw = dict(fmt=fmt, prologue="quant", act_d=torch.tensor(0.05),
              act_t=torch.tensor(1.0), act_top=7, out_dtype=torch.float32)
    scale = torch.from_numpy((rng.random(n) * 0.01).astype(np.float32))
    want = F.fused_quant_matmul_plain(x, w, scale, None, **kw)
    xp = torch.cat([x, torch.zeros((m, kp - k))], dim=1)
    got = F.fused_quant_matmul_plain(xp, wp.contiguous(), scale, None, **kw)
    assert torch.equal(got, want)

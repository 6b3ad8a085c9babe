"""K8's work split (``ops/fused.py:chunked_layout``), which the CUDA kernel
``csrc/fused_mlp_chunked.cu`` launches at: its constants against the
sources, each GEMM phase's items covering every output once, the wgmma N
and the ring's shared memory within the card's limits, a mirror of the
kernel's phases (int32 sums of each item's 128-deep steps, then the
epilogues) bit-equal to the plain version, and the width limit gone. No
JAX: the plain version is held to the JAX package in
``tests/test_torch_fused_chunked.py``."""

import dataclasses
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from quantized_vit_tpu_torch.models import ViTConfig
from quantized_vit_tpu_torch.ops import fused as F
from quantized_vit_tpu_torch.serve import vit_int4 as tv

torch.set_num_threads(1)

CSRC = Path(F.__file__).resolve().parent.parent / "csrc"
SMS = 132
H100_BLOCK_SMEM = 232448  # what one block may take, static memory included
K8_STATIC_SMEM = 1024  # ptxas: the 1024-byte aligned dynamic window
WIDTHS = {"vit_b": (768, 3072), "vit_h": (1280, 5120),
          "past_old_limit": (1536, 6144)}
ROWS = (1, 45, 208, 272, 416, 544, 592, 624, 6656)


def _ints(text, names):
    """The integer constants ``names`` of ``constexpr int`` declarations."""
    env = {}
    for decl in re.findall(r"constexpr int ([^;]+);", text):
        for part in decl.split(","):
            name, _, expr = part.partition("=")
            name, expr = name.strip(), expr.strip()
            if re.fullmatch(r"\d+", expr):
                env[name] = int(expr)
    return [env[n] for n in names]


def test_layout_constants_match_the_source():
    """Weight rows an item, the ring's step, the threads (two consumer
    warpgroups and a producer warp), the LayerNorm groups, the ring's
    stages and shared memory, and the wgmma N the kernel instantiates and
    dispatches: the picker's constants are the kernel's."""
    src = (CSRC / "fused_mlp_chunked.cu").read_text()
    rows, bk, cwg, ln_min, ln_max, stages, smem, slack = _ints(
        src, ("ROWS", "BK", "CWG", "LN_MIN_T", "LN_MAX_T", "MAX_STAGES",
              "SMEM_MAX", "SMEM_SLACK"))
    assert (rows, bk) == (F.CHUNKED_ROWS, F.CHUNKED_BK)
    assert F.CHUNKED_WR == (2 * rows, rows)  # fc1's items, fc2's
    assert "std::max(2 * ROWS + nw1, ROWS + CWG * nw2) * BK" in src
    assert "CT = 128 * CWG, NT = CT + 32" in src
    assert F.CHUNKED_THREADS == 128 * cwg + 32 == 288
    assert (ln_min, ln_max) == (F.CHUNKED_LN_GROUPS[0],
                                F.CHUNKED_LN_GROUPS[-1])
    assert (stages, smem, slack) == (F.CHUNKED_MAX_STAGES, F.CHUNKED_SMEM,
                                     F.CHUNKED_SMEM_SLACK)
    assert smem == H100_BLOCK_SMEM
    wg = (CSRC / "wgmma_int8.cuh").read_text()
    built = sorted(int(n) for n in re.findall(r"struct Mma<(\d+)>", wg))
    assert tuple(built) == F.CHUNKED_NW
    for nw in F.CHUNKED_NW:
        assert f"m64n{nw}k32.s32.s8.s8" in wg
        assert f"case {nw}:" in src or nw == F.CHUNKED_NW[-1]
        assert f"nw == {nw}" in src
    # the grid: enough blocks for the largest phase, one an SM
    assert "(H + 2 * ROWS - 1) / (2 * ROWS) *" in src
    assert "(K + ROWS - 1) / ROWS * static_cast<long long>(g2)" in src
    assert "a.nc1, a.nw1, a.g1, false};" in src  # fc1 shares the tokens
    assert "a.nc2, a.nw2, a.g2, true};" in src  # fc2 the weight tile


def _covers_once(lay, phase):
    """Every output of the phase (weight row x token row) in exactly one
    warpgroup tile, every tile within its chunk's rows and the matrix."""
    rows, _, wr, nc, nw, _ = lay.phase(phase)
    hits = np.zeros((rows, lay.m), np.uint8)
    for tiles in lay.items(phase):
        assert len(tiles) == 2
        if wr == F.CHUNKED_ROWS:  # one weight tile, two token chunks
            assert tiles[0][0] == tiles[1][0]
            assert tiles[1][1] == tiles[0][1] + nc
        else:  # two weight tiles, one chunk
            assert tiles[1][0] == tiles[0][0] + F.CHUNKED_ROWS
            assert tiles[0][1] == tiles[1][1]
        assert tiles[0][2] > 0  # no item without work
        for r0, t0, cnt in tiles:
            assert r0 % F.CHUNKED_ROWS == 0 and t0 % 8 == 0
            if cnt > 0:
                assert cnt <= nc <= nw and r0 < rows
                hits[r0:r0 + F.CHUNKED_ROWS, t0:t0 + cnt] += 1
    assert (hits == 1).all()


@pytest.mark.parametrize("m", ROWS)
@pytest.mark.parametrize("width", sorted(WIDTHS))
def test_every_phase_covers_its_outputs_once(width, m):
    """At ViT-B's and ViT-H's widths and one past the first K8's limit,
    at every M of the forwards and their ragged neighbours: each GEMM
    phase covers its outputs exactly once; the LayerNorm groups cover the
    rows; the wgmma N is a multiple of 8 up to 256 and holds the chunk;
    the ring (3-16 stages) fits the block's shared memory; the grid is
    the largest phase's items, one an SM."""
    k, hid = WIDTHS[width]
    lay = F.chunked_layout(m, k, hid, 2, SMS)
    for phase in (1, 2):
        _covers_once(lay, phase)
        _, _, wr, nc, nw, g = lay.phase(phase)
        assert wr == F.CHUNKED_WR[phase - 1] and nw in F.CHUNKED_NW
        assert nw % 8 == 0 and 8 <= nc <= nw <= 256 and nc % 8 == 0
        assert nc <= lay.m8
    assert 3 <= lay.stages <= F.CHUNKED_MAX_STAGES
    assert lay.smem_bytes + K8_STATIC_SMEM <= H100_BLOCK_SMEM
    assert lay.smem_bytes == 1024 + lay.stages * lay.stage_bytes + 256
    if lay.stages < F.CHUNKED_MAX_STAGES:  # as deep as the memory allows
        deeper = dataclasses.replace(lay, stages=lay.stages + 1)
        assert deeper.smem_bytes + K8_STATIC_SMEM > H100_BLOCK_SMEM
    per_block = 256 // lay.ln_threads
    assert lay.ln_items * per_block >= m > (lay.ln_items - 1) * per_block
    assert lay.ln_threads in F.CHUNKED_LN_GROUPS
    assert F.chunked_grid(lay, SMS) == min(SMS, max(
        lay.ln_items, len(lay.items(1)), len(lay.items(2))))
    sizes = lay.scratch_bytes()
    assert sizes == {"levels": lay.m8 * -(-k // 128) * 128,
                     "hidden": lay.m8 * -(-hid // 128) * 128}


def test_layouts_at_the_route_sites():
    """The picks the kernel's note and PERF.md cite, one wave of items a
    phase: at ViT-H/14 batch 1 (272 rows) fc1 in 120 items of 128 units x
    one chunk of 96 rows at N 128, fc2 in 120 items of 64 columns x 2
    chunks of 24 rows at N 32; at batch 2 (544) 120 x 184 rows at N 256
    and 120 x 2 x 48 at N 64; ViT-B's chain at batch 3 (624) 120 x 128
    and 120 x 2 x 32; every weight tile read once a token group and every
    token tile once a weight tile: the L2 bytes of the note."""
    b1 = F.chunked_layout(272, 1280, 5120)
    assert (b1.nc1, b1.nw1, b1.g1, b1.nc2, b1.nw2, b1.g2) == (96, 128, 3,
                                                              24, 32, 6)
    b2 = F.chunked_layout(544, 1280, 5120)
    assert (b2.nc1, b2.nw1, b2.g1, b2.nc2, b2.nw2, b2.g2) == (184, 256, 3,
                                                              48, 64, 6)
    b3 = F.chunked_layout(624, 768, 3072)
    assert (b3.nc1, b3.g1, b3.nc2, b3.g2) == (128, 5, 32, 10)
    for lay in (b1, b2, b3):
        assert len(lay.items(1)) == len(lay.items(2)) == 120
        assert F.chunked_grid(lay) == 120
    w = 1280 * 5120
    for lay in (b1, b2):
        assert lay.l2_bytes(1) == lay.g1 * w + 40 * lay.g1 * lay.nc1 * 1280
        assert lay.l2_bytes(2) == lay.g2 * w + 20 * (
            2 * lay.g2 * lay.nc2) * 5120
    assert [round(v / 1e6, 1) for v in (b1.l2_bytes(1), b1.l2_bytes(2),
                                        b2.l2_bytes(1), b2.l2_bytes(2))] \
        == [34.4, 68.8, 47.9, 98.3]
    assert (b1.stages, b2.stages) == (7, 4)


@pytest.mark.parametrize("sms", [16, 66, 114])
def test_layouts_follow_smaller_cards(sms):
    """On fewer SMs the picker takes fewer token groups (one wave of items
    a phase, where a chunk of 256 rows allows it) and the coverage
    holds."""
    for k, hid in WIDTHS.values():
        for m in (272, 544):
            lay = F.chunked_layout(m, k, hid, 2, sms)
            for phase in (1, 2):
                _covers_once(lay, phase)
                _, _, wr, nc, _, g = lay.phase(phase)
                chunks = 2 if wr == 64 else 1
                assert nc * chunks * (g - 1) < m <= nc * chunks * g
                g_min = -(-m // (chunks * 256))  # chunks of 256 rows
                assert len(lay.items(phase)) <= sms or g == g_min


def _levels(x, kw):
    """The int8 levels of quant(LN(x)): the plain K1 prologue through an
    identity weight (its f32 output is the levels, exactly)."""
    k = x.shape[1]
    eye = torch.eye(k, dtype=torch.int8)
    out = F.fused_quant_matmul_plain(
        x, eye, 1.0, None, fmt="int8", prologue="ln_quant",
        act_d=kw["act_d"], act_t=kw["act_t"], act_top=kw["act_top"],
        act_pow=kw["act_pow"], ln_scale=kw["ln_scale"],
        ln_bias=kw["ln_bias"], out_dtype=torch.float32)
    return out.to(torch.int8)


def _phase_sums(lay, phase, a, w):
    """A GEMM phase of K8 on the CPU in its order: each warpgroup tile of
    each item the int32 sum of its 128-deep steps' products (a: the token
    rows' levels [M, depth], w: the weight [depth, rows]); every output
    written once. Returns [M, rows] int32."""
    rows, depth, _, _, _, _ = lay.phase(phase)
    acc = torch.zeros((lay.m, rows), dtype=torch.int32)
    done = torch.zeros((lay.m, rows), dtype=torch.bool)
    a64, w64 = a.to(torch.int64), w.to(torch.int64)
    for tiles in lay.items(phase):
        for r0, t0, cnt in tiles:
            if cnt <= 0:
                continue
            r1 = min(r0 + F.CHUNKED_ROWS, rows)
            tile = torch.zeros((cnt, r1 - r0), dtype=torch.int32)
            for k0 in range(0, depth, F.CHUNKED_BK):
                part = (a64[t0:t0 + cnt, k0:k0 + F.CHUNKED_BK]
                        @ w64[k0:k0 + F.CHUNKED_BK, r0:r1])
                tile += part.to(torch.int32)
            assert not done[t0:t0 + cnt, r0:r1].any()
            done[t0:t0 + cnt, r0:r1] = True
            acc[t0:t0 + cnt, r0:r1] = tile
    assert done.all()
    return acc


def _mirror(x, w1, s1, b1, w2, s2, b2, kw, lay):
    """K8's three phases on the CPU: the LayerNorm levels, fc1 item by item
    then its dequant + GELU-quant epilogue (the plan's folds), fc2 item by
    item then ``acc * s2 + b2 + x`` in f32."""
    dev = x.device
    lv = _levels(x, kw)
    acc1 = _phase_sums(lay, 1, lv, w1)
    sc1, bi1, _, _, _, folded = F._matmul_folds(
        dev, w1.shape[1], s1, b1, "ln_quant", kw["act_d"], kw["act_pow"],
        kw["ln_scale"], kw["ln_bias"], "gelu_quant", kw["hid_d"],
        kw["hid_pow"], False)
    y = acc1.to(torch.float32) * sc1 + bi1
    if folded:
        hlv = F._gelu_quant_folded(y, F._f32(kw["hid_d"], dev),
                                   kw["hid_top"])
    else:
        hlv = F._quantize_f32(F._gelu_f32(y), F._f32(kw["hid_d"], dev),
                              F._f32(kw["hid_t"], dev), kw["hid_top"], True)
    acc2 = _phase_sums(lay, 2, hlv, w2)
    out = acc2.to(torch.float32) * s2 + b2
    return (out + x.to(torch.float32)).to(x.dtype)


@pytest.mark.parametrize("pow_", [False, True], ids=["lin", "pow"])
@pytest.mark.parametrize("groups", [None, (2, 3), (5, 4), (1, 1)])
def test_phase_mirror_equals_plain(groups, pow_):
    """The kernel's decomposition changes no bit: the mirror at the
    picker's token groups and at others (one group, many, a last group
    with a ragged chunk), with ragged rows, tokens and depth, equals
    fused_mlp_plain."""
    rng = np.random.default_rng((groups or (0, 0))[0] * 7 + pow_)
    m, k, hid = 61, 200, 328
    dt = torch.float32 if pow_ else torch.bfloat16
    x = torch.from_numpy(rng.standard_normal((m, k)) * 0.5).to(dt)
    w1 = torch.from_numpy(rng.integers(-127, 128, (k, hid)).astype(np.int8))
    w2 = torch.from_numpy(rng.integers(-127, 128, (hid, k)).astype(np.int8))
    s1, b1 = torch.tensor(5e-5), torch.from_numpy(
        rng.standard_normal(hid).astype(np.float32) * 0.01)
    s2, b2 = torch.tensor(5e-5), torch.from_numpy(
        rng.standard_normal(k).astype(np.float32) * 0.01)
    kw = dict(ln_scale=torch.from_numpy(
        rng.standard_normal(k).astype(np.float32) * 0.1 + 1),
        ln_bias=torch.from_numpy(
            rng.standard_normal(k).astype(np.float32) * 0.01),
        act_d=torch.tensor(0.05), act_t=torch.tensor(1.08 if pow_ else 1.0),
        act_top=127, act_pow=pow_, hid_d=torch.tensor(0.05),
        hid_t=torch.tensor(0.93 if pow_ else 1.0), hid_top=127,
        hid_pow=pow_, fmt="int8", fmt2="int8")
    want = F.fused_mlp_plain(x, w1, s1, b1, w2, s2, b2, out_dtype=dt, **kw)
    lay = F.chunked_layout(m, k, hid)
    if groups is not None:
        fields = {}
        for phase, g in zip((1, 2), groups):
            chunks = 2 if F.CHUNKED_WR[phase - 1] == 64 else 1
            nc = -(-(-(-m // (chunks * g))) // 8) * 8
            fields.update({
                f"nc{phase}": nc, f"g{phase}": -(-m // (chunks * nc)),
                f"nw{phase}": next(v for v in F.CHUNKED_NW if v >= nc)})
        lay = dataclasses.replace(lay, **fields)
    for phase in (1, 2):
        _covers_once(lay, phase)
    assert torch.equal(_mirror(x, w1, s1, b1, w2, s2, b2, kw, lay), want)


def test_no_width_limit():
    """K8 takes any width with int8 weights (its first design refused K >
    1280) and still refuses packed int4 with the JAX package's reason;
    the forward's kernel limits name no K8 width: ViT-H/14's and a
    1536-wide ViT whose MLP at batch 1-2 takes K8's route."""
    assert F.mlp_chunked_kernel_limit(1536) is None
    assert F.mlp_chunked_kernel_limit(1 << 14, "int8", "int8") is None
    for fmts in (("int4", None), ("int8", "int4"), ("int4", "int8")):
        assert "int8 weights only" in F.mlp_chunked_kernel_limit(1536, *fmts)
    assert not hasattr(F, "MLP_CHUNKED_MAX_K")
    wide = ViTConfig(patch_size=14, embed_dim=1536, num_heads=24, depth=1)
    for b in (1, 2):
        assert tv.mlp_route(b * 272, 1536, 6144, "int8") == tv.MLP_CHUNKED
        assert tv.kernel_limits(wide, batch=b, fmt="int8") == []
    vit_h = ViTConfig(patch_size=14, embed_dim=1280, num_heads=16, depth=1)
    assert tv.kernel_limits(vit_h, fmt="int8") == []
    assert not any("fused_mlp_chunked" in lim for lim in tv.kernel_limits(
        ViTConfig(patch_size=14, embed_dim=2048, num_heads=16, depth=1),
        fmt="int8"))


def test_plan_pads_weights_off_the_tiles():
    """The plan's weight copies as K8's tensor maps read them: the shared
    n-major copy itself at ViT widths, a zero-padded copy [rows rounded
    up to 64, depth rounded up to 128] elsewhere, the levels unchanged."""
    w = torch.arange(5120 * 1280, dtype=torch.int64).remainder(255).sub(
        127).to(torch.int8).reshape(5120, 1280)
    assert F._chunked_copy(w, 5120, 1280) is w
    small = torch.randint(-127, 128, (40, 72), dtype=torch.int8)
    pad = F._chunked_copy(small, 40, 72)
    assert pad.shape == (64, 128)
    assert torch.equal(pad[:40, :72], small)
    assert not pad[40:].any() and not pad[:, 72:].any()


def test_cpu_tensors_never_reach_the_kernel():
    """run_mlp_chunked is the kernel's launcher: a CPU tensor is refused
    (fused_mlp takes the plain version for it)."""
    plan = F.MlpPlan(*([None] * 18))
    with pytest.raises(ValueError, match="CUDA tensors"):
        F.run_mlp_chunked(plan, torch.zeros((4, 8)))

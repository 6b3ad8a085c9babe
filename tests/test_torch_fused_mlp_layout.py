"""K2's work split (``ops/fused.py:mlp_layout``), which the CUDA kernel
``csrc/fused_mlp.cu`` launches at: its constants against the sources,
each phase's work items covering every output once, the scratch sizes,
enough items to fill the H100's SMs at every M of the forwards, and a
mirror of the kernel's split fc2 (int32 partial tiles summed, then the
epilogue) bit-equal to the plain version. No JAX: the plain version is
held to the JAX package in ``tests/test_torch_fused.py``."""

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
H100_SM_SMEM = 233472
WIDTHS = {"vit_b": (768, 3072), "vit_h": (1280, 5120)}
ROWS = (1, 45, 208, 272, 416, 544, 624, 6656)


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
    """Tiles, threads, k step, the smallest LayerNorm group and the two
    blocks an SM: the picker's constants are the kernel's, and two blocks
    of the larger GEMM ring fit an H100 SM."""
    src = (CSRC / "fused_mlp.cu").read_text()
    big, small, nt, ln_min = _ints(src, ("TILE_L", "TILE_S", "NT",
                                         "LN_MIN_T"))
    assert (big, small) == F.MLP_TILES and nt == F.MLP_THREADS
    assert ln_min == F.MLP_LN_GROUPS[0] and F.MLP_LN_GROUPS[-1] == nt
    assert "cached = std::min(v, 2);" in src and F.MLP_BLOCKS_PER_SM == 2
    gemm = (CSRC / "int8_gemm.cuh").read_text()
    (bk,) = _ints(gemm, ("GT_BK",))
    assert bk == F.MLP_BK and "GT_SK = GT_BK + 16, GT_ST = 3" in gemm
    ring = 3 * (big + big) * (bk + 16)
    assert 2 * (ring + 1024 + 256) <= H100_SM_SMEM


def _covers_once(layout):
    """Every [M, H] hidden level in one fc1 tile; every [M, K] output in
    one fc2 tile, taken whole or in splits that take each 128-deep step
    of the hidden depth once."""
    m, k, hid = layout.m, layout.k, layout.hid
    t1, t2 = layout.tile1, layout.tile2
    hits = np.zeros((m, hid), np.uint8)
    for r0, c0 in layout.fc1_tiles():
        hits[r0:r0 + t1, c0:c0 + t1] += 1
    assert (hits == 1).all()
    nkt = -(-layout.hp // F.MLP_BK)
    steps = {}
    for r0, c0, first, end in layout.fc2_items():
        assert 0 <= first < end <= nkt
        steps.setdefault((r0, c0), []).append((first, end))
    out = np.zeros((m, k), np.uint8)
    for (r0, c0), ranges in steps.items():
        ranges.sort()
        assert ranges[0][0] == 0 and ranges[-1][1] == nkt
        assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
        assert len(ranges) in (1, layout.splits)
        out[r0:r0 + t2, c0:c0 + t2] += 1
    whole = sum(len(v) == 1 for v in steps.values())
    assert whole == layout.full2
    assert layout.splits > 1 or layout.full2 == layout.fc2_tiles
    assert (out == 1).all()
    per_block = F.MLP_THREADS // layout.ln_threads
    assert layout.ln_items * per_block >= m > (layout.ln_items - 1) * per_block


@pytest.mark.parametrize("m", ROWS)
@pytest.mark.parametrize("width", sorted(WIDTHS))
def test_every_phase_covers_its_outputs_once(width, m):
    """At ViT-B's and ViT-H's widths and every M of the forwards and
    their ragged neighbours: each phase covers its outputs exactly once,
    the scratch is as the kernel's note states, and from 208 rows on
    (batch 1) every phase has a work item for each of the 132 SMs."""
    k, hid = WIDTHS[width]
    lay = F.mlp_layout(m, k, hid, 2, SMS)
    _covers_once(lay)
    sizes = lay.scratch_bytes()
    assert sizes["levels"] == m * (-(-k // 64) * 64)
    assert sizes["hidden"] == m * (-(-hid // 64) * 64)
    split = lay.fc2_tiles - lay.full2
    assert sizes["counts"] == 4 * split
    assert sizes["partials"] == 4 * split * lay.splits * lay.tile2**2
    assert (split == 0) == (lay.splits == 1)
    if m >= 208:
        assert lay.ln_items >= SMS
        assert len(lay.fc1_tiles()) >= SMS
        assert len(lay.fc2_items()) >= SMS


def test_layouts_at_the_forward_sites():
    """The picks the kernel's note and PERF.md cite: ViT-B/16 batch 32
    takes both GEMMs in 128 x 128 tiles, 264 of fc2's 312 tiles whole and
    48 split 5 ways (hidden levels 20.4 MB); batch 1 and 2 64 x 64 tiles,
    each fc2 tile split 5 and 3 ways; ViT-H/14 batch 1 and 2 split 2 ways
    and none, batch 2 keeping 2.8 MB of hidden levels."""
    b32 = F.mlp_layout(6656, 768, 3072)
    assert (b32.ln_threads, b32.tile1, b32.tile2, b32.full2,
            b32.splits) == (8, 128, 128, 264, 5)
    assert b32.scratch_bytes()["hidden"] == 20447232
    assert b32.scratch_bytes()["levels"] == 5111808
    for m, splits in ((208, 5), (416, 3)):
        lay = F.mlp_layout(m, 768, 3072)
        assert (lay.tile1, lay.tile2, lay.full2, lay.splits) == (64, 64, 0,
                                                                  splits)
    assert F.mlp_layout(272, 1280, 5120).splits == 2
    b2h = F.mlp_layout(544, 1280, 5120)
    assert (b2h.tile1, b2h.tile2, b2h.splits) == (128, 64, 1)
    assert b2h.scratch_bytes()["hidden"] == 2785280


@pytest.mark.parametrize("sms", [16, 66, 114])
def test_layouts_fill_smaller_cards(sms):
    """The picker follows the card: on fewer SMs every phase still has an
    item an SM at batch 1 widths, and the coverage holds."""
    for k, hid in WIDTHS.values():
        lay = F.mlp_layout(208, k, hid, 2, sms)
        _covers_once(lay)
        assert min(lay.ln_items, len(lay.fc1_tiles()),
                   len(lay.fc2_items())) >= sms


def _mirror(x, w1, s1, b1, w2, s2, b2, kw, layout):
    """K2's phases on the CPU in the kernel's order: the hidden levels of
    phases 1-2 (the plain version's fc1, exact), then fc2 item by item
    as int32 partial tiles over the layout's hidden-depth splits, summed,
    and the epilogue ``acc * s2 + b2 + x`` in f32."""
    hlv = F.fused_quant_matmul_plain(
        x, w1, s1, b1, fmt=kw["fmt"], prologue="ln_quant",
        act_d=kw["act_d"], act_t=kw["act_t"], act_top=kw["act_top"],
        act_pow=kw["act_pow"], ln_scale=kw["ln_scale"],
        ln_bias=kw["ln_bias"], epilogue="gelu_quant", out_d=kw["hid_d"],
        out_t=kw["hid_t"], out_top=kw["hid_top"], out_pow=kw["hid_pow"])
    w2l = (unpack_int4(w2) if kw["fmt2"] == "int4" else w2).to(torch.int64)
    m, k = x.shape
    acc = torch.zeros((m, k), dtype=torch.int32)
    t2 = layout.tile2
    for r0, c0, first, end in layout.fc2_items():
        h0, h1 = first * F.MLP_BK, end * F.MLP_BK
        part = hlv[r0:r0 + t2, h0:h1].to(torch.int64) @ w2l[h0:h1,
                                                            c0:c0 + t2]
        acc[r0:r0 + t2, c0:c0 + t2] += part.to(torch.int32)
    y = acc.to(torch.float32) * s2 + b2
    return (y + x.to(torch.float32)).to(x.dtype)


@pytest.mark.parametrize("fmt", ["int8", "int4"])
@pytest.mark.parametrize("tile2,full2,splits", [(128, 1, 1), (64, 0, 2),
                                                (64, 5, 3)])
def test_split_fc2_mirror_equals_plain(tile2, full2, splits, fmt):
    """The kernel's fc2 split into int32 partial tiles changes no bit:
    the mirror with tiles whole and split 2-3 ways equals
    fused_mlp_plain."""
    rng = np.random.default_rng(splits * 10 + (fmt == "int4"))
    m, k, hid = 100, 96, 320
    x = torch.from_numpy(rng.standard_normal((m, k)) * 0.5).to(
        torch.bfloat16)
    lv1 = torch.from_numpy(rng.integers(-7, 8, (k, hid)).astype(np.int8))
    lv2 = torch.from_numpy(rng.integers(-7, 8, (hid, k)).astype(np.int8))
    w1, w2 = ((pack_int4(lv1), pack_int4(lv2)) if fmt == "int4"
              else (lv1, lv2))
    s1, b1 = torch.tensor(1e-3), torch.from_numpy(
        rng.standard_normal(hid).astype(np.float32) * 0.01)
    s2, b2 = torch.tensor(1e-3), torch.from_numpy(
        rng.standard_normal(k).astype(np.float32) * 0.01)
    kw = dict(ln_scale=torch.from_numpy(
        rng.standard_normal(k).astype(np.float32) * 0.1 + 1),
        ln_bias=torch.from_numpy(
            rng.standard_normal(k).astype(np.float32) * 0.01),
        act_d=torch.tensor(0.05), act_t=torch.tensor(1.0), act_top=127,
        act_pow=False, hid_d=torch.tensor(0.05), hid_t=torch.tensor(1.0),
        hid_top=127, hid_pow=False, fmt=fmt, fmt2=fmt)
    want = F.fused_mlp_plain(x, w1, s1, b1, w2, s2, b2, **kw)
    lay = dataclasses.replace(F.mlp_layout(m, k, hid), tile2=tile2,
                              full2=full2 if splits > 1 else (
                                  -(-m // tile2) * -(-k // tile2)),
                              splits=splits)
    got = _mirror(x, w1, s1, b1, w2, s2, b2, kw, lay)
    assert torch.equal(got, want)


# K15 (fused_mlp_gather) is K2's kernel with the next block's gather:
# its grid (F.mlp_grid) and the gather's chunks (F.gather_split).
# (gather bytes: ViT-B/16's and ViT-H/14's four block weights at tp = 1
# and 2, a process's jobs: each shard into every process's buffer)
GATHERS = {
    "vit_b_tp1": (6656, 768, 3072, 1, 249),
    "vit_b_tp2": (3328, 768, 3072, 2, 252),
    "vit_h_tp1": (8704, 1280, 5120, 1, 300),
    "vit_h_tp2": (4352, 1280, 5120, 2, 302),
}


def _block_jobs(k, hid, tp):
    return [k * 3 * k // tp, k * k // tp, k * hid // tp, hid * k // tp] * tp


def _chunk_of(job_bytes, chunk, c):
    """csrc/copy_jobs.cuh:copy_chunk's (job, first byte, bytes) of chunk
    c, in its loop's order."""
    for j, n in enumerate(job_bytes):
        pieces = -(-n // chunk)
        if c < pieces:
            return j, c * chunk, min(chunk, n - c * chunk)
        c -= pieces
    raise AssertionError("chunk past the jobs")


@pytest.mark.parametrize("name", sorted(GATHERS))
def test_gather_split_covers_every_byte_once(name):
    """Every byte of every job in one chunk, the chunks 4096-byte aligned
    pieces of at most 64 KB, numbered as the kernel walks them; the chunk
    counts at ViT-B/16's and ViT-H/14's gathers (28 KB x 249 at ViT-B
    batch 32, 64 KB x 300 at ViT-H)."""
    m, k, hid, tp, want = GATHERS[name]
    jobs = _block_jobs(k, hid, tp)
    grid = F.mlp_grid(F.mlp_layout(m, k, hid))
    split = F.gather_split(jobs, grid)
    assert split.chunks == want
    assert split.chunk % F.GATHER_CHUNK_ALIGN == 0
    assert F.GATHER_CHUNK_ALIGN <= split.chunk <= F.GATHER_CHUNK_MAX
    pieces = [_chunk_of(jobs, split.chunk, c) for c in range(split.chunks)]
    for j, n in enumerate(jobs):
        hits = np.zeros(n, np.uint8)
        for jj, o, nb in pieces:
            if jj == j:
                assert o % F.GATHER_CHUNK_ALIGN == 0 and nb > 0
                hits[o:o + nb] += 1
        assert (hits == 1).all()
    if name == "vit_b_tp1":
        assert (grid, split.chunk) == (264, 28672)


def test_gather_split_edges():
    """No jobs or empty jobs: no chunks; ragged byte counts end in a short
    chunk; a small grid takes 64 KB chunks, a large one 4 KB."""
    assert F.gather_split([], 264) == F.GatherSplit(4096, 0)
    assert F.gather_split([0, 0], 264).chunks == 0
    s = F.gather_split([100, 4097, 5], 1)
    assert s == F.GatherSplit(8192, 3)
    assert [_chunk_of([100, 4097, 5], s.chunk, c) for c in range(3)] == [
        (0, 0, 100), (1, 0, 4097), (2, 0, 5)]
    assert F.gather_split([10 << 20], 2).chunk == F.GATHER_CHUNK_MAX
    assert F.gather_split([1 << 20], 10_000).chunk == F.GATHER_CHUNK_ALIGN


def test_mlp_grid_and_copy_constants_match_the_source():
    """mlp_grid repeats the launch's sizing (the largest phase, two
    blocks an SM); the chunk alignment is the kernel's."""
    src = (CSRC / "fused_mlp.cu").read_text()
    assert ("a.full2 + static_cast<long long>(a.tiles2 - a.full2) * a.S"
            in src)
    assert "chunk < 4096 || chunk % 4096" in src
    assert F.GATHER_CHUNK_ALIGN == 4096 == 16 * F.MLP_THREADS
    assert "if constexpr (COPY) copy_rows(c);" in src
    for m in ROWS:
        for k, hid in WIDTHS.values():
            lay = F.mlp_layout(m, k, hid)
            items = max(lay.ln_items, len(lay.fc1_tiles()),
                        len(lay.fc2_items()))
            assert F.mlp_grid(lay) == min(2 * SMS, items)

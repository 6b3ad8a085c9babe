"""K5's work split (``ops/block_stack.py:stack_layout``), which the CUDA
kernel ``csrc/block_stack.cu`` launches at: its constants against the
source, each GEMM phase's items covering every output once, the wgmma N
and the shared memory of the ring and the attention tile within the
card's limits, a mirror of one transformer block's phases (the packed
int4 nibble pairs as two depth ranges of one weight tile, whole int32
sums a feature x token, the epilogues in order) bit-equal to the plain
version, the kernel's copies of the weights, and its limits. No JAX: the
plain version is held to the JAX package in
``tests/test_torch_block_stack.py``."""

import dataclasses
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from quantized_vit_tpu_torch.models import ViTConfig
from quantized_vit_tpu_torch.ops import block_stack as B
from quantized_vit_tpu_torch.ops import fused as F
from quantized_vit_tpu_torch.ops.attention import attention_qkv_plain
from quantized_vit_tpu_torch.quant import pack_int4, unpack_int4
from quantized_vit_tpu_torch.serve import kernel_limits

torch.set_num_threads(1)

CSRC = Path(B.__file__).resolve().parent.parent / "csrc"
SMS = 132
H100_BLOCK_SMEM = 232448  # what one block may take, static memory included
K5_STATIC_SMEM = 1024  # the static arrays of the tile and the counts
ROWS = (40, 208, 416, 592, 832)
# (D, heads, hidden)
WIDTHS = {64: (64, 2, 256), 768: (768, 12, 3072), 1280: (1280, 16, 5120)}


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
    """Weight rows a warpgroup, the ring's step, the threads (two consumer
    warpgroups, a producer warp), the ring's stages and shared memory, the
    wgmma N instantiated and dispatched, the attention tiles, the
    LayerNorm groups and the five grid barriers a transformer block: the
    picker's constants are the kernel's."""
    src = (CSRC / "block_stack.cu").read_text()
    rows, bk, cwg, stages, smem, slack = _ints(
        src, ("ROWS", "BK", "CWG", "MAX_STAGES", "SMEM_MAX", "SMEM_SLACK"))
    assert (rows, bk) == (B.STACK_ROWS, B.STACK_BK)
    assert B.STACK_WR == (2 * rows, rows, 2 * rows, rows)
    assert "CT = 128 * CWG, NT = CT + 32" in src
    assert B.STACK_THREADS == 128 * cwg + 32 == 288
    assert (stages, smem, slack) == (B.STACK_MAX_STAGES, B.STACK_SMEM,
                                     B.STACK_SMEM_SLACK)
    assert smem == H100_BLOCK_SMEM
    # a stage: the weight rows and a chunk's token tiles, kt depth ranges
    assert "((shared ? ROWS : 2 * ROWS) + kt * a.nw[ph]) * BK" in src
    assert "p.split = ph == G_PROJ || ph == G_FC2;" in src
    assert "XCHG_BYTES = 2 * (NW_SPLIT / 4) * 128 * 4" in src
    assert _ints(src, ("NW_SPLIT",)) == [B.STACK_NW_SHARED[-1]]
    wg = (CSRC / "wgmma_int8.cuh").read_text()
    built = sorted(int(n) for n in re.findall(r"struct MmaR<(\d+)>", wg))
    assert tuple(built) == B.STACK_NW
    for nw in B.STACK_NW:
        assert f"m64n{nw}k32.s32.s8.s8" in wg
        assert f"case {nw}:" in src or nw == B.STACK_NW[-1]
        assert f"nw == {nw}" in src
    # proj's and fc2's N: 32 or 64 (128 only where the depth is not split)
    assert B.STACK_NW_SHARED == B.STACK_NW[:2]
    assert "(nw == 128 && !split)" in src
    for r in B.STACK_ATT_TILES:
        assert f"attention_items<T, {r}, HDM>" in src
    # five grid barriers a transformer block (one of them skipped after
    # the last block), one after block 0's LayerNorm rows
    loop = src[src.index("for (int l = 0; l < a.L; ++l) {"):]
    assert loop.count("grid.sync();") == 5
    assert src.count("grid.sync();") == 6
    # no split-K: the only atomic counts a token group's arrivals
    assert src.count("atomicAdd(") == 1
    assert "atomicAdd(a.cnt + q, 1u)" in src
    assert not (CSRC / "attention_core.cuh").exists()
    for path in CSRC.iterdir():
        assert "attention_core" not in path.read_text()


def _covers_once(lay, phase):
    """Every output of the phase (feature x token row) in exactly one
    output tile, every tile within its chunk's rows and the matrix."""
    rows = lay.widths(phase)[0]
    wr, nc, nw = B.STACK_WR[phase], lay.nc[phase], lay.nw[phase]
    hits = np.zeros((rows, lay.m), np.uint8)
    for tiles in lay.items(phase):
        if wr == B.STACK_ROWS:  # one tile, the warpgroups split its depth
            assert len(tiles) == 1
        else:  # two weight tiles, one chunk
            assert len(tiles) == 2
            assert tiles[1][0] == tiles[0][0] + B.STACK_ROWS
            assert tiles[0][1] == tiles[1][1]
        assert tiles[0][2] > 0  # no item without work
        for r0, t0, cnt in tiles:
            assert r0 % B.STACK_ROWS == 0 and t0 % 8 == 0
            if cnt > 0:
                assert cnt <= nc <= nw and r0 < rows
                hits[r0:r0 + B.STACK_ROWS, t0:t0 + cnt] += 1
    assert (hits == 1).all()


@pytest.mark.parametrize("int4", [True, False], ids=["int4", "int8"])
@pytest.mark.parametrize("m", ROWS)
@pytest.mark.parametrize("width", sorted(WIDTHS))
def test_every_phase_covers_its_outputs_once(width, m, int4):
    """At D 64, ViT-B's 768 and ViT-H's 1280, at the latency entry's rows
    (208, 592 at 224 / 384 px) and others: each GEMM phase covers its
    outputs exactly once; every wgmma N is a multiple of 8 up to 256 and
    holds its chunk; the ring (3-16 stages) and the attention tile, which
    share the bytes, fit the block's shared memory; the grid is the
    largest phase's items, one an SM."""
    d, heads, hid = WIDTHS[width]
    hd = d // heads
    for itemsize in (2, 4):
        lay = B.stack_layout(m, d, d, hid, int4, itemsize, 1, heads, hd, SMS)
        for phase in range(4):
            _covers_once(lay, phase)
            nc, nw = lay.nc[phase], lay.nw[phase]
            assert nw in (B.STACK_NW_SHARED if phase % 2 else B.STACK_NW)
            assert nw % 8 == 0 and nw <= 256
            assert 8 <= nc <= nw and nc % 8 == 0
            assert lay.steps(phase) * B.STACK_BK == lay.row_bytes(phase)
            depth = lay.widths(phase)[1]
            assert lay.row_bytes(phase) * (2 if int4 else 1) >= depth
        assert 3 <= lay.stages <= B.STACK_MAX_STAGES
        assert lay.smem_bytes + K5_STATIC_SMEM <= H100_BLOCK_SMEM
        ring = lay.stages * lay.stage_bytes
        assert lay.att_smem <= ring < lay.smem_bytes
        assert lay.smem_bytes == (1024 + -(-ring // 16) * 16 + B.STACK_XCHG
                                  + 256)
        # the ring fills STACK_RING (or takes 3 stages), so the shared
        # memory leaves the L1 cache its share
        assert ring <= B.STACK_RING or lay.stages == 3
        assert (ring + lay.stage_bytes > B.STACK_RING
                or lay.stages == B.STACK_MAX_STAGES)
        assert lay.att_rows in B.STACK_ATT_TILES
        assert lay.grid(SMS) == min(SMS, max(
            [lay.att_items] + [len(lay.items(p)) for p in range(4)]))


def test_layouts_at_the_latency_sites():
    """The picks the kernel's note and PERF.md cite: ViT-B/16 batch 1 at
    224 px (208 rows, packed int4, bf16) qkv 18 weight tiles x 7 chunks of
    32 rows, proj and fc2 12 x 9 chunks of 24, fc1 24 x 5 chunks of 48,
    the attention at 32 query rows (84 items, one wave); at 384 px (592
    rows) 32 rows (228 items); every weight tile read once a token chunk,
    every token tile once a weight tile (both depth ranges of a packed
    tile): the L2 bytes of the note."""
    b1 = B.stack_layout(208, 768, 768, 3072, True, 2, 1, 12, 64)
    assert (b1.nc, b1.nw, b1.g) == ((32, 24, 48, 24), (32, 32, 64, 32),
                                    (7, 9, 5, 9))
    assert (b1.att_rows, b1.att_items, b1.stages) == (32, 84, 4)
    assert [len(b1.items(p)) for p in range(4)] == [126, 108, 120, 108]
    packed = {0: 2304 * 384, 1: 768 * 384, 2: 3072 * 384, 3: 768 * 1536}
    for p in range(4):  # each weight byte once a token chunk at least
        assert b1.l2_bytes(p) > b1.g[p] * packed[p]
    assert [round(b1.l2_bytes(p) / 1e6, 1) for p in range(4)] == [
        9.3, 4.6, 10.3, 18.6]
    assert round(sum(b1.l2_bytes(p) for p in range(4)) / 1e6, 1) == 42.8
    px384 = B.stack_layout(592, 768, 768, 3072, True, 2, 1, 12, 64)
    assert (px384.att_rows, px384.att_items) == (32, 228)
    assert b1.grid(SMS) == 126  # qkv's items, the most of any phase


def _levels(x, g, b, d, t, top, pow_, eps):
    """The int8 levels of quant(LN(x)) with the plan's folded gamma / beta:
    the plain K1 prologue through an identity weight (its f32 output is
    the levels, exactly)."""
    k = x.shape[1]
    out = F.fused_quant_matmul_plain(
        x, torch.eye(k, dtype=torch.int8), 1.0, None, fmt="int8",
        prologue="ln_quant", act_d=d, act_t=t, act_top=top, act_pow=pow_,
        ln_scale=g, ln_bias=b, ln_eps=eps, out_dtype=torch.float32,
        prefolded=True)
    return out.to(torch.int8)


def _phase_sums(lay, phase, a, w_k):
    """A GEMM phase of K5 on the CPU in its order, from the kernel's
    weight copy ``w_k`` [N64, kw] (packed int4: byte c holds depth c in
    its low nibble and c + kw in its high one): each warpgroup tile of
    each item the int32 sum over its 128-byte steps of the products of
    the step's A tiles (two depth ranges with packed int4) with the token
    rows' levels ``a`` [M, depth] at those depths; every output written
    once, whole. Returns [M, features] int32."""
    rows = lay.widths(phase)[0]
    depth = a.shape[1]
    kw = w_k.shape[1]
    span = 2 * kw if lay.int4 else kw
    a_pad = torch.zeros((lay.m, span), dtype=torch.int64)
    a_pad[:, :depth] = a.to(torch.int64)
    acc = torch.zeros((lay.m, rows), dtype=torch.int32)
    done = torch.zeros((lay.m, rows), dtype=torch.bool)
    for tiles in lay.items(phase):
        for r0, t0, cnt in tiles:
            if cnt <= 0:
                continue
            r1 = min(r0 + B.STACK_ROWS, rows)
            tile = torch.zeros((cnt, r1 - r0), dtype=torch.int32)
            for c in range(0, kw, B.STACK_BK):
                packed = w_k[r0:r1, c:c + B.STACK_BK]
                ranges = []
                if lay.int4:
                    lo = (packed << 4) >> 4  # arithmetic: int8 nibbles
                    hi = packed >> 4
                    ranges = [(lo, c), (hi, c + kw)]
                else:
                    ranges = [(packed, c)]
                for a_tile, k0 in ranges:
                    part = (a_pad[t0:t0 + cnt, k0:k0 + B.STACK_BK]
                            @ a_tile.to(torch.int64).T)
                    tile += part.to(torch.int32)
            assert not done[t0:t0 + cnt, r0:r1].any()
            done[t0:t0 + cnt, r0:r1] = True
            acc[t0:t0 + cnt, r0:r1] = tile
    assert done.all()
    return acc


def _mirror_block(plan, x, lay, n_valid):
    """One transformer block of K5 on the CPU in its phases' order: LN1
    levels, qkv item by item then acc * qs + qb rounded to the residual
    dtype, the attention's levels (K6's plain version), proj item by item
    then x2 = acc * ps + pb + x, LN2 levels, fc1 then the folded GELU-quant
    (or GELU, then the pow quantizer), fc2 then acc * s2 + b2 + x2."""
    v = {k: t[0] for k, t in plan.vec.items()}
    p = dict(zip(B._SCALARS, plan.prm[0]))
    dt, f32 = x.dtype, torch.float32
    j, n = lay.j_imgs, lay.n
    lv = _levels(x, v["l1g"], v["l1b"], p["act_d"], p["act_t"],
                 plan.act_top, plan.act_pow, plan.ln_eps)
    acc = _phase_sums(lay, 0, lv, plan.kern[0][0])
    qkv = (acc.to(f32) * v["qs"] + v["qb"]).to(dt)
    alv = attention_qkv_plain(
        qkv.reshape(j, n, -1), heads=plan.heads, sm_scale=plan.sm_scale,
        n_valid=n_valid, out_d=p["out_d"], out_t=p["out_t"],
        out_top=plan.out_top, out_pow=plan.out_pow).reshape(j * n, -1)
    acc = _phase_sums(lay, 1, alv, plan.kern[1][0])
    y = acc.to(f32) * v["ps"]
    y = y + v["pb"]
    x2 = (y + x.to(f32)).to(dt)
    lv2 = _levels(x2, v["l2g"], v["l2b"], p["mlp_d"], p["mlp_t"],
                  plan.mlp_top, plan.mlp_pow, plan.ln_eps)
    acc = _phase_sums(lay, 2, lv2, plan.kern[2][0])
    y = acc.to(f32) * v["s1"] + v["b1"]
    if plan.hid_pow:
        hlv = F._quantize_f32(F._gelu_f32(y), p["hid_d"], p["hid_t"],
                              plan.hid_top, True)
    else:
        hlv = F._gelu_quant_folded(y, p["hid_d"], plan.hid_top)
    acc = _phase_sums(lay, 3, hlv, plan.kern[3][0])
    y = acc.to(f32) * v["s2"] + v["b2"]
    return (y + x2.to(f32)).to(dt)


def _stack(rng, d, heads, hid, fmt, pow_):
    """A one-block stack at artifact-like scales (chip_smoke.py's
    operands): weights [1, K(/2), N], folded LayerNorm rows."""
    def w(k, n):
        lv = torch.from_numpy(rng.integers(-7, 8, (1, k, n)).astype(np.int8))
        return pack_int4(lv, axis=1) if fmt == "int4" else lv

    def rows(n, scale, base=0.0):
        return torch.from_numpy((rng.standard_normal((1, n)) * scale
                                 + base).astype(np.float32))

    def scal(v):
        return torch.full((1,), v, dtype=torch.float32)

    t_a, t_h = (1.08, 0.93) if pow_ else (1.0, 1.0)
    g_sc, g_base = (0.1, 1.0) if pow_ else (2.0, 20.0)
    ops = (w(d, 3 * d), rows(3 * d, 2e-4, 1e-3), rows(3 * d, 1e-2),
           rows(d, g_sc, g_base), rows(d, 0.2), w(d, d),
           rows(d, 2e-4, 1e-3), rows(d, 1e-2), rows(d, g_sc, g_base),
           rows(d, 0.2), w(d, hid), rows(hid, 2e-4, 7e-4),
           rows(hid, 1e-2), w(hid, d), rows(d, 2e-4, 1e-3),
           rows(d, 1e-2), scal(0.05), scal(t_a), scal(0.05),
           scal(t_h), scal(0.05), scal(t_a), scal(0.05), scal(t_h))
    return B.plan_block_stack(
        *ops, heads=heads, sm_scale=(d // heads)**-0.5, fmt=fmt,
        act_pow=pow_, out_pow=pow_, mlp_pow=pow_, hid_pow=pow_, act_top=7,
        out_top=7, mlp_top=7, hid_top=7)


@pytest.mark.parametrize("case", [
    ("int4", "bf16", False, 1, None), ("int8", "bf16", False, 1, None),
    ("int4", "f32", True, 1, None), ("int8", "f32", True, 2, None),
    ("int4", "bf16", False, 2, (1, 1, 1, 1)),
    ("int4", "bf16", True, 1, (3, 2, 4, 2))],
    ids=["int4-bf16", "int8-bf16", "int4-f32-pow", "int8-f32-pow-j2",
         "int4-one-group", "int4-set-groups"])
def test_block_mirror_equals_plain(case):
    """The kernel's decomposition changes no bit: one transformer block of
    the mirror (widths off the 128-byte tiles, so the plan's copies are
    padded and packed int4 is repacked at a 128-byte half; ragged
    n_valid; at the picker's token groups and at set ones) equals
    vit_block_stack_plain."""
    fmt, dt_name, pow_, j, groups = case
    dt = torch.bfloat16 if dt_name == "bf16" else torch.float32
    d, heads, hid, n, n_valid = 96, 3, 160, 40, 37
    rng = np.random.default_rng(len(fmt) + 3 * pow_ + 7 * j)
    plan = _stack(rng, d, heads, hid, fmt, pow_)
    x = torch.from_numpy(rng.standard_normal((j * n, d)) * 0.5).to(dt)
    lay = B.stack_layout(j * n, d, d, hid, fmt == "int4", dt.itemsize, j,
                         heads, d // heads, SMS)
    if groups is not None:
        fields = {"nc": [], "nw": [], "g": []}
        for p, g in enumerate(groups):
            nws = B.STACK_NW_SHARED if p % 2 else B.STACK_NW
            g = max(g, -(-lay.m // nws[-1]))  # chunks within the N
            nc = -(-(-(-lay.m // g)) // 8) * 8
            fields["nc"].append(nc)
            fields["g"].append(-(-lay.m // nc))
            fields["nw"].append(next(v for v in nws if v >= nc))
        assert fields["g"][1] == fields["g"][3]  # one count a token group
        lay = dataclasses.replace(lay, **{k: tuple(v)
                                          for k, v in fields.items()})
    for p in range(4):
        _covers_once(lay, p)
    want = B.vit_block_stack_plain(plan, x, n_valid=n_valid, out_dtype=dt,
                                   j_imgs=j)
    assert torch.equal(_mirror_block(plan, x, lay, n_valid), want)


def test_plan_copies_weights_onto_the_tiles():
    """The plan's weight copies as K5's tensor maps read them: the n-major
    stack itself at ViT widths; elsewhere [L, N rounded up to 64, row
    bytes] with zero levels in the padding, packed int4 repacked so that
    its high nibbles sit a whole number of 128-byte steps deeper."""
    w = torch.randint(-8, 8, (2, 3072, 768), dtype=torch.int8)
    packed = pack_int4(w, axis=2)
    assert B._stack_copy(packed, 3072, 768, True) is packed
    assert B._stack_copy(w, 3072, 768, False) is w
    assert (B.stack_row_bytes(768, True), B.stack_row_bytes(1280, True),
            B.stack_row_bytes(96, True), B.stack_row_bytes(96, False)) \
        == (384, 640, 128, 128)
    small = torch.randint(-8, 8, (2, 40, 96), dtype=torch.int8)
    pad = B._stack_copy(small, 40, 96, False)
    assert pad.shape == (2, 64, 128)
    assert torch.equal(pad[:, :40, :96], small)
    assert not pad[:, 40:].any() and not pad[:, :, 96:].any()
    rep = B._stack_copy(pack_int4(small, axis=2), 40, 96, True)
    assert rep.shape == (2, 64, 128)
    lv = unpack_int4(rep, axis=2)  # pairs c and c + 128
    assert torch.equal(lv[:, :40, :96], small)
    assert not lv[:, 40:].any() and not lv[:, :, 96:].any()


def test_kernel_limits():
    """K5 keeps only what it needs: head_dim a multiple of 8 up to 80 and
    16-byte rows. ViT-B/16 at 224 and 384 px (592 key rows, the first
    K5's shared memory refused it) and ViT-H/14 (head_dim 80) serve the
    latency entry; head_dim 96 and widths off 16 are refused."""
    for cfg in (ViTConfig(), ViTConfig(img_size=384),
                ViTConfig(patch_size=14, embed_dim=1280, num_heads=16,
                          depth=2)):
        assert kernel_limits(cfg, latency=True) == []
    assert B.stack_kernel_limit(768, 3072, 64) is None
    assert B.stack_kernel_limit(1 << 13, 1 << 15, 64) is None
    assert B.stack_kernel_limit(1280, 5120, 80) is None
    assert "head_dim 96" in B.stack_kernel_limit(768, 3072, 96)
    assert "head_dim 20" in B.stack_kernel_limit(60, 240, 20)
    assert "multiples of 16" in B.stack_kernel_limit(72, 288, 24)
    assert "multiples of 16" in B.stack_kernel_limit(768, 3080, 64)
    assert "multiples of 16" in B.stack_kernel_limit(768, 3072, 8,
                                                     attn_width=776)
    assert not hasattr(B, "MAX_D") and not hasattr(B, "_QT")


def test_cpu_tensors_never_reach_the_kernel():
    """run_block_stack is the kernel's launcher: a CPU tensor is refused
    (vit_block_stack takes the plain version for it)."""
    plan = _stack(np.random.default_rng(0), 64, 2, 128, "int4", False)
    with pytest.raises(ValueError, match="CUDA tensors"):
        B.run_block_stack(plan, torch.zeros((40, 64)))


@pytest.mark.parametrize("bad", [dict(j_imgs=0), dict(j_imgs=5),
                                 dict(hid_top=0), dict(act_top=-1)],
                         ids=["j0", "j5", "hid_top0", "act_top-1"])
def test_the_jax_refusals_stay(bad):
    """The JAX function's own refusals, in its words: 1-4 images a call
    and positive static tops (block_stack.py:210-218)."""
    rng = np.random.default_rng(1)
    if "j_imgs" in bad:
        plan = _stack(rng, 64, 2, 128, "int4", False)
        with pytest.raises(ValueError, match="j_imgs"):
            B.vit_block_stack_plain(plan, torch.zeros((40, 64)), **bad)
        return
    with pytest.raises(ValueError, match="positive"):
        B._tops(dict(dict(act_top=7, out_top=7, mlp_top=7, hid_top=7),
                     **bad))

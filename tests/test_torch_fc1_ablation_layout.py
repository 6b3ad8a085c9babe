"""The work split of K17's float-prologue fc1 kernel
(``ops/ablations.py:fc1_ln_layout``; ``csrc/fc1_ablation.cu:
fc1_ln_kernel``, which K16's quant and LayerNorm modes also run): its
constants against the source; every output covered once by the blocks'
items and tiles, and each tile's depth by its windows; the shared memory
within the card's 227 KB at every depth; one wave at the tools' shape on
132 SMs (and the waves it claims elsewhere); the panel's swizzled layout
and the epilogue's fragment-to-byte-stage map, each a bijection; a CPU
mirror of the kernel's order (levels, the weight read from its swizzled
boxes, tiles over windows, the epilogue in fragment order) bit-equal to
the plain version; float32 copies of the kernel's rounding
(``round_clip_byte``: the clip, then the magic add, its low byte) and of
its erf-GELU and folded levels (``level_fast``, ``erf_clamped``) equal
to the plain version's at ties, at the tops, past them and at the erf
clamp's edges; and ``fc1_kernel_limit`` refusing and admitting exactly
what it did before the redesign. No JAX: the plain versions are held to
the root tools' Pallas kernels in ``tests/test_torch_ablations.py``."""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from quantized_vit_tpu_torch.ops import ablations as ab

torch.set_num_threads(1)

SRC = (Path(ab.__file__).resolve().parent.parent / "csrc"
       / "fc1_ablation.cu").read_text()
CARD_SMEM = 232448  # an H100's shared memory a block may take (227 KB)
TOOL = (7168, 768, 3072)
SHAPES = [TOOL, (1000, 768, 1540), (17, 768, 3072), (300, 80, 3072),
          (1040, 1280, 5120), (300, 3072, 768), (1, 16, 4),
          (2000, 768, 3072), (1664, 768, 3072), (113, 4096, 260),
          (7, 30000, 8)]
# the panel sizes built: a window of the panel, the panel whole
BUILT_NW = (ab.FC1_LN_WINDOW_NW, ab.FC1_LN_NW)


def _constants():
    """The ``constexpr int L_...`` constants of the source, evaluated."""
    env = {}
    for decl in re.findall(r"constexpr int (L_[^;]+);", SRC):
        for part in re.split(r",\s*(?=L_)", decl):
            name, _, expr = part.partition("=")
            env[name.strip()] = eval(expr, {}, dict(env))
    return env


def test_constants_match_the_source():
    c = _constants()
    assert c["L_TILE"] == ab.FC1_LN_TILE
    assert c["L_BK"] == ab.FC1_LN_BK
    assert c["L_MAX_STAGES"] == ab.FC1_LN_MAX_STAGES
    assert c["L_SMEM"] == ab.FC1_LN_SMEM
    assert c["L_EPI_RS"] == ab.FC1_LN_EPI_RS
    assert c["L_NT"] == ab.FC1_LN_THREADS
    assert c["L_NW"] == ab.FC1_LN_NW
    assert c["L_WINDOW_NW"] == ab.FC1_LN_WINDOW_NW
    assert "ln_kernel_nw<L_NW, true>" in SRC
    assert "ln_kernel_nw<L_WINDOW_NW, false>" in SRC
    # the shared-memory formula of the source at every built panel
    body = re.search(r"int ln_smem\(int nw, int win, int stages\) \{\s*"
                     r"return ([^;]+);", SRC).group(1).replace("\n", " ")
    for nw in BUILT_NW:
        for win, stages in ((1, 2), (6, 7), (12, 8)):
            assert eval(body, {}, dict(c, nw=nw, win=win, stages=stages)) \
                == ab._ln_smem(nw, win, stages)
    assert ab.FC1_LN_SMEM <= CARD_SMEM


def _coverage(lay):
    """Per output, the times the kernel's loops (the producer's and the
    consumers' order) write it; per (item, tile), the steps its windows
    cover."""
    cnt = np.zeros((lay.m, lay.n), np.int32)
    for b in range(lay.grid):
        for i in lay.block_items(b):
            t0, f0, ntile = lay.item(i)
            order = lay.tile_order(i)
            assert sorted(order) == list(range(ntile))
            for j in order:
                steps = []
                for s0 in range(0, lay.steps, lay.win):
                    steps += list(range(s0, min(s0 + lay.win, lay.steps)))
                assert steps == list(range(lay.steps))
                fb = f0 + 64 * j
                cnt[t0:t0 + lay.nw, fb:fb + 64] += 1
    return cnt


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("sms", [132, 114, 8])
def test_every_output_covered_once(shape, sms):
    lay = ab.fc1_ln_layout(*shape, sms=sms)
    assert (_coverage(lay) == 1).all()
    # the blocks' runs partition the items, panel-major
    runs = [i for b in range(lay.grid) for i in lay.block_items(b)]
    assert runs == list(range(lay.items))
    assert lay.waves == max(len(lay.block_items(b))
                            for b in range(lay.grid))
    assert lay.grid == min(lay.items, sms)


@pytest.mark.parametrize("k", [16, 80, 128, 768, 784, 1280, 1536, 1552,
                               2816, 2832, 3072, 5120, 12288, 30000,
                               100000])
def test_shared_memory_fits_at_every_depth(k):
    lay = ab.fc1_ln_layout(1000, k, 768)
    assert lay.smem_bytes <= ab.FC1_LN_SMEM <= CARD_SMEM
    assert 2 <= lay.stages <= ab.FC1_LN_MAX_STAGES
    assert 1 <= lay.win <= lay.steps
    assert lay.f % ab.FC1_LN_TILE == 0
    if not lay.whole:  # a window of the panel: one tile a warpgroup
        assert lay.f == 2 * ab.FC1_LN_TILE
        assert lay.nw == ab.FC1_LN_WINDOW_NW
    # no larger ring or window would fit
    assert (ab._ln_smem(lay.nw, lay.win, lay.stages + 1) > ab.FC1_LN_SMEM
            or lay.stages == ab.FC1_LN_MAX_STAGES)


def test_tool_shape_is_one_wave():
    lay = ab.fc1_ln_layout(*TOOL, sms=132)
    assert (lay.nw, lay.f, lay.win, lay.stages) == (112, 1536, 6, 7)
    # 64 panels x 2 feature ranges
    assert (lay.items, lay.grid, lay.waves) == (128, 128, 1)
    assert lay.whole and lay.smem_bytes == 219904
    # the weight through L2: 64 panels x 3072 rows x 768 bytes (151 MB),
    # against the old 128 x 128 tile's 56 x 24 tiles x 2 x 128 x 768 (264
    # MB)
    assert lay.weight_bytes() == 64 * 3072 * 768
    assert lay.weight_bytes() < 56 * 24 * 2 * 128 * 768


def _limit_before(m, k, n, fmt):
    """fc1_kernel_limit as it was before the float prologues moved to the
    wgmma kernel (frozen)."""
    if k % 16 or (fmt == "int4" and (k // 2) % 16) or n % 4 or m < 1:
        return (f"fc1_ablation: needs K % 16 == 0 (packed int4: K/2 % 16 == "
                f"0) and N % 4 == 0, got M {m}, K {k}, N {n} ({fmt})")
    return None


def test_kernel_limit_unchanged():
    for fmt in ("int8", "int4"):
        for m in (0, 1, 17, 7168):
            for k in list(range(0, 300)) + [768, 1280, 3072, 30000, 30001]:
                for n in (0, 1, 4, 6, 64, 1540, 3072):
                    assert ab.fc1_kernel_limit(m, k, n, fmt) == \
                        _limit_before(m, k, n, fmt), (m, k, n, fmt)


@pytest.mark.parametrize("nw", BUILT_NW)
def test_panel_layout_is_the_swizzle_wgmma_reads(nw):
    """panel_levels' stores (a 16-level unit u of row r at window step s,
    physical piece (u % 8) ^ (r % 8)) fill the window's bytes once, and the
    128-byte swizzle the descriptors read (row r's logical piece c at c ^
    (r % 8) within its 1024-byte atom) finds each level where it was
    put."""
    win = 3
    seen = {}
    for r in range(nw):
        for u in range(win * 8):
            s, pc = divmod(u, 8)
            off = s * nw * 128 + r * 128 + ((pc ^ (r & 7)) << 4)
            assert off not in seen
            seen[off] = (r, u)
    assert sorted(seen) == list(range(0, win * nw * 128, 16))
    for (r, u) in seen.values():
        s, c = divmod(u, 8)
        atom = s * nw * 128 + (r // 8) * 1024
        read = atom + (r % 8) * 128 + ((c ^ (r % 8)) << 4)
        assert seen[read] == (r, u)


def _fragments(hw):
    """(thread, accumulator index) -> (feature, token) of a warpgroup's
    64 x hw wgmma tile (wgmma_int8.cuh's note; hw, the panel's tokens),
    and the byte-stage address ln_epilogue stores it at."""
    out = []
    for tid in range(128):
        wq, lane = tid >> 5, tid & 31
        g, tq = lane >> 2, lane & 3
        for j in range(hw // 8):
            for h in range(2):
                for x in range(2):
                    r = 2 * h + x
                    feat = 16 * wq + g + 8 * (r >= 2)
                    tok = 8 * j + 2 * tq + (r & 1)
                    addr = ((8 * j + 2 * tq + x) * ab.FC1_LN_EPI_RS
                            + 16 * wq + g + 8 * h)
                    out.append((tid, 4 * j + r, feat, tok, addr))
    return out


@pytest.mark.parametrize("nw", BUILT_NW)
def test_epilogue_stage_map(nw):
    """Every (feature, token) of a warpgroup's tile once, each at stage
    byte tok * 80 + feature; the stores of a warp's 32 lanes for one
    accumulator fall in distinct banks or the same word; the 16-byte
    pieces read back cover the stage's levels once."""
    hw = nw
    assert hw % 8 == 0  # the panel's rows fill whole swizzle atoms
    frags = _fragments(hw)
    pairs = {(f, t) for _, _, f, t, _ in frags}
    assert len(pairs) == len(frags) == 64 * hw
    for _, _, f, t, addr in frags:
        assert addr == t * ab.FC1_LN_EPI_RS + f
    by_warp = {}
    for tid, i, _, _, addr in frags:
        by_warp.setdefault((tid >> 5, i), []).append(addr)
    for addrs in by_warp.values():
        words = {a // 4 for a in addrs}
        assert len({w % 32 for w in words}) == len(words)
    pieces = [(p >> 2, p & 3) for p in range(hw * 4)]
    covered = sorted(tok * ab.FC1_LN_EPI_RS + 16 * c + e
                     for tok, c in pieces for e in range(16))
    assert covered == sorted(t * ab.FC1_LN_EPI_RS + f for f, t in pairs)


def _mirror(x, w, v, lay, **kw):
    """The kernel's order on the CPU: each block's items, each window's
    levels of the panel (the plain prologue's rows, zeros past M and K),
    each tile's int32 sums over the windows' steps on the whole panel,
    then the epilogue in fragment order into the stage and out in 16-byte
    pieces."""
    m, k, n = lay.m, lay.k, lay.n
    lv = ab.fc1_prologue_plain(x, v.prologue, ln_g=kw.get("ln_g"),
                               ln_b=kw.get("ln_b")).to(torch.int64)
    kp = lay.steps * 128
    lvp = torch.zeros((lay.panels * lay.nw, kp), dtype=torch.int64)
    lvp[:m, :k] = lv
    # the kernel's weight boxes, read back through the swizzle
    steps = lay.steps
    boxes = ab.fc1_ln_weight(w, k, n).reshape(lay.tiles, steps, 64, 8, 16)
    rows = torch.arange(64)
    pieces = torch.arange(8)[None, :] ^ (rows[:, None] % 8)
    logical = torch.gather(boxes, 3, pieces[None, None, :, :, None].expand(
        boxes.shape))  # the swizzle is its own inverse
    wp = logical.permute(1, 3, 4, 0, 2).reshape(kp, lay.tiles * 64).to(
        torch.int64)
    scale = kw.get("scale", ab.SCALE)
    out = torch.full((m, n), 99, dtype=torch.int8)
    hw = lay.nw
    frags = _fragments(hw)
    for b in range(lay.grid):
        for i in lay.block_items(b):
            t0, f0, _ = lay.item(i)
            for j in lay.tile_order(i):
                fb = f0 + 64 * j
                acc = torch.zeros((64, hw), dtype=torch.int64)
                for s0 in range(0, lay.steps, lay.win):
                    s1 = min(s0 + lay.win, lay.steps)
                    a = lvp[t0:t0 + hw, 128 * s0:128 * s1]
                    acc += (wp[128 * s0:128 * s1, fb:fb + 64].T @ a.T)
                feats = torch.arange(fb, fb + 64)
                live = feats < n
                sc = torch.zeros(64)
                sc[live] = (scale[feats[live]] if v.vscale
                            else torch.tensor(float(scale)))
                y = acc.to(torch.int32).to(torch.float32) * sc[:, None]
                if v.bias:
                    bi = torch.zeros(64)
                    bi[live] = kw["bias"][feats[live]]
                    y = y + bi[:, None]
                levels = ab.fc1_epilogue_plain(y, v.epilogue)[1]
                stage = torch.zeros(hw * ab.FC1_LN_EPI_RS, dtype=torch.int8)
                for _, _, f, t, addr in frags:
                    stage[addr] = levels[f, t]
                for p in range(hw * 4):
                    tok, c = p >> 2, p & 3
                    row, f = t0 + tok, fb + 16 * c
                    if row >= m or f >= n:
                        continue
                    o = tok * ab.FC1_LN_EPI_RS + 16 * c
                    e = min(16, n - f)
                    out[row, f:f + e] = stage[o:o + e]
    return out


@pytest.mark.parametrize("mode,m,k,n,sms", [
    ("lean", 130, 768, 200, 3), ("bias", 70, 80, 132, 5),
    ("folded", 20, 3072, 136, 2), ("vscale", 9, 30000, 4, 1),
    ("lean", 300, 768, 64, 132)])
def test_mirror_of_the_kernel_order_is_the_plain_version(mode, m, k, n, sms):
    """Bit-equal at a whole panel (K 768, 80) and in window mode (K 3072,
    30000), ragged M and N (N % 16 != 0: the 4-byte words), several
    panels a block and one block a panel."""
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((m, k))).to(torch.bfloat16)
    w = torch.from_numpy(rng.integers(-16, 17, (k, n)).astype(np.int8))
    v = ab.EXP_PRO2_MODES[mode]
    kw = dict(ln_g=torch.from_numpy((rng.standard_normal(k) * 4).astype(
                  np.float32)),
              ln_b=torch.from_numpy((rng.standard_normal(k) * 2).astype(
                  np.float32)))
    if v.vscale:
        kw["scale"] = torch.from_numpy(
            (rng.uniform(0.5, 1.5, n) * 1e-3).astype(np.float32))
    if v.bias:
        kw["bias"] = torch.from_numpy(
            (rng.standard_normal(n) * 0.5).astype(np.float32))
    lay = ab.fc1_ln_layout(m, k, n, sms=sms)
    assert lay.whole == (k <= 1536)
    got = _mirror(x, w, v, lay, **kw)
    want = ab.fc1_ablation_plain(x, w, v, **kw)
    assert torch.equal(got, want)


# float32 copies of the kernel's rounding and erf-GELU / folded levels
# (csrc/fc1_ablation.cu: round_clip_byte, erf_clamped, level_fast), in
# numpy's float32, which neither fuses nor reorders
F = np.float32
C2 = F(0.7071067811865476)
ERF = [F(1.6343068626e-04), F(-4.6024812456e-03), F(5.0755384214e-02),
       F(-2.8632930819e-01), F(1.0820510812e+00)]


def _round_clip_byte(r, top):
    """fminf(fmaxf(r, -top), top) + 1.5 * 2^23, the low byte of its bits
    (NaN clips to -top: fmaxf takes the number)."""
    c = np.fmin(np.fmax(r, F(-top)), F(top))
    bits = (c + F(ab.MAGIC)).astype(F).view(np.uint32)
    return (bits & 0xFF).astype(np.uint8).view(np.int8)


def _erf_clamped(v):
    v2 = v * v
    acc = ERF[0]
    for c in ERF[1:]:
        acc = acc * v2 + c
    return acc * v


def _level_fast(y, epilogue):
    inv_d, top = F(ab.INV_D), F(ab.TOP)
    if epilogue == "gelu_erf":
        z = np.fmin(np.fmax(y * C2, F(-3)), F(3))
        w = z * C2 * inv_d
        return _round_clip_byte(w + w * _erf_clamped(z), top)
    c2 = F(0.70710678118654757) / F(ab.OUT_D)
    w = y * c2
    e = _erf_clamped(np.fmin(np.fmax(y, F(-3)), F(3)))
    return _round_clip_byte(w + w * e, top)


def _ties_and_tops():
    """Half-integer ties, their float32 neighbours, the tops, past them."""
    h = np.arange(-9, 9, dtype=F) + F(0.5)
    r = np.concatenate([h, np.nextafter(h, F(-np.inf)),
                        np.nextafter(h, F(np.inf)),
                        np.arange(-9, 10, dtype=F),
                        [F(-0.0), F(1e-30), F(-1e-30), F(2**22), F(-2**22),
                         F(1e10), F(-1e10), F(np.inf), F(-np.inf)]])
    return r.astype(F)


def test_round_clip_byte_is_the_plain_rounding():
    """clip before the magic add equals the plain versions' round, then
    clip (the epilogue's ``_levels(round(pre))`` and the prologues'
    ``clamp(round(v))``) at every tie, at and past the tops; NaN goes to
    -top (the plain version's f32 -> int8 cast of NaN is undefined)."""
    assert "__fadd_rn(fminf(fmaxf(r, -top), top), MAGIC))" in SRC
    r = _ties_and_tops()
    got = torch.from_numpy(_round_clip_byte(r, ab.TOP))
    rt = torch.from_numpy(r)
    assert torch.equal(got, ab._levels(torch.round(rt)))
    assert torch.equal(got, ab.fc1_prologue_plain(rt, "quant"))
    assert _round_clip_byte(np.array([np.nan], F), ab.TOP)[0] == -ab.TOP


@pytest.mark.parametrize("epilogue", ["gelu_erf", "folded"])
def test_level_fast_is_the_plain_epilogue(epilogue):
    """The kernel's erf-GELU and folded levels at a dense sweep of y, at
    the erf clamp's edges (y * C2 = +-3, y = +-3) and their float32
    neighbours, where the level is a tie and far past the tops."""
    fast = SRC[SRC.index("uint32_t level_fast("):]
    fast = re.sub(r"\s+", " ", fast[:fast.index("} else {")])
    assert ("const float z = fminf(fmaxf(y * C2, -3.0f), 3.0f); const float "
            "e = erf_clamped(z); const float w = z * C2 * a.inv_d; return "
            "round_clip_byte(w + w * e, a.out_top);") in fast
    assert ("const float e = erf_clamped(fminf(fmaxf(y, -3.0f), 3.0f)); "
            "const float w = y * a.c2; return round_clip_byte(w + w * e, "
            "a.out_top);") in fast
    edge = np.array([3 / C2, -3 / C2, 3, -3], F)
    edges = np.concatenate([edge, np.nextafter(edge, F(np.inf)),
                            np.nextafter(edge, F(-np.inf))])
    sweep = np.linspace(-12, 12, 480001, dtype=F)
    y = np.concatenate([sweep, edges, _ties_and_tops() / F(ab.INV_D),
                        np.array([1e3, -1e3, 1e30, -1e30, 0, -0.0], F)])
    y = y[np.isfinite(y)].astype(F)  # y: an int32 sum times a finite scale
    got = torch.from_numpy(_level_fast(y, epilogue))
    want = ab.fc1_epilogue_plain(torch.from_numpy(y), epilogue)[1]
    assert torch.equal(got, want)
    # the sweep reaches the top and every level down to GELU's least
    assert set(got.tolist()) == set(range(int(got.min()), ab.TOP + 1))
    assert int(got.min()) < 0

"""K19's layout and the premise of its exact MMAs, on the CPU.

K19 (``csrc/attn_ablation.cu``, ``ops/ablations.py:exp_attn2``) runs
blocks of 4 warps over a grid (share, head, image group): a block takes
the tasks (image j, query tile t) of its image group with (j nmt + t) % S
== share, J images one after another, and gives its u-th task to warp
u % 4. K and V arrive by TMA, raw bf16, in a ring of 7 slots of 32 keys
(a K box and a V box of 32 rows of 128 bytes in the 128-byte swizzle:
16-byte piece p of row r at p ^ (r % 8)), one stage a slot of an image:
once for all of the block's tiles of that image when the keys fit the
ring, else once a round of tiles. Only the keys up to the last key tile
that holds a real key (nkr = min(nk, n_valid rounded up to 8)) are staged
and read: the keys past it have p = 0 and add nothing. A warp streams its
16-row query tile (q staged in shared memory in the same swizzle) over
those keys 16 at a time (8 in a last odd key tile) on m16n8k8 .f64: the
scores' k-lane t (t + 4) of octet m is head column 8 m + 2 t (+ 1), q held
as the high words of its f64 values (256-byte rows, 16-byte chunk 2 o + e
holding columns 8 o + e, + 2, + 4, + 6); D element q of key tile j is row
g + 8 (q / 2), key 8 j + 2 t + q % 2, which is P.V's k-lane t + 4 (q % 2)
of key tile j, so p passes from registers.

These tests emulate the kernel in Python: the grid's and the ring's maps
take every (image, query tile, key) exactly once a pass; the ldmatrix
addresses of q, K and V (swizzle included) give each lane the (row,
column) pairs the MMAs' fragments need; and the sums added in the
kernel's order (scores by k-step, p's row sums lane by lane then the
quad's xor 1 and xor 2, P.V key tile by key tile), rounded once to f32
and followed by the epilogue, give ``exp_attn2_plain``'s levels bit for
bit at the root tool's shape and data (its first four images). At that
data every such f64 sum is exact, so the order does not change the bits;
the kernel itself, and its order on the card, are held to the plain
version in ``chip_smoke.py`` phase 3d.
"""

import functools

import numpy as np
import pytest
import torch

from quantized_vit_tpu_torch.ops import ablations as ab
from quantized_vit_tpu_torch.ops.attention import _LOG2E

torch.set_num_threads(1)

LIMIT = 232448  # the shared memory a block can use on Hopper
SM_SMEM = 233472  # an SM's, 1 KB of it reserved for each resident block
NW, SEG, NSLOT = 4, 32, 7  # attn_ablation.cu's A2_NW, A2_SEG, A2_NSLOT
BOX = SEG * 128  # A2_BOX: a slot's K (or V) box
# the root tool's shape: images, queries, heads, head_dim, real tokens
B, N, H, HD, NV = 32, 224, 12, 64, 197
B4 = 4  # the images these tests emulate


def _nkr(nk, nv):
    """The keys K19 reads: up to the last key tile with a real key."""
    return min(nk, -(-max(nv, 0) // 8) * 8)


def _grid(b, n, nkr, j):
    """Each block's tasks as attn2_kernel lays them out for nkr keys read:
    a list of dicts with the block's image group, passes, slots an image
    and, per warp, its tasks (image, query tile, first stage, last over
    those stages)."""
    nmt = -(-n // 16)
    s_ = min(j, nmt)
    ns = -(-nkr // SEG)
    passes = 1 if ns <= NSLOT else (-(-nmt // s_) + 3) >> 2
    blocks = []
    for z in range(b // j):
        for sh in range(s_):
            warps = [[] for _ in range(NW)]
            u0 = 0
            for jj in range(j):
                r = (sh - jj * nmt) % s_
                cnt = (nmt - r + s_ - 1) // s_
                for w in range(NW):
                    first = u0 + ((w - u0) & 3)
                    for p in range(passes):
                        lo = first if passes == 1 else first + 4 * p
                        hi = (u0 + cnt if passes == 1
                              else min(u0 + cnt, u0 + 4 * p + 4))
                        for u in range(lo, hi, 4):
                            warps[w].append((z * j + jj, r + s_ * (u - u0),
                                             (jj * passes + p) * ns,
                                             u + 4 >= hi))
                u0 += cnt
            blocks.append({"z": z, "passes": passes, "ns": ns,
                           "warps": warps})
    return blocks


def _stage_keys(nk, ns, k):
    """The keys stage k of a block puts in its slot, by row (rows past nk
    are TMA's zeros)."""
    r0 = (k % ns) * SEG
    return list(range(r0, min(r0 + SEG, nk)))


def _slot_tiles(nkr, s):
    """The key tiles of 8 rows a2_tile runs in slot s: those with a key
    read."""
    return min(4, -(-(nkr - SEG * s) // 8))


@pytest.mark.parametrize("nk,nv", [(1, 1), (37, 37), (208, 197),
                                   (300, 290), (20, 0)])
@pytest.mark.parametrize("head_dim", [8, 40, 64])
def test_maps_take_each_index_once(head_dim, nk, nv):
    """Every (image, query tile) once over the grid (a block a head), for
    J = 1, 2, 4, the tiles of a warp in order of images; every key read
    staged once a pass; each warp done with every stage exactly once;
    every key read once a tile over its slots' key tiles, from the stage
    and row the kernel reads; the keys left out are past n_valid; every
    head column once over the scores' k-lanes (t, t + 4 of octet m: 8 m +
    2 t, + 1) and over P.V's column tiles, for the head's octets alone."""
    hdt = head_dim // 8
    cols = [8 * m + 2 * t + e for m in range(hdt) for t in range(4)
            for e in range(2)]
    assert sorted(cols) == list(range(head_dim))
    n = max(nk, 37)
    nkr = _nkr(nk, nv)
    assert nkr >= min(nk, nv) and (nkr == nk or nkr - nv < 8)
    nk = nkr
    for j in (1, 2, 4):
        taken = {}
        for blk in _grid(4, n, nk, j):
            ns, passes = blk["ns"], blk["passes"]
            per_img = passes * ns
            staged = {}
            for k in range(j * per_img):
                img = blk["z"] * j + k // per_img
                for key in _stage_keys(nk, ns, k):
                    staged[(img, key)] = staged.get((img, key), 0) + 1
            assert all(v == passes for v in staged.values())
            assert len(staged) == j * nk
            for tasks in blk["warps"]:
                assert [t[0] for t in tasks] == sorted(t[0] for t in tasks)
                done = [k0 + c for _, _, k0, last in tasks if last
                        for c in range(ns)]
                busy = {k0 for _, _, k0, _ in tasks}
                idle = [k0 + c for k0 in range(0, j * per_img, max(ns, 1))
                        if k0 not in busy for c in range(ns)]
                assert sorted(done + idle) == list(range(j * per_img))
                for img, mt, k0, _ in tasks:
                    taken[(img, mt)] = taken.get((img, mt), 0) + 1
                    keys = []
                    for s in range(ns):
                        rows = _stage_keys(nk, ns, k0 + s)
                        for r in range(8 * _slot_tiles(nk, s)):
                            if r < len(rows):
                                assert rows[r] == SEG * s + r
                                keys.append(rows[r])
                    assert sorted(keys) == list(range(nk))
        assert sorted(taken) == [(img, mt) for img in range(4)
                                 for mt in range(-(-n // 16))]
        assert set(taken.values()) == {1}


def test_tool_grid_balance():
    """At the tool's shape every J gives 384 blocks (12 heads) of 14
    tile-tasks each, 4, 4, 3 and 3 to the warps; 200 of the 208 keys are
    read (25 key tiles, 7 slots)."""
    nkr = _nkr(ab._n_keys(N, NV, 2), NV)
    assert nkr == 200
    for j in ab.EXP_ATTN2_J:
        blocks = _grid(B, N, nkr, j)
        assert len(blocks) * H == 384
        for blk in blocks:
            assert sorted(map(len, blk["warps"])) == [3, 3, 4, 4]


def _unswizzle(addr, pitch=128):
    """(row, logical 16-byte chunk) of a byte offset into rows of `pitch`
    bytes in the 128-byte swizzle (chunk c of row r at (c & 8) | ((c & 7)
    ^ (r % 8)))."""
    assert addr % 16 == 0
    row, c = addr // pitch, (addr % pitch) // 16
    return row, (c & 8) | ((c & 7) ^ (row % 8))


def _ldsm(addr_of, trans=False, pitch=128):
    """What each lane (g = lane / 4, t = lane % 4) receives from matrix i
    of an ldmatrix whose lane l gives the address addr_of(l), as (row,
    16-byte chunk, 16-bit element) of both halves: row r of matrix i is
    lane 8 i + r's row. Without .trans a lane gets row g, elements 2 t, 2 t
    + 1 (its 32-bit word t); with it rows 2 t, 2 t + 1, element g."""
    got = {}
    for lane in range(32):
        g, t = lane >> 2, lane & 3
        for i in range(4):
            if trans:
                got[(lane, i)] = [_unswizzle(addr_of(8 * i + 2 * t + e),
                                             pitch) + (g,) for e in range(2)]
            else:
                row, c = _unswizzle(addr_of(8 * i + g), pitch)
                got[(lane, i)] = [(row, c, 2 * t + e) for e in range(2)]
    return got


def test_ldmatrix_addresses_give_the_fragments():
    """a2_keys' ldmatrix addresses (lane l: x = l % 8, xs = x << 4, lo = l
    / 8) against m16n8k8's fragments (A[g + 8 hh][t + 4 e], B[t + 4 e][g]):
    q's register 2 e + hh holds row g + 8 hh, head column 8 m + 2 t + e (the
    32-bit word t of chunk 2 m + e); K's register x holds key 8 (x % 2) +
    g, columns 8 (m0 + x / 2) + 2 t + e (its halves e), so A's and B's
    k-lane t + 4 e is the same column; V's register i (.trans) holds keys 2
    t + e of the key tile, P.V's k-lane t + 4 e, at column 8 (n0 + i) + g."""
    qx = lambda l: (l & 7) ^ (l >> 4)
    for m in range(8):
        qw = _ldsm(lambda l: ((l & 7) + 8 * ((l >> 3) & 1)) * 256 + (
            ((2 * m) & 8) | (((2 * m) & 7) ^ qx(l))) * 16, pitch=256)
        for lane in range(32):
            g, t = lane >> 2, lane & 3
            for e in range(2):
                for hh in range(2):
                    row, c, el = qw[(lane, 2 * e + hh)][0]
                    assert (row, c, el // 2) == (g + 8 * hh, 2 * m + e, t)
                    # chunk 2 m + e, word t: head column 8 m + e + 2 t
                    assert 8 * (c >> 1) + (c & 1) + 2 * (el // 2) == (
                        8 * m + 2 * t + e)
    for m0 in range(0, 8, 2):
        kb = _ldsm(lambda l: (((l >> 3) & 1) * 8 + (l & 7)) * 128 + (
            ((m0 + (l >> 4)) << 4) ^ ((l & 7) << 4)))
        for lane in range(32):
            g, t = lane >> 2, lane & 3
            for x in range(4):
                for e in range(2):
                    row, c, el = kb[(lane, x)][e]
                    assert (row, 8 * c + el) == (8 * (x % 2) + g,
                                                 8 * (m0 + x // 2) + 2 * t + e)
    for jt in range(2):
        for n0 in (0, 4):
            vb = _ldsm(lambda l: jt * 1024 + (l & 7) * 128 + (
                ((n0 + (l >> 3)) << 4) ^ ((l & 7) << 4)), trans=True)
            for lane in range(32):
                g, t = lane >> 2, lane & 3
                for i in range(4):
                    assert [(r, 8 * c + el) for r, c, el in vb[(lane, i)]] == [
                        (8 * jt + 2 * t + e, 8 * (n0 + i) + g)
                        for e in range(2)]


def test_bf16_operands_convert_exactly():
    """Every bf16 (both zeros, the subnormals, the largest, inf and NaN) is
    exact in f32 and in f64, and its f64 has a zero low word, so q's f64
    high words alone hold it; every product of two bf16 is exact in f64."""
    bits = np.arange(1 << 16, dtype=np.uint32)
    f32 = (bits << np.uint32(16)).view(np.float32)
    with np.errstate(invalid="ignore"):  # the signalling NaNs
        f64 = f32.astype(np.float64)
    real = ~np.isnan(f32)
    assert np.array_equal(f64[real].astype(np.float32).view(np.uint32),
                          f32[real].view(np.uint32))
    assert not (f64.view(np.uint64) & np.uint64(0xFFFFFFFF)).any()
    top = np.float64(np.uint32(0x7F7F0000).view(np.float32))
    assert np.isfinite(top * top) and (top * top) / top == top


def test_integer_built_operands():
    """The bf16 -> f64 operand built by integer operations, as
    ``attn_ablation.cu:bf_f64`` builds it at ``QVT_A2_OFF`` 5 and
    ``tools/exp_attn_design.py:bits_f64_exact`` times it (sign, exponent +
    896, mantissa; subnormals converted), is every finite bf16 exactly;
    the probe's stand-in without the bias (``bits_f64``) is every finite
    bf16 times 2^-896, so it times less work than the route."""
    bits = np.arange(1 << 16, dtype=np.uint32)
    x = bits << np.uint32(16)
    f32 = x.view(np.float32)
    finite = np.isfinite(f32)
    field = (x.view(np.int32) >> 3) & np.int32(np.uint32(0x8FFFE000).view(
        np.int32))
    ex = x & np.uint32(0x7F800000)
    sub = (ex == 0) & ((x & np.uint32(0x007F0000)) != 0)
    hi = (field + np.where(ex != 0, 896 << 20, 0).astype(np.int32)).view(
        np.uint32)
    built = (hi.astype(np.uint64) << np.uint64(32)).view(np.float64)
    built = np.where(sub, f32.astype(np.float64), built)
    want = f32[finite].astype(np.float64)
    assert np.array_equal(built[finite].view(np.uint64),
                          want.view(np.uint64))
    stand_in = (field.view(np.uint32).astype(np.uint64)
                << np.uint64(32)).view(np.float64)
    assert np.array_equal(stand_in[finite], want * 2.0 ** -896)


@functools.lru_cache(maxsize=None)
def _tool_qkv():
    """The root tool's qkv (seed 0, N(0, 0.1^2) in bf16), its first four
    images."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((B4, N, 3 * H * HD)) * 0.1
    return torch.from_numpy(x).to(torch.bfloat16)


def _emulate(x, d):
    """K19's output emulated in its order of summation (f64), rounded and
    finished as the kernel finishes."""
    nk = ab._n_keys(N, NV, 2)
    nkr = _nkr(nk, NV)
    xr = x.reshape(B4, N, 3, H, HD).permute(0, 3, 2, 1, 4).float()
    q = (xr[:, :, 0] * (ab.SM_SCALE * _LOG2E)).to(torch.bfloat16).double()
    k = xr[:, :, 1, :nk].double()
    v = xr[:, :, 2, :nk].double()
    o = torch.zeros((B4, H, N, HD), dtype=torch.float64)
    lanes = torch.zeros((4, B4, H, N), dtype=torch.float64)
    for s in range(-(-nkr // SEG)):
        for jt in range(_slot_tiles(nkr, s)):
            k0 = SEG * s + 8 * jt
            keys = torch.arange(k0, min(k0 + 8, nk))
            if not len(keys):
                continue
            sc = torch.zeros((B4, H, N, len(keys)), dtype=torch.float64)
            for m in range(HD // 8):
                for e in range(2):
                    cols = [8 * m + 2 * t + e for t in range(4)]
                    sc = sc + torch.einsum("bhnc,bhkc->bhnk", q[..., cols],
                                           k[:, :, keys][..., cols])
            sc = sc.float()
            p = torch.where(keys < NV,
                            torch.exp2(torch.clamp_max(sc, 100.0)),
                            torch.zeros_like(sc))
            for i, key in enumerate(keys.tolist()):
                t = (key % 8) // 2
                lanes[t] = lanes[t] + p[..., i].double()
            pb = p.to(torch.bfloat16).double()
            for e in range(2):
                sel = [i for i, key in enumerate(keys.tolist())
                       if key % 2 == e]
                o = o + torch.einsum("bhnk,bhkc->bhnc", pb[..., sel],
                                     v[:, :, keys[sel]])
    x1 = [lanes[t] + lanes[t ^ 1] for t in range(4)]
    rs = (x1[0] + x1[2]).float()
    inv = 1.0 / ((rs + np.float32(1e-30)) * np.float32(d))
    lv = torch.clamp(torch.round(o.float() * inv[..., None]), -ab.TOP,
                     ab.TOP).to(torch.int8)
    return lv.permute(0, 2, 1, 3).reshape(B4, N, H * HD)


def test_sums_in_the_kernel_order_give_the_plain_levels():
    x = _tool_qkv()
    want = ab.exp_attn2_plain(x, 0.05, heads=H, n_valid=NV)
    assert torch.equal(_emulate(x, 0.05), want)


def _a2_smem():
    """A copy of attn_ablation.cu:A2_SMEM: 1 KB to align the ring, 7 slots
    of a K and a V box, the 4 warps' q tiles (16 rows of 64 f64 high
    words), a full mbarrier and a count a slot."""
    return 1024 + NSLOT * 2 * BOX + NW * 16 * 256 + NSLOT * (8 + 4)


def test_smem_mirror_lets_three_blocks_share_an_sm():
    """74,836 bytes a block: it fits a block's 232,448 and three blocks
    share an SM (with the card's 1 KB a block), as the C source's
    static_assert says; at most 168 registers a thread (launch bounds 128,
    3) let three blocks hold an SM's 65,536 registers too. The ring's 7
    slots hold the tool's 200 keys read, so they are read once a block."""
    smem = _a2_smem()
    assert smem == 74836 and smem <= LIMIT
    assert NSLOT * SEG >= _nkr(ab._n_keys(N, NV, 2), NV)
    assert SM_SMEM // (smem + 1024) == 3
    assert 65536 // (168 * 128) == 3


def _first_limit(b, n, n_valid, heads, head_dim, j):
    """A frozen copy of the first K19's limits: ops/ablations.py
    (qkv_kernel_limit's head_dim <= 80 in multiples of 8, at most 64, J
    dividing B) and qvt_exp_attn2's checks (head_dim >= 8, nk <= N,
    n_valid <= nk, B / J and heads <= 65535), with a grid the card
    launches (B, N and heads >= 1)."""
    nk = ab._n_keys(n, n_valid, 2)
    return (8 <= head_dim <= 64 and head_dim % 8 == 0 and nk <= n
            and n_valid <= nk and j >= 1 and b % j == 0
            and b // j <= 65535 and heads <= 65535 and b >= 1 and n >= 1
            and heads >= 1)


def test_limit_takes_every_shape_the_first_kernel_took():
    taken = 0
    for b in (1, 2, 4, 6, 32, 65536 * 2):
        for n, nv in ((1, 1), (17, 1), (37, 37), (224, 197), (300, 290),
                      (300, 301), (1000, 1000), (20, 0), (20, -3)):
            for heads in (1, 3, 12, 65535, 65536):
                for hd in (0, 4, 8, 16, 40, 56, 64, 72, 80):
                    for j in (0, 1, 2, 4, 3):
                        old = _first_limit(b, n, nv, heads, hd, j)
                        new = ab.attn2_kernel_limit(b, n, nv, heads, hd,
                                                    j) is None
                        assert new or not old, (b, n, nv, heads, hd, j)
                        taken += new
    assert taken > 0
    for j in ab.EXP_ATTN2_J:
        assert ab.attn2_kernel_limit(B, N, NV, H, HD, j) is None

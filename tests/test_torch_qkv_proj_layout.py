"""K9's layout and the premise of its exact MMA, on the CPU.

``ops/attention.py:qkv_proj_layout`` picks K9's (query rows R, cluster
size G) from the card's SMs and shared memory; ``qkv_proj_smem_bytes``
mirrors ``csrc/attention_proj.cu:smem_bytes`` and ``qkv_proj_kernel_limit``
reads it. The limit must take every shape the first K9 took: it is held
here against a frozen copy of that kernel's formula. The MMA-order checks
sum the float path's scores, p . v and p sums in f64 in the order K9's
m16n8k4 MMAs and its reductions add them, and compare with the plain
version's dots (``_dot_f32``, f64 rounded once to f32) and row sum
(``sum_f32``): bit-equal for bf16; for f32 within one ulp, the flips
counted.
"""

import numpy as np
import pytest
import torch

import quantized_vit_tpu_torch.ops.attention as A

torch.set_num_threads(1)

H100 = dict(sms=132, sm_smem=233472)
LIMIT = 232448  # the shared memory a block can use on Hopper

# the timing sites: ViT-H/14 at batch 8, ViT-B/16 at batch 32 (padded
# tokens, heads, head_dim)
SITES = {"vith_b8": (8, 272, 16, 80), "vitb_b32": (32, 208, 12, 64)}


def _blocks(b, n, rows, cluster):
    return -(-n // rows) * b * cluster


@pytest.mark.parametrize("site,want", [("vith_b8", (32, 8)),
                                       ("vitb_b32", (32, 1))])
def test_layout_at_the_path_shapes(site, want):
    """The picks at the two sites, each a grid that gives all 132 SMs a
    block and fits a block's shared memory."""
    b, n, heads, hd = SITES[site]
    rows, cluster = A.qkv_proj_layout(b, n, heads, hd, **H100)
    assert (rows, cluster) == want
    assert heads % cluster == 0 and cluster <= A.QKV_PROJ_MAX_CLUSTER
    assert _blocks(b, n, rows, cluster) >= H100["sms"]
    assert A.qkv_proj_smem_bytes(rows, hd, heads * hd) <= LIMIT


def _per_sm(rows, hd, hdim, sm_smem=H100["sm_smem"]):
    return sm_smem // (A.qkv_proj_smem_bytes(rows, hd, hdim) + 1024)


@pytest.mark.parametrize("b", [1, 2, 3, 8, 32])
@pytest.mark.parametrize("n,heads,hd", [(272, 16, 80), (208, 12, 64),
                                        (64, 2, 64), (40, 3, 32),
                                        (37, 2, 24), (592, 12, 64),
                                        (577, 16, 80), (257, 13, 64)])
def test_every_pick_fits_and_fills_where_it_can(b, n, heads, hd):
    """Every pick fits 232,448 bytes and is a layout the kernel takes: the
    32-row tile wherever two of its blocks fit an SM, a cluster that
    divides the heads; it gives all 132 SMs a block whenever a cluster
    size at that tile can."""
    rows, cluster = A.qkv_proj_layout(b, n, heads, hd, **H100)
    hdim = heads * hd
    assert A.qkv_proj_smem_bytes(rows, hd, hdim) <= LIMIT
    assert heads % cluster == 0 and cluster <= A.QKV_PROJ_MAX_CLUSTER
    two = [r for r in A.QKV_PROJ_TILES if _per_sm(r, hd, hdim) >= 2]
    assert rows == two[0]
    gs = [g for g in range(1, 9) if heads % g == 0]
    if any(_blocks(b, n, rows, g) >= H100["sms"] for g in gs):
        assert _blocks(b, n, rows, cluster) >= H100["sms"]
    else:
        assert cluster == gs[-1]


def test_layout_follows_the_card():
    """The picker reads the SM count and the shared memory an SM: on 16
    SMs ViT-H/14 at batch 8 walks as few heads a block with clusters of 4
    (9 waves of 4 heads against 18 of 2), and an SM of 70,000 bytes takes
    only the 16-row tile."""
    b, n, heads, hd = SITES["vith_b8"]
    assert A.qkv_proj_layout(b, n, heads, hd, sms=16,
                             sm_smem=233472) == (32, 4)
    rows, _ = A.qkv_proj_layout(b, n, heads, hd, sms=132, sm_smem=70000)
    assert rows == 16
    assert A.qkv_proj_smem_bytes(rows, hd, heads * hd) + 1024 <= 70000


def _pr5_limit_fits(n, heads, hd, itemsize):
    """A frozen copy of the first K9's limit (its qkv_proj_kernel_limit):
    one head's k/v of n rows (or the two weight buffers), a tile's q rows
    in the qkv dtype and its int8 levels, at the tile of 64, 32 or 16 rows
    that fits."""
    if hd > 80 or hd % 8:
        return False
    rq = (hd + (8 if itemsize == 2 else 4)) * itemsize
    rv = (hd + 8) * itemsize
    region = max(n * (rq + rv), 2 * 256 * 80)
    level_row = -(-heads * hd // 64) * 64 + 16
    return min(region + r * (rq + level_row) + 3 * 32 * 4
               for r in (64, 32, 16)) <= LIMIT


def test_limit_takes_every_shape_the_first_kernel_took():
    """Over a grid of (tokens, heads, head_dim, qkv itemsize): every shape
    the first K9 took is taken; shapes it refused (592 tokens at head_dim 64
    in f32, the 384-px models) are taken now."""
    taken = refused_before = 0
    for n in (8, 37, 64, 197, 208, 257, 272, 400, 577, 592, 1024, 2048):
        for heads in (1, 2, 3, 4, 6, 8, 12, 16, 24, 32, 64, 96, 128, 144,
                      148, 149, 150, 186, 190, 372, 1488):
            for hd in (8, 16, 24, 32, 48, 64, 72, 80):
                for itemsize in (2, 4):
                    old = _pr5_limit_fits(n, heads, hd, itemsize)
                    new = A.qkv_proj_kernel_limit(heads, hd) is None
                    assert new or not old, (n, heads, hd, itemsize)
                    taken += new
                    refused_before += new and not old
    assert taken > 0 and refused_before > 0
    assert not _pr5_limit_fits(592, 12, 64, 4)
    assert A.qkv_proj_kernel_limit(12, 64) is None


def _warp_grid(mt, nt, nw=8):
    """csrc/fp64_mma.cuh:warp_grid."""
    best, tiles, loads = (1, 1), mt * nt + 1, 1 << 20
    for wr in range(1, nw + 1):
        for wc in range(1, nw // wr + 1):
            if mt % wr or nt % wc:
                continue
            ti, lo = (mt // wr) * (nt // wc), mt // wr + nt // wc
            if ti < tiles or (ti == tiles and lo < loads):
                best, tiles, loads = (wr, wc), ti, lo
    return best


def _mma_order_dot(a, b, depth):
    """a [..., M, K] . b [..., K, N] summed in f64 as K9's m16n8k4 MMAs add
    it: the depth zero-padded to ``depth`` (a multiple of 4), k ascending,
    each product added to the running sum in turn (the K and V chunks one
    after another into one accumulator); rounded once to f32."""
    a, b = a.to(torch.float64), b.to(torch.float64)
    acc = torch.zeros(a.shape[:-1] + b.shape[-1:], dtype=torch.float64)
    for k in range(depth):
        if k < a.shape[-1]:
            acc = acc + a[..., k, None] * b[..., k, None, :]
        else:  # the padding: zero products
            acc = acc + 0.0
    return acc.to(torch.float32)


def _psum_order(p, rows):
    """The row sums of f32 p [..., n_keys] in the order K9 adds them at a
    tile of ``rows``: each lane (warp column w, quad lane t) sums its keys
    (chunk by chunk, its 8-key tiles, then the pair) in f64, the quad
    reduces over xor 1 then xor 2, and the warp columns add in order;
    rounded to f32, plus 1e-30."""
    kc = 64 if rows >= 32 else 32
    wc = _warp_grid(rows // 16, kc // 8)[1]
    span = kc // wc  # keys of a chunk a warp column covers
    p = p.to(torch.float64)
    n = p.shape[-1]
    lane = torch.zeros(p.shape[:-1] + (wc, 4), dtype=torch.float64)
    for c0 in range(0, n, kc):
        for w in range(wc):
            for k8 in range(0, span, 8):
                for e in range(2):
                    for t in range(4):
                        key = c0 + w * span + k8 + 2 * t + e
                        if key < n:
                            lane[..., w, t] = lane[..., w, t] + p[..., key]
    q = lane + lane[..., [1, 0, 3, 2]]
    q = q + q[..., [2, 3, 0, 1]]
    tot = q[..., 0, 0]
    for w in range(1, wc):
        tot = tot + q[..., w, 0]
    return tot.to(torch.float32) + 1e-30


def _float_path(site, dtype, seed):
    """q (pre-scaled, rounded), k, v of a site at batch 2 and the p of
    the float path (no row max), as attention_qkv_plain forms them."""
    _, n, heads, hd = SITES[site]
    nv = {"vith_b8": 257, "vitb_b32": 197}[site]
    rng = np.random.default_rng(seed)
    x = torch.from_numpy((rng.standard_normal((2, heads, 3, n, hd)) * 0.7)
                         .astype(np.float32)).to(dtype)
    q, k, v = x[:, :, 0], x[:, :, 1], x[:, :, 2]
    nk = A._n_keys(n, nv, x.element_size())
    k, v = k[:, :, :nk], v[:, :, :nk]
    qs = (q.float() * (hd**-0.5 * A._LOG2E)).to(dtype)
    s = A._dot_f32(qs, k.transpose(-1, -2))
    s = torch.where(torch.arange(nk) < nv, s, torch.full_like(s, -1e30))
    p = torch.exp2(torch.clamp_max(s, 100.0))
    return qs, k, v, p, nk, -(-hd // 4) * 4


@pytest.mark.parametrize("site", list(SITES))
def test_bf16_float_path_is_exact_in_the_mma_order(site):
    """bf16: the scores, p . v and the p sums in K9's order equal the
    plain version's bit for bit."""
    qs, k, v, p, nk, depth = _float_path(site, torch.bfloat16, seed=1)
    assert torch.equal(_mma_order_dot(qs, k.transpose(-1, -2), depth),
                       A._dot_f32(qs, k.transpose(-1, -2)))
    pb = p.to(torch.bfloat16)
    assert torch.equal(_mma_order_dot(pb, v, -(-nk // 4) * 4),
                       A._dot_f32(pb, v))
    rows = A.qkv_proj_layout(*SITES[site], **H100)[0]
    assert torch.equal(_psum_order(p, rows), A.sum_f32(p, -1)[..., 0]
                       + 1e-30)


@pytest.mark.parametrize("site", list(SITES))
def test_f32_float_path_in_the_mma_order_within_one_ulp(site):
    """f32: the f64 sums are not exact, so K9's order can move a result by
    one f32 ulp (the sum within 2^-29 of an f32 tie). Counted, seeded as
    here: 0 flips in the scores, p . v and p sums at both sites."""
    qs, k, v, p, nk, depth = _float_path(site, torch.float32, seed=2)
    rows = A.qkv_proj_layout(*SITES[site], **H100)[0]
    flips = []
    for got, want in (
            (_mma_order_dot(qs, k.transpose(-1, -2), depth),
             A._dot_f32(qs, k.transpose(-1, -2))),
            (_mma_order_dot(p, v, -(-nk // 4) * 4), A._dot_f32(p, v)),
            (_psum_order(p, rows), A.sum_f32(p, -1)[..., 0] + 1e-30)):
        ulps = (got.view(torch.int32).long()
                - want.view(torch.int32).long()).abs()
        assert int(ulps.max()) <= 1
        flips.append(int((ulps > 0).sum()))
    print(f"{site}: {flips} of scores, p.v, p sums differ by 1 ulp")
    assert flips == [0, 0, 0]

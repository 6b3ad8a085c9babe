"""K6's query tile, its limit and the premise of its exact MMA, on the CPU.

``ops/attention.py:qkv_attn_tile_rows`` picks K6's query rows a block
from the card's SMs and shared memory, which ``qkv_attn_smem_bytes``
(a mirror of ``csrc/attention_qkv.cu:smem_bytes``) gives it. K/V stream
in chunks, so ``qkv_kernel_limit`` checks head_dim only and takes any
token count: it must take every shape the first K6 took, held here
against a frozen copy of that kernel's formula, and the 384-px models it
refused. The MMA-order checks
sum the float path's scores, p . v and p sums in f64 in the order K6's
m16n8k4 MMAs and its reductions add them at its tile, and compare with the
plain version's dots (``_dot_f32``, f64 rounded once to f32) and row sum
(``sum_f32``): bit-equal for bf16; for f32 within one ulp, the flips
counted.
"""

import numpy as np
import pytest
import torch

import quantized_vit_tpu_torch.ops.attention as A
from quantized_vit_tpu_torch.models import ViTConfig
from quantized_vit_tpu_torch.serve import kernel_limits

torch.set_num_threads(1)

H100 = dict(sms=132, sm_smem=233472)
LIMIT = 232448  # the shared memory a block can use on Hopper
KC = 64  # keys a chunk (csrc/attention_qkv.cu)

# the chain's timing sites (images, padded tokens, heads, head_dim): the
# ViT-B/16 and ViT-H/14 chain at batch 1-2 and ViT-B/16 at batch 32
SITES = {"vitb_b2": (2, 208, 12, 64), "vith_b1": (1, 272, 16, 80),
         "vith_b2": (2, 272, 16, 80), "vitb_b32": (32, 208, 12, 64)}


def _blocks(b, n, heads, rows):
    return -(-n // rows) * heads * b


def _per_sm(rows, hd, itemsize, sm_smem=H100["sm_smem"]):
    return min(2, sm_smem // (A.qkv_attn_smem_bytes(rows, hd, itemsize)
                              + 1024))


@pytest.mark.parametrize("site,want,blocks", [
    ("vitb_b2", 32, 168), ("vith_b1", 32, 144), ("vith_b2", 64, 160),
    ("vitb_b32", 64, 1536)])
def test_tile_rows_at_the_path_sites(site, want, blocks):
    """The picks at the four sites, each a grid that gives all 132 SMs a
    block and fits a block's shared memory; at ViT-B/16 batch 2 the
    64-row tile would leave SMs idle (96 blocks)."""
    b, n, heads, hd = SITES[site]
    rows = A.qkv_attn_tile_rows(b, n, heads, hd, **H100)
    assert rows == want
    assert _blocks(b, n, heads, rows) == blocks >= H100["sms"]
    assert A.qkv_attn_smem_bytes(rows, hd) <= LIMIT
    if site == "vitb_b2":
        assert _blocks(b, n, heads, 64) == 96


@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("b", [1, 2, 3, 8, 32])
@pytest.mark.parametrize("n,heads,hd", [(272, 16, 80), (208, 12, 64),
                                        (64, 2, 64), (40, 3, 32),
                                        (37, 2, 24), (592, 12, 64),
                                        (577, 16, 80), (257, 13, 64)])
def test_every_pick_fits_and_fills_where_it_can(n, heads, hd, b, itemsize):
    """Every pick fits 232,448 bytes with two blocks an SM; where some
    tile's grid gives all 132 SMs a block the pick's does too and keeps
    the most query rows on an SM, else it is the smallest tile."""
    rows = A.qkv_attn_tile_rows(b, n, heads, hd, itemsize, **H100)
    assert rows in A.QKV_ATTN_TILES
    assert A.qkv_attn_smem_bytes(rows, hd, itemsize) <= LIMIT
    assert _per_sm(rows, hd, itemsize) == 2
    full = [r for r in A.QKV_ATTN_TILES
            if _blocks(b, n, heads, r) >= H100["sms"]]
    if full:
        assert rows in full
        assert rows * _per_sm(rows, hd, itemsize) == max(
            r * _per_sm(r, hd, itemsize) for r in full)
    else:
        assert rows == A.QKV_ATTN_TILES[-1]


def test_pick_follows_the_card():
    """The picker reads the SM count and the shared memory an SM: on 16
    SMs ViT-H/14 at batch 1 fills the card with 64-row tiles, and an SM
    of 100,000 bytes cannot hold the f32 64-row tile at head_dim 80, so
    batch 2 takes 32 rows there."""
    assert A.qkv_attn_tile_rows(*SITES["vith_b1"], sms=16,
                                sm_smem=233472) == 64
    rows = A.qkv_attn_tile_rows(*SITES["vith_b2"], 4, sms=132,
                                sm_smem=100000)
    assert rows == 32
    assert A.qkv_attn_smem_bytes(64, 80, 4) + 1024 > 100000
    assert A.qkv_attn_smem_bytes(rows, 80, 4) + 1024 <= 100000


def _first_limit_fits(n, hd, itemsize):
    """A frozen copy of the first K6's limit (its qkv_kernel_limit): one
    head's k/v of n rows and one 8-row q tile in the qkv dtype, and the
    scale reduction, in a block's shared memory."""
    if hd > 80 or hd % 8:
        return False
    rq = (hd + (8 if itemsize == 2 else 4)) * itemsize
    rv = (hd + 8) * itemsize
    return n * (rq + rv) + 8 * rq + 3 * 32 * 4 <= LIMIT


def test_limit_takes_every_shape_the_first_kernel_took():
    """Over a grid of (tokens, head_dim, qkv itemsize): every shape the
    first K6 took is taken; shapes it refused (592 tokens at head_dim 64
    in f32, the 384-px models) are taken now; head_dim past 80 or off the
    multiples of 8 is still refused."""
    taken = refused_before = 0
    for n in (8, 37, 64, 197, 208, 257, 272, 400, 577, 592, 1024, 2048,
              4096):
        for hd in (8, 16, 24, 32, 48, 64, 72, 80, 84, 88, 96):
            for itemsize in (2, 4):
                old = _first_limit_fits(n, hd, itemsize)
                new = A.qkv_kernel_limit(hd) is None
                assert new or not old, (n, hd, itemsize)
                assert new == (hd <= 80 and hd % 8 == 0)
                taken += new
                refused_before += new and not old
    assert taken > 0 and refused_before > 0
    assert not _first_limit_fits(592, 64, 4)
    assert A.qkv_kernel_limit(64) is None


@pytest.mark.parametrize("b", [1, 2, 3])
def test_kernel_limits_serve_384px_f32_chain(b):
    """The 384-px ViT-B/16 with an f32 residual stream on the chain
    (batch 1-3): no kernel refuses it now."""
    assert kernel_limits(ViTConfig(img_size=384), batch=b,
                         float_dtype=torch.float32) == []


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
    """a [..., M, K] . b [..., K, N] summed in f64 as K6's m16n8k4 MMAs add
    it: the depth zero-padded to ``depth`` (a multiple of 4), k ascending,
    each product added to the running sum in turn (P.V's chunks of 64 keys
    one after another into one accumulator); rounded once to f32."""
    a, b = a.to(torch.float64), b.to(torch.float64)
    acc = torch.zeros(a.shape[:-1] + b.shape[-1:], dtype=torch.float64)
    for k in range(depth):
        if k < a.shape[-1]:
            acc = acc + a[..., k, None] * b[..., k, None, :]
        else:  # the padding: zero products
            acc = acc + 0.0
    return acc.to(torch.float32)


def _psum_order(p, rows):
    """The row sums of f32 p [..., n_keys] in the order K6 adds them at a
    tile of ``rows``: each lane (warp column w, quad lane t) sums its keys
    (chunk by chunk of 64, its 8-key tiles, then the pair) in f64, the
    quad reduces over xor 1 then xor 2, and the warp columns add in order;
    rounded to f32, plus 1e-30."""
    wc = _warp_grid(rows // 16, KC // 8)[1]
    span = KC // wc  # keys of a chunk a warp column covers
    p = p.to(torch.float64)
    n = p.shape[-1]
    lane = torch.zeros(p.shape[:-1] + (wc, 4), dtype=torch.float64)
    for c0 in range(0, n, KC):
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


CHAIN = ("vitb_b2", "vith_b1", "vith_b2")


def _float_path(site, dtype, seed):
    """q (pre-scaled, rounded), k, v of a chain site and the p of the
    float path (no row max), as attention_qkv_plain forms them."""
    b, n, heads, hd = SITES[site]
    nv = {"vitb_b2": 197, "vith_b1": 257, "vith_b2": 257}[site]
    rng = np.random.default_rng(seed)
    x = torch.from_numpy((rng.standard_normal((b, heads, 3, n, hd)) * 0.7)
                         .astype(np.float32)).to(dtype)
    q, k, v = x[:, :, 0], x[:, :, 1], x[:, :, 2]
    nk = A._n_keys(n, nv, x.element_size())
    k, v = k[:, :, :nk], v[:, :, :nk]
    qs = (q.float() * (hd**-0.5 * A._LOG2E)).to(dtype)
    s = A._dot_f32(qs, k.transpose(-1, -2))
    s = torch.where(torch.arange(nk) < nv, s, torch.full_like(s, -1e30))
    p = torch.exp2(torch.clamp_max(s, 100.0))
    rows = A.qkv_attn_tile_rows(*SITES[site], x.element_size(), **H100)
    return qs, k, v, p, nk, -(-hd // 4) * 4, rows


@pytest.mark.parametrize("site", CHAIN)
def test_bf16_float_path_is_exact_in_the_mma_order(site):
    """bf16: the scores, p . v and the p sums in K6's order at its tile
    (32 rows at ViT-B b2 and ViT-H b1, 64 at ViT-H b2) equal the plain
    version's bit for bit."""
    qs, k, v, p, nk, depth, rows = _float_path(site, torch.bfloat16, seed=1)
    assert torch.equal(_mma_order_dot(qs, k.transpose(-1, -2), depth),
                       A._dot_f32(qs, k.transpose(-1, -2)))
    pb = p.to(torch.bfloat16)
    assert torch.equal(_mma_order_dot(pb, v, -(-nk // 4) * 4),
                       A._dot_f32(pb, v))
    assert torch.equal(_psum_order(p, rows), A.sum_f32(p, -1)[..., 0]
                       + 1e-30)


@pytest.mark.parametrize("site", CHAIN)
def test_f32_float_path_in_the_mma_order_within_one_ulp(site):
    """f32: the f64 sums are not exact, so K6's order can move a result by
    one f32 ulp (the sum within 2^-29 of an f32 tie). Counted, seeded as
    here: 0 flips in the scores, p . v and p sums at the three sites."""
    qs, k, v, p, nk, depth, rows = _float_path(site, torch.float32, seed=2)
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
    print(f"{site} (R {rows}): {flips} of scores, p.v, p sums differ by 1 "
          "ulp")
    assert flips == [0, 0, 0]

"""K18's layout and the premise of its exact MMAs, on the CPU.

K18 (``csrc/attn_ablation.cu``, ``ops/ablations.py:exp_attn``) runs one
block a (head, image) with K and V in shared memory as f64 rows (at most
:data:`ATTN_F64_KEYS` keys) or bf16 rows (up to 256); ``_attn_smem``
here mirrors its ``attn_smem``. Its limit must take every shape the first
K18 took (a frozen copy of that limit here).

The kernel's index maps: the scores' k-step s, k-lane t is head column
S t + s (S = head_dim / 4); P.V's k-step (j, e), k-lane t is key 8 j +
2 t + e; a lane's row sum adds its keys in that order and the quad adds
xor 1, then xor 2; ``transposed`` sums a lane's keys 16 mk + 8 hh + g,
then xor 4, 8, 16. These tests check that the maps take every head
column and key exactly once, and that sums in f64 over them (the scores,
p . v, the row sums, ``mxu_sum``'s ones column), rounded once to f32,
are bit-equal to ``exp_attn_plain``'s at the root tool's shape and data.
At that data every such f64 sum is exact (products of bf16 values, sums
of bf16 p), so any order gives the same bits: these tests check the
coverage of the indices, not the order of summation, and they emulate
the kernel in Python rather than run it. The order, and the kernel
itself, are held to the plain version only on the card
(``chip_smoke.py`` phase 3d). The output emulated from those sums equals
the plain version's for every mode but ``recip`` (whose approximate
reciprocal the card alone computes).
"""

import functools

import numpy as np
import pytest
import torch

from quantized_vit_tpu_torch.ops import ablations as ab
from quantized_vit_tpu_torch.ops.fused import sum_f32

torch.set_num_threads(1)

LIMIT = 232448  # the shared memory a block can use on Hopper
# the root tool's shape: images, queries, keys, heads, head_dim
B, N, NK, H, HD = 8, 224, 208, 12, 64


@functools.lru_cache(maxsize=None)
def _tool_qkv():
    """The root tool's x (seed 0, N(0, 0.1^2) in bf16) and its q, k, v as
    [B, H, rows, hd] f64."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((B, N, 3 * H * HD)) * 0.1).to(
        torch.bfloat16)
    xr = x.reshape(B, N, 3, H, HD).permute(0, 3, 2, 1, 4).to(torch.float64)
    return x, xr[:, :, 0], xr[:, :, 1, :NK], xr[:, :, 2, :NK]


def _score_order():
    """The head columns in the order the scores' MMAs add them."""
    s_ = HD // 4
    return [s_ * t + s for s in range(s_) for t in range(4)]


def _key_order(nk):
    """The keys in the order P.V's MMAs add them."""
    return [8 * j + 2 * t + e for j in range(nk // 8) for e in range(2)
            for t in range(4)]


@functools.lru_cache(maxsize=None)
def _scores():
    """(the kernel's scores, the plain version's), f32 [B, H, N, NK]."""
    _, q, k, _ = _tool_qkv()
    acc = torch.zeros((B, H, N, NK), dtype=torch.float64)
    for c in _score_order():
        acc = acc + q[..., :, c, None] * k[..., None, :, c]
    plain = torch.einsum("bhnd,bhmd->bhnm", q, k).to(torch.float32)
    return acc.to(torch.float32), plain


def _p(s, mode):
    """p (bf16 values as f32) of scores s in ``mode``, as the kernel and
    exp_attn_plain form it."""
    if mode == "matmuls_only":
        return s.to(torch.bfloat16).float()
    if mode != "no_mask":
        s = torch.where(torch.arange(NK) < ab.ATTN_N_VALID, s,
                        torch.full_like(s, -1e30))
    if mode != "no_max":
        s = s - s.amax(dim=-1, keepdim=True)
    p = s if mode == "no_exp" else torch.exp(s)
    return p.to(torch.bfloat16).float()


def _pv(p, v):
    acc = torch.zeros((B, H, N, HD), dtype=torch.float64)
    pd = p.to(torch.float64)
    for key in _key_order(NK):
        acc = acc + pd[..., key, None] * v[..., key, None, :]
    return acc.to(torch.float32)


def _row_sums(p):
    """The row sums as the kernel's lanes and quad shuffles add them."""
    pd = p.to(torch.float64)
    lane = []
    for t in range(4):
        acc = torch.zeros(pd.shape[:-1], dtype=torch.float64)
        for j in range(NK // 8):
            for e in range(2):
                acc = acc + pd[..., 8 * j + 2 * t + e]
        lane.append(acc)
    x1 = [lane[t] + lane[t ^ 1] for t in range(4)]
    return (x1[0] + x1[2]).to(torch.float32)


def _row_sums_transposed(p):
    """transposed: lane g adds keys 16 mk + 8 hh + g, then xor 4, 8, 16."""
    pd = p.to(torch.float64)
    lane = []
    for g in range(8):
        acc = torch.zeros(pd.shape[:-1], dtype=torch.float64)
        for mk in range(NK // 16):
            for hh in range(2):
                acc = acc + pd[..., 16 * mk + 8 * hh + g]
        lane.append(acc)
    for m in (1, 2, 4):
        lane = [lane[g] + lane[g ^ m] for g in range(8)]
    return lane[0].to(torch.float32)


def _ones_column(p):
    acc = torch.zeros(p.shape[:-1], dtype=torch.float64)
    pd = p.to(torch.float64)
    for key in _key_order(NK):
        acc = acc + pd[..., key]
    return acc.to(torch.float32)


def test_scores_in_the_mma_order_are_the_plain_versions():
    got, want = _scores()
    assert torch.equal(got, want)


@pytest.mark.parametrize("mode", ab.EXP_ATTN_MODES)
def test_mode_sums_in_the_mma_order_are_the_plain_versions(mode):
    """P.V, the row sums and the ones column in the kernel's order, each
    bit-equal to the plain version's f64 sum rounded once; the kernel's
    output emulated from them equals exp_attn_plain's."""
    x, _, _, v = _tool_qkv()
    s, _ = _scores()
    p = _p(s, mode)
    o = _pv(p, v)
    o_plain = torch.einsum("bhnm,bhmd->bhnd", p.to(torch.float64),
                           v).to(torch.float32)
    assert torch.equal(o, o_plain)
    want_sum = sum_f32(p, -1)[..., 0]
    rs = (_row_sums_transposed(p) if mode == "transposed"
          else _row_sums(p))
    assert torch.equal(rs, want_sum)
    if mode == "mxu_sum":
        rs = _ones_column(p)
        assert torch.equal(rs, want_sum)
    if mode == "recip":
        return
    rs = rs[..., None]
    if mode == "sum_only":
        o = o + rs * 1e-30
    elif mode not in ("matmuls_only", "no_exp", "no_sum"):
        o = o / rs
    lv = torch.clamp(torch.round(o * ab.INV_D), -ab.TOP, ab.TOP).to(
        torch.int8)
    out = lv.permute(0, 2, 1, 3).reshape(B, N, H * HD)
    assert torch.equal(out, ab.exp_attn_plain(x, mode, heads=H, n_keys=NK))


def _attn_smem(f64):
    """A copy of csrc/attn_ablation.cu:attn_smem (with ATTN_LDK and
    attn_ldv): 26 key tiles of 8 as f64 rows, or 32 as bf16 rows and the
    raw rows."""
    kt = 26 if f64 else 32
    rows = 8 * kt * (64 + 8) + 64 * (8 * kt + 8)
    return rows * 8 if f64 else rows * 2 + 4 * 256 * (64 + 8)


def test_smem_mirror_fits_a_block():
    """f64 rows (the tool's shape) take 230,400 bytes, bf16 rows (up to
    256 keys of head_dim 64) 144,384; both fit a block's 232,448, as the
    C source's static_assert says. f64 rows hold 26 key tiles of 8."""
    assert _attn_smem(True) == 230400
    assert _attn_smem(False) == 144384
    assert max(_attn_smem(True), _attn_smem(False)) <= LIMIT
    assert ab.ATTN_F64_KEYS == 8 * 26 and NK <= ab.ATTN_F64_KEYS


@pytest.mark.parametrize("head_dim", [8, 40, 64])
def test_index_maps_cover_each_index_once(head_dim):
    """The scores' head columns, P.V's keys and the transposed sums' keys
    are permutations of their full ranges (at every key count the kernel
    pads to, a multiple of 16)."""
    s_ = head_dim // 4
    cols = [s_ * t + s for s in range(s_) for t in range(4)]
    assert sorted(cols) == list(range(head_dim))
    for nkp in range(16, ab.ATTN_MAX_KEYS + 1, 16):
        assert sorted(_key_order(nkp)) == list(range(nkp))
        tr = [16 * mk + 8 * hh + g for g in range(8)
              for mk in range(nkp // 16) for hh in range(2)]
        assert sorted(tr) == list(range(nkp))


def _first_limit(n, n_keys, head_dim):
    """A frozen copy of the first K18's limit (ops/ablations.py and the C
    entry point's checks): 1 <= keys <= min(N, 256), head_dim 8-64 in
    multiples of 8."""
    return (1 <= n_keys <= min(n, 256) and 8 <= head_dim <= 64
            and head_dim % 8 == 0)


def test_limit_takes_every_shape_the_first_kernel_took():
    taken = 0
    for n in (1, 8, 17, 37, 64, 197, 208, 224, 256, 300, 1000):
        for nk in (1, 8, 15, 16, 37, 197, 208, 209, 216, 250, 256, 257):
            for hd in (4, 8, 16, 24, 40, 56, 64, 72, 80):
                old = _first_limit(n, nk, hd)
                new = ab.attn_kernel_limit(n, nk, hd) is None
                assert new or not old, (n, nk, hd)
                taken += new
    assert taken > 0
    assert ab.attn_kernel_limit(N, NK, HD) is None

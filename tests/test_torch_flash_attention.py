"""Port parity: the standalone attention (kernel K13, ``flash_attention``)
against the JAX package's ``_flash_attention`` Pallas kernel in interpret
mode and its XLA mirror ``flash_attention_xla``.

The port follows the kernel where the two JAX functions differ: p is cast
to v's dtype before AV (attention.py:55; the mirror casts it to q's,
:963 — ROADMAP.md, faults of the reference the port must not copy), so
the mixed-dtype cases are held against the kernel only. Tolerances (the
JAX side sums its dots in f32, the port in f64 rounded once): float
outputs (f32) within 1e-5; int8 levels within 1 level at <= 0.5% of
positions (bench.py:80-87).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from quantized_vit_tpu.ops.attention import (_flash_attention,
                                             flash_attention as j_flash,
                                             flash_attention_xla)
import quantized_vit_tpu_torch.ops.attention as A
from quantized_vit_tpu_torch.ops import flash_attention, flash_attention_plain
from quantized_vit_tpu_torch.ops.attention import flash_kernel_limit

torch.set_num_threads(1)

# (q/k dtype, v dtype): equal, and mixed both ways (C1.5)
DTYPES = [("float32", "float32"), ("bfloat16", "bfloat16"),
          ("float32", "bfloat16"), ("bfloat16", "float32")]
# (B, H, N, hd, n_valid): n_valid < N, ragged N, head_dim 80
SHAPES = [(2, 3, 20, 16, 13), (1, 2, 37, 80, 30)]


def _inputs(shape, dts, seed):
    b, h, n, hd, _ = shape
    rng = np.random.default_rng(seed)
    out = []
    for dt in (dts[0], dts[0], dts[1]):
        a = jnp.asarray(rng.standard_normal((b, h, n, hd)).astype(np.float32),
                        getattr(jnp, dt))
        out.append((a, torch.from_numpy(np.asarray(a.astype(jnp.float32)))
                    .to(getattr(torch, dt))))
    return [j for j, _ in out], [t for _, t in out]


def _quant(kind):
    """JAX and port keywords of the epilogue: float, or int8 levels with
    t = 1 (linear) or t != 1 (pow)."""
    if kind == "float":
        return {}, {}
    t = 1.0 if kind == "lin" else 0.93
    return (dict(out_d=jnp.float32(0.02), out_t=jnp.float32(t), out_top=31,
                 out_pow=kind == "pow"),
            dict(out_d=torch.tensor(0.02), out_t=torch.tensor(t),
                 out_top=31, out_pow=kind == "pow"))


def _close(got, want, kind):
    got = got.float().numpy() if kind == "float" else got.numpy()
    want = np.asarray(want, np.float32 if kind == "float" else np.int8)
    assert got.shape == want.shape
    if kind == "float":
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    else:
        d = np.abs(got.astype(np.int32) - want.astype(np.int32))
        assert d.max(initial=0) <= 1 and (d > 0).mean() <= 0.005, d.max()


@pytest.mark.parametrize("kind", ["float", "lin", "pow"])
@pytest.mark.parametrize("dts", DTYPES, ids=lambda d: f"{d[0]}-{d[1]}")
@pytest.mark.parametrize("shape", SHAPES, ids=["n20", "n37hd80"])
def test_plain_matches_jax_kernel_interpret(shape, dts, kind):
    (jq, jk, jv), (tq, tk, tv) = _inputs(shape, dts, seed=shape[2])
    jkw, tkw = _quant(kind)
    kw = dict(sm_scale=shape[3]**-0.5, n_valid=shape[4])
    want = _flash_attention(jq, jk, jv, out_dtype=jnp.float32,
                            interpret=True, **kw, **jkw)
    got = flash_attention_plain(tq, tk, tv, out_dtype=torch.float32, **kw,
                                **tkw)
    _close(got, want, kind)
    # the CPU wrapper takes the plain version
    assert torch.equal(flash_attention(tq, tk, tv, out_dtype=torch.float32,
                                       **kw, **tkw), got)


@pytest.mark.parametrize("kind", ["float", "lin", "pow"])
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_plain_matches_jax_xla_mirror_at_equal_dtypes(dt, kind):
    shape = SHAPES[0]
    (jq, jk, jv), (tq, tk, tv) = _inputs(shape, (dt, dt), seed=7)
    jkw, tkw = _quant(kind)
    kw = dict(sm_scale=0.25, n_valid=shape[4])
    want = flash_attention_xla(jq, jk, jv, out_dtype=jnp.float32, **kw, **jkw)
    _close(flash_attention_plain(tq, tk, tv, out_dtype=torch.float32, **kw,
                                 **tkw), want, kind)


def test_mixed_dtypes_follow_the_kernel_not_the_mirror():
    """q/k f32, v bf16: p is cast to bf16 (the kernel), not kept in f32
    (the mirror); the port's plain version equals its own computation
    with p cast to v's dtype and differs from one that keeps p in f32."""
    (jq, jk, jv), (tq, tk, tv) = _inputs(SHAPES[0], DTYPES[2], seed=3)
    kw = dict(sm_scale=0.25, n_valid=13)
    got = flash_attention_plain(tq, tk, tv, out_dtype=torch.float32, **kw)
    kern = np.asarray(_flash_attention(jq, jk, jv, out_dtype=jnp.float32,
                                       interpret=True, **kw))
    mirror = np.asarray(flash_attention_xla(jq, jk, jv,
                                            out_dtype=jnp.float32, **kw))
    d_kern = np.abs(got.numpy() - kern).max()
    d_mirror = np.abs(got.numpy() - mirror).max()
    assert d_kern <= 1e-5 < d_mirror


def test_out_top_check_raises_like_jax():
    """out_d without a positive out_top raises (attention.py:65-76); a
    non-int out_top is made an int."""
    (jq, jk, jv), (tq, tk, tv) = _inputs(SHAPES[0], DTYPES[0], seed=1)
    for top in (None, 0):
        with pytest.raises(ValueError, match="out_top"):
            flash_attention(tq, tk, tv, sm_scale=0.25,
                            out_d=torch.tensor(0.02),
                            out_t=torch.tensor(1.0), out_top=top)
        with pytest.raises(ValueError, match="out_top"):
            j_flash(jq, jk, jv, sm_scale=0.25, out_d=jnp.float32(0.02),
                    out_t=jnp.float32(1.0), out_top=top, interpret=True)
    a = flash_attention(tq, tk, tv, sm_scale=0.25, out_d=torch.tensor(0.02),
                        out_t=torch.tensor(1.0), out_top=torch.tensor(31))
    b = flash_attention(tq, tk, tv, sm_scale=0.25, out_d=torch.tensor(0.02),
                        out_t=torch.tensor(1.0), out_top=31)
    assert a.dtype == torch.int8 and torch.equal(a, b)


def test_shape_dtype_and_head_dim_checks():
    q = torch.zeros((1, 2, 8, 16))
    with pytest.raises(ValueError, match="one shape"):
        flash_attention(q, q, torch.zeros((1, 2, 9, 16)), sm_scale=0.25)
    with pytest.raises(TypeError, match="f32 or bf16"):
        flash_attention(q, q, q.to(torch.int8), sm_scale=0.25)
    assert flash_kernel_limit(128) is None
    assert "head_dim 160" in flash_kernel_limit(160)


# ---------------------------------------------------------------------------
# the kernel's query tile and its summation order (csrc/flash_attention.cu)
# ---------------------------------------------------------------------------

# (B, H, N, hd) -> the tile flash_tile_rows picks: the path shapes (ViT-B/16
# batch 32; ViT-H/14 batch 8 and 1), a 384-px ViT-B/16 (592 tokens), the
# ragged 50 tokens at head_dim 72 and head_dim 128
TILES = {(32, 12, 208, 64): 64, (8, 16, 272, 80): 32, (1, 16, 272, 80): 32,
         (32, 12, 592, 64): 64, (3, 2, 50, 72): 16, (4, 8, 197, 128): 32}


@pytest.mark.parametrize("shape", list(TILES), ids=lambda s: "x".join(
    map(str, s)))
def test_flash_tile_rows_at_the_path_shapes(shape):
    qt = A.flash_tile_rows(*shape)
    assert qt == TILES[shape]
    assert A.flash_smem_bytes(qt, shape[2], shape[3]) <= 232448


def test_flash_tile_rows_fits_everywhere_and_prefers_resident_rows():
    """Every pick fits a block's 232,448 bytes; 0 exactly where the token
    limit names the shape; where some tile gives every SM a block, the
    pick does, and no such tile keeps more query rows on an SM."""
    def resident(qt, n, hd):
        return qt * min(2, 233472 // (A.flash_smem_bytes(qt, n, hd) + 1024))

    for hd in (8, 20, 64, 72, 80, 96, 128):
        for n in (1, 7, 50, 197, 208, 272, 592, 1025, 2000, 2408, 2409,
                  2840, 2841, 2984, 2985, 4000):
            for b, h in ((1, 1), (1, 16), (8, 16), (32, 12)):
                qt = A.flash_tile_rows(b, h, n, hd)
                assert (qt == 0) == (A.flash_kernel_limit(hd, n)
                                     is not None)
                if not qt:
                    continue
                assert qt in A.FLASH_TILES
                assert A.flash_smem_bytes(qt, n, hd) <= 232448
                full = [t for t in A.FLASH_TILES
                        if A.flash_smem_bytes(t, n, hd) <= 232448
                        and -(-n // t) * h * b >= 132]
                if full:
                    assert qt in full
                    assert resident(qt, n, hd) == max(
                        resident(t, n, hd) for t in full)


def test_flash_tile_rows_follows_the_cards_sms_and_shared_memory():
    """The launch passes the card's SMs and shared memory an SM: more SMs
    than ViT-H/14 batch 1's 32-row grid (144 blocks) takes the most
    blocks (16 rows, 272); an SM of half the H100's shared memory holds
    one 106-KB ViT-B/16 block at 64 rows or two 72-KB ones at 32, and 64
    resident rows tie to the smaller tile."""
    assert A.flash_tile_rows(1, 16, 272, 80) == 32
    assert A.flash_tile_rows(1, 16, 272, 80, sms=114) == 32
    assert A.flash_tile_rows(1, 16, 272, 80, sms=200) == 16
    assert A.flash_tile_rows(32, 12, 208, 64) == 64
    assert A.flash_tile_rows(32, 12, 208, 64, sm_smem=150000) == 32


def test_flash_kernel_limit_names_the_token_bound():
    assert A.flash_kernel_limit(64, 2984) is None
    assert "2985 tokens" in A.flash_kernel_limit(64, 2985)
    assert A.flash_kernel_limit(128, 2408) is None
    assert "shared memory" in A.flash_kernel_limit(128, 2409)


def _mma_order_dot(a, b, hdm):
    """a [..., M, K] . b [..., K, N] summed in f64 as the kernel's MMAs
    add: the depth zero-padded to ``hdm`` (a multiple of 4), k ascending,
    every product added to the running sum in turn (k-steps of 4, chunks
    of 64 keys one after another); rounded once to f32."""
    a, b = a.to(torch.float64), b.to(torch.float64)
    acc = torch.zeros(a.shape[:-1] + b.shape[-1:], dtype=torch.float64)
    for kk in range(0, hdm, 4):
        for t in range(4):
            if kk + t < a.shape[-1]:
                acc = acc + a[..., kk + t, None] * b[..., kk + t, None, :]
            else:  # the padding: zero products
                acc = acc + 0.0
    return acc.to(torch.float32)


def _path_qkv(b, h, n, hd, dt, seed):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal((b, h, n, hd)).astype(
        np.float32)).to(dt) for _ in range(3)]


def _softmax_p(q, k, v, n_valid):
    """p of flash_attention_plain, cast to v's dtype."""
    n, hd = q.shape[2], q.shape[3]
    s = A._dot_f32(q, k.transpose(-1, -2)) * A._f32_value(hd**-0.5)
    col = torch.arange(n)
    s = torch.where(col < n_valid, s, torch.full_like(s, -1e30))
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    return (p / A.sum_f32(p, -1)).to(v.dtype)


# the path shapes at batch 2 (the batch only repeats the (image, head)
# blocks): ViT-B/16's 208 tokens at head_dim 64, ViT-H/14's 272 at 80
PATHS = [(2, 12, 208, 64, 197), (2, 16, 272, 80, 257)]


@pytest.mark.parametrize("shape", PATHS, ids=["vit_b", "vit_h"])
def test_bf16_dots_are_exact_in_the_mma_order(shape):
    """The premise of the FP64 tensor-core kernel: with bf16 operands the
    scores q.k and the output p.v summed in f64 in the MMA's order equal
    the plain version's f64 DGEMM order after the rounding to f32, bit for
    bit, so the kernel's bits do not depend on its order."""
    b, h, n, hd, nv = shape
    q, k, v = _path_qkv(b, h, n, hd, torch.bfloat16, seed=hd)
    hdm = 64 if hd <= 64 else 80
    want = A._dot_f32(q, k.transpose(-1, -2))
    assert torch.equal(_mma_order_dot(q, k.transpose(-1, -2), hdm), want)
    p = _softmax_p(q, k, v, nv)
    keys = -(-n // 4) * 4  # the last k-step's padded keys: p = 0, v = 0
    assert torch.equal(_mma_order_dot(p, v, keys), A._dot_f32(p, v))


@pytest.mark.parametrize("shape", PATHS, ids=["vit_b", "vit_h"])
def test_f32_dots_in_the_mma_order_within_one_ulp(shape):
    """With f32 operands the f64 sums are not exact, so the order can move
    the f32 rounding, at most by 1 ulp of f32 (a flip needs the f64 sum
    within 2^-29 of an f32 tie). Counts found, seeded as here: 0 of
    1,038,336 scores and 0 of 319,488 outputs at ViT-B, 0 of 2,367,488
    and 0 of 696,320 at ViT-H."""
    b, h, n, hd, nv = shape
    q, k, v = _path_qkv(b, h, n, hd, torch.float32, seed=hd + 1)
    hdm = 64 if hd <= 64 else 80
    p = _softmax_p(q, k, v, nv)
    for got, want in ((_mma_order_dot(q, k.transpose(-1, -2), hdm),
                       A._dot_f32(q, k.transpose(-1, -2))),
                      (_mma_order_dot(p, v, -(-n // 4) * 4),
                       A._dot_f32(p, v))):
        ulps = (got.view(torch.int32).long()
                - want.view(torch.int32).long()).abs()
        assert int(ulps.max()) <= 1
        print(f"{int((ulps > 0).sum())} of {ulps.numel()} differ by 1 ulp")

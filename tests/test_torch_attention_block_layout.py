"""K3's layout, its limit and the premise of its exact design, on the CPU.

``csrc/attention_block.cu`` runs LN + quant once per row, the qkv GEMM on
the int8 tensor cores into a q/k/v scratch, then K6's attention tile
(``csrc/qkv_attention.cuh``) over (query tile, head, image) items.
``ops/attention.py:heads_smem_bytes`` mirrors its shared memory and
``heads_tile_rows`` picks its query tile; both are held here against the
sources' own constants. q/k/v leave shared memory, so
``heads_kernel_limit`` checks head_dim only: it takes every shape the
first K3 took (a frozen copy of its formula) and the 384-px and f32
ViT-H/14 shapes it refused. A plain mirror of the kernel (its LayerNorm
and quantize arithmetic, the exact int GEMM and its dequant, the
attention's f64 sums in K6's MMA order at the picked tile) equals
``attention_heads_plain`` bit for bit. ``attention_heads_plain`` stays
within the attention contract of the JAX ``_attention_block`` (Pallas
interpret mode) at the token counts the first K3 refused.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import quantized_vit_tpu_torch.ops.attention as A
from quantized_vit_tpu.ops import attention as ja
from quantized_vit_tpu_torch.ops.fused import fold_ln
from tests.test_torch_attention_qkv_layout import _mma_order_dot, _psum_order

torch.set_num_threads(1)

H100 = dict(sms=132, sm_smem=233472)
LIMIT = 232448  # the shared memory a block can use on Hopper
CSRC = Path(A.__file__).resolve().parent.parent / "csrc"

# K3's sites (images, padded tokens, heads, head_dim, qkv itemsize):
# ViT-B/16 and ViT-H/14 at batch 32 and 4, the 384-px ViT-B/16 at 4
SITES = {"vitb_b32": (32, 208, 12, 64, 2), "vith_b32": (32, 272, 16, 80, 2),
         "vitb_b4": (4, 208, 12, 64, 2), "vith_b4_f32": (4, 272, 16, 80, 4),
         "vitb384_b4": (4, 592, 12, 64, 2)}


def _consts(path, names):
    """The integer constants ``names`` of a source's ``constexpr int``
    declarations (``A = 1, B = A + 16``), evaluated in order."""
    text = path.read_text()
    env = {}
    for decl in re.findall(r"constexpr int ([^;]+);", text):
        for part in decl.split(","):
            name, _, expr = part.partition("=")
            name, expr = name.strip(), expr.strip()
            if re.fullmatch(r"[A-Z_0-9]+", name) and re.fullmatch(
                    r"[A-Z_0-9 +*/()-]+", expr):
                expr = re.sub(r"qvt::", "", expr)
                try:
                    env[name] = eval(expr.replace("/", "//"), {}, dict(env))
                except NameError:
                    pass
    return [env[n] for n in names]


def test_shared_memory_mirror_matches_the_sources():
    """The GEMM ring (ST stages of BM + BN rows of SK bytes: K3's tile in
    attention_block.cu, the ring of int8_gemm.cuh, which K2 shares) and
    K6's tile (qkv_attention.cuh:qkv_attn_smem) as the sources compute
    them, against the wrapper's mirrors; every K3 block fits two to an
    H100 SM."""
    bm, bn = _consts(CSRC / "attention_block.cu", ("BM", "BN"))
    bk, sk, st = _consts(CSRC / "int8_gemm.cuh", ("GT_BK", "GT_SK", "GT_ST"))
    assert sk == bk + 16
    assert A._HEADS_GEMM_SMEM == st * (bm + bn) * sk
    text = (CSRC / "qkv_attention.cuh").read_text()
    body = re.search(r"int qkv_attn_smem\(int R, int HDM, int es\) \{\s*"
                     r"return ([^;]+);", text).group(1)
    body = " ".join(body.split())
    kc, kvb = _consts(CSRC / "qkv_attention.cuh", ("QA_KC", "QA_KVB"))
    for rows in A.QKV_ATTN_TILES:
        for hd in (24, 64, 72, 80):
            for es in (2, 4):
                hdm = 64 if hd <= 64 else 80
                src = eval(body.replace("QA_KVB", str(kvb))
                           .replace("QA_KC", str(kc))
                           .replace("QA_NW", "8"),
                           {}, dict(R=rows, HDM=hdm, es=es))
                assert A.qkv_attn_smem_bytes(rows, hd, es) == src + 128
                got = A.heads_smem_bytes(rows, hd, es)
                assert got == max(A._HEADS_GEMM_SMEM, src) + 128
                assert got <= LIMIT
                assert 2 * (got + 1024) <= H100["sm_smem"]


@pytest.mark.parametrize("site,items", [
    ("vitb_b32", 1536), ("vith_b32", 2560), ("vitb_b4", 192),
    ("vith_b4_f32", 320), ("vitb384_b4", 480)])
def test_tile_rows_at_the_k3_sites(site, items):
    """64 query rows at every site of the forwards: their items give all
    132 SMs one, and two blocks fit an SM at any tile, so the largest
    tile keeps the most query rows resident."""
    b, n, heads, hd, es = SITES[site]
    rows = A.heads_tile_rows(b, n, heads, hd, es, **H100)
    assert rows == 64
    assert -(-n // rows) * heads * b == items >= H100["sms"]


@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("b", [1, 3, 4, 8, 32])
@pytest.mark.parametrize("n,heads,hd", [(272, 16, 80), (208, 12, 64),
                                        (40, 3, 32), (37, 2, 24),
                                        (592, 12, 64), (577, 16, 80)])
def test_every_pick_is_the_k6_rule_on_k3_memory(n, heads, hd, b, itemsize):
    """K3's pick is K6's rule (qkv_attn_tile_rows) applied to K3's shared
    memory: where some tile's items fill the SMs, the pick's do and keep
    the most query rows on an SM; else the smallest tile."""
    rows = A.heads_tile_rows(b, n, heads, hd, itemsize, **H100)
    assert rows in A.QKV_ATTN_TILES
    full = [r for r in A.QKV_ATTN_TILES
            if -(-n // r) * heads * b >= H100["sms"]]
    assert rows == (max(full) if full else A.QKV_ATTN_TILES[-1])


def test_pick_follows_the_card():
    """On 1,000 SMs ViT-B/16 at batch 4 fills no SM set (624 items of 16
    rows), so the smallest tile; an SM of 150,000 bytes holds one block of
    any tile, and the 64-row tile still keeps the most rows."""
    assert A.heads_tile_rows(4, 208, 12, 64, 2, sms=1000,
                             sm_smem=233472) == 16
    assert A.heads_tile_rows(4, 208, 12, 64, 2, sms=132,
                             sm_smem=150000) == 64


def _first_limit_fits(n, hd, itemsize):
    """A frozen copy of the first K3's limit: the image's q/k/v in the qkv
    dtype, the GEMM tiles, LayerNorm statistics and the scale reduction in
    a block's shared memory."""
    if hd > 80 or hd % 8:
        return False
    rq = (hd + (8 if itemsize == 2 else 4)) * itemsize
    rv = (hd + 8) * itemsize
    tn = 3 if hd <= 64 else 4
    return (n * (2 * rq + rv) + (112 + 64 * tn) * 80 + 8 * n + 3 * 32 * 4
            <= LIMIT)


def test_limit_takes_any_token_count():
    """Over a grid of (tokens, head_dim, qkv itemsize): every shape the
    first K3 took is taken, any token count at head_dim <= 80 in multiples
    of 8 is taken (the 384-px models in bf16, ViT-H/14 in f32), and other
    head dims are refused."""
    refused_before = 0
    for n in (8, 40, 197, 208, 257, 272, 400, 577, 592, 1024, 4096, 16384):
        for hd in (8, 24, 32, 64, 72, 80, 84, 88, 96, 128):
            for itemsize in (2, 4):
                old = _first_limit_fits(n, hd, itemsize)
                new = A.heads_kernel_limit(hd) is None
                assert new or not old, (n, hd, itemsize)
                assert new == (hd <= 80 and hd % 8 == 0)
                refused_before += new and not old
    assert refused_before > 0
    assert not _first_limit_fits(592, 64, 2)
    assert not _first_limit_fits(272, 80, 4)
    assert A.heads_kernel_limit(64) is None
    assert A.heads_kernel_limit(80) is None


# ---------------------------------------------------------------------------
# the kernel's arithmetic, mirrored


def _f(v):
    return torch.tensor(v, dtype=torch.float32)


def _quantize(y, d, t, top, pow_):
    """qvt_common.cuh:quantize with folded = !pow (the plan folds 1/d)."""
    if pow_:
        p = torch.exp(t * torch.log(torch.clamp_min(y.abs(), 1e-30)))
        lv = torch.clamp_max(torch.round(p / d), top)
        return (torch.sign(y) * lv).to(torch.int8)
    return torch.clamp(torch.round(y), -top, top).to(torch.int8)


def _levels(x, g, b, d, t, top, pow_, eps=1e-6):
    """Phase 1: mu and 1/sqrt(var + eps) from f64 sums rounded once, the
    levels of ((x - mu) * rs) * gamma + beta, op by op in f32."""
    x = x.to(torch.float32)
    k = x.shape[-1]
    inv_k = _f(1.0) / _f(float(k))
    s = x.to(torch.float64).sum(-1, keepdim=True).to(torch.float32)
    s2 = (x * x).to(torch.float64).sum(-1, keepdim=True).to(torch.float32)
    mu = s * inv_k
    var = torch.clamp_min(s2 * inv_k - mu * mu, 0.0)
    rs = _f(1.0) / torch.sqrt(var + _f(eps))
    y = (x - mu) * rs * g + b
    return _quantize(y, d, t, top, pow_)


def _heads_mirror(x, w, qs, qb, g, be, *, heads, sm_scale, n_valid, d, t,
                  top, out_d, out_t, out_top, pow_, int_attention):
    """K3's result by its own order of operations (phases 1-3; the
    attention's f64 sums in K6's MMA order at the tile K3 picks)."""
    b, n, dm = x.shape
    dt = x.dtype
    gf, bf = fold_ln(g, be, d, pow_, "cpu")
    lv = _levels(x.reshape(b * n, dm), gf, bf, d, t, 127, pow_)
    acc = (lv.to(torch.int64) @ w.to(torch.int64)).to(torch.float32)
    qkv = (acc * qs + qb).to(dt).reshape(b, n, 3, heads, -1)
    hd = qkv.shape[-1]
    nk = A._n_keys(n, n_valid, x.element_size())
    rows = A.heads_tile_rows(b, n, heads, hd, x.element_size(), **H100)
    q, k, v = (qkv[:, :, i].permute(0, 2, 1, 3) for i in range(3))
    k, v = k[:, :, :nk], v[:, :, :nk]
    col = torch.arange(nk)
    if int_attention:
        def dyn(z):
            z = z.to(torch.float32)
            s = torch.clamp_min(z.abs().amax(dim=(2, 3), keepdim=True),
                                1e-30) * _f(1.0 / 127.0)
            return torch.clamp(torch.round(z * (1.0 / s)), -127, 127), s

        ql, q_s = dyn(q.float() * _f(sm_scale))  # sm_scale in f32
        kl, k_s = dyn(k)
        vl, v_s = dyn(v)
        sc = (ql.double() @ kl.double().transpose(-1, -2)).float()
        sc = sc * (q_s * k_s * _f(A._LOG2E))
        sc = torch.where(col < n_valid, sc, torch.full_like(sc, -1e30))
        p = torch.round(torch.exp2(sc - sc.amax(-1, keepdim=True)) * 127.0)
        o = (p.double() @ vl.double()).float() * v_s
        ps = p.double().sum(-1, keepdim=True).float()
    else:
        qm = (q.float() * _f(sm_scale * A._LOG2E)).to(dt)
        sc = _mma_order_dot(qm, k.transpose(-1, -2), hd)
        sc = torch.where(col < n_valid, sc, torch.full_like(sc, -1e30))
        p = torch.exp2(torch.clamp_max(sc, 100.0))
        o = _mma_order_dot(p.to(dt), v, -(-nk // 4) * 4)
        ps = _psum_order(p, rows)[..., None]
    o = o.permute(0, 2, 1, 3)  # [B, N, H, hd]
    ps = ps.permute(0, 2, 1, 3)
    if pow_:
        return _quantize(o / ps, out_d, out_t, out_top, True).reshape(
            b * n, heads * hd)
    lv = torch.clamp(torch.round(o * (_f(1.0) / (ps * out_d))), -out_top,
                     out_top)
    return lv.to(torch.int8).reshape(b * n, heads * hd)


@pytest.mark.parametrize("int_attention", [False, True],
                         ids=["f_attn", "int_attn"])
@pytest.mark.parametrize("dtype,pow_", [(torch.bfloat16, False),
                                        (torch.float32, False),
                                        (torch.bfloat16, True)],
                         ids=["bf16", "f32", "bf16_pow"])
@pytest.mark.parametrize("shape", [(2, 40, 3, 32, 29), (1, 48, 2, 80, 41),
                                   (4, 32, 2, 64, 32)],
                         ids=["h3x32", "h2x80", "h2x64_b4"])
def test_mirror_of_the_kernel_equals_the_plain_version(shape, dtype, pow_,
                                                       int_attention):
    """The kernel's own order of operations gives attention_heads_plain's
    int8 levels bit for bit, bf16 and f32, linear and pow quantizers, with
    and without int_attention, ragged and full key counts."""
    b, n, heads, hd, nv = shape
    dm = heads * hd
    rng = np.random.default_rng(b * 1000 + n + hd)
    x = torch.from_numpy(rng.standard_normal((b, n, dm)) * 0.3).to(dtype)
    w = torch.from_numpy(rng.integers(-7, 8, (dm, 3 * dm)).astype(np.int8))
    qs = _f(1e-3)
    qb = torch.from_numpy((rng.standard_normal(3 * dm) * 0.01)
                          .astype(np.float32))
    g = torch.from_numpy((rng.standard_normal(dm) * 0.1 + 1)
                         .astype(np.float32))
    be = torch.from_numpy((rng.standard_normal(dm) * 0.01)
                          .astype(np.float32))
    q = dict(act_d=_f(0.05), act_t=_f(1.08 if pow_ else 1.0), act_top=127,
             out_d=_f(0.06), out_t=_f(0.93 if pow_ else 1.0), out_top=31)
    want = A.attention_heads_plain(
        x, w, qs, qb, ln_scale=g, ln_bias=be, heads=heads,
        sm_scale=hd**-0.5, n_valid=nv, act_pow=pow_, out_pow=pow_,
        out_dtype=dtype, int_attention=int_attention, **q)
    got = _heads_mirror(
        x, w, qs, qb, g, be, heads=heads, sm_scale=hd**-0.5,
        n_valid=nv, d=q["act_d"], t=q["act_t"], top=127, out_d=q["out_d"],
        out_t=q["out_t"], out_top=31, pow_=pow_, int_attention=int_attention)
    assert torch.equal(got, want)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_plain_branch_matches_pallas_past_the_first_limit(dtype):
    """attention_block_plain against the JAX ``_attention_block`` in
    Pallas interpret mode at 592 tokens (a 384-px patch-16 model),
    head_dim 64 (more tokens than the first K3 held in shared memory in
    either dtype), n_valid 577:
    within the attention contract (bench.py:217-221: within 0.1
    everywhere, differing at <= 1% of positions). In f32 "differing"
    counts differences past 1e-5: XLA contracts the proj's
    ``acc * scale + bias`` into a multiply-add (the note of
    tests/test_torch_int_matmul.py), which moves the f32 residual sum by
    an ulp of its O(1) terms (~1e-7) at many positions, while one
    attention level flip moves an output by proj_scale * |w| >= 2e-3."""
    b, n, heads, hd, nv = 1, 592, 2, 64, 577
    dm = heads * hd
    assert not _first_limit_fits(n, hd, 2 if dtype == "bfloat16" else 4)
    rng = np.random.default_rng(11)
    x = (rng.standard_normal((b, n, dm)) * 0.2).astype(np.float32)
    wq = rng.integers(-7, 8, (dm, 3 * dm)).astype(np.int8)
    wp = rng.integers(-7, 8, (dm, dm)).astype(np.int8)
    qb = (rng.standard_normal(3 * dm) * 0.01).astype(np.float32)
    pb = (rng.standard_normal(dm) * 0.01).astype(np.float32)
    g = (rng.standard_normal(dm) * 0.1 + 1.0).astype(np.float32)
    be = (rng.standard_normal(dm) * 0.01).astype(np.float32)
    jdt = getattr(jnp, dtype)
    pal = np.asarray(ja._attention_block(
        jnp.asarray(x, jdt), jnp.asarray(wq), jnp.float32(1e-3),
        jnp.asarray(qb), jnp.asarray(wp), jnp.float32(2e-3), jnp.asarray(pb),
        ln_scale=jnp.asarray(g), ln_bias=jnp.asarray(be), heads=heads,
        sm_scale=0.125, n_valid=nv, act_d=jnp.float32(0.05),
        act_t=jnp.float32(1.0), act_top=127, out_d=jnp.float32(0.06),
        out_t=jnp.float32(1.0), out_top=31, out_dtype=jdt, interpret=True),
        np.float32)
    tdt = getattr(torch, dtype)
    got = A.attention_block_plain(
        torch.from_numpy(x).to(tdt), torch.from_numpy(wq), _f(1e-3),
        torch.from_numpy(qb), torch.from_numpy(wp), _f(2e-3),
        torch.from_numpy(pb), ln_scale=torch.from_numpy(g),
        ln_bias=torch.from_numpy(be), heads=heads, sm_scale=0.125,
        n_valid=nv, act_d=_f(0.05), act_t=_f(1.0), act_top=127,
        out_d=_f(0.06), out_t=_f(1.0), out_top=31, out_dtype=tdt)
    diff = np.abs(got.float().numpy() - pal)
    share = (diff > (1e-5 if dtype == "float32" else 0.0)).mean()
    assert diff.max() <= 0.1 and share <= 0.01, (
        f"max {diff.max()} share {share:.4%}")

"""Port parity: the standalone attention (kernel K13, ``flash_attention``)
against the JAX package's ``_flash_attention`` Pallas kernel in interpret
mode and its XLA mirror ``flash_attention_xla``.

The port follows the kernel where the two JAX functions differ: p is cast
to v's dtype before AV (attention.py:55; the mirror casts it to q's,
:963 — ROADMAP.md C1.6), so the mixed-dtype cases are held against the
kernel only. Tolerances (the JAX side sums its dots in f32, the port in
f64 rounded once): float outputs (f32) within 1e-5; int8 levels within 1
level at <= 0.5% of positions (bench.py:80-87).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from quantized_vit_tpu.ops.attention import (_flash_attention,
                                             flash_attention as j_flash,
                                             flash_attention_xla)
from quantized_vit_tpu_torch.ops import flash_attention, flash_attention_plain
from quantized_vit_tpu_torch.ops.attention import flash_kernel_limit

torch.set_num_threads(1)

# (q/k dtype, v dtype): equal, and mixed both ways (C1.6)
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

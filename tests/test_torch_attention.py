"""Port parity: K3 ``attention_block`` plain version and the attention
pieces against the JAX package.

The JAX side runs as its tests do on the CPU: ``_attention_block`` in
Pallas interpret mode, the XLA chain it replaces (qkv matmul ->
``attention_qkv_xla`` -> proj + residual), and ``attention_qkv_xla`` with
``int_attention`` on and off. Tolerances follow the JAX package's own
attention check (bench.py:217-221): the branch output within 0.1
everywhere and differing at <= 1% of positions (an attention level flip at
a rounding tie moves its row by one ``scale * w`` step); int8 levels within
1 level at <= 0.5% of positions. The port accumulates the attention dots in
f64 and the JAX package in f32, which is where such ties can split.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from quantized_vit_tpu.ops import attention as ja
from quantized_vit_tpu.ops import fused as jf
from quantized_vit_tpu.quant.packing import pack_int4 as jpack
from quantized_vit_tpu_torch.ops import attention as ta
from quantized_vit_tpu_torch.quant import pack_int4 as tpack

torch.set_num_threads(1)


def _levels_close(got, want, frac=0.005):
    d = np.abs(np.asarray(got, np.int32) - np.asarray(want, np.int32))
    assert d.max(initial=0) <= 1 and (d > 0).mean() <= frac, (
        f"level diff max {d.max()} at {(d > 0).mean():.4%}")


def _branch_close(got, want):
    d = np.abs(np.asarray(got, np.float32) - np.asarray(want, np.float32))
    assert d.max(initial=0) <= 0.1 and (d > 0).mean() <= 0.01, (
        f"max {d.max()} share {(d > 0).mean():.4%}")


def _mk(b=2, n=32, heads=3, hd=32, seed=0):
    rng = np.random.default_rng(seed)
    d = heads * hd
    return dict(
        b=b, n=n, heads=heads, hd=hd, d=d, three=3 * d,
        x=(rng.standard_normal((b, n, d)) * 0.2).astype(np.float32),
        wq=rng.integers(-7, 8, (d, 3 * d)).astype(np.int8),
        qb=(rng.standard_normal(3 * d) * 0.01).astype(np.float32),
        wp=rng.integers(-7, 8, (d, d)).astype(np.int8),
        pb=(rng.standard_normal(d) * 0.01).astype(np.float32),
        g=(rng.standard_normal(d) * 0.1 + 1.0).astype(np.float32),
        be=(rng.standard_normal(d) * 0.01).astype(np.float32),
    )


def _qkw(pow_, framework):
    f = (lambda v: jnp.float32(v)) if framework == "jax" else (
        lambda v: torch.tensor(v, dtype=torch.float32))
    return dict(act_d=f(0.05), act_t=f(1.08 if pow_ else 1.0), act_top=127,
                act_pow=pow_, out_d=f(0.06), out_t=f(0.93 if pow_ else 1.0),
                out_top=31, out_pow=pow_)


def _w(arr, fmt, framework):
    if framework == "jax":
        a = jnp.asarray(arr)
        return jpack(a, axis=0) if fmt == "int4" else a
    a = torch.from_numpy(arr)
    return tpack(a) if fmt == "int4" else a


@pytest.mark.parametrize("pow_", [False, True], ids=["lin", "pow"])
@pytest.mark.parametrize("fmt", ["int8", "int4"])
def test_attention_block_plain_matches_pallas_and_chain(fmt, pow_):
    """Odd head count (3 heads, the compressed-subnet case of
    tests/ops/test_attention_block.py:82), masked keys (n_valid 29 < 32)."""
    m = _mk()
    nv = 29
    xj = jnp.asarray(m["x"], jnp.bfloat16)
    common_j = dict(ln_scale=jnp.asarray(m["g"]), ln_bias=jnp.asarray(m["be"]),
                    heads=m["heads"], sm_scale=0.18, n_valid=nv,
                    **_qkw(pow_, "jax"))
    pal = np.asarray(ja._attention_block(
        xj, _w(m["wq"], fmt, "jax"), jnp.float32(1e-3), jnp.asarray(m["qb"]),
        _w(m["wp"], fmt, "jax"), jnp.float32(2e-3), jnp.asarray(m["pb"]),
        fmt=fmt, interpret=True, **common_j), np.float32)
    x2 = xj.reshape(m["b"] * m["n"], m["d"])
    q = _qkw(pow_, "jax")
    qkv = jf.fused_quant_matmul_xla(
        x2, _w(m["wq"], fmt, "jax"), jnp.float32(1e-3), jnp.asarray(m["qb"]),
        fmt=fmt, prologue="ln_quant", act_d=q["act_d"], act_t=q["act_t"],
        act_top=127, act_pow=pow_, ln_scale=jnp.asarray(m["g"]),
        ln_bias=jnp.asarray(m["be"]), out_dtype=jnp.bfloat16)
    alv = ja.attention_qkv_xla(
        qkv.reshape(m["b"], m["n"], m["three"]), heads=m["heads"],
        sm_scale=0.18, n_valid=nv, out_d=q["out_d"], out_t=q["out_t"],
        out_top=31, out_pow=pow_)
    chain = np.asarray(jf.fused_quant_matmul_xla(
        alv.reshape(-1, m["d"]), _w(m["wp"], fmt, "jax"), jnp.float32(2e-3),
        jnp.asarray(m["pb"]), fmt=fmt, prologue=None, epilogue="residual",
        residual=x2), np.float32).reshape(pal.shape)

    xt = torch.from_numpy(m["x"]).to(torch.bfloat16)
    kw = dict(ln_scale=torch.from_numpy(m["g"]),
              ln_bias=torch.from_numpy(m["be"]), heads=m["heads"],
              sm_scale=0.18, n_valid=nv, fmt=fmt, out_dtype=torch.bfloat16,
              **_qkw(pow_, "torch"))
    got = ta.attention_block_plain(
        xt, _w(m["wq"], fmt, "torch"), torch.tensor(1e-3),
        torch.from_numpy(m["qb"]), _w(m["wp"], fmt, "torch"),
        torch.tensor(2e-3), torch.from_numpy(m["pb"]), **kw).float().numpy()
    _branch_close(got, pal)
    _branch_close(got, chain)
    alv_t = ta.attention_heads_plain(
        xt, _w(m["wq"], fmt, "torch"), torch.tensor(1e-3),
        torch.from_numpy(m["qb"]), **kw)
    _levels_close(alv_t.numpy(), np.asarray(alv).reshape(-1, m["d"]))


def test_attention_block_mixed_formats_match_chain():
    """qkv int8, proj packed int4 (GETA mixed precision): one call, a
    format per weight operand."""
    m = _mk(seed=3)
    xj = jnp.asarray(m["x"], jnp.bfloat16)
    x2 = xj.reshape(-1, m["d"])
    q = _qkw(False, "jax")
    qkv = jf.fused_quant_matmul_xla(
        x2, jnp.asarray(m["wq"]), jnp.float32(1e-3), jnp.asarray(m["qb"]),
        fmt="int8", prologue="ln_quant", act_d=q["act_d"], act_t=q["act_t"],
        act_top=127, ln_scale=jnp.asarray(m["g"]),
        ln_bias=jnp.asarray(m["be"]), out_dtype=jnp.bfloat16)
    alv = ja.attention_qkv_xla(
        qkv.reshape(m["b"], m["n"], m["three"]), heads=m["heads"],
        sm_scale=0.18, n_valid=29, out_d=q["out_d"], out_t=q["out_t"],
        out_top=31)
    want = np.asarray(jf.fused_quant_matmul_xla(
        alv.reshape(-1, m["d"]), _w(m["wp"], "int4", "jax"),
        jnp.float32(2e-3), jnp.asarray(m["pb"]), fmt="int4", prologue=None,
        epilogue="residual", residual=x2), np.float32)
    got = ta.attention_block_plain(
        torch.from_numpy(m["x"]).to(torch.bfloat16),
        torch.from_numpy(m["wq"]), torch.tensor(1e-3),
        torch.from_numpy(m["qb"]), _w(m["wp"], "int4", "torch"),
        torch.tensor(2e-3), torch.from_numpy(m["pb"]),
        ln_scale=torch.from_numpy(m["g"]), ln_bias=torch.from_numpy(m["be"]),
        heads=m["heads"], sm_scale=0.18, n_valid=29, fmt="int8",
        fmt_proj="int4", out_dtype=torch.bfloat16, **_qkw(False, "torch"))
    _branch_close(got.float().numpy().reshape(want.shape), want)


@pytest.mark.parametrize("quantize", [False, True], ids=["float", "levels"])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("int_attention", [False, True],
                         ids=["float_attn", "int_attn"])
def test_attention_qkv_plain_matches_xla(int_attention, dtype, quantize):
    """The plain attention on the fused-qkv layout, 3 heads, masked keys,
    both residual dtypes, int8 or float output, int_attention on/off."""
    rng = np.random.default_rng(11)
    b, n, heads, hd = 2, 24, 3, 16
    qkv = (rng.standard_normal((b, n, 3 * heads * hd)) * 0.7).astype(
        np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    kw = dict(heads=heads, sm_scale=hd**-0.5, n_valid=19)
    qj, qt = {}, {}
    if quantize:
        qj = dict(out_d=jnp.float32(0.02), out_t=jnp.float32(1.0),
                  out_top=31)
        qt = dict(out_d=torch.tensor(0.02), out_t=torch.tensor(1.0),
                  out_top=31)
    want = np.asarray(ja.attention_qkv_xla(
        jnp.asarray(qkv, jdt), int_attention=int_attention,
        out_dtype=jnp.float32, **kw, **qj))
    got = ta.attention_qkv_plain(
        torch.from_numpy(qkv).to(tdt), int_attention=int_attention,
        out_dtype=torch.float32, **kw, **qt).numpy()
    assert got.shape == want.shape == (b, n, heads * hd)
    if quantize:
        _levels_close(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_attention_pieces_match_jax():
    """_dyn_int8, _n_keys, _score_one_head and _softmax_av, one head."""
    rng = np.random.default_rng(5)
    q = (rng.standard_normal((20, 16)) * 0.8).astype(np.float32)
    k = (rng.standard_normal((24, 16)) * 0.8).astype(np.float32)
    v = (rng.standard_normal((24, 16)) * 0.8).astype(np.float32)
    lv_t, s_t = ta._dyn_int8(torch.from_numpy(q))
    lv_j, s_j = ja._dyn_int8(jnp.asarray(q))
    np.testing.assert_array_equal(lv_t.numpy(), np.asarray(lv_j))
    assert float(s_t) == float(s_j)
    for n, nv, item in ((208, 197, 2), (208, 197, 4), (32, 29, 2), (16, 16, 4)):
        assert ta._n_keys(n, nv, item) == ja._n_keys(n, nv, item)
    col = np.arange(24)[None, :]
    for int_attn in (False, True):
        s2_t = ta._score_one_head(torch.from_numpy(q), torch.from_numpy(k),
                                  0.25, int_attn)
        s2_j = ja._score_one_head(jnp.asarray(q), jnp.asarray(k), 0.25,
                                  int_attn)
        np.testing.assert_allclose(s2_t.numpy(), np.asarray(s2_j),
                                   rtol=1e-5, atol=1e-5)
        o_t, p_t = ta._softmax_av(s2_t, torch.from_numpy(v),
                                  torch.from_numpy(col), 21, int_attn)
        o_j, p_j = ja._softmax_av(jnp.asarray(s2_t.numpy()), jnp.asarray(v),
                                  jnp.asarray(col), 21, int_attn)
        np.testing.assert_allclose(o_t.numpy(), np.asarray(o_j), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(p_t.numpy(), np.asarray(p_j), rtol=1e-6)

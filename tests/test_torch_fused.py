"""Port parity: K1 ``fused_quant_matmul`` and K2 ``fused_mlp`` plain
PyTorch versions (and the level-math pieces) against the JAX package.

Inputs come from a numpy seed and go to both packages. The JAX side runs
as its own tests run it on the CPU: the XLA mirror, and the Pallas kernel
in interpret mode. Tolerances follow the parity contract of the JAX
package's kernel checks (bench.py:80-87, :129-132): integer accumulators
exact; int8-level outputs within 1 level at <= 0.5% of positions (the port
sums LayerNorm statistics in f64, the JAX package in f32, so a level can
flip at a rounding tie); float outputs of the same f32 epilogue within
1e-6 relative, except that a flipped input level moves an output by one
``scale * w`` step, at no more than 0.5% of rows.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from quantized_vit_tpu.ops import fused as jf
from quantized_vit_tpu.ops import reference as jref
from quantized_vit_tpu.quant.packing import pack_int4 as jpack
from quantized_vit_tpu_torch.ops import fused as tf
from quantized_vit_tpu_torch.ops import reference as tref
from quantized_vit_tpu_torch.quant import pack_int4 as tpack

torch.set_num_threads(1)

PROLOGUES = [None, "quant", "ln_quant", "gelu_quant"]
EPILOGUES = [None, "residual", "quant", "gelu_quant"]


def _levels_close(got, want):
    d = np.abs(np.asarray(got, np.int32) - np.asarray(want, np.int32))
    assert d.max(initial=0) <= 1 and (d > 0).mean() <= 0.005, (
        f"level diff max {d.max()} at {(d > 0).mean():.4%}")


def _float_close(got, want, step):
    """Equal to f32 rounding, except rows where an input level flipped
    (each moves an output by at most ``step``), at <= 0.5% of rows."""
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    d = np.abs(got - want)
    tol = 1e-6 + 1e-6 * np.abs(want)
    bad_rows = (d > tol).any(axis=-1)
    assert bad_rows.mean() <= 0.005, f"{bad_rows.sum()} rows differ"
    assert d.max(initial=0) <= step + 1e-5, f"max diff {d.max()}"


def _k1_inputs(seed, m, k, n, fmt, prologue, epilogue, pow_, with_bias):
    rng = np.random.default_rng(seed)
    if prologue is None:
        x = rng.integers(-7, 8, (m, k)).astype(np.int8)
    elif prologue == "gelu_quant":
        x = (rng.standard_normal((m, k)) * 1.5).astype(np.float32)
    else:
        x = rng.standard_normal((m, k)).astype(np.float32)
    w = rng.integers(-7, 8, (k, n)).astype(np.int8)
    scale = (rng.random(n) * 0.01 + 1e-3).astype(np.float32)
    bias = ((rng.standard_normal(n) * 0.1).astype(np.float32)
            if with_bias else None)
    kw = {}
    if prologue is not None:
        kw.update(act_d=np.float32(0.05),
                  act_t=np.float32(1.08 if pow_ else 1.0),
                  act_top=127 if prologue == "ln_quant" else 7,
                  act_pow=pow_ and prologue != "gelu_quant")
    if prologue == "ln_quant":
        kw.update(ln_scale=(rng.standard_normal(k) * 0.1 + 1).astype(
                      np.float32),
                  ln_bias=(rng.standard_normal(k) * 0.01).astype(np.float32))
    res = None
    if epilogue == "residual":
        res = rng.standard_normal((m, n)).astype(np.float32)
    if epilogue in ("quant", "gelu_quant"):
        kw.update(out_d=np.float32(0.5),
                  out_t=np.float32(0.93 if pow_ else 1.0), out_top=31,
                  out_pow=pow_)
    return x, w, scale, bias, res, kw


def _run_both(x, w, scale, bias, res, kw, fmt, prologue, epilogue,
              pallas=False):
    wj = jpack(jnp.asarray(w), axis=0) if fmt == "int4" else jnp.asarray(w)
    wt = tpack(torch.from_numpy(w)) if fmt == "int4" else torch.from_numpy(w)
    jkw = {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
           for k, v in kw.items()}
    tkw = {k: (torch.from_numpy(v) if isinstance(v, np.ndarray)
               else torch.tensor(v) if isinstance(v, np.floating) else v)
           for k, v in kw.items()}
    common = dict(fmt=fmt, prologue=prologue, epilogue=epilogue)
    jres = None if res is None else jnp.asarray(res)
    tres = None if res is None else torch.from_numpy(res)
    jb = None if bias is None else jnp.asarray(bias)
    tb = None if bias is None else torch.from_numpy(bias)
    want = jf.fused_quant_matmul_xla(
        jnp.asarray(x), wj, jnp.asarray(scale), jb, residual=jres,
        out_dtype=jnp.float32, **common, **jkw)
    got = tf.fused_quant_matmul_plain(
        torch.from_numpy(x), wt, torch.from_numpy(scale), tb, residual=tres,
        out_dtype=torch.float32, **common, **tkw)
    pal = None
    if pallas:
        pal = jf.fused_quant_matmul(
            jnp.asarray(x), wj, jnp.asarray(scale), jb, residual=jres,
            out_dtype=jnp.float32, interpret=True, **common, **jkw)
    return got.numpy(), np.asarray(want), (None if pal is None
                                           else np.asarray(pal))


@pytest.mark.parametrize("pow_", [False, True], ids=["lin", "pow"])
@pytest.mark.parametrize("fmt", ["int4", "int8"])
@pytest.mark.parametrize("epilogue", EPILOGUES, ids=str)
@pytest.mark.parametrize("prologue", PROLOGUES, ids=str)
def test_fused_quant_matmul_plain_matches_xla(prologue, epilogue, fmt, pow_):
    """Every prologue x epilogue, both formats, both quantizer maps; odd
    M/N and no bias on alternate cases."""
    i = PROLOGUES.index(prologue) + EPILOGUES.index(epilogue)
    odd = i % 2 == 1
    m, k, n = (37, 64, 50) if odd else (48, 64, 96)
    x, w, scale, bias, res, kw = _k1_inputs(
        i + 10 * pow_, m, k, n, fmt, prologue, epilogue, pow_,
        with_bias=not odd)
    got, want, _ = _run_both(x, w, scale, bias, res, kw, fmt, prologue,
                             epilogue)
    assert got.shape == want.shape == (m, n)
    if epilogue in ("quant", "gelu_quant"):
        assert got.dtype == np.int8
        _levels_close(got, want)
    else:
        _float_close(got, want, step=0.01 * 8 * 8)


@pytest.mark.parametrize("epilogue", EPILOGUES, ids=str)
@pytest.mark.parametrize("prologue", PROLOGUES, ids=str)
def test_fused_quant_matmul_plain_matches_pallas_interpret(prologue,
                                                           epilogue):
    """The Pallas kernel itself (interpret mode), packed int4 weights."""
    x, w, scale, bias, res, kw = _k1_inputs(
        3, 48, 256, 128, "int4", prologue, epilogue, False, with_bias=True)
    got, _, pal = _run_both(x, w, scale, bias, res, kw, "int4", prologue,
                            epilogue, pallas=True)
    if epilogue in ("quant", "gelu_quant"):
        _levels_close(got, pal)
    else:
        _float_close(got, pal, step=0.01 * 8 * 8)


def _mlp_inputs(seed, m, k, hid, pow_):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((m, k)) * 0.5).astype(np.float32)
    w1 = rng.integers(-7, 8, (k, hid)).astype(np.int8)
    w2 = rng.integers(-7, 8, (hid, k)).astype(np.int8)
    b1 = (rng.standard_normal(hid) * 0.01).astype(np.float32)
    b2 = (rng.standard_normal(k) * 0.01).astype(np.float32)
    kw = dict(ln_scale=(rng.standard_normal(k) * 0.1 + 1).astype(np.float32),
              ln_bias=(rng.standard_normal(k) * 0.01).astype(np.float32),
              act_d=np.float32(0.05), act_t=np.float32(1.08 if pow_ else 1),
              act_top=127, act_pow=pow_, hid_d=np.float32(0.05),
              hid_t=np.float32(0.93 if pow_ else 1), hid_top=127,
              hid_pow=pow_)
    return x, w1, b1, w2, b2, kw


def _to_t(kw):
    return {k: (torch.from_numpy(v) if isinstance(v, np.ndarray)
                else torch.tensor(v) if isinstance(v, np.floating) else v)
            for k, v in kw.items()}


def _to_j(kw):
    return {k: (jnp.asarray(v) if isinstance(v, (np.ndarray, np.floating))
                else v) for k, v in kw.items()}


@pytest.mark.parametrize("pow_", [False, True], ids=["lin", "pow"])
@pytest.mark.parametrize("fmt", ["int4", "int8"])
def test_fused_mlp_plain_matches_jax(fmt, pow_):
    """K2 plain vs the XLA mirror and the resident-weight Pallas kernel
    (interpret). Float output within 1e-5 (bench.py:129-132) unless a
    hidden level flipped at a tie."""
    m, k, hid = 40, 256, 512
    x, w1, b1, w2, b2, kw = _mlp_inputs(5 + pow_, m, k, hid, pow_)
    s1, s2 = np.float32(1e-3), np.float32(1e-3)
    jw1 = jpack(jnp.asarray(w1), axis=0) if fmt == "int4" else jnp.asarray(w1)
    jw2 = jpack(jnp.asarray(w2), axis=0) if fmt == "int4" else jnp.asarray(w2)
    tw1 = tpack(torch.from_numpy(w1)) if fmt == "int4" else torch.from_numpy(
        w1)
    tw2 = tpack(torch.from_numpy(w2)) if fmt == "int4" else torch.from_numpy(
        w2)
    xj = jnp.asarray(x, jnp.bfloat16)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    args_j = (xj, jw1, jnp.asarray(s1), jnp.asarray(b1), jw2, jnp.asarray(s2),
              jnp.asarray(b2))
    want = np.asarray(jf.fused_mlp_xla(*args_j, fmt=fmt,
                                       out_dtype=jnp.bfloat16, **_to_j(kw)),
                      np.float32)
    pal = np.asarray(jf.fused_mlp(*args_j, fmt=fmt, out_dtype=jnp.bfloat16,
                                  interpret=True, **_to_j(kw)), np.float32)
    got = tf.fused_mlp_plain(
        xt, tw1, torch.tensor(s1), torch.from_numpy(b1), tw2,
        torch.tensor(s2), torch.from_numpy(b2), fmt=fmt,
        out_dtype=torch.bfloat16, **_to_t(kw)).float().numpy()
    for ref in (want, pal):
        d = np.abs(got - ref)
        # a flipped hidden level moves a bf16 output by ~s2*|w2| = 7e-3
        assert (d > 1e-5).any(axis=-1).mean() <= 0.05, d.max()
        assert d.max() <= 0.05


@pytest.mark.parametrize("pow_", [False, True], ids=["lin", "pow"])
def test_fused_mlp_plain_matches_jax_at_vit_h_width(pow_):
    """K2 plain vs the XLA mirror and the resident-weight Pallas kernel
    (interpret) at ViT-H/14's widths (K 1280, H 5120) with packed int4
    weights, which the CUDA kernel's first design refused; a few rows.
    Tolerance as the ViT-B-width case."""
    m, k, hid = 8, 1280, 5120
    x, w1, b1, w2, b2, kw = _mlp_inputs(21 + pow_, m, k, hid, pow_)
    s1, s2 = np.float32(1e-3), np.float32(1e-3)
    xj = jnp.asarray(x, jnp.bfloat16)
    args_j = (xj, jpack(jnp.asarray(w1), axis=0), jnp.asarray(s1),
              jnp.asarray(b1), jpack(jnp.asarray(w2), axis=0),
              jnp.asarray(s2), jnp.asarray(b2))
    want = np.asarray(jf.fused_mlp_xla(*args_j, fmt="int4",
                                       out_dtype=jnp.bfloat16, **_to_j(kw)),
                      np.float32)
    pal = np.asarray(jf.fused_mlp(*args_j, fmt="int4",
                                  out_dtype=jnp.bfloat16, interpret=True,
                                  **_to_j(kw)), np.float32)
    got = tf.fused_mlp_plain(
        torch.from_numpy(x).to(torch.bfloat16), tpack(torch.from_numpy(w1)),
        torch.tensor(s1), torch.from_numpy(b1), tpack(torch.from_numpy(w2)),
        torch.tensor(s2), torch.from_numpy(b2), fmt="int4",
        out_dtype=torch.bfloat16, **_to_t(kw)).float().numpy()
    for ref in (want, pal):
        d = np.abs(got - ref)
        assert (d > 1e-5).any(axis=-1).mean() <= 0.05, d.max()
        assert d.max() <= 0.05


@pytest.mark.parametrize("pow_", [False, True], ids=["lin", "pow"])
def test_fused_mlp_plain_prefolded_equals_folding(pow_):
    """``prefolded``: fed the constants that fold_ln/fold_gelu make (a
    folded block stack's operands), the plain MLP equals the call that
    folds them itself, bit for bit."""
    m, k, hid = 24, 64, 96
    x, w1, b1, w2, b2, kw = _mlp_inputs(11 + pow_, m, k, hid, pow_)
    tkw = _to_t(kw)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    w1t, w2t = torch.from_numpy(w1), torch.from_numpy(w2)
    s1, b1t = torch.full((hid,), 1e-3), torch.from_numpy(b1)
    s2, b2t = torch.tensor(1e-3), torch.from_numpy(b2)
    want = tf.fused_mlp_plain(xt, w1t, s1, b1t, w2t, s2, b2t, fmt="int8",
                              **tkw)
    g, b = tf.fold_ln(tkw["ln_scale"], tkw["ln_bias"], tkw["act_d"], pow_,
                      "cpu")
    fs1, fb1 = (s1, b1t) if pow_ else tf.fold_gelu(s1, b1t, "cpu")
    got = tf.fused_mlp_plain(xt, w1t, fs1, fb1, w2t, s2, b2t, fmt="int8",
                             prefolded=True,
                             **dict(tkw, ln_scale=g, ln_bias=b))
    assert torch.equal(got, want)


def test_fused_mlp_mixed_formats_match_jax_chain():
    """GETA mixed-precision export: w1 int8, w2 packed int4. The JAX
    reference is its XLA chain with a format per layer."""
    m, k, hid = 24, 64, 96
    x, w1, b1, w2, b2, kw = _mlp_inputs(9, m, k, hid, False)
    jkw = _to_j(kw)
    xj = jnp.asarray(x)
    hlv = jf.fused_quant_matmul_xla(
        xj, jnp.asarray(w1), jnp.float32(1e-3), jnp.asarray(b1), fmt="int8",
        prologue="ln_quant", act_d=jkw["act_d"], act_t=jkw["act_t"],
        act_top=127, ln_scale=jkw["ln_scale"], ln_bias=jkw["ln_bias"],
        epilogue="gelu_quant", out_d=jkw["hid_d"], out_t=jkw["hid_t"],
        out_top=127)
    want = np.asarray(jf.fused_quant_matmul_xla(
        hlv, jpack(jnp.asarray(w2), axis=0), jnp.float32(1e-3),
        jnp.asarray(b2), fmt="int4", prologue=None, epilogue="residual",
        residual=xj, out_dtype=jnp.float32))
    got = tf.fused_mlp_plain(
        torch.from_numpy(x), torch.from_numpy(w1), torch.tensor(1e-3),
        torch.from_numpy(b1), tpack(torch.from_numpy(w2)),
        torch.tensor(1e-3), torch.from_numpy(b2), fmt="int8", fmt2="int4",
        out_dtype=torch.float32, **_to_t(kw)).numpy()
    _float_close(got, want, step=1e-3 * 8)


@pytest.mark.parametrize("fmt", ["int4", "int8"])
def test_reference_int_matmuls_exact(fmt):
    rng = np.random.default_rng(2)
    x = rng.integers(-127, 128, (33, 3072)).astype(np.int8)
    w = rng.integers(-7, 8, (3072, 40)).astype(np.int8)
    if fmt == "int4":
        want = jref.int4_matmul_ref(jnp.asarray(x),
                                    jpack(jnp.asarray(w), axis=0))
        got = tref.int4_matmul_ref(torch.from_numpy(x),
                                   tpack(torch.from_numpy(w)))
    else:
        w = rng.integers(-127, 128, (3072, 40)).astype(np.int8)
        want = jref.int8_matmul_ref(jnp.asarray(x), jnp.asarray(w))
        got = tref.int8_matmul_ref(torch.from_numpy(x), torch.from_numpy(w))
    # 127 * 127 * 3072 > 2**24: an f32 product would not be exact
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.dtype == torch.int32
    acc = got[:4]
    s = np.float32(3e-3)
    b = np.arange(40, dtype=np.float32)
    np.testing.assert_array_equal(
        tref.quant_linear_ref(acc, torch.tensor(s), torch.from_numpy(b)),
        np.asarray(jref.quant_linear_ref(jnp.asarray(acc.numpy()), s,
                                         jnp.asarray(b))))


def test_level_math_pieces_match_jax():
    """erf polynomial, GELU, the folded GELU-quant, both quantizer maps and
    the fast-variance LayerNorm, element for element."""
    rng = np.random.default_rng(4)
    x = (rng.standard_normal((64, 128)) * 2).astype(np.float32)
    xt, xj = torch.from_numpy(x), jnp.asarray(x)
    np.testing.assert_array_equal(tf._erf_f32(xt).numpy(),
                                  np.asarray(jf._erf_f32(xj)))
    np.testing.assert_allclose(tf._gelu_f32(xt).numpy(),
                               np.asarray(jf._gelu_f32(xj)), rtol=1e-6,
                               atol=1e-7)
    d = np.float32(0.07)
    np.testing.assert_array_equal(
        tf._gelu_quant_folded(xt, torch.tensor(d), 31).numpy(),
        np.asarray(jf._gelu_quant_folded(xj, jnp.float32(d), 31)))
    for pow_, t in ((False, 1.0), (True, 0.9)):
        _levels_close(
            tf._quantize_f32(xt, torch.tensor(d), torch.tensor(np.float32(t)),
                             63, pow_).numpy(),
            np.asarray(jf._quantize_f32(xj, jnp.float32(d), jnp.float32(t),
                                        63, pow_)))
    g = (rng.standard_normal(128) * 0.1 + 1).astype(np.float32)
    b = (rng.standard_normal(128) * 0.1).astype(np.float32)
    np.testing.assert_allclose(
        tf._layernorm_f32(xt, torch.from_numpy(g), torch.from_numpy(b),
                          1e-6).numpy(),
        np.asarray(jf._layernorm_f32(xj, jnp.asarray(g), jnp.asarray(b),
                                     1e-6)), rtol=1e-5, atol=1e-5)

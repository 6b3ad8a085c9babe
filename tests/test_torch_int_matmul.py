"""Port parity: the first-generation integer GEMMs K10-K12
(``int4_matmul``, ``int8_matmul``, ``quant_matmul_fa``) against the JAX
package.

The port runs its plain versions through the public wrappers on CPU
tensors; the CUDA kernels are held to those on the card by
``chip_smoke.py``. The JAX side runs as tests/ops/test_int4_matmul.py
runs it: the Pallas kernels in interpret mode, and the XLA mirrors.
Tolerances: integer sums are exact, so a float output is exact against
the JAX function run op by op (``jax.disable_jit``); jitted, XLA may
contract ``acc * scale + bias`` into one multiply-add, so against a
jitted call one ulp (f32, or bf16 for a bf16 output) of the larger of
the result and the product before the bias. Requantized
int8 levels: within 1 level at <= 0.5% of positions. The LSFQ pipeline
and ``quant_matmul_fa``'s numpy reference keep their test's 1e-4.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from quantized_vit_tpu.ops import int4_matmul as j_int4
from quantized_vit_tpu.ops import int4_matmul_xla as j_int4_xla
from quantized_vit_tpu.ops import int8_matmul as j_int8
from quantized_vit_tpu.ops import int8_matmul_xla as j_int8_xla
from quantized_vit_tpu.ops import quant_matmul_fa as j_fa
from quantized_vit_tpu.ops.int4_matmul import _fa_quant as j_fa_quant
from quantized_vit_tpu.quant import pack_int4 as j_pack
from quantized_vit_tpu_torch.ops import (int4_matmul, int4_matmul_xla,
                                         int8_matmul, int8_matmul_xla,
                                         quant_matmul_fa)
from quantized_vit_tpu_torch.ops.int4_matmul import fa_levels
from quantized_vit_tpu_torch.quant import pack_int4, unpack_int4

torch.set_num_threads(1)


def _levels(shape, seed, lo=-7, hi=8):
    return np.random.default_rng(seed).integers(lo, hi, size=shape).astype(
        np.int8)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _ulp_close(got, want, bias=None, dtype=np.float32):
    """|got - want| within one ulp in ``dtype`` of the larger of the two
    and of the product before ``bias`` was added: a contracted
    ``acc * scale + bias`` skips the product's rounding, which can be worth
    more than an ulp of the sum where the bias cancels the product."""
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    mag = np.maximum(np.abs(got), np.abs(want))
    if bias is not None:
        mag = np.maximum(mag, np.abs(want - np.asarray(bias, np.float32)))
    if dtype == "bfloat16":  # 8 significand bits
        ulp = np.exp2(np.floor(np.log2(np.maximum(mag, 1e-30))) - 7)
    elif dtype == "float16":
        ulp = np.spacing(mag.astype(np.float16)).astype(np.float32)
    else:
        ulp = np.spacing(mag)
    assert np.all(np.abs(got - want) <= ulp), np.abs(got - want).max()


def _levels_close(got, want, frac=0.005):
    d = np.abs(np.asarray(got, np.int32) - np.asarray(want, np.int32))
    assert d.max(initial=0) <= 1 and (d > 0).mean() <= frac, (
        f"level diff max {d.max()} at {(d > 0).mean():.4%}")


def _scale_bias(n, seed, bias=True):
    rng = np.random.default_rng(seed)
    scale = (rng.random(n) * 0.01).astype(np.float32)
    b = rng.standard_normal(n).astype(np.float32) if bias else None
    return scale, b


@pytest.mark.parametrize("m,k,n", [(8, 64, 128), (197, 768, 768),
                                   (100, 250, 130)])
def test_int4_matmul_matches_jax(m, k, n):
    """Per-channel scale and bias, f32 out, ragged shapes (K = 250 is off
    the 16-byte path and not a multiple of the TPU's 256)."""
    x, w = _levels((m, k), 0), _levels((k, n), 1)
    scale, bias = _scale_bias(n, 2)
    wp = j_pack(jnp.asarray(w), axis=0)
    want = np.asarray(j_int4(jnp.asarray(x), wp, jnp.asarray(scale),
                             jnp.asarray(bias), block_m=64, block_n=128,
                             interpret=True))
    got = int4_matmul(_t(x), pack_int4(_t(w)), _t(scale), _t(bias),
                      block_m=64, block_n=128)
    assert got.dtype == torch.float32 and got.shape == (m, n)
    _ulp_close(got.numpy(), want, bias)
    with jax.disable_jit():
        mirror = np.asarray(j_int4_xla(jnp.asarray(x), wp, jnp.asarray(scale),
                                       jnp.asarray(bias)))
    np.testing.assert_array_equal(got.numpy(), mirror)
    np.testing.assert_array_equal(
        int4_matmul_xla(_t(x), pack_int4(_t(w)), _t(scale), _t(bias)).numpy(),
        mirror)


def test_int4_matmul_scalar_scale_no_bias():
    x, w = _levels((32, 128), 3), _levels((128, 64), 4)
    wp = j_pack(jnp.asarray(w), axis=0)
    want = np.asarray(j_int4(jnp.asarray(x), wp, jnp.float32(0.02),
                             interpret=True, block_m=32, block_n=64))
    got = int4_matmul(_t(x), pack_int4(_t(w)), 0.02).numpy()
    _ulp_close(got, want)
    with jax.disable_jit():
        mirror = np.asarray(j_int4_xla(jnp.asarray(x), wp, jnp.float32(0.02)))
    np.testing.assert_array_equal(got, mirror)


@pytest.mark.parametrize("m,k,n", [(64, 128, 96), (50, 96, 72)])
def test_int4_matmul_requant_matches_jax(m, k, n):
    """The fused requant epilogue: int8 ``clip(round(acc*scale+bias),
    -top, top)``."""
    x, w = _levels((m, k), 5), _levels((k, n), 6)
    rng = np.random.default_rng(7)
    scale = (rng.random(n) * 0.02 + 0.01).astype(np.float32)
    bias = (rng.standard_normal(n) * 2).astype(np.float32)
    want = np.asarray(j_int4(jnp.asarray(x), j_pack(jnp.asarray(w), axis=0),
                             jnp.asarray(scale), jnp.asarray(bias),
                             requant_top=7, interpret=True))
    got = int4_matmul(_t(x), pack_int4(_t(w)), _t(scale), _t(bias),
                      requant_top=7).numpy()
    assert got.dtype == want.dtype == np.int8
    _levels_close(got, want)
    assert np.abs(got).max() == 7 and (got == 0).mean() < 0.5


def test_int4_packed_tail_equals_the_repacked_weight():
    """K = 200 is not a multiple of 256: the JAX wrapper unpacks, pads and
    repacks the weight (int4_matmul.py:176-184), which moves the packing's
    halves; the port multiplies the packed weight as it is. Both equal the
    product with the weight repacked at K = 256 and x padded with zeros."""
    m, k, n, kp = 24, 200, 40, 256
    x, w = _levels((m, k), 8), _levels((k, n), 9)
    scale, bias = _scale_bias(n, 10)
    got = int4_matmul(_t(x), pack_int4(_t(w)), _t(scale), _t(bias)).numpy()
    w_pad = pack_int4(torch.nn.functional.pad(
        unpack_int4(pack_int4(_t(w))), (0, 0, 0, kp - k)))
    x_pad = torch.nn.functional.pad(_t(x), (0, kp - k))
    np.testing.assert_array_equal(
        got, int4_matmul(x_pad, w_pad, _t(scale), _t(bias)).numpy())
    want = np.asarray(j_int4(jnp.asarray(x), j_pack(jnp.asarray(w), axis=0),
                             jnp.asarray(scale), jnp.asarray(bias),
                             interpret=True))
    _ulp_close(got, want, bias)


@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,k,n", [(64, 128, 128), (197, 768, 256),
                                   (33, 40, 24)])
def test_int8_matmul_matches_jax(m, k, n, out_dtype):
    """int8 x int8 in f32, then the cast to ``out_dtype``."""
    x = _levels((m, k), 11, -127, 128)
    w = _levels((k, n), 12, -127, 128)
    scale, bias = _scale_bias(n, 13, bias=(m % 2 == 1))
    jb = None if bias is None else jnp.asarray(bias)
    tb = None if bias is None else _t(bias)
    want = np.asarray(j_int8(jnp.asarray(x), jnp.asarray(w),
                             jnp.asarray(scale), jb, block_m=64,
                             block_n=128, out_dtype=getattr(jnp, out_dtype),
                             interpret=True), np.float32)
    got = int8_matmul(_t(x), _t(w), _t(scale), tb, block_m=64, block_n=128,
                      out_dtype=getattr(torch, out_dtype))
    assert got.dtype == getattr(torch, out_dtype)
    _ulp_close(got.float().numpy(), want, bias,
               "bfloat16" if out_dtype == "bfloat16" else np.float32)
    with jax.disable_jit():
        mirror = np.asarray(j_int8_xla(
            jnp.asarray(x), jnp.asarray(w), jnp.asarray(scale), jb,
            out_dtype=getattr(jnp, out_dtype)), np.float32)
    np.testing.assert_array_equal(got.float().numpy(), mirror)
    np.testing.assert_array_equal(
        int8_matmul_xla(_t(x), _t(w), _t(scale), tb,
                        getattr(torch, out_dtype)).float().numpy(), mirror)


@pytest.mark.parametrize("kernel", ["int4_matmul", "int8_matmul",
                                    "quant_matmul_fa"])
def test_float16_out_matches_jax(kernel):
    """Any float ``out_dtype``, as the JAX kernels take (int4_matmul.py:
    98, 296, 365): the wrapper casts the f32 product (the CUDA kernel
    writes f32, bf16 or requantized int8). float16 within an ulp of the
    Pallas kernel in interpret mode, equal to the XLA mirror run op by op,
    and equal to the f32 result cast."""
    m, k, n = 33, 96, 40
    scale, bias = _scale_bias(n, 31)
    js, jb, ts, tb = (jnp.asarray(scale), jnp.asarray(bias), _t(scale),
                      _t(bias))
    f16 = dict(out_dtype=torch.float16)
    if kernel == "quant_matmul_fa":
        x, w_lv, _, _ = _fa_case(m, k, n, "float32", seed=32)
        q = (0.02, 1.3, 127.0)
        want = np.asarray(j_fa(
            jnp.asarray(x), j_pack(jnp.asarray(w_lv), axis=0), js, jb,
            *(jnp.float32(v) for v in q), out_dtype=jnp.float16,
            interpret=True), np.float32)

        def run(**kw):
            return quant_matmul_fa(_t(x), pack_int4(_t(w_lv)), ts, tb,
                                   *(torch.tensor(v) for v in q), **kw)
        mirror = None
    else:
        lo = -127 if kernel == "int8_matmul" else -7
        x, w = _levels((m, k), 33, lo, -lo + 1), _levels((k, n), 34, lo,
                                                          -lo + 1)
        four = kernel == "int4_matmul"
        jw = j_pack(jnp.asarray(w), axis=0) if four else jnp.asarray(w)
        tw = pack_int4(_t(w)) if four else _t(w)
        jfn, jxla, tfn = ((j_int4, j_int4_xla, int4_matmul) if four
                          else (j_int8, j_int8_xla, int8_matmul))
        want = np.asarray(jfn(jnp.asarray(x), jw, js, jb,
                              out_dtype=jnp.float16, interpret=True),
                          np.float32)
        with jax.disable_jit():
            mirror = np.asarray(jxla(jnp.asarray(x), jw, js, jb,
                                     out_dtype=jnp.float16), np.float32)

        def run(**kw):
            return tfn(_t(x), tw, ts, tb, **kw)
    got = run(**f16)
    assert got.dtype == torch.float16 and got.shape == (m, n)
    _ulp_close(got.float().numpy(), want, bias, "float16")
    if mirror is not None:
        np.testing.assert_array_equal(got.float().numpy(), mirror)
    assert torch.equal(got, run(out_dtype=torch.float32).to(torch.float16))


def _fa_case(m, k, n, x_dtype, seed=11):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, k)).astype(np.float32)
    if x_dtype == "bfloat16":  # values representable in bf16 on both sides
        x = torch.from_numpy(x).to(torch.bfloat16).float().numpy()
    w_lv = _levels((k, n), seed + 1)
    scale = (rng.random(n) * 0.01).astype(np.float32)
    bias = rng.standard_normal(n).astype(np.float32)
    return x, w_lv, scale, bias


@pytest.mark.parametrize("x_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("act_pow", [True, False])
@pytest.mark.parametrize("fmt", ["int4", "int8"])
def test_quant_matmul_fa_matches_jax(fmt, act_pow, x_dtype):
    """The fused activation quantizer: levels equal to ``_fa_quant``'s
    (op by op), outputs within an ulp of the Pallas kernel in interpret
    mode and within the 1e-4 of the numpy quantize-then-matmul of
    tests/ops/test_int4_matmul.py:123-150."""
    m, k, n = 24, 64, 48
    x, w_lv, scale, bias = _fa_case(m, k, n, x_dtype)
    d, t, top = 0.02, (1.3 if act_pow else 1.0), 127.0
    jx = jnp.asarray(x, getattr(jnp, x_dtype))
    tx = _t(x).to(getattr(torch, x_dtype))
    jw = j_pack(jnp.asarray(w_lv), axis=0) if fmt == "int4" else \
        jnp.asarray(w_lv)
    tw = pack_int4(_t(w_lv)) if fmt == "int4" else _t(w_lv)
    out_dtype = "bfloat16" if x_dtype == "bfloat16" else "float32"

    with jax.disable_jit():
        j_lv = np.asarray(j_fa_quant(jx, jnp.float32(d)[None],
                                     jnp.float32(t)[None],
                                     jnp.int32(top)[None], act_pow))
    np.testing.assert_array_equal(
        fa_levels(tx, torch.tensor(d), torch.tensor(t), top, act_pow).numpy(),
        j_lv)

    want = np.asarray(j_fa(jx, jw, jnp.asarray(scale), jnp.asarray(bias),
                           jnp.float32(d), jnp.float32(t), jnp.float32(top),
                           fmt=fmt, act_pow=act_pow,
                           out_dtype=getattr(jnp, out_dtype),
                           interpret=True), np.float32)
    got = quant_matmul_fa(tx, tw, _t(scale), _t(bias), torch.tensor(d),
                          torch.tensor(t), torch.tensor(top), fmt=fmt,
                          act_pow=act_pow,
                          out_dtype=getattr(torch, out_dtype))
    assert got.dtype == getattr(torch, out_dtype) and got.shape == (m, n)
    _ulp_close(got.float().numpy(), want, bias,
               "bfloat16" if out_dtype == "bfloat16" else np.float32)

    p = np.abs(x) ** np.float32(t) if act_pow else np.abs(x)
    x_lv = (np.sign(x) * np.minimum(np.round(p / np.float32(d)),
                                    top)).astype(np.int8)
    ref = (x_lv.astype(np.int64) @ w_lv.astype(np.int64)).astype(
        np.float32) * scale[None, :] + bias
    np.testing.assert_allclose(got.float().numpy(), ref,
                               rtol=1e-2 if out_dtype == "bfloat16" else 1e-5,
                               atol=1e-4)


def test_quant_matmul_fa_ragged_scalar_scale_no_bias():
    """K = 40 (off the 16-byte path), a scalar scale and no bias."""
    m, k, n = 7, 40, 20
    x, w_lv, _, _ = _fa_case(m, k, n, "float32", seed=21)
    jw = j_pack(jnp.asarray(w_lv), axis=0)
    want = np.asarray(j_fa(jnp.asarray(x), jw, jnp.float32(0.01), None,
                           jnp.float32(0.05), jnp.float32(0.9),
                           jnp.int32(15), act_pow=True, interpret=True))
    got = quant_matmul_fa(_t(x), pack_int4(_t(w_lv)), 0.01, None, 0.05, 0.9,
                          15, act_pow=True).numpy()
    _ulp_close(got, want)


def test_full_lsfq_pipeline_through_the_gemms():
    """tests/ops/test_int4_matmul.py:89-120 with the port's quantizers: the
    LSFQ levels through int4_matmul, and the float x through
    quant_matmul_fa (its min(round(p/d), top) is lsfq_levels at q_s = 0),
    both equal to the fake-quant float product within 1e-4."""
    from quantized_vit_tpu_torch.quant import (init_quant_params,
                                               lsfq_levels, lsfq_nonlinear,
                                               lsfq_top_level)

    rng = np.random.default_rng(8)
    x = _t(rng.standard_normal((64, 256)).astype(np.float32) * 0.5)
    w = _t(rng.standard_normal((256, 128)).astype(np.float32) * 0.05)
    d_w, qm_w, t_w = init_quant_params(w, num_bits=4, nonlinear=True)
    d_a, qm_a, t_a = init_quant_params(x, num_bits=4, nonlinear=True)
    clip = torch.tensor([-2.0, 2.0])
    float_out = (lsfq_nonlinear(x, d_a, qm_a, t_a, clip)
                 @ lsfq_nonlinear(w, d_w, qm_w, t_w, clip)).numpy()
    w_packed = pack_int4(lsfq_levels(w, d_w, qm_w, t_w).to(torch.int8))
    x_lv = lsfq_levels(x, d_a, qm_a, t_a).to(torch.int8)
    scale = (d_w * d_a)[0]
    int_out = int4_matmul(x_lv, w_packed, scale).numpy()
    np.testing.assert_allclose(int_out, float_out, rtol=1e-4, atol=1e-4)
    fa_out = quant_matmul_fa(x, w_packed, scale, None, d_a[0], t_a[0],
                             lsfq_top_level(d_a, qm_a, t_a)[0],
                             act_pow=True).numpy()
    np.testing.assert_allclose(fa_out, float_out, rtol=1e-4, atol=1e-4)


def test_errors_are_the_jax_ones():
    """TypeError for non-int8 levels or weights, ValueError for a K
    mismatch (int4_matmul.py:149-154, :244-249, :416-417)."""
    f32 = torch.zeros((4, 8))
    i8 = torch.zeros((4, 8), dtype=torch.int8)
    with pytest.raises(TypeError):
        int4_matmul(f32, torch.zeros((4, 8), dtype=torch.int8), 1.0)
    with pytest.raises(TypeError):
        int8_matmul(i8, torch.zeros((8, 8)), 1.0)
    with pytest.raises(ValueError, match="K mismatch"):
        int4_matmul(i8, torch.zeros((3, 8), dtype=torch.int8), 1.0)
    with pytest.raises(ValueError, match="K mismatch"):
        int8_matmul(i8, torch.zeros((7, 8), dtype=torch.int8), 1.0)
    for fmt, w in (("int4", torch.zeros((3, 8), dtype=torch.int8)),
                   ("int8", torch.zeros((7, 8), dtype=torch.int8))):
        with pytest.raises(ValueError, match="K mismatch"):
            quant_matmul_fa(f32, w, 1.0, None, 0.1, 1.0, 7, fmt=fmt)

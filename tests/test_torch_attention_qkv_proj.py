"""Port parity: K9 ``attention_qkv_proj`` (attention on the raw fused-qkv
tensor, the proj quantizer's levels, the proj GEMM, dequant and residual
in one launch) against the JAX package.

The port runs its plain version through the public wrapper on CPU
tensors; the CUDA kernel is held to it on the card by ``chip_smoke.py``.
The JAX side: ``_attention_qkv_proj`` in Pallas interpret mode, as
tests/ops/test_attention_block.py runs it, within the attention contract
of tests/test_torch_attention.py (outputs within 0.1, more than 1e-5 off
at <= 1% of positions: the port sums the attention dots in f64, the JAX
package in f32, which can split a level at a rounding tie); and the pair
the kernel replaces, ``attention_qkv_xla`` then ``fused_quant_matmul_xla``
with the residual epilogue (bench.py:173-185), bit for bit where
tests/ops/test_attention_block.py:62-75 holds the TPU kernel to it (float
attention, t = 1), run op by op (``jax.disable_jit``). ``int_attention``
runs at head_dim 16, whose power-of-two ``sm_scale`` keeps the Pallas
kernels equal to the XLA mirror that the port follows
(tests/test_torch_attention_qkv.py).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from quantized_vit_tpu.ops import attention_qkv_xla, fused_quant_matmul_xla
from quantized_vit_tpu.ops.attention import _attention_qkv_proj
from quantized_vit_tpu.quant.packing import pack_int4 as jpack
from quantized_vit_tpu_torch.ops import attention_qkv_proj
from quantized_vit_tpu_torch.quant import pack_int4 as tpack

torch.set_num_threads(1)


def _case(b, n, heads, hd, d, seed):
    rng = np.random.default_rng(seed)
    hdim = heads * hd
    return dict(
        qkv=(rng.standard_normal((b, n, 3 * hdim)) * 0.7).astype(np.float32),
        wp=rng.integers(-7, 8, (hdim, d)).astype(np.int8),
        pb=(rng.standard_normal(d) * 0.01).astype(np.float32),
        res=(rng.standard_normal((b, n, d)) * 0.5).astype(np.float32))


def _branch_close(got, want):
    """The attention contract. A position differs by more than 1e-5: the
    jitted JAX kernel contracts its f32 epilogue into multiply-adds, which
    moves an f32 output by an ulp or two (a level flip moves it by
    scale * |w| >= 2e-3)."""
    diff = np.abs(np.asarray(got, np.float32) - np.asarray(want, np.float32))
    assert diff.max() <= 0.1 and (diff > 1e-5).mean() <= 0.01, (
        f"max {diff.max()} at {(diff > 1e-5).mean():.4%}")


# (weights, heads, head_dim, qkv dtype, pow quantizer, int_attention, bias)
CASES = [
    ("int8", 2, 64, "bfloat16", False, False, True),
    ("int4", 2, 64, "bfloat16", False, False, True),
    ("int8", 3, 16, "bfloat16", True, False, True),
    ("int4", 3, 16, "float32", True, False, False),
    ("int8", 3, 16, "bfloat16", False, True, True),
    ("int4", 3, 16, "float32", False, True, True),
    ("int4", 2, 80, "bfloat16", False, False, True),
    ("int8", 2, 80, "float32", True, False, False),
]


@pytest.mark.parametrize("fmt,heads,hd,dtype,pow_,int_attn,bias", CASES)
def test_attention_qkv_proj_matches_pallas_interpret(fmt, heads, hd, dtype,
                                                     pow_, int_attn, bias):
    """Masked keys (n_valid 29 < 32), int8 and packed int4 proj weights,
    t = 1 and t != 1, ``int_attention``, bias and none, bf16 and f32, 3
    heads, head_dim 16, 64 and 80."""
    b, n, d = 2, 32, 48
    c = _case(b, n, heads, hd, d, seed=hd + heads)
    t = 0.93 if pow_ else 1.0
    kw = dict(heads=heads, sm_scale=hd**-0.5, n_valid=29, out_top=31,
              out_pow=pow_, fmt=fmt, int_attention=int_attn)
    jw = jpack(jnp.asarray(c["wp"]), axis=0) if fmt == "int4" else \
        jnp.asarray(c["wp"])
    tw = tpack(torch.from_numpy(c["wp"])) if fmt == "int4" else \
        torch.from_numpy(c["wp"])
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = np.asarray(_attention_qkv_proj(
        jnp.asarray(c["qkv"], jdt), jw, jnp.float32(2e-3),
        jnp.asarray(c["pb"]) if bias else None, jnp.asarray(c["res"], jdt),
        out_d=jnp.float32(0.01), out_t=jnp.float32(t), out_dtype=jdt,
        interpret=True, **kw), np.float32)
    got = attention_qkv_proj(
        torch.from_numpy(c["qkv"]).to(tdt), tw, torch.tensor(2e-3),
        torch.from_numpy(c["pb"]) if bias else None,
        torch.from_numpy(c["res"]).to(tdt), out_d=torch.tensor(0.01),
        out_t=torch.tensor(t), out_dtype=tdt, **kw)
    assert got.dtype == tdt and got.shape == (b, n, d)
    assert torch.isfinite(got.float()).all()
    _branch_close(got.float().numpy(), want)
    # the attention levels are not all clipped to 0: the branch moved
    assert np.abs(want - c["res"]).max() > 0.05


@pytest.mark.parametrize("fmt", ["int8", "int4"])
def test_attention_qkv_proj_equals_the_xla_pair(fmt):
    """The shapes of bench.py's parity preamble (qkv [2, 64, 384] bf16, 2
    heads, n_valid 50, out_top 7, w_proj [128, 256] with bias), float
    attention at t = 1: bit for bit the pair the kernel replaces."""
    b, n, heads, hd, d = 2, 64, 2, 64, 256
    c = _case(b, n, heads, hd, d, seed=3)
    q = dict(out_d=0.06, out_t=1.0, out_top=7)
    jw = jpack(jnp.asarray(c["wp"]), axis=0) if fmt == "int4" else \
        jnp.asarray(c["wp"])
    tw = tpack(torch.from_numpy(c["wp"])) if fmt == "int4" else \
        torch.from_numpy(c["wp"])
    qkv = jnp.asarray(c["qkv"], jnp.bfloat16)
    res = jnp.asarray(c["res"], jnp.bfloat16)
    with jax.disable_jit():
        alv = attention_qkv_xla(qkv, heads=heads, sm_scale=0.18, n_valid=50,
                                out_d=jnp.float32(q["out_d"]),
                                out_t=jnp.float32(q["out_t"]),
                                out_top=q["out_top"])
        want = np.asarray(fused_quant_matmul_xla(
            alv.reshape(b * n, heads * hd), jw, jnp.float32(2e-3),
            jnp.asarray(c["pb"]), fmt=fmt, prologue=None,
            epilogue="residual", residual=res.reshape(b * n, d)),
            np.float32).reshape(b, n, d)
    got = attention_qkv_proj(
        torch.from_numpy(c["qkv"]).to(torch.bfloat16), tw,
        torch.tensor(2e-3), torch.from_numpy(c["pb"]),
        torch.from_numpy(c["res"]).to(torch.bfloat16), heads=heads,
        sm_scale=0.18, n_valid=50, fmt=fmt, out_d=torch.tensor(q["out_d"]),
        out_t=torch.tensor(q["out_t"]), out_top=q["out_top"])
    np.testing.assert_array_equal(got.float().numpy(), want)


def test_attention_qkv_proj_guards():
    """A missing or zero out_top raises (attention.py:695-704), as do a
    residual of the wrong shape and a qkv width that does not fit the
    proj weight."""
    qkv = torch.zeros((1, 8, 48))
    w = torch.zeros((16, 24), dtype=torch.int8)
    res = torch.zeros((1, 8, 24))
    kw = dict(heads=2, sm_scale=0.25, out_d=torch.tensor(0.1))
    for top in (None, 0):
        with pytest.raises(ValueError, match="out_top"):
            attention_qkv_proj(qkv, w, 1.0, None, res, out_top=top, **kw)
    with pytest.raises(ValueError, match="residual"):
        attention_qkv_proj(qkv, w, 1.0, None, torch.zeros((1, 8, 16)),
                           out_top=7, **kw)
    with pytest.raises(ValueError, match="w_proj"):
        attention_qkv_proj(qkv, torch.zeros((24, 24), dtype=torch.int8),
                           1.0, None, res, out_top=7, **kw)

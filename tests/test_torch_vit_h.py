"""Port parity at ViT-H/14's widths: the serving forward and the attention
kernels' plain versions at head_dim 80, against the JAX package.

ViT-H/14 (Dosovitskiy et al. 2021, Table 1): D 1280, 16 heads of 80, MLP
5120, patch 14 at 224 px, 257 tokens padded to 272. The forward runs at
depth 2 (every block has the same shapes; depth only repeats them) with
int8-stored levels, the configuration the ViT-H serving path takes. The
JAX side is its XLA path (``use_pallas=False``); the port runs its plain
PyTorch versions (CPU tensors), which K8, K3 and K6 are held to on the
card. Tolerances are those of tests/test_torch_vit_int4.py (logits within
1e-4) and tests/test_torch_attention*.py (branch outputs within 0.1 at
<= 1% of positions, int8 levels within 1 level at <= 0.5%): the port sums
LayerNorm statistics and attention dots in f64, the JAX package in f32,
which can split a level at a rounding tie.

The JAX forward runs op by op (``jax.disable_jit``): jitted, XLA
contracts multiply-adds in its f32 glue, and at ViT-H's widths (2.4 M
rounded levels per block and image) that splits enough ties to move the
logits by up to 0.26 (a CPU run at depth 2); op by op the two agree to
the bit. With ``int_attention`` at head_dim 80 the reference is the JAX
package's XLA mirror: its Pallas kernels round ``q * sm_scale`` to the
qkv dtype where the mirror, which the port follows, keeps it in f32
(tests/test_torch_attention_qkv.py), and 80**-0.5 is not a power of two.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from quantized_vit_tpu.models.vit import ViTConfig as JConfig
from quantized_vit_tpu.ops import attention as ja
from quantized_vit_tpu.ops import fused as jf
from quantized_vit_tpu.serve import random_vit_int4_artifact as j_random
from quantized_vit_tpu.serve import vit_int4_forward as j_forward
from quantized_vit_tpu_torch.models import ViTConfig
from quantized_vit_tpu_torch.ops import attention as ta
from quantized_vit_tpu_torch.serve import (artifact_from_numpy,
                                           vit_int4_forward)

torch.set_num_threads(1)

VIT_H = dict(patch_size=14, embed_dim=1280, depth=2, num_heads=16,
             num_classes=1000)


@pytest.fixture(scope="module")
def vit_h_pair():
    jart = j_random(JConfig(**VIT_H), seed=0, pack_weights=False)
    return jart, artifact_from_numpy(jax.tree.map(np.asarray, jart),
                                     device="cpu")


@pytest.mark.parametrize("batch", [1, 2, 4])
def test_vit_h_forward_matches_jax(vit_h_pair, batch):
    jart, art = vit_h_pair
    cfg = ViTConfig(**VIT_H)
    assert (cfg.embed_dim // cfg.num_heads, cfg.num_tokens) == (80, 257)
    x = np.random.default_rng(batch).standard_normal(
        (batch, cfg.num_patches, 14 * 14 * 3)).astype(np.float32)
    with jax.disable_jit():
        want = np.asarray(j_forward(jart, jnp.asarray(x), JConfig(**VIT_H),
                                    use_pallas=False,
                                    float_dtype=jnp.float32,
                                    images_layout="patches"))
    got = vit_int4_forward(art, torch.from_numpy(x), cfg,
                           float_dtype=torch.float32, images_layout="patches")
    assert got.shape == (batch, 1000) and torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


def _levels_close(got, want, frac=0.005):
    d = np.abs(np.asarray(got, np.int32) - np.asarray(want, np.int32))
    assert d.max(initial=0) <= 1 and (d > 0).mean() <= frac, (
        f"level diff max {d.max()} at {(d > 0).mean():.4%}")


def _branch_close(got, want):
    d = np.abs(np.asarray(got, np.float32) - np.asarray(want, np.float32))
    assert d.max(initial=0) <= 0.1 and (d > 0).mean() <= 0.01, (
        d.max(), (d > 0).mean())


@pytest.mark.parametrize("int_attention", [False, True],
                         ids=["float_attn", "int_attn"])
def test_attention_block_head_dim_80_matches_jax(int_attention):
    """K3's plain version (the attention branch with its proj) at
    head_dim 80, 2 heads, 40 tokens with 33 real: against the JAX chain it
    replaces (qkv matmul -> ``attention_qkv_xla`` -> proj + residual) and,
    with float attention, ``_attention_block`` in interpret mode."""
    rng = np.random.default_rng(11)
    b, n, heads, hd, nv = 2, 40, 2, 80, 33
    d = heads * hd
    x = (rng.standard_normal((b, n, d)) * 0.2).astype(np.float32)
    wq = rng.integers(-7, 8, (d, 3 * d)).astype(np.int8)
    wp = rng.integers(-7, 8, (d, d)).astype(np.int8)
    qb = (rng.standard_normal(3 * d) * 0.01).astype(np.float32)
    pb = (rng.standard_normal(d) * 0.01).astype(np.float32)
    g = (rng.standard_normal(d) * 0.1 + 1.0).astype(np.float32)
    be = (rng.standard_normal(d) * 0.01).astype(np.float32)
    q = dict(act_top=127, act_pow=False, out_top=31, out_pow=False)
    xj = jnp.asarray(x, jnp.bfloat16)
    x2 = xj.reshape(b * n, d)
    qkv = jf.fused_quant_matmul_xla(
        x2, jnp.asarray(wq), jnp.float32(1e-3), jnp.asarray(qb), fmt="int8",
        prologue="ln_quant", act_d=jnp.float32(0.05), act_t=jnp.float32(1.0),
        act_top=127, ln_scale=jnp.asarray(g), ln_bias=jnp.asarray(be),
        out_dtype=jnp.bfloat16)
    alv = ja.attention_qkv_xla(
        qkv.reshape(b, n, 3 * d), heads=heads, sm_scale=hd**-0.5,
        n_valid=nv, out_d=jnp.float32(0.06), out_t=jnp.float32(1.0),
        out_top=31, int_attention=int_attention)
    chain = np.asarray(jf.fused_quant_matmul_xla(
        alv.reshape(-1, d), jnp.asarray(wp), jnp.float32(2e-3),
        jnp.asarray(pb), fmt="int8", prologue=None, epilogue="residual",
        residual=x2), np.float32).reshape(b, n, d)
    got = ta.attention_block_plain(
        torch.from_numpy(x).to(torch.bfloat16), torch.from_numpy(wq),
        torch.tensor(1e-3), torch.from_numpy(qb), torch.from_numpy(wp),
        torch.tensor(2e-3), torch.from_numpy(pb), ln_scale=torch.from_numpy(g),
        ln_bias=torch.from_numpy(be), heads=heads, sm_scale=hd**-0.5,
        n_valid=nv, act_d=torch.tensor(0.05), act_t=torch.tensor(1.0),
        out_d=torch.tensor(0.06), out_t=torch.tensor(1.0), fmt="int8",
        out_dtype=torch.bfloat16, int_attention=int_attention,
        **q).float().numpy()
    _branch_close(got, chain)
    if not int_attention:
        _branch_close(got, np.asarray(ja._attention_block(
            xj, jnp.asarray(wq), jnp.float32(1e-3), jnp.asarray(qb),
            jnp.asarray(wp), jnp.float32(2e-3), jnp.asarray(pb),
            ln_scale=jnp.asarray(g), ln_bias=jnp.asarray(be), heads=heads,
            sm_scale=hd**-0.5, n_valid=nv, act_d=jnp.float32(0.05),
            act_t=jnp.float32(1.0), out_d=jnp.float32(0.06),
            out_t=jnp.float32(1.0), fmt="int8", interpret=True, **q),
            np.float32))


@pytest.mark.parametrize("quant", [None, "lin", "pow"])
@pytest.mark.parametrize("int_attention", [False, True],
                         ids=["float_attn", "int_attn"])
def test_attention_qkv_head_dim_80_matches_jax(int_attention, quant):
    """K6's plain version at head_dim 80, 2 heads, 40 tokens with 33 real,
    bf16 qkv: float out, or the proj quantizer's levels with t = 1 and
    t != 1. Against ``attention_qkv`` in interpret mode, or with
    int_attention its XLA mirror."""
    rng = np.random.default_rng(12)
    b, n, heads, hd = 2, 40, 2, 80
    qkv = (rng.standard_normal((b, n, 3 * heads * hd)) * 0.7).astype(
        np.float32)
    kw = dict(heads=heads, sm_scale=hd**-0.5, n_valid=33,
              int_attention=int_attention)
    qj, qt = {}, {}
    if quant:
        t = 0.93 if quant == "pow" else 1.0
        qj = dict(out_d=jnp.float32(0.01), out_t=jnp.float32(t), out_top=31,
                  out_pow=quant == "pow")
        qt = dict(out_d=torch.tensor(0.01), out_t=torch.tensor(t),
                  out_top=31, out_pow=quant == "pow")
    jin = jnp.asarray(qkv, jnp.bfloat16)
    want = np.asarray(
        ja.attention_qkv_xla(jin, out_dtype=jnp.float32, **kw, **qj)
        if int_attention else
        ja.attention_qkv(jin, out_dtype=jnp.float32, interpret=True, **kw,
                         **qj))
    got = ta.attention_qkv(torch.from_numpy(qkv).to(torch.bfloat16),
                           out_dtype=torch.float32, **kw, **qt).numpy()
    assert got.shape == want.shape == (b, n, heads * hd)
    if quant:
        _levels_close(got, want)
        assert np.abs(got).max() > 1
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)

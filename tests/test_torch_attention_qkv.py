"""Port parity: K6 ``attention_qkv`` (the batch 1-3 chain's attention) and
the chain route against the JAX package.

The JAX side runs as tests/ops/test_fused.py:160-208 runs it on the CPU:
``attention_qkv`` in Pallas interpret mode. The port runs its plain
version (CPU tensors, through the public wrapper). Tolerances as in
tests/test_torch_attention.py: int8 levels within 1 level at <= 0.5% of
positions, float outputs to 1e-5 (the port sums the attention dots in f64,
the JAX package in f32). The whole forward at batch 1-3 against the JAX
chain (``use_pallas=False``) within 1e-4; ``int_attention`` through the
plain path against the JAX package at a chain batch and a block batch.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from quantized_vit_tpu.models.vit import ViTConfig as JConfig
from quantized_vit_tpu.ops import attention as ja
from quantized_vit_tpu.quant.packing import pack_int4 as jpack
from quantized_vit_tpu.serve import random_vit_int4_artifact as j_random
from quantized_vit_tpu.serve import vit_int4_forward as j_forward
from quantized_vit_tpu_torch.models import ViTConfig
from quantized_vit_tpu_torch.ops import attention as ta
from quantized_vit_tpu_torch.quant import pack_int4 as tpack
from quantized_vit_tpu_torch.serve import (artifact_from_numpy, uses_chain,
                                           vit_int4_forward)
from quantized_vit_tpu_torch.utils import patchify_batch

torch.set_num_threads(1)

SMALL = dict(img_size=32, patch_size=16, embed_dim=64, depth=2, num_heads=4,
             num_classes=10)


def _levels_close(got, want, frac=0.005):
    d = np.abs(np.asarray(got, np.int32) - np.asarray(want, np.int32))
    assert d.max(initial=0) <= 1 and (d > 0).mean() <= frac, (
        f"level diff max {d.max()} at {(d > 0).mean():.4%}")


@pytest.mark.parametrize("quant", [None, "lin", "pow"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("int_attention", [False, True],
                         ids=["float_attn", "int_attn"])
def test_attention_qkv_matches_pallas_interpret(int_attention, dtype, quant):
    """3 heads, masked keys (n_valid 27 < 32), both qkv dtypes, float out or
    the proj quantizer's levels with t = 1 and t != 1."""
    rng = np.random.default_rng(7)
    b, n, heads, hd = 2, 32, 3, 16
    qkv = (rng.standard_normal((b, n, 3 * heads * hd)) * 0.7).astype(
        np.float32)
    kw = dict(heads=heads, sm_scale=hd**-0.5, n_valid=27,
              int_attention=int_attention)
    qj, qt = {}, {}
    if quant:
        t = 0.93 if quant == "pow" else 1.0
        qj = dict(out_d=jnp.float32(0.01), out_t=jnp.float32(t), out_top=31,
                  out_pow=quant == "pow")
        qt = dict(out_d=torch.tensor(0.01), out_t=torch.tensor(t),
                  out_top=31, out_pow=quant == "pow")
    want = np.asarray(ja.attention_qkv(
        jnp.asarray(qkv, getattr(jnp, dtype)), out_dtype=jnp.float32,
        interpret=True, **kw, **qj))
    got = ta.attention_qkv(torch.from_numpy(qkv).to(getattr(torch, dtype)),
                           out_dtype=torch.float32, **kw, **qt).numpy()
    assert got.shape == want.shape == (b, n, heads * hd)
    if quant:
        assert got.dtype == np.int8
        _levels_close(got, want)
        assert np.abs(got).max() > 1  # the levels are not all clipped to 0
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("batch", [1, 2, 3, 4, 5])
def test_route_gate_mirrors_jax(batch):
    """The JAX gate (vit_int4.py:272): batch >= 4 takes attention_block,
    a smaller batch the chain with attention_qkv."""
    assert uses_chain(batch) == (not batch >= 4)


def _pair(cfg_kw, seed=0, pack=True):
    jart = j_random(JConfig(**cfg_kw), seed=seed, pack_weights=pack)
    art = artifact_from_numpy(jax.tree.map(np.asarray, jart), device="cpu")
    return jart, art


def _patches(cfg_kw, b, seed):
    s = cfg_kw["img_size"]
    x = np.random.default_rng(seed).standard_normal(
        (b, s, s, 3)).astype(np.float32)
    return patchify_batch(x, cfg_kw["patch_size"])


@pytest.mark.parametrize("batch", [1, 2, 3])
def test_chain_batches_match_jax(batch):
    """The forward at the chain's batch sizes, bf16 residual stream (the
    serving setting), against the JAX chain."""
    jart, art = _pair(SMALL, seed=batch)
    x = _patches(SMALL, batch, seed=10 + batch)
    want = np.asarray(j_forward(jart, jnp.asarray(x), JConfig(**SMALL),
                                use_pallas=False, float_dtype=jnp.bfloat16,
                                images_layout="patches"))
    got = vit_int4_forward(art, torch.from_numpy(x), ViTConfig(**SMALL),
                           float_dtype=torch.bfloat16,
                           images_layout="patches")
    assert got.shape == (batch, 10)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("batch", [2, 4])
def test_int_attention_forward_matches_jax(batch):
    """``int_attention`` through the plain path, at a chain batch (2) and a
    block batch (4): the kernels run it on both routes on the card."""
    jart, art = _pair(SMALL, seed=20)
    x = _patches(SMALL, batch, seed=21)
    want = np.asarray(j_forward(jart, jnp.asarray(x), JConfig(**SMALL),
                                use_pallas=False, int_attention=True,
                                images_layout="patches"))
    got = vit_int4_forward(art, torch.from_numpy(x), ViTConfig(**SMALL),
                           int_attention=True, images_layout="patches")
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


def test_attention_block_int_attention_matches_pallas():
    """K3's plain version with int_attention against the JAX
    ``_attention_block`` in interpret mode (int8 score and AV products).
    head_dim 16: the JAX kernels scale q by sm_scale in the qkv dtype
    (attention.py:170) where its XLA mirror, which the port follows, does it
    in f32 (:906); with a power-of-two sm_scale (head_dim 16 or 64, as at
    ViT-B) the two agree."""
    rng = np.random.default_rng(4)
    b, n, heads, hd = 2, 32, 3, 16
    d = heads * hd
    x = (rng.standard_normal((b, n, d)) * 0.2).astype(np.float32)
    wq = rng.integers(-7, 8, (d, 3 * d)).astype(np.int8)
    wp = rng.integers(-7, 8, (d, d)).astype(np.int8)
    qb = (rng.standard_normal(3 * d) * 0.01).astype(np.float32)
    pb = (rng.standard_normal(d) * 0.01).astype(np.float32)
    g = (rng.standard_normal(d) * 0.1 + 1.0).astype(np.float32)
    be = (rng.standard_normal(d) * 0.01).astype(np.float32)
    q = dict(act_top=127, act_pow=False, out_top=31, out_pow=False)
    want = np.asarray(ja._attention_block(
        jnp.asarray(x, jnp.bfloat16), jpack(jnp.asarray(wq), axis=0),
        jnp.float32(1e-3), jnp.asarray(qb), jpack(jnp.asarray(wp), axis=0),
        jnp.float32(2e-3), jnp.asarray(pb), ln_scale=jnp.asarray(g),
        ln_bias=jnp.asarray(be), heads=heads, sm_scale=hd**-0.5, n_valid=29,
        act_d=jnp.float32(0.05), act_t=jnp.float32(1.0),
        out_d=jnp.float32(0.06), out_t=jnp.float32(1.0), fmt="int4",
        int_attention=True, interpret=True, **q), np.float32)
    got = ta.attention_block(
        torch.from_numpy(x).to(torch.bfloat16), tpack(torch.from_numpy(wq)),
        torch.tensor(1e-3), torch.from_numpy(qb), tpack(torch.from_numpy(wp)),
        torch.tensor(2e-3), torch.from_numpy(pb), ln_scale=torch.from_numpy(g),
        ln_bias=torch.from_numpy(be), heads=heads, sm_scale=hd**-0.5,
        n_valid=29, act_d=torch.tensor(0.05), act_t=torch.tensor(1.0),
        out_d=torch.tensor(0.06), out_t=torch.tensor(1.0), fmt="int4",
        int_attention=True, **q).float().numpy()
    d_ = np.abs(got - want)
    assert d_.max() <= 0.1 and (d_ > 0).mean() <= 0.01


def test_attention_qkv_guards():
    """A missing top with out_d raises (attention.py:802-808), as does a
    qkv width that does not split into the heads."""
    qkv = torch.zeros((1, 8, 48))
    with pytest.raises(ValueError, match="out_top"):
        ta.attention_qkv(qkv, heads=2, sm_scale=0.25,
                         out_d=torch.tensor(0.1))
    with pytest.raises(ValueError, match="split into"):
        ta.attention_qkv(torch.zeros((1, 8, 50)), heads=2, sm_scale=0.25)

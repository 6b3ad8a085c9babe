"""Port parity: the whole serving slice (``vit_int4_forward``) against the
JAX package's ``vit_int4_forward`` on the same artifact and images.

The JAX side runs its XLA path (``use_pallas=False``, the chain of
fused_quant_matmul_xla / attention_qkv_xla) and, in one case, its Pallas
path in interpret mode at batch 4, where it routes through
``attention_block`` and ``fused_mlp``. The port runs its plain PyTorch
versions (CPU tensors). Tolerance: logits within 1e-4, the bar of
tests/serve/test_vit_int4.py:72. Both sides do the same integer math; the
f32 glue rounds in another order (the port sums LayerNorm statistics and
attention dots in f64, the JAX package in f32, and XLA contracts
multiply-adds), which could split a level at a rounding tie. None of
these seeded inputs lands on one.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from quantized_vit_tpu.models.vit import ViTConfig as JConfig
from quantized_vit_tpu.serve import random_vit_int4_artifact as j_random
from quantized_vit_tpu.serve import vit_int4_forward as j_forward
from quantized_vit_tpu.serve.vit_int4 import QLayerArtifact as JQLayer
from quantized_vit_tpu.quant.packing import unpack_int4 as junpack
from quantized_vit_tpu_torch.models import ViTConfig
from quantized_vit_tpu_torch.serve import (artifact_from_numpy,
                                           vit_int4_forward)
from quantized_vit_tpu_torch.utils import patchify_batch

torch.set_num_threads(1)

SMALL = dict(img_size=32, patch_size=16, embed_dim=64, depth=2, num_heads=4,
             num_classes=10)


def _pair(cfg_kw, seed=0, pack=True):
    jart = j_random(JConfig(**cfg_kw), seed=seed, pack_weights=pack)
    art = artifact_from_numpy(jax.tree.map(np.asarray, jart), device="cpu")
    return jart, art


def _images(cfg_kw, b, seed=1):
    s = cfg_kw["img_size"]
    return np.random.default_rng(seed).standard_normal(
        (b, s, s, 3)).astype(np.float32)


@pytest.mark.parametrize("pack", [True, False], ids=["int4", "int8"])
@pytest.mark.parametrize("layout", ["nhwc", "patches"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_matches_jax_xla(dtype, layout, pack):
    jart, art = _pair(SMALL, pack=pack)
    x = _images(SMALL, 2)
    if layout == "patches":
        x = patchify_batch(x, 16)
    want = np.asarray(j_forward(jart, jnp.asarray(x), JConfig(**SMALL),
                                use_pallas=False,
                                float_dtype=getattr(jnp, dtype),
                                images_layout=layout))
    got = vit_int4_forward(art, torch.from_numpy(x), ViTConfig(**SMALL),
                           float_dtype=getattr(torch, dtype),
                           images_layout=layout)
    assert got.dtype == torch.float32 and got.shape == (2, 10)
    # bf16: the residual stream rounds to bf16 on both sides at the same
    # places; the same 1e-4 holds unless a level flips
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


def test_layouts_agree():
    """nhwc (on-device patchify, K1 raw accumulators, scale in K4) equals
    the host-patchified path within test_vit_int4.py:174-186's 2e-4."""
    _, art = _pair(SMALL)
    x = _images(SMALL, 3, seed=4)
    a = vit_int4_forward(art, torch.from_numpy(x), ViTConfig(**SMALL))
    b = vit_int4_forward(art, torch.from_numpy(patchify_batch(x, 16)),
                         ViTConfig(**SMALL), images_layout="patches")
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-4, atol=2e-4)


def test_input_scale_uint8_matches_jax():
    jart, art = _pair(SMALL, seed=2)
    img = np.random.default_rng(3).integers(0, 256, (2, 32, 32, 3)).astype(
        np.uint8)
    xp = patchify_batch(img.astype(np.float32), 16).astype(np.uint8)
    want = np.asarray(j_forward(jart, jnp.asarray(xp), JConfig(**SMALL),
                                use_pallas=False, images_layout="patches",
                                input_scale=1.0 / 255.0))
    got = vit_int4_forward(art, torch.from_numpy(xp), ViTConfig(**SMALL),
                           images_layout="patches", input_scale=1.0 / 255.0)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


def _to_int8(q: JQLayer) -> JQLayer:
    return JQLayer(w=junpack(q.w, axis=0), scale=q.scale, bias=q.bias,
                   act=q.act, fmt="int8", act_pow=q.act_pow, top=q.top)


def test_mixed_format_artifact_matches_jax():
    """A GETA mixed-precision export: per-layer formats differ inside a
    block (qkv/fc1 int8, proj/fc2 packed int4), and one layer has a pow
    quantizer (t != 1)."""
    jart = j_random(JConfig(**SMALL), seed=5, pack_weights=True)
    blk = jart["blocks"][0]
    blk["qkv"] = _to_int8(blk["qkv"])
    blk["fc1"] = _to_int8(blk["fc1"])
    p = blk["proj"]
    blk["proj"] = JQLayer(w=p.w, scale=p.scale, bias=p.bias,
                          act={**p.act, "t": jnp.float32(0.9)}, fmt="int4",
                          act_pow=True, top=p.top)
    art = artifact_from_numpy(jax.tree.map(np.asarray, jart), device="cpu")
    assert art["blocks"][0]["qkv"].fmt == "int8"
    assert art["blocks"][0]["proj"].fmt == "int4"
    x = _images(SMALL, 2, seed=6)
    want = np.asarray(j_forward(jart, jnp.asarray(x), JConfig(**SMALL),
                                use_pallas=False))
    got = vit_int4_forward(art, torch.from_numpy(x), ViTConfig(**SMALL))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


def test_forward_matches_jax_pallas_interpret_block_kernels():
    """batch 4, embed_dim 256: the JAX forward routes through
    attention_block and fused_mlp (vit_int4.py:272, :326), run here in
    Pallas interpret mode. bf16 residual stream, the serving setting."""
    from jax.experimental.pallas import tpu as pltpu

    cfg_kw = dict(SMALL, embed_dim=256, depth=1, num_heads=4)
    jart, art = _pair(cfg_kw, seed=7)
    x = patchify_batch(_images(cfg_kw, 4, seed=8), 16)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(j_forward(jart, jnp.asarray(x), JConfig(**cfg_kw),
                                    use_pallas=True,
                                    float_dtype=jnp.bfloat16,
                                    images_layout="patches"))
    got = vit_int4_forward(art, torch.from_numpy(x), ViTConfig(**cfg_kw),
                           float_dtype=torch.bfloat16,
                           images_layout="patches")
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


def test_vit_b_width_depth2_batch2_matches_jax():
    """ViT-B/16 widths (768, 12 heads, 224 px, 1000 classes) at depth 2 and
    batch 2, f32, int8-stored weights (bench.py's artifact): the same 1e-4
    bar."""
    cfg_kw = dict(depth=2)
    jart, art = _pair(cfg_kw, seed=0, pack=False)
    x = patchify_batch(_images(dict(img_size=224), 2, seed=9), 16)
    want = np.asarray(j_forward(jart, jnp.asarray(x), JConfig(**cfg_kw),
                                use_pallas=False, images_layout="patches"))
    got = vit_int4_forward(art, torch.from_numpy(x), ViTConfig(**cfg_kw),
                           images_layout="patches").numpy()
    assert got.shape == (2, 1000) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)

"""Port parity: the batch-1 latency entry (``prepare_latency_artifact``,
``vit_int4_forward_latency``) and the block stack K5 replaces
(``vit_block_stack``) against the JAX package.

The JAX side runs as its own tests do on the CPU
(tests/ops/test_block_stack.py): the megakernel in Pallas interpret mode,
the config img 32, patch 16, D 64, depth 3, heads 2. The port runs its
plain versions (CPU tensors). Logits within 1e-4, the bar of
tests/test_torch_vit_int4.py; the port's latency forward equals its own
chain forward bit for bit, as the JAX bench demands of its megakernel
(bench.py:359-367).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from quantized_vit_tpu.models.vit import ViTConfig as JConfig
from quantized_vit_tpu.ops.block_stack import vit_block_stack as j_stack
from quantized_vit_tpu.serve import prepare_latency_artifact as j_prepare
from quantized_vit_tpu.serve import random_vit_int4_artifact as j_random
from quantized_vit_tpu.serve import vit_int4_forward as j_forward
from quantized_vit_tpu.serve import vit_int4_forward_latency as j_latency
from quantized_vit_tpu_torch.models import ViTConfig
from quantized_vit_tpu_torch.ops import (block_stack as tb,
                                         vit_block_stack,
                                         vit_block_stack_plain)
from quantized_vit_tpu_torch.serve import (StackMeta, artifact_from_numpy,
                                           kernel_limits,
                                           prepare_latency_artifact,
                                           random_vit_int4_artifact,
                                           vit_int4_forward,
                                           vit_int4_forward_latency)
from quantized_vit_tpu_torch.utils import patchify_batch

torch.set_num_threads(1)

SMALL = dict(img_size=32, patch_size=16, embed_dim=64, depth=3,
             num_heads=2, num_classes=10)
_STACK = ("wq", "qs", "qb", "l1g", "l1b", "wp", "ps", "pb", "l2g", "l2b",
          "w1", "s1", "b1", "w2", "s2", "b2", "act_d", "act_t", "out_d",
          "out_t", "mlp_d", "mlp_t", "hid_d", "hid_t")


def _pair(cfg_kw, seed=0, pack=True):
    jart = j_random(JConfig(**cfg_kw), seed=seed, pack_weights=pack)
    art = artifact_from_numpy(jax.tree.map(np.asarray, jart), device="cpu")
    return jart, art


def _image(cfg_kw, seed=1):
    s = cfg_kw.get("img_size", 224)
    return np.random.default_rng(seed).standard_normal(
        (1, s, s, 3)).astype(np.float32)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("pack", [True, False], ids=["int4", "int8"])
def test_latency_forward_matches_jax_megakernel(pack, dtype):
    jart, art = _pair(SMALL, seed=0, pack=pack)
    x = _image(SMALL)
    jlat, jmeta = j_prepare(jart, JConfig(**SMALL))
    want = np.asarray(j_latency(jlat, jnp.asarray(x), JConfig(**SMALL),
                                jmeta, float_dtype=getattr(jnp, dtype),
                                images_layout="nhwc", interpret=True))
    lat, meta = prepare_latency_artifact(art, ViTConfig(**SMALL))
    assert tuple(meta) == tuple(jmeta)
    got = vit_int4_forward_latency(lat, torch.from_numpy(x),
                                   ViTConfig(**SMALL), meta,
                                   float_dtype=getattr(torch, dtype),
                                   images_layout="nhwc")
    assert got.shape == (1, 10) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("pack", [True, False], ids=["int4", "int8"])
def test_latency_forward_equals_chain_forward(pack, dtype):
    """The stacked, folded operands give the chain's logits exactly."""
    cfg = ViTConfig(**SMALL)
    art = random_vit_int4_artifact(cfg, seed=3, pack_weights=pack,
                                   device="cpu")
    x = torch.from_numpy(patchify_batch(_image(SMALL, seed=4), 16))
    kw = dict(float_dtype=getattr(torch, dtype), images_layout="patches")
    lat, meta = prepare_latency_artifact(art, cfg)
    got = vit_int4_forward_latency(lat, x, cfg, meta, **kw)
    want = vit_int4_forward(art, x, cfg, **kw)
    assert torch.equal(got, want)


@pytest.mark.parametrize("j_imgs", [1, 2])
def test_block_stack_matches_jax_kernel(j_imgs):
    """The port's ``vit_block_stack`` (plain on the CPU) against the JAX
    megakernel in interpret mode, on the JAX latency artifact's stacked
    operands (tests/ops/test_block_stack.py:77-113)."""
    cfg = JConfig(**SMALL)
    jlat, jmeta = j_prepare(j_random(cfg, seed=2, pack_weights=True), cfg)
    st = jlat["stack"]
    n_pad = 32
    x = (np.random.default_rng(2).standard_normal((j_imgs * n_pad, 64))
         * 0.2).astype(np.float32)
    kw = dict(heads=jmeta.heads, sm_scale=32**-0.5, n_valid=cfg.num_tokens,
              fmt=jmeta.fmt, act_pow=jmeta.act_pow, out_pow=jmeta.out_pow,
              mlp_pow=jmeta.mlp_pow, hid_pow=jmeta.hid_pow,
              act_top=jmeta.act_top, out_top=jmeta.out_top,
              mlp_top=jmeta.mlp_top, hid_top=jmeta.hid_top, j_imgs=j_imgs)
    want = np.asarray(j_stack(jnp.asarray(x, jnp.bfloat16),
                              *(st[k] for k in _STACK),
                              out_dtype=jnp.bfloat16, interpret=True, **kw),
                      np.float32)
    got = vit_block_stack(torch.from_numpy(x).to(torch.bfloat16),
                          *(torch.from_numpy(np.array(st[k]))
                            for k in _STACK), out_dtype=torch.bfloat16, **kw)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=1e-4,
                               atol=1e-4)


def test_block_stack_two_images_equal_two_single_calls():
    """j_imgs = 2 equals two j_imgs = 1 calls exactly: the attention of
    one image never reads the other's rows."""
    cfg = ViTConfig(**SMALL)
    art = random_vit_int4_artifact(cfg, seed=5, device="cpu")
    plan = prepare_latency_artifact(art, cfg)[0]["stack"]
    x = (torch.randn((64, 64), generator=torch.Generator().manual_seed(0))
         * 0.3).to(torch.bfloat16)
    two = vit_block_stack_plain(plan, x, n_valid=5, j_imgs=2)
    one = torch.cat([vit_block_stack_plain(plan, x[:32], n_valid=5),
                     vit_block_stack_plain(plan, x[32:], n_valid=5)])
    assert torch.equal(two, one)
    assert torch.isfinite(two.float()).all() and not torch.equal(two, x)


def test_vit_b_width_latency_matches_jax_at_208_and_224_tokens():
    """ViT-B/16 widths (768, 12 heads, 224 px, 1000 classes) at depth 1,
    batch 1: the port's latency forward (208 token rows) against the JAX
    chain at 208 rows and at the 224 rows of the JAX latency entry."""
    cfg_kw = dict(depth=1)
    jart, art = _pair(cfg_kw, seed=0, pack=True)
    x = patchify_batch(_image(cfg_kw, seed=9), 16)
    lat, meta = prepare_latency_artifact(art, ViTConfig(**cfg_kw))
    got = vit_int4_forward_latency(lat, torch.from_numpy(x),
                                   ViTConfig(**cfg_kw), meta).numpy()
    assert got.shape == (1, 1000) and np.isfinite(got).all()
    for n_align in (16, 32):
        want = np.asarray(j_forward(jart, jnp.asarray(x), JConfig(**cfg_kw),
                                    use_pallas=False,
                                    float_dtype=jnp.bfloat16,
                                    images_layout="patches",
                                    n_align=n_align))
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def _mixed_top(art):
    art["blocks"][1] = dict(art["blocks"][1], qkv=dataclasses.replace(
        art["blocks"][1]["qkv"], top=31))


def _mixed_fmt(art):
    from quantized_vit_tpu_torch.quant.packing import unpack_int4

    for blk in art["blocks"]:
        p = blk["proj"]
        blk["proj"] = dataclasses.replace(p, w=unpack_int4(p.w), fmt="int8")


@pytest.mark.parametrize("case", ["batch", "uniform", "mixed"])
def test_latency_refusals(case):
    """The JAX function's refusals, in its words (vit_int4.py:561-568,
    :664-670)."""
    cfg = ViTConfig(**SMALL)
    art = random_vit_int4_artifact(cfg, seed=0, device="cpu")
    if case == "batch":
        lat, meta = prepare_latency_artifact(art, cfg)
        with pytest.raises(ValueError, match="batch-1"):
            vit_int4_forward_latency(lat, torch.zeros((2, 32, 32, 3)), cfg,
                                     meta, images_layout="nhwc")
        return
    (_mixed_top if case == "uniform" else _mixed_fmt)(art)
    with pytest.raises(ValueError, match="uniform" if case == "uniform"
                       else "mixed weight formats"):
        prepare_latency_artifact(art, cfg)


def test_block_stack_guards_and_limits():
    """Positive static tops; K5's own limits: ViT-B/16 at 224 and 384 px
    and ViT-H/14 (head_dim 80) fit; head_dim 96 and widths off 16 bytes
    do not."""
    cfg = ViTConfig(**SMALL)
    art = random_vit_int4_artifact(cfg, seed=0, device="cpu")
    assert isinstance(prepare_latency_artifact(art, cfg)[1], StackMeta)
    with pytest.raises(ValueError, match="positive hid_top"):
        tb._tops(dict(act_top=7, out_top=7, mlp_top=7, hid_top=0))
    assert kernel_limits(ViTConfig(), latency=True) == []
    assert kernel_limits(ViTConfig(img_size=384), latency=True) == []
    vit_h = ViTConfig(patch_size=14, embed_dim=1280, depth=1, num_heads=16)
    assert kernel_limits(vit_h, latency=True) == []
    wide_head = ViTConfig(embed_dim=768, depth=1, num_heads=8)
    assert any("head_dim 96" in s for s in kernel_limits(wide_head,
                                                         latency=True))
    odd = ViTConfig(embed_dim=72, depth=1, num_heads=3)
    assert any("multiples of 16" in s for s in kernel_limits(odd,
                                                             latency=True))


def test_vit_b_384px_latency_matches_jax_at_592_and_608_tokens():
    """The 384-px ViT-B/16 latency entry in bf16 (577 tokens, 592 rows;
    the first K5 refused its 592 key rows) at depth 1: against the JAX
    chain at 592 rows and at the 608 rows of the JAX latency entry, and
    equal to the port's own chain forward bit for bit."""
    cfg_kw = dict(img_size=384, depth=1)
    jart, art = _pair(cfg_kw, seed=1, pack=True)
    x = patchify_batch(_image(cfg_kw, seed=10), 16)
    cfg = ViTConfig(**cfg_kw)
    assert kernel_limits(cfg, latency=True) == []
    lat, meta = prepare_latency_artifact(art, cfg)
    kw = dict(float_dtype=torch.bfloat16, images_layout="patches")
    got = vit_int4_forward_latency(lat, torch.from_numpy(x), cfg, meta,
                                   **kw)
    assert got.shape == (1, 1000) and torch.isfinite(got).all()
    assert torch.equal(got, vit_int4_forward(art, torch.from_numpy(x), cfg,
                                             **kw))
    for n_align in (16, 32):
        want = np.asarray(j_forward(jart, jnp.asarray(x), JConfig(**cfg_kw),
                                    use_pallas=False,
                                    float_dtype=jnp.bfloat16,
                                    images_layout="patches",
                                    n_align=n_align))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)

"""Port parity: the FSDP forward with in-kernel weight gathers
(``serve/vit_fsdp.py:vit_int4_forward_fsdp_rdma``, kernels K14 + K15 on
the card) on the CPU, at tp = 1 in this process and at tp = 2 as two gloo
processes, on tests/serve/test_vit_fsdp.py's ``_rdma_cfg`` (img 32, patch
16, D 128, depth 2, 2 heads, seed 5).

Tolerances: against the port's single-device forward, exactly equal (the
gathered weights are the originals byte for byte and each process runs
the same pipeline on its own images); against the JAX
``vit_int4_forward(use_pallas=False, float_dtype=f32)``, logits within
1e-4, the port's f32 forward tolerance (tests/test_torch_vit_int4.py).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from quantized_vit_tpu.models.vit import ViTConfig as JConfig
from quantized_vit_tpu.serve import (prepare_fsdp_rdma_artifact as
                                     j_prepare)
from quantized_vit_tpu.serve import random_vit_int4_artifact as j_random
from quantized_vit_tpu.serve import vit_int4_forward as j_forward
from quantized_vit_tpu_torch.models import ViTConfig
from quantized_vit_tpu_torch.ops import _build
from quantized_vit_tpu_torch.parallel import (initialize_distributed,
                                              run_processes)
from quantized_vit_tpu_torch.serve import (artifact_from_numpy,
                                           kernel_limits,
                                           prepare_fsdp_rdma_artifact,
                                           random_vit_int4_artifact,
                                           shard_fsdp_rdma_artifact,
                                           vit_int4_forward,
                                           vit_int4_forward_fsdp_rdma)

from tests import torch_workers as tw

torch.set_num_threads(1)

RDMA = dict(img_size=32, patch_size=16, embed_dim=128, depth=2,
            num_heads=2, num_classes=10)
SEED = 5
SHARDED = ("qkv", "proj", "fc1", "fc2")


def _images(b=4):
    return np.random.default_rng(SEED).standard_normal(
        (b, 32, 32, 3)).astype(np.float32)


def _art():
    return random_vit_int4_artifact(ViTConfig(**RDMA), seed=SEED,
                                    pack_weights=False, device="cpu")


@pytest.fixture(scope="module")
def tp2(tmp_path_factory):
    """The forward at tp = 2 (4 images: 2 a process) in f32 and bf16, one
    spawned gloo group."""
    cases = [("fsdp", dt, RDMA, SEED, _images(), dt)
             for dt in ("float32", "bfloat16")]
    cases.append(("mesh", 2, ("fsdp", "dp2", RDMA, SEED, _images(),
                              "float32")))
    return run_processes(tw.run_cases, 2, str(tmp_path_factory.mktemp("s")),
                         args=(cases,), timeout_s=240)


@pytest.fixture(scope="module")
def mesh22(tmp_path_factory):
    """The forward on a (2, 2) mesh (4 images: 1 a process)."""
    cases = [("mesh", 2, ("fsdp", "dp2", RDMA, SEED, _images(), "float32"))]
    return run_processes(tw.run_cases, 4, str(tmp_path_factory.mktemp("s")),
                         args=(cases,), timeout_s=240)


@pytest.fixture(scope="module")
def jax_logits():
    jart = j_random(JConfig(**RDMA), seed=SEED, pack_weights=False)
    return np.asarray(j_forward(jart, jnp.asarray(_images()), JConfig(**RDMA),
                                use_pallas=False, float_dtype=jnp.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fsdp_tp1_equals_single_device_forward(dtype, jax_logits):
    cfg, art = ViTConfig(**RDMA), _art()
    x = torch.from_numpy(_images())
    dt = getattr(torch, dtype)
    want = vit_int4_forward(art, x, cfg, float_dtype=dt)
    got = vit_int4_forward_fsdp_rdma(shard_fsdp_rdma_artifact(art, 0, 1), x,
                                     cfg, float_dtype=dt)
    assert got.shape == (4, 10) and got.dtype == torch.float32
    assert torch.equal(got, want)
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), jax_logits, rtol=1e-4,
                                   atol=1e-4)


# ViT-H/14's widths (D 1280, 16 heads of 80, MLP 5120) at depth 1 on a
# 28-px image (4 patches of 14): the model the first K15 refused
VIT_H_W = dict(img_size=28, patch_size=14, embed_dim=1280, depth=1,
               num_heads=16, num_classes=10)


def test_fsdp_tp1_at_vit_h_width_equals_single_device_forward():
    """The FSDP forward at ViT-H/14's widths (tp = 1, f32): exactly the
    port's single-device forward, and within 1e-4 of the JAX
    ``vit_int4_forward(use_pallas=False)``."""
    cfg = ViTConfig(**VIT_H_W)
    art = random_vit_int4_artifact(cfg, seed=SEED, pack_weights=False,
                                   device="cpu")
    x = np.random.default_rng(SEED).standard_normal(
        (2, 28, 28, 3)).astype(np.float32)
    assert kernel_limits(cfg, batch=2, fmt="int8", fsdp_rdma=True) == []
    want = vit_int4_forward(art, torch.from_numpy(x), cfg,
                            float_dtype=torch.float32)
    got = vit_int4_forward_fsdp_rdma(shard_fsdp_rdma_artifact(art, 0, 1),
                                     torch.from_numpy(x), cfg,
                                     float_dtype=torch.float32)
    assert got.shape == (2, 10)
    assert torch.equal(got, want)
    jart = j_random(JConfig(**VIT_H_W), seed=SEED, pack_weights=False)
    j_logits = np.asarray(j_forward(jart, jnp.asarray(x),
                                    JConfig(**VIT_H_W), use_pallas=False,
                                    float_dtype=jnp.float32))
    np.testing.assert_allclose(got.numpy(), j_logits, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fsdp_tp2_equals_single_device_forward(tp2, dtype, jax_logits):
    """Rank r returns the logits of images [2r, 2r + 2): together exactly
    the single-device forward's, and (f32) the JAX forward's within
    1e-4."""
    cfg = ViTConfig(**RDMA)
    want = vit_int4_forward(_art(), torch.from_numpy(_images()), cfg,
                            float_dtype=getattr(torch, dtype)).numpy()
    got = np.concatenate([res[dtype][0] for res in tp2])
    np.testing.assert_array_equal(got, want)
    if dtype == "float32":
        np.testing.assert_allclose(got, jax_logits, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("layout", [(2, 1), (2, 2)])
def test_fsdp_data_axis_equals_single_device_forward(tp2, mesh22, layout):
    """A (2, tp) mesh: each process takes its images and gathers over its
    model line; together exactly the single-device forward's logits (the
    (1, tp) forward's, bit for bit)."""
    cfg = ViTConfig(**RDMA)
    want = vit_int4_forward(_art(), torch.from_numpy(_images()), cfg,
                            float_dtype=torch.float32).numpy()
    res = tp2 if layout == (2, 1) else mesh22
    got = np.concatenate([r["dp2"][0] for r in res])
    np.testing.assert_array_equal(got, want)


def test_fsdp_per_rank_weight_bytes_are_total_over_tp(tp2):
    """The point of the mode: a process holds total / tp of the block
    weight bytes (tests/serve/test_vit_fsdp.py:83-96)."""
    art = _art()
    total = sum(b[k].w.numel() for b in art["blocks"] for k in SHARDED)
    for res in tp2:
        assert res["float32"][1] * 2 == total
    assert [res["float32"][1] for res in tp2] == [total // 2] * 2


@pytest.mark.parametrize("tp", [1, 2, 4])
def test_rank_shards_concatenate_to_the_kernels_layout(tp):
    """A rank's shard of weight [R, N] has the JAX row shard's shape
    [R/tp, N]; the shards in rank order are the kernels' n-major copy
    (the bytes the plans read once gathered), and the rest of the
    artifact is shared."""
    art = _art()
    farts = [shard_fsdp_rdma_artifact(art, r, tp) for r in range(tp)]
    for i, blk in enumerate(art["blocks"]):
        for k in SHARDED:
            w = blk[k].w
            shards = [f["blocks"][i][k].w for f in farts]
            assert all(s.shape == (w.shape[0] // tp, w.shape[1])
                       for s in shards)
            cat = torch.cat(shards).reshape(w.shape[1], w.shape[0])
            assert torch.equal(cat, _build.n_major(w))
            assert torch.equal(cat.t(), w)
            assert farts[0]["blocks"][i][k].scale is blk[k].scale
    assert farts[-1]["pos_embed"] is art["pos_embed"]


def test_fsdp_rdma_prep_refusals_match_jax():
    """The two refusals of vit_fsdp.py:151-174: packed int4 MLP weights,
    and weight rows that do not split into tile-aligned shards."""
    cfg = ViTConfig(**RDMA)
    packed = random_vit_int4_artifact(cfg, seed=0, device="cpu")
    with pytest.raises(ValueError, match="int8"):
        prepare_fsdp_rdma_artifact(packed, cfg, 2)
    with pytest.raises(ValueError, match="int8"):
        shard_fsdp_rdma_artifact(packed, 0, 2)
    with pytest.raises(ValueError, match="int8"):
        j_prepare(j_random(JConfig(**RDMA), seed=0, pack_weights=True),
                  JConfig(**RDMA), 2)
    # D = 128 rows split into 8 shards of 16 int8 rows (tile: 32)
    art = _art()
    with pytest.raises(ValueError, match="not divisible by tp\\*32=256"):
        prepare_fsdp_rdma_artifact(art, cfg, 8)
    jart = j_random(JConfig(**RDMA), seed=SEED, pack_weights=False)
    with pytest.raises(ValueError, match="not divisible by tp\\*32=256"):
        j_prepare(jart, JConfig(**RDMA), 8)
    assert prepare_fsdp_rdma_artifact(art, cfg, 4) is art
    # the port's artifact from the JAX one is refused and accepted alike
    ported = artifact_from_numpy(jax.tree.map(np.asarray, jart),
                                 device="cpu")
    prepare_fsdp_rdma_artifact(ported, cfg, 4)


def test_fsdp_forward_refusals():
    """The batch must divide over the processes (vit_fsdp.py:369-370); an
    artifact sharded for another axis is refused; the kernels' limits
    are empty for ViT-B/16 and ViT-H/14 (K15 is K2's kernel, which takes
    any width)."""
    cfg, art = ViTConfig(**RDMA), _art()
    peers = initialize_distributed(device="cpu")
    assert (peers.rank, peers.tp) == (0, 1)
    fart = shard_fsdp_rdma_artifact(art, 0, 1)
    x = torch.from_numpy(_images(3))
    vit_int4_forward_fsdp_rdma(fart, x, cfg, peers)  # tp = 1: any batch

    class Two:
        rank, tp = 0, 2

    with pytest.raises(ValueError, match="not divisible by device count 2"):
        vit_int4_forward_fsdp_rdma(shard_fsdp_rdma_artifact(art, 0, 2), x,
                                   cfg, Two())
    with pytest.raises(ValueError, match="sharded for"):
        vit_int4_forward_fsdp_rdma(fart, x, cfg, Two())
    vit_h = ViTConfig(patch_size=14, embed_dim=1280, depth=1, num_heads=16)
    assert kernel_limits(vit_h, batch=16, fmt="int8",
                         float_dtype=torch.bfloat16, fsdp_rdma=True) == []
    assert kernel_limits(vit_h, fmt="int8", fsdp_rdma=True) == []
    assert kernel_limits(ViTConfig(), batch=16, fmt="int8",
                         float_dtype=torch.bfloat16, fsdp_rdma=True) == []
    with pytest.raises(ValueError, match="num_processes > 1 needs"):
        initialize_distributed(num_processes=2, device="cpu")

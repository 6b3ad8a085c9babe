"""Port parity: the column-sharded FSDP forward
(``serve/vit_fsdp.py:vit_int4_forward_fsdp``; K14 gathers each block's
four weights one block ahead on the card) on the CPU, at tp = 1 in this
process and tp = 2 and 4 as spawned gloo processes, on
tests/serve/test_vit_fsdp.py's shapes (img 32, D 64, depth 2, 4 heads,
batch 8, seed 3), int8 and packed int4.

Tolerances: against the port's single-device forward, exactly equal (the
gathered weights are the originals byte for byte and each process runs
the single-device block on its own images); against the JAX
``vit_int4_forward_fsdp(use_pallas=False)`` on the conftest's CPU mesh,
logits within 1e-4 (the port's f32 forward tolerance).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from quantized_vit_tpu.models.vit import ViTConfig as JConfig
from quantized_vit_tpu.serve import prepare_fsdp_artifact as j_prepare
from quantized_vit_tpu.serve import random_vit_int4_artifact as j_random
from quantized_vit_tpu.serve import shard_fsdp_artifact as j_shard
from quantized_vit_tpu.serve import vit_int4_forward_fsdp as j_forward_fsdp
from quantized_vit_tpu_torch.models import ViTConfig
from quantized_vit_tpu_torch.ops import _build
from quantized_vit_tpu_torch.parallel import (COLLECTIVES, reset_collectives,
                                              run_processes)
from quantized_vit_tpu_torch.serve import (fsdp_artifact_specs,
                                           prepare_fsdp_artifact,
                                           random_vit_int4_artifact,
                                           shard_fsdp_artifact,
                                           vit_int4_forward,
                                           vit_int4_forward_fsdp)

from tests import torch_workers as tw

torch.set_num_threads(1)

SMALL = dict(img_size=32, patch_size=16, embed_dim=64, depth=2, num_heads=4,
             num_classes=10)
SEED = 3
SHARDED = ("qkv", "proj", "fc1", "fc2")


def _images(b=8):
    return np.random.default_rng(SEED).standard_normal(
        (b, 32, 32, 3)).astype(np.float32)


def _art(packed):
    return random_vit_int4_artifact(ViTConfig(**SMALL), seed=SEED,
                                    pack_weights=packed, device="cpu")


def _cases():
    return [("fsdp_col", f"f32:{packed}", SMALL, SEED, packed, _images(),
             "float32") for packed in (False, True)] + [
        ("fsdp_col", "bf16", SMALL, SEED, True, _images(), "bfloat16")] + [
        ("mesh", 2, ("fsdp_col", f"dp2:{packed}", SMALL, SEED, packed,
                     _images(), "float32")) for packed in (False, True)]


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    return {tp: run_processes(tw.run_cases, tp,
                              str(tmp_path_factory.mktemp("s")),
                              args=(_cases(),), timeout_s=240)
            for tp in (2, 4)}


def _single(packed, dtype=torch.float32):
    return vit_int4_forward(_art(packed), torch.from_numpy(_images()),
                            ViTConfig(**SMALL), float_dtype=dtype).numpy()


def _jax(packed, tp):
    cfg = JConfig(**SMALL)
    mesh = Mesh(np.array(jax.devices()[:8]).reshape(8 // tp, tp),
                ("data", "model"))
    art = j_shard(j_prepare(j_random(cfg, seed=SEED, pack_weights=packed),
                            cfg, tp), mesh)
    x = jax.device_put(jnp.asarray(_images()),
                       NamedSharding(mesh, P(("data", "model"))))
    return np.asarray(j_forward_fsdp(art, x, cfg, mesh, use_pallas=False,
                                     float_dtype=jnp.float32))


@pytest.mark.parametrize("packed", [False, True])
def test_tp1_equals_single_device_forward(packed):
    cfg = ViTConfig(**SMALL)
    reset_collectives()
    got = vit_int4_forward_fsdp(shard_fsdp_artifact(_art(packed), 0, 1),
                                torch.from_numpy(_images()), cfg,
                                float_dtype=torch.float32)
    assert got.shape == (8, 10) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), _single(packed))
    np.testing.assert_allclose(got.numpy(), _jax(packed, 1), rtol=0,
                               atol=1e-4)
    assert dict(COLLECTIVES) == {("all_gather", "int8"): 4 * SMALL["depth"]}


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("tp", [2, 4])
def test_spawned_equals_single_device_and_jax(spawned, tp, packed):
    """Rank r returns the logits of images [r*8/tp, (r+1)*8/tp):
    together exactly the single-device forward's, and the JAX column
    forward's within 1e-4."""
    got = np.concatenate([r[f"f32:{packed}"][0] for r in spawned[tp]])
    np.testing.assert_array_equal(got, _single(packed))
    np.testing.assert_allclose(got, _jax(packed, tp), rtol=0, atol=1e-4)


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("world", [2, 4])
def test_data_axis_equals_single_device(spawned, world, packed):
    """A (2, world/2) mesh: each process takes its 8/world images and
    gathers the weights over its model line; together exactly the
    single-device forward's logits (the (1, tp) forward's, bit for
    bit)."""
    got = np.concatenate([r[f"dp2:{packed}"][0] for r in spawned[world]])
    np.testing.assert_array_equal(got, _single(packed))


@pytest.mark.parametrize("tp", [2, 4])
def test_spawned_bf16_equals_single_device(spawned, tp):
    got = np.concatenate([r["bf16"][0] for r in spawned[tp]])
    np.testing.assert_array_equal(got, _single(True, torch.bfloat16))


@pytest.mark.parametrize("tp", [2, 4])
def test_per_process_weight_bytes_are_total_over_tp(spawned, tp):
    """tests/serve/test_vit_fsdp.py:83-96: a process holds total / tp of
    the block-weight bytes."""
    for packed in (False, True):
        art = _art(packed)
        total = sum(b[k].w.numel() for b in art["blocks"] for k in SHARDED)
        assert [r[f"f32:{packed}"][1] for r in spawned[tp]] == \
            [total // tp] * tp


@pytest.mark.parametrize("tp", [2, 4])
def test_four_weight_gathers_a_block(spawned, tp):
    """Exactly 4 int8 weight all-gathers per block and nothing else (no
    reduce-scatter: the compute is data parallel)."""
    for res in spawned[tp]:
        for name, (_, _, counts) in res.items():
            assert counts == {("all_gather", "int8"): 4 * SMALL["depth"]}, \
                name


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("tp", [1, 2, 4])
def test_column_shards_are_rows_of_the_kernels_layout(tp, packed):
    """A rank's shard of weight [R, N] is its columns [R, N/tp] (the JAX
    column shard's values), stored as N/tp contiguous rows of the n-major
    copy; the shards in rank order are that copy, and the rest of the
    artifact is shared."""
    art = _art(packed)
    parts = [shard_fsdp_artifact(art, r, tp) for r in range(tp)]
    specs = fsdp_artifact_specs(art)
    for i, blk in enumerate(art["blocks"]):
        for k in SHARDED:
            w = blk[k].w
            shards = [p["blocks"][i][k].w for p in parts]
            n = w.shape[1] // tp
            for r, s in enumerate(shards):
                assert torch.equal(s, w[:, r * n:(r + 1) * n])
                assert s.t().is_contiguous()
            assert torch.equal(torch.cat([s.t() for s in shards]),
                               _build.n_major(w))
            assert specs["blocks"][i][k].w == "col"
            assert parts[0]["blocks"][i][k].bias is blk[k].bias
    assert parts[-1]["pos_embed"] is art["pos_embed"]
    assert specs["pos_embed"] == "rep"


def test_refusals():
    """A width that does not divide over tp (vit_fsdp.py:60-85), with the
    JAX message; a batch that does not divide; an artifact sharded for
    another axis."""
    cfg = ViTConfig(**SMALL)
    art = _art(True)
    with pytest.raises(ValueError, match="output width 64 not divisible "
                                         "by tp=3"):
        prepare_fsdp_artifact(art, cfg, 3)
    with pytest.raises(ValueError, match="output width 64 not divisible "
                                         "by tp=3"):
        shard_fsdp_artifact(art, 0, 3)
    with pytest.raises(ValueError, match="output width 64 not divisible "
                                         "by tp=3"):
        j_prepare(j_random(JConfig(**SMALL), seed=SEED), JConfig(**SMALL), 3)
    assert prepare_fsdp_artifact(art, cfg, 4) is art
    fart = shard_fsdp_artifact(art, 0, 1)
    x = torch.from_numpy(_images(3))

    class Two:
        rank, tp = 0, 2

    with pytest.raises(ValueError, match="batch 3 not divisible by device "
                                         "count 2"):
        vit_int4_forward_fsdp(shard_fsdp_artifact(art, 0, 2), x, cfg, Two())
    with pytest.raises(ValueError, match="sharded for"):
        vit_int4_forward_fsdp(fart, x, cfg, Two())

"""Port parity: tensor-parallel serving (``serve/vit_tp.py``,
``parallel/tp_comm.py``) on the CPU, against the JAX
``vit_int4_forward_tp(use_pallas=False)`` on the conftest's virtual CPU
mesh, at the shapes of tests/serve/test_vit_tp.py (img 32, D 64, depth 2,
4 heads, batch 8): tp = 1 in this process, tp = 2 and 4 as spawned gloo
processes (one group per tp, in module fixtures).

Tolerances: f32 residual and f32 comm, logits within 1e-4 of the JAX TP
forward (the JAX test's own bound against the single-device forward);
bf16 comm, the JAX test's criterion (tests/serve/test_vit_tp.py:58-84):
the deviation from the f32 TP forward at most 1.5x the single-device bf16
forward's, plus 1e-6 (XLA's psum_scatter sums in another order than the
port's rank order, so the bits are not compared).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from quantized_vit_tpu.models.vit import ViTConfig as JConfig
from quantized_vit_tpu.serve import prepare_tp_artifact as j_prepare
from quantized_vit_tpu.serve import random_vit_int4_artifact as j_random
from quantized_vit_tpu.serve import shard_tp_artifact as j_shard
from quantized_vit_tpu.serve import vit_int4_forward_tp as j_forward_tp
from quantized_vit_tpu.serve.vit_tp import _qkv_head_perm as j_perm
from quantized_vit_tpu.serve.vit_tp import (repack_row_parallel_entry as
                                            j_repack)
from quantized_vit_tpu_torch.models import ViTConfig
from quantized_vit_tpu_torch.ops import ln_quant_levels
from quantized_vit_tpu_torch.ops.fused import fused_quant_matmul_plain
from quantized_vit_tpu_torch.parallel import (COLLECTIVES, check_mesh,
                                              reset_collectives,
                                              run_processes)
from quantized_vit_tpu_torch.serve import (artifact_from_numpy,
                                           prepare_tp_artifact,
                                           random_vit_int4_artifact,
                                           shard_tp_artifact,
                                           tp_artifact_specs,
                                           vit_int4_forward,
                                           vit_int4_forward_tp)
from quantized_vit_tpu_torch.serve.vit_tp import (_ln_quant, _qkv_head_perm,
                                                  repack_row_parallel_entry)

from tests import torch_workers as tw

torch.set_num_threads(1)

SMALL = dict(img_size=32, patch_size=16, embed_dim=64, depth=2, num_heads=4,
             num_classes=10)
# (seed, packed) of the JAX tests' int8 and packed-int4 cases
INT8, INT4 = (0, False), (2, True)
BF16_SEED = 1


def _images(seed):
    return np.random.default_rng(seed).standard_normal(
        (8, 32, 32, 3)).astype(np.float32)


def _mesh(dp, tp):
    return Mesh(np.array(jax.devices()[:dp * tp]).reshape(dp, tp),
                ("data", "model"))


def _j_tp(seed, packed, tp, float_dtype=jnp.float32, comm=jnp.float32):
    cfg = JConfig(**SMALL)
    art = j_random(cfg, seed=seed, pack_weights=packed)
    mesh = _mesh(8 // tp, tp)
    art_tp = j_shard(j_prepare(art, cfg, tp), mesh)
    x = jax.device_put(jnp.asarray(_images(seed)),
                       NamedSharding(mesh, P(("data", "model"))))
    return np.asarray(j_forward_tp(art_tp, x, cfg, mesh, use_pallas=False,
                                   float_dtype=float_dtype, comm_dtype=comm),
                      np.float32)


def _art(seed, packed):
    return random_vit_int4_artifact(ViTConfig(**SMALL), seed=seed,
                                    pack_weights=packed, device="cpu")


def _cases(tp):
    cases = [("tp", f"f32:{seed}:{packed}", SMALL, seed, packed,
              _images(seed), "float32", "float32")
             for seed, packed in (INT8, INT4)]
    # the same forwards with a data axis: (2, tp / 2) meshes of the group
    cases += [("mesh", 2, ("tp", f"dp2:{seed}:{packed}", SMALL, seed, packed,
                           _images(seed), "float32", "float32"))
              for seed, packed in (INT8, INT4)]
    if tp == 2:
        cases.append(("tp", "bf16", SMALL, BF16_SEED, False,
                      _images(BF16_SEED), "bfloat16", "bfloat16"))
    return cases


@pytest.fixture(scope="module")
def tp2(tmp_path_factory):
    return run_processes(tw.run_cases, 2, str(tmp_path_factory.mktemp("s")),
                         args=(_cases(2),), timeout_s=240)


@pytest.fixture(scope="module")
def tp4(tmp_path_factory):
    return run_processes(tw.run_cases, 4, str(tmp_path_factory.mktemp("s")),
                         args=(_cases(4),), timeout_s=240)


def _logits(res, name):
    return np.concatenate([r[name][0] for r in res])


@pytest.mark.parametrize("tp", [1, 2, 4])
def test_qkv_head_perm_equals_jax(tp):
    np.testing.assert_array_equal(_qkv_head_perm(4, 8, tp), j_perm(4, 8, tp))
    perm = _qkv_head_perm(4, 8, tp)
    cols = np.arange(96)[perm].reshape(tp, 3, 4 // tp, 8)
    orig = np.arange(96).reshape(3, 4, 8)
    for i in range(tp):
        np.testing.assert_array_equal(
            cols[i], orig[:, i * (4 // tp):(i + 1) * (4 // tp)])


def test_repack_row_parallel_entry_equals_jax():
    """The per-shard repack (ADVICE r3 #1): the same bytes as the JAX
    function's, and shard i's local unpack gives global rows [i*K/tp,
    (i+1)*K/tp) in order."""
    from quantized_vit_tpu.quant.packing import pack_int4 as j_pack
    from quantized_vit_tpu.serve.vit_int4 import QLayerArtifact as JQ
    from quantized_vit_tpu_torch.quant.packing import pack_int4, unpack_int4
    from quantized_vit_tpu_torch.serve import QLayerArtifact

    rng = np.random.default_rng(0)
    k, n, tp = 64, 48, 4
    w = rng.integers(-7, 8, (k, n)).astype(np.int8)
    e = QLayerArtifact(w=pack_int4(torch.from_numpy(w), axis=0),
                       scale=torch.tensor(1.0), bias=None, act={},
                       fmt="int4")
    re = repack_row_parallel_entry(e, tp)
    je = j_repack(JQ(w=j_pack(jnp.asarray(w), axis=0), scale=jnp.float32(1),
                     bias=None, act={}, fmt="int4"), tp)
    np.testing.assert_array_equal(re.w.numpy(), np.asarray(je.w))
    kp = k // 2
    for i in range(tp):
        local = re.w[i * kp // tp:(i + 1) * kp // tp]
        np.testing.assert_array_equal(unpack_int4(local, axis=0).numpy(),
                                      w[i * k // tp:(i + 1) * k // tp])
    assert repack_row_parallel_entry(e, 1) is e


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("tp", [1, 2, 4])
def test_prepare_tp_artifact_equals_jax(tp, packed):
    """The permuted qkv columns (w, bias) and the re-packed proj/fc2 are
    the JAX arrays, byte for byte; the rest is untouched."""
    cfg = ViTConfig(**SMALL)
    art = _art(3, packed)
    got = prepare_tp_artifact(art, cfg, tp)
    want = j_prepare(j_random(JConfig(**SMALL), seed=3, pack_weights=packed),
                     JConfig(**SMALL), tp)
    for gb, wb, ab in zip(got["blocks"], want["blocks"], art["blocks"]):
        for k in ("qkv", "proj", "fc1", "fc2"):
            np.testing.assert_array_equal(gb[k].w.numpy(),
                                          np.asarray(wb[k].w))
            np.testing.assert_array_equal(gb[k].bias.numpy(),
                                          np.asarray(wb[k].bias))
        assert gb["fc1"] is ab["fc1"] and gb["norm1"] is ab["norm1"]
    assert got["pos_embed"] is art["pos_embed"]


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("tp", [2, 4])
def test_tp_shards_concatenate_to_the_whole(tp, packed):
    """Column shards (qkv, fc1, their biases) and row shards (proj, fc2)
    in rank order give back the TP-prepared artifact; the rest is shared;
    the spec tree names each placement."""
    cfg = ViTConfig(**SMALL)
    prep = prepare_tp_artifact(_art(0, packed), cfg, tp)
    parts = [shard_tp_artifact(prep, r, tp) for r in range(tp)]
    specs = tp_artifact_specs(prep)
    for i, blk in enumerate(prep["blocks"]):
        for k, axis in (("qkv", 1), ("fc1", 1), ("proj", 0), ("fc2", 0)):
            assert specs["blocks"][i][k].w == ("col" if axis else "row")
            shards = [p["blocks"][i][k] for p in parts]
            assert torch.equal(torch.cat([s.w for s in shards], axis),
                               blk[k].w)
            bias = [s.bias for s in shards]
            assert torch.equal(torch.cat(bias) if axis else bias[0],
                               blk[k].bias)
            assert all(s.fmt == blk[k].fmt for s in shards)
    assert all(p["pos_embed"] is prep["pos_embed"] for p in parts)
    assert [p["tp"] for p in parts] == [(r, tp) for r in range(tp)]
    assert specs["blocks"][0]["norm1"] == {"scale": "rep", "bias": "rep"}


@pytest.mark.parametrize("packed", [False, True])
def test_tp1_matches_jax_and_single_device(packed):
    """tp = 1 in this process: within 1e-4 of the JAX TP forward and of
    the port's single-device forward (f32, f32 comm)."""
    seed = INT4[0] if packed else INT8[0]
    cfg = ViTConfig(**SMALL)
    art = _art(seed, packed)
    x = torch.from_numpy(_images(seed))
    reset_collectives()
    got = vit_int4_forward_tp(
        shard_tp_artifact(prepare_tp_artifact(art, cfg, 1), 0, 1), x, cfg,
        float_dtype=torch.float32, comm_dtype=torch.float32)
    assert got.shape == (8, 10) and got.dtype == torch.float32
    assert dict(COLLECTIVES) == {("all_gather", "int8"): 4,
                                 ("reduce_scatter", "float32"): 4}
    np.testing.assert_allclose(got.numpy(), _j_tp(seed, packed, 1),
                               rtol=0, atol=1e-4)
    single = vit_int4_forward(art, x, cfg, float_dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), single.numpy(), rtol=0,
                               atol=1e-4)


@pytest.mark.parametrize("case", [INT8, INT4], ids=["int8", "int4"])
def test_tp2_matches_jax(tp2, case):
    seed, packed = case
    np.testing.assert_allclose(_logits(tp2, f"f32:{seed}:{packed}"),
                               _j_tp(seed, packed, 2), rtol=0, atol=1e-4)


@pytest.mark.parametrize("case", [INT8, INT4], ids=["int8", "int4"])
def test_tp4_matches_jax(tp4, case):
    """tp = 4: one head a process, fc1 and fc2 in 64-wide shards, packed
    int4 proj/fc2 re-packed in 16-row chunks."""
    seed, packed = case
    np.testing.assert_allclose(_logits(tp4, f"f32:{seed}:{packed}"),
                               _j_tp(seed, packed, 4), rtol=0, atol=1e-4)


@pytest.mark.parametrize("case", [INT8, INT4], ids=["int8", "int4"])
@pytest.mark.parametrize("layout", [(2, 1), (2, 2)])
def test_data_axis_equals_dp1(tp2, tp4, layout, case):
    """A (2, tp) mesh: each of the 2 x tp processes takes its 8/(2 tp)
    images and its model line's collectives; together the logits of the
    (1, tp) forward (tp = 1 in this process) within the f32 criterion,
    1e-4, and the JAX TP forward's within 1e-4."""
    seed, packed = case
    dp, tp = layout
    got = _logits(tp2 if dp * tp == 2 else tp4, f"dp2:{seed}:{packed}")
    if tp == 1:
        cfg = ViTConfig(**SMALL)
        one = vit_int4_forward_tp(
            shard_tp_artifact(prepare_tp_artifact(_art(seed, packed), cfg,
                                                  1), 0, 1),
            torch.from_numpy(_images(seed)), cfg, float_dtype=torch.float32,
            comm_dtype=torch.float32).numpy()
    else:
        one = _logits(tp2, f"f32:{seed}:{packed}")
    assert got.shape == (8, 10)
    np.testing.assert_allclose(got, one, rtol=0, atol=1e-4)
    np.testing.assert_allclose(got, _j_tp(seed, packed, tp), rtol=0,
                               atol=1e-4)


def test_tp2_bf16_comm_close(tp2):
    """Serving dtypes (bf16 residual, bf16 reduce-scatter) against the f32
    TP forward: no worse than 1.5x the single-device bf16 forward's
    deviation (tests/serve/test_vit_tp.py:58-84), the JAX forward on the
    same criterion, and the port's f32 TP reference equal to JAX's within
    1e-4."""
    cfg = ViTConfig(**SMALL)
    art = _art(BF16_SEED, False)
    exact = _j_tp(BF16_SEED, False, 2)
    served = _logits(tp2, "bf16")
    single = vit_int4_forward(art, torch.from_numpy(_images(BF16_SEED)),
                              cfg, float_dtype=torch.bfloat16).numpy()
    dev_tp = np.abs(served - exact).max()
    dev_single = np.abs(single - exact).max()
    assert dev_tp <= 1.5 * dev_single + 1e-6, (dev_tp, dev_single)
    j_served = _j_tp(BF16_SEED, False, 2, jnp.bfloat16, jnp.bfloat16)
    assert np.abs(j_served - exact).max() <= 1.5 * dev_single + 1e-6


@pytest.mark.parametrize("tp", [2, 4])
def test_two_gathers_two_reduce_scatters_a_block(tp2, tp4, tp):
    """Exactly 2 all-gathers of int8 levels and 2 reduce-scatters (in the
    comm dtype) per block, nothing else
    (tests/serve/test_vit_tp.py:87-112)."""
    depth = SMALL["depth"]
    for res in (tp2 if tp == 2 else tp4):
        for name, (_, _, counts) in res.items():
            comm = "bfloat16" if name == "bf16" else "float32"
            assert counts == {("all_gather", "int8"): 2 * depth,
                              ("reduce_scatter", comm): 2 * depth}, name


def test_per_process_weight_bytes(tp2):
    """A process holds its column and row shards: total / tp of the block
    weights."""
    art = _art(0, False)
    total = sum(b[k].w.numel() for b in art["blocks"]
                for k in ("qkv", "proj", "fc1", "fc2"))
    assert [r["f32:0:False"][1] for r in tp2] == [total // 2] * 2


@pytest.mark.parametrize("act_pow", [False, True])
def test_ln_quant_levels_equal_jax_and_k1_prologue(act_pow):
    """The levels launch's plain version (``_ln_quant``): the JAX
    ``_ln_quant``'s levels, and those K1's ln_quant prologue feeds its
    GEMM (the GEMM on them with prologue None gives K1's output)."""
    from quantized_vit_tpu.serve.vit_tp import _ln_quant as j_ln_quant
    from quantized_vit_tpu.serve.vit_int4 import QLayerArtifact as JQ
    from quantized_vit_tpu_torch.serve import QLayerArtifact

    rng = np.random.default_rng(7)
    x = (rng.standard_normal((40, 64)) * 0.7).astype(np.float32)
    g = (rng.standard_normal(64) * 0.1 + 1).astype(np.float32)
    b = (rng.standard_normal(64) * 0.05).astype(np.float32)
    w = rng.integers(-7, 8, (64, 24)).astype(np.int8)
    t = 1.1 if act_pow else 1.0
    act = {"d": np.float32(0.04), "q_m": np.float32(0.3), "t": np.float32(t)}
    e = QLayerArtifact(w=torch.from_numpy(w), scale=torch.tensor(1e-3),
                       bias=None, act={k: torch.tensor(v)
                                       for k, v in act.items()},
                       fmt="int8", act_pow=act_pow, top=127)
    ln = {"scale": torch.from_numpy(g), "bias": torch.from_numpy(b)}
    got = _ln_quant(torch.from_numpy(x), ln, e)
    je = JQ(w=jnp.asarray(w), scale=jnp.float32(1e-3), bias=None,
            act={k: jnp.asarray(v) for k, v in act.items()}, fmt="int8",
            act_pow=act_pow, top=127)
    want = np.asarray(j_ln_quant(jnp.asarray(x), {"scale": jnp.asarray(g),
                                                  "bias": jnp.asarray(b)},
                                 je))
    np.testing.assert_array_equal(got.numpy(), want)
    lv = ln_quant_levels(torch.from_numpy(x), ln["scale"], ln["bias"],
                         act_d=e.act["d"], act_t=e.act["t"], act_top=127,
                         act_pow=act_pow)
    assert torch.equal(lv, got) and lv.dtype == torch.int8
    kw = dict(fmt="int8", out_dtype=torch.float32)
    k1 = fused_quant_matmul_plain(
        torch.from_numpy(x), e.w, e.scale, prologue="ln_quant",
        act_d=e.act["d"], act_t=e.act["t"], act_top=127, act_pow=act_pow,
        ln_scale=ln["scale"], ln_bias=ln["bias"], **kw)
    assert torch.equal(fused_quant_matmul_plain(lv, e.w, e.scale,
                                                prologue=None, **kw), k1)


def test_tp_refusals():
    """The refusals of the JAX preparation and forward: heads % tp, K %
    2tp for a packed row shard, batch % tp, and an artifact sharded for
    another axis; a (dp, tp) layout whose dp x tp processes are not the
    group's."""
    cfg = ViTConfig(**SMALL)
    art = _art(0, True)
    with pytest.raises(ValueError, match="heads=4 not divisible by tp=3"):
        prepare_tp_artifact(art, cfg, 3)
    with pytest.raises(ValueError, match="heads=4 not divisible by tp=3"):
        j_prepare(j_random(JConfig(**SMALL), seed=0), JConfig(**SMALL), 3)
    e = dataclasses.replace(art["blocks"][0]["proj"],
                            w=art["blocks"][0]["proj"].w[:3])
    with pytest.raises(ValueError, match="K divisible by 2\\*tp; got K=6"):
        repack_row_parallel_entry(e, 2)
    tart = shard_tp_artifact(prepare_tp_artifact(art, cfg, 1), 0, 1)

    class Two:
        rank, tp = 0, 2

    x = torch.from_numpy(_images(0))[:3]
    with pytest.raises(ValueError, match="batch 3 not divisible by "
                                         "dp\\*tp=2"):
        vit_int4_forward_tp(shard_tp_artifact(prepare_tp_artifact(
            art, cfg, 2), 0, 2), x, cfg, Two())
    with pytest.raises(ValueError, match="needs 8 processes; the group "
                                         "has 1"):
        check_mesh(2, 4)
    check_mesh(1, 1)
    with pytest.raises(ValueError, match="sharded for"):
        vit_int4_forward_tp(tart, x, cfg, Two())
    with pytest.raises(ValueError, match="rank 2 outside tp=2"):
        shard_tp_artifact(art, 2, 2)
    # the port's artifact from the JAX one prepares to the same bytes
    jart = j_random(JConfig(**SMALL), seed=0, pack_weights=True)
    ported = artifact_from_numpy(jax.tree.map(np.asarray, jart),
                                 device="cpu")
    for a, b in zip(prepare_tp_artifact(ported, cfg, 2)["blocks"],
                    prepare_tp_artifact(art, cfg, 2)["blocks"]):
        assert torch.equal(a["qkv"].w, b["qkv"].w)

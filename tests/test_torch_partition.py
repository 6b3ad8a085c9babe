"""Port parity: the (dp, tp) process layout and the partition rules
(``parallel/partition.py``, ``parallel/distributed.py:
create_hybrid_mesh``) against the JAX functions on the conftest's CPU
mesh: the rules and specs on the paths of tests/parallel/
test_partition.py, and, in eight spawned gloo processes laid out (2, 4)
as ``mesh8``, each rank's shards (equal to JAX's addressable shard of
its device, exactly), their gather back to the whole, its slice of the
batch and of an INT4 serving artifact, and the hybrid mesh. All
comparisons are exact (the shards are copies).
"""

import functools

import numpy as np
import pytest
import torch

import flax
import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as JP

from quantized_vit_tpu.models import QuantConfig as JQ
from quantized_vit_tpu.models import ViTConfig as JC
from quantized_vit_tpu.models import VisionTransformer as JV
from quantized_vit_tpu.parallel import (VIT_PARTITION_RULES as J_RULES,
                                        create_hybrid_mesh as j_hybrid,
                                        data_sharding as j_data,
                                        partition_specs as j_specs,
                                        shard_params as j_shard,
                                        spec_for_path as j_spec)
from quantized_vit_tpu.parallel.partition import (shard_vit_artifact as
                                                  j_shard_art)
from quantized_vit_tpu.serve import random_vit_int4_artifact as j_random
from quantized_vit_tpu_torch.models import flatten_tree
from quantized_vit_tpu_torch.parallel import (VIT_PARTITION_RULES,
                                              create_hybrid_mesh,
                                              create_mesh, partition_specs,
                                              run_processes, spec_for_path)
from quantized_vit_tpu_torch.parallel import PartitionSpec as P

from tests import torch_mesh_workers as mw

torch.set_num_threads(1)

PATHS = ["blocks_0/attn/qkv/kernel", "blocks_3/attn/proj/kernel",
         "blocks_7/mlp/fc1/kernel", "blocks_7/mlp/fc2/kernel",
         "blocks_0/mlp/fc1/bias", "blocks_0/attn/qkv/bias",
         "blocks_0/attn/proj/bias", "blocks_0/mlp/fc2/bias",
         "blocks_0/attn/qkv/d_quant_wt", "blocks_0/norm1/scale",
         "pos_embed", "cls_token", "head/kernel", "patch_embed/proj/kernel"]
SMALL = dict(img_size=32, patch_size=16, embed_dim=64, depth=1, num_heads=4,
             num_classes=8)


@functools.lru_cache(maxsize=None)
def _jax_params():
    cfg = JC(**SMALL, quant=JQ(enabled=True))
    x = jnp.zeros((1, 32, 32, 3), jnp.float32)
    return flax.core.unfreeze(jax.jit(JV(cfg).init)(jax.random.PRNGKey(0),
                                                    x)["params"])


def _flat_np(tree):
    return {k: np.asarray(v) for k, v in flatten_tree(
        jax.tree.map(np.asarray, tree)).items()}


def _images():
    return np.random.default_rng(0).standard_normal((8, 32, 32, 3)).astype(
        np.float32)


@functools.lru_cache(maxsize=None)
def _artifact():
    return jax.tree.map(np.asarray, j_random(JC(**SMALL), seed=0,
                                             pack_weights=False))


def _plain(node):
    """The artifact with its layer objects as SimpleNamespaces (a spawned
    process unpickles them without importing the JAX package)."""
    import dataclasses
    import types

    if dataclasses.is_dataclass(node):
        return types.SimpleNamespace(**{f.name: _plain(getattr(node, f.name))
                                        for f in dataclasses.fields(node)})
    if isinstance(node, dict):
        return {k: _plain(v) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return [_plain(v) for v in node]
    return node


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return run_processes(mw.partition, 8, str(tmp_path_factory.mktemp("p")),
                         args=(_flat_np(_jax_params()), _plain(_artifact()),
                               _images()), timeout_s=240)


def test_rules_equal_jax():
    assert [(pat, tuple(spec)) for pat, spec in VIT_PARTITION_RULES] == \
        [(pat, tuple(spec)) for pat, spec in J_RULES]
    for path in PATHS:
        assert tuple(spec_for_path(path)) == tuple(j_spec(path)), path
    assert spec_for_path("blocks_0/attn/qkv/kernel") == P(None, "model")
    assert spec_for_path("pos_embed") == P()


def test_partition_specs_equal_jax():
    params = _jax_params()
    got = flatten_tree(partition_specs(_flat_tree(params)))
    want = flatten_tree(jax.tree.map(lambda s: s, j_specs(params),
                                     is_leaf=lambda s: isinstance(s, JP)))
    assert set(got) == set(want)
    for k in got:
        assert tuple(got[k]) == tuple(want[k]), k


def _flat_tree(params):
    from quantized_vit_tpu_torch.models import unflatten_tree

    return unflatten_tree({k: torch.from_numpy(v.copy())
                           for k, v in _flat_np(params).items()})


def test_shard_shapes_at_tp4_equal_jax(ranks, mesh8):
    """tests/parallel/test_partition.py:30-52: qkv (64, 192/4), proj
    (64/4, 64), LN whole; every leaf's shard on every rank equals the
    JAX addressable shard of the device at the same mesh position."""
    sharded = j_shard(_jax_params(), mesh8)
    assert ranks[0]["shards"]["blocks_0/attn/qkv/kernel"] == (64, 48)
    assert ranks[0]["shards"]["blocks_0/attn/proj/kernel"] == (16, 64)
    assert ranks[0]["shards"]["blocks_0/norm1/scale"] == (64,)
    devs = mesh8.devices
    qkv = sharded["blocks_0"]["attn"]["qkv"]["kernel"]
    by_dev = {s.device: np.asarray(s.data) for s in qkv.addressable_shards}
    for r in ranks:
        c = r["coords"]
        assert c == {"data": ranks.index(r) // 4, "model": ranks.index(r) % 4}
        np.testing.assert_array_equal(r["qkv"],
                                      by_dev[devs[c["data"], c["model"]]])
    flat = flatten_tree(jax.tree.map(
        lambda a: tuple(a.addressable_shards[0].data.shape), sharded))
    assert ranks[0]["shards"] == flat


def test_gather_params_inverts_shard_params(ranks):
    want = _flat_np(_jax_params())
    for r in ranks:
        assert set(r["gathered"]) == set(want)
        for k, v in want.items():
            np.testing.assert_array_equal(r["gathered"][k], v, err_msg=k)


def test_data_sharding_is_the_ranks_batch_slice(ranks, mesh8):
    x = jax.device_put(jnp.asarray(_images()), j_data(mesh8, 4))
    by_dev = {s.device: np.asarray(s.data) for s in x.addressable_shards}
    for r in ranks:
        c = r["coords"]
        np.testing.assert_array_equal(
            r["batch"], by_dev[mesh8.devices[c["data"], c["model"]]])


def test_shard_vit_artifact_equals_jax(ranks, mesh8):
    placed = j_shard_art(jax.tree.map(jnp.asarray, _artifact()), mesh8)
    blk = placed["blocks"][0]
    for r in ranks:
        c = r["coords"]
        dev = mesh8.devices[c["data"], c["model"]]
        for k in ("qkv", "proj", "fc1", "fc2"):
            w = {s.device: np.asarray(s.data) for s in
                 blk[k].w.addressable_shards}[dev]
            np.testing.assert_array_equal(r["art"][k][0], w, err_msg=k)
            b = {s.device: np.asarray(s.data) for s in
                 blk[k].bias.addressable_shards}[dev]
            np.testing.assert_array_equal(r["art"][k][1], b, err_msg=k)


def test_hybrid_mesh_shapes_equal_jax(ranks):
    jm = j_hybrid(ici_shape=(4, 2), dcn_shape=(1,),
                  axis_names=("replica", "data", "model"))
    for i, r in enumerate(ranks):
        shape, coords = r["hybrid"]
        assert tuple(shape.values()) == jm.devices.shape
        assert tuple(shape) == jm.axis_names
        assert coords == {"replica": 0, "data": i // 2, "model": i % 2}
        assert r["health"]


def test_hybrid_mesh_refusals():
    with pytest.raises(ValueError, match="must match dcn\\+ici shape"):
        create_hybrid_mesh(ici_shape=(2, 2), dcn_shape=(1,),
                           axis_names=("data", "model"), device="cpu")
    with pytest.raises(ValueError):
        j_hybrid(ici_shape=(2, 2), dcn_shape=(1,),
                 axis_names=("data", "model"))
    with pytest.raises(ValueError, match="needs 2 processes"):
        create_mesh((1, 2), device="cpu")
    one = create_mesh((1, 1), device="cpu")
    assert dict(one.shape) == {"data": 1, "model": 1} and one.rank == 0

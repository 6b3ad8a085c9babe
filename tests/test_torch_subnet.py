"""Port parity: subnet construction (``compress/subnet.py``) and the OTO
methods around it (``graph/oto.py``: ``construct_subnet``,
``random_set_zero_groups``, ``cluster_node_groups``, ``visualize``)
against the JAX package on the tiny quantized ViT
(``tests/torch_a1_params.py``) and on UltraNet
(``tests/torch_ultranet_params.py``, ``construct_subnet_ultranet`` with
its batch stats). Exact: the same groups zeroed, the same per-block
widths, the sliced params (and UltraNet's running statistics) bit for
bit, the same clusters and DOT text; UltraNet's subnet forward equal to
the zeroed full net's within 1e-5. Also the per-block kernel limits of
the serving forward (``serve.kernel_limits``)."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from quantized_vit_tpu.compress import construct_subnet_vit as jsubnet
from quantized_vit_tpu.compress import kept_groups as jkept
from quantized_vit_tpu_torch.compress import construct_subnet_vit, kept_groups
from quantized_vit_tpu_torch.models import (ViTConfig, VisionTransformer,
                                            apply, flatten_tree)
from quantized_vit_tpu_torch.serve import kernel_limits

from tests import torch_a1_params as A
from tests import torch_ultranet_params as U

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def base():
    return A.jax_params()


@pytest.mark.parametrize("seed,target,div", [
    (0, None, 1), (A.ODD_SEED, None, 1), (5, None, 2), (1, 0.5, 2),
    (2, 0.3, 1)])
def test_random_set_zero_groups_same_groups(base, seed, target, div):
    _, _, jz, tz = A.zeroed(*base, seed, target, div)
    assert A.trees_equal(jz, tz)
    assert not A.trees_equal(base[1], tz)


def test_odd_hidden_seed(base):
    joto, _, jz, _ = A.zeroed(*base, A.ODD_SEED)
    jm, _ = joto.construct_subnet(jz)
    assert any(h % 2 for h in jm.cfg.hidden_per_block)
    assert len(set(jm.cfg.heads_per_block)) > 1


@pytest.mark.parametrize("seed,target,div", [
    (0, None, 1), (A.ODD_SEED, None, 1), (4, None, 1), (1, 0.5, 2)])
def test_construct_subnet_vit_equal(base, seed, target, div):
    joto, oto, jz, tz = A.zeroed(*base, seed, target, div)
    for g, jg in zip(oto.node_groups, joto.node_groups):
        np.testing.assert_array_equal(kept_groups(g, tz), jkept(jg, jz))
    jcfg, jp = jsubnet(joto.cfg, jz, joto.node_groups)
    cfg, tp = construct_subnet_vit(oto.cfg, tz, oto.node_groups)
    assert cfg.heads_per_block == jcfg.heads_per_block
    assert cfg.hidden_per_block == jcfg.hidden_per_block
    assert A.trees_equal(jp, tp)
    # the OTO facade: a model of the subnet's config holding the new
    # params' tensors themselves (no fresh weights), which runs on them
    model, tp2 = oto.construct_subnet(tz)
    jmodel, _ = joto.construct_subnet(jz)
    assert isinstance(model, VisionTransformer)
    assert model.cfg == cfg
    assert model.cfg.hidden_per_block == jmodel.cfg.hidden_per_block
    leaves = flatten_tree(tp2)
    for k, v in model.named_parameters():
        assert v.data_ptr() == leaves[k.replace(".", "/")].data_ptr(), k
    assert {b.device.type for b in model.buffers()} == {"cpu"}
    assert A.trees_equal(jp, tp2)
    x = torch.from_numpy(np.random.default_rng(seed).standard_normal(
        (2, 32, 32, 3)).astype(np.float32))
    assert torch.equal(model(x), apply(model, tp2, x))
    # a compressed model compresses again to itself
    oto2 = type(oto)(model, tp2)
    cfg3, tp3 = construct_subnet_vit(cfg, tp2, oto2.node_groups)
    assert cfg3 == cfg and A.trees_equal(jp, tp3)


def test_construct_subnet_uniform_keeps_every_block_alike(base):
    _, oto, _, tz = A.zeroed(*base, 0, 0.5, 2)
    cfg, _ = construct_subnet_vit(oto.cfg, tz, oto.node_groups)
    assert len(set(cfg.heads_per_block)) == 1
    assert len(set(cfg.hidden_per_block)) == 1


@pytest.mark.parametrize("k", [1, 2, 3, 9])
def test_cluster_node_groups_equal(base, k):
    joto, oto = A.otos(*base)
    want = joto.cluster_node_groups(k)
    got = oto.cluster_node_groups(k)
    assert {c: [g.id for g in gs] for c, gs in got.items()} == \
        {c: [g.id for g in gs] for c, gs in want.items()}


def test_visualize_equal(base, tmp_path):
    joto, oto = A.otos(*base)
    path = tmp_path / "groups.dot"
    assert oto.visualize(str(path)) == joto.visualize()
    assert path.read_text() == joto.visualize()


def test_kernel_limits_read_each_block():
    """The latency entry's K5 takes each block's widths: a pruned width
    off its 16-byte rows is refused before any preparation, the block
    named; the other routes take any per-block width."""
    ok = ViTConfig(heads_per_block=(6,) * 12, hidden_per_block=(1536,) * 12)
    assert kernel_limits(ok, latency=True) == []
    odd = dataclasses.replace(ok, hidden_per_block=(1536,) * 11 + (2035,))
    lims = kernel_limits(odd, latency=True)
    assert len(lims) == 1 and lims[0].startswith("block 11: ")
    assert "hidden 2035" in lims[0]
    heads = dataclasses.replace(ok, heads_per_block=(6,) * 11 + (11,))
    assert kernel_limits(heads, latency=True) == []
    assert kernel_limits(odd) == [] and kernel_limits(odd, batch=3) == []


@pytest.fixture(scope="module")
def ultranet():
    _, params, stats, x = U.trained_like(0, batch=2)
    return params, stats, x


@pytest.mark.parametrize("seed,target,div", [(0, None, 1), (2, 0.5, 2)])
def test_construct_subnet_ultranet_equal(ultranet, seed, target, div):
    """The same channels zeroed and kept, the sliced params and batch
    stats bit-equal; the OTO facade's model at the kept widths, whose
    eval forward on the subnet's trees gives the JAX subnet's raw
    predictions within 1e-5 (not the zeroed full net's: DoReFa divides a
    kernel by its max |tanh|, and the sliced in-dim rows of the next conv
    leave that max)."""
    from quantized_vit_tpu.compress import construct_subnet_ultranet as jsub
    from quantized_vit_tpu_torch.compress import construct_subnet_ultranet
    from quantized_vit_tpu_torch.models import UltraNet, ultranet_apply

    params, stats, x = ultranet
    joto, oto, jz, tz = U.zeroed(params, stats, seed, target, div)
    assert U.trees_equal(jz, tz) and not U.trees_equal(params, tz)
    for g, jg in zip(oto.node_groups, joto.node_groups):
        np.testing.assert_array_equal(kept_groups(g, tz), jkept(jg, jz))
    jch, jp, js = jsub(jz, joto.node_groups, joto.batch_stats)
    ch, tp, ts = construct_subnet_ultranet(tz, oto.node_groups,
                                           oto.batch_stats)
    assert ch == jch and min(ch) < 64
    assert U.trees_equal(jp, tp) and U.trees_equal(js, ts)
    model, tp2, ts2 = oto.construct_subnet(tz)
    assert isinstance(model, UltraNet) and model.channels == ch
    assert U.trees_equal(jp, tp2) and U.trees_equal(js, ts2)
    assert U.trees_equal(jp, model.param_tree())
    from quantized_vit_tpu.models import UltraNet as JU

    _, want = jax.jit(JU(channels=jch).apply)(
        {"params": jp, "batch_stats": js}, x)
    with torch.no_grad():
        _, got = ultranet_apply(model, tp2, ts2, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_ultranet_cluster_and_visualize_equal(ultranet):
    params, stats, _ = ultranet
    joto, oto = U.otos(params, stats)
    for k in (1, 2, 3):
        assert {c: [g.id for g in gs] for c, gs in
                oto.cluster_node_groups(k).items()} == {
            c: [g.id for g in gs] for c, gs in
            joto.cluster_node_groups(k).items()}
    assert oto.visualize() == joto.visualize()

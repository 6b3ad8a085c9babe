"""Port parity: generic subnet construction for discovered groups
(``compress/auto.py``) against the JAX package's ``construct_subnet_auto``,
on ``tests/compress/test_auto_subnet.py``'s FunkyNet (conv -> BN -> relu,
a depthwise conv, a residual, a max pool, a flatten into a dense layer):
the plan's in-dim links, the sliced params and BN statistics bit-equal to
the JAX function's on the same zeroed trees, and the compressed forward
within 1e-5 of the zeroed model's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quantized_vit_tpu.graph import OTO as JOTO
from quantized_vit_tpu_torch import models as M
from quantized_vit_tpu_torch.compress import construct_subnet_auto
from quantized_vit_tpu_torch.graph import OTO

from tests import torch_auto_nets as N
from tests.torch_family_params import jax_vars, torch_tree, trees_equal

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def setup():
    """Both OTOs on FunkyNet's JAX init and non-trivial BN statistics (the
    JAX test's draws), and both packages' random zeroing at 0.4."""
    x = np.zeros((2, 8, 8, 3), np.float32)
    jm = N.JFunkyNet()
    params, stats = jax_vars(jm, x)
    rng = np.random.default_rng(1)
    stats = jax.tree.map(
        lambda v: rng.standard_normal(v.shape).astype(np.float32), stats)
    stats["bn1"]["var"] = np.abs(stats["bn1"]["var"]) + 0.5
    joto = JOTO(jm, jax.tree.map(jnp.asarray, params),
                batch_stats=jax.tree.map(jnp.asarray, stats),
                example_input=jnp.asarray(x))
    oto = OTO(N.FunkyNet(), torch_tree(params), batch_stats=torch_tree(stats),
              example_input=torch.from_numpy(x))
    kw = dict(target_group_sparsity=0.4, num_group_divisible=1, seed=7)
    return dict(jm=jm, joto=joto, oto=oto, stats=stats,
                jsparse=joto.random_set_zero_groups(**kw),
                sparse=oto.random_set_zero_groups(**kw))


def test_flatten_link_recorded(setup):
    plan = setup["oto"]._auto_plan
    fc1 = plan["fc1/kernel"]
    # the 4x4 grid (8x8 input, one 2x2 max pool) folds into fc1's features
    assert (fc1.in_group_id, fc1.in_spatial, fc1.in_channels) == ("c3", 16,
                                                                  8)
    assert (plan["c3/kernel"].in_group_id, plan["c3/kernel"].in_spatial) == (
        "c1", 1)
    assert N.plan_rows(plan, port=True) == N.plan_rows(
        setup["joto"]._auto_plan, port=False)


def test_groups_merge_depthwise_and_residual(setup):
    oto = setup["oto"]
    assert N.content(oto.node_groups) == N.content(setup["joto"].node_groups)
    by_kernel = {e.path: g for g in oto.node_groups for e in g.entries}
    assert by_kernel["c1/kernel"] is by_kernel["dw/kernel"]
    assert by_kernel["c1/kernel"] is by_kernel["c2/kernel"]
    assert not by_kernel["head/kernel"].is_prunable


def test_sliced_trees_equal_jax(setup):
    assert trees_equal(setup["jsparse"], setup["sparse"])
    jnew, jshapes, jstats = setup["joto"].construct_subnet(setup["jsparse"])
    new, shapes, new_stats = construct_subnet_auto(
        setup["sparse"], setup["oto"].node_groups, setup["oto"]._auto_plan,
        batch_stats=setup["oto"].batch_stats)
    assert shapes == jshapes
    assert trees_equal(jnew, new)
    assert trees_equal(jstats, new_stats)
    w1, w2, d1 = shapes["c1"][-1], shapes["c3"][-1], shapes["fc1"][-1]
    assert w1 < 8 and w2 < 8 and d1 < 12  # something was pruned
    assert shapes["fc1"][0] == 16 * w2    # the flatten's expansion


def test_compressed_forward_matches_sparse_forward(setup):
    oto = setup["oto"]
    model, new, new_stats = oto.construct_subnet(
        setup["sparse"], model_builder=lambda s: N.FunkyNet(
            w1=s["c1"][-1], w2=s["c3"][-1], d1=s["fc1"][-1], device="meta"))
    model = M.bind_tree(model, new, new_stats)
    xr = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (3, 8, 8, 3)).astype(np.float32))
    with torch.no_grad():
        y_sparse = M.apply_variables(oto.model, setup["sparse"], xr,
                                     batch_stats=oto.batch_stats)
        y_slim = model(xr)
    np.testing.assert_allclose(y_slim.numpy(), y_sparse.numpy(), rtol=1e-5,
                               atol=1e-5)
    # and the JAX package's compressed forward on the same trees
    jnew, jshapes, jstats = setup["joto"].construct_subnet(setup["jsparse"])
    want = N.JFunkyNet(w1=jshapes["c1"][-1], w2=jshapes["c3"][-1],
                       d1=jshapes["fc1"][-1]).apply(
        {"params": jnew, "batch_stats": jstats}, jnp.asarray(xr.numpy()))
    np.testing.assert_allclose(y_slim.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_costs_equal_jax(setup):
    oto, joto = setup["oto"], setup["joto"]
    for name in ("compute_macs", "compute_bops", "compute_num_params",
                 "compute_weight_size", "compute_average_bit_width"):
        assert getattr(oto, name)() == getattr(joto, name)(), name

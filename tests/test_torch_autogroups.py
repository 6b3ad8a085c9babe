"""Port parity: the automatic grouping (``graph/autogroups.py``) against
the JAX package's ``discover_node_groups`` and ``trace_cost_report``,
every case of ``tests/graph/test_autogroups.py``.

Each model runs in both packages on the same weights (the JAX init, numpy
leaves, as torch tensors for the port); the port's groups (ids, entries
in order with their transforms, sizes, prunability), its dataflow edges
and its compression plans must equal the JAX function's, and the trace's
MACs, BOPs and parameter counts its report's. The port traces an aten
graph (``make_fx``), the JAX package a jaxpr, so these hold the two walks
to one partition on the families (UltraNet, MobileNet, ResNet-8/20 float
and LSFQ, the ViT) and on the small nets of ``tests/torch_auto_nets.py``
(CustomNet, the edge net, GrayNet, the late-union net)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quantized_vit_tpu import models as JM
from quantized_vit_tpu.graph import OTO as JOTO
from quantized_vit_tpu.graph import discover_node_groups as jdiscover
from quantized_vit_tpu.graph import trace_cost_report as jcost
from quantized_vit_tpu_torch import models as M
from quantized_vit_tpu_torch.graph import (OTO, discover_node_groups,
                                           mobilenet_node_groups,
                                           resnet_node_groups, trace_apply,
                                           trace_cost_report,
                                           ultranet_node_groups)
from quantized_vit_tpu_torch.opt.groups import Transform, group_sq_norms

from tests import torch_auto_nets as N
from tests.torch_family_params import jax_vars, torch_tree

torch.set_num_threads(1)

X32 = np.zeros((1, 32, 32, 3), np.float32)


def _vit_cfgs(quant: bool):
    kw = dict(img_size=32, patch_size=16, embed_dim=48, depth=1, num_heads=2,
              num_classes=5)
    if quant:
        return (JM.ViTConfig(quant=JM.QuantConfig(enabled=True), **kw),
                M.ViTConfig(quant=M.QuantConfig(enabled=True), **kw))
    return JM.ViTConfig(**kw), M.ViTConfig(**kw)


def _case(name):
    """(JAX model, port model, input, JAX kwargs, port kwargs, BN?, init
    bits or None) of one case."""
    det = {"deterministic": True}
    if name == "ultranet":
        return (JM.UltraNet(), M.UltraNet(device="cpu"),
                np.zeros((1, 32, 64, 3), np.float32), {"train": False},
                {"train": False}, True, None)
    if name == "mobilenet":
        return (JM.mobilenet_small(), M.mobilenet_small(device="cpu"), X32,
                det, det, True, None)
    if name in ("resnet8", "resnet20"):
        j, p = getattr(JM, name)(), getattr(M, name)(device="cpu")
        return j, p, X32, det, det, True, None
    if name == "resnet8_lsfq":
        return (JM.resnet8(quant=JM.QuantConfig(enabled=True)),
                M.resnet8(quant=M.QuantConfig(enabled=True), device="cpu"),
                X32, det, det, True, 8.0)
    if name in ("vit", "vit_lsfq"):
        jc, pc = _vit_cfgs(name == "vit_lsfq")
        return (JM.VisionTransformer(jc), M.VisionTransformer(pc, device="cpu"),
                X32, det, det, False, 8.0 if name == "vit_lsfq" else None)
    if name == "custom":
        return (N.JCustomNet(), N.CustomNet(),
                np.zeros((2, 16, 16, 3), np.float32), {}, {}, False, None)
    if name == "edges":
        return (N.JEdgeNet(), N.EdgeNet(), np.zeros((1, 8, 8, 3), np.float32),
                {}, {}, False, None)
    if name == "late_union":
        return (N.JLateUnionNet(), N.LateUnionNet(),
                np.zeros((2, 4), np.float32), {}, {}, False, None)
    if name == "gray":
        return (N.JGrayNet(), N.GrayNet(),
                np.zeros((1, 16, 16, 1), np.float32), det, det, True, None)
    raise KeyError(name)


def _setup(name):
    """The case's models, the JAX trees (numpy) and the port's (tensors),
    the input: (jm, pm, x, jkw, pkw, jtrees, ptrees)."""
    jm, pm, x, jkw, pkw, bn, bits = _case(name)
    params, stats = jax_vars(jm, x)
    if bits is not None:
        params = jax.tree.map(np.asarray, JM.init_quant_params_tree(
            params, init_bits=bits))
    jtrees = {"batch_stats": stats} if bn else {}
    ptrees = {"batch_stats": torch_tree(stats)} if bn else {}
    return jm, pm, x, jkw, pkw, (params, jtrees), (torch_tree(params),
                                                   ptrees)


@functools.lru_cache(maxsize=None)
def _discover(name):
    jm, pm, x, jkw, pkw, (jp, jt), (pp, pt) = _setup(name)
    want = jdiscover(jm, jp, jnp.asarray(x), model_kwargs=jkw,
                     return_edges=True, return_plan=True, **jt)
    got = discover_node_groups(pm, pp, torch.from_numpy(x),
                               model_kwargs=pkw, return_edges=True,
                               return_plan=True, **pt)
    return want, got, pp  # cached: read, never modified, by the tests


CASES = ["ultranet", "mobilenet", "resnet8", "resnet20", "resnet8_lsfq",
         "vit", "vit_lsfq", "custom", "edges", "late_union", "gray"]


@pytest.mark.parametrize("name", CASES)
def test_discovery_equals_jax(name):
    (jg, je, jplan), (g, e, plan), _ = _discover(name)
    assert N.content(g) == N.content(jg)
    assert e == je
    assert N.plan_rows(plan, port=True) == N.plan_rows(jplan, port=False)


def test_discovery_walks_a_given_trace():
    """``graph=``: a ``trace_apply`` of the same call, walked instead of
    tracing again: the same groups, edges and plan."""
    jm, pm, x, jkw, pkw, (jp, jt), (pp, pt) = _setup("resnet8_lsfq")
    xt = torch.from_numpy(x)
    graph = trace_apply(pm, pp, xt, pt["batch_stats"], pkw)
    assert len(graph.nodes) > 0
    (_, _, _), want, _ = _discover("resnet8_lsfq")
    got = discover_node_groups(pm, pp, xt, model_kwargs=pkw,
                               return_edges=True, return_plan=True,
                               graph=graph, **pt)
    assert N.content(got[0]) == N.content(want[0]) and got[1] == want[1]
    assert N.plan_rows(got[2], True) == N.plan_rows(want[2], True)


@pytest.mark.parametrize("name", ["ultranet", "mobilenet", "resnet8",
                                  "resnet20"])
def test_discovery_matches_declarative(name):
    """As the JAX tests: the discovered partition is the family builder's
    (the groups as sets: ids are naming)."""
    (_, _, _), (g, _, _), pp = _discover(name)
    if name == "ultranet":
        declared = ultranet_node_groups(pp)
    else:
        cfg = _case(name)[1].cfg
        declared = (mobilenet_node_groups if name == "mobilenet"
                    else resnet_node_groups)(cfg, pp)

    def groups_as_sets(groups):
        return {(tuple(sorted((e.path, e.transform.value)
                              for e in gr.entries)),
                 gr.num_groups, gr.is_prunable) for gr in groups}

    assert groups_as_sets(g) == groups_as_sets(declared)


def test_depthwise_merges_into_its_producer():
    (_, _, _), (g, _, _), _ = _discover("mobilenet")
    stem = next(gr for gr in g
                if any(e.path == "stem_conv/kernel" for e in gr.entries))
    assert any(e.path == "dw_0/kernel" for e in stem.entries)


def test_resnet20_streams_merge_all_blocks():
    (_, _, _), (g, _, _), _ = _discover("resnet20")
    stream1 = next(gr for gr in g if any(
        e.path == "stage1_block0/down_conv/kernel" for e in gr.entries))
    assert {e.path for e in stream1.entries if e.path.endswith("kernel")} \
        == {"stage1_block0/conv2/kernel", "stage1_block0/down_conv/kernel",
            "stage1_block1/conv2/kernel", "stage1_block2/conv2/kernel"}


def test_lsfq_quant_scalars_stay_out_of_the_groups():
    (_, _, _), (g, _, _), _ = _discover("resnet8_lsfq")
    for gr in g:
        for e in gr.entries:
            if e.path.rsplit("/", 1)[-1].startswith(("d_quant", "q_m",
                                                     "t_quant")):
                assert e.transform == Transform.NO_PRUNE


@pytest.mark.parametrize("name", ["vit", "vit_lsfq"])
def test_vit_discovery_is_conservative(name):
    (_, _, _), (g, _, _), _ = _discover(name)
    by_kernel = {e.path: gr for gr in g for e in gr.entries}
    for path in ("blocks_0/attn/qkv/kernel", "patch_embed/proj/kernel",
                 "head/kernel"):
        assert not by_kernel[path].is_prunable
    fc1 = by_kernel["blocks_0/mlp/fc1/kernel"]
    assert fc1.is_prunable and fc1.num_groups == 192


@pytest.mark.parametrize("name", ["resnet8_lsfq", "mobilenet", "vit_lsfq",
                                  "custom", "ultranet"])
def test_trace_cost_report_equals_jax(name):
    jm, pm, x, jkw, pkw, (jp, jt), (pp, pt) = _setup(name)
    want = jcost(jm, jp, jnp.asarray(x), model_kwargs=jkw, **jt)
    got = trace_cost_report(pm, pp, torch.from_numpy(x), model_kwargs=pkw,
                            **pt)
    assert got["total_macs"] == want["total_macs"]
    assert got["num_params"] == want["num_params"]
    assert set(got["per_layer"]) == set(want["per_layer"])
    for layer, row in want["per_layer"].items():
        assert got["per_layer"][layer]["macs"] == row["macs"], layer
    # the learned widths: log2 of f32 ratios, an ulp apart at most
    assert got["total_bops"] == pytest.approx(want["total_bops"], rel=1e-6)


def test_discovered_groups_drive_hesso():
    """Discovered groups drive the optimizers: HESSO zeroes whole channel
    groups of a MobileNet with no declarations."""
    from quantized_vit_tpu_torch.opt import HESSO, HESSOConfig

    m = M.mobilenet_small(device="cpu")
    params = M.tree_map(lambda p: p.detach().clone(), m.param_tree())
    stats = m.batch_stats_tree()
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (2, 32, 32, 3)).astype(np.float32))
    groups = discover_node_groups(m, params, x, batch_stats=stats,
                                  model_kwargs={"deterministic": True})
    opt = HESSO(groups, params, HESSOConfig(
        lr=1e-2, target_group_sparsity=0.3, start_pruning_step=2,
        pruning_steps=6, pruning_periods=2))
    p = params
    for _ in range(12):
        leaves = {k: v.detach().requires_grad_()
                  for k, v in M.flatten_tree(p).items()}
        y = M.apply_variables(m, M.unflatten_tree(leaves), x,
                              batch_stats=stats, deterministic=True)
        grads = torch.autograd.grad(torch.mean(y * y), list(leaves.values()))
        p = opt.step(p, M.unflatten_tree(dict(zip(leaves, grads))))
    zeroed = sum(int((group_sq_norms(gr, p) == 0).sum())
                 for gr in groups if gr.is_prunable)
    assert zeroed > 0


def test_oto_auto_discovery_on_custom_model():
    """OTO(model, params, example_input=...) on a model with no family:
    its groups, costs and HESSO as the JAX OTO's, and the compressed
    forward equal to the zeroed model's."""
    jm, pm, x, _, _, (jp, _), (pp, _) = _setup("custom")
    joto = JOTO(jm, jax.tree.map(jnp.asarray, jp), example_input=x)
    oto = OTO(pm, pp, example_input=torch.from_numpy(x))
    assert oto.kind == "auto"
    assert N.content(oto.node_groups) == N.content(joto.node_groups)
    assert oto.group_edges == joto.group_edges
    by_kernel = {e.path: g for g in oto.node_groups for e in g.entries}
    assert by_kernel["c1/kernel"] is by_kernel["c2/kernel"]
    assert by_kernel["d1/kernel"].is_prunable
    assert not by_kernel["out/kernel"].is_prunable
    # c1 16*16*9*3*12 + c2 16*16*9*12*12 + d1 12*24 + out 24*4
    assert oto.compute_macs(pp) == joto.compute_macs(jp) == \
        82944 + 331776 + 288 + 96
    assert oto.compute_num_params(pp) == joto.compute_num_params(jp) == 2056
    assert oto.compute_average_bit_width(pp) == pytest.approx(32.0)
    assert oto.compute_weight_size(pp) == joto.compute_weight_size(jp)

    opt = oto.hesso(lr=1e-2, target_group_sparsity=0.25,
                    start_pruning_step=2, pruning_steps=6,
                    pruning_periods=2)
    xr = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (2, 16, 16, 3)).astype(np.float32))
    p = pp
    for _ in range(10):
        leaves = {k: v.detach().requires_grad_()
                  for k, v in M.flatten_tree(p).items()}
        y = M.apply_variables(pm, M.unflatten_tree(leaves), xr)
        grads = torch.autograd.grad(torch.mean(y * y), list(leaves.values()))
        p = opt.step(p, M.unflatten_tree(dict(zip(leaves, grads))))
    assert sum(int((group_sq_norms(g, p) == 0).sum())
               for g in oto.node_groups if g.is_prunable) > 0

    new_params, shapes = oto.construct_subnet(p)
    rebuilt = M.bind_tree(N.CustomNet(width=shapes["c2"][-1],
                                      hidden=shapes["d1"][-1],
                                      device="meta"), new_params)
    with torch.no_grad():
        y_sparse = M.apply_variables(pm, p, xr)
        y_slim = rebuilt(xr)
    np.testing.assert_allclose(y_slim.numpy(), y_sparse.numpy(), rtol=1e-5,
                               atol=1e-5)


def test_auto_discovery_records_dataflow_edges():
    jm, pm, x, _, _, (jp, _), (pp, _) = _setup("edges")
    oto = OTO(pm, pp, example_input=torch.from_numpy(x))
    assert oto.group_edges == [("a", "b"), ("b", "c")]
    dot = oto.visualize()
    assert '"a" -> "b";' in dot and '"b" -> "c";' in dot
    assert dot == JOTO(jm, jp, example_input=x).visualize()


def test_unprunable_survives_late_union_reroot():
    (_, _, _), (g, _, _), _ = _discover("late_union")
    by_kernel = {e.path: gr for gr in g for e in gr.entries}
    assert by_kernel["c0/kernel"] is by_kernel["c1/kernel"]
    assert not by_kernel["c1/kernel"].is_prunable


def test_one_channel_input_conv_is_not_depthwise():
    (_, _, _), (g, _, _), _ = _discover("gray")
    gr = next(gr for gr in g
              if any(e.path == "c0/kernel" for e in gr.entries))
    assert gr.is_prunable and gr.num_groups == 16
    paths = {e.path for e in gr.entries}
    assert "bn0/scale" in paths and "bn0/bias" in paths


def test_oto_without_family_or_input_raises_jax_error():
    with pytest.raises(ValueError, match="example_input"):
        OTO(torch.nn.Linear(3, 3))
    # a plain module's weights are [out, in] / OIHW, not the flax layout
    # discovery reads: it must come with a params tree
    mlp = torch.nn.Sequential(torch.nn.Linear(3, 8), torch.nn.ReLU(),
                              torch.nn.Linear(8, 4))
    with pytest.raises(ValueError, match="params="):
        OTO(mlp, example_input=torch.zeros(2, 3))
    with pytest.raises(ValueError, match="no stems|stems"):
        discover_node_groups(torch.nn.ReLU(), {}, torch.zeros(2, 3))

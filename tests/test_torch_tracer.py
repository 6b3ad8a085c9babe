"""The port's graph tracer (``graph/tracer.py``): ``make_fx``'s aten graph
of ``models.apply_variables`` with the params tree's paths on its inputs,
the ``a > b > c`` chain search, and ``validate_node_groups`` holding the
ViT's declared groups to the trace, as ``tests/graph/test_tracer.py``
holds the JAX tracer's (the op names are aten's: ``mm`` where the jaxpr
has ``dot_general``, ``convolution`` for ``conv_general_dilated``)."""

import dataclasses

import numpy as np
import pytest
import torch

from quantized_vit_tpu_torch import models as M
from quantized_vit_tpu_torch.graph import vit_node_groups
from quantized_vit_tpu_torch.graph.tracer import (TracedGraph, tree_paths,
                                                  validate_node_groups)
from quantized_vit_tpu_torch.opt.groups import (NodeGroup, ParamEntry,
                                                Transform)

torch.set_num_threads(1)


def _tree(model, bits=8.0):
    params = M.tree_map(lambda p: p.detach().clone(), model.param_tree())
    return M.init_quant_params_tree(params, init_bits=bits)


@pytest.fixture(scope="module")
def vit_trace():
    cfg = M.ViTConfig(img_size=32, patch_size=16, embed_dim=32, depth=2,
                      num_heads=4, mlp_ratio=2.0, num_classes=7,
                      quant=M.QuantConfig(enabled=True))
    m = M.VisionTransformer(cfg, device="cpu")
    p = _tree(m)
    g = TracedGraph.trace(
        lambda pp, xx: M.apply_variables(m, pp, xx, deterministic=True),
        p, torch.zeros(1, 32, 32, 3), params=p)
    return cfg, p, g


def test_trace_captures_program(vit_trace):
    _, p, g = vit_trace
    ops = set(g.ops())
    # the dense products (the patch embed is the space-to-depth GEMM) and
    # the softmax
    assert {"mm", "bmm", "_softmax"} <= ops
    used = g.params_used()
    assert "patch_embed/proj/kernel" in used
    assert any(u.startswith("blocks_0/attn/qkv") for u in used)
    assert set(used) <= set(M.flatten_tree(p))
    # every node carries its output shape; the logits are the output
    assert all(n.shape is not None for n in g.nodes if n.op == "mm")
    assert [g.by_id[i].shape for i in g.output_ids] == [(1, 7)]


def test_conv_model_traces_convolution():
    """An overlapping conv traces as ``convolution`` on NCHW, its kernel
    through a permute of the HWIO leaf; groups and stride recorded."""
    m = M.QuantConv(3, 8, (3, 3), strides=(2, 2),
                    config=M.QuantConfig(enabled=True), device="cpu")
    p = M.init_quant_params_tree({k: v.detach().clone() for k, v in
                                  m.named_parameters()}, 8.0)
    g = TracedGraph.trace(lambda pp, xx: torch.func.functional_call(
        m, pp, (xx,)), p, torch.zeros(1, 8, 8, 3), params=p)
    conv = [n for n in g.nodes if n.op == "convolution"]
    assert len(conv) == 1 and conv[0].shape == (1, 8, 4, 4)
    assert conv[0].attrs["groups"] == 1 and conv[0].attrs["stride"] == (2, 2)
    assert len(g.search("convolution > *")) >= 1
    assert [n.attrs["dims"] for n in g.nodes if n.op == "permute"] == [
        (0, 3, 1, 2), (3, 2, 0, 1), (0, 2, 3, 1)]
    # the kernel reaches the conv through the quantizer and the permute
    assert "kernel" in g.params_used()


def test_search_chains(vit_trace):
    _, _, g = vit_trace
    assert len(g.search("exp > div")) > 0        # the quantizer's pow
    assert len(g.search("mm > _unsafe_view > add")) > 0  # dense + bias
    assert len(g.search("mm > *")) >= 1
    assert g.search("_softmax > convolution") == []


def test_search_simple_fn():
    g = TracedGraph.trace(lambda a, b: torch.tanh(a @ b).sum(),
                          torch.ones(3, 4), torch.ones(4, 5))
    chains = g.search("mm > tanh > sum")
    assert len(chains) == 1
    assert [n.op for n in chains[0]] == ["mm", "tanh", "sum"]
    assert g.params_used() == []
    assert g.nodes[0].arg_ids == ("<arg>", "<arg>")


def test_placeholders_follow_pytree_order():
    """Labels follow ``torch.utils._pytree``'s flattening of the tree (a
    dict in its insertion order), whatever the tree's key order."""
    tree = {"w": torch.ones(4, 2), "a": {"z": torch.ones(2), "b":
                                         torch.full((2,), 2.0)}}
    assert tree_paths(tree) == ["w", "a/z", "a/b"]
    g = TracedGraph.trace(lambda t, x: (x @ t["w"]) * t["a"]["b"]
                          + t["a"]["z"], tree, torch.ones(3, 4), params=tree)
    mm = next(n for n in g.nodes if n.op == "mm")
    assert mm.arg_ids == ("<arg>", "w") and mm.param_names == ("w",)
    mul = next(n for n in g.nodes if n.op == "mul")
    assert "a/b" in mul.param_names
    add = next(n for n in g.nodes if n.op == "add")
    assert "a/z" in add.param_names


def test_tuple_outputs_trace_as_getitem():
    """``F.max_pool2d`` traces as ``max_pool2d_with_indices`` and a
    ``getitem`` of its values; the node's shape is its first output's."""
    from quantized_vit_tpu_torch.models.ultranet import max_pool_2x2

    g = TracedGraph.trace(max_pool_2x2, torch.zeros(1, 4, 6, 3))
    pool = next(n for n in g.nodes if n.op == "max_pool2d_with_indices")
    assert pool.shape == (1, 3, 2, 3)
    assert len(g.search("max_pool2d_with_indices > getitem > permute")) == 1


def test_validate_node_groups_consistent(vit_trace):
    cfg, p, g = vit_trace
    rep = validate_node_groups(g, vit_node_groups(cfg, p), p)
    assert rep == {"missing": [], "uncovered": []}


def test_validate_detects_missing_and_uncovered(vit_trace):
    cfg, p, g = vit_trace
    groups = [gr for gr in vit_node_groups(cfg, p) if gr.id != "head"]
    rep = validate_node_groups(g, groups, p)
    assert "head/kernel" in rep["uncovered"]
    groups.append(NodeGroup(id="bogus", entries=[
        ParamEntry("nope/kernel", Transform.OUT)], num_groups=4))
    rep = validate_node_groups(g, groups, p)
    assert "nope/kernel" in rep["missing"]


def test_ops_match_the_jax_trace_per_layer_kind(vit_trace):
    """The JAX trace of the same ViT holds one dot_general per dense
    product the port traces as ``mm`` (the attention's two einsums are
    ``bmm`` here): the counts of products agree."""
    import flax
    import jax
    import jax.numpy as jnp

    from quantized_vit_tpu import models as JM
    from quantized_vit_tpu.graph.tracer import TracedGraph as JTracedGraph

    cfg, _, g = vit_trace
    jcfg = JM.ViTConfig(**{f.name: getattr(cfg, f.name)
                           for f in dataclasses.fields(cfg)
                           if f.name != "quant"},
                        quant=JM.QuantConfig(enabled=True))
    jm = JM.VisionTransformer(jcfg)
    x = jnp.zeros((1, 32, 32, 3), jnp.float32)
    jp = JM.init_quant_params_tree(flax.core.unfreeze(
        jm.init(jax.random.PRNGKey(0), x)["params"]), 8.0)
    jg = JTracedGraph.trace(
        lambda pp, xx: jm.apply({"params": pp}, xx, deterministic=True),
        jp, x, params=jp)
    assert jg.ops().count("dot_general") == (g.ops().count("mm")
                                             + g.ops().count("bmm"))
    assert sorted(jg.params_used()) == sorted(g.params_used())
    assert np.prod(g.by_id[g.output_ids[0]].shape) == 7

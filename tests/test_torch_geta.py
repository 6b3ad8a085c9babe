"""Port parity: node groups (``graph/builders.py``), group-space transforms
(``opt/groups.py``), importance scores (``opt/importance.py``) and the
GETA optimizer (``opt/geta.py``, through ``graph/oto.py``) against the JAX
package, on the tiny quantized ViT of ``tests/opt/test_geta.py``.

The GETA run feeds both optimizers the same gradients (JAX's, at JAX's
params, every step), so what is compared is the optimizer alone: the
redundant-group sets chosen at every pruning boundary must be equal, the
bit ramp-down and the frozen bit layout equal, and every param within 1e-5
of its leaf's largest magnitude (f32 update arithmetic in another order,
over 16 steps).
"""

import numpy as np
import pytest
import torch

import flax
import jax
import jax.numpy as jnp

from quantized_vit_tpu.graph import OTO as JOTO
from quantized_vit_tpu.graph.builders import vit_node_groups as jgroups
from quantized_vit_tpu.models import QuantConfig as JQ
from quantized_vit_tpu.models import ViTConfig as JC
from quantized_vit_tpu.models import VisionTransformer as JV
from quantized_vit_tpu.models import init_quant_params_tree as jinit
from quantized_vit_tpu.opt import groups as jg
from quantized_vit_tpu.opt.importance import \
    combine_importance_scores as jscores
from quantized_vit_tpu_torch.graph import OTO, mark_unprunable, \
    vit_node_groups
from quantized_vit_tpu_torch.models import (QuantConfig, ViTConfig,
                                            VisionTransformer,
                                            flatten_tree, params_from_jax,
                                            unflatten_tree)
from quantized_vit_tpu_torch.opt import groups as tg
from quantized_vit_tpu_torch.opt.importance import combine_importance_scores

torch.set_num_threads(1)

TINY = dict(img_size=32, patch_size=16, embed_dim=32, depth=2, num_heads=2,
            mlp_ratio=2.0, num_classes=10)
UNPRUNABLE = ["patch_embed", "pos_embed", "cls_token", "head"]


def _jax_tiny():
    model = JV(JC(**TINY, quant=JQ(enabled=True)))
    x = jnp.asarray(np.random.default_rng(0).standard_normal(
        (2, 32, 32, 3)), jnp.float32)
    params = flax.core.unfreeze(jax.jit(model.init)(
        jax.random.PRNGKey(0), x)["params"])
    return model, jinit(params, init_bits=8.0), x


def _torch_tree(jtree):
    return unflatten_tree({k: torch.from_numpy(np.array(v)) for k, v in
                           flatten_tree(jax.tree.map(np.asarray,
                                                     jtree)).items()})


def _port_model(jparams):
    return params_from_jax(jax.tree.map(np.asarray, jparams),
                           ViTConfig(**TINY, quant=QuantConfig()),
                           device="cpu")


def _summary(groups):
    return [(g.id, [(e.path, e.transform.value) for e in g.entries],
             g.num_groups, g.num_heads, g.is_prunable) for g in groups]


def test_vit_node_groups_equal_jax():
    _, jparams, _ = _jax_tiny()
    tparams = _torch_tree(jparams)
    want = jgroups(JC(**TINY, quant=JQ()), jparams,
                   unprunable_extra=["blocks_1/mlp"])
    got = vit_node_groups(ViTConfig(**TINY), tparams,
                          unprunable_extra=["blocks_1/mlp"])
    assert _summary(got) == _summary(want)
    assert len(got) == 2 + 2 * TINY["depth"]
    from quantized_vit_tpu.graph.builders import mark_unprunable as jmark
    assert (_summary(mark_unprunable(got, ["blocks_0/attn"]))
            == _summary(jmark(want, ["blocks_0/attn"])))


@pytest.mark.parametrize("tf", ["out", "in", "accessory", "qkv_heads",
                                "heads", "no_prune"])
def test_group_transforms_equal_jax(tf):
    rng = np.random.default_rng(1)
    shapes = {"out": (6, 5, 8), "in": (8, 12), "accessory": (8,),
              "qkv_heads": (10, 3 * 4 * 3), "heads": (10, 4 * 3),
              "no_prune": (1,)}
    groups = {"out": 8, "in": 4, "accessory": 8, "qkv_heads": 4,
              "heads": 4, "no_prune": 1}
    p = rng.standard_normal(shapes[tf]).astype(np.float32)
    n = groups[tf]
    jt, tt = jg.Transform(tf), tg.Transform(tf)
    want = jg.group_matrix(jnp.asarray(p), jt, n, n)
    got = tg.group_matrix(torch.from_numpy(p), tt, n, n)
    if want is None:
        assert got is None
        return
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    mask = (rng.random(n) < 0.5).astype(np.float32)
    np.testing.assert_array_equal(
        tg.group_mask_for_param(torch.from_numpy(mask), tt, p.shape,
                                n).numpy(),
        np.asarray(jg.group_mask_for_param(jnp.asarray(mask), jt, p.shape,
                                           n)))
    if tf in ("qkv_heads", "heads") and p.ndim == 1:
        return
    axis = p.shape[-1] if tf in ("out", "qkv_heads", "heads") else p.shape[0]
    kept = np.flatnonzero(mask)
    np.testing.assert_array_equal(
        tg.kept_indices_for_axis(kept, tt, axis, n, n),
        jg.kept_indices_for_axis(kept, jt, axis, n, n))


def test_importance_scores_equal_jax():
    _, jparams, _ = _jax_tiny()
    rng = np.random.default_rng(2)
    jgv = jax.tree.map(lambda a: jnp.asarray(
        rng.standard_normal(a.shape).astype(np.float32) * 1e-2), jparams)
    want_s, want_gl = jscores(jgroups(JC(**TINY), jparams), jparams, jgv)
    tparams, tgv = _torch_tree(jparams), _torch_tree(jgv)
    got_s, got_gl = combine_importance_scores(
        vit_node_groups(ViTConfig(**TINY), tparams), tparams, tgv)
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), rtol=1e-5)
    for a, b in zip(got_gl, want_gl):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5)


@pytest.mark.parametrize("variant", ["sgd", "adam"])
def test_geta_four_phases_match_jax(variant):
    """warmup (steps 1-2), range projection with a bit ramp-down, two
    pruning periods, fix: the same groups chosen, params within 1e-5."""
    jmodel, jparams, x = _jax_tiny()
    y = jnp.array([1, 2])
    kw = dict(lr=5e-2 if variant == "sgd" else 1e-3, lr_quant=1e-3,
              variant=variant, target_group_sparsity=0.3,
              start_projection_step=2, projection_steps=4,
              projection_periods=2, start_pruning_step=6, pruning_steps=6,
              pruning_periods=2, bit_reduction=2.0, min_bit_wt=4.0,
              max_bit_wt=8.0, min_bit_act=4.0, max_bit_act=8.0)
    joto = JOTO(jmodel, jparams)
    joto.mark_unprunable_by_param_names(UNPRUNABLE)
    jopt = joto.geta(**kw)
    model = _port_model(jparams)
    tparams = _torch_tree(jparams)
    oto = OTO(model, tparams)
    oto.mark_unprunable_by_param_names(UNPRUNABLE)
    opt = oto.geta(**kw)
    assert opt.total_num_groups == jopt.total_num_groups
    assert opt.target_num_redundant_groups == \
        jopt.target_num_redundant_groups

    def loss(p):
        logits = jmodel.apply({"params": p}, x, deterministic=True)
        return -jnp.mean(jnp.sum(jax.nn.log_softmax(logits)
                                 * jax.nn.one_hot(y, 10), -1))

    grad_fn = jax.jit(jax.grad(loss))
    for step in range(16):
        g = grad_fn(jparams)
        tgr = _torch_tree(g)
        jparams = jopt.step(jparams, jopt.clip_grads(g))
        tparams = opt.step(tparams, opt.clip_grads(tgr))
        assert opt.pruned_group_idxes == jopt.pruned_group_idxes, step
        assert opt.state == jopt.state, step
        assert opt.max_bit_wt == jopt.max_bit_wt
    assert opt.bit_layers and opt.bit_layers == jopt.bit_layers
    assert opt.pruned_group_idxes  # two periods pruned something
    want = flatten_tree(jax.tree.map(np.asarray, jparams))
    got = flatten_tree(tparams)
    for k, w in want.items():
        err = np.abs(got[k].numpy() - w).max()
        assert err <= 1e-5 * np.abs(w).max() + 1e-12, (k, err)
    m, jm = opt.compute_metrics(tparams), jopt.compute_metrics(jparams)
    assert m["num_zero_groups"] == jm["num_zero_groups"] == \
        opt.target_num_redundant_groups
    assert opt.bitwidth_dict(tparams) == jopt.bitwidth_dict(jparams)
    assert set(opt.gl_scales) == set(jopt.gl_scales)
    for k, v in jopt.gl_scales.items():
        np.testing.assert_allclose(opt.gl_scales[k], v, rtol=1e-4)


def test_oto_names_the_roadmap_item_for_other_families():
    with pytest.raises(NotImplementedError,
                       match="ROADMAP.md.*'Other model families"):
        OTO(torch.nn.Linear(3, 3))
    model = VisionTransformer(ViTConfig(**TINY, quant=QuantConfig()),
                              device="cpu")
    oto = OTO(model)  # defaults to the model's own params tree
    assert set(flatten_tree(oto.params)) == set(model.params_by_path())
    assert [g.id for g in oto.node_groups][:2] == ["residual_stream",
                                                   "blocks_0/attn"]

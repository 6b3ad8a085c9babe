"""Port parity: the LoRA adapters (``models/lora.py``: ``LoraDense``,
``LoraEmbedding``, ``merge_lora``, ``lora_grad_mask``) and their place in
the pruning graph (``graph/builders.py``'s LoRA entries, the ``lora_a @
lora_b`` importance proxy, HESSO and GETA pruning ``lora_b`` with its base)
against the JAX package on the CPU, the JAX layers' weights carried across
by ``params_from_jax``.

Tolerances: forwards within rtol 1e-5, atol 1e-6 (f32 products in
another order); a merge within the same of JAX's merged weights;
importance scores within rtol 1e-5; masks, entries and the pruned columns
exact. Each of the JAX package's ``tests/models/test_lora.py`` tests and
``tests/opt/test_geta.py::test_lora_no_prune_entries_keep_training_during_pruning``
has its case here."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quantized_vit_tpu.graph.builders import lora_embedding_entries as jemb
from quantized_vit_tpu.graph.builders import lora_layer_entries as jdense
from quantized_vit_tpu.models import LoraDense as JLoraDense
from quantized_vit_tpu.models import LoraEmbedding as JLoraEmbedding
from quantized_vit_tpu.models import lora_grad_mask as jmask
from quantized_vit_tpu.models import merge_lora as jmerge
from quantized_vit_tpu.opt import HESSO as JHESSO
from quantized_vit_tpu.opt import HESSOConfig as JHESSOConfig
from quantized_vit_tpu.opt import NodeGroup as JNodeGroup
from quantized_vit_tpu.opt.importance import \
    combine_importance_scores as jscores
from quantized_vit_tpu_torch.graph import (lora_embedding_entries,
                                           lora_layer_entries)
from quantized_vit_tpu_torch.models import (LoraDense, LoraEmbedding,
                                            flatten_tree, lora_grad_mask,
                                            lora_params_from_jax, merge_lora,
                                            tree_map)
from quantized_vit_tpu_torch.opt import (GETA, HESSO, GETAConfig,
                                         HESSOConfig, NodeGroup,
                                         combine_importance_scores)

from tests import torch_family_params as F

torch.set_num_threads(1)


def _dense(rank=4, features=12, in_dim=6, seed=0, trained=True):
    """(JAX layer, params with random adapters, x, port layer)."""
    jm = JLoraDense(features=features, rank=rank, alpha=8.0)
    x = np.random.default_rng(seed).standard_normal((3, in_dim)).astype(
        np.float32)
    params, _ = F.jax_vars(jm, x)
    if trained:
        rng = np.random.default_rng(seed + 1)
        for k in ("lora_a", "lora_b"):
            params[k] = (rng.standard_normal(params[k].shape) * 0.1).astype(
                np.float32)
    return jm, params, x, lora_params_from_jax(params, alpha=8.0,
                                               device="cpu")


def _emb(vocab=10, features=12, rank=4, seed=0, trained=True):
    jm = JLoraEmbedding(num_embeddings=vocab, features=features, rank=rank,
                        alpha=8.0)
    ids = np.random.default_rng(seed).integers(0, vocab, (3, 5)).astype(
        np.int32)
    params, _ = F.jax_vars(jm, ids)
    if trained:
        rng = np.random.default_rng(seed + 1)
        params["lora_a"] = (rng.standard_normal(params["lora_a"].shape)
                            * 0.1).astype(np.float32)
    return jm, params, ids, lora_params_from_jax(params, alpha=8.0,
                                                 device="cpu")


def _run(layer, inp):
    with torch.no_grad():
        return layer(torch.from_numpy(inp)).numpy()


@pytest.mark.parametrize("trained", [False, True], ids=["init", "trained"])
@pytest.mark.parametrize("kind", ["dense", "embedding"])
def test_forward_matches_jax(kind, trained):
    jm, params, inp, layer = (_dense if kind == "dense" else _emb)(
        trained=trained)
    assert isinstance(layer, LoraDense if kind == "dense" else LoraEmbedding)
    assert F.trees_equal(params, layer.param_tree())
    assert layer.scaling == jm.scaling == 2.0
    np.testing.assert_allclose(_run(layer, inp), np.asarray(
        jm.apply({"params": params}, inp)), rtol=1e-5, atol=1e-6)


def test_lora_zero_init_is_identity_with_base():
    _, params, x, layer = _dense(trained=False)
    base = x @ params["kernel"] + params["bias"]
    np.testing.assert_allclose(_run(layer, x), base, rtol=1e-6)
    # the port's own initializers: lora_b zero, so the base
    fresh = LoraDense(6, 12, rank=4, device="cpu")
    assert not fresh.lora_b.any()
    xt = torch.from_numpy(x)
    with torch.no_grad():
        np.testing.assert_allclose(fresh(xt).numpy(), (
            xt @ fresh.kernel + fresh.bias).numpy(), rtol=1e-6)


def test_lora_embedding_zero_init_is_identity_with_base():
    _, params, ids, layer = _emb(trained=False)
    np.testing.assert_allclose(_run(layer, ids), params["embedding"][ids],
                               rtol=1e-6)
    fresh = LoraEmbedding(10, 12, rank=4, device="cpu")
    assert not fresh.lora_a.any()


@pytest.mark.parametrize("kind", ["dense", "embedding"])
def test_merge_lora_is_lossless_and_matches_jax(kind):
    jm, params, inp, layer = (_dense if kind == "dense" else _emb)()
    y_adapted = _run(layer, inp)
    merged = merge_lora({"layer": layer.param_tree()},
                        default_scaling=layer.scaling)["layer"]
    assert "lora_a" not in merged and "lora_b" not in merged
    jmerged = jmerge({"layer": params}, default_scaling=jm.scaling)["layer"]
    for k, v in jmerged.items():
        np.testing.assert_allclose(merged[k].detach().numpy(), v, rtol=1e-5,
                                   atol=1e-6)
    with torch.no_grad():
        if kind == "dense":
            y = torch.from_numpy(inp) @ merged["kernel"] + merged["bias"]
        else:
            y = merged["embedding"][torch.from_numpy(inp)]
    np.testing.assert_allclose(y.numpy(), y_adapted, rtol=1e-5, atol=1e-6)
    # scaling by path
    by_path = merge_lora({"a": {"b": layer.param_tree()}},
                         scaling_by_path={"a/b": 0.0})["a"]["b"]
    base = "kernel" if kind == "dense" else "embedding"
    assert torch.equal(by_path[base], layer.param_tree()[base])


def test_lora_grad_mask_marks_only_adapters():
    _, params, _, layer = _dense()
    tree = {"layer": layer.param_tree(),
            "other": {"kernel": layer.kernel}}
    mask = lora_grad_mask(tree)
    assert mask == jmask({"layer": params,
                          "other": {"kernel": params["kernel"]}})
    assert mask["layer"]["lora_a"] is True
    assert mask["layer"]["lora_b"] is True
    assert mask["layer"]["kernel"] is False
    assert mask["layer"]["bias"] is False
    assert mask["other"]["kernel"] is False
    # the caller masks gradients or sets requires_grad with it
    flat = flatten_tree(mask)
    for k, p in flatten_tree(tree).items():
        p.requires_grad_(flat[k])
    assert [k for k, p in layer.named_parameters() if p.requires_grad] == [
        "lora_a", "lora_b"]


def _raw_proxy_scores(params, base_key):
    ba = params["lora_a"] @ params["lora_b"]
    raw = np.abs((params[base_key] * ba).sum(axis=0))
    return raw / (np.sqrt((raw ** 2).sum() + 1e-8) + 1e-8)


@pytest.mark.parametrize("kind", ["dense", "embedding"])
def test_lora_importance_uses_ba_proxy(kind):
    """With a frozen base (zero gradients everywhere) taylor saliency
    comes from ``lora_a @ lora_b`` against the base weight, as JAX's."""
    jm, params, _, layer = (_dense if kind == "dense" else _emb)()
    entries, jentries = ((lora_layer_entries, jdense) if kind == "dense"
                         else (lora_embedding_entries, jemb))
    tree, jtree = {"layer": layer.param_tree()}, {"layer": params}
    assert [(e.path, e.transform.value) for e in entries(tree, "layer")] \
        == [(e.path, e.transform.value) for e in jentries(jtree, "layer")]
    n = params["lora_b"].shape[-1]
    g = NodeGroup(id="layer", entries=entries(tree, "layer"), num_groups=n)
    jg = JNodeGroup(id="layer", entries=jentries(jtree, "layer"),
                    num_groups=n)
    scores, _ = combine_importance_scores(
        [g], tree, tree_map(torch.zeros_like, tree),
        {"taylor_first_order": 1.0})
    jsc, _ = jscores([jg], jax.tree.map(jnp.asarray, jtree),
                     jax.tree.map(jnp.zeros_like, jtree),
                     {"taylor_first_order": 1.0})
    scores = scores.detach().numpy()
    assert np.isfinite(scores).all() and scores.std() > 0
    np.testing.assert_allclose(scores, np.asarray(jsc), rtol=1e-5,
                               atol=1e-7)
    base = "kernel" if kind == "dense" else "embedding"
    np.testing.assert_allclose(scores, _raw_proxy_scores(params, base),
                               rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("kind", ["dense", "embedding"])
def test_hesso_prunes_lora_with_base(kind):
    """HESSO at lr 0 on zero gradients: 2 of 8 columns of the base and
    lora_b go to zero together, the same columns as JAX's; lora_a
    (NO_PRUNE) is untouched."""
    jm, params, _, layer = (_dense(features=8) if kind == "dense"
                            else _emb(features=8))
    if kind == "dense":
        rng = np.random.default_rng(3)
        params["lora_b"] = (rng.standard_normal(params["lora_b"].shape)
                            * 0.1).astype(np.float32)
        layer = lora_params_from_jax(params, alpha=8.0, device="cpu")
    entries, jentries = ((lora_layer_entries, jdense) if kind == "dense"
                         else (lora_embedding_entries, jemb))
    tree, jtree = F.torch_tree({"layer": params}), {"layer": params}
    kw = dict(lr=0.0, target_group_sparsity=0.25, start_pruning_step=1,
              pruning_steps=6, pruning_periods=1)
    opt = HESSO([NodeGroup(id="layer", entries=entries(tree, "layer"),
                           num_groups=8)], tree, HESSOConfig(**kw))
    jopt = JHESSO([JNodeGroup(id="layer", entries=jentries(jtree, "layer"),
                              num_groups=8)], jtree, JHESSOConfig(**kw))
    p, jp = tree, jax.tree.map(jnp.asarray, jtree)
    for _ in range(8):
        p = opt.step(p, tree_map(torch.zeros_like, p))
        jp = jopt.step(jp, jax.tree.map(jnp.zeros_like, jp))
    base = "kernel" if kind == "dense" else "embedding"
    k = p["layer"][base].numpy()
    zero_cols = np.abs(k).sum(axis=0) == 0
    assert zero_cols.sum() == 2
    np.testing.assert_array_equal(
        zero_cols, np.abs(np.asarray(jp["layer"][base])).sum(axis=0) == 0)
    assert (np.abs(p["layer"]["lora_b"].numpy()).sum(axis=0)[zero_cols]
            == 0).all()
    np.testing.assert_array_equal(p["layer"]["lora_a"].numpy(),
                                  params["lora_a"])


def test_lora_no_prune_entries_keep_training_during_pruning():
    """lora_a (NO_PRUNE, not a quantizer scalar) keeps its plain descent
    in GETA's pruning steps, as the JAX optimizer's."""
    jm = JLoraDense(features=8, rank=2, alpha=4.0)
    x = np.random.default_rng(0).standard_normal((3, 6)).astype(np.float32)
    params, _ = F.jax_vars(jm, x)
    params["lora_a"] = (np.random.default_rng(1).standard_normal(
        params["lora_a"].shape) * 0.1).astype(np.float32)
    tree = F.torch_tree({"layer": params})
    g = NodeGroup(id="layer", entries=lora_layer_entries(tree, "layer"),
                  num_groups=8)
    opt = GETA([g], tree, GETAConfig(
        lr=1e-2, lr_quant=1e-3, target_group_sparsity=0.25,
        start_projection_step=100, projection_steps=10,
        projection_periods=1, start_pruning_step=1, pruning_steps=6,
        pruning_periods=1))
    p = tree
    before = p["layer"]["lora_a"].clone()
    for _ in range(4):
        p = opt.step(p, tree_map(torch.ones_like, p))
    assert not torch.equal(before, p["layer"]["lora_a"])

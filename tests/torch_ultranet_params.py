"""Shared inputs of the port's UltraNet tests: the JAX package's UltraNet
at a seed with BN parameters and running statistics drawn from numpy as
``tests/artifact/test_model_artifacts.py:_trained_like_ultranet`` draws
them (a trained model's small statistics), the same trees as torch CPU
tensors, and both packages' OTOs on them. Input 32 x 64, as the JAX
tests run it."""

import flax
import jax
import jax.numpy as jnp
import numpy as np
import torch

from quantized_vit_tpu.graph import OTO as JOTO
from quantized_vit_tpu.models import ULTRANET_LAYERS
from quantized_vit_tpu.models import UltraNet as JUltraNet
from quantized_vit_tpu_torch.graph import OTO
from quantized_vit_tpu_torch.models import (flatten_tree, unflatten_tree,
                                            ultranet_params_from_jax)

HW = (32, 64)
TIE = 1e-5


def trained_like(seed: int = 0, batch: int = 2):
    """(JAX model, params, batch_stats, x): numpy trees and an NHWC f32
    image batch in [0, 1)."""
    model = JUltraNet()
    rng = np.random.default_rng(seed)
    x = rng.random((batch, *HW, 3)).astype(np.float32)
    variables = jax.jit(model.init)(jax.random.PRNGKey(seed),
                                    jnp.asarray(x[:1]))
    params = jax.tree.map(np.asarray, flax.core.unfreeze(
        variables["params"]))
    stats = jax.tree.map(np.asarray, flax.core.unfreeze(
        variables["batch_stats"]))
    for i in range(len(ULTRANET_LAYERS)):
        feat = params[f"conv_{i}"]["kernel"].shape[-1]
        stats[f"bn_{i}"]["mean"] = rng.normal(0, 0.05, feat).astype(
            np.float32)
        stats[f"bn_{i}"]["var"] = rng.uniform(0.5, 1.5, feat).astype(
            np.float32)
        params[f"bn_{i}"]["scale"] = rng.uniform(0.5, 1.5, feat).astype(
            np.float32)
        params[f"bn_{i}"]["bias"] = rng.normal(0, 0.1, feat).astype(
            np.float32)
    return model, params, stats, x


def torch_tree(tree):
    """A numpy (or JAX) tree as torch CPU tensors, the same bytes."""
    return unflatten_tree({k: torch.from_numpy(np.array(v)) for k, v in
                           flatten_tree(jax.tree.map(np.asarray,
                                                     tree)).items()})


def numpy_tree(tree):
    return unflatten_tree({k: v.detach().cpu().numpy() if isinstance(
        v, torch.Tensor) else np.asarray(v)
        for k, v in flatten_tree(tree).items()})


def port_model(params, stats):
    return ultranet_params_from_jax(params, stats, device="cpu")


def otos(params, stats):
    """(JAX OTO, port OTO) on the same trees."""
    joto = JOTO(JUltraNet(), jax.tree.map(jnp.asarray, params),
                batch_stats=jax.tree.map(jnp.asarray, stats))
    oto = OTO(port_model(params, stats), torch_tree(params),
              batch_stats=torch_tree(stats))
    return joto, oto


def zeroed(params, stats, seed: int, target=None, divisible: int = 1):
    """Both packages' ``random_set_zero_groups``: (JAX OTO, port OTO, JAX
    zeroed tree, port zeroed tree)."""
    joto, oto = otos(params, stats)
    jz = joto.random_set_zero_groups(target_group_sparsity=target,
                                     num_group_divisible=divisible,
                                     seed=seed)
    tz = oto.random_set_zero_groups(target_group_sparsity=target,
                                    num_group_divisible=divisible,
                                    seed=seed)
    return joto, oto, jz, tz


def trees_equal(a, b) -> bool:
    fa = flatten_tree(numpy_tree(jax.tree.map(np.asarray, a)))
    fb = flatten_tree(numpy_tree(b))
    return set(fa) == set(fb) and all(
        fa[k].shape == fb[k].shape and fa[k].dtype == fb[k].dtype
        and np.array_equal(fa[k], fb[k]) for k in fa)


def held_at_ties(got, want, pre, what=""):
    """Integer levels ``got`` (JAX) equal ``want`` (the port) except where
    ``pre`` (the port's value before rounding, in levels) lies within
    :data:`TIE` of a half-integer, where they may differ by one.
    Returns the number of positions that differ."""
    got = np.asarray(got).astype(np.int64)
    want = np.asarray(want).astype(np.int64)
    pre = np.asarray(pre, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    frac = pre - np.floor(pre)
    tie = np.abs(frac - 0.5) < TIE
    d = np.abs(got - want)
    assert d.max(initial=0) <= 1, f"{what}: max level diff {d.max()}"
    off = (d > 0) & ~tie
    assert not off.any(), (
        f"{what}: {off.sum()} positions differ off a tie; pre there "
        f"{pre[off][:4]}, jax {got[off][:4]}, port {want[off][:4]}")
    return int((d > 0).sum())


def pruned_tables(tables, layer: int = 2, drop=(0, 5)):
    """An integer tree with output channels ``drop`` of conv ``layer``
    removed (and the next conv's matching inputs): what the export of a
    pruned subnet holds."""
    keep = np.setdiff1d(np.arange(tables[f"conv_{layer}_inc"].shape[0]),
                        drop)
    out = dict(tables)
    out[f"conv_{layer}_kernel_int"] = tables[f"conv_{layer}_kernel_int"][
        ..., keep]
    for nm in ("inc", "bias_int"):
        out[f"conv_{layer}_{nm}"] = tables[f"conv_{layer}_{nm}"][keep]
    nxt = f"conv_{layer + 1}_kernel_int"
    out[nxt] = tables[nxt][:, :, keep]
    return out

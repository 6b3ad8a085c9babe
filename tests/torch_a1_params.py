"""Shared inputs of the port's train -> compress -> export tests: the
``vit_tiny_test`` ViT (img 32) of the JAX package with quantizer scalars
set per layer, as a trained model's would be, and the same tree as torch
CPU tensors. Both packages get the same numbers: the JAX params are made
once and handed to the port as numpy arrays."""

import flax
import jax
import jax.numpy as jnp
import numpy as np
import torch

from quantized_vit_tpu.graph import OTO as JOTO
from quantized_vit_tpu.models import QuantConfig as JQ
from quantized_vit_tpu.models import ViTConfig as JC
from quantized_vit_tpu.models import VisionTransformer as JV
from quantized_vit_tpu.models import init_quant_params_tree as jinit
from quantized_vit_tpu_torch.graph import OTO
from quantized_vit_tpu_torch.models import (QuantConfig, ViTConfig,
                                            VisionTransformer, flatten_tree,
                                            unflatten_tree)

# cli/_common.py's vit_tiny_test at img 32
TINY = dict(img_size=32, patch_size=16, embed_dim=64, depth=2, num_heads=2,
            num_classes=10)
UNPRUNABLE = ["patch_embed", "pos_embed", "cls_token", "head"]
# (layer, quantizer, bits, t): the weights at 4 bits but for these; a
# layer above 8 bits (requantized at export), one at 6 (int8 storage), a
# nonlinear weight and a pow activation
BITS = (("head", "wt", 12.0, 1.0), ("head", "act", 10.0, 1.0),
        ("blocks_0/attn/proj", "wt", 6.0, 1.0),
        ("blocks_0/mlp/fc1", "wt", 4.0, 0.93),
        ("blocks_1/mlp/fc1", "act", 4.0, 1.08))


def jax_params(seed: int = 0):
    """(JAX model, params) of the tiny quantized ViT at 4 bits with
    :data:`BITS` applied: d = q_m^t / (2^(bits-1) - 1)."""
    model = JV(JC(**TINY, quant=JQ(enabled=True)))
    x = jnp.zeros((1, 32, 32, 3), jnp.float32)
    params = flax.core.unfreeze(jax.jit(model.init)(
        jax.random.PRNGKey(seed), x)["params"])
    params = jinit(params, init_bits=4.0)
    flat = {k: np.array(v) for k, v in
            flatten_tree(jax.tree.map(np.asarray, params)).items()}
    for layer, kind, bits, t in BITS:
        q_m = flat[f"{layer}/q_m_{kind}"]
        flat[f"{layer}/t_quant_{kind}"] = np.full((1,), t, np.float32)
        flat[f"{layer}/d_quant_{kind}"] = (
            np.abs(q_m) ** t / (2.0 ** (bits - 1.0) - 1.0)).astype(
                np.float32)
    return model, jax.tree.map(jnp.asarray, unflatten_tree(flat))


def torch_tree(jtree):
    """A JAX params tree as torch CPU tensors (the same bytes)."""
    return unflatten_tree({k: torch.from_numpy(np.array(v)) for k, v in
                           flatten_tree(jax.tree.map(np.asarray,
                                                     jtree)).items()})


def otos(jmodel, jparams):
    """(JAX OTO, port OTO) of the same params, UNPRUNABLE marked."""
    joto = JOTO(jmodel, jparams)
    joto.mark_unprunable_by_param_names(UNPRUNABLE)
    model = VisionTransformer(ViTConfig(**TINY, quant=QuantConfig()),
                              device="cpu")
    oto = OTO(model, torch_tree(jparams))
    oto.mark_unprunable_by_param_names(UNPRUNABLE)
    return joto, oto


def trees_equal(a, b) -> bool:
    """Two params trees (JAX and port) with the same paths and bytes."""
    fa = flatten_tree(jax.tree.map(np.asarray, a))
    fb = {k: v.detach().cpu().numpy() for k, v in flatten_tree(b).items()}
    return set(fa) == set(fb) and all(
        fa[k].shape == fb[k].shape and fa[k].dtype == fb[k].dtype
        and np.array_equal(fa[k], fb[k]) for k in fa)


def zeroed(jmodel, jparams, seed: int, target=None, divisible: int = 1):
    """Both packages' ``random_set_zero_groups`` on the same params:
    (JAX OTO, port OTO, JAX zeroed tree, port zeroed tree)."""
    joto, oto = otos(jmodel, jparams)
    jz = joto.random_set_zero_groups(target_group_sparsity=target,
                                     num_group_divisible=divisible,
                                     seed=seed)
    tz = oto.random_set_zero_groups(target_group_sparsity=target,
                                    num_group_divisible=divisible,
                                    seed=seed)
    return joto, oto, jz, tz


def _np(v):
    if v is None:
        return None
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def _same(a, b, ulps: int = 0):
    a, b = _np(a), _np(b)
    if a is None or b is None:
        return a is None and b is None
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if ulps and a.dtype.kind == "f":
        return bool(np.all(np.abs(a.view(np.int32).astype(np.int64)
                                  - b.view(np.int32).astype(np.int64))
                           <= ulps))
    return np.array_equal(a, b)


def artifact_layers(art):
    yield "patch_embed", art["patch_embed"]
    for i, blk in enumerate(art["blocks"]):
        for k in ("qkv", "proj", "fc1", "fc2"):
            yield f"blocks_{i}/{k}", blk[k]
    if "head" in art:
        yield "head", art["head"]


def assert_artifacts_equal(got, want, ulps: int = 0):
    """Two serving artifacts (JAX or port) with the same layers, bytes
    and static fields; ``ulps``: the f32 scales and activation constants
    within that many ulps (a layer requantized to 8 bits takes its step
    from an f32 exp and log, which XLA and PyTorch round apart by an
    ulp where t != 1)."""
    for (name, g), (_, w) in zip(artifact_layers(got), artifact_layers(want)):
        assert (g.fmt, g.top, g.act_pow) == (w.fmt, w.top, w.act_pow), name
        assert isinstance(g.top, int) and isinstance(g.act_pow, bool)
        assert _same(g.w, w.w) and _same(g.bias, w.bias), name
        assert _same(g.scale, w.scale, ulps), (name, "scale")
        assert set(g.act) == set(w.act)
        for k in g.act:
            assert _same(g.act[k], w.act[k], ulps), (name, k)
    for k in ("cls_token", "pos_embed"):
        assert _same(got[k], want[k])
    for k in ("scale", "bias"):
        assert _same(got["norm"][k], want["norm"][k])
        for gb, wb in zip(got["blocks"], want["blocks"]):
            for n in ("norm1", "norm2"):
                assert _same(gb[n][k], wb[n][k])


# a seed whose random sparsity leaves an odd hidden width in some block
# (found by test_torch_subnet.py::test_odd_hidden_seed)
ODD_SEED = 3

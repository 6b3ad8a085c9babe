"""Port parity: the ViT state-dict converters (``interop/torch_import.py``)
against the JAX package's, and ``cli._common.load_params_any`` on a
reference ViT ``.pt``.

The trees are the JAX ViT's init (numpy, PRNGKey(0)): plain, with a
``pre_logits`` layer (a representation size) and quantization-aware (the
six quant scalars a layer, at init bits 8). ``vit_params_to_torch`` gives
the JAX function's dict byte for byte (names, shapes, dtypes, values);
``vit_params_from_torch`` of it gives the tree back exactly, its leaves
tensors on the device asked for."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from quantized_vit_tpu import models as JM
from quantized_vit_tpu.interop import vit_params_to_torch as jto_torch
from quantized_vit_tpu_torch import models as M
from quantized_vit_tpu_torch.cli import _common as common
from quantized_vit_tpu_torch.interop import (normalize_state_dict,
                                             vit_params_from_torch,
                                             vit_params_to_torch)

from tests.torch_family_params import jax_vars, torch_tree

torch.set_num_threads(1)

SMALL = dict(img_size=32, patch_size=16, embed_dim=64, depth=2, num_heads=4,
             num_classes=10)
KINDS = ["plain", "pre_logits", "qat"]


def _jax_tree(kind):
    """(JAX model, params tree as numpy) of one kind."""
    quant = JM.QuantConfig(enabled=kind == "qat")
    rep = 48 if kind == "pre_logits" else None
    m = JM.VisionTransformer(JM.ViTConfig(quant=quant,
                                          representation_size=rep, **SMALL))
    params, _ = jax_vars(m, np.zeros((1, 32, 32, 3), np.float32),
                         deterministic=True)
    if kind == "qat":
        params = jax.tree.map(np.asarray, JM.init_quant_params_tree(
            params, init_bits=8.0))
    return m, params


def _same_dict(got, want):
    assert list(got) == list(want)
    for k, v in want.items():
        assert got[k].shape == v.shape and got[k].dtype == v.dtype, k
        assert np.array_equal(got[k], v), k


@pytest.mark.parametrize("kind", KINDS)
def test_to_torch_equals_jax(kind):
    _, params = _jax_tree(kind)
    want = jto_torch(params)
    _same_dict(vit_params_to_torch(torch_tree(params)), want)
    # numpy leaves convert alike
    _same_dict(vit_params_to_torch(params), want)
    if kind == "qat":
        assert want["blocks.0.attn.qkv.d_quant_wt"].shape == (1,)
    if kind == "pre_logits":
        assert want["pre_logits.fc.weight"].shape == (48, 64)


@pytest.mark.parametrize("kind", KINDS)
def test_round_trip_exact(kind):
    _, params = _jax_tree(kind)
    sd = {k: torch.from_numpy(np.array(v))
          for k, v in jto_torch(params).items()}
    back = M.flatten_tree(vit_params_from_torch(sd, device="cpu"))
    flat = M.flatten_tree(params)
    assert set(back) == set(flat)
    for k, v in flat.items():
        assert isinstance(back[k], torch.Tensor)
        assert back[k].dtype == torch.float32 and back[k].is_contiguous()
        assert np.array_equal(back[k].numpy(), v), k


def test_strict_refuses_unknown_keys():
    _, params = _jax_tree("plain")
    sd = dict(jto_torch(params))
    sd["blocks.0.attn.mystery_buffer"] = np.zeros(3, np.float32)
    sd["blocks.0.norm1.num_batches_tracked"] = np.zeros((), np.int64)
    with pytest.raises(KeyError, match="mystery_buffer"):
        vit_params_from_torch(sd, device="cpu")
    tree = vit_params_from_torch(sd, strict=False, device="cpu")
    assert "mystery_buffer" not in tree["blocks_0"]["attn"]
    assert set(M.flatten_tree(tree)) == set(M.flatten_tree(params))


def test_from_torch_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _, params = _jax_tree("plain")
    with pytest.raises(RuntimeError, match="cuda"):
        vit_params_from_torch(jto_torch(params))


def test_wrapped_payloads_normalize():
    """``{"model": sd}`` (train.py's checkpoints) and ``module.``-prefixed
    keys convert as the bare dict; an unknown payload raises TypeError."""
    _, params = _jax_tree("plain")
    sd = {k: torch.from_numpy(np.array(v))
          for k, v in jto_torch(params).items()}
    wrapped = {"model": {f"module.{k}": v for k, v in sd.items()},
               "optimizer": {}, "args": None}
    assert list(normalize_state_dict(wrapped)) == list(sd)
    a = M.flatten_tree(vit_params_from_torch(wrapped, device="cpu"))
    b = M.flatten_tree(vit_params_from_torch(sd, device="cpu"))
    assert all(torch.equal(a[k], b[k]) for k in b)
    with pytest.raises(TypeError):
        vit_params_from_torch(3.0, device="cpu")


@pytest.mark.parametrize("kind", ["plain", "qat"])
def test_load_params_any_reads_a_vit_pt(tmp_path, kind):
    """A reference ``.pt`` (the JAX converter's dict of the JAX init,
    saved by torch) read by ``load_params_any`` runs the port's ViT to the
    JAX model's logits; the tree equals the source bit for bit."""
    jm, params = _jax_tree(kind)
    torch.save({k: torch.from_numpy(np.array(v))
                for k, v in jto_torch(params).items()}, tmp_path / "m.pt")
    tree, step, extra = common.load_params_any(str(tmp_path / "m.pt"),
                                               device="cpu")
    assert step == 0 and extra == {}
    flat = M.flatten_tree(params)
    assert all(np.array_equal(v.numpy(), flat[k])
               for k, v in M.flatten_tree(tree).items())
    quant = M.QuantConfig(enabled=kind == "qat")
    model = M.model_for_params(M.ViTConfig(quant=quant, **SMALL), tree)
    x = np.random.default_rng(0).standard_normal((2, 32, 32, 3)).astype(
        np.float32)
    with torch.no_grad():
        got = model(torch.from_numpy(x), deterministic=True).numpy()
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x),
                               deterministic=True))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)

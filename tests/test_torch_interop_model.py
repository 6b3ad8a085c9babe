"""Port parity: the reference-shaped torch ViT (``interop/torch_model.py``)
and the ``torch``/``onnx`` export targets of ``cli/export.py`` against the
JAX package's.

The JAX package's ``build_torch_vit`` is a torch module too: both modules,
loaded with one interchange dict of the JAX init, give the same logits
bit for bit, within 1e-4 of the flax forward, at full and per-block-pruned
widths. ``bake_weight_quant`` equals the JAX function's exactly; the
``export_onnx`` contract (a file with the ``onnx`` package, else the
documented RuntimeError) holds; ``cli.export torch`` writes the JAX CLI's
``model.pt`` and ``arch.json`` from one checkpoint of the port's, a full
one and a compressed one (its config in ``extra["subnet"]``)."""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from quantized_vit_tpu import models as JM
from quantized_vit_tpu.cli import export as jexport
from quantized_vit_tpu.interop import vit_params_to_torch as jto_torch
from quantized_vit_tpu.interop import torch_model as jtm
from quantized_vit_tpu_torch import models as M
from quantized_vit_tpu_torch.cli import export as texport
from quantized_vit_tpu_torch.interop import vit_params_to_torch
from quantized_vit_tpu_torch.interop.torch_model import (bake_weight_quant,
                                                         build_torch_vit,
                                                         export_onnx,
                                                         load_interchange)
from quantized_vit_tpu_torch.opt.checkpoint import save_checkpoint

from tests.torch_family_params import jax_vars, torch_tree

torch.set_num_threads(1)


def _cfg(per_block=False, quant=False, rep=None, depth=2):
    return JM.ViTConfig(
        img_size=32, patch_size=16, embed_dim=64, depth=depth, num_heads=4,
        num_classes=7, quant=JM.QuantConfig(enabled=quant),
        representation_size=rep,
        heads_per_block=(2, 4) if per_block else None,
        hidden_per_block=(128, 256) if per_block else None)


def _params(cfg):
    m = JM.VisionTransformer(cfg)
    params, _ = jax_vars(m, np.zeros((1, 32, 32, 3), np.float32),
                         deterministic=True)
    return m, params


@pytest.mark.parametrize("per_block,rep", [(False, None), (True, None),
                                           (False, 48)])
def test_module_equals_jax_module_and_flax(per_block, rep):
    cfg = _cfg(per_block, rep=rep)
    m, params = _params(cfg)
    x = np.random.default_rng(0).standard_normal((3, 32, 32, 3)).astype(
        np.float32)
    want = np.asarray(m.apply({"params": params}, jnp.asarray(x)))
    arch = dataclasses.asdict(cfg)
    tmodel = load_interchange(build_torch_vit(arch, device="cpu"),
                              vit_params_to_torch(torch_tree(params)))
    jmodel = jtm.load_interchange(jtm.build_torch_vit(arch),
                                  jto_torch(params))
    assert [n for n, _ in tmodel.named_parameters()] == [
        n for n, _ in jmodel.named_parameters()]
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    with torch.no_grad():
        got = tmodel.eval()(xt).numpy()
        assert np.array_equal(got, jmodel.eval()(xt).numpy())
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_build_draws_from_its_seed_alone():
    arch = dataclasses.asdict(_cfg())
    torch.manual_seed(1)
    a = build_torch_vit(arch, device="cpu").state_dict()
    torch.manual_seed(2)
    b = build_torch_vit(arch, device="cpu").state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)


def test_build_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        build_torch_vit(dataclasses.asdict(_cfg()))


def test_load_interchange_refuses_missing_and_unknown_keys():
    cfg = _cfg()
    _, params = _params(cfg)
    sd = vit_params_to_torch(torch_tree(params))
    tmodel = build_torch_vit(dataclasses.asdict(cfg), device="cpu")
    with pytest.raises(KeyError, match="missing"):
        load_interchange(tmodel, {k: v for k, v in sd.items()
                                  if k != "head.bias"})
    with pytest.raises(KeyError, match="unknown"):
        load_interchange(tmodel, {**sd, "blocks.0.extra": np.zeros(2)})


def test_bake_weight_quant_equals_jax():
    cfg = _cfg(quant=True, depth=1)
    _, params = _params(cfg)
    params = jax.tree.map(np.asarray, JM.init_quant_params_tree(
        params, init_bits=4.0))
    want = M.flatten_tree(jax.tree.map(np.asarray,
                                       jtm.bake_weight_quant(params, cfg)))
    got = M.flatten_tree(bake_weight_quant(torch_tree(params), cfg))
    assert set(got) == set(want)
    for k, v in want.items():
        assert np.array_equal(got[k].numpy(), v), k
    d = params["blocks_0"]["attn"]["qkv"]["d_quant_wt"]
    # the baked kernel lies on the quantizer's grid: few distinct levels
    assert len(np.unique(got["blocks_0/attn/qkv/kernel"].numpy() / d)) <= 17


def test_export_onnx_contract(tmp_path):
    """With the ``onnx`` package the export writes a file; without it the
    documented RuntimeError names the package."""
    tmodel = build_torch_vit(dataclasses.asdict(_cfg(depth=1)), device="cpu")
    try:
        import onnx  # noqa: F401
        has_onnx = True
    except ImportError:
        has_onnx = False
    path = str(tmp_path / "model.onnx")
    if has_onnx:
        export_onnx(path, tmodel, 32)
        assert os.path.getsize(path) > 0
    else:
        with pytest.raises(RuntimeError, match="onnx"):
            export_onnx(path, tmodel, 32)


def _checkpoint(tmp_path, compressed: bool):
    """A port checkpoint of a QAT vit_tiny_test tree (a compressed one
    with its subnet config in extra) and the export flags."""
    from quantized_vit_tpu_torch.cli import _common as common
    from quantized_vit_tpu_torch.cli import train as ttrain

    args = ttrain.parse_args(["--model", "vit_tiny_test", "--img-size", "32"])
    model, cfg = common.build_model(args, M.QuantConfig(enabled=True),
                                    device="cpu")
    params = M.init_quant_params_tree(M.tree_map(
        lambda p: p.detach().clone(), model.param_tree()), 8.0)
    extra = {}
    if compressed:
        from quantized_vit_tpu_torch.graph import OTO

        oto = OTO(model, params)
        zeroed = oto.random_set_zero_groups(params, seed=0)
        sub_model, params = oto.construct_subnet(zeroed)
        extra["subnet"] = dataclasses.asdict(sub_model.cfg)
    save_checkpoint(str(tmp_path / "ck"), params, extra=extra)
    return ["--model", "vit_tiny_test", "--img-size", "32", "--checkpoint",
            str(tmp_path / "ck")]


@pytest.mark.parametrize("compressed", [False, True])
def test_torch_target_equals_jax_cli(tmp_path, compressed):
    flags = _checkpoint(tmp_path, compressed)
    jexport.main(["torch"] + flags + ["--out", str(tmp_path / "jax")])
    out = texport.main(["torch"] + flags + ["--out", str(tmp_path / "port"),
                                            "--device", "cpu"])
    assert out == str(tmp_path / "port")
    want = torch.load(tmp_path / "jax" / "model.pt")
    got = torch.load(tmp_path / "port" / "model.pt")
    assert list(got) == list(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype and torch.equal(got[k], v), k
    assert (tmp_path / "port" / "arch.json").read_text() == (
        tmp_path / "jax" / "arch.json").read_text()
    # the exported pair rebuilds the model: its logits are the port's
    arch = json.loads((tmp_path / "port" / "arch.json").read_text())
    tmodel = load_interchange(build_torch_vit(arch, device="cpu"),
                              {k: v.numpy() for k, v in got.items()})
    assert tmodel.blocks[0].mlp.fc1.out_features == (
        arch["hidden_per_block"][0] if compressed else 256)


def test_onnx_target_contract(tmp_path):
    flags = _checkpoint(tmp_path, False)
    argv = ["onnx"] + flags + ["--out", str(tmp_path / "m.onnx"),
                               "--bake-quant", "--device", "cpu"]
    try:
        import onnx  # noqa: F401
    except ImportError:
        with pytest.raises(RuntimeError, match="onnx"):
            texport.main(argv)
        return
    texport.main(argv)
    assert os.path.getsize(tmp_path / "m.onnx") > 0

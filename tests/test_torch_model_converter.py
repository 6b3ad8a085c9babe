"""Port parity: ``model_to_quantize_model`` (``models/layers.py``), a float
model and its params -> the quantized twin with every Dense/Conv's (d,
q_m, t) set from its weights, against the JAX converter on the CPU, for
every family with a quant-bearing config (ViT, ResNet, MobileNet, the
Transformer, the autoencoder).

Exact: the twin's params tree (paths, shapes, the copied floats and the
new scalars) equals JAX's bit for bit; its forward within rtol 1e-5,
atol 1e-5 of JAX's twin; at a high initial bit width and with weight
quantizers only, near the float model (rtol 1e-2, the reference's
idiom). Each of the JAX package's ``tests/models/test_model_converter.py``
tests has its case here."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quantized_vit_tpu.models import AutoencoderConfig as JAECfg
from quantized_vit_tpu.models import ConvAutoencoder as JAE
from quantized_vit_tpu.models import QuantConfig as JQ
from quantized_vit_tpu.models import TransformerConfig as JTCfg
from quantized_vit_tpu.models import TransformerEncoder as JEnc
from quantized_vit_tpu.models import ViTConfig as JViTCfg
from quantized_vit_tpu.models import VisionTransformer as JViT
from quantized_vit_tpu.models import mobilenet_small as jmobilenet
from quantized_vit_tpu.models import model_to_quantize_model as jconvert
from quantized_vit_tpu.models import resnet8 as jresnet8
from quantized_vit_tpu_torch.models import (AutoencoderConfig, MobileNetConfig,
                                            QuantConfig, ResNetConfig,
                                            TransformerConfig, UltraNet,
                                            ViTConfig, apply_variables,
                                            autoencoder_params_from_jax,
                                            collect_quant_params,
                                            flatten_tree,
                                            mobilenet_params_from_jax,
                                            model_to_quantize_model,
                                            params_from_jax,
                                            resnet_params_from_jax,
                                            transformer_params_from_jax)

from tests import torch_family_params as F

torch.set_num_threads(1)

IMG = np.random.default_rng(0).standard_normal((2, 32, 32, 3)).astype(
    np.float32)
TOKENS = np.random.default_rng(1).integers(0, 101, (2, 16)).astype(np.int32)


def _vit():
    jm = JViT(JViTCfg(img_size=32, patch_size=16, embed_dim=48, depth=2,
                      num_heads=2, num_classes=5, quant=JQ.off()))
    params, _ = F.jax_vars(jm, IMG)
    cfg = ViTConfig(img_size=32, patch_size=16, embed_dim=48, depth=2,
                    num_heads=2, num_classes=5)
    return jm, params, None, IMG, params_from_jax(params, cfg, device="cpu")


def _resnet():
    jm = jresnet8()
    params, stats = F.jax_vars(jm, IMG)
    stats = F.trained_like_stats(stats, 0)
    return jm, params, stats, IMG, resnet_params_from_jax(
        params, F.port_cfg(jm.cfg, ResNetConfig), stats, device="cpu")


def _mobilenet():
    jm = jmobilenet()
    params, stats = F.jax_vars(jm, IMG)
    stats = F.trained_like_stats(stats, 1)
    return jm, params, stats, IMG, mobilenet_params_from_jax(
        params, F.port_cfg(jm.cfg, MobileNetConfig), stats, device="cpu")


def _transformer():
    jm = JEnc(JTCfg(vocab_size=101, max_len=16, embed_dim=32, depth=2,
                    num_heads=4, num_kv_heads=2, rope=True,
                    mlp_type="swiglu", num_classes=3))
    params, _ = F.jax_vars(jm, TOKENS)
    return jm, params, None, TOKENS, transformer_params_from_jax(
        params, F.port_cfg(jm.cfg, TransformerConfig), device="cpu")


def _autoencoder():
    jm = JAE(JAECfg(widths=(8, 16), skip_concat=True))
    x = IMG[:, :16, :16]
    params, _ = F.jax_vars(jm, x)
    return jm, params, None, x, autoencoder_params_from_jax(
        params, F.port_cfg(jm.cfg, AutoencoderConfig), device="cpu")


FAMILIES = {"vit": _vit, "resnet": _resnet, "mobilenet": _mobilenet,
            "transformer": _transformer, "autoencoder": _autoencoder}


def _japply(jm, params, stats, x):
    v = {"params": params}
    if stats is not None:
        v["batch_stats"] = stats
    return np.asarray(jax.jit(lambda v, x: jm.apply(v, x))(v, x))


def _apply(model, params, x):
    with torch.no_grad():
        return apply_variables(model, params, torch.from_numpy(x)).numpy()


@pytest.mark.parametrize("acts", [True, False], ids=["wa", "w_only"])
@pytest.mark.parametrize("family", list(FAMILIES))
def test_converter_matches_jax(family, acts):
    jm, params, stats, x, model = FAMILIES[family]()
    jq = JQ(enabled=True, quantize_acts=acts)
    jqm, jqp = jconvert(jm, jax.tree.map(jnp.asarray, params), x, quant=jq,
                        init_bits=8.0)
    qm, qp = model_to_quantize_model(model, model.param_tree(), x,
                                     quant=F.port_quant(jq), init_bits=8.0)
    if family == "vit":  # the port's ViTConfig keeps quant as a dict
        assert qm.cfg.quant_config == F.port_quant(jq)
    else:
        assert qm.cfg == F.port_cfg(jqm.cfg, type(model.cfg))
    assert F.trees_equal(jax.tree.map(np.asarray, jqp), qp)
    leaves = flatten_tree(qp)
    for k, v in qm.named_parameters():
        assert v is leaves[k.replace(".", "/")] and v.requires_grad, k
    if stats is not None:  # the twin carries the float model's statistics
        assert F.trees_equal(stats, qm.batch_stats_tree())
    np.testing.assert_allclose(_apply(qm, qp, x),
                               _japply(jqm, jax.tree.map(np.asarray, jqp),
                                       stats, x), rtol=1e-5, atol=1e-5)


def test_converted_resnet_matches_fp32_at_high_bits():
    jm, params, stats, x, model = _resnet()
    qm, qp = model_to_quantize_model(
        model, model.param_tree(), x,
        quant=QuantConfig(enabled=True, quantize_acts=False), init_bits=16.0)
    np.testing.assert_allclose(_apply(qm, qp, x),
                               _apply(model, model.param_tree(), x),
                               rtol=1e-2, atol=1e-3)


def test_converted_vit_structure_and_parity():
    jm, params, _, x, model = _vit()
    qm, qp = model_to_quantize_model(model, model.param_tree(), x,
                                     init_bits=24.0)
    layers = collect_quant_params(qp)
    assert len(layers) == 2 + 4 * 2
    assert all(len(v) == 6 for v in layers.values())
    k = qp["blocks_0"]["mlp"]["fc1"]
    assert float(k["q_m_wt"].detach()[0]) == float(
        k["kernel"].detach().abs().max())
    qm2, qp2 = model_to_quantize_model(
        model, model.param_tree(), x,
        quant=QuantConfig(enabled=True, quantize_acts=False), init_bits=24.0)
    np.testing.assert_allclose(_apply(qm2, qp2, x),
                               _apply(model, model.param_tree(), x),
                               rtol=1e-2, atol=1e-2)


def test_converted_mobilenet_runs():
    _, _, _, x, model = _mobilenet()
    qm, qp = model_to_quantize_model(
        model, model.param_tree(), x,
        quant=QuantConfig(enabled=True, quantize_acts=False), init_bits=12.0)
    assert np.isfinite(_apply(qm, qp, x)).all()


def test_converter_rejects_shape_mismatch_and_configless_models():
    jm, params, stats, x, model = _resnet()
    tree = model.param_tree()
    tree["stem_conv"]["kernel"] = tree["stem_conv"]["kernel"][..., :8]
    with pytest.raises(ValueError, match="shape mismatch at stem_conv/kernel"):
        model_to_quantize_model(model, tree, x)
    with pytest.raises(ValueError, match="no quant-bearing config"):
        model_to_quantize_model(UltraNet(device="cpu"), {}, x)

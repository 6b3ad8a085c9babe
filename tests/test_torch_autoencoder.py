"""Port parity: the conv autoencoder (``models/autoencoder.py``) with its
transposed convs, GroupNorm, tanh GELU and U-Net skips, its node groups,
subnet and cost report against the JAX package, on the CPU at 16 x 16 x 3
(batch 2), the JAX model's weights carried across by ``params_from_jax``.

Tolerances: ``conv_transpose_nhwc`` and ``QuantConvTranspose`` within
1e-5 of ``jax.lax.conv_transpose`` / the JAX layer (f32 sums in another
order); GroupNorm and the GELU within 1e-6; the forward within rtol 1e-5,
atol 1e-5; the gradients of a QAT loss as ``tests/torch_family_params.py``
states; node groups, subnet params and configs exact; cost reports within
1e-9 relative. Each of the JAX package's
``tests/compress/test_autoencoder_subnet.py`` tests has its case here."""

import functools

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quantized_vit_tpu.compress import construct_subnet_autoencoder as jsub
from quantized_vit_tpu.graph import autoencoder_node_groups as jgroups
from quantized_vit_tpu.graph.costs import autoencoder_cost_report as jcost
from quantized_vit_tpu.models import AutoencoderConfig as JCfg
from quantized_vit_tpu.models import ConvAutoencoder as JAE
from quantized_vit_tpu.models import QuantConfig as JQ
from quantized_vit_tpu.models import QuantConvTranspose as JConvT
from quantized_vit_tpu.models import init_quant_params_tree as jinit
from quantized_vit_tpu.opt import groups as jgroups_mod
from quantized_vit_tpu_torch.compress import construct_subnet_autoencoder
from quantized_vit_tpu_torch.graph import (autoencoder_cost_report,
                                           autoencoder_node_groups)
from quantized_vit_tpu_torch.models import (AutoencoderConfig,
                                            ConvAutoencoder, GroupNorm,
                                            QuantConvTranspose,
                                            apply_variables,
                                            autoencoder_params_from_jax,
                                            flatten_tree)
from quantized_vit_tpu_torch.models.autoencoder import gelu_tanh
from quantized_vit_tpu_torch.models.layers import conv_transpose_nhwc
from quantized_vit_tpu_torch.opt import (get_path, group_mask_for_param,
                                         set_path)

from tests import torch_family_params as F

torch.set_num_threads(1)

QUANTS = {"off": JQ.off(), "wa": JQ(enabled=True),
          "w_only": JQ(enabled=True, quantize_acts=False)}
SHAPES = {"plain": dict(widths=(8, 16), norm_groups=4),
          "unet": dict(widths=(8, 16, 16), norm_groups=4, skip_concat=True),
          "instance": dict(widths=(8,), norm_groups=8)}


def _x(seed=0, hw=16):
    return np.random.default_rng(seed).standard_normal(
        (2, hw, hw, 3)).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _jax_setup(shape="plain", quant="wa", bits=8.0, seed=0):
    jm = JAE(JCfg(**SHAPES[shape], in_channels=3, quant=QUANTS[quant]))
    x = _x(seed)
    params, _ = F.jax_vars(jm, x)
    if QUANTS[quant].enabled:
        params = jax.tree.map(np.asarray, jinit(params, init_bits=bits))
    return jm, params, x


def _setup(shape="plain", quant="wa"):
    jm, params, x = _jax_setup(shape, quant)
    model = autoencoder_params_from_jax(
        params, F.port_cfg(jm.cfg, AutoencoderConfig), device="cpu")
    return jm, params, x, model


def _japply(jm, params, x):
    return np.asarray(jax.jit(lambda p, x: jm.apply({"params": p}, x))(
        params, x))


def _apply(model, params, x):
    with torch.no_grad():
        return apply_variables(model, params, torch.from_numpy(x)).numpy()


# ---------------------------------------------------------------------------
# the layers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("hw", [(5, 6), (8, 7)], ids=["odd_even", "even_odd"])
@pytest.mark.parametrize("k", [1, 3, 4])
@pytest.mark.parametrize("s", [1, 2])
@pytest.mark.parametrize("padding", ["SAME", "VALID"])
def test_conv_transpose_matches_lax(padding, s, k, hw):
    rng = np.random.default_rng(100 * s + k)
    x = rng.standard_normal((2, *hw, 3)).astype(np.float32)
    kern = rng.standard_normal((k, k, 3, 5)).astype(np.float32)
    want = np.asarray(jax.lax.conv_transpose(
        x, kern, (s, s), padding, dimension_numbers=("NHWC", "HWIO",
                                                     "NHWC")))
    got = conv_transpose_nhwc(torch.from_numpy(x), torch.from_numpy(kern),
                              (s, s), padding).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("quant", list(QUANTS))
def test_quant_conv_transpose_layer_matches_jax(quant):
    """The layer (its quantizers, its kernel [kh, kw, in, out], bias) on
    an odd input at stride 2."""
    x = np.random.default_rng(3).standard_normal((2, 7, 5, 6)).astype(
        np.float32)
    jl = JConvT(features=4, kernel_size=(3, 3), strides=(2, 2),
                config=QUANTS[quant])
    params, _ = F.jax_vars(jl, x)
    if QUANTS[quant].enabled:
        params = jax.tree.map(np.asarray, jinit(params, init_bits=8.0))
    layer = QuantConvTranspose(6, 4, (3, 3), strides=(2, 2),
                               config=F.port_quant(QUANTS[quant]),
                               device="cpu")
    layer.load_state_dict({k: torch.from_numpy(np.array(v))
                           for k, v in params.items()}, strict=False)
    with torch.no_grad():
        got = layer(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jl.apply({"params": params},
                                                        x)),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("groups", [1, 4, 8])
def test_group_norm_matches_flax(groups):
    rng = np.random.default_rng(groups)
    x = (rng.standard_normal((2, 5, 6, 8)) * 3 + 1).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, 8).astype(np.float32)
    bias = rng.normal(0, 0.1, 8).astype(np.float32)
    want = fnn.GroupNorm(num_groups=groups).apply(
        {"params": {"scale": scale, "bias": bias}}, x)
    gn = GroupNorm(8, groups, device="cpu")
    gn.scale.data, gn.bias.data = torch.from_numpy(scale), torch.from_numpy(
        bias)
    with torch.no_grad():
        got = gn(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-6, atol=1e-6)


def test_gelu_is_the_tanh_approximation():
    x = np.linspace(-6, 6, 1001, dtype=np.float32)
    got = gelu_tanh(torch.from_numpy(x)).numpy()
    # tanh an ulp apart in the two libraries; 1 + tanh cancels below -3
    np.testing.assert_allclose(got, np.asarray(jax.nn.gelu(x)), rtol=1e-6,
                               atol=1e-6)
    # not the exact GELU
    assert np.abs(got - np.asarray(jax.nn.gelu(x, approximate=False))).max(
    ) > 1e-4


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("quant", list(QUANTS))
@pytest.mark.parametrize("shape", ["plain", "unet"])
def test_forward_matches_jax(shape, quant):
    jm, params, x, model = _setup(shape, quant)
    assert F.trees_equal(params, model.param_tree())
    y = _apply(model, model.param_tree(), x)
    assert y.shape == x.shape
    np.testing.assert_allclose(y, _japply(jm, params, x), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("fused", [False, True], ids=["chain", "k7_plain"])
def test_qat_grads_match_jax(fused, monkeypatch):
    """The gradients of a reconstruction loss on every leaf, through the
    transposed convs and the U-Net concats; ``fused``: K7's plain version
    here, the JAX package's fused quantizer backward there."""
    jm0, params, x = _jax_setup("unet", "wa")
    jm = JAE(JCfg(**SHAPES["unet"], in_channels=3,
                  quant=JQ(enabled=True, fused_vjp=fused)))
    model = ConvAutoencoder(F.port_cfg(jm.cfg, AutoencoderConfig),
                            device="cpu")

    def jloss(p):
        return jnp.mean(jnp.square(jm.apply({"params": p}, x) - x))

    def tloss(p):
        xt = torch.from_numpy(x)
        return torch.mean(torch.square(apply_variables(model, p, xt) - xt))

    jv, jg = F.jax_value_and_grads(jloss, params)
    v, g, masses = F.port_value_and_grads(tloss, params, monkeypatch)
    np.testing.assert_allclose(v, jv, rtol=1e-5)
    # three encoder convs, three transposed convs, the output conv
    assert len(masses) == 3 * 2 * 7
    F.assert_grads_close(g, jg, masses)


@pytest.mark.parametrize("shape", list(SHAPES))
def test_node_groups_match_jax(shape):
    jm, params, x, model = _setup(shape)
    groups = autoencoder_node_groups(model.cfg, model.param_tree())
    F.assert_groups_equal(jgroups(jm.cfg, params), groups)
    out_g = [g for g in groups if g.id == "out_conv"][0]
    assert not out_g.is_prunable
    F.assert_reports_equal(jcost(jm.cfg, params, img_hw=(16, 16)),
                           autoencoder_cost_report(model.cfg,
                                                   model.param_tree(),
                                                   img_hw=(16, 16)))


def _zero_groups(params, group, idxes, jax_tree=False):
    """Zero the groups ``idxes`` of ``group`` in a port tree, or in a JAX
    tree with the JAX package's functions (its test's helper)."""
    mask = np.zeros((group.num_groups,), np.float32)
    mask[np.asarray(idxes)] = 1.0
    mod = jgroups_mod if jax_tree else None
    for e in group.entries:
        if e.transform.value == "no_prune":
            continue
        if jax_tree:
            p = mod.get_path(params, e.path)
            m = mod.group_mask_for_param(jnp.asarray(mask), e.transform,
                                         p.shape, group.num_heads)
            params = mod.set_path(params, e.path, p * (1.0 - m))
        else:
            p = get_path(params, e.path)
            m = group_mask_for_param(torch.from_numpy(mask), e.transform,
                                     tuple(p.shape), group.num_heads)
            params = set_path(params, e.path, p * (1.0 - m))
    return params


def _compress_both(shape, quant, zeros):
    """Zero the same norm groups in both packages' trees; (JAX config and
    params, port config and params, port zeroed tree, port model, x)."""
    jm, params, x, model = _setup(shape, quant)
    tz = model.param_tree()
    jz = params
    groups = autoencoder_node_groups(model.cfg, tz)
    jg = jgroups(jm.cfg, params)
    by, jby = {g.id: g for g in groups}, {g.id: g for g in jg}
    for gid, idx in zeros.items():
        tz = _zero_groups(tz, by[gid], idx)
        jz = _zero_groups(jz, jby[gid], idx, jax_tree=True)
    assert F.trees_equal(jz, tz)
    jcfg, jp = jsub(jm.cfg, jz, jg)
    cfg, tp = construct_subnet_autoencoder(model.cfg, tz, groups)
    assert F.port_cfg(jcfg, AutoencoderConfig) == cfg
    assert F.trees_equal(jp, tp)
    F.assert_reports_equal(jcost(jcfg, jp), autoencoder_cost_report(cfg, tp))
    return jcfg, jp, cfg, tp, tz, model, x


@pytest.mark.parametrize("quant", ["off", "wa"])
def test_subnet_forward_parity(quant):
    _, _, cfg, tp, tz, model, x = _compress_both(
        "plain", quant, {"enc_0": [1, 3], "enc_1": [0], "dec_0": [2]})
    assert cfg.widths == (4, 12) and cfg.enc_norm_groups == (2, 3)
    assert cfg.dec_widths[0] == 6 and cfg.dec_norm_groups == (3, 4)
    sub = ConvAutoencoder(cfg, device="cpu")
    np.testing.assert_allclose(_apply(sub, tp, x), _apply(model, tz, x),
                               rtol=1e-5, atol=1e-5)


def test_unprunable_output_conv_kept():
    cfg = AutoencoderConfig(widths=(8,), norm_groups=2, in_channels=3)
    model = ConvAutoencoder(cfg, device="cpu")
    groups = autoencoder_node_groups(cfg, model.param_tree())
    assert not [g for g in groups if g.id == "out_conv"][0].is_prunable
    x = torch.zeros((1, 8, 8, 3))
    with torch.no_grad():
        assert tuple(model(x).shape) == tuple(x.shape)


def test_instance_norm_case():
    _, _, cfg, tp, tz, model, x = _compress_both("instance", "off",
                                                 {"enc_0": [2, 5, 7]})
    assert cfg.widths == (5,) and cfg.enc_norm_groups == (5,)
    np.testing.assert_allclose(_apply(ConvAutoencoder(cfg, device="cpu"),
                                      tp, x), _apply(model, tz, x),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("quant", ["off", "wa"])
def test_unet_skip_concat_compress_is_lossless(quant):
    """The concat-fed in-dims take both producers' kept channels, the
    second segment offset by the decoder stage's original width."""
    jm, params, x, _ = _setup("unet", quant)
    assert params["dec_1"]["kernel"].shape[-2] == \
        jm.cfg.decoder_widths[0] + jm.cfg.widths[1]
    _, _, cfg, tp, tz, model, x = _compress_both(
        "unet", quant, {"enc_0": [1], "enc_1": [0, 3], "dec_0": [2]})
    assert cfg.widths == (6, 8, 16)
    assert tp["dec_1"]["kernel"].shape[-2] == cfg.dec_widths[0] + \
        cfg.widths[1]
    assert tp["dec_2"]["kernel"].shape[-2] == cfg.dec_widths[1] + \
        cfg.widths[0]
    assert tp["out_conv"]["kernel"].shape[-2] == cfg.dec_widths[2]
    np.testing.assert_allclose(_apply(ConvAutoencoder(cfg, device="cpu"),
                                      tp, x), _apply(model, tz, x),
                               rtol=1e-5, atol=1e-5)


def test_oto_zeroing_and_subnet_match_jax():
    """The OTO facade: the same random groups zeroed, the subnet's model
    holding its params' tensors, its forward equal to the zeroed net's."""
    jm, params, x, model = _setup("unet", "wa")
    joto, oto = F.otos(jm, model, params)
    jz, tz = F.zeroed(joto, oto, 1, 0.5)
    assert F.trees_equal(jz, tz)
    sub, sp = oto.construct_subnet(tz)
    jsubm, jsp = joto.construct_subnet(jz)
    assert sub.cfg == F.port_cfg(jsubm.cfg, AutoencoderConfig)
    assert F.trees_equal(jsp, sp)
    leaves = flatten_tree(sp)
    for k, v in sub.named_parameters():
        assert v.data_ptr() == leaves[k.replace(".", "/")].data_ptr(), k
    np.testing.assert_allclose(_apply(sub, sp, x), _apply(model, tz, x),
                               rtol=1e-5, atol=1e-5)
    assert oto.compute_macs(sp) < oto.compute_macs()

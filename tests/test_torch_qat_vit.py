"""Port parity: the quantized layers (``models/layers.py``) and the
quantization-aware ViT (``models/vit.py``) against the JAX package, with
the JAX model's weights carried across by ``params_from_jax``.

A tiny ViT (32 px, patch 16, width 32, depth 2, 2 heads), drop rates 0,
one seeded batch; logits, the cross-entropy loss and the gradient of
every parameter, at init bits 32 and 8, ``fused_vjp`` on and off (on the
CPU both take the plain chain), ``matmul_dtype`` None and ``bfloat16``.

Tolerances: logits and loss within 1e-5 relative (f32 sums in another
order). A weight, bias, LayerNorm or embedding gradient within 1e-5 of the
largest magnitude of its leaf in f32 (sum order), 1e-3 with bf16 dots (a
one-ulp f32 difference can move a bf16-rounded operand by one bf16 ulp,
2^-8 relative). A quantizer scalar's gradient is a sum, so it is held to
the L1 mass of its summands (recorded from the port's plain chain): q_m
and t within 1e-5 of it (K7's contract); d within 2e-3 of it at 8 bits,
because the residual ``round(p/d) - p/d`` moves by ulp(p)/d, up to 2^7
ulps, when the pre-quant value p moves by one ulp.

At 32 bits d's gradient has no JAX parity to hold: p/d spans 2^31 steps,
so a one-ulp change of p moves a residual anywhere in [-0.5, 0.5], and
XLA's exp/log and PyTorch's differ by an ulp even on the same inputs
(fed one quantizer site's JAX inputs, the two backwards' d gradients
differ by up to 0.68 of the L1 mass). The 32-bit cases therefore check d's
gradients only for being finite and leave them out of the comparison;
the 8-bit cases are the model-level check of d, and
``test_torch_lsfq.py`` holds d's gradient at the quantizer level.
"""

import functools

import numpy as np
import pytest
import torch

import flax
import jax
import jax.numpy as jnp

from quantized_vit_tpu.models import QuantConfig as JQ
from quantized_vit_tpu.models import QuantConv as JConv
from quantized_vit_tpu.models import ViTConfig as JC
from quantized_vit_tpu.models import VisionTransformer as JV
from quantized_vit_tpu.models import bitwidth_dict as jbitwidth_dict
from quantized_vit_tpu.models import init_quant_params_tree as jinit
from quantized_vit_tpu_torch.ops import quant_vjp as tqv
from quantized_vit_tpu_torch.models import (QuantConfig, QuantConv,
                                            ViTConfig, apply, bitwidth_dict,
                                            collect_quant_params,
                                            flatten_tree,
                                            init_quant_params_tree,
                                            params_from_jax, params_to_numpy,
                                            unflatten_tree)

torch.set_num_threads(1)

TINY = dict(img_size=32, patch_size=16, embed_dim=32, depth=2, num_heads=2,
            mlp_ratio=2.0, num_classes=10)
LABELS = np.array([1, 2, 7])


def _images(seed=0, n=3):
    return np.random.default_rng(seed).standard_normal(
        (n, 32, 32, 3)).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _jax_ref(bits, dtype):
    """JAX params (numpy), logits, loss and gradients of the tiny ViT."""
    q = JQ(enabled=True, matmul_dtype=dtype)
    model = JV(JC(**TINY, quant=q))
    x = jnp.asarray(_images())
    params = flax.core.unfreeze(jax.jit(model.init)(
        jax.random.PRNGKey(0), x)["params"])
    params = jinit(params, init_bits=bits)

    def loss_fn(p):
        logits = model.apply({"params": p}, x, deterministic=True)
        onehot = jax.nn.one_hot(jnp.asarray(LABELS), 10)
        return -jnp.mean(jnp.sum(jax.nn.log_softmax(logits) * onehot,
                                 -1)), logits

    (loss, logits), grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(params)
    to_np = functools.partial(jax.tree.map, np.asarray)
    return to_np(params), float(loss), np.asarray(logits), flatten_tree(
        to_np(grads))


_SCALARS = ("d_quant", "q_m", "t_quant")


def _record_masses(monkeypatch, named):
    """{param path: L1 mass of its gradient's summands}, filled by the
    plain chain's backward while the test runs."""
    masses = {}
    plain = tqv.lsfq_nonlinear_bwd_plain
    by_ptr = {v.data_ptr(): k for k, v in named.items()}

    def recording(x, g, d, q_m, t, **kw):
        terms = tqv.nonlinear_bwd_terms(x, g, d, q_m, t, **kw)[1:]
        for p, term in zip((d, q_m, t), terms):
            masses[by_ptr[p.data_ptr()]] = float(
                term.abs().sum(dtype=torch.float64))
        return plain(x, g, d, q_m, t, **kw)

    monkeypatch.setattr(tqv, "lsfq_nonlinear_bwd_plain", recording)
    return masses


def _grad_tol(path, want, masses, bits=8.0, bf16=False):
    """The tolerances of the module docstring; None where the gradient is
    not compared (d at 32 bits)."""
    leaf = path.rsplit("/", 1)[-1]
    if leaf.startswith("d_quant"):
        return None if bits == 32.0 else 2e-3 * masses[path]
    if leaf.startswith(_SCALARS):
        return 1e-5 * masses[path]
    return (1e-3 if bf16 else 1e-5) * float(np.abs(want).max())


def _port(tree, bits, dtype, fused, monkeypatch=None):
    """The port's loss, logits and gradients on the JAX weights; with
    ``monkeypatch``, also the L1 mass of every quantizer scalar's
    summands, by param path."""
    cfg = ViTConfig(**TINY, quant=QuantConfig(enabled=True,
                                              matmul_dtype=dtype,
                                              fused_vjp=fused))
    model = params_from_jax(tree, cfg, device="cpu")
    leaves = {k: v.detach().clone().requires_grad_()
              for k, v in model.params_by_path().items()}
    masses = ({} if monkeypatch is None
              else _record_masses(monkeypatch, leaves))
    logits = apply(model, unflatten_tree(leaves), torch.from_numpy(_images()))
    logp = torch.log_softmax(logits, -1)
    loss = -logp[torch.arange(3), torch.from_numpy(LABELS)].mean()
    loss.backward()
    return model, float(loss.detach()), logits.detach().numpy(), {
        k: v.grad.numpy() for k, v in leaves.items()}, masses


@pytest.mark.parametrize("dtype", [None, "bfloat16"], ids=["f32", "bf16"])
@pytest.mark.parametrize("fused", [False, True], ids=["chain", "fused"])
@pytest.mark.parametrize("bits", [32.0, 8.0])
def test_tiny_vit_logits_loss_grads_match_jax(bits, fused, dtype,
                                              monkeypatch):
    tree, jloss, jlogits, jgrads = _jax_ref(bits, dtype)
    _, loss, logits, grads, masses = _port(tree, bits, dtype, fused,
                                           monkeypatch)
    np.testing.assert_allclose(logits, jlogits, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(loss, jloss, rtol=1e-5)
    assert set(grads) == set(jgrads)
    assert len(masses) == 3 * 2 * (1 + 4 * TINY["depth"] + 1)
    compared = 0
    for k, want in jgrads.items():
        assert np.isfinite(grads[k]).all(), k
        tol = _grad_tol(k, want, masses, bits, dtype is not None)
        if tol is None:
            continue
        err = float(np.abs(grads[k] - want).max())
        assert err <= tol + 1e-12, (k, err, tol)
        compared += 1
    n_d = 2 * (1 + 4 * TINY["depth"] + 1)  # d_quant_wt and _act per layer
    assert compared == len(jgrads) - (n_d if bits == 32.0 else 0)


def test_params_from_jax_round_trip_is_exact():
    tree = _jax_ref(8.0, None)[0]
    model = params_from_jax(tree, ViTConfig(**TINY, quant=QuantConfig()),
                            device="cpu")
    back = params_to_numpy(model)
    flat, fback = flatten_tree(tree), flatten_tree(back)
    assert list(fback) and set(flat) == set(fback)
    for k in flat:
        assert fback[k].dtype == flat[k].dtype
        np.testing.assert_array_equal(fback[k], flat[k])
    # flax names and layouts: [in, out] kernels, HWIO conv, (1,) scalars
    assert fback["blocks_1/attn/qkv/kernel"].shape == (32, 96)
    assert fback["patch_embed/proj/kernel"].shape == (16, 16, 3, 32)
    assert fback["head/t_quant_act"].shape == (1,)
    with pytest.raises(ValueError, match="missing"):
        params_from_jax({k: v for k, v in tree.items() if k != "head"},
                        ViTConfig(**TINY, quant=QuantConfig()),
                        device="cpu")


def test_quant_config_round_trips_through_dicts():
    q = QuantConfig(enabled=True, matmul_dtype="bfloat16", fused_vjp=True,
                    weight_clip=(-1.5, 1.5))
    d = q.asdict()
    assert d["weight_clip"] == [-1.5, 1.5]
    assert QuantConfig.from_dict(d) == q
    assert set(d) == {f.name for f in
                      __import__("dataclasses").fields(JQ)}
    assert ViTConfig(quant=q).quant == d
    assert ViTConfig(quant=q).quant_config == q
    assert ViTConfig().quant_config == QuantConfig.off()


def test_init_quant_params_and_bitwidths_match_jax():
    tree = _jax_ref(32.0, None)[0]
    for bits in (32.0, 6.0):
        want = flatten_tree(jax.tree.map(np.asarray, jinit(
            jax.tree.map(jnp.asarray, tree), init_bits=bits)))
        got = flatten_tree(init_quant_params_tree(
            jax.tree.map(torch.from_numpy, tree), init_bits=bits))
        for k in want:
            np.testing.assert_array_equal(got[k].numpy(), want[k])
        jb = jbitwidth_dict(jax.tree.map(jnp.asarray, unflatten_tree(want)))
        tb = bitwidth_dict(unflatten_tree(got))
        assert set(jb) == set(tb) == set(collect_quant_params(
            unflatten_tree(got)))
        for lp in jb:
            for key in ("weight_bit", "act_bit"):
                assert abs(jb[lp][key] - tb[lp][key]) < 1e-4


@pytest.mark.parametrize("conv", ["same_s2", "valid_grouped"])
def test_quant_conv_general_path_matches_jax(conv, monkeypatch):
    """The general (non-patch) conv path: SAME padding with stride 2, and
    VALID with feature groups."""
    kw = (dict(kernel_size=(3, 3), strides=(2, 2), padding="SAME",
               feature_group_count=1) if conv == "same_s2" else
          dict(kernel_size=(3, 3), strides=(1, 1), padding="VALID",
               feature_group_count=2))
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 9, 9, 4)).astype(np.float32)
    jconv = JConv(features=6, config=JQ(enabled=True), **kw)
    params = jinit(flax.core.unfreeze(jax.jit(jconv.init)(
        jax.random.PRNGKey(1), jnp.asarray(x))["params"]), init_bits=8.0)
    g = rng.standard_normal((2, 5, 5, 6) if conv == "same_s2"
                            else (2, 7, 7, 6)).astype(np.float32)

    @jax.jit
    def fwd_bwd(p):
        y, vjp = jax.vjp(lambda p: jconv.apply({"params": p},
                                               jnp.asarray(x)), p)
        return y, vjp(jnp.asarray(g))[0]

    want, jg = fwd_bwd(params)
    jgrads = flatten_tree(jax.tree.map(np.asarray, jg))

    conv_t = QuantConv(4, 6, config=QuantConfig(enabled=True), **kw,
                       device="cpu")
    with torch.no_grad():
        for k, v in conv_t.named_parameters():
            v.copy_(torch.from_numpy(np.asarray(params[k])))
    named = dict(conv_t.named_parameters())
    masses = _record_masses(monkeypatch, named)
    y = conv_t(torch.from_numpy(x))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)
    y.backward(torch.from_numpy(g))
    for k, v in named.items():
        err = float(np.abs(v.grad.numpy() - jgrads[k]).max())
        assert err <= _grad_tol(k, jgrads[k], masses) + 1e-12, (k, err)

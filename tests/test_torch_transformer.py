"""Port parity: the separate-q/k/v Transformer encoder
(``models/transformer.py``: Bert-style attention, GQA, RoPE, the causal
mask, SwiGLU) with its node groups, subnet and cost report against the
JAX package, on the CPU at the JAX tests' width (vocabulary 101, 16
tokens, width 32, depth 2, 4 heads) and at ``transformer_encoder_tiny``,
the JAX model's weights carried across by ``params_from_jax``.

Tolerances: logits within rtol 1e-5, atol 1e-5 of JAX's (quant off, on
with and without activation quantizers; no mask and a ragged one); the
gradients of a QAT loss as ``tests/torch_family_params.py`` states; node
groups, subnet params and configs exact; cost reports within 1e-9
relative; ``rope_rotate`` within 1e-6 (f32 pow, cos and sin in each
library's own rounding). Each of the JAX package's
``tests/models/test_transformer.py`` tests has its case here."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quantized_vit_tpu.compress import construct_subnet_transformer as jsub
from quantized_vit_tpu.graph import transformer_node_groups as jgroups
from quantized_vit_tpu.graph.costs import transformer_cost_report as jcost
from quantized_vit_tpu.models import QuantConfig as JQ
from quantized_vit_tpu.models import TransformerConfig as JCfg
from quantized_vit_tpu.models import TransformerEncoder as JEnc
from quantized_vit_tpu.models import init_quant_params_tree as jinit
from quantized_vit_tpu.models import transformer_encoder_tiny as jtiny
from quantized_vit_tpu.models.transformer import rope_rotate as jrope
from quantized_vit_tpu_torch.compress import construct_subnet_transformer
from quantized_vit_tpu_torch.graph import (OTO, transformer_cost_report,
                                           transformer_node_groups)
from quantized_vit_tpu_torch.models import (TransformerConfig,
                                            TransformerEncoder,
                                            apply_variables, flatten_tree,
                                            transformer_params_from_jax,
                                            unflatten_tree)
from quantized_vit_tpu_torch.models.transformer import rope_rotate

from tests import torch_family_params as F

torch.set_num_threads(1)

BASE = dict(vocab_size=101, max_len=16, embed_dim=32, depth=2, num_heads=4,
            num_classes=3)
KINDS = {
    "mha": {},
    "gqa": dict(num_kv_heads=2, causal=True, rope=True),
    "llama": dict(num_kv_heads=2, causal=True, rope=True,
                  mlp_type="swiglu"),
}
QUANTS = {"off": JQ.off(), "wa": JQ(enabled=True),
          "w_only": JQ(enabled=True, quantize_acts=False)}


def _tokens(cfg, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (2, 16)).astype(np.int32)


def _ragged(n=16):
    m = np.ones((2, n), np.int32)
    m[0, 10:] = 0
    m[1, 3:] = 0
    return m


@functools.lru_cache(maxsize=None)
def _jax_setup(kind="mha", quant="wa", bits=8.0, seed=0):
    jcfg = JCfg(**BASE, **KINDS[kind], quant=QUANTS[quant])
    jm = JEnc(jcfg)
    tokens = _tokens(jcfg, seed)
    params, _ = F.jax_vars(jm, tokens)
    if QUANTS[quant].enabled:
        params = jax.tree.map(np.asarray, jinit(params, init_bits=bits))
    return jm, params, tokens


def _setup(kind="mha", quant="wa", bits=8.0, seed=0):
    """(JAX model, params, tokens, port model on the CPU)."""
    jm, params, tokens = _jax_setup(kind, quant, bits, seed)
    model = transformer_params_from_jax(
        params, F.port_cfg(jm.cfg, TransformerConfig), device="cpu")
    return jm, params, tokens, model


def _japply(jm, params, tokens, mask=None):
    return np.asarray(jax.jit(lambda p, t, m: jm.apply(
        {"params": p}, t, attn_mask=m))(params, tokens, mask))


def _apply(model, params, tokens, mask=None):
    with torch.no_grad():
        return apply_variables(model, params, torch.from_numpy(tokens),
                               None if mask is None
                               else torch.from_numpy(mask)).numpy()


@pytest.mark.parametrize("masked", [False, True], ids=["nomask", "ragged"])
@pytest.mark.parametrize("quant", list(QUANTS))
@pytest.mark.parametrize("kind", list(KINDS))
def test_forward_matches_jax(kind, quant, masked):
    jm, params, tokens, model = _setup(kind, quant)
    mask = _ragged() if masked else None
    np.testing.assert_allclose(
        _apply(model, model.param_tree(), tokens, mask),
        _japply(jm, params, tokens, mask), rtol=1e-5, atol=1e-5)


def test_tiny_encoder_matches_jax():
    jm = jtiny(quant=JQ(enabled=True))
    tokens = np.random.default_rng(4).integers(0, 1000, (3, 64)).astype(
        np.int32)
    params = jax.tree.map(np.asarray, jinit(F.jax_vars(jm, tokens)[0],
                                            init_bits=8.0))
    model = transformer_params_from_jax(
        params, F.port_cfg(jm.cfg, TransformerConfig), device="cpu")
    assert F.trees_equal(params, model.param_tree())
    mask = np.ones((3, 64), np.int32)
    mask[1, 40:] = 0
    np.testing.assert_allclose(
        _apply(model, model.param_tree(), tokens, mask),
        _japply(jm, params, tokens, mask), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("fused", [False, True], ids=["chain", "k7_plain"])
@pytest.mark.parametrize("kind", ["mha", "llama"])
def test_qat_grads_match_jax(kind, fused, monkeypatch):
    """The gradients of a QAT loss (cross entropy under a ragged mask) on
    every leaf, the embedding's gather included; ``fused``: K7's plain
    version here, the JAX package's fused quantizer backward there."""
    jm0, params, tokens, _ = _setup(kind, "wa")
    jm = JEnc(dataclasses.replace(jm0.cfg, quant=JQ(enabled=True,
                                                     fused_vjp=fused)))
    model = TransformerEncoder(F.port_cfg(jm.cfg, TransformerConfig),
                               device="cpu")
    mask = _ragged()
    onehot = np.eye(3, dtype=np.float32)[[0, 2]]

    def jloss(p):
        y = jm.apply({"params": p}, tokens, attn_mask=mask)
        return -jnp.mean(jnp.sum(jax.nn.log_softmax(y) * onehot, -1))

    def tloss(p):
        y = apply_variables(model, p, torch.from_numpy(tokens),
                            torch.from_numpy(mask))
        return -(torch.log_softmax(y, -1) * torch.from_numpy(onehot)).sum(
            -1).mean()

    jv, jg = F.jax_value_and_grads(jloss, params)
    v, g, masses = F.port_value_and_grads(tloss, params, monkeypatch)
    np.testing.assert_allclose(v, jv, rtol=1e-5)
    per_block = 7 if kind == "llama" else 6
    assert len(masses) == 3 * 2 * (per_block * BASE["depth"] + 1)
    F.assert_grads_close(g, jg, masses)


def test_rope_matches_jax_and_its_properties():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((1, 6, 2, 8)).astype(np.float32)
    pos = np.arange(6)
    r = rope_rotate(torch.from_numpy(x), torch.from_numpy(pos)).numpy()
    np.testing.assert_allclose(r, np.asarray(jrope(jnp.asarray(x),
                                                   jnp.asarray(pos))),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(r[:, 0], x[:, 0], rtol=1e-6)
    np.testing.assert_allclose(np.linalg.norm(r, axis=-1),
                               np.linalg.norm(x, axis=-1), rtol=1e-5)
    q = torch.from_numpy(rng.standard_normal((1, 6, 2, 8)).astype(
        np.float32))
    k = torch.from_numpy(rng.standard_normal((1, 6, 2, 8)).astype(
        np.float32))
    p = torch.from_numpy(pos)
    s1 = torch.einsum("bnhd,bmhd->bhnm", rope_rotate(q, p), rope_rotate(k, p))
    s2 = torch.einsum("bnhd,bmhd->bhnm", rope_rotate(q, p + 3),
                      rope_rotate(k, p + 3))
    np.testing.assert_allclose(s1.numpy(), s2.numpy(), rtol=1e-4, atol=1e-5)
    assert np.abs(r[:, 1:] - x[:, 1:]).max() > 0.1
    # the input's dtype comes back
    assert rope_rotate(q.double(), p).dtype == torch.float64


def test_quantized_matches_fp32_at_high_bits():
    """Weight quantizers at 32 bits: the logits of the float twin."""
    jm, params, tokens, _ = _setup("mha", "off")
    qtree = jax.tree.map(np.asarray, jinit(_jax_setup("mha", "wa")[1],
                                           init_bits=32.0))
    fp = transformer_params_from_jax(params, TransformerConfig(**BASE),
                                     device="cpu")
    wq = TransformerEncoder(dataclasses.replace(
        fp.cfg, quant=F.port_quant(QUANTS["w_only"])), device="cpu")
    q_only = {k: v for k, v in flatten_tree(qtree).items()
              if not k.endswith("_act")}
    y_q = _apply(wq, F.torch_tree(unflatten_tree(q_only)), tokens)
    y_fp = _apply(fp, F.torch_tree(unflatten_tree(
        {k: v for k, v in q_only.items()
         if not k.rsplit("/", 1)[-1].startswith(F.SCALARS)})), tokens)
    np.testing.assert_allclose(y_q, y_fp, rtol=1e-2, atol=1e-3)


def test_attention_mask_changes_only_masked_tokens():
    jm, params, tokens, model = _setup("mha", "wa", bits=16.0)
    mask = np.ones((2, 16), np.int32)
    mask[:, 10:] = 0
    y_full = _apply(model, model.param_tree(), tokens)
    y_mask = _apply(model, model.param_tree(), tokens, mask)
    assert not np.allclose(y_full, y_mask) and np.isfinite(y_mask).all()
    # a masked key changes nothing: other tokens there leave y as it was
    t2 = tokens.copy()
    t2[:, 10:] = (t2[:, 10:] + 1) % BASE["vocab_size"]
    np.testing.assert_allclose(_apply(model, model.param_tree(), t2, mask),
                               y_mask, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("kind", list(KINDS))
def test_node_groups_match_jax(kind):
    jm, params, tokens, model = _setup(kind)
    groups = transformer_node_groups(model.cfg, model.param_tree())
    F.assert_groups_equal(jgroups(jm.cfg, params), groups)
    by = {g.id: g for g in groups}
    assert not by["residual_stream"].is_prunable
    assert not by["head"].is_prunable
    paths = [e.path for e in by["residual_stream"].entries]
    assert "embed/embedding" in paths and "pos_embed" in paths
    attn = by["blocks_0/attn"]
    assert attn.num_groups == attn.num_heads == model.cfg.kv_heads
    assert {"q", "k", "v"} <= {e.path.split("/")[-2] for e in attn.entries}
    mlp = {e.path for e in by["blocks_0/mlp"].entries}
    assert ("blocks_0/gate/kernel" in mlp) == (kind == "llama")


def test_gqa_kv_projection_shapes():
    jm, params, tokens, model = _setup("gqa")
    a = model.param_tree()["blocks_0"]["attn"]
    hd = 32 // 4
    assert tuple(a["q"]["kernel"].shape) == (32, 4 * hd)
    assert tuple(a["k"]["kernel"].shape) == (32, 2 * hd)
    assert tuple(a["v"]["kernel"].shape) == (32, 2 * hd)
    y = _apply(model, model.param_tree(), tokens)
    assert y.shape == (2, 3) and np.isfinite(y).all()


@pytest.mark.parametrize("kind,seed,target,div", [
    ("mha", 0, 0.5, 2), ("gqa", 5, 0.5, 1), ("llama", 9, 0.5, 1),
    ("llama", 2, None, 1)])
def test_subnet_equal_and_lossless(kind, seed, target, div):
    """Both packages zero the same groups; the subnet's params and config
    are JAX's bit for bit (whole kv groups under GQA, heads_per_block in
    query heads, SwiGLU's gate with fc1), its forward equals the zeroed
    model's, and its MACs fall."""
    jm, params, tokens, model = _setup(kind)
    joto, oto = F.otos(jm, model, params)
    jz, tz = F.zeroed(joto, oto, seed, target, div)
    assert F.trees_equal(jz, tz)
    jcfg, jp = jsub(joto.cfg, jz, joto.node_groups)
    cfg, tp = construct_subnet_transformer(oto.cfg, tz, oto.node_groups)
    assert F.port_cfg(jcfg, TransformerConfig) == cfg
    assert F.trees_equal(jp, tp)
    sub, sp = oto.construct_subnet(tz)
    assert sub.cfg == cfg
    hd, g = 32 // 4, model.cfg.q_per_kv
    assert any(h < 4 for h in cfg.heads_per_block) or any(
        m < 128 for m in cfg.hidden_per_block)
    for i, h in enumerate(cfg.heads_per_block):
        assert h % g == 0
        a = sp[f"blocks_{i}"]["attn"]
        assert a["q"]["kernel"].shape[-1] == h * hd
        assert a["k"]["kernel"].shape[-1] == (h // g) * hd
        assert a["proj"]["kernel"].shape[0] == h * hd
        hid = cfg.hidden_per_block[i]
        blk = sp[f"blocks_{i}"]
        assert blk["fc1"]["kernel"].shape[-1] == hid
        assert blk["fc2"]["kernel"].shape[0] == hid
        if kind == "llama":
            assert blk["gate"]["kernel"].shape[-1] == hid
    for mask in (None, _ragged()):
        np.testing.assert_allclose(_apply(sub, sp, tokens, mask),
                                   _apply(model, tz, tokens, mask),
                                   rtol=1e-5, atol=1e-5)
    F.assert_reports_equal(jcost(jcfg, jp), transformer_cost_report(cfg, tp))
    assert oto.compute_macs(sp) < oto.compute_macs()


def test_oto_on_compressed_model_regroups_correctly():
    jm, params, tokens, model = _setup("gqa")
    joto, oto = F.otos(jm, model, params)
    jz, tz = F.zeroed(joto, oto, 5, 0.5)
    sub, sp = oto.construct_subnet(tz)
    jsubm, jsp = joto.construct_subnet(jz)
    oto2 = OTO(sub, sp)
    F.assert_groups_equal(jgroups(jsubm.cfg, jsp), oto2.node_groups)
    by = {g.id: g for g in oto2.node_groups}
    for i in range(BASE["depth"]):
        assert by[f"blocks_{i}/attn"].num_groups == \
            sub.cfg.heads_per_block[i] // 2
        assert by[f"blocks_{i}/mlp"].num_groups == sub.cfg.hidden_per_block[i]
    z2 = oto2.random_set_zero_groups(sp, target_group_sparsity=0.4, seed=6)
    m3, p3 = oto2.construct_subnet(z2)
    np.testing.assert_allclose(_apply(m3, p3, tokens),
                               _apply(sub, z2, tokens), rtol=1e-5, atol=1e-5)
    assert oto2.compute_macs(sp) > 0
    F.assert_reports_equal(jcost(jsubm.cfg, jsp, seq_len=16),
                           transformer_cost_report(sub.cfg, sp, seq_len=16))


def test_geta_steps_prune_and_costs():
    """GETA with the loss's gradients (clipped) through projection and
    pruning: the loss stays finite, the subnet is smaller and cheaper."""
    jm, params, tokens, model = _setup("mha")
    oto = OTO(model, F.torch_tree(params))
    macs0 = oto.compute_macs()
    opt = oto.geta(lr=1e-2, target_group_sparsity=0.5,
                   start_projection_step=1, projection_steps=2,
                   projection_periods=1, start_pruning_step=3,
                   pruning_steps=2, pruning_periods=1)
    tt = torch.from_numpy(tokens)

    def loss_fn(p):
        return torch.mean(torch.square(apply_variables(model, p, tt)))

    p = oto.params
    for _ in range(8):
        leaves = {k: v.detach().requires_grad_()
                  for k, v in flatten_tree(p).items()}
        g = torch.autograd.grad(loss_fn(unflatten_tree(leaves)),
                                list(leaves.values()))
        p = opt.step(p, opt.clip_grads(unflatten_tree(dict(zip(leaves, g)))))
    with torch.no_grad():
        assert np.isfinite(float(loss_fn(p)))
    sub, sp = oto.construct_subnet(p)
    assert (any(h < 4 for h in sub.cfg.heads_per_block)
            or any(m < 128 for m in sub.cfg.hidden_per_block))
    assert oto.compute_macs(sp) < macs0

"""Port parity: the depthwise-separable CNN (``models/mobilenet.py``) with
its node groups (the depthwise merge into the producer's group), subnet
and cost report against the JAX package, on the CPU at
``mobilenet_small`` (32 x 32 x 3, batch 2), the JAX model's weights and
BN statistics carried across by ``params_from_jax``.

Tolerances as ``tests/test_torch_resnet.py`` states them (train mode in
f32 with weight quantizers only, for the reason given there; the W+A train
mode in f64 on both sides within ``F64_TOL``). Each of the JAX
package's ``tests/models/test_mobilenet.py`` tests has its case here."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quantized_vit_tpu.compress import construct_subnet_mobilenet as jsubnet
from quantized_vit_tpu.graph import mobilenet_node_groups as jgroups
from quantized_vit_tpu.graph.costs import mobilenet_cost_report as jcost
from quantized_vit_tpu.models import QuantConfig as JQ
from quantized_vit_tpu.models import init_quant_params_tree as jinit
from quantized_vit_tpu.models import mobilenet_small as jmobilenet
from quantized_vit_tpu_torch.compress import construct_subnet_mobilenet
from quantized_vit_tpu_torch.graph import (mobilenet_cost_report,
                                           mobilenet_node_groups)
from quantized_vit_tpu_torch.models import (MobileNet, MobileNetConfig,
                                            apply_variables, flatten_tree,
                                            mobilenet_params_from_jax,
                                            unflatten_tree)
from quantized_vit_tpu_torch.opt import Transform

from tests import torch_family_params as F

torch.set_num_threads(1)

QUANTS = {"off": JQ.off(), "wa": JQ(enabled=True),
          "w_only": JQ(enabled=True, quantize_acts=False)}
# the (quant, train) cases held in f64 (tests/test_torch_resnet.py)
F64_CASES = {("wa", True)}


@functools.lru_cache(maxsize=None)
def _jax_setup(quant, bits=8.0, seed=0):
    jm = jmobilenet(quant=QUANTS[quant])
    x = np.random.default_rng(seed).standard_normal(
        (2, 32, 32, 3)).astype(np.float32)
    params, stats = F.jax_vars(jm, x)
    stats = F.trained_like_stats(stats, seed)
    if QUANTS[quant].enabled:
        params = jax.tree.map(np.asarray, jinit(params, init_bits=bits))
    return jm, params, stats, x


def _setup(quant="wa"):
    """(JAX model, params, stats, x, port model on the CPU)."""
    jm, params, stats, x = _jax_setup(quant)
    model = mobilenet_params_from_jax(
        params, F.port_cfg(jm.cfg, MobileNetConfig), stats, device="cpu")
    return jm, params, stats, x, model


def _japply(jm, params, stats, x, train=False):
    out = jax.jit(lambda v, x: jm.apply(
        v, x, deterministic=not train,
        mutable=["batch_stats"] if train else False))(
            {"params": params, "batch_stats": stats}, x)
    if train:
        return np.asarray(out[0]), jax.tree.map(np.asarray,
                                                out[1]["batch_stats"])
    return np.asarray(out)


@pytest.mark.parametrize("quant,train", [
    ("off", False), ("wa", False), ("w_only", False), ("off", True),
    ("w_only", True), ("wa", True)])
def test_forward_matches_jax(quant, train):
    jm, params, stats, x, model = _setup(quant)
    f64 = (quant, train) in F64_CASES
    tol = F.F64_TOL if f64 else 1e-5
    if f64:
        params, stats, x = F.to_f64(params), F.to_f64(stats), x.astype(
            np.float64)
    xt = torch.from_numpy(x)
    with torch.no_grad():
        if train:
            # f64: the f64 trees; else the port model's own
            ptree = F.torch_tree(params) if f64 else model.param_tree()
            stree = (F.torch_tree(stats) if f64
                     else model.batch_stats_tree())
            y, new = apply_variables(model, ptree, xt, batch_stats=stree,
                                     mutable=True, deterministic=False)
            jy, jnew = _japply(jm, params, stats, x, train=True)
            got = flatten_tree(new)
            for k, v in flatten_tree(jnew).items():
                np.testing.assert_allclose(got[k].numpy(), v, rtol=tol,
                                           atol=tol)
        else:
            y, jy = model(xt), _japply(jm, params, stats, x)
    assert y.dtype == (torch.float64 if f64 else torch.float32)
    np.testing.assert_allclose(y.numpy(), jy, rtol=tol, atol=tol)


@pytest.mark.parametrize("fused", [False, True], ids=["chain", "k7_plain"])
@pytest.mark.parametrize("quant,train", [("wa", False), ("w_only", True),
                                         ("wa", True)])
def test_qat_grads_match_jax(quant, train, fused, monkeypatch):
    """The gradients of one QAT loss (mean squared logits, the JAX test's)
    on every leaf; ``fused``: K7's plain version here, the JAX package's
    fused quantizer backward there. The depthwise kernels [3, 3, 1, C]
    take K7 as any other weight."""
    jm = jmobilenet(quant=JQ(**{**vars(QUANTS[quant]), "fused_vjp": fused}))
    _, params, stats, x, _ = _setup(quant)
    f64 = (quant, train) in F64_CASES
    if f64:
        params, stats, x = F.to_f64(params), F.to_f64(stats), x.astype(
            np.float64)
    model = MobileNet(F.port_cfg(jm.cfg, MobileNetConfig), device="cpu")

    def jloss(p):
        y = jm.apply({"params": p, "batch_stats": stats}, x,
                     deterministic=not train,
                     mutable=["batch_stats"] if train else False)
        return jnp.mean(jnp.square(y[0] if train else y))

    def tloss(p):
        y = apply_variables(model, p, torch.from_numpy(x),
                            batch_stats=F.torch_tree(stats), mutable=train,
                            deterministic=not train)
        return torch.mean(torch.square(y[0] if train else y))

    jv, jg = F.jax_value_and_grads(jloss, params)
    v, g, masses = F.port_value_and_grads(tloss, params, monkeypatch)
    np.testing.assert_allclose(v, jv, rtol=F.F64_TOL if f64 else 1e-5)
    # stem, three depthwise and three pointwise convs, head
    assert len(masses) == 3 * (2 if quant == "wa" else 1) * 8
    F.assert_grads_close(g, jg, masses, f64=f64)


def test_depthwise_conv_shapes_and_forward():
    _, params, stats, x, model = _setup("off")
    tree = model.param_tree()
    assert tuple(tree["dw_0"]["kernel"].shape) == (3, 3, 1, 8)
    assert tuple(tree["dw_1"]["kernel"].shape) == (3, 3, 1, 16)
    assert F.trees_equal(params, tree)
    assert F.trees_equal(stats, model.batch_stats_tree())
    with torch.no_grad():
        y = model(torch.from_numpy(x))
    assert tuple(y.shape) == (2, 10) and bool(torch.isfinite(y).all())


def test_node_groups_merge_depthwise_into_producer():
    jm, params, stats, x, model = _setup("wa")
    groups = mobilenet_node_groups(model.cfg, model.param_tree())
    F.assert_groups_equal(jgroups(jm.cfg, params), groups)
    by = {g.id: g for g in groups}
    stem = {e.path for e in by["stem"].entries}
    assert {"stem_conv/kernel", "dw_0/kernel", "dw_bn_0/scale"} <= stem
    assert by["stem"].num_groups == model.cfg.stem_width
    pw0 = {e.path for e in by["pw_0"].entries}
    assert "pw_0/kernel" in pw0 and "dw_1/kernel" in pw0
    last = by[f"pw_{len(model.cfg.widths) - 1}"]
    assert not any("dw_" in e.path for e in last.entries)
    tf = {e.path: e.transform for e in by["pw_0"].entries}
    assert tf["pw_0/d_quant_wt"] == Transform.NO_PRUNE
    assert not by["head"].is_prunable


@pytest.mark.parametrize("seed,target,div", [(3, 0.4, 1), (1, None, 1),
                                             (4, 0.5, 2)])
def test_zero_groups_then_compress_is_lossless_and_equal(seed, target, div):
    jm, params, stats, x, model = _setup("wa")
    joto, oto = F.otos(jm, model, params, stats)
    jz, tz = F.zeroed(joto, oto, seed, target, div)
    assert F.trees_equal(jz, tz)
    jcfg, jp, js = jsubnet(joto.cfg, jz, joto.node_groups, joto.batch_stats)
    cfg, tp, ts = construct_subnet_mobilenet(oto.cfg, tz, oto.node_groups,
                                             oto.batch_stats)
    assert F.port_cfg(jcfg, MobileNetConfig) == cfg
    assert F.trees_equal(jp, tp) and F.trees_equal(js, ts)
    sub, sp, ss = oto.construct_subnet(tz)
    assert sub.cfg == cfg and sub.cfg.widths != model.cfg.widths
    for i, w in enumerate(sub.cfg.widths[:-1]):
        assert sp[f"dw_{i + 1}"]["kernel"].shape[-1] == w
    xt = torch.from_numpy(x)
    with torch.no_grad():
        y_sparse = apply_variables(model, tz, xt,
                                   batch_stats=oto.batch_stats)
        y_sub = sub(xt)
    np.testing.assert_allclose(y_sub.numpy(), y_sparse.numpy(), rtol=1e-5,
                               atol=1e-5)
    F.assert_reports_equal(jcost(jcfg, jp), mobilenet_cost_report(cfg, tp))


def test_cost_report_counts_depthwise_cheaply():
    jm, params, stats, x, model = _setup("wa")
    joto, oto = F.otos(jm, model, params, stats)
    report = oto._report()
    F.assert_reports_equal(jcost(jm.cfg, joto.params), report)
    assert report["per_layer"]["dw_1"]["macs"] < \
        report["per_layer"]["pw_1"]["macs"]
    assert oto.compute_macs() > 0
    assert 8.0 < oto.compute_average_bit_width() < 32.0


def test_hesso_prunes_mobilenet_to_target():
    """HESSO on the gradients of mean(y^2) shrinks the subnet, which
    runs; the same zero-group count as the JAX optimizer's on its own
    gradients."""
    jm, params, stats, x, model = _setup("wa")
    joto, oto = F.otos(jm, model, params, stats)
    kw = dict(lr=1e-2, target_group_sparsity=0.3, start_pruning_step=2,
              pruning_steps=8, pruning_periods=2)
    opt, jopt = oto.hesso(**kw), joto.hesso(**kw)
    jgrad = jax.jit(jax.grad(lambda p: jnp.mean(jnp.square(jm.apply(
        {"params": p, "batch_stats": joto.batch_stats}, x)))))
    xt = torch.from_numpy(x)
    p, jp = oto.params, joto.params
    for _ in range(14):
        leaves = {k: v.detach().requires_grad_()
                  for k, v in flatten_tree(p).items()}
        loss = torch.mean(torch.square(apply_variables(
            model, unflatten_tree(leaves), xt, batch_stats=oto.batch_stats)))
        g = torch.autograd.grad(loss, list(leaves.values()))
        p = opt.step(p, unflatten_tree(dict(zip(leaves, g))))
        jp = jopt.step(jp, jgrad(jp))
    assert opt.compute_metrics(p)["num_zero_groups"] == \
        jopt.compute_metrics(jp)["num_zero_groups"]
    m2, p2, s2 = oto.construct_subnet(p)
    assert (sum(m2.cfg.widths) + m2.cfg.stem_width
            < sum(model.cfg.widths) + model.cfg.stem_width)
    with torch.no_grad():
        assert bool(torch.isfinite(m2(xt)).all())

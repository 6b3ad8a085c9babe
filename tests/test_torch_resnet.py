"""Port parity: the residual CNN (``models/resnet.py``) with its node
groups, subnet and cost report against the JAX package, on the CPU at
``resnet8`` (32 x 32 x 3, batch 2), the JAX model's weights and BN
statistics carried across by ``params_from_jax``.

Tolerances: the forward (quant off and on, with and without activation
quantizers) within rtol 1e-5, atol 1e-5 of JAX's, the updated running
statistics too; the gradients of a QAT loss as
``tests/torch_family_params.py`` states; node groups, subnet params and
configs exact; cost reports within 1e-9 relative. Each of the JAX
package's ``tests/models/test_resnet.py`` tests has its case here.

Train mode (BatchNorms on the batch's statistics) runs in f32 with weight
quantizers only. At init the activation quantizers' q_m comes from the
weights' range and clips most activations, so some channels reach a
train-mode BatchNorm nearly constant, and its fast variance ``E[x^2] -
E[x]^2`` cancels: the port's own f32 gradients there differ from its f64
ones by 5-8%, so f32 sums in XLA's order and PyTorch's cannot agree to
1e-5. The W+A train mode, the one a GETA run trains in, runs in f64 on
both sides (params, statistics and input as f64 numpy), the forward, the
statistics and every gradient within ``F64_TOL`` (1e-9;
``tests/torch_family_params.py``)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quantized_vit_tpu.compress import construct_subnet_resnet as jsubnet
from quantized_vit_tpu.graph import resnet_node_groups as jgroups
from quantized_vit_tpu.graph.costs import resnet_cost_report as jcost
from quantized_vit_tpu.models import QuantConfig as JQ
from quantized_vit_tpu.models import init_quant_params_tree as jinit
from quantized_vit_tpu.models import resnet8 as jresnet8
from quantized_vit_tpu_torch.compress import construct_subnet_resnet
from quantized_vit_tpu_torch.graph import (OTO, resnet_cost_report,
                                           resnet_node_groups)
from quantized_vit_tpu_torch.models import (QuantConfig, ResNet,
                                            ResNetConfig, apply_variables,
                                            flatten_tree,
                                            init_quant_params_tree,
                                            resnet_params_from_jax,
                                            unflatten_tree)
from quantized_vit_tpu_torch.opt import Transform

from tests import torch_family_params as F

torch.set_num_threads(1)

QUANTS = {"off": JQ.off(), "wa": JQ(enabled=True),
          "w_only": JQ(enabled=True, quantize_acts=False)}
LABELS = np.array([3, 7])
# the (quant, train) cases held in f64 (the module docstring)
F64_CASES = {("wa", True)}


def _x(seed=0, batch=2):
    return np.random.default_rng(seed).standard_normal(
        (batch, 32, 32, 3)).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _jax_setup(quant, bits, seed):
    jm = jresnet8(quant=QUANTS[quant])
    x = _x(seed)
    params, stats = F.jax_vars(jm, x)
    stats = F.trained_like_stats(stats, seed)
    if QUANTS[quant].enabled:
        params = jax.tree.map(np.asarray, jinit(params, init_bits=bits))
    return jm, params, stats, x


def _setup(quant="wa", bits=8.0, seed=0):
    """(JAX model, params, stats, x, port model on the CPU)."""
    jm, params, stats, x = _jax_setup(quant, bits, seed)
    model = resnet_params_from_jax(params, F.port_cfg(jm.cfg, ResNetConfig),
                                   stats, device="cpu")
    return jm, params, stats, x, model


def _japply(jm, params, stats, x, train=False):
    v = {"params": params, "batch_stats": stats}
    if train:
        y, new = jax.jit(lambda v, x: jm.apply(
            v, x, deterministic=False, mutable=["batch_stats"]))(v, x)
        return np.asarray(y), jax.tree.map(np.asarray, new["batch_stats"])
    return np.asarray(jax.jit(lambda v, x: jm.apply(
        v, x, deterministic=True))(v, x))


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
            for k, v in flatten_tree(jnew).items():
                np.testing.assert_allclose(
                    flatten_tree(new)[k].numpy(), v, rtol=tol, atol=tol)
            # the given trees stay as they were
            assert F.trees_equal(stats, stree if f64
                                 else model.batch_stats_tree())
        else:
            y, jy = model(xt), _japply(jm, params, stats, x)
    assert y.dtype == (torch.float64 if f64 else torch.float32)
    np.testing.assert_allclose(y.numpy(), jy, rtol=tol, atol=tol)


@pytest.mark.parametrize("fused", [False, True], ids=["chain", "k7_plain"])
@pytest.mark.parametrize("quant,train", [("wa", False), ("w_only", True),
                                         ("wa", True)])
def test_qat_grads_match_jax(quant, train, fused, monkeypatch):
    """One QAT loss (cross entropy) and the gradient of every leaf;
    ``fused`` runs K7's plain version here against the JAX package's
    fused quantizer backward."""
    q = JQ(**{**vars(QUANTS[quant]), "fused_vjp": fused})
    jm = jresnet8(quant=q)
    _, params, stats, x, _ = _setup(quant)
    f64 = (quant, train) in F64_CASES
    if f64:
        params, stats, x = F.to_f64(params), F.to_f64(stats), x.astype(
            np.float64)
    model = ResNet(F.port_cfg(jm.cfg, ResNetConfig), device="cpu")
    onehot = np.eye(10, dtype=x.dtype)[LABELS]

    def jloss(p):
        y = jm.apply({"params": p, "batch_stats": stats}, x,
                     deterministic=not train,
                     mutable=["batch_stats"] if train else False)
        y = y[0] if train else y
        return -jnp.mean(jnp.sum(jax.nn.log_softmax(y) * onehot, -1))

    def tloss(p):
        y = apply_variables(model, p, torch.from_numpy(x),
                            batch_stats=F.torch_tree(stats), mutable=train,
                            deterministic=not train)
        y = y[0] if train else y
        return -(torch.log_softmax(y, -1) * torch.from_numpy(onehot)).sum(
            -1).mean()

    jv, jg = F.jax_value_and_grads(jloss, params)
    v, g, masses = F.port_value_and_grads(tloss, params, monkeypatch)
    np.testing.assert_allclose(v, jv, rtol=F.F64_TOL if f64 else 1e-5)
    # 10 quantized layers (stem, 6 block convs, 2 downsample convs, head),
    # one or two quantizers each
    assert len(masses) == 3 * (2 if quant == "wa" else 1) * 10
    F.assert_grads_close(g, jg, masses, f64=f64)


def test_params_from_jax_round_trip_is_exact():
    _, params, stats, _, model = _setup("wa")
    assert F.trees_equal(params, model.param_tree())
    assert F.trees_equal(stats, model.batch_stats_tree())


def test_quantized_resnet_matches_fp32_at_high_bits():
    """Weight-only quantizers at 16 bits stay near the float model (the
    activation quantizer's first q_m comes from the weight range and
    would clip ReLU outputs before any training, as in the reference)."""
    jm, params, stats, x, model = _setup("off")
    q = ResNet(ResNetConfig(stage_sizes=(1, 1, 1), quant=QuantConfig(
        enabled=True, quantize_acts=False)), device="cpu")
    qp = dict(flatten_tree(q.param_tree()))
    qp.update(flatten_tree(model.param_tree()))
    qparams = init_quant_params_tree(unflatten_tree(qp), init_bits=16.0)
    xt = torch.from_numpy(x)
    with torch.no_grad():
        y_f = model(xt).numpy()
        y_q = apply_variables(q, qparams, xt,
                              batch_stats=model.batch_stats_tree()).numpy()
    np.testing.assert_allclose(y_q, y_f, rtol=1e-2, atol=1e-2)
    jq = jresnet8(quant=QUANTS["w_only"])
    jqp = jax.tree.map(np.asarray, jinit(unflatten_tree(
        {**flatten_tree(F.jax_vars(jq, x)[0]), **flatten_tree(params)}),
        init_bits=16.0))
    np.testing.assert_allclose(y_q, _japply(jq, jqp, stats, x), rtol=1e-5,
                               atol=1e-5)


def test_node_groups_match_jax_and_structure():
    jm, params, stats, x, model = _setup("wa")
    groups = resnet_node_groups(model.cfg, model.param_tree())
    F.assert_groups_equal(jgroups(jm.cfg, params), groups)
    by = {g.id: g for g in groups}
    paths0 = {e.path for e in by["stream_0"].entries}
    assert {"stem_conv/kernel", "stage0_block0/conv2/kernel"} <= paths0
    assert by["stream_0"].num_groups == 16 and by["stream_0"].is_prunable
    paths1 = {e.path for e in by["stream_1"].entries}
    assert {"stage1_block0/down_conv/kernel",
            "stage1_block0/bn2/scale"} <= paths1
    assert by["stage2_block0"].num_groups == 64
    tf = {e.path.split("/")[-1]: e.transform
          for e in by["stage2_block0"].entries}
    assert tf["d_quant_wt"] == Transform.NO_PRUNE
    assert not by["head"].is_prunable


@pytest.mark.parametrize("seed,target,div", [(7, 0.4, 1), (2, 0.5, 1),
                                             (3, None, 2)])
def test_zero_groups_then_compress_is_lossless_and_equal(seed, target, div):
    jm, params, stats, x, model = _setup("wa")
    joto, oto = F.otos(jm, model, params, stats)
    jz, tz = F.zeroed(joto, oto, seed, target, div)
    assert F.trees_equal(jz, tz)
    jcfg, jp, js = jsubnet(joto.cfg, jz, joto.node_groups,
                           joto.batch_stats)
    cfg, tp, ts = construct_subnet_resnet(oto.cfg, tz, oto.node_groups,
                                          oto.batch_stats)
    assert F.port_cfg(jcfg, ResNetConfig) == cfg
    assert F.trees_equal(jp, tp) and F.trees_equal(js, ts)
    sub, sp, ss = oto.construct_subnet(tz)
    assert sub.cfg == cfg and sub.cfg.widths != model.cfg.widths
    assert sub.cfg.inner_widths is not None
    leaves = flatten_tree(sp)
    for k, v in sub.named_parameters():
        assert v.data_ptr() == leaves[k.replace(".", "/")].data_ptr(), k
    xt = torch.from_numpy(x)
    with torch.no_grad():
        y_sparse = apply_variables(model, tz, xt,
                                   batch_stats=oto.batch_stats)
        y_sub = sub(xt)
    np.testing.assert_allclose(y_sub.numpy(), y_sparse.numpy(), rtol=1e-5,
                               atol=1e-5)


def test_cost_report_matches_jax_and_decreases():
    jm, params, stats, x, model = _setup("wa")
    joto, oto = F.otos(jm, model, params, stats)
    F.assert_reports_equal(jcost(jm.cfg, jax.tree.map(jnp.asarray, params)),
                           resnet_cost_report(oto.cfg, oto.params))
    full_macs = oto.compute_macs()
    full_params = oto.compute_num_params()
    jz, tz = F.zeroed(joto, oto, 2, 0.5)
    sub, sp, ss = oto.construct_subnet(tz)
    jsub, jsp, _ = joto.construct_subnet(jz)
    oto2 = OTO(sub, sp, batch_stats=ss)
    F.assert_reports_equal(jcost(jsub.cfg, jsp), oto2._report(sp))
    assert oto2.compute_macs(sp) < full_macs
    assert oto2.compute_num_params(sp) < full_params
    assert oto.compute_average_bit_width() == pytest.approx(8.0, abs=1)


def test_hesso_trains_and_prunes():
    """HESSO over the residual-CNN groups on seeded random gradients
    reaches the target group sparsity, as the JAX optimizer does on the
    same gradients, and the subnet runs."""
    jm, params, stats, x, model = _setup("wa")
    joto, oto = F.otos(jm, model, params, stats)
    kw = dict(lr=1e-3, target_group_sparsity=0.3, start_pruning_step=2,
              pruning_steps=8, pruning_periods=2)
    opt, jopt = oto.hesso(**kw), joto.hesso(**kw)
    rng = np.random.default_rng(0)
    p, jp = oto.params, joto.params
    for _ in range(14):
        g = {k: (rng.standard_normal(v.shape) * 1e-3).astype(np.float32)
             for k, v in flatten_tree(params).items()}
        p = opt.step(p, F.torch_tree(unflatten_tree(g)))
        jp = jopt.step(jp, jax.tree.map(jnp.asarray, unflatten_tree(g)))
    met, jmet = opt.compute_metrics(p), jopt.compute_metrics(jp)
    assert met["group_sparsity"] == pytest.approx(0.3, abs=0.05)
    assert met["num_zero_groups"] == jmet["num_zero_groups"]
    sub, sp, ss = oto.construct_subnet(p)
    with torch.no_grad():
        assert tuple(sub(torch.from_numpy(x)).shape) == (2, 10)

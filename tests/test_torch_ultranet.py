"""Port parity: UltraNet (``quant/dorefa.py``, ``quant/integer.py``,
``models/ultranet.py``, the node groups) against the JAX package, on the
CPU at 32 x 64 input, the inputs drawn from numpy seeds
(``tests/torch_ultranet_params.py``).

Tolerances. Where both packages run the same f32 operations on the same
inputs (the straight-through quantizers on a given input, the BN fold,
the integer tables, the integer requantization, the integer forward's
raw predictions) the results are equal bit for bit. Where a library
transcendental (tanh, exp, sigmoid) or a reduction or conv in its own
order enters, values agree within the stated tolerance, and a quantizer
level may differ by one only where the port's value before rounding lies
within 1e-5 of a half-level (``held_at_ties``). The whole network is held
layer by layer on the JAX package's activations (each layer's input
taken from JAX, so a tie flip cannot spread), and end to end where no
level flipped."""

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quantized_vit_tpu.artifact import export_ultranet_int as jexport
from quantized_vit_tpu.graph import ultranet_node_groups as jgroups
from quantized_vit_tpu.models import ULTRANET_LAYERS
from quantized_vit_tpu.models import UltraNetInt as JUltraNetInt
from quantized_vit_tpu.models import ultranet as jm
from quantized_vit_tpu.quant import dorefa as jd
from quantized_vit_tpu.quant import integer as ji
from quantized_vit_tpu_torch.graph import ultranet_node_groups
from quantized_vit_tpu_torch.models import ultranet as tm
from quantized_vit_tpu_torch.quant import dorefa as td
from quantized_vit_tpu_torch.quant import integer as ti

from tests import torch_ultranet_params as U

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def net():
    return U.trained_like(0, batch=2)


def _t(a, grad=False):
    return torch.from_numpy(np.array(a)).requires_grad_(grad)


def _np(t):
    return t.detach().numpy()


# ---------------------------------------------------------------------------
# quantizers, with their gradients
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("k", [1, 2, 4, 8, 32])
def test_uniform_quantize_equal_with_gradient(k):
    """Value and straight-through gradient bit-equal (the same f32
    ops)."""
    rng = np.random.default_rng(k)
    x = rng.standard_normal((64, 33)).astype(np.float32)
    g = rng.standard_normal((64, 33)).astype(np.float32)
    jv, jg = jax.value_and_grad(
        lambda v: jnp.sum(jd.uniform_quantize(v, k) * g))(jnp.asarray(x))
    xt = _t(x, True)
    v = (td.uniform_quantize(xt, k) * _t(g)).sum()
    v.backward()
    np.testing.assert_array_equal(
        _np(td.uniform_quantize(_t(x), k)),
        np.asarray(jd.uniform_quantize(jnp.asarray(x), k)))
    np.testing.assert_array_equal(_np(xt.grad), np.asarray(jg))


@pytest.mark.parametrize("w_bit,tied_max", [(1, False), (2, False),
                                            (4, False), (4, True),
                                            (8, False), (32, False)])
def test_quantize_weight_with_gradient(w_bit, tied_max):
    """Levels equal off ties (tanh differs by ulps); the gradient, through
    tanh and max|tanh| (split evenly over tied maxima in both), within
    1e-5 relative."""
    rng = np.random.default_rng(w_bit)
    w = rng.normal(0, 0.5, (3, 3, 8, 16)).astype(np.float32)
    if tied_max:
        w[0, 0, 0, 0], w[1, 2, 3, 4] = 2.5, -2.5
    g = rng.standard_normal(w.shape).astype(np.float32)
    jq, jg = jax.value_and_grad(
        lambda v: jnp.sum(jd.quantize_weight(v, w_bit) * g))(jnp.asarray(w))
    jq = np.asarray(jd.quantize_weight(jnp.asarray(w), w_bit))
    wt = _t(w, True)
    q = td.quantize_weight(wt, w_bit)
    (q * _t(g)).sum().backward()
    if w_bit in (1, 32):
        np.testing.assert_allclose(_np(q), jq, rtol=1e-6, atol=0)
    else:
        n = 2 ** (w_bit - 1) - 1
        th = np.tanh(w.astype(np.float64))
        pre = th / np.abs(th).max() * n
        U.held_at_ties(np.round(jq * n), np.round(_np(q) * n), pre, "w")
    np.testing.assert_allclose(_np(wt.grad), np.asarray(jg), rtol=1e-5,
                               atol=1e-6)
    if tied_max:  # both maxima take half of the max's gradient
        gw = _np(wt.grad)
        assert gw[0, 0, 0, 0] != 0 and gw[1, 2, 3, 4] != 0


@pytest.mark.parametrize("a_bit", [2, 4, 8, 32])
def test_quantize_activation_equal_with_gradient(a_bit):
    rng = np.random.default_rng(10 + a_bit)
    x = rng.uniform(-0.5, 1.5, (16, 40)).astype(np.float32)
    g = rng.standard_normal(x.shape).astype(np.float32)
    jv, jg = jax.value_and_grad(
        lambda v: jnp.sum(jd.quantize_activation(v, a_bit) * g))(
            jnp.asarray(x))
    xt = _t(x, True)
    q = td.quantize_activation(xt, a_bit)
    (q * _t(g)).sum().backward()
    np.testing.assert_array_equal(
        _np(q), np.asarray(jd.quantize_activation(jnp.asarray(x), a_bit)))
    np.testing.assert_array_equal(_np(xt.grad), np.asarray(jg))


def test_level_functions():
    rng = np.random.default_rng(3)
    w = rng.normal(0, 0.5, (3, 3, 16, 32)).astype(np.float32)
    x = rng.uniform(-0.5, 1.5, (8, 64)).astype(np.float32)
    for bits in (2, 4, 8):
        n = 2 ** (bits - 1) - 1
        th = np.tanh(w.astype(np.float64))
        U.held_at_ties(jd.quantize_weight_levels(jnp.asarray(w), bits),
                       td.quantize_weight_levels(_t(w), bits),
                       th / np.abs(th).max() * n, "levels")
        np.testing.assert_array_equal(
            _np(td.quantize_activation_levels(_t(x), bits)),
            np.asarray(jd.quantize_activation_levels(jnp.asarray(x), bits)))


@pytest.mark.parametrize("w_bit", [2, 4, 8])
def test_fold_batchnorm_equal_with_gradient(w_bit):
    """The reference's sqrt(var) + eps fold: bit-equal values (IEEE sqrt
    and division in both), the gradients of gamma and beta equal."""
    rng = np.random.default_rng(20 + w_bit)
    c = 48
    gamma = rng.uniform(0.2, 1.8, c).astype(np.float32)
    beta = rng.normal(0, 0.5, c).astype(np.float32)
    mean = rng.normal(0, 0.5, c).astype(np.float32)
    var = rng.uniform(0.1, 2.0, c).astype(np.float32)
    g = rng.standard_normal((2, c)).astype(np.float32)

    def jf(ga, be):
        wq, bq = jd.fold_batchnorm(ga, be, mean, var, 1e-5, w_bit)
        return jnp.sum(wq * g[0]) + jnp.sum(bq * g[1])

    jgrads = jax.grad(jf, argnums=(0, 1))(jnp.asarray(gamma),
                                          jnp.asarray(beta))
    ga, be = _t(gamma, True), _t(beta, True)
    wq, bq = td.fold_batchnorm(ga, be, _t(mean), _t(var), 1e-5, w_bit)
    ((wq * _t(g[0])).sum() + (bq * _t(g[1])).sum()).backward()
    jwq, jbq = jd.fold_batchnorm(gamma, beta, mean, var, 1e-5, w_bit)
    np.testing.assert_array_equal(_np(wq), np.asarray(jwq))
    np.testing.assert_array_equal(_np(bq), np.asarray(jbq))
    np.testing.assert_allclose(_np(ga.grad), np.asarray(jgrads[0]),
                               rtol=1e-6, atol=0)
    np.testing.assert_allclose(_np(be.grad), np.asarray(jgrads[1]),
                               rtol=1e-6, atol=0)
    jw, jb = jd.fold_batchnorm_affine(gamma, beta, mean, var, 1e-5)
    tw, tb = td.fold_batchnorm_affine(_t(gamma), _t(beta), _t(mean),
                                      _t(var), 1e-5)
    np.testing.assert_array_equal(_np(tw), np.asarray(jw))
    np.testing.assert_array_equal(_np(tb), np.asarray(jb))


# ---------------------------------------------------------------------------
# integer export math
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("w_bit,in_bit,l_shift", [(4, 8, 8), (4, 4, 8),
                                                  (2, 4, 4), (8, 4, 6)])
def test_integer_tables_equal(w_bit, in_bit, l_shift):
    """``bn_act_quantize_int`` bit-equal: f32 in the JAX function's order,
    its Python constants as f32 scalars; the weight levels off ties."""
    rng = np.random.default_rng(w_bit * 100 + in_bit)
    c = 64
    args = (rng.uniform(0.5, 1.5, c).astype(np.float32),
            rng.normal(0, 0.1, c).astype(np.float32),
            rng.normal(0, 0.05, c).astype(np.float32),
            rng.uniform(0.5, 1.5, c).astype(np.float32))
    kw = dict(w_bit=w_bit, in_bit=in_bit, out_bit=4, l_shift=l_shift)
    j_inc, j_bias = ji.bn_act_quantize_int(*args, 1e-5, **kw)
    t_inc, t_bias = ti.bn_act_quantize_int(*map(_t, args), 1e-5, **kw)
    assert t_inc.dtype == t_bias.dtype == torch.int32
    np.testing.assert_array_equal(_np(t_inc), np.asarray(j_inc))
    np.testing.assert_array_equal(_np(t_bias), np.asarray(j_bias))
    jw, jb = ji.bn_act_w_bias_float(*args, 1e-5)
    tw, tb = ti.bn_act_w_bias_float(*map(_t, args), 1e-5)
    np.testing.assert_array_equal(_np(tw), np.asarray(jw))
    np.testing.assert_array_equal(_np(tb), np.asarray(jb))
    w = rng.normal(0, 0.3, (3, 3, 16, c)).astype(np.float32)
    th = np.tanh(w.astype(np.float64))
    pre = th / np.abs(th).max() * (2 ** (w_bit - 1) - 1)
    U.held_at_ties(ji.weight_quantize_int(jnp.asarray(w), w_bit),
                   ti.weight_quantize_int(_t(w), w_bit), pre, "int")
    U.held_at_ties(
        np.asarray(ji.weight_quantize_float(jnp.asarray(w), w_bit))
        * (2 ** (w_bit - 1) - 1),
        _np(ti.weight_quantize_float(_t(w), w_bit))
        * (2 ** (w_bit - 1) - 1), pre, "float")
    np.testing.assert_array_equal(
        _np(ti.uniform_quantize(_t(w), 3)),
        np.asarray(ji.uniform_quantize(jnp.asarray(w), 3)))


def test_requantize_int_int64_equal():
    """Exact integers, against the JAX function with x64 on (as the tests
    run it): accumulators to the extreme 60,480 and BN scales whose
    ``acc * inc`` leaves int32's range (the port computes in int64 on
    every device; ROADMAP.md, C1.7)."""
    rng = np.random.default_rng(5)
    acc = rng.integers(-60480, 60481, (4, 10, 20, 64)).astype(np.int32)
    acc[0, 0, 0, :2] = (60480, -60480)
    inc = rng.integers(-60000, 60000, 64).astype(np.int32)
    bias = rng.integers(-2**30, 2**30, 64).astype(np.int32)
    assert np.abs(acc.astype(np.int64) * inc).max() > 2**31
    for in_bit in (4, 8):
        want = ji.requantize_int(jnp.asarray(acc), jnp.asarray(inc),
                                 jnp.asarray(bias), w_bit=4, in_bit=in_bit,
                                 out_bit=4, l_shift=8)
        got = ti.requantize_int(_t(acc), _t(inc), _t(bias), w_bit=4,
                                in_bit=in_bit, out_bit=4, l_shift=8)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(_np(got), np.asarray(want))
        assert 0 < np.asarray(want).mean() < 15


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------


def _flax_vars(module, x, *a, **k):
    v = module.init(jax.random.PRNGKey(0), jnp.asarray(x), *a, **k)
    return jax.tree.map(np.asarray, flax.core.unfreeze(v))


@pytest.mark.parametrize("case", ["same", "valid_bias", "w8"])
def test_dorefa_conv_and_dense(case):
    """Outputs within 1e-5 (the convs' f32 sums in their own orders)."""
    rng = np.random.default_rng(30)
    x = rng.standard_normal((2, 12, 20, 8)).astype(np.float32)
    kw = {"same": dict(), "valid_bias": dict(padding="VALID",
                                             use_bias=True),
          "w8": dict(w_bit=8)}[case]
    jmod = jm.DoReFaConv(16, 3, **kw)
    v = _flax_vars(jmod, x)
    if "bias" in v["params"]:
        v["params"]["bias"] = rng.standard_normal(16).astype(np.float32)
    want = np.asarray(jmod.apply(v, jnp.asarray(x)))
    mod = tm.DoReFaConv(8, 16, 3, device="cpu", **kw)
    mod.kernel.data.copy_(_t(v["params"]["kernel"]))
    if mod.bias is not None:
        mod.bias.data.copy_(_t(v["params"]["bias"]))
    np.testing.assert_allclose(_np(mod(_t(x))), want, rtol=1e-5, atol=1e-5)
    xd = rng.standard_normal((5, 24)).astype(np.float32)
    jd_ = jm.DoReFaDense(10, w_bit=kw.get("w_bit", 4))
    vd = _flax_vars(jd_, xd)
    vd["params"]["bias"] = rng.standard_normal(10).astype(np.float32)
    dense = tm.DoReFaDense(24, 10, w_bit=kw.get("w_bit", 4), device="cpu")
    dense.kernel.data.copy_(_t(vd["params"]["kernel"]))
    dense.bias.data.copy_(_t(vd["params"]["bias"]))
    np.testing.assert_allclose(_np(dense(_t(xd))),
                               np.asarray(jd_.apply(vd, jnp.asarray(xd))),
                               rtol=1e-5, atol=1e-5)


def _bn_vars(rng, c):
    return ({"scale": rng.uniform(0.5, 1.5, c).astype(np.float32),
             "bias": rng.normal(0, 0.2, c).astype(np.float32)},
            {"mean": rng.normal(0, 0.3, c).astype(np.float32),
             "var": rng.uniform(0.3, 1.7, c).astype(np.float32)})


def _load_bn(mod, p, s):
    for name, v in {**p, **s}.items():
        getattr(mod, name).data.copy_(_t(v))
    return mod


@pytest.mark.parametrize("kind", ["bn2d_q", "bn1d_eval", "bn1d_train"])
def test_dorefa_batchnorms(kind):
    """BatchNorm2d_Q bit-equal (the fold, then an affine); BatchNorm1d_Q
    within 1e-5 in training (its batch variance, an rsqrt)."""
    rng = np.random.default_rng(40)
    c = 24
    p, s = _bn_vars(rng, c)
    if kind == "bn2d_q":
        x = rng.standard_normal((2, 6, 7, c)).astype(np.float32)
        jmod, mod, kw = jm.DoReFaBatchNorm(), tm.DoReFaBatchNorm(
            c, device="cpu"), {}
    else:
        x = rng.standard_normal((16, c)).astype(np.float32)
        jmod = jm.DoReFaBatchNorm1d()
        mod = tm.DoReFaBatchNorm1d(c, device="cpu")
        kw = {"train": kind == "bn1d_train"}
    want = np.asarray(jmod.apply({"params": p, "batch_stats": s},
                                 jnp.asarray(x), **kw))
    got = _np(_load_bn(mod, p, s)(_t(x), **kw))
    if kind == "bn1d_train":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("train", [False, True])
def test_flax_batchnorm_both_modes(train):
    """flax's BatchNorm (momentum 0.9, eps 1e-5, the fast variance): the
    output within 1e-5, the updated running statistics within 1e-6
    relative, the gradients of x, scale and bias within 1e-5."""
    rng = np.random.default_rng(50)
    c = 16
    x = (rng.standard_normal((4, 6, 10, c)) * 1.5 + 0.7).astype(np.float32)
    g = rng.standard_normal(x.shape).astype(np.float32)
    p, s = _bn_vars(rng, c)
    jbn = jm.nn.BatchNorm(use_running_average=not train, momentum=0.9,
                          epsilon=1e-5)

    def jf(xx, pp):
        y, upd = jbn.apply({"params": pp, "batch_stats": s}, xx,
                           mutable=["batch_stats"])
        return jnp.sum(y * g), (y, upd)

    (_, (jy, jupd)), jgr = jax.value_and_grad(jf, argnums=(0, 1),
                                              has_aux=True)(
        jnp.asarray(x), jax.tree.map(jnp.asarray, p))
    bn = _load_bn(tm.BatchNorm(c, device="cpu"), p, s)
    xt = _t(x, True)
    y = bn(xt, train)
    (y * _t(g)).sum().backward()
    np.testing.assert_allclose(_np(y), np.asarray(jy), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(_np(xt.grad), np.asarray(jgr[0]), rtol=1e-5,
                               atol=1e-5)
    for nm in ("scale", "bias"):
        np.testing.assert_allclose(_np(getattr(bn, nm).grad),
                                   np.asarray(jgr[1][nm]), rtol=1e-5,
                                   atol=1e-4)
    for nm in ("mean", "var"):
        want = np.asarray(jupd["batch_stats"][nm])
        np.testing.assert_allclose(_np(getattr(bn, nm)), want, rtol=1e-6,
                                   atol=1e-7)
        if not train:
            np.testing.assert_array_equal(_np(getattr(bn, nm)), s[nm])


def test_yolo_decode():
    """Raw predictions equal (a reshape); the boxes and confidences within
    1e-6 relative (exp and sigmoid)."""
    rng = np.random.default_rng(60)
    p = rng.normal(0, 2, (3, 2, 4, 36)).astype(np.float32)
    jio, jp = jm.yolo_decode(jnp.asarray(p), (32, 64))
    tio, tp = tm.yolo_decode(_t(p), (32, 64))
    np.testing.assert_array_equal(_np(tp), np.asarray(jp))
    np.testing.assert_allclose(_np(tio), np.asarray(jio), rtol=1e-6,
                               atol=1e-6)


# ---------------------------------------------------------------------------
# the whole network
# ---------------------------------------------------------------------------


def _jax_run(model, params, stats, x, train):
    """JAX's forward with each bn_i's output captured: (out, {i: bn_i
    out}, updated stats or None)."""
    mutable = ["intermediates"] + (["batch_stats"] if train else [])
    out, state = model.apply(
        {"params": params, "batch_stats": stats}, jnp.asarray(x),
        train=train, mutable=mutable,
        capture_intermediates=lambda mdl, _: mdl.name is not None
        and mdl.name.startswith("bn_"))
    inter = state["intermediates"]
    bns = {i: np.asarray(inter[f"bn_{i}"]["__call__"][0])
           for i in range(len(ULTRANET_LAYERS))}
    return out, bns, state.get("batch_stats")


def _act(bn_out):
    """The JAX forward's activation after bn_i, in numpy f32 as XLA runs
    it op by op: clip, then the straight-through ``a + (q - a)``."""
    a = np.minimum(np.float32(1.0), np.maximum(np.float32(0.0), bn_out))
    q = np.round(a * np.float32(15.0)) / np.float32(15.0)
    return a + (q - a)


def _pool(x):
    b, h, w, c = x.shape
    x = x[:, :h // 2 * 2, :w // 2 * 2]
    return x.reshape(b, h // 2, 2, w // 2, 2, c).max(axis=(2, 4))


def _levels_held(jbn, tbn, what):
    pre = np.clip(tbn.astype(np.float64), 0, 1) * 15
    return U.held_at_ties(np.round(np.clip(jbn, 0, 1) * 15),
                          np.round(np.clip(tbn, 0, 1) * 15), pre, what)


@pytest.mark.parametrize("train", [False, True])
def test_ultranet_layer_by_layer(net, train):
    """Each block on the JAX package's input activation: its BN output
    within 1e-5 of JAX's (1e-4 in training, where the batch statistics of
    the two convs' outputs enter), its levels equal off ties; the head's
    raw predictions within 1e-5 on JAX's last activation."""
    model, params, stats, x = net
    out, bns, _ = _jax_run(model, params, stats, x, train)
    port = U.port_model(params, stats)
    act = x
    with torch.no_grad():
        for i, (_, _, pool) in enumerate(ULTRANET_LAYERS):
            h = getattr(port, f"conv_{i}")(_t(act))
            tbn = _np(getattr(port, f"bn_{i}")(h, train))
            tol = 1e-4 if train else 1e-5
            np.testing.assert_allclose(tbn, bns[i], rtol=tol, atol=tol)
            _levels_held(bns[i], tbn, f"bn_{i}")
            act = _act(bns[i])
            if pool:
                act = _pool(act)
        head = getattr(port, f"conv_{len(ULTRANET_LAYERS)}")(_t(act))
        _, tp = tm.yolo_decode(head, x.shape[1:3])
    jp = out if train else out[1]
    np.testing.assert_allclose(_np(tp), np.asarray(jp), rtol=1e-5,
                               atol=1e-5)


def _port_bn_outputs(port):
    seen = {}
    hooks = [getattr(port, f"bn_{i}").register_forward_hook(
        lambda m, a, o, i=i: seen.__setitem__(i, _np(o)))
        for i in range(len(ULTRANET_LAYERS))]
    return seen, hooks


@pytest.mark.parametrize("train", [False, True])
def test_ultranet_forward_and_gradients(net, train):
    """The port's own forward end to end: every block's levels equal
    JAX's (at this input no value lies within 1e-5 of a half-level, which
    ``held_at_ties`` checks), so the raw predictions agree within 1e-5,
    the decoded boxes within 1e-6 relative, the updated running
    statistics within 1e-5 relative, and (train mode) the gradients of
    the stand-in objective sum(p^2) within 1e-4 relative (L2) for every
    parameter."""
    model, params, stats, x = net
    out, bns, jupd = _jax_run(model, params, stats, x, train)
    port = U.port_model(params, stats)
    seen, hooks = _port_bn_outputs(port)
    tparams = {k: {kk: _t(vv, True) for kk, vv in v.items()}
               for k, v in params.items()}
    res = tm.ultranet_apply(port, tparams, U.torch_tree(stats), _t(x),
                            train=train)
    for h in hooks:
        h.remove()
    flips = sum(_levels_held(bns[i], seen[i], f"bn_{i}") for i in bns)
    assert flips == 0
    if not train:
        tio, tp = res
        np.testing.assert_allclose(_np(tp), np.asarray(out[1]), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(_np(tio), np.asarray(out[0]), rtol=1e-6,
                                   atol=1e-5)
        return
    tp, tstats = res
    np.testing.assert_allclose(_np(tp), np.asarray(out), rtol=1e-5,
                               atol=1e-5)
    for i in range(len(ULTRANET_LAYERS)):
        for nm in ("mean", "var"):
            np.testing.assert_allclose(
                _np(tstats[f"bn_{i}"][nm]),
                np.asarray(jupd[f"bn_{i}"][nm]), rtol=1e-5, atol=1e-6)
            assert np.array_equal(stats[f"bn_{i}"][nm],
                                  np.asarray(U.torch_tree(stats)[
                                      f"bn_{i}"][nm]))  # inputs untouched

    def jloss(pp):
        p_, _ = model.apply({"params": pp, "batch_stats": stats},
                            jnp.asarray(x), train=True,
                            mutable=["batch_stats"])
        return jnp.sum(p_ ** 2)

    jgrad = jax.jit(jax.grad(jloss))(jax.tree.map(jnp.asarray, params))
    (tp ** 2).sum().backward()
    for layer, leaves in tparams.items():
        for nm, leaf in leaves.items():
            want = np.asarray(jgrad[layer][nm])
            err = np.linalg.norm(_np(leaf.grad) - want) / np.linalg.norm(want)
            assert err < 1e-4, (layer, nm, err)


def test_ultranet_module_forward_updates_its_buffers(net):
    """``UltraNet.forward`` in train mode updates its own running buffers
    as ``ultranet_apply`` returns them; in eval mode it leaves them."""
    _, params, stats, x = net
    port = U.port_model(params, stats)
    with torch.no_grad():
        port(_t(x))
        assert U.trees_equal(stats, port.batch_stats_tree())
        _, new = tm.ultranet_apply(port, port.param_tree(),
                                   port.batch_stats_tree(), _t(x), True)
        port(_t(x), train=True)
    assert U.trees_equal(U.numpy_tree(new), port.batch_stats_tree())
    assert not U.trees_equal(stats, port.batch_stats_tree())


# ---------------------------------------------------------------------------
# the integer forward
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["seed0", "seed1", "extremes", "wide_bn"])
def test_ultranet_int_bit_exact_on_jax_tables(case):
    """On the JAX package's integer tables: the raw predictions bit-equal
    (exact integer accumulators, int64 requantization, the same f32
    dequantization), the decoded boxes within 1e-6 relative. ``extremes``
    feeds image levels 0 and 255 only; ``wide_bn`` sets BN scales up to
    12, where ``acc * inc`` leaves int32's range."""
    seed = 1 if case == "seed1" else 0
    _, params, stats, x = U.trained_like(seed, batch=2)
    if case == "wide_bn":
        rng = np.random.default_rng(7)
        for i in range(len(ULTRANET_LAYERS)):
            c = params[f"bn_{i}"]["scale"].shape[0]
            params[f"bn_{i}"]["scale"] = rng.uniform(0.5, 12.0, c).astype(
                np.float32)
    tables = jax.tree.map(np.asarray, jexport(params, stats))
    if case == "wide_bn":
        assert max(int(np.abs(tables[f"conv_{i}_inc"]).max())
                   for i in range(1, 8)) * 60480 > 2**31
    xl = np.round(np.clip(x, 0, 1) * 255).astype(np.int32)
    if case == "extremes":
        xl = np.where(xl > 127, 255, 0).astype(np.int32)
    jio, jp = JUltraNetInt().apply({"params": tables}, jnp.asarray(xl))
    port = tm.int_params_from_jax(tables, device="cpu")
    tio, tp = port(_t(xl))
    np.testing.assert_array_equal(_np(tp), np.asarray(jp))
    np.testing.assert_allclose(_np(tio), np.asarray(jio), rtol=1e-6,
                               atol=1e-5)


def test_ultranet_int_refuses_a_pruned_artifact(net):
    """A pruned integer tree (conv_2 at 62 channels): the JAX model
    declares its parameters at ULTRANET_LAYERS' widths and refuses it
    (flax's shape error); the port refuses it too, naming the layer."""
    _, params, stats, _ = net
    tables = U.pruned_tables(jax.tree.map(np.asarray,
                                          jexport(params, stats)))
    assert tables["conv_2_kernel_int"].shape[-1] == 62
    xl = np.zeros((1, *U.HW, 3), np.int32)
    with pytest.raises(flax.errors.ScopeParamShapeError):
        JUltraNetInt().apply({"params": tables}, jnp.asarray(xl))
    with pytest.raises(ValueError, match="conv_2_kernel_int.*pruned"):
        tm.int_params_from_jax(tables, device="cpu")


# ---------------------------------------------------------------------------
# node groups
# ---------------------------------------------------------------------------


def _groups_equal(got, want):
    assert [g.id for g in got] == [g.id for g in want]
    for g, w in zip(got, want):
        assert (g.num_groups, g.is_prunable) == (w.num_groups,
                                                 w.is_prunable)
        assert [(e.path, e.transform.name) for e in g.entries] == [
            (e.path, e.transform.name) for e in w.entries]


def test_ultranet_node_groups_equal(net):
    """The groups of the full net and of a subnet (regrouped from its
    kernel widths): ids, entries, sizes, prunability."""
    from quantized_vit_tpu.compress import construct_subnet_ultranet as jsub

    _, params, stats, _ = net
    _groups_equal(ultranet_node_groups(U.torch_tree(params)),
                  jgroups(params))
    joto, _, jz, _ = U.zeroed(params, stats, 3)
    _, sub, _ = jsub(jz, joto.node_groups, None)
    sub = jax.tree.map(np.asarray, sub)
    _groups_equal(ultranet_node_groups(U.torch_tree(sub)), jgroups(sub))
    assert jgroups(sub)[2].num_groups < 64

"""Shared inputs and checks of the port's model-family tests (ResNet,
MobileNet, the separate-q/k/v Transformer, the conv autoencoder): the JAX
package's model initialised at PRNGKey(0) on a numpy input, its trees as
numpy and as torch CPU tensors, the port's config of a JAX config, both
OTOs on the same trees, and the comparisons the tests share.

Gradient tolerances (a QAT loss at init bits 8, as
``tests/test_torch_qat_vit.py`` holds the ViT's): a weight, bias, norm or
embedding gradient within 1e-5 of its leaf's largest magnitude (f32 sums
in another order) plus 1e-8 (a leaf whose gradient is all but zero, as a
BN scale's under a loss that barely reaches it, ~1e-10, carries its sums'
rounding only); q_m and t within 1e-5 of the L1 mass of their
gradient's summands (K7's contract); d within 2e-3 of it, because the
residual ``round(p/d) - p/d`` moves by ulp(p)/d when the pre-quant value
p moves by one ulp.

The W+A train mode (BatchNorms on the batch's statistics, activation
quantizers on) runs in float64 on both sides (:func:`to_f64`): in f32 a
channel that reaches a BatchNorm nearly constant cancels in its fast
variance ``E[x^2] - E[x]^2``, and f32 sums in XLA's order and PyTorch's
cannot agree there. In f64 the forward, the statistics, the loss and
every gradient (each scalar's within :data:`F64_TOL` of its summands' L1
mass, each other leaf's within :data:`F64_TOL` of its largest magnitude)
agree within :data:`F64_TOL`."""

import dataclasses

import flax
import jax
import jax.numpy as jnp
import numpy as np
import torch

from quantized_vit_tpu.graph import OTO as JOTO
from quantized_vit_tpu.models import QuantConfig as JQ
from quantized_vit_tpu_torch.graph import OTO
from quantized_vit_tpu_torch.models import (QuantConfig, flatten_tree,
                                            unflatten_tree)
from quantized_vit_tpu_torch.ops import quant_vjp as tqv

SCALARS = ("d_quant", "q_m", "t_quant")
F64_TOL = 1e-9


def jax_vars(model, *inputs, **kw):
    """(params, batch_stats or None) of a JAX model as numpy trees, every
    leaf f32: the tests' conftest turns on x64, under which flax makes a
    param declared without a dtype (the Transformer's ``pos_embed``) f64;
    without x64, the configuration the port follows, it is f32."""
    v = jax.jit(lambda *a: model.init(jax.random.PRNGKey(0), *a, **kw))(
        *[jnp.asarray(a) for a in inputs])
    to_np = lambda t: jax.tree.map(  # noqa: E731
        lambda a: np.asarray(a, np.float32), flax.core.unfreeze(t))
    return (to_np(v["params"]),
            to_np(v["batch_stats"]) if "batch_stats" in v else None)


def trained_like_stats(stats, seed: int):
    """A ``batch_stats`` tree of the same shapes with a trained model's
    small statistics (means normal(0, 0.1), variances in [0.5, 1.5))
    drawn from numpy, as ``tests/torch_ultranet_params.py`` draws
    UltraNet's."""
    rng = np.random.default_rng(seed + 100)
    return unflatten_tree({
        k: (rng.normal(0, 0.1, np.shape(v)) if k.endswith("mean")
            else rng.uniform(0.5, 1.5, np.shape(v))).astype(np.float32)
        for k, v in flatten_tree(stats).items()})


def to_f64(tree):
    """A numpy tree with every leaf as float64 (the same values)."""
    return unflatten_tree({k: np.asarray(v, np.float64)
                           for k, v in flatten_tree(tree).items()})


def torch_tree(tree):
    """A numpy (or JAX) tree as torch CPU tensors, the same bytes."""
    if tree is None:
        return None
    return unflatten_tree({k: torch.from_numpy(np.array(v)) for k, v in
                           flatten_tree(jax.tree.map(np.asarray,
                                                     tree)).items()})


def numpy_tree(tree):
    return unflatten_tree({k: v.detach().cpu().numpy() if isinstance(
        v, torch.Tensor) else np.asarray(v)
        for k, v in flatten_tree(tree).items()})


def port_quant(q: JQ) -> QuantConfig:
    return QuantConfig(**dataclasses.asdict(q))


def port_cfg(jcfg, cls):
    """The port's config of class ``cls`` with a JAX config's fields."""
    kw = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)}
    kw["quant"] = port_quant(jcfg.quant)
    return cls(**kw)


def trees_equal(a, b) -> bool:
    """Two trees (JAX and port) with the same paths, shapes, dtypes and
    bytes."""
    fa = flatten_tree(jax.tree.map(np.asarray, a))
    fb = flatten_tree(numpy_tree(b))
    return set(fa) == set(fb) and all(
        fa[k].shape == fb[k].shape and fa[k].dtype == fb[k].dtype
        and np.array_equal(fa[k], fb[k]) for k in fa)


def assert_groups_equal(jgroups, groups):
    """Ids, sizes, head counts, prunability, entry paths and transforms."""
    assert [g.id for g in groups] == [g.id for g in jgroups]
    for g, jg in zip(groups, jgroups):
        assert (g.num_groups, g.num_heads, g.is_prunable, g.is_auxiliary) \
            == (jg.num_groups, jg.num_heads, jg.is_prunable,
                jg.is_auxiliary), g.id
        assert [(e.path, e.transform.value) for e in g.entries] == [
            (e.path, e.transform.value) for e in jg.entries], g.id


def assert_reports_equal(jrep, rep, rel: float = 1e-9):
    assert set(rep["per_layer"]) == set(jrep["per_layer"])
    for layer, row in jrep["per_layer"].items():
        for k, v in row.items():
            got = rep["per_layer"][layer][k]
            assert abs(got - v) <= rel * max(abs(v), 1e-30), (layer, k)
    for k in ("total_macs", "total_bops", "num_params", "weight_size_bits",
              "average_bit_width"):
        assert abs(rep[k] - jrep[k]) <= rel * max(abs(jrep[k]), 1e-30), k


def otos(jmodel, port_model, params, stats=None):
    """(JAX OTO, port OTO) on the same trees."""
    jkw = {} if stats is None else {
        "batch_stats": jax.tree.map(jnp.asarray, stats)}
    kw = {} if stats is None else {"batch_stats": torch_tree(stats)}
    return (JOTO(jmodel, jax.tree.map(jnp.asarray, params), **jkw),
            OTO(port_model, torch_tree(params), **kw))


def zeroed(joto, oto, seed: int, target=None, divisible: int = 1):
    """Both packages' ``random_set_zero_groups``: (JAX tree, port
    tree)."""
    kw = dict(target_group_sparsity=target, num_group_divisible=divisible,
              seed=seed)
    return (joto.random_set_zero_groups(**kw),
            oto.random_set_zero_groups(**kw))


def record_masses(monkeypatch, named):
    """{param path: L1 mass of its gradient's summands}, filled by the
    plain quantizer backward while the test runs."""
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


def assert_grads_close(grads, jgrads, masses, f64=False):
    """The module docstring's gradient tolerances (``f64``: those of the
    float64 runs); returns the count of leaves compared."""
    assert set(grads) == set(jgrads)
    for k, want in jgrads.items():
        got = grads[k]
        assert np.isfinite(got).all(), k
        leaf = k.rsplit("/", 1)[-1]
        if f64:
            assert got.dtype == want.dtype == np.float64, k
            tol = F64_TOL * (masses[k] if leaf.startswith(SCALARS)
                             else float(np.abs(want).max()))
        elif leaf.startswith("d_quant"):
            tol = 2e-3 * masses[k]
        elif leaf.startswith(SCALARS):
            tol = 1e-5 * masses[k]
        else:
            tol = 1e-5 * float(np.abs(want).max()) + 1e-8
        err = float(np.abs(got - want).max())
        assert err <= tol, (k, err, tol)
    return len(jgrads)


def port_value_and_grads(fn, tree, monkeypatch):
    """(value, {path: gradient}, masses) of ``fn(params_tree)`` on copies
    of ``tree``'s leaves, with the quantizers' summand masses."""
    leaves = {k: v.detach().clone().requires_grad_()
              for k, v in flatten_tree(torch_tree(tree)).items()}
    masses = record_masses(monkeypatch, leaves)
    out = fn(unflatten_tree(leaves))
    out.backward()
    return float(out.detach()), {
        k: (np.zeros(tuple(v.shape), np.float32) if v.grad is None
            else v.grad.numpy()) for k, v in leaves.items()}, masses


def jax_value_and_grads(fn, tree):
    value, grads = jax.jit(jax.value_and_grad(fn))(
        jax.tree.map(jnp.asarray, tree))
    return float(value), flatten_tree(jax.tree.map(np.asarray, grads))

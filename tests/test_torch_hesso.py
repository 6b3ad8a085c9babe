"""Port parity: HESSO and HESSO-CRIC (``opt/hesso.py``,
``opt/hesso_cric.py``, through ``graph/oto.py``'s ``hesso`` and
``hesso_cric``) against the JAX package's, on the tiny quantized ViT of
``tests/test_torch_geta.py``.

Both packages' optimizers get the same gradients, drawn from a numpy seed
per step (and, for CRIC, the same losses), so what is compared is the
optimizer alone. HESSO runs warmup, two pruning periods and their
commits; CRIC the basic steps, the per-node-group projection, its cycles,
termination and the hybrid steps. At every step the redundant, pruned and
(for CRIC) violating index sets must be equal, and at the end every param
within ``RTOL`` of its leaf's largest magnitude (at the start or the end),
the committed rows exactly zero on both sides. No run comes out
bit-equal: the jitted JAX update contracts ``p - lr * g`` and the momentum
sums into fused multiply-adds, which round once where the port's separate
ops round twice (an ulp on 17 of the 92 leaves after one plain SGD step),
and the ulps add up over the run."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from quantized_vit_tpu.graph import OTO as JOTO
from quantized_vit_tpu_torch.graph import OTO
from quantized_vit_tpu_torch.models import flatten_tree, tree_map
from quantized_vit_tpu_torch.opt import (HESSO, HESSOCRIC, HESSOCRICConfig,
                                         HESSOConfig, NodeGroup, ParamEntry,
                                         Transform)

from tests.test_torch_geta import UNPRUNABLE, _jax_tiny, _port_model, \
    _torch_tree

torch.set_num_threads(1)

RTOL = 1e-6

HESSO_KW = dict(target_group_sparsity=0.5, start_pruning_step=3,
                pruning_steps=8, pruning_periods=2)
HESSO_STEPS = 14
CRIC_KW = dict(target_group_sparsity=0.4, start_cric_step=2,
               max_cycle_period=3, sampling_steps=3,
               hybrid_training_steps=3, proj_per_node_group=True,
               trial_group_sparsities=(0.25, 0.5))


def _variant_kw(variant):
    # Adam's step is ~lr whatever the gradient's scale: its usual 1e-3
    kw = dict(variant=variant, lr=1e-2 if variant == "sgd" else 1e-3)
    if variant == "adamw":
        kw["weight_decay"] = 0.05
    if variant == "sgd":
        kw["first_momentum"] = 0.9
    return kw


def _pair(kind, **kw):
    jmodel, jparams, _ = _jax_tiny()
    joto = JOTO(jmodel, jparams)
    joto.mark_unprunable_by_param_names(UNPRUNABLE)
    oto = OTO(_port_model(jparams), _torch_tree(jparams))
    oto.mark_unprunable_by_param_names(UNPRUNABLE)
    return (getattr(joto, kind)(**kw), jparams,
            getattr(oto, kind)(**kw), oto.params, joto.node_groups)


def _grads(jparams, step):
    """Seeded gradients, as (JAX tree, port tree) of the same bytes."""
    rng = np.random.default_rng(100 + step)
    jg = jax.tree.map(lambda p: jnp.asarray(
        rng.standard_normal(p.shape).astype(np.float32) * 1e-2), jparams)
    return jg, _torch_tree(jg)


def _assert_close(tparams, jparams, jstart, opt, groups):
    """Every leaf within RTOL of its largest magnitude at the start or the
    end; the committed-pruned rows exactly zero in both trees."""
    want = flatten_tree(jax.tree.map(np.asarray, jparams))
    start = flatten_tree(jax.tree.map(np.asarray, jstart))
    got = flatten_tree(tparams)
    assert set(got) == set(want)
    for k, w in want.items():
        err = np.abs(got[k].numpy() - w).max()
        scale = max(np.abs(w).max(), np.abs(start[k]).max())
        assert err <= RTOL * scale, (k, err, scale)
    from quantized_vit_tpu.opt.groups import group_matrix as jgm
    n_zero = 0
    for g in groups:
        pruned = opt.state.get(g.id, {}).get("pruned", [])
        for e in g.entries:
            gm = jgm(jnp.asarray(want[e.path]), e.transform, g.num_groups,
                     g.num_heads)
            if gm is None or not pruned:
                continue
            tm = jgm(jnp.asarray(got[e.path].numpy()), e.transform,
                     g.num_groups, g.num_heads)
            assert not np.asarray(gm)[pruned].any(), e.path
            assert not np.asarray(tm)[pruned].any(), e.path
            n_zero += len(pruned)
    assert n_zero > 0


@pytest.mark.parametrize("variant", ["sgd", "adam", "adamw"])
def test_hesso_matches_jax(variant):
    jopt, jparams, opt, tparams, groups = _pair("hesso", **HESSO_KW,
                                                **_variant_kw(variant))
    jstart = jparams
    assert isinstance(opt, HESSO)
    assert opt.pruning_period_duration == jopt.pruning_period_duration == 4
    assert opt.target_num_redundant_groups == \
        jopt.target_num_redundant_groups > 0
    pruned_seen = []
    for step in range(HESSO_STEPS):
        jg, tg = _grads(jparams, step)
        jparams = jopt.step(jparams, jopt.clip_grads(jg))
        tparams = opt.step(tparams, opt.clip_grads(tg))
        assert opt.state == jopt.state, step
        assert opt.pruned_group_idxes == jopt.pruned_group_idxes, step
        pruned_seen.append(sum(len(s["pruned"]) for s in opt.state.values()))
    # two periods committed their groups, at the target in the end
    assert 0 < pruned_seen[7] < pruned_seen[-1] == \
        opt.target_num_redundant_groups
    _assert_close(tparams, jparams, jstart, opt, groups)
    m, jm = opt.compute_metrics(tparams), jopt.compute_metrics(jparams)
    assert m["num_zero_groups"] == jm["num_zero_groups"] == \
        opt.target_num_redundant_groups


def test_hesso_group_divisible_matches_jax():
    jopt, jparams, opt, tparams, groups = _pair(
        "hesso", **dict(HESSO_KW, target_group_sparsity=0.3,
                        group_divisible=2), **_variant_kw("adam"))
    jstart = jparams
    for step in range(HESSO_STEPS):
        jg, tg = _grads(jparams, step)
        jparams = jopt.step(jparams, jg)
        tparams = opt.step(tparams, tg)
        assert opt.state == jopt.state, step
    assert opt.target_num_redundant_groups == \
        jopt.target_num_redundant_groups
    _assert_close(tparams, jparams, jstart, opt, groups)


def _losses(n):
    return np.random.default_rng(7).uniform(0.5, 2.5, n).astype(np.float32)


@pytest.mark.parametrize("variant", ["sgd", "adam", "adamw"])
def test_hesso_cric_matches_jax(variant):
    jopt, jparams, opt, tparams, groups = _pair("hesso_cric", **CRIC_KW,
                                                **_variant_kw(variant))
    jstart = jparams
    assert isinstance(opt, HESSOCRIC)
    assert opt.start_global_sampling_step == \
        jopt.start_global_sampling_step
    n_steps = opt.start_global_sampling_step + 3 * 3 + 5
    losses = _losses(n_steps)
    cycles = {}
    for step in range(n_steps):
        jg, tg = _grads(jparams, step)
        jparams = jopt.step(jparams, jg, loss=float(losses[step]))
        tparams = opt.step(tparams, tg, loss=float(losses[step]))
        assert opt.state == jopt.state, step
        assert opt.curr_cycle_period == jopt.curr_cycle_period, step
        assert opt.is_terminated == jopt.is_terminated, step
        cycles[opt.curr_cycle_period] = {
            k: list(v["active_violating"]) for k, v in opt.state.items()}
        assert opt.loss_collection == jopt.loss_collection, step
    assert opt.is_terminated and opt.terminated_step == jopt.terminated_step
    assert len(cycles) >= 3  # the projection's, then the cycles'
    assert len(opt.score_collection) == len(jopt.score_collection)
    for a, b in zip(opt.score_collection, jopt.score_collection):
        np.testing.assert_allclose(a, b, rtol=1e-5)
    _assert_close(tparams, jparams, jstart, opt, groups)
    m, jm = opt.compute_metrics(tparams), jopt.compute_metrics(jparams)
    assert m == pytest.approx(jm, rel=1e-5)
    assert m["num_zero_groups"] == opt.target_num_redundant_groups > 0


# -- the port's own behaviour on the JAX package's toy (tests/opt) ----------


def _toy(out=8):
    rng = np.random.default_rng(0)
    params = {
        "fc1": {"kernel": torch.from_numpy(
                    rng.standard_normal((6, out)).astype(np.float32)),
                "bias": torch.from_numpy(
                    rng.standard_normal(out).astype(np.float32))},
        "fc2": {"kernel": torch.from_numpy(
            rng.standard_normal((out, 4)).astype(np.float32))},
    }
    groups = [
        NodeGroup(id="fc1",
                  entries=[ParamEntry("fc1/kernel", Transform.OUT),
                           ParamEntry("fc1/bias", Transform.ACCESSORY)],
                  num_groups=out),
        NodeGroup(id="fc2", entries=[ParamEntry("fc2/kernel", Transform.OUT)],
                  num_groups=4, is_prunable=False),
    ]
    return params, groups


def _toy_grads(params, seed):
    rng = np.random.default_rng(seed)
    return tree_map(lambda p: torch.from_numpy(
        (rng.standard_normal(tuple(p.shape)) * 1e-3).astype(np.float32)),
        params)


def test_hesso_toy_prunes_rows_to_exact_zero():
    params, groups = _toy()
    opt = HESSO(groups, params, HESSOConfig(
        lr=1e-3, target_group_sparsity=0.5, start_pruning_step=2,
        pruning_steps=10, pruning_periods=2))
    for step in range(16):
        params = opt.step(params, _toy_grads(params, step))
    zero = np.where(params["fc1"]["kernel"].abs().sum(0).numpy() == 0)[0]
    assert len(zero) == 4 == opt.compute_metrics(params)["num_zero_groups"]
    assert (params["fc1"]["bias"].numpy()[zero] == 0).all()
    assert (params["fc2"]["kernel"].abs().sum(0) > 0).all()


def test_cric_reset_hands_back_fresh_copies():
    """A reset returns the cached params bit for bit, as new tensors: an
    in-place update of what a reset returned leaves the cache as it was."""
    params, groups = _toy()
    cfg = HESSOCRICConfig(lr=1e-2, target_group_sparsity=0.25,
                          start_cric_step=1, max_cycle_period=5,
                          sampling_steps=3, hybrid_training_steps=2,
                          tolerance=-1, proj_per_node_group=False)
    opt = HESSOCRIC(groups, params, cfg)
    start = tree_map(lambda p: p.clone(), params)
    for step in range(7):
        params = opt.step(params, _toy_grads(params, step), loss=1.0)
        if step in (0, 3, 6):  # the cycle boundaries reset, then train
            cached = flatten_tree(opt.cache_params)
            assert all(torch.equal(cached[k], v)
                       for k, v in flatten_tree(start).items())
        for p in flatten_tree(params).values():
            p.mul_(3.0)  # a caller updating in place
    cached = flatten_tree(opt.cache_params)
    assert all(torch.equal(cached[k], v)
               for k, v in flatten_tree(start).items())
    a, b = opt.cache_params, opt.cache_params
    assert a["fc1"]["kernel"].data_ptr() != b["fc1"]["kernel"].data_ptr()


def test_cric_toy_reaches_target_sparsity():
    params, groups = _toy()
    opt = HESSOCRIC(groups, params, HESSOCRICConfig(
        lr=1e-3, target_group_sparsity=0.5, start_cric_step=2,
        max_cycle_period=2, sampling_steps=3, hybrid_training_steps=3,
        proj_per_node_group=True))
    assert opt.start_global_sampling_step == 2 + 6
    for step in range(30):
        params = opt.step(params, _toy_grads(params, step), loss=1.0)
    assert opt.is_terminated
    m = opt.compute_metrics(params)
    assert m["num_zero_groups"] == 4
    assert m["group_sparsity"] == pytest.approx(0.5)

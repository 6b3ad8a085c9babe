"""Port parity: the training drivers (``utils/training.py``), losses
(``utils/losses.py``), guards, the data pipeline (``utils/data.py``,
``utils/native_prep.py:PrefetchLoader``) and checkpoints
(``opt/checkpoint.py``) against the JAX package.

The loops: the same tiny quantized ViT (JAX weights carried across), the
same seeded data and numpy shuffling, GETA (sgd, warmup then range
projection), label smoothing and the group lasso on, mixup off (random
streams differ between the frameworks; mixup is compared with JAX's own
Beta draw and permutation passed in). The loss per step within 1e-5
relative, params after the epoch within 1e-4 of each leaf's largest
magnitude (f32 sums in another order, carried over 4 steps), except the
quantizer steps d, within 2e-2: d moves by lr_quant times its gradient, a
sum of rounding residuals held only to 2e-3 of its summands' L1 mass
(``tests/test_torch_qat_vit.py``), which can be tens of times the sum.
Evaluation equal. Checkpoints cross in both directions and resume identically.
"""

import numpy as np
import pytest
import torch

import flax
import jax
import jax.numpy as jnp

from quantized_vit_tpu.graph import OTO as JOTO
from quantized_vit_tpu.models import QuantConfig as JQ
from quantized_vit_tpu.models import ViTConfig as JC
from quantized_vit_tpu.models import VisionTransformer as JV
from quantized_vit_tpu.models import init_quant_params_tree as jinit
from quantized_vit_tpu.opt import GETA as JGETA
from quantized_vit_tpu.opt import load_checkpoint as jload
from quantized_vit_tpu.opt import save_checkpoint as jsave
from quantized_vit_tpu.utils import losses as jlosses
from quantized_vit_tpu.utils import training as jtraining
from quantized_vit_tpu.utils.data import ArrayDataset as JArrayDataset
from quantized_vit_tpu.utils.data import DataLoader as JDataLoader
from quantized_vit_tpu_torch.graph import OTO
from quantized_vit_tpu_torch.models import (QuantConfig, ViTConfig, apply,
                                            flatten_tree, params_from_jax,
                                            unflatten_tree)
from quantized_vit_tpu_torch.opt import (GETA, load_checkpoint,
                                         save_checkpoint, scan_checkpoint)
from quantized_vit_tpu_torch.utils import (ArrayDataset, DataLoader,
                                           NonFiniteLossError,
                                           PrefetchLoader, TrainLoop,
                                           all_finite, assert_tree_finite,
                                           evaluate, losses, normalize_image,
                                           topk_accuracy)

torch.set_num_threads(1)

TINY = dict(img_size=32, patch_size=16, embed_dim=32, depth=2, num_heads=2,
            mlp_ratio=2.0, num_classes=4)
GETA_KW = dict(lr=2e-2, lr_quant=1e-3, variant="sgd",
               target_group_sparsity=0.3, start_projection_step=2,
               projection_steps=4, projection_periods=2,
               start_pruning_step=100, pruning_steps=4, pruning_periods=1,
               min_bit_wt=4.0, max_bit_wt=8.0, min_bit_act=4.0,
               max_bit_act=8.0)
LOOP_KW = dict(num_classes=4, label_smooth=True, use_group_lasso=True,
               group_lasso_lambda=1e-3)


def _data(n=16, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, 32, 32, 3)).astype(np.float32),
            rng.integers(0, 4, n))


def _jax_setup():
    model = JV(JC(**TINY, quant=JQ(enabled=True)))
    params = flax.core.unfreeze(jax.jit(model.init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)))["params"])
    return model, jinit(params, init_bits=8.0)


def _port_setup(jparams):
    model = params_from_jax(jax.tree.map(np.asarray, jparams),
                            ViTConfig(**TINY, quant=QuantConfig(
                                enabled=True)), device="cpu")
    params = unflatten_tree({k: v.detach().clone() for k, v in
                             model.params_by_path().items()})
    return model, params


def test_train_one_epoch_and_evaluate_match_jax():
    images, labels = _data()
    jmodel, jparams = _jax_setup()
    jopt = JOTO(jmodel, jparams).geta(**GETA_KW)
    jloop = jtraining.TrainLoop(
        apply_fn=lambda p, x, r: jmodel.apply({"params": p}, x,
                                              deterministic=True),
        optimizer=jopt, **LOOP_KW)
    model, params = _port_setup(jparams)
    opt = OTO(model, params).geta(**GETA_KW)
    loop = TrainLoop(apply_fn=lambda p, x, g: apply(model, p, x),
                     optimizer=opt, device="cpu", **LOOP_KW)

    jparams, jm = jloop.train_one_epoch(
        jparams, JDataLoader(JArrayDataset(images, labels), 4, shuffle=True,
                             seed=3), 0, jax.random.PRNGKey(0))
    params, m = loop.train_one_epoch(
        params, DataLoader(ArrayDataset(images, labels), 4, shuffle=True,
                           seed=3), 0, torch.Generator().manual_seed(0))
    assert m["steps"] == jm["steps"] == 4 and len(m["step_losses"]) == 4
    for k in ("loss", "ce_loss", "gl_loss"):
        np.testing.assert_allclose(m[k], jm[k], rtol=1e-5)
    assert m["acc"] == jm["acc"]
    want = flatten_tree(jax.tree.map(np.asarray, jparams))
    got = flatten_tree(params)
    for k, w in want.items():
        err = np.abs(got[k].numpy() - w).max()
        rel = 2e-2 if k.rsplit("/", 1)[-1].startswith("d_quant") else 1e-4
        assert err <= rel * np.abs(w).max() + 1e-12, (k, err)

    ev_x, ev_y = _data(10, seed=1)
    jev = jtraining.evaluate(
        lambda p, x: jmodel.apply({"params": p}, x, deterministic=True),
        jparams, JDataLoader(JArrayDataset(ev_x, ev_y), 4, pad_last=True))
    ev = evaluate(lambda p, x: apply(model, p, x), params,
                  DataLoader(ArrayDataset(ev_x, ev_y), 4, pad_last=True),
                  device="cpu")
    assert ev["samples"] == jev["samples"] == 10
    assert ev["top1"] == jev["top1"] and ev["top5"] == jev["top5"]
    np.testing.assert_allclose(ev["loss"], jev["loss"], rtol=1e-5)


def test_nonfinite_loss_raises():
    images, labels = _data(4)
    _, jparams = _jax_setup()
    model, params = _port_setup(jparams)
    opt = OTO(model, params).geta(**GETA_KW)
    loop = TrainLoop(
        apply_fn=lambda p, x, g: apply(model, p, x) * float("nan"),
        optimizer=opt, device="cpu", num_classes=4)
    with pytest.raises(NonFiniteLossError, match="non-finite loss"):
        loop.train_one_epoch(params, DataLoader(
            ArrayDataset(images, labels), 4), 0)


def test_losses_match_jax():
    rng = np.random.default_rng(4)
    logits = rng.standard_normal((6, 5)).astype(np.float32)
    teacher = rng.standard_normal((6, 5)).astype(np.float32)
    labels = np.array([0, 4, 2, 2, 1, -1])  # -1: a zero row, as jax
    for eps in (None, 0.1):
        np.testing.assert_allclose(
            losses.one_hot(torch.from_numpy(labels), 5, eps).numpy(),
            np.asarray(jlosses.one_hot(jnp.asarray(labels), 5, eps)),
            rtol=1e-7)
    target = np.asarray(jlosses.one_hot(jnp.asarray(labels), 5, 0.1))
    np.testing.assert_allclose(
        float(losses.cross_entropy_onehot_target(torch.from_numpy(logits),
                                                 torch.from_numpy(target))),
        float(jlosses.cross_entropy_onehot_target(jnp.asarray(logits),
                                                  jnp.asarray(target))),
        rtol=1e-6)
    np.testing.assert_allclose(
        float(losses.softmax_cross_entropy(torch.from_numpy(logits[:5]),
                                           torch.from_numpy(labels[:5]))),
        float(jlosses.softmax_cross_entropy(jnp.asarray(logits[:5]),
                                            jnp.asarray(labels[:5]))),
        rtol=1e-6)
    np.testing.assert_allclose(
        float(losses.kd_loss(torch.from_numpy(logits),
                             torch.from_numpy(teacher), 4.0)),
        float(jlosses.kd_loss(jnp.asarray(logits), jnp.asarray(teacher),
                              4.0)), rtol=1e-5)


def test_mixup_with_jax_draws_matches_jax():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((6, 4, 4, 3)).astype(np.float32)
    y = np.asarray(jlosses.one_hot(jnp.asarray([0, 1, 2, 3, 1, 0]), 4))
    key = jax.random.PRNGKey(7)
    jx, jy = jlosses.mixup(key, jnp.asarray(x), jnp.asarray(y), 0.2)
    k_gamma, k_perm = jax.random.split(key)
    gamma = float(jax.random.beta(k_gamma, 0.2, 0.2))
    perm = np.asarray(jax.random.permutation(k_perm, 6))
    tx, ty = losses.mixup(None, torch.from_numpy(x), torch.from_numpy(y),
                          0.2, gamma=gamma, perm=torch.from_numpy(perm))
    np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
    np.testing.assert_array_equal(ty.numpy(), np.asarray(jy))
    # the port's own draws: a Beta(a, a) share and a permutation
    gen = torch.Generator().manual_seed(0)
    draws = [losses.beta_sample(0.2, gen) for _ in range(200)]
    assert all(0.0 <= v <= 1.0 for v in draws)
    assert 0.3 < np.mean(draws) < 0.7
    mx, my = losses.mixup(gen, torch.from_numpy(x), torch.from_numpy(y))
    np.testing.assert_allclose(my.sum(-1).numpy(), 1.0, rtol=1e-6)


def test_group_lasso_matches_jax():
    _, jparams = _jax_setup()
    from quantized_vit_tpu.graph.builders import vit_node_groups as jvg
    from quantized_vit_tpu_torch.graph import vit_node_groups

    tparams = unflatten_tree({k: torch.from_numpy(np.array(v)) for k, v in
                              flatten_tree(jax.tree.map(
                                  np.asarray, jparams)).items()})
    jgs = [g for g in jvg(JC(**TINY), jparams) if g.is_prunable]
    tgs = [g for g in vit_node_groups(ViTConfig(**TINY), tparams)
           if g.is_prunable]
    scales = {g.id: np.linspace(0.5, 2.0, g.num_groups).astype(np.float32)
              for g in jgs}
    for sc in (None, scales):
        want = jlosses.group_lasso_loss(
            jgs, jparams, None if sc is None else
            {k: jnp.asarray(v) for k, v in sc.items()})
        got = losses.group_lasso_loss(
            tgs, tparams, None if sc is None else
            {k: torch.from_numpy(v) for k, v in sc.items()})
        np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


def test_topk_guards_and_normalize():
    logits = torch.tensor([[0.1, 0.9, 0.0], [0.8, 0.1, 0.05],
                           [0.2, 0.3, 0.5]])
    labels = torch.tensor([1, 1, 2])
    want = jtraining.topk_accuracy(jnp.asarray(logits.numpy()),
                                   jnp.asarray(labels.numpy()), (1, 2),
                                   jnp.asarray([True, True, False]))
    got = topk_accuracy(logits, labels, (1, 2),
                        torch.tensor([True, True, False]))
    assert {k: int(v) for k, v in got.items()} == {
        k: int(v) for k, v in want.items()}
    tree = {"a": torch.ones(3), "b": {"c": torch.zeros(2)}}
    assert bool(all_finite(tree))
    assert_tree_finite(tree)
    tree["b"]["c"][0] = float("inf")
    assert not bool(all_finite(tree))
    with pytest.raises(NonFiniteLossError, match="b/c"):
        assert_tree_finite(tree)
    img = np.random.default_rng(0).random((4, 4, 3)).astype(np.float32)
    from quantized_vit_tpu.utils.data import normalize_image as jnorm
    np.testing.assert_array_equal(normalize_image(img), jnorm(img))


def test_dataloader_and_prefetch_give_jax_batches():
    images, labels = _data(11)
    for kw in (dict(shuffle=True, seed=2), dict(pad_last=True)):
        want = list(JDataLoader(JArrayDataset(images, labels), 4, **kw))
        got = list(DataLoader(ArrayDataset(images, labels), 4, **kw))
        pre = list(PrefetchLoader(DataLoader(ArrayDataset(images, labels),
                                             4, **kw), depth=2))
        assert len(got) == len(want) == len(pre)
        for (a, b, c), (x, y, z), (p, q, r) in zip(got, want, pre):
            np.testing.assert_array_equal(a, x)
            np.testing.assert_array_equal(b, y)
            np.testing.assert_array_equal(c, z)
            np.testing.assert_array_equal(a, p)

    def broken():
        yield from DataLoader(ArrayDataset(images, labels), 4)
        raise RuntimeError("loader failed")

    with pytest.raises(RuntimeError, match="loader failed"):
        list(PrefetchLoader(broken()))


def _step_both(params_a, opt_a, params_b, opt_b, grads):
    return (opt_a.step(params_a, opt_a.clip_grads(grads[0])),
            opt_b.step(params_b, opt_b.clip_grads(grads[1])))


def test_checkpoints_cross_between_port_and_jax(tmp_path):
    """A port checkpoint read by JAX and a JAX checkpoint read by the port:
    params equal, GETA state restored, the next step identical."""
    jmodel, jparams = _jax_setup()
    model, params = _port_setup(jparams)
    kw = dict(GETA_KW, variant="adam")
    joto, oto = JOTO(jmodel, jparams), OTO(model, params)
    jopt, opt = joto.geta(**kw), oto.geta(**kw)
    rng = np.random.default_rng(6)
    for _ in range(3):
        g = {k: rng.standard_normal(v.shape).astype(np.float32) * 1e-2
             for k, v in flatten_tree(params).items()}
        params = opt.step(params, opt.clip_grads(unflatten_tree(
            {k: torch.from_numpy(v) for k, v in g.items()})))
        jparams = jopt.step(jparams, jopt.clip_grads(unflatten_tree(
            {k: jnp.asarray(v) for k, v in g.items()})))

    port_path = str(tmp_path / "port" / "ckpt_3")
    save_checkpoint(port_path, params, opt.state_dict(), {"note": "port"})
    assert scan_checkpoint(str(tmp_path / "port")) == port_path
    jp2, jstate, jextra = jload(port_path)
    assert jextra == {"note": "port"}
    for k, v in flatten_tree(params).items():
        np.testing.assert_array_equal(np.asarray(flatten_tree(jp2)[k]),
                                      v.numpy())
    jopt2 = JGETA(joto.node_groups, jp2, jopt.cfg)
    jopt2.load_state_dict(jstate)
    assert jopt2.num_steps == 3

    jax_path = str(tmp_path / "jax" / "ckpt_3")
    jsave(jax_path, jparams, jopt.state_dict(), {"note": "jax"})
    p2, state, extra = load_checkpoint(jax_path, device="cpu")
    assert extra == {"note": "jax"}
    for k, v in flatten_tree(jax.tree.map(np.asarray, jparams)).items():
        np.testing.assert_array_equal(flatten_tree(p2)[k].numpy(), v)
    opt2 = GETA(oto.node_groups, p2, opt.cfg)
    opt2.load_state_dict(state)
    assert (opt2.num_steps, opt2.max_bit_wt) == (jopt.num_steps,
                                                  jopt.max_bit_wt)
    for k, v in flatten_tree(jax.tree.map(np.asarray, jopt.m2)).items():
        np.testing.assert_array_equal(flatten_tree(opt2.m2)[k].numpy(), v)

    # the port resumed from its own checkpoint steps exactly as before
    p3, state3, _ = load_checkpoint(port_path, device="cpu")
    opt3 = GETA(oto.node_groups, p3, opt.cfg)
    opt3.load_state_dict(state3)
    g = unflatten_tree({k: torch.full(v.shape, 1e-3) for k, v in
                        flatten_tree(params).items()})
    a, b = _step_both(params, opt, p3, opt3, (g, g))
    for k, v in flatten_tree(a).items():
        assert torch.equal(v, flatten_tree(b)[k]), k

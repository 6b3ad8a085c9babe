"""Port parity: the DP x TP QAT training step (``parallel/train_step.py``)
against the JAX ``jit`` step over ``shard_params``
(``__graft_entry__.py:dryrun_multichip``) on the conftest's CPU mesh, at
its shapes: img 32, patch 16, D 64, depth 2, 2 heads, 10 classes,
``QuantConfig(enabled=True)``, quantizers at init bits 8, cross-entropy
on one-hot labels, ``optax.adam(1e-3)``; one step on a batch of 4 at the
layouts (2, 2), (1, 2) and (2, 1) (four spawned gloo processes: (2, 2),
then two regrouped pairs).

Tolerances: the loss within 1e-5; every gradient leaf within rtol 1e-4
and atol 1e-7 of JAX's (TP sums partial products in another order than
XLA's dot), except the quantizers' d gradients, which are sums of
rounding residuals ``round(p/d) - p/d`` (tests/test_torch_qat_vit.py):
an ulp of a pre-quant value moves a residual by up to 2^7 ulps at 8
bits, so d is held, as there, to 2e-3 of the L1 mass of its summands
(recorded from the port's single-process plain chain on the same batch);
the Adam-updated params within
1e-6 (an lr of 1e-3 times a unit-size update: a flipped sign of a
near-zero gradient moves a leaf by up to 2e-3, so leaves whose gradient
is below 1e-6 in magnitude are left out of that check).
"""

import functools

import numpy as np
import pytest
import torch

import flax
import jax
import jax.numpy as jnp
import optax
from jax.sharding import Mesh, NamedSharding

from quantized_vit_tpu.models import QuantConfig as JQ
from quantized_vit_tpu.models import ViTConfig as JC
from quantized_vit_tpu.models import VisionTransformer as JV
from quantized_vit_tpu.models import init_quant_params_tree as jinit
from quantized_vit_tpu.parallel import data_sharding as j_data_sharding
from quantized_vit_tpu.parallel import partition_specs as j_specs
from quantized_vit_tpu_torch.models import (QuantConfig, ViTConfig, apply,
                                            flatten_tree, params_from_jax,
                                            unflatten_tree)
from quantized_vit_tpu_torch.ops import quant_vjp as tqv
from quantized_vit_tpu_torch.parallel import run_processes

from tests import torch_mesh_workers as mw

torch.set_num_threads(1)

CFG = dict(img_size=32, patch_size=16, embed_dim=64, depth=2, num_heads=2,
           num_classes=10)
LAYOUTS = [(2, 2), (1, 2), (2, 1)]


def _inputs():
    x = np.random.default_rng(0).standard_normal((4, 32, 32, 3)).astype(
        np.float32)
    y = np.random.default_rng(1).integers(0, 10, 4)
    return x, y


@functools.lru_cache(maxsize=None)
def _jax_params():
    model = JV(JC(**CFG, quant=JQ(enabled=True)))
    x, _ = _inputs()
    params = flax.core.unfreeze(model.init(jax.random.PRNGKey(0),
                                           jnp.asarray(x[:1]))["params"])
    return model, jinit(params, init_bits=8.0)


@functools.lru_cache(maxsize=None)
def _jax_step(dp, tp):
    """dryrun_multichip's step on the (dp, tp) mesh: (loss, grads, new
    params), flat numpy."""
    model, params = _jax_params()
    mesh = Mesh(np.array(jax.devices()[:dp * tp]).reshape(dp, tp),
                ("data", "model"))
    x, y = _inputs()
    tx = optax.adam(1e-3)
    opt_state = tx.init(params)
    sh = jax.tree.map(lambda s: NamedSharding(mesh, s), j_specs(params))
    p = jax.tree.map(jax.device_put, params, sh)
    xs = jax.device_put(jnp.asarray(x), j_data_sharding(mesh, 4))
    ys = jax.device_put(jnp.asarray(y), j_data_sharding(mesh, 1))

    def loss_fn(p, xb, yb):
        logits = model.apply({"params": p}, xb, deterministic=True)
        onehot = jax.nn.one_hot(yb, 10)
        return -jnp.mean(jnp.sum(jax.nn.log_softmax(logits) * onehot,
                                 axis=-1))

    @jax.jit
    def step(p, opt_state, xb, yb):
        loss, grads = jax.value_and_grad(loss_fn)(p, xb, yb)
        updates, opt_state = tx.update(grads, opt_state, p)
        return loss, grads, optax.apply_updates(p, updates)

    with mesh:
        loss, grads, new = step(p, opt_state, xs, ys)
    flat = lambda t: {k: np.asarray(v) for k, v in flatten_tree(
        jax.tree.map(np.asarray, t)).items()}
    return float(loss), flat(grads), flat(new)


@functools.lru_cache(maxsize=None)
def _masses():
    """{d param path: L1 mass of its gradient's summands} from the port's
    single-process step on the whole batch (plain chain)."""
    _, params = _jax_params()
    model = params_from_jax(jax.tree.map(np.asarray, params),
                            ViTConfig(**CFG, quant=QuantConfig(enabled=True)),
                            device="cpu")
    leaves = {k: v.detach().clone().requires_grad_()
              for k, v in model.params_by_path().items()}
    by_ptr = {v.data_ptr(): k for k, v in leaves.items()}
    masses = {}
    plain = tqv.lsfq_nonlinear_bwd_plain

    def recording(x, g, d, q_m, t, **kw):
        term = tqv.nonlinear_bwd_terms(x, g, d, q_m, t, **kw)[1]
        masses[by_ptr[d.data_ptr()]] = float(term.abs().sum(
            dtype=torch.float64))
        return plain(x, g, d, q_m, t, **kw)

    x, y = _inputs()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tqv, "lsfq_nonlinear_bwd_plain", recording)
        logits = apply(model, unflatten_tree(leaves), torch.from_numpy(x))
        logp = torch.log_softmax(logits, -1)
        loss = -logp[torch.arange(4), torch.from_numpy(y)].mean()
        loss.backward()
    return masses


@pytest.fixture(scope="module")
def ported(tmp_path_factory):
    _, params = _jax_params()
    x, y = _inputs()
    pnp = {k: np.asarray(v) for k, v in flatten_tree(params).items()}
    d = str(tmp_path_factory.mktemp("train"))
    res = run_processes(mw.train, 4, d, args=(CFG, pnp, x, y, d),
                        timeout_s=240)
    out = {"errors": res[0]["errors"]}
    for r in res:
        out.update({k: v for k, v in r.items() if isinstance(k, tuple)})
    return out


@pytest.mark.parametrize("layout", LAYOUTS)
def test_loss_equals_jax(ported, layout):
    loss, _, _ = _jax_step(*layout)
    assert abs(ported[layout]["loss"] - loss) <= 1e-5


@pytest.mark.parametrize("layout", LAYOUTS)
def test_gradients_equal_jax(ported, layout):
    _, grads, _ = _jax_step(*layout)
    got = ported[layout]["grads"]
    assert set(got) == set(grads)
    for k, want in grads.items():
        if k.rsplit("/", 1)[-1].startswith("d_quant"):
            err = float(np.abs(got[k] - want).max())
            assert err <= 2e-3 * _masses()[k], (k, err, _masses()[k])
        else:
            np.testing.assert_allclose(got[k], want, rtol=1e-4, atol=1e-7,
                                       err_msg=k)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_adam_params_equal_jax(ported, layout):
    _, grads, new = _jax_step(*layout)
    got = ported[layout]["params"]
    for k, want in new.items():
        keep = np.abs(grads[k]) >= 1e-6
        np.testing.assert_allclose(got[k][keep], want[keep], atol=1e-6,
                                   rtol=0, err_msg=k)


def test_step_refusals(ported):
    assert ported["errors"] == ["heads=1 not divisible by tp=2",
                                "mlp_hidden=257 not divisible by tp=2"]

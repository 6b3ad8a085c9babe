"""Port parity: the quantized collectives (``parallel/collectives.py``)
against the JAX ``quantized_ring_all_reduce`` and ``dp_all_reduce_grads``
on the conftest's CPU mesh, on the inputs of
tests/parallel/test_collectives.py:31-110, at n = 8, 4 and 2 processes
(eight spawned gloo processes, once; the smaller groups regrouped from
them).

Tolerances: the ring equals JAX's within 1e-6 relative (the same f32
operations in the same order: expected bit-exact), every replica
bit-identical, and the JAX tests' bounds against the exact sum; the
exact mode within rtol 1e-5, atol 1e-6 of JAX's psum mean (XLA's
all-reduce sums in another order than the port's rank order); the
batched-leaf ring equal to the per-leaf ring bit for bit.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as JP

from quantized_vit_tpu.parallel.collectives import (
    dp_all_reduce_grads as j_sync, quantized_ring_all_reduce as j_ring)
from quantized_vit_tpu_torch.parallel import run_processes

from tests import torch_mesh_workers as mw

torch.set_num_threads(1)

NS = [8, 4, 2]


def _inputs():
    """{name: (per-process values [8, ...], block)}: the JAX tests'."""
    r = np.random.default_rng
    return {
        "x1000": (r(0).standard_normal((8, 1, 1000))[:, 0].astype(
            np.float32), 100),
        "ragged": (r(1).standard_normal((8, 1, 7, 13))[:, 0].astype(
            np.float32), 16),
        "w64": (r(2).standard_normal((8, 1, 64))[:, 0].astype(np.float32),
                256),
        "b8": (r(2).standard_normal((8, 1, 8))[:, 0].astype(np.float32),
               256),
        "w512": (r(3).standard_normal((8, 1, 512))[:, 0].astype(
            np.float32), 64),
    }


def _run(n, fn, x_all):
    mesh = Mesh(np.array(jax.devices()[:n]), ("data",))
    f = shard_map(lambda x: fn(x[0])[None], mesh=mesh, in_specs=JP("data"),
                  out_specs=JP("data"))
    return np.asarray(jax.jit(f)(jnp.asarray(x_all[:n])))


@functools.lru_cache(maxsize=None)
def _jax(n, name, mode, block=None):
    x_all, b = _inputs()[name]
    if mode == "ring":
        return _run(n, lambda x: j_ring(x, "data", block=block or b), x_all)
    if mode == "psum":
        return _run(n, lambda x: jax.lax.psum(x, "data"), x_all)
    return _run(n, lambda x: j_sync({"g": x}, "data",
                                    quantized=mode == "quant",
                                    block=64)["g"], x_all)


@pytest.fixture(scope="module")
def ported(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("coll"))
    return run_processes(mw.collectives, 8, d, args=(_inputs(), d),
                         timeout_s=240)


def _all(ported, n, *keys):
    """[n, ...]: every process's result under ``keys``."""
    out = []
    for r in ported[:n]:
        v = r[n]
        for k in keys:
            v = v[k]
        out.append(v)
    return np.stack(out)


@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("name", list(_inputs()))
def test_ring_equals_jax(ported, n, name):
    got = _all(ported, n, "ring", name)
    want = _jax(n, name, "ring")
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    # every replica holds the same bits
    for i in range(1, n):
        np.testing.assert_array_equal(got[i], got[0])
    # the JAX tests' bounds against the exact sum
    exact = _jax(n, name, "psum")
    denom = np.maximum(np.abs(exact), 1.0)
    assert np.max(np.abs(got - exact) / denom) < 0.15
    if name == "x1000":
        assert np.mean(np.abs(got - exact) / denom) < 0.02


@pytest.mark.parametrize("n", NS)
def test_exact_mode_is_psum_mean(ported, n):
    for name in _inputs():
        got = _all(ported, n, "exact", name)
        np.testing.assert_allclose(got, _jax(n, name, "exact"), rtol=1e-5,
                                   atol=1e-6, err_msg=name)
        np.testing.assert_allclose(_all(ported, n, "exact_sum", name),
                                   _jax(n, name, "psum"), rtol=1e-5,
                                   atol=1e-6, err_msg=name)
        for i in range(1, n):
            np.testing.assert_array_equal(got[i], got[0])


@pytest.mark.parametrize("n", NS)
def test_quantized_mode_equals_jax(ported, n):
    for name in _inputs():
        got = _all(ported, n, "quant", name)
        want = _jax(n, name, "quant")
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7,
                                   err_msg=name)
        if name == "w512":  # the JAX test's bounds on the mean
            mean = _jax(n, name, "psum") / n
            denom = np.maximum(np.abs(mean), 0.5)
            assert np.max(np.abs(got - mean) / denom) < 0.2
            assert np.mean(np.abs(got - mean) / denom) < 0.03


@pytest.mark.parametrize("n", NS)
def test_batched_leaves_equal_per_leaf_ring(ported, n):
    for name in _inputs():
        np.testing.assert_array_equal(_all(ported, n, "batched", name),
                                      _all(ported, n, "per_leaf", name))
        np.testing.assert_allclose(_all(ported, n, "per_leaf", name),
                                   _jax(n, name, "ring", 64), rtol=1e-6,
                                   atol=1e-7, err_msg=name)


def test_ring_single_process_is_identity():
    from quantized_vit_tpu_torch.parallel import (Peers,
                                                  quantized_ring_all_reduce)

    x = torch.arange(10.0)
    assert quantized_ring_all_reduce(x, Peers(0, 1, "cpu")) is x

"""Port parity: sharded checkpoints (``parallel/sharded_ckpt.py``, on
``torch.distributed.checkpoint``) and elastic recovery
(``parallel/elastic.py``) against the JAX package's, on the cases of
tests/parallel/test_sharded_ckpt.py and tests/parallel/test_elastic.py,
run over four spawned gloo processes:

- a tree with the ViT partition rules' paths written at (2, 2),
  restored at (2, 2), then on regrouped pairs at (1, 2) and (2, 1), and
  whole; ``scan_sharded_checkpoint`` on two step directories;
- ``shrink_mesh`` against the JAX function's layouts;
- ``elastic_restore`` of a (2, 2) checkpoint onto three survivors
  (shrunk to (1, 2)); the supervisor with a failure injected at the
  third health check (steps 0, 1 on four processes, then 1, 2, 3 on two)
  and the ``max_failures`` re-raise. The JAX test runs 8 -> 4 devices
  and is ``slow``; the port's copy runs 4 -> 2 processes.

Every restore equals the written arrays exactly (a checkpoint moves
bytes).
"""

import numpy as np
import pytest
import torch

import jax

from quantized_vit_tpu.parallel.elastic import shrink_mesh as j_shrink
from quantized_vit_tpu.parallel.sharded_ckpt import (scan_sharded_checkpoint
                                                     as j_scan)
from quantized_vit_tpu_torch.parallel import (run_processes,
                                              save_sharded_checkpoint,
                                              scan_sharded_checkpoint,
                                              shrink_mesh)

from tests import torch_mesh_workers as mw

torch.set_num_threads(1)


def _tiny_vit_tree(rng):
    """tests/parallel/test_sharded_ckpt.py:24-42's tree, f32 (flat)."""
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    return {"blocks_0/attn/qkv/kernel": f(16, 48),
            "blocks_0/attn/qkv/bias": f(48),
            "blocks_0/attn/proj/kernel": f(16, 16),
            "blocks_0/attn/proj/bias": f(16),
            "blocks_0/mlp/fc1/kernel": f(16, 64),
            "blocks_0/mlp/fc1/bias": f(64),
            "blocks_0/mlp/fc2/kernel": f(64, 16),
            "blocks_0/mlp/fc2/bias": f(16),
            "norm/scale": f(16)}


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("ck"))
    res = run_processes(mw.ckpt, 4, d, args=(_tiny_vit_tree(
        np.random.default_rng(0)), d, d), timeout_s=240)
    return res, d


@pytest.fixture(scope="module")
def elastic(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("el"))
    return run_processes(mw.elastic, 4, d, args=(d, d), timeout_s=240)


def _equal(got, want):
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)


def test_roundtrip_same_mesh(ckpt):
    res, _ = ckpt
    host = _tiny_vit_tree(np.random.default_rng(0))
    for r in res:
        assert r["extra"] == {"bit_layers": {"blocks_0/attn/qkv": 4.0},
                              "num_steps": 123}
        _equal(r[(2, 2)], host)
        # the column-sharded qkv kernel restored sharded over 'model'
        assert r["shape22"] == (16, 24)


@pytest.mark.parametrize("layout", [(1, 2), (2, 1)])
def test_restore_onto_different_topology(ckpt, layout):
    res, _ = ckpt
    host = _tiny_vit_tree(np.random.default_rng(0))
    ranks = res[:2] if layout == (1, 2) else res[2:]
    for r in ranks:
        _equal(r[layout], host)
        assert r[f"fc1_{layout}"] == (16, 64 // layout[1])


def test_restore_unsharded_and_scan(ckpt, tmp_path):
    res, d = ckpt
    host = _tiny_vit_tree(np.random.default_rng(0))
    for r in res:
        _equal(r["whole"], host)
    tree = {"norm": {"scale": torch.ones(4)}}
    save_sharded_checkpoint(str(tmp_path / "ckpt_5"), tree)
    save_sharded_checkpoint(str(tmp_path / "ckpt_40"), tree)
    (tmp_path / "ckpt_99.txt").write_text("not a directory")
    latest = scan_sharded_checkpoint(str(tmp_path))
    assert latest.endswith("ckpt_40") and latest == j_scan(str(tmp_path))
    assert scan_sharded_checkpoint(d).endswith("ckpt_10")


@pytest.mark.parametrize("n, mp", [(6, 2), (2, 4), (8, 2), (3, 1), (1, 2)])
def test_shrink_mesh_equals_jax(n, mp):
    got = shrink_mesh(list(range(n)), model_parallel=mp)
    want = j_shrink(jax.devices()[:n], model_parallel=mp)
    assert got.shape == dict(want.shape)
    assert got.ranks.tolist() == [[d.id for d in row]
                                  for row in want.devices]
    with pytest.raises(ValueError, match="no surviving"):
        shrink_mesh([])


def test_elastic_restore_onto_shrunken_mesh(elastic):
    params = {k: v.numpy() for k, v in mw.flatten_tree(
        mw._dense_params(0)).items()}
    for rank, r in enumerate(elastic):
        if rank >= 2:
            assert r["restore"] is None
            continue
        extra, shape, local, gathered = r["restore"]
        assert extra == {"step": 3}
        assert shape == {"data": 1, "model": 2}
        assert local == (16, 16)  # the kernel lives sharded per the rules
        _equal(gathered, params)


def test_supervisor_recovers_and_resumes(elastic):
    params = {k: v.numpy() for k, v in mw.flatten_tree(
        mw._dense_params(1)).items()}
    for rank, r in enumerate(elastic):
        failures, size, seen = r["supervisor"]
        assert failures == 1
        assert seen[:2] == [(0, 4), (1, 4)]
        if rank >= 2:  # left out of the shrunken layout
            assert size is None and len(seen) == 2
            continue
        # resumed from the checkpoint's step (1) on two processes and
        # completed through step 3
        assert size == 2 and seen[2:] == [(1, 2), (2, 2), (3, 2)]
        _equal(r["final"], params)
        # unrecoverable: a failure beyond max_failures re-raises
        assert r["reraised"] is True

"""Port parity: the GPipe forward (``parallel/pipeline.py``) against the
JAX package's on the conftest's CPU mesh (tests/parallel/
test_pipeline.py): the stack/unstack round trip, ``gpipe_blocks`` over
4 stages with 1 and 4 microbatches against the JAX sequential blocks,
``vit_pipeline_forward`` at 2 microbatches with quantization off and on
(init bits 8) against the JAX model, and the refusals. The 4 stages are
four spawned gloo processes (once, every case in one group).

Tolerance: 2e-5 (the JAX test's own, rtol and atol), the JAX weights
carried across.
"""

import functools

import numpy as np
import pytest
import torch

import flax
import jax
import jax.numpy as jnp

from quantized_vit_tpu.models import QuantConfig as JQ
from quantized_vit_tpu.models import ViTConfig as JC
from quantized_vit_tpu.models import VisionTransformer as JV
from quantized_vit_tpu.models import init_quant_params_tree as jinit
from quantized_vit_tpu.models.vit import Block as JBlock
from quantized_vit_tpu_torch.models import (ViTConfig, VisionTransformer,
                                            flatten_tree)
from quantized_vit_tpu_torch.parallel import (create_mesh, gpipe_blocks,
                                              run_processes,
                                              stack_block_params,
                                              unstack_block_params,
                                              vit_pipeline_forward)

from tests import torch_mesh_workers as mw

torch.set_num_threads(1)

CFG = dict(img_size=32, patch_size=16, embed_dim=64, depth=4, num_heads=2,
           num_classes=6)


@functools.lru_cache(maxsize=None)
def _vit(quant=False):
    cfg = JC(**CFG, quant=JQ(enabled=True) if quant else JQ.off())
    model = JV(cfg)
    x = np.random.default_rng(0).standard_normal((4, 32, 32, 3)).astype(
        np.float32)
    params = flax.core.unfreeze(jax.jit(model.init)(jax.random.PRNGKey(0),
                                                    jnp.asarray(x))["params"])
    if quant:
        params = jinit(params, init_bits=8.0)
    flat = {k: np.asarray(v) for k, v in flatten_tree(
        jax.tree.map(np.asarray, params)).items()}
    return model, params, flat, x


def _h():
    return np.random.default_rng(1).standard_normal((4, 5, 64)).astype(
        np.float32)


@functools.lru_cache(maxsize=None)
def _sequential():
    cfg = JC(**CFG, quant=JQ.off())
    model, params, _, _ = _vit()
    block = JBlock(cfg, drop_path_rate=0.0)
    want = jnp.asarray(_h())
    for i in range(4):
        want = block.apply({"params": params[f"blocks_{i}"]}, want, True)
    return np.asarray(want)


@pytest.fixture(scope="module")
def stages(tmp_path_factory):
    cases = [("blocks", f"m{m}", CFG, _vit()[2], _h(), m) for m in (1, 4)]
    cases += [("vit", f"q{q}", CFG, q, _vit(q)[2], _vit(q)[3])
              for q in (False, True)]
    res = run_processes(mw.pipeline, 4, str(tmp_path_factory.mktemp("pp")),
                        args=(cases,), timeout_s=240)
    for r in res[1:]:  # every rank holds the last stage's outputs
        for k, v in r.items():
            np.testing.assert_array_equal(v, res[0][k])
    return res[0]


def test_stack_unstack_roundtrip():
    _, _, flat, _ = _vit()
    params = mw._torch(flat)
    stacked = stack_block_params(params, 4)
    assert stacked["attn"]["qkv"]["kernel"].shape == (4, 64, 192)
    back = unstack_block_params(stacked, 4)
    for i in range(4):
        a, b = flatten_tree(params[f"blocks_{i}"]), flatten_tree(
            back[f"blocks_{i}"])
        assert set(a) == set(b)
        for k in a:
            assert torch.equal(a[k], b[k]), k


@pytest.mark.parametrize("n_micro", [1, 4])
def test_gpipe_blocks_match_sequential(stages, n_micro):
    np.testing.assert_allclose(stages[f"m{n_micro}"], _sequential(),
                               rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("quant", [False, True])
def test_vit_pipeline_forward_matches_model(stages, quant):
    model, params, _, x = _vit(quant)
    want = np.asarray(model.apply({"params": params}, jnp.asarray(x)))
    np.testing.assert_allclose(stages[f"q{quant}"], want, rtol=2e-5,
                               atol=2e-5)


def test_pipeline_refusals():
    _, _, flat, x = _vit()
    params = mw._torch(flat)
    mesh = create_mesh((1,), ("pipe",), device="cpu")
    with pytest.raises(ValueError, match="depth 4 not divisible by stages "
                                         "3"):
        mesh3 = mesh.__class__(shape={"pipe": 3}, rank=0,
                               coords={"pipe": 0}, groups={"pipe": None},
                               device=mesh.device)
        gpipe_blocks(stack_block_params(params, 4),
                     torch.zeros((2, 2, 5, 64)), lambda bp, z: z,
                     mesh=mesh3)
    model = VisionTransformer(ViTConfig(**CFG), device="meta")
    with pytest.raises(ValueError, match="batch 4 not divisible by 3"):
        vit_pipeline_forward(model, params, torch.from_numpy(x), mesh=mesh,
                             n_microbatches=3)
    het = VisionTransformer(ViTConfig(**CFG, heads_per_block=(2, 1, 2, 2)),
                            device="meta")
    with pytest.raises(ValueError, match="homogeneous blocks"):
        vit_pipeline_forward(het, params, torch.from_numpy(x), mesh=mesh,
                             n_microbatches=2)
    # one stage: the blocks in order, no exchange
    got = vit_pipeline_forward(model, params, torch.from_numpy(x),
                               mesh=mesh, n_microbatches=2)
    np.testing.assert_allclose(got.numpy(), np.asarray(_vit()[0].apply(
        {"params": _vit()[1]}, jnp.asarray(x))), rtol=2e-5, atol=2e-5)

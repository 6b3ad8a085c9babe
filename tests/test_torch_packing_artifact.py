"""Port parity: int4 packing and the artifact format.

The port's pack/unpack must be byte-identical to the JAX package's, an
artifact written by either package must load in the other with identical
bytes, and the port's seeded random artifact must equal the JAX one.
"""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from quantized_vit_tpu.artifact import (load_vit_int4_artifact as j_load,
                                        save_vit_int4_artifact as j_save)
from quantized_vit_tpu.models.vit import ViTConfig as JConfig
from quantized_vit_tpu.quant.packing import pack_int4 as jpack
from quantized_vit_tpu.quant.packing import unpack_int4 as junpack
from quantized_vit_tpu.serve import random_vit_int4_artifact as j_random
from quantized_vit_tpu_torch.artifact import (load_vit_int4_artifact,
                                              save_vit_int4_artifact)
from quantized_vit_tpu_torch.models import ViTConfig
from quantized_vit_tpu_torch.quant import pack_int4, unpack_int4
from quantized_vit_tpu_torch.serve import (QLayerArtifact,
                                           artifact_from_numpy,
                                           random_vit_int4_artifact)

torch.set_num_threads(1)

SMALL = dict(img_size=32, patch_size=16, embed_dim=64, depth=2, num_heads=4,
             num_classes=10)


def _np(v):
    if isinstance(v, torch.Tensor):
        return v.numpy()
    return np.asarray(v)


def assert_tree_equal(t, j):
    """Port tree ``t`` equals JAX tree ``j``: same structure, dtypes and
    bytes; QLayerArtifact metadata equal."""
    if isinstance(t, QLayerArtifact):
        assert (t.fmt, t.act_pow, t.top) == (j.fmt, j.act_pow, j.top)
        for f in ("w", "scale", "bias", "act"):
            assert_tree_equal(getattr(t, f), getattr(j, f))
    elif isinstance(t, dict):
        assert set(t) == set(j)
        for k in t:
            assert_tree_equal(t[k], j[k])
    elif isinstance(t, (list, tuple)):
        assert len(t) == len(j)
        for a, b in zip(t, j):
            assert_tree_equal(a, b)
    elif t is None:
        assert j is None
    else:
        a, b = _np(t), _np(j)
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("axis", [0, 1])
def test_pack_unpack_byte_identical(axis):
    rng = np.random.default_rng(axis)
    w = rng.integers(-8, 8, (12, 10)).astype(np.int8)
    pt = pack_int4(torch.from_numpy(w), axis=axis)
    pj = jpack(jnp.asarray(w), axis=axis)
    assert pt.numpy().tobytes() == np.asarray(pj).tobytes()
    np.testing.assert_array_equal(unpack_int4(pt, axis=axis).numpy(), w)
    np.testing.assert_array_equal(
        unpack_int4(torch.from_numpy(np.array(pj)), axis=axis).numpy(),
        np.asarray(junpack(pj, axis=axis)))
    with pytest.raises(ValueError):
        pack_int4(torch.zeros((3, 2), dtype=torch.int8), axis=0)


@pytest.mark.parametrize("pack", [True, False], ids=["int4", "int8"])
def test_jax_saved_artifact_loads_byte_equal(tmp_path, pack):
    jart = j_random(JConfig(**SMALL), seed=0, pack_weights=pack)
    j_save(str(tmp_path), jart, JConfig(**SMALL))
    art, cfg = load_vit_int4_artifact(str(tmp_path), device="cpu")
    assert_tree_equal(art, jart)
    assert cfg.embed_dim == 64 and cfg.depth == 2 and cfg.num_tokens == 5
    assert cfg.quant["enabled"] is False


@pytest.mark.parametrize("pack", [True, False], ids=["int4", "int8"])
def test_port_writer_read_by_jax_loader(tmp_path, pack):
    art = random_vit_int4_artifact(ViTConfig(**SMALL), seed=1,
                                   pack_weights=pack, device="cpu")
    save_vit_int4_artifact(str(tmp_path), art, ViTConfig(**SMALL))
    jart, jcfg = j_load(str(tmp_path))
    assert_tree_equal(art, jart)
    assert jcfg == JConfig(**SMALL)


@pytest.mark.parametrize("pack", [True, False], ids=["int4", "int8"])
def test_random_artifact_and_artifact_from_numpy_match_jax(pack):
    jart = j_random(JConfig(**SMALL), seed=3, pack_weights=pack)
    art = random_vit_int4_artifact(ViTConfig(**SMALL), seed=3,
                                   pack_weights=pack, device="cpu")
    assert_tree_equal(art, jart)
    conv = artifact_from_numpy(jax.tree.map(np.asarray, jart), device="cpu")
    assert isinstance(conv["blocks"][1]["fc2"], QLayerArtifact)
    assert_tree_equal(conv, jart)


def test_format_v1_top_inside_act(tmp_path):
    """Format-v1 manifests kept ``top`` inside the act dict as an array
    (artifact/io.py:78-84); the reader lifts it to static metadata."""
    jart = j_random(JConfig(**SMALL), seed=0)
    j_save(str(tmp_path), jart, JConfig(**SMALL))
    man_p = os.path.join(tmp_path, "manifest.json")
    with open(man_p) as f:
        man = json.load(f)
    arrays = dict(np.load(os.path.join(tmp_path, "arrays.npz")))
    q = man["tree"]["__dict__"]["head"]["__qlayer__"]
    top = q.pop("top")
    arrays["root.head.act.top"] = np.asarray(top, np.int32)
    q["act"]["__dict__"]["top"] = {"__arr__": "root.head.act.top"}
    with open(man_p, "w") as f:
        json.dump(man, f)
    np.savez(os.path.join(tmp_path, "arrays.npz"), **arrays)
    art, _ = load_vit_int4_artifact(str(tmp_path), device="cpu")
    assert art["head"].top == top == 7
    assert set(art["head"].act) == {"d", "q_m", "t"}

"""Port parity: the host-side batch preparation (``utils/native_prep.py``
and its C++ engine ``utils/_native/batchprep.cc``) against the JAX
package's module of the same name.

Every comparison is of bytes (no tolerance): the normalization, the row
gather (negative indices wrapped, out-of-range ones refused with
IndexError), and patchify in f32 and uint8, on the port's native path and
on its numpy path, which must give the same bytes as each other and as the
JAX functions."""

import numpy as np
import pytest

from quantized_vit_tpu.utils import native_prep as jnp_prep
from quantized_vit_tpu.utils.data import ArrayDataset as JArrayDataset
from quantized_vit_tpu_torch.utils import native_prep as prep
from quantized_vit_tpu_torch.utils._gxx import BUILD_ROOT, so_path
from quantized_vit_tpu_torch.utils.data import ArrayDataset

MEAN = np.array([0.485, 0.456, 0.406], np.float32)
STD = np.array([0.229, 0.224, 0.225], np.float32)


@pytest.fixture(params=["native", "numpy"])
def path(request, monkeypatch):
    """Each test on the port's native path and on its numpy path."""
    if request.param == "numpy":
        monkeypatch.setattr(prep, "_load", lambda: None)
    else:
        assert prep.native_prep_available() == \
            jnp_prep.native_prep_available()
    return request.param


def test_source_is_the_jax_packages_and_builds_outside_the_package():
    with open(prep._SRC, "rb") as f, open(jnp_prep._SRC, "rb") as g:
        assert f.read() == g.read()
    so = so_path(prep._SRC, prep._SO)
    assert so.parent.parent == BUILD_ROOT
    assert "build" in so.parts and "quantized_vit_tpu_torch" not in so.parts


@pytest.mark.parametrize("stats", ["imagenet", "half", "scalar"])
def test_normalize_u8_batch_bytes_equal_jax(path, stats):
    rng = np.random.default_rng(0)
    u8 = rng.integers(0, 256, (3, 12, 10, 3)).astype(np.uint8)
    mean, std = {"imagenet": (MEAN, STD),
                 "half": (np.full(3, 0.5, np.float32),) * 2,
                 "scalar": (0.25, 0.5)}[stats]
    got = prep.normalize_u8_batch(u8, mean, std)
    want = jnp_prep.normalize_u8_batch(u8, mean, std)
    assert got.dtype == np.float32 and got.shape == u8.shape
    assert got.tobytes() == want.tobytes()


def test_normalize_every_u8_value(path):
    u8 = np.arange(256, dtype=np.uint8).reshape(1, 16, 16, 1).repeat(3, -1)
    got = prep.normalize_u8_batch(u8, MEAN, STD)
    with np.errstate(all="ignore"):
        want = ((u8.astype(np.float32) * (1.0 / 255.0) - MEAN)
                * (1.0 / STD))
    assert got.tobytes() == want.astype(np.float32).tobytes()


@pytest.mark.parametrize("idx", [[3, 0, 49, 7, 7], [-1, -50, 2, -3],
                                 []], ids=["plain", "negative", "empty"])
def test_gather_rows_bytes_equal_jax(path, idx):
    rng = np.random.default_rng(1)
    src = rng.standard_normal((50, 4, 4, 3)).astype(np.float32)
    idx = np.asarray(idx, np.int64)
    got = prep.gather_rows(src, idx)
    assert got.tobytes() == jnp_prep.gather_rows(src, idx).tobytes()
    assert got.tobytes() == src[idx].tobytes()
    assert got.shape == (len(idx), 4, 4, 3)


@pytest.mark.parametrize("idx", [[50], [-51], [0, 3, 99]])
def test_gather_rows_out_of_range_raises(path, idx):
    src = np.zeros((50, 2), np.float32)
    with pytest.raises(IndexError, match="out of range"):
        prep.gather_rows(src, np.asarray(idx))
    with pytest.raises(IndexError, match="out of range"):
        jnp_prep.gather_rows(src, np.asarray(idx))


@pytest.mark.parametrize("shape,patch", [((2, 32, 32, 3), 16),
                                         ((3, 28, 42, 3), 14),
                                         ((1, 16, 16, 1), 8)])
def test_patchify_bytes_equal_jax(path, shape, patch):
    rng = np.random.default_rng(2)
    x = rng.standard_normal(shape).astype(np.float32)
    got = prep.patchify_batch(x, patch)
    assert got.tobytes() == jnp_prep.patchify_batch(x, patch).tobytes()
    u8 = rng.integers(0, 256, shape).astype(np.uint8)
    got8 = prep.patchify_batch_u8(u8, patch)
    assert got8.dtype == np.uint8
    assert got8.tobytes() == jnp_prep.patchify_batch_u8(u8, patch).tobytes()
    # the u8 reorder is the f32 one on the same values
    assert np.array_equal(got8.astype(np.float32),
                          prep.patchify_batch(u8.astype(np.float32), patch))


def test_patchify_refuses_indivisible_images(path):
    with pytest.raises(ValueError, match="not divisible by patch 16"):
        prep.patchify_batch(np.zeros((1, 20, 32, 3), np.float32), 16)
    with pytest.raises(ValueError, match="not divisible by patch 16"):
        prep.patchify_batch_u8(np.zeros((1, 32, 20, 3), np.uint8), 16)


@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.uint8])
def test_array_dataset_get_equals_jax(path, dtype):
    rng = np.random.default_rng(3)
    images = (rng.standard_normal((20, 4, 4, 3)) * 50).astype(dtype)
    labels = rng.integers(0, 5, 20)
    idx = np.asarray([4, -1, 0, 19, 4])
    got = ArrayDataset(images, labels).get(idx)
    want = JArrayDataset(images, labels).get(idx)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()

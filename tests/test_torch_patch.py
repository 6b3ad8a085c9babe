"""Port parity: K4 ``patch_finalize`` plain version and the host patchify
against the JAX package (Pallas kernel in interpret mode, and the XLA
layout of serve/vit_int4.py:244-250). ``acc*scale + pos`` is one f32
multiply and one add in the port; XLA's CPU backend contracts it into one
FMA, so f32 outputs agree to an ulp of the product (|acc*scale| <= ~1.5
here: 1e-6 absolute) and bf16 outputs, rounded from those, agree to one
bf16 ulp at the rare ties."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from quantized_vit_tpu.ops.patch import patch_finalize as j_patch_finalize
from quantized_vit_tpu.utils import native_prep as jprep
from quantized_vit_tpu_torch.ops.patch import (patch_finalize,
                                               patch_finalize_plain)
from quantized_vit_tpu_torch.utils import native_prep as tprep

torch.set_num_threads(1)


@pytest.mark.parametrize("n_pad", [5, 16, 32])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_patch_finalize_plain_matches_jax(dtype, n_pad):
    rng = np.random.default_rng(n_pad)
    b, p, d = 3, 4, 72
    acc = (rng.standard_normal((b, p, d)) * 300).astype(np.float32)
    pos = (rng.standard_normal((p, d)) * 0.02).astype(np.float32)
    cls = (rng.standard_normal(d) * 0.02).astype(np.float32)
    scale = np.float32(1e-3)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    pal = np.asarray(j_patch_finalize(
        jnp.asarray(acc), jnp.asarray(pos), jnp.asarray(cls), scale,
        n_pad=n_pad, out_dtype=jdt, interpret=True), np.float32)
    # the XLA layout of the use_pallas=False forward
    body = jnp.asarray(acc) * jnp.float32(scale) + jnp.asarray(pos)
    x = jnp.concatenate([body, jnp.broadcast_to(jnp.asarray(cls), (b, 1, d))],
                        axis=1).astype(jdt)
    x = jnp.pad(x, ((0, 0), (0, n_pad - p - 1), (0, 0)))
    xla = np.asarray(x.reshape(b * n_pad, d), np.float32)
    args = (torch.from_numpy(acc), torch.from_numpy(pos),
            torch.from_numpy(cls), torch.tensor(scale))
    got = patch_finalize_plain(*args, n_pad=n_pad, out_dtype=tdt)
    assert got.dtype == tdt and got.shape == (b * n_pad, d)
    atol = 1e-6 if dtype == "float32" else 2.0**-8
    np.testing.assert_allclose(got.float().numpy(), pal, rtol=0, atol=atol)
    np.testing.assert_allclose(got.float().numpy(), xla, rtol=0, atol=atol)
    # cls row and padding rows are copies and zeros: exact
    rows = got.float().numpy().reshape(b, n_pad, d)[:, p:]
    np.testing.assert_array_equal(rows, pal.reshape(b, n_pad, d)[:, p:])
    # the public wrapper takes the plain version for CPU tensors
    np.testing.assert_array_equal(
        patch_finalize(*args, n_pad=n_pad, out_dtype=tdt).float().numpy(),
        got.float().numpy())


@pytest.mark.parametrize("u8", [False, True])
def test_patchify_matches_jax_host_prep(u8):
    rng = np.random.default_rng(1)
    if u8:
        img = rng.integers(0, 256, (2, 32, 48, 3)).astype(np.uint8)
        got, want = (tprep.patchify_batch_u8(img, 16),
                     jprep.patchify_batch_u8(img, 16))
    else:
        img = rng.standard_normal((2, 32, 48, 3)).astype(np.float32)
        got, want = (tprep.patchify_batch(img, 16),
                     jprep.patchify_batch(img, 16))
    assert got.dtype == want.dtype and got.shape == (2, 6, 768)
    np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError):
        tprep.patchify_batch(img[:, :30], 16)

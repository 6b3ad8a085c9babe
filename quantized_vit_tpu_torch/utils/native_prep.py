"""Host-side patchify (numpy path of ``quantized_vit_tpu/utils/
native_prep.py``): NHWC images -> the ViT patch layout [B, (H/P)*(W/P),
P*P*C] that ``vit_int4_forward(images_layout='patches')`` takes."""

from __future__ import annotations

import numpy as np


def _patchify(images: np.ndarray, patch: int) -> np.ndarray:
    b, h, w, c = images.shape
    if h % patch or w % patch:
        raise ValueError(f"image {h}x{w} not divisible by patch {patch}")
    x = images.reshape(b, h // patch, patch, w // patch, patch * c)
    x = np.transpose(x, (0, 1, 3, 2, 4))
    return np.ascontiguousarray(
        x.reshape(b, (h // patch) * (w // patch), patch * patch * c))


def patchify_batch(images: np.ndarray, patch: int) -> np.ndarray:
    """NHWC f32 batch -> [B, (H/P)*(W/P), P*P*C] f32."""
    return _patchify(np.ascontiguousarray(images, np.float32), patch)


def patchify_batch_u8(images: np.ndarray, patch: int) -> np.ndarray:
    """uint8 variant (the integer-input serving mode, ``input_scale``)."""
    return _patchify(np.ascontiguousarray(images, np.uint8), patch)

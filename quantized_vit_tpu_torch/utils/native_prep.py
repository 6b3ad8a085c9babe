"""Host-side input preparation (``quantized_vit_tpu/utils/
native_prep.py``, numpy paths): patchify (NHWC images -> the ViT patch
layout [B, (H/P)*(W/P), P*P*C] that ``vit_int4_forward(images_layout=
'patches')`` takes) and :class:`PrefetchLoader`."""

from __future__ import annotations

import queue
import threading
from typing import Iterator

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


class PrefetchLoader:
    """Wrap any batch iterator; a background thread keeps ``depth`` batches
    prepared ahead so host-side input work overlaps the device step."""

    def __init__(self, loader, depth: int = 2):
        self.loader = loader
        self.depth = int(depth)

    def __len__(self):
        return len(self.loader)

    def __iter__(self) -> Iterator:
        q: "queue.Queue" = queue.Queue(maxsize=self.depth)
        end = object()
        err: list = []
        abandoned = threading.Event()

        def put(item) -> bool:
            # a bounded put that notices the consumer leaving (break or an
            # exception in the training loop), so the producer never blocks
            # forever holding prepared batches
            while not abandoned.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def work():
            try:
                for item in self.loader:
                    if not put(item):
                        return
            except BaseException as e:  # raised again in the consumer
                err.append(e)
            finally:
                put(end)

        threading.Thread(target=work, daemon=True).start()
        try:
            while True:
                item = q.get()
                if item is end:
                    if err:
                        raise err[0]
                    return
                yield item
        finally:
            abandoned.set()

"""Host-side input preparation (``quantized_vit_tpu/utils/native_prep.py``):
the C++ batch-prep engine (``_native/batchprep.cc``, OpenMP, bound with
:mod:`ctypes`) for the uint8 -> normalized-f32 conversion, the batch
gather of an in-memory dataset and patchify (NHWC images -> the ViT patch
layout [B, (H/P)*(W/P), P*P*C] that ``vit_int4_forward(images_layout=
'patches')`` takes), and :class:`PrefetchLoader`.

The engine is built with g++ at first use into ``build/native/<hash>/``
at the repository root (listed in ``.gitignore``), keyed on a hash of the
source, so an edited source rebuilds. Without g++ every function takes
its numpy path, as the JAX package's does; both give the same bytes.
"""

from __future__ import annotations

import ctypes
import queue
import threading
from pathlib import Path
from typing import Iterator

import numpy as np

from ._gxx import load_library

_SRC = Path(__file__).resolve().parent / "_native" / "batchprep.cc"
_SO = "libqvtbatchprep.so"


def _bind(lib: ctypes.CDLL) -> None:
    f32p = ctypes.POINTER(ctypes.c_float)
    i64 = ctypes.c_int64
    lib.qvt_normalize_u8_to_f32.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), f32p, i64, i64, f32p, f32p]
    lib.qvt_gather_rows_f32.argtypes = [
        f32p, ctypes.POINTER(ctypes.c_int64), f32p, i64, i64]
    lib.qvt_patchify_f32.argtypes = [f32p, f32p, i64, i64, i64, i64, i64]
    for fn in (lib.qvt_normalize_u8_to_f32, lib.qvt_gather_rows_f32,
               lib.qvt_patchify_f32):
        fn.restype = None


def _load():
    return load_library(_SRC, _SO, _bind)


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def native_prep_available() -> bool:
    """Whether the C++ engine is built and loaded (else the numpy paths
    run)."""
    return _load() is not None


def normalize_u8_batch(images_u8: np.ndarray, mean: np.ndarray,
                       std: np.ndarray) -> np.ndarray:
    """uint8 NHWC batch -> normalized float32 in one pass:
    ``(x * (1/255) - mean) * (1/std)`` in f32 (the C++ path reads
    per-channel 256-entry tables of exactly those values)."""
    images_u8 = np.ascontiguousarray(images_u8, np.uint8)
    c = images_u8.shape[-1]
    # broadcast scalars before the native call: it reads mean[ch] and
    # inv_std[ch] for every ch < c
    mean = np.ascontiguousarray(
        np.broadcast_to(np.asarray(mean, np.float32), (c,)))
    inv_std = np.ascontiguousarray(
        np.broadcast_to(1.0 / np.asarray(std, np.float32), (c,)))
    lib = _load()
    if lib is None:
        return ((images_u8.astype(np.float32) * (1.0 / 255.0) - mean)
                * inv_std)
    out = np.empty(images_u8.shape, np.float32)
    lib.qvt_normalize_u8_to_f32(
        _ptr(images_u8, ctypes.c_uint8), _ptr(out, ctypes.c_float),
        images_u8.size // c, c, _ptr(mean, ctypes.c_float),
        _ptr(inv_std, ctypes.c_float))
    return out


def gather_rows(src: np.ndarray, idx: np.ndarray) -> np.ndarray:
    """``src[idx]`` for a float32 array on the host, rows copied in
    parallel (the batch gather of an in-memory dataset). numpy's
    semantics: negative indices wrap, out-of-range ones raise IndexError.

    Not the K14 kernel of the same name (``ops/ring_gather.py:
    gather_rows``, which gathers weight shards across processes on the
    card): this one is host code over numpy arrays."""
    src = np.ascontiguousarray(src, np.float32)
    idx = np.asarray(idx, np.int64)
    # checked here: the C++ gather dereferences unchecked
    idx = np.where(idx < 0, idx + len(src), idx)
    if idx.size and (idx.min() < 0 or idx.max() >= len(src)):
        raise IndexError(
            f"gather index out of range for first axis of size {len(src)}")
    idx = np.ascontiguousarray(idx)
    lib = _load()
    if lib is None:
        return src[idx]
    out = np.empty((len(idx),) + src.shape[1:], np.float32)
    lib.qvt_gather_rows_f32(
        _ptr(src, ctypes.c_float), _ptr(idx, ctypes.c_int64),
        _ptr(out, ctypes.c_float), len(idx), int(np.prod(src.shape[1:])))
    return out


def _patchify(images: np.ndarray, patch: int) -> np.ndarray:
    b, h, w, c = images.shape
    x = images.reshape(b, h // patch, patch, w // patch, patch * c)
    x = np.transpose(x, (0, 1, 3, 2, 4))
    return np.ascontiguousarray(
        x.reshape(b, (h // patch) * (w // patch), patch * patch * c))


def _check_patch(images: np.ndarray, patch: int):
    h, w = images.shape[1:3]
    if h % patch or w % patch:
        raise ValueError(f"image {h}x{w} not divisible by patch {patch}")


def patchify_batch(images: np.ndarray, patch: int) -> np.ndarray:
    """NHWC f32 batch -> [B, (H/P)*(W/P), P*P*C] f32: a byte reorder on
    the host (the C++ engine's, else numpy's)."""
    images = np.ascontiguousarray(images, np.float32)
    _check_patch(images, patch)
    lib = _load()
    if lib is None:
        return _patchify(images, patch)
    b, h, w, c = images.shape
    out = np.empty((b, (h // patch) * (w // patch), patch * patch * c),
                   np.float32)
    lib.qvt_patchify_f32(_ptr(images, ctypes.c_float),
                         _ptr(out, ctypes.c_float), b, h, w, c, patch)
    return out


def patchify_batch_u8(images: np.ndarray, patch: int) -> np.ndarray:
    """uint8 variant (the integer-input serving mode, ``input_scale``):
    the same reorder on numpy's path, as in the JAX package (the engine is
    f32 only)."""
    images = np.ascontiguousarray(images, np.uint8)
    _check_patch(images, patch)
    return _patchify(images, patch)


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

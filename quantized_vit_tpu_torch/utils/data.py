"""Data pipeline (``quantized_vit_tpu/utils/data.py``): an in-memory
dataset, a class-per-subfolder image dataset decoded with PIL, and a
loader of numpy NHWC float32 batches of a fixed size, the trailing
partial batch dropped or padded with a validity mask."""

from __future__ import annotations

import os
import random
from typing import Callable, Iterator, List, Optional, Sequence, Tuple

import numpy as np

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def normalize_image(x: np.ndarray, mean=IMAGENET_MEAN, std=IMAGENET_STD):
    """[0,1] float image (H, W, 3) -> normalized."""
    return (x - mean) / std


def read_split_data(root: str, val_rate: float = 0.2, seed: int = 0
                    ) -> Tuple[List[str], List[int], List[str], List[int]]:
    """Split a class-per-subfolder image tree into (train_paths,
    train_labels, val_paths, val_labels); class indices follow the sorted
    subfolder names."""
    if not os.path.isdir(root):
        raise FileNotFoundError(f"dataset root {root} does not exist")
    classes = sorted(c for c in os.listdir(root)
                     if os.path.isdir(os.path.join(root, c)))
    class_idx = {c: i for i, c in enumerate(classes)}
    rng = random.Random(seed)
    exts = {".jpg", ".jpeg", ".png", ".bmp"}
    train_paths: List[str] = []
    train_labels: List[int] = []
    val_paths: List[str] = []
    val_labels: List[int] = []
    for c in classes:
        cdir = os.path.join(root, c)
        imgs = sorted(os.path.join(cdir, f) for f in os.listdir(cdir)
                      if os.path.splitext(f)[1].lower() in exts)
        val_set = set(rng.sample(imgs, k=int(len(imgs) * val_rate)))
        for p in imgs:
            if p in val_set:
                val_paths.append(p)
                val_labels.append(class_idx[c])
            else:
                train_paths.append(p)
                train_labels.append(class_idx[c])
    return train_paths, train_labels, val_paths, val_labels


class ArrayDataset:
    """In-memory dataset over (images NHWC float32, labels int) arrays."""

    def __init__(self, images: np.ndarray, labels: np.ndarray):
        if len(images) != len(labels):
            raise ValueError(f"{len(images)} images but {len(labels)} "
                             "labels")
        self.images = np.asarray(images)
        self.labels = np.asarray(labels, np.int32)

    def __len__(self):
        return len(self.images)

    def get(self, idx: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        if self.images.dtype == np.float32:
            from .native_prep import gather_rows

            return gather_rows(self.images, idx), self.labels[idx]
        return self.images[idx], self.labels[idx]


class ImageFolderDataset:
    """Path-list dataset decoding with PIL at access time: each file
    resized to ``img_size`` square (bilinear) as uint8; a file that is not
    RGB raises ValueError. ``transform`` maps a float32 [0, 1] HWC array to
    the final HWC array; with ``normalize=(mean, std)`` and no
    ``transform`` the batch stays uint8 until one
    :func:`~.native_prep.normalize_u8_batch` call normalizes all of it."""

    def __init__(self, paths: Sequence[str], labels: Sequence[int],
                 img_size: int = 224,
                 transform: Optional[Callable[[np.ndarray], np.ndarray]] = None,
                 normalize: Optional[Tuple[np.ndarray, np.ndarray]] = None):
        if len(paths) != len(labels):
            raise ValueError(f"{len(paths)} paths but {len(labels)} labels")
        self.paths = list(paths)
        self.labels = np.asarray(labels, np.int32)
        self.img_size = img_size
        self.transform = transform
        self.normalize = normalize

    def __len__(self):
        return len(self.paths)

    def _decode_u8(self, path: str) -> np.ndarray:
        from PIL import Image

        img = Image.open(path)
        if img.mode != "RGB":
            raise ValueError(f"image: {path} isn't RGB mode.")
        img = img.resize((self.img_size, self.img_size), Image.BILINEAR)
        return np.asarray(img, np.uint8)

    def _load(self, path: str) -> np.ndarray:
        x = self._decode_u8(path).astype(np.float32) / 255.0
        if self.transform is not None:
            x = self.transform(x)
        return x

    def get(self, idx: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        if self.normalize is not None and self.transform is None:
            from .native_prep import normalize_u8_batch

            xs_u8 = np.stack([self._decode_u8(self.paths[i]) for i in idx])
            return (normalize_u8_batch(xs_u8, *self.normalize),
                    self.labels[idx])
        xs = np.stack([self._load(self.paths[i]) for i in idx])
        return xs, self.labels[idx]


class DataLoader:
    """Fixed-size batch iterator with the JAX package's numpy shuffling (the
    same seed gives the same batches). ``pad_last=False`` drops the
    trailing partial batch; ``pad_last=True`` fills it with index 0 and
    marks those rows invalid. Yields (images, labels, mask) as float32,
    int32 and bool numpy arrays."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = False,
                 seed: int = 0, pad_last: bool = False):
        self.dataset = dataset
        self.batch_size = int(batch_size)
        self.shuffle = shuffle
        self.pad_last = pad_last
        self._rng = np.random.default_rng(seed)

    def __len__(self):
        n = len(self.dataset)
        if self.pad_last:
            return (n + self.batch_size - 1) // self.batch_size
        return n // self.batch_size

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
        n = len(self.dataset)
        order = np.arange(n)
        if self.shuffle:
            self._rng.shuffle(order)
        bs = self.batch_size
        stop = n if self.pad_last else (n // bs) * bs
        for start in range(0, stop, bs):
            idx = order[start:start + bs]
            mask = np.ones(bs, bool)
            if len(idx) < bs:
                pad = bs - len(idx)
                mask[len(idx):] = False
                idx = np.concatenate([idx, np.zeros(pad, idx.dtype)])
            images, labels = self.dataset.get(idx)
            yield images.astype(np.float32), labels, mask

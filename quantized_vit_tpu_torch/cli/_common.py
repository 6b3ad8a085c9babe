"""Shared CLI plumbing: dataset flags, model presets, checkpoints, seeding
(port of ``quantized_vit_tpu/cli/_common.py``, plus ``cli/eval.py``'s
``vit_config_from_dict``, which ``cli/train.py`` needs too)."""

from __future__ import annotations

import argparse
from typing import Tuple

import numpy as np


def set_seed(seed: int):
    """Python's, numpy's and torch's default generators from ``seed``."""
    import random

    import torch

    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)


def add_dataset_args(p: argparse.ArgumentParser):
    p.add_argument("--dataset", default="synthetic",
                   choices=["synthetic", "folder", "npz"],
                   help="synthetic: random data (smoke runs); folder: "
                        "class-per-subfolder image tree (read_split_data); "
                        "npz: {train,test}_{images,labels} arrays")
    p.add_argument("--data-path", default="", help="dataset root / npz file")
    p.add_argument("--num-classes", type=int, default=10)
    p.add_argument("--img-size", type=int, default=224)
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--synthetic-samples", type=int, default=64)


def add_model_args(p: argparse.ArgumentParser):
    p.add_argument("--model", default="vit_b16",
                   choices=["vit_b16", "vit_b32", "vit_l16", "vit_tiny_test",
                            "vit_small_test"],
                   help="vit_tiny_test is a 2-block toy for smoke runs; "
                        "vit_small_test a 4-block patch-8 model for the "
                        "accuracy rehearsal")
    p.add_argument("--weights", default="",
                   help="checkpoint to initialize from (opt/checkpoint)")


def model_config(args, quant):
    """The ViTConfig of ``--model`` (the five presets)."""
    from ..models.vit import ViTConfig

    presets = {"vit_b16": (16, 768, 12, 12), "vit_b32": (32, 768, 12, 12),
               "vit_l16": (16, 1024, 24, 16),
               "vit_small_test": (8, 64, 4, 4),
               "vit_tiny_test": (16, 64, 2, 2)}
    patch, dim, depth, heads = presets[args.model]
    return ViTConfig(img_size=args.img_size, patch_size=patch, embed_dim=dim,
                     depth=depth, num_heads=heads,
                     num_classes=args.num_classes, quant=quant)


def build_model(args, quant, device="cuda", seed: int = 0):
    """(model, config) from ``--model``: the model's weights drawn from
    ``seed`` on ``device`` (the card unless the caller asks for the
    CPU)."""
    from ..models.vit import VisionTransformer

    cfg = model_config(args, quant)
    return VisionTransformer(cfg, seed=seed, device=device), cfg


def load_params_any(path: str, device="cuda") -> Tuple:
    """(params, step, extra) of a checkpoint of the port
    (``opt.checkpoint``), its tensors on ``device``, or of a reference
    PyTorch ``.pt``/``.pth`` file whose keys are ``layers.{i}.*``: the
    UltraNet Sequential, its BN statistics under ``extra["batch_stats"]``.
    Any other ``.pt`` file (a ViT state dict) needs the ViT converters of
    interop/, not ported."""
    if path.endswith((".pt", ".pth")):
        from ..artifact.ultranet import as_tensors
        from ..device import resolve_device
        from ..interop import load_torch_checkpoint, ultranet_params_from_torch

        resolve_device(device)
        sd = load_torch_checkpoint(path)
        if any(k.startswith("layers.") for k in sd):
            params, stats = ultranet_params_from_torch(sd)
            return (as_tensors(params, device), 0,
                    {"batch_stats": as_tensors(stats, device)})
        raise NotImplementedError(
            f"{path}: reading a reference ViT checkpoint needs interop/'s "
            "ViT converters, not ported (ROADMAP.md, modules to port, "
            "'Other model families, interop, auto-discovery')")
    from ..opt.checkpoint import load_checkpoint

    return load_checkpoint(path, device=device)


def build_datasets(args) -> Tuple:
    """(train_ds, val_ds) per ``--dataset``: the synthetic arrays from the
    JAX function's numpy draws (equal byte for byte), an npz file, or a
    class-per-subfolder image tree split by ``read_split_data``."""
    from ..utils import ArrayDataset, ImageFolderDataset, read_split_data

    if args.dataset == "synthetic":
        rng = np.random.default_rng(0)
        n = args.synthetic_samples
        s = args.img_size

        def mk(k):
            return ArrayDataset(
                rng.standard_normal((k, s, s, 3)).astype(np.float32),
                rng.integers(0, args.num_classes, k))

        return mk(n), mk(max(n // 4, args.batch_size))
    if args.dataset == "npz":
        with np.load(args.data_path) as z:
            return (ArrayDataset(z["train_images"], z["train_labels"]),
                    ArrayDataset(z["test_images"], z["test_labels"]))
    tp, tl, vp, vl = read_split_data(args.data_path)
    # decoded as uint8, the batch normalized in one native pass with the
    # JAX CLI's (0.5, 0.5) statistics (the reference's CIFAR-style
    # Normalize(0.5, 0.5, 0.5))
    norm = (np.full(3, 0.5, np.float32), np.full(3, 0.5, np.float32))
    return (ImageFolderDataset(tp, tl, img_size=args.img_size,
                               normalize=norm),
            ImageFolderDataset(vp, vl, img_size=args.img_size,
                               normalize=norm))


def vit_config_from_dict(d: dict):
    """A ViTConfig from its dict form (a ``compressed`` checkpoint's
    ``subnet``: per-block widths as lists, the quant config as a dict)."""
    from ..models.layers import QuantConfig
    from ..models.vit import ViTConfig

    d = dict(d)
    q = {k: (tuple(v) if isinstance(v, list) else v)
         for k, v in d.pop("quant").items()}
    for k in ("heads_per_block", "hidden_per_block"):
        if d.get(k) is not None:
            d[k] = tuple(d[k])
    return ViTConfig(quant=QuantConfig(**q), **d)

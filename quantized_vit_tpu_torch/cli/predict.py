"""Single-image prediction (port of ``quantized_vit_tpu/cli/predict.py``).

Loads a checkpoint (full or compressed, as ``cli.eval``), preprocesses
one image (RGB, bilinear resize, [0, 1], ImageNet normalization), and
prints the softmax top-k with class names from an optional JSON index
``{idx: name}``. Runs on the card unless ``--device cpu``.

    python -m quantized_vit_tpu_torch.cli.predict --checkpoint CKPT \\
        --image img.png [--class-index classes.json] [--topk 5]
"""

from __future__ import annotations

import argparse
import json

import numpy as np

from ._common import add_model_args
from .eval import load_model_for_eval


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="QViT single-image prediction")
    add_model_args(p)
    p.add_argument("--checkpoint", required=True)
    p.add_argument("--image", required=True)
    p.add_argument("--img-size", type=int, default=224)
    p.add_argument("--num-classes", type=int, default=10)
    p.add_argument("--class-index", default="",
                   help="json {idx: name}")
    p.add_argument("--topk", type=int, default=5)
    p.add_argument("--fp32", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cpu' runs the plain PyTorch path")
    return p.parse_args(argv)


def load_image(path: str, img_size: int) -> np.ndarray:
    """[1, img_size, img_size, 3] float32: converted to RGB (unlike the
    folder dataset, which refuses other modes), resized, /255,
    normalized."""
    from PIL import Image

    from ..utils.data import normalize_image

    img = Image.open(path)
    if img.mode != "RGB":
        img = img.convert("RGB")
    img = img.resize((img_size, img_size), Image.BILINEAR)
    x = np.asarray(img, np.float32) / 255.0
    return normalize_image(x)[None]


def main(argv=None):
    """Returns the top-k as [(class index, probability), ...]."""
    args = parse_args(argv)

    import torch

    from ..device import resolve_device
    from ..models import apply

    dev = resolve_device(args.device)
    model, params = load_model_for_eval(args, device=dev)
    x = torch.from_numpy(load_image(args.image, args.img_size)).to(dev)
    with torch.no_grad():
        logits = apply(model, params, x, deterministic=True)
    probs = torch.softmax(logits[0], dim=-1).cpu().numpy()
    names = {}
    if args.class_index:
        with open(args.class_index) as f:
            names = {int(k): v for k, v in json.load(f).items()}
    order = np.argsort(-probs)[: args.topk]
    for i in order:
        print(f"class: {names.get(int(i), int(i)):<20} "
              f"prob: {probs[i]:.4f}")
    return [(int(i), float(probs[i])) for i in order]


if __name__ == "__main__":
    main()

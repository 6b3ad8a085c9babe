"""Test-set evaluation of a (possibly compressed) checkpoint (port of
``quantized_vit_tpu/cli/eval.py``).

Loads the model, runs the test split of ``--dataset`` through the QAT
forward (``models.apply``, deterministic), and reports top-1 / top-5 and
the mean loss, optionally written to ``--results`` as JSON. A compressed
subnet (``cli.train``'s ``compressed`` checkpoint) is rebuilt from the
ViTConfig dict in its meta (``extra["subnet"]``); any other checkpoint
runs on the architecture of ``--model``. Runs on the card unless
``--device cpu``.

    python -m quantized_vit_tpu_torch.cli.eval --checkpoint runs/train/final \\
        --model vit_tiny_test --img-size 32 --dataset folder --data-path DIR
"""

from __future__ import annotations

import argparse
import json
import os

from ._common import (add_dataset_args, add_model_args, build_datasets,
                      load_params_any, model_config, set_seed,
                      vit_config_from_dict)


def load_model_for_eval(args, device="cuda"):
    """(model, params) on ``device``: the subnet of the checkpoint's
    ``extra["subnet"]`` config, else the architecture of ``--model`` (with
    quantizers unless ``--fp32``). ``params`` keeps the checkpoint's leaves
    that the model has (flax's apply ignores the others, such as the
    quantizer scalars under ``--fp32``); the model holds its tensors."""
    from ..models import QuantConfig, VisionTransformer, model_for_params
    from ..models.layers import flatten_tree, unflatten_tree

    params, _, extra = load_params_any(args.checkpoint, device=device)
    if "subnet" in extra:
        cfg = vit_config_from_dict(extra["subnet"])
    else:
        cfg = model_config(args, QuantConfig(enabled=not args.fp32))
    wanted = flatten_tree(VisionTransformer(cfg, device="meta").param_tree())
    flat = flatten_tree(params)
    missing = sorted(set(wanted) - set(flat))
    if missing:
        raise ValueError(f"{args.checkpoint}: no {missing[:4]} for the "
                         f"model of {cfg}")
    params = unflatten_tree({k: flat[k] for k in wanted})
    return model_for_params(cfg, params), params


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="QViT checkpoint evaluation")
    add_dataset_args(p)
    add_model_args(p)
    p.add_argument("--checkpoint", required=True,
                   help="checkpoint path prefix (from cli.train)")
    p.add_argument("--fp32", action="store_true",
                   help="evaluate without quantizers")
    p.add_argument("--results", default="",
                   help="optional results path (JSON)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cpu' runs the plain PyTorch path")
    return p.parse_args(argv)


def main(argv=None):
    """Returns ``{"top1", "top5", "loss", "samples"}``."""
    args = parse_args(argv)
    set_seed(args.seed)

    from ..device import resolve_device
    from ..models import apply
    from ..utils import DataLoader, evaluate

    dev = resolve_device(args.device)
    model, params = load_model_for_eval(args, device=dev)
    _, test_ds = build_datasets(args)
    loader = DataLoader(test_ds, args.batch_size, pad_last=True)
    out = evaluate(lambda p, x: apply(model, p, x, deterministic=True),
                   params, loader, device=dev)
    print(f"[eval] top1 {out['top1']:.4f} top5 {out['top5']:.4f} "
          f"loss {out['loss']:.4f} ({out['samples']} samples)")
    if args.results:
        os.makedirs(os.path.dirname(args.results) or ".", exist_ok=True)
        with open(args.results, "w") as f:
            json.dump(out, f, indent=1)
    return out


if __name__ == "__main__":
    main()

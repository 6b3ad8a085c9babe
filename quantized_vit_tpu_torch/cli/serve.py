"""Serving CLI: INT4 artifact + continuous batching load test (port of
``quantized_vit_tpu/cli/serve.py``, single-device path).

Loads a ViT INT4 artifact, starts the :class:`ContinuousBatcher`, fires
``--requests`` synthetic requests (distinct images from a fixed seed) and
reports throughput, latency and batch occupancy as one JSON line. It
serves an f32 residual stream (``SERVE_DTYPE``), as the JAX CLI's
single-device branch does (it calls ``vit_int4_forward`` with its f32
default, quantized_vit_tpu/cli/serve.py:129-146), so the two CLIs answer
alike on one artifact; bf16 is the JAX CLI's mesh branch, not ported.

    python -m quantized_vit_tpu_torch.cli.serve --artifact DIR [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

SERVE_DTYPE = torch.float32  # the residual stream's dtype


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="QViT INT4 serving load test")
    p.add_argument("--artifact", required=True)
    p.add_argument("--requests", type=int, default=64)
    p.add_argument("--rate", type=float, default=0.0,
                   help="request arrival rate /s (0 = as fast as possible)")
    p.add_argument("--max-batch", type=int, default=8)
    p.add_argument("--max-delay-ms", type=float, default=5.0)
    p.add_argument("--mesh-model", type=int, default=0,
                   help="multi-device serving (not ported: must stay 0)")
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cpu' runs the plain PyTorch path")
    p.add_argument("--no-kernels", "--no-pallas", dest="no_kernels",
                   action="store_true",
                   help="plain PyTorch ops instead of the CUDA kernels "
                        "(--no-pallas: the JAX CLI's name of this flag)")
    p.add_argument("--input-uint8", action="store_true",
                   help="serve uint8 pixel inputs; cast and scale by 1/255 "
                        "on the device")
    return p.parse_args(argv)


def build_forward(args):
    """Artifact + flags -> (forward(images) -> logits tensor, cfg)."""
    if args.mesh_model:
        raise SystemExit(
            "--mesh-model: multi-device serving is not ported yet "
            "(ROADMAP.md, modules to port, 'Multi-device')")
    from ..artifact import load_vit_int4_artifact
    from ..serve import prepare_kernels, vit_int4_forward
    from ..utils.native_prep import patchify_batch, patchify_batch_u8

    art, cfg = load_vit_int4_artifact(args.artifact, device=args.device)
    dev = torch.device(args.device)
    use_kernels = not args.no_kernels
    # the kernels' weight layout and folded constants, made once
    plan = (prepare_kernels(art, cfg) if use_kernels and dev.type != "cpu"
            else None)
    kw = dict(float_dtype=SERVE_DTYPE, images_layout="patches",
              use_kernels=use_kernels, plan=plan)
    # host-side patchify in the batcher's dispatch thread (the host writes
    # these bytes during batch assembly anyway)
    if args.input_uint8:
        def forward(images):
            x = torch.from_numpy(patchify_batch_u8(
                np.asarray(images, np.uint8), cfg.patch_size)).to(dev)
            return vit_int4_forward(art, x, cfg, input_scale=1.0 / 255.0,
                                    **kw)
    else:
        def forward(images):
            x = torch.from_numpy(patchify_batch(
                np.asarray(images, np.float32), cfg.patch_size)).to(dev)
            return vit_int4_forward(art, x, cfg, **kw)
    return forward, cfg


def request_images(cfg, n: int, uint8: bool) -> np.ndarray:
    rng = np.random.default_rng(0)
    shape = (n, cfg.img_size, cfg.img_size, cfg.in_channels)
    if uint8:
        return rng.integers(0, 256, shape).astype(np.uint8)
    return rng.standard_normal(shape).astype(np.float32)


def main(argv=None):
    """Runs the load test; prints the summary as one JSON line and returns
    it, with the request ``images`` and their ``answers`` (logits) added."""
    args = parse_args(argv)
    from ..serve import ContinuousBatcher

    forward, cfg = build_forward(args)
    images = request_images(cfg, args.requests, args.input_uint8)
    batcher = ContinuousBatcher(forward, max_batch=args.max_batch,
                                max_delay_ms=args.max_delay_ms)
    print("[serve] warming buckets", batcher.buckets)
    batcher.warmup(images[0])

    lat = []
    t0 = time.time()
    with batcher:
        futs = []
        for img in images:
            if args.rate > 0:
                time.sleep(1.0 / args.rate)
            futs.append((time.monotonic(), batcher.submit(img)))
        answers = []
        for t_sub, f in futs:
            answers.append(f.result(timeout=120))
            lat.append(time.monotonic() - t_sub)
    wall = time.time() - t0

    out = {
        "requests": args.requests,
        "device": str(args.device),
        "wall_s": round(wall, 3),
        "throughput_rps": round(args.requests / wall, 2),
        "latency_p50_ms": round(float(np.percentile(lat, 50)) * 1e3, 2),
        "latency_p99_ms": round(float(np.percentile(lat, 99)) * 1e3, 2),
        "batches": batcher.stats["batches"],
        "padded": batcher.stats["padded"],
        "batch_hist": batcher.stats["batch_hist"],
    }
    print(json.dumps(out))
    out["images"] = images
    out["answers"] = np.stack(answers)
    return out


if __name__ == "__main__":
    main()

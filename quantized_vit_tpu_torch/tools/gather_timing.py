"""K15 (``fused_mlp_gather``) and the FSDP forwards, timed on the card
through the package's public entry points, so that one script times any
version of the package (run it from the root of a checkout):

    python3 -m quantized_vit_tpu_torch.tools.gather_timing

Prints one JSON object: the card (``nvidia-smi``'s name and power limit);
at each K15 site (the MLP of ViT-B/16's and ViT-H/14's FSDP forward at
batch 32, tp = 1, gathering the next block's four int8 weights, 7.08 and
19.7 MB; and ViT-B/16's gathering 4, 8, 16 and 31 MB of int8 rows, the
overlap sweep), random bf16 x and int8 weights from seed 0: K15
(``run_mlp_gather`` on a prepared plan and gather), K2 on the same plan
(``run_mlp``) and K14 alone on the same gather (``run_gather_rows``),
each the median of 200 CUDA-event readings after 5 warm-ups (None where
the version refuses the width);
and the forwards at batch 32 (int8-stored levels from seed 0, bf16
residual stream): ``vit_int4_forward_fsdp_rdma`` at tp = 1 and
``vit_int4_forward`` of ViT-B/16 and ViT-H/14, medians of 20 in ms.
"""

from __future__ import annotations

import json
import subprocess

import numpy as np
import torch

from ..models import ViTConfig
from ..ops import (plan_gather_rows, plan_mlp, run_gather_rows, run_mlp,
                   run_mlp_gather)
from ..serve import (prepare_fsdp_rdma_kernels, prepare_kernels,
                     random_vit_int4_artifact, shard_fsdp_rdma_artifact,
                     vit_int4_forward, vit_int4_forward_fsdp_rdma)
from .chain_timing import events_us

# (rows, K, H, bytes of dummy int8 rows to gather; None: the next block's
# four weights)
SITES = {"vitb_b32": (6656, 768, 3072, None),
         "vith_b32": (8704, 1280, 5120, None),
         **{f"vitb_b32_{mb}MB": (6656, 768, 3072, mb << 20)
            for mb in (4, 8, 16, 31)}}
MODELS = {"vitb": {}, "vith": dict(patch_size=14, embed_dim=1280, depth=32,
                                   num_heads=16, num_classes=1000)}
BATCH = 32


def k15_site(m, k, hid, nbytes, g):
    one = torch.ones((), device="cuda")
    x = torch.randn((m, k), generator=g, device="cuda").to(torch.bfloat16)
    w1 = torch.randint(-7, 8, (k, hid), dtype=torch.int8, device="cuda",
                       generator=g)
    w2 = torch.randint(-7, 8, (hid, k), dtype=torch.int8, device="cuda",
                       generator=g)
    if nbytes is None:
        shapes = [(k, 3 * k), (k, k), (k, hid), (hid, k)]
    else:
        rows = nbytes // k
        shapes = [(rows - rows % 32, k)]
    shards = [torch.randint(-128, 128, s, dtype=torch.int8, device="cuda",
                            generator=g) for s in shapes]
    plan = plan_mlp(w1, 1e-3 * one, None, w2, 1e-3 * one, None, fmt="int8",
                    ln_scale=torch.ones(k, device="cuda"),
                    ln_bias=torch.zeros(k, device="cuda"), act_d=0.05 * one,
                    act_t=one, act_top=127, hid_d=0.05 * one, hid_t=one,
                    hid_top=127)
    gather = plan_gather_rows(shards)
    out = {"bytes": sum(s.numel() for s in shards),
           "k2_same_plan": events_us(lambda: run_mlp(plan, x)),
           "k14_alone": events_us(lambda: run_gather_rows(gather))}
    try:
        out["k15"] = events_us(lambda: run_mlp_gather(plan, gather, x))
    except (ValueError, RuntimeError):  # a version with a width limit
        out["k15"] = None
    return out


def main():
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    out = {"card": smi, "k15_us": {}, "forward_ms": {}}
    g = torch.Generator(device="cuda").manual_seed(0)
    for site, (m, k, hid, nbytes) in SITES.items():
        out["k15_us"][site] = k15_site(m, k, hid, nbytes, g)
    kw = dict(float_dtype=torch.bfloat16, images_layout="patches")
    for name, cfg_kw in MODELS.items():
        cfg = ViTConfig(**cfg_kw)
        art = random_vit_int4_artifact(cfg, seed=0, pack_weights=False,
                                       device="cuda")
        kp = cfg.patch_size**2 * cfg.in_channels
        x = torch.from_numpy(np.random.default_rng(1).standard_normal(
            (BATCH, cfg.num_patches, kp)).astype(np.float32)).cuda()
        plan = prepare_kernels(art, cfg)
        out["forward_ms"][f"{name}_b{BATCH}"] = events_us(
            lambda: vit_int4_forward(art, x, cfg, plan=plan, **kw),
            iters=20, warmup=3) / 1e3
        del plan
        fart = shard_fsdp_rdma_artifact(art, 0, 1)
        del art
        try:
            fplan = prepare_fsdp_rdma_kernels(fart, cfg)
        except ValueError:  # a version with a width limit
            out["forward_ms"][f"{name}_fsdp_tp1_b{BATCH}"] = None
            continue
        out["forward_ms"][f"{name}_fsdp_tp1_b{BATCH}"] = events_us(
            lambda: vit_int4_forward_fsdp_rdma(fart, x, cfg, plan=fplan,
                                               **kw),
            iters=20, warmup=3) / 1e3
        del fart, fplan
    print(json.dumps(out))


if __name__ == "__main__":
    main()

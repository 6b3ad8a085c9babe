"""K5's work split on the card: the layout of ``ops/block_stack.py:
stack_layout`` against its neighbours.

On the batch-1 latency entry's stack (ViT-B/16 from seed 0, packed int4,
depth 12; a random bf16 x at 208 and 592 rows, the 224- and 384-px
entries), it launches K5 (``_launch_block_stack``, not counted as a
forward's launch) at the picker's layout, then with the other attention
tile, with a ring filling the shared memory, and at half and twice the
picker's token chunks in every GEMM phase (the ring re-sized), and
prints each one's CUDA-event median, its device time (torch.profiler,
the mean of 10 launches), and whether its output equals the plain
version's.

    python3 -m quantized_vit_tpu_torch.tools.stack_design [out.json]
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys

import torch

from ..models import ViTConfig
from ..ops import block_stack as B
from ..serve import prepare_latency_artifact, random_vit_int4_artifact
from .chain_timing import events_us
from .chunked_design import device_us

# rows (the padded tokens) and real tokens of the 224- and 384-px entries
SITES = {"vitb_224": (208, 197), "vitb_384": (592, 577)}


def scaled(lay: B.StackLayout, factor: float) -> B.StackLayout:
    """``lay`` with every GEMM phase at ``factor`` times its token chunks
    (within each phase's widest N), the ring re-sized."""
    nc, nw, g = [], [], []
    for p in range(4):
        nws = B.STACK_NW_SHARED if p % 2 else B.STACK_NW
        want = max(1, round(lay.g[p] * factor), B._cdiv(lay.m, nws[-1]))
        c = B._round_up(B._cdiv(lay.m, want), 8)
        nc.append(c)
        nw.append(next(v for v in nws if v >= c))
        g.append(B._cdiv(lay.m, c))
    out = dataclasses.replace(lay, nc=tuple(nc), nw=tuple(nw), g=tuple(g))
    return dataclasses.replace(out, stages=B.stack_stages(out.stage_bytes))


def full_ring(lay: B.StackLayout) -> int:
    """The ring stages that fill the shared memory (the picker holds the
    ring near ``STACK_RING``, leaving the rest to the L1 cache)."""
    room = (B.STACK_SMEM - B.STACK_SMEM_SLACK - 1024 - B.STACK_XCHG
            - 16 * B.STACK_MAX_STAGES)
    return min(B.STACK_MAX_STAGES, room // lay.stage_bytes)


def main():
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    cfg = ViTConfig()
    art = random_vit_int4_artifact(cfg, seed=0, pack_weights=True,
                                   device="cuda")
    stack = prepare_latency_artifact(art, cfg)[0]["stack"]
    g = torch.Generator(device="cuda").manual_seed(1)
    out = {"card": smi, "sites": {}}
    for site, (m, nv) in SITES.items():
        x = torch.randn((m, cfg.embed_dim), generator=g,
                        device="cuda").to(torch.bfloat16)
        base = B.stack_layout_for(stack, x, 1)
        nk = B._n_keys(m, nv, 2)
        want = B.vit_block_stack_plain(stack, x, n_valid=nv)
        tried = {"picked": base,
                 f"attention {48 - base.att_rows} rows": dataclasses.replace(
                     base, att_rows=48 - base.att_rows),
                 "full ring": dataclasses.replace(base, stages=full_ring(
                     base)),
                 "chunks x0.5": scaled(base, 0.5),
                 "chunks x2": scaled(base, 2.0)}
        rows = out["sites"][site] = {}
        for name, lay in tried.items():
            def fn(lay=lay):
                return B._launch_block_stack(stack, x, lay, n_valid=nv,
                                             nk=nk)

            rows[name] = {"nc": lay.nc, "nw": lay.nw, "g": lay.g,
                          "att_rows": lay.att_rows, "stages": lay.stages,
                          "exact": bool(torch.equal(fn(), want)),
                          "events_us": events_us(fn, iters=20),
                          "device_us": device_us(fn)}
            print(f"{site} {name:20s} {rows[name]}", flush=True)
    text = json.dumps(out)
    print(text)
    if len(sys.argv) > 1:
        with open(sys.argv[1], "w") as f:
            f.write(text)


if __name__ == "__main__":
    main()

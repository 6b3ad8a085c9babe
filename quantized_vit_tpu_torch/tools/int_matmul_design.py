"""K10-K12 (``csrc/int_matmul.cu``) at the work split the picker chooses
and at its neighbours, on the card, at the twelve sites of
``tools/chain_timing.py:INT_MM_SITES`` (ViT-B/16's qkv, proj, fc1 and fc2
at M = 1664, each with the three front ends: ``int4_matmul`` and
``int8_matmul`` with f32 out, ``quant_matmul_fa`` on the packed weight
with bf16 x and out), and at ViT-B/16's fc2 at batch 1 (``fc2_b1``: 208
rows, a deep weight at few tiles):

    python3 -m quantized_vit_tpu_torch.tools.int_matmul_design [site ...]

For each site and front end (random levels in [-7, 7] and a bf16 x at 0.1
from seed 0) it launches the kernel at the layout
``ops/int4_matmul.py:int_matmul_layout`` picks and at the others listed
in :func:`variants` (``_launch_int_matmul``), checks that every layout
gives the picked one's bits (int32 sums are exact, so neither the tile nor
the split can move one), and times each: the median of CUDA-event
readings of 200 calls after 5 warm-ups, and the device time of a call
(torch.profiler's CUDA trace, the mean of 20). With site names as
arguments (``qkv``, ``proj``, ``fc1``, ``fc2``, ``fc2_b1``): only those.
Prints the card's name and power limit, a line a site and front end, and
one JSON object.
"""

from __future__ import annotations

import json
import subprocess
import sys

import torch

from ..ops.fused import _card_sms
from ..ops.int4_matmul import (INT_MM_NW, _launch_int_matmul,
                               int_matmul_layout, int_matmul_variant,
                               plan_int_matmul)
from ..quant import pack_int4
from .chain_timing import INT_MM_SITES, device_us, events_us

SPLITS = (2, 3, 4, 6)
# a deep weight at few tiles, where the picker splits the depth: ViT-B/16's
# fc2 at batch 1 (208 rows, 12 tiles of 128 x 128)
DEEP_SITES = {"fc2_b1": (208, 3072, 768)}


def variants(pick):
    """The picked layout; each token tile with every tile whole, and split
    each way of SPLITS (up to the steps): every tile, and the tiles left
    after whole waves of the grid."""
    out = [pick]
    sms = _card_sms(0)
    for nw in INT_MM_NW:
        cands = [(None, 1)]
        for s in SPLITS:
            if s <= pick.steps:
                cands += [(0, s), ("waves", s)]
        for full, s in cands:
            tiles = -(-pick.n // 128) * -(-pick.m // nw)
            if full == "waves":
                if tiles <= sms or tiles % sms == 0:
                    continue
                full = tiles - tiles % sms
            v = int_matmul_variant(pick, nw, s, full)
            if v not in out:
                out.append(v)
    return out


def main():
    only = set(sys.argv[1:])
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(0)
    one = torch.ones((), device=dev)
    bf16 = torch.bfloat16
    fa = dict(act_d=0.05 * one, act_t=one, act_top=7, act_pow=False)
    out = {"card": smi, "sites": {}}
    for site, (m, k, n) in {**INT_MM_SITES, **DEEP_SITES}.items():
        if only and site not in only:
            continue
        xl = torch.randint(-7, 8, (m, k), dtype=torch.int8, device=dev,
                           generator=g)
        xf = (torch.randn((m, k), generator=g, device=dev) * 0.1).to(bf16)
        w8 = torch.randint(-7, 8, (k, n), dtype=torch.int8, device=dev,
                           generator=g)
        w4 = pack_int4(w8, axis=0)
        bias = torch.randn((n,), generator=g, device=dev) * 0.01
        fronts = {
            "int4_matmul": (plan_int_matmul(w4, 1e-3 * one, bias,
                                            fmt="int4"), xl, torch.float32),
            "int8_matmul": (plan_int_matmul(w8, 1e-3 * one, bias,
                                            fmt="int8"), xl, torch.float32),
            "quant_matmul_fa": (plan_int_matmul(w4, 1e-3 * one, bias,
                                                fmt="int4", **fa), xf,
                                bf16)}
        for front, (plan, x, odt) in fronts.items():
            pick = int_matmul_layout(m, k, n, plan.int4, x.element_size(),
                                     x.data_ptr() % 16 == 0,
                                     torch.empty((), dtype=odt)
                                     .element_size(), _card_sms(0))

            def call(lay, plan=plan, x=x, odt=odt):
                return _launch_int_matmul(plan, x, lay, out_dtype=odt)

            want = call(pick)
            rows = []
            for lay in variants(pick):
                rows.append({"nw": lay.nw, "full": lay.full,
                             "splits": lay.splits, "stages": lay.stages,
                             "prologue": lay.prologue,
                             "items": len(lay.items()),
                             "equal": bool(torch.equal(call(lay), want)),
                             "us": events_us(lambda lay=lay: call(lay)),
                             "device_us": device_us(lambda lay=lay:
                                                    call(lay))})
            res = {"rows": m, "k": k, "n": n, "picked": rows[0],
                   "layouts": rows}
            out["sites"][f"{site}:{front}"] = res
            print(f"{site}:{front}", json.dumps(res), flush=True)
    print(json.dumps(out))


if __name__ == "__main__":
    main()

"""K1 (``csrc/fused_quant_matmul.cu``) at every work split worth trying, on
the card, at the K1 sites of the forwards:

    python3 -m quantized_vit_tpu_torch.tools.matmul_design [site ...]

For each site (``tools/chain_timing.py:K1_SITES``: ViT-B/16's patch
embed, proj and head, its chain qkv and proj at batch 1-3, ViT-H/14's
patch embed, chain qkv and proj, fc1 and fc2; random x and int8 weights
from seed 0) it launches K1 at the layout ``ops/fused.py:matmul_layout``
picks and at the others listed below (``_launch_matmul``, no launch
counted as a forward's), checks that every layout gives the picked one's
bits (int32 sums are exact, so the split cannot move one), and times
each: the median of CUDA-event readings of 200 calls after 5 warm-ups,
and the device time of a call (torch.profiler's CUDA trace, the mean of
20; at small M the host's time to launch a call exceeds the kernel's, and
the events then read the host). With site names as arguments: only
those. Prints the card's name and power limit and one JSON object.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys

import torch

from ..ops.attention import _card_shape
from ..ops.fused import _launch_matmul, matmul_layout, plan_matmul
from .chain_timing import K1_SITES, device_us, events_us

SPLITS = (1, 2, 3, 6)


def variants(pick):
    """The picked layout; every tile whole, and every tile split each way
    of SPLITS (up to the steps of depth), at both tiles."""
    out = [pick]
    for tile in (128, 64):
        tiles = -(-pick.m // tile) * -(-pick.n // tile)
        for s in SPLITS:
            if s > pick.steps:
                continue
            v = dataclasses.replace(pick, tile=tile, splits=s,
                                    full=tiles if s == 1 else 0)
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
    out = {"card": smi, "sites": {}}
    for site, (m, k, n, pro, epi, xdt) in K1_SITES.items():
        if only and site not in only:
            continue
        w = torch.randint(-7, 8, (k, n), dtype=torch.int8, device=dev,
                          generator=g)
        layer = {} if pro is None else dict(act_d=0.05 * one, act_t=one,
                                            act_top=127)
        if pro == "ln_quant":
            layer.update(ln_scale=torch.ones(k, device=dev),
                         ln_bias=torch.zeros(k, device=dev))
        if epi == "gelu_quant":
            layer.update(out_d=0.05 * one, out_t=one, out_top=127)
        plan = plan_matmul(w, 1e-3 * one, None, fmt="int8", prologue=pro,
                           epilogue=epi, **layer)
        x = (torch.randint(-7, 8, (m, k), dtype=torch.int8, device=dev,
                           generator=g) if xdt == torch.int8 else
             torch.randn((m, k), generator=g, device=dev).to(xdt))
        res = (torch.randn((m, n), generator=g, device=dev).to(
            torch.bfloat16) if epi == "residual" else None)
        odt = torch.float32 if xdt == torch.float32 else torch.bfloat16
        pick = matmul_layout(m, k, n, pro, x.element_size(),
                             _card_shape(0)[0])

        def call(lay):
            return _launch_matmul(plan, x, lay, residual=res, out_dtype=odt)

        want = call(pick)
        rows = []
        for lay in variants(pick):
            rows.append({"tile": lay.tile, "full": lay.full,
                         "splits": lay.splits,
                         "equal": bool(torch.equal(call(lay), want)),
                         "us": events_us(lambda lay=lay: call(lay)),
                         "device_us": device_us(lambda lay=lay: call(lay))})
        res_ = {"rows": m, "k": k, "n": n, "prologue": pro,
                "epilogue": epi, "ln_threads": pick.ln_threads,
                "picked": rows[0], "layouts": rows}
        out["sites"][site] = res_
        print(site, json.dumps(res_), flush=True)
    print(json.dumps(out))


if __name__ == "__main__":
    main()

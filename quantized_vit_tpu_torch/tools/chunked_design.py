"""K8's work split on the card: the layouts of ``ops/fused.py:
chunked_layout`` against their neighbours.

At ViT-H/14's MLP at batch 1 and 2 (272 and 544 rows, K 1280, H 5120)
and ViT-B/16's at the chain's batch 3 (624 rows, K 768, H 3072), int8
levels and a random bf16 x, it launches K8 (``_launch_mlp_chunked``, not
counted as a forward's launch) at the picker's layout, then at each
count of token groups of fc1 with fc2 at the picker's, and of fc2 with
fc1 at the picker's (the ring as deep as the shared memory allows), and
prints each one's device time (torch.profiler, the mean of
10 launches) beside K2 on the same plan, the bytes the phase loads from
L2, and whether its output equals the picker's.

    python3 -m quantized_vit_tpu_torch.tools.chunked_design [out.json]
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys

import torch

from ..ops import fused as F

SITES = {"vith_b1": (272, 1280, 5120), "vith_b2": (544, 1280, 5120),
         "vitb_chain_b3": (624, 768, 3072)}


def device_us(fn, n=10) -> float:
    """The mean device time of ``fn``'s kernels over ``n`` calls."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    return sum(e.device_time_total for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA) / n


def neighbours(lay: F.ChunkedLayout, phase: int):
    """``lay`` with phase ``phase`` at each count of token groups whose
    chunk fits 8-256 rows (the groups as many as the chunk, rounded up to
    8 rows, needs), the ring re-sized."""
    m, wr = lay.m, lay.phase(phase)[2]
    chunks = 2 if wr == F.CHUNKED_ROWS else 1
    seen = set()
    for g in range(1, 17):
        nc = F._round_up(F._cdiv(m, chunks * g), 8)
        g = F._cdiv(m, chunks * nc)  # no group without tokens
        if nc > F.CHUNKED_NW[-1] or (nc, g) in seen:
            continue
        seen.add((nc, g))
        nw = next(v for v in F.CHUNKED_NW if v >= nc)
        sfx = str(phase)
        alt = dataclasses.replace(lay, **{"nc" + sfx: nc, "nw" + sfx: nw,
                                          "g" + sfx: g})
        yield dataclasses.replace(alt,
                                  stages=F.chunked_stages(alt.stage_bytes))


def main():
    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(0)
    one = torch.ones((), device=dev)
    d05 = torch.full((), 0.05, device=dev)
    power = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(power.strip())
    record = {"card": power.strip(), "sites": {}}
    for site, (m, k, hid) in SITES.items():
        w1 = torch.randint(-7, 8, (k, hid), dtype=torch.int8, device=dev,
                           generator=g)
        w2 = torch.randint(-7, 8, (hid, k), dtype=torch.int8, device=dev,
                           generator=g)
        kw = dict(hid_d=d05, hid_t=one, hid_top=7, act_d=d05, act_t=one,
                  act_top=7, fmt="int8", ln_scale=torch.ones(k, device=dev),
                  ln_bias=torch.zeros(k, device=dev))
        p8 = F.plan_mlp_chunked(w1, 1e-3 * one, None, w2, 1e-3 * one, None,
                                **kw)
        p2 = F.plan_mlp(w1, 1e-3 * one, None, w2, 1e-3 * one, None, **kw)
        x = torch.randn((m, k), generator=g, device=dev).to(torch.bfloat16)
        pick = F.chunked_layout(m, k, hid)
        want = F._launch_mlp_chunked(p8, x, pick)
        rows = []
        for phase in (1, 2):
            for lay in neighbours(pick, phase):
                got = F._launch_mlp_chunked(p8, x, lay)
                rows.append({
                    "phase": phase,
                    "nc": lay.phase(phase)[3], "nw": lay.phase(phase)[4],
                    "g": lay.phase(phase)[5], "stages": lay.stages,
                    "l2_mb": lay.l2_bytes(phase) / 1e6,
                    "us": device_us(
                        lambda lay=lay: F._launch_mlp_chunked(p8, x, lay)),
                    "equal": bool(torch.equal(got, want)),
                    "picked": lay == pick})
        res = {"picked": dataclasses.asdict(pick),
               "picked_us": device_us(lambda: F.run_mlp_chunked(p8, x)),
               "k2_us": device_us(lambda: F.run_mlp(p2, x)), "rows": rows}
        record["sites"][site] = res
        print(f"{site}: picked {res['picked_us']:.1f} us, K2 on the same "
              f"plan {res['k2_us']:.1f} us")
        for r in sorted(rows, key=lambda r: (r["phase"], r["us"])):
            print(f"  fc{r['phase']} g {r['g']:2d} nc {r['nc']}"
                  f" nw {r['nw']} stages {r['stages']:2d} L2 "
                  f"{r['l2_mb']:6.1f} MB: {r['us']:6.1f} us"
                  f"{'' if r['equal'] else ' DIFFERS'}"
                  f"{' (picked)' if r['picked'] else ''}")
        if not all(r["equal"] for r in rows):
            raise SystemExit(f"{site}: a layout changed the output")
    if len(sys.argv) > 1:
        with open(sys.argv[1], "w") as f:
            json.dump(record, f, indent=1)


if __name__ == "__main__":
    main()

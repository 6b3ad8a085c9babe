"""K2 (``csrc/fused_mlp.cu``) at every work split worth trying, on the
card, at the MLP sites of the forwards:

    python3 -m quantized_vit_tpu_torch.tools.mlp_design

For each site (ViT-B/16 at batch 32, 2 and 1 with int8 levels; ViT-H/14
at batch 1 and 2 with packed int4), random bf16 x and weights from seed
0, it launches K2 at the layout ``ops/fused.py:mlp_layout`` picks and at
the others listed below (``_launch_mlp``, no launch counted as the
forward's), checks that every layout gives the picked one's bits (int32
sums are exact, so the split cannot move one), and times each: the
median of CUDA-event readings of 200 calls after 5 warm-ups. Beside
them the device time of a call (torch.profiler's CUDA trace, the mean of
20): at batch 1-2 the host's time to issue a call can exceed the
kernel's, and the events then read the host. Also K8
(``run_mlp_chunked``) on int8 weights at the same widths, and the card's
name and power limit. Prints one JSON object.
"""

from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess

import torch

from ..ops.attention import _card_shape
from ..ops.fused import (_launch_mlp, mlp_layout, plan_mlp, plan_mlp_chunked,
                         run_mlp_chunked)
from ..quant import pack_int4

# (rows, K, H, weight format)
SITES = {"vitb_b32": (6656, 768, 3072, "int8"),
         "vitb_b2": (416, 768, 3072, "int8"),
         "vitb_b1": (208, 768, 3072, "int8"),
         "vith_b1_int4": (272, 1280, 5120, "int4"),
         "vith_b2_int4": (544, 1280, 5120, "int4")}
SPLITS = (1, 2, 3, 4, 5, 6, 8)


def events_us(fn, iters=200, warmup=5):
    for _ in range(warmup):
        fn()
    pairs = []
    for _ in range(iters):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        pairs.append((s, e))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs) * 1e3


def device_us(fn, reps=20):
    """The device time of one call's kernels (torch.profiler's CUDA
    trace); None if the trace holds none."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    tot = sum(e.device_time_total for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA)
    return tot / reps if tot > 0 else None


def variants(pick):
    """The picked layout; fc2's tiles all whole, and all split each way
    of SPLITS, at both fc2 tiles; the other fc1 tile (the kernel builds
    a 128 x 128 fc1 beside a 128 x 128 fc2 only)."""
    out = [pick]
    for t2 in (128, 64):
        n2 = -(-pick.m // t2) * -(-pick.k // t2)
        for s in SPLITS:
            v = dataclasses.replace(pick, tile2=t2, splits=s,
                                    full2=n2 if s == 1 else 0)
            if v not in out:
                out.append(v)
    if pick.tile2 == 64:
        out.append(dataclasses.replace(pick, tile1=192 - pick.tile1))
    return [v for v in out if v.tile2 == 64 or v.tile1 == 128]


def main():
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(0)
    one = torch.ones((), device=dev)
    d05 = torch.full((), 0.05, device=dev)
    out = {"card": smi, "sites": {}}
    for site, (m, k, hid, fmt) in SITES.items():
        x = (torch.randn((m, k), generator=g, device=dev) * 0.5).to(
            torch.bfloat16)
        lv1 = torch.randint(-7, 8, (k, hid), dtype=torch.int8, device=dev,
                            generator=g)
        lv2 = torch.randint(-7, 8, (hid, k), dtype=torch.int8, device=dev,
                            generator=g)
        w1, w2 = ((pack_int4(lv1, axis=0), pack_int4(lv2, axis=0))
                  if fmt == "int4" else (lv1, lv2))
        kw = dict(ln_scale=torch.ones(k, device=dev),
                  ln_bias=torch.zeros(k, device=dev), act_d=d05, act_t=one,
                  act_top=127, hid_d=d05, hid_t=one, hid_top=127)
        plan = plan_mlp(w1, 1e-3 * one, None, w2, 1e-3 * one, None, fmt=fmt,
                        **kw)
        pick = mlp_layout(m, k, hid, 2, _card_shape(0)[0])
        want = _launch_mlp(plan, x, pick)
        rows = []
        for lay in variants(pick):
            got = _launch_mlp(plan, x, lay)
            rows.append({"ln_threads": lay.ln_threads, "tile1": lay.tile1,
                         "tile2": lay.tile2, "full2": lay.full2,
                         "splits": lay.splits,
                         "equal": bool(torch.equal(got, want)),
                         "us": events_us(lambda lay=lay: _launch_mlp(
                             plan, x, lay)),
                         "device_us": device_us(lambda lay=lay: _launch_mlp(
                             plan, x, lay))})
        res = {"rows": m, "k": k, "hid": hid, "fmt": fmt,
               "picked": rows[0], "layouts": rows}
        # K8 on int8 levels of the same widths
        p8 = plan_mlp_chunked(lv1, 1e-3 * one, None, lv2, 1e-3 * one, None,
                              fmt="int8", **kw)
        res["k8_int8_us"] = events_us(lambda: run_mlp_chunked(p8, x))
        res["k8_int8_device_us"] = device_us(lambda: run_mlp_chunked(p8, x))
        out["sites"][site] = res
        print(site, json.dumps(res), flush=True)
    print(json.dumps(out))


if __name__ == "__main__":
    main()

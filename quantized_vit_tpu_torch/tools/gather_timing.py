"""K14 (``gather_rows``), K15 (``fused_mlp_gather``) and the FSDP
forwards, timed on the card through the package's public entry points, so
that one script times any version of the package (run it from the root of
a checkout; copy it into a parent checkout to compare two trees in one
call, in turns):

    python3 -m quantized_vit_tpu_torch.tools.gather_timing [k14] [k15]
        [forwards] [sweep]

(no argument: all four). Prints one JSON object with the card
(``nvidia-smi``'s name and power limit) and:

- ``k14``: K14 on block 0's four int8 weights as the FSDP forward gathers
  them (ViT-B/16: 7.08 MB, ViT-H/14: 19.7 MB), at tp = 1 in this process
  and at tp = 2 as two spawned processes sharing the card (each gathering
  its half into its own and its peer's outputs). ``cold``: a 256 MB
  buffer written before each launch (the shards are not in the 50 MB
  L2); ``warm``: launches back to back. At tp = 1 the device time from
  torch.profiler's CUDA trace (the median a launch over 30), the launch
  alone between two CUDA events queued behind a sleep kernel
  (``queued_*``: no host time between them, the device's ~4 us of
  launch latency included) and plain CUDA events (``events_us``, warm,
  the host's time a call included); at tp = 2 the queued events, each
  process's launch timed while the other waits. Beside them at tp = 1
  the yardsticks on the same shards (device time, cold and warm):
  ``torch.cat`` of each shard and ``Tensor.copy_`` of each into its
  output (cudaMemcpyAsync, device to device); each gather checked byte
  for byte against the full weights.
- ``k15``: K15 at ViT-B/16's and ViT-H/14's FSDP sites (the MLP of
  batch 32's rows, gathering the next block's four int8 weights), K2 on
  the same plan and K14 alone on the same gather: the median of 200
  CUDA-event readings after 5 warm-ups (None where the version refuses
  the width).
- ``sweep``: K15 at ViT-B/16's width gathering 4, 8, 16 and 31 MB of int8
  rows (the overlap sweep).
- ``forwards``: ``vit_int4_forward_fsdp_rdma`` at tp = 1 and
  ``vit_int4_forward`` of ViT-B/16 and ViT-H/14 at batch 32 (int8-stored
  levels from seed 0, bf16 residual stream), medians of 20 in ms.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys

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
         "vith_b32": (8704, 1280, 5120, None)}
SWEEP = {f"vitb_b32_{mb}MB": (6656, 768, 3072, mb << 20)
         for mb in (4, 8, 16, 31)}
MODELS = {"vitb": {}, "vith": dict(patch_size=14, embed_dim=1280, depth=32,
                                   num_heads=16, num_classes=1000)}
# K14's widths: (D, MLP hidden) of block 0's four weights
WIDTHS = {"vitb": (768, 3072), "vith": (1280, 5120)}
BATCH = 32
FLUSH_BYTES = 256 << 20
REPS = 30
K14_TPS = (2,)


def _card():
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()


def block_weights(d, hid, seed):
    """Block 0's four int8 weights as the FSDP forward gathers them: qkv
    [D, 3D], proj [D, D], fc1 [D, hid], fc2 [hid, D] (opaque bytes)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    return [torch.randint(-128, 128, s, dtype=torch.int8, device="cuda",
                          generator=g)
            for s in ((d, 3 * d), (d, d), (d, hid), (hid, d))]


def _rows(t, rank, tp):
    r = t.shape[0] // tp
    return t[rank * r:(rank + 1) * r].contiguous()


def device_us(fn, flush=None, reps=REPS):
    """The device time of one call of ``fn`` in torch.profiler's CUDA
    trace over ``reps`` calls, each after ``flush()`` when given (its
    fill kernels left out): the median launch where a call is one
    kernel, else the mean of the calls' summed kernels and copies."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):  # a trace now and then comes back empty: retry
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                if flush is not None:
                    flush()
                torch.cuda.synchronize()
                fn()
                torch.cuda.synchronize()
        evs = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and "fill" not in e.name.lower()]
        if evs:
            break
    else:
        return None
    if len(evs) == reps:  # one kernel a call: the median launch
        return statistics.median(e.device_time_total for e in evs)
    return sum(e.device_time_total for e in evs) / reps


# cycles of the queued sleep before a timed launch (~200 us at 1.98 GHz)
SLEEP_CYCLES = 400_000


def queued_us(fn, flush=None, reps=REPS):
    """The median time of one call of ``fn`` between two CUDA events that
    the stream reaches back to back: a sleep kernel is queued first, so
    the start event, the call's kernels and the end event wait behind it
    and no host time falls between them (each call after ``flush()``
    when given). For processes that share the card, which cannot all
    trace it."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        if flush is not None:
            flush()
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SLEEP_CYCLES)
        s.record()
        fn()
        e.record()
        torch.cuda.synchronize()
        times.append(s.elapsed_time(e) * 1e3)
    return statistics.median(times)


def raw_launch(plan):
    """K14 on a prepared gather with no fence and not counted (its C entry
    point, as ``ops.ring_gather.run_gather_rows`` calls it)."""
    from ..ops import _build
    from ..ops import ring_gather as rg

    fn = _build.library("ring_gather").qvt_gather_rows
    fn.argtypes = [_build.P, _build.P, _build.P, _build.I, _build.I,
                   _build.P]
    fn.restype = _build.I
    _build.check(fn(plan.src, plan.dst, plan.nbytes, plan.n_jobs,
                    rg._copy_blocks(plan.moved), _build.stream()),
                 "gather_rows")


def _flusher():
    buf = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    state = {"i": 0}

    def flush():
        state["i"] += 1
        buf.fill_(state["i"] & 255)

    return flush


def _checked(outs, full):
    """Each gathered output against its full weight, byte for byte."""
    return all(torch.equal(o.view(-1).view(torch.uint8),
                           f.reshape(-1).view(torch.uint8))
               for o, f in zip(outs, full))


def k14_tp1(name, flush):
    d, hid = WIDTHS[name]
    full = block_weights(d, hid, 1)
    plan = plan_gather_rows(full)
    outs = [torch.empty_like(s) for s in full]
    launch = lambda: run_gather_rows(plan)  # noqa: E731
    raw = lambda: raw_launch(plan)  # noqa: E731
    res = {"bytes": sum(s.numel() for s in full),
           "bound_us": 2 * sum(s.numel() for s in full) / 3.35e12 * 1e6,
           "cold_us": device_us(launch, flush),
           "warm_us": device_us(launch),
           "queued_cold_us": queued_us(raw, flush),
           "queued_warm_us": queued_us(raw),
           "events_us": events_us(launch),
           "ok": _checked(launch(), full)}
    cat = lambda: [torch.cat([s]) for s in full]  # noqa: E731
    cp = lambda: [o.copy_(s) for o, s in zip(outs, full)]  # noqa: E731
    res["cat_cold_us"], res["cat_warm_us"] = device_us(cat, flush), \
        device_us(cat)
    res["copy_cold_us"], res["copy_warm_us"] = device_us(cp, flush), \
        device_us(cp)
    return res


def _serial(peers, tp, rank, fn):
    """``fn()`` in each process in turn, the others waiting at a
    barrier; this process's result."""
    res = None
    for r in range(tp):
        peers.barrier()
        if r == rank:
            res = fn()
        torch.cuda.synchronize()
        peers.barrier()
    return res


def k14_worker(rank, tp, init_method, names):
    """One of ``tp`` processes sharing the card: its shards of each width,
    gathered into its own and its peers' outputs (checked against the
    full weights), then each process's launch timed in turn while the
    others wait at a barrier, cold and warm (:func:`queued_us`, the
    launch without its fences)."""
    from ..parallel import initialize_distributed

    peers = initialize_distributed(init_method, tp, rank, device="cuda")
    out = {}
    try:
        flush = _flusher()
        for name in names:
            d, hid = WIDTHS[name]
            full = block_weights(d, hid, 1)
            plan = plan_gather_rows([_rows(f, rank, tp) for f in full],
                                    peers=peers)
            res = {"read_bytes": sum(f.numel() for f in full) // tp,
                   "written_bytes": sum(f.numel() for f in full),
                   "ok": _checked(run_gather_rows(plan), full)}
            res["cold_us"], res["warm_us"] = _serial(
                peers, tp, rank, lambda: (
                    queued_us(lambda: raw_launch(plan), flush),
                    queued_us(lambda: raw_launch(plan))))
            out[name] = res
            del plan
    finally:
        peers.close()
    return out


def k14(out):
    flush = _flusher()
    res = {f"{name}_tp1": k14_tp1(name, flush) for name in WIDTHS}
    from ..parallel import run_processes

    for tp in K14_TPS:
        try:
            ranks = run_processes(
                k14_worker, tp,
                os.path.abspath(os.path.join("build", "dist")),
                args=(tuple(WIDTHS),), timeout_s=120)
        except RuntimeError as e:  # recorded; the other groups still run
            res[f"tp{tp}_error"] = str(e)[-2000:]
            continue
        for name in WIDTHS:
            res[f"{name}_tp{tp}"] = [r[name] for r in ranks]
    out["k14"] = res


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


def forwards(out):
    kw = dict(float_dtype=torch.bfloat16, images_layout="patches")
    out["forward_ms"] = {}
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


def main(argv=None):
    modes = set(argv if argv is not None else sys.argv[1:]) or {
        "k14", "k15", "sweep", "forwards"}
    out = {"card": _card()}
    g = torch.Generator(device="cuda").manual_seed(0)
    if "k14" in modes:
        k14(out)
    if "k15" in modes:
        out["k15_us"] = {site: k15_site(*v, g) for site, v in SITES.items()}
    if "sweep" in modes:
        out["sweep_us"] = {site: k15_site(*v, g) for site, v in SWEEP.items()}
    if "forwards" in modes:
        forwards(out)
    print(json.dumps(out))


if __name__ == "__main__":
    main()

"""The shared runner of the six ablation tools (``exp_pro``, ``exp_pro2``,
``exp_attn``, ``exp_attn2``, ``exp_epilogue``, ``exp_fc1``: kernels
K16-K21, ``ops/ablations.py``).

A tool builds its inputs from the root tool's seed at the root tool's
shapes and hands over one :class:`Mode` a mode. For each mode the runner
runs the tool's wrapper once and holds it against the plain version on
the same inputs (the largest level difference and the share of positions
that differ), then times it on the card: the kernel's launch (operands
prepared: the library call alone) by CUDA events (the median of 20 after
3 warm-ups, 200 when a call takes under 1 ms) and by torch.profiler's
device time, the plain version by events, and the library yardstick once
a tool. ``chip_smoke.py`` times phase 3d and every other phase with these
helpers (:func:`events_us`, :func:`device_us`, :func:`int_mm_yard`). The bound is
the larger of the bytes over 3.35 TB/s and the operations over the
operand type's peak (H100 SXM data sheet: 1,979 TOPS int8, 989 TFLOP/s
bf16); attention also prints the FP64 tensor cores' ceiling (67 TFLOP/s),
that of an exact kernel. On the CPU (``--device cpu``) the wrappers take
the plain versions and nothing is timed.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import subprocess
import time
from typing import Callable, List, Optional

import torch

from ..device import resolve_device

HBM = 3.35e12
PEAK = {"int8": 1979e12, "bf16": 989e12}
FP64_TC = 67e12


@dataclasses.dataclass
class Mode:
    """One mode of a tool: its wrapper call (the tool path: the kernel's
    plan and launch, counted), the launch alone on prepared operands (for
    timing; the plain version on the CPU), the plain version, and the work
    the bound counts (bytes each input read once and each output written
    once; operations at the operand type's peak)."""

    mode: str
    call: Callable[[], torch.Tensor]
    launch: Callable[[], torch.Tensor]
    plain: Callable[[], torch.Tensor]
    bytes: int
    ops: int
    kind: str  # "int8" or "bf16"
    # within 1 level at <= 0.5% of positions (library transcendentals and
    # the approximate reciprocal round apart from PyTorch's at ties), else
    # bit-exact
    levels: bool = False


@dataclasses.dataclass
class Tool:
    modes: List[Mode]
    yard: Optional[Callable[[], object]]  # one PyTorch call, a yardstick
    yard_name: str


def bound_us(m: Mode):
    """(bound in us, "bytes" or "operations")."""
    t_b, t_o = m.bytes / HBM, m.ops / PEAK[m.kind]
    return max(t_b, t_o) * 1e6, "bytes" if t_b >= t_o else "operations"


def events_us(fn, iters=20, warmup=3, short_iters=200):
    """Median us of ``iters`` CUDA-event readings of one call, after
    ``warmup`` calls; at least ``short_iters`` readings when a call takes
    under 1 ms. Without a card (a rehearsal on the CPU) one call on the
    host's clock, never a device number."""
    for _ in range(warmup):
        fn()
    if not torch.cuda.is_available():
        t0 = time.perf_counter()
        fn()
        return (time.perf_counter() - t0) * 1e6
    torch.cuda.synchronize()
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    s.record()
    fn()
    e.record()
    torch.cuda.synchronize()
    if s.elapsed_time(e) < 1.0:
        iters = max(iters, short_iters)
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


def device_us(fn, reps=20, tries=5):
    """The device time of the kernels of one call (torch.profiler's CUDA
    trace, the mean of ``reps``); None without a card or if no trace of
    ``tries`` is whole. A trace now and then comes back empty or with
    some kernels dropped: one whose count of device events is not a whole
    multiple of ``reps`` is taken again."""
    if not torch.cuda.is_available():
        return None
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        times = [e.device_time_total for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
        if times and len(times) % reps == 0 and sum(times) > 0:
            return sum(times) / reps
    return None


def batch_us(fn, n=20, batches=5):
    """us a call of ``n`` calls queued back to back between two CUDA
    events, the median of ``batches``: the card's time a call with the
    gaps between launches, the host's submit time hidden where a call
    outlasts it; no profiler, so no trace to drop kernels. None without a
    card."""
    if not torch.cuda.is_available():
        return None
    fn()
    torch.cuda.synchronize()
    per = []
    for _ in range(batches):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        for _ in range(n):
            fn()
        e.record()
        e.synchronize()
        per.append(s.elapsed_time(e) * 1e3 / n)
    return statistics.median(per)


def level_diff(got, want):
    """(largest level difference, share of positions that differ)."""
    d = (got.to(torch.int32) - want.to(torch.int32)).abs()
    return int(d.max()) if d.numel() else 0, float((d > 0).float().mean())


def check(m: Mode) -> dict:
    """The wrapper's result against the plain version's under the mode's
    contract."""
    got, want = m.call(), m.plain()
    mx, share = level_diff(got, want)
    ok = (got.shape == want.shape and got.dtype == want.dtype and
          (mx <= 1 and share <= 0.005 if m.levels else mx == 0))
    return {"max_abs_err": mx, "share_differ": share,
            "bit_exact": mx == 0, "contract": "levels" if m.levels
            else "exact", "ok": ok}


def measure(m: Mode) -> dict:
    """Times on the card: the launch (events, and the profiler's device
    time), the plain version (events); the bound from the shapes."""
    b, by = bound_us(m)
    return {"us": events_us(m.launch), "device_us": device_us(m.launch),
            "plain_us": events_us(m.plain), "bound_us": b, "bound_by": by,
            "fp64_ceiling_us": (m.ops / FP64_TC * 1e6 if m.kind == "bf16"
                                else None)}


def measure_yard(tool: Tool) -> Optional[dict]:
    """The tool's yardstick on the card (events and device time), None
    where it has none."""
    if tool.yard is None:
        return None
    return {"us": events_us(tool.yard), "device_us": device_us(tool.yard)}


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()


def main(name: str, modes: List[str], build, argv=None, shape=None) -> int:
    """The command line of a tool: ``[mode ...] [--device cpu]``. ``build(
    dev, modes, shape)`` makes its :class:`Tool`; ``shape`` (tests) cuts
    the root tool's shapes."""
    ap = argparse.ArgumentParser(prog=f"quantized_vit_tpu_torch.tools.{name}")
    ap.add_argument("modes", nargs="*",
                    help=f"modes to run (default: all): {', '.join(modes)}")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu: the plain versions, untimed")
    args = ap.parse_args(argv)
    bad = [m for m in args.modes if m not in modes]
    if bad:
        ap.error(f"unknown modes {bad}; modes: {', '.join(modes)}")
    dev = resolve_device(args.device)
    cuda = dev.type == "cuda"
    smi = card() if cuda else None
    print(smi or "cpu: the plain versions; nothing timed", flush=True)
    tool = build(dev, args.modes or modes, shape)
    rows = {}
    for m in tool.modes:
        r = check(m)
        line = (f"{name} {m.mode}: parity max {r['max_abs_err']} share "
                f"{r['share_differ']:.2e} ({r['contract']}, "
                f"{'ok' if r['ok'] else 'FAILED'})")
        b, by = bound_us(m)
        if cuda:
            r.update(measure(m))
            dv = r["device_us"]
            line += (f"; {r['us']:.1f} us (device "
                     f"{'n/a' if dv is None else f'{dv:.1f}'} us), bound "
                     f"{b:.2f} us ({by}), plain {r['plain_us']:.1f} us")
            if r["fp64_ceiling_us"] is not None:
                line += f", FP64 ceiling {r['fp64_ceiling_us']:.1f} us"
        else:
            line += f"; bound on an H100 {b:.2f} us ({by})"
        print(line, flush=True)
        rows[m.mode] = r
    out = {"tool": name, "card": smi, "modes": rows}
    y = measure_yard(tool) if cuda else None
    if y is not None:
        out["yardstick"] = {tool.yard_name: y}
        dv = y["device_us"]
        print(f"{name} yardstick {tool.yard_name}: {y['us']:.1f} us "
              f"(device {'n/a' if dv is None else f'{dv:.1f}'} us)",
              flush=True)
    print(json.dumps(out), flush=True)
    return 0 if all(r["ok"] for r in rows.values()) else 1


def int_mm_yard(shapes, dev):
    """``torch._int_mm`` at each (M, K, N) of ``shapes`` on random int8
    operands, as one call sequence: the GEMMs alone, a yardstick (the
    port never calls it). A shape this PyTorch refuses raises when
    called."""
    mats = []
    for m, k, n in shapes:
        a = torch.randint(-7, 8, (m, k), dtype=torch.int8, device=dev)
        b = torch.randint(-7, 8, (n, k), dtype=torch.int8, device=dev).t()
        mats.append((a, b))
    return lambda: [torch._int_mm(a, b) for a, b in mats]


def sdpa_yard(b: int, heads: int, n: int, hd: int, dev):
    """bf16 ``scaled_dot_product_attention`` on [B, H, N, hd]: a yardstick
    an exact kernel cannot match (the port never calls it)."""
    q, k, v = (torch.randn((b, heads, n, hd), device=dev,
                           dtype=torch.bfloat16) for _ in range(3))
    return lambda: torch.nn.functional.scaled_dot_product_attention(q, k, v)

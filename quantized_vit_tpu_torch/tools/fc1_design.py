"""The measurements behind K17's design (``csrc/fc1_ablation.cu:
fc1_ln_kernel``, the float-prologue fc1 that K16's quant and LayerNorm
modes also run), on the card:

- the registers, shared memory and spills ``nvcc -Xptxas -v`` reports for
  each instantiation of ``fc1_ln_kernel`` (from the build's
  ``ptxas.log``), and the erf-GELU epilogue's issue floor counted from the
  source (:func:`epilogue_floor_us`);
- the work split ``ops/ablations.py:fc1_ln_layout`` picks at the tool's
  shape, and K17 ``lean`` at its neighbours, the 112-token panel at other
  feature ranges and the 64-token window instantiation (device time and
  back-to-back launches; each checked against the picked one's bits);
- with ``--stages``: K17 ``lean`` at the tool's shape built with each of
  the kernel's stages switched off in turn (``QVT_F1_OFF``: 1 the
  prologue, each level the low byte of x's element; 2 the products, the
  ring still streamed and waited on; 3 the epilogue's arithmetic, each
  level the low byte of its sum; 4-6 those together, down to the ring
  and x's loads alone; 7 the ping-pong's turns; 8 every weight box from
  one place in L2; 9 both 6 and 8), all built at once into
  ``build/kernels/fc1_design/``, device time in turns with the kernels'
  own build (the variants in order, then back, twice over; device time
  and back-to-back launches, each through the same launch).

::

    python3 -m quantized_vit_tpu_torch.tools.fc1_design [--stages]

Device times are torch.profiler's (``tools/_ablation.py:device_us``, the
mean of 20 launches, a trace with kernels dropped taken again, "n/a"
when no trace of five is whole); "batch" times are 20 launches queued
back to back between two CUDA events (``batch_us``, the median of 5), so
no trace can drop a kernel. Prints the card's name and power limit first and
one JSON object last.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import re
import subprocess
import sys

import torch

from ..device import resolve_device
from ..ops import _build
from ..ops import ablations as ab
from . import _ablation, exp_pro, exp_pro2
from ._ablation import card

# The erf-GELU epilogue of fc1_ln_kernel an output, counted from the
# source (ln_epilogue, level_fast, erf_clamped, round_clip_byte): 21 f32
# operations (the scale's multiply, z = y * C2 and its clamp, the erf
# polynomial's ten, w's two multiplies, w + w * e, the clamp and the magic
# add), one int -> f32 conversion, one shared-memory byte store. The
# card's issue: 128 lanes a clock an SM, 132 SMs, at most 1.98 GHz (H100
# SXM data sheet).
EPI_SLOTS_PER_OUTPUT = 21 + 1 + 1
SMS, LANES, CLOCK = 132, 128, 1.98e9


def epilogue_floor_us(m: int, n: int) -> float:
    """The least time the erf-GELU epilogue's instructions take to issue
    on an H100 for an m x n output (all SMs, every clock, no stall)."""
    return m * n * EPI_SLOTS_PER_OUTPUT / (SMS * LANES) / CLOCK * 1e6


# QVT_F1_OFF's builds of fc1_ablation.cu (0: the kernels' own)
STAGES = ((0, "full"), (1, "prologue off"), (2, "products off"),
          (3, "epilogue arithmetic off"),
          (4, "products and epilogue arithmetic off"),
          (5, "products, epilogue arithmetic and prologue off"),
          (6, "the ring and x's loads alone (no stores to out either)"),
          (7, "ping-pong turns off"),
          (8, "every stage from one weight box"),
          (9, "the ring and x's loads alone, every stage from one box"))


def ptxas_rows(build_dir) -> list:
    """(kernel, registers, spill stores, spill loads) of each
    fc1_ln_kernel instantiation in the build's ptxas log."""
    text = (build_dir / "ptxas.log").read_text()
    rows, name, spill = [], None, (None, None)
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
            continue
        if name and "fc1_ln_kernel" in name:
            sp = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                           r"loads", line)
            if sp:
                spill = (int(sp.group(1)), int(sp.group(2)))
            rg = re.search(r"Used (\d+) registers", line)
            if rg:
                pars = re.search(r"fc1_ln_kernelILi(\d+)ELi(\d+)ELi(\d+)E",
                                 name)
                label = (f"pro {pars.group(1)} ep {pars.group(2)} nw "
                         f"{pars.group(3)}" if pars else name)
                rows.append({"kernel": label, "registers": int(rg.group(1)),
                             "spill_stores": spill[0],
                             "spill_loads": spill[1]})
                name = None
    return rows


def _lean(dev):
    """K17 lean at the tool's shape and inputs (``tools/exp_pro2.py``)."""
    return exp_pro2.build(dev, ["lean"]).modes[0]


def layouts(dev) -> list:
    """K17 lean at the picked layout and its neighbours (the whole panel
    at feature ranges of 768, 1536 and 3072; the window instantiation,
    its one window the whole depth), each launched on the tool's inputs
    through a plan at that layout; bits against the picked one's."""
    m, k, n = exp_pro2.M, exp_pro2.K, exp_pro2.N
    _, x, w, g, b = exp_pro.inputs(dev, m, k, n, False)
    plan = ab.plan_fc1(w, ab.EXP_PRO2_MODES["lean"], m, ln_g=g, ln_b=b)
    pick = plan.layout
    want = ab.run_fc1(plan, x, "exp_pro2").clone()
    cands = [pick]
    for f in (768, 1536, 3072):
        lay = dataclasses.replace(pick, f=f)
        if lay not in cands:
            cands.append(lay)
    win, stages = ab._ln_fit(ab.FC1_LN_WINDOW_NW, pick.steps)
    cands.append(dataclasses.replace(pick, nw=ab.FC1_LN_WINDOW_NW, f=128,
                                     win=win, stages=stages))
    rows = []
    for lay in cands:
        p = ab.fc1_plan_at(plan, lay)
        call = lambda p=p: ab.run_fc1(p, x, "exp_pro2")
        rows.append({"nw": lay.nw, "f": lay.f,
                     "items": lay.items, "waves": lay.waves,
                     "picked": lay == pick,
                     "model_us": ab._ln_makespan(lay),
                     "device_us": _ablation.device_us(call),
                     "batch_us": _ablation.batch_us(call),
                     "same_bits": bool(torch.equal(call(), want))})
    return rows


def stage_times(dev, rounds=2) -> list:
    """K17 lean at the tool's shape with each stage switched off (all
    variants built at once, one ``nvcc`` each), device time and
    back-to-back launches in turns. Returns (label, [device us a turn],
    [batch us a turn], levels as the plain version's)."""
    out_dir = _build.BUILD_ROOT / "fc1_design"
    out_dir.mkdir(parents=True, exist_ok=True)
    own = _build.build_all() / "fc1_ablation.so"
    procs, libs = [], {0: own}
    for off, _ in STAGES[1:]:
        so = out_dir / f"fc1_ablation_off{off}_{_build.source_hash()}.so"
        libs[off] = so
        if not so.exists():
            procs.append(subprocess.Popen(
                [_build._nvcc(), *_build.NVCC_FLAGS,
                 *_build.SOURCE_FLAGS.get("fc1_ablation.cu", ()),
                 f"-DQVT_F1_OFF={off}", "-I", str(_build.CSRC), "-o",
                 str(so), str(_build.CSRC / "fc1_ablation.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    for p in procs:
        text = p.communicate()[0]
        if p.returncode:
            raise RuntimeError(
                f"nvcc failed on a stage build:\n{text[-4000:]}")
    mode = _lean(dev)
    want = mode.plain()
    times = {off: [] for off, _ in STAGES}
    ev = {off: [] for off, _ in STAGES}
    exact = {}
    order = [off for off, _ in STAGES]
    try:
        for _ in range(rounds):
            for off in order + order[::-1]:
                _build.use_library("fc1_ablation", libs[off])
                m = _lean(dev)  # a plan's host state is its library's
                exact[off] = bool(torch.equal(m.launch(), want))
                times[off].append(_ablation.device_us(m.launch))
                ev[off].append(_ablation.batch_us(m.launch))
    finally:
        _build.use_library("fc1_ablation", own)
    return [(label, times[off], ev[off], exact[off])
            for off, label in STAGES]


def _us(u) -> str:
    return "n/a" if u is None else f"{u:.1f}"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="quantized_vit_tpu_torch.tools.fc1_design")
    ap.add_argument("--stages", action="store_true",
                    help="also time K17 lean with each stage switched off")
    args = ap.parse_args(argv)
    dev = resolve_device("cuda")
    smi = card()
    print(smi, flush=True)
    out = {"card": smi, "ptxas": ptxas_rows(_build.build_all()),
           "epilogue_floor_us": epilogue_floor_us(exp_pro2.M, exp_pro2.N)}
    print(f"erf-GELU epilogue's issue floor at {exp_pro2.M} x {exp_pro2.N}: "
          f"{out['epilogue_floor_us']:.1f} us", flush=True)
    for r in out["ptxas"]:
        print(f"ptxas {r['kernel']}: {r['registers']} registers, spills "
              f"{r['spill_stores']} / {r['spill_loads']} bytes", flush=True)
    out["layouts"] = layouts(dev)
    for r in out["layouts"]:
        print(f"K17 lean nw {r['nw']} f {r['f']} "
              f"({r['items']} items, {r['waves']} waves"
              f"{', picked' if r['picked'] else ''}): "
              f"device {_us(r['device_us'])} us, batch "
              f"{r['batch_us']:.1f} us, model "
              f"{r['model_us']:.1f} us, bits "
              f"{'equal' if r['same_bits'] else 'DIFFER'}", flush=True)
    ok = all(r["same_bits"] for r in out["layouts"])
    if args.stages:
        out["stages"] = []
        for label, us, evs, same in stage_times(dev):
            out["stages"].append({"stage": label, "device_us": us,
                                  "batch_us": evs, "exact": same})
            ts = " / ".join(_us(u) for u in us)
            es = " / ".join(_us(u) for u in evs)
            print(f"K17 lean, {label}: device {ts} us, batch {es} us in "
                  f"turns; levels "
                  f"{'equal to' if same else 'unlike'} the plain version's",
                  flush=True)
    print(json.dumps(out), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())

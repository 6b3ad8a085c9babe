"""The measurements behind K18's and K19's designs
(``csrc/attn_ablation.cu``), on the card:

- the FP64 tensor cores' rate (``mma.sync`` m16n8k4 .f64) with 2, 4 and 8
  independent accumulators a warp, and with 8 and one other instruction
  interleaved a MMA: an f32 -> f64 conversion (also one per two MMAs), an
  f64 -> f32 conversion, a 64-bit shared-memory load (the MMA's B), a
  16-byte shared-memory load per two MMAs (its halves their Bs; both loads
  at the same index, wrapped at a power of two), an ``expf``, and a bf16
  -> f64 operand built by integer operations, both as a stand-in that
  leaves out the exponent's bias and the zero and subnormal cases (bf16
  times 2^-896: a bound on the route's rate) and exact (also one per two
  MMAs each); the m16n8k8 and m16n8k16 .f64 forms alone (K19's). 132 blocks
  of 256 threads, the loop from registers; cycles a MMA a sub-partition
  at the data sheet's 1.98 GHz (an m16n8k4's work: the deeper forms count
  2 and 4);
- with ``--stages``: K19 (``tools/exp_attn2.py``, J = 1) built with each
  of its stages switched off or swapped in turn (``attn_ablation.cu``'s
  ``QVT_A2_OFF``: exp2f, the operand conversions, the scores' MMAs,
  P.V's MMAs, operands built by integer operations), device time in
  turns with the kernels' own build;
- with ``--builds``: the build of ``attn_ablation.cu`` alone, with and
  without ``--split-compile=0`` (``ops/_build.py:SOURCE_FLAGS``).

::

    python3 -m quantized_vit_tpu_torch.tools.exp_attn_design \
        [--stages] [--builds]

Times are CUDA events (the mean of 10 launches after 3). The sources build
with ``nvcc`` into ``build/kernels/`` (listed in ``.gitignore``).
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
import time

import numpy as np
import torch

from ..device import resolve_device
from ..ops import _build
from ._ablation import card

_SOURCE = r"""
#include <cuda_runtime.h>
__device__ __forceinline__ void dmma(double (&d)[4], const double (&a)[2],
                                     double b) {
  asm("mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 {%0, %1, %2, %3}, "
      "{%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
      : "d"(a[0]), "d"(a[1]), "d"(b));
}
// the deeper f64 forms K19 runs (attn_ablation.cu:dmma8, dmma16)
__device__ __forceinline__ void dmma8(double (&d)[4], const double (&a)[4],
                                      const double (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b[0]), "d"(b[1]));
}
__device__ __forceinline__ void dmma16(double (&d)[4], const double (&a)[8],
                                       const double (&b)[4]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f64.f64.f64.f64 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7, %8, %9, %10, %11}, {%12, %13, %14, %15}, "
      "{%0, %1, %2, %3};\n"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(a[4]), "d"(a[5]),
        "d"(a[6]), "d"(a[7]), "d"(b[0]), "d"(b[1]), "d"(b[2]), "d"(b[3]));
}
// a bf16 -> f64 operand built by integer operations (a route measured for
// K19's design and not taken). The stand-in: the half e of w times 2^-896
// (no exponent bias, zero and subnormals not told apart), cheaper than
// the route, so a bound on its rate
__device__ __forceinline__ double bits_f64(unsigned w, int e) {
  const int x = static_cast<int>(e ? w : w << 16);
  return __hiloint2double((x >> 3) & static_cast<int>(0x8FFFE000u), 0);
}
// the route itself, every finite bf16 exactly: sign, exponent + 896,
// mantissa; zero as zero, subnormals by a conversion
// (attn_ablation.cu:bf_f64 at QVT_A2_OFF 5)
__device__ __forceinline__ double bits_f64_exact(unsigned w, int e) {
  const unsigned x = e ? w & 0xFFFF0000u : w << 16, ex = x & 0x7F800000u;
  if (ex == 0 && (x & 0x007F0000u))
    return static_cast<double>(__uint_as_float(x));
  const int hi = (static_cast<int>(x) >> 3) & static_cast<int>(0x8FFFE000u);
  return __hiloint2double(hi + (ex ? 896 << 20 : 0), 0);
}
// KIND 0: MMAs alone; 1: + an f32 -> f64 conversion a MMA; 2: + an f64 ->
// f32 conversion a MMA; 3: + a 64-bit shared load a MMA (its B); 4: + an
// expf a MMA; 5: + a 16-byte shared load per two MMAs (.x the first's B,
// .y the second's); 6: + an f32 -> f64 conversion per two MMAs; 7: + a
// bf16 -> f64 built by integer operations a MMA (the halves of a word in
// turn); 8: + one per two MMAs; 9, 10: the m16n8k8 and m16n8k16 forms
// alone; 11, 12: as 7, 8 by the exact route. KIND 3 and 5 load at the
// same index ix
template <int CH, int KIND>
__global__ void __launch_bounds__(256, 1) probe(double* out, int iters,
                                                float f) {
  __shared__ __align__(16) double sm[2048];
  for (int i = threadIdx.x; i < 2048; i += 256) sm[i] = i * 1e-3;
  __syncthreads();
  double acc[CH][4];
  for (int c = 0; c < CH; ++c)
    for (int e = 0; e < 4; ++e) acc[c][e] = 0.0;
  const double a[2] = {threadIdx.x * 1e-3, 1.0};
  float fx = f * threadIdx.x, fs = 0.f;
  const int lane = threadIdx.x & 31;
  // K18's fragment addresses: rows 68 (64-bit) or 72 (16-byte) apart
  const double* p64 = sm + (lane >> 2) * 68 + (lane & 3);
  const double* p128 = sm + (lane >> 2) * 72 + 2 * (lane & 3);
  for (int it = 0; it < iters; ++it) {
    double2 v2 = make_double2(0.0, 0.0);
#pragma unroll
    for (int c = 0; c < CH; ++c) {
      double b = a[0];
      const int ix = (it * CH + c) % 16 * 4;  // a multiple of 8 at even c
      if (KIND == 1) b = static_cast<double>(fx + c);
      if (KIND == 2) fs += static_cast<float>(acc[c][0]);
      if (KIND == 3) b = p64[ix];
      if (KIND == 4) fs += expf(fx + c);
      if (KIND == 5) {
        if ((c & 1) == 0)
          v2 = *reinterpret_cast<const double2*>(p128 + ix);
        b = (c & 1) ? v2.y : v2.x;
      }
      if (KIND == 6 && (c & 1) == 0) b = static_cast<double>(fx + c);
      if (KIND == 7) b = bits_f64(__float_as_uint(fx) + c, c & 1);
      if (KIND == 8 && (c & 1) == 0) b = bits_f64(__float_as_uint(fx) + c, 0);
      if (KIND == 11) b = bits_f64_exact(__float_as_uint(fx) + c, c & 1);
      if (KIND == 12 && (c & 1) == 0)
        b = bits_f64_exact(__float_as_uint(fx) + c, 0);
      if (KIND == 9) {
        const double a4[4] = {a[0], a[1], a[0], a[1]}, b2[2] = {b, b};
        dmma8(acc[c], a4, b2);
      } else if (KIND == 10) {
        const double a8[8] = {a[0], a[1], a[0], a[1], a[0], a[1], a[0], a[1]};
        const double b4[4] = {b, b, b, b};
        dmma16(acc[c], a8, b4);
      } else {
        dmma(acc[c], a, b);
      }
    }
    fx += 1e-7f;
  }
  double s = fs;
  for (int c = 0; c < CH; ++c)
    for (int e = 0; e < 4; ++e) s += acc[c][e];
  out[blockIdx.x * 256 + threadIdx.x] = s;
}
#define RUN(CH, KIND)                                                   \
  extern "C" int run_##CH##_##KIND(double* o, int it, void* st) {       \
    probe<CH, KIND><<<132, 256, 0, (cudaStream_t)st>>>(o, it, 1e-3f);   \
    return (int)cudaGetLastError();                                     \
  }
RUN(8, 0) RUN(4, 0) RUN(2, 0) RUN(8, 1) RUN(8, 6) RUN(8, 2) RUN(8, 3)
RUN(8, 5) RUN(8, 4) RUN(8, 7) RUN(8, 8) RUN(8, 9) RUN(8, 10) RUN(8, 11)
RUN(8, 12)
"""

CASES = ((8, 0, "MMAs alone, 8 chains a warp"),
         (4, 0, "MMAs alone, 4 chains"), (2, 0, "MMAs alone, 2 chains"),
         (8, 1, "+ f32 -> f64 a MMA"), (8, 6, "+ f32 -> f64 per two MMAs"),
         (8, 2, "+ f64 -> f32 a MMA"), (8, 3, "+ 64-bit shared load a MMA"),
         (8, 5, "+ 16-byte shared load per two MMAs"),
         (8, 4, "+ expf a MMA"),
         (8, 7, "+ bf16 -> f64 from bits a MMA (stand-in, no bias)"),
         (8, 8, "+ bf16 -> f64 from bits per two MMAs (stand-in, no bias)"),
         (8, 11, "+ bf16 -> f64 from bits a MMA (exact)"),
         (8, 12, "+ bf16 -> f64 from bits per two MMAs (exact)"),
         (8, 9, "m16n8k8 MMAs alone, 8 chains"),
         (8, 10, "m16n8k16 MMAs alone, 8 chains"))
# the k-depth of each case's MMA (its FLOP: 16 x 8 x depth x 2)
DEPTH = {9: 8, 10: 16}
ITERS = 4096
BLOCKS, WARPS = 132, 8


def mma_rates(dev) -> list:
    out_dir = _build.BUILD_ROOT / "exp_attn_design"
    out_dir.mkdir(parents=True, exist_ok=True)
    cu = out_dir / "mma_probe.cu"
    cu.write_text(_SOURCE)
    so = out_dir / "mma_probe.so"
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so),
                    str(cu)], check=True, capture_output=True)
    lib = ctypes.CDLL(str(so))
    o = torch.empty(BLOCKS * 256, dtype=torch.float64, device=dev)
    st = torch.cuda.current_stream(dev).cuda_stream
    rows = []
    for ch, kind, what in CASES:
        fn = getattr(lib, f"run_{ch}_{kind}")
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        for _ in range(3):
            _build.check(fn(o.data_ptr(), ITERS, st), "mma probe")
        torch.cuda.synchronize(dev)
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        for _ in range(10):
            fn(o.data_ptr(), ITERS, st)
        e.record()
        torch.cuda.synchronize(dev)
        us = s.elapsed_time(e) / 10 * 1e3
        # a warp's MMAs in m16n8k4 units; two warps a sub-partition
        mmas = ITERS * ch * DEPTH.get(kind, 4) // 4
        rows.append({"case": what, "us": us,
                     "tflops": BLOCKS * WARPS * mmas * 1024 / us / 1e6,
                     "cycles_per_mma": us * 1e-6 * 1.98e9 / (2 * mmas)})
    return rows


# QVT_A2_OFF's builds of attn_ablation.cu (0: the kernels' own)
STAGES = ((0, "full"), (1, "exp2f off"), (2, "operand conversions off"),
          (3, "scores' MMAs off"), (4, "P.V's MMAs off"),
          (5, "operands built by integer operations"))


def stage_times(dev, rounds=2) -> list:
    """K19 at the tool's shape, J = 1, built with each stage switched off
    (all variants built at once, one ``nvcc`` each), device time in turns:
    the variants in order, then back, ``rounds`` times over. Returns
    (label, [us a turn], levels as the full build's)."""
    from ..ops import ablations as ab
    from . import _ablation, exp_attn2

    out_dir = _build.BUILD_ROOT / "exp_attn_design"
    out_dir.mkdir(parents=True, exist_ok=True)
    own = _build.build_all() / "attn_ablation.so"
    procs, libs = [], {0: own}
    for off, _ in STAGES[1:]:
        so = out_dir / f"attn_ablation_off{off}_{_build.source_hash()}.so"
        libs[off] = so
        if not so.exists():
            procs.append(subprocess.Popen(
                [_build._nvcc(), *_build.NVCC_FLAGS,
                 *_build.SOURCE_FLAGS["attn_ablation.cu"],
                 f"-DQVT_A2_OFF={off}", "-I", str(_build.CSRC), "-o",
                 str(so), str(_build.CSRC / "attn_ablation.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    for p in procs:
        text = p.communicate()[0]
        if p.returncode:
            raise RuntimeError(
                f"nvcc failed on a stage build:\n{text[-4000:]}")
    b, n, h, hd, nv = (exp_attn2.B, exp_attn2.N, exp_attn2.H, exp_attn2.HD,
                       exp_attn2.NV)
    qkv = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (b, n, 3 * h * hd)) * 0.1).to(torch.bfloat16).to(dev)
    plan = ab.plan_exp_attn2(dev, 0.05, h)
    call = lambda: ab.run_exp_attn2(plan, qkv, j_imgs=1, n_valid=nv)
    want = ab.exp_attn2_plain(qkv, 0.05, heads=h, n_valid=nv)
    times = {off: [] for off, _ in STAGES}
    exact = {}
    order = [off for off, _ in STAGES]
    try:
        for _ in range(rounds):
            for off in order + order[::-1]:
                _build.use_library("attn_ablation", libs[off])
                exact[off] = bool(torch.equal(call(), want))
                times[off].append(_ablation.device_us(call))
    finally:
        _build.use_library("attn_ablation", own)
    return [(label, times[off], exact[off]) for off, label in STAGES]


def build_seconds() -> dict:
    """attn_ablation.cu built alone, with and without its split flag."""
    out_dir = _build.BUILD_ROOT / "exp_attn_design"
    out_dir.mkdir(parents=True, exist_ok=True)
    res = {}
    for tag, extra in (("split", ["--split-compile=0"]), ("one", [])):
        t0 = time.perf_counter()
        subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, *extra, "-I",
                        str(_build.CSRC), "-o",
                        str(out_dir / f"attn_ablation_{tag}.so"),
                        str(_build.CSRC / "attn_ablation.cu")], check=True,
                       capture_output=True)
        res[tag] = time.perf_counter() - t0
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="quantized_vit_tpu_torch.tools.exp_attn_design")
    ap.add_argument("--stages", action="store_true",
                    help="also time K19 with each stage switched off")
    ap.add_argument("--builds", action="store_true",
                    help="also time attn_ablation.cu's build with and "
                         "without --split-compile=0")
    args = ap.parse_args(argv)
    dev = resolve_device("cuda")
    print(card(), flush=True)
    for r in mma_rates(dev):
        print(f"{r['case']}: {r['us']:.1f} us, {r['tflops']:.1f} TFLOP/s, "
              f"{r['cycles_per_mma']:.1f} cycles an m16n8k4's work a "
              f"sub-partition",
              flush=True)
    if args.stages:
        for label, us, same in stage_times(dev):
            ts = " / ".join("n/a" if u is None else f"{u:.1f}" for u in us)
            print(f"K19 J = 1, {label}: device {ts} us in turns; levels "
                  f"{'equal to' if same else 'unlike'} the plain version's",
                  flush=True)
    if args.builds:
        b = build_seconds()
        print(f"attn_ablation.cu alone: {b['one']:.1f} s, with "
              f"--split-compile=0 {b['split']:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

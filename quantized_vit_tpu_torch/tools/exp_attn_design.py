"""The measurements behind K18's design (``csrc/attn_ablation.cu``), on
the card:

- the FP64 tensor cores' rate (``mma.sync`` m16n8k4 .f64) with 2, 4 and 8
  independent accumulators a warp, and with 8 and one other instruction
  interleaved a MMA: an f32 -> f64 conversion (also one per two MMAs), an
  f64 -> f32 conversion, a 64-bit shared-memory load (the MMA's B), a
  16-byte shared-memory load per two MMAs (its halves their Bs; both loads
  at the same index, wrapped at a power of two), an ``expf``. 132 blocks
  of 256 threads, the loop from registers; cycles a MMA a sub-partition
  at the data sheet's 1.98 GHz;
- with ``--builds``: the build of ``attn_ablation.cu`` alone, with and
  without ``--split-compile=0`` (``ops/_build.py:SOURCE_FLAGS``).

::

    python3 -m quantized_vit_tpu_torch.tools.exp_attn_design [--builds]

Times are CUDA events (the mean of 10 launches after 3). The sources build
with ``nvcc`` into ``build/kernels/`` (listed in ``.gitignore``).
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
import time

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
// KIND 0: MMAs alone; 1: + an f32 -> f64 conversion a MMA; 2: + an f64 ->
// f32 conversion a MMA; 3: + a 64-bit shared load a MMA (its B); 4: + an
// expf a MMA; 5: + a 16-byte shared load per two MMAs (.x the first's B,
// .y the second's); 6: + an f32 -> f64 conversion per two MMAs. KIND 3 and
// 5 load at the same index ix
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
      dmma(acc[c], a, b);
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
RUN(8, 5) RUN(8, 4)
"""

CASES = ((8, 0, "MMAs alone, 8 chains a warp"),
         (4, 0, "MMAs alone, 4 chains"), (2, 0, "MMAs alone, 2 chains"),
         (8, 1, "+ f32 -> f64 a MMA"), (8, 6, "+ f32 -> f64 per two MMAs"),
         (8, 2, "+ f64 -> f32 a MMA"), (8, 3, "+ 64-bit shared load a MMA"),
         (8, 5, "+ 16-byte shared load per two MMAs"),
         (8, 4, "+ expf a MMA"))
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
        mmas = ITERS * ch  # a warp's; two warps a sub-partition
        rows.append({"case": what, "us": us,
                     "tflops": BLOCKS * WARPS * mmas * 1024 / us / 1e6,
                     "cycles_per_mma": us * 1e-6 * 1.98e9 / (2 * mmas)})
    return rows


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
    ap.add_argument("--builds", action="store_true",
                    help="also time attn_ablation.cu's build with and "
                         "without --split-compile=0")
    args = ap.parse_args(argv)
    dev = resolve_device("cuda")
    print(card(), flush=True)
    for r in mma_rates(dev):
        print(f"{r['case']}: {r['us']:.1f} us, {r['tflops']:.1f} TFLOP/s, "
              f"{r['cycles_per_mma']:.1f} cycles a MMA a sub-partition",
              flush=True)
    if args.builds:
        b = build_seconds()
        print(f"attn_ablation.cu alone: {b['one']:.1f} s, with "
              f"--split-compile=0 {b['split']:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""The measurements behind K13's two design choices, on the card.

K13 (``csrc/flash_attention.cu``) runs its products on one FP64
tensor-core MMA form and takes a query tile a block from
``ops/attention.py:flash_tile_rows``. This tool prints:

- each MMA form of sm_90 (m8n8k4, m16n8k4, m16n8k8, m16n8k16): its
  fragment layout checked against a float64 matmul, then its throughput,
  ``CHAINS`` independent accumulators per warp in a loop from registers
  (no memory traffic), on 132 and 264 blocks of 256 threads;
- K13 at its path shapes (random bf16 q/k/v at ViT-B/16 batch 32,
  ViT-H/14 batch 8 and 1) at every query tile that fits, launched through
  the library's entry point (not the wrapper: no launch counted), the
  picker's tile marked: the mean of ``REPS`` back-to-back launches.

Times are CUDA events::

    python3 -m quantized_vit_tpu_torch.tools.flash_design

The MMA source below is built with ``nvcc`` into ``build/kernels/``
(listed in ``.gitignore``).
"""

from __future__ import annotations

import ctypes
import subprocess

import numpy as np
import torch

from ..ops import _build
from ..ops.attention import (FLASH_TILES, _card_shape, _flash_library,
                             _SMEM_MAX, flash_smem_bytes, flash_tile_rows)

# (PTX shape, M, K): the A fragment holds M*K/32 values a thread, B K/4
FORMS = (("m8n8k4", 8, 4), ("m16n8k4", 16, 4), ("m16n8k8", 16, 8),
         ("m16n8k16", 16, 16))
CHAINS = 8
ITERS = 2048
# K13's path shapes: (tag, B, H, N, hd, real tokens)
K13_SHAPES = (("vitb_b32", 32, 12, 208, 64, 197),
              ("vith_b8", 8, 16, 272, 80, 257),
              ("vith_b1", 1, 16, 272, 80, 257))
REPS = 50

_SOURCE = r"""
#include <cuda_runtime.h>
template <int M, int K> struct Form {
  enum { NA = M * K / 32, NB = K / 4, NC = M / 4 };
};
template <int M, int K>
__device__ __forceinline__ void mma(double* c, const double* a,
                                   const double* b);
template <> __device__ __forceinline__ void mma<8, 4>(double* c,
    const double* a, const double* b) {
  asm("mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0,%1}, {%2}, "
      "{%3}, {%0,%1};\n" : "+d"(c[0]), "+d"(c[1]) : "d"(a[0]), "d"(b[0]));
}
template <> __device__ __forceinline__ void mma<16, 4>(double* c,
    const double* a, const double* b) {
  asm("mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 {%0,%1,%2,%3}, "
      "{%4,%5}, {%6}, {%0,%1,%2,%3};\n"
      : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3])
      : "d"(a[0]), "d"(a[1]), "d"(b[0]));
}
template <> __device__ __forceinline__ void mma<16, 8>(double* c,
    const double* a, const double* b) {
  asm("mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3])
      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b[0]), "d"(b[1]));
}
template <> __device__ __forceinline__ void mma<16, 16>(double* c,
    const double* a, const double* b) {
  asm("mma.sync.aligned.m16n8k16.row.col.f64.f64.f64.f64 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7,%8,%9,%10,%11}, {%12,%13,%14,%15}, {%0,%1,%2,%3};\n"
      : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3])
      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(a[4]), "d"(a[5]),
        "d"(a[6]), "d"(a[7]), "d"(b[0]), "d"(b[1]), "d"(b[2]), "d"(b[3]));
}
// the layouts under test (g = lane/4, t = lane%4): a_i = A[g + 8(i%2)]
// [t + 4(i/2)] (m8: A[g][t]), b_i = B[t + 4i][g], c_i = C[g + 8(i/2)]
// [2t + i%2]
template <int M, int K>
__global__ void layout(const double* A, const double* B, double* C) {
  using F = Form<M, K>;
  const int g = threadIdx.x >> 2, t = threadIdx.x & 3;
  double a[F::NA], b[F::NB], c[F::NC];
  for (int i = 0; i < F::NA; ++i)
    a[i] = M == 8 ? A[g * K + t] : A[(g + 8 * (i % 2)) * K + t + 4 * (i / 2)];
  for (int i = 0; i < F::NB; ++i) b[i] = B[(t + 4 * i) * 8 + g];
  for (int i = 0; i < F::NC; ++i) c[i] = 0.0;
  mma<M, K>(c, a, b);
  for (int i = 0; i < F::NC; ++i)
    C[(g + 8 * (i / 2)) * 8 + 2 * t + i % 2] = c[i];
}
template <int M, int K>
__global__ void rate(double* out, int iters) {
  using F = Form<M, K>;
  double a[F::NA], b[F::NB], c[CHAINS][F::NC];
  for (int i = 0; i < F::NA; ++i) a[i] = 1.0 + threadIdx.x * 1e-3 + i;
  for (int i = 0; i < F::NB; ++i) b[i] = 1e-9 * (i + 1);
  for (int j = 0; j < CHAINS; ++j)
    for (int i = 0; i < F::NC; ++i) c[j][i] = 0.0;
  for (int it = 0; it < iters; ++it)
#pragma unroll
    for (int j = 0; j < CHAINS; ++j) mma<M, K>(c[j], a, b);
  double s = 0.0;
  for (int j = 0; j < CHAINS; ++j)
    for (int i = 0; i < F::NC; ++i) s += c[j][i];
  if (s == 12345.0) out[threadIdx.x] = s;  // keeps the chains live
}
#define FORM(M, K)                                                        \
  extern "C" int layout_##M##_##K(const void* A, const void* B, void* C) { \
    layout<M, K><<<1, 32>>>(static_cast<const double*>(A),                \
                            static_cast<const double*>(B),                \
                            static_cast<double*>(C));                     \
    return static_cast<int>(cudaGetLastError());                          \
  }                                                                       \
  extern "C" int rate_##M##_##K(int blocks, int iters, void* out) {       \
    rate<M, K><<<blocks, 256>>>(static_cast<double*>(out), iters);        \
    return static_cast<int>(cudaGetLastError());                          \
  }
FORM(8, 4)
FORM(16, 4)
FORM(16, 8)
FORM(16, 16)
"""


def build() -> ctypes.CDLL:
    out = _build.BUILD_ROOT / "flash_design"
    out.mkdir(parents=True, exist_ok=True)
    src = out / "flash_design.cu"
    src.write_text(_SOURCE)
    lib = out / "flash_design.so"
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS,
                    f"-DCHAINS={CHAINS}", "-o", str(lib), str(src)],
                   check=True, capture_output=True, text=True)
    return ctypes.CDLL(str(lib))


def mma_forms():
    lib = build()
    P, I = ctypes.c_void_p, ctypes.c_int
    rng = np.random.default_rng(0)
    out = torch.zeros(256, dtype=torch.float64, device="cuda")
    for name, m, k in FORMS:
        lay = getattr(lib, f"layout_{m}_{k}")
        lay.argtypes, lay.restype = [P, P, P], I
        a = torch.tensor(rng.standard_normal((m, k)), device="cuda")
        b = torch.tensor(rng.standard_normal((k, 8)), device="cuda")
        c = torch.full((m, 8), float("nan"), dtype=torch.float64,
                       device="cuda")
        _build.check(lay(a.data_ptr(), b.data_ptr(), c.data_ptr()), name)
        torch.cuda.synchronize()
        err = float((c - a @ b).abs().max())
        run = getattr(lib, f"rate_{m}_{k}")
        run.argtypes, run.restype = [I, I, P], I
        rates = []
        for blocks in (132, 264):
            _build.check(run(blocks, 16, out.data_ptr()), name)
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            _build.check(run(blocks, ITERS, out.data_ptr()), name)
            e1.record()
            torch.cuda.synchronize()
            macs = blocks * 8 * ITERS * CHAINS * m * 8 * k
            rates.append(2 * macs / e0.elapsed_time(e1) / 1e9)
        print(f"{name:9s} layout max err {err:.3g}; "
              + ", ".join(f"{bl} blocks {r:.1f} TFLOP/s"
                          for bl, r in zip((132, 264), rates)))


def k13_tiles():
    fn = _flash_library().qvt_flash_attention
    code = _build.dtype_code(torch.bfloat16)
    g = torch.Generator(device="cuda").manual_seed(0)
    for tag, b, h, n, hd, nv in K13_SHAPES:
        q, k, v = (torch.randn((b, h, n, hd), generator=g, device="cuda").to(
            torch.bfloat16) for _ in range(3))
        out = torch.empty_like(q)
        pick = flash_tile_rows(b, h, n, hd, *_card_shape(0))
        times = []
        for qt in FLASH_TILES:
            if flash_smem_bytes(qt, n, hd) > _SMEM_MAX:
                continue
            args = (q.data_ptr(), code, k.data_ptr(), code, v.data_ptr(),
                    code, out.data_ptr(), code, None, b, h, n, hd, nv, qt,
                    hd**-0.5, 0, 0, _build.stream())
            for _ in range(3):
                _build.check(fn(*args), "flash_attention")
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            for _ in range(REPS):
                fn(*args)
            e1.record()
            torch.cuda.synchronize()
            _build.check(fn(*args), "flash_attention")
            us = e0.elapsed_time(e1) * 1e3 / REPS
            times.append(f"qt {qt}{' (picked)' if qt == pick else ''} "
                         f"{-(-n // qt) * h * b} blocks {us:.1f} us")
        print(f"flash_attention:{tag} [{b}x{h}x{n}x{hd}]: "
              + ", ".join(times))


def main():
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip())
    mma_forms()
    k13_tiles()


if __name__ == "__main__":
    main()

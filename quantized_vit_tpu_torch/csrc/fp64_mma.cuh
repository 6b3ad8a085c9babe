// The FP64 tensor-core pieces shared by K13 (flash_attention.cu) and K9
// (attention_proj.cu): the full-rate MMA form and the warps' layout over a
// grid of its tiles.
//
// On the H100 the mma.sync m8n8k4 .f64 form issues at half the FP64
// tensor rate, the m16n8 forms at the full rate (tools/flash_design.py);
// k4 keeps one B value and two A values a thread, the smallest fragments
// of the full-rate forms. Products of bf16 or f32 values, and of int8
// levels, are exact in f64, so an MMA changes only the order of the f64
// additions.
#pragma once

namespace qvt {

// The warps' layout over an mt x nt grid of 16 x 8 tiles: wr x wc warps
// (wr | mt, wc | nt, wr * wc <= nw), fewest tiles for the busiest warp,
// then fewest fragment loads per k-step.
struct WarpGrid {
  int wr, wc;
};
__host__ __device__ constexpr WarpGrid warp_grid(int mt, int nt, int nw = 8) {
  WarpGrid best = {1, 1};
  int tiles = mt * nt + 1, loads = 1 << 20;
  for (int wr = 1; wr <= nw; ++wr)
    for (int wc = 1; wr * wc <= nw; ++wc) {
      if (mt % wr != 0 || nt % wc != 0) continue;
      const int ti = (mt / wr) * (nt / wc), lo = mt / wr + nt / wc;
      if (ti < tiles || (ti == tiles && lo < loads)) {
        best.wr = wr;
        best.wc = wc;
        tiles = ti;
        loads = lo;
      }
    }
  return best;
}

// d = a.b + d on the FP64 tensor cores, m16n8k4. Fragments (one warp,
// g = lane/4, t = lane%4): a[i] = A[g + 8i][t] of the 16 x 4 A; b =
// B[t][g] of the 4 x 8 B; d[i] = D[g + 8(i/2)][2t + i%2] of the 16 x 8 D.
__device__ __forceinline__ void dmma(double (&d)[4], const double (&a)[2],
                                     double b) {
  asm("mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 {%0, %1, %2, %3}, "
      "{%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
      : "d"(a[0]), "d"(a[1]), "d"(b));
}

}  // namespace qvt

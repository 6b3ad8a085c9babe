// The int8 tensor-core GEMM tile of K3's qkv phase (attention_block.cu)
// and K2's fc1 and fc2 phases (fused_mlp.cu): one block's BM x BN tile of
// A @ B over the k steps [kt0, kt1) of GT_BK bytes each.
//
// A: int8 levels [rows][lda] in device memory (lda a multiple of 16, the
// base 16-byte aligned), typically a scratch the same launch wrote, so it
// is read only through cp.async.cg (L2), never through L1. Columns past
// lda land as zeros. B: a weight of K x N levels in the kernels' n-major
// layout (qvt::WeightT; int8 or packed int4). On the 16-byte path
// (`w_vec`, WeightT::vec_ok on the host) its pieces land raw through
// cp.async, packed int4 included, and each B fragment takes its nibbles in
// registers (pieces never straddle K/2 since (K/2) % 16 == 0); off it the
// levels are unpacked byte by byte. k past K gives zero B, so A's bytes
// there never reach a sum.
//
// A three-stage cp.async ring of GT_BK-deep steps (row stride GT_SK =
// GT_BK + 16: the 8 rows of an ldmatrix fall in distinct banks), fragments
// by ldmatrix, mma.sync m16n8k32 s8 into int32. The NT / 32 warps tile the
// block as (BM / WM) x (BN / WN) warp tiles of WM x WN.
#pragma once

#include "qvt_common.cuh"

namespace qvt {

constexpr int GT_BK = 128, GT_SK = GT_BK + 16, GT_ST = 3;

// dynamic shared memory of a BM x BN tile's ring
__host__ __device__ constexpr int gemm_ring_bytes(int BM, int BN) {
  return GT_ST * (BM + BN) * GT_SK;
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// acc = A[row0 .. row0 + BM, k steps kt0 .. kt1] @ B[.., col0 .. col0 + BN]
// (rows past M and columns past w.N give zeros). Every thread of the block
// calls it with the block's dynamic shared memory (gemm_ring_bytes). It
// ends with the ring drained and a block barrier, so the caller may reuse
// the shared memory. Accumulator element (i, j, 2 * hh + e) is tile row
// wm + 16 i + lane / 4 + 8 hh and column wn + 8 j + 2 (lane % 4) + e, for
// the warp's wm = warp / (BN / WN) * WM and wn = warp % (BN / WN) * WN.
template <int BM, int BN, int WM, int WN, int NT>
__device__ __forceinline__ void gemm_tile(int (&acc)[WM / 16][WN / 8][4],
                                          const int8_t* A, int lda, int M,
                                          const WeightT& w, bool w_vec,
                                          int row0, int col0, int kt0,
                                          int kt1, int8_t* smem) {
  constexpr int TM = WM / 16, TN = WN / 8, BK = GT_BK, SK = GT_SK,
                ST = GT_ST;
  static_assert(NT / 32 == (BM / WM) * (BN / WN), "the GEMM's warps");
  static_assert(TN % 2 == 0, "B fragments load in pairs of n8 tiles");
  const int N = w.N, K = w.K, kh = K >> 1;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int t = lane & 3;
  const int wm = warp / (BN / WN) * WM, wn = warp % (BN / WN) * WN;
  // packed int4 pieces land raw: their nibbles are taken per fragment
  const bool unpack = w.int4 && w_vec;
  int8_t* As = smem;
  int8_t* Bs = smem + ST * BM * SK;
  // k step kt's A and B tiles into stage (kt - kt0) % ST: one commit group
  // (empty past the last step)
  auto load = [&](int kt) {
    if (kt < kt1) {
      const int k0 = kt * BK;
      int8_t* as = As + (kt - kt0) % ST * BM * SK;
      int8_t* bs = Bs + (kt - kt0) % ST * BN * SK;
      for (int p = threadIdx.x; p < BM * BK / 16; p += NT) {
        const int r = p / (BK / 16), c = p % (BK / 16) * 16;
        const bool ok = row0 + r < M && k0 + c < lda;
        cp_async16(as + r * SK + c,
                   ok ? A + static_cast<long long>(row0 + r) * lda + k0 + c
                      : A,
                   ok);
      }
      if (w_vec) {
        for (int p = threadIdx.x; p < BN * BK / 16; p += NT) {
          const int r = p / (BK / 16), c = p % (BK / 16) * 16;
          const int nn = col0 + r, k = k0 + c;
          const bool ok = nn < N && k < K;
          const int8_t* src = w.wt;
          if (ok)
            src += w.int4 ? static_cast<long long>(nn) * kh +
                                (k < kh ? k : k - kh)
                          : static_cast<long long>(nn) * K + k;
          cp_async16(bs + r * SK + c, src, ok);
        }
      } else {  // off the 16-byte path: levels, unpacked, byte by byte
        for (int e = threadIdx.x; e < BN * BK; e += NT) {
          const int r = e / BK, c = e - r * BK;
          bs[r * SK + c] = w.at(k0 + c, col0 + r);
        }
      }
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };
  zero_acc(acc);
  for (int s = 0; s < ST - 1; ++s) load(kt0 + s);
  for (int kt = kt0; kt < kt1; ++kt) {
    // step kt has landed; every warp is past step kt - 1, whose stage
    // takes step kt + ST - 1
    asm volatile("cp.async.wait_group %0;\n" ::"n"(ST - 2));
    __syncthreads();
    load(kt + ST - 1);
    const int8_t* as = As + (kt - kt0) % ST * BM * SK;
    const int8_t* bs = Bs + (kt - kt0) % ST * BN * SK;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 32) {
      uint32_t af[TM][4], bf[TN][2];
#pragma unroll
      for (int i = 0; i < TM; ++i)
        ldsm_x4(af[i], as + (wm + 16 * i + (lane & 7) +
                             ((lane >> 3) & 1) * 8) * SK +
                           kk + (lane >> 4) * 16);
#pragma unroll
      for (int jp = 0; jp < TN / 2; ++jp) {
        uint32_t r4[4];
        ldsm_x4(r4, bs + (wn + 16 * jp + (lane >> 4) * 8 + (lane & 7)) * SK +
                        kk + ((lane >> 3) & 1) * 16);
        bf[2 * jp][0] = r4[0];
        bf[2 * jp][1] = r4[1];
        bf[2 * jp + 1][0] = r4[2];
        bf[2 * jp + 1][1] = r4[3];
      }
      if (unpack) {  // this lane's bytes are k .. k + 3 and k + 16 ..
        const int k = kt * BK + kk + 4 * t;
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          bf[j][0] = nibbles(bf[j][0], k >= kh);
          bf[j][1] = nibbles(bf[j][1], k + 16 >= kh);
        }
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j)
          mma_s8(acc[i][j], af[i][0], af[i][1], af[i][2], af[i][3], bf[j][0],
                 bf[j][1]);
    }
  }
  asm volatile("cp.async.wait_group 0;\n" ::);
  __syncthreads();  // the next tile's loads reuse every stage
}

}  // namespace qvt

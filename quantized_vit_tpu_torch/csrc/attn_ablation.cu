// K18, K19: the attention timing ablations of the root tools, for Hopper
// (sm_90a).
//
// K18 replaces tools/exp_attn.py:kernel and kernel_v2 (pallas_call,
// exp_attn.py:111): the attention of one image's heads on a fused-qkv
// tensor x [B, N, (3, H, hd)] bf16, keys and values from its first nk rows:
//   s = q k^T (f32, no scale), keys >= n_valid masked to -1e30, minus the
//   row max, p = exp(s) in bf16, o = p v (f32), o / sum(p), then the levels
//   clip(round(o * inv_d), +-top) [B, N, H*hd] int8,
// with the stages switched off one at a time as the tool's modes do
// (MODE_* below; ops/ablations.py:exp_attn_plain). `mxu_sum` takes sum(p)
// from the P.V MMA as one more n8 column of ones; `transposed` computes
// S^T = K Q^T and reduces over the MMA's other axis. Both compute `full`'s
// function. `recip` multiplies by rcp.approx.f32 of the sum, the card's
// counterpart of pl.reciprocal(approx=True).
//
// K19 replaces tools/exp_attn2.py:kernel (pallas_call, exp_attn2.py:64):
// K6's attention (attention_qkv.cu; the proj quantizer's levels, exp2
// clamped at 100, no row max, sum(p) + 1e-30) with J images a TPU
// program. Here a block takes its share of the query tiles of J images of
// one head, one image after another (K19's design below).
//
// Bound on this card (3.35 TB/s; 989 TFLOP/s bf16; the FP64 tensor cores'
// 67 TFLOP/s, the ceiling of an exact kernel):
//   K18 at B 8, N 224, nk 208, 12 heads of 64: 1.15 GFLOP; 9.24 MB (q
//       at 224 rows, k and v at 208, the int8 levels: 2.76 us, bytes);
//       FP64 ceiling 17.1 us
//   K19 at B 32, N 224, nk 208, 197 real keys: 4.34 GFLOP; 35.88 MB (q
//       at 224 rows, k and v at the 197 real keys, the levels: 10.71 us,
//       bytes); FP64 ceiling 64.7 us
//
// K19's design: no row max, so a query tile's keys stream through p and
// P.V chunk by chunk with no row ever whole. Blocks of 4 warps (128
// threads), 3 blocks an SM (launch bounds 128, 3: at most 168 registers;
// 74,836 bytes of shared memory a block), so 3 warps a sub-partition; a
// warp owns one 16-row query tile at a time. The grid (S, heads, B / J),
// S = min(J, query tiles), gives every J 384 blocks of 14 tile-tasks at
// the tool's shape (tasks (j, t) with (j nmt + t) % S == share, the u-th
// to warp u % 4: 4, 4, 3, 3 tiles a warp), one wave at 3 blocks on 132
// SMs, at most 12 tiles on a sub-partition. K and V arrive raw (bf16) by
// TMA, a 32-row K box and V box a ring slot in the 128-byte swizzle (3-D
// tensor map [B][nk][3 heads hd]: rows past nk read as zeros), 7 slots
// (224 keys), each stage's bytes on a full mbarrier; the last warp done
// with a slot (a shared counter) starts its next stage, so the ring runs
// ahead with no block barrier, and each image's keys are read from device
// memory once a block (when they fit the ring; else once a round of 4
// tiles). Only keys up to the last key tile with a real key are read. A
// warp stages its q tile (times q_mul, rounded to bf16) as the high words
// of their f64 values (the low words are zero), so q needs no conversion
// at the MMA; it streams 16 keys at a time: the scores of two key tiles as
// two m16n8k8 .f64 chains (K's B fragments by ldmatrix, widened bf16 ->
// f64 at each use), p = exp2f(min(s, 100)) into the f64 row sums and, as
// bf16 pairs, straight into P.V's A fragments, then P.V on m16n8k8 with
// V^T fragments by ldmatrix.trans. The f64 output accumulator (16 x 64)
// stays in registers across all keys. Numerics as the plain version's,
// -fmad=false.
//
// K18's design: the FP64 tensor cores bound it, so both products run on
// mma.sync m16n8k4 .f64 (qvt::dmma; products of bf16 values are exact in
// f64, so only the order of the f64 additions changes, and the sums are
// exact at the tool's data). A block of 8 warps takes a whole (head,
// image), 96 blocks at the tool's shape: a smaller block would stage K and
// V again and not shorten the busiest SM. K and V are copied once
// (cp.async) and widened once to f64 in shared memory (230,400 bytes at
// most 208 keys; up to 256 keys the rows stay bf16, widened at each use,
// and the scores are computed twice, for the row max and then for p): K's
// rows hold a thread's two k-steps side by side, V is stored transposed
// with a thread's two keys side by side, so every B fragment load is one
// 16-byte load for two MMAs, and both pitches are constants (fragment
// addresses are a register and an immediate: at runtime pitches ptxas
// held every unrolled address in a register and spilled). A shared load
// beside each MMA, 64-bit or 16-byte per two, leaves the MMA rate as it
// is (tools/exp_attn_design.py). A warp owns whole 16-row
// tiles of queries, one after another: its q rows are the A fragments (a
// thread holds the columns S t .. S t + S - 1, S = hd / 4, of rows g and
// g + 8), the scores of all keys stay in its registers
// (the m16n8 D fragments, rounded once to f32), so mask, max and sum take
// shuffles within the quad only, and p (rounded to bf16, packed in pairs)
// feeds P.V as the A fragment straight from those registers (key 8 j +
// 2 t + e of D tile j is k-lane t of P.V k-step (j, e)); P.V runs over
// half a head's columns at a time. The first four warps copy K, the last
// four V; the last four widen V while the first four start their scores,
// so the two warps of each SM sub-partition run out of step and one's
// softmax overlaps the other's MMAs. `transposed` holds S^T's D fragments
// (16 keys x 8 queries), reduces over keys by the xor-4/8/16 shuffles and
// moves p and the row sums into P.V's layout by shuffles. Numerics are
// those of the plain version, built with -fmad=false: f64 sums rounded
// once to f32, expf as PyTorch's exp on the card calls it, p rounded to
// bf16, a true division, rintf. The mode is a template argument: a stage
// switched off costs nothing.

#include <cuda.h>  // CUtensorMap and its enums (no driver library linked)

#include <algorithm>

#include "qkv_attention.cuh"

namespace {

constexpr int NT = 256, NW = NT / 32;
constexpr int HDM = 64;        // the widest head
constexpr int MAXK = 256;      // the most keys
constexpr int KT_F64 = 26;     // key tiles of 8 with f64 rows (208 keys)
constexpr int KT_BF16 = MAXK / 8;
// the warps of the group that stages V (the second half of the block), and
// the 16-byte pieces of raw V rows a thread of it moves into V^T (at most)
constexpr int NTV = NT / 2;
constexpr int VW = MAXK * (HDM / 8) / NTV;

// ops/ablations.py:EXP_ATTN_MODES
enum {
  MODE_FULL = 0,
  MODE_NO_MASK = 1,
  MODE_NO_MAX = 2,
  MODE_NO_EXP = 3,
  MODE_MATMULS_ONLY = 4,
  MODE_SUM_ONLY = 5,
  MODE_RECIP = 6,
  MODE_NO_SUM = 7,
  MODE_MXU_SUM = 8,
  MODE_TRANSPOSED = 9
};

struct AttnArgs {
  const __nv_bfloat16* x;
  int8_t* out;
  int B, n, nk, nkp, heads, hd, n_valid;
  float inv_d, top;
};

// K's rows (HDM + 8 elements) and V^T's rows (8 KT + 8 keys) are 8 mod 16
// elements apart, so a quarter warp's 16-byte fragment loads fall in
// distinct banks; both pitches are constants, so every fragment address is
// a base register and an immediate offset
constexpr int ATTN_LDK = HDM + 8;
__host__ __device__ constexpr int attn_ldv(int kt) { return 8 * kt + 8; }
// dynamic shared memory of an instantiation: K [8 KT][ATTN_LDK] and V^T
// [HDM][attn_ldv(KT)], f64 or bf16, and the raw bf16 rows of K and V (hd
// + 8 apart; f64 rows hold them in V^T's space until it is written);
// mirrored by tests/test_torch_attn_ablation_layout.py; both fit a block
// of every sm_90a part
__host__ __device__ constexpr int attn_smem(bool f64) {
  return f64 ? (8 * KT_F64 * ATTN_LDK + HDM * attn_ldv(KT_F64)) * 8
             : (8 * KT_BF16 * ATTN_LDK + HDM * attn_ldv(KT_BF16)) * 2 +
                   4 * MAXK * (HDM + 8);
}
static_assert(attn_smem(true) <= 232448 && attn_smem(false) <= 232448,
              "K18's shared memory exceeds a Hopper block's");

__device__ __forceinline__ float bfr(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float rcp_approx(float v) {
  float r;
  asm("rcp.approx.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}

// the bf16 in the low (h = 0) or high half of a word, as f32
__device__ __forceinline__ float bf_half(uint32_t u, int h) {
  return __uint_as_float(h ? u & 0xFFFF0000u : u << 16);
}

// (row, column) of the elements i0 + k nt of rows w long, one step at a
// time without a division
struct RowWalk {
  int r, c, w, dr, dc;
  __device__ RowWalk(int w_, int i0 = threadIdx.x, int nt = NT) : w(w_) {
    r = i0 / w;
    c = i0 - r * w;
    dr = nt / w;
    dc = nt - dr * w;
  }
  __device__ void next() {
    r += dr;
    c += dc;
    if (c >= w) {
      c -= w;
      ++r;
    }
  }
};

template <typename T>
__device__ __forceinline__ T from_bf(__nv_bfloat16 v);
template <>
__device__ __forceinline__ double from_bf<double>(__nv_bfloat16 v) {
  return static_cast<double>(__bfloat162float(v));
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_bf<__nv_bfloat16>(
    __nv_bfloat16 v) {
  return v;
}
// the pair of elements p[0], p[1] as f64 (one 16- or 4-byte load)
__device__ __forceinline__ void pair_d(const double* p, double& x,
                                       double& y) {
  const double2 v = *reinterpret_cast<const double2*>(p);
  x = v.x;
  y = v.y;
}
__device__ __forceinline__ void pair_d(const __nv_bfloat16* p, double& x,
                                       double& y) {
  const uint32_t u = *reinterpret_cast<const uint32_t*>(p);
  x = static_cast<double>(bf_half(u, 0));
  y = static_cast<double>(bf_half(u, 1));
}

// One block a (head, image). T: the type of K's and V^T's rows in shared
// memory. double (at most KT_F64 key tiles): a warp's scores stay in its
// registers; bf16 (up to KT_BF16): the scores are computed twice, once for
// the row max and once for p, and only p is held.
template <int MODE, typename T>
__global__ void __launch_bounds__(NT, 1) attn_kernel(AttnArgs a) {
  constexpr bool F64 = sizeof(T) == 8;
  constexpr int KT = F64 ? KT_F64 : KT_BF16;
  constexpr bool TR = MODE == MODE_TRANSPOSED;
  constexpr bool MXU = MODE == MODE_MXU_SUM;
  constexpr bool DO_MASK =
      MODE != MODE_NO_MASK && MODE != MODE_MATMULS_ONLY;
  constexpr bool DO_MAX = MODE != MODE_NO_MAX && MODE != MODE_MATMULS_ONLY;
  constexpr bool DO_EXP = MODE != MODE_NO_EXP && MODE != MODE_MATMULS_ONLY;
  constexpr bool DO_SUM = MODE == MODE_FULL || MODE == MODE_NO_MASK ||
                          MODE == MODE_NO_MAX || MODE == MODE_SUM_ONLY ||
                          MODE == MODE_RECIP || MODE == MODE_TRANSPOSED;
  const float NEG_INF = -__int_as_float(0x7f800000);
  extern __shared__ __align__(16) unsigned char smem[];
  const int n = a.n, nk = a.nk, nkp = a.nkp, hd = a.hd, nv = a.n_valid;
  const int S = hd / 4, HDT = hd / 8, nkt = nkp / 8, RL = hd + 8;
  constexpr int LDK = ATTN_LDK, LDV = attn_ldv(KT);
  // K [8 KT][LDK], head column S t + s at 8 (s / 2) + 2 t + s % 2 (a
  // thread's two k-steps side by side); V^T [HDM][LDV]; the raw bf16 rows
  // of K, then V, RL apart (f64: in V^T's space until it is written)
  T* Ks = reinterpret_cast<T*>(smem);
  T* Vt = Ks + 8 * KT * LDK;
  __nv_bfloat16* rk = reinterpret_cast<__nv_bfloat16*>(F64 ? Vt
                                                           : Vt + HDM * LDV);
  __nv_bfloat16* rv = rk + nkp * RL;
  const int h = blockIdx.x, b = blockIdx.y, HD = a.heads * hd;
  const long long W = 3LL * HD;
  const __nv_bfloat16* xb =
      a.x + static_cast<long long>(b) * n * W + h * hd;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;

  // the first four warps copy K's nkp raw rows, the last four V's, by
  // cp.async (rows past nk zero). The last four then stage V^T while the
  // first four start on their scores: the two warps of an SM sub-partition
  // run out of step, so one's softmax overlaps the other's MMAs.
  const bool vgrp = warp >= NW / 2;
  {
    const int kv = vgrp ? 1 : 0;
    for (RowWalk p(hd / 8, threadIdx.x - kv * NTV, NTV); p.r < nkp; p.next())
      qvt::cp_async16((kv ? rv : rk) + p.r * RL + 8 * p.c,
                      xb + (p.r < nk ? p.r : 0) * W + (1 + kv) * HD + 8 * p.c,
                      p.r < nk);
    asm volatile("cp.async.commit_group;\n" ::);
  }

  // a warp's q rows g and g + 8 of tile mt: columns S t .. S t + S - 1 as
  // bf16 pairs (zeros past n)
  const int nmt = (n + 15) / 16, iters = (nmt + NW - 1) / NW;
  uint32_t qr[2][8];
  auto load_q = [&](int mt) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = 16 * mt + g + 8 * i;
      const bool in = mt < nmt && r < n;
      const uint32_t* src = reinterpret_cast<const uint32_t*>(
          xb + static_cast<long long>(in ? r : 0) * W + S * t);
#pragma unroll
      for (int w = 0; w < 8; ++w)
        qr[i][w] = in && 2 * w < S ? __ldg(src + w) : 0u;
    }
  };
  load_q(warp);

  if (!vgrp) asm volatile("cp.async.wait_group 0;\n" ::);
  __syncthreads();
  for (RowWalk p(hd); p.r < nkp; p.next()) {
    const int s = 2 * (p.c >> 3) + (p.c & 1), tt = (p.c >> 1) & 3;
    Ks[p.r * LDK + p.c] = from_bf<T>(rk[p.r * RL + S * tt + s]);
  }
  __syncthreads();

  // q[g + 8 i][S t + s] as f64; K[r][S t + s], K[r][S t + s + 1] (s even)
  auto qat = [&](int i, int s) {
    return static_cast<double>(bf_half(qr[i][s >> 1], s & 1));
  };
  auto kpair = [&](int r, int s, double& x, double& y) {
    pair_d(Ks + r * LDK + 4 * s + 2 * t, x, y);
  };
  // the scores, rounded to f32: visit(j, e, v) for D tile j (keys 8 j ..),
  // element e (row g + 8 (e / 2), key 8 j + 2 t + e % 2); four key tiles
  // (four MMA chains) at a time, two k-steps a fragment load
  auto scores = [&](auto&& visit) {
#pragma unroll
    for (int j0 = 0; j0 < KT; j0 += 4) {
      if (j0 >= nkt) break;
      double d[4][4];
#pragma unroll
      for (int c = 0; c < 4; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) d[c][e] = 0.0;
#pragma unroll
      for (int s = 0; s < 16; s += 2) {
        if (s >= S) break;
        const double q0[2] = {qat(0, s), qat(1, s)};
        const double q1[2] = {qat(0, s + 1), qat(1, s + 1)};
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          if (j0 + c >= KT || j0 + c >= nkt) continue;
          double b0, b1;
          kpair(8 * (j0 + c) + g, s, b0, b1);
          qvt::dmma(d[c], q0, b0);
          qvt::dmma(d[c], q1, b1);
        }
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        if (j0 + c >= KT || j0 + c >= nkt) continue;
#pragma unroll
        for (int e = 0; e < 4; ++e)
          visit(j0 + c, e, static_cast<float>(d[c][e]));
      }
    }
  };
  // transposed: S^T = K Q^T, visit(mk, nq, e, v) for key 16 mk + 8 (e / 2)
  // + g, query 8 nq + 2 t + e % 2; two key tiles of 16 at a time
  auto scores_t = [&](auto&& visit) {
#pragma unroll
    for (int mk0 = 0; mk0 < KT / 2; mk0 += 2) {
      if (2 * mk0 >= nkt) break;
      double d[2][2][4];
#pragma unroll
      for (int c = 0; c < 2; ++c)
#pragma unroll
        for (int nq = 0; nq < 2; ++nq)
#pragma unroll
          for (int e = 0; e < 4; ++e) d[c][nq][e] = 0.0;
#pragma unroll
      for (int s = 0; s < 16; s += 2) {
        if (s >= S) break;
        const double q0[2] = {qat(0, s), qat(1, s)};
        const double q1[2] = {qat(0, s + 1), qat(1, s + 1)};
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int mk = mk0 + c;
          if (mk >= KT / 2 || 2 * mk >= nkt) continue;
          double k0[2], k1[2];
          kpair(16 * mk + g, s, k0[0], k1[0]);
          kpair(16 * mk + 8 + g, s, k0[1], k1[1]);
#pragma unroll
          for (int nq = 0; nq < 2; ++nq) {
            qvt::dmma(d[c][nq], k0, q0[nq]);
            qvt::dmma(d[c][nq], k1, q1[nq]);
          }
        }
      }
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int mk = mk0 + c;
        if (mk >= KT / 2 || 2 * mk >= nkt) continue;
#pragma unroll
        for (int nq = 0; nq < 2; ++nq)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            visit(mk, nq, e, static_cast<float>(d[c][nq][e]));
      }
    }
  };

  if (vgrp) {
    // V has landed: its raw rows (a thread's 16-byte pieces, lanes on
    // consecutive keys) through registers into V^T (f64: the rows overlap
    // their raw copy); every warp reads it after the block's barrier
    // before its first P.V
    asm volatile("cp.async.wait_group 0;\n" ::);
    asm volatile("bar.sync 2, %0;\n" ::"n"(NTV) : "memory");
    uint4 vr[VW];
    {
      RowWalk p(nkp, threadIdx.x - NTV, NTV);  // p.r: 8 columns, p.c: key
#pragma unroll
      for (int w = 0; w < VW; ++w, p.next())
        if (p.r < HDT)
          vr[w] = *reinterpret_cast<const uint4*>(rv + p.c * RL + 8 * p.r);
    }
    if (F64) asm volatile("bar.sync 2, %0;\n" ::"n"(NTV) : "memory");
    {
      RowWalk p(nkp, threadIdx.x - NTV, NTV);
#pragma unroll
      for (int w = 0; w < VW; ++w, p.next())
        if (p.r < HDT) {
          const uint32_t u[4] = {vr[w].x, vr[w].y, vr[w].z, vr[w].w};
#pragma unroll
          for (int k = 0; k < 8; ++k) {
            const unsigned short bits = static_cast<unsigned short>(
                k & 1 ? u[k >> 1] >> 16 : u[k >> 1] & 0xFFFFu);
            Vt[(8 * p.r + k) * LDV + p.c] =
                from_bf<T>(__ushort_as_bfloat16(bits));
          }
        }
    }
  }

  for (int it = 0; it < iters; ++it) {
    const int mt = warp + it * NW;
    const bool have = mt < nmt;
    // p, packed: pp[j][i] = the bf16 pair of keys 8 j + 2 t, + 1 of row
    // g + 8 i, P.V's A fragments
    uint32_t pp[KT][2];
    float rs[2] = {0.f, 0.f};  // the row sums (f32)
    if (have) {
      if constexpr (!TR) {
        // mask, the rows' max (over this lane's keys, then the quad),
        // exp, p in bf16 (its sum is taken from P.V's A fragments)
        float m[2] = {NEG_INF, NEG_INF};
        auto masked = [&](int key, float v) {
          return DO_MASK && key >= nv ? -1e30f : v;
        };
        auto take_p = [&](int j, int e, float v) {
          const int key = 8 * j + 2 * t + (e & 1);
          float p = 0.f;
          if (key < nk) {
            const float x = DO_MAX ? v - m[e >> 1] : v;
            p = bfr(DO_EXP ? expf(x) : x);
          }
          pp[j][e >> 1] |= (__float_as_uint(p) >> 16) << (16 * (e & 1));
        };
        // (p's pairs are zeroed just before they fill: no live range
        // across the score MMAs)
        auto zero_pp = [&]() {
#pragma unroll
          for (int j = 0; j < KT; ++j) pp[j][0] = pp[j][1] = 0u;
        };
        if constexpr (F64) {
          float sc[KT][4];
          scores([&](int j, int e, float v) {
            const int key = 8 * j + 2 * t + (e & 1);
            v = masked(key, v);
            sc[j][e] = v;
            if (DO_MAX && key < nk) m[e >> 1] = fmaxf(m[e >> 1], v);
          });
          if (DO_MAX)
#pragma unroll
            for (int i = 0; i < 2; ++i) {
              m[i] = fmaxf(m[i], __shfl_xor_sync(0xffffffffu, m[i], 1));
              m[i] = fmaxf(m[i], __shfl_xor_sync(0xffffffffu, m[i], 2));
            }
          zero_pp();
#pragma unroll
          for (int j = 0; j < KT; ++j) {
            if (j >= nkt) break;
#pragma unroll
            for (int e = 0; e < 4; ++e) take_p(j, e, sc[j][e]);
          }
        } else {
          // pass 0 the rows' max (where the mode takes it), pass 1 p: one
          // copy of the score code
#pragma unroll 1
          for (int pass = DO_MAX ? 0 : 1; pass < 2; ++pass) {
            if (pass == 1) {
              if (DO_MAX)
#pragma unroll
                for (int i = 0; i < 2; ++i) {
                  m[i] = fmaxf(m[i], __shfl_xor_sync(0xffffffffu, m[i], 1));
                  m[i] = fmaxf(m[i], __shfl_xor_sync(0xffffffffu, m[i], 2));
                }
              zero_pp();
            }
            scores([&](int j, int e, float v) {
              const int key = 8 * j + 2 * t + (e & 1);
              v = masked(key, v);
              if (pass == 1)
                take_p(j, e, v);
              else if (key < nk)
                m[e >> 1] = fmaxf(m[e >> 1], v);
            });
          }
        }
      } else {
        // full's stages over S^T's keys: this lane's (16 mk + 8 hh + g),
        // then the xor-4/8/16 shuffles; m[nq][c], query 8 nq + 2 t + c
        float m[2][2];
        double ps[2][2];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          m[q >> 1][q & 1] = NEG_INF;
          ps[q >> 1][q & 1] = 0.0;
        }
        auto masked = [&](int key, float v) { return key >= nv ? -1e30f : v; };
        auto take_max = [&](int mk, int nq, int e, float v) {
          const int key = 16 * mk + 8 * (e >> 1) + g;
          if (key < nk) m[nq][e & 1] = fmaxf(m[nq][e & 1], masked(key, v));
        };
        // p, packed: pk[mk][hh][nq] = the bf16 pair of queries 2 t, 2 t + 1
        uint32_t pk[KT / 2][2][2];
        auto zero_pk = [&]() {
#pragma unroll
          for (int mk = 0; mk < KT / 2; ++mk)
#pragma unroll
            for (int q = 0; q < 4; ++q) pk[mk][q >> 1][q & 1] = 0u;
        };
        auto take_p = [&](int mk, int nq, int e, float v) {
          const int key = 16 * mk + 8 * (e >> 1) + g, c = e & 1;
          const float p =
              key < nk ? bfr(expf(masked(key, v) - m[nq][c])) : 0.f;
          ps[nq][c] += static_cast<double>(p);
          pk[mk][e >> 1][nq] |= (__float_as_uint(p) >> 16) << (16 * c);
        };
        auto max_over_keys = [&]() {
#pragma unroll
          for (int q = 0; q < 4; ++q)
#pragma unroll
            for (int o = 4; o < 32; o <<= 1)
              m[q >> 1][q & 1] = fmaxf(
                  m[q >> 1][q & 1],
                  __shfl_xor_sync(0xffffffffu, m[q >> 1][q & 1], o));
        };
        if constexpr (F64) {
          float sc[KT][4];
          scores_t([&](int mk, int nq, int e, float v) {
            sc[2 * mk + nq][e] = v;
            take_max(mk, nq, e, v);
          });
          max_over_keys();
          zero_pk();
          // a lane's keys in order: mk, then hh (its sum's order)
#pragma unroll
          for (int mk = 0; mk < KT / 2; ++mk) {
            if (2 * mk >= nkt) break;
#pragma unroll
            for (int nq = 0; nq < 2; ++nq)
#pragma unroll
              for (int e = 0; e < 4; ++e)
                take_p(mk, nq, e, sc[2 * mk + nq][e]);
          }
        } else {
#pragma unroll 1
          for (int pass = 0; pass < 2; ++pass) {
            if (pass == 1) {
              max_over_keys();
              zero_pk();
            }
            scores_t([&](int mk, int nq, int e, float v) {
              if (pass == 1)
                take_p(mk, nq, e, v);
              else
                take_max(mk, nq, e, v);
            });
          }
        }
        float st[2][2];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          double v = ps[q >> 1][q & 1];
#pragma unroll
          for (int o = 4; o < 32; o <<= 1)
            v += __shfl_xor_sync(0xffffffffu, v, o);
          st[q >> 1][q & 1] = static_cast<float>(v);
        }
        // p into P.V's layout: key 16 mk + 8 hh + 2 t + e of query g (+ 8
        // nq) is lane (2 t + e, g / 2)'s pair pk[mk][hh][nq], half g % 2
#pragma unroll
        for (int mk = 0; mk < KT / 2; ++mk) {
          if (2 * mk >= nkt) break;
#pragma unroll
          for (int hh = 0; hh < 2; ++hh)
#pragma unroll
            for (int nq = 0; nq < 2; ++nq) {
              uint32_t w = 0u;
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const uint32_t u = __shfl_sync(
                    0xffffffffu, pk[mk][hh][nq], (2 * t + e) * 4 + (g >> 1));
                w |= ((g & 1 ? u >> 16 : u) & 0xFFFFu) << (16 * e);
              }
              pp[2 * mk + hh][nq] = w;
            }
        }
        // the row sums of queries g and g + 8: lane g / 2's, half g % 2
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const float s0 = __shfl_sync(0xffffffffu, st[i][0], g >> 1);
          const float s1 = __shfl_sync(0xffffffffu, st[i][1], g >> 1);
          rs[i] = g & 1 ? s1 : s0;
        }
      }
    }

    if (it == 0) __syncthreads();  // V^T is staged

    if (have) {
      load_q(mt + NW);  // the next tile's q rows, during P.V
      // o = p . v over four column tiles of 8 at a time (a half of a
      // head of 64: fewer live accumulators): k-step (j, e) takes keys 8 j
      // + 2 t + e (k-lane t), a thread's two keys of V^T in one load; the
      // row sums (f64) and the ones column from the first half's A
      // fragments, in the same key order
      double one[4] = {0.0, 0.0, 0.0, 0.0};
      double ps[2] = {0.0, 0.0};
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        if (4 * half >= HDT) break;
        double oacc[4][4];
#pragma unroll
        for (int c = 0; c < 4; ++c)
#pragma unroll
          for (int e = 0; e < 4; ++e) oacc[c][e] = 0.0;
#pragma unroll
        for (int j = 0; j < KT; ++j) {
          if (j >= nkt) break;
          double pa[2][2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            pa[e][0] = static_cast<double>(bf_half(pp[j][0], e));
            pa[e][1] = static_cast<double>(bf_half(pp[j][1], e));
            if (half == 0 && DO_SUM && !TR) {
              ps[0] += pa[e][0];
              ps[1] += pa[e][1];
            }
            if (half == 0 && MXU)
              qvt::dmma(one, pa[e], 1.0);  // p times a column of ones
          }
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int nt = 4 * half + c;
            if (nt >= HDT) break;
            double v0, v1;
            pair_d(Vt + (8 * nt + g) * LDV + 8 * j + 2 * t, v0, v1);
            qvt::dmma(oacc[c], pa[0], v0);
            qvt::dmma(oacc[c], pa[1], v1);
          }
        }
        if (half == 0 && DO_SUM && !TR)
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            ps[i] += __shfl_xor_sync(0xffffffffu, ps[i], 1);
            ps[i] += __shfl_xor_sync(0xffffffffu, ps[i], 2);
            rs[i] = static_cast<float>(ps[i]);
          }
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int r = 16 * mt + g + 8 * i;
          if (r >= n) continue;
          int8_t* orow = a.out + (static_cast<long long>(b) * n + r) * HD +
                         h * hd + 2 * t;
          const float den = MXU ? static_cast<float>(one[2 * i]) : rs[i];
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int nt = 4 * half + c;
            if (nt >= HDT) break;
            int lv[2];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              float o = static_cast<float>(oacc[c][2 * i + e]);
              if (MXU)
                o = o / den;
              else if (MODE == MODE_RECIP)
                o = o * rcp_approx(rs[i]);
              else if (MODE == MODE_SUM_ONLY)
                o = o + rs[i] * 1e-30f;
              else if (DO_SUM)
                o = o / rs[i];
              lv[e] = static_cast<int>(
                  fminf(fmaxf(rintf(o * a.inv_d), -a.top), a.top));
            }
            *reinterpret_cast<uint16_t*>(orow + 8 * nt) =
                static_cast<uint16_t>((lv[0] & 0xFF) | ((lv[1] & 0xFF) << 8));
          }
        }
      }
    }
  }
}

template <int MODE, typename T>
cudaError_t launch_attn_as(const AttnArgs& a, cudaStream_t st) {
  auto kern = attn_kernel<MODE, T>;
  constexpr int smem = attn_smem(sizeof(T) == 8);
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  kern<<<dim3(a.heads, a.B), NT, smem, st>>>(a);
  return cudaGetLastError();
}

// f64 rows where the keys fit the f64 instantiation's registers, else
// bf16 rows
template <int MODE>
cudaError_t launch_attn(const AttnArgs& a, bool f64, cudaStream_t st) {
  return f64 ? launch_attn_as<MODE, double>(a, st)
             : launch_attn_as<MODE, __nv_bfloat16>(a, st);
}

// ---------------------------------------------------------------------------
// K19: blocks of 4 warps, a warp streaming its 16-row query tiles over the
// keys 16 at a time, K and V raw in a ring of 32-key slots fed by TMA
// ---------------------------------------------------------------------------

constexpr int A2_NW = 4, A2_NT = 32 * A2_NW;
constexpr int A2_SEG = 32;   // keys a ring slot
constexpr int A2_NSLOT = 7;  // slots: 224 keys resident at once
// a slot: the K box, then the V box, each 32 rows of 64 bf16 (128 bytes)
// in TMA's 128-byte swizzle (16-byte piece p of row r at p ^ (r % 8)); a
// warp's q tile: 16 rows of 64 f64 high words (256 bytes), 16-byte chunk
// c of row r at (c & 8) | ((c & 7) ^ (r % 8))
constexpr int A2_BOX = A2_SEG * 128;
constexpr int A2_SLOT = 2 * A2_BOX;
constexpr int A2_QT = 16 * 256;
// 1 KB to align the ring to 1024 bytes, the ring, the warps' q tiles, a
// full mbarrier and an arrival count a slot (mirrored by
// tests/test_torch_attn2_layout.py); three blocks share an SM's 228 KB
// (1 KB of each block's reserved)
constexpr int A2_SMEM =
    1024 + A2_NSLOT * A2_SLOT + A2_NW * A2_QT + A2_NSLOT * (8 + 4);
static_assert(3 * (A2_SMEM + 1024) <= 233472,
              "K19's ring does not let three blocks share an SM");

struct Attn2Args {
  CUtensorMap kv;  // qkv as [B][nk][3 heads hd] bf16, boxes 32 x 64
  const __nv_bfloat16* qkv;
  int8_t* out;
  const float* prm;  // out_d
  int n, nv, heads, hd;
  int J;    // images a block
  int S;    // shares of an image group's tasks (blockIdx.x)
  int nmt;  // query tiles of 16 rows
  int nkr;  // the keys read: up to the last key tile with a real key
  int ns;   // 32-key ring slots of those keys
  float q_mul, top;
};

__device__ __forceinline__ void a2_ldsm(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
__device__ __forceinline__ void a2_ldsm_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// QVT_A2_OFF: a build with one of K19's stages switched off or swapped,
// for timing only (tools/exp_attn_design.py --stages; 0, none, in the
// kernels' own build): 1 exp2f (p = min(s, 100)); 2 the bf16 -> f64
// operand conversions (the bits moved, not converted); 3 the scores'
// MMAs (and so their loads); 4 P.V's MMAs (and so V's loads); 5 the
// operands built by integer operations (sign, exponent + 896, mantissa;
// subnormals converted: every finite bf16 exactly) in place of the
// conversion. Only 0 and 5 compute the function.
#ifndef QVT_A2_OFF
#define QVT_A2_OFF 0
#endif
constexpr int A2_OFF = QVT_A2_OFF;

// the bf16 in the low (e = 0) or high half of w as an f64 MMA operand
__device__ __forceinline__ double bf_f64(uint32_t w, int e) {
  if (A2_OFF == 2) return __hiloint2double(e ? w : w << 16, 0);
  if (A2_OFF == 5) {
    const uint32_t x = e ? w & 0xFFFF0000u : w << 16, ex = x & 0x7F800000u;
    if (ex == 0 && (x & 0x007F0000u))
      return static_cast<double>(__uint_as_float(x));
    const int hi = (static_cast<int>(x) >> 3) & static_cast<int>(0x8FFFE000u);
    return __hiloint2double(hi + (ex ? 896 << 20 : 0), 0);
  }
  return static_cast<double>(bf_half(w, e));
}
// d = a.b + d on the FP64 tensor cores, m16n8k8 (g = lane / 4, t = lane
// % 4): a = A[g][t], A[g + 8][t], A[g][t + 4], A[g + 8][t + 4]; b =
// B[t][g], B[t + 4][g]; d as qvt::dmma's (fp64_mma.cuh). Products of bf16
// values are exact in f64, so the deeper form changes only the order of
// the f64 additions; it takes half the instructions of two m16n8k4.
__device__ __forceinline__ void dmma8(double (&d)[4], const double (&a)[4],
                                      const double (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b[0]), "d"(b[1]));
}
// two f32 as a pair of bf16 (round to nearest even), lo in the low half
__device__ __forceinline__ uint32_t bf2(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

// a block's ring: its shared-memory address (the slots, then the warps' q
// tiles, the full mbarriers and the arrival counts at constant offsets)
// and its stages
constexpr int A2_FULL = A2_NSLOT * A2_SLOT + A2_NW * A2_QT;
constexpr int A2_CNT = A2_FULL + 8 * A2_NSLOT;
struct A2Ring {
  uint32_t ring;
  int total;    // stages of the block: J images x passes x slots
  int per_img;  // stages an image
};

// stage k (the keys of slot k % ns of image k / per_img) into ring slot k %
// A2_NSLOT: two TMA boxes (K, V; rows past nk zero), on the slot's full
// mbarrier; one thread starts it
__device__ __forceinline__ void a2_stage(const Attn2Args& a, const A2Ring& R,
                                         int k, int h) {
  const int slot = k % A2_NSLOT;
  const int b = blockIdx.z * a.J + k / R.per_img;
  const int r0 = (k % a.ns) * A2_SEG, HD = a.heads * a.hd;
  const uint32_t bar = R.ring + A2_FULL + 8 * slot,
                 dst = R.ring + slot * A2_SLOT;
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(2 * A2_BOX)
               : "memory");
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
#pragma unroll
  for (int v = 0; v < 2; ++v)
    asm volatile(
        "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::"
        "complete_tx::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(
            dst + v * A2_BOX),
        "l"(reinterpret_cast<uint64_t>(&a.kv)), "r"(bar),
        "r"((1 + v) * HD + h * a.hd), "r"(r0), "r"(b)
        : "memory");
}

// until the slot's phase of this parity has landed; a wait that outlasts
// 10 s traps, so a broken protocol faults the launch instead of holding
// the card
__device__ __forceinline__ void a2_wait(const A2Ring& R, int slot,
                                        uint32_t parity) {
  const uint32_t bar = R.ring + A2_FULL + 8 * slot;
  uint32_t done = 0, polls = 0;
  uint64_t t0 = 0;
  for (;;) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if ((++polls & 1023) == 0) {
      uint64_t now;
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));
      if (t0 == 0)
        t0 = now;
      else if (now - t0 > 10000000000ull)
        __trap();
    }
  }
}

// this warp is done with stage k; the last of the block's warps to be done
// refills its slot with stage k + A2_NSLOT
__device__ __forceinline__ void a2_done(const Attn2Args& a, const A2Ring& R,
                                        int k, int h, int lane) {
  __syncwarp();
  if (lane == 0) {
    const uint32_t cnt = R.ring + A2_CNT + 4 * (k % A2_NSLOT);
    int old;
    asm volatile("atom.acq_rel.cta.shared::cta.add.u32 %0, [%1], 1;\n"
                 : "=r"(old)
                 : "r"(cnt)
                 : "memory");
    if (old == A2_NW - 1) {
      asm volatile("st.relaxed.cta.shared::cta.u32 [%0], 0;\n" ::"r"(cnt)
                   : "memory");
      if (k + A2_NSLOT < R.total) a2_stage(a, R, k + A2_NSLOT, h);
    }
  }
  __syncwarp();
}

// JT (1 or 2) key tiles of 8 keys (rows 8 apart at `kt` in a slot: K, then
// V A2_BOX bytes on) for the 16-row query tile at `qt`. The scores of each
// key tile are an MMA chain over the head's octets m, k-lane t of octet m
// being head columns 8 m + 2 t (t) and + 1 (t + 4): the pair ldmatrix
// gives a thread of K's row, and the two q words of the same columns. p =
// exp2(min(s, 100)) for the real keys goes into the row sums (f32 values,
// f64 sums) and, rounded to bf16, into P.V's A fragments straight from the
// D fragments: element q of key tile j is row g + 8 (q / 2), key 8 j + 2 t
// + q % 2, P.V's k-lane t + 4 (q % 2) of key tile j. `lk`: this lane's row
// of an ldmatrix of K (row lane % 8 of key tile lane / 8 % 2; xs = lane %
// 8 << 4, its swizzle); `lq`, `qx`: the same in the q tile (row lane % 8 +
// 8 (lane / 8 % 2), chunk parity lane / 16).
template <int JT>
__device__ __forceinline__ void a2_keys(uint32_t kt, uint32_t qt,
                                        uint32_t lk, uint32_t lq,
                                        uint32_t xs, uint32_t qx, int key0,
                                        int nv, int HDT, double (&o)[8][4],
                                        double (&rs)[2]) {
  double sd[JT][4];
#pragma unroll
  for (int j = 0; j < JT; ++j)
#pragma unroll
    for (int q = 0; q < 4; ++q) sd[j][q] = 0.0;
  const uint32_t lane_oct = (threadIdx.x & 31) >> 3;  // a lane's matrix
#pragma unroll
  for (int m0 = 0; m0 < 8; m0 += 2) {
    if (m0 >= HDT) break;
    // kb[x]: key tile x % 2, octet m0 + x / 2
    uint32_t kb[4];
    a2_ldsm(kb, kt + lk + (((m0 + (lane_oct >> 1)) << 4) ^ xs));
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int m = m0 + i;
      if (m >= HDT) break;
      // q's f64 high words of octet m: qw[2 e + hh] is row g + 8 hh, head
      // column 8 m + 2 t + e
      uint32_t qw[4];
      a2_ldsm(qw, qt + lq + ((((2 * m) & 8) | (((2 * m) & 7) ^ qx)) << 4));
      const double qa[4] = {
          __hiloint2double(qw[0], 0), __hiloint2double(qw[1], 0),
          __hiloint2double(qw[2], 0), __hiloint2double(qw[3], 0)};
#pragma unroll
      for (int j = 0; j < JT; ++j) {
        const double kk[2] = {bf_f64(kb[2 * i + j], 0),
                              bf_f64(kb[2 * i + j], 1)};
        if (A2_OFF != 3) dmma8(sd[j], qa, kk);
      }
    }
  }
  uint32_t pp[JT][2];
#pragma unroll
  for (int j = 0; j < JT; ++j) {
    float p[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float s = fminf(static_cast<float>(sd[j][q]), 100.f);
      p[q] = key0 + 8 * j + (q & 1) < nv ? (A2_OFF == 1 ? s : exp2f(s))
                                         : 0.f;
      rs[q >> 1] += static_cast<double>(p[q]);
    }
    pp[j][0] = bf2(p[0], p[1]);
    pp[j][1] = bf2(p[2], p[3]);
  }
  // P.V a key tile at a time: its V^T fragments of all the head's octets
  // (.trans: a thread gets keys 2 t, 2 t + 1 of column g), its A fragment
  // once for them
#pragma unroll
  for (int j = 0; j < JT; ++j) {
    const uint32_t vt = kt + A2_BOX + j * 1024 + (xs << 3);
    uint32_t vb[2][4];
    a2_ldsm_t(vb[0], vt + ((lane_oct << 4) ^ xs));
    if (HDT > 4) a2_ldsm_t(vb[1], vt + (((4 + lane_oct) << 4) ^ xs));
    const double pa[4] = {bf_f64(pp[j][0], 0), bf_f64(pp[j][1], 0),
                          bf_f64(pp[j][0], 1), bf_f64(pp[j][1], 1)};
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      if (nt >= HDT) break;
      const double vv[2] = {bf_f64(vb[nt >> 2][nt & 3], 0),
                            bf_f64(vb[nt >> 2][nt & 3], 1)};
      if (A2_OFF != 4) dmma8(o[nt], pa, vv);
    }
  }
}

// query tile mt of image b, its keys from stages k0 .. k0 + ns - 1 (slot
// by slot, 16 keys a step); `last`: this warp's last tile over those
// stages (it releases each slot after use). `qt`: this warp's q tile in
// shared memory. HDC: the head's 8-column tiles, fixed at compile time
// (8: the tool's heads of 64, 2-4% faster than the run-time width on the
// H100 in turns, tools/exp_attn2.py; 0: a.hd / 8 at run time).
template <int HDC>
__device__ __forceinline__ void a2_tile(const Attn2Args& a, const A2Ring& R,
                                        uint32_t qt, int mt, int b, int h,
                                        int k0, bool last, float d,
                                        int lane) {
  const int g = lane >> 2, t = lane & 3;
  const int n = a.n, hd = a.hd, HD = a.heads * hd;
  const int HDT = HDC ? HDC : hd / 8;
  const long long W = 3LL * HD;
  // q times q_mul, rounded to bf16, as the high words of its f64 values
  // (the low words are zero) into the warp's q tile: row r, 16-byte chunk
  // 2 o + e holds head columns 8 o + e, + 2, + 4, + 6, at chunk (c & 8) |
  // ((c & 7) ^ (r % 8)); lane takes the octets (row, o) lane, lane + 32,
  // ... of the 16 x 8 (zeros past n and past the head)
  __syncwarp();  // the last tile's ldmatrix reads are done
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int i = lane + 32 * u, r = i >> 3, oc = i & 7;
    const int row = 16 * mt + r;
    uint32_t hw[8];
#pragma unroll
    for (int c = 0; c < 8; ++c) hw[c] = 0u;
    if (row < n && oc < HDT) {
      const uint4 v = __ldg(reinterpret_cast<const uint4*>(
          a.qkv + (static_cast<long long>(b) * n + row) * W + h * hd +
          8 * oc));
      const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int c = 0; c < 8; ++c)
        hw[c] = static_cast<uint32_t>(__double2hiint(static_cast<double>(
            bfr(bf_half(w[c >> 1], c & 1) * a.q_mul))));
    }
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int ch = 2 * oc + e;
      asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(
                       qt + r * 256 + (((ch & 8) | ((ch & 7) ^ (r & 7))) << 4)),
                   "r"(hw[e]), "r"(hw[2 + e]), "r"(hw[4 + e]), "r"(hw[6 + e])
                   : "memory");
    }
  }
  __syncwarp();
  // this lane's ldmatrix rows: of K, row lane % 8 of key tile lane / 8 %
  // 2 (xs: its swizzle); of q, row lane % 8 + 8 (lane / 8 % 2), chunk parity
  // lane / 16 (qx: its swizzle)
  const uint32_t x = lane & 7, xs = x << 4, qx = x ^ (lane >> 4);
  const uint32_t lk2 = (((lane >> 3) & 1) * 8 + x) * 128;
  const uint32_t lq = (x + 8 * ((lane >> 3) & 1)) * 256;
  double o[8][4];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int q = 0; q < 4; ++q) o[nt][q] = 0.0;
  double rs[2] = {0.0, 0.0};
  int slot = k0 % A2_NSLOT;
  uint32_t parity = (k0 / A2_NSLOT) & 1;
  for (int s = 0; s < a.ns; ++s) {
    a2_wait(R, slot, parity);
    const uint32_t sb = R.ring + slot * A2_SLOT;
    // the slot's key tiles that hold a real key, two at a time
    const int key0 = 32 * s + 2 * t, kts = min(4, (a.nkr - 32 * s + 7) >> 3);
#pragma unroll
    for (int j2 = 0; j2 < 2; ++j2) {
      const int left = kts - 2 * j2;
      if (left >= 2)
        a2_keys<2>(sb + 2048 * j2, qt, lk2, lq, xs, qx, key0 + 16 * j2,
                   a.nv, HDT, o, rs);
      else if (left == 1)
        a2_keys<1>(sb + 2048 * j2, qt, lk2, lq, xs, qx, key0 + 16 * j2,
                   a.nv, HDT, o, rs);
    }
    if (last) a2_done(a, R, k0 + s, h, lane);
    if (++slot == A2_NSLOT) {
      slot = 0;
      parity ^= 1;
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    double v = rs[i];
    v += __shfl_xor_sync(0xffffffffu, v, 1);
    v += __shfl_xor_sync(0xffffffffu, v, 2);
    const float inv = 1.0f / ((static_cast<float>(v) + 1e-30f) * d);
    const int r = 16 * mt + g + 8 * i;
    if (r >= n) continue;
    int8_t* orow = a.out + (static_cast<long long>(b) * n + r) * HD +
                   h * hd + 2 * t;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      if (nt >= HDT) break;
      int lv[2];
#pragma unroll
      for (int e = 0; e < 2; ++e)
        lv[e] = static_cast<int>(fminf(
            fmaxf(rintf(static_cast<float>(o[nt][2 * i + e]) * inv), -a.top),
            a.top));
      *reinterpret_cast<uint16_t*>(orow + 8 * nt) =
          static_cast<uint16_t>((lv[0] & 0xFF) | ((lv[1] & 0xFF) << 8));
    }
  }
}

// block (share, head, image group): the share's tasks, (image j, tile t)
// with (j nmt + t) % S == share, in order, J images one after another;
// the block's u-th task goes to warp u % 4
template <int HDC>
__global__ void __launch_bounds__(A2_NT, 3)
    attn2_kernel(const __grid_constant__ Attn2Args a) {
  extern __shared__ __align__(1024) unsigned char smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int h = blockIdx.y, share = blockIdx.x, S = a.S, nmt = a.nmt;
  // all of an image's keys fit the ring: one pass, a warp's tiles one after
  // another over the resident slots; else a pass a round of 4 tasks (one a
  // warp), the keys streamed again for each
  const int passes = a.ns <= A2_NSLOT ? 1 : ((nmt + S - 1) / S + 3) >> 2;
  A2Ring R;
  R.ring = (static_cast<uint32_t>(__cvta_generic_to_shared(smem)) + 1023) &
           ~1023u;
  const uint32_t qt = R.ring + A2_NSLOT * A2_SLOT + warp * A2_QT;
  R.per_img = passes * a.ns;
  R.total = a.J * R.per_img;
  if (threadIdx.x < A2_NSLOT) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                     R.ring + A2_FULL + 8 * threadIdx.x)
                 : "memory");
    asm volatile("st.shared.u32 [%0], 0;\n" ::"r"(R.ring + A2_CNT +
                                                 4 * threadIdx.x)
                 : "memory");
  }
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  __syncthreads();
  if (threadIdx.x == 0)
    for (int k = 0; k < min(A2_NSLOT, R.total); ++k) a2_stage(a, R, k, h);
  const float d = __ldg(a.prm);
  for (int j = 0, k0 = 0, U = 0; j < a.J; ++j) {
    const int b = blockIdx.z * a.J + j;
    const int r = ((share - j * nmt) % S + S) % S;  // the share's first tile
    const int cnt = (nmt - r + S - 1) / S;         // and its tiles
    const int first = U + ((warp - U) & 3);        // this warp's first task
    for (int p = 0; p < passes; ++p, k0 += a.ns) {
      const int lo = passes == 1 ? first : first + 4 * p;
      const int hi = passes == 1 ? U + cnt : min(U + cnt, U + 4 * p + 4);
      if (lo >= hi)
        for (int s = 0; s < a.ns; ++s) {
          a2_wait(R, (k0 + s) % A2_NSLOT, ((k0 + s) / A2_NSLOT) & 1);
          a2_done(a, R, k0 + s, h, lane);
        }
      for (int u = lo; u < hi; u += 4)
        a2_tile<HDC>(a, R, qt, r + S * (u - U), b, h, k0, u + 4 >= hi, d,
                     lane);
    }
    U += cnt;
  }
}

// qkv as a 3-D tensor [B][nk][3 heads hd] for TMA: the rows of an image
// past nk read as zeros, boxes of 32 rows x 64 columns in the 128-byte
// swizzle
int a2_encode(CUtensorMap* map, const void* qkv, int B, int n, int nk,
              int width) {
  using Encode = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                              void*, const cuuint64_t*, const cuuint64_t*,
                              const cuuint32_t*, const cuuint32_t*,
                              CUtensorMapInterleave, CUtensorMapSwizzle,
                              CUtensorMapL2promotion,
                              CUtensorMapFloatOOBfill);
  static Encode encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult q;
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &q);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (q != cudaDriverEntryPointSuccess || fn == nullptr)
      return static_cast<int>(cudaErrorInvalidValue);
    encode = reinterpret_cast<Encode>(fn);
  }
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(width),
                              static_cast<cuuint64_t>(nk),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(width) * 2,
                                 static_cast<cuuint64_t>(n) * width * 2};
  const cuuint32_t box[3] = {64, A2_SEG, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(qkv), dims,
      strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// K19's shared memory above 48 KB, and all of the SM's as shared memory
// (three blocks' rings)
template <int HDC>
cudaError_t launch_attn2(const Attn2Args& a, int B, cudaStream_t st) {
  auto kern = attn2_kernel<HDC>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, A2_SMEM);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kern,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return e;
  kern<<<dim3(a.S, a.heads, B / a.J), A2_NT, A2_SMEM, st>>>(a);
  return cudaGetLastError();
}

}  // namespace

// K18. x [B][n][3 * heads * hd] bf16, 16-byte aligned; out [B][n][heads *
// hd] int8; keys and values from the first nk rows (nk <= min(n, 256));
// hd <= 64, a multiple of 8; mode: ops/ablations.py:EXP_ATTN_CODES. One
// block a (head, image); K and V as f64 rows at most 208 keys (rounded up
// to 16), else bf16 rows.
extern "C" int qvt_exp_attn(const void* x, void* out, int B, int n, int nk,
                            int heads, int hd, int n_valid, int mode,
                            int top, float inv_d, void* stream) {
  if (B < 1 || n < 1 || nk < 1 || nk > n || nk > MAXK || hd > HDM ||
      hd < 8 || hd % 8 || heads < 1 || heads > 65535 || B > 65535 ||
      (reinterpret_cast<uintptr_t>(x) & 15) || mode < MODE_FULL ||
      mode > MODE_TRANSPOSED)
    return static_cast<int>(cudaErrorInvalidValue);
  AttnArgs a;
  a.x = static_cast<const __nv_bfloat16*>(x);
  a.out = static_cast<int8_t*>(out);
  a.B = B;
  a.n = n;
  a.nk = nk;
  a.nkp = (nk + 15) / 16 * 16;
  a.heads = heads;
  a.hd = hd;
  a.n_valid = n_valid;
  a.inv_d = inv_d;
  a.top = static_cast<float>(top);
  const bool f64 = a.nkp <= 8 * KT_F64;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  switch (mode) {
    case MODE_FULL: e = launch_attn<MODE_FULL>(a, f64, st); break;
    case MODE_NO_MASK: e = launch_attn<MODE_NO_MASK>(a, f64, st); break;
    case MODE_NO_MAX: e = launch_attn<MODE_NO_MAX>(a, f64, st); break;
    case MODE_NO_EXP: e = launch_attn<MODE_NO_EXP>(a, f64, st); break;
    case MODE_MATMULS_ONLY:
      e = launch_attn<MODE_MATMULS_ONLY>(a, f64, st);
      break;
    case MODE_SUM_ONLY: e = launch_attn<MODE_SUM_ONLY>(a, f64, st); break;
    case MODE_RECIP: e = launch_attn<MODE_RECIP>(a, f64, st); break;
    case MODE_NO_SUM: e = launch_attn<MODE_NO_SUM>(a, f64, st); break;
    case MODE_MXU_SUM: e = launch_attn<MODE_MXU_SUM>(a, f64, st); break;
    default: e = launch_attn<MODE_TRANSPOSED>(a, f64, st);
  }
  return static_cast<int>(e);
}

// K19. qkv [B][n][3 * heads * hd] bf16, 16-byte aligned (hd <= 64, a
// multiple of 8); out [B][n][heads * hd] int8, 2-byte aligned; prm: out_d
// (f32 device memory); nk key rows, n_valid of them real; J images a block
// (B % J == 0); q_mul = sm_scale * log2(e) as f32.
extern "C" int qvt_exp_attn2(const void* qkv, void* out, const void* prm,
                             int B, int n, int heads, int hd, int n_valid,
                             int nk, int J, float q_mul, int out_top,
                             void* stream) {
  if (B < 1 || n < 1 || heads < 1 || hd > HDM || hd < 8 || hd % 8 ||
      nk < 0 || nk > n || n_valid > nk || J < 1 || B % J ||
      B / J > 65535 || heads > 65535 || out_top < 1 ||
      (reinterpret_cast<uintptr_t>(qkv) & 15) ||
      (reinterpret_cast<uintptr_t>(out) & 1))
    return static_cast<int>(cudaErrorInvalidValue);
  Attn2Args a;
  if (nk > 0) {
    const int e = a2_encode(&a.kv, qkv, B, n, nk, 3 * heads * hd);
    if (e) return e;
  }
  a.qkv = static_cast<const __nv_bfloat16*>(qkv);
  a.out = static_cast<int8_t*>(out);
  a.prm = static_cast<const float*>(prm);
  a.n = n;
  a.nv = n_valid;
  a.heads = heads;
  a.hd = hd;
  a.J = J;
  a.nmt = (n + 15) / 16;
  a.S = std::min(J, a.nmt);
  a.nkr = std::min(nk, (std::max(n_valid, 0) + 7) / 8 * 8);
  a.ns = (a.nkr + A2_SEG - 1) / A2_SEG;
  a.q_mul = q_mul;
  a.top = static_cast<float>(out_top);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(hd == HDM ? launch_attn2<HDM / 8>(a, B, st)
                                    : launch_attn2<0>(a, B, st));
}

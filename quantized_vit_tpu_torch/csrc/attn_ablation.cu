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
// program. Here a block takes the same (query tile, head) item of J
// images, one after another, through K6's tile (qkv_attention.cuh:
// qkv_attn_tile): J = 1 is K6's grid, J = 2 and 4 coarsen it.
//
// Bound on this card (3.35 TB/s; 989 TFLOP/s bf16; the FP64 tensor cores'
// 67 TFLOP/s, the ceiling of an exact kernel):
//   K18 at B 8, N 224, nk 208, 12 heads of 64: 1.15 GFLOP; 9.24 MB (q
//       at 224 rows, k and v at 208, the int8 levels: 2.76 us, bytes);
//       FP64 ceiling 17.1 us
//   K19 at B 32, N 224, nk 208: 4.58 GFLOP; 36.96 MB (11.03 us, bytes);
//       FP64 ceiling 68.4 us
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

// K19: item (query tile, head) of images blockIdx.z * J .. + J - 1
template <int R>
__global__ void __launch_bounds__(qvt::QA_NT, 2)
    attn2_kernel(qvt::QkvAttnArgs a, int J) {
  extern __shared__ __align__(16) unsigned char smem[];
  qvt::PhaseClock clk;
  for (int j = 0; j < J; ++j) {
    if (j) __syncthreads();  // the last item's output copy read smem
    qvt::qkv_attn_tile<__nv_bfloat16, R, HDM, false, false>(
        a, blockIdx.x * R, blockIdx.y, blockIdx.z * J + j, smem, clk);
  }
}

template <int R>
cudaError_t launch_attn2(const qvt::QkvAttnArgs& a, int J,
                         cudaStream_t st) {
  auto kern = attn2_kernel<R>;
  constexpr int smem = qvt::qkv_attn_smem(R, HDM, 2);
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  kern<<<dim3((a.n + R - 1) / R, a.heads, a.B / J), qvt::QA_NT, smem, st>>>(
      a, J);
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

// K19. qkv [B][n][3 * heads * hd] bf16 (hd <= 64, a multiple of 8); out
// [B][n][heads * hd] int8, 8-byte aligned; prm: out_d, out_t (f32 device
// memory); nk key rows, n_valid of them real; rows: the query tile (64,
// 32 or 16: ops/attention.py:qkv_attn_tile_rows); J images a block (B % J
// == 0); q_mul = sm_scale * log2(e) as f32.
extern "C" int qvt_exp_attn2(const void* qkv, void* out, const void* prm,
                             int B, int n, int heads, int hd, int n_valid,
                             int nk, int rows, int J, float q_mul,
                             int out_top, void* stream) {
  if (hd > HDM || hd < 8 || hd % 8 || nk > n || n_valid > nk || J < 1 ||
      B % J || B / J > 65535 || heads > 65535 ||
      (rows != 64 && rows != 32 && rows != 16) ||
      (reinterpret_cast<uintptr_t>(out) & 7) || out_top < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  qvt::QkvAttnArgs a;
  a.qkv = qkv;
  a.qkv_dt = qvt::DT_BF16;
  a.out = out;
  a.out_dt = qvt::DT_INT8;
  a.out_mode = qvt::QA_OUT_LEVELS;
  a.out_es = 1;
  a.prm = static_cast<const float*>(prm);
  a.B = B;
  a.n = n;
  a.heads = heads;
  a.hd = hd;
  a.n_valid = n_valid;
  a.nk = nk;
  a.q_mul = q_mul;
  a.sm_scale = 1.f;  // read by int_attention only
  a.out_top = static_cast<float>(out_top);
  a.int_attn = false;
  a.qkv_vec = (reinterpret_cast<uintptr_t>(qkv) & 15) == 0;
  a.out_vec = hd % 16 == 0 && (reinterpret_cast<uintptr_t>(out) & 15) == 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e = rows == 64   ? launch_attn2<64>(a, J, st)
                  : rows == 32 ? launch_attn2<32>(a, J, st)
                               : launch_attn2<16>(a, J, st);
  return static_cast<int>(e);
}

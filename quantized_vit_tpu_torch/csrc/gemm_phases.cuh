// Phases of K1 (fused_quant_matmul.cu) and K2 (fused_mlp.cu), both
// persistent grids of NT threads a block:
//   - row_levels (both, K8's and K10-K12's too): a prologue once per row,
//     the int8 levels of x into a level scratch [M][Kp] (zeros past K), a
//     row to a group of threads;
//   - stage_acc, load4, store4 (both), ldg4 (K1): a GEMM tile's int32
//     accumulators staged in shared memory for an epilogue done by rows,
//     with whole 4-element loads and stores of device memory;
//   - split_reduce (K1): an output tile whose depth is split over S work
//     items summed exactly from the staged tiles, by the last item of the
//     tile to arrive (K2 sums its own from the MMA fragments: this
//     version spilled registers in K2's 128 x 128 instance).
// Each is a template over the kernel's argument struct, which names the
// fields it reads (x, x_dt, K, Kp, M, ln_t, ln_g, ln_b, prm, act_top,
// eps, x_vec, lv).
#pragma once

#include "qvt_common.cuh"

namespace qvt {

// what row_levels computes from x: a copy of int8 levels, the quantizer,
// LayerNorm then the quantizer, or the folded GELU-quant (fused.py:
// _fused_kernel's prologues), or K12's quantizer (int4_matmul.py:
// _fa_quant, the true division: qvt::fa_quant)
enum {
  ROWS_COPY = 0,
  ROWS_QUANT = 1,
  ROWS_LN = 2,
  ROWS_GELU = 3,
  ROWS_FA = 4
};

// The int8 levels of prologue(x) into a.lv, a group of a.ln_t threads a
// row (a.ln_t / 32 warps above 32, summed through shared memory), NT /
// a.ln_t rows a block at a time; the columns [K, Kp) of each row get zero
// levels. The LayerNorm statistics are qvt::ln_stats' (f64 sums of x and
// of x*x taken in f32, rounded once; any order gives the same f32); its
// levels (x - mu) * rs * gamma + beta, the linear quantizer's 1/d folded
// into gamma/beta by the plan. The quantizer prologue is not folded
// (x * (1/d)); ROWS_FA divides (p / d), which can round a level apart
// from x * (1/d) at a tie, and with no row statistics takes x's 16-byte
// pieces as one flat range where Kp == K; the GELU one is
// fused.py:_gelu_quant_folded.
// a.act_top is the clamp level of every quantizer. On the 16-byte
// path (a.x_vec: x 16-byte aligned, bf16 or f32, K a multiple of the
// piece's 8 or 4 values; gamma and beta 16-byte aligned) a thread loads
// whole pieces and stores their levels at once; gamma and beta load as
// float4. POW: the input quantizer's pow map (a template argument: as a
// runtime flag in an unrolled level loop it cost K2 about a third of a
// phase).
template <int PRO, bool POW, int NT, class Args>
__device__ __forceinline__ void row_levels(const Args& a) {
  const int T = a.ln_t, rpb = NT / T, W = T < 32 ? T : 32;
  const int gl = threadIdx.x % T, grp = threadIdx.x / T;
  const int K = a.K;
  const float act_d = a.prm[0], act_t = a.prm[1];
  const bool bf = a.x_dt == DT_BF16;
  const int epp = bf ? 8 : 4, np = K / epp;  // 16-byte pieces a row
  const char* xb = static_cast<const char*>(a.x);
  auto level = [&](float v, float mu, float rs, float g,
                   float b) -> uint32_t {
    if constexpr (PRO == ROWS_LN)
      return static_cast<uint8_t>(quantize((v - mu) * rs * g + b, act_d,
                                           act_t, a.act_top, POW, !POW));
    else if constexpr (PRO == ROWS_QUANT)
      return static_cast<uint8_t>(
          quantize(v, act_d, act_t, a.act_top, POW, false));
    else if constexpr (PRO == ROWS_FA)
      return static_cast<uint8_t>(fa_quant(v, act_d, act_t, a.act_top, POW));
    else
      return static_cast<uint8_t>(gelu_quant_folded(v, act_d, a.act_top));
  };
  if constexpr (PRO == ROWS_FA) {
    if (a.x_vec && a.Kp == K) {
      // K12's levels need no row statistics and, Kp == K, no zero
      // columns: x's pieces as one flat range over the grid's threads,
      // FA_BATCH loads in flight a thread (by row groups, a thread took
      // its row's pieces one load at a time, and the rows' last round left
      // SMs idle; eight in flight were slower on an H100)
      constexpr int FA_BATCH = 4;
      const long long total = a.M * static_cast<long long>(np);
      const long long stride = static_cast<long long>(gridDim.x) * NT;
      for (long long q0 = blockIdx.x * static_cast<long long>(NT) +
                          threadIdx.x;
           q0 < total; q0 += FA_BATCH * stride) {
        uint4 u[FA_BATCH];
#pragma unroll
        for (int b = 0; b < FA_BATCH; ++b) {
          const long long q = q0 + b * stride;
          u[b] = q < total ? __ldg(reinterpret_cast<const uint4*>(xb) + q)
                           : make_uint4(0u, 0u, 0u, 0u);
        }
#pragma unroll
        for (int b = 0; b < FA_BATCH; ++b) {
          const long long q = q0 + b * stride;
          if (q >= total) break;
          uint32_t w[2] = {0u, 0u};
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            if (e >= epp) break;
            w[e >> 2] |= level(piece_at(u[b], bf, e), 0.f, 0.f, 0.f, 0.f)
                         << (8 * (e & 3));
          }
          if (bf)
            reinterpret_cast<uint2*>(a.lv)[q] = make_uint2(w[0], w[1]);
          else
            reinterpret_cast<uint32_t*>(a.lv)[q] = w[0];
        }
      }
      return;
    }
  }
  for (long long r0 = static_cast<long long>(blockIdx.x) * rpb; r0 < a.M;
       r0 += static_cast<long long>(gridDim.x) * rpb) {
    const long long r = r0 + grp;
    const bool live = r < a.M;  // a dead row's threads still reduce
    const long long base = r * K;
    auto piece = [&](int q) {
      return __ldg(reinterpret_cast<const uint4*>(
          xb + (base + static_cast<long long>(q) * epp) * (bf ? 2 : 4)));
    };
    float mu = 0.f, rs = 0.f;
    if constexpr (PRO == ROWS_LN) {
      __shared__ double red[2][NT / 32];
      const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
      const float inv_k = 1.0f / static_cast<float>(K);
      double s = 0.0, s2 = 0.0;
      if (live && a.x_vec) {
        for (int q = gl; q < np; q += T) {
          const uint4 u = piece(q);
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            if (e >= epp) break;
            const float v = piece_at(u, bf, e);
            s += static_cast<double>(v);
            s2 += static_cast<double>(v * v);
          }
        }
      } else if (live) {
        for (int k = gl; k < K; k += T) {
          const float v = load_f(a.x, a.x_dt, base + k);
          s += static_cast<double>(v);
          s2 += static_cast<double>(v * v);
        }
      }
      for (int o = W / 2; o > 0; o >>= 1) {
        s += __shfl_xor_sync(0xffffffffu, s, o);
        s2 += __shfl_xor_sync(0xffffffffu, s2, o);
      }
      if (T > 32) {  // the group's warps, in order
        if (lane == 0) {
          red[0][warp] = s;
          red[1][warp] = s2;
        }
        __syncthreads();
        s = s2 = 0.0;
        for (int i = grp * (T / 32); i < (grp + 1) * (T / 32); ++i) {
          s += red[0][i];
          s2 += red[1][i];
        }
        __syncthreads();  // red is rewritten for the next rows
      }
      mu = static_cast<float>(s) * inv_k;
      const float var =
          fmaxf(static_cast<float>(s2) * inv_k - mu * mu, 0.f);
      rs = 1.0f / sqrtf(var + a.eps);
    }
    if (!live) continue;
    int8_t* out = a.lv + r * a.Kp;
    for (int k = K + gl; k < a.Kp; k += T) out[k] = 0;
    if constexpr (PRO == ROWS_COPY) {
      const int8_t* x8 = static_cast<const int8_t*>(a.x) + base;
      for (int k = gl; k < K; k += T) out[k] = x8[k];
      continue;
    } else {
      if (!a.x_vec) {
        for (int k = gl; k < K; k += T) {
          const bool ln = PRO == ROWS_LN;
          out[k] = static_cast<int8_t>(
              level(load_f(a.x, a.x_dt, base + k), mu, rs,
                    ln ? a.ln_g[k] : 0.f, ln ? a.ln_b[k] : 0.f));
        }
        continue;
      }
      for (int q = gl; q < np; q += T) {
        const uint4 u = piece(q);
        const int k = q * epp;
        float gv[8] = {}, bv[8] = {};
        if constexpr (PRO == ROWS_LN) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            if (h * 4 >= epp) break;
            const float4 g4 =
                __ldg(reinterpret_cast<const float4*>(a.ln_g + k) + h);
            const float4 b4 =
                __ldg(reinterpret_cast<const float4*>(a.ln_b + k) + h);
            gv[4 * h] = g4.x, gv[4 * h + 1] = g4.y, gv[4 * h + 2] = g4.z;
            gv[4 * h + 3] = g4.w;
            bv[4 * h] = b4.x, bv[4 * h + 1] = b4.y, bv[4 * h + 2] = b4.z;
            bv[4 * h + 3] = b4.w;
          }
        }
        uint32_t w[2] = {0u, 0u};
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          if (e >= epp) break;
          w[e >> 2] |= level(piece_at(u, bf, e), mu, rs, gv[e], bv[e])
                       << (8 * (e & 3));
        }
        if (bf)
          *reinterpret_cast<uint2*>(out + k) = make_uint2(w[0], w[1]);
        else
          *reinterpret_cast<uint32_t*>(out + k) = w[0];
      }
    }
  }
}

// A tile's accumulators into the stage (the drained GEMM ring) as int32
// [BM][BN + 8]: the fragments' 8-byte stores fall in distinct banks. The
// epilogues then give a row to 8 threads, each a 4-column group at a time
// (16-byte stage reads interleaved at 32 columns: no bank conflicts),
// with whole 4-element loads and stores of device memory. Computed in
// the fragments, the epilogue's math had the accumulators live beside it
// (128 registers a thread) and the stores went out scattered, 2 or 4
// bytes to a row: K2's epilogues ran slower so.
constexpr int STAGE_PAD = 8;

template <int BM, int BN>
__device__ __forceinline__ void stage_acc(
    const int (&acc)[BM / 32][BN / 32][4], int* stage) {
  constexpr int TM = BM / 32, TN = BN / 32, WM = BM / 2, WN = BN / 4;
  constexpr int RS = BN + STAGE_PAD;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp / (BN / WN) * WM + (lane >> 2);
  const int wn = warp % (BN / WN) * WN + 2 * (lane & 3);
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
        *reinterpret_cast<int2*>(stage + (wm + 16 * i + 8 * hh) * RS + wn +
                                 8 * j) =
            make_int2(acc[i][j][2 * hh], acc[i][j][2 * hh + 1]);
  __syncthreads();
}

// four consecutive elements of a bf16 or f32 row (8 or 16 bytes)
__device__ __forceinline__ void load4(const void* p, int dt, long long i,
                                      float (&v)[4]) {
  if (dt == DT_F32) {
    const float4 f = *reinterpret_cast<const float4*>(
        static_cast<const float*>(p) + i);
    v[0] = f.x, v[1] = f.y, v[2] = f.z, v[3] = f.w;
    return;
  }
  const uint2 u = *reinterpret_cast<const uint2*>(
      static_cast<const __nv_bfloat16*>(p) + i);
  v[0] = __uint_as_float(u.x << 16);
  v[1] = __uint_as_float(u.x & 0xFFFF0000u);
  v[2] = __uint_as_float(u.y << 16);
  v[3] = __uint_as_float(u.y & 0xFFFF0000u);
}

// load4 through the read-only data path (ld.global.nc): for data no
// thread of the launch writes; the compiler may start it ahead of stores
__device__ __forceinline__ void ldg4(const void* p, int dt, long long i,
                                     float (&v)[4]) {
  if (dt == DT_F32) {
    const float4 f =
        __ldg(reinterpret_cast<const float4*>(static_cast<const float*>(p) +
                                              i));
    v[0] = f.x, v[1] = f.y, v[2] = f.z, v[3] = f.w;
    return;
  }
  const uint2 u = __ldg(reinterpret_cast<const uint2*>(
      static_cast<const __nv_bfloat16*>(p) + i));
  v[0] = __uint_as_float(u.x << 16);
  v[1] = __uint_as_float(u.x & 0xFFFF0000u);
  v[2] = __uint_as_float(u.y << 16);
  v[3] = __uint_as_float(u.y & 0xFFFF0000u);
}

__device__ __forceinline__ void store4(void* p, int dt, long long i,
                                       const float (&v)[4]) {
  if (dt == DT_F32) {
    *reinterpret_cast<float4*>(static_cast<float*>(p) + i) =
        make_float4(v[0], v[1], v[2], v[3]);
    return;
  }
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
  *reinterpret_cast<uint2*>(static_cast<__nv_bfloat16*>(p) + i) =
      make_uint2(*reinterpret_cast<const uint32_t*>(&lo),
                 *reinterpret_cast<const uint32_t*>(&hi));
}

// One split of a BM x BN output tile whose depth is split over S work
// items, item q of the split items (split tile q / S, split sp = q % S),
// its accumulators staged (stage_acc): its int32 partial tile goes from
// the stage to part [split tiles * S][BM * BN] in whole 16-byte rows; the
// tile's last split to arrive (cnt[q / S] counts arrivals, atomicInc
// wraps it back to 0 at the S-th, so the counts stay zero between
// launches) adds the others' partials, written before their arrival, into
// the stage, in split order. Returns true, for every thread of the block,
// on the last split, the stage then holding the tile's sums for the
// epilogue; else the stage may be reused at once. Int32 sums are exact:
// no split changes a bit. A thread loads four of its pieces of one
// partial before it adds any (a 64 x 64 tile's all; more in flight spilled
// at 128 x 128), so (S - 1) round trips to L2 make a 64 x 64 tile's sum.
template <int BM, int BN, int NT>
__device__ __forceinline__ bool split_reduce(int* stage, int* part,
                                             int* cnt, int q, int S) {
  constexpr int RS = BN + STAGE_PAD, C4 = BN / 4, P = BM * C4 / NT;
  // pieces summed at a time: the sums and the loads in flight in registers
  constexpr int CH = P < 4 ? P : 4;
  static_assert(BM * C4 % NT == 0 && P % CH == 0, "a tile's pieces");
  __shared__ int s_last;
  const int tile = q / S, sp = q - tile * S;
  auto at = [&](int j) {  // piece j's offset in the stage
    const int p = threadIdx.x + j * NT;
    return p / C4 * RS + p % C4 * 4;
  };
  auto in_part = [&](int j) {  // and in a partial tile
    const int p = threadIdx.x + j * NT;
    return p / C4 * BN + p % C4 * 4;
  };
  int* mine = part + static_cast<long long>(q) * BM * BN;
#pragma unroll
  for (int j = 0; j < P; ++j)
    *reinterpret_cast<int4*>(mine + in_part(j)) =
        *reinterpret_cast<const int4*>(stage + at(j));
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    s_last = atomicInc(reinterpret_cast<unsigned*>(cnt + tile),
                       static_cast<unsigned>(S - 1)) ==
             static_cast<unsigned>(S - 1);
  __syncthreads();
  if (!s_last) return false;
  __threadfence();
#pragma unroll
  for (int j0 = 0; j0 < P; j0 += CH) {
    int4 sum[CH];
#pragma unroll
    for (int j = 0; j < CH; ++j)
      sum[j] = *reinterpret_cast<const int4*>(stage + at(j0 + j));
    for (int o = 0; o < S; ++o) {
      if (o == sp) continue;
      const int* other =
          part + (static_cast<long long>(tile) * S + o) * BM * BN;
      int4 v[CH];
#pragma unroll
      for (int j = 0; j < CH; ++j)
        v[j] = __ldcg(reinterpret_cast<const int4*>(other + in_part(j0 + j)));
#pragma unroll
      for (int j = 0; j < CH; ++j) {
        sum[j].x += v[j].x;
        sum[j].y += v[j].y;
        sum[j].z += v[j].z;
        sum[j].w += v[j].w;
      }
    }
#pragma unroll
    for (int j = 0; j < CH; ++j)
      *reinterpret_cast<int4*>(stage + at(j0 + j)) = sum[j];
  }
  __syncthreads();
  return true;
}

}  // namespace qvt

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
// from the P.V loop as a product with a column of ones; `transposed`
// holds the scores as [keys][queries]. Both compute `full`'s function.
// `recip` multiplies by rcp.approx.f32 of the sum, the card's counterpart
// of pl.reciprocal(approx=True).
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
// K18's design is simple and right first: a block of 256 threads per
// (32 query rows, head, image) stages its q rows as f32 and the head's
// keys and values whole (bf16, at most 256 keys) in shared memory; the
// scores and P.V run on the FP64 pipes (scalar fma, products of bf16
// values exact in f64), 4 rows x 4 keys a thread at a time; the scores go
// through a shared [rows][keys] (or [keys][rows]) tile where a warp a row
// masks, takes the max, the exp and the sum (f64, rounded once). Numerics
// are those of the plain version, built with -fmad=false: f64 sums
// rounded once to f32, expf as PyTorch's exp on the card calls it, p
// rounded to bf16, a true division, rintf.

#include <algorithm>

#include "qkv_attention.cuh"

namespace {

constexpr int NT = 256, NW = NT / 32;
constexpr int QT = 32;         // query rows a block
constexpr int RPW = QT / NW;   // rows a warp
constexpr int HDM = 64;        // the widest head
constexpr int MAXK = 256;      // the most keys
constexpr int LDK = HDM + 2;   // K rows (bf16): a lane's word in its bank
constexpr int JG = 4;          // key groups of 32 a pass of the scores

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

// dynamic shared memory at nkp keys (a multiple of 32): q (f32), K, V
// (bf16), the score tile (f32, either layout), the row sums
__host__ __device__ constexpr int attn_smem(int nkp) {
  return 4 * QT * HDM + 2 * nkp * LDK + 2 * nkp * HDM + 4 * nkp * (QT + 1) +
         4 * QT;
}

template <bool TR>
__device__ __forceinline__ int pidx(int r, int key, int nkp) {
  return TR ? key * (QT + 1) + r : r * (nkp + 1) + key;
}

__device__ __forceinline__ float bfr(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float rcp_approx(float v) {
  float r;
  asm("rcp.approx.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}

template <int MODE>
__global__ void __launch_bounds__(NT, 2) attn_kernel(AttnArgs a) {
  constexpr bool TR = MODE == MODE_TRANSPOSED;
  constexpr bool DO_MASK =
      MODE != MODE_NO_MASK && MODE != MODE_MATMULS_ONLY;
  constexpr bool DO_MAX = MODE != MODE_NO_MAX && MODE != MODE_MATMULS_ONLY;
  constexpr bool DO_EXP = MODE != MODE_NO_EXP && MODE != MODE_MATMULS_ONLY;
  constexpr bool DO_SUM = MODE == MODE_FULL || MODE == MODE_NO_MASK ||
                          MODE == MODE_NO_MAX || MODE == MODE_SUM_ONLY ||
                          MODE == MODE_RECIP || MODE == MODE_TRANSPOSED;
  extern __shared__ __align__(16) unsigned char smem[];
  const int nkp = a.nkp, nk = a.nk, hd = a.hd, hp = hd / 8;
  // q [QT][HDM] f32, K [nkp][LDK] and V [nkp][HDM] bf16, the score tile
  // [QT][nkp + 1] (TR: [nkp][QT + 1]) f32, the row sums [QT]
  float* Qs = reinterpret_cast<float*>(smem);
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(Qs + QT * HDM);
  __nv_bfloat16* Vs = Ks + nkp * LDK;
  float* Ps = reinterpret_cast<float*>(Vs + nkp * HDM);
  float* rsum = Ps + nkp * (QT + 1);
  const int q0 = blockIdx.x * QT, h = blockIdx.y, b = blockIdx.z;
  const int nq = min(QT, a.n - q0), HD = a.heads * hd;
  const long long W = 3LL * HD;
  const __nv_bfloat16* xb =
      a.x + static_cast<long long>(b) * a.n * W + h * hd;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  // stage q (f32), K and V (bf16): 16-byte pieces, zeros past the rows
  for (int i = threadIdx.x; i < QT * hp; i += NT) {
    const int r = i / hp, c = (i - r * hp) * 8;
    uint4 u = make_uint4(0u, 0u, 0u, 0u);
    if (r < nq)
      u = __ldg(reinterpret_cast<const uint4*>(xb + (q0 + r) * W + c));
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
    float4* d = reinterpret_cast<float4*>(Qs + r * HDM + c);
    d[0] = make_float4(__uint_as_float(w[0] << 16),
                       __uint_as_float(w[0] & 0xFFFF0000u),
                       __uint_as_float(w[1] << 16),
                       __uint_as_float(w[1] & 0xFFFF0000u));
    d[1] = make_float4(__uint_as_float(w[2] << 16),
                       __uint_as_float(w[2] & 0xFFFF0000u),
                       __uint_as_float(w[3] << 16),
                       __uint_as_float(w[3] & 0xFFFF0000u));
  }
  for (int i = threadIdx.x; i < nkp * hp; i += NT) {
    const int key = i / hp, c = (i - key * hp) * 8;
    uint4 uk = make_uint4(0u, 0u, 0u, 0u), uv = uk;
    if (key < nk) {
      uk = __ldg(reinterpret_cast<const uint4*>(xb + key * W + HD + c));
      uv = __ldg(reinterpret_cast<const uint4*>(xb + key * W + 2 * HD + c));
    }
    uint32_t* dk = reinterpret_cast<uint32_t*>(Ks + key * LDK + c);
    dk[0] = uk.x, dk[1] = uk.y, dk[2] = uk.z, dk[3] = uk.w;
    *reinterpret_cast<uint4*>(Vs + key * HDM + c) = uv;
  }
  __syncthreads();

  // scores: rows RPW * warp + i, keys lane + 32 j, exact f64 sums
  const int nj = nkp / 32;
  for (int jg = 0; jg < nj; jg += JG) {
    double acc[RPW][JG];
#pragma unroll
    for (int i = 0; i < RPW; ++i)
#pragma unroll
      for (int jj = 0; jj < JG; ++jj) acc[i][jj] = 0.0;
    for (int d = 0; d < hd; d += 2) {
      float2 qv[RPW], kv[JG];
#pragma unroll
      for (int i = 0; i < RPW; ++i)
        qv[i] = *reinterpret_cast<const float2*>(
            Qs + (RPW * warp + i) * HDM + d);
#pragma unroll
      for (int jj = 0; jj < JG; ++jj) {
        const int key = min(lane + 32 * (jg + jj), nkp - 1);
        const uint32_t u =
            *reinterpret_cast<const uint32_t*>(Ks + key * LDK + d);
        kv[jj] = make_float2(__uint_as_float(u << 16),
                             __uint_as_float(u & 0xFFFF0000u));
      }
#pragma unroll
      for (int i = 0; i < RPW; ++i)
#pragma unroll
        for (int jj = 0; jj < JG; ++jj) {
          acc[i][jj] = __fma_rn(static_cast<double>(qv[i].x),
                                static_cast<double>(kv[jj].x), acc[i][jj]);
          acc[i][jj] = __fma_rn(static_cast<double>(qv[i].y),
                                static_cast<double>(kv[jj].y), acc[i][jj]);
        }
    }
#pragma unroll
    for (int i = 0; i < RPW; ++i)
#pragma unroll
      for (int jj = 0; jj < JG; ++jj) {
        const int key = lane + 32 * (jg + jj);
        if (jg + jj < nj && key < nk)
          Ps[pidx<TR>(RPW * warp + i, key, nkp)] =
              static_cast<float>(acc[i][jj]);
      }
  }
  __syncthreads();

  // the softmax's stages, a warp a row: mask, max, exp, p in bf16, sum
  for (int i = 0; i < RPW; ++i) {
    const int r = RPW * warp + i;
    float s[MAXK / 32];
    float m = -__int_as_float(0x7f800000);
#pragma unroll
    for (int j = 0; j < MAXK / 32; ++j) {
      const int key = lane + 32 * j;
      s[j] = 0.f;
      if (key < nk) {
        float v = Ps[pidx<TR>(r, key, nkp)];
        if (DO_MASK && key >= a.n_valid) v = -1e30f;
        s[j] = v;
        m = fmaxf(m, v);
      }
    }
    if (DO_MAX)
      for (int o = 16; o > 0; o >>= 1)
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    double sum = 0.0;
#pragma unroll
    for (int j = 0; j < MAXK / 32; ++j) {
      const int key = lane + 32 * j;
      if (key < nk) {
        const float t = DO_MAX ? s[j] - m : s[j];
        const float p = bfr(DO_EXP ? expf(t) : t);
        Ps[pidx<TR>(r, key, nkp)] = p;
        sum += static_cast<double>(p);
      }
    }
    if (DO_SUM) {
      sum = qvt::warp_sum(sum);
      if (lane == 0) rsum[r] = static_cast<float>(sum);
    }
  }
  __syncthreads();

  // o = p . v: rows RPW * warp + i, columns lane and lane + 32
  double acc[RPW][2], ps[RPW];
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    acc[i][0] = acc[i][1] = 0.0;
    ps[i] = 0.0;
  }
  for (int key = 0; key < nk; ++key) {
    const float v0 = __bfloat162float(Vs[key * HDM + lane]);
    const float v1 = __bfloat162float(Vs[key * HDM + lane + 32]);
#pragma unroll
    for (int i = 0; i < RPW; ++i) {
      const double p =
          static_cast<double>(Ps[pidx<TR>(RPW * warp + i, key, nkp)]);
      acc[i][0] = __fma_rn(p, static_cast<double>(v0), acc[i][0]);
      acc[i][1] = __fma_rn(p, static_cast<double>(v1), acc[i][1]);
      if (MODE == MODE_MXU_SUM) ps[i] += p;  // p times a column of ones
    }
  }
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    const int r = RPW * warp + i;
    if (r >= nq) continue;
    int8_t* orow = a.out + (static_cast<long long>(b) * a.n + q0 + r) * HD +
                   h * hd;
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int d = lane + 32 * c;
      if (d >= hd) continue;
      float o = static_cast<float>(acc[i][c]);
      if (MODE == MODE_MXU_SUM)
        o = o / static_cast<float>(ps[i]);
      else if (MODE == MODE_RECIP)
        o = o * rcp_approx(rsum[r]);
      else if (MODE == MODE_SUM_ONLY)
        o = o + rsum[r] * 1e-30f;
      else if (DO_SUM)
        o = o / rsum[r];
      orow[d] = static_cast<int8_t>(static_cast<int>(
          fminf(fmaxf(rintf(o * a.inv_d), -a.top), a.top)));
    }
  }
}

template <int MODE>
cudaError_t launch_attn(const AttnArgs& a, cudaStream_t st) {
  auto kern = attn_kernel<MODE>;
  const int smem = attn_smem(a.nkp);
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  kern<<<dim3((a.n + QT - 1) / QT, a.heads, a.B), NT, smem, st>>>(a);
  return cudaGetLastError();
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
// hd <= 64, a multiple of 8; mode: ops/ablations.py:EXP_ATTN_CODES.
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
  a.nkp = (nk + 31) / 32 * 32;
  a.heads = heads;
  a.hd = hd;
  a.n_valid = n_valid;
  a.inv_d = inv_d;
  a.top = static_cast<float>(top);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  switch (mode) {
    case MODE_FULL: e = launch_attn<MODE_FULL>(a, st); break;
    case MODE_NO_MASK: e = launch_attn<MODE_NO_MASK>(a, st); break;
    case MODE_NO_MAX: e = launch_attn<MODE_NO_MAX>(a, st); break;
    case MODE_NO_EXP: e = launch_attn<MODE_NO_EXP>(a, st); break;
    case MODE_MATMULS_ONLY: e = launch_attn<MODE_MATMULS_ONLY>(a, st); break;
    case MODE_SUM_ONLY: e = launch_attn<MODE_SUM_ONLY>(a, st); break;
    case MODE_RECIP: e = launch_attn<MODE_RECIP>(a, st); break;
    case MODE_NO_SUM: e = launch_attn<MODE_NO_SUM>(a, st); break;
    case MODE_MXU_SUM: e = launch_attn<MODE_MXU_SUM>(a, st); break;
    default: e = launch_attn<MODE_TRANSPOSED>(a, st);
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

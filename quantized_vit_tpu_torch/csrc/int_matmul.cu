// K10-K12: the first-generation integer GEMMs, for Hopper (sm_90a).
//
// One tiled int8 tensor-core GEMM with three front ends replaces three TPU
// kernels of quantized_vit_tpu/ops/int4_matmul.py:
//   K10 int4_matmul (_int4_kernel, pallas_call at int4_matmul.py:193):
//       int8 levels [M, K] x packed int4 [K/2, N] -> int32 -> * scale
//       + bias in f32 -> f32/bf16, or (requant_top) int8
//       clip(rint(.), -top, top);
//   K11 int8_matmul (_int8_kernel, :273): int8 levels x int8 [K, N];
//   K12 quant_matmul_fa (_int4_fa_kernel, _int8_fa_kernel, :480): float x
//       [M, K] (f32 or bf16) quantized to LSFQ levels on the way in,
//       _fa_quant's sign(x) * min(rint(p / d), top) with p = |x| or
//       exp(t * log(max(|x|, 1e-30))): a true division (K1's quant
//       prologue multiplies by 1/d instead, which can flip a level at a
//       rounding tie), d, t and top read from device memory.
//
// Design: a 128 x 128 output tile per block, 8 warps of 64 x 32 (mma.sync
// m16n8k32 s8 -> s32), K walked in chunks of 64 levels through two
// shared-memory stages filled with cp.async (chunk c + 1 loads while chunk c
// computes). The weight arrives n-major (ops/_build.py:n_major, copied once
// per layer by the plan), so a chunk is 16-byte pieces of weight rows.
// Packed int4 stays packed in shared memory: a chunk is 32 packed columns
// k' whose low nibbles are levels k' and high nibbles levels K/2 + k' (the
// packing's halves), so the first k32 step multiplies x columns k' by the
// low nibbles and the second x columns K/2 + k' by the high ones, unpacked
// into the mma fragment in registers; each packed byte is read once. The
// float front end copies raw x into its stage, and the block quantizes it
// into an int8 tile before the product. Ragged M, N and K are zero-filled
// (src-size 0), so the wrapper pads nothing (the JAX wrappers pad K to 256
// or 128, M and N to their tiles; zero levels add nothing); rows that are
// not whole 16-byte pieces take byte copies into the same tiles. Integer
// sums are exact. The epilogue is f32: acc * scale, then + bias (two
// roundings, -fmad=false), then the cast or the requant (rintf, half to
// even).
//
// Bound on this card at ViT-B/16's layer shapes (M = 1664): int4 fc1 with
// f32 out moves ~22.9 MB (6.8 us at 3.35 TB/s: bytes); int4 fc2 does
// 7.85 G int8 ops (4.0 us at 1,979 TOPS: operations). This version uses
// mma.sync without wgmma or TMA, so it runs well below either.

#include "qvt_common.cuh"

namespace {

constexpr int BM = 128, BN = 128, BKL = 64, NT = 256;
constexpr int SA = BKL + 16;  // int8 tile row stride (bytes), conflict-free
constexpr int SB = BKL + 16;  // weight tile row stride (packed: 32 used)

struct Args {
  const void* x;
  const int8_t* w;  // n-major: [N][K] int8 or [N][K/2] packed int4
  int w4;
  const float* scale;  // [N]
  const float* bias;   // [N] or null
  const float* prm;    // float front end: d, t
  const int* top;      // float front end: the clamp level
  void* out;
  int out_dt;
  int requant;
  float requant_top;
  int M, K, N;
  int act_pow;
  bool x_vec, w_vec;  // rows are whole 16-byte pieces, bases aligned
};

template <typename TX>
__host__ __device__ constexpr int esize() {
  return static_cast<int>(sizeof(TX));
}

// raw x tile row stride (bytes) of one stage
template <typename TX>
__host__ __device__ constexpr int raw_stride() {
  return BKL * esize<TX>() + 16;
}

template <typename TX>
__host__ __device__ constexpr int smem_bytes() {
  // two stages of { raw x [BM][raw] | weight [BN][SB] }, and for a float x
  // the quantized int8 tile [BM][SA]
  return 2 * (BM * raw_stride<TX>() + BN * SB) +
         (sizeof(TX) == 1 ? 0 : BM * SA);
}

// _fa_quant (int4_matmul.py:326-343) on one element
__device__ __forceinline__ int8_t fa_quant(float x, float d, float t,
                                           float top, bool pow_map) {
  const float ax = fabsf(x);
  const float p = pow_map ? expf(t * logf(fmaxf(ax, 1e-30f))) : ax;
  const float lv = fminf(rintf(p / d), top);
  const float s = x > 0.f ? 1.f : (x < 0.f ? -1.f : 0.f);
  return static_cast<int8_t>(static_cast<int>(s * lv));
}

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename TX>
__global__ void __launch_bounds__(NT) int_mm_kernel(Args a) {
  extern __shared__ __align__(16) int8_t smem[];
  constexpr int ES = esize<TX>(), RA = raw_stride<TX>();
  constexpr int E = 16 / ES;  // x elements per 16-byte piece
  constexpr int STAGE = BM * RA + BN * SB;
  int8_t* aq = smem + 2 * STAGE;  // float x: the quantized tile

  const int M = a.M, K = a.K, N = a.N;
  const int kh = K >> 1;
  const int m_base = blockIdx.y * BM, n_base = blockIdx.x * BN;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = (warp >> 2) * 64, wn = (warp & 3) * 32;
  const bool w4 = a.w4 != 0;
  const int n_chunks = w4 ? (kh + 31) / 32 : (K + BKL - 1) / BKL;
  const TX* x = static_cast<const TX*>(a.x);

  // x column of tile column c (0..63) in chunk ch, and whether it exists:
  // int4 pairs tile columns 0..31 with k' and 32..63 with K/2 + k'
  auto x_col = [&](int ch, int c, int& col) -> bool {
    if (w4) {
      const int kp = ch * 32 + (c & 31);
      col = c < 32 ? kp : kh + kp;
      return kp < kh;
    }
    col = ch * BKL + c;
    return col < K;
  };

  auto load = [&](int ch, int8_t* st) {
    int8_t* xs = st;
    int8_t* ws = st + BM * RA;
    constexpr int XP = BKL / E;  // x pieces per tile row
    for (int i = threadIdx.x; i < BM * XP; i += NT) {
      const int r = i / XP, c = (i - r * XP) * E;
      const int row = m_base + r;
      int8_t* dst = xs + r * RA + c * ES;
      int col;
      if (a.x_vec) {
        const bool ok = x_col(ch, c, col) && row < M;
        qvt::cp_async16(dst, ok ? x + static_cast<long long>(row) * K + col
                                : x,
                        ok);
      } else {
        for (int j = 0; j < E; ++j) {
          TX* d = reinterpret_cast<TX*>(dst) + j;
          *d = (x_col(ch, c + j, col) && row < M)
                   ? x[static_cast<long long>(row) * K + col]
                   : TX(0.f);
        }
      }
    }
    // weight: BN rows of 64 bytes (int8) or 32 packed bytes (int4)
    const int wp = w4 ? 2 : 4, ldw = w4 ? kh : K, kb = ch * (w4 ? 32 : 64);
    for (int i = threadIdx.x; i < BN * wp; i += NT) {
      const int nn = i / wp, c = (i - nn * wp) * 16;
      const int n = n_base + nn, k = kb + c;
      int8_t* dst = ws + nn * SB + c;
      const int8_t* src = a.w + static_cast<long long>(n) * ldw + k;
      if (a.w_vec) {
        const bool ok = n < N && k < ldw;
        qvt::cp_async16(dst, ok ? src : a.w, ok);
      } else {
        for (int j = 0; j < 16; ++j)
          dst[j] = (n < N && k + j < ldw) ? src[j] : int8_t(0);
      }
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };

  int acc[4][4][4];
  qvt::zero_acc(acc);
  const float d = a.prm ? a.prm[0] : 1.f, tq = a.prm ? a.prm[1] : 1.f;
  const float top = a.top ? static_cast<float>(a.top[0]) : 0.f;

  if (n_chunks > 0) load(0, smem);
  for (int ch = 0; ch < n_chunks; ++ch) {
    int8_t* st = smem + (ch & 1) * STAGE;
    if (ch + 1 < n_chunks) {
      load(ch + 1, smem + ((ch + 1) & 1) * STAGE);
      asm volatile("cp.async.wait_group 1;\n" ::);
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::);
    }
    __syncthreads();
    const int8_t* As = st;
    if constexpr (ES > 1) {
      // the float front end: quantize the raw tile, four levels a word
      for (int i = threadIdx.x; i < BM * (BKL / 4); i += NT) {
        const int r = i / (BKL / 4), c = (i - r * (BKL / 4)) * 4;
        const TX* src = reinterpret_cast<const TX*>(st + r * RA) + c;
        uint32_t v = 0;
#pragma unroll
        for (int u = 0; u < 4; ++u)
          v |= static_cast<uint32_t>(static_cast<uint8_t>(
                   fa_quant(to_f(src[u]), d, tq, top, a.act_pow)))
               << (8 * u);
        *reinterpret_cast<uint32_t*>(aq + r * SA + c) = v;
      }
      __syncthreads();
      As = aq;
    }
    const int8_t* Bs = st + BM * RA;
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {
      uint32_t af[4][4], bf[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int8_t* p = As + (wm + i * 16 + g) * SA + ks * 32 + t * 4;
        af[i][0] = *reinterpret_cast<const uint32_t*>(p);
        af[i][1] = *reinterpret_cast<const uint32_t*>(p + 8 * SA);
        af[i][2] = *reinterpret_cast<const uint32_t*>(p + 16);
        af[i][3] = *reinterpret_cast<const uint32_t*>(p + 8 * SA + 16);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int8_t* q =
            Bs + (wn + j * 8 + g) * SB + (w4 ? 0 : ks * 32) + t * 4;
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(q);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(q + 16);
        bf[j][0] = w4 ? qvt::nibbles(b0, ks == 1) : b0;
        bf[j][1] = w4 ? qvt::nibbles(b1, ks == 1) : b1;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          qvt::mma_s8(acc[i][j], af[i][0], af[i][1], af[i][2], af[i][3],
                      bf[j][0], bf[j][1]);
    }
    __syncthreads();  // the stage (and the quantized tile) is free again
  }

#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int row = m_base + wm + i * 16 + g + (r >= 2 ? 8 : 0);
        const int col = n_base + wn + j * 8 + t * 2 + (r & 1);
        if (row >= M || col >= N) continue;
        const long long o = static_cast<long long>(row) * N + col;
        float v = static_cast<float>(acc[i][j][r]) * a.scale[col];
        if (a.bias) v = v + a.bias[col];
        if (a.requant)
          static_cast<int8_t*>(a.out)[o] = qvt::clip_round(v, a.requant_top);
        else
          qvt::store_f(a.out, a.out_dt, o, v);
      }
}

template <typename TX>
int launch(Args& a, cudaStream_t stream) {
  constexpr int es = esize<TX>();
  const int kh = a.K >> 1;
  const bool x_al = (reinterpret_cast<uintptr_t>(a.x) & 15) == 0;
  const bool w_al = (reinterpret_cast<uintptr_t>(a.w) & 15) == 0;
  a.x_vec = x_al && (a.K * es) % 16 == 0 && (!a.w4 || (kh * es) % 16 == 0);
  a.w_vec = w_al && (a.w4 ? kh % 16 == 0 : a.K % 16 == 0);
  constexpr int smem = smem_bytes<TX>();
  cudaError_t e = cudaFuncSetAttribute(
      int_mm_kernel<TX>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid((a.N + BN - 1) / BN, (a.M + BM - 1) / BM);
  int_mm_kernel<TX><<<grid, NT, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x_dt: int8 levels (int4_matmul, int8_matmul) or f32/bf16 (quant_matmul_fa,
// which needs prm = [d, t] and top); requant: int8 out clipped to
// +-requant_top, else out_dt (f32 or bf16)
extern "C" int qvt_int_matmul(const void* x, int x_dt, const void* w,
                              int w_int4, const void* scale, const void* bias,
                              const void* prm, const void* top, void* out,
                              int out_dt, int requant, int requant_top, int M,
                              int K, int N, int act_pow, void* stream) {
  if ((w_int4 && K % 2) || (x_dt != qvt::DT_INT8 && (!prm || !top)))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.x = x;
  a.w = static_cast<const int8_t*>(w);
  a.w4 = w_int4;
  a.scale = static_cast<const float*>(scale);
  a.bias = static_cast<const float*>(bias);
  a.prm = x_dt == qvt::DT_INT8 ? nullptr : static_cast<const float*>(prm);
  a.top = x_dt == qvt::DT_INT8 ? nullptr : static_cast<const int*>(top);
  a.out = out;
  a.out_dt = out_dt;
  a.requant = requant;
  a.requant_top = static_cast<float>(requant_top);
  a.M = M;
  a.K = K;
  a.N = N;
  a.act_pow = act_pow;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_dt == qvt::DT_F32) return launch<float>(a, st);
  if (x_dt == qvt::DT_BF16) return launch<__nv_bfloat16>(a, st);
  return launch<int8_t>(a, st);
}

// K16, K17, K20, K21: the fc1 timing ablations of the root tools, for
// Hopper (sm_90a).
//
// Replaces four TPU kernels that each time K1's fc1 GEMM with one piece
// changed (ops/ablations.py maps every mode name to its function):
//   K16 tools/exp_pro.py:kernel (pallas_call, exp_pro.py:99): a prologue
//       variant, then the erf-GELU quant epilogue;
//   K17 tools/exp_pro2.py:kernel (exp_pro2.py:146): the LayerNorm fc1
//       with a vector scale, a bias, runtime tops and K1's folded forms;
//   K20 tools/exp_epilogue.py:variant_kernel (exp_epilogue.py:103): packed
//       int4 weights, an epilogue variant;
//   K21 tools/exp_fc1.py:kernel (exp_fc1.py:106): int8 levels in, an
//       epilogue variant.
// The function:
//   lv  = prologue(x)     int8 levels in place | clip(round(x), +-top) |
//                         LayerNorm (two moments) * g + b, rounded, clipped
//   acc = lv @ W          int8 x int8 -> int32 (W int8 or packed int4)
//   y   = acc * scale (+ bias)   scale a scalar or an [N] vector
//   out = epilogue(y)     one of twelve variants (EP_* below), int8
//
// Bound on this card (each input read once, each output written once;
// 1,979 TOPS int8, 3.35 TB/s) at the tools' shapes:
//   K16, K17, K21  7168 x 768 x 3072: 33.8 G ops, 17.1 us; bytes 35.4 MB
//                  with bf16 x (10.6 us), 29.9 MB with int8 x (8.9 us)
//   K20            1664 x 768 x 3072, packed int4: 7.85 G ops, 3.97 us;
//                  7.57 MB (2.26 us)
// All four are bound by operations.
//
// Design: K1's (fused_quant_matmul.cu) without its depth splits, built
// from K1's shared pieces so that the times read as stage costs of K1's
// design. One launch of a persistent grid, at most two blocks of 256
// threads an SM. With a float prologue it is cooperative: phase 1 writes
// the levels once a row into a scratch [M][K] (gemm_phases.cuh:
// row_levels, a warp a row), a grid barrier, then phase 2: the GEMM over
// 128 x 128 output tiles (int8_gemm.cuh:gemm_tile: a three-stage cp.async
// ring, ldmatrix, mma.sync m16n8k32 s8; packed int4 takes its nibbles per
// fragment), the accumulators staged in shared memory (gemm_phases.cuh:
// stage_acc), the epilogue by rows, 8 threads a row, four levels stored
// at a time. With int8 levels in, phase 2 reads x in place (a plain
// launch). Each (prologue, epilogue) pair the tools use is one
// instantiation, the epilogue a template argument as in K1 and K2 (a
// runtime switch inside an unrolled epilogue cost K2 a third of a phase).
//
// Numerics: those of the plain version (ops/ablations.py:
// fc1_ablation_plain), built with -fmad=false: the LayerNorm sums in f64
// rounded once, 1/sqrtf, rintf; the GEMM exact; every epilogue the tool's
// f32 arithmetic in the tool's order. The magic rounding is an add and a
// subtract (__fadd_rn: never contracted or folded), round half to even
// as on the TPU. tanhf and expf are the CUDA library's, as PyTorch's tanh
// and sigmoid on the card call them; the bf16 erf rounds to bf16 after
// every operation, as PyTorch's bf16 tensors do.

#include <cooperative_groups.h>

#include <algorithm>

#include "gemm_phases.cuh"
#include "int8_gemm.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int NT = 256;
constexpr int TILE = 128, WM = TILE / 2, WN = TILE / 4;
constexpr int BK = qvt::GT_BK;
constexpr int LN_T = 32;  // threads a prologue row

// codes of ops/ablations.py:FC1_PROLOGUES and FC1_EPILOGUES
enum { PRO_LEVELS = 0, PRO_QUANT = 1, PRO_LN = 2 };
enum {
  EP_TRUNC = 0,           // exp_fc1 none: the f32 -> int8 cast
  EP_ROUND = 1,           // clip(round(y / d))
  EP_MAGIC = 2,           // the same, rounded by the magic add
  EP_GELU_ERF = 3,        // the tools' erf-GELU on z = clip(y/sqrt2, +-3)
  EP_GELU_ERF_MAGIC = 4,  // the same, magic
  EP_GELU_TANH = 5,       // tanh GELU, magic
  EP_GELU_SIG = 6,        // y * sigmoid(1.702 y), magic
  EP_GELU_BF16 = 7,       // the erf polynomial in bf16, magic
  EP_GELU7 = 8,           // fused.py:_gelu_f32, round
  EP_GELU7_MAGIC = 9,     // the same, magic
  EP_GELU5 = 10,          // a five-coefficient erf, clipped, magic
  EP_FOLDED = 11          // fused.py:_gelu_quant_folded on y as z
};

// the tools' constants, as f32 roundings of their Python doubles
constexpr float C2 = static_cast<float>(0.7071067811865476);  // 2^-0.5
constexpr float T1 = static_cast<float>(0.7978845608);
constexpr float T3 = static_cast<float>(0.035677408136172);  // T1*0.044715
constexpr float SIG = static_cast<float>(1.702);
// exp_epilogue.py's gelu5 erf coefficients, E0 first
constexpr float E0 = static_cast<float>(1.128241);
constexpr float E1 = static_cast<float>(-0.37356343);
constexpr float E2 = static_cast<float>(0.10320428);
constexpr float E3 = static_cast<float>(-0.016230284);
constexpr float E4 = static_cast<float>(0.0010670409);
constexpr float MAGIC = 12582912.0f;  // 1.5 * 2^23

struct Args {
  // phase 1 (gemm_phases.cuh:row_levels reads these names)
  const void* x;
  int x_dt;
  int M, K, Kp, ln_t;
  const float* ln_g;
  const float* ln_b;
  const float* prm;  // the prologue quantizer's d and t (1, 1)
  float act_top, eps;
  bool x_vec;
  int8_t* lv;  // scratch [M][K] (float prologues)
  // phase 2
  qvt::WeightT w;
  bool w_vec;
  int N, tiles;
  const float* scale;  // [N], or null: scale_s
  const float* bias;   // [N] or null
  float scale_s, inv_d, c2, out_top;
  int8_t* out;
};

__device__ __forceinline__ float magic(float v) {
  return __fadd_rn(__fadd_rn(v, MAGIC), -MAGIC);
}

__device__ __forceinline__ float bfr(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ uint32_t clip8(float r, float top) {
  return static_cast<uint8_t>(static_cast<int8_t>(
      static_cast<int>(fminf(fmaxf(r, -top), top))));
}

// the level of y under epilogue EP (ops/ablations.py:fc1_epilogue_plain)
template <int EP>
__device__ __forceinline__ uint32_t level(float y, const Args& a) {
  const float inv_d = a.inv_d, top = a.out_top;
  if constexpr (EP == EP_TRUNC) {
    return static_cast<uint8_t>(static_cast<int8_t>(static_cast<int>(y)));
  } else if constexpr (EP == EP_ROUND) {
    return clip8(rintf(y * inv_d), top);
  } else if constexpr (EP == EP_MAGIC) {
    return clip8(magic(y * inv_d), top);
  } else if constexpr (EP == EP_GELU_ERF || EP == EP_GELU_ERF_MAGIC) {
    const float z = fminf(fmaxf(y * C2, -3.0f), 3.0f);
    const float e = qvt::erf_poly(z);
    const float w = z * C2 * inv_d;
    const float r = w + w * e;
    return clip8(EP == EP_GELU_ERF ? rintf(r) : magic(r), top);
  } else if constexpr (EP == EP_GELU_TANH) {
    const float y2 = y * y;
    const float t = tanhf(y * (T1 + T3 * y2));
    return clip8(magic(y * inv_d * 0.5f * (1.0f + t)), top);
  } else if constexpr (EP == EP_GELU_SIG) {
    const float s = 1.0f / (1.0f + expf(-(SIG * y)));
    return clip8(magic(y * s * inv_d), top);
  } else if constexpr (EP == EP_GELU_BF16) {
    const float z = bfr(fminf(fmaxf(y * C2, -3.0f), 3.0f));
    const float z2 = bfr(z * z);
    float acc = bfr(1.6343068626e-04f);
    acc = bfr(bfr(acc * z2) + bfr(-4.6024812456e-03f));
    acc = bfr(bfr(acc * z2) + bfr(5.0755384214e-02f));
    acc = bfr(bfr(acc * z2) + bfr(-2.8632930819e-01f));
    acc = bfr(bfr(acc * z2) + bfr(1.0820510812e+00f));
    const float e = bfr(acc * z);
    const float w = y * (0.5f * inv_d);
    return clip8(magic(w + w * e), top);
  } else if constexpr (EP == EP_GELU7) {
    return clip8(rintf(qvt::gelu(y) * inv_d), top);
  } else if constexpr (EP == EP_GELU7_MAGIC) {
    return clip8(magic(qvt::gelu(y) * inv_d), top);
  } else if constexpr (EP == EP_GELU5) {
    const float v = fminf(fmaxf(y * C2, -3.0f), 3.0f);
    const float v2 = v * v;
    float acc = E4;
    acc = acc * v2 + E3;
    acc = acc * v2 + E2;
    acc = acc * v2 + E1;
    acc = acc * v2 + E0;
    const float erf = fminf(fmaxf(acc * v, -1.0f), 1.0f);
    return clip8(magic(y * 0.5f * (1.0f + erf) * inv_d), top);
  } else {
    return static_cast<uint8_t>(qvt::gelu_quant_folded_c2(y, a.c2, top));
  }
}

// The epilogue of a staged 128 x 128 tile: y = acc * scale (+ bias), its
// levels; a row to 8 threads, each a 4-column group at a time (N % 4 ==
// 0: whole groups), scale and bias as float4, four levels a store.
template <int EP>
__device__ __forceinline__ void store_tile(const Args& a, const int* stage,
                                           int row0, int col0) {
  constexpr int RS = TILE + qvt::STAGE_PAD;
  const int q = threadIdx.x & 7;
  for (int r = threadIdx.x >> 3; r < TILE; r += NT / 8) {
    const int row = row0 + r;
    if (row >= a.M) continue;
#pragma unroll
    for (int s = 0; s < TILE / 32; ++s) {
      const int c = 32 * s + 4 * q, col = col0 + c;
      if (col >= a.N) continue;
      const int4 v = *reinterpret_cast<const int4*>(stage + r * RS + c);
      float y[4] = {static_cast<float>(v.x), static_cast<float>(v.y),
                    static_cast<float>(v.z), static_cast<float>(v.w)};
      if (a.scale) {
        const float4 s4 =
            __ldg(reinterpret_cast<const float4*>(a.scale + col));
        y[0] = y[0] * s4.x, y[1] = y[1] * s4.y, y[2] = y[2] * s4.z;
        y[3] = y[3] * s4.w;
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) y[e] = y[e] * a.scale_s;
      }
      if (a.bias) {
        const float4 b4 = __ldg(reinterpret_cast<const float4*>(a.bias + col));
        y[0] = y[0] + b4.x, y[1] = y[1] + b4.y, y[2] = y[2] + b4.z;
        y[3] = y[3] + b4.w;
      }
      *reinterpret_cast<uint32_t*>(
          a.out + static_cast<long long>(row) * a.N + col) =
          level<EP>(y[0], a) | level<EP>(y[1], a) << 8 |
          level<EP>(y[2], a) << 16 | level<EP>(y[3], a) << 24;
    }
  }
  __syncthreads();  // the next tile's loads reuse the stage
}

template <int PRO, int EP>
__global__ void __launch_bounds__(NT, 2) fc1_kernel(Args a) {
  extern __shared__ __align__(16) int8_t smem[];
  if constexpr (PRO != PRO_LEVELS) {  // a cooperative launch
    qvt::row_levels<PRO == PRO_LN ? qvt::ROWS_LN : qvt::ROWS_QUANT, false,
                    NT>(a);
    cg::this_grid().sync();
  }
  const int8_t* A =
      PRO == PRO_LEVELS ? static_cast<const int8_t*>(a.x) : a.lv;
  const int nkt = (a.K + BK - 1) / BK, tn = (a.N + TILE - 1) / TILE;
  for (int it = blockIdx.x; it < a.tiles; it += gridDim.x) {
    const int row0 = it / tn * TILE, col0 = it % tn * TILE;
    int acc[WM / 16][WN / 8][4];
    qvt::gemm_tile<TILE, TILE, WM, WN, NT>(acc, A, a.K, a.M, a.w, a.w_vec,
                                           row0, col0, 0, nkt, smem);
    int* stage = reinterpret_cast<int*>(smem);
    qvt::stage_acc<TILE, TILE>(acc, stage);
    store_tile<EP>(a, stage, row0, col0);
  }
}

template <int PRO, int EP>
cudaError_t launch(Args& a, int sms, cudaStream_t st) {
  auto kern = fc1_kernel<PRO, EP>;
  constexpr int smem = qvt::gemm_ring_bytes(TILE, TILE);
  static int per_sm = -1;
  if (per_sm < 0) {
    int v = 0;
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&v, kern, NT, smem);
    if (e != cudaSuccess) return e;
    per_sm = std::min(v, 2);
  }
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  // enough blocks for the larger phase: row groups, output tiles
  int want = a.tiles;
  if (PRO != PRO_LEVELS)
    want = std::max(want, (a.M + NT / LN_T - 1) / (NT / LN_T));
  const int grid = std::min(per_sm * sms, want);
  if (PRO == PRO_LEVELS) {
    kern<<<grid, NT, smem, st>>>(a);
    return cudaGetLastError();
  }
  void* args[] = {&a};
  cudaError_t e = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(kern),
                                              dim3(grid), dim3(NT), args,
                                              smem, st);
  return e != cudaSuccess ? e : cudaGetLastError();
}

}  // namespace

// x [M][K]: int8 levels (prologue 0; read in place: 16-byte aligned) or
// bf16/f32 (1: quant, 2: LayerNorm with ln_g, ln_b [K]); w: the n-major
// levels of a K x N weight ([N][K] int8, or packed int4 [N][K/2]);
// scale_v [N] or null (then scale_s); bias [N] or null; prm: the
// prologue quantizer's d and t, both 1.0 (f32 device memory); lv:
// scratch [M][K] for prologues 1 and 2; out [M][N] int8. K % 16 == 0
// (packed int4: K/2 % 16 == 0), N % 4 == 0; every vector 16-byte
// aligned. Returns cudaErrorInvalidValue for a pair of prologue and
// epilogue it is not built for (ops/ablations.py:FC1_BUILT).
extern "C" int qvt_fc1_ablation(const void* x, int x_dt, const void* w,
                                int w_int4, int K, const void* scale_v,
                                const void* bias, const void* ln_g,
                                const void* ln_b, const void* prm, void* lv,
                                float scale_s, float inv_d, float out_d,
                                float eps, void* out, int M, int N,
                                int prologue, int epilogue, int act_top,
                                int out_top, int sms, void* stream) {
  auto mis16 = [](const void* p) {
    return (reinterpret_cast<uintptr_t>(p) & 15) != 0;
  };
  const bool lev = prologue == PRO_LEVELS;
  if (M < 1 || K < 16 || K % 16 || (w_int4 && (K / 2) % 16) || N < 4 ||
      N % 4 || sms < 1 || mis16(x) || mis16(w) || mis16(scale_v) ||
      mis16(bias) || (reinterpret_cast<uintptr_t>(out) & 3) ||
      (lev != (x_dt == qvt::DT_INT8)) ||
      (!lev && x_dt != qvt::DT_BF16 && x_dt != qvt::DT_F32) ||
      (!lev && (lv == nullptr || mis16(lv) || prm == nullptr)) ||
      (prologue == PRO_LN &&
       (ln_g == nullptr || ln_b == nullptr || mis16(ln_g) || mis16(ln_b))) ||
      (epilogue == EP_FOLDED && !(out_d > 0.f)))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.x = x;
  a.x_dt = x_dt;
  a.M = M;
  a.K = K;
  a.Kp = K;
  a.ln_t = LN_T;
  a.ln_g = static_cast<const float*>(ln_g);
  a.ln_b = static_cast<const float*>(ln_b);
  a.prm = static_cast<const float*>(prm);
  a.act_top = static_cast<float>(act_top);
  a.eps = eps;
  a.x_vec = !lev;  // bf16 or f32 rows of whole 16-byte pieces (K % 16)
  a.lv = static_cast<int8_t*>(lv);
  a.w = qvt::WeightT{static_cast<const int8_t*>(w), K, N, w_int4};
  a.w_vec = true;  // K % 16, K/2 % 16 (int4), aligned: checked above
  a.N = N;
  a.tiles = (M + TILE - 1) / TILE * ((N + TILE - 1) / TILE);
  a.scale = static_cast<const float*>(scale_v);
  a.bias = static_cast<const float*>(bias);
  a.scale_s = scale_s;
  a.inv_d = inv_d;
  a.c2 = 0.70710678118654757f / out_d;  // fused.py:_gelu_quant_folded
  a.out_top = static_cast<float>(out_top);
  a.out = static_cast<int8_t*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define QVT_FC1(P, E)               \
  if (prologue == P && epilogue == E) \
  return static_cast<int>(launch<P, E>(a, sms, st))
  QVT_FC1(PRO_LEVELS, EP_TRUNC);
  QVT_FC1(PRO_LEVELS, EP_ROUND);
  QVT_FC1(PRO_LEVELS, EP_MAGIC);
  QVT_FC1(PRO_LEVELS, EP_GELU_ERF);
  QVT_FC1(PRO_LEVELS, EP_GELU_ERF_MAGIC);
  QVT_FC1(PRO_LEVELS, EP_GELU_TANH);
  QVT_FC1(PRO_LEVELS, EP_GELU_SIG);
  QVT_FC1(PRO_LEVELS, EP_GELU_BF16);
  QVT_FC1(PRO_LEVELS, EP_GELU7);
  QVT_FC1(PRO_LEVELS, EP_GELU7_MAGIC);
  QVT_FC1(PRO_LEVELS, EP_GELU5);
  QVT_FC1(PRO_QUANT, EP_GELU_ERF);
  QVT_FC1(PRO_LN, EP_GELU_ERF);
  QVT_FC1(PRO_LN, EP_FOLDED);
#undef QVT_FC1
  return static_cast<int>(cudaErrorInvalidValue);
}

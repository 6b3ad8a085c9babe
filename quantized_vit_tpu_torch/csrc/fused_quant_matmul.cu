// K1: fused quantized matmul for Hopper (sm_90a).
//
// Replaces the TPU kernel quantized_vit_tpu/ops/fused.py:_fused_kernel
// (pallas_call in _fused_quant_matmul, fused.py:556):
//   lv  = prologue(x)            none (int8 levels) | quant | ln_quant |
//                                gelu_quant, f32 level math
//   acc = lv @ W                 int8 x int8 -> int32 (W int8 levels, or
//                                packed int4)
//   out = epilogue(acc*scale+bias)   none | residual | quant | gelu_quant
// x [M, K]; W [K, N] in the plan's n-major layout ([N][Kw] or packed
// [N][Kw/2], Kw = K, or K rounded up to 64 with zero levels past K:
// ops/fused.py:plan_matmul's padded copy).
//
// Bound on this card (each input read once, each output written once;
// 1,979 TOPS int8, 3.35 TB/s), at the forwards' sites:
//   ViT-B patch embed b32  6272 x 768 x 768, f32 in/out     39.1 MB 11.68 us
//   ViT-B proj b32         6656 x 768 x 768, + bf16 res     26.2 MB  7.81 us
//   ViT-B head b32 / b1    32 / 1 x 768 x 1000, f32        1.0 / 0.4 MB
//                                                        0.30 / 0.12 us
//   ViT-B chain qkv b1-b3  208-624 x 768 x 2304, bf16      3.1-5.6 MB
//                                                          0.91-1.67 us
//   ViT-B chain proj b1-b3 208-624 x 768 x 768, + res      1.4-3.0 MB
//                                                          0.41-0.89 us
//   ViT-H patch embed b32  8192 x 588 x 1280, f32          62.0 MB 18.50 us
//   ViT-H chain qkv b1/b2  272 / 544 x 1280 x 3840      7.7 / 10.5 MB
//                                                        2.30 / 3.13 us
//   ViT-H fc1 b32          8704 x 1280 x 5120, LN -> GELU-quant:
//                          114.1 G ops                           57.65 us
//   ViT-H fc2 b32          8704 x 5120 x 1280, + res: 114.1 G ops 57.65 us
// So the embeds, the proj and the small-batch sites are bound by bytes,
// the ViT-H MLP GEMMs by operations.
//
// Design: one launch of a persistent grid (at most two blocks of 256
// threads an SM), in two phases.
//   1. With a prologue: the prologue once per row, into a level scratch lv
//      [M, Kp] (Kp = K rounded up to 64, zero levels past K), a row to a
//      group of 8 to 256 threads (gemm_phases.cuh:row_levels, K2's), then
//      a grid barrier (a cooperative launch). It reads x once (19.3 MB of
//      f32 at the ViT-B embed, 22.3 MB of bf16 at ViT-H fc1) and writes
//      M * Kp bytes (4.8 MB, 11.1 MB). The first K1 ran the prologue (the
//      LayerNorm statistics over the whole K included) once per 64-column
//      output tile: 80 times a row at ViT-H fc1, 36 at the chain qkv.
//      Prologue None reads x's levels in place (K % 16 == 0, 16-byte
//      aligned: every site above): no phase 1, no barrier, a plain launch.
//      Off that path phase 1 copies the levels into the scratch.
//   2. The GEMM on the int8 tensor cores (int8_gemm.cuh:gemm_tile, K3's
//      and K2's: a three-stage cp.async ring of 128-deep steps, ldmatrix,
//      mma.sync m16n8k32 s8; packed int4 takes its nibbles per fragment)
//      over 128 x 128 or 64 x 64 output tiles. The accumulators are staged
//      in shared memory (gemm_phases.cuh:stage_acc) and the epilogue runs
//      by rows, 8 threads a row, with whole 16-byte loads of scale, bias
//      and the residual and whole stores of out (4 levels, or 4 bf16 or
//      f32 values). The first K1 stored single elements from the MMA
//      fragments at stride N.
// The work split (ops/fused.py:matmul_layout, from M, K, N and the card's
// SMs): the 128 x 128 tile where its tiles fill the grid, else 64 x 64;
// the tiles left after whole waves split their depth S ways
// (gemm_phases.cuh:split_reduce: int32 partial tiles, the last split to
// arrive adds the others'; its arrival count wraps back to zero, so the
// counts, which the wrapper keeps zeroed once, need no reset between
// launches) only where that shortens the longest block's work by more
// than a split costs: at the forwards' sites only ViT-H's 1280-deep
// chain qkv splits. At a 768-deep K a split's partial tile costs more
// than idle SMs do (tools/matmul_design.py): the batch-1 chain proj runs
// 48 whole 64 x 64 tiles, which beat 240 split items (the first K1 ran
// the same 48 blocks, with synchronous 64-deep steps). The byte-wise B
// path (a weight off the 16-byte path, K = 588 at ViT-H's embed) is off
// the forwards: the embed's plan pads its own copy to Kp with zero
// levels (packed int4 re-packed at Kp), and the scratch's zero columns
// meet them; the byte-wise path stays for any other width.
//
// Numerics: those of the plain version (ops/fused.py:
// fused_quant_matmul_plain): the levels are exact (f64 sums rounded once,
// -fmad=false, rintf), the int32 GEMM is exact, split or not, and the
// epilogue is the plain version's f32 arithmetic in its order.

#include <cooperative_groups.h>

#include <algorithm>

#include "gemm_phases.cuh"
#include "int8_gemm.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int NT = 256;
// the GEMM tiles (BM = BN), each of 2 x 4 warps of BM/2 x BN/4
constexpr int TILE_L = 128, TILE_S = 64;
constexpr int BK = qvt::GT_BK;
// the prologue's group of threads a row: LN_MIN_T .. NT, a power of two
constexpr int LN_MIN_T = 8;

// prologue codes (ops/fused.py:_PROLOGUES); PRO_COPY: int8 levels that
// cannot be read in place, copied into the scratch
enum { PRO_NONE = 0, PRO_QUANT = 1, PRO_LN = 2, PRO_GELU = 3, PRO_COPY = 4 };
// epilogue codes (ops/fused.py:_EPILOGUES)
enum { EPI_NONE = 0, EPI_RES = 1, EPI_QUANT = 2, EPI_GELU = 3 };
// the kernel's epilogue kinds: float out (none, or + a residual), levels
enum { OUT_FLOAT = 0, OUT_QUANT = 1, OUT_GELU = 2 };

struct Args {
  const void* x;
  int x_dt;
  qvt::WeightT w;  // Kw x N levels, n-major: [N][Kw] or packed [N][Kw/2]
  const float* scale;
  const float* bias;  // or null
  const float* ln_g;
  const float* ln_b;
  const void* res;  // or null
  int res_dt;
  const float* prm;  // act_d, act_t, out_d, out_t
  int8_t* lv;        // scratch: the levels [M][Kp] (null: x in place)
  int* part;         // scratch: int32 partial tiles, one a split
  int* cnt;          // arrivals a split tile, zero between launches
  void* out;
  int out_dt;
  int M, K, N, Kp;
  int pro, ln_t, S, tiles, full;
  int act_pow;
  float act_top, out_top, eps;
  bool x_vec, w_vec, quad;
};

// Phase 1: the levels of the prologue into a.lv (gemm_phases.cuh)
__device__ __forceinline__ void prologue(const Args& a) {
  switch (a.pro) {
    case PRO_QUANT:
      if (a.act_pow)
        qvt::row_levels<qvt::ROWS_QUANT, true, NT>(a);
      else
        qvt::row_levels<qvt::ROWS_QUANT, false, NT>(a);
      break;
    case PRO_LN:
      if (a.act_pow)
        qvt::row_levels<qvt::ROWS_LN, true, NT>(a);
      else
        qvt::row_levels<qvt::ROWS_LN, false, NT>(a);
      break;
    case PRO_GELU:
      qvt::row_levels<qvt::ROWS_GELU, false, NT>(a);
      break;
    default:
      qvt::row_levels<qvt::ROWS_COPY, false, NT>(a);
  }
}

// The epilogue of a staged BM x BN tile (fused.py:_fused_kernel's, in the
// plain version's f32 order): v = acc * scale (+ bias); OUT_FLOAT: v (+
// the residual) in the output dtype; OUT_QUANT: the levels of v (POW: the
// pow quantizer; else linear, 1/d folded into scale and bias by the
// plan); OUT_GELU: the folded GELU-quant of v (2^-0.5 folded by the
// plan), or POW: GELU, then the pow quantizer. A row to 8 threads, each a
// 4-column group at a time; a.quad (N % 4 == 0, every operand aligned to
// 4 elements, scale and bias to 16 bytes): whole 4-element loads and
// stores. The residual is read through the read-only path (qvt::ldg4), so
// the compiler may start a later group's load before an earlier group's
// store: with plain loads each waited for the stores before it (a store
// to out could alias it, for all the compiler knows), about 13 us a 128 x
// 128 tile (tools/phase_probe.py).
template <int BM, int BN, int OUT, bool POW>
__device__ __forceinline__ void store_tile(const Args& a, const int* stage,
                                           int row0, int col0) {
  constexpr int RS = BN + qvt::STAGE_PAD;
  const float out_d = a.prm[2], out_t = a.prm[3];
  const float c2 = 0.70710678118654757f / out_d;
  const int q = threadIdx.x & 7;
  auto level = [&](float v) -> uint32_t {
    if constexpr (OUT == OUT_QUANT)
      return static_cast<uint8_t>(
          qvt::quantize(v, out_d, out_t, a.out_top, POW, !POW));
    else if constexpr (POW)
      return static_cast<uint8_t>(qvt::quantize(
          qvt::gelu(v), out_d, out_t, a.out_top, true, false));
    else
      return static_cast<uint8_t>(
          qvt::gelu_quant_folded_c2(v, c2, a.out_top));
  };
  for (int r = threadIdx.x >> 3; r < BM; r += NT / 8) {
    const int row = row0 + r;
    if (row >= a.M) continue;
#pragma unroll
    for (int s = 0; s < BN / 32; ++s) {
      const int c = 32 * s + 4 * q, col = col0 + c;
      if (col >= a.N) continue;
      const int4 v = *reinterpret_cast<const int4*>(stage + r * RS + c);
      const int acc[4] = {v.x, v.y, v.z, v.w};
      const long long o = static_cast<long long>(row) * a.N + col;
      if (a.quad) {  // the group is in; every operand aligned
        const float4 s4 =
            __ldg(reinterpret_cast<const float4*>(a.scale + col));
        float y[4] = {static_cast<float>(acc[0]) * s4.x,
                      static_cast<float>(acc[1]) * s4.y,
                      static_cast<float>(acc[2]) * s4.z,
                      static_cast<float>(acc[3]) * s4.w};
        if (a.bias) {
          const float4 b4 =
              __ldg(reinterpret_cast<const float4*>(a.bias + col));
          y[0] = y[0] + b4.x, y[1] = y[1] + b4.y, y[2] = y[2] + b4.z;
          y[3] = y[3] + b4.w;
        }
        if constexpr (OUT == OUT_FLOAT) {
          if (a.res) {
            float rv[4];
            qvt::ldg4(a.res, a.res_dt, o, rv);
#pragma unroll
            for (int e = 0; e < 4; ++e) y[e] = y[e] + rv[e];
          }
          qvt::store4(a.out, a.out_dt, o, y);
        } else {
          *reinterpret_cast<uint32_t*>(static_cast<int8_t*>(a.out) + o) =
              level(y[0]) | level(y[1]) << 8 | level(y[2]) << 16 |
              level(y[3]) << 24;
        }
        continue;
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (col + e >= a.N) break;
        float y = static_cast<float>(acc[e]) * __ldg(a.scale + col + e);
        if (a.bias) y = y + __ldg(a.bias + col + e);
        if constexpr (OUT == OUT_FLOAT) {
          if (a.res) y = y + qvt::load_f(a.res, a.res_dt, o + e);
          qvt::store_f(a.out, a.out_dt, o + e, y);
        } else {
          static_cast<int8_t*>(a.out)[o + e] = static_cast<int8_t>(level(y));
        }
      }
    }
  }
  __syncthreads();  // the next item's loads reuse the stage
}

// Phase 2: the GEMM over the BM x BN output tiles, A = the level scratch
// (or x's levels in place): the first a.full tiles whole, one work item
// each, then the other tiles in a.S splits of the depth each
// (consecutive items).
template <int BM, int OUT, bool POW>
__device__ __forceinline__ void gemm_phase(const Args& a, int8_t* smem,
                                           qvt::PhaseClock& clk) {
  constexpr int BN = BM, WM = BM / 2, WN = BN / 4, TM = WM / 16,
                TN = WN / 8;
  const bool direct = a.pro == PRO_NONE;
  const int8_t* A = direct ? static_cast<const int8_t*>(a.x) : a.lv;
  const int lda = direct ? a.K : a.Kp;
  const int S = a.S, full = a.full;
  const int nkt = (lda + BK - 1) / BK, tn = (a.N + BN - 1) / BN;
  const int items = full + (a.tiles - full) * S;
  for (int it = blockIdx.x; it < items; it += gridDim.x) {
    const int q = it - full, tile = it < full ? it : full + q / S;
    const int sp = it < full ? 0 : q - (tile - full) * S;
    const int row0 = tile / tn * BM, col0 = tile % tn * BN;
    const int kt0 = it < full ? 0 : sp * nkt / S;
    const int kt1 = it < full ? nkt : (sp + 1) * nkt / S;
    int acc[TM][TN][4];
    qvt::gemm_tile<BM, BN, WM, WN, NT>(acc, A, lda, a.M, a.w, a.w_vec, row0,
                                       col0, kt0, kt1, smem);
    int* stage = reinterpret_cast<int*>(smem);
    qvt::stage_acc<BM, BN>(acc, stage);
    // a split's partial out; the tile's last split adds the others'
    const bool last = it < full || S == 1 ||
                      qvt::split_reduce<BM, BN, NT>(stage, a.part, a.cnt, q,
                                                    S);
    clk.mark(2);
    if (!last) continue;
    store_tile<BM, BN, OUT, POW>(a, stage, row0, col0);
    clk.mark(3);
  }
}

// T x T output tiles; OUT, POW: the epilogue
template <int T, int OUT, bool POW>
__global__ void __launch_bounds__(NT, 2) fqm_kernel(Args a) {
  extern __shared__ __align__(16) int8_t smem[];
  qvt::PhaseClock clk;  // tools/phase_probe.py fused_quant_matmul
  clk.begin();
  if (a.pro != PRO_NONE) {  // a cooperative launch
    prologue(a);
    clk.mark(0);
    cg::this_grid().sync();
    clk.mark(1);
  }
  gemm_phase<T, OUT, POW>(a, smem, clk);
  clk.store(blockIdx.x);
}

// blocks of one instantiation co-resident on an SM, at most two (0 on an
// error); ops/fused.py:matmul_layout counts two
template <int T, int OUT, bool POW>
int per_sm() {
  static int cached = -1;
  if (cached < 0) {
    int v = 0;
    const int smem = qvt::gemm_ring_bytes(T, T);
    if (cudaFuncSetAttribute(fqm_kernel<T, OUT, POW>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem) != cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &v, fqm_kernel<T, OUT, POW>, NT, smem) != cudaSuccess)
      return 0;
    cached = std::min(v, 2);
  }
  return cached;
}

template <int T, int OUT, bool POW>
cudaError_t launch(Args& a, int sms, cudaStream_t stream) {
  const int cap = per_sm<T, OUT, POW>() * sms;
  if (cap < 1) return cudaErrorInvalidConfiguration;
  // enough blocks for the larger phase: row groups, GEMM items
  long long want = a.full + static_cast<long long>(a.tiles - a.full) * a.S;
  if (a.pro != PRO_NONE)
    want = std::max<long long>(
        want, (a.M + NT / a.ln_t - 1) / (NT / a.ln_t));
  const int grid = static_cast<int>(std::min<long long>(cap, want));
  const int smem = qvt::gemm_ring_bytes(T, T);
  if (a.pro == PRO_NONE) {
    fqm_kernel<T, OUT, POW><<<grid, NT, smem, stream>>>(a);
    return cudaGetLastError();
  }
  void* args[] = {&a};
  cudaError_t e = cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(fqm_kernel<T, OUT, POW>), dim3(grid), dim3(NT),
      args, smem, stream);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

template <int T>
cudaError_t launch_tile(Args& a, int epilogue, int out_pow, int sms,
                        cudaStream_t st) {
  if (epilogue == EPI_QUANT)
    return out_pow ? launch<T, OUT_QUANT, true>(a, sms, st)
                   : launch<T, OUT_QUANT, false>(a, sms, st);
  if (epilogue == EPI_GELU)
    return out_pow ? launch<T, OUT_GELU, true>(a, sms, st)
                   : launch<T, OUT_GELU, false>(a, sms, st);
  return launch<T, OUT_FLOAT, false>(a, sms, st);
}

}  // namespace

// x [M][K] (int8 levels under prologue 0 or 4); w: n-major levels of a
// wk x N weight (wk = K, or Kp with zero levels past K); tile: the output
// tile (128 or 64); ln_t: threads a prologue row (8 .. 256, a power of
// two); full: the tiles taken whole, first; S: the splits of the depth (1
// .. its 128-deep steps) of each other tile. lv: scratch [M][Kp] (Kp a
// multiple of 64, >= wk), 16-byte aligned, unless prologue 0 (x read in
// place: K % 16 == 0, x 16-byte aligned); with S > 1, part: int32 [split
// tiles * S][tile * tile], 8-byte aligned, and cnt: int32 [split tiles],
// zero (ops/fused.py:matmul_layout picks it all; run_matmul allocates).
extern "C" int qvt_fused_quant_matmul(
    const void* x, int x_dt, const void* w, int w_int4, int wk,
    const void* scale, const void* bias, const void* ln_g, const void* ln_b,
    const void* res, int res_dt, const void* prm, void* lv, void* part,
    void* cnt, void* out, int out_dt, int M, int K, int N, int Kp,
    int prologue, int epilogue, int act_pow, int out_pow, int act_top,
    int out_top, float eps, int ln_t, int tile, int full, int S,
    void* stream) {
  const uintptr_t xa = reinterpret_cast<uintptr_t>(x);
  const bool direct = prologue == PRO_NONE;
  const int lda = direct ? K : Kp;
  const int tiles = (M + tile - 1) / tile * ((N + tile - 1) / tile);
  if (prologue < PRO_NONE || prologue > PRO_COPY || epilogue < EPI_NONE ||
      epilogue > EPI_GELU || (tile != TILE_L && tile != TILE_S) ||
      wk < K || (wk != K && wk != Kp) || (w_int4 && wk % 2) ||
      (epilogue == EPI_RES) != (res != nullptr) ||
      (epilogue >= EPI_QUANT) != (out_dt == qvt::DT_INT8) ||
      ((direct || prologue == PRO_COPY) && x_dt != qvt::DT_INT8) ||
      (direct && (K % 16 || (xa & 15))) ||
      (!direct && (lv == nullptr || Kp % 64 || Kp < wk || ln_t < LN_MIN_T ||
                   ln_t > NT || (ln_t & (ln_t - 1)) ||
                   (reinterpret_cast<uintptr_t>(lv) & 15))) ||
      S < 1 || S > (lda + BK - 1) / BK || full < 0 || full > tiles ||
      (S > 1 && (part == nullptr || cnt == nullptr ||
                 (reinterpret_cast<uintptr_t>(part) & 7))))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.x = x;
  a.x_dt = x_dt;
  a.w = qvt::WeightT{static_cast<const int8_t*>(w), wk, N, w_int4};
  a.scale = static_cast<const float*>(scale);
  a.bias = static_cast<const float*>(bias);
  a.ln_g = static_cast<const float*>(ln_g);
  a.ln_b = static_cast<const float*>(ln_b);
  a.res = res;
  a.res_dt = res_dt;
  a.prm = static_cast<const float*>(prm);
  a.lv = static_cast<int8_t*>(lv);
  a.part = static_cast<int*>(part);
  a.cnt = static_cast<int*>(cnt);
  a.out = out;
  a.out_dt = out_dt;
  a.M = M;
  a.K = K;
  a.N = N;
  a.Kp = Kp;
  a.pro = prologue;
  a.ln_t = ln_t;
  a.S = S;
  a.tiles = tiles;
  a.full = full;
  a.act_pow = act_pow;
  a.act_top = static_cast<float>(act_top);
  a.out_top = static_cast<float>(out_top);
  a.eps = eps;
  const bool fl = x_dt == qvt::DT_BF16 || x_dt == qvt::DT_F32;
  // phase 1's 16-byte path: rows of whole pieces; gamma, beta as float4
  a.x_vec = fl && (xa & 15) == 0 && K % (x_dt == qvt::DT_BF16 ? 8 : 4) == 0 &&
            (prologue != PRO_LN ||
             ((reinterpret_cast<uintptr_t>(ln_g) |
               reinterpret_cast<uintptr_t>(ln_b)) & 15) == 0);
  // WeightT::vec_ok, on the host
  a.w_vec = wk % 16 == 0 && (!w_int4 || (wk / 2) % 16 == 0) &&
            (reinterpret_cast<uintptr_t>(w) & 15) == 0;
  // the epilogue in whole 4-column groups: N % 4 == 0, out and the
  // residual aligned to 4 elements, scale and bias to 16 bytes
  const int oes = out_dt == qvt::DT_INT8 ? 1 : out_dt == qvt::DT_F32 ? 4 : 2;
  const int res_es = res_dt == qvt::DT_F32 ? 4 : 2;
  a.quad = N % 4 == 0 &&
           reinterpret_cast<uintptr_t>(out) % (4 * oes) == 0 &&
           (res == nullptr ||
            ((res_dt == qvt::DT_BF16 || res_dt == qvt::DT_F32) &&
             reinterpret_cast<uintptr_t>(res) % (4 * res_es) == 0)) &&
           ((reinterpret_cast<uintptr_t>(scale) |
             reinterpret_cast<uintptr_t>(bias)) & 15) == 0;
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  e = tile == TILE_L ? launch_tile<TILE_L>(a, epilogue, out_pow, sms, st)
                     : launch_tile<TILE_S>(a, epilogue, out_pow, sms, st);
  return static_cast<int>(e);
}

// The levels-only launch: K1's phase 1 under the LayerNorm + quant
// prologue (gemm_phases.cuh:row_levels<ROWS_LN>), alone, into lv [M][K]
// (no zero columns: Kp = K), with no GEMM and no grid barrier (a plain
// launch of ceil(M / rows a block) blocks). Tensor-parallel serving
// (serve/vit_tp.py) runs it to quantize a process's rows before their
// levels are all-gathered; its levels are those K1's ln_quant prologue
// writes into its scratch, bit for bit (the same code, the same folded
// gamma/beta from the plan). Bound: x read once, M * K levels written.
namespace {

template <bool POW>
__global__ void __launch_bounds__(NT) ln_levels_kernel(Args a) {
  qvt::row_levels<qvt::ROWS_LN, POW, NT>(a);
}

}  // namespace

// x [M][K] bf16 or f32; ln_g, ln_b [K] f32 (the quantizer's 1/d folded in
// when act_pow is 0); prm: act_d, act_t (and two unused); lv [M][K] int8,
// 16-byte aligned; ln_t: threads a row (8 .. 256, a power of two).
extern "C" int qvt_ln_quant_levels(const void* x, int x_dt, const void* ln_g,
                                   const void* ln_b, const void* prm,
                                   void* lv, int M, int K, int act_pow,
                                   int act_top, float eps, int ln_t,
                                   void* stream) {
  const uintptr_t xa = reinterpret_cast<uintptr_t>(x);
  if ((x_dt != qvt::DT_BF16 && x_dt != qvt::DT_F32) || M < 0 || K < 1 ||
      lv == nullptr || (reinterpret_cast<uintptr_t>(lv) & 15) ||
      ln_t < LN_MIN_T || ln_t > NT || (ln_t & (ln_t - 1)) || act_top < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (M == 0) return 0;
  Args a{};
  a.x = x;
  a.x_dt = x_dt;
  a.ln_g = static_cast<const float*>(ln_g);
  a.ln_b = static_cast<const float*>(ln_b);
  a.prm = static_cast<const float*>(prm);
  a.lv = static_cast<int8_t*>(lv);
  a.M = M;
  a.K = K;
  a.Kp = K;
  a.pro = PRO_LN;
  a.ln_t = ln_t;
  a.act_pow = act_pow;
  a.act_top = static_cast<float>(act_top);
  a.eps = eps;
  // the 16-byte path of phase 1, as qvt_fused_quant_matmul sets it; the
  // stores of a piece's levels (8 or 4 bytes at k = q * 8 or q * 4) stay
  // aligned since each row starts at r * K
  a.x_vec = (xa & 15) == 0 && K % (x_dt == qvt::DT_BF16 ? 8 : 4) == 0 &&
            ((reinterpret_cast<uintptr_t>(ln_g) |
              reinterpret_cast<uintptr_t>(ln_b)) & 15) == 0;
  const int rpb = NT / ln_t, grid = (M + rpb - 1) / rpb;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (act_pow)
    ln_levels_kernel<true><<<grid, NT, 0, st>>>(a);
  else
    ln_levels_kernel<false><<<grid, NT, 0, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

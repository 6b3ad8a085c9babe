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
// All four are bound by operations. The erf-GELU epilogue adds about 28
// f32, integer and conversion operations an output (-fmad=false): 22.0 M
// outputs are ~0.6 G lane operations, ~18-21 us on 132 SMs of 128 lanes,
// the size of the int8 bound, so it has to run beside the products.
//
// Two kernels.
//
// The float prologues (K16's quant and LayerNorm modes, all of K17):
// fc1_ln_kernel, one plain launch of a persistent grid, one block an SM
// of two consumer warpgroups and a producer warp (288 threads), no level
// scratch and no grid barrier (the first K16/K17 ran K1's design: the
// levels of every row into a scratch [M][K], a grid barrier, then K1's
// mma.sync tile). An item is a panel of NW tokens x a range of F output
// features (a multiple of 64); the items go to the blocks in contiguous
// runs, panel-major, so a block that holds several items of one panel
// computes its levels once. The work split (ops/ablations.py:
// fc1_ln_layout) picks F from the waves and the weight's L2 bytes (F x K
// a panel, read again by each panel): at the tools' shape NW 112 and F
// 1536, 128 items in one wave, 151 MB of weight and 22 MB of x through L2
// (the old tile read ~264 MB).
//   1. The panel's levels: the consumer warps take its rows four at a
//      time, a warp a row (gemm_phases.cuh:row_levels' arithmetic: the
//      LayerNorm moments as f64 sums rounded once, 1/sqrtf, the clip and
//      round), and write them straight into shared memory as the wgmma B
//      operand: [step][token][128 bytes] under the 128-byte swizzle
//      (wgmma_int8.cuh), zeros past K and past M; then
//      fence.proxy.async.shared::cta and a consumer barrier. The producer
//      is already streaming the weight meanwhile. A panel of 112 tokens is
//      held whole up to K 1536; deeper, a 64-token instantiation holds a
//      window of steps at a time, each window's levels computed again from
//      x, an item then two tiles, one a warpgroup, summed over the
//      windows.
//   2. The products: a tile is 64 features x NW tokens, outT = W lvT on
//      wgmma m64nNk32 (the weight the A operand from its ring, the panel
//      the B operand, both through descriptors). The plan keeps the
//      weight in boxes of 64 features x 128 levels, each already in the
//      swizzled layout (ops/ablations.py:fc1_ln_weight), so a ring stage
//      is one contiguous 8 KB bulk copy by the TMA unit (cp.async.bulk,
//      completing on the stage's full mbarrier); one ring a warpgroup,
//      filled in the tiles' order, each stage freed by its warps'
//      arrivals on its empty mbarrier. A warpgroup keeps one product
//      group in flight and frees each stage as the next one's products go
//      out. The items of one feature range start their tiles at different
//      places (the panel's index mod the tiles).
//   3. Ping-pong: the tiles of a block alternate between the warpgroups,
//      and a warpgroup issues its tile's products only after the other
//      has issued its previous tile's (two named barriers), so one
//      warpgroup's epilogue runs while the other's products run.
//   4. The epilogue from the fragments: each thread's int32 sums (two
//      features x NW/4 tokens) -> y = acc * scale (+ bias) -> the level,
//      one byte each into a [token][64 + 16] byte stage, then whole
//      16-byte pieces of a token's 64 levels to out (4-byte words where N
//      % 16 != 0). No int32 stage. Its rounding (and the prologue's) is
//      the magic add, no float-to-int conversion (round_clip_byte).
// What holds it on an H100 (tools/fc1_design.py --stages; PERF.md row
// 17): the weight stream and the steps that do not hide under it. The
// ring with x's loads alone takes about half the kernel's time, as long
// when every stage reads the same L2-hot box (not L2's bytes) and with
// one 15-stage ring for both warpgroups (not its depth). The LayerNorm,
// the products, the epilogue's arithmetic and its stores each add to it,
// since a stage is freed only once its products are done. Measured and
// not kept: the weight by a 2-D TMA tensor map (64 x 128 boxes of the
// n-major copy, or of unswizzled 8 KB boxes, the TMA unit swizzling
// them), 4-5% slower than the bulk copy either way; clusters of 2 and 4
// blocks sharing each box by a multicast copy (2.2-2.7x and 6.5x
// slower); that shared 15-stage ring (4% slower); half a panel a
// warpgroup with both reading each stage; a whole 64-token panel at the
// depths the 112-token one takes.
//
// The levels-in modes (K16 int8_in, K20, K21): fc1_kernel, K1's tile
// (int8_gemm.cuh:gemm_tile: a three-stage cp.async ring, ldmatrix,
// mma.sync m16n8k32 s8; packed int4 takes its nibbles per fragment) over
// 128 x 128 output tiles in a persistent grid of at most two blocks of
// 256 threads an SM, x's levels read in place, the accumulators staged in
// shared memory (gemm_phases.cuh:stage_acc), the epilogue by rows, 8
// threads a row, four levels stored at a time; a plain launch.
//
// Each (prologue, epilogue) pair the tools use is one instantiation, the
// epilogue a template argument (a runtime switch inside an unrolled
// epilogue cost K2 a third of a phase).
//
// Numerics: those of the plain version (ops/ablations.py:
// fc1_ablation_plain), built with -fmad=false: the LayerNorm sums in f64
// rounded once, 1/sqrtf, rintf; the GEMM exact; every epilogue the tool's
// f32 arithmetic in the tool's order. The magic rounding is an add and a
// subtract (__fadd_rn: never contracted or folded), round half to even
// as on the TPU. tanhf and expf are the CUDA library's, as PyTorch's tanh
// and sigmoid on the card call them; the bf16 erf rounds to bf16 after
// every operation, as PyTorch's bf16 tensors do.

#include <algorithm>
#include <cstring>

#include "gemm_phases.cuh"
#include "int8_gemm.cuh"
#include "wgmma_int8.cuh"

namespace qvt {
namespace wg {

// m64n112k32, the 112-token panel's products (wgmma_int8.cuh's Mma at N =
// 112)
template <>
struct Mma<112> {
  __device__ __forceinline__ static void run(int (&d)[56], uint64_t a,
                                             uint64_t b, int acc) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %58, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n112k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55"
        "}, %56, %57, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
          "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
          "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
          "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
          "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
          "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
          "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
          "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
          "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
          "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
          "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
          "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
          "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]),
          "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55])
        : "l"(a), "l"(b), "r"(acc));
  }
};

}  // namespace wg
}  // namespace qvt

namespace wg = qvt::wg;

namespace {

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

// QVT_F1_OFF: a build with stages of fc1_ln_kernel switched off, for
// timing only (tools/fc1_design.py --stages; 0, none, in the kernels' own
// build): 1 the prologue (each level the low byte of x's element, no
// moments); 2 the products (the ring still streamed and waited on, the
// sums 0); 3 the epilogue's arithmetic (each level the low byte of its
// int32 sum); 4 the products and the epilogue's arithmetic; 5 those and
// the prologue; 6 those and the epilogue's stores to out (the ring and
// x's loads alone); 7 the ping-pong's turns; 8 every weight box read from
// the first (the same 8 KB of L2 for every stage of every block); 9 both 6
// and 8. Only 0 and 7 compute the function.
#ifndef QVT_F1_OFF
#define QVT_F1_OFF 0
#endif
constexpr int F1_OFF = QVT_F1_OFF;
constexpr bool OFF_PRO = F1_OFF == 1 || F1_OFF == 5 || F1_OFF == 6 ||
                         F1_OFF == 9;
constexpr bool OFF_MMA = F1_OFF == 2 || (F1_OFF >= 4 && F1_OFF <= 6) ||
                         F1_OFF == 9;
constexpr bool OFF_EPI = F1_OFF == 3 || (F1_OFF >= 4 && F1_OFF <= 6) ||
                         F1_OFF == 9;
constexpr bool OFF_STORE = F1_OFF == 6 || F1_OFF == 9;
constexpr bool OFF_TURN = F1_OFF == 7;
constexpr bool ONE_BOX = F1_OFF == 8 || F1_OFF == 9;

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

// what an epilogue reads: y = acc * (scale[col] or scale_s) (+ bias[col]),
// its level under 1/d (inv_d), the folded form's c2, the clip; out [M][N]
struct Epi {
  const float* scale;  // [N], or null: scale_s
  const float* bias;   // [N] or null
  float scale_s, inv_d, c2, out_top;
  int8_t* out;
  int M, N;
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
__device__ __forceinline__ uint32_t level(float y, const Epi& a) {
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

// ---------------------------------------------------------------------------
// the levels-in kernel (K1's tile)
// ---------------------------------------------------------------------------

constexpr int NT = 256;
constexpr int TILE = 128, WM = TILE / 2, WN = TILE / 4;
constexpr int BK = qvt::GT_BK;

struct Args {
  const int8_t* x;  // levels [M][K], 16-byte aligned rows
  int K;
  qvt::WeightT w;
  int tiles;
  Epi e;
};

// The epilogue of a staged 128 x 128 tile: y = acc * scale (+ bias), its
// levels; a row to 8 threads, each a 4-column group at a time (N % 4 ==
// 0: whole groups), scale and bias as float4, four levels a store.
template <int EP>
__device__ __forceinline__ void store_tile(const Epi& a, const int* stage,
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

template <int EP>
__global__ void __launch_bounds__(NT, 2) fc1_kernel(Args a) {
  extern __shared__ __align__(16) int8_t smem[];
  const int nkt = (a.K + BK - 1) / BK, tn = (a.e.N + TILE - 1) / TILE;
  for (int it = blockIdx.x; it < a.tiles; it += gridDim.x) {
    const int row0 = it / tn * TILE, col0 = it % tn * TILE;
    int acc[WM / 16][WN / 8][4];
    qvt::gemm_tile<TILE, TILE, WM, WN, NT>(acc, a.x, a.K, a.e.M, a.w, true,
                                           row0, col0, 0, nkt, smem);
    int* stage = reinterpret_cast<int*>(smem);
    qvt::stage_acc<TILE, TILE>(acc, stage);
    store_tile<EP>(a.e, stage, row0, col0);
  }
}

template <int EP>
cudaError_t launch(Args& a, int sms, cudaStream_t st) {
  auto kern = fc1_kernel<EP>;
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
  kern<<<std::min(per_sm * sms, a.tiles), NT, smem, st>>>(a);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// the float-prologue kernel (wgmma + TMA, the levels in shared memory)
// ---------------------------------------------------------------------------

// features a tile (a warpgroup's wgmma M), depth bytes a step (one
// 128-byte swizzled row), a weight stage's bytes, consumer threads, the
// block
constexpr int L_TILE = 64, L_BK = 128, L_STAGE = L_TILE * L_BK, L_CT = 256,
              L_NT = L_CT + 32;
// ring stages a warpgroup at most; dynamic shared memory a block may take;
// the epilogue's byte stage: a token's 64 levels, rows 80 bytes apart (16-
// byte aligned; a warp's byte stores fall in distinct banks)
constexpr int L_MAX_STAGES = 8, L_SMEM = 231424, L_EPI_RS = 80;
// named barriers: the consumers; each warpgroup's; "warpgroup w may issue
// its next tile's products"
constexpr int L_CBAR = 1, L_WBAR = 2, L_OBAR = 4;

struct LnArgs {
  // the weight copy in its boxes: [np / 64][steps][64 rows][128 bytes],
  // each box's rows under the 128-byte swizzle (ops/ablations.py:
  // fc1_ln_weight), one contiguous 8 KB box a ring stage
  const uint8_t* wb;
  const void* x;     // [M][K] bf16 or f32, 16-byte aligned
  int x_dt;
  const float* ln_g;  // [K] (LayerNorm)
  const float* ln_b;
  const float* prm;  // the prologue quantizer's d and t (1, 1)
  float act_top, eps;
  Epi e;
  int K, steps;    // depth; 128-byte steps of the panel (K rounded up)
  int F, nf;       // features an item (a multiple of 64); items a panel
  int items;       // panels x nf
  int win;         // steps of the panel held at once (== steps: whole)
  int stages;      // a warpgroup's ring
  int tiles;       // tiles of 64 features in N (rounded up)
  bool vec16;      // N % 16 == 0 and out 16-byte aligned
};

__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync %0, %1;\n" ::"n"(L_CBAR), "n"(L_CT) : "memory");
}

__device__ __forceinline__ void warpgroup_sync(int w) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(L_WBAR + w), "n"(128) : "memory");
}

// warpgroup w waits for its turn to issue products, or hands the turn to
// warpgroup w (each a 256-thread barrier: one warpgroup syncs, the other
// arrives)
__device__ __forceinline__ void turn_wait(int w) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(L_OBAR + w), "n"(L_CT) : "memory");
}
__device__ __forceinline__ void turn_give(int w) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(L_OBAR + w), "n"(L_CT)
               : "memory");
}

// a contiguous bulk copy of `bytes` (a multiple of 16) from device memory
// at `src` into `dst`, completing on `bar`
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(wg::smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes),
      "r"(wg::smem_u32(bar))
      : "memory");
}

// item i's first token and feature, its tiles of 64 features, and the
// tile it starts from: the items of one feature range (one a panel) take
// its tiles from different starts, so the blocks streaming the same weight
// rows do not all ask L2 for the same boxes at once
struct LnItem {
  int t0, f0, ntile, rot;
  __device__ __forceinline__ int tile(int j) const {
    const int t = j + rot;
    return t < ntile ? t : t - ntile;
  }
};

template <int NW>
__device__ __forceinline__ LnItem item_of(const LnArgs& a, int i) {
  LnItem r;
  const int p = i / a.nf, fr = i - p * a.nf;
  r.t0 = p * NW;
  r.f0 = fr * a.F;
  r.ntile = min(a.F / L_TILE, a.tiles - r.f0 / L_TILE);
  r.rot = p % r.ntile;
  return r;
}

// this block's items: a contiguous run, panel-major
__device__ __forceinline__ void block_items(const LnArgs& a, int& i0,
                                            int& i1) {
  i0 = static_cast<int>(static_cast<long long>(blockIdx.x) * a.items /
                        gridDim.x);
  i1 = static_cast<int>(static_cast<long long>(blockIdx.x + 1) * a.items /
                        gridDim.x);
}

// The float-prologue kernel's levels with no conversion after its input's
// (the prologue's and the erf-GELU and folded epilogues'): clip(rint(r),
// +-top) is rint(clip(r, +-top)) for an integer top (NaN to -top either
// way), and rint of |v| <= top < 2^22 is the magic add, whose low byte is
// the level's (1.5 * 2^23 has a zero low byte). The erf polynomial's
// clamp is the one already on its argument (qvt_common.cuh:erf_poly
// clamps again: idempotent).
__device__ __forceinline__ float erf_clamped(float v) {
  const float v2 = v * v;
  float acc = 1.6343068626e-04f;
  acc = acc * v2 + -4.6024812456e-03f;
  acc = acc * v2 + 5.0755384214e-02f;
  acc = acc * v2 + -2.8632930819e-01f;
  acc = acc * v2 + 1.0820510812e+00f;
  return acc * v;
}

__device__ __forceinline__ uint32_t round_clip_byte(float r, float top) {
  return __float_as_uint(__fadd_rn(fminf(fmaxf(r, -top), top), MAGIC));
}

// The levels of the panel's rows [t0, t0 + NW) at the steps [s0, s1) into
// `panel` ([s - s0][token][128 bytes], swizzled), by the 8 consumer warps,
// a warp LN_R rows at a time (rows r, r + 8, ...: their loads in flight
// together): the LayerNorm moments over the whole row (f64 sums rounded
// once, as gemm_phases.cuh:row_levels), then a lane a 16-byte piece of x
// (8 bf16 or 4 f32 levels) of each row, g and b loaded once for the rows;
// zeros past K and for rows past M.
constexpr int LN_R = 4;

template <int PRO, int NW>
__device__ __forceinline__ void panel_levels(const LnArgs& a, int t0, int s0,
                                             int s1, uint8_t* panel) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int K = a.K;
  const bool bf = a.x_dt == qvt::DT_BF16;
  const int epp = bf ? 8 : 4, esz = bf ? 2 : 4, np = K / epp;
  // the window's columns with levels, as 16-byte pieces of x
  const int q0 = s0 * L_BK / epp, q1 = min(K, s1 * L_BK) / epp;
  const float act_d = a.prm[0];
  const char* xb = static_cast<const char*>(a.x);
  for (int rb = warp; rb < NW; rb += 8 * LN_R) {
    const uint4* xr[LN_R];
    bool live[LN_R];
#pragma unroll
    for (int i = 0; i < LN_R; ++i) {
      const long long row = t0 + rb + 8 * i;
      live[i] = rb + 8 * i < NW && row < a.e.M;
      xr[i] = reinterpret_cast<const uint4*>(xb + (live[i] ? row : 0) * K *
                                                      esz);
    }
    float mu[LN_R] = {}, rs[LN_R] = {};
    if constexpr (PRO == PRO_LN && !OFF_PRO) {
      double s[LN_R] = {}, s2[LN_R] = {};
#pragma unroll 2
      for (int q = lane; q < np; q += 32) {
        uint4 u[LN_R];
#pragma unroll
        for (int i = 0; i < LN_R; ++i)
          u[i] = live[i] ? __ldg(xr[i] + q) : make_uint4(0, 0, 0, 0);
#pragma unroll
        for (int i = 0; i < LN_R; ++i)
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            if (e >= epp) break;
            const float v = qvt::piece_at(u[i], bf, e);
            s[i] += static_cast<double>(v);
            s2[i] += static_cast<double>(v * v);
          }
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
#pragma unroll
        for (int i = 0; i < LN_R; ++i) {
          s[i] += __shfl_xor_sync(0xffffffffu, s[i], o);
          s2[i] += __shfl_xor_sync(0xffffffffu, s2[i], o);
        }
      const float inv_k = 1.0f / static_cast<float>(K);
#pragma unroll
      for (int i = 0; i < LN_R; ++i) {
        mu[i] = static_cast<float>(s[i]) * inv_k;
        const float var =
            fmaxf(static_cast<float>(s2[i]) * inv_k - mu[i] * mu[i], 0.f);
        rs[i] = 1.0f / sqrtf(var + a.eps);
      }
    }
    for (int q = q0 + lane; q < q1; q += 32) {
      const int k = q * epp;
      float gv[8] = {}, bv[8] = {};
      if constexpr (PRO == PRO_LN && !OFF_PRO) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          if (4 * h >= epp) break;
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
      uint4 u[LN_R];
#pragma unroll
      for (int i = 0; i < LN_R; ++i)
        u[i] = live[i] ? __ldg(xr[i] + q) : make_uint4(0, 0, 0, 0);
      const int pc = (k % L_BK) >> 4, off = (k / L_BK - s0) * NW * L_BK +
                                            (k & 15);
#pragma unroll
      for (int i = 0; i < LN_R; ++i) {
        const int r = rb + 8 * i;
        if (r >= NW) break;
        uint32_t w[2] = {0u, 0u};
        if (live[i]) {
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            if (e >= epp) break;
            uint32_t lv;
            if constexpr (OFF_PRO) {
              const uint32_t ws[4] = {u[i].x, u[i].y, u[i].z, u[i].w};
              lv = bf ? (ws[e >> 1] >> (16 * (e & 1))) & 0xFFu
                      : ws[e] & 0xFFu;
            } else {
              // qvt::quantize's levels (folded: clip(rint(v)); else
              // clip(rint(v * (1 / d)))), rounded as round_clip_byte
              const float v = qvt::piece_at(u[i], bf, e);
              if constexpr (PRO == PRO_LN)
                lv = round_clip_byte((v - mu[i]) * rs[i] * gv[e] + bv[e],
                                     a.act_top) & 0xFFu;
              else
                lv = round_clip_byte(v * (1.0f / act_d), a.act_top) & 0xFFu;
            }
            w[e >> 2] |= lv << (8 * (e & 3));
          }
        }
        uint8_t* dst = panel + off + r * L_BK + ((pc ^ (r & 7)) << 4);
        if (bf)
          *reinterpret_cast<uint2*>(dst) = make_uint2(w[0], w[1]);
        else
          *reinterpret_cast<uint32_t*>(dst) = w[0];
      }
    }
    // zero levels past K in the window's last step
    for (int un = max(K, s0 * L_BK) / 16 + lane; un < s1 * L_BK / 16;
         un += 32) {
      const int pc = un % (L_BK / 16), s = un / (L_BK / 16) - s0;
#pragma unroll
      for (int i = 0; i < LN_R; ++i) {
        const int r = rb + 8 * i;
        if (r >= NW) break;
        *reinterpret_cast<uint4*>(panel + s * NW * L_BK + r * L_BK +
                                  ((pc ^ (r & 7)) << 4)) =
            make_uint4(0, 0, 0, 0);
      }
    }
  }
}

// The producer (one thread): the weight boxes of this block's tiles, in
// the consumers' order, each into its warpgroup's ring (WHOLE: the tiles
// alternate between the rings; else an item's tile w is warpgroup w's)
template <int NW, bool WHOLE>
__device__ __forceinline__ void ln_produce(const LnArgs& a, uint8_t* ring,
                                           uint64_t* full, uint64_t* empty) {
  int i0, i1;
  block_items(a, i0, i1);
  uint32_t u[2] = {0u, 0u};
  int q = 0;
  for (int i = i0; i < i1; ++i) {
    const LnItem t = item_of<NW>(a, i);
    for (int s0 = 0; s0 < a.steps; s0 += a.win) {
      const int s1 = min(s0 + a.win, a.steps);
      for (int j = 0; j < t.ntile; ++j, ++q) {
        const int w = WHOLE ? q & 1 : j;
        const long long box =
            static_cast<long long>(t.f0 / L_TILE + (WHOLE ? t.tile(j) : j)) *
            a.steps;
        for (int ks = s0; ks < s1; ++ks, ++u[w]) {
          const int s = u[w] % a.stages, b = w * L_MAX_STAGES + s;
          wg::mbar_wait(&empty[b], ((u[w] / a.stages) & 1) ^ 1);
          wg::mbar_arrive_tx(&full[b], L_STAGE);
          bulk_load(ring + (w * a.stages + s) * L_STAGE,
                    a.wb + (ONE_BOX ? 0 : (box + ks) * L_STAGE), L_STAGE,
                    &full[b]);
        }
      }
    }
  }
}

// a warp's release of a ring slot
__device__ __forceinline__ void release(uint64_t* bar) {
  if ((threadIdx.x & 31) == 0) wg::mbar_arrive(bar);
}

template <int EP>
__device__ __forceinline__ uint32_t level_fast(float y, const Epi& a) {
  if constexpr (EP == EP_GELU_ERF) {
    const float z = fminf(fmaxf(y * C2, -3.0f), 3.0f);
    const float e = erf_clamped(z);
    const float w = z * C2 * a.inv_d;
    return round_clip_byte(w + w * e, a.out_top);
  } else if constexpr (EP == EP_FOLDED) {
    const float e = erf_clamped(fminf(fmaxf(y, -3.0f), 3.0f));
    const float w = y * a.c2;
    return round_clip_byte(w + w * e, a.out_top);
  } else {
    return level<EP>(y, a);
  }
}

// The epilogue of warpgroup w's tile (features fb.., tokens t0..): each
// thread's sums (features fb + 16 wq + g and + 8, tokens 8 j + 2 t + e) ->
// levels -> the byte stage -> 16-byte pieces of each token's 64 levels
template <int EP, int NW>
__device__ __forceinline__ void ln_epilogue(const LnArgs& a,
                                            const int (&d)[NW / 2], int t0,
                                            int fb, uint8_t* stage) {
  const Epi& e = a.e;
  const int w = threadIdx.x / 128, tid = threadIdx.x & 127;
  const int lane = threadIdx.x & 31, wq = tid >> 5, g = lane >> 2,
            tq = lane & 3;
  float sc[2], bi[2] = {0.f, 0.f};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int f = fb + 16 * wq + g + 8 * h;
    const bool in = f < e.N;
    sc[h] = e.scale ? (in ? __ldg(e.scale + f) : 0.f) : e.scale_s;
    if (e.bias) bi[h] = in ? __ldg(e.bias + f) : 0.f;
  }
  warpgroup_sync(w);  // the previous tile's stores have read the stage
#pragma unroll
  for (int j = 0; j < NW / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int x = 0; x < 2; ++x) {
        const int acc = d[4 * j + 2 * h + x];
        uint32_t lv;
        if constexpr (OFF_EPI) {
          lv = static_cast<uint32_t>(acc) & 0xFFu;
        } else {
          float y = static_cast<float>(acc) * sc[h];
          if (e.bias) y = y + bi[h];
          lv = level_fast<EP>(y, e);
        }
        stage[(8 * j + 2 * tq + x) * L_EPI_RS + 16 * wq + g + 8 * h] =
            static_cast<uint8_t>(lv);
      }
  warpgroup_sync(w);
  if constexpr (OFF_STORE) return;
  for (int p = tid; p < NW * 4; p += 128) {
    const int tok = p >> 2, c = p & 3, row = t0 + tok, f = fb + 16 * c;
    if (row >= e.M || f >= e.N) continue;
    const uint4 v =
        *reinterpret_cast<const uint4*>(stage + tok * L_EPI_RS + 16 * c);
    int8_t* o = e.out + static_cast<long long>(row) * e.N + f;
    if (a.vec16) {
      *reinterpret_cast<uint4*>(o) = v;
    } else {
      const uint32_t ws[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (f + 4 * q < e.N) reinterpret_cast<uint32_t*>(o)[q] = ws[q];
    }
  }
}

// A warpgroup's products over the panel's steps [s0, s1) (the panel
// holding the window from s0): each stage's four k32 products issued as
// one group with the previous group still in flight, the stage before it
// freed once that group is done; returns with the last group in flight
template <int NW>
__device__ __forceinline__ void mma_steps(const LnArgs& a, int (&d)[NW / 2],
                                          int s0, int s1, uint32_t& u,
                                          const uint8_t* panel, uint8_t* ring,
                                          uint64_t* full, uint64_t* empty) {
  const int lane = threadIdx.x & 31;
  for (int ks = s0; ks < s1; ++ks, ++u) {
    const int s = u % a.stages;
    wg::mbar_wait(&full[s], (u / a.stages) & 1);
    if constexpr (!OFF_MMA) {
      const uint64_t da = wg::desc_sw128(ring + s * L_STAGE);
      const uint64_t db = wg::desc_sw128(panel + (ks - s0) * NW * L_BK);
      wg::fence_regs(d);
      wg::fence();
#pragma unroll
      for (int kk = 0; kk < L_BK / 32; ++kk)
        wg::Mma<NW>::run(d, da + 2 * kk, db + 2 * kk, 1);
      wg::commit();
      wg::wait<1>();
      wg::fence_regs(d);
    }
    if (ks > s0) release(&empty[(u + a.stages - 1) % a.stages]);
  }
}

// the last group done, its stage freed
template <int NW>
__device__ __forceinline__ void mma_finish(const LnArgs& a, int (&d)[NW / 2],
                                           uint32_t u, uint64_t* empty) {
  wg::wait<0>();
  wg::fence_regs(d);
  release(&empty[(u + a.stages - 1) % a.stages]);
}

// A consumer warpgroup. WHOLE (the panel held whole): the panel's levels
// with the other warpgroup once a panel, then every other tile of the
// block, its products issued in turn with the other's (ping-pong), its
// epilogue while the other's products run. Else (a window of the panel at
// a time): each item's windows, its levels computed by both, then this
// warpgroup's tile of the item (tile w) summed over them, its epilogue
// last.
template <int PRO, int EP, int NW, bool WHOLE>
__device__ __forceinline__ void ln_consume(const LnArgs& a, uint8_t* panel,
                                           uint8_t* ring, uint64_t* full,
                                           uint64_t* empty, uint8_t* stage) {
  const int w = threadIdx.x / 128;
  int i0, i1;
  block_items(a, i0, i1);
  int ntot = 0;  // this block's tiles (the turns' order)
  if constexpr (WHOLE)
    for (int i = i0; i < i1; ++i) ntot += item_of<NW>(a, i).ntile;
  uint8_t* myring = ring + w * a.stages * L_STAGE;
  uint64_t* myfull = full + w * L_MAX_STAGES;
  uint64_t* myempty = empty + w * L_MAX_STAGES;
  uint32_t u = 0;
  int q = 0, last = -1;
  for (int i = i0; i < i1; ++i) {
    const LnItem t = item_of<NW>(a, i);
    const int p = i / a.nf;
    if constexpr (WHOLE) {
      if (p != last) {
        // every product that read the panel has completed (each
        // warpgroup waited for its groups before its epilogue)
        wg::fence_proxy_async_smem();
        consumer_sync();
        panel_levels<PRO, NW>(a, t.t0, 0, a.steps, panel);
        wg::fence_proxy_async_smem();  // generic stores -> wgmma's reads
        consumer_sync();
        last = p;
      }
      for (int j = 0; j < t.ntile; ++j, ++q) {
        if ((q & 1) != w) continue;
        if (q > 0 && !OFF_TURN) turn_wait(w);
        int d[NW / 2];
#pragma unroll
        for (int r = 0; r < NW / 2; ++r) d[r] = 0;
        mma_steps<NW>(a, d, 0, a.steps, u, panel, myring, myfull, myempty);
        if (q + 1 < ntot && !OFF_TURN) turn_give(w ^ 1);
        mma_finish<NW>(a, d, u, myempty);
        ln_epilogue<EP, NW>(a, d, t.t0, t.f0 + t.tile(j) * L_TILE, stage);
      }
    } else {
      int d[NW / 2];
#pragma unroll
      for (int r = 0; r < NW / 2; ++r) d[r] = 0;
      for (int s0 = 0; s0 < a.steps; s0 += a.win) {
        const int s1 = min(s0 + a.win, a.steps);
        wg::fence_proxy_async_smem();
        consumer_sync();
        panel_levels<PRO, NW>(a, t.t0, s0, s1, panel);
        wg::fence_proxy_async_smem();
        consumer_sync();
        if (w < t.ntile) {
          mma_steps<NW>(a, d, s0, s1, u, panel, myring, myfull, myempty);
          mma_finish<NW>(a, d, u, myempty);
        }
      }
      if (w < t.ntile)
        ln_epilogue<EP, NW>(a, d, t.t0, t.f0 + w * L_TILE, stage);
    }
  }
}

template <int PRO, int EP, int NW, bool WHOLE>
__global__ void __launch_bounds__(L_NT, 1)
    fc1_ln_kernel(const LnArgs a) {
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* panel = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* ring = panel + a.win * NW * L_BK;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + 2 * a.stages * L_STAGE);
  uint64_t* empty = full + 2 * L_MAX_STAGES;
  uint8_t* stage = reinterpret_cast<uint8_t*>(empty + 2 * L_MAX_STAGES);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int s = 0; s < 2 * L_MAX_STAGES; ++s) {
      wg::mbar_init(&full[s], 1);
      wg::mbar_init(&empty[s], 4);  // the owning warpgroup's warps
    }
    wg::mbar_fence_init();
  }
  __syncthreads();
  if (warp == L_CT / 32) {
    if (lane == 0) ln_produce<NW, WHOLE>(a, ring, full, empty);
  } else {
    ln_consume<PRO, EP, NW, WHOLE>(
        a, panel, ring, full, empty,
        stage + (threadIdx.x / 128) * NW * L_EPI_RS);
  }
}

using LnKernel = void (*)(LnArgs);

// the panel sizes built: held whole (ops/ablations.py:FC1_LN_NW), and a
// window of the panel at a time (FC1_LN_WINDOW_NW)
constexpr int L_NW = 112, L_WINDOW_NW = 64;

// the instantiation of (prologue, epilogue) at panel size nw, null where
// not built (ops/ablations.py:FC1_BUILT)
template <int NW, bool WHOLE>
LnKernel ln_kernel_nw(int pro, int ep) {
  if (pro == PRO_LN && ep == EP_GELU_ERF)
    return fc1_ln_kernel<PRO_LN, EP_GELU_ERF, NW, WHOLE>;
  if (pro == PRO_LN && ep == EP_FOLDED)
    return fc1_ln_kernel<PRO_LN, EP_FOLDED, NW, WHOLE>;
  if (pro == PRO_QUANT && ep == EP_GELU_ERF)
    return fc1_ln_kernel<PRO_QUANT, EP_GELU_ERF, NW, WHOLE>;
  return nullptr;
}

LnKernel ln_kernel(int pro, int ep, int nw) {
  if (nw == L_NW) return ln_kernel_nw<L_NW, true>(pro, ep);
  if (nw == L_WINDOW_NW) return ln_kernel_nw<L_WINDOW_NW, false>(pro, ep);
  return nullptr;
}

// shared memory of a layout: the 1024-byte alignment, the panel window,
// two rings, a full and an empty barrier a stage at most, two byte stages
int ln_smem(int nw, int win, int stages) {
  return 1024 + win * nw * L_BK + 2 * stages * L_STAGE +
         2 * 2 * L_MAX_STAGES * 8 + 2 * nw * L_EPI_RS;
}

// The host's part, once a plan (qvt_fc1_ln_prepare): the layout and the
// grid
struct LnState {
  const uint8_t* wb;
  int M, K, N, nw, F, nf, items, steps, win, stages, tiles, smem, grid;
};

}  // namespace

// x [M][K] int8 levels, read in place (16-byte aligned); w: the n-major
// levels of a K x N weight ([N][K] int8, or packed int4 [N][K/2]);
// scale_v [N] or null (then scale_s); bias [N] or null; out [M][N] int8.
// K % 16 == 0 (packed int4: K/2 % 16 == 0), N % 4 == 0; every vector
// 16-byte aligned. Returns cudaErrorInvalidValue for an epilogue it is not
// built for (ops/ablations.py:FC1_BUILT).
extern "C" int qvt_fc1_ablation(const void* x, const void* w, int w_int4,
                                int K, const void* scale_v, const void* bias,
                                float scale_s, float inv_d, float out_d,
                                void* out, int M, int N, int epilogue,
                                int out_top, int sms, void* stream) {
  auto mis16 = [](const void* p) {
    return (reinterpret_cast<uintptr_t>(p) & 15) != 0;
  };
  if (M < 1 || K < 16 || K % 16 || (w_int4 && (K / 2) % 16) || N < 4 ||
      N % 4 || sms < 1 || mis16(x) || mis16(w) || mis16(scale_v) ||
      mis16(bias) || (reinterpret_cast<uintptr_t>(out) & 3) ||
      epilogue == EP_FOLDED)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.x = static_cast<const int8_t*>(x);
  a.K = K;
  a.w = qvt::WeightT{static_cast<const int8_t*>(w), K, N, w_int4};
  a.tiles = (M + TILE - 1) / TILE * ((N + TILE - 1) / TILE);
  a.e = Epi{static_cast<const float*>(scale_v),
            static_cast<const float*>(bias),
            scale_s,
            inv_d,
            0.70710678118654757f / out_d,
            static_cast<float>(out_top),
            static_cast<int8_t*>(out),
            M,
            N};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define QVT_FC1(E) \
  if (epilogue == E) return static_cast<int>(launch<E>(a, sms, st))
  QVT_FC1(EP_TRUNC);
  QVT_FC1(EP_ROUND);
  QVT_FC1(EP_MAGIC);
  QVT_FC1(EP_GELU_ERF);
  QVT_FC1(EP_GELU_ERF_MAGIC);
  QVT_FC1(EP_GELU_TANH);
  QVT_FC1(EP_GELU_SIG);
  QVT_FC1(EP_GELU_BF16);
  QVT_FC1(EP_GELU7);
  QVT_FC1(EP_GELU7_MAGIC);
  QVT_FC1(EP_GELU5);
#undef QVT_FC1
  return static_cast<int>(cudaErrorInvalidValue);
}

// Bytes of the float-prologue kernel's host state a caller allocates for
// one plan.
extern "C" int qvt_fc1_ln_state_bytes() {
  return static_cast<int>(sizeof(LnState));
}

// Once a plan (ops/ablations.py:fc1_ln_layout): checks the layout and
// sizes the grid on the current device. w: the plan's weight copy in its
// boxes (ops/ablations.py:fc1_ln_weight: [np / 64][steps][64][128] int8
// levels, each box's rows swizzled, np a multiple of 64 and at least N,
// 16-byte aligned); nw: the panel's tokens (112: the panel held whole, win
// == its steps; 64: a window of win steps at a time, F 128); F: features
// an item (a multiple of 64); stages: a warpgroup's ring (2 .. 8).
extern "C" int qvt_fc1_ln_prepare(void* state, const void* w, int np, int M,
                                  int K, int N, int nw, int F, int win,
                                  int stages) {
  LnState* s = static_cast<LnState*>(state);
  const int steps = (K + L_BK - 1) / L_BK;
  const int tiles = (N + L_TILE - 1) / L_TILE;
  const long long panels = (M + static_cast<long long>(nw) - 1) / nw;
  const int nf = F > 0 ? (tiles * L_TILE + F - 1) / F : 0;
  if (ln_kernel(PRO_LN, EP_GELU_ERF, nw) == nullptr || M < 1 || K < 16 ||
      K % 16 || N < 4 || N % 4 || np < N || np % L_TILE || F < L_TILE ||
      F % L_TILE || win < 1 || win > steps || (nw == L_NW && win != steps) ||
      (nw == L_WINDOW_NW && F != 2 * L_TILE) || stages < 2 ||
      stages > L_MAX_STAGES || panels * nf > (1 << 30) ||
      ln_smem(nw, win, stages) > L_SMEM ||
      (reinterpret_cast<uintptr_t>(w) & 15))
    return static_cast<int>(cudaErrorInvalidValue);
  std::memset(static_cast<void*>(s), 0, sizeof(LnState));
  s->wb = static_cast<const uint8_t*>(w);
  s->M = M;
  s->K = K;
  s->N = N;
  s->nw = nw;
  s->F = F;
  s->nf = nf;
  s->items = static_cast<int>(panels * nf);
  s->steps = steps;
  s->win = win;
  s->stages = stages;
  s->tiles = tiles;
  s->smem = ln_smem(nw, win, stages);
  cudaError_t ce = cudaSuccess;
  for (int pro : {PRO_QUANT, PRO_LN})
    for (int ep : {EP_GELU_ERF, EP_FOLDED}) {
      const LnKernel k = ln_kernel(pro, ep, nw);
      if (k != nullptr && ce == cudaSuccess)
        ce = cudaFuncSetAttribute(reinterpret_cast<const void*>(k),
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  L_SMEM);
    }
  int dev = 0, sms = 0;
  if (ce == cudaSuccess) ce = cudaGetDevice(&dev);
  if (ce == cudaSuccess)
    ce = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (ce != cudaSuccess) return static_cast<int>(ce);
  s->grid = std::min(s->items, sms);
  return 0;
}

// One launch for a prepared plan: x [M][K] bf16 or f32 (prologue 1:
// quant, 2: LayerNorm with ln_g, ln_b [K]); prm: the prologue quantizer's
// d and t, both 1.0 (f32 device memory); scale_v [N] or null (then
// scale_s); bias [N] or null; out [M][N] int8. Every vector 16-byte
// aligned, out 4-byte. Returns cudaErrorInvalidValue for a pair it is not
// built for (ops/ablations.py:FC1_BUILT).
extern "C" int qvt_fc1_ln(void* state, const void* x, int x_dt,
                          const void* scale_v, const void* bias,
                          const void* ln_g, const void* ln_b, const void* prm,
                          float scale_s, float inv_d, float out_d, float eps,
                          void* out, int prologue, int epilogue, int act_top,
                          int out_top, void* stream) {
  const LnState* s = static_cast<const LnState*>(state);
  auto mis16 = [](const void* p) {
    return (reinterpret_cast<uintptr_t>(p) & 15) != 0;
  };
  const LnKernel k = ln_kernel(prologue, epilogue, s->nw);
  if (k == nullptr || (x_dt != qvt::DT_BF16 && x_dt != qvt::DT_F32) ||
      mis16(x) || mis16(scale_v) || mis16(bias) || prm == nullptr ||
      (reinterpret_cast<uintptr_t>(out) & 3) ||
      (prologue == PRO_LN &&
       (ln_g == nullptr || ln_b == nullptr || mis16(ln_g) || mis16(ln_b))) ||
      (epilogue == EP_FOLDED && !(out_d > 0.f)))
    return static_cast<int>(cudaErrorInvalidValue);
  LnArgs a;
  a.wb = s->wb;
  a.x = x;
  a.x_dt = x_dt;
  a.ln_g = static_cast<const float*>(ln_g);
  a.ln_b = static_cast<const float*>(ln_b);
  a.prm = static_cast<const float*>(prm);
  a.act_top = static_cast<float>(act_top);
  a.eps = eps;
  a.e = Epi{static_cast<const float*>(scale_v),
            static_cast<const float*>(bias),
            scale_s,
            inv_d,
            0.70710678118654757f / out_d,  // fused.py:_gelu_quant_folded
            static_cast<float>(out_top),
            static_cast<int8_t*>(out),
            s->M,
            s->N};
  a.K = s->K;
  a.steps = s->steps;
  a.F = s->F;
  a.nf = s->nf;
  a.items = s->items;
  a.win = s->win;
  a.stages = s->stages;
  a.tiles = s->tiles;
  a.vec16 = s->N % 16 == 0 && (reinterpret_cast<uintptr_t>(out) & 15) == 0;
  k<<<s->grid, L_NT, s->smem, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

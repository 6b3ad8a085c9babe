// K2: whole transformer-MLP residual branch for Hopper (sm_90a).
//
// Replaces the TPU kernel quantized_vit_tpu/ops/fused.py:_fused_mlp_kernel
// (pallas_call in _fused_mlp, fused.py:977):
//   out = x + fc2(quant(GELU(fc1(quant(LN(x))))))
// x [M, K] in bf16 or f32; w1 [K, H] and w2 [H, K] as int8 levels or
// packed int4, both in the plan's n-major layout ([H][K(/2)], [K][H(/2)];
// packed int4 pairs k and k + K/2, or h and h + H/2, in one byte).
//
// Bound on this card: 4 M K H int8 ops, 62.8 G at ViT-B/16 batch 32 (M =
// 6656, K 768, H 3072): 31.7 us at 1,979 TOPS; 3.93 G at batch 2 (M =
// 416): 1.98 us. Compute-bound: ~25 MB in and out at batch 32 (7.5 us).
//
// Design: one cooperative launch of a persistent grid (at most two blocks
// of 256 threads an SM), three phases split by two grid barriers.
//   1. LayerNorm (fast variance, sums in f64) and quant, once per row,
//      into a level scratch lv [M, Kp] (Kp = K rounded up to 64): reads x
//      (10.2 MB at ViT-B batch 32, bf16), writes 5.1 MB. A row takes a
//      group of 8 to 256 threads, so that at small M the rows still spread
//      over every SM (gemm_phases.cuh:row_levels, shared with K1).
//   2. fc1 on the int8 tensor cores (int8_gemm.cuh's tile, K3's), output
//      tiles over the blocks; the epilogue dequantizes (s1, b1, with the
//      2^-0.5 fold when the hidden quantizer is linear), then the folded
//      GELU-quant (or GELU, then the pow quantizer), and writes the int8
//      hidden levels to a scratch hid [M, Hp] (Hp = H rounded up to 64).
//      The TPU kernel kept this tensor in VMEM; here it goes through L2:
//      20.4 MB at ViT-B batch 32, 2.8 MB at ViT-H/14 batch 2, inside the
//      50 MB L2.
//   3. fc2 on the int8 tensor cores over the hidden levels; the epilogue
//      acc * s2 + b2 + x in f32 (fused.py:699-700), stored in the output
//      dtype. The whole waves of output tiles run whole; the tiles left
//      over (all of them at small M) split the hidden depth S ways: each
//      split writes its int32 partial tile to a scratch, and the last
//      split of a tile to arrive (an atomic count, zeroed in phase 1)
//      adds the others' and runs the epilogue. Int32 sums are exact, so
//      no split changes a bit. At ViT-B batch 32, 264 of the 312 128 x
//      128 tiles run whole and 48 split 5 ways, where whole they left a
//      second wave of 48 tiles on an idle grid. (K1's staged version of
//      this sum, gemm_phases.cuh:split_reduce, spilled registers in
//      this kernel's 128 x 128 instance and cost 9% at batch 32.)
// Both epilogues stage the accumulators in shared memory and give each
// row to 8 threads, with whole 4-element loads and stores of device
// memory (gemm_phases.cuh:stage_acc). Each GEMM's tile (128 x 128 or 64 x
// 64), the LayerNorm group, the whole tiles and S come from the wrapper
// (ops/fused.py:mlp_layout), from M, K, H and the card's SMs: at every
// M >= 208 each phase has at least one work item an SM. The wrapper
// allocates every scratch with torch.empty.
//
// Against the first K2 (one 32-row block walking the hidden dimension in
// 32-unit chunks): its weights were re-read from L2 by every 32-row block
// (~980 MB a call at batch 32); the 128 x 128 tiles here read ~490 MB.
// Its 13 blocks at batch 2 left 119 SMs idle; here each phase fills the
// card. Its fc2 accumulator [32, K] lived in registers (K <= 1024); here
// no width enters a block's registers or shared memory, so any K and H
// that fused_mlp_plain takes run.
//
// Numerics: those of the plain version (ops/fused.py:fused_mlp_plain):
// the LayerNorm levels are exact (f64 sums rounded once, -fmad=false,
// rintf), the int32 GEMMs are exact, and each epilogue is the plain
// version's f32 arithmetic in its order.
//
// K15 (fused_mlp_gather; replaces quantized_vit_tpu/ops/ring_gather.py:
// fused_mlp_gather, pallas_call at :314, _mlp_gather_kernel :176) is this
// kernel with a copy: the MLP of one FSDP block and, in the same launch,
// the gather of the next block's row shards (copy_jobs.cuh), cut into
// chunks (ops/fused.py:gather_split). The copy is a template argument
// (COPY), as the quantizer is, so K2's instance holds no copy code and
// compiles as before (the same registers and spills). Copy blocks beside
// the MLP blocks would shrink the co-resident grid (two blocks an SM take
// the register file), so every block copies: after its LayerNorm rows in
// phase 1, chunks blockIdx.x, + grid, ... Phase 1 is memory-bound, so the
// copy adds about its bytes' time (14.2 MB read and written at ViT-B/16
// batch 32, >= 4.2 us at 3.35 TB/s: 240.1 against K2's 235.5 us on the
// same plan on an H100 80GB HBM3 at 700 W, PERF.md). Copying instead
// while a block waits at a grid barrier (chunks claimed from an atomic
// count) kept its state live across the GEMM phases: its 128 x 128
// instance spilled 232 bytes against K2's 100, and it ran 258.8 us. No
// kernel spins on another
// process: at tp > 1 the wrapper orders the launch against the peers'
// (ops/ring_gather.py).

#include <cooperative_groups.h>

#include <algorithm>

#include "copy_jobs.cuh"
#include "gemm_phases.cuh"
#include "int8_gemm.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int NT = 256;
// the GEMM tiles (BM = BN), each of 2 x 4 warps of BM/2 x BN/4
constexpr int TILE_L = 128, TILE_S = 64;
constexpr int BK = qvt::GT_BK;
// the LayerNorm group of threads a row: LN_MIN_T .. NT, a power of two
constexpr int LN_MIN_T = 8;

struct Args {
  const void* x;
  int x_dt;
  qvt::WeightT w1;  // K x H levels, n-major: [H][K] or packed [H][K/2]
  qvt::WeightT w2;  // H x K levels, n-major: [K][H] or packed [K][H/2]
  const float* s1;
  const float* b1;
  const float* s2;
  const float* b2;
  const float* ln_g;
  const float* ln_b;
  const float* prm;  // act_d, act_t, hid_d, hid_t
  int8_t* lv;        // scratch: the levels of LN(x) [M][Kp]
  int8_t* hid;       // scratch: the hidden levels [M][Hp]
  int* part;         // scratch: fc2's int32 partial tiles, one a split
  int* cnt;          // scratch: fc2's arrivals a split tile
  void* out;
  int out_dt;
  int M, K, H, Kp, Hp;
  int ln_t, S, tiles2, full2;
  int act_pow, hid_pow;
  float act_top, hid_top, eps;
  bool x_vec, w1_vec, w2_vec, sb1_vec, quad;
};

// K15's copy: the jobs, their chunks' bytes (a multiple of 4096) and
// count; K2 takes none
struct Copy {
  qvt::Jobs jb;
  long long chunk;
  int chunks;
};

struct NoCopy {};

template <bool COPY>
struct CopyOf {
  using T = Copy;
};
template <>
struct CopyOf<false> {
  using T = NoCopy;
};

// this block's chunks, in phase 1
__device__ __forceinline__ void copy_rows(const Copy& c) {
  for (long long ch = blockIdx.x; ch < c.chunks; ch += gridDim.x)
    qvt::copy_chunk(c.jb, c.chunk, ch, NT);
}

// Phase 1: the int8 levels of quant(LN(x)) into a.lv
// (gemm_phases.cuh:row_levels, a group of a.ln_t threads a row; POW: the
// input quantizer's pow map), then fc2's arrival counts zeroed (read
// after both grid barriers).
template <bool POW>
__device__ __forceinline__ void ln_quant_rows(const Args& a) {
  qvt::row_levels<qvt::ROWS_LN, POW, NT>(a);
  if (a.S > 1)
    for (int i = blockIdx.x * NT + threadIdx.x; i < a.tiles2 - a.full2;
         i += gridDim.x * NT)
      a.cnt[i] = 0;
}

// the hidden level of fc1's accumulator at unit h (fused.py:_gelu_quant:
// the dequant then the folded GELU-quant, or, POW, GELU then the pow
// quantizer; hid_d, hid_t: the hidden quantizer's scalars, c2 = 2^-0.5 /
// hid_d). POW is a template argument: as a runtime flag inside the
// unrolled epilogue it cost about a third of fc1's phase (phase probe).
template <bool POW>
__device__ __forceinline__ uint32_t hidden_level(const Args& a, int acc,
                                                 float s, float b,
                                                 float hid_d, float hid_t,
                                                 float c2) {
  const float y = static_cast<float>(acc) * s + b;
  return static_cast<uint8_t>(
      POW ? qvt::quantize(qvt::gelu(y), hid_d, hid_t, a.hid_top, true, false)
          : qvt::gelu_quant_folded_c2(y, c2, a.hid_top));
}

// fc1's epilogue from the stage: four levels a group, one 4-byte store
// of hid (a group past H lands in hid's padding)
template <int BM, int BN, bool POW>
__device__ __forceinline__ void store_levels(const Args& a, const int* stage,
                                             int row0, int col0) {
  constexpr int RS = BN + qvt::STAGE_PAD;
  const float hid_d = a.prm[2], hid_t = a.prm[3];
  const float c2 = 0.70710678118654757f / hid_d;
  const int q = threadIdx.x & 7;
  for (int r = threadIdx.x >> 3; r < BM; r += NT / 8) {
    const int row = row0 + r;
    if (row >= a.M) continue;
#pragma unroll
    for (int s = 0; s < BN / 32; ++s) {
      const int c = 32 * s + 4 * q, col = col0 + c;
      if (col >= a.Hp) continue;  // Hp % 4 == 0: the group is in or out
      const int4 v = *reinterpret_cast<const int4*>(stage + r * RS + c);
      float sc[4], bi[4];
      if (a.sb1_vec && col + 3 < a.H) {
        const float4 s4 = __ldg(reinterpret_cast<const float4*>(a.s1 + col));
        const float4 b4 = __ldg(reinterpret_cast<const float4*>(a.b1 + col));
        sc[0] = s4.x, sc[1] = s4.y, sc[2] = s4.z, sc[3] = s4.w;
        bi[0] = b4.x, bi[1] = b4.y, bi[2] = b4.z, bi[3] = b4.w;
      } else {  // s1, b1 off 16 bytes; or past H: padding, any level
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          sc[e] = col + e < a.H ? __ldg(a.s1 + col + e) : 0.f;
          bi[e] = col + e < a.H ? __ldg(a.b1 + col + e) : 0.f;
        }
      }
      const uint32_t w =
          hidden_level<POW>(a, v.x, sc[0], bi[0], hid_d, hid_t, c2) |
          hidden_level<POW>(a, v.y, sc[1], bi[1], hid_d, hid_t, c2) << 8 |
          hidden_level<POW>(a, v.z, sc[2], bi[2], hid_d, hid_t, c2) << 16 |
          hidden_level<POW>(a, v.w, sc[3], bi[3], hid_d, hid_t, c2) << 24;
      *reinterpret_cast<uint32_t*>(
          a.hid + static_cast<long long>(row) * a.Hp + col) = w;
    }
  }
  __syncthreads();  // the next tile's loads reuse the stage
}

// Phase 2: the hidden levels of fc1 over the BM x BN output tiles.
template <int BM, int BN>
__device__ __forceinline__ void fc1_phase(const Args& a, int8_t* smem) {
  constexpr int WM = BM / 2, WN = BN / 4, TM = WM / 16, TN = WN / 8;
  const int M = a.M, H = a.H;
  const int nkt = (a.Kp + BK - 1) / BK, tn = (H + BN - 1) / BN;
  const int tiles = (M + BM - 1) / BM * tn;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int row0 = tile / tn * BM, col0 = tile % tn * BN;
    int acc[TM][TN][4];
    qvt::gemm_tile<BM, BN, WM, WN, NT>(acc, a.lv, a.Kp, M, a.w1, a.w1_vec,
                                       row0, col0, 0, nkt, smem);
    int* stage = reinterpret_cast<int*>(smem);
    qvt::stage_acc<BM, BN>(acc, stage);
    if (a.hid_pow)
      store_levels<BM, BN, true>(a, stage, row0, col0);
    else
      store_levels<BM, BN, false>(a, stage, row0, col0);
  }
}

// fc2's epilogue from the stage: acc * s2 + b2 + x in f32 (fused.py:
// 699-700), four columns a group
template <int BM, int BN>
__device__ __forceinline__ void store_out(const Args& a, const int* stage,
                                          int row0, int col0) {
  constexpr int RS = BN + qvt::STAGE_PAD;
  const int q = threadIdx.x & 7;
  for (int r = threadIdx.x >> 3; r < BM; r += NT / 8) {
    const int row = row0 + r;
    if (row >= a.M) continue;
#pragma unroll
    for (int s = 0; s < BN / 32; ++s) {
      const int c = 32 * s + 4 * q, col = col0 + c;
      if (col >= a.K) continue;
      const int4 v = *reinterpret_cast<const int4*>(stage + r * RS + c);
      const int acc[4] = {v.x, v.y, v.z, v.w};
      const long long o = static_cast<long long>(row) * a.K + col;
      if (a.quad) {  // K % 4 == 0: the group is in; x, out, s2, b2 aligned
        const float4 s4 = __ldg(reinterpret_cast<const float4*>(a.s2 + col));
        const float4 b4 = __ldg(reinterpret_cast<const float4*>(a.b2 + col));
        const float sc[4] = {s4.x, s4.y, s4.z, s4.w};
        const float bi[4] = {b4.x, b4.y, b4.z, b4.w};
        float y[4];
        qvt::load4(a.x, a.x_dt, o, y);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          y[e] = (static_cast<float>(acc[e]) * sc[e] + bi[e]) + y[e];
        qvt::store4(a.out, a.out_dt, o, y);
        continue;
      }
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (col + e < a.K)
          qvt::store_f(a.out, a.out_dt, o + e,
                       (static_cast<float>(acc[e]) * __ldg(a.s2 + col + e) +
                        __ldg(a.b2 + col + e)) +
                           qvt::load_f(a.x, a.x_dt, o + e));
    }
  }
  __syncthreads();  // the next item's loads reuse the stage
}

// Phase 3: out = fc2(hidden levels) * s2 + b2 + x over the BM x BN output
// tiles: the first a.full2 tiles whole, one work item each, then the
// other tiles in a.S splits of the hidden depth each (consecutive items).
template <int BM, int BN>
__device__ __forceinline__ void fc2_phase(const Args& a, int8_t* smem) {
  constexpr int WM = BM / 2, WN = BN / 4, TM = WM / 16, TN = WN / 8;
  __shared__ int s_last;
  const int M = a.M, K = a.K, S = a.S, full = a.full2;
  const int nkt = (a.Hp + BK - 1) / BK, tn = (K + BN - 1) / BN;
  const int items = full + ((M + BM - 1) / BM * tn - full) * S;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp / (BN / WN) * WM, wn = warp % (BN / WN) * WN;
  // f(i, j, hh, r, c) over this thread's accumulator pairs (tile-local
  // r, c)
  auto each = [&](auto&& f) {
#pragma unroll
    for (int j = 0; j < TN; ++j)
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          f(i, j, hh, wm + 16 * i + g + 8 * hh, wn + 8 * j + 2 * t);
        }
  };
  for (int it = blockIdx.x; it < items; it += gridDim.x) {
    const int q = it - full, tile = it < full ? it : full + q / S;
    const int sp = it < full ? 0 : q - (tile - full) * S;
    const int row0 = tile / tn * BM, col0 = tile % tn * BN;
    const int kt0 = it < full ? 0 : sp * nkt / S;
    const int kt1 = it < full ? nkt : (sp + 1) * nkt / S;
    int acc[TM][TN][4];
    qvt::gemm_tile<BM, BN, WM, WN, NT>(acc, a.hid, a.Hp, M, a.w2, a.w2_vec,
                                       row0, col0, kt0, kt1, smem);
    if (it >= full && S > 1) {
      // this split's partial tile out (BM x BN int32, item q's); the last
      // split of the tile to arrive adds the others' (written before
      // their arrival: fence, then the count) and goes on to the epilogue
      const int split_tile = tile - full;
      each([&](int i, int j, int hh, int r, int c) {
        *reinterpret_cast<int2*>(a.part + static_cast<long long>(q) * BM *
                                              BN + r * BN + c) =
            make_int2(acc[i][j][2 * hh], acc[i][j][2 * hh + 1]);
      });
      __threadfence();
      __syncthreads();
      if (threadIdx.x == 0)
        s_last = atomicAdd(a.cnt + split_tile, 1) == S - 1;
      __syncthreads();
      if (!s_last) continue;
      __threadfence();
      for (int o = 0; o < S; ++o) {
        if (o == sp) continue;
        const int* other =
            a.part + (static_cast<long long>(split_tile) * S + o) * BM * BN;
        each([&](int i, int j, int hh, int r, int c) {
          const int2 v =
              __ldcg(reinterpret_cast<const int2*>(other + r * BN + c));
          acc[i][j][2 * hh] += v.x;
          acc[i][j][2 * hh + 1] += v.y;
        });
      }
    }
    int* stage = reinterpret_cast<int*>(smem);
    qvt::stage_acc<BM, BN>(acc, stage);
    store_out<BM, BN>(a, stage, row0, col0);
  }
}

// T1 x T1 tiles for fc1, T2 x T2 for fc2; COPY: K15's copy (else K2)
template <int T1, int T2, bool COPY>
__global__ void __launch_bounds__(NT, 2)
    mlp_kernel(Args a, typename CopyOf<COPY>::T c) {
  extern __shared__ __align__(16) int8_t smem[];
  cg::grid_group grid = cg::this_grid();
  qvt::PhaseClock clk;  // tools/phase_probe.py fused_mlp, fused_mlp_gather
  clk.begin();
  if (a.act_pow)
    ln_quant_rows<true>(a);
  else
    ln_quant_rows<false>(a);
  if constexpr (COPY) copy_rows(c);
  clk.mark(0);
  grid.sync();
  clk.mark(1);
  fc1_phase<T1, T1>(a, smem);
  clk.mark(2);
  grid.sync();
  clk.mark(3);
  fc2_phase<T2, T2>(a, smem);
  clk.mark(4);
  clk.store(blockIdx.x);
}

// the dynamic shared memory of a launch: the larger GEMM ring
constexpr int smem_bytes(int T1, int T2) {
  return qvt::gemm_ring_bytes(T1 > T2 ? T1 : T2, T1 > T2 ? T1 : T2);
}

// blocks of one instantiation co-resident on an SM, at most two (0 on an
// error); ops/fused.py:mlp_layout counts two
template <int T1, int T2, bool COPY>
int per_sm() {
  static int cached = -1;
  if (cached < 0) {
    int v = 0;
    if (cudaFuncSetAttribute(mlp_kernel<T1, T2, COPY>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_bytes(T1, T2)) != cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &v, mlp_kernel<T1, T2, COPY>, NT, smem_bytes(T1, T2)) !=
            cudaSuccess)
      return 0;
    cached = std::min(v, 2);
  }
  return cached;
}

template <int T1, int T2, bool COPY>
cudaError_t launch(Args& a, typename CopyOf<COPY>::T& c, int sms,
                   cudaStream_t stream) {
  const int cap = per_sm<T1, T2, COPY>() * sms;
  if (cap < 1) return cudaErrorInvalidConfiguration;
  // enough blocks for the largest phase: row groups, fc1 tiles, fc2 items
  const long long M = a.M;
  long long want = std::max(
      std::max((M + NT / a.ln_t - 1) / (NT / a.ln_t),
               (M + T1 - 1) / T1 * ((a.H + T1 - 1) / T1)),
      a.full2 + static_cast<long long>(a.tiles2 - a.full2) * a.S);
  // K15: a block a chunk at least (the copy's blocks at small M)
  if constexpr (COPY) want = std::max<long long>(want, c.chunks);
  if (want < 1) return cudaSuccess;
  const int grid = static_cast<int>(std::min<long long>(cap, want));
  void* args[] = {&a, &c};
  cudaError_t e = cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(mlp_kernel<T1, T2, COPY>), dim3(grid),
      dim3(NT), args, smem_bytes(T1, T2), stream);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// the launch at fc1's and fc2's tiles (checked by set_args)
template <bool COPY>
int launch_tiles(Args& a, typename CopyOf<COPY>::T& c, int tile1, int tile2,
                 void* stream) {
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (tile2 == TILE_L)
    e = launch<TILE_L, TILE_L, COPY>(a, c, sms, st);
  else
    e = tile1 == TILE_L ? launch<TILE_L, TILE_S, COPY>(a, c, sms, st)
                        : launch<TILE_S, TILE_S, COPY>(a, c, sms, st);
  return static_cast<int>(e);
}

// K2's arguments checked into a (0, or an error code)
int set_args(Args& a, const void* x, int x_dt, const void* w1, int w1_int4,
             const void* s1, const void* b1, const void* w2, int w2_int4,
             const void* s2, const void* b2, const void* ln_g,
             const void* ln_b, const void* prm, void* lv, void* hid,
             void* part, void* cnt, void* out, int out_dt, int M, int K,
             int H, int Kp, int Hp, int ln_t, int tile1, int tile2,
             int full2, int S, int act_pow, int hid_pow, int act_top,
             int hid_top, float eps) {
  if (Kp % 64 || Kp < K || Hp % 64 || Hp < H || ln_t < LN_MIN_T ||
      ln_t > NT || (ln_t & (ln_t - 1)) ||
      (tile1 != TILE_L && tile1 != TILE_S) ||
      (tile2 != TILE_L && tile2 != TILE_S) ||
      (tile2 == TILE_L && tile1 != TILE_L) || S < 1 ||
      S > (Hp + BK - 1) / BK ||
      (S > 1 && (part == nullptr || cnt == nullptr ||
                 (reinterpret_cast<uintptr_t>(part) & 7))) ||
      (w2_int4 && H % 2) || (w1_int4 && K % 2) ||
      (reinterpret_cast<uintptr_t>(lv) & 15) ||
      (reinterpret_cast<uintptr_t>(hid) & 15))
    return static_cast<int>(cudaErrorInvalidValue);
  a.x = x;
  a.x_dt = x_dt;
  a.w1 = qvt::WeightT{static_cast<const int8_t*>(w1), K, H, w1_int4};
  a.w2 = qvt::WeightT{static_cast<const int8_t*>(w2), H, K, w2_int4};
  a.s1 = static_cast<const float*>(s1);
  a.b1 = static_cast<const float*>(b1);
  a.s2 = static_cast<const float*>(s2);
  a.b2 = static_cast<const float*>(b2);
  a.ln_g = static_cast<const float*>(ln_g);
  a.ln_b = static_cast<const float*>(ln_b);
  a.prm = static_cast<const float*>(prm);
  a.lv = static_cast<int8_t*>(lv);
  a.hid = static_cast<int8_t*>(hid);
  a.part = static_cast<int*>(part);
  a.cnt = static_cast<int*>(cnt);
  a.out = out;
  a.out_dt = out_dt;
  a.M = M;
  a.K = K;
  a.H = H;
  a.Kp = Kp;
  a.Hp = Hp;
  a.ln_t = ln_t;
  a.S = S;
  a.tiles2 = (M + tile2 - 1) / tile2 * ((K + tile2 - 1) / tile2);
  a.full2 = full2;
  if (full2 < 0 || full2 > a.tiles2)
    return static_cast<int>(cudaErrorInvalidValue);
  a.act_pow = act_pow;
  a.hid_pow = hid_pow;
  a.act_top = static_cast<float>(act_top);
  a.hid_top = static_cast<float>(hid_top);
  a.eps = eps;
  const uintptr_t xa = reinterpret_cast<uintptr_t>(x);
  const uintptr_t oa = reinterpret_cast<uintptr_t>(out);
  const int xes = x_dt == qvt::DT_F32 ? 4 : 2;
  const int oes = out_dt == qvt::DT_F32 ? 4 : 2;
  // the 16-byte path of phase 1: rows of whole pieces; gamma, beta as
  // float4
  a.x_vec = (xa & 15) == 0 && K % 16 == 0 &&
            (x_dt == qvt::DT_BF16 || x_dt == qvt::DT_F32) &&
            ((reinterpret_cast<uintptr_t>(ln_g) |
              reinterpret_cast<uintptr_t>(ln_b)) & 15) == 0;
  // WeightT::vec_ok, on the host
  a.w1_vec = K % 16 == 0 && (!w1_int4 || (K / 2) % 16 == 0) &&
             (reinterpret_cast<uintptr_t>(w1) & 15) == 0;
  a.w2_vec = H % 16 == 0 && (!w2_int4 || (H / 2) % 16 == 0) &&
             (reinterpret_cast<uintptr_t>(w2) & 15) == 0;
  a.sb1_vec = ((reinterpret_cast<uintptr_t>(s1) |
                reinterpret_cast<uintptr_t>(b1)) & 15) == 0;
  // fc2's epilogue in whole 4-column groups: K % 4 == 0, x and out
  // aligned to 4 elements, s2 and b2 to 16 bytes
  a.quad = K % 4 == 0 && (x_dt == qvt::DT_BF16 || x_dt == qvt::DT_F32) &&
           xa % (4 * xes) == 0 && oa % (4 * oes) == 0 &&
           ((reinterpret_cast<uintptr_t>(s2) |
             reinterpret_cast<uintptr_t>(b2)) & 15) == 0;
  return 0;
}

}  // namespace

// tile1, tile2: fc1's and fc2's output tile (128 or 64; fc1's is 128
// where fc2's is, the instantiations built); ln_t: threads a
// LayerNorm row (8 .. 256, a power of two); full2: fc2's tiles taken
// whole, first; S: the splits of the hidden depth (1 .. its 128-deep
// steps) of each other fc2 tile. lv: scratch [M][Kp], hid: [M][Hp], both
// 16-byte aligned (Kp, Hp multiples of 64, >= K, H); with S > 1, part:
// int32 [split tiles * S][tile2 * tile2] and cnt: int32 [split tiles],
// 8-byte aligned (ops/fused.py:mlp_layout picks all of it; run_mlp
// allocates).
extern "C" int qvt_fused_mlp(
    const void* x, int x_dt, const void* w1, int w1_int4, const void* s1,
    const void* b1, const void* w2, int w2_int4, const void* s2,
    const void* b2, const void* ln_g, const void* ln_b, const void* prm,
    void* lv, void* hid, void* part, void* cnt, void* out, int out_dt, int M,
    int K, int H, int Kp, int Hp, int ln_t, int tile1, int tile2,
    int full2, int S, int act_pow, int hid_pow, int act_top, int hid_top,
    float eps, void* stream) {
  Args a;
  const int err = set_args(a, x, x_dt, w1, w1_int4, s1, b1, w2, w2_int4, s2,
                           b2, ln_g, ln_b, prm, lv, hid, part, cnt, out,
                           out_dt, M, K, H, Kp, Hp, ln_t, tile1, tile2,
                           full2, S, act_pow, hid_pow, act_top, hid_top,
                           eps);
  if (err) return err;
  NoCopy none;
  return launch_tiles<false>(a, none, tile1, tile2, stream);
}

// K15: K2's arguments, then the copy jobs (host arrays of pointers and
// sizes) and the split of their bytes into chunks (chunk: bytes a chunk,
// a multiple of 4096; chunks: their count; ops/fused.py:gather_split).
extern "C" int qvt_fused_mlp_gather(
    const void* x, int x_dt, const void* w1, int w1_int4, const void* s1,
    const void* b1, const void* w2, int w2_int4, const void* s2,
    const void* b2, const void* ln_g, const void* ln_b, const void* prm,
    void* lv, void* hid, void* part, void* cnt, void* out, int out_dt, int M,
    int K, int H, int Kp, int Hp, int ln_t, int tile1, int tile2,
    int full2, int S, int act_pow, int hid_pow, int act_top, int hid_top,
    float eps, const long long* src, const long long* dst,
    const long long* bytes, int n_jobs, long long chunk, int chunks,
    void* stream) {
  Args a;
  int err = set_args(a, x, x_dt, w1, w1_int4, s1, b1, w2, w2_int4, s2, b2,
                     ln_g, ln_b, prm, lv, hid, part, cnt, out, out_dt, M, K,
                     H, Kp, Hp, ln_t, tile1, tile2, full2, S, act_pow,
                     hid_pow, act_top, hid_top, eps);
  if (err) return err;
  Copy c;
  err = qvt::fill_jobs(c.jb, src, dst, bytes, n_jobs);
  if (err) return err;
  c.chunk = chunk;
  c.chunks = chunks;
  if (chunk < 4096 || chunk % 4096 || chunks < 0 ||
      qvt::count_chunks(c.jb, chunk) != chunks)
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_tiles<true>(a, c, tile1, tile2, stream);
}

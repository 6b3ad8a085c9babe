// K10-K12: the integer GEMMs of quantized_vit_tpu/ops/int4_matmul.py, for
// Hopper (sm_90a).
//
// One kernel with three front ends replaces three TPU kernels:
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
// Bound on this card (H100 SXM: 1,979 TOPS int8, 3.35 TB/s; each input
// read once, each output written once) at ViT-B/16's layer shapes, M =
// 1664 (qkv / proj / fc1 / fc2): K10 with f32 out 5.23 / 2.00 / 6.84 us
// (bytes) / 3.97 (operations), K11 5.49 / 2.09 / 7.20 / 3.97, K12 (bf16
// x and out) 3.32 / 1.62 / 4.17 / 4.17 (bytes).
//
// Design: one launch of a persistent grid, one block an SM of two
// consumer warpgroups and one producer warp (288 threads), in two phases.
//   1. The front end, once a row (cooperative launches only): K12's
//      levels of x (gemm_phases.cuh:row_levels under ROWS_FA, the true
//      division; act_pow is its POW template argument), or a copy of int8
//      levels that TMA cannot read in place, into a level scratch
//      lv [Mr][Kp] (Kp = the weight copy's depth, K rounded up to whole
//      16-byte TMA pieces and at least 128, zeros past K; Mr = M, at least
//      a token tile), a row to a group of 8-32 consumer threads; then a
//      grid barrier with fence.proxy.async on both sides (plain stores
//      read by TMA). Int8 levels whose rows TMA can read as they stand
//      (16-byte aligned, K the weight copy's depth, M at least a token
//      tile) skip it: a plain launch. The first K12 re-quantized its raw
//      x tile in every block of a row stripe, 6-24 times a row.
//   2. The GEMM on wgmma (wgmma_int8.cuh): an item is 128 output features
//      (the two warpgroups' 64 each) x NW tokens (64, 96 or 128) over a
//      range of the depth, outT = W lvT: the weight is the A operand, the
//      tokens the B operand, both K-major as the plan's n-major copy and
//      the row-major levels already are. Weight and token tiles arrive
//      through a ring of 2-8 stages, each one 128-byte step of the weight
//      rows, written by TMA from CUtensorMaps under the 128-byte swizzle
//      (the weight's encoded once a plan and layout, the tokens' when
//      their buffer moves), guarded by a full and an empty mbarrier; the
//      producer warp keeps the ring ahead of the consumers across items.
//      Int8 weights feed wgmma from shared memory (m64nNk32, both
//      operands through descriptors). wgmma has no int4 operand: a packed
//      step holds 128 bytes of a weight row, levels k' (low nibbles) and
//      k' + Kh (high nibbles; Kh = the packed row width), so a stage
//      holds the packed tile and both depth ranges' token tiles, and each
//      consumer thread loads its A fragment's bytes from the swizzled
//      tile and sign-extends the nibbles into two register fragments
//      (wgmma with A from registers, MmaR, as K5): each packed byte
//      crosses shared memory once.
// The work split (ops/int4_matmul.py:int_matmul_layout, from M, K, N and
// the card's SMs): the token tile NW, the tiles taken whole (the first
// `full`), and the splits S of the depth of each other tile. A split
// item writes its int32 sums from its fragments to a partial buffer in
// whole 16-byte pieces, thread-major (coalesced); the tile's last split
// to arrive (an atomicInc count that wraps back to zero, so the counts,
// which the wrapper keeps zeroed once, need no reset) adds the others'
// into its fragments. Int32 sums are exact: no split moves a bit. At
// ViT-B/16's sites (M = 1664) on an H100 whole tiles beat every split
// (a partial tile costs more L2 bytes than the steps it saves): 128
// tokens at qkv and fc1 (234 and 312 tiles), 96 at proj and fc2 (108
// tiles in one wave, where 78 of 128 leave 54 SMs idle); the splits
// serve deep weights at few tiles (ViT-B's fc2 at batch 1: 12 tiles).
// The epilogue transposes through shared memory: a warpgroup stages its
// 64 x NW accumulators 32 tokens at a time as [token][feature] int32, then
// a token row to 16 threads, each 4 features: acc.f32 * scale, then
// + bias (two roundings, -fmad=false), then f32 or bf16 (whole 16- or
// 8-byte stores: store4) or the requant (rintf, half to even, clipped to
// +-top; 4 levels a store). Ragged M and N are masked there; ragged K is
// zeros in the padded weight copy, the scratch and TMA's out-of-bounds
// fill. The first K10-K12 ran mma.sync on 128 x 128 tiles with a 2-stage
// cp.async pipeline and stored single elements from the fragments.
//
// Numerics: those of the plain versions (ops/int4_matmul.py): the levels
// are _fa_quant's in f32 (-fmad=false, rintf, the true division), the
// int32 products are exact in any order, split or not, and the epilogue
// is the plain version's f32 arithmetic in its order.

#include <cooperative_groups.h>

#include <algorithm>
#include <cstring>

#include "gemm_phases.cuh"
#include "wgmma_int8.cuh"

namespace cg = cooperative_groups;
namespace wg = qvt::wg;

namespace qvt {
namespace wg {

// m64n96k32, the 96-token tile's products (wgmma_int8.cuh's Mma and MmaR
// at N = 96; the header's other users take 32-256 by powers of two)
template <>
struct Mma<96> {
  __device__ __forceinline__ static void run(int (&d)[48], uint64_t a,
                                             uint64_t b, int acc) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %50, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n96k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47"
        "}, %48, %49, p;\n}\n"
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
          "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47])
        : "l"(a), "l"(b), "r"(acc));
  }
};

template <>
struct MmaR<96> {
  __device__ __forceinline__ static void run(int (&d)[48],
                                             const uint32_t (&a)[4],
                                             uint64_t b, int acc) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %53, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n96k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47"
        "}, {%48, %49, %50, %51}, %52, p;\n}\n"
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
          "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
  }
};

}  // namespace wg
}  // namespace qvt

namespace {

// output features an item (the wgmma M of the two warpgroups), weight
// bytes a ring step (one 128-byte swizzled row), consumer warpgroups and
// threads, the block
constexpr int ROWS = 128, WG_ROWS = 64, BK = 128, CWG = 2, CT = 128 * CWG,
              NT = CT + 32;
// the row group of consumer threads in phase 1: LN_MIN_T .. LN_MAX_T (no
// block barrier inside row_levels, which the producer warp skips)
constexpr int LN_MIN_T = 8, LN_MAX_T = 32;
// ring stages at most; dynamic shared memory a block may take
constexpr int MAX_STAGES = 8, SMEM_DYN = 231424;
// the epilogue's stage, a warpgroup's: EPI_T tokens x 64 features of
// int32, rows EPI_RS apart (the fragments' stores fall in distinct banks)
constexpr int EPI_T = 32, EPI_RS = WG_ROWS + 4;
constexpr int EPI_BYTES = CWG * EPI_T * EPI_RS * 4;
// phase 1: none (x's levels read in place), a copy of int8 levels, K12's
// quantizer
enum { PRO_NONE = 0, PRO_COPY = 1, PRO_FA = 2 };
// named barriers: the consumers, then each warpgroup's
constexpr int CBAR = 1, WBAR = 2;

struct Args {
  CUtensorMap tm_w;  // the weight copy [Np][Wb] bytes, 128 x 128 boxes
  CUtensorMap tm_a;  // the token levels (x or lv) [rows][Kp], 128 x NW
  const void* x;
  int x_dt;
  const float* scale;  // [N]
  const float* bias;   // [N] or null
  const float* prm;    // K12: d, t
  const int* top;      // K12: the clamp level
  int8_t* lv;          // phase 1's level scratch [Mr][Kp]
  int* part;           // int32 partials, one a split item
  int* cnt;            // arrivals a split tile, zero between launches
  void* out;
  int out_dt;
  int requant;
  float requant_top;
  int M, K, N, Kp;
  int kh;     // int4: the packed row width, the high range's offset
  int steps;  // 128-byte steps of a weight row
  int pro, act_pow, ln_t;
  int tn, tiles, full, S;  // feature tiles; all tiles; whole; splits
  int stages, stage_bytes;
  bool x_vec, quad;
};

// what row_levels reads (gemm_phases.cuh), K12's clamp level read from
// device memory
struct RowArgs {
  const void* x;
  int x_dt, K, Kp, M, ln_t;
  const float* ln_g;
  const float* ln_b;
  const float* prm;
  float act_top, eps;
  bool x_vec;
  int8_t* lv;
};

// Phase 1: the levels of x (or a copy of its levels) into a.lv, by the
// consumer threads
__device__ __forceinline__ void levels(const Args& a) {
  RowArgs r{a.x,   a.x_dt, a.K, a.Kp, a.M, a.ln_t, nullptr, nullptr,
            a.prm, 0.f,    0.f, a.x_vec, a.lv};
  if (a.pro == PRO_COPY) {
    qvt::row_levels<qvt::ROWS_COPY, false, CT>(r);
    return;
  }
  r.act_top = static_cast<float>(__ldg(a.top));
  if (a.act_pow)
    qvt::row_levels<qvt::ROWS_FA, true, CT>(r);
  else
    qvt::row_levels<qvt::ROWS_FA, false, CT>(r);
}

__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync %0, %1;\n" ::"n"(CBAR), "n"(CT) : "memory");
}

__device__ __forceinline__ void warpgroup_sync(int w) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(WBAR + w), "n"(128) : "memory");
}

// work item `it`: its features from f0, tokens from t0, the 128-byte
// steps [k0, k1); q: its index among the split items (-1: a whole tile)
struct Item {
  int f0, t0, k0, k1, q;
};

template <int NW>
__device__ __forceinline__ Item item_of(const Args& a, int it) {
  Item r;
  const int q = it - a.full;
  const int tile = it < a.full ? it : a.full + q / a.S;
  const int sp = it < a.full ? 0 : q - (tile - a.full) * a.S;
  r.f0 = tile % a.tn * ROWS;
  r.t0 = tile / a.tn * NW;
  r.k0 = it < a.full ? 0 : sp * a.steps / a.S;
  r.k1 = it < a.full ? a.steps : (sp + 1) * a.steps / a.S;
  r.q = it < a.full ? -1 : q;
  return r;
}

__device__ __forceinline__ int items(const Args& a) {
  return a.full + (a.tiles - a.full) * a.S;
}

// The producer (one thread): the ring's stages for this block's items, in
// the consumers' order: the weight box, then the token box of each depth
// range (int4: k' and Kh + k')
template <int NW, bool W4>
__device__ __forceinline__ void produce(const Args& a, uint8_t* ring,
                                        uint64_t* full, uint64_t* empty) {
  constexpr uint32_t BYTES = (ROWS + (W4 ? 2 : 1) * NW) * BK;
  uint32_t it = 0;
  for (int item = blockIdx.x; item < items(a); item += gridDim.x) {
    const Item t = item_of<NW>(a, item);
    for (int ks = t.k0; ks < t.k1; ++ks, ++it) {
      const int s = it % a.stages;
      wg::mbar_wait(&empty[s], ((it / a.stages) & 1) ^ 1);
      uint8_t* st = ring + s * a.stage_bytes;
      wg::mbar_arrive_tx(&full[s], BYTES);
      wg::tma_load_2d(st, &a.tm_w, ks * BK, t.f0, &full[s]);
      wg::tma_load_2d(st + ROWS * BK, &a.tm_a, ks * BK, t.t0, &full[s]);
      if (W4)
        wg::tma_load_2d(st + (ROWS + NW) * BK, &a.tm_a, a.kh + ks * BK,
                        t.t0, &full[s]);
    }
  }
}

// A split item's int32 sums: its fragments to the partial buffer (int4
// pieces, [item][warpgroup][piece][thread]); the tile's last split to
// arrive adds the others' into its fragments and returns true (for every
// consumer thread), the others false
template <int NW>
__device__ __forceinline__ bool split_sum(const Args& a, int (&d)[NW / 2],
                                          int q, int* s_last) {
  constexpr int V = NW / 8;  // int4 pieces a thread
  const int w = threadIdx.x / 128, tid = threadIdx.x & 127;
  const int tile = q / a.S, sp = q - tile * a.S;
  int4* part = reinterpret_cast<int4*>(a.part);
  int4* mine = part + (static_cast<long long>(q) * CWG + w) * V * 128 + tid;
#pragma unroll
  for (int i = 0; i < V; ++i)
    mine[i * 128] = make_int4(d[4 * i], d[4 * i + 1], d[4 * i + 2],
                              d[4 * i + 3]);
  __threadfence();
  consumer_sync();
  if (threadIdx.x == 0)
    *s_last = atomicInc(reinterpret_cast<unsigned*>(a.cnt + tile),
                        static_cast<unsigned>(a.S - 1)) ==
              static_cast<unsigned>(a.S - 1);
  consumer_sync();
  if (!*s_last) return false;
  __threadfence();
  for (int o = 0; o < a.S; ++o) {
    if (o == sp) continue;
    const int4* other =
        part + ((static_cast<long long>(tile) * a.S + o) * CWG + w) * V * 128 +
        tid;
#pragma unroll
    for (int i0 = 0; i0 < V; i0 += 4) {
      int4 v[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) v[i] = __ldcg(other + (i0 + i) * 128);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        d[4 * (i0 + i)] += v[i].x;
        d[4 * (i0 + i) + 1] += v[i].y;
        d[4 * (i0 + i) + 2] += v[i].z;
        d[4 * (i0 + i) + 3] += v[i].w;
      }
    }
  }
  return true;
}

// The epilogue of a warpgroup's 64 features x NW tokens: staged EPI_T
// tokens at a time as [token][feature], then a token row to 16 threads,
// each 4 features (the same 4 for every row, so their scale and bias load
// once)
template <int NW>
__device__ __forceinline__ void epilogue(const Args& a, const int (&d)[NW / 2],
                                         const Item& t, int* stage) {
  const int w = threadIdx.x / 128, tid = threadIdx.x & 127;
  const int lane = threadIdx.x & 31, wq = tid >> 5, g = lane >> 2,
            tq = lane & 3;
  const int c4 = tid & 15, r8 = tid >> 4;  // 4-feature group, token row
  const int f = t.f0 + w * WG_ROWS + 4 * c4;
  float sc[4] = {0.f, 0.f, 0.f, 0.f}, bi[4] = {0.f, 0.f, 0.f, 0.f};
  if (a.quad && f < a.N) {
    const float4 s4 = __ldg(reinterpret_cast<const float4*>(a.scale + f));
    sc[0] = s4.x, sc[1] = s4.y, sc[2] = s4.z, sc[3] = s4.w;
    if (a.bias) {
      const float4 b4 = __ldg(reinterpret_cast<const float4*>(a.bias + f));
      bi[0] = b4.x, bi[1] = b4.y, bi[2] = b4.z, bi[3] = b4.w;
    }
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (f + e < a.N) {
        sc[e] = __ldg(a.scale + f + e);
        if (a.bias) bi[e] = __ldg(a.bias + f + e);
      }
  }
#pragma unroll
  for (int c = 0; c < NW / EPI_T; ++c) {
#pragma unroll
    for (int jj = 0; jj < EPI_T / 8; ++jj)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          stage[(8 * jj + 2 * tq + e) * EPI_RS + 16 * wq + g + 8 * hh] =
              d[4 * (c * EPI_T / 8 + jj) + 2 * hh + e];
    warpgroup_sync(w);
#pragma unroll
    for (int rr = 0; rr < EPI_T / 8; ++rr) {
      const int tok = 8 * rr + r8, row = t.t0 + c * EPI_T + tok;
      if (row >= a.M || f >= a.N) continue;
      const int4 v4 = *reinterpret_cast<const int4*>(stage + tok * EPI_RS +
                                                     4 * c4);
      const int acc[4] = {v4.x, v4.y, v4.z, v4.w};
      float y[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        y[e] = static_cast<float>(acc[e]) * sc[e];
        if (a.bias) y[e] = y[e] + bi[e];
      }
      const long long o = static_cast<long long>(row) * a.N + f;
      if (a.quad) {
        if (a.requant)
          *reinterpret_cast<uint32_t*>(static_cast<int8_t*>(a.out) + o) =
              static_cast<uint8_t>(qvt::clip_round(y[0], a.requant_top)) |
              static_cast<uint8_t>(qvt::clip_round(y[1], a.requant_top))
                  << 8 |
              static_cast<uint8_t>(qvt::clip_round(y[2], a.requant_top))
                  << 16 |
              static_cast<uint32_t>(static_cast<uint8_t>(
                  qvt::clip_round(y[3], a.requant_top)))
                  << 24;
        else
          qvt::store4(a.out, a.out_dt, o, y);
        continue;
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (f + e >= a.N) break;
        if (a.requant)
          static_cast<int8_t*>(a.out)[o + e] =
              qvt::clip_round(y[e], a.requant_top);
        else
          qvt::store_f(a.out, a.out_dt, o + e, y[e]);
      }
    }
    warpgroup_sync(w);  // the stage is rewritten by the next chunk
  }
}

// A consumer warpgroup: its 64 features of each of this block's items,
// stage by stage (four k32 products a depth range a stage, waited for at
// once, so the stage goes back to the producer early; every consumer warp
// releases each stage), then the split's sums and the epilogue.
template <int NW, bool W4>
__device__ __forceinline__ void consume(const Args& a, uint8_t* ring,
                                        uint64_t* full, uint64_t* empty,
                                        int* stage, int* s_last) {
  const int w = threadIdx.x / 128, lane = threadIdx.x & 31;
  const int wq = (threadIdx.x >> 5) & 3, g = lane >> 2, t = lane & 3;
  // rows 16 wq + g and + 8 of the warpgroup's weight rows; depth bytes 4t
  // of the two 16-byte pieces of each k32 step, under the swizzle
  const int ra = 16 * wq + g, rb = ra + 8;
  uint32_t it = 0;
  for (int item = blockIdx.x; item < items(a); item += gridDim.x) {
    const Item tI = item_of<NW>(a, item);
    int d[NW / 2];
#pragma unroll
    for (int i = 0; i < NW / 2; ++i) d[i] = 0;
    for (int ks = tI.k0; ks < tI.k1; ++ks, ++it) {
      const int s = it % a.stages;
      wg::mbar_wait(&full[s], (it / a.stages) & 1);
      const uint8_t* st = ring + s * a.stage_bytes;
      const uint8_t* wt = st + w * WG_ROWS * BK;
      const uint64_t db = wg::desc_sw128(st + ROWS * BK);
      if constexpr (W4) {
        const uint64_t dh = wg::desc_sw128(st + (ROWS + NW) * BK);
        uint32_t af[2][BK / 32][4];
#pragma unroll
        for (int kk = 0; kk < BK / 32; ++kk)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int pc = 2 * kk + h;
            const uint32_t u0 = *reinterpret_cast<const uint32_t*>(
                wt + ra * BK + ((pc ^ (ra & 7)) << 4) + 4 * t);
            const uint32_t u1 = *reinterpret_cast<const uint32_t*>(
                wt + rb * BK + ((pc ^ (rb & 7)) << 4) + 4 * t);
            af[0][kk][2 * h] = qvt::nibbles(u0, false);
            af[0][kk][2 * h + 1] = qvt::nibbles(u1, false);
            af[1][kk][2 * h] = qvt::nibbles(u0, true);
            af[1][kk][2 * h + 1] = qvt::nibbles(u1, true);
          }
        wg::fence_regs(d);
        wg::fence();
#pragma unroll
        for (int kk = 0; kk < BK / 32; ++kk) {
          wg::MmaR<NW>::run(d, af[0][kk], db + 2 * kk, 1);
          wg::MmaR<NW>::run(d, af[1][kk], dh + 2 * kk, 1);
        }
      } else {
        const uint64_t da = wg::desc_sw128(wt);
        wg::fence_regs(d);
        wg::fence();
#pragma unroll
        for (int kk = 0; kk < BK / 32; ++kk)
          wg::Mma<NW>::run(d, da + 2 * kk, db + 2 * kk, 1);
      }
      wg::commit();
      wg::wait<0>();
      wg::fence_regs(d);
      if (lane == 0) wg::mbar_arrive(&empty[s]);
    }
    if (tI.q >= 0 && !split_sum<NW>(a, d, tI.q, s_last)) continue;
    epilogue<NW>(a, d, tI, stage + w * EPI_T * EPI_RS);
  }
}

template <int NW, bool W4>
__global__ void __launch_bounds__(NT, 1)
    int_mm_kernel(const __grid_constant__ Args a) {
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  __shared__ int s_last;
  uint8_t* ring = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full =
      reinterpret_cast<uint64_t*>(ring + a.stages * a.stage_bytes);
  uint64_t* empty = full + MAX_STAGES;
  int* stage = reinterpret_cast<int*>(empty + MAX_STAGES);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int s = 0; s < a.stages; ++s) {
      wg::mbar_init(&full[s], 1);
      wg::mbar_init(&empty[s], CT / 32);
    }
    wg::mbar_fence_init();
  }
  __syncthreads();
  qvt::PhaseClock clk;  // tools/phase_probe.py int_matmul
  clk.begin();
  const bool producer = warp == CT / 32;
  if (a.pro != PRO_NONE) {  // a cooperative launch
    if (!producer) levels(a);
    wg::fence_proxy_async();  // lv's plain stores before the TMA reads
    clk.mark(0);
    cg::this_grid().sync();
    clk.mark(1);
  }
  if (producer) {
    if (lane == 0) {
      wg::fence_proxy_async();
      produce<NW, W4>(a, ring, full, empty);
    }
  } else {
    consume<NW, W4>(a, ring, full, empty, stage, &s_last);
  }
  clk.mark(2);
  clk.store(blockIdx.x);
}

using Kernel = void (*)(Args);

// the kernel of token tile nw and weight format (null where not built: at
// nw 256 the 128 accumulators a thread hit the 168 registers that 288
// threads leave, spilled, and ran slower than nw 128 at every ViT-B site
// on an H100)
Kernel kernel_of(int nw, int w4) {
  if (nw == 64) {
    if (w4) return int_mm_kernel<64, true>;
    return int_mm_kernel<64, false>;
  }
  if (nw == 96) {
    if (w4) return int_mm_kernel<96, true>;
    return int_mm_kernel<96, false>;
  }
  if (nw == 128) {
    if (w4) return int_mm_kernel<128, true>;
    return int_mm_kernel<128, false>;
  }
  return nullptr;
}

// blocks of `k` co-resident on an SM at `smem` bytes (0 on an error)
int per_sm(Kernel k, int smem) {
  if (cudaFuncSetAttribute(reinterpret_cast<const void*>(k),
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           SMEM_DYN) != cudaSuccess)
    return 0;
  int v = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &v, reinterpret_cast<const void*>(k), NT, smem) != cudaSuccess)
    return 0;
  return v;
}

// The host's part, once a plan and layout (qvt_int_mm_prepare): the
// weight's map, the layout, the ring and the grid; the token map of the
// buffer it was last encoded for.
struct State {
  CUtensorMap tm_w, tm_a;
  const void* a_at;
  int M, K, N, Kp, kh, steps, w4, nw, pro, ln_t, tn, tiles, full, S;
  int rows;  // the token buffer's rows
  int stages, stage_bytes, smem, grid;
};

State* state_of(void* p) {
  return reinterpret_cast<State*>((reinterpret_cast<uintptr_t>(p) + 63) &
                                  ~uintptr_t(63));
}

}  // namespace

// Bytes of the host state a caller allocates for one plan and layout (a
// CUtensorMap is 64-byte aligned: the state starts at the first 64-byte
// boundary of the buffer).
extern "C" int qvt_int_mm_state_bytes() {
  return static_cast<int>(sizeof(State)) + 64;
}

// Once a plan and layout (ops/int4_matmul.py:int_matmul_layout): checks
// it, encodes the weight's map (w: the plan's n-major copy [np][wb]
// bytes, int8 levels or packed int4, wb a multiple of 16 and at least 128,
// np a multiple of 128 and at least N; its depth in levels Kw = wb, or 2
// wb packed, at least K), sizes the ring and the grid on the current
// device. pro: 0 reads x's int8 levels in place (K == Kw, M >= nw), 1
// copies them into the scratch, 2 quantizes a float x into it (K12); the
// scratch (and x read in place) is [rows][Kw], rows = max(M, nw). ln_t:
// phase 1's threads a row (8, 16, 32); nw: the token tile (64, 96, 128);
// full: the tiles taken whole; S: the splits of
// each other tile's steps (1 .. steps); stages: 2 .. 8.
extern "C" int qvt_int_mm_prepare(void* state, const void* w, int w4, int wb,
                                  int np, int M, int K, int N, int pro,
                                  int ln_t, int nw, int full, int S,
                                  int stages) {
  State* s = state_of(state);
  const Kernel k = kernel_of(nw, w4);
  const int kw = w4 ? 2 * wb : wb;
  const int tn = (N + ROWS - 1) / ROWS;
  const long long tiles = static_cast<long long>(tn) * ((M + nw - 1) / nw);
  const int steps = (wb + BK - 1) / BK;
  const int stage_bytes = (ROWS + (w4 ? 2 : 1) * nw) * BK;
  const int smem = 1024 + stages * stage_bytes + 16 * MAX_STAGES + EPI_BYTES;
  if (k == nullptr || M < 1 || K < 1 || N < 1 || wb % 16 || wb < BK ||
      np % ROWS || np < N || K > kw || pro < PRO_NONE || pro > PRO_FA ||
      (pro == PRO_NONE && (K != kw || M < nw)) ||
      (pro != PRO_NONE && (ln_t < LN_MIN_T || ln_t > LN_MAX_T ||
                           (ln_t & (ln_t - 1)))) ||
      tiles > (1 << 30) || full < 0 || full > tiles || S < 1 || S > steps ||
      (S == 1 && full != tiles) || stages < 2 || stages > MAX_STAGES ||
      smem > SMEM_DYN || (reinterpret_cast<uintptr_t>(w) & 15))
    return static_cast<int>(cudaErrorInvalidValue);
  std::memset(static_cast<void*>(s), 0, sizeof(State));
  const int e = qvt::encode_tiled_int8(&s->tm_w, w, wb, np, wb, ROWS);
  if (e) return e;
  s->M = M;
  s->K = K;
  s->N = N;
  s->Kp = kw;
  s->kh = w4 ? wb : 0;
  s->steps = steps;
  s->w4 = w4;
  s->nw = nw;
  s->pro = pro;
  s->ln_t = ln_t;
  s->tn = tn;
  s->tiles = static_cast<int>(tiles);
  s->full = full;
  s->S = S;
  s->rows = std::max(M, nw);
  s->stages = stages;
  s->stage_bytes = stage_bytes;
  s->smem = smem;
  int dev = 0, sms = 0;
  cudaError_t ce = cudaGetDevice(&dev);
  if (ce == cudaSuccess)
    ce = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (ce != cudaSuccess) return static_cast<int>(ce);
  const int cap = per_sm(k, smem) * sms;
  if (cap < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  // enough blocks for the larger phase: row groups, GEMM items
  long long want = full + (tiles - full) * static_cast<long long>(S);
  if (pro != PRO_NONE)
    want = std::max<long long>(want, (M + CT / ln_t - 1) / (CT / ln_t));
  s->grid = static_cast<int>(std::min<long long>(cap, want));
  return 0;
}

// One launch for the prepared plan and layout: x [M, K] (int8 levels, or
// f32/bf16 under pro 2 with prm = [d, t] and top on the device); scale
// [N] and bias [N] or null (f32); lv: the scratch [rows][Kw] int8 (pro
// 1, 2), 16-byte aligned, its map encoded again when it moves (x's when
// read in place); with S > 1 part: int32 [split items][2 * nw * 64] and
// cnt: int32 [split tiles], zero; out [M, N]: int8 levels clipped to
// +-requant_top (requant), else out_dt (f32 or bf16).
extern "C" int qvt_int_matmul(void* state, const void* x, int x_dt,
                              const void* scale, const void* bias,
                              const void* prm, const void* top, void* lv,
                              void* part, void* cnt, void* out, int out_dt,
                              int requant, int requant_top, int act_pow,
                              void* stream) {
  State* s = state_of(state);
  const uintptr_t xa = reinterpret_cast<uintptr_t>(x);
  const bool fl = x_dt == qvt::DT_F32 || x_dt == qvt::DT_BF16;
  const void* src = s->pro == PRO_NONE ? x : lv;
  if ((s->pro == PRO_FA) != fl || (fl && !top) ||
      (s->pro != PRO_NONE && !prm) ||
      (s->pro == PRO_NONE && (xa & 15)) ||
      (reinterpret_cast<uintptr_t>(src) & 15) ||
      (s->S > 1 && (!part || !cnt ||
                    (reinterpret_cast<uintptr_t>(part) & 15))) ||
      (requant != 0) != (out_dt == qvt::DT_INT8))
    return static_cast<int>(cudaErrorInvalidValue);
  if (s->a_at != src) {
    const int e = qvt::encode_tiled_int8(&s->tm_a, src, s->Kp, s->rows,
                                         s->Kp, s->nw);
    if (e) return e;
    s->a_at = src;
  }
  Args a;
  a.tm_w = s->tm_w;
  a.tm_a = s->tm_a;
  a.x = x;
  a.x_dt = x_dt;
  a.scale = static_cast<const float*>(scale);
  a.bias = static_cast<const float*>(bias);
  a.prm = static_cast<const float*>(prm);
  a.top = static_cast<const int*>(top);
  a.lv = static_cast<int8_t*>(lv);
  a.part = static_cast<int*>(part);
  a.cnt = static_cast<int*>(cnt);
  a.out = out;
  a.out_dt = out_dt;
  a.requant = requant;
  a.requant_top = static_cast<float>(requant_top);
  a.M = s->M;
  a.K = s->K;
  a.N = s->N;
  a.Kp = s->Kp;
  a.kh = s->kh;
  a.steps = s->steps;
  a.pro = s->pro;
  a.act_pow = act_pow;
  a.ln_t = s->ln_t;
  a.tn = s->tn;
  a.tiles = s->tiles;
  a.full = s->full;
  a.S = s->S;
  a.stages = s->stages;
  a.stage_bytes = s->stage_bytes;
  // phase 1's 16-byte path: rows of whole pieces of a float x
  a.x_vec = fl && (xa & 15) == 0 && s->K % (x_dt == qvt::DT_BF16 ? 8 : 4) == 0;
  // the epilogue in whole 4-feature groups: N % 4 == 0, out aligned to 4
  // elements, scale and bias to 16 bytes
  const int oes = out_dt == qvt::DT_INT8 ? 1 : out_dt == qvt::DT_F32 ? 4 : 2;
  a.quad = s->N % 4 == 0 &&
           reinterpret_cast<uintptr_t>(out) % (4 * oes) == 0 &&
           ((reinterpret_cast<uintptr_t>(scale) |
             reinterpret_cast<uintptr_t>(bias)) & 15) == 0;
  const Kernel k = kernel_of(s->nw, s->w4);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (s->pro == PRO_NONE) {
    k<<<s->grid, NT, s->smem, st>>>(a);
    return static_cast<int>(cudaGetLastError());
  }
  void* args[] = {&a};
  cudaError_t e = cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(k), dim3(s->grid), dim3(NT), args, s->smem, st);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

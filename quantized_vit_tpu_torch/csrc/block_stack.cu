// K5: the whole ViT block stack in one launch, for Hopper (sm_90a).
//
// Replaces the TPU kernel quantized_vit_tpu/ops/block_stack.py:
// _block_stack_kernel (:65; pallas_call in _vit_block_stack,
// block_stack.py:341), the batch-1 latency path: x [j*n, D] -> x after
// `depth` blocks, each
//   x2 = round(x + proj(quant(attn(qkv(quant(LN1(x)))))))
//   x  = round(x2 + fc2(quant(GELU(fc1(quant(LN2(x2)))))))
// (round: to the residual dtype) with every block's own stacked weights,
// vectors and quantizer scalars ([L][8] on the device). The TPU kernel's
// point is one dispatch for the whole depth, and so is this kernel's.
//
// Bound on this card (H100 SXM, 1,979 TOPS int8, 3.35 TB/s): 2 M (3HD D +
// HD D + 2 D hid) int8 ops a block plus the attention's 4 M n HD at the
// bf16 rate, against the packed weights (read once) and x in and out:
//   ViT-B/16 224 px (M 208, L 12): 35.3 G ops 17.9 us + 1.6 G attention
//     ops 1.6 us, 42.5 MB of int4 weights 12.7 us: 19.5 us, operations;
//   ViT-B/16 384 px (M 592): 100.6 G ops 50.8 us + 12.9 G 13.0 us, the
//     same 42.5 MB: 63.8 us, operations.
//
// Design: one cooperative launch of a persistent grid, one block an SM:
// two consumer warpgroups and one producer warp (288 threads). A block
// of the stack is five phases, each ended by a grid barrier:
//   1. qkv: q/k/v^T = Wq lv^T on wgmma m64nNk32 s8, the weight the A
//      operand (64 output features a warpgroup), the token rows the B
//      operand (N = 32, 64 or 128 rows, the chunk rounded up). An item is
//      128 features x one token chunk, each warpgroup its 64. Epilogue
//      acc * qs + qb, rounded to the residual dtype, into a q/k/v scratch
//      [M][3HD] in that dtype (the values are rounded already, so the
//      bits are an f32 scratch's; half the bytes in bf16).
//   2. attention: K6's tile (qkv_attention.cuh:qkv_attn_tile, as K3's
//      third phase runs it, on a named barrier of the consumers) over
//      (image, head, R query rows) items, K/V streamed in 64-key chunks
//      onto mma.sync m16n8k4 .f64, into the int8 levels alv [M][HD]; R =
//      32 or 16 (ops/block_stack.py:stack_layout: the fewest rows a block
//      takes in all, waves of items x R).
//   3. proj: x2 = round(acc * ps + pb + x). An item is 64 features x one
//      token chunk; its weights are few tiles and deep, so the two
//      warpgroups split the depth (every other 128-byte step each) and
//      exchange half their int32 sums in shared memory (exact in any
//      order); each finishes one half of the fragments' rows. Every item
//      owns its outputs' whole sums: no split-K across blocks, no atomics
//      on sums. Each item then counts its token chunk's arrival; once a
//      block's items are done, it waits for each of its chunks to arrive
//      from every weight tile and computes its share of the chunk's LN2 +
//      quant rows (a warp a row, ln_rows) into lv.
//   4. fc1: as qkv, the epilogue the folded GELU-quant (or GELU, then the
//      pow quantizer) into the hidden levels hlv [M][hid].
//   5. fc2: as proj, x = round(acc * s2 + b2 + x2), and the next block's
//      LN1 rows.
// Block 0's LN1 rows come from a row phase before the first barrier. So
// the grid barriers number 5 a block (5 L in all: 60 at depth 12, where
// the first K5 had 7 a block, 85): lv before qkv, the q/k/v scratch before
// the attention, alv before proj, x2 and lv before fc1, hlv before fc2,
// x and lv before the next qkv and proj. The row phases fold into the
// GEMMs' arrivals (a wait for 12 blocks, not a grid barrier).
//
// The GEMM operands come through a ring of 3-16 stages in shared memory,
// each one 128-byte-deep step (the item's weight tiles and its chunk's
// token tiles) written by TMA from CUtensorMaps (the weights' encoded once
// a plan and layout, the scratch's when it moves) under the 128-byte
// swizzle, guarded by a full and an empty mbarrier a stage; the producer
// warp keeps the ring ahead of the consumers across items, and the weight
// stream does not depend on the activations: before the barriers after
// proj, fc1 and fc2 it loads the next GEMM phase's first weight tiles
// (their bytes expected on the stage's full barrier without an arrival;
// the token tiles complete it after the barrier). The attention's shared
// memory is the ring's: nothing crosses the two barriers around it. The
// ring takes about 128 KB (ops/block_stack.py:STACK_RING): what the
// launch leaves of the SM's 228 KB is its L1 cache, which holds the
// kernel's register spills (a block has 168 registers a thread with 9
// warps: 3 warps share a sub-partition's 16384), where a ring filling
// the shared memory leaves 25 KB (tools/stack_design.py times both). The
// token chunks come from the wrapper (stack_layout: K8's one-wave rule
// for each phase's features).
//
// Packed int4 weights: wgmma takes s8 operands only. The packed byte k'
// of a weight row holds levels k' (low nibble) and k' + Kh (high), Kh =
// the packed row width (the plan repacks a weight whose K / 2 is off 128
// bytes at a half of 128-byte multiples). So one packed 64 x 128 tile is
// the A operand of two depth ranges, [c, c + 128) and [c + Kh, c + Kh +
// 128): a stage holds the packed tile and both ranges' token tiles, and
// each consumer thread loads its A fragment's bytes (4 x 4 a k32 step)
// from the swizzled tile and sign-extends the nibbles straight into two
// register fragments (wgmma with A from registers, MmaR). The other way,
// an unpack stage in shared memory between the TMA and the products,
// writes and reads every level once more and needs a barrier of the
// warpgroup and a proxy fence a stage; from registers the packed bytes
// are read once, 16 a thread, with no bank conflict. Int8 weights take
// the same path, their bytes as they are (one kernel for both formats).
//
// L2 -> SM traffic a transformer block at ViT-B/16 224 px, packed int4
// (stack_layout: qkv 18 tiles of 128 features x 7 chunks of 32 rows,
// proj and fc2 12 tiles of 64 x 9 chunks of 24, fc1 24 x 5 chunks of 48;
// each weight tile read once a chunk, each chunk's tiles once a weight
// tile): qkv 9.3 MB, proj 4.6, fc1 10.3, fc2 18.6, 42.8 MB, 0.51 GB over
// the depth (StackLayout.l2_bytes). The first K5's 32 x 64 tiles read
// each block's 3.54 MB of weights 7 times, plus its split-K atomics.
//
// Against the first K5 (its note's items):
//   1. small synchronous mma.sync tiles: wgmma fed by the TMA ring;
//   2. split-K int32 atomics for proj and fc2, accumulators zeroed every
//      block: items cut features x tokens, the depth split only between
//      a block's two warpgroups, so the epilogue writes x2 / x;
//   3. seven grid barriers a block: five;
//   4. attention on the half-rate m8n8k4 .f64 core with all key rows in
//      shared memory (about 380 at most, head_dim <= 64, 48 units at
//      ViT-B batch 1): K6's streamed tile, any key count, heads to 80;
//   5. rows kept in registers (D <= 1024): a warp a row, any width;
//   6. an f32 qkv scratch: the residual dtype;
//   7. nothing in flight across a barrier: the ring runs ahead across a
//      phase's items, and the next phase's first weight tiles load before
//      three of the five barriers.
//
// Numerics: those of the plain version (ops/block_stack.py:
// vit_block_stack_plain): LayerNorm levels exact (f64 sums rounded once,
// -fmad=false, rintf), int32 products exact in any order, each epilogue
// the plain version's f32 arithmetic in its order, the attention K6's.

#include <cooperative_groups.h>

#include <algorithm>
#include <cstring>

#include "qkv_attention.cuh"
#include "wgmma_int8.cuh"

namespace cg = cooperative_groups;
namespace wg = qvt::wg;

namespace {

// weight rows a warpgroup (the wgmma M), depth bytes a ring stage,
// consumer warpgroups and threads, the block (the consumers and a producer
// warp, whose first thread issues the copies)
constexpr int ROWS = 64, BK = 128, CWG = 2, CT = 128 * CWG, NT = CT + 32;
// the wgmma N of proj's and fc2's items at most (their epilogues hold
// residuals beside the accumulators), and the shared memory in which
// their two warpgroups exchange half their sums: [2][NW_SPLIT / 4][128]
constexpr int NW_SPLIT = 64, XCHG_BYTES = 2 * (NW_SPLIT / 4) * 128 * 4;
static_assert(CT == qvt::QA_NT, "the consumers run K6's tile");
// the named barrier of the consumer threads (0 is the block's)
constexpr int CBAR = 1;
// ring stages at most; shared memory a block may take; what the ring
// leaves for the 1024-byte alignment, the barriers and static memory
constexpr int MAX_STAGES = 16, SMEM_MAX = 232448, SMEM_SLACK = 2048;
// 16-byte pieces of a LayerNorm row a lane keeps in registers between its
// two passes (more are loaded again): a warp takes a row, so 4 keep a
// 1024-wide bf16 row (and every ViT-B row)
constexpr int LN_KEEP = 4;

// the quantizer scalars of a layer, prm[l][*]
enum {
  P_ACT_D, P_ACT_T, P_OUT_D, P_OUT_T, P_MLP_D, P_MLP_T, P_HID_D, P_HID_T,
  NPRM
};
// the GEMM phases
enum { G_QKV = 0, G_PROJ = 1, G_FC1 = 2, G_FC2 = 3 };

struct Args {
  CUtensorMap tm_w[4];  // the weight stacks [L * N64][Kw], 64 x 128 boxes
  CUtensorMap tm_b[4];  // lv (qkv's chunk), alv, lv (fc1's chunk), hlv
  const void* x_in;     // [M][D] residual dtype
  void* x;              // [M][D] the residual stream, the output
  void* x2;             // [M][D] scratch
  void* qkv;            // [M][3HD] scratch, residual dtype
  int8_t* lv;           // [M][D]
  int8_t* alv;          // [M][HD]
  int8_t* hlv;          // [M][hid]
  unsigned* cnt;        // a token group's arrivals (zero between phases)
  const float *qs, *qb, *l1g, *l1b, *ps, *pb, *l2g, *l2b, *s1, *b1, *s2,
      *b2;
  const float* prm;  // [L][NPRM]
  int dt;
  int L, j_imgs, n, n_valid, nk, M, D, heads, hd, HD, hid;
  int nout[4];  // each phase's output features: 3HD, D, hid, D
  int n64[4];   // a layer's weight rows in the stack (nout up to 64)
  int steps[4];  // 128-byte steps of a weight row (Kw / 128)
  int kw[4];     // bytes of a weight row; int4: the high nibbles' offset
  int nc[4], nw[4], g[4];
  int kt;  // token tiles a chunk a step: 2 with packed int4, else 1
  int att_rows, stages, stage_bytes;
  float q_mul;
  int act_pow, out_pow, mlp_pow, hid_pow;
  float act_top, out_top, mlp_top, hid_top, eps;
};

// The host's part, once a plan and layout (qvt_block_stack_prepare): the
// arguments but the pointers of a call, the grid, the scratch the
// activation maps were encoded for.
struct State {
  Args a;
  const void* at;
  int grid, smem;
};

// GEMM phase `ph` of layer l: an item is one chunk of nc token rows (g
// chunks) against 128 weight rows, each consumer warpgroup its own 64
// (qkv, fc1), or against 64 weight rows, the warpgroups splitting the
// depth (`split`: proj and fc2, whose weights are few tiles and deep: a
// warpgroup takes every other step, and the two sums meet in shared
// memory). kt: token tiles a step (2 with packed int4: the two depth
// ranges of a packed tile).
struct Phase {
  const CUtensorMap* wmap;
  const CUtensorMap* bmap;
  int rows, wrow0, steps, hi, nc, nw, groups, kt;
  bool split;
  __device__ __forceinline__ int wr() const {
    return split ? ROWS : 2 * ROWS;
  }
  __device__ __forceinline__ int items() const {
    return (rows + wr() - 1) / wr() * groups;
  }
  __device__ __forceinline__ int a_off(int w) const {
    return split ? 0 : w * ROWS * BK;
  }
  // the token tile of depth range h
  __device__ __forceinline__ int b_off(int h) const {
    return (wr() + h * nw) * BK;
  }
};

__device__ __forceinline__ Phase phase_of(const Args& a, int ph, int l) {
  Phase p;
  p.wmap = &a.tm_w[ph];
  p.bmap = &a.tm_b[ph];
  p.rows = a.nout[ph];
  p.wrow0 = l * a.n64[ph];
  p.steps = a.steps[ph];
  p.hi = a.kw[ph];
  p.nc = a.nc[ph];
  p.nw = a.nw[ph];
  p.groups = a.g[ph];
  p.kt = a.kt;
  p.split = ph == G_PROJ || ph == G_FC2;
  return p;
}

// warpgroup w's tile of item `it`: its first weight row, first token row
// and token count (<= 0: no work for it); q: the item's token chunk
__device__ __forceinline__ void tile_of(const Phase& p, int M, int it, int w,
                                        int& row0, int& t0, int& cnt,
                                        int& q) {
  const int rt = it / p.groups;
  q = it % p.groups;
  row0 = p.split ? rt * ROWS : rt * 2 * ROWS + w * ROWS;
  t0 = q * p.nc;
  cnt = row0 < p.rows ? min(p.nc, M - t0) : 0;
}

// What issue() copies of a step: its weight and token tiles, the weight
// tiles alone (ahead of a grid barrier) or the token tiles alone (after
// it)
enum { TILES_ALL, TILES_W, TILES_B };

// The producer's TMA copies of step ks of item `it` into stage `st`,
// completing on `bar` (load: false counts the bytes only). Returns the
// bytes.
__device__ __forceinline__ uint32_t issue(const Args& a, const Phase& p,
                                          uint8_t* st, uint64_t* bar, int it,
                                          int ks, bool load, int what) {
  uint32_t bytes = 0;
  for (int w = 0; w < CWG; ++w) {
    int row0, t0, cnt, q;
    tile_of(p, a.M, it, w, row0, t0, cnt, q);
    if (cnt <= 0) continue;
    // the weight tile: each warpgroup's, or the one both split
    if ((w == 0 || !p.split) && what != TILES_B) {
      bytes += ROWS * BK;
      if (load)
        wg::tma_load_2d(st + p.a_off(w), p.wmap, ks * BK, p.wrow0 + row0,
                        bar);
    }
    // the token tiles: one chunk an item
    if (w == 0 && what != TILES_W) {
      for (int h = 0; h < p.kt; ++h) {
        bytes += p.nc * BK;
        if (load)
          wg::tma_load_2d(st + p.b_off(h), p.bmap, ks * BK + h * p.hi, t0,
                          bar);
      }
    }
  }
  return bytes;
}

// The producer (one thread): the ring's stages for this block's items of
// the phase, in the consumers' order; `it` counts stages over the launch.
// The first `pre` stages already hold their weight tiles (prefetch) and
// expect their bytes: their token tiles complete them.
__device__ __forceinline__ void produce(const Args& a, const Phase& p,
                                        uint8_t* ring, uint64_t* full,
                                        uint64_t* empty, uint32_t& it,
                                        int pre) {
  for (int item = blockIdx.x; item < p.items(); item += gridDim.x)
    for (int ks = 0; ks < p.steps; ++ks, ++it, --pre) {
      const int s = it % a.stages;
      uint8_t* st = ring + s * a.stage_bytes;
      const int what = pre > 0 ? TILES_B : TILES_ALL;
      if (pre <= 0) wg::mbar_wait(&empty[s], ((it / a.stages) & 1) ^ 1);
      wg::mbar_arrive_tx(&full[s],
                         issue(a, p, st, &full[s], item, ks, false, what));
      issue(a, p, st, &full[s], item, ks, true, what);
    }
}

// The weight tiles of the first steps of this block's first item of phase
// p (the weights do not depend on the activations), into the next free
// stages ahead of the grid barrier, their bytes expected on the full
// barriers without an arrival; `it` does not move. Returns the steps
// prefetched (produce() completes them).
__device__ __forceinline__ int prefetch(const Args& a, const Phase& p,
                                        uint8_t* ring, uint64_t* full,
                                        uint64_t* empty, uint32_t it) {
  const int item = blockIdx.x;
  if (item >= p.items()) return 0;
  const int n = min(p.steps, a.stages);
  for (int ks = 0; ks < n; ++ks, ++it) {
    const int s = it % a.stages;
    uint8_t* st = ring + s * a.stage_bytes;
    wg::mbar_wait(&empty[s], ((it / a.stages) & 1) ^ 1);
    wg::mbar_expect_tx(&full[s],
                       issue(a, p, st, &full[s], item, ks, false, TILES_W));
    issue(a, p, st, &full[s], item, ks, true, TILES_W);
  }
  return n;
}

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync %0, %1;\n" ::"n"(CBAR), "n"(CT) : "memory");
}

__device__ __forceinline__ float ld_cg(const void* p, int dt, long long i) {
  if (dt == qvt::DT_F32) return __ldcg(static_cast<const float*>(p) + i);
  const unsigned short u = __ldcg(static_cast<const unsigned short*>(p) + i);
  return __uint_as_float(static_cast<uint32_t>(u) << 16);
}

// Where a block's thread 0 spends its time (tools/phase_probe.py
// block_stack; its own clock, no barrier), summed over the launch: each
// GEMM phase's item steps (qkv, proj, fc1, fc2), its epilogues, the
// waits for a token chunk to arrive whole after proj and fc2, block 0's
// LayerNorm rows, the attention, the grid barriers' waits, the chunks'
// LayerNorm rows. Stored as qvt_clk[block * 16 + 0..15]: start, end and
// the 14 sums. Without QVT_PROBE every method is empty.
enum {
  C_GEMM = 0,  // + the phase
  C_EPI = 4,   // + the phase
  C_LN2 = 8, C_LN1 = 9, C_LN0 = 10, C_ATT = 11, C_BAR = 12, C_LNROWS = 13,
  C_SLOTS = 14
};
struct StackClock {
#ifdef QVT_PROBE
  unsigned long long ph[C_SLOTS], start, last;
  __device__ __forceinline__ void begin() {
    for (int i = 0; i < C_SLOTS; ++i) ph[i] = 0ull;
    start = last = qvt_now();
  }
  __device__ __forceinline__ void mark(int i) {
    if (threadIdx.x != 0) return;
    const unsigned long long t = qvt_now();
    ph[i] += t - last;
    last = t;
  }
  __device__ __forceinline__ void store() const {
    if (threadIdx.x != 0) return;
    unsigned long long* qc = qvt_clk + blockIdx.x * 16;
    qc[0] = start;
    qc[1] = last;
    for (int i = 0; i < C_SLOTS; ++i) qc[2 + i] = ph[i];
  }
#else
  __device__ __forceinline__ void begin() {}
  __device__ __forceinline__ void mark(int) {}
  __device__ __forceinline__ void store() const {}
#endif
};
#ifdef QVT_PROBE
// the grid stamps (thread 0 of block 0 after each grid barrier) follow the
// blocks' clocks
constexpr int STAMP0 = 4096;
#endif

// LayerNorm + quant of rows [r0, r1) of src [M][D] (written in this
// launch: read through L2) into lv [M][D], by the CT consumer threads, a
// warp a row. The statistics are K8's and K3's (f64 sums of x and of x*x
// taken in f32, rounded once); the levels (x - mu) * rs * gamma + beta,
// the linear quantizer's 1/d folded into gamma / beta by the plan. Rows
// load as 16-byte pieces (D is a multiple of 16); a lane keeps up to
// LN_KEEP of its pieces in registers for the second pass. POW: the
// quantizer's pow map (a template argument: a runtime flag in the
// unrolled level loop doubles the code the rows run). Not inlined: one
// copy for its three call sites.
template <bool POW>
__device__ __noinline__ void ln_rows(const Args& a, const void* src,
                                     int r0, int r1, const float* gam,
                                     const float* bet, float d, float t,
                                     float top) {
  constexpr int T = 32;
  const int gl = threadIdx.x % T, grp = threadIdx.x / T;
  const int D = a.D;
  const bool bf = a.dt == qvt::DT_BF16;
  const int epp = bf ? 8 : 4, np = D / epp;
  const float inv_k = 1.0f / static_cast<float>(D);
  const char* xb = static_cast<const char*>(src);
  for (int rb = r0; rb < r1; rb += CT / T) {
    const int r = rb + grp;
    const bool live = r < r1;  // a dead row's threads still reduce
    const long long base = static_cast<long long>(r) * D;
    auto piece = [&](int q) {
      return __ldcg(reinterpret_cast<const uint4*>(
          xb + (base + static_cast<long long>(q) * epp) * (bf ? 2 : 4)));
    };
    uint4 keep[LN_KEEP];
    double s = 0.0, s2 = 0.0;
    auto add = [&](const uint4& u) {
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        if (e >= epp) break;
        const float v = qvt::piece_at(u, bf, e);
        s += static_cast<double>(v);
        s2 += static_cast<double>(v * v);
      }
    };
    if (live) {
#pragma unroll
      for (int j = 0; j < LN_KEEP; ++j)
        if (gl + j * T < np) keep[j] = piece(gl + j * T);
#pragma unroll
      for (int j = 0; j < LN_KEEP; ++j)
        if (gl + j * T < np) add(keep[j]);
      for (int q = gl + LN_KEEP * T; q < np; q += T) add(piece(q));
    }
    for (int o = T / 2; o > 0; o >>= 1) {
      s += __shfl_xor_sync(0xffffffffu, s, o);
      s2 += __shfl_xor_sync(0xffffffffu, s2, o);
    }
    const float mu = static_cast<float>(s) * inv_k;
    const float var = fmaxf(static_cast<float>(s2) * inv_k - mu * mu, 0.f);
    const float rs = 1.0f / sqrtf(var + a.eps);
    if (!live) continue;
    int8_t* out = a.lv + base;
    auto put = [&](int q, const uint4& u) {
      const int k = q * epp;
      float gv[8], bv[8];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (h * 4 >= epp) break;
        const float4 g4 = __ldg(reinterpret_cast<const float4*>(gam + k) + h);
        const float4 b4 = __ldg(reinterpret_cast<const float4*>(bet + k) + h);
        gv[4 * h] = g4.x, gv[4 * h + 1] = g4.y, gv[4 * h + 2] = g4.z;
        gv[4 * h + 3] = g4.w;
        bv[4 * h] = b4.x, bv[4 * h + 1] = b4.y, bv[4 * h + 2] = b4.z;
        bv[4 * h + 3] = b4.w;
      }
      uint32_t w[2] = {0u, 0u};
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        if (e >= epp) break;
        const float y = (qvt::piece_at(u, bf, e) - mu) * rs * gv[e] + bv[e];
        w[e >> 2] |= static_cast<uint32_t>(static_cast<uint8_t>(
                         qvt::quantize(y, d, t, top, POW, !POW)))
                     << (8 * (e & 3));
      }
      if (bf)
        *reinterpret_cast<uint2*>(out + k) = make_uint2(w[0], w[1]);
      else
        *reinterpret_cast<uint32_t*>(out + k) = w[0];
    };
#pragma unroll
    for (int j = 0; j < LN_KEEP; ++j)
      if (gl + j * T < np) put(gl + j * T, keep[j]);
    for (int q = gl + LN_KEEP * T; q < np; q += T) put(q, piece(q));
  }
}

template <bool POW>
__device__ __forceinline__ void ln_rows_at(const Args& a, const void* src,
                                           int r0, int r1, int l, int rows2) {
  const float* P = a.prm + l * NPRM;
  const long long o = static_cast<long long>(l) * a.D;
  if (rows2)
    ln_rows<POW>(a, src, r0, r1, a.l2g + o, a.l2b + o, P[P_MLP_D],
                 P[P_MLP_T], a.mlp_top);
  else
    ln_rows<POW>(a, src, r0, r1, a.l1g + o, a.l1b + o, P[P_ACT_D],
                 P[P_ACT_T], a.act_top);
}

// the levels of layer l's LN1 (ln2: LN2) of rows [r0, r1) of src
__device__ __forceinline__ void layer_norm(const Args& a, const void* src,
                                           int r0, int r1, int l, bool ln2) {
  if (ln2 ? a.mlp_pow : a.act_pow)
    ln_rows_at<true>(a, src, r0, r1, l, ln2);
  else
    ln_rows_at<false>(a, src, r0, r1, l, ln2);
}

// The epilogue of a warpgroup's tile: output feature f (the tile's row)
// of token row t (its column), in the plain version's f32 order, for the
// fragments' row halves [h0, h1) (proj and fc2, whose warpgroups split
// the depth: one half each). The residual epilogues (proj, fc2) load all
// their residuals first: a store before a load keeps the compiler from
// issuing the load early (it cannot rule out aliasing). HPOW: fc1's
// hidden quantizer is the pow map.
template <int NW, int PH, bool HPOW>
__device__ __forceinline__ void epilogue(const Args& a, int l,
                                         const int (&d)[NW / 2], int rows,
                                         int row0, int t0, int cnt, int h0,
                                         int h1) {
  const int lane = threadIdx.x & 31, wq = (threadIdx.x >> 5) & 3;
  const int g = lane >> 2, t = lane & 3;
  constexpr bool RES = PH == G_PROJ || PH == G_FC2;
  const long long D = a.D;
  const float* sc_v = PH == G_QKV    ? a.qs + l * 3LL * a.HD
                      : PH == G_PROJ ? a.ps + l * D
                      : PH == G_FC1  ? a.s1 + l * static_cast<long long>(a.hid)
                                     : a.s2 + l * D;
  const float* bi_v = PH == G_QKV    ? a.qb + l * 3LL * a.HD
                      : PH == G_PROJ ? a.pb + l * D
                      : PH == G_FC1  ? a.b1 + l * static_cast<long long>(a.hid)
                                     : a.b2 + l * D;
  if constexpr (RES) {
    // one half (h0): its residuals, then the sums
    const int f = row0 + 16 * wq + g + 8 * h0;
    if (f >= rows) return;
    float res[NW / 4];
#pragma unroll
    for (int j = 0; j < NW / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 8 * j + 2 * t + e;
        const long long i = (t0 + col) * D + f;
        res[2 * j + e] = col >= cnt        ? 0.f
                         : PH == G_FC2     ? ld_cg(a.x2, a.dt, i)
                         : l == 0          ? qvt::load_f(a.x_in, a.dt, i)
                                           : ld_cg(a.x, a.dt, i);
      }
    const float sc = __ldg(sc_v + f), bi = __ldg(bi_v + f);
#pragma unroll
    for (int j = 0; j < NW / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 8 * j + 2 * t + e;
        if (col >= cnt) continue;
        float y = static_cast<float>(d[4 * j + 2 * h0 + e]) * sc;
        y = y + bi;
        qvt::store_f(PH == G_PROJ ? a.x2 : a.x, a.dt, (t0 + col) * D + f,
                     y + res[2 * j + e]);
      }
    return;
  }
  const float* P = a.prm + l * NPRM;
  const float hid_d = P[P_HID_D], hid_t = P[P_HID_T];
  const float c2 = 0.70710678118654757f / hid_d;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int f = row0 + 16 * wq + g + 8 * hh;
    if (f >= rows || hh < h0 || hh >= h1) continue;
    const float sc = __ldg(sc_v + f), bi = __ldg(bi_v + f);
#pragma unroll
    for (int j = 0; j < NW / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 8 * j + 2 * t + e;
        if (col >= cnt) continue;
        float y = static_cast<float>(d[4 * j + 2 * hh + e]) * sc;
        y = y + bi;
        const long long tr = t0 + col;
        if constexpr (PH == G_QKV) {
          qvt::store_f(a.qkv, a.dt, tr * 3 * a.HD + f, y);
        } else {
          a.hlv[tr * a.hid + f] =
              HPOW ? qvt::quantize(qvt::gelu(y), hid_d, hid_t, a.hid_top,
                                   true, false)
                   : qvt::gelu_quant_folded_c2(y, c2, a.hid_top);
        }
      }
  }
}

// The consumer warpgroups: their tiles of this block's items of GEMM
// phase PH of layer l, stage by stage (four k32 products a depth range a
// stage, waited for at once, so the stage goes back to the producer
// early), then the epilogue; every consumer warp releases each stage.
// The A fragments come from the stage's weight tile through registers:
// packed int4 bytes split into the two ranges' levels (low and high
// nibbles, sign-extended), int8 bytes as they are. After proj and fc2
// (but the last block's) each item counts its token group's arrival;
// once the block's items are done, it waits for each of its groups to
// arrive whole and computes its share of the group's LayerNorm levels
// for the next GEMM (a group's rows split over its weight tiles' items).
template <int NW, int PH, bool HPOW>
__device__ __forceinline__ void consume(const Args& a, const Phase& p,
                                        int l, uint8_t* ring, uint64_t* full,
                                        uint64_t* empty, uint32_t& it,
                                        StackClock& clk) {
  // the exchange sits below the barriers (the kernel's shared memory)
  int* xchg = reinterpret_cast<int*>(full) - XCHG_BYTES / 4;
  const int w = threadIdx.x / 128, lane = threadIdx.x & 31;
  const int wq = (threadIdx.x >> 5) & 3, g = lane >> 2, t = lane & 3;
  constexpr bool LN = PH == G_PROJ || PH == G_FC2;
  const bool int4 = p.kt == 2;
  // rows 16 wq + g and + 8 of a weight tile; depth bytes 4t of the two
  // 16-byte pieces of each k32 step, under the 128-byte swizzle
  const int ra = 16 * wq + g, rb = ra + 8;
  for (int item = blockIdx.x; item < p.items(); item += gridDim.x) {
    int row0, t0, cnt, q;
    tile_of(p, a.M, item, w, row0, t0, cnt, q);
    int d[NW / 2];
#pragma unroll
    for (int i = 0; i < NW / 2; ++i) d[i] = 0;
    for (int ks = 0; ks < p.steps; ++ks, ++it) {
      const int s = it % a.stages;
      wg::mbar_wait(&full[s], (it / a.stages) & 1);
      if (cnt > 0 && (!p.split || (ks & 1) == w)) {
        const uint8_t* st = ring + s * a.stage_bytes;
        const uint8_t* at = st + p.a_off(w);
        uint32_t af[2][BK / 32][4];
#pragma unroll
        for (int kk = 0; kk < BK / 32; ++kk)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int pc = 2 * kk + h;
            const uint32_t u0 = *reinterpret_cast<const uint32_t*>(
                at + ra * BK + ((pc ^ (ra & 7)) << 4) + 4 * t);
            const uint32_t u1 = *reinterpret_cast<const uint32_t*>(
                at + rb * BK + ((pc ^ (rb & 7)) << 4) + 4 * t);
            af[0][kk][2 * h] = int4 ? qvt::nibbles(u0, false) : u0;
            af[0][kk][2 * h + 1] = int4 ? qvt::nibbles(u1, false) : u1;
            af[1][kk][2 * h] = qvt::nibbles(u0, true);
            af[1][kk][2 * h + 1] = qvt::nibbles(u1, true);
          }
        const uint64_t d0 = wg::desc_sw128(st + p.b_off(0));
        const uint64_t d1 = wg::desc_sw128(st + p.b_off(1));
        wg::fence_regs(d);
        wg::fence();
#pragma unroll
        for (int kk = 0; kk < BK / 32; ++kk) {
          wg::MmaR<NW>::run(d, af[0][kk], d0 + 2 * kk, 1);
          if (int4) wg::MmaR<NW>::run(d, af[1][kk], d1 + 2 * kk, 1);
        }
        wg::commit();
        wg::wait<0>();
        wg::fence_regs(d);
      }
      if (lane == 0) wg::mbar_arrive(&empty[s]);
    }
    clk.mark(C_GEMM + PH);
    if (p.split && cnt > 0) {
      // each warpgroup finishes the rows of one half of the fragments
      // (hh = w): it hands the other half of its sums over, [w][j, e][t]
      const int tid = threadIdx.x & 127;
#pragma unroll
      for (int j = 0; j < NW / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          xchg[((w * NW / 4) + 2 * j + e) * 128 + tid] =
              d[4 * j + 2 * (1 - w) + e];
      consumer_sync();
#pragma unroll
      for (int j = 0; j < NW / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          d[4 * j + 2 * w + e] +=
              xchg[(((1 - w) * NW / 4) + 2 * j + e) * 128 + tid];
      consumer_sync();  // read before the next item's hand-over
    }
    if (cnt > 0)
      epilogue<NW, PH, HPOW>(a, l, d, p.rows, row0, t0, cnt,
                             p.split ? w : 0, p.split ? w + 1 : 2);
    clk.mark(C_EPI + PH);
    if (LN && (PH == G_PROJ || l + 1 < a.L)) {
      __threadfence();  // this item's outputs, then its arrival
      consumer_sync();
      if (threadIdx.x == 0) atomicAdd(a.cnt + q, 1u);
    }
  }
  if constexpr (LN) {
    if (PH == G_FC2 && l + 1 == a.L) return;
    // the block's items again: its groups whole, then its rows of each.
    // (After all of its items: a block waiting inside its first item for
    // a group whose other tile is some waiting block's second item would
    // never finish.) The counts grow by the tiles at each use: proj's
    // and fc2's of each layer; block 0 zeroes them at the launch's start.
    const unsigned tiles = (p.rows + ROWS - 1) / ROWS;
    const unsigned want = tiles * (2 * l + (PH == G_FC2 ? 2 : 1));
    for (int item = blockIdx.x; item < p.items(); item += gridDim.x) {
      const int rt = item / p.groups, q = item % p.groups;
      if (threadIdx.x == 0)
        while (ld_acquire(a.cnt + q) < want) __nanosleep(64);
      consumer_sync();
      clk.mark(PH == G_PROJ ? C_LN2 : C_LN1);
      const int g0 = q * p.nc, g1 = min(a.M, g0 + p.nc);
      const int per = (g1 - g0 + tiles - 1) / tiles;
      const int r0 = min(g1, g0 + rt * per), r1 = min(g1, r0 + per);
      if (PH == G_PROJ)
        layer_norm(a, a.x2, r0, r1, l, true);
      else
        layer_norm(a, a.x, r0, r1, l + 1, false);
      clk.mark(C_LNROWS);
    }
  }
}

// the phase's consumers at its wgmma N
template <int PH, bool HPOW>
__device__ __forceinline__ void consume_at(const Args& a, int l,
                                           uint8_t* ring, uint64_t* full,
                                           uint64_t* empty, uint32_t& it,
                                           StackClock& clk) {
  const Phase p = phase_of(a, PH, l);
  switch (p.nw) {
    case 32: consume<32, PH, HPOW>(a, p, l, ring, full, empty, it, clk); break;
    case 64: consume<64, PH, HPOW>(a, p, l, ring, full, empty, it, clk); break;
    default:  // N 128: qkv and fc1 only
      if constexpr (PH == G_QKV || PH == G_FC1)
        consume<128, PH, HPOW>(a, p, l, ring, full, empty, it, clk);
  }
}

// One GEMM phase of layer l, by the block's roles. The producer then
// loads the next GEMM phase's first weight tiles (`next` >= 0) ahead of
// the grid barrier; `pre` carries their count into that phase.
template <int PH, bool PRODUCER>
__device__ __forceinline__ void gemm_phase(const Args& a, int l,
                                           uint8_t* ring, uint64_t* full,
                                           uint64_t* empty, uint32_t& it,
                                           int& pre, int next, int next_l,
                                           StackClock& clk) {
  if constexpr (PRODUCER) {
    if (threadIdx.x == CT) {
      wg::fence_proxy_async();
      produce(a, phase_of(a, PH, l), ring, full, empty, it, pre);
      pre = next < 0 ? 0
                     : prefetch(a, phase_of(a, next, next_l), ring, full,
                                empty, it);
    }
  } else if constexpr (PH == G_FC1) {
    if (a.hid_pow)
      consume_at<PH, true>(a, l, ring, full, empty, it, clk);
    else
      consume_at<PH, false>(a, l, ring, full, empty, it, clk);
  } else {
    consume_at<PH, false>(a, l, ring, full, empty, it, clk);
  }
  wg::fence_proxy_async();  // plain stores before the next phase's TMA
}

// Layer l's attention over its (image, head, query tile) items, by the
// consumer threads
template <typename T, int R, int HDM>
__device__ __forceinline__ void attention_items(const Args& a, int l,
                                                unsigned char* smem) {
  qvt::QkvAttnArgs q;
  q.qkv = a.qkv;
  q.qkv_dt = a.dt;
  q.out = a.alv;
  q.out_dt = qvt::DT_INT8;
  q.out_mode = a.out_pow ? qvt::QA_OUT_POW : qvt::QA_OUT_LEVELS;
  q.out_es = 1;
  q.prm = a.prm + l * NPRM + P_OUT_D;  // out_d, out_t
  q.B = a.j_imgs;
  q.n = a.n;
  q.heads = a.heads;
  q.hd = a.hd;
  q.n_valid = a.n_valid;
  q.nk = a.nk;
  q.q_mul = a.q_mul;
  q.sm_scale = 0.f;
  q.out_top = a.out_top;
  q.int_attn = false;
  q.qkv_vec = true;  // the scratch: 16-byte rows and base
  q.out_vec = a.hd % 16 == 0;
  qvt::PhaseClock clk;
  const int nqt = (a.n + R - 1) / R, items = nqt * a.heads * a.j_imgs;
  for (int it = blockIdx.x; it < items; it += gridDim.x) {
    const int hb = it / nqt;
    qvt::qkv_attn_tile<T, R, HDM, false, true, CBAR>(
        q, (it - hb * nqt) * R, hb % a.heads, hb / a.heads, smem, clk);
    consumer_sync();  // the next item's q rows overwrite this output tile
  }
}

template <typename T, int HDM>
__device__ __forceinline__ void attention_rows(const Args& a, int l,
                                               unsigned char* smem) {
  if (a.att_rows == 32)
    attention_items<T, 32, HDM>(a, l, smem);
  else
    attention_items<T, 16, HDM>(a, l, smem);
}

// The launch as one role sees it: the producer warpgroup (its first
// thread issues the copies) or the consumer warpgroups, each with its own
// registers; both pass the same grid barriers.
template <bool PRODUCER>
__device__ __forceinline__ void run_role(const Args& a, uint8_t* ring,
                                         uint64_t* full, uint64_t* empty) {
  cg::grid_group grid = cg::this_grid();
  uint32_t it = 0;
  int pre = 0;  // the producer's prefetched steps of the next phase
  StackClock clk;
  clk.begin();
  QVT_GRID_STAMP(STAMP0);
  // block 0's LN1 levels, a slab of rows a block; the producer loads the
  // first qkv weight tiles meanwhile; block 0 zeroes the arrival counts
  if constexpr (PRODUCER) {
    if (threadIdx.x == CT)
      pre = prefetch(a, phase_of(a, G_QKV, 0), ring, full, empty, it);
  } else {
    if (blockIdx.x == 0)
      for (int i = threadIdx.x; i < a.g[G_PROJ]; i += CT) a.cnt[i] = 0u;
    const int per = (a.M + gridDim.x - 1) / gridDim.x;
    const int r0 = min(a.M, static_cast<int>(blockIdx.x) * per);
    layer_norm(a, a.x_in, r0, min(a.M, r0 + per), 0, false);
  }
  wg::fence_proxy_async();
  clk.mark(C_LN0);
  grid.sync();
  clk.mark(C_BAR);
  QVT_GRID_STAMP(STAMP0 + 1);
  for (int l = 0; l < a.L; ++l) {
    // the weight stream does not depend on the activations: each GEMM
    // phase's producer loads the next GEMM phase's first weight tiles
    // before the barrier, but across the attention (its shared memory is
    // the ring's)
    gemm_phase<G_QKV, PRODUCER>(a, l, ring, full, empty, it, pre, -1, 0,
                                clk);
    grid.sync();
    clk.mark(C_BAR);
    QVT_GRID_STAMP(STAMP0 + 5 * l + 2);
    if constexpr (!PRODUCER) {
      if (a.dt == qvt::DT_F32)
        a.hd <= 64 ? attention_rows<float, 64>(a, l, ring)
                   : attention_rows<float, 80>(a, l, ring);
      else
        a.hd <= 64 ? attention_rows<__nv_bfloat16, 64>(a, l, ring)
                   : attention_rows<__nv_bfloat16, 80>(a, l, ring);
    }
    // alv before proj's TMA; the tile's bytes before the ring's TMA
    wg::fence_proxy_async();
    wg::fence_proxy_async_smem();
    clk.mark(C_ATT);
    grid.sync();
    clk.mark(C_BAR);
    QVT_GRID_STAMP(STAMP0 + 5 * l + 3);
    gemm_phase<G_PROJ, PRODUCER>(a, l, ring, full, empty, it, pre, G_FC1, l,
                                 clk);
    grid.sync();
    clk.mark(C_BAR);
    QVT_GRID_STAMP(STAMP0 + 5 * l + 4);
    gemm_phase<G_FC1, PRODUCER>(a, l, ring, full, empty, it, pre, G_FC2, l,
                                clk);
    grid.sync();
    clk.mark(C_BAR);
    QVT_GRID_STAMP(STAMP0 + 5 * l + 5);
    gemm_phase<G_FC2, PRODUCER>(a, l, ring, full, empty, it, pre,
                                l + 1 < a.L ? G_QKV : -1, l + 1, clk);
#ifndef QVT_PROBE
    if (l + 1 < a.L)
#endif
      grid.sync();  // (the probe's build also ends on one, for its stamp)
    clk.mark(C_BAR);
    QVT_GRID_STAMP(STAMP0 + 5 * l + 6);
  }
  clk.store();
}

__global__ void __launch_bounds__(NT, 1)
    stack_kernel(const __grid_constant__ Args a) {
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* ring = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  // the ring and the attention tile share the bytes; proj's and fc2's
  // exchange and the barriers follow
  const int att = qvt::qkv_attn_smem(a.att_rows, a.hd <= 64 ? 64 : 80,
                                     a.dt == qvt::DT_F32 ? 4 : 2);
  uint64_t* full = reinterpret_cast<uint64_t*>(
      ring + ((max(a.stages * a.stage_bytes, att) + 15) & ~15) + XCHG_BYTES);
  uint64_t* empty = full + MAX_STAGES;
  if (threadIdx.x == 0) {
    for (int s = 0; s < a.stages; ++s) {
      wg::mbar_init(&full[s], 1);
      wg::mbar_init(&empty[s], CT / 32);
    }
    wg::mbar_fence_init();
  }
  __syncthreads();
  if (threadIdx.x >= CT)
    run_role<true>(a, ring, full, empty);
  else
    run_role<false>(a, ring, full, empty);
}

// blocks co-resident on an SM at `smem` bytes (0 on an error)
int per_sm(int smem) {
  static bool attr = false;
  if (!attr) {
    if (cudaFuncSetAttribute(stack_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             SMEM_MAX - 1024) != cudaSuccess)
      return 0;
    attr = true;
  }
  int v = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&v, stack_kernel, NT,
                                                    smem) != cudaSuccess)
    return 0;
  return v;
}

State* state_of(void* p) {
  return reinterpret_cast<State*>((reinterpret_cast<uintptr_t>(p) + 63) &
                                  ~uintptr_t(63));
}

// A phase's layout is sound: the chunk nc a multiple of 8 up to the wgmma
// N nw (at most NW_SPLIT where the warpgroups split the depth: proj and
// fc2), the g chunks covering M and none empty
bool phase_ok(int M, bool split, int nc, int nw, int g) {
  return (nw == 32 || nw == 64 || (nw == 128 && !split)) &&
         nw <= (split ? NW_SPLIT : 128) && nc >= 8 && nc % 8 == 0 &&
         nc <= nw && g >= 1 && static_cast<long long>(nc) * g >= M &&
         static_cast<long long>(nc) * (g - 1) < M;
}

// The scratch, each piece 256-byte aligned: x2 | qkv | lv | alv | hlv |
// counts. Returns its bytes; with a base, points a's scratch into it.
long long scratch_layout(long long M, int D, int HD, int hid, int es,
                         int groups, char* base, Args* a) {
  auto up = [](long long b) { return (b + 255) / 256 * 256; };
  const long long sizes[6] = {M * D * es, M * 3 * HD * es, M * D, M * HD,
                              M * hid, 4LL * groups};
  long long off[6], total = 0;
  for (int i = 0; i < 6; ++i) {
    off[i] = total;
    total += up(sizes[i]);
  }
  if (base) {
    a->x2 = base + off[0];
    a->qkv = base + off[1];
    a->lv = reinterpret_cast<int8_t*>(base + off[2]);
    a->alv = reinterpret_cast<int8_t*>(base + off[3]);
    a->hlv = reinterpret_cast<int8_t*>(base + off[4]);
    a->cnt = reinterpret_cast<unsigned*>(base + off[5]);
  }
  return total;
}

}  // namespace

// Bytes of the host state a caller allocates for one plan and layout (a
// CUtensorMap is 64-byte aligned: the state starts at the first 64-byte
// boundary of the buffer).
extern "C" int qvt_block_stack_state_bytes() {
  return static_cast<int>(sizeof(State)) + 64;
}

// Bytes of scratch a launch at the prepared state needs; the last 4 x
// groups bytes are the arrival counts, zero before the first launch (each
// launch leaves them zero).
extern "C" long long qvt_block_stack_scratch_bytes(void* state) {
  const State* s = state_of(state);
  return scratch_layout(s->a.M, s->a.D, s->a.HD, s->a.hid,
                        s->a.dt == qvt::DT_F32 ? 4 : 2, s->a.g[G_PROJ],
                        nullptr, nullptr);
}

// Once a plan and layout: checks the geometry, encodes the weights' maps
// (the n-major stacks wq [L][N64 0][kw 0], wp, w1, w2: N64 the layer's
// output features rounded up to 64, kw a multiple of 128 bytes, packed
// int4 pairing levels k' and k' + kw of each row), sizes the ring and the
// grid on the current device. geo: L, j_imgs, n, nk, D, heads, hd, hid,
// dt, int4, then for each phase (qkv, proj, fc1, fc2) n64 and kw. lay
// (ops/block_stack.py:stack_layout): att_rows (16, 32), stages (3 .. 16),
// then per phase nc, nw, g (proj's and fc2's nw at most 64: their
// epilogues hold residuals beside the accumulators).
extern "C" int qvt_block_stack_prepare(void* state, const void* wq,
                                       const void* wp, const void* w1,
                                       const void* w2, const int* geo,
                                       const int* lay) {
  State* s = state_of(state);
  std::memset(static_cast<void*>(s), 0, sizeof(State));
  Args& a = s->a;
  a.L = geo[0];
  a.j_imgs = geo[1];
  a.n = geo[2];
  a.nk = geo[3];
  a.D = geo[4];
  a.heads = geo[5];
  a.hd = geo[6];
  a.hid = geo[7];
  a.dt = geo[8];
  a.kt = geo[9] ? 2 : 1;
  a.HD = a.heads * a.hd;
  a.M = a.j_imgs * a.n;
  a.nout[G_QKV] = 3 * a.HD;
  a.nout[G_PROJ] = a.D;
  a.nout[G_FC1] = a.hid;
  a.nout[G_FC2] = a.D;
  const int depth[4] = {a.D, a.HD, a.D, a.hid};
  a.att_rows = lay[0];
  a.stages = lay[1];
  int stage = 0;
  const int kt = a.kt;
  for (int ph = 0; ph < 4; ++ph) {
    a.n64[ph] = geo[10 + 2 * ph];
    a.kw[ph] = geo[11 + 2 * ph];
    a.nc[ph] = lay[2 + 3 * ph];
    a.nw[ph] = lay[3 + 3 * ph];
    a.g[ph] = lay[4 + 3 * ph];
    a.steps[ph] = a.kw[ph] / BK;
    const bool shared = ph == G_PROJ || ph == G_FC2;
    if (a.n64[ph] < a.nout[ph] || a.n64[ph] % ROWS || a.kw[ph] % BK ||
        a.kw[ph] * kt < depth[ph] ||
        !phase_ok(a.M, shared, a.nc[ph], a.nw[ph], a.g[ph]))
      return static_cast<int>(cudaErrorInvalidValue);
    stage = std::max(stage, ((shared ? ROWS : 2 * ROWS) + kt * a.nw[ph]) * BK);
  }
  // proj and fc2 count arrivals in the same counts: the same groups
  if (a.nc[G_PROJ] != a.nc[G_FC2] || a.g[G_PROJ] != a.g[G_FC2])
    return static_cast<int>(cudaErrorInvalidValue);
  a.stage_bytes = stage;
  const int att = qvt::qkv_attn_smem(a.att_rows, a.hd <= 64 ? 64 : 80,
                                     a.dt == qvt::DT_F32 ? 4 : 2);
  s->smem = 1024 + ((std::max(a.stages * stage, att) + 15) & ~15) +
            XCHG_BYTES + 16 * MAX_STAGES;
  if (a.M < 1 || a.L < 1 || a.nk > a.n || a.nk < 1 || a.hd % 8 ||
      a.hd > qvt::QA_HDMAX || a.D % 16 || a.HD % 16 || a.hid % 16 ||
      (a.dt != qvt::DT_BF16 && a.dt != qvt::DT_F32) ||
      (a.att_rows != 16 && a.att_rows != 32) || a.stages < 3 ||
      a.stages > MAX_STAGES || s->smem + SMEM_SLACK - 1024 > SMEM_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  const void* w[4] = {wq, wp, w1, w2};
  for (int ph = 0; ph < 4; ++ph) {
    if (reinterpret_cast<uintptr_t>(w[ph]) & 15)
      return static_cast<int>(cudaErrorInvalidValue);
    const int e = qvt::encode_tiled_int8(
        &a.tm_w[ph], w[ph], a.kw[ph],
        static_cast<long long>(a.L) * a.n64[ph], a.kw[ph], ROWS);
    if (e) return e;
  }
  int dev = 0, sms = 0;
  cudaError_t ce = cudaGetDevice(&dev);
  if (ce == cudaSuccess)
    ce = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (ce != cudaSuccess) return static_cast<int>(ce);
  const int cap = per_sm(s->smem) * sms;
  if (cap < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  // enough blocks for the largest phase
  long long want = (a.n + a.att_rows - 1) / a.att_rows *
                   static_cast<long long>(a.heads) * a.j_imgs;
  for (int ph = 0; ph < 4; ++ph) {
    const int wr = ph == G_PROJ || ph == G_FC2 ? ROWS : 2 * ROWS;
    want = std::max<long long>(
        want, (a.nout[ph] + wr - 1) / wr * static_cast<long long>(a.g[ph]));
  }
  s->grid = static_cast<int>(std::min<long long>(cap, want));
  return 0;
}

// One launch at the prepared state: x_in [M][D] in the residual dtype
// (16-byte aligned), x the output like it, vecs the per-block vectors in
// one f32 buffer (qs qb [L][3HD] | l1g l1b ps pb l2g l2b [L][D] | s1 b1
// [L][hid] | s2 b2 [L][D]), prm [L][8] quantizer scalars, scratch of
// qvt_block_stack_scratch_bytes (256-byte aligned; the activation maps are
// encoded again when it moves).
extern "C" int qvt_block_stack(void* state, const void* x_in, void* x,
                               const void* vecs, const void* prm,
                               void* scratch, int n_valid, float q_mul,
                               int act_pow, int out_pow, int mlp_pow,
                               int hid_pow, int act_top, int out_top,
                               int mlp_top, int hid_top, float eps,
                               void* stream) {
  State* s = state_of(state);
  Args& a = s->a;
  if (((reinterpret_cast<uintptr_t>(scratch) & 255) != 0) ||
      ((reinterpret_cast<uintptr_t>(x_in) | reinterpret_cast<uintptr_t>(x)) &
       15) ||
      n_valid < 1 || n_valid > a.nk)
    return static_cast<int>(cudaErrorInvalidValue);
  if (s->at != scratch) {
    scratch_layout(a.M, a.D, a.HD, a.hid, a.dt == qvt::DT_F32 ? 4 : 2,
                   a.g[G_PROJ], static_cast<char*>(scratch), &a);
    const void* base[4] = {a.lv, a.alv, a.lv, a.hlv};
    const int width[4] = {a.D, a.HD, a.D, a.hid};
    for (int ph = 0; ph < 4; ++ph) {
      const int e = qvt::encode_tiled_int8(&a.tm_b[ph], base[ph], width[ph],
                                           a.M, width[ph], a.nc[ph]);
      if (e) return e;
    }
    s->at = scratch;
  }
  a.x_in = x_in;
  a.x = x;
  const float* v = static_cast<const float*>(vecs);
  const long long L = a.L, LD = L * a.D, LW = L * 3 * a.HD, LH = L * a.hid;
  a.qs = v;
  a.qb = a.qs + LW;
  a.l1g = a.qb + LW;
  a.l1b = a.l1g + LD;
  a.ps = a.l1b + LD;
  a.pb = a.ps + LD;
  a.l2g = a.pb + LD;
  a.l2b = a.l2g + LD;
  a.s1 = a.l2b + LD;
  a.b1 = a.s1 + LH;
  a.s2 = a.b1 + LH;
  a.b2 = a.s2 + LD;
  a.prm = static_cast<const float*>(prm);
  a.n_valid = n_valid;
  a.q_mul = q_mul;
  a.act_pow = act_pow;
  a.out_pow = out_pow;
  a.mlp_pow = mlp_pow;
  a.hid_pow = hid_pow;
  a.act_top = static_cast<float>(act_top);
  a.out_top = static_cast<float>(out_top);
  a.mlp_top = static_cast<float>(mlp_top);
  a.hid_top = static_cast<float>(hid_top);
  a.eps = eps;
  void* args[] = {&a};
  cudaError_t e = cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(stack_kernel),
      dim3(s->grid), dim3(NT), args, s->smem,
      static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

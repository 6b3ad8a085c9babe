// K8: whole transformer-MLP residual branch for int8 weights too big to
// stay resident (ViT-H/14 at batch 1-2, ViT-B/16's chain at batch 3), on
// Hopper (sm_90a): the port's first kernel on TMA and wgmma.
//
// Replaces the TPU kernel quantized_vit_tpu/ops/fused.py:
// _fused_mlp_chunked_kernel (:703; pallas_call in _fused_mlp_chunked,
// fused.py:1065, reached from _fused_mlp's auto-chunk gate, :916-942):
//   out = x + fc2(quant(GELU(fc1(quant(LN(x))))))
// for int8 w1 [K, H] and w2 [H, K] (the plan's n-major copies w1t [H][K],
// w2t [K][H]). The TPU kernel walks (M tile x hidden chunk) in order and
// carries fc2's sum of an M tile in VMEM across the chunks; here the
// blocks run in parallel, so the work is cut so that no sum crosses a
// block.
//
// Bound on this card (H100 SXM, 1,979 TOPS int8, 3.35 TB/s): 4 M K H int8
// ops against both weights (2 K H bytes) plus x in and out:
//   ViT-H/14 b1 (M 272, K 1280, H 5120): 7.13 G ops 3.6 us, 14.5 MB 4.3 us
//   ViT-H/14 b2 (M 544):                14.26 G ops 7.2 us, 15.9 MB 4.7 us
//   ViT-B/16 chain b3 (M 624, K 768, H 3072): 5.89 G ops 3.0 us, 6.6 MB
//   384-px ViT-B/16 chain b1, f32 (M 592): 5.59 G ops 2.8 us, 8.4 MB.
//
// Design: one cooperative launch of a persistent grid (one block an SM:
// two consumer warpgroups and one producer warp, 288 threads), three
// phases split by two grid barriers.
//   1. LayerNorm (fast variance, f64 sums rounded once) and quant once a
//      row into a level scratch lv [M8][Kp] (Kp = K rounded up to 128, M8
//      = M rounded up to 8; gemm_phases.cuh:row_levels, K2's and K1's, a
//      group of 8-32 consumer threads a row).
//   2. fc1 as hid^T = w1t lv^T on wgmma m64nNk32 s8: the weight is the A
//      operand (64 hidden units a warpgroup), the token rows the B operand
//      (N = 32, 64, 128 or 256 rows, the chunk rounded up), both K-major
//      as the plan's n-major copy and the row-major scratch already are.
//      An item is 128 units and one chunk of nc token rows, the two
//      consumer warpgroups sharing the chunk. The epilogue dequantizes
//      (s1, b1, with the 2^-0.5 fold when the hidden quantizer is linear),
//      then the folded GELU-quant (or GELU, then the pow quantizer), into
//      an int8 hidden scratch hid [M8][Hp] (Hp = H rounded up to 128; 1.4
//      / 2.8 MB at ViT-H b1 / b2, in L2).
//   3. fc2 as out^T = w2t hid^T the same way, an item 64 output columns
//      and two chunks, the warpgroups sharing the weight tile, over the
//      whole hidden depth; the epilogue acc * s2 + b2 + x in f32
//      (fused.py:699-700). No sum is split over blocks: the items cut the
//      tokens, not the depth, so there are no partial sums and no
//      reduction.
// The operands of each item arrive through a ring of 3-16 stages in shared
// memory, each stage one 128-deep step (the item's weight tiles and
// token tiles) written by TMA (cp.async.bulk.tensor) from CUtensorMaps
// the host encodes once per plan and M (the weights) or per scratch
// buffer (lv, hid), under the 128-byte swizzle, guarded by a full and an
// empty mbarrier; the producer warp keeps the ring ahead of the
// consumers across items, so the next steps' loads run under this
// step's wgmma. The token chunks and the wgmma N come from the wrapper
// (ops/fused.py:chunked_layout: the most token groups whose items still
// take one wave), from M, K, H and the card's SMs. (fc1's weight tiles are
// many, H / 128, and short, K deep: sharing the token chunk saves more;
// fc2's are few, K / 64, and long: sharing the weight tile does. Each
// phase in the other item shape was no faster on the card.)
//
// Traffic (L2 -> SM) at ViT-H b1 / b2, as chunked_layout picks: every
// weight tile is read by its items' blocks, each in the same wave, so
// each weight byte comes from device memory once and from L2 once a
// token group; the token rows are read once a weight tile. fc1 (40 tiles
// of 128 units, 3 groups of 96 / 184 rows): 6.5 MB of w1 x 3 + 0.37 /
// 0.71 MB of levels x 40 = 34.4 / 47.9 MB; fc2 (20 tiles of 64 columns,
// 6 groups of 2 x 24 / 48 rows): 6.5 MB of w2 x 6 + 1.5 / 2.9 MB of
// hidden levels x 20 = 68.8 / 98.3 MB (ChunkedLayout.l2_bytes). The first
// K8 read 118 / 223 MB of weights from L2 plus 39 MB of partials. These
// bytes, not the products, set the phases' time (PERF.md has the phases'
// times on an H100). Sharing fc2's weight tile between the two blocks of
// a cluster (TMA multicast, a cooperative cluster launch) halves its
// weight bytes, but the stages then wait on both blocks' consumers: it
// was slower on the card at every site, and is not used.
//
// Against the first K8:
//   - its 32-row tiles each re-read both weights: here a weight tile is
//     read once a token group, and the token chunks grow with M (up to
//     256 rows), so batch 2 reads each weight no more often than batch 1;
//   - its 16 x 8 mma.sync steps over 32-unit chunks, split over two depth
//     halves summed in shared memory with four block barriers a chunk:
//     here wgmma over 128-deep ring steps, one mbarrier wait a step;
//   - one 512-thread block an SM holding fc2's [32, K] accumulator in
//     registers (K <= 1280): here an accumulator is 64 rows x N tokens
//     whatever the width, so any K and H run;
//   - fc2's partials [S, M, K] int32 through device memory and a reduction
//     pass: gone; an item owns its outputs over the whole depth.
//
// Numerics: those of the plain version (ops/fused.py:fused_mlp_plain):
// the LayerNorm levels are exact (f64 sums rounded once, -fmad=false,
// rintf), the int32 products are exact in any order, and each epilogue is
// the plain version's f32 arithmetic in its order.

#include <cooperative_groups.h>

#include <algorithm>
#include <cstring>

#include "gemm_phases.cuh"
#include "wgmma_int8.cuh"

namespace cg = cooperative_groups;
namespace wg = qvt::wg;

namespace {

// weight rows an item (the wgmma M), depth bytes a ring stage (one
// 128-byte swizzled row), consumer warpgroups and threads, the block
constexpr int ROWS = 64, BK = 128, CWG = 2, CT = 128 * CWG, NT = CT + 32;
// the LayerNorm group of consumer threads a row: LN_MIN_T .. LN_MAX_T (no
// block barrier inside row_levels, which the producer warp skips)
constexpr int LN_MIN_T = 8, LN_MAX_T = 32;
// ring stages at most; shared memory a block may take; what the ring
// leaves for the 1024-byte alignment, the barriers and row_levels'
// static shared memory
constexpr int MAX_STAGES = 16, SMEM_MAX = 232448, SMEM_SLACK = 2048;

struct Args {
  CUtensorMap tm_w1;   // w1t [H][K] levels, 64 x 128 boxes
  CUtensorMap tm_w2;   // w2t [K][H]
  CUtensorMap tm_lv;   // lv [M8][Kp], nc1 x 128 boxes
  CUtensorMap tm_hid;  // hid [M8][Hp], nc2 x 128 boxes
  const void* x;
  int x_dt;
  const float* s1;
  const float* b1;
  const float* s2;
  const float* b2;
  const float* ln_g;
  const float* ln_b;
  const float* prm;  // act_d, act_t, hid_d, hid_t
  int8_t* lv;
  int8_t* hid;
  void* out;
  int out_dt;
  int M, K, H, Kp, Hp;
  int ln_t;
  // each phase's token chunk, wgmma N, token groups
  int nc1, nw1, g1, nc2, nw2, g2;
  int stages, stage_bytes;  // the ring
  int act_pow, hid_pow;
  float act_top, hid_top, eps;
  bool x_vec;
};

// The host's part, once a plan and M (qvt_mlp_chunked_prepare): the
// weights' maps, the layout and the grid; the activation maps of the
// scratch buffer they were last encoded for.
struct State {
  CUtensorMap tm_w1, tm_w2, tm_lv, tm_hid;
  const void* lv_at;
  const void* hid_at;
  int M, K, H, Kp, Hp, ln_t, nc1, nw1, g1, nc2, nw2, g2;
  int stages, stage_bytes, smem, grid;
};

// One GEMM phase: `rows` weight rows (the outputs) over `steps` 128-deep
// steps, the wgmma N `nw` (>= nc). With `shared_w` (fc2) an item is 64
// weight rows, the two consumer warpgroups sharing the weight tile, each
// its own chunk of `nc` token rows (the tokens in `groups` groups of two
// chunks); else (fc1) 128 weight rows, each warpgroup its own 64, both one
// chunk of `nc` rows (`groups` chunks).
struct Phase {
  const CUtensorMap* wmap;
  const CUtensorMap* amap;
  int rows, steps, nc, nw, groups;
  bool shared_w;
  __device__ __forceinline__ int wr() const {
    return shared_w ? ROWS : 2 * ROWS;
  }
  __device__ __forceinline__ int items() const {
    return (rows + wr() - 1) / wr() * groups;
  }
  // stage offsets of warpgroup w's weight tile and token tile
  __device__ __forceinline__ int a_off(int w) const {
    return shared_w ? 0 : w * ROWS * BK;
  }
  __device__ __forceinline__ int b_off(int w) const {
    return wr() * BK + (shared_w ? w * nw * BK : 0);
  }
};

// warpgroup w's tile of item `it`: its first weight row, its first token
// row and its token count (<= 0: no work for it)
__device__ __forceinline__ void tile_of(const Phase& p, int M, int it, int w,
                                        int& row0, int& t0, int& cnt) {
  const int rt = it / p.groups, q = it % p.groups;
  if (p.shared_w) {
    row0 = rt * ROWS;
    t0 = (q * 2 + w) * p.nc;
  } else {
    row0 = rt * 2 * ROWS + w * ROWS;
    t0 = q * p.nc;
  }
  cnt = row0 < p.rows ? min(p.nc, M - t0) : 0;
}

// The producer's TMA copies of step ks of item `it` into stage `st`,
// completing on `bar`, for the warpgroups with work (load: false counts
// the bytes only). Returns the step's bytes.
__device__ __forceinline__ uint32_t issue(const Args& a, const Phase& p,
                                          uint8_t* st, uint64_t* bar, int it,
                                          int ks, bool load) {
  uint32_t bytes = 0;
  for (int w = 0; w < CWG; ++w) {
    int row0, t0, cnt;
    tile_of(p, a.M, it, w, row0, t0, cnt);
    if (cnt <= 0) continue;
    if (w == 0 || !p.shared_w) {  // the weight tile: once if shared
      bytes += ROWS * BK;
      if (load)
        wg::tma_load_2d(st + p.a_off(w), p.wmap, ks * BK, row0, bar);
    }
    if (w == 0 || p.shared_w) {  // the token tile: once if shared
      bytes += p.nc * BK;
      if (load)
        wg::tma_load_2d(st + p.b_off(w), p.amap, ks * BK, t0, bar);
    }
  }
  return bytes;
}

// The producer (one thread): the ring's stages for this block's items of
// the phase, in the consumers' order. `it` counts stages over the launch.
// (Loading the next phase's first weight tiles ahead of the grid barrier
// changed nothing measurable on an H100, so the producer waits for it.)
__device__ __forceinline__ void produce(const Args& a, const Phase& p,
                                        uint8_t* ring, uint64_t* full,
                                        uint64_t* empty, uint32_t& it) {
  for (int item = blockIdx.x; item < p.items(); item += gridDim.x)
    for (int ks = 0; ks < p.steps; ++ks, ++it) {
      const int s = it % a.stages;
      wg::mbar_wait(&empty[s], ((it / a.stages) & 1) ^ 1);
      uint8_t* st = ring + s * a.stage_bytes;
      wg::mbar_arrive_tx(&full[s],
                         issue(a, p, st, &full[s], item, ks, false));
      issue(a, p, st, &full[s], item, ks, true);
    }
}

// fc1's epilogue from the accumulator: the hidden level of unit u (the
// tile's row) for token t (its column), stored to hid[t][u]
template <int NW, bool POW>
__device__ __forceinline__ void store_levels(const Args& a, const int (&d)[NW / 2],
                                             int row0, int t0, int cnt) {
  const int lane = threadIdx.x & 31, wq = (threadIdx.x >> 5) & 3;
  const int g = lane >> 2, t = lane & 3;
  const float hid_d = a.prm[2], hid_t = a.prm[3];
  const float c2 = 0.70710678118654757f / hid_d;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int u = row0 + 16 * wq + g + 8 * hh;
    if (u >= a.H) continue;
    const float sc = __ldg(a.s1 + u), bi = __ldg(a.b1 + u);
#pragma unroll
    for (int j = 0; j < NW / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 8 * j + 2 * t + e;
        if (col >= cnt) continue;
        const float y = static_cast<float>(d[4 * j + 2 * hh + e]) * sc + bi;
        const int8_t lv =
            POW ? qvt::quantize(qvt::gelu(y), hid_d, hid_t, a.hid_top, true,
                                false)
                : qvt::gelu_quant_folded_c2(y, c2, a.hid_top);
        a.hid[static_cast<long long>(t0 + col) * a.Hp + u] = lv;
      }
  }
}

// fc2's epilogue from the accumulator: out[t][f] = acc * s2 + b2 + x in
// f32 for output column f (the tile's row) and token t (its column)
template <int NW>
__device__ __forceinline__ void store_out(const Args& a, const int (&d)[NW / 2],
                                          int row0, int t0, int cnt) {
  const int lane = threadIdx.x & 31, wq = (threadIdx.x >> 5) & 3;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int f = row0 + 16 * wq + g + 8 * hh;
    if (f >= a.K) continue;
    const float sc = __ldg(a.s2 + f), bi = __ldg(a.b2 + f);
#pragma unroll
    for (int j = 0; j < NW / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 8 * j + 2 * t + e;
        if (col >= cnt) continue;
        const long long o = static_cast<long long>(t0 + col) * a.K + f;
        qvt::store_f(a.out, a.out_dt, o,
                     (static_cast<float>(d[4 * j + 2 * hh + e]) * sc + bi) +
                         qvt::load_f(a.x, a.x_dt, o));
      }
  }
}

// A consumer warpgroup: its chunk of each of this block's items of the
// phase, stage by stage (four k32 products a stage, waited for at once,
// so the stage goes back to the producer as early as it can: the phases
// are bound by the ring's loads, not by the products), then the
// epilogue. Every consumer warp releases each stage (the empty barrier
// counts the eight).
template <int NW, bool FC1>
__device__ __forceinline__ void consume(const Args& a, const Phase& p,
                                        uint8_t* ring, uint64_t* full,
                                        uint64_t* empty, uint32_t& it) {
  const int w = threadIdx.x / 128, lane = threadIdx.x & 31;
  for (int item = blockIdx.x; item < p.items(); item += gridDim.x) {
    int row0, t0, cnt;
    tile_of(p, a.M, item, w, row0, t0, cnt);
    int d[NW / 2];
#pragma unroll
    for (int i = 0; i < NW / 2; ++i) d[i] = 0;
    for (int ks = 0; ks < p.steps; ++ks, ++it) {
      const int s = it % a.stages;
      wg::mbar_wait(&full[s], (it / a.stages) & 1);
      if (cnt > 0) {
        const uint8_t* st = ring + s * a.stage_bytes;
        const uint64_t da = wg::desc_sw128(st + p.a_off(w));
        const uint64_t db = wg::desc_sw128(st + p.b_off(w));
        wg::fence_regs(d);
        wg::fence();
#pragma unroll
        for (int kk = 0; kk < BK / 32; ++kk)
          wg::Mma<NW>::run(d, da + 2 * kk, db + 2 * kk, 1);
        wg::commit();
        wg::wait<0>();
        wg::fence_regs(d);
      }
      if (lane == 0) wg::mbar_arrive(&empty[s]);
    }
    if (cnt <= 0) continue;
    if constexpr (FC1) {
      if (a.hid_pow)
        store_levels<NW, true>(a, d, row0, t0, cnt);
      else
        store_levels<NW, false>(a, d, row0, t0, cnt);
    } else {
      store_out<NW>(a, d, row0, t0, cnt);
    }
  }
}

// the phase's consumers at its wgmma N
template <bool FC1>
__device__ __forceinline__ void consume_at(int nw, const Args& a,
                                           const Phase& p, uint8_t* ring,
                                           uint64_t* full, uint64_t* empty,
                                           uint32_t& it) {
  switch (nw) {
    case 32: consume<32, FC1>(a, p, ring, full, empty, it); break;
    case 64: consume<64, FC1>(a, p, ring, full, empty, it); break;
    case 128: consume<128, FC1>(a, p, ring, full, empty, it); break;
    default: consume<256, FC1>(a, p, ring, full, empty, it); break;
  }
}

__global__ void __launch_bounds__(NT, 1)
    mlp_chunked_kernel(const __grid_constant__ Args a) {
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* ring = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full =
      reinterpret_cast<uint64_t*>(ring + a.stages * a.stage_bytes);
  uint64_t* empty = full + MAX_STAGES;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int s = 0; s < a.stages; ++s) {
      wg::mbar_init(&full[s], 1);
      wg::mbar_init(&empty[s], CT / 32);
    }
    wg::mbar_fence_init();
  }
  __syncthreads();
  cg::grid_group grid = cg::this_grid();
  qvt::PhaseClock clk;  // tools/phase_probe.py fused_mlp_chunked
  clk.begin();
  const Phase p1{&a.tm_w1, &a.tm_lv, a.H, (a.K + BK - 1) / BK,
                 a.nc1, a.nw1, a.g1, false};
  const Phase p2{&a.tm_w2, &a.tm_hid, a.K, (a.H + BK - 1) / BK,
                 a.nc2, a.nw2, a.g2, true};
  const bool producer = warp == CT / 32;
  uint32_t it = 0;
  // phase 1: the levels of quant(LN(x)) into lv, by the consumer threads
  if (!producer) {
    if (a.act_pow)
      qvt::row_levels<qvt::ROWS_LN, true, CT>(a);
    else
      qvt::row_levels<qvt::ROWS_LN, false, CT>(a);
  }
  wg::fence_proxy_async();  // lv's plain stores before phase 2's TMA
  clk.mark(0);
  grid.sync();
  clk.mark(1);
  // phase 2: fc1
  if (producer) {
    if (lane == 0) {
      wg::fence_proxy_async();
      produce(a, p1, ring, full, empty, it);
    }
  } else {
    consume_at<true>(a.nw1, a, p1, ring, full, empty, it);
  }
  wg::fence_proxy_async();  // hid's plain stores before phase 3's TMA
  clk.mark(2);
  grid.sync();
  clk.mark(3);
  // phase 3: fc2
  if (producer) {
    if (lane == 0) {
      wg::fence_proxy_async();
      produce(a, p2, ring, full, empty, it);
    }
  } else {
    consume_at<false>(a.nw2, a, p2, ring, full, empty, it);
  }
  clk.mark(4);
  clk.store(blockIdx.x);
}

// blocks co-resident on an SM at `smem` bytes (0 on an error)
int per_sm(int smem) {
  static bool attr = false;
  if (!attr) {
    if (cudaFuncSetAttribute(mlp_chunked_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             SMEM_MAX - 1024) != cudaSuccess)
      return 0;
    attr = true;
  }
  int v = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&v, mlp_chunked_kernel,
                                                    NT, smem) != cudaSuccess)
    return 0;
  return v;
}

bool nw_ok(int nw) {
  return nw == 32 || nw == 64 || nw == 128 || nw == 256;
}

State* state_of(void* p) {
  return reinterpret_cast<State*>((reinterpret_cast<uintptr_t>(p) + 63) &
                                  ~uintptr_t(63));
}

// A phase's layout is sound: the chunk nc a multiple of 8 up to the wgmma
// N nw and the scratch rows, the groups of `chunks` chunks covering M and
// none of them empty
bool phase_ok(int M, int chunks, int nc, int nw, int g) {
  const int M8 = (M + 7) / 8 * 8;
  const long long group = static_cast<long long>(chunks) * nc;
  return nw_ok(nw) && nc >= 8 && nc % 8 == 0 && nc <= nw && nc <= M8 &&
         g >= 1 && group * g >= M && group * (g - 1) < M;
}

}  // namespace

// Bytes of the host state a caller allocates for one plan and M (a
// CUtensorMap is 64-byte aligned: the state starts at the first 64-byte
// boundary of the buffer).
extern "C" int qvt_mlp_chunked_state_bytes() {
  return static_cast<int>(sizeof(State)) + 64;
}

// Once a plan and M: checks the layout, encodes the weights' maps (w1t
// [H8][Kw], w2t [K8][Hw] levels, n-major, with H8 and K8 the rows rounded
// up to 64 and Kw and Hw multiples of 16 and at least 128: the plan pads
// small shapes), sizes the ring and the grid on the current device. The
// layout (ops/fused.py:chunked_layout): ln_t threads a LayerNorm row (8,
// 16, 32); per GEMM phase the token chunk nc (8 .. nw, a multiple of 8),
// the wgmma N nw (32, 64, 128, 256) and the token groups g (fc1's of one
// chunk, fc2's of two); `stages` ring stages (3 .. 16). A stage holds the
// larger phase's tiles: fc1's 128 weight rows and nw1 token rows, fc2's
// 64 weight rows and two chunks of nw2 rows.
extern "C" int qvt_mlp_chunked_prepare(void* state, const void* w1t,
                                       const void* w2t, int M, int K, int H,
                                       int Kw, int Hw, int ln_t, int nc1,
                                       int nw1, int g1, int nc2, int nw2,
                                       int g2, int stages) {
  State* s = state_of(state);
  if (M < 1 || K < 1 || H < 1 || !phase_ok(M, 1, nc1, nw1, g1) ||
      !phase_ok(M, CWG, nc2, nw2, g2))
    return static_cast<int>(cudaErrorInvalidValue);
  const int stage_bytes =
      std::max(2 * ROWS + nw1, ROWS + CWG * nw2) * BK;
  const int smem = 1024 + stages * stage_bytes + 2 * MAX_STAGES * 8;
  if (Kw < K || Hw < H || Kw % 16 || Hw % 16 || Kw < BK || Hw < BK ||
      ln_t < LN_MIN_T || ln_t > LN_MAX_T || (ln_t & (ln_t - 1)) ||
      stages < 3 || stages > MAX_STAGES ||
      smem + SMEM_SLACK - 1024 > SMEM_MAX ||
      (reinterpret_cast<uintptr_t>(w1t) & 15) ||
      (reinterpret_cast<uintptr_t>(w2t) & 15))
    return static_cast<int>(cudaErrorInvalidValue);
  std::memset(static_cast<void*>(s), 0, sizeof(State));
  const int H8 = (H + ROWS - 1) / ROWS * ROWS;
  const int K8 = (K + ROWS - 1) / ROWS * ROWS;
  int e = qvt::encode_tiled_int8(&s->tm_w1, w1t, Kw, H8, Kw, ROWS);
  if (!e) e = qvt::encode_tiled_int8(&s->tm_w2, w2t, Hw, K8, Hw, ROWS);
  if (e) return e;
  s->M = M;
  s->K = K;
  s->H = H;
  s->Kp = (K + BK - 1) / BK * BK;
  s->Hp = (H + BK - 1) / BK * BK;
  s->ln_t = ln_t;
  s->nc1 = nc1;
  s->nw1 = nw1;
  s->g1 = g1;
  s->nc2 = nc2;
  s->nw2 = nw2;
  s->g2 = g2;
  s->stages = stages;
  s->stage_bytes = stage_bytes;
  s->smem = smem;
  int dev = 0, sms = 0;
  cudaError_t ce = cudaGetDevice(&dev);
  if (ce == cudaSuccess)
    ce = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (ce != cudaSuccess) return static_cast<int>(ce);
  const int cap = per_sm(smem) * sms;
  if (cap < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  // enough blocks for the largest phase: row groups, fc1's, fc2's items
  const long long want = std::max<long long>(
      std::max<long long>((M + CT / ln_t - 1) / (CT / ln_t),
                          (H + 2 * ROWS - 1) / (2 * ROWS) *
                              static_cast<long long>(g1)),
      (K + ROWS - 1) / ROWS * static_cast<long long>(g2));
  s->grid = static_cast<int>(std::min<long long>(cap, want));
  return 0;
}

// One launch for the prepared plan and M: x [M, K] (bf16 or f32), the
// plan's scales, biases and LayerNorm affine (f32), prm (act_d, act_t,
// hid_d, hid_t on the device), lv: scratch [M8][Kp] and hid: [M8][Hp]
// int8 (16-byte aligned; their maps are encoded again when they move),
// out [M, K] in out_dt.
extern "C" int qvt_fused_mlp_chunked(
    void* state, const void* x, int x_dt, const void* s1, const void* b1,
    const void* s2, const void* b2, const void* ln_g, const void* ln_b,
    const void* prm, void* lv, void* hid, void* out, int out_dt,
    int act_pow, int hid_pow, int act_top, int hid_top, float eps,
    void* stream) {
  State* s = state_of(state);
  if ((reinterpret_cast<uintptr_t>(lv) | reinterpret_cast<uintptr_t>(hid)) &
      15)
    return static_cast<int>(cudaErrorInvalidValue);
  const int M8 = (s->M + 7) / 8 * 8;
  if (s->lv_at != lv) {
    const int e =
        qvt::encode_tiled_int8(&s->tm_lv, lv, s->Kp, M8, s->Kp, s->nc1);
    if (e) return e;
    s->lv_at = lv;
  }
  if (s->hid_at != hid) {
    const int e =
        qvt::encode_tiled_int8(&s->tm_hid, hid, s->Hp, M8, s->Hp, s->nc2);
    if (e) return e;
    s->hid_at = hid;
  }
  Args a;
  a.tm_w1 = s->tm_w1;
  a.tm_w2 = s->tm_w2;
  a.tm_lv = s->tm_lv;
  a.tm_hid = s->tm_hid;
  a.x = x;
  a.x_dt = x_dt;
  a.s1 = static_cast<const float*>(s1);
  a.b1 = static_cast<const float*>(b1);
  a.s2 = static_cast<const float*>(s2);
  a.b2 = static_cast<const float*>(b2);
  a.ln_g = static_cast<const float*>(ln_g);
  a.ln_b = static_cast<const float*>(ln_b);
  a.prm = static_cast<const float*>(prm);
  a.lv = static_cast<int8_t*>(lv);
  a.hid = static_cast<int8_t*>(hid);
  a.out = out;
  a.out_dt = out_dt;
  a.M = s->M;
  a.K = s->K;
  a.H = s->H;
  a.Kp = s->Kp;
  a.Hp = s->Hp;
  a.ln_t = s->ln_t;
  a.nc1 = s->nc1;
  a.nw1 = s->nw1;
  a.g1 = s->g1;
  a.nc2 = s->nc2;
  a.nw2 = s->nw2;
  a.g2 = s->g2;
  a.stages = s->stages;
  a.stage_bytes = s->stage_bytes;
  a.act_pow = act_pow;
  a.hid_pow = hid_pow;
  a.act_top = static_cast<float>(act_top);
  a.hid_top = static_cast<float>(hid_top);
  a.eps = eps;
  // the 16-byte path of phase 1 (K2's rule): rows of whole pieces;
  // gamma, beta as float4
  a.x_vec = (reinterpret_cast<uintptr_t>(x) & 15) == 0 && s->K % 16 == 0 &&
            (x_dt == qvt::DT_BF16 || x_dt == qvt::DT_F32) &&
            ((reinterpret_cast<uintptr_t>(ln_g) |
              reinterpret_cast<uintptr_t>(ln_b)) & 15) == 0;
  void* args[] = {&a};
  cudaError_t e = cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(mlp_chunked_kernel), dim3(s->grid), dim3(NT),
      args, s->smem, static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

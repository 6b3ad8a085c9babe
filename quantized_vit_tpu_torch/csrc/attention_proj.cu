// K9: attention + proj in one launch, for Hopper (sm_90a).
//
// Replaces the TPU kernel quantized_vit_tpu/ops/attention.py:
// _attn_proj_kernel (pallas_call in _attention_qkv_proj, attention.py:770):
//   out = residual + levels(softmax(q k^T s) v) @ w_proj * scale (+ bias)
// on the raw fused-qkv tensor [B, N, (3, H, hd)] in the residual dtype:
// per head the masked exp2 softmax with deferred normalization (as K6),
// the proj quantizer's int8 levels (round(o_un * (1/(p_sum*d))) at t = 1,
// the pow quantizer of o_un/p_sum otherwise: attention.py:348-355), then
// the int8 proj GEMM (w_proj int8 [H*hd, D] or packed int4 [H*hd/2, D]),
// acc*scale (+bias) + residual in f32, cast to the output dtype
// (:357-375). The TPU kernel keeps the levels in VMEM scratch; so does
// this one: they never reach device memory.
//
// Numerics, those of K6 (K3 and K5 run its tile), which the plain
// version (ops/attention.py:attention_qkv_proj_plain) mirrors: float path,
// q pre-scaled by sm_scale*log2e and rounded back to the qkv dtype, scores
// over the n_valid keys, p = exp2(min(s, 100)) with no row max, p rounded
// to the qkv dtype for P.V, p_sum from f32 p plus 1e-30; int_attention,
// q*sm_scale, k and v as int8 levels with per-(image, head) scales over all
// n query rows and the nk key rows, the row max first, p levels
// round(p*127), p_sum their sum. Built with -fmad=false; sums in f64,
// rounded once to f32.
//
// Design. The TPU program walks the heads with everything in VMEM; on this
// card one block walking 16 heads left most SMs idle (a block per (image,
// 64-row tile): 40 blocks on 132 SMs at ViT-H/14 batch 8). Here the heads
// are split over a thread-block cluster of G blocks (G | H, G <= 8): a
// cluster takes one (image, tile of R = 32 or 16 query rows), its block of
// rank r the heads [r*H/G, (r+1)*H/G). (R, G) come from the wrapper
// (ops/attention.py:qkv_proj_layout, from the card's SMs and shared
// memory; tools/qkv_proj_design.py times every layout).
// - Attention, per head, on the FP64 tensor cores (mma.sync m16n8k4 .f64,
//   fp64_mma.cuh, as K13), widening each fragment value to f64 as it
//   loads. q is staged once a head as f32, pre-scaled (or as levels). K
//   and V stream raw (the qkv dtype) in chunks of KC keys (64; 32 at
//   R = 16), K_0 V_0 K_1 V_1 ... over all the block's heads, with cp.async
//   into three buffers in bf16 (two in f32): a chunk's copy runs during
//   the two steps before it, one barrier a step. int_attention turns a
//   landed chunk into levels in place (exact in bf16). The float path
//   needs no row max, so a chunk goes from scores to p (a [R][KC] tile)
//   to P.V at once; int_attention first streams the head's K chunks for
//   the row max, then recomputes the same exact scores. Each warp keeps
//   its patch of the [R x hd] output in f64 registers over the head's
//   chunks; the p sums are kept per lane and reduced over the quad and
//   the warps in a fixed order.
// - int_attention's scales (attention.py:140-147) are maxima over all n
//   query rows and the nk key rows of a head, rows that span every query
//   tile's cluster. Computing them once per (image, head) would take a
//   second launch or an exchange between clusters; K9 stays one launch,
//   so each block scans its own heads' q, k and v once a head, at the
//   head's start and outside the chunk loop: (n + 2 nk) x hd values per
//   (tile, head), from L2 after the first tile reads them.
//   tools/phase_probe.py times the scan (its "int scales" phase).
// - Row strides (elements): q HDM + 4 (f32); k HDM + 8 (bf16) or HDM + 4
//   (f32); v HDM + 8; the p tile KC + 4: each warp's fragment loads fall
//   in 32 banks.
// - The levels: each block writes its heads' levels into its own columns of
//   an int8 tile [R][H*hd] in shared memory; after cluster.sync() it copies
//   the other blocks' columns out of their shared memory (distributed
//   shared memory, map_shared_rank) into its tile.
// - Proj, split by output columns: block r takes D/G columns (rounded up
//   to 8) over the full depth, with the int8 mma.sync loop (m16n8k32 s8,
//   256 columns a pass, cp.async weight chunks of 64 levels, three in
//   flight, in the space the attention freed; packed int4 unpacked into
//   the fragments: low nibbles against level columns k', high against
//   H*hd/2 + k'); the epilogue goes through shared memory so that the
//   residual and the output move as rows. Each output column's int32 sum
//   runs in one block, so the result does not depend on the split; each
//   w_proj byte is read once per cluster. A final cluster.sync() keeps
//   every block's shared memory alive until the others have read it.
//
// Exactness. Products of bf16 or f32 values, and of int8 levels, are exact
// in f64, so only the order of the f64 additions differs from the plain
// version's. For bf16 the f64 sums are exact at these shapes, so every
// order gives the same f32; for f32 an order moves the result only when
// the f64 sum lies within 2^-29 of an f32 tie, inside the attention
// contract (tests/test_torch_qkv_proj_layout.py counts them in this
// kernel's order). The proj's int32 sums are exact in any split.
//
// Bound on this card at ViT-H/14 batch 8 (8 x 272 rows, 16 heads of 80,
// D 1280, bf16): 29.5 MB moved (8.8 us at 3.35 TB/s) against 3.0 G
// attention operations at the bf16 rate and 7.1 G int8 proj operations
// (6.7 us): bytes. An exact kernel cannot use the bf16 rate: its ceiling is
// the 3.0 GFLOP over the FP64 tensor cores' 67 TFLOP/s (45 us) plus the
// proj at the int8 rate (3.6 us).

#include <cooperative_groups.h>

#include <algorithm>

#include "fp64_mma.cuh"
#include "qkv_stream.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int NT = qvt::QKV_NT, NW = NT / 32;
using qvt::absmax_rows;
using qvt::from_f32;
using qvt::load8;
using qvt::prefetch;
using qvt::store8;
using qvt::store_rows;
using qvt::to_f32;
using qvt::widen16;
using qvt::Xf;
constexpr int HDMAX = 80;     // the widest head (head_bound)
constexpr int PN = 256;       // proj output columns per pass (32 a warp)
constexpr int PK = 64;        // proj levels per chunk
constexpr int SB = PK + 16;   // weight chunk row stride (bytes)
constexpr int WBUF = PN * SB;
// static shared memory: the scale reduction and two heads' scales
constexpr int SMEM_STATIC = 3 * NW * 4 + 2 * 8 * 4;
constexpr int SMEM_MAX = 232448 - SMEM_STATIC;

// keys a chunk: 64, or 32 at 16 rows (which keeps the smallest tile's
// attention inside the weight buffers' space); K/V chunk buffers: 3 in the
// qkv dtype bf16, 2 in f32; weight buffers: 3, 2 at 16 rows
__host__ __device__ constexpr int key_chunk(int R) { return R >= 32 ? 64 : 32; }
__host__ __device__ constexpr int kv_buffers(int es) { return es == 2 ? 3 : 2; }
__host__ __device__ constexpr int weight_stages(int R) {
  return R >= 32 ? 3 : 2;
}
__host__ __device__ constexpr int head_bound(int hd) {
  return hd <= 64 ? 64 : 80;
}
__host__ __device__ inline int round_up(int a, int b) {
  return (a + b - 1) / b * b;
}

// bytes of the attention's shared memory: q (f32), the K/V chunk buffers
// (the qkv dtype, `es` bytes an element, rows HDM + 8 apart), the p tile
// (f32), the row sums' (f64) and row maxima's (f32) per-warp partials
// (mirrored by ops/attention.py:qkv_proj_smem_bytes)
__host__ __device__ constexpr int attn_bytes(int R, int HDM, int es) {
  return 4 * R * (HDM + 4) + kv_buffers(es) * key_chunk(R) * (HDM + 8) * es +
         4 * R * (key_chunk(R) + 4) + 12 * NW * R;
}

// the level tile [R][sa] (sa = round_up(H*hd, 64) + 16), then the
// attention's space, later the weight buffers
size_t smem_bytes(int R, int hd, int hdim, int es) {
  return static_cast<size_t>(R) * (round_up(hdim, 64) + 16) +
         std::max(attn_bytes(R, head_bound(hd), es),
                  weight_stages(R) * WBUF);
}

struct Args {
  const void* qkv;
  int qkv_dt;
  const int8_t* w;  // n-major: [D][H*hd] int8 or [D][H*hd/2] packed int4
  int w4;
  const float* scale;  // [D]
  const float* bias;   // [D] or null
  const void* res;
  int res_dt;
  const float* prm;  // out_d, out_t
  void* out;
  int out_dt;
  int B, n, heads, hd, D, n_valid, nk;
  int G;   // blocks a cluster (heads split G ways)
  int dg;  // proj output columns a block
  int sa;  // level tile row stride: round_up(H*hd, 64) + 16
  float q_mul, sm_scale, out_top;
  int out_pow;
  bool int_attn, qkv_vec, w_vec;
  bool out_vec;  // residual and output rows as 16-byte pieces of 8 values
};

template <typename T, int R, int HDM>
__global__ void __launch_bounds__(NT, 2) qkv_proj_kernel(Args a) {
  constexpr int KC = key_chunk(R), WST = weight_stages(R);
  constexpr int KVB = kv_buffers(sizeof(T));
  // rows (elements) of q (f32), of a K and a V chunk (T: raw qkv values)
  // and of the p tile (f32): each warp's fragment loads in 32 banks
  constexpr int LDQ = HDM + 4, LDV = HDM + 8, LDP = KC + 4;
  constexpr int LDK = sizeof(T) == 2 ? HDM + 8 : HDM + 4;
  constexpr int CBUF = KC * LDV;  // elements of a chunk buffer
  // scores: [R x KC] a chunk; P.V: [R x HDM]
  constexpr qvt::WarpGrid SG = qvt::warp_grid(R / 16, KC / 8);
  constexpr int SWM = R / 16 / SG.wr, SWN = KC / 8 / SG.wc;
  // P.V's n-tiles: at 32 rows and head bound 80, 12 (columns 80-95 are
  // computed and dropped) so all 8 warps take 3 tiles, not 5 warps 4
  constexpr int PVT = R == 32 && HDM == 80 ? 12 : HDM / 8;
  constexpr qvt::WarpGrid OG = qvt::warp_grid(R / 16, PVT);
  constexpr int OWM = R / 16 / OG.wr, OWN = PVT / OG.wc;
  constexpr int VE = 16 / sizeof(T);  // elements a 16-byte piece
  constexpr int QV = (R * HDM / VE + NT - 1) / NT;  // q pieces a thread
  constexpr int MT = R / 16;  // the proj's m16 row groups

  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float isc[2][8];  // q_inv k_inv v_inv s_mul v_s, by head parity
  __shared__ float red[3][NW];
  cg::cluster_group cluster = cg::this_cluster();
  const int G = a.G, rank = static_cast<int>(cluster.block_rank());
  const int q0 = (blockIdx.x / G) * R, b = blockIdx.y;
  const int n = a.n, nk = a.nk, hd = a.hd, H = a.heads;
  const int HD = H * hd, SA = a.sa, HB = H / G;
  const long long W = 3 * HD;
  const int nq = min(n - q0, R);
  int8_t* lv = reinterpret_cast<int8_t*>(smem);  // [R][SA]
  unsigned char* region = smem + R * SA;
  float* Qs = reinterpret_cast<float*>(region);  // [R][LDQ]
  T* Cb = reinterpret_cast<T*>(Qs + R * LDQ);  // KVB x [KC][LDK or LDV]
  float* Ps = reinterpret_cast<float*>(Cb + KVB * CBUF);  // [R][LDP]
  double* psp = reinterpret_cast<double*>(Ps + R * LDP);  // [NW][R]
  float* rmp = reinterpret_cast<float*>(psp + NW * R);    // [NW][R]
  const T* src = static_cast<const T*>(a.qkv);
  const long long row0 = static_cast<long long>(b) * n;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const bool INT = a.int_attn;

  // the step stream: per head (int_attention: nkc K chunks for the row
  // max first), then K_0 V_0 K_1 V_1 ...
  const int nkc = (nk + KC - 1) / KC;
  const int pre_steps = INT ? nkc : 0, sph = pre_steps + 2 * nkc;
  const int nsteps = HB * sph;
  enum { KMAX = 0, KS = 1, VS = 2 };
  auto kind_of = [&](int j) {
    return j < pre_steps ? KMAX : (((j - pre_steps) & 1) ? VS : KS);
  };
  auto chunk_of = [&](int j) {
    return j < pre_steps ? j : (j - pre_steps) >> 1;
  };
  auto head_src = [&](int hl) {
    return src + row0 * W + (rank * HB + hl) * hd;
  };

  // int_attention: head hl's dynamic scales (attention.py:140-147) over all
  // n query rows and the nk key rows, into isc[hl & 1]; every thread calls
  auto scales = [&](int hl) {
    const T* hs = head_src(hl);
    float m[3] = {absmax_rows(hs, W, n, hd, a.qkv_vec, a.sm_scale),
                  absmax_rows(hs + HD, W, nk, hd, a.qkv_vec, 1.f),
                  absmax_rows(hs + 2 * HD, W, nk, hd, a.qkv_vec, 1.f)};
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      for (int o = 16; o > 0; o >>= 1)
        m[j] = fmaxf(m[j], __shfl_xor_sync(0xffffffffu, m[j], o));
      if (lane == 0) red[j][warp] = m[j];
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      float s[3];
      for (int j = 0; j < 3; ++j) {
        float mx = 0.f;
        for (int w = 0; w < NW; ++w) mx = fmaxf(mx, red[j][w]);
        s[j] = fmaxf(mx, 1e-30f) * static_cast<float>(1.0 / 127.0);
      }
      float* is = isc[hl & 1];
      is[0] = 1.0f / s[0];
      is[1] = 1.0f / s[1];
      is[2] = 1.0f / s[2];
      is[3] = s[0] * s[1] * static_cast<float>(1.4426950408889634);
      is[4] = s[2];
    }
    __syncthreads();
  };
  // head hl's q rows of the tile, transformed, into Qs (rows past nq zero)
  auto stage_q = [&](int hl) {
    const T* qs = head_src(hl) + static_cast<long long>(q0) * W;
    const Xf f = INT ? Xf{2, 0, a.sm_scale, isc[hl & 1][0]}
                     : Xf{1, a.qkv_dt, a.q_mul, 1.f};
    uint4 qv[QV];
    if (a.qkv_vec) prefetch(qv, qs, W, nq, hd);
    store_rows<T, LDQ>(Qs, qv, qs, W, nq, R, hd, a.qkv_vec, f);
  };
  // step s's K or V chunk, raw, into buffer s % KVB with cp.async (rows
  // past the nk keys zero): one commit group (empty past the last step)
  auto issue = [&](int s) {
    if (s >= nsteps) {
      asm volatile("cp.async.commit_group;\n" ::);
      return;
    }
    const int j = s % sph, c = chunk_of(j);
    const bool v = kind_of(j) == VS;
    const int rows = min(KC, nk - c * KC), LD = v ? LDV : LDK;
    const T* p = head_src(s / sph) + static_cast<long long>(c) * KC * W +
                 (v ? 2 * HD : HD);
    T* dst = Cb + (s % KVB) * CBUF;
    if (a.qkv_vec) {
      const int valid = rows * hd / VE;
      for (int i = threadIdx.x; i < KC * hd / VE; i += NT) {
        const int e = i * VE, r = e / hd, cc = e - r * hd;
        qvt::cp_async16(dst + r * LD + cc, i < valid ? p + r * W + cc : p,
                        i < valid);
      }
    } else {
      for (int e = threadIdx.x; e < KC * hd; e += NT) {
        const int r = e / hd, cc = e - r * hd;
        dst[r * LD + cc] = r < rows ? p[r * W + cc] : from_f32<T>(0.f);
      }
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };
  // int_attention: step s's chunk (landed) as int8 levels, in place
  // (levels are exact in bf16)
  auto levels = [&](int s) {
    const bool v = kind_of(s % sph) == VS;
    const int LD = v ? LDV : LDK;
    const float inv = isc[(s / sph) & 1][v ? 2 : 1];
    T* d = Cb + (s % KVB) * CBUF;
    for (int e = threadIdx.x; e < KC * hd; e += NT) {
      const int r = e / hd, cc = e - r * hd;
      const float x = to_f32(d[r * LD + cc]);
      d[r * LD + cc] =
          from_f32<T>(fminf(fmaxf(rintf(x * inv), -127.f), 127.f));
    }
  };

  qvt::PhaseClock clk;
  clk.begin();
  if (INT) {
    scales(0);
    clk.mark(5);
  }
  stage_q(0);
  for (int s = 0; s < KVB; ++s) issue(s);
  asm volatile("cp.async.wait_group %0;\n" ::"n"(KVB - 1));
  __syncthreads();
  if (INT) {
    levels(0);
    __syncthreads();
  }
  clk.mark(0);

  // score warps: a patch of [R x KC] at (m0, n0); P.V warps: of
  // [R x 8 PVT]
  const int m0 = warp / SG.wc * SWM * 16, n0 = warp % SG.wc * SWN * 8;
  const bool scorer = warp < SG.wr * SG.wc;
  const int om0 = warp / OG.wc * OWM * 16, on0 = warp % OG.wc * OWN * 8;
  const bool owner = warp < OG.wr * OG.wc && om0 < nq;
  double psum[SWM][2];  // this lane's share of its rows' p sums
  float rmax[SWM][2];   // int_attention: its rows' maxima
  double oacc[OWM][OWN][4];

  for (int s = 0; s < nsteps; ++s) {
    const int hl = s / sph, j = s % sph, kind = kind_of(j), c = chunk_of(j);
    const T* buf = Cb + (s % KVB) * CBUF;
    const int kc = min(KC, nk - c * KC);
    const float* is = isc[hl & 1];
    if (kind != VS) {
      if (c == 0) {
#pragma unroll
        for (int i = 0; i < SWM; ++i)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            if (kind == KMAX) {
              rmax[i][h] = -__int_as_float(0x7f800000);  // -inf
            } else {
              psum[i][h] = 0.0;
              if (INT && scorer) {  // the row max from the first pass
                const int r = m0 + 16 * i + 8 * h + g;
                float mx = rmp[r];
                for (int w = 1; w < SG.wc; ++w) mx = fmaxf(mx, rmp[w * R + r]);
                rmax[i][h] = mx;
              }
            }
          }
      }
      if (scorer && m0 < nq && n0 < kc) {
        double acc[SWM][SWN][4];
#pragma unroll
        for (int i = 0; i < SWM; ++i)
#pragma unroll
          for (int jj = 0; jj < SWN; ++jj)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[i][jj][e] = 0.0;
#pragma unroll
        for (int kk = 0; kk < HDM; kk += 4) {
          if (kk >= hd) break;
          double av[SWM][2], bv[SWN];
#pragma unroll
          for (int i = 0; i < SWM; ++i)
#pragma unroll
            for (int h = 0; h < 2; ++h)
              av[i][h] = Qs[(m0 + 16 * i + 8 * h + g) * LDQ + kk + t];
#pragma unroll
          for (int jj = 0; jj < SWN; ++jj)
            bv[jj] = to_f32(buf[(n0 + 8 * jj + g) * LDK + kk + t]);
#pragma unroll
          for (int i = 0; i < SWM; ++i)
#pragma unroll
            for (int jj = 0; jj < SWN; ++jj)
              qvt::dmma(acc[i][jj], av[i], bv[jj]);
        }
        const int key0 = c * KC + n0 + 2 * t;
#pragma unroll
        for (int i = 0; i < SWM; ++i)
#pragma unroll
          for (int jj = 0; jj < SWN; ++jj)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int h = e >> 1, key = key0 + 8 * jj + (e & 1);
              float sc = static_cast<float>(acc[i][jj][e]);
              if (INT) sc = sc * is[3];
              if (kind == KMAX) {
                rmax[i][h] = fmaxf(rmax[i][h], key < a.n_valid ? sc : -1e30f);
                continue;
              }
              float p;
              if (INT) {
                p = key < a.n_valid ? exp2f(sc - rmax[i][h]) : 0.f;
                p = rintf(p * 127.0f);
                psum[i][h] += static_cast<double>(p);
              } else {
                p = key < a.n_valid ? exp2f(fminf(sc, 100.f)) : 0.f;
                psum[i][h] += static_cast<double>(p);
                p = qvt::round_to(p, a.qkv_dt);
              }
              Ps[(m0 + 16 * i + 8 * h + g) * LDP + n0 + 8 * jj + 2 * t +
                 (e & 1)] = p;
            }
      }
      // after the head's last K chunk of a pass: this warp's share of its
      // rows' max (first pass) or p sum, reduced over the quad
      if (scorer && c == nkc - 1) {
#pragma unroll
        for (int i = 0; i < SWM; ++i)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = m0 + 16 * i + 8 * h + g;
            if (kind == KMAX) {
              float mx = rmax[i][h];
              mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
              mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
              if (t == 0) rmp[(warp % SG.wc) * R + r] = mx;
            } else {
              double ps = psum[i][h];
              ps += __shfl_xor_sync(0xffffffffu, ps, 1);
              ps += __shfl_xor_sync(0xffffffffu, ps, 2);
              if (t == 0) psp[(warp % SG.wc) * R + r] = ps;
            }
          }
      }
    } else {
      // o += p . v over this chunk's keys
      if (c == 0) {
#pragma unroll
        for (int i = 0; i < OWM; ++i)
#pragma unroll
          for (int jj = 0; jj < OWN; ++jj)
#pragma unroll
            for (int e = 0; e < 4; ++e) oacc[i][jj][e] = 0.0;
      }
      if (owner) {
#pragma unroll 4
        for (int kk = 0; kk < kc; kk += 4) {
          double av[OWM][2], bv[OWN];
#pragma unroll
          for (int i = 0; i < OWM; ++i)
#pragma unroll
            for (int h = 0; h < 2; ++h)
              av[i][h] = static_cast<double>(
                  Ps[(om0 + 16 * i + 8 * h + g) * LDP + kk + t]);
#pragma unroll
          for (int jj = 0; jj < OWN; ++jj)
            bv[jj] = to_f32(buf[(kk + t) * LDV + on0 + 8 * jj + g]);
#pragma unroll
          for (int i = 0; i < OWM; ++i)
#pragma unroll
            for (int jj = 0; jj < OWN; ++jj)
              qvt::dmma(oacc[i][jj], av[i], bv[jj]);
        }
        if (c == nkc - 1) {
          // the head's levels into this block's columns of the level tile
          const int col0 = (rank * HB + hl) * hd;
#pragma unroll
          for (int i = 0; i < OWM; ++i)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int r = om0 + 16 * i + 8 * h + g;
              if (r >= nq) continue;
              double ps = psp[r];
              for (int w = 1; w < SG.wc; ++w) ps += psp[w * R + r];
              const float pf = INT ? static_cast<float>(ps)
                                   : static_cast<float>(ps) + 1e-30f;
              const float inv = 1.0f / (pf * a.prm[0]);
#pragma unroll
              for (int jj = 0; jj < OWN; ++jj)
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                  const int col = on0 + 8 * jj + 2 * t + e;
                  if (col >= hd) continue;
                  float ov = static_cast<float>(oacc[i][jj][2 * h + e]);
                  if (INT) ov = ov * is[4];
                  lv[r * SA + col0 + col] =
                      a.out_pow ? qvt::quantize(ov / pf, a.prm[0], a.prm[1],
                                                a.out_top, true, false)
                                : qvt::clip_round(ov * inv, a.out_top);
                }
            }
        }
      }
    }
    clk.mark(1);
    // the next step's chunk has landed (its copy ran during the last KVB - 1
    // steps' MMAs); once every warp is past this step, its buffer takes the
    // copy of step s + KVB, and a new head's scales and q rows are staged
    const bool more = s + 1 < nsteps, new_head = more && (s + 1) % sph == 0;
    asm volatile("cp.async.wait_group %0;\n" ::"n"(KVB - 2));
    if (new_head && INT) {
      clk.mark(0);
      scales(hl + 1);
      clk.mark(5);
    }
    __syncthreads();
    if (more) {
      if (INT) levels(s + 1);
      if (new_head) stage_q(hl + 1);
      issue(s + KVB);
      if (INT || new_head) __syncthreads();
    }
    clk.mark(0);
  }

  // the levels of every head: this block's columns are in its tile, the
  // others' in the cluster's other blocks
  cluster.sync();
  const bool w4 = a.w4 != 0;
  const int half = HD >> 1, ldw = w4 ? half : HD;
  const int n_chunks = w4 ? (half + 31) / 32 : (HD + PK - 1) / PK;
  const int c0 = rank * a.dg, c1 = min(a.D, c0 + a.dg);
  int8_t* wb = reinterpret_cast<int8_t*>(region);
  // chunk ch of the pass at column nb (its columns < c1) into weight
  // buffer ch % WST: one commit group (an empty one past the last chunk)
  auto load = [&](int nb, int ch) {
    const int wp = w4 ? 2 : 4, kb = ch * (w4 ? 32 : PK);
    const int width = min(PN, c1 - nb);
    int8_t* wbuf = wb + (ch % WST) * WBUF;
    for (int i = threadIdx.x; ch < n_chunks && i < width * wp; i += NT) {
      const int nn = i / wp, cc = (i - nn * wp) * 16;
      const int col = nb + nn, k = kb + cc;
      int8_t* dst = wbuf + nn * SB + cc;
      const int8_t* wsrc = a.w + static_cast<long long>(col) * ldw + k;
      if (a.w_vec) {
        const bool ok = col < c1 && k < ldw;
        qvt::cp_async16(dst, ok ? wsrc : a.w, ok);
      } else {
        for (int jj = 0; jj < 16; ++jj)
          dst[jj] = (col < c1 && k + jj < ldw) ? wsrc[jj] : int8_t(0);
      }
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };
  // the first pass's first chunks in flight during the exchange
  if (c0 < c1)
    for (int ch = 0; ch < WST - 1; ++ch) load(c0, ch);
  {
    // 16-byte pieces of a block's level columns where they are whole,
    // else 8-byte; eight loads in flight before their stores
    const int GW = HB * hd, sz = (GW % 16 == 0 && SA % 16 == 0) ? 16 : 8;
    const int per = GW / sz, tot = G * R * per;
    for (int i0 = threadIdx.x; i0 < tot; i0 += 8 * NT) {
      uint4 v[8];
      int off[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int i = i0 + u * NT, p = i / (R * per);
        off[u] = -1;
        if (i >= tot || p == rank) continue;
        const int r = (i - p * R * per) / per;
        off[u] = r * SA + p * GW + (i - p * R * per - r * per) * sz;
        const int8_t* peer = cluster.map_shared_rank(lv, p) + off[u];
        if (sz == 16)
          v[u] = *reinterpret_cast<const uint4*>(peer);
        else
          *reinterpret_cast<uint2*>(&v[u]) =
              *reinterpret_cast<const uint2*>(peer);
      }
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        if (off[u] < 0) continue;
        if (sz == 16)
          *reinterpret_cast<uint4*>(lv + off[u]) = v[u];
        else
          *reinterpret_cast<uint2*>(lv + off[u]) =
              *reinterpret_cast<const uint2*>(&v[u]);
      }
    }
  }
  __syncthreads();
  clk.mark(2);

  // proj: levels [R, H*hd] x w_proj -> columns [c0, c1), PN per pass (32 a
  // warp; warps past the pass's columns idle), WST weight chunks in flight
  const int wn = warp * 32;
  for (int nb = c0; nb < c1; nb += PN) {
    const int width = min(PN, c1 - nb);
    int acc[MT][4][4];
    qvt::zero_acc(acc);
    if (nb != c0)
      for (int ch = 0; ch < WST - 1; ++ch) load(nb, ch);
    for (int ch = 0; ch < n_chunks; ++ch) {
      load(nb, ch + WST - 1);
      asm volatile("cp.async.wait_group %0;\n" ::"n"(WST - 1));
      __syncthreads();
      const int8_t* Bs = wb + (ch % WST) * WBUF;
#pragma unroll
      for (int ks = 0; ks < 2; ++ks) {
        if (wn >= width) break;
        // level columns of this k32 step: int4 pairs the low nibbles with
        // columns k' and the high ones with H*hd/2 + k'
        const int acol = w4 ? (ks ? half : 0) + ch * 32 : ch * PK + ks * 32;
        uint32_t af[MT][4], bf[4][2];
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          const int8_t* p = lv + (i * 16 + g) * SA + acol + t * 4;
          af[i][0] = *reinterpret_cast<const uint32_t*>(p);
          af[i][1] = *reinterpret_cast<const uint32_t*>(p + 8 * SA);
          af[i][2] = *reinterpret_cast<const uint32_t*>(p + 16);
          af[i][3] = *reinterpret_cast<const uint32_t*>(p + 8 * SA + 16);
        }
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const int8_t* q =
              Bs + (wn + jj * 8 + g) * SB + (w4 ? 0 : ks * 32) + t * 4;
          const uint32_t b0 = *reinterpret_cast<const uint32_t*>(q);
          const uint32_t b1 = *reinterpret_cast<const uint32_t*>(q + 16);
          bf[jj][0] = w4 ? qvt::nibbles(b0, ks == 1) : b0;
          bf[jj][1] = w4 ? qvt::nibbles(b1, ks == 1) : b1;
        }
#pragma unroll
        for (int i = 0; i < MT; ++i)
#pragma unroll
          for (int jj = 0; jj < 4; ++jj)
            qvt::mma_s8(acc[i][jj], af[i][0], af[i][1], af[i][2], af[i][3],
                        bf[jj][0], bf[jj][1]);
      }
      __syncthreads();  // the buffer is free for chunk ch + WST
    }
    clk.mark(3);
    // acc * scale (+ bias) as f32 rows [R][PN + 4] in the free weight
    // buffers, then + residual and the cast, a row's columns by consecutive
    // threads
    float* to = reinterpret_cast<float*>(wb);
    constexpr int LDO = PN + 4;
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int qr = i * 16 + g + (r >= 2 ? 8 : 0);
          const int cl = wn + jj * 8 + t * 2 + (r & 1);
          if (qr >= nq || cl >= width) continue;
          float v = static_cast<float>(acc[i][jj][r]) * a.scale[nb + cl];
          if (a.bias) v = v + a.bias[nb + cl];
          to[qr * LDO + cl] = v;
        }
    __syncthreads();
    if (a.out_vec) {
      // 8 columns a thread, four pieces' residual loads in flight
      const int w8 = width / 8, tot = nq * w8;
      for (int i0 = threadIdx.x; i0 < tot; i0 += 4 * NT) {
        float rv[4][8];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int i = i0 + u * NT, r = i / w8;
          if (i < tot)
            load8(a.res, a.res_dt,
                  (row0 + q0 + r) * a.D + nb + (i - r * w8) * 8, rv[u]);
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int i = i0 + u * NT, r = i / w8, cl = (i - r * w8) * 8;
          if (i >= tot) continue;
          const float4* tv =
              reinterpret_cast<const float4*>(to + r * LDO + cl);
          const float4 x = tv[0], y = tv[1];
          const float tk[8] = {x.x, x.y, x.z, x.w, y.x, y.y, y.z, y.w};
#pragma unroll
          for (int k = 0; k < 8; ++k) rv[u][k] = tk[k] + rv[u][k];
          store8(a.out, a.out_dt, (row0 + q0 + r) * a.D + nb + cl, rv[u]);
        }
      }
    } else {
      for (int e = threadIdx.x; e < nq * width; e += NT) {
        const int r = e / width, cl = e - r * width;
        const long long o = (row0 + q0 + r) * a.D + nb + cl;
        qvt::store_f(a.out, a.out_dt, o,
                     to[r * LDO + cl] + qvt::load_f(a.res, a.res_dt, o));
      }
    }
    __syncthreads();  // the weight buffers are free for the next pass
    clk.mark(4);
  }
  asm volatile("cp.async.wait_group 0;\n" ::);
  // no block leaves (and frees its shared memory) while another of the
  // cluster may still read its levels
  cluster.sync();
  clk.mark(2);
  clk.store(blockIdx.y * gridDim.x + blockIdx.x);
}

template <typename T, int R, int HDM>
cudaError_t launch(const Args& a, size_t smem, cudaStream_t stream,
                   int* clusters) {
  auto kern = qkv_proj_kernel<T, R, HDM>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.G * ((a.n + R - 1) / R), a.B, 1);
  cfg.blockDim = dim3(NT, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.G;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (clusters) return cudaOccupancyMaxActiveClusters(clusters, kern, &cfg);
  e = cudaLaunchKernelEx(&cfg, kern, a);
  return e != cudaSuccess ? e : cudaGetLastError();
}

template <typename T>
cudaError_t launch_t(const Args& a, int rows, size_t smem,
                     cudaStream_t stream, int* clusters) {
  if (a.hd <= 64)
    return rows == 32 ? launch<T, 32, 64>(a, smem, stream, clusters)
                      : launch<T, 16, 64>(a, smem, stream, clusters);
  return rows == 32 ? launch<T, 32, 80>(a, smem, stream, clusters)
                    : launch<T, 16, 80>(a, smem, stream, clusters);
}

// checks the layout, fills the args and launches (or, with `clusters`,
// only asks how many clusters of this layout the card holds at once)
int run(const void* qkv, int qkv_dt, const void* w, int w_int4,
        const void* scale, const void* bias, const void* res, int res_dt,
        const void* prm, void* out, int out_dt, int B, int n, int heads,
        int hd, int D, int n_valid, int nk, int rows, int cluster,
        float q_mul, float sm_scale, int int_attn, int out_pow, int out_top,
        void* stream, int* clusters) {
  const int hdim = heads * hd;
  if (hd > HDMAX || hd % 8 || nk > n || n_valid > nk ||
      (qkv_dt != qvt::DT_BF16 && qkv_dt != qvt::DT_F32) ||
      (rows != 32 && rows != 16) || cluster < 1 ||
      cluster > 8 || heads % cluster || B > 65535 ||
      smem_bytes(rows, hd, hdim, qkv_dt == qvt::DT_BF16 ? 2 : 4) > SMEM_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.qkv = qkv;
  a.qkv_dt = qkv_dt;
  a.w = static_cast<const int8_t*>(w);
  a.w4 = w_int4;
  a.scale = static_cast<const float*>(scale);
  a.bias = static_cast<const float*>(bias);
  a.res = res;
  a.res_dt = res_dt;
  a.prm = static_cast<const float*>(prm);
  a.out = out;
  a.out_dt = out_dt;
  a.B = B;
  a.n = n;
  a.heads = heads;
  a.hd = hd;
  a.D = D;
  a.n_valid = n_valid;
  a.nk = nk;
  a.G = cluster;
  a.dg = round_up((D + cluster - 1) / cluster, 8);
  a.sa = round_up(hdim, 64) + 16;
  a.q_mul = q_mul;
  a.sm_scale = sm_scale;
  a.out_top = static_cast<float>(out_top);
  a.out_pow = out_pow;
  a.int_attn = int_attn != 0;
  // q/k/v head slices as 16-byte pieces: with hd % 8 == 0 every row,
  // column offset and shared row is a multiple of 16 bytes
  a.qkv_vec = (reinterpret_cast<uintptr_t>(qkv) & 15) == 0;
  a.w_vec = (reinterpret_cast<uintptr_t>(w) & 15) == 0 &&
            (w_int4 ? (hdim / 2) % 16 == 0 : hdim % 16 == 0);
  // D % 8 == 0 keeps every block's columns (a.dg and the 256-column
  // passes are multiples of 8) and every row on the 16-byte grid
  a.out_vec = D % 8 == 0 && (reinterpret_cast<uintptr_t>(res) & 15) == 0 &&
              (reinterpret_cast<uintptr_t>(out) & 15) == 0;
  const size_t smem =
      smem_bytes(rows, hd, hdim, qkv_dt == qvt::DT_BF16 ? 2 : 4);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t e =
      qkv_dt == qvt::DT_BF16
          ? launch_t<__nv_bfloat16>(a, rows, smem, st, clusters)
          : launch_t<float>(a, rows, smem, st, clusters);
  return static_cast<int>(e);
}

}  // namespace

// rows: query rows a cluster, 32 or 16; cluster: its blocks G (G | H,
// G <= 8); ops/attention.py:qkv_proj_layout picks both.
// cudaErrorInvalidValue if the layout does not fit.
extern "C" int qvt_attention_qkv_proj(
    const void* qkv, int qkv_dt, const void* w, int w_int4, const void* scale,
    const void* bias, const void* res, int res_dt, const void* prm, void* out,
    int out_dt, int B, int n, int heads, int hd, int D, int n_valid, int nk,
    int rows, int cluster, float q_mul, float sm_scale, int int_attn,
    int out_pow, int out_top, void* stream) {
  return run(qkv, qkv_dt, w, w_int4, scale, bias, res, res_dt, prm, out,
             out_dt, B, n, heads, hd, D, n_valid, nk, rows, cluster, q_mul,
             sm_scale, int_attn, out_pow, out_top, stream, nullptr);
}

// the clusters of a layout the card holds at once
// (cudaOccupancyMaxActiveClusters) into *clusters; 0: it cannot be
// scheduled
extern "C" int qvt_attention_qkv_proj_clusters(int qkv_dt, int heads, int hd,
                                               int rows, int cluster,
                                               int* clusters) {
  *clusters = 0;
  return run(nullptr, qkv_dt, nullptr, 0, nullptr, nullptr, nullptr,
             qvt::DT_BF16, nullptr, nullptr, qvt::DT_BF16, 1, rows, heads, hd,
             heads * hd, rows, rows, rows, cluster, 1.f, 1.f, 0, 0, 1,
             nullptr, clusters);
}

// K6: multi-head attention on the raw fused-qkv tensor, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel quantized_vit_tpu/ops/attention.py:
// _attn_qkv_kernel (pallas_call in _attention_qkv, attention.py:859), the
// attention of the batch 1-3 serving chain (K1 qkv -> K6 -> K1 proj):
//   qkv [B, N, (3, H, hd)] in the residual dtype -> out [B, N, H*hd]
// as int8 levels of the proj quantizer (round(o_un * (1/(p_sum*d))), or
// the pow quantizer of o_un/p_sum) or as floats o_un/p_sum
// (attention.py:277-289), with int_attention as the TPU kernel has it.
//
// Numerics (those of attention_core.cuh and K9, which the plain version
// ops/attention.py:attention_qkv_plain mirrors): float path, q pre-scaled
// by sm_scale*log2e and rounded back to the qkv dtype, scores over the
// n_valid keys of the nk key rows, p = exp2(min(s, 100)) with no row max,
// p rounded to the qkv dtype for P.V, p_sum from f32 p plus 1e-30;
// int_attention, q*sm_scale, k and v as int8 levels with per-(image, head)
// scales over all n query rows and the nk key rows, the row max first, p
// levels round(p*127), p_sum their sum. Built with -fmad=false; sums in
// f64, rounded once to f32.
//
// Design: a block per (tile of R query rows, head, image), R = 64, 32 or
// 16 from the wrapper (ops/attention.py:qkv_attn_tile_rows: among the
// tiles whose grid gives every SM a block, the most query rows resident
// on an SM). Every block reads its head's K/V once (from L2 after the
// first tile of the head); no token count enters shared memory.
// - The tile's q rows are staged once as f32: pre-scaled and rounded
//   (float path) or as levels (int_attention).
// - K and V stream raw (the qkv dtype) in chunks of KC = 64 keys through
//   a ring of three buffers filled by cp.async 16-byte copies: K_0 V_0
//   K_1 V_1 ..., a chunk's copy running during the two steps before it,
//   one barrier a step (the ring of K9, attention_proj.cu, without its
//   heads and weights: K9 takes 32 keys at 16 rows to make room for its
//   weight buffers, K6 has none and keeps 64 at every tile). Rows past nk
//   are zero.
// - Both products on the FP64 tensor cores (mma.sync m16n8k4 .f64,
//   fp64_mma.cuh, as K13 and K9), each fragment value widened to f64 as it
//   loads: a chunk's k values are converted once a warp, not once per 8
//   query rows as the m8n8k4 core of attention_core.cuh does. The float
//   path needs no row max, so a K step goes from scores to p (a [R][KC]
//   f32 tile) at once and the V step after it adds p . v into each warp's
//   f64 register patch of the [R x hd] output. int_attention first
//   streams the K chunks for the row max, then recomputes the same exact
//   scores; each landed chunk is turned into levels in place (exact in
//   bf16). The p sums are kept per lane and reduced over the quad and then
//   the warps in a fixed order.
// - int_attention's scales (attention.py:140-147) are maxima over all n
//   query rows and the nk key rows of a head, rows that span every query
//   tile's block. Computing them once per (image, head) would take a
//   second launch; K6 stays one launch, so each block scans its head's
//   q, k and v with 16-byte loads before it stages q ((n + 2 nk) x hd
//   values, from L2 after the first tile).
// - The output goes through shared memory (the q tile's space, free after
//   the last K step) and leaves as 16-byte row pieces (8-byte where a
//   head's row of levels is not a multiple of 16 bytes) into the head's
//   columns of out: levels or floats in the output dtype.
// - Row strides (elements): q HDM + 4 (f32); k HDM + 8 (bf16) or HDM + 4
//   (f32); v HDM + 8; the p tile KC + 4: each warp's fragment loads fall
//   in 32 banks.
//
// Exactness. Products of bf16 or f32 values, and of int8 levels, are exact
// in f64, so only the order of the f64 additions differs from the plain
// version's. For bf16 the f64 sums are exact at these shapes, so every
// order gives the same f32; for f32 an order moves a result only when the
// f64 sum lies within 2^-29 of an f32 tie, inside the attention contract
// (tests/test_torch_attention_qkv_layout.py counts them in this kernel's
// order).
//
// Bound on this card at ViT-B/16 batch 2 (208 rows, 12 heads of 64, nk
// 208, bf16): 2.24 MB in and out (0.67 us at 3.35 TB/s) against 0.27 G
// attention operations at the bf16 rate (0.27 us): bytes. An exact kernel
// cannot use the bf16 rate: its ceiling is the 0.27 GFLOP over the FP64
// tensor cores' 67 TFLOP/s (4.0 us; 63.5 us at batch 32).

#include <algorithm>

#include "qkv_stream.cuh"
#include "fp64_mma.cuh"

namespace {

using qvt::absmax_rows;
using qvt::from_f32;
using qvt::prefetch;
using qvt::store_rows;
using qvt::to_f32;
using qvt::Xf;

constexpr int NT = qvt::QKV_NT, NW = NT / 32;
constexpr int KC = 64;   // keys a chunk
constexpr int KVB = 3;   // K/V chunk buffers
constexpr int HDMAX = 80;  // the widest head (HDM) instantiated

// bytes of dynamic shared memory at R query rows, head bound HDM and a
// qkv dtype of `es` bytes: q (f32), the K/V chunk buffers (the qkv dtype,
// rows HDM + 8 apart), the p tile (f32), the row sums' (f64) and row
// maxima's (f32) per-warp partials (mirrored by
// ops/attention.py:qkv_attn_smem_bytes)
__host__ __device__ constexpr int smem_bytes(int R, int HDM, int es) {
  return 4 * R * (HDM + 4) + KVB * KC * (HDM + 8) * es + 4 * R * (KC + 4) +
         12 * NW * R;
}
// the largest instantiation, with the static scale reduction and scales
// (3 x NW + 8 floats) and the 1 KB the card reserves a block: two blocks
// fit an H100 SM's 233,472 bytes
static_assert(2 * (smem_bytes(64, HDMAX, 4) + (3 * NW + 8) * 4 + 1024) <=
                  233472,
              "two blocks of K6 fit an SM");

enum { OUT_LEVELS = 0, OUT_POW = 1, OUT_FLOAT = 2 };

struct Args {
  const void* qkv;
  int qkv_dt;
  void* out;
  int out_dt;
  int out_mode;
  int out_es;        // bytes an output element
  const float* prm;  // out_d, out_t
  int B, n, heads, hd, n_valid, nk;
  float q_mul, sm_scale, out_top;
  bool int_attn, qkv_vec;
  bool out_vec;  // output rows as 16-byte pieces (else 8-byte)
};

template <typename T, int R, int HDM>
__global__ void __launch_bounds__(NT, 2) qkv_attn_kernel(Args a) {
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

  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float isc[8];  // q_inv k_inv v_inv s_mul v_s
  __shared__ float red[3][NW];
  const int q0 = blockIdx.x * R, h = blockIdx.y, b = blockIdx.z;
  const int n = a.n, nk = a.nk, hd = a.hd, HD = a.heads * hd;
  const long long W = 3 * HD;
  const int nq = min(n - q0, R);
  float* Qs = reinterpret_cast<float*>(smem);  // [R][LDQ]
  T* Cb = reinterpret_cast<T*>(Qs + R * LDQ);  // KVB x [KC][LDK or LDV]
  float* Ps = reinterpret_cast<float*>(Cb + KVB * CBUF);  // [R][LDP]
  double* psp = reinterpret_cast<double*>(Ps + R * LDP);  // [NW][R]
  float* rmp = reinterpret_cast<float*>(psp + NW * R);    // [NW][R]
  const long long row0 = static_cast<long long>(b) * n;
  // this head's q columns in row 0 of the image (k: + HD, v: + 2 HD)
  const T* hs = static_cast<const T*>(a.qkv) + row0 * W + h * hd;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const bool INT = a.int_attn;

  // the step stream (int_attention: nkc K chunks for the row max first),
  // then K_0 V_0 K_1 V_1 ...
  const int nkc = (nk + KC - 1) / KC;
  const int pre_steps = INT ? nkc : 0, nsteps = pre_steps + 2 * nkc;
  enum { KMAX = 0, KS = 1, VS = 2 };
  auto kind_of = [&](int j) {
    return j < pre_steps ? KMAX : (((j - pre_steps) & 1) ? VS : KS);
  };
  auto chunk_of = [&](int j) {
    return j < pre_steps ? j : (j - pre_steps) >> 1;
  };

  // int_attention: the head's dynamic scales (attention.py:140-147) over
  // all n query rows and the nk key rows, into isc; every thread calls
  auto scales = [&]() {
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
      isc[0] = 1.0f / s[0];
      isc[1] = 1.0f / s[1];
      isc[2] = 1.0f / s[2];
      isc[3] = s[0] * s[1] * static_cast<float>(1.4426950408889634);
      isc[4] = s[2];
    }
    __syncthreads();
  };
  // step s's K or V chunk, raw, into buffer s % KVB with cp.async (rows
  // past the nk keys zero): one commit group (empty past the last step)
  auto issue = [&](int s) {
    if (s >= nsteps) {
      asm volatile("cp.async.commit_group;\n" ::);
      return;
    }
    const int c = chunk_of(s);
    const bool v = kind_of(s) == VS;
    const int rows = min(KC, nk - c * KC), LD = v ? LDV : LDK;
    const T* p = hs + static_cast<long long>(c) * KC * W + (v ? 2 * HD : HD);
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
    const bool v = kind_of(s) == VS;
    const int LD = v ? LDV : LDK;
    const float inv = isc[v ? 2 : 1];
    T* d = Cb + (s % KVB) * CBUF;
    for (int e = threadIdx.x; e < KC * hd; e += NT) {
      const int r = e / hd, cc = e - r * hd;
      const float x = to_f32(d[r * LD + cc]);
      d[r * LD + cc] =
          from_f32<T>(fminf(fmaxf(rintf(x * inv), -127.f), 127.f));
    }
  };

  QVT_PHASES_BEGIN();
  if (INT) {
    scales();
    QVT_PHASE(4);
  }
  {
    // the tile's q rows, transformed, into Qs (rows past nq zero)
    const T* qs = hs + static_cast<long long>(q0) * W;
    const Xf f = INT ? Xf{2, 0, a.sm_scale, isc[0]}
                     : Xf{1, a.qkv_dt, a.q_mul, 1.f};
    uint4 qv[QV];
    if (a.qkv_vec) prefetch(qv, qs, W, nq, hd);
    store_rows<T, LDQ>(Qs, qv, qs, W, nq, R, hd, a.qkv_vec, f);
  }
  for (int s = 0; s < KVB; ++s) issue(s);
  asm volatile("cp.async.wait_group %0;\n" ::"n"(KVB - 1));
  __syncthreads();
  if (INT && nsteps > 0) {
    levels(0);
    __syncthreads();
  }
  QVT_PHASE(0);

  // score warps: a patch of [R x KC] at (m0, n0); P.V warps: of
  // [R x 8 PVT]
  const int m0 = warp / SG.wc * SWM * 16, n0 = warp % SG.wc * SWN * 8;
  const bool scorer = warp < SG.wr * SG.wc;
  const int om0 = warp / OG.wc * OWM * 16, on0 = warp % OG.wc * OWN * 8;
  const bool owner = warp < OG.wr * OG.wc && om0 < nq;
  double psum[SWM][2];  // this lane's share of its rows' p sums
  float rmax[SWM][2];   // int_attention: its rows' maxima
  double oacc[OWM][OWN][4];
#pragma unroll
  for (int i = 0; i < OWM; ++i)
#pragma unroll
    for (int jj = 0; jj < OWN; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e) oacc[i][jj][e] = 0.0;

  for (int s = 0; s < nsteps; ++s) {
    const int kind = kind_of(s), c = chunk_of(s);
    const T* buf = Cb + (s % KVB) * CBUF;
    const int kc = min(KC, nk - c * KC);
    if (kind != VS) {
      if (c == 0) {
#pragma unroll
        for (int i = 0; i < SWM; ++i)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            if (kind == KMAX) {
              rmax[i][hh] = -__int_as_float(0x7f800000);  // -inf
            } else {
              psum[i][hh] = 0.0;
              if (INT && scorer) {  // the row max from the first pass
                const int r = m0 + 16 * i + 8 * hh + g;
                float mx = rmp[r];
                for (int w = 1; w < SG.wc; ++w) mx = fmaxf(mx, rmp[w * R + r]);
                rmax[i][hh] = mx;
              }
            }
          }
      }
      const bool scoring = scorer && m0 < nq && n0 < kc;
      double acc[SWM][SWN][4];
#pragma unroll
      for (int i = 0; i < SWM; ++i)
#pragma unroll
        for (int jj = 0; jj < SWN; ++jj)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][jj][e] = 0.0;
      if (scoring) {
#pragma unroll
        for (int kk = 0; kk < HDM; kk += 4) {
          if (kk >= hd) break;
          double av[SWM][2], bv[SWN];
#pragma unroll
          for (int i = 0; i < SWM; ++i)
#pragma unroll
            for (int hh = 0; hh < 2; ++hh)
              av[i][hh] = Qs[(m0 + 16 * i + 8 * hh + g) * LDQ + kk + t];
#pragma unroll
          for (int jj = 0; jj < SWN; ++jj)
            bv[jj] = to_f32(buf[(n0 + 8 * jj + g) * LDK + kk + t]);
#pragma unroll
          for (int i = 0; i < SWM; ++i)
#pragma unroll
            for (int jj = 0; jj < SWN; ++jj)
              qvt::dmma(acc[i][jj], av[i], bv[jj]);
        }
      }
      QVT_PHASE(1);
      if (scoring) {
        const int key0 = c * KC + n0 + 2 * t;
#pragma unroll
        for (int i = 0; i < SWM; ++i)
#pragma unroll
          for (int jj = 0; jj < SWN; ++jj)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int hh = e >> 1, key = key0 + 8 * jj + (e & 1);
              float sc = static_cast<float>(acc[i][jj][e]);
              if (INT) sc = sc * isc[3];
              if (kind == KMAX) {
                rmax[i][hh] =
                    fmaxf(rmax[i][hh], key < a.n_valid ? sc : -1e30f);
                continue;
              }
              float p;
              if (INT) {
                p = key < a.n_valid ? exp2f(sc - rmax[i][hh]) : 0.f;
                p = rintf(p * 127.0f);
                psum[i][hh] += static_cast<double>(p);
              } else {
                p = key < a.n_valid ? exp2f(fminf(sc, 100.f)) : 0.f;
                psum[i][hh] += static_cast<double>(p);
                p = qvt::round_to(p, a.qkv_dt);
              }
              Ps[(m0 + 16 * i + 8 * hh + g) * LDP + n0 + 8 * jj + 2 * t +
                 (e & 1)] = p;
            }
      }
      // after the last K chunk of a pass: this warp's share of its rows'
      // max (first pass) or p sum, reduced over the quad
      if (scorer && c == nkc - 1) {
#pragma unroll
        for (int i = 0; i < SWM; ++i)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int r = m0 + 16 * i + 8 * hh + g;
            if (kind == KMAX) {
              float mx = rmax[i][hh];
              mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
              mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
              if (t == 0) rmp[(warp % SG.wc) * R + r] = mx;
            } else {
              double ps = psum[i][hh];
              ps += __shfl_xor_sync(0xffffffffu, ps, 1);
              ps += __shfl_xor_sync(0xffffffffu, ps, 2);
              if (t == 0) psp[(warp % SG.wc) * R + r] = ps;
            }
          }
      }
      QVT_PHASE(2);
    } else {
      // o += p . v over this chunk's keys
      if (owner) {
#pragma unroll 4
        for (int kk = 0; kk < kc; kk += 4) {
          double av[OWM][2], bv[OWN];
#pragma unroll
          for (int i = 0; i < OWM; ++i)
#pragma unroll
            for (int hh = 0; hh < 2; ++hh)
              av[i][hh] = static_cast<double>(
                  Ps[(om0 + 16 * i + 8 * hh + g) * LDP + kk + t]);
#pragma unroll
          for (int jj = 0; jj < OWN; ++jj)
            bv[jj] = to_f32(buf[(kk + t) * LDV + on0 + 8 * jj + g]);
#pragma unroll
          for (int i = 0; i < OWM; ++i)
#pragma unroll
            for (int jj = 0; jj < OWN; ++jj)
              qvt::dmma(oacc[i][jj], av[i], bv[jj]);
        }
      }
      QVT_PHASE(3);
    }
    // the next step's chunk has landed (its copy ran during the last
    // KVB - 1 steps' MMAs); once every warp is past this step, its buffer
    // takes the copy of step s + KVB
    asm volatile("cp.async.wait_group %0;\n" ::"n"(KVB - 2));
    __syncthreads();
    if (s + 1 < nsteps) {
      if (INT) levels(s + 1);
      issue(s + KVB);
      if (INT) __syncthreads();
    }
    QVT_PHASE(0);
  }
  asm volatile("cp.async.wait_group 0;\n" ::);

  // the epilogue: each owner's outputs, final, into the [R][osb]-byte tile
  // in q's space (free since the last K step), then out in row pieces
  unsigned char* Os = smem;
  const int es = a.out_es, osb = (hd * es + 15) / 16 * 16;
  if (owner) {
#pragma unroll
    for (int i = 0; i < OWM; ++i)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int r = om0 + 16 * i + 8 * hh + g;
        if (r >= nq) continue;
        double ps = 0.0;
        if (nkc > 0) {
          ps = psp[r];
          for (int w = 1; w < SG.wc; ++w) ps += psp[w * R + r];
        }
        const float pf = INT ? static_cast<float>(ps)
                             : static_cast<float>(ps) + 1e-30f;
        const float inv = 1.0f / (pf * a.prm[0]);
#pragma unroll
        for (int jj = 0; jj < OWN; ++jj)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = on0 + 8 * jj + 2 * t + e;
            if (col >= hd) continue;
            float ov = static_cast<float>(oacc[i][jj][2 * hh + e]);
            if (INT) ov = ov * isc[4];
            unsigned char* o = Os + r * osb + col * es;
            if (a.out_mode == OUT_LEVELS)
              *reinterpret_cast<int8_t*>(o) = qvt::clip_round(ov * inv,
                                                              a.out_top);
            else if (a.out_mode == OUT_POW)
              *reinterpret_cast<int8_t*>(o) = qvt::quantize(
                  ov / pf, a.prm[0], a.prm[1], a.out_top, true, false);
            else
              qvt::store_f(o, a.out_dt, 0, ov / pf);
          }
      }
  }
  __syncthreads();
  {
    const int pz = a.out_vec ? 16 : 8, per = hd * es / pz;
    unsigned char* dst = static_cast<unsigned char*>(a.out) +
                         ((row0 + q0) * HD + h * hd) * es;
    for (int i = threadIdx.x; i < nq * per; i += NT) {
      const int r = i / per, off = (i - r * per) * pz;
      unsigned char* d = dst + static_cast<long long>(r) * HD * es + off;
      const unsigned char* sp = Os + r * osb + off;
      if (a.out_vec)
        *reinterpret_cast<uint4*>(d) = *reinterpret_cast<const uint4*>(sp);
      else
        *reinterpret_cast<uint2*>(d) = *reinterpret_cast<const uint2*>(sp);
    }
  }
  QVT_PHASE(5);
  QVT_PHASES_STORE((blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x +
                   blockIdx.x);
}

template <typename T, int R, int HDM>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  auto kern = qkv_attn_kernel<T, R, HDM>;
  constexpr int smem = smem_bytes(R, HDM, sizeof(T));
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  kern<<<dim3((a.n + R - 1) / R, a.heads, a.B), NT, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, int HDM>
cudaError_t launch_rows(const Args& a, int rows, cudaStream_t stream) {
  if (rows == 64) return launch<T, 64, HDM>(a, stream);
  if (rows == 32) return launch<T, 32, HDM>(a, stream);
  return launch<T, 16, HDM>(a, stream);
}

}  // namespace

// rows: query rows a block, 64, 32 or 16 (ops/attention.py:
// qkv_attn_tile_rows picks it). out_mode: 0 int8 levels (out_pow false),
// 1 int8 levels of the pow quantizer, 2 floats in out_dt.
extern "C" int qvt_attention_qkv(const void* qkv, int qkv_dt, void* out,
                                 int out_dt, int out_mode, const void* prm,
                                 int B, int n, int heads, int hd, int n_valid,
                                 int nk, int rows, float q_mul,
                                 float sm_scale, int int_attn, int out_top,
                                 void* stream) {
  const int out_es = out_mode != OUT_FLOAT ? 1 : out_dt == qvt::DT_F32 ? 4
                                                                        : 2;
  if (hd > HDMAX || hd % 8 || nk > n || n_valid > nk ||
      (qkv_dt != qvt::DT_BF16 && qkv_dt != qvt::DT_F32) ||
      (out_mode == OUT_FLOAT && out_dt != qvt::DT_BF16 &&
       out_dt != qvt::DT_F32) ||
      (rows != 64 && rows != 32 && rows != 16) || B > 65535 ||
      heads > 65535 || (reinterpret_cast<uintptr_t>(out) & 7) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.qkv = qkv;
  a.qkv_dt = qkv_dt;
  a.out = out;
  a.out_dt = out_dt;
  a.out_mode = out_mode;
  a.out_es = out_es;
  a.prm = static_cast<const float*>(prm);
  a.B = B;
  a.n = n;
  a.heads = heads;
  a.hd = hd;
  a.n_valid = n_valid;
  a.nk = nk;
  a.q_mul = q_mul;
  a.sm_scale = sm_scale;
  a.out_top = static_cast<float>(out_top);
  a.int_attn = int_attn != 0;
  // q/k/v head slices as 16-byte pieces: with hd % 8 == 0 every row,
  // column offset and shared row is a multiple of 16 bytes
  a.qkv_vec = (reinterpret_cast<uintptr_t>(qkv) & 15) == 0;
  // a head's output row, and so every row start and column offset of the
  // head's columns, a multiple of 16 bytes (else of 8: hd % 8 == 0)
  a.out_vec = (hd * out_es) % 16 == 0 &&
              (reinterpret_cast<uintptr_t>(out) & 15) == 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (qkv_dt == qvt::DT_BF16)
    e = hd <= 64 ? launch_rows<__nv_bfloat16, 64>(a, rows, st)
                 : launch_rows<__nv_bfloat16, 80>(a, rows, st);
  else
    e = hd <= 64 ? launch_rows<float, 64>(a, rows, st)
                 : launch_rows<float, 80>(a, rows, st);
  return static_cast<int>(e);
}

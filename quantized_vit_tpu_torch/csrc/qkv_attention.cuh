// The attention of one (tile of R query rows, head, image) on the raw
// fused-qkv tensor [B, N, (3, H, hd)], shared by K6 (attention_qkv.cu: a
// block per tile) and K3 (attention_block.cu: the tiles of its third phase,
// on the q/k/v its GEMM phase wrote). The design and the numerics are K6's
// (attention_qkv.cu's note): q staged once as f32, K/V raw through a ring
// of three 64-key cp.async buffers, both products on mma.sync m16n8k4 .f64,
// int_attention's scales from a scan of the head's q, k and v rows.
#pragma once

#include "qkv_stream.cuh"
#include "fp64_mma.cuh"

namespace qvt {

constexpr int QA_NT = QKV_NT, QA_NW = QA_NT / 32;
constexpr int QA_KC = 64;     // keys a chunk
constexpr int QA_KVB = 3;     // K/V chunk buffers
constexpr int QA_HDMAX = 80;  // the widest head (HDM) instantiated

// bytes of dynamic shared memory at R query rows, head bound HDM and a
// qkv dtype of `es` bytes: q (f32), the K/V chunk buffers (the qkv dtype,
// rows HDM + 8 apart), the p tile (f32), the row sums' (f64) and row
// maxima's (f32) per-warp partials (mirrored by
// ops/attention.py:qkv_attn_smem_bytes)
__host__ __device__ constexpr int qkv_attn_smem(int R, int HDM, int es) {
  return 4 * R * (HDM + 4) + QA_KVB * QA_KC * (HDM + 8) * es +
         4 * R * (QA_KC + 4) + 12 * QA_NW * R;
}
// the static scale reduction and scales of qkv_attn_tile, in bytes
constexpr int QA_STATIC = (3 * QA_NW + 8) * 4;

enum { QA_OUT_LEVELS = 0, QA_OUT_POW = 1, QA_OUT_FLOAT = 2 };

// the barrier of the tile's QA_NT threads: the block's (BAR 0), or named
// barrier BAR where the block has other threads (K5's producer warp)
template <int BAR>
__device__ __forceinline__ void qa_sync() {
  if constexpr (BAR == 0)
    __syncthreads();
  else
    asm volatile("bar.sync %0, %1;\n" ::"n"(BAR), "n"(QA_NT) : "memory");
}

struct QkvAttnArgs {
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

// The tile of query rows q0 .. q0 + R - 1 of head h of image b, into the
// head's columns of a.out. Every thread of the block calls it; `smem` is
// the block's dynamic shared memory (qkv_attn_smem(R, HDM, sizeof(T))
// bytes). MARK: the phases go to clk (K6's staging, scores, p, P.V, int
// scales, epilogue). CG: q/k/v are read through L2 only (K3's and K5's
// scratch, written earlier in the same launch; K/V always are, by
// cp.async.cg). BAR: the tile's barrier (qa_sync).
template <typename T, int R, int HDM, bool MARK, bool CG, int BAR = 0>
__device__ __forceinline__ void qkv_attn_tile(const QkvAttnArgs& a, int q0,
                                              int h, int b,
                                              unsigned char* smem,
                                              PhaseClock& clk) {
  constexpr int NT = QA_NT, NW = QA_NW, KC = QA_KC, KVB = QA_KVB;
  // rows (elements) of q (f32), of a K and a V chunk (T: raw qkv values)
  // and of the p tile (f32): each warp's fragment loads in 32 banks
  constexpr int LDQ = HDM + 4, LDV = HDM + 8, LDP = KC + 4;
  constexpr int LDK = sizeof(T) == 2 ? HDM + 8 : HDM + 4;
  constexpr int CBUF = KC * LDV;  // elements of a chunk buffer
  // scores: [R x KC] a chunk; P.V: [R x HDM]
  constexpr WarpGrid SG = warp_grid(R / 16, KC / 8);
  constexpr int SWM = R / 16 / SG.wr, SWN = KC / 8 / SG.wc;
  // P.V's n-tiles: at 32 rows and head bound 80, 12 (columns 80-95 are
  // computed and dropped) so all 8 warps take 3 tiles, not 5 warps 4
  constexpr int PVT = R == 32 && HDM == 80 ? 12 : HDM / 8;
  constexpr WarpGrid OG = warp_grid(R / 16, PVT);
  constexpr int OWM = R / 16 / OG.wr, OWN = PVT / OG.wc;
  constexpr int VE = 16 / sizeof(T);  // elements a 16-byte piece
  constexpr int QV = (R * HDM / VE + NT - 1) / NT;  // q pieces a thread

  __shared__ float isc[8];  // q_inv k_inv v_inv s_mul v_s
  __shared__ float red[3][NW];
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
    float m[3] = {absmax_rows<T, CG>(hs, W, n, hd, a.qkv_vec, a.sm_scale),
                  absmax_rows<T, CG>(hs + HD, W, nk, hd, a.qkv_vec, 1.f),
                  absmax_rows<T, CG>(hs + 2 * HD, W, nk, hd, a.qkv_vec,
                                     1.f)};
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      for (int o = 16; o > 0; o >>= 1)
        m[j] = fmaxf(m[j], __shfl_xor_sync(0xffffffffu, m[j], o));
      if (lane == 0) red[j][warp] = m[j];
    }
    qa_sync<BAR>();
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
    qa_sync<BAR>();
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
        cp_async16(dst + r * LD + cc, i < valid ? p + r * W + cc : p,
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

  if (INT) {
    scales();
    if (MARK) clk.mark(4);
  }
  {
    // the tile's q rows, transformed, into Qs (rows past nq zero)
    const T* qs = hs + static_cast<long long>(q0) * W;
    const Xf f = INT ? Xf{2, 0, a.sm_scale, isc[0]}
                     : Xf{1, a.qkv_dt, a.q_mul, 1.f};
    uint4 qv[QV];
    if (a.qkv_vec) prefetch<T, QV, CG>(qv, qs, W, nq, hd);
    store_rows<T, LDQ>(Qs, qv, qs, W, nq, R, hd, a.qkv_vec, f);
  }
  for (int s = 0; s < KVB; ++s) issue(s);
  asm volatile("cp.async.wait_group %0;\n" ::"n"(KVB - 1));
  qa_sync<BAR>();
  if (INT && nsteps > 0) {
    levels(0);
    qa_sync<BAR>();
  }
  if (MARK) clk.mark(0);

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
              dmma(acc[i][jj], av[i], bv[jj]);
        }
      }
      if (MARK) clk.mark(1);
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
                p = round_to(p, a.qkv_dt);
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
      if (MARK) clk.mark(2);
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
              dmma(oacc[i][jj], av[i], bv[jj]);
        }
      }
      if (MARK) clk.mark(3);
    }
    // the next step's chunk has landed (its copy ran during the last
    // KVB - 1 steps' MMAs); once every warp is past this step, its buffer
    // takes the copy of step s + KVB
    asm volatile("cp.async.wait_group %0;\n" ::"n"(KVB - 2));
    qa_sync<BAR>();
    if (s + 1 < nsteps) {
      if (INT) levels(s + 1);
      issue(s + KVB);
      if (INT) qa_sync<BAR>();
    }
    if (MARK) clk.mark(0);
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
            if (a.out_mode == QA_OUT_LEVELS)
              *reinterpret_cast<int8_t*>(o) = clip_round(ov * inv, a.out_top);
            else if (a.out_mode == QA_OUT_POW)
              *reinterpret_cast<int8_t*>(o) = quantize(
                  ov / pf, a.prm[0], a.prm[1], a.out_top, true, false);
            else
              store_f(o, a.out_dt, 0, ov / pf);
          }
      }
  }
  qa_sync<BAR>();
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
  if (MARK) clk.mark(5);
}

}  // namespace qvt

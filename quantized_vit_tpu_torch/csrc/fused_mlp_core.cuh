// The MLP row block of K2's first design, now K15's alone
// (ring_gather.cu; K2 itself, fused_mlp.cu, runs in three phases since
// its redesign and computes the same bits): one 32-row block of
//   out = x + fc2(quant(GELU(fc1(quant(LN(x))))))
// as quantized_vit_tpu/ops/fused.py:_fused_mlp_kernel computes it.
//
// Each block owns 32 rows, runs LN + quant once into shared memory, then
// walks the hidden dimension in chunks of 32 units:
//   fc1 chunk (int32) -> dequant -> folded GELU-quant -> int8 hidden chunk
//   in shared memory -> fc2 partial added into an int32 register
//   accumulator [32, K].
// Int32 sums are exact, so chunk order is free; the [M, hidden] tensor
// never reaches device memory. With packed int4 w2 (rows h and h + H/2 in
// one byte, fused.py:664-682) a chunk walks 16 packed w2 rows and computes
// the two matching fc1 column ranges together. Epilogue acc2*s2 + b2 + x
// in f32 (fused.py:699-700).
//
// Both weights arrive transposed, n-major (the layer's plan), so a
// chunk's w1 columns and w2 rows are 16-byte pieces: int8 weights stream
// through two shared-memory buffers with cp.async (the next chunk loads
// while this one computes); packed int4 is unpacked by synchronous fills.
#pragma once

#include "qvt_common.cuh"

namespace qvt_mlp {

constexpr int BM = 32, HC = 32, SK = HC + 16, NT = 256;

struct Args {
  const void* x;
  int x_dt;
  qvt::WeightT w1;  // K x H levels, transposed: [H][K] or packed [H][K/2]
  const float* s1;
  const float* b1;
  qvt::WeightT w2;  // H x K levels, transposed: [K][H] or packed [K][H/2]
  const float* s2;
  const float* b2;
  const float* ln_g;
  const float* ln_b;
  const float* prm;  // act_d, act_t, hid_d, hid_t
  void* out;
  int out_dt;
  int M, K, H, Kp;
  int act_pow, hid_pow;
  float act_top, hid_top, eps;
};

inline Args make_args(const void* x, int x_dt, const void* w1, int w1_int4,
                      const void* s1, const void* b1, const void* w2,
                      int w2_int4, const void* s2, const void* b2,
                      const void* ln_g, const void* ln_b, const void* prm,
                      void* out, int out_dt, int M, int K, int H,
                      int act_pow, int hid_pow, int act_top, int hid_top,
                      float eps) {
  Args a;
  a.x = x;
  a.x_dt = x_dt;
  a.w1 = qvt::WeightT{static_cast<const int8_t*>(w1), K, H, w1_int4};
  a.s1 = static_cast<const float*>(s1);
  a.b1 = static_cast<const float*>(b1);
  a.w2 = qvt::WeightT{static_cast<const int8_t*>(w2), H, K, w2_int4};
  a.s2 = static_cast<const float*>(s2);
  a.b2 = static_cast<const float*>(b2);
  a.ln_g = static_cast<const float*>(ln_g);
  a.ln_b = static_cast<const float*>(ln_b);
  a.prm = static_cast<const float*>(prm);
  a.out = out;
  a.out_dt = out_dt;
  a.M = M;
  a.K = K;
  a.H = H;
  a.Kp = (K + 63) / 64 * 64;
  a.act_pow = act_pow;
  a.hid_pow = hid_pow;
  a.act_top = static_cast<float>(act_top);
  a.hid_top = static_cast<float>(hid_top);
  a.eps = eps;
  return a;
}

// row blocks of an M-row call
inline int row_blocks(const Args& a) { return (a.M + BM - 1) / BM; }

// Shared memory: lvA [BM][Kp+16] | Hs [BM][SK] | two buffers of
// { B1s [HC][Kp+16] | B2s [64*TN2][SK] } | mu [BM] | rs [BM]
template <int TN2>
size_t smem_bytes(const Args& a) {
  const size_t buf = static_cast<size_t>(HC) * (a.Kp + 16) +
                     static_cast<size_t>(64) * TN2 * SK;
  return static_cast<size_t>(BM) * (a.Kp + 16) + BM * SK + 2 * buf +
         2 * BM * sizeof(float);
}

// The MLP of rows [32 * blk, 32 * blk + 32); every thread of the block
// (NT) calls it, with the block's dynamic shared memory.
template <int TN2>
__device__ __forceinline__ void mlp_rows(const Args& a, int blk,
                                         int8_t* smem) {
  const int ska = a.Kp + 16;
  const int buf_bytes = HC * ska + 64 * TN2 * SK;
  int8_t* lvA = smem;
  int8_t* Hs = lvA + BM * ska;
  int8_t* bufs = Hs + BM * SK;
  float* s_mu = reinterpret_cast<float*>(bufs + 2 * buf_bytes);
  float* s_rs = s_mu + BM;

  const int m_base = blk * BM;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const float act_d = a.prm[0], act_t = a.prm[1];
  const float hid_d = a.prm[2], hid_t = a.prm[3];
  const int M = a.M, K = a.K, H = a.H;

  QVT_STAMP(0);
  qvt::ln_stats(a.x, a.x_dt, m_base, BM, M - m_base, K, a.eps, s_mu, s_rs);
  __syncthreads();
  // LN + quant once per row block (gamma/beta carry 1/d when t == 1)
  qvt::fill_rows(lvA, BM, ska, a.Kp, [&](int r, int k) -> int8_t {
    const int row = m_base + r;
    if (row >= M || k >= K) return 0;
    const long long i = static_cast<long long>(row) * K + k;
    float y = (qvt::load_f(a.x, a.x_dt, i) - s_mu[r]) * s_rs[r] * a.ln_g[k] +
              a.ln_b[k];
    return qvt::quantize(y, act_d, act_t, a.act_top, a.act_pow,
                         !a.act_pow);
  });

  QVT_STAMP(1);
  int acc2[2][TN2][4];
  qvt::zero_acc(acc2);
  const int half2 = H >> 1;
  const int n_chunks =
      a.w2.int4 ? (half2 + HC / 2 - 1) / (HC / 2) : (H + HC - 1) / HC;
  // fc1 warp tile of the [32, 32] chunk product: 16 rows x 8 units
  const int m1 = (warp & 1) * 16, n1 = (warp >> 1) * 8;
  // hidden unit of column j of chunk c (-1 past the end); with packed int4
  // w2 a chunk is HC/2 packed rows: units c*HC/2 + j and H/2 + c*HC/2 + j'
  auto hid = [&](int c, int j) -> int {
    if (a.w2.int4) {
      const int pr = c * (HC / 2) + (j & (HC / 2 - 1));
      if (pr >= half2) return -1;
      return j < HC / 2 ? pr : pr + half2;
    }
    const int h = c * HC + j;
    return h < H ? h : -1;
  };
  // int8 weights on the 16-byte paths stream through two buffers with
  // cp.async: chunk c + 1 loads while chunk c computes. Packed int4 (or a
  // shape off those paths) is unpacked by synchronous fills instead.
  const bool vec = a.w1.vec_ok() && a.w2.vec_ok();
  const bool async = vec && !a.w1.int4 && !a.w2.int4;
  auto prefetch = [&](int c, int8_t* b1s, int8_t* b2s) {
    const int kq = a.Kp / 16;
    for (int idx = threadIdx.x; idx < HC * kq; idx += NT) {
      const int j = idx / kq, k = (idx - j * kq) * 16;
      const int h = hid(c, j);
      const bool ok = h >= 0 && k < K;
      qvt::cp_async16(
          b1s + j * ska + k,
          a.w1.wt + (ok ? static_cast<long long>(h) * K + k : 0), ok);
    }
    for (int idx = threadIdx.x; idx < 64 * TN2 * (HC / 16); idx += NT) {
      const int n = idx / (HC / 16), j0 = (idx - n * (HC / 16)) * 16;
      const int h = hid(c, j0);
      const bool ok = h >= 0 && n < K;
      qvt::cp_async16(
          b2s + n * SK + j0,
          a.w2.wt + (ok ? static_cast<long long>(n) * H + h : 0), ok);
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };
  if (async) prefetch(0, bufs, bufs + HC * ska);

  for (int c = 0; c < n_chunks; ++c) {
    int8_t* B1s = bufs + (c & 1) * buf_bytes;
    int8_t* B2s = B1s + HC * ska;
    if (async) {
      if (c + 1 < n_chunks) {
        int8_t* nb = bufs + ((c + 1) & 1) * buf_bytes;
        prefetch(c + 1, nb, nb + HC * ska);
        asm volatile("cp.async.wait_group 1;\n" ::);
      } else {
        asm volatile("cp.async.wait_group 0;\n" ::);
      }
    } else if (vec) {
      // B1s[j][k] = W1[k, hid(j)]; B2s[n][j] = W2[hid(j), n] (16
      // consecutive j are 16 consecutive hidden units: one piece)
      qvt::fill_rows16(B1s, HC, ska, a.Kp, [&](int j, int k) -> uint4 {
        return a.w1.vec16(k, hid(c, j));
      });
      qvt::fill_rows16(B2s, 64 * TN2, SK, HC, [&](int n, int j) -> uint4 {
        return a.w2.vec16(hid(c, j), n);
      });
    } else {
      qvt::fill_rows(B1s, HC, ska, a.Kp, [&](int j, int k) -> int8_t {
        return a.w1.at(k, hid(c, j));
      });
      qvt::fill_rows(B2s, 64 * TN2, SK, HC, [&](int n, int j) -> int8_t {
        const int h = hid(c, j);
        return h < 0 ? 0 : a.w2.at(h, n);
      });
    }
    __syncthreads();

    // fc1 as two independent accumulator chains (alternate 32-deep
    // k-steps), summed after: int32 sums are exact in any order
    int acc1[1][1][4], acc1b[1][1][4];
    qvt::zero_acc(acc1);
    qvt::zero_acc(acc1b);
    for (int kk = 0; kk < a.Kp; kk += 64) {
      qvt::warp_mma<1, 1>(acc1, lvA + kk, ska, B1s + kk, ska, 32, m1, n1,
                          lane);
      qvt::warp_mma<1, 1>(acc1b, lvA + kk + 32, ska, B1s + kk + 32, ska, 32,
                          m1, n1, lane);
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) acc1[0][0][r] += acc1b[0][0][r];

    // dequant -> GELU -> fc2's input levels, into shared memory only
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = m1 + g + (r >= 2 ? 8 : 0);
      const int col = n1 + t * 2 + (r & 1);
      const int h = hid(c, col);
      int8_t lv = 0;
      if (h >= 0) {
        float y = static_cast<float>(acc1[0][0][r]) * a.s1[h] + a.b1[h];
        lv = a.hid_pow ? qvt::quantize(qvt::gelu(y), hid_d, hid_t, a.hid_top,
                                       true, false)
                       : qvt::gelu_quant_folded(y, hid_d, a.hid_top);
      }
      Hs[row * SK + col] = lv;
    }
    __syncthreads();
    qvt::warp_mma<2, TN2>(acc2, Hs, SK, B2s, SK, HC, 0, warp * TN2 * 8,
                          lane);
    __syncthreads();
  }
  QVT_STAMP(2);

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < TN2; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int row = m_base + i * 16 + g + (r >= 2 ? 8 : 0);
        const int col = warp * TN2 * 8 + j * 8 + t * 2 + (r & 1);
        if (row >= M || col >= K) continue;
        const long long o = static_cast<long long>(row) * K + col;
        float v = static_cast<float>(acc2[i][j][r]) * a.s2[col] + a.b2[col];
        qvt::store_f(a.out, a.out_dt, o, v + qvt::load_f(a.x, a.x_dt, o));
      }
  QVT_STAMPS_STORE(blk);
}

// the fc2 tile count (n8 tiles per warp) a launch instantiates for K: 4,
// 8, 12 or 16; 0 past K = 1024
inline int tn2_of(const Args& a) {
  const int tiles = a.Kp / 64;
  return tiles <= 4 ? 4 : tiles <= 8 ? 8 : tiles <= 12 ? 12
                                                         : tiles <= 16 ? 16 : 0;
}

}  // namespace qvt_mlp

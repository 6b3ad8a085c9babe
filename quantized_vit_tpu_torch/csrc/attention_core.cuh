// The attention phase shared by K3 (attention_block.cu) and K5
// (block_stack.cu): one head's attention over
// q/k/v rows already in shared memory (values rounded to the qkv dtype,
// held as f32 or, for a bf16 qkv dtype, as bf16: the same values in half
// the space), with the int8 or float epilogue of
// quantized_vit_tpu/ops/attention.py:164-231 and :277-289.
//
// Float path (attention.py:_score_one_head / _softmax_av with
// int_attention off): q pre-scaled by sm_scale*log2e and rounded back to
// the qkv dtype, scores over the n_valid unmasked keys,
// p = exp2(min(s, 100)) with no row-max subtraction, p rounded to the v
// dtype for AV, p_sum from f32 p plus 1e-30.
//
// int_attention (attention.py:140-147, 169-175, 198-221): q*sm_scale, k
// and v become int8 levels with dynamic per-(image, head) scales (the max
// runs over all query rows, padded ones included, and all nk key rows:
// attn_int_scales), the scores are exact integer dots times
// q_s*k_s*log2e, p = exp2(s - rowmax) (a first pass over the keys finds
// the row max, the second recomputes the same exact scores), p levels
// round(p*127), AV an exact integer dot times v_s, p_sum the sum of the p
// levels.
//
// Both run on the f64 tensor cores (mma.sync m8n8k4), a warp taking 8
// query rows at a time. A lane keeps hd/4 q values and hd/4 outputs in
// f64 registers; the functions take the head-dim bound HDM (64 or 80) as a
// template argument, so a narrower head keeps the smaller register set. Every product of bf16 or f32 values, and of int8
// levels, is exact in f64, and every sum here stays far inside f64's
// exact range for the levels (|s| <= 127*127*hd, |o| <= 127*127*nk), so
// after the single rounding to f32 the results equal the plain version's
// (ops/attention.py, sums in float64) in any summation order.
#pragma once

#include "qvt_common.cuh"

namespace qvt {

constexpr int ATT_HDMAX = 80;  // the widest head (HDM) instantiated
constexpr int ATT_KT = 4;      // key tiles per attention step

// Row strides (elements) of q/k and of v in shared memory, free of bank
// conflicts for the f64 mma fragment loads at hd = 64 and 80: f32 rows
// hd + 4 and hd + 8, bf16 rows hd + 8 for both
__host__ __device__ inline int att_q_stride(int hd) { return hd + 4; }
__host__ __device__ inline int att_v_stride(int hd) { return hd + 8; }
template <typename T>
__host__ __device__ inline int att_q_stride_t(int hd) {
  return sizeof(T) == 2 ? hd + 8 : hd + 4;
}

__device__ __forceinline__ float att_ld(const float* p) { return *p; }
__device__ __forceinline__ float att_ld(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
// v as the element type T (bf16: round to nearest even)
__device__ __forceinline__ void att_st(float* p, float v) { *p = v; }
__device__ __forceinline__ void att_st(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// the dynamic int8 scales of one (image, head) (attention.py:140-147)
struct IntScales {
  float q_inv, k_inv, v_inv;  // 1 / scale of q*sm_scale, k, v
  float s_mul;                // q_s * k_s * log2e
  float v_s;
};

enum { ATT_OUT_LEVELS = 0, ATT_OUT_POW = 1, ATT_OUT_FLOAT = 2 };

template <typename T = float>
struct AttnArgs {
  const T* q;  // query rows (stride rq), the first of them row 0
  const T* k;  // key rows (stride rq)
  const T* v;  // value rows (stride rv)
  int rq, rv;
  int nq;       // query rows present
  int n_kv;     // key/value rows present
  int n_valid;  // keys at or past this are masked
  int hd;
  float q_mul;     // float path: sm_scale*log2e (f32)
  float sm_scale;  // int path: sm_scale (f32)
  int qkv_dt;
  bool int_attn;
  IntScales is;
  // output: row (out_row0 + query row), columns out_col0 .. + hd
  int out_mode;
  void* out;
  int out_dt;
  long long out_stride, out_row0;
  int out_col0;
  float out_d, out_t, out_top;
};

// D = A B + C on the f64 tensor cores: A 8x4 (a = A[lane/4][lane%4]),
// B 4x8 (b = B[lane%4][lane/4]), C/D 8x8 (c0, c1 = C[lane/4][2*(lane%4)+i])
__device__ __forceinline__ void dmma(double& c0, double& c1, double a,
                                     double b) {
  asm volatile(
      "mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 "
      "{%0,%1}, {%2}, {%3}, {%0,%1};\n"
      : "+d"(c0), "+d"(c1)
      : "d"(a), "d"(b));
}

// round(x * inv) clipped to [-127, 127] (attention.py:_dyn_int8)
__device__ __forceinline__ double dyn_level(float x, float inv) {
  return static_cast<double>(fminf(fmaxf(rintf(x * inv), -127.f), 127.f));
}

// Block-wide: the dynamic scales of one head from its nq query rows and
// nk key/value rows in shared memory. Every thread of the block calls it.
template <typename T>
__device__ __forceinline__ IntScales attn_int_scales(const T* q, const T* k,
                                                     const T* v, int rq,
                                                     int rv, int nq, int nk,
                                                     int hd, float sm_scale) {
  __shared__ float red[3][32];
  float m[3] = {0.f, 0.f, 0.f};
  for (int i = threadIdx.x; i < nq * hd; i += blockDim.x) {
    const int r = i / hd, c = i - r * hd;
    m[0] = fmaxf(m[0], fabsf(att_ld(q + r * rq + c) * sm_scale));
  }
  for (int i = threadIdx.x; i < nk * hd; i += blockDim.x) {
    const int r = i / hd, c = i - r * hd;
    m[1] = fmaxf(m[1], fabsf(att_ld(k + r * rq + c)));
    m[2] = fmaxf(m[2], fabsf(att_ld(v + r * rv + c)));
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    for (int o = 16; o > 0; o >>= 1)
      m[j] = fmaxf(m[j], __shfl_xor_sync(0xffffffffu, m[j], o));
    if (lane == 0) red[j][warp] = m[j];
  }
  __syncthreads();
  const int nw = blockDim.x >> 5;
  float s[3];
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    float mx = 0.f;
    for (int w = 0; w < nw; ++w) mx = fmaxf(mx, red[j][w]);
    s[j] = fmaxf(mx, 1e-30f) * static_cast<float>(1.0 / 127.0);
  }
  __syncthreads();  // red is reused by the next call
  IntScales r;
  r.q_inv = 1.0f / s[0];
  r.k_inv = 1.0f / s[1];
  r.v_inv = 1.0f / s[2];
  r.s_mul = s[0] * s[1] * static_cast<float>(1.4426950408889634);
  r.v_s = s[2];
  return r;
}

template <bool INT, int HDM, typename T>
__device__ __forceinline__ void attention_rows_impl(const AttnArgs<T>& a,
                                                    int warp, int nwarps) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int hd = a.hd, KS = hd / 4, NTV = hd / 8;
  const int key_tiles = (a.n_valid + 7) / 8;
  const unsigned full = 0xffffffffu;
  // score of one (row, key) from the two accumulator chains
  auto score = [&](double c0, double c1, int key) -> float {
    if (key >= a.n_valid) return -1e30f;
    const double sc = c0 + c1;
    return INT ? static_cast<float>(sc) * a.is.s_mul : static_cast<float>(sc);
  };
  for (int mt = warp; mt * 8 < a.nq; mt += nwarps) {
    const int qrow = mt * 8 + g;
    double qa[HDM / 4];
#pragma unroll
    for (int ks = 0; ks < HDM / 4; ++ks) {
      qa[ks] = 0.0;
      if (ks < KS && qrow < a.nq) {
        const float qv = att_ld(a.q + qrow * a.rq + ks * 4 + t);
        qa[ks] = INT ? dyn_level(qv * a.sm_scale, a.is.q_inv)
                     : static_cast<double>(round_to(qv * a.q_mul, a.qkv_dt));
      }
    }
    // scores of KT key tiles from kt0 into c, each in two chains (even and
    // odd k-steps): 2*KT independent mma chains in flight
    auto scores = [&](int kt0, double (&c)[ATT_KT][2][2]) {
#pragma unroll
      for (int u = 0; u < ATT_KT; ++u)
        c[u][0][0] = c[u][0][1] = c[u][1][0] = c[u][1][1] = 0.0;
#pragma unroll
      for (int ks = 0; ks < HDM / 4; ++ks) {
        if (ks >= KS) break;
#pragma unroll
        for (int u = 0; u < ATT_KT; ++u) {
          const int key = (kt0 + u) * 8 + g;
          double kb = 0.0;
          if (kt0 + u < key_tiles && key < a.n_kv) {
            const float kv = att_ld(a.k + key * a.rq + ks * 4 + t);
            kb = INT ? dyn_level(kv, a.is.k_inv) : static_cast<double>(kv);
          }
          dmma(c[u][ks & 1][0], c[u][ks & 1][1], qa[ks], kb);
        }
      }
    };
    // int_attention: the row max of the scores first (lane (g, t) sees
    // keys 2t, 2t+1 of every tile of row g)
    float rmax = 0.f;
    if (INT) {
      rmax = -__int_as_float(0x7f800000);  // -inf
      for (int kt0 = 0; kt0 < key_tiles; kt0 += ATT_KT) {
        double c[ATT_KT][2][2];
        scores(kt0, c);
#pragma unroll
        for (int u = 0; u < ATT_KT; ++u) {
          if (kt0 + u >= key_tiles) break;
#pragma unroll
          for (int i = 0; i < 2; ++i)
            rmax = fmaxf(rmax, score(c[u][0][i], c[u][1][i],
                                     (kt0 + u) * 8 + 2 * t + i));
        }
      }
      rmax = fmaxf(rmax, __shfl_xor_sync(full, rmax, 1));
      rmax = fmaxf(rmax, __shfl_xor_sync(full, rmax, 2));
    }
    double o[HDM / 8][2];
#pragma unroll
    for (int nt = 0; nt < HDM / 8; ++nt) o[nt][0] = o[nt][1] = 0.0;
    double psum = 0.0;
    for (int kt0 = 0; kt0 < key_tiles; kt0 += ATT_KT) {
      double c[ATT_KT][2][2];
      scores(kt0, c);
#pragma unroll
      for (int u = 0; u < ATT_KT; ++u) {
        const int kt = kt0 + u;
        if (kt >= key_tiles) break;
        // p of rows g, keys kt*8 + 2t + {0, 1}
        double pb[2];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int key = kt * 8 + 2 * t + i;
          if (INT) {
            const float p =
                key < a.n_valid
                    ? exp2f(score(c[u][0][i], c[u][1][i], key) - rmax)
                    : 0.f;
            pb[i] = static_cast<double>(rintf(p * 127.0f));
            psum += pb[i];
          } else {
            const float p =
                key < a.n_valid
                    ? exp2f(fminf(score(c[u][0][i], c[u][1][i], key), 100.f))
                    : 0.f;
            pb[i] = round_to(p, a.qkv_dt);
            psum += p;
          }
        }
        // P as the A operand of two k-steps: lane (g, t) needs
        // P[g][4h + t], held by lane (g, 2h + t/2) as its element t % 2
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int src = (lane & ~3) | (2 * hh + (t >> 1));
          const double v0 = __shfl_sync(full, pb[0], src);
          const double v1 = __shfl_sync(full, pb[1], src);
          const double pa = (t & 1) ? v1 : v0;
          const int vkey = kt * 8 + 4 * hh + t;
#pragma unroll
          for (int nt = 0; nt < HDM / 8; ++nt) {
            if (nt >= NTV) break;
            double vb = 0.0;
            if (vkey < a.n_kv) {
              const float vv = att_ld(a.v + vkey * a.rv + nt * 8 + g);
              vb = INT ? dyn_level(vv, a.is.v_inv) : static_cast<double>(vv);
            }
            dmma(o[nt][0], o[nt][1], pa, vb);
          }
        }
      }
    }
    psum += __shfl_xor_sync(full, psum, 1);
    psum += __shfl_xor_sync(full, psum, 2);
    if (qrow >= a.nq) continue;
    const float ps = INT ? static_cast<float>(psum)
                         : static_cast<float>(psum) + 1e-30f;
    const long long obase =
        (a.out_row0 + qrow) * a.out_stride + a.out_col0 + 2 * t;
    const float inv = 1.0f / (ps * a.out_d);
#pragma unroll
    for (int nt = 0; nt < HDM / 8; ++nt) {
      if (nt >= NTV) break;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float ov = INT ? static_cast<float>(o[nt][i]) * a.is.v_s
                             : static_cast<float>(o[nt][i]);
        const long long oi = obase + nt * 8 + i;
        if (a.out_mode == ATT_OUT_LEVELS)
          static_cast<int8_t*>(a.out)[oi] = clip_round(ov * inv, a.out_top);
        else if (a.out_mode == ATT_OUT_POW)
          static_cast<int8_t*>(a.out)[oi] =
              quantize(ov / ps, a.out_d, a.out_t, a.out_top, true, false);
        else
          store_f(a.out, a.out_dt, oi, ov / ps);
      }
    }
  }
}

// The attention of the query rows [0, a.nq): 8-row tiles warp, warp +
// nwarps, ... of the calling warp, for head_dim <= HDM. a.is must be set
// when a.int_attn.
template <int HDM, typename T>
__device__ __forceinline__ void attention_rows(const AttnArgs<T>& a, int warp,
                                               int nwarps) {
  if (a.int_attn)
    attention_rows_impl<true, HDM>(a, warp, nwarps);
  else
    attention_rows_impl<false, HDM>(a, warp, nwarps);
}

}  // namespace qvt

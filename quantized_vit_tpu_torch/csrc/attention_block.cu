// K3: attention residual branch for Hopper (sm_90a), first of its two
// launches (the second is K1 with the residual epilogue for proj).
//
// Replaces the TPU kernel quantized_vit_tpu/ops/attention.py:
// _attn_block_kernel (pallas_call in _attention_block, attention.py:667),
// which computes x + proj(quant(softmax(q k^T s) v)) with
// q/k/v = qkv(quant(LN(x))) and keeps the [M, 3D] qkv tensor out of HBM
// (66 MB per block at batch 32). This kernel keeps that property: one
// block per (head, image)
//   1. LayerNorm statistics of the image's rows (fast-variance form);
//   2. this head's q/k/v columns of the qkv GEMM, 112 rows at a time, with
//      the A tile quantized from LN(x) on the fly (mma.sync m16n8k32 s8;
//      the weight arrives n-major from the layer's plan; the next
//      step's x and weight pieces load into registers during this step);
//      dequant + bias, rounded to the residual dtype as the TPU scratch is
//      (attention.py:469), kept in shared memory in that dtype (bf16 or
//      f32: 139 KB of q/k/v at ViT-H's 272 tokens x head_dim 80 in bf16);
//   3. the attention of this head on the f64 tensor cores, float or
//      int_attention (attention_core.cuh, shared with K5 and K6), and the
//      int8 levels round(o * (1/(p_sum*d))) (attention.py:164-231).
// Only the int8 attention levels [B*N, H*hd] are written to memory.
//
// Bound on this card at ViT-B batch 32 (both launches): 31.4 G int8 ops
// over 1,979 TOPS plus 4.25 G bf16 ops over 989 TFLOP/s (~20 us), against
// ~23 MB moved: compute-bound. This version computes the attention in f64
// (67 TFLOP/s on the f64 tensor cores against 989 for bf16) to stay
// bit-exact with the plain version, and stages its GEMM tiles through
// registers one step ahead, without TMA or wgmma, so it is far from it.

#include "attention_core.cuh"

namespace {

// 8 warps. The qkv GEMM takes 112 query rows (7 m16 tiles) per pass,
// every warp all of them and TN n8 tiles of the 3*hd columns: TN = 3 (192
// columns) for head_dim <= 64, 4 (256) for head_dim <= 80. Two passes at
// 208 rows, three at 272. The attention gives each warp 8-row tiles of
// queries.
constexpr int NT = 256, BMQ = 112, TMQ = BMQ / 16, BK = 64, SK = BK + 16;

__host__ __device__ constexpr int tn_of(int hdm) { return (3 * hdm + 63) / 64; }

template <typename T, int HDM>
__host__ __device__ inline size_t smem_bytes(int n, int hd) {
  return static_cast<size_t>(n) *
             (2 * qvt::att_q_stride_t<T>(hd) + qvt::att_v_stride(hd)) *
             sizeof(T) +
         static_cast<size_t>(BMQ + 64 * tn_of(HDM)) * SK +
         static_cast<size_t>(2) * n * sizeof(float);
}

struct Args {
  const void* x;
  int x_dt;
  qvt::WeightT wq;  // D x 3*H*hd levels, transposed: [3*H*hd][D(/2)]
  const float* qs;
  const float* qb;
  const float* ln_g;
  const float* ln_b;
  const float* prm;  // act_d, act_t, out_d, out_t
  int8_t* alv;
  int B, n, D, heads, hd, n_valid, nk;
  float q_mul, sm_scale;
  bool int_attn;
  int qkv_dt;
  int act_pow, out_pow;
  float act_top, out_top, eps;
};

// Shared memory: q [n][RQ] | k [n][RQ] | v [n][RV] (T, the qkv dtype) |
// As [BMQ][SK] | Bs [64*TN][SK] | mu [n] | rs [n]
template <typename T, int HDM>
__global__ void __launch_bounds__(NT) attn_kernel(Args a) {
  constexpr int TN = tn_of(HDM), NQKV = 64 * TN;
  extern __shared__ __align__(16) int8_t smem[];
  const int n = a.n, hd = a.hd, D = a.D;
  const int RQ = qvt::att_q_stride_t<T>(hd), RV = qvt::att_v_stride(hd);
  T* q_s = reinterpret_cast<T*>(smem);
  T* k_s = q_s + n * RQ;
  T* v_s = k_s + n * RQ;
  int8_t* As = reinterpret_cast<int8_t*>(v_s + n * RV);
  int8_t* Bs = As + BMQ * SK;
  float* s_mu = reinterpret_cast<float*>(Bs + NQKV * SK);
  float* s_rs = s_mu + n;

  const int h = blockIdx.x, b = blockIdx.y;
  const int HD = a.heads * hd;
  const long long row0 = static_cast<long long>(b) * n;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const float act_d = a.prm[0], act_t = a.prm[1];
  const float out_d = a.prm[2], out_t = a.prm[3];

  QVT_STAMP(0);
  qvt::ln_stats(a.x, a.x_dt, row0, n, n, D, a.eps, s_mu, s_rs);
  __syncthreads();
  QVT_STAMP(1);

  // this head's q/k/v: column j of the [n, 3*hd] tile is global qkv
  // column part*HD + h*hd + jj
  const int wn = warp * TN * 8;
  const bool w_vec = a.wq.vec_ok();
  auto col_of = [&](int j) {  // qkv column of this head's tile column j
    const int part = j / hd;
    return part * HD + h * hd + (j - part * hd);
  };
  auto level = [&](int i, int k, float v) -> int8_t {  // quant(LN(x))
    if (i >= n || k >= D) return 0;
    float y = (v - s_mu[i]) * s_rs[i] * a.ln_g[k] + a.ln_b[k];
    return qvt::quantize(y, act_d, act_t, a.act_top, a.act_pow, !a.act_pow);
  };
  // the GEMM's steps: row passes of BMQ rows x D in BK-deep steps
  const int n_k = (D + BK - 1) / BK;
  const int n_it = (n + BMQ - 1) / BMQ * n_k;
  // Prefetch path: the next step's x rows (raw 16-byte pieces) and weight
  // pieces load into registers while this step's tile product runs
  const int xb = a.x_dt == qvt::DT_BF16 ? 2 : 4;
  const int epp = 16 / xb;  // x elements per piece
  const bool pre =
      w_vec && (a.x_dt == qvt::DT_BF16 || a.x_dt == qvt::DT_F32) &&
      D % epp == 0 && (reinterpret_cast<uintptr_t>(a.x) & 15) == 0;
  const int xpr = BK / epp, x_pieces = BMQ * xpr;
  const char* xbytes = static_cast<const char*>(a.x);
  constexpr int XR = BMQ * BK * 4 / 16 / NT;  // f32 pieces per thread
  static_assert(NQKV * BK / 16 == TN * NT, "TN weight pieces a thread");
  uint4 xr[XR], wr[TN];
  auto load = [&](int it) {
    const int rt = it / n_k * BMQ, k0 = it % n_k * BK;
#pragma unroll
    for (int u = 0; u < XR; ++u) {
      const int p = threadIdx.x + u * NT;
      const int r = p / xpr, k = k0 + (p - r * xpr) * epp;
      xr[u] = p < x_pieces && rt + r < n && k < D
                  ? __ldg(reinterpret_cast<const uint4*>(
                        xbytes + ((row0 + rt + r) * D + k) * xb))
                  : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int u = 0; u < TN; ++u) {
      const int p = threadIdx.x + u * NT, j = p >> 2;
      wr[u] = a.wq.vec16(k0 + (p & 3) * 16, j < 3 * hd ? col_of(j) : -1);
    }
  };
  auto store = [&](int it) {
    const int rt = it / n_k * BMQ, k0 = it % n_k * BK;
#pragma unroll
    for (int u = 0; u < XR; ++u) {
      const int p = threadIdx.x + u * NT;
      if (p >= x_pieces) break;
      const int r = p / xpr, c = (p - r * xpr) * epp;
      const uint32_t w[4] = {xr[u].x, xr[u].y, xr[u].z, xr[u].w};
      uint32_t lv[2] = {0u, 0u};
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        if (e >= epp) break;
        const float v = xb == 2 ? __uint_as_float(e & 1 ? w[e >> 1] & 0xFFFF0000u
                                                        : w[e >> 1] << 16)
                                : __uint_as_float(w[e]);
        lv[e >> 2] |= static_cast<uint32_t>(static_cast<uint8_t>(
                          level(rt + r, k0 + c + e, v)))
                      << (8 * (e & 3));
      }
      if (epp == 8)
        *reinterpret_cast<uint2*>(As + r * SK + c) = make_uint2(lv[0], lv[1]);
      else
        *reinterpret_cast<uint32_t*>(As + r * SK + c) = lv[0];
    }
#pragma unroll
    for (int u = 0; u < TN; ++u) {
      const int p = threadIdx.x + u * NT;
      *reinterpret_cast<uint4*>(Bs + (p >> 2) * SK + (p & 3) * 16) = wr[u];
    }
  };

  int acc[TMQ][TN][4];
  if (pre) load(0);
  for (int it = 0; it < n_it; ++it) {
    const int rt = it / n_k * BMQ, k0 = it % n_k * BK;
    if (k0 == 0) qvt::zero_acc(acc);
    if (pre) {
      store(it);
    } else {
      qvt::fill_rows(As, BMQ, SK, BK, [&](int r, int kk) -> int8_t {
        const int i = rt + r, k = k0 + kk;
        if (i >= n || k >= D) return 0;
        return level(i, k, qvt::load_f(a.x, a.x_dt, (row0 + i) * D + k));
      });
      // this head's q/k/v weight columns: Bs[j][k] = Wqkv[k, col(j)]
      if (w_vec)
        qvt::fill_rows16(Bs, NQKV, SK, BK, [&](int j, int c) -> uint4 {
          return a.wq.vec16(k0 + c, j < 3 * hd ? col_of(j) : -1);
        });
      else
        qvt::fill_rows(Bs, NQKV, SK, BK, [&](int j, int kk) -> int8_t {
          return a.wq.at(k0 + kk, j < 3 * hd ? col_of(j) : -1);
        });
    }
    __syncthreads();
    if (pre && it + 1 < n_it) load(it + 1);
    qvt::warp_mma<TMQ, TN>(acc, As, SK, Bs, SK, BK, 0, wn, lane);
    __syncthreads();
    if (k0 + BK < D) continue;
#pragma unroll
    for (int i = 0; i < TMQ; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int qi = rt + i * 16 + g + (r >= 2 ? 8 : 0);
          const int col = wn + j * 8 + t * 2 + (r & 1);
          if (qi >= n || col >= 3 * hd) continue;
          const int part = col / hd, jj = col - part * hd;
          const int gc = part * HD + h * hd + jj;
          float y = static_cast<float>(acc[i][j][r]) * a.qs[gc];
          if (a.qb) y = y + a.qb[gc];
          T* dst = part == 0 ? q_s + qi * RQ
                             : part == 1 ? k_s + qi * RQ : v_s + qi * RV;
          qvt::att_st(dst + jj, y);
        }
  }
  __syncthreads();
  QVT_STAMP(2);

  // 3. the attention of this head (attention_core.cuh), 8 query rows per
  // warp at a time, writing the int8 levels of the proj quantizer
  qvt::AttnArgs<T> at;
  at.q = q_s;
  at.k = k_s;
  at.v = v_s;
  at.rq = RQ;
  at.rv = RV;
  at.nq = n;
  at.n_kv = a.nk;  // keys past nk are masked (attention.py:_n_keys)
  at.n_valid = a.n_valid;
  at.hd = hd;
  at.q_mul = a.q_mul;
  at.sm_scale = a.sm_scale;
  at.qkv_dt = a.qkv_dt;
  at.int_attn = a.int_attn;
  if (a.int_attn)  // scales over all n query rows and the nk key rows
    at.is = qvt::attn_int_scales(q_s, k_s, v_s, RQ, RV, n, a.nk, hd,
                                 a.sm_scale);
  at.out_mode = a.out_pow ? qvt::ATT_OUT_POW : qvt::ATT_OUT_LEVELS;
  at.out = a.alv;
  at.out_dt = qvt::DT_INT8;
  at.out_stride = HD;
  at.out_row0 = row0;
  at.out_col0 = h * hd;
  at.out_d = out_d;
  at.out_t = out_t;
  at.out_top = a.out_top;
  qvt::attention_rows<HDM>(at, warp, NT / 32);
  QVT_STAMPS_STORE(blockIdx.y * gridDim.x + blockIdx.x);
}

}  // namespace

template <typename T, int HDM>
int launch(const Args& a, cudaStream_t stream) {
  const size_t smem = smem_bytes<T, HDM>(a.n, a.hd);
  cudaError_t e = cudaFuncSetAttribute(
      attn_kernel<T, HDM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  attn_kernel<T, HDM><<<dim3(a.heads, a.B), NT, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int qvt_attention_heads(
    const void* x, int x_dt, const void* wq, int wq_int4, const void* qs,
    const void* qb, const void* ln_g, const void* ln_b, const void* prm,
    void* alv, int B, int n, int D, int heads, int hd, int n_valid, int nk,
    float q_mul, float sm_scale, int int_attn, int qkv_dt, int act_pow,
    int out_pow, int act_top, int out_top, float eps, void* stream) {
  if (hd > qvt::ATT_HDMAX || hd % 8 || nk > n || n_valid > nk ||
      (qkv_dt != qvt::DT_BF16 && qkv_dt != qvt::DT_F32))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.x = x;
  a.x_dt = x_dt;
  a.wq = qvt::WeightT{static_cast<const int8_t*>(wq), D, 3 * heads * hd,
                      wq_int4};
  a.qs = static_cast<const float*>(qs);
  a.qb = static_cast<const float*>(qb);
  a.ln_g = static_cast<const float*>(ln_g);
  a.ln_b = static_cast<const float*>(ln_b);
  a.prm = static_cast<const float*>(prm);
  a.alv = static_cast<int8_t*>(alv);
  a.B = B;
  a.n = n;
  a.D = D;
  a.heads = heads;
  a.hd = hd;
  a.n_valid = n_valid;
  a.nk = nk;
  a.q_mul = q_mul;
  a.sm_scale = sm_scale;
  a.int_attn = int_attn != 0;
  a.qkv_dt = qkv_dt;
  a.act_pow = act_pow;
  a.out_pow = out_pow;
  a.act_top = static_cast<float>(act_top);
  a.out_top = static_cast<float>(out_top);
  a.eps = eps;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (qkv_dt == qvt::DT_BF16)
    return hd <= 64 ? launch<__nv_bfloat16, 64>(a, st)
                    : launch<__nv_bfloat16, 80>(a, st);
  return hd <= 64 ? launch<float, 64>(a, st) : launch<float, 80>(a, st);
}

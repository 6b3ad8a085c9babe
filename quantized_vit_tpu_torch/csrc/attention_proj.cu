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
// Design: a block per (image, tile of R query rows): R = 64 (an 8-row
// attention tile for each of the 8 warps), or 32 or 16 where a larger tile
// overflows shared memory (f32 qkv at ViT-H/14's widths takes 16). For
// each head the block stages the head's q columns of its rows and the k/v
// columns of the nk key rows (attention.py:_n_keys) in shared memory in
// the qkv dtype, and runs the attention core of attention_core.cuh (the f64
// tensor-core core of K3, K5 and K6; a warp per 8-row query tile) with its
// output pointed at a shared [R, H*hd] int8 tile of levels. After the last
// head the k/v space holds two buffers of w_proj chunks (256 output columns
// x 64 levels, n-major from the layer's plan; packed int4 stays packed and
// is unpacked into the mma fragments, low nibbles against level columns k',
// high against H*hd/2 + k'), streamed with cp.async, and the 8 warps run
// the proj GEMM 32 columns each (mma.sync m16n8k32 s8). The int32 sums of a
// row run in one block, so the result does not depend on the split: it is
// the plain version's (K6's levels, then K1's residual epilogue) bit for
// bit, up to the attention core's f64 sums (attention_core.cuh).
//
// Bound on this card at ViT-H/14 batch 8 (8 x 272 rows, 16 heads of 80,
// D 1280, bf16): 29.5 MB moved (8.8 us at 3.35 TB/s) against 3.0 G
// attention operations at the bf16 rate and 7.1 G int8 proj operations
// (6.7 us): bytes.
// The attention runs in f64 on the tensor cores (67 TFLOP/s, for bit
// parity), each block re-stages its image's k/v per head and re-reads
// w_proj from L2, so this first version is far above it.

#include <algorithm>

#include "attention_core.cuh"

namespace {

constexpr int NT = 256, NW = NT / 32;
constexpr int PN = 256;       // proj output columns per pass (32 a warp)
constexpr int PK = 64;        // proj levels per chunk
constexpr int SB = PK + 16;   // weight chunk row stride (bytes)
constexpr int WBUF = PN * SB;
constexpr int SMEM_MAX = 232448 - 3 * 32 * 4;  // less attn_int_scales' red

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
  int B, n, heads, hd, D, n_valid, nk, rows;
  int sa;       // level tile row stride: round_up(H*hd, 64) + 16
  int region;   // bytes of the k/v | weight-buffer region
  float q_mul, sm_scale, out_top;
  int out_pow;
  bool int_attn, qkv_vec, w_vec;
};

__host__ __device__ inline int round_up(int a, int b) {
  return (a + b - 1) / b * b;
}

template <typename T>
size_t region_bytes(int nk, int hd) {
  return std::max(static_cast<size_t>(nk) *
                      (qvt::att_q_stride_t<T>(hd) + qvt::att_v_stride(hd)) *
                      sizeof(T),
                  static_cast<size_t>(2 * WBUF));
}

template <typename T>
size_t smem_bytes(int rows, int nk, int hd, int hdim) {
  return region_bytes<T>(nk, hd) +
         static_cast<size_t>(rows) * qvt::att_q_stride_t<T>(hd) * sizeof(T) +
         static_cast<size_t>(rows) * (round_up(hdim, 64) + 16);
}

// Copy `count` rows of hd values (source row stride W elements, from src)
// into shared rows of stride rs: 16-byte pieces when `vec`
template <typename T>
__device__ __forceinline__ void stage_rows(T* dst, int rs, const T* src,
                                           long long W, int count, int hd,
                                           bool vec) {
  if (vec) {
    constexpr int E = 16 / sizeof(T);
    const int pr = hd / E;
    for (int i = threadIdx.x; i < count * pr; i += NT) {
      const int r = i / pr, c = (i - r * pr) * E;
      *reinterpret_cast<uint4*>(dst + r * rs + c) =
          __ldg(reinterpret_cast<const uint4*>(src + r * W + c));
    }
  } else {
    for (int i = threadIdx.x; i < count * hd; i += NT) {
      const int r = i / hd, c = i - r * hd;
      dst[r * rs + c] = src[r * W + c];
    }
  }
}

// Shared memory: region { k [nk][RQ] | v [nk][RV] } (T), later two weight
// buffers [PN][SB] | q [rows][RQ] (T) | levels [rows][sa] (int8)
template <typename T, int HDM>
__global__ void __launch_bounds__(NT, 1) attn_proj_kernel(Args a) {
  extern __shared__ __align__(16) int8_t smem[];
  const int n = a.n, nk = a.nk, hd = a.hd, H = a.heads, R = a.rows;
  const int HD = H * hd, W = 3 * HD, D = a.D, SA = a.sa;
  const int RQ = qvt::att_q_stride_t<T>(hd), RV = qvt::att_v_stride(hd);
  const int b = blockIdx.y, q0 = blockIdx.x * R;
  const int nq = min(n - q0, R);
  T* k_s = reinterpret_cast<T*>(smem);
  T* v_s = k_s + nk * RQ;
  T* q_s = reinterpret_cast<T*>(smem + a.region);
  int8_t* lv = reinterpret_cast<int8_t*>(q_s + R * RQ);
  const long long row0 = static_cast<long long>(b) * n;
  const T* src = static_cast<const T*>(a.qkv);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;

  // the level tile's columns past H*hd (and rows past nq) stay 0
  for (int i = threadIdx.x; i < R * SA / 16; i += NT)
    reinterpret_cast<uint4*>(lv)[i] = make_uint4(0u, 0u, 0u, 0u);

  qvt::AttnArgs<T> at;
  at.k = k_s;
  at.v = v_s;
  at.q = q_s;
  at.rq = RQ;
  at.rv = RV;
  at.nq = nq;
  at.n_kv = nk;
  at.n_valid = a.n_valid;
  at.hd = hd;
  at.q_mul = a.q_mul;
  at.sm_scale = a.sm_scale;
  at.qkv_dt = a.qkv_dt;
  at.int_attn = a.int_attn;
  at.out_mode = a.out_pow ? qvt::ATT_OUT_POW : qvt::ATT_OUT_LEVELS;
  at.out = lv;
  at.out_dt = qvt::DT_INT8;
  at.out_stride = SA;
  at.out_row0 = 0;
  at.out_d = a.prm[0];
  at.out_t = a.prm[1];
  at.out_top = a.out_top;

  for (int h = 0; h < H; ++h) {
    __syncthreads();  // the previous head's k/v and q are no longer read
    stage_rows(k_s, RQ, src + row0 * W + HD + h * hd, W, nk, hd, a.qkv_vec);
    stage_rows(v_s, RV, src + row0 * W + 2 * HD + h * hd, W, nk, hd,
               a.qkv_vec);
    stage_rows(q_s, RQ, src + (row0 + q0) * W + h * hd, W, nq, hd,
               a.qkv_vec);
    __syncthreads();
    if (a.int_attn) {
      // the q scale runs over all n query rows of the image
      float q_max = 0.f;
      for (int i = threadIdx.x; i < n * hd; i += NT) {
        const int r = i / hd, c = i - r * hd;
        q_max = fmaxf(q_max, fabsf(qvt::att_ld(src + (row0 + r) * W +
                                               h * hd + c) *
                                   a.sm_scale));
      }
      at.is = qvt::attn_int_scales(q_s, k_s, v_s, RQ, RV, 0, nk, hd,
                                   a.sm_scale, q_max);
    }
    at.out_col0 = h * hd;
    qvt::attention_rows<HDM>(at, warp, NW);
  }
  __syncthreads();  // every head's levels are in the tile; k/v are free

  // proj: levels [R, H*hd] x w_proj -> [R, D], PN columns per pass
  const bool w4 = a.w4 != 0;
  const int half = HD >> 1, ldw = w4 ? half : HD;
  const int n_chunks = w4 ? (half + 31) / 32 : (HD + PK - 1) / PK;
  const int wn = warp * 32;
  auto load = [&](int nb, int ch, int8_t* buf) {
    const int wp = w4 ? 2 : 4, kb = ch * (w4 ? 32 : PK);
    for (int i = threadIdx.x; i < PN * wp; i += NT) {
      const int nn = i / wp, c = (i - nn * wp) * 16;
      const int col = nb + nn, k = kb + c;
      int8_t* dst = buf + nn * SB + c;
      const int8_t* wsrc = a.w + static_cast<long long>(col) * ldw + k;
      if (a.w_vec) {
        const bool ok = col < D && k < ldw;
        qvt::cp_async16(dst, ok ? wsrc : a.w, ok);
      } else {
        for (int j = 0; j < 16; ++j)
          dst[j] = (col < D && k + j < ldw) ? wsrc[j] : int8_t(0);
      }
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };

  for (int nb = 0; nb < D; nb += PN) {
    int acc[4][4][4];
    qvt::zero_acc(acc);
    load(nb, 0, smem);
    for (int ch = 0; ch < n_chunks; ++ch) {
      const int8_t* Bs = smem + (ch & 1) * WBUF;
      if (ch + 1 < n_chunks) {
        load(nb, ch + 1, smem + ((ch + 1) & 1) * WBUF);
        asm volatile("cp.async.wait_group 1;\n" ::);
      } else {
        asm volatile("cp.async.wait_group 0;\n" ::);
      }
      __syncthreads();
#pragma unroll
      for (int ks = 0; ks < 2; ++ks) {
        // level columns of this k32 step: int4 pairs the low nibbles with
        // columns k' and the high ones with H*hd/2 + k'
        const int acol = w4 ? (ks ? half : 0) + ch * 32 : ch * PK + ks * 32;
        uint32_t af[4][4], bf[4][2];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if (i * 16 >= R) break;  // the tile's m16 row groups
          const int8_t* p = lv + (i * 16 + g) * SA + acol + t * 4;
          af[i][0] = *reinterpret_cast<const uint32_t*>(p);
          af[i][1] = *reinterpret_cast<const uint32_t*>(p + 8 * SA);
          af[i][2] = *reinterpret_cast<const uint32_t*>(p + 16);
          af[i][3] = *reinterpret_cast<const uint32_t*>(p + 8 * SA + 16);
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int8_t* q =
              Bs + (wn + j * 8 + g) * SB + (w4 ? 0 : ks * 32) + t * 4;
          const uint32_t b0 = *reinterpret_cast<const uint32_t*>(q);
          const uint32_t b1 = *reinterpret_cast<const uint32_t*>(q + 16);
          bf[j][0] = w4 ? qvt::nibbles(b0, ks == 1) : b0;
          bf[j][1] = w4 ? qvt::nibbles(b1, ks == 1) : b1;
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if (i * 16 >= R) break;
#pragma unroll
          for (int j = 0; j < 4; ++j)
            qvt::mma_s8(acc[i][j], af[i][0], af[i][1], af[i][2], af[i][3],
                        bf[j][0], bf[j][1]);
        }
      }
      __syncthreads();  // the buffer is free for chunk ch + 2
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int qr = i * 16 + g + (r >= 2 ? 8 : 0);
          const int col = nb + wn + j * 8 + t * 2 + (r & 1);
          if (qr >= nq || col >= D) continue;
          const long long o = (row0 + q0 + qr) * D + col;
          float v = static_cast<float>(acc[i][j][r]) * a.scale[col];
          if (a.bias) v = v + a.bias[col];
          qvt::store_f(a.out, a.out_dt, o,
                       v + qvt::load_f(a.res, a.res_dt, o));
        }
  }
}

template <typename T, int HDM>
int launch(Args& a, cudaStream_t stream) {
  const int hdim = a.heads * a.hd;
  a.sa = round_up(hdim, 64) + 16;
  a.region = static_cast<int>(region_bytes<T>(a.nk, a.hd));
  a.rows = 0;
  const int rows[3] = {64, 32, 16};  // query rows a block, largest to fit
  for (int r : rows)
    if (smem_bytes<T>(r, a.nk, a.hd, hdim) <= SMEM_MAX) {
      a.rows = r;
      break;
    }
  if (a.rows == 0) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes<T>(a.rows, a.nk, a.hd, hdim);
  cudaError_t e = cudaFuncSetAttribute(
      attn_proj_kernel<T, HDM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid((a.n + a.rows - 1) / a.rows, a.B);
  attn_proj_kernel<T, HDM><<<grid, NT, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int qvt_attention_qkv_proj(
    const void* qkv, int qkv_dt, const void* w, int w_int4, const void* scale,
    const void* bias, const void* res, int res_dt, const void* prm, void* out,
    int out_dt, int B, int n, int heads, int hd, int D, int n_valid, int nk,
    float q_mul, float sm_scale, int int_attn, int out_pow, int out_top,
    void* stream) {
  if (hd > qvt::ATT_HDMAX || hd % 8 || nk > n || n_valid > nk ||
      (qkv_dt != qvt::DT_BF16 && qkv_dt != qvt::DT_F32))
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
  a.q_mul = q_mul;
  a.sm_scale = sm_scale;
  a.out_top = static_cast<float>(out_top);
  a.out_pow = out_pow;
  a.int_attn = int_attn != 0;
  const int es = qkv_dt == qvt::DT_BF16 ? 2 : 4;
  const int hdim = heads * hd;
  // q/k/v head slices as 16-byte pieces: every row, column offset and
  // shared row a multiple of 16 bytes
  a.qkv_vec = (reinterpret_cast<uintptr_t>(qkv) & 15) == 0 &&
              (hd * es) % 16 == 0;
  a.w_vec = (reinterpret_cast<uintptr_t>(w) & 15) == 0 &&
            (w_int4 ? (hdim / 2) % 16 == 0 : hdim % 16 == 0);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (qkv_dt == qvt::DT_BF16)
    return hd <= 64 ? launch<__nv_bfloat16, 64>(a, st)
                    : launch<__nv_bfloat16, 80>(a, st);
  return hd <= 64 ? launch<float, 64>(a, st) : launch<float, 80>(a, st);
}

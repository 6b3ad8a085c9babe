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
// Design: a block per (head, image, query split). It loads this head's
// q columns of all N rows and its k/v columns of the nk key rows
// (attention.py:_n_keys) into shared memory as f32, then runs the
// attention core of attention_core.cuh (shared with K3 and K5) on its
// share of the 8-row query tiles. At batch 1-3 there are only 12-36
// (head, image) pairs for 132 SMs, so the query tiles of a pair are split
// over up to four blocks; each block loads the whole head (the
// int_attention scales run over every query row).
//
// Bound on this card at ViT-B batch 2: 2.24 MB in and out (0.67 us at
// 3.35 TB/s) against 0.2 G bf16-rate attention operations: bytes. The
// attention runs in f64 on the tensor cores (bit-exact with the plain
// version), and each query split re-reads its head's k/v, so it is far
// from that bound.

#include <algorithm>

#include "attention_core.cuh"

namespace {

constexpr int NT = 256;

struct Args {
  const void* qkv;
  int qkv_dt;
  void* out;
  int out_dt;
  int out_mode;
  const float* prm;  // out_d, out_t
  int B, n, heads, hd, n_valid, nk, splits;
  float q_mul, sm_scale, out_top;
  bool int_attn;
};

size_t smem_bytes(int n, int nk, int hd) {
  return (static_cast<size_t>(n + nk) * qvt::att_q_stride(hd) +
          static_cast<size_t>(nk) * qvt::att_v_stride(hd)) *
         sizeof(float);
}

// Shared memory: q [n][hd+4] | k [nk][hd+4] | v [nk][hd+8] (f32); at
// ViT-B 173 KB, one block per SM, so the registers need not be shared
__global__ void __launch_bounds__(NT, 1) qkv_attn_kernel(Args a) {
  extern __shared__ __align__(16) float fsm[];
  const int n = a.n, nk = a.nk, hd = a.hd;
  const int RQ = qvt::att_q_stride(hd), RV = qvt::att_v_stride(hd);
  float* q_s = fsm;
  float* k_s = q_s + n * RQ;
  float* v_s = k_s + nk * RQ;
  const int h = blockIdx.x, b = blockIdx.y, split = blockIdx.z;
  const int HD = a.heads * hd, W = 3 * HD;
  const long long row0 = static_cast<long long>(b) * n;

  // this head's q of every row and k/v of the nk key rows; neighbouring
  // threads read neighbouring columns of a row
  for (int i = threadIdx.x; i < n * hd; i += NT) {
    const int r = i / hd, c = i - r * hd;
    const long long base = (row0 + r) * W + h * hd + c;
    q_s[r * RQ + c] = qvt::load_f(a.qkv, a.qkv_dt, base);
    if (r < nk) {
      k_s[r * RQ + c] = qvt::load_f(a.qkv, a.qkv_dt, base + HD);
      v_s[r * RV + c] = qvt::load_f(a.qkv, a.qkv_dt, base + 2 * HD);
    }
  }
  __syncthreads();

  qvt::AttnArgs at;
  at.q = q_s;
  at.k = k_s;
  at.v = v_s;
  at.rq = RQ;
  at.rv = RV;
  at.nq = n;
  at.n_kv = nk;
  at.n_valid = a.n_valid;
  at.hd = hd;
  at.q_mul = a.q_mul;
  at.sm_scale = a.sm_scale;
  at.qkv_dt = a.qkv_dt;
  at.int_attn = a.int_attn;
  if (a.int_attn)
    at.is = qvt::attn_int_scales(q_s, k_s, v_s, RQ, RV, n, nk, hd,
                                 a.sm_scale);
  at.out_mode = a.out_mode;
  at.out = a.out;
  at.out_dt = a.out_dt;
  at.out_stride = HD;
  at.out_row0 = row0;
  at.out_col0 = h * hd;
  at.out_d = a.prm[0];
  at.out_t = a.prm[1];
  at.out_top = a.out_top;
  const int warp = threadIdx.x >> 5, nw = NT / 32;
  qvt::attention_rows(at, split * nw + warp, nw * a.splits);
}

int sm_count() {
  static int count = 0;
  if (count == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev);
  }
  return count;
}

}  // namespace

// out_mode: 0 int8 levels (out_pow false), 1 int8 levels of the pow
// quantizer, 2 floats in out_dt
extern "C" int qvt_attention_qkv(const void* qkv, int qkv_dt, void* out,
                                 int out_dt, int out_mode, const void* prm,
                                 int B, int n, int heads, int hd, int n_valid,
                                 int nk, float q_mul, float sm_scale,
                                 int int_attn, int out_top, void* stream) {
  if (hd > qvt::ATT_HDMAX || hd % 8 || nk > n || n_valid > nk)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.qkv = qkv;
  a.qkv_dt = qkv_dt;
  a.out = out;
  a.out_dt = out_dt;
  a.out_mode = out_mode;
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
  // query splits: enough blocks for two per SM, each warp at least one
  // 8-row tile, at most four splits
  const int tiles = (n + 7) / 8, nw = NT / 32;
  const int pairs = heads * B;
  int splits = (2 * sm_count() + pairs - 1) / pairs;
  splits = std::max(1, std::min(splits, std::min(4, (tiles + nw - 1) / nw)));
  a.splits = splits;
  const size_t smem = smem_bytes(n, nk, hd);
  cudaError_t e = cudaFuncSetAttribute(
      qkv_attn_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  qkv_attn_kernel<<<dim3(heads, B, splits), NT, smem,
                    static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

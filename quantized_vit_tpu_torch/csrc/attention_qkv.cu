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
// Design: a block per (head, image, query split). A split owns a
// contiguous range of 8-row query tiles: it loads this head's q columns
// of its own rows and the k/v columns of the nk key rows
// (attention.py:_n_keys) into shared memory in the qkv dtype (bf16 or
// f32), then runs the attention core of attention_core.cuh (shared with
// K3 and K5) on its tiles. At batch 1-3 there are only 12-48 (head,
// image) pairs for 132 SMs, so the query tiles of a pair are split over
// up to four blocks, and over more where a split's rows would not fit
// shared memory (f32 at ViT-H's 272 tokens x head_dim 80); int_attention's
// q scale is the max over every query row, read from device memory.
//
// Bound on this card at ViT-B batch 2: 2.24 MB in and out (0.67 us at
// 3.35 TB/s) against 0.2 G bf16-rate attention operations: bytes. The
// attention runs in f64 on the tensor cores (bit-exact with the plain
// version), and each query split re-reads its head's k/v, so it is far
// from that bound.

#include <algorithm>

#include "attention_core.cuh"

namespace {

constexpr int NT = 256, NW = NT / 32;
constexpr int SMEM_MAX = 232448;  // bytes of shared memory a block can use

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

// query rows of one split
__host__ __device__ inline int split_rows(int n, int splits) {
  const int tiles = (n + 7) / 8;
  return (tiles + splits - 1) / splits * 8;
}

template <typename T>
size_t smem_bytes(int q_rows, int nk, int hd) {
  return (static_cast<size_t>(q_rows + nk) * qvt::att_q_stride_t<T>(hd) +
          static_cast<size_t>(nk) * qvt::att_v_stride(hd)) *
         sizeof(T);
}

// Shared memory: q [split rows][RQ] | k [nk][RQ] | v [nk][RV] (T); one
// block per SM at ViT-B and ViT-H, so the registers need not be shared
template <typename T, int HDM>
__global__ void __launch_bounds__(NT, 1) qkv_attn_kernel(Args a) {
  extern __shared__ __align__(16) int8_t smem[];
  const int n = a.n, nk = a.nk, hd = a.hd;
  const int RQ = qvt::att_q_stride_t<T>(hd), RV = qvt::att_v_stride(hd);
  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = blockIdx.z * split_rows(n, a.splits);
  const int nq = min(n - q0, split_rows(n, a.splits));
  if (nq <= 0) return;  // the whole block: a split past the last tile
  T* q_s = reinterpret_cast<T*>(smem);
  T* k_s = q_s + nq * RQ;
  T* v_s = k_s + nk * RQ;
  const int HD = a.heads * hd, W = 3 * HD;
  const long long row0 = static_cast<long long>(b) * n;
  const T* src = static_cast<const T*>(a.qkv);

  // this head's q of the split's rows and k/v of the nk key rows;
  // neighbouring threads read neighbouring columns of a row
  for (int i = threadIdx.x; i < nk * hd; i += NT) {
    const int r = i / hd, c = i - r * hd;
    const long long base = (row0 + r) * W + HD + h * hd + c;
    k_s[r * RQ + c] = src[base];
    v_s[r * RV + c] = src[base + HD];
  }
  for (int i = threadIdx.x; i < nq * hd; i += NT) {
    const int r = i / hd, c = i - r * hd;
    q_s[r * RQ + c] = src[(row0 + q0 + r) * W + h * hd + c];
  }
  __syncthreads();

  qvt::AttnArgs<T> at;
  at.q = q_s;
  at.k = k_s;
  at.v = v_s;
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
  if (a.int_attn) {
    // the q scale runs over all n query rows, the split's and the others
    float q_max = 0.f;
    for (int i = threadIdx.x; i < n * hd; i += NT) {
      const int r = i / hd, c = i - r * hd;
      q_max = fmaxf(q_max, fabsf(qvt::att_ld(src + (row0 + r) * W + h * hd +
                                             c) *
                                 a.sm_scale));
    }
    at.is = qvt::attn_int_scales(q_s, k_s, v_s, RQ, RV, 0, nk, hd,
                                 a.sm_scale, q_max);
  }
  at.out_mode = a.out_mode;
  at.out = a.out;
  at.out_dt = a.out_dt;
  at.out_stride = HD;
  at.out_row0 = row0 + q0;
  at.out_col0 = h * hd;
  at.out_d = a.prm[0];
  at.out_t = a.prm[1];
  at.out_top = a.out_top;
  qvt::attention_rows<HDM>(at, threadIdx.x >> 5, NW);
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

template <typename T, int HDM>
int launch(Args& a, cudaStream_t stream) {
  // query splits: enough blocks for two per SM, each warp at least one
  // 8-row tile, at most four; more when a split's rows overflow shared
  // memory
  const int tiles = (a.n + 7) / 8;
  const int pairs = a.heads * a.B;
  int splits = (2 * sm_count() + pairs - 1) / pairs;
  splits = std::max(1, std::min(splits, std::min(4, (tiles + NW - 1) / NW)));
  while (splits < tiles &&
         smem_bytes<T>(split_rows(a.n, splits), a.nk, a.hd) > SMEM_MAX)
    ++splits;
  a.splits = splits;
  const size_t smem = smem_bytes<T>(split_rows(a.n, splits), a.nk, a.hd);
  cudaError_t e = cudaFuncSetAttribute(
      qkv_attn_kernel<T, HDM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  qkv_attn_kernel<T, HDM><<<dim3(a.heads, a.B, splits), NT, smem, stream>>>(
      a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// out_mode: 0 int8 levels (out_pow false), 1 int8 levels of the pow
// quantizer, 2 floats in out_dt
extern "C" int qvt_attention_qkv(const void* qkv, int qkv_dt, void* out,
                                 int out_dt, int out_mode, const void* prm,
                                 int B, int n, int heads, int hd, int n_valid,
                                 int nk, float q_mul, float sm_scale,
                                 int int_attn, int out_top, void* stream) {
  if (hd > qvt::ATT_HDMAX || hd % 8 || nk > n || n_valid > nk ||
      (qkv_dt != qvt::DT_BF16 && qkv_dt != qvt::DT_F32))
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
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (qkv_dt == qvt::DT_BF16)
    return hd <= 64 ? launch<__nv_bfloat16, 64>(a, st)
                    : launch<__nv_bfloat16, 80>(a, st);
  return hd <= 64 ? launch<float, 64>(a, st) : launch<float, 80>(a, st);
}

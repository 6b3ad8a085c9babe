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
// Numerics (those of K9, which the plain version
// ops/attention.py:attention_qkv_plain mirrors): float path, q pre-scaled
// by sm_scale*log2e and rounded back to the qkv dtype, scores over the
// n_valid keys of the nk key rows, p = exp2(min(s, 100)) with no row max,
// p rounded to the qkv dtype for P.V, p_sum from f32 p plus 1e-30;
// int_attention, q*sm_scale, k and v as int8 levels with per-(image, head)
// scales over all n query rows and the nk key rows, the row max first, p
// levels round(p*127), p_sum their sum. Built with -fmad=false; sums in
// f64, rounded once to f32.
//
// Design (the block's body is qkv_attention.cuh:qkv_attn_tile, which K3
// runs on its own q/k/v scratch): a block per (tile of R query rows, head,
// image), R = 64, 32 or 16 from the wrapper
// (ops/attention.py:qkv_attn_tile_rows: among the
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
//   query rows as the first design's m8n8k4 core did. The float
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

#include "qkv_attention.cuh"

namespace {

using Args = qvt::QkvAttnArgs;
constexpr int NT = qvt::QA_NT;
enum { OUT_LEVELS = qvt::QA_OUT_LEVELS, OUT_POW = qvt::QA_OUT_POW,
       OUT_FLOAT = qvt::QA_OUT_FLOAT };

// the largest instantiation, with the static scale reduction and scales
// and the 1 KB the card reserves a block: two blocks fit an H100 SM's
// 233,472 bytes
static_assert(2 * (qvt::qkv_attn_smem(64, qvt::QA_HDMAX, 4) +
                   qvt::QA_STATIC + 1024) <= 233472,
              "two blocks of K6 fit an SM");

// the body is qvt::qkv_attn_tile (qkv_attention.cuh), shared with K3
template <typename T, int R, int HDM>
__global__ void __launch_bounds__(NT, 2) qkv_attn_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  qvt::PhaseClock clk;
  clk.begin();
  qvt::qkv_attn_tile<T, R, HDM, true, false>(a, blockIdx.x * R, blockIdx.y,
                                             blockIdx.z, smem, clk);
  clk.store((blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x);
}

template <typename T, int R, int HDM>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  auto kern = qkv_attn_kernel<T, R, HDM>;
  constexpr int smem = qvt::qkv_attn_smem(R, HDM, sizeof(T));
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
  if (hd > qvt::QA_HDMAX || hd % 8 || nk > n || n_valid > nk ||
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

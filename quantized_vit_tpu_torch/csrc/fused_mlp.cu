// K2: whole transformer-MLP residual branch for Hopper (sm_90a).
//
// Replaces the TPU kernel quantized_vit_tpu/ops/fused.py:_fused_mlp_kernel
// (pallas_call in _fused_mlp, fused.py:977):
//   out = x + fc2(quant(GELU(fc1(quant(LN(x))))))
// The TPU kernel keeps both weights resident in VMEM (4.7 MB int8 at
// ViT-B); 227 KB of shared memory cannot, so this kernel follows the
// structure of _fused_mlp_chunked_kernel (fused.py:703-776): each block
// owns 32 rows and walks the hidden dimension in chunks of 32 units
// (fused_mlp_core.cuh, which K15 in ring_gather.cu shares).
//
// Bound on this card at ViT-B batch 32 (M = 6656): 62.8 G int8 ops over
// 1,979 TOPS = 31.7 us, against ~25 MB moved (~7.5 us): compute-bound.
// This first version uses mma.sync with synchronous shared-memory fills
// and no TMA/wgmma; each 32-row block re-reads both weights (4.7 MB at
// ViT-B, int8) from L2, about 1 GB per call at batch 32.

#include "fused_mlp_core.cuh"

namespace {

template <int TN2>
__global__ void __launch_bounds__(qvt_mlp::NT)
    mlp_kernel(qvt_mlp::Args a) {
  extern __shared__ __align__(16) int8_t smem[];
  qvt_mlp::mlp_rows<TN2>(a, blockIdx.x, smem);
}

template <int TN2>
int launch(const qvt_mlp::Args& a, cudaStream_t stream) {
  const size_t smem = qvt_mlp::smem_bytes<TN2>(a);
  cudaError_t e = cudaFuncSetAttribute(
      mlp_kernel<TN2>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  mlp_kernel<TN2><<<qvt_mlp::row_blocks(a), qvt_mlp::NT, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int qvt_fused_mlp(const void* x, int x_dt, const void* w1,
                             int w1_int4, const void* s1, const void* b1,
                             const void* w2, int w2_int4, const void* s2,
                             const void* b2, const void* ln_g,
                             const void* ln_b, const void* prm, void* out,
                             int out_dt, int M, int K, int H, int act_pow,
                             int hid_pow, int act_top, int hid_top,
                             float eps, void* stream) {
  const qvt_mlp::Args a = qvt_mlp::make_args(
      x, x_dt, w1, w1_int4, s1, b1, w2, w2_int4, s2, b2, ln_g, ln_b, prm,
      out, out_dt, M, K, H, act_pow, hid_pow, act_top, hid_top, eps);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (qvt_mlp::tn2_of(a)) {
    case 4: return launch<4>(a, st);
    case 8: return launch<8>(a, st);
    case 12: return launch<12>(a, st);
    case 16: return launch<16>(a, st);
    default: return static_cast<int>(cudaErrorInvalidValue);  // K > 1024
  }
}

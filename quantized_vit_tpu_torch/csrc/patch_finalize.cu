// K4: patch-embed finalization for Hopper (sm_90a).
//
// Replaces the TPU kernel quantized_vit_tpu/ops/patch.py:
// _patch_finalize_kernel (pallas_call in patch_finalize, patch.py:52).
// Writes the padded token stream [B*n_pad, D] in the residual dtype:
//   rows 0..P-1 : acc*scale + pos_patch
//   row  P      : cls_row
//   rows P+1..  : 0
//
// A pure element-wise pass with no tensor-core work: bound by the bytes
// it moves (acc f32 read once, out written once; ~30 MB at batch 32 with a
// bf16 stream, ~9 us at 3.35 TB/s). One grid-stride loop, each thread
// handling 4 consecutive features of a row; pos_patch and cls_row stay in
// L2.

#include "qvt_common.cuh"

namespace {

__global__ void pf_kernel(const float* __restrict__ acc,
                          const float* __restrict__ pos,
                          const float* __restrict__ cls,
                          const float* __restrict__ scale, void* out,
                          int out_dt, int B, int P, int D, int n_pad) {
  const float s = scale[0];
  const int dq = (D + 3) / 4;
  const long long total = static_cast<long long>(B) * n_pad * dq;
  for (long long idx = blockIdx.x * static_cast<long long>(blockDim.x) +
                       threadIdx.x;
       idx < total; idx += static_cast<long long>(gridDim.x) * blockDim.x) {
    const int d0 = static_cast<int>(idx % dq) * 4;
    const long long row = idx / dq;
    const int r = static_cast<int>(row % n_pad);
    const int b = static_cast<int>(row / n_pad);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int d = d0 + u;
      if (d >= D) break;
      float v;
      if (r < P)
        v = acc[(static_cast<long long>(b) * P + r) * D + d] * s +
            pos[static_cast<long long>(r) * D + d];
      else if (r == P)
        v = cls[d];
      else
        v = 0.f;
      qvt::store_f(out, out_dt, row * D + d, v);
    }
  }
}

}  // namespace

extern "C" int qvt_patch_finalize(const void* acc, const void* pos,
                                  const void* cls, const void* scale,
                                  void* out, int out_dt, int B, int P, int D,
                                  int n_pad, void* stream) {
  const long long total = static_cast<long long>(B) * n_pad * ((D + 3) / 4);
  const int nt = 256;
  long long blocks = (total + nt - 1) / nt;
  if (blocks > 132 * 16) blocks = 132 * 16;
  pf_kernel<<<static_cast<int>(blocks), nt, 0,
              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(acc), static_cast<const float*>(pos),
      static_cast<const float*>(cls), static_cast<const float*>(scale), out,
      out_dt, B, P, D, n_pad);
  return static_cast<int>(cudaGetLastError());
}

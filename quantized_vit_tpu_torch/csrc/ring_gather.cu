// K14 gather_rows for Hopper (sm_90a): the in-kernel weight all-gather of
// FSDP serving.
//
// Replaces quantized_vit_tpu/ops/ring_gather.py:gather_rows (pallas_call
// at :154; _gather_start/_gather_wait :81-128). K15, the same gather
// inside the MLP launch (fused_mlp_gather, pallas_call at :314), is K2's
// kernel with a copy (fused_mlp.cu); both copy the jobs of copy_jobs.cuh.
//
// The TPU kernel's neighbour barrier and byte-counting semaphores have no
// counterpart in here: two processes that share one card time-slice, and
// a kernel spinning on a flag another process sets can stall for a whole
// slice. The wrapper orders the launches instead (interprocess events and
// a host barrier before the launch, and again after it before anyone
// reads the gathered buffers).
//
// Bound on this card: K14 moves its bytes twice (read + write): ViT-B's
// four int8 block weights, 7.08 MB, take >= 4.2 us at 3.35 TB/s. Its grid
// is one block of 256 threads per 64 KB moved, at most one an SM
// (ops/ring_gather.py), every thread on 16-byte pieces.

#include "copy_jobs.cuh"

namespace {

constexpr int CT = 256;

__global__ void __launch_bounds__(CT) gather_kernel(qvt::Jobs jb) {
  qvt::copy_jobs(jb, blockIdx.x, gridDim.x, CT);
}

}  // namespace

// K14: n_blocks blocks copy the jobs (host arrays of pointers and sizes)
extern "C" int qvt_gather_rows(const long long* src, const long long* dst,
                               const long long* bytes, int n_jobs,
                               int n_blocks, void* stream) {
  qvt::Jobs jb;
  const int err = qvt::fill_jobs(jb, src, dst, bytes, n_jobs);
  if (err) return err;
  if (n_jobs == 0) return 0;
  gather_kernel<<<n_blocks, CT, 0, static_cast<cudaStream_t>(stream)>>>(jb);
  return static_cast<int>(cudaGetLastError());
}

// K14 gather_rows and K15 fused_mlp_gather for Hopper (sm_90a): the
// in-kernel weight all-gather of FSDP serving.
//
// Replace quantized_vit_tpu/ops/ring_gather.py:gather_rows (pallas_call at
// :154; _gather_start/_gather_wait :81-128) and :fused_mlp_gather
// (pallas_call at :314; _mlp_gather_kernel :176).
//
// A gather is a list of copy jobs (src, dst, bytes) handed over by value
// in the kernel's parameters: each of this process's row shards into its
// own row slot of its output (rank * bytes into the buffer) and into the
// same slot of every peer's output, through the pointers that CUDA IPC
// mapped into this process (ops/ring_gather.py plans them). The bytes
// are copied opaquely (int8 levels, packed int4, bf16), 16 bytes a thread
// where source, destination and length allow it, else byte by byte. The
// TPU kernel's neighbour barrier and byte-counting semaphores have no
// counterpart in here: two processes that share one card time-slice, and
// a kernel spinning on a flag another process sets can stall for a whole
// slice. The wrapper orders the launches instead (interprocess events and
// a host barrier before the launch, and again after it before anyone
// reads the gathered buffers).
//
// K15 is one launch whose first row_blocks(M) blocks run MLP row blocks
// (fused_mlp_core.cuh, K2's first design; K2 itself, fused_mlp.cu, now
// computes the same bits in three phases) and
// whose last blocks run the copy jobs of the next block's shards. Blocks
// start in index order, so the copy blocks take the SMs the MLP's last
// wave leaves idle (at ViT-B batch 32: 208 row blocks, one per SM, on 132
// SMs).
//
// Bounds on this card: K14 moves its bytes twice (read + write): ViT-B's
// four int8 block weights, 7.08 MB, take >= 4.2 us at 3.35 TB/s. K15 is
// bounded by K2's operations (31.7 us at ViT-B batch 32); its copy is
// ~0.5% of that. The row blocks keep an fc2 accumulator [32, K] in
// registers, so K15 takes K <= 1024 (ops/ring_gather.py:
// mlp_gather_kernel_limit).

#include "fused_mlp_core.cuh"

namespace {

constexpr int MAX_JOBS = 64, CT = 256;

struct Jobs {
  const int8_t* src[MAX_JOBS];
  int8_t* dst[MAX_JOBS];
  long long bytes[MAX_JOBS];
  int n;
};

// the copy jobs, spread over blocks [0, nb) of the copy part of the grid
__device__ __forceinline__ void copy_jobs(const Jobs& jb, int b, int nb) {
  const long long tid = static_cast<long long>(b) * CT + threadIdx.x;
  const long long stride = static_cast<long long>(nb) * CT;
  for (int j = 0; j < jb.n; ++j) {
    const int8_t* s = jb.src[j];
    int8_t* d = jb.dst[j];
    const long long n = jb.bytes[j];
    const bool vec = ((reinterpret_cast<uintptr_t>(s) |
                       reinterpret_cast<uintptr_t>(d)) & 15) == 0;
    const long long n16 = vec ? n / 16 : 0;
    const uint4* s4 = reinterpret_cast<const uint4*>(s);
    uint4* d4 = reinterpret_cast<uint4*>(d);
    for (long long i = tid; i < n16; i += 4 * stride) {
      // four 16-byte loads in flight before the stores
      uint4 v[4];
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (i + u * stride < n16) v[u] = __ldcs(s4 + i + u * stride);
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (i + u * stride < n16) __stcs(d4 + i + u * stride, v[u]);
    }
    for (long long i = n16 * 16 + tid; i < n; i += stride) d[i] = s[i];
  }
}

__global__ void __launch_bounds__(CT) gather_kernel(Jobs jb) {
  copy_jobs(jb, blockIdx.x, gridDim.x);
}

template <int TN2>
__global__ void __launch_bounds__(qvt_mlp::NT)
    mlp_gather_kernel(qvt_mlp::Args a, Jobs jb, int n_mlp) {
  extern __shared__ __align__(16) int8_t smem[];
  if (static_cast<int>(blockIdx.x) < n_mlp)
    qvt_mlp::mlp_rows<TN2>(a, blockIdx.x, smem);
  else
    copy_jobs(jb, blockIdx.x - n_mlp, gridDim.x - n_mlp);
}

template <int TN2>
int launch_mlp_gather(const qvt_mlp::Args& a, const Jobs& jb, int n_mlp,
                      int n_copy, cudaStream_t stream) {
  const size_t smem = qvt_mlp::smem_bytes<TN2>(a);
  cudaError_t e = cudaFuncSetAttribute(
      mlp_gather_kernel<TN2>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  mlp_gather_kernel<TN2><<<n_mlp + n_copy, qvt_mlp::NT, smem, stream>>>(
      a, jb, n_mlp);
  return static_cast<int>(cudaGetLastError());
}

int fill_jobs(Jobs& jb, const long long* src, const long long* dst,
              const long long* bytes, int n_jobs) {
  if (n_jobs < 0 || n_jobs > MAX_JOBS)
    return static_cast<int>(cudaErrorInvalidValue);
  jb.n = n_jobs;
  for (int j = 0; j < n_jobs; ++j) {
    jb.src[j] = reinterpret_cast<const int8_t*>(src[j]);
    jb.dst[j] = reinterpret_cast<int8_t*>(dst[j]);
    jb.bytes[j] = bytes[j];
  }
  return 0;
}

}  // namespace

// K14: n_blocks blocks copy the jobs (host arrays of pointers and sizes)
extern "C" int qvt_gather_rows(const long long* src, const long long* dst,
                               const long long* bytes, int n_jobs,
                               int n_blocks, void* stream) {
  Jobs jb;
  const int err = fill_jobs(jb, src, dst, bytes, n_jobs);
  if (err) return err;
  if (n_jobs == 0) return 0;
  gather_kernel<<<n_blocks, CT, 0, static_cast<cudaStream_t>(stream)>>>(jb);
  return static_cast<int>(cudaGetLastError());
}

// K15: K2's arguments, then the copy jobs and the number of copy blocks
extern "C" int qvt_fused_mlp_gather(
    const void* x, int x_dt, const void* w1, const void* s1, const void* b1,
    const void* w2, const void* s2, const void* b2, const void* ln_g,
    const void* ln_b, const void* prm, void* out, int out_dt, int M, int K,
    int H, int act_pow, int hid_pow, int act_top, int hid_top, float eps,
    const long long* src, const long long* dst, const long long* bytes,
    int n_jobs, int n_copy, void* stream) {
  Jobs jb;
  const int err = fill_jobs(jb, src, dst, bytes, n_jobs);
  if (err) return err;
  // int8 weights only (ring_gather.py:229-232)
  const qvt_mlp::Args a = qvt_mlp::make_args(
      x, x_dt, w1, 0, s1, b1, w2, 0, s2, b2, ln_g, ln_b, prm, out, out_dt,
      M, K, H, act_pow, hid_pow, act_top, hid_top, eps);
  const int n_mlp = qvt_mlp::row_blocks(a);
  if (n_jobs == 0) n_copy = 0;
  if (n_mlp + n_copy == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (qvt_mlp::tn2_of(a)) {
    case 4: return launch_mlp_gather<4>(a, jb, n_mlp, n_copy, st);
    case 8: return launch_mlp_gather<8>(a, jb, n_mlp, n_copy, st);
    case 12: return launch_mlp_gather<12>(a, jb, n_mlp, n_copy, st);
    case 16: return launch_mlp_gather<16>(a, jb, n_mlp, n_copy, st);
    default: return static_cast<int>(cudaErrorInvalidValue);  // K > 1024
  }
}

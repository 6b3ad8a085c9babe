// K7: the fused single-pass backward of the LSFQ nonlinear quantizer, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel quantized_vit_tpu/ops/quant_vjp.py:_bwd_kernel
// (pallas_call in lsfq_nonlinear_bwd_fused, quant_vjp.py:172). One read of
// (x, g) gives
//   grad_x = where(x >= clip_hi | x <= clip_lo, 0, g)      (clipped STE)
// and the three scalar gradients of the quantizer's (d, q_m, t)
//   grad_d  = sum(g * sgn * gd)
//   grad_qm = sum(g * gqm)
//   grad_t  = sum(g * sgn * gt)
// with the terms and mask precedence of quant/lsfq.py:_nonlinear_bwd
// (:82-102). d, q_m and t are read from device memory (they are learnable
// and change every step; a host read would stall the stream at every
// quantizer site); clip_lo, clip_hi and q_s are constants of the layer.
//
// Bound: the bytes it moves, 12 per element (x and g read, grad_x
// written): 69.4 us for the [6304, 3072] fc2 activation of ViT-B/16 at
// batch 32 at 3.35 TB/s. The TPU kernel walked row tiles in order and
// carried the sums in SMEM from one grid step to the next; here blocks run
// in no order, so the sums take two stages in a fixed order, which makes
// them the same from run to run: each block walks its share of the
// flattened elements grid-stride with 16-byte loads (a scalar tail for a
// count not divisible by 4, or a scalar walk for an unaligned tensor),
// adds each f32 term to an f64 partial, and reduces its threads' partials
// in shared memory; a second one-block launch sums the per-block partials
// and rounds each sum once to f32. The grid depends on the element count
// only. The plain version (ops/quant_vjp.py) takes the same f32 terms and
// sums them in f64.
//
// Numerics: compiled with -fmad=false (no contraction, so every product
// and sum rounds as PyTorch's separate ops do); round is rintf (half to
// even, as torch.round); logf/expf/IEEE division as PyTorch's CUDA ops.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr float kEps = 1e-6f;        // quant/lsfq.py:_EPS
constexpr float kLogGuard = 1e-30f;  // _safe_pow's clamp

struct Scalars {
  float d, q_m, t, q_s, clip_lo, clip_hi;
  float range_pow, log_range, gd_top, gqm_top;
};

__device__ __forceinline__ Scalars load_scalars(const float* d_p,
                                                const float* qm_p,
                                                const float* t_p, float q_s,
                                                float clip_lo,
                                                float clip_hi) {
  Scalars s;
  s.d = *d_p;
  s.q_m = *qm_p;
  s.t = *t_p;
  s.q_s = q_s;
  s.clip_lo = clip_lo;
  s.clip_hi = clip_hi;
  // _safe_pow(|q_m - q_s| + eps, t) and (..., t - 1); the base is >= eps
  const float range_abs = fabsf(s.q_m - s.q_s) + kEps;
  s.log_range = logf(fmaxf(range_abs, kLogGuard));
  s.range_pow = expf(s.t * s.log_range);
  const float range_pow_low = expf((s.t - 1.0f) * s.log_range);
  const float r = s.range_pow / s.d;
  s.gd_top = rintf(r) - r;
  s.gqm_top = s.t * range_pow_low;
  return s;
}

// one element: writes grad_x, adds its three f32 terms to the partials
__device__ __forceinline__ float element(float x, float g, const Scalars& s,
                                         double& pd, double& pqm,
                                         double& pt) {
  const float x_abs = fabsf(x);
  const float sgn = x > 0.f ? 1.f : (x < 0.f ? -1.f : 0.f);
  const float log_in = logf(fmaxf(x_abs - s.q_s, kLogGuard));
  const float input_pow = expf(s.t * log_in);
  const float r = input_pow / s.d;
  float gd = rintf(r) - r;
  float gt = input_pow * log_in;
  if (x_abs >= s.q_m) {
    gd = s.gd_top;
    gt = s.range_pow * s.log_range;
  }
  if (x_abs <= s.q_s) {  // applied last: wins on overlap (q_m <= q_s)
    gd = 0.f;
    gt = 0.f;
  }
  const float gqm = x_abs <= s.q_m ? 0.f : sgn * s.gqm_top;
  const float gs = g * sgn;
  pd += static_cast<double>(gs * gd);
  pqm += static_cast<double>(g * gqm);
  pt += static_cast<double>(gs * gt);
  return (x >= s.clip_hi || x <= s.clip_lo) ? 0.f : g;
}

__device__ __forceinline__ double block_sum(double v, double* sh) {
  sh[threadIdx.x] = v;
  __syncthreads();
  for (int w = kThreads / 2; w > 0; w >>= 1) {
    if (threadIdx.x < w) sh[threadIdx.x] += sh[threadIdx.x + w];
    __syncthreads();
  }
  const double out = sh[0];
  __syncthreads();
  return out;
}

// (the kernels' names start with quant_bwd: a profiler trace finds them so)
__global__ void __launch_bounds__(kThreads)
    quant_bwd_kernel(const float* __restrict__ x, const float* __restrict__ g,
               float* __restrict__ gx, const float* __restrict__ d_p,
               const float* __restrict__ qm_p, const float* __restrict__ t_p,
               float q_s, float clip_lo, float clip_hi, long long n, int vec,
               double* __restrict__ partials) {
  __shared__ double sh[kThreads];
  const Scalars s = load_scalars(d_p, qm_p, t_p, q_s, clip_lo, clip_hi);
  double pd = 0.0, pqm = 0.0, pt = 0.0;
  const long long tid =
      blockIdx.x * static_cast<long long>(kThreads) + threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  long long done = 0;
  if (vec) {
    const long long n4 = n / 4;
    const float4* x4 = reinterpret_cast<const float4*>(x);
    const float4* g4 = reinterpret_cast<const float4*>(g);
    float4* gx4 = reinterpret_cast<float4*>(gx);
    for (long long i = tid; i < n4; i += stride) {
      const float4 xv = x4[i];
      const float4 gv = g4[i];
      float4 o;
      o.x = element(xv.x, gv.x, s, pd, pqm, pt);
      o.y = element(xv.y, gv.y, s, pd, pqm, pt);
      o.z = element(xv.z, gv.z, s, pd, pqm, pt);
      o.w = element(xv.w, gv.w, s, pd, pqm, pt);
      gx4[i] = o;
    }
    done = n4 * 4;
  }
  for (long long i = done + tid; i < n; i += stride)
    gx[i] = element(x[i], g[i], s, pd, pqm, pt);
  pd = block_sum(pd, sh);
  pqm = block_sum(pqm, sh);
  pt = block_sum(pt, sh);
  if (threadIdx.x == 0) {
    partials[blockIdx.x] = pd;
    partials[gridDim.x + blockIdx.x] = pqm;
    partials[2 * gridDim.x + blockIdx.x] = pt;
  }
}

// one block: the per-block partials summed in a fixed order, rounded once
__global__ void __launch_bounds__(kThreads)
    quant_bwd_finish(const double* __restrict__ partials, int blocks,
                     float* __restrict__ out) {
  __shared__ double sh[kThreads];
  for (int r = 0; r < 3; ++r) {
    double v = 0.0;
    for (int i = threadIdx.x; i < blocks; i += kThreads)
      v += partials[r * blocks + i];
    v = block_sum(v, sh);
    if (threadIdx.x == 0) out[r] = static_cast<float>(v);
  }
}

}  // namespace

// x, g, gx: n f32 elements (contiguous); d, q_m, t: one f32 each on the
// device; out: 3 f32 (grad_d, grad_q_m, grad_t); partials: 3 * blocks f64
// scratch. vec: x, g and gx are 16-byte aligned.
extern "C" int qvt_quant_bwd(const void* x, const void* g, void* gx,
                             const void* d, const void* q_m, const void* t,
                             float q_s, float clip_lo, float clip_hi,
                             long long n, int vec, int blocks,
                             void* partials, void* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  quant_bwd_kernel<<<blocks, kThreads, 0, st>>>(
      static_cast<const float*>(x), static_cast<const float*>(g),
      static_cast<float*>(gx), static_cast<const float*>(d),
      static_cast<const float*>(q_m), static_cast<const float*>(t), q_s,
      clip_lo, clip_hi, n, vec, static_cast<double*>(partials));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  quant_bwd_finish<<<1, kThreads, 0, st>>>(
      static_cast<const double*>(partials), blocks, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

// Shared device code of the serving kernels: element loads and stores,
// the exact f32 level math of quantized_vit_tpu/ops/fused.py, and the
// int8 tensor-core tile product (mma.sync m16n8k32 s8 x s8 -> s32).
//
// Numerics: every file is compiled with -fmad=false, so a*b+c rounds twice
// as the plain PyTorch version's separate ops do. Rounding is rintf
// (half to even, as torch.round / jnp.round), never roundf. The LayerNorm
// inverse root is 1.0f / sqrtf(v): both correctly rounded (rsqrtf is
// approximate). erf is the odd polynomial of fused.py:_erf_f32, by Horner;
// erff is never used.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace qvt {

// element-type codes (ops/_build.py:DTYPE_CODE)
enum { DT_INT8 = 0, DT_F32 = 1, DT_BF16 = 2 };

__device__ __forceinline__ float load_f(const void* p, int dt, long long i) {
  if (dt == DT_F32) return static_cast<const float*>(p)[i];
  if (dt == DT_BF16)
    return __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i]);
  return static_cast<float>(static_cast<const int8_t*>(p)[i]);
}

// element e of a 16-byte piece of bf16 (8) or f32 (4) values
__device__ __forceinline__ float piece_at(const uint4& u, bool bf, int e) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
  if (!bf) return __uint_as_float(w[e]);
  return __uint_as_float(e & 1 ? w[e >> 1] & 0xFFFF0000u : w[e >> 1] << 16);
}

__device__ __forceinline__ void store_f(void* p, int dt, long long i,
                                        float v) {
  if (dt == DT_F32)
    static_cast<float*>(p)[i] = v;
  else
    static_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16_rn(v);
}

// v rounded to the element type dt (bf16: round to nearest even)
__device__ __forceinline__ float round_to(float v, int dt) {
  return dt == DT_BF16 ? __bfloat162float(__float2bfloat16_rn(v)) : v;
}

__device__ __forceinline__ int8_t clip_round(float v, float top) {
  float r = rintf(v);
  r = fminf(fmaxf(r, -top), top);
  return static_cast<int8_t>(static_cast<int>(r));
}

// fused.py:_quantize_f32
__device__ __forceinline__ int8_t quantize(float x, float d, float t,
                                           float top, bool pow_map,
                                           bool folded) {
  if (pow_map) {
    float p = expf(t * logf(fmaxf(fabsf(x), 1e-30f)));
    float lv = fminf(rintf(p / d), top);
    float s = x > 0.f ? 1.f : (x < 0.f ? -1.f : 0.f);
    return static_cast<int8_t>(static_cast<int>(s * lv));
  }
  if (folded) return clip_round(x, top);
  return clip_round(x * (1.0f / d), top);
}

// int4_matmul.py:_fa_quant, K12's quantizer: sign(x) * min(rint(p / d),
// top), p = |x| or exp(t * log(max(|x|, 1e-30))), a true division (the
// linear branch of quantize multiplies by 1/d)
__device__ __forceinline__ int8_t fa_quant(float x, float d, float t,
                                           float top, bool pow_map) {
  const float ax = fabsf(x);
  const float p = pow_map ? expf(t * logf(fmaxf(ax, 1e-30f))) : ax;
  const float lv = fminf(rintf(p / d), top);
  const float s = x > 0.f ? 1.f : (x < 0.f ? -1.f : 0.f);
  return static_cast<int8_t>(static_cast<int>(s * lv));
}

// fused.py:_erf_f32 (clamped odd polynomial, Horner in f32)
__device__ __forceinline__ float erf_poly(float x) {
  float v = fminf(fmaxf(x, -3.0f), 3.0f);
  float v2 = v * v;
  float acc = 1.6343068626e-04f;
  acc = acc * v2 + -4.6024812456e-03f;
  acc = acc * v2 + 5.0755384214e-02f;
  acc = acc * v2 + -2.8632930819e-01f;
  acc = acc * v2 + 1.0820510812e+00f;
  return acc * v;
}

// fused.py:_gelu_f32
__device__ __forceinline__ float gelu(float x) {
  return x * 0.5f * (1.0f + erf_poly(x * 0.70710678118654752f));
}

// gelu_quant_folded at c2 = 0.70710678118654757f / d, divided once by a
// caller that quantizes many values with one d
__device__ __forceinline__ int8_t gelu_quant_folded_c2(float z, float c2,
                                                       float top) {
  float e = erf_poly(z);
  float w = z * c2;
  return clip_round(w + w * e, top);
}

// fused.py:_gelu_quant_folded: levels of GELU(y)/d from z = y/sqrt(2)
__device__ __forceinline__ int8_t gelu_quant_folded(float z, float d,
                                                    float top) {
  return gelu_quant_folded_c2(z, 0.70710678118654757f / d, top);
}

// four packed nibbles (one per byte, in the low half) sign-extended to
// four int8 bytes: (u ^ 8) - 8 per byte
__device__ __forceinline__ uint32_t sext_nib4(uint32_t x) {
  return __vsub4(x ^ 0x08080808u, 0x08080808u);
}

// the low (hi = false) or high nibbles of four packed bytes, as levels
__device__ __forceinline__ uint32_t nibbles(uint32_t p, bool hi) {
  return sext_nib4((hi ? p >> 4 : p) & 0x0F0F0F0Fu);
}

// A weight of K x N levels, stored transposed ("n-major", k contiguous:
// the layout of the mma B operand): int8 wt[n][k], or packed int4
// wt[n][k'] = W[k', n] & 0xF | W[k' + K/2, n] << 4 for k' < K/2 (the
// transpose of quant/packing.py's [K/2, N] layout). 0 outside.
struct WeightT {
  const int8_t* wt;
  int K, N, int4;
  __device__ __forceinline__ int8_t at(int k, int n) const {
    if (k >= K || n >= N || k < 0 || n < 0) return 0;
    if (!int4) return wt[static_cast<long long>(n) * K + k];
    const int half = K >> 1;
    if (k < half) {
      int8_t p = wt[static_cast<long long>(n) * half + k];
      return static_cast<int8_t>(static_cast<int8_t>(p << 4) >> 4);
    }
    int8_t p = wt[static_cast<long long>(n) * half + k - half];
    return static_cast<int8_t>(p >> 4);
  }
  // the 16-byte path: K % 16 == 0, (int4) (K/2) % 16 == 0, aligned base
  __device__ __forceinline__ bool vec_ok() const {
    return K % 16 == 0 && (!int4 || (K / 2) % 16 == 0) &&
           (reinterpret_cast<uintptr_t>(wt) & 15) == 0;
  }
  // levels W[k..k+15, n] as 16 bytes (k % 16 == 0); zeros outside
  __device__ __forceinline__ uint4 vec16(int k, int n) const {
    if (k >= K || n >= N || k < 0 || n < 0) return make_uint4(0u, 0u, 0u, 0u);
    if (!int4)
      return __ldg(reinterpret_cast<const uint4*>(
          wt + static_cast<long long>(n) * K + k));
    const int half = K >> 1;
    const bool hi = k >= half;
    const uint4 p = __ldg(reinterpret_cast<const uint4*>(
        wt + static_cast<long long>(n) * half + (hi ? k - half : k)));
    return make_uint4(nibbles(p.x, hi), nibbles(p.y, hi), nibbles(p.z, hi),
                      nibbles(p.w, hi));
  }
};

// 16 bytes global -> shared without passing through registers; a false
// `valid` writes zeros (src-size 0, nothing is read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void mma_s8(int (&c)[4], uint32_t a0, uint32_t a1,
                                       uint32_t a2, uint32_t a3, uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// One warp's share of a tile product over a shared-memory chunk of depth
// bk (a multiple of 32). As: rows x k bytes, row stride sa; Bs: cols x k
// bytes (the weight transposed), row stride sb. The warp accumulates TM
// m16 tiles from row m0 and TN n8 tiles from column n0. Accumulator
// element r of tile (i, j) is row m0 + 16i + lane/4 + 8*(r >= 2), column
// n0 + 8j + 2*(lane%4) + (r & 1).
template <int TM, int TN>
__device__ __forceinline__ void warp_mma(int (&acc)[TM][TN][4],
                                         const int8_t* As, int sa,
                                         const int8_t* Bs, int sb, int bk,
                                         int m0, int n0, int lane) {
  const int g = lane >> 2, t = lane & 3;
  for (int kk = 0; kk < bk; kk += 32) {
    uint32_t a[TM][4], b[TN][2];
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int8_t* p = As + (m0 + i * 16 + g) * sa + kk + t * 4;
      a[i][0] = *reinterpret_cast<const uint32_t*>(p);
      a[i][1] = *reinterpret_cast<const uint32_t*>(p + 8 * sa);
      a[i][2] = *reinterpret_cast<const uint32_t*>(p + 16);
      a[i][3] = *reinterpret_cast<const uint32_t*>(p + 8 * sa + 16);
    }
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int8_t* p = Bs + (n0 + j * 8 + g) * sb + kk + t * 4;
      b[j][0] = *reinterpret_cast<const uint32_t*>(p);
      b[j][1] = *reinterpret_cast<const uint32_t*>(p + 16);
    }
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j)
        mma_s8(acc[i][j], a[i][0], a[i][1], a[i][2], a[i][3], b[j][0],
               b[j][1]);
  }
}

template <int TM, int TN>
__device__ __forceinline__ void zero_acc(int (&acc)[TM][TN][4]) {
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0;
}

// The fills below work in batches of FB loop iterations: every load of a
// batch is issued before any shared-memory store, so a thread keeps FB
// loads in flight.
constexpr int FB = 4;

// Fill a rows x bk int8 tile (row stride s) from level(r, k); each thread
// writes 4 consecutive k as one word.
template <class F>
__device__ __forceinline__ void fill_rows(int8_t* S, int rows, int s, int bk,
                                          F level) {
  const int kq = bk >> 2, total = rows * kq, step = blockDim.x;
  for (int base = threadIdx.x; base < total; base += FB * step) {
    uint32_t v[FB];
#pragma unroll
    for (int b = 0; b < FB; ++b) {
      const int idx = base + b * step;
      const int r = idx / kq, c = (idx - r * kq) * 4;
      v[b] = 0;
      if (idx < total) {
#pragma unroll
        for (int u = 0; u < 4; ++u)
          v[b] |= static_cast<uint32_t>(static_cast<uint8_t>(level(r, c + u)))
                  << (8 * u);
      }
    }
#pragma unroll
    for (int b = 0; b < FB; ++b) {
      const int idx = base + b * step;
      if (idx < total) {
        const int r = idx / kq, c = (idx - r * kq) * 4;
        *reinterpret_cast<uint32_t*>(S + r * s + c) = v[b];
      }
    }
  }
}

// Fill a rows x bk int8 tile (row stride s, a multiple of 16) with 16-byte
// pieces piece(r, c) (c % 16 == 0): rows of a k-contiguous source are
// copied as whole 16-byte loads, neighbouring threads on neighbouring
// pieces. Needs bk % 16 == 0.
template <class P>
__device__ __forceinline__ void fill_rows16(int8_t* S, int rows, int s,
                                            int bk, P piece) {
  const int cq = bk >> 4, total = rows * cq, step = blockDim.x;
  for (int base = threadIdx.x; base < total; base += FB * step) {
    uint4 v[FB];
#pragma unroll
    for (int b = 0; b < FB; ++b) {
      const int idx = base + b * step;
      const int r = idx / cq, c = (idx - r * cq) * 16;
      v[b] = idx < total ? piece(r, c) : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int b = 0; b < FB; ++b) {
      const int idx = base + b * step;
      if (idx >= total) break;
      const int r = idx / cq, c = (idx - r * cq) * 16;
      *reinterpret_cast<uint4*>(S + r * s + c) = v[b];
    }
  }
}

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Fast-variance LayerNorm statistics (fused.py:_layernorm_f32) of `rows`
// rows of x (row stride K) starting at row0, one warp per row: mu and
// 1/sqrt(max(E[x^2] - mu^2, 0) + eps). The sums run in f64 and round once
// to f32 (ops/fused.py:sum_f32), so any summation order gives the plain
// version's value. Rows past M get mu = 0, rs = 0.
__device__ __forceinline__ void ln_stats(const void* x, int dt, long long row0,
                                         int rows, int M_left, int K,
                                         float eps, float* s_mu,
                                         float* s_rs) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  const float inv_k = 1.0f / static_cast<float>(K);
  // 16-byte loads (8 bf16 or 4 f32 per lane) when rows allow them
  const bool aligned = (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  const bool v_bf16 = dt == DT_BF16 && K % 8 == 0 && aligned;
  const bool v_f32 = dt == DT_F32 && K % 4 == 0 && aligned;
  for (int r = warp; r < rows; r += nw) {
    double s = 0.0, s2 = 0.0;
    // squares are taken in f32, as the plain version does
    auto add = [&](float v) {
      s += static_cast<double>(v);
      s2 += static_cast<double>(v * v);
    };
    if (r < M_left) {
      const long long base = (row0 + r) * K;
      if (v_bf16) {
        const uint4* p = reinterpret_cast<const uint4*>(
            static_cast<const __nv_bfloat16*>(x) + base);
        for (int q = lane; q < K / 8; q += 32) {
          const uint4 u = __ldg(p + q);
          const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            add(__uint_as_float(w[i] << 16));
            add(__uint_as_float(w[i] & 0xFFFF0000u));
          }
        }
      } else if (v_f32) {
        const uint4* p = reinterpret_cast<const uint4*>(
            static_cast<const float*>(x) + base);
        for (int q = lane; q < K / 4; q += 32) {
          const uint4 u = __ldg(p + q);
          add(__uint_as_float(u.x));
          add(__uint_as_float(u.y));
          add(__uint_as_float(u.z));
          add(__uint_as_float(u.w));
        }
      } else {
        for (int k = lane; k < K; k += 32) add(load_f(x, dt, base + k));
      }
    }
    s = warp_sum(s);
    s2 = warp_sum(s2);
    if (lane == 0) {
      float mu = static_cast<float>(s) * inv_k;
      float var = fmaxf(static_cast<float>(s2) * inv_k - mu * mu, 0.f);
      s_mu[r] = mu;
      s_rs[r] = r < M_left ? 1.0f / sqrtf(var + eps) : 0.f;
    }
  }
}

}  // namespace qvt

// Phase stamps (tools/phase_probe.py builds with -DQVT_PROBE): thread 0 of
// each block records %globaltimer at the kernel's phase boundaries into
// qvt_clk[block * 4 + 0..3], read back by qvt_probe_read (and zeroed by
// qvt_probe_clear); in a cooperative
// kernel, thread 0 of block 0 records stamp i after each grid barrier
// (QVT_GRID_STAMP). Without QVT_PROBE every macro is empty and the kernels
// are unchanged.
#ifdef QVT_PROBE
__device__ unsigned long long qvt_clk[65536 * 4];
__device__ __forceinline__ unsigned long long qvt_now() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
extern "C" int qvt_probe_read(void* out) {
  return static_cast<int>(
      cudaMemcpyFromSymbol(out, qvt_clk, sizeof(qvt_clk)));
}
extern "C" int qvt_probe_clear() {
  void* p = nullptr;
  cudaError_t e = cudaGetSymbolAddress(&p, qvt_clk);
  return static_cast<int>(e != cudaSuccess ? e
                                           : cudaMemset(p, 0, sizeof(qvt_clk)));
}
// stamp i of 0..2, after all threads reach it
#define QVT_STAMP(i)  \
  __syncthreads();    \
  const unsigned long long qvt_t##i = qvt_now()
// the end stamp, and the block's four stamps stored
#define QVT_STAMPS_STORE(block)                       \
  do {                                                \
    __syncthreads();                                  \
    if (threadIdx.x == 0) {                           \
      unsigned long long* qc = qvt_clk + (block) * 4; \
      qc[0] = qvt_t0;                                 \
      qc[1] = qvt_t1;                                 \
      qc[2] = qvt_t2;                                 \
      qc[3] = qvt_now();                              \
    }                                                 \
  } while (0)
#define QVT_GRID_STAMP(i)                        \
  do {                                           \
    if (blockIdx.x == 0 && threadIdx.x == 0)     \
      qvt_clk[i] = qvt_now();                    \
  } while (0)
#else
#define QVT_GRID_STAMP(i) \
  do {                    \
  } while (0)
#define QVT_STAMP(i) \
  do {               \
  } while (0)
#define QVT_STAMPS_STORE(block) \
  do {                          \
  } while (0)
#endif

namespace qvt {

// Summed phase times of a block, for a kernel whose phases repeat (a loop
// over heads, passes or items) or span functions: begin() starts the
// block's clock, mark(i) adds the time since the previous mark to phase i
// (< 6), store(block) writes start, end and the six sums to
// qvt_clk[block * 8 + 0..7]. Every mark is a barrier of the block.
// Without QVT_PROBE every method is empty.
struct PhaseClock {
#ifdef QVT_PROBE
  unsigned long long ph[6], start, last;
  __device__ __forceinline__ void begin() {
    __syncthreads();
    for (int i = 0; i < 6; ++i) ph[i] = 0ull;
    start = last = qvt_now();
  }
  __device__ __forceinline__ void mark(int i) {
    __syncthreads();
    const unsigned long long t = qvt_now();
    ph[i] += t - last;
    last = t;
  }
  __device__ __forceinline__ void store(int block) const {
    if (threadIdx.x == 0) {
      unsigned long long* qc = qvt_clk + block * 8;
      qc[0] = start;
      qc[1] = last;
      for (int i = 0; i < 6; ++i) qc[2 + i] = ph[i];
    }
  }
#else
  __device__ __forceinline__ void begin() {}
  __device__ __forceinline__ void mark(int) {}
  __device__ __forceinline__ void store(int) const {}
#endif
};

}  // namespace qvt

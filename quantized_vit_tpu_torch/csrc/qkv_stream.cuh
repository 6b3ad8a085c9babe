// Device helpers shared by K6 (attention_qkv.cu), K9 (attention_proj.cu)
// and K3 (attention_block.cu, through qkv_attention.cuh):
// 16-byte loads and stores of bf16/f32 rows, the operand transforms of the
// attention (the float path's pre-scaled q, the int8 levels), and the
// staging of head slices of the fused-qkv tensor [B, N, (3, H, hd)] into
// shared memory by blocks of QKV_NT threads. With hd % 8 == 0 every row,
// column offset and shared row of a head slice is a multiple of 16 bytes.
#pragma once

#include "qvt_common.cuh"

namespace qvt {

constexpr int QKV_NT = 256;  // threads a block of K6 and K9

// 8 consecutive values (element i, a multiple of 8, 16-byte aligned) of a
// bf16 or f32 tensor as f32, and back (bf16: round to nearest even)
__device__ __forceinline__ void load8(const void* p, int dt, long long i,
                                      float (&v)[8]) {
  if (dt == qvt::DT_BF16) {
    const uint4 u = *reinterpret_cast<const uint4*>(
        static_cast<const __nv_bfloat16*>(p) + i);
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      v[2 * k] = __uint_as_float(w[k] << 16);
      v[2 * k + 1] = __uint_as_float(w[k] & 0xFFFF0000u);
    }
  } else {
    const float4* f = reinterpret_cast<const float4*>(
        static_cast<const float*>(p) + i);
    const float4 x = f[0], y = f[1];
    v[0] = x.x, v[1] = x.y, v[2] = x.z, v[3] = x.w;
    v[4] = y.x, v[5] = y.y, v[6] = y.z, v[7] = y.w;
  }
}
__device__ __forceinline__ void store8(void* p, int dt, long long i,
                                       const float (&v)[8]) {
  if (dt == qvt::DT_BF16) {
    uint32_t w[4];
#pragma unroll
    for (int k = 0; k < 4; ++k)
      w[k] = static_cast<uint32_t>(
                 __bfloat16_as_ushort(__float2bfloat16_rn(v[2 * k]))) |
             static_cast<uint32_t>(
                 __bfloat16_as_ushort(__float2bfloat16_rn(v[2 * k + 1])))
                 << 16;
    *reinterpret_cast<uint4*>(static_cast<__nv_bfloat16*>(p) + i) =
        make_uint4(w[0], w[1], w[2], w[3]);
  } else {
    float4* f = reinterpret_cast<float4*>(static_cast<float*>(p) + i);
    f[0] = make_float4(v[0], v[1], v[2], v[3]);
    f[1] = make_float4(v[4], v[5], v[6], v[7]);
  }
}

// x as the MMA operand: mode 0 x; 1 round_to(x * m1, dt) (the float
// path's q); 2 the int8 level clip(rint((x * m1) * m2)) (attention.py:
// _dyn_int8; m1 = sm_scale for q, 1 for k and v, which leaves x as is)
struct Xf {
  int mode, dt;
  float m1, m2;
  __device__ __forceinline__ float operator()(float x) const {
    if (mode == 1) return qvt::round_to(x * m1, dt);
    if (mode == 2)
      return fminf(fmaxf(rintf((x * m1) * m2), -127.f), 127.f);
    return x;
  }
};

// 16 bytes of global memory: through the read-only path (__ldg), or with
// CG through L2 only (__ldcg), for data written earlier in the same
// launch (K3's q/k/v scratch), which the read-only path may not see
template <bool CG>
__device__ __forceinline__ uint4 ld16(const void* p) {
  return CG ? __ldcg(reinterpret_cast<const uint4*>(p))
            : __ldg(reinterpret_cast<const uint4*>(p));
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <class T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// the 16 bytes u of T at d (16-byte aligned) as transformed f32
template <class T>
__device__ __forceinline__ void widen16(float* d, const uint4& u,
                                        const Xf& f);
template <>
__device__ __forceinline__ void widen16<float>(float* d, const uint4& u,
                                               const Xf& f) {
  *reinterpret_cast<float4*>(d) =
      make_float4(f(__uint_as_float(u.x)), f(__uint_as_float(u.y)),
                  f(__uint_as_float(u.z)), f(__uint_as_float(u.w)));
}
template <>
__device__ __forceinline__ void widen16<__nv_bfloat16>(float* d,
                                                       const uint4& u,
                                                       const Xf& f) {
  // element 2i is the low half of word i
  float4* o = reinterpret_cast<float4*>(d);
  o[0] = make_float4(f(__uint_as_float(u.x << 16)),
                     f(__uint_as_float(u.x & 0xFFFF0000u)),
                     f(__uint_as_float(u.y << 16)),
                     f(__uint_as_float(u.y & 0xFFFF0000u)));
  o[1] = make_float4(f(__uint_as_float(u.z << 16)),
                     f(__uint_as_float(u.z & 0xFFFF0000u)),
                     f(__uint_as_float(u.w << 16)),
                     f(__uint_as_float(u.w & 0xFFFF0000u)));
}

// `count` rows of hd values (row stride W elements from src): this
// thread's 16-byte vectors tid + u * QKV_NT into pre[u] (CG: see ld16)
template <class T, int PV, bool CG = false>
__device__ __forceinline__ void prefetch(uint4 (&pre)[PV], const T* src,
                                         long long W, int count, int hd) {
  constexpr int VE = 16 / sizeof(T);
  const int nvec = count * hd / VE;
#pragma unroll
  for (int u = 0; u < PV; ++u) {
    const int i = threadIdx.x + u * QKV_NT;
    if (i < nvec) {
      const int e = i * VE, r = e / hd;
      pre[u] = ld16<CG>(src + r * W + e - r * hd);
    }
  }
}

// the rows of a prefetch (or, off the 16-byte path, of src itself) into
// shared rows dst of stride LD, transformed; rows count .. total - 1 zero
template <class T, int LD, int PV>
__device__ __forceinline__ void store_rows(float* dst, const uint4 (&pre)[PV],
                                           const T* src, long long W,
                                           int count, int total, int hd,
                                           bool vec, const Xf& f) {
  constexpr int VE = 16 / sizeof(T);
  if (vec) {
    const int nvec = count * hd / VE;
#pragma unroll
    for (int u = 0; u < PV; ++u) {
      const int i = threadIdx.x + u * QKV_NT;
      if (i >= nvec) continue;
      const int e = i * VE, r = e / hd;
      widen16<T>(dst + r * LD + e - r * hd, pre[u], f);
    }
  } else {
    for (int e = threadIdx.x; e < count * hd; e += QKV_NT) {
      const int r = e / hd, c = e - r * hd;
      dst[r * LD + c] = f(to_f32(src[r * W + c]));
    }
  }
  for (int e = threadIdx.x; e < (total - count) * hd; e += QKV_NT) {
    const int r = e / hd;
    dst[(count + r) * LD + e - r * hd] = 0.f;
  }
}

// this thread's max of |x * mul| over `count` rows of hd values (CG: see
// ld16)
template <class T, bool CG = false>
__device__ __forceinline__ float absmax_rows(const T* src, long long W,
                                             int count, int hd, bool vec,
                                             float mul) {
  float m = 0.f;
  if (vec) {
    constexpr int VE = 16 / sizeof(T);
    const Xf id = {0, 0, 1.f, 1.f};
    for (int i = threadIdx.x; i < count * hd / VE; i += QKV_NT) {
      const int e = i * VE, r = e / hd;
      const uint4 u = ld16<CG>(src + r * W + e - r * hd);
      alignas(16) float v[8];
      widen16<T>(v, u, id);
#pragma unroll
      for (int j = 0; j < VE; ++j) m = fmaxf(m, fabsf(v[j] * mul));
    }
  } else {
    for (int e = threadIdx.x; e < count * hd; e += QKV_NT) {
      const int r = e / hd;
      m = fmaxf(m, fabsf(to_f32(src[r * W + e - r * hd]) * mul));
    }
  }
  return m;
}

}  // namespace qvt

// K8: whole transformer-MLP residual branch for big-weight MLPs on Hopper
// (sm_90a), the hidden dimension split over blocks.
//
// Replaces the TPU kernel quantized_vit_tpu/ops/fused.py:
// _fused_mlp_chunked_kernel (pallas_call in _fused_mlp_chunked,
// fused.py:1065):
//   out = x + fc2(quant(GELU(fc1(quant(LN(x))))))
// for int8 w1 [K, H] and w2 [H, K]. The TPU kernel walks a sequential
// (M tile x hidden chunk) grid and carries the fc2 sum of an M tile in
// VMEM scratch across its hidden chunks. Blocks here run in parallel and
// in no order, so the hidden dimension is split over them instead:
//
//   grid (S hidden slices) x (R row tiles of 32 rows). Block (s, r) runs
//   LN + quant of its 32 rows once into shared memory, then walks the
//   32-unit hidden chunks of slice s (as K2 walks all of them): fc1 chunk
//   (int32) -> dequant -> folded GELU-quant -> int8 hidden chunk in shared
//   memory -> fc2 partial added into an int32 register accumulator
//   [32, K]. The [M, H] hidden tensor never reaches device memory.
//
// With S > 1 the launch is cooperative: each block stores its int32 fc2
// partial [32, K] to a scratch [S, M, K], one grid barrier, then block
// (s, r) sums the S partials of a 1/S share of row tile r's elements and
// applies the epilogue acc*s2 + b2 + x in f32, once per element. Int32
// sums are exact, so the split gives the same bits as one block walking
// every chunk (S = 1, the epilogue straight from registers: used when the
// row tiles alone fill the card). S is chosen so that R*S blocks are
// co-resident (one per SM at ViT-H widths): 14 x 9 at M = 272, 7 x 17 at
// M = 544.
//
// 16 warps. fc1 of a [32, 32] chunk is 8 warp tiles of 16 x 8, each split
// over two K halves (warps w and w + 8, summed through shared memory);
// fc2 gives each warp K/16 output columns. The weights arrive n-major
// (the layer's plan), so a chunk's w1 columns and w2 rows are 16-byte
// pieces, streamed with cp.async through two buffers (the next chunk
// loads while this one computes); the w2 chunk rows are 32 bytes with the
// two 16-byte halves swapped on every other group of four rows, so the
// tensor-core fragment loads are free of bank conflicts without padding.
//
// Bound on this card at ViT-H batch 1 (M = 272, K 1280, H 5120): 7.13 G
// int8 ops (3.6 us at 1,979 TOPS) against ~14.5 MB moved (4.3 us at
// 3.35 TB/s): bytes. Every row tile re-reads both weights (13.1 MB) from
// L2, the partials round-trip through L2, and the tile products use
// mma.sync without TMA or wgmma, so this first version is well above it.

#include <cooperative_groups.h>

#include <algorithm>

#include "qvt_common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int BM = 32, HC = 32, SH = HC + 16, NT = 512, NW = NT / 32;
constexpr int MAX_TN2 = 10;  // fc2: K <= 16 warps x 10 n8 tiles = 1280

struct Args {
  const void* x;
  int x_dt;
  qvt::WeightT w1;  // K x H levels, transposed: [H][K]
  const float* s1;
  const float* b1;
  qvt::WeightT w2;  // H x K levels, transposed: [K][H]
  const float* s2;
  const float* b2;
  const float* ln_g;
  const float* ln_b;
  const float* prm;  // act_d, act_t, hid_d, hid_t
  void* out;
  int out_dt;
  int* part;  // [S][M][K] int32 fc2 partials (S > 1)
  int M, K, H, Kp, S;
  int act_pow, hid_pow;
  float act_top, hid_top, eps;
};

// byte offset of 16-byte piece p (0, 1) of w2 chunk row n: the halves
// swap on every other group of four rows
__device__ __forceinline__ int b2_off(int n, int p) {
  return n * HC + ((p ^ ((n >> 2) & 1)) << 4);
}

__host__ __device__ inline int kp_of(int K) { return (K + 63) / 64 * 64; }

template <int TN2>
__host__ __device__ inline size_t smem_bytes(int K) {
  const size_t sa = kp_of(K) + 16;
  const size_t buf = HC * sa + static_cast<size_t>(NW) * TN2 * 8 * HC;
  return BM * sa + BM * SH + 2 * buf + 8 * 32 * 4 * sizeof(int) +
         2 * BM * sizeof(float);
}

// Shared memory: lvA [BM][Kp+16] | Hs [BM][SH] | two buffers of { B1s
// [HC][Kp+16] | B2s [16*TN2*8][HC] } | red [8][32][4] int32 | mu | rs
template <int TN2>
__global__ void __launch_bounds__(NT, 1) mlp_chunked_kernel(Args a) {
  extern __shared__ __align__(16) int8_t smem[];
  const int sa = a.Kp + 16;
  const int n2 = NW * TN2 * 8;  // fc2 columns of the block (>= K)
  const int buf_bytes = HC * sa + n2 * HC;
  int8_t* lvA = smem;
  int8_t* Hs = lvA + BM * sa;
  int8_t* bufs = Hs + BM * SH;
  int* red = reinterpret_cast<int*>(bufs + 2 * buf_bytes);
  float* s_mu = reinterpret_cast<float*>(red + 8 * 32 * 4);
  float* s_rs = s_mu + BM;

  const int slice = blockIdx.x, m_base = blockIdx.y * BM;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const float act_d = a.prm[0], act_t = a.prm[1];
  const float hid_d = a.prm[2], hid_t = a.prm[3];
  const int M = a.M, K = a.K, H = a.H;

  QVT_STAMP(0);
  qvt::ln_stats(a.x, a.x_dt, m_base, BM, M - m_base, K, a.eps, s_mu, s_rs);
  __syncthreads();
  // LN + quant once per row tile (gamma/beta carry 1/d when t == 1)
  qvt::fill_rows(lvA, BM, sa, a.Kp, [&](int r, int k) -> int8_t {
    const int row = m_base + r;
    if (row >= M || k >= K) return 0;
    const long long i = static_cast<long long>(row) * K + k;
    float y = (qvt::load_f(a.x, a.x_dt, i) - s_mu[r]) * s_rs[r] * a.ln_g[k] +
              a.ln_b[k];
    return qvt::quantize(y, act_d, act_t, a.act_top, a.act_pow,
                         !a.act_pow);
  });

  QVT_STAMP(1);
  int acc2[2][TN2][4];
  qvt::zero_acc(acc2);
  const int n_chunks = (H + HC - 1) / HC;
  const int c_begin = slice * n_chunks / a.S;
  const int c_end = (slice + 1) * n_chunks / a.S;
  // fc1: warp tile (16 rows x 8 units) tw over K half kh
  const int tw = warp & 7, kh = warp >> 3;
  const int m1 = (tw & 1) * 16, n1 = (tw >> 1) * 8;
  const int k_half = a.Kp / 2;
  const int n0 = warp * TN2 * 8;  // this warp's fc2 columns
  auto hid = [&](int c, int j) -> int {
    const int h = c * HC + j;
    return h < H ? h : -1;
  };
  const bool async = a.w1.vec_ok() && a.w2.vec_ok();
  auto prefetch = [&](int c, int8_t* b1s, int8_t* b2s) {
    const int kq = a.Kp / 16;
    for (int idx = threadIdx.x; idx < HC * kq; idx += NT) {
      const int j = idx / kq, k = (idx - j * kq) * 16;
      const int h = hid(c, j);
      const bool ok = h >= 0 && k < K;
      qvt::cp_async16(
          b1s + j * sa + k,
          a.w1.wt + (ok ? static_cast<long long>(h) * K + k : 0), ok);
    }
    for (int idx = threadIdx.x; idx < n2 * 2; idx += NT) {
      const int n = idx >> 1, p = idx & 1;
      const int h = hid(c, p * 16);
      const bool ok = h >= 0 && n < K;
      qvt::cp_async16(
          b2s + b2_off(n, p),
          a.w2.wt + (ok ? static_cast<long long>(n) * H + h : 0), ok);
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };
  if (async && c_begin < c_end) prefetch(c_begin, bufs, bufs + HC * sa);

  for (int c = c_begin; c < c_end; ++c) {
    int8_t* B1s = bufs + ((c - c_begin) & 1) * buf_bytes;
    int8_t* B2s = B1s + HC * sa;
    if (async) {
      if (c + 1 < c_end) {
        int8_t* nb = bufs + ((c + 1 - c_begin) & 1) * buf_bytes;
        prefetch(c + 1, nb, nb + HC * sa);
        asm volatile("cp.async.wait_group 1;\n" ::);
      } else {
        asm volatile("cp.async.wait_group 0;\n" ::);
      }
    } else {
      // shapes off the 16-byte path: byte-wise fills
      qvt::fill_rows(B1s, HC, sa, a.Kp, [&](int j, int k) -> int8_t {
        return a.w1.at(k, hid(c, j));
      });
      for (int idx = threadIdx.x; idx < n2 * HC; idx += NT) {
        const int n = idx / HC, j = idx - n * HC;
        const int h = hid(c, j);
        B2s[b2_off(n, j >> 4) + (j & 15)] = h < 0 ? 0 : a.w2.at(h, n);
      }
    }
    __syncthreads();

    // fc1 over this warp's K half, two accumulator chains
    int acc1[1][1][4], acc1b[1][1][4];
    qvt::zero_acc(acc1);
    qvt::zero_acc(acc1b);
    const int k0 = kh * k_half;
    for (int kk = k0; kk < k0 + k_half; kk += 64) {
      qvt::warp_mma<1, 1>(acc1, lvA + kk, sa, B1s + kk, sa, 32, m1, n1,
                          lane);
      if (kk + 32 < k0 + k_half)
        qvt::warp_mma<1, 1>(acc1b, lvA + kk + 32, sa, B1s + kk + 32, sa, 32,
                            m1, n1, lane);
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) acc1[0][0][r] += acc1b[0][0][r];
    if (kh == 1) {
#pragma unroll
      for (int r = 0; r < 4; ++r) red[(tw * 32 + lane) * 4 + r] = acc1[0][0][r];
    }
    __syncthreads();
    if (kh == 0) {
      // dequant -> GELU -> fc2's input levels, into shared memory only
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int row = m1 + g + (r >= 2 ? 8 : 0);
        const int col = n1 + t * 2 + (r & 1);
        const int h = hid(c, col);
        int8_t lv = 0;
        if (h >= 0) {
          const int acc = acc1[0][0][r] + red[(tw * 32 + lane) * 4 + r];
          float y = static_cast<float>(acc) * a.s1[h] + a.b1[h];
          lv = a.hid_pow ? qvt::quantize(qvt::gelu(y), hid_d, hid_t,
                                         a.hid_top, true, false)
                         : qvt::gelu_quant_folded(y, hid_d, a.hid_top);
        }
        Hs[row * SH + col] = lv;
      }
    }
    __syncthreads();

    // fc2 partial: acc2 += Hs [32, 32] x B2s [32 units, n0 .. n0 + 8*TN2)
    uint32_t af[2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int8_t* p = Hs + (i * 16 + g) * SH + t * 4;
      af[i][0] = *reinterpret_cast<const uint32_t*>(p);
      af[i][1] = *reinterpret_cast<const uint32_t*>(p + 8 * SH);
      af[i][2] = *reinterpret_cast<const uint32_t*>(p + 16);
      af[i][3] = *reinterpret_cast<const uint32_t*>(p + 8 * SH + 16);
    }
#pragma unroll
    for (int j = 0; j < TN2; ++j) {
      const int n = n0 + j * 8 + g;
      const uint32_t b0 =
          *reinterpret_cast<const uint32_t*>(B2s + b2_off(n, 0) + t * 4);
      const uint32_t b1 =
          *reinterpret_cast<const uint32_t*>(B2s + b2_off(n, 1) + t * 4);
#pragma unroll
      for (int i = 0; i < 2; ++i)
        qvt::mma_s8(acc2[i][j], af[i][0], af[i][1], af[i][2], af[i][3], b0,
                    b1);
    }
    __syncthreads();
  }
  QVT_STAMP(2);

  if (a.S == 1) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < TN2; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int row = m_base + i * 16 + g + (r >= 2 ? 8 : 0);
          const int col = n0 + j * 8 + t * 2 + (r & 1);
          if (row >= M || col >= K) continue;
          const long long o = static_cast<long long>(row) * K + col;
          float v = static_cast<float>(acc2[i][j][r]) * a.s2[col] + a.b2[col];
          qvt::store_f(a.out, a.out_dt, o, v + qvt::load_f(a.x, a.x_dt, o));
        }
    QVT_STAMPS_STORE(blockIdx.y * gridDim.x + blockIdx.x);
    return;
  }

  // the slice's partial sums (column pairs as 8-byte stores when K is
  // even), then one grid barrier
  int* part = a.part + static_cast<long long>(slice) * M * K;
  const bool pairs = (K & 1) == 0;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < TN2; ++j)
#pragma unroll
      for (int r = 0; r < 4; r += 2) {
        const int row = m_base + i * 16 + g + (r >= 2 ? 8 : 0);
        const int col = n0 + j * 8 + t * 2;
        if (row >= M || col >= K) continue;
        int* p = part + static_cast<long long>(row) * K + col;
        if (pairs) {
          *reinterpret_cast<int2*>(p) =
              make_int2(acc2[i][j][r], acc2[i][j][r + 1]);
        } else {
          p[0] = acc2[i][j][r];
          if (col + 1 < K) p[1] = acc2[i][j][r + 1];
        }
      }
  cg::this_grid().sync();

  // this block's share of row tile blockIdx.y, in units of 4 elements
  // (16-byte loads) when K % 4 == 0: the S partials summed (int32, so any
  // order gives these bits), then the epilogue
  const int vw = (K & 3) == 0 ? 4 : 1;
  const int rows = min(BM, M - m_base);
  const long long units = static_cast<long long>(rows) * K / vw;
  const long long u0 = units * slice / a.S, u1 = units * (slice + 1) / a.S;
  const long long base = static_cast<long long>(m_base) * K;
  const long long stride = static_cast<long long>(M) * K;
  for (long long u = u0 + threadIdx.x; u < u1; u += NT) {
    const long long o = base + u * vw;
    int acc[4] = {0, 0, 0, 0};
    if (vw == 4) {
#pragma unroll 4
      for (int sp = 0; sp < a.S; ++sp) {
        const int4 p =
            __ldcg(reinterpret_cast<const int4*>(a.part + sp * stride + o));
        acc[0] += p.x;
        acc[1] += p.y;
        acc[2] += p.z;
        acc[3] += p.w;
      }
    } else {
#pragma unroll 4
      for (int sp = 0; sp < a.S; ++sp) acc[0] += __ldcg(a.part + sp * stride + o);
    }
    for (int i = 0; i < vw; ++i) {
      const int col = static_cast<int>((o + i) % K);
      float v = static_cast<float>(acc[i]) * a.s2[col] + a.b2[col];
      qvt::store_f(a.out, a.out_dt, o + i,
                   v + qvt::load_f(a.x, a.x_dt, o + i));
    }
  }
  QVT_STAMPS_STORE(blockIdx.y * gridDim.x + blockIdx.x);
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

// co-resident blocks of one TN2 variant at width K (a negative CUDA error)
template <int TN2>
int capacity(int K) {
  const size_t smem = smem_bytes<TN2>(K);
  cudaError_t e = cudaFuncSetAttribute(
      mlp_chunked_kernel<TN2>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return -static_cast<int>(e);
  int per_sm = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, mlp_chunked_kernel<TN2>, NT, smem);
  if (e != cudaSuccess) return -static_cast<int>(e);
  return per_sm * sm_count();
}

template <int TN2>
int launch(Args& a, cudaStream_t stream) {
  const size_t smem = smem_bytes<TN2>(a.K);
  cudaError_t e = cudaFuncSetAttribute(
      mlp_chunked_kernel<TN2>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(a.S, (a.M + BM - 1) / BM);
  if (a.S == 1) {
    mlp_chunked_kernel<TN2><<<grid, NT, smem, stream>>>(a);
    return static_cast<int>(cudaGetLastError());
  }
  void* args[] = {&a};
  e = cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(mlp_chunked_kernel<TN2>), grid, dim3(NT), args,
      smem, stream);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// the fc2 n8 tiles per warp for width K: the variants built are 1, 2, 4,
// 6, 8 and 10 (K <= 1280); 0 past them
int tn2_of(int K) {
  const int need = (K + NW * 8 - 1) / (NW * 8);
  for (int v : {1, 2, 4, 6, 8, MAX_TN2})
    if (need <= v) return v;
  return 0;
}

}  // namespace

// Hidden slices S of a launch at (M, K, H): enough row tiles x slices to
// fill the co-resident grid, 1 when the row tiles alone do; negative on a
// CUDA error or a K the kernel does not take.
extern "C" int qvt_fused_mlp_chunked_splits(int M, int K, int H) {
  int cap = 0;
  switch (tn2_of(K)) {
    case 1: cap = capacity<1>(K); break;
    case 2: cap = capacity<2>(K); break;
    case 4: cap = capacity<4>(K); break;
    case 6: cap = capacity<6>(K); break;
    case 8: cap = capacity<8>(K); break;
    case MAX_TN2: cap = capacity<MAX_TN2>(K); break;
    default: return -static_cast<int>(cudaErrorInvalidValue);
  }
  if (cap <= 0) return cap < 0 ? cap : -static_cast<int>(cudaErrorInvalidValue);
  const int tiles = (M + BM - 1) / BM;
  const int chunks = (H + HC - 1) / HC;
  if (tiles >= cap) return 1;
  return std::max(1, std::min(chunks, cap / tiles));
}

extern "C" int qvt_fused_mlp_chunked(
    const void* x, int x_dt, const void* w1, const void* s1, const void* b1,
    const void* w2, const void* s2, const void* b2, const void* ln_g,
    const void* ln_b, const void* prm, void* out, int out_dt, void* part,
    int M, int K, int H, int S, int act_pow, int hid_pow, int act_top,
    int hid_top, float eps, void* stream) {
  if (S < 1 || (S > 1 && part == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.x = x;
  a.x_dt = x_dt;
  a.w1 = qvt::WeightT{static_cast<const int8_t*>(w1), K, H, 0};
  a.s1 = static_cast<const float*>(s1);
  a.b1 = static_cast<const float*>(b1);
  a.w2 = qvt::WeightT{static_cast<const int8_t*>(w2), H, K, 0};
  a.s2 = static_cast<const float*>(s2);
  a.b2 = static_cast<const float*>(b2);
  a.ln_g = static_cast<const float*>(ln_g);
  a.ln_b = static_cast<const float*>(ln_b);
  a.prm = static_cast<const float*>(prm);
  a.out = out;
  a.out_dt = out_dt;
  a.part = static_cast<int*>(part);
  a.M = M;
  a.K = K;
  a.H = H;
  a.Kp = kp_of(K);
  a.S = S;
  a.act_pow = act_pow;
  a.hid_pow = hid_pow;
  a.act_top = static_cast<float>(act_top);
  a.hid_top = static_cast<float>(hid_top);
  a.eps = eps;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (tn2_of(K)) {
    case 1: return launch<1>(a, st);
    case 2: return launch<2>(a, st);
    case 4: return launch<4>(a, st);
    case 6: return launch<6>(a, st);
    case 8: return launch<8>(a, st);
    case MAX_TN2: return launch<MAX_TN2>(a, st);
    default: return static_cast<int>(cudaErrorInvalidValue);  // K > 1280
  }
}

// K13: standalone attention softmax(q k^T * scale) v for Hopper (sm_90a).
//
// Replaces quantized_vit_tpu/ops/attention.py:_flash_attention (pallas_call
// at :119; body _attn_kernel :34-62). q/k/v [B, H, N, hd], float (bf16 or
// f32, each its own); out [B, H, N, hd] bf16/f32, or int8 LSFQ levels of
// the proj quantizer.
//
// Numerics, those of the TPU kernel: s = (q . k, f32 accumulation) *
// scale (the scale after the dot); keys at or past n_valid set to -1e30
// (all N keys, no trim); s - rowmax, exp (not exp2, no clamp); p divided by
// its row sum; p cast to v's dtype; o = p . v with f32 accumulation; then
// the output cast, or _quantize_f32(o, d, t, top, pow). As in every kernel
// of this port, the sums run in f64 and round once to f32, and the file is
// compiled with -fmad=false, so the plain version
// (ops/attention.py:flash_attention_plain) gives the same bits.
//
// Both products run on the FP64 tensor cores (mma.sync m16n8k4 .f64), and
// that keeps the bits: q, k, v and p are bf16 or f32 values, so the
// product of two of them has at most 48 significant bits and is exact in
// f64. The MMA computes d = a.b + c per k-step of 4 with exact products;
// whether it fuses them changes nothing, and -fmad=false has nothing to
// act on there. What differs from the f64 SIMT loop this kernel replaced,
// and from the plain version's DGEMM, is only the order of the f64
// additions; each sum is then rounded once to f32. For bf16 operands the
// f64 sum of these products is exact whenever its terms span under 53
// bits, as they do here, so every order gives the same f32; for f32
// operands an order can move a rounding of the f64 sum, which reaches the
// f32 result only when that sum lies within 2^-29 of an f32 tie
// (tests/test_torch_flash_attention.py counts them in the MMA's order).
//
// Design. The TPU program keeps one (image, head)'s whole [N, N] f32
// score matrix in VMEM; at ViT-H/14's 272 tokens that is 296 KB, beyond a
// block's 227 KB of shared memory. So a block takes one (image, head,
// tile of QT query rows), QT in {64, 32, 16} picked by the wrapper
// (ops/attention.py:flash_tile_rows: the tile that keeps the most query
// rows resident on an SM, two blocks at most). Shared memory holds the
// tile's q rows, two chunk buffers of 64 key rows and the score rows
// [QT][N], all f32 (bf16 and f32 inputs are exact there; each fragment
// value is widened to f64 as it is loaded): half the bytes of f64
// staging, so two blocks of 64 rows fit on one SM at ViT-B/16's 208
// tokens, and half the bytes a fragment load moves. The two passes stay:
// scores over K's chunks, the softmax, then P.V over V's chunks. No
// online softmax: the TPU kernel takes the global row max before exp
// (attention.py:51-53), and rescaling partial sums by
// exp(m_old - m_new) would change the bits.
// - m16n8k4, not m8n8k4: on the H100 the m8n8k4 .f64 form issues at
//   half the FP64 tensor rate, the m16n8 forms at the full rate
//   (tools/flash_design.py); k4 keeps one B value and two A values a
//   thread, the smallest fragments of the full-rate forms.
// - Scores: each warp owns a patch of the [QT x 64] chunk (up to 32 x 16)
//   and reuses each A fragment (q) across its B fragments (k) and back;
//   the accumulators round to f32, take the scale and the mask, and land
//   in the score rows.
// - P.V: p is read from the score rows (already cast to v's dtype),
//   widened to f64 as the A operand; V's chunk is B; each warp keeps its
//   patch of the [QT x hd] output in f64 registers over all chunks.
// - Softmax: the TPU kernel's per-row code; a warp takes QT / 8 rows side
//   by side, so its passes keep that many independent chains in flight.
// - A tile's rows past N (the last tile) are zeros: warps whose rows all
//   lie there skip the MMAs, and the softmax skips those rows.
// - Staging: K and V stream as one sequence of chunks through the two
//   buffers. A chunk's raw bytes are loaded with 16-byte loads into
//   registers while the previous chunk's MMAs run, then converted to f32
//   (the dtype a template parameter) and stored into the free buffer: one
//   __syncthreads per chunk. hd pads with zero columns to the head bound
//   (64, 80 or 128), a chunk past N with zero rows, the score columns
//   past N to a multiple of 4 with zeros: zeros add nothing.
// - q and k rows are HDM + 4 floats apart, v rows HDM + 8 and score rows
//   round8(N) + 4, so each warp's fragment loads (lane g = lane/4 reads
//   row g, column t = lane%4; v's transposed) fall in 32 distinct banks.
//
// Bound on this card at ViT-B/16 batch 32 (q/k/v [32, 12, 208, 64] bf16):
// 4.25 GFLOP over 989 TFLOP/s = 4.3 us, 40.9 MB over 3.35 TB/s = 12.2 us:
// bytes. An exact kernel cannot use the bf16 rate: its own ceiling is the
// FP64 tensor cores' 67 TFLOP/s, 63 us for those 4.25 GFLOP.

#include "fp64_mma.cuh"
#include "qvt_common.cuh"

namespace {

using qvt::dmma;
using qvt::warp_grid;
using qvt::WarpGrid;

constexpr int NT = 256, NW = NT / 32, KC = 64;
constexpr int SMEM_MAX = 232448;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  int q_dt, k_dt, v_dt;
  void* out;
  int out_dt;  // DT_INT8: quantize with prm = [d, t]
  const float* prm;
  int B, H, N, hd, n_valid, qt;
  float scale, top;
  int out_pow;
};

// the head bound a head_dim is padded to, and the shared-memory row
// strides in floats: q and k rows HDM + 4 (= 4 x odd mod 32), v rows
// HDM + 8 (= 8 x odd mod 32), score rows round8(N) + 4 (mirrored by
// ops/attention.py:flash_smem_bytes)
__host__ __device__ constexpr int head_bound(int hd) {
  return hd <= 64 ? 64 : (hd <= 80 ? 80 : 128);
}
__host__ __device__ inline int score_ld(int N) { return (N + 7) / 8 * 8 + 4; }

size_t smem_bytes(int qt, int N, int hd) {
  const int hdm = head_bound(hd);
  return (static_cast<size_t>(qt) * (hdm + 4) +
          static_cast<size_t>(2) * KC * (hdm + 8) +
          static_cast<size_t>(qt) * score_ld(N)) *
         sizeof(float);
}

// One operand of [B, H, N, hd]: its 16-byte path needs whole vectors per
// row and an aligned (image, head) slice.
struct Operand {
  const void* p;
  bool bf16, vec;
  __device__ Operand(const void* p_, int dt, int N, int hd) : p(p_) {
    bf16 = dt == qvt::DT_BF16;
    const int ve = bf16 ? 8 : 4;
    vec = (reinterpret_cast<uintptr_t>(p_) & 15) == 0 && hd % ve == 0 &&
          (static_cast<long long>(N) * hd) % ve == 0;
  }
  __device__ int esize() const { return bf16 ? 2 : 4; }
};

// the 16-byte vectors of cnt elements from element e0 into this thread's
// registers (vector tid + u * NT in pre[u])
template <int PV>
__device__ __forceinline__ void prefetch(uint4 (&pre)[PV], const Operand& o,
                                         long long e0, int cnt) {
  const int nvec = cnt * o.esize() / 16;
  const uint4* src = reinterpret_cast<const uint4*>(
      static_cast<const unsigned char*>(o.p) + e0 * o.esize());
#pragma unroll
  for (int u = 0; u < PV; ++u) {
    const int i = threadIdx.x + u * NT;
    if (i < nvec) pre[u] = __ldg(src + i);
  }
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// 16 bytes of T as f32 at d (16-byte aligned), from the register itself
template <class T>
__device__ __forceinline__ void widen16(float* d, const uint4& u);
template <>
__device__ __forceinline__ void widen16<float>(float* d, const uint4& u) {
  *reinterpret_cast<uint4*>(d) = u;
}
template <>
__device__ __forceinline__ void widen16<__nv_bfloat16>(float* d,
                                                       const uint4& u) {
  // element 2i is the low half of word i
  uint4* o = reinterpret_cast<uint4*>(d);
  o[0] = make_uint4(u.x << 16, u.x & 0xFFFF0000u, u.y << 16,
                    u.y & 0xFFFF0000u);
  o[1] = make_uint4(u.z << 16, u.z & 0xFFFF0000u, u.w << 16,
                    u.w & 0xFFFF0000u);
}

// the prefetched vectors, as f32, into rows of dst (stride LD): element e
// of the span is row e / hd, column e % hd (a vector stays in one row)
template <class T, int LD, int PV>
__device__ __forceinline__ void store_vec(float* dst, const uint4 (&pre)[PV],
                                          int cnt, int hd) {
  constexpr int VE = 16 / sizeof(T);
  const int nvec = cnt / VE;
#pragma unroll
  for (int u = 0; u < PV; ++u) {
    const int i = threadIdx.x + u * NT;
    if (i >= nvec) continue;
    const int e = i * VE, r = e / hd;
    widen16<T>(dst + r * LD + e - r * hd, pre[u]);
  }
}

// the element-by-element path (hd or the slice off the 16-byte grid)
template <class T, int LD>
__device__ __forceinline__ void store_scalar(float* dst, const void* p,
                                             long long e0, int cnt, int hd) {
  const T* src = static_cast<const T*>(p) + e0;
  for (int e = threadIdx.x; e < cnt; e += NT) {
    const int r = e / hd, c = e - r * hd;
    dst[r * LD + c] = to_f32(src[e]);
  }
}

// rows [r0, r0 + nr) of the (image, head) slice at element `base` into
// dst, from pre (16-byte path) or straight from device memory; rows nr..
// total - 1 of dst zeroed (a tile or chunk past N)
template <int LD, int PV>
__device__ __forceinline__ void store_rows(float* dst, const uint4 (&pre)[PV],
                                           const Operand& o, long long base,
                                           int r0, int nr, int total,
                                           int hd) {
  const int cnt = nr * hd;
  if (o.vec) {
    if (o.bf16)
      store_vec<__nv_bfloat16, LD>(dst, pre, cnt, hd);
    else
      store_vec<float, LD>(dst, pre, cnt, hd);
  } else {
    const long long e0 = base + static_cast<long long>(r0) * hd;
    if (o.bf16)
      store_scalar<__nv_bfloat16, LD>(dst, o.p, e0, cnt, hd);
    else
      store_scalar<float, LD>(dst, o.p, e0, cnt, hd);
  }
  for (int e = threadIdx.x; e < (total - nr) * hd; e += NT) {
    const int r = e / hd;
    dst[(nr + r) * LD + e - r * hd] = 0.f;
  }
}

// softmax of one warp's rows S0 + NW * i * lds (i < RW; only i < nlive
// when GUARD): max, exp, f64 sum, divide, cast to v's dtype, per row as
// the TPU kernel does. The rows run side by side and each pass loads all
// of its values before it stores any, so RW chains stay in flight.
template <int RW, bool GUARD>
__device__ __forceinline__ void softmax_rows(float* S0, int lds, int N,
                                             int nlive, int v_dt) {
  const int lane = threadIdx.x & 31;
  float mx[RW], tot[RW];
  double sum[RW];
#pragma unroll
  for (int i = 0; i < RW; ++i) {
    mx[i] = __int_as_float(0xff800000);  // -inf
    sum[i] = 0.0;
  }
  for (int j = lane; j < N; j += 32)
#pragma unroll
    for (int i = 0; i < RW; ++i)
      if (!GUARD || i < nlive) mx[i] = fmaxf(mx[i], S0[NW * i * lds + j]);
#pragma unroll
  for (int i = 0; i < RW; ++i)
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], o));
  for (int j = lane; j < N; j += 32) {
    float p[RW];
#pragma unroll
    for (int i = 0; i < RW; ++i)
      if (!GUARD || i < nlive) p[i] = S0[NW * i * lds + j];
#pragma unroll
    for (int i = 0; i < RW; ++i)
      if (!GUARD || i < nlive) {
        p[i] = expf(p[i] - mx[i]);
        sum[i] += static_cast<double>(p[i]);
      }
#pragma unroll
    for (int i = 0; i < RW; ++i)
      if (!GUARD || i < nlive) S0[NW * i * lds + j] = p[i];
  }
#pragma unroll
  for (int i = 0; i < RW; ++i)
    tot[i] = static_cast<float>(qvt::warp_sum(sum[i]));
  for (int j = lane; j < N; j += 32) {
    float p[RW];
#pragma unroll
    for (int i = 0; i < RW; ++i)
      if (!GUARD || i < nlive) p[i] = S0[NW * i * lds + j];
#pragma unroll
    for (int i = 0; i < RW; ++i)
      if (!GUARD || i < nlive)
        S0[NW * i * lds + j] = qvt::round_to(p[i] / tot[i], v_dt);
  }
}

template <int QT, int HDM>
__global__ void __launch_bounds__(NT, 2) flash_kernel(Args a) {
  constexpr int LDK = HDM + 4, LDV = HDM + 8;
  // scores: [QT x KC] per chunk; P.V: [QT x HDM]; softmax: RW rows a warp
  constexpr WarpGrid SG = warp_grid(QT / 16, KC / 8);
  constexpr int SWM = QT / 16 / SG.wr, SWN = KC / 8 / SG.wc;
  constexpr WarpGrid OG = warp_grid(QT / 16, HDM / 8);
  constexpr int OWM = QT / 16 / OG.wr, OWN = HDM / 8 / OG.wc;
  constexpr int RW = QT / NW;
  // 16-byte vectors of one f32 chunk per thread
  constexpr int PV = KC * HDM * 4 / 16 / NT;
  static_assert(KC * HDM * 4 % (16 * NT) == 0, "chunk vectors per thread");

  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Qs = reinterpret_cast<float*>(smem_raw);  // [QT][LDK]
  float* Cb = Qs + QT * LDK;  // 2 x [KC][LDV]: k rows LDK apart, v rows LDV
  float* S = Cb + 2 * KC * LDV;  // [QT][lds]

  const int N = a.N, hd = a.hd, lds = score_ld(N);
  const int q0 = blockIdx.x * QT;
  const int rows = min(QT, N - q0);
  const long long base =
      (static_cast<long long>(blockIdx.z) * a.H + blockIdx.y) * N * hd;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int nk = (N + KC - 1) / KC, nc = 2 * nk;
  const Operand Q(a.q, a.q_dt, N, hd), K(a.k, a.k_dt, N, hd),
      V(a.v, a.v_dt, N, hd);

  // chunk c of the stream: K's chunks, then V's
  auto chunk_op = [&](int c) { return c < nk ? K : V; };
  auto chunk_r0 = [&](int c) { return (c < nk ? c : c - nk) * KC; };
  auto chunk_rows = [&](int c) { return min(KC, N - chunk_r0(c)); };
  uint4 pre[PV];
  auto fetch = [&](int c) {
    const Operand o = chunk_op(c);
    if (o.vec)
      prefetch(pre, o, base + static_cast<long long>(chunk_r0(c)) * hd,
               chunk_rows(c) * hd);
  };
  auto stage = [&](int c) {
    float* dst = Cb + (c & 1) * KC * LDV;
    if (c < nk)
      store_rows<LDK>(dst, pre, K, base, chunk_r0(c), chunk_rows(c), KC, hd);
    else
      store_rows<LDV>(dst, pre, V, base, chunk_r0(c), chunk_rows(c), KC, hd);
  };

  QVT_STAMP(0);
  // zeros: the columns [hd, HDM) of q and of k's chunks, and the score
  // columns [N, round4(N)) that P.V's last k-step reads (rows past N are
  // zeroed as they are staged; v's columns past hd reach only output
  // columns that are not stored)
  {
    const int cp = HDM - hd, pad = ((N + 3) & ~3) - N;
    for (int i = threadIdx.x; i < QT * cp; i += NT)
      Qs[(i / cp) * LDK + hd + i % cp] = 0.f;
    for (int i = threadIdx.x; i < 2 * KC * cp; i += NT) {
      const int r = i / cp;
      Cb[(r / KC) * KC * LDV + (r % KC) * LDK + hd + i % cp] = 0.f;
    }
    for (int i = threadIdx.x; i < QT * pad; i += NT)
      S[(i / pad) * lds + N + i % pad] = 0.f;
  }
  fetch(0);
  {
    uint4 qv[PV];
    if (Q.vec)
      prefetch(qv, Q, base + static_cast<long long>(q0) * hd, rows * hd);
    store_rows<LDK>(Qs, qv, Q, base, q0, rows, QT, hd);
  }
  stage(0);
  if (nc > 1) fetch(1);
  __syncthreads();

  // after chunk c's MMAs: chunk c + 1 into the other buffer (its readers
  // finished before the last barrier), chunk c + 2's loads in flight
  auto advance = [&](int c) {
    if (c + 1 < nc) {
      stage(c + 1);
      if (c + 2 < nc) fetch(c + 2);
    }
    __syncthreads();
  };

  // scores: s[r][j] = f32(sum_d q[r][d] k[j][d]) * scale, masked
  for (int c = 0; c < nk; ++c) {
    const float* Kc = Cb + (c & 1) * KC * LDV;
    const int j0 = c * KC, kc = chunk_rows(c);
    const int m0 = warp / SG.wc * SWM * 16, n0 = warp % SG.wc * SWN * 8;
    if (warp < SG.wr * SG.wc && n0 < kc && m0 < rows) {
      double acc[SWM][SWN][4] = {};
#pragma unroll
      for (int kk = 0; kk < HDM; kk += 4) {
        double av[SWM][2], bv[SWN];
#pragma unroll
        for (int i = 0; i < SWM; ++i)
#pragma unroll
          for (int h = 0; h < 2; ++h)
            av[i][h] = Qs[(m0 + 16 * i + 8 * h + g) * LDK + kk + t];
#pragma unroll
        for (int j = 0; j < SWN; ++j)
          bv[j] = Kc[(n0 + 8 * j + g) * LDK + kk + t];
#pragma unroll
        for (int i = 0; i < SWM; ++i)
#pragma unroll
          for (int j = 0; j < SWN; ++j) dmma(acc[i][j], av[i], bv[j]);
      }
#pragma unroll
      for (int i = 0; i < SWM; ++i)
#pragma unroll
        for (int j = 0; j < SWN; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int jj = j0 + n0 + 8 * j + 2 * t + (e & 1);
            if (jj >= N) continue;
            const float sv = static_cast<float>(acc[i][j][e]) * a.scale;
            S[(m0 + 16 * i + 8 * (e >> 1) + g) * lds + jj] =
                jj < a.n_valid ? sv : -1e30f;
          }
    }
    advance(c);
  }
  QVT_STAMP(1);

  // softmax per row (the tile's last rows past N skipped)
  if (rows == QT)
    softmax_rows<RW, false>(S + warp * lds, lds, N, RW, a.v_dt);
  else
    softmax_rows<RW, true>(S + warp * lds, lds, N, (rows - warp + NW - 1) / NW,
                           a.v_dt);
  __syncthreads();
  QVT_STAMP(2);

  // o[r][c] = f32(sum_j p[r][j] v[j][c]); each warp keeps its patch in
  // f64 over all of V's chunks
  const int om0 = warp / OG.wc * OWM * 16, on0 = warp % OG.wc * OWN * 8;
  const bool owner = warp < OG.wr * OG.wc && om0 < rows;
  double oacc[OWM][OWN][4] = {};
  for (int c = nk; c < nc; ++c) {
    const float* Vc = Cb + (c & 1) * KC * LDV;
    const int j0 = chunk_r0(c), kc = chunk_rows(c);
    if (owner) {
      const float* P = S + om0 * lds + j0;
#pragma unroll 4
      for (int kk = 0; kk < kc; kk += 4) {
        double av[OWM][2], bv[OWN];
#pragma unroll
        for (int i = 0; i < OWM; ++i)
#pragma unroll
          for (int h = 0; h < 2; ++h)
            av[i][h] =
                static_cast<double>(P[(16 * i + 8 * h + g) * lds + kk + t]);
#pragma unroll
        for (int j = 0; j < OWN; ++j)
          bv[j] = Vc[(kk + t) * LDV + on0 + 8 * j + g];
#pragma unroll
        for (int i = 0; i < OWM; ++i)
#pragma unroll
          for (int j = 0; j < OWN; ++j) dmma(oacc[i][j], av[i], bv[j]);
      }
    }
    advance(c);
  }

  const float d = a.prm ? a.prm[0] : 1.f, tq = a.prm ? a.prm[1] : 1.f;
  if (owner) {
#pragma unroll
    for (int i = 0; i < OWM; ++i)
#pragma unroll
      for (int j = 0; j < OWN; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = om0 + 16 * i + 8 * (e >> 1) + g;
          const int col = on0 + 8 * j + 2 * t + (e & 1);
          if (r >= rows || col >= hd) continue;
          const long long oi =
              base + static_cast<long long>(q0 + r) * hd + col;
          const float v = static_cast<float>(oacc[i][j][e]);
          if (a.out_dt == qvt::DT_INT8)
            static_cast<int8_t*>(a.out)[oi] =
                qvt::quantize(v, d, tq, a.top, a.out_pow, false);
          else
            qvt::store_f(a.out, a.out_dt, oi, v);
        }
  }
  QVT_STAMPS_STORE((blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x +
                   blockIdx.x);
}

template <int QT, int HDM>
int launch(const Args& a, size_t smem, cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(
      flash_kernel<QT, HDM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((a.N + QT - 1) / QT, a.H, a.B);
  flash_kernel<QT, HDM><<<grid, NT, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int HDM>
int launch_qt(const Args& a, size_t smem, cudaStream_t stream) {
  if (a.qt == 64) return launch<64, HDM>(a, smem, stream);
  if (a.qt == 32) return launch<32, HDM>(a, smem, stream);
  return launch<16, HDM>(a, smem, stream);
}

}  // namespace

// qt: query rows per block, 64, 32 or 16 (ops/attention.py:
// flash_tile_rows); cudaErrorInvalidValue if the block does not fit
extern "C" int qvt_flash_attention(const void* q, int q_dt, const void* k,
                                   int k_dt, const void* v, int v_dt,
                                   void* out, int out_dt, const void* prm,
                                   int B, int H, int N, int hd, int n_valid,
                                   int qt, float scale, int out_top,
                                   int out_pow, void* stream) {
  if ((qt != 64 && qt != 32 && qt != 16) || hd < 1 || hd > 128 || N < 1 ||
      B > 65535 || H > 65535 || smem_bytes(qt, N, hd) > SMEM_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.q_dt = q_dt;
  a.k_dt = k_dt;
  a.v_dt = v_dt;
  a.out = out;
  a.out_dt = out_dt;
  a.prm = static_cast<const float*>(prm);
  a.B = B;
  a.H = H;
  a.N = N;
  a.hd = hd;
  a.n_valid = n_valid;
  a.qt = qt;
  a.scale = scale;
  a.top = static_cast<float>(out_top);
  a.out_pow = out_pow;
  const size_t smem = smem_bytes(qt, N, hd);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int hdm = head_bound(hd);
  if (hdm == 64) return launch_qt<64>(a, smem, st);
  if (hdm == 80) return launch_qt<80>(a, smem, st);
  return launch_qt<128>(a, smem, st);
}

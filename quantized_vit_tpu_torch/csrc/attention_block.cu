// K3: attention residual branch for Hopper (sm_90a), first of its two
// launches (the second is K1 with the residual epilogue for proj).
//
// Replaces the TPU kernel quantized_vit_tpu/ops/attention.py:
// _attn_block_kernel (pallas_call in _attention_block, attention.py:667),
// which computes x + proj(quant(softmax(q k^T s) v)) with
// q/k/v = qkv(quant(LN(x))). This launch writes the int8 attention levels
// [B*N, H*hd] of the proj quantizer:
//   alv = levels(attn(qkv(quant(LN(x))))) per head.
//
// Design: one cooperative launch of a persistent grid (two blocks of 256
// threads on each SM), three phases split by two grid barriers.
//   1. LayerNorm (fast variance, sums in f64) and quant, once per row: a
//      warp per row writes the row's int8 levels into a scratch
//      [M, Dp] (Dp = D rounded up to 64, zero past D; 5.1 MB at ViT-B/16
//      batch 32). The first design redid both in every head's block (12
//      times at ViT-B).
//   2. The qkv GEMM on the int8 tensor cores (int8_gemm.cuh's tile,
//      shared with K2): 128 x 128 output tiles over the blocks, 128-deep
//      k steps through a three-stage cp.async ring
//      (levels and the n-major weight of the layer's plan, both as raw
//      16-byte pieces; packed int4 pieces land as they are and each B
//      fragment is unpacked in registers as it loads), fragments by
//      ldmatrix, mma.sync m16n8k32 s8 into int32, 8 warps of 64 x 32.
//      The epilogue acc * qs + qb (one rounding each, -fmad=false) is
//      rounded to the residual dtype, as the TPU scratch is
//      (attention.py:469), and written to a q/k/v scratch [M, 3*H*hd] in
//      the layout of the fused-qkv tensor (30.7 MB at ViT-B batch 32 in
//      bf16, mostly held in the 50 MB L2).
//   3. The attention of K6, over (tile of R query rows, head, image)
//      items: qkv_attention.cuh's qkv_attn_tile, reading the scratch
//      through L2 (q staged once as f32, K/V through the 64-key cp.async
//      ring, both products on mma.sync m16n8k4 .f64, int_attention's
//      scales from a scan of the head's rows), R = 64, 32 or 16 from the
//      wrapper (ops/attention.py:heads_tile_rows, K6's rule on this
//      kernel's shared memory). No token count enters shared memory.
// Shared memory is the larger of the GEMM ring (110,592 bytes) and the
// attention tile's (at most 112,640), so two blocks fit an SM.
//
// Numerics: those of the plain version (ops/attention.py:
// attention_heads_plain: K1's ln_quant, then attention_qkv_plain): the
// levels of LayerNorm are exact, the int32 GEMM is exact, and the
// attention is K6's, whose f64 sums change only the order of the
// additions of exact products.
//
// Bound on this card at ViT-B batch 32: 23.6 G int8 ops (11.9 us at 1,979
// TOPS) and 4.25 G attention operations; exact only in f64, so their
// ceiling is 4.25 GFLOP over the FP64 tensor cores' 67 TFLOP/s (63.5 us);
// ~17 MB in and out (5 us): the FP64 attention bounds it.

#include <cooperative_groups.h>

#include <algorithm>

#include "int8_gemm.cuh"
#include "qkv_attention.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int NT = qvt::QA_NT, NW = qvt::QA_NW;
// the GEMM (int8_gemm.cuh): BM x BN tiles of BK-deep steps; warps 2 x 4
// of WM x WN
constexpr int BM = 128, BN = 128, BK = qvt::GT_BK;
constexpr int WM = 64, WN = 32, TM = WM / 16, TN = WN / 8;
constexpr int GEMM_SMEM = qvt::gemm_ring_bytes(BM, BN);

// dynamic shared memory at R query rows, head bound HDM, qkv dtype of es
// bytes (mirrored by ops/attention.py:heads_smem_bytes)
__host__ __device__ constexpr int smem_bytes(int R, int HDM, int es) {
  return qvt::qkv_attn_smem(R, HDM, es) > GEMM_SMEM
             ? qvt::qkv_attn_smem(R, HDM, es)
             : GEMM_SMEM;
}
static_assert(2 * (smem_bytes(64, qvt::QA_HDMAX, 4) + qvt::QA_STATIC +
                   1024) <= 233472,
              "two blocks of K3 fit an SM");

struct Args {
  const void* x;
  int x_dt;
  qvt::WeightT wq;  // D x 3*H*hd levels, transposed: [3*H*hd][D(/2)]
  const float* qs;
  const float* qb;
  const float* ln_g;
  const float* ln_b;
  const float* prm;  // act_d, act_t, out_d, out_t
  int8_t* lv;        // scratch: the levels of LN(x) [M][Dp]
  void* qkv;         // scratch: q/k/v [M][3*H*hd] in the qkv dtype
  int8_t* alv;
  int B, n, D, Dp, heads, hd, n_valid, nk;
  float q_mul, sm_scale;
  bool int_attn;
  int qkv_dt;
  int act_pow, out_pow;
  float act_top, out_top, eps;
  bool x_vec, w_vec, out_vec;
};

// Phase 1: the int8 levels of quant(LN(x)) into a.lv. The statistics are
// qvt::ln_stats' (f64 sums of x and of x*x taken in f32, rounded once;
// any order gives the same f32), the levels those of the first K3
// ((x - mu) * rs * gamma + beta, the linear quantizer's 1/d folded into
// gamma/beta by the plan). On the 16-byte path a group of G = 8, 16 or 32
// lanes takes a row (at most 12 pieces a lane), so a warp loads 32 / G
// rows at once; the second pass loads the row's pieces again (from L1);
// gamma and beta load as float4. Else a warp a row.
__device__ __forceinline__ void ln_quant_rows(const Args& a) {
  const int lane = threadIdx.x & 31;
  const long long M = static_cast<long long>(a.B) * a.n;
  const long long wid = static_cast<long long>(blockIdx.x) * NW +
                        (threadIdx.x >> 5);
  const long long nwarps = static_cast<long long>(gridDim.x) * NW;
  const int D = a.D;
  const float inv_k = 1.0f / static_cast<float>(D);
  const float act_d = a.prm[0], act_t = a.prm[1];
  const bool bf = a.x_dt == qvt::DT_BF16;
  auto level = [&](float v, float mu, float rs, float g,
                   float b) -> uint32_t {
    const float y = (v - mu) * rs * g + b;
    return static_cast<uint8_t>(qvt::quantize(y, act_d, act_t, a.act_top,
                                              a.act_pow, !a.act_pow));
  };
  auto stats = [&](double s, double s2, int width, float& mu, float& rs) {
    for (int o = width / 2; o > 0; o >>= 1) {
      s += __shfl_xor_sync(0xffffffffu, s, o);
      s2 += __shfl_xor_sync(0xffffffffu, s2, o);
    }
    mu = static_cast<float>(s) * inv_k;
    const float var = fmaxf(static_cast<float>(s2) * inv_k - mu * mu, 0.f);
    rs = 1.0f / sqrtf(var + a.eps);
  };
  if (!a.x_vec) {
    for (long long r = wid; r < M; r += nwarps) {
      const long long base = r * D;
      double s = 0.0, s2 = 0.0;
      for (int k = lane; k < D; k += 32) {
        const float v = qvt::load_f(a.x, a.x_dt, base + k);
        s += static_cast<double>(v);
        s2 += static_cast<double>(v * v);
      }
      float mu, rs;
      stats(s, s2, 32, mu, rs);
      int8_t* out = a.lv + r * a.Dp;
      for (int k = lane; k < D; k += 32)
        out[k] = static_cast<int8_t>(level(qvt::load_f(a.x, a.x_dt, base + k),
                                           mu, rs, a.ln_g[k], a.ln_b[k]));
      for (int k = D + lane; k < a.Dp; k += 32) out[k] = 0;
    }
    return;
  }
  const int epp = bf ? 8 : 4, np = D / epp;  // 16-byte pieces a row
  const int G = np <= 96 ? 8 : np <= 192 ? 16 : 32;
  const int per = 32 / G, gl = lane % G;
  const char* xb = static_cast<const char*>(a.x);
  for (long long r0 = wid * per; r0 < M; r0 += nwarps * per) {
    const long long r = r0 + lane / G;
    const bool live = r < M;  // a dead row's lanes still shuffle
    const long long base = r * D;
    auto piece = [&](int q) {
      return __ldg(reinterpret_cast<const uint4*>(
          xb + (base + static_cast<long long>(q) * epp) * (bf ? 2 : 4)));
    };
    double s = 0.0, s2 = 0.0;
    for (int q = gl; live && q < np; q += G) {
      const uint4 u = piece(q);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        if (e >= epp) break;
        const float v = qvt::piece_at(u, bf, e);
        s += static_cast<double>(v);
        s2 += static_cast<double>(v * v);
      }
    }
    float mu, rs;
    stats(s, s2, G, mu, rs);
    if (!live) continue;
    int8_t* out = a.lv + r * a.Dp;
    auto put = [&](int q, const uint4 u) {
      const int k = q * epp;
      float gv[8], bv[8];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (h * 4 >= epp) break;
        const float4 g4 =
            __ldg(reinterpret_cast<const float4*>(a.ln_g + k) + h);
        const float4 b4 =
            __ldg(reinterpret_cast<const float4*>(a.ln_b + k) + h);
        gv[4 * h] = g4.x, gv[4 * h + 1] = g4.y, gv[4 * h + 2] = g4.z;
        gv[4 * h + 3] = g4.w;
        bv[4 * h] = b4.x, bv[4 * h + 1] = b4.y, bv[4 * h + 2] = b4.z;
        bv[4 * h + 3] = b4.w;
      }
      uint32_t w[2] = {0u, 0u};
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        if (e >= epp) break;
        w[e >> 2] |= level(qvt::piece_at(u, bf, e), mu, rs, gv[e], bv[e])
                     << (8 * (e & 3));
      }
      if (bf)
        *reinterpret_cast<uint2*>(out + k) = make_uint2(w[0], w[1]);
      else
        *reinterpret_cast<uint32_t*>(out + k) = w[0];
    };
    for (int q = gl; q < np; q += G) put(q, piece(q));
    for (int k = D + gl * 16; k < a.Dp; k += G * 16)  // Dp - D: 16 | both
      *reinterpret_cast<uint4*>(out + k) = make_uint4(0u, 0u, 0u, 0u);
  }
}

__device__ __forceinline__ void store_pair(float* p, float y0, float y1) {
  *reinterpret_cast<float2*>(p) = make_float2(y0, y1);
}
__device__ __forceinline__ void store_pair(__nv_bfloat16* p, float y0,
                                           float y1) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(y0, y1);
}

// Phase 2: q/k/v = levels @ Wqkv * qs (+ qb), rounded to T, into a.qkv:
// int8_gemm.cuh's tile over the 128 x 128 output tiles.
template <typename T>
__device__ __forceinline__ void qkv_gemm(const Args& a, int8_t* smem) {
  const int M = a.B * a.n, N = 3 * a.heads * a.hd;
  const int nkt = (a.Dp + BK - 1) / BK;
  const int tiles_n = (N + BN - 1) / BN;
  const int tiles = (M + BM - 1) / BM * tiles_n;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp / (BN / WN) * WM, wn = warp % (BN / WN) * WN;
  T* qkv = static_cast<T*>(a.qkv);
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int row0 = tile / tiles_n * BM, col0 = tile % tiles_n * BN;
    int acc[TM][TN][4];
    qvt::gemm_tile<BM, BN, WM, WN, NT>(acc, a.lv, a.Dp, M, a.wq, a.w_vec,
                                       row0, col0, 0, nkt, smem);
    // dequant + bias, rounded to T: columns 2t, 2t + 1 of each n8 tile
    // (N is a multiple of 8)
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int col = col0 + wn + 8 * j + 2 * t;
      const int cl = min(col, N - 2);
      const float s0 = __ldg(a.qs + cl), s1 = __ldg(a.qs + cl + 1);
      const float b0 = a.qb ? __ldg(a.qb + cl) : 0.f;
      const float b1 = a.qb ? __ldg(a.qb + cl + 1) : 0.f;
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int row = row0 + wm + 16 * i + g + 8 * hh;
          if (row >= M || col >= N) continue;
          float y0 = static_cast<float>(acc[i][j][2 * hh]) * s0;
          float y1 = static_cast<float>(acc[i][j][2 * hh + 1]) * s1;
          if (a.qb) {
            y0 = y0 + b0;
            y1 = y1 + b1;
          }
          store_pair(qkv + static_cast<long long>(row) * N + col, y0, y1);
        }
    }
  }
}

// Phase 3: K6's attention over the (query tile, head, image) items
template <typename T, int R, int HDM>
__device__ __forceinline__ void attention_items(const Args& a,
                                                unsigned char* smem,
                                                qvt::PhaseClock& clk) {
  qvt::QkvAttnArgs q;
  q.qkv = a.qkv;
  q.qkv_dt = a.qkv_dt;
  q.out = a.alv;
  q.out_dt = qvt::DT_INT8;
  q.out_mode = a.out_pow ? qvt::QA_OUT_POW : qvt::QA_OUT_LEVELS;
  q.out_es = 1;
  q.prm = a.prm + 2;  // out_d, out_t
  q.B = a.B;
  q.n = a.n;
  q.heads = a.heads;
  q.hd = a.hd;
  q.n_valid = a.n_valid;
  q.nk = a.nk;  // keys past nk are masked (attention.py:_n_keys)
  q.q_mul = a.q_mul;
  q.sm_scale = a.sm_scale;
  q.out_top = a.out_top;
  q.int_attn = a.int_attn;
  q.qkv_vec = true;  // the scratch: 16-byte rows and base
  q.out_vec = a.out_vec;
  const int nqt = (a.n + R - 1) / R, items = nqt * a.heads * a.B;
  for (int it = blockIdx.x; it < items; it += gridDim.x) {
    const int hb = it / nqt;
    qvt::qkv_attn_tile<T, R, HDM, false, true>(q, (it - hb * nqt) * R,
                                               hb % a.heads, hb / a.heads,
                                               smem, clk);
    __syncthreads();  // the next item's q rows overwrite this output tile
  }
}

template <typename T, int R, int HDM>
__global__ void __launch_bounds__(NT, 2) heads_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::grid_group grid = cg::this_grid();
  qvt::PhaseClock clk;  // tools/phase_probe.py attention_block
  clk.begin();
  ln_quant_rows(a);
  clk.mark(0);
  grid.sync();
  clk.mark(1);
  qkv_gemm<T>(a, reinterpret_cast<int8_t*>(smem));
  clk.mark(2);
  grid.sync();
  clk.mark(3);
  attention_items<T, R, HDM>(a, smem, clk);
  clk.mark(4);
  clk.store(blockIdx.x);
}

// blocks of one instantiation co-resident on an SM (0 on an error)
template <typename T, int R, int HDM>
int per_sm() {
  static int cached = -1;
  if (cached < 0) {
    constexpr int smem = smem_bytes(R, HDM, sizeof(T));
    int v = 0;
    if (cudaFuncSetAttribute(heads_kernel<T, R, HDM>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem) != cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &v, heads_kernel<T, R, HDM>, NT, smem) != cudaSuccess)
      return 0;
    cached = v;
  }
  return cached;
}

template <typename T, int R, int HDM>
cudaError_t launch(Args& a, int sms, cudaStream_t stream) {
  const int cap = per_sm<T, R, HDM>() * sms;
  if (cap < 1) return cudaErrorInvalidConfiguration;
  // enough blocks for the largest phase: rows a warp, GEMM tiles, items
  const long long M = static_cast<long long>(a.B) * a.n;
  const long long N = 3LL * a.heads * a.hd;
  const long long want = std::max(
      std::max((M + NW - 1) / NW, (M + BM - 1) / BM * ((N + BN - 1) / BN)),
      static_cast<long long>((a.n + R - 1) / R) * a.heads * a.B);
  const int grid = static_cast<int>(std::min<long long>(cap, want));
  void* args[] = {&a};
  cudaError_t e = cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(heads_kernel<T, R, HDM>), dim3(grid), dim3(NT),
      args, smem_bytes(R, HDM, sizeof(T)), stream);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

template <typename T, int HDM>
cudaError_t launch_rows(Args& a, int rows, int sms, cudaStream_t stream) {
  if (rows == 64) return launch<T, 64, HDM>(a, sms, stream);
  if (rows == 32) return launch<T, 32, HDM>(a, sms, stream);
  return launch<T, 16, HDM>(a, sms, stream);
}

}  // namespace

// rows: query rows an attention item, 64, 32 or 16 (ops/attention.py:
// heads_tile_rows picks it). lv: scratch of B*n rows of Dp bytes (Dp a
// multiple of 64, >= D); qkv: scratch [B*n, 3*heads*hd] in the qkv dtype;
// both 16-byte aligned.
extern "C" int qvt_attention_heads(
    const void* x, int x_dt, const void* wq, int wq_int4, const void* qs,
    const void* qb, const void* ln_g, const void* ln_b, const void* prm,
    void* lv, void* qkv, void* alv, int B, int n, int D, int Dp, int heads,
    int hd, int n_valid, int nk, int rows, float q_mul, float sm_scale,
    int int_attn, int qkv_dt, int act_pow, int out_pow, int act_top,
    int out_top, float eps, void* stream) {
  if (hd > qvt::QA_HDMAX || hd % 8 || nk > n || n_valid > nk ||
      Dp % 64 || Dp < D ||
      (qkv_dt != qvt::DT_BF16 && qkv_dt != qvt::DT_F32) ||
      (rows != 64 && rows != 32 && rows != 16) ||
      (reinterpret_cast<uintptr_t>(lv) & 15) ||
      (reinterpret_cast<uintptr_t>(qkv) & 15) ||
      (reinterpret_cast<uintptr_t>(alv) & 7))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.x = x;
  a.x_dt = x_dt;
  a.wq = qvt::WeightT{static_cast<const int8_t*>(wq), D, 3 * heads * hd,
                      wq_int4};
  a.qs = static_cast<const float*>(qs);
  a.qb = static_cast<const float*>(qb);
  a.ln_g = static_cast<const float*>(ln_g);
  a.ln_b = static_cast<const float*>(ln_b);
  a.prm = static_cast<const float*>(prm);
  a.lv = static_cast<int8_t*>(lv);
  a.qkv = qkv;
  a.alv = static_cast<int8_t*>(alv);
  a.B = B;
  a.n = n;
  a.D = D;
  a.Dp = Dp;
  a.heads = heads;
  a.hd = hd;
  a.n_valid = n_valid;
  a.nk = nk;
  a.q_mul = q_mul;
  a.sm_scale = sm_scale;
  a.int_attn = int_attn != 0;
  a.qkv_dt = qkv_dt;
  a.act_pow = act_pow;
  a.out_pow = out_pow;
  a.act_top = static_cast<float>(act_top);
  a.out_top = static_cast<float>(out_top);
  a.eps = eps;
  const bool x_al = (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  // the 16-byte path: rows of whole pieces; gamma, beta as float4
  a.x_vec = x_al && D % 16 == 0 &&
            (x_dt == qvt::DT_BF16 || x_dt == qvt::DT_F32) &&
            ((reinterpret_cast<uintptr_t>(ln_g) |
              reinterpret_cast<uintptr_t>(ln_b)) & 15) == 0;
  // WeightT::vec_ok, on the host
  a.w_vec = D % 16 == 0 && (!wq_int4 || (D / 2) % 16 == 0) &&
            (reinterpret_cast<uintptr_t>(wq) & 15) == 0;
  a.out_vec = hd % 16 == 0 && (reinterpret_cast<uintptr_t>(alv) & 15) == 0;
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (qkv_dt == qvt::DT_BF16)
    e = hd <= 64 ? launch_rows<__nv_bfloat16, 64>(a, rows, sms, st)
                 : launch_rows<__nv_bfloat16, 80>(a, rows, sms, st);
  else
    e = hd <= 64 ? launch_rows<float, 64>(a, rows, sms, st)
                 : launch_rows<float, 80>(a, rows, sms, st);
  return static_cast<int>(e);
}

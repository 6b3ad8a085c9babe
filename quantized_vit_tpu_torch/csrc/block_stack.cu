// K5: the whole ViT block stack in one launch, for Hopper (sm_90a).
//
// Replaces the TPU kernel quantized_vit_tpu/ops/block_stack.py:
// _block_stack_kernel (pallas_call in _vit_block_stack, block_stack.py:341),
// the batch-1 latency path: x [j*n, D] -> x after `depth` blocks, each
//   x2 = x + proj(quant(attn(qkv(quant(LN1(x))))))   (rounded to the
//                                                      residual dtype)
//   x  = x2 + fc2(quant(GELU(fc1(quant(LN2(x2))))))
// with every block's own stacked weights and per-layer quantizer scalars
// ([8][L] on the device, indexed by block). The TPU kernel's point is one
// dispatch for the whole depth, and so is this kernel's.
//
// Design: a persistent cooperative grid, one 256-thread block per SM,
// walks the blocks' phases with grid-wide barriers between them:
//   A. per row (a warp each): the previous block's fc2 residual
//      (int32 split-K sums * s2 + b2 + x2, rounded), LN1 statistics and the
//      quantized levels -> lv;
//   1. qkv GEMM, 32x64 output tiles over the whole grid -> qkv (f32,
//      rounded to the residual dtype as the TPU scratch is,
//      block_stack.py:110);
//   2. attention per (image, head, 64-row query tile): k/v of the head and
//      the tile's q into shared memory, the attention core of
//      attention_core.cuh (shared with K3 and K6) -> int8 levels alv;
//   3. proj GEMM, split over K, int32 atomics into acc_p (exact in any
//      order);
//   B. per row: x2 = acc_p * ps + pb + x, rounded to the residual dtype
//      before LN2 (block_stack.py:151-155), LN2 statistics and levels -> lv;
//   4. fc1 GEMM with the GELU + quant epilogue -> hidden levels;
//   5. fc2 GEMM, split over K, int32 atomics into acc2.
// A last row phase writes the final residual. Seven barriers per block
// (tools/phase_probe.py times the phases from QVT_GRID_STAMP).
// The residual stream and the qkv, alv, hidden and accumulator scratches
// live in device memory; at batch 1 all of them (under 2 MB) stay in the
// 50 MB L2. Padded query rows are computed like real ones. Packed int4 w2
// pairs hidden rows h and h + hid/2 (block_stack.py:170-183): the n-major
// WeightT walks that layout as in K1/K2.
//
// Bound on this card at ViT-B batch 1 (208 rows, L = 12): 35.3 G int8 ops
// (1,979 TOPS: 17.9 us) and 1.6 G attention ops at the bf16 rate (1.6 us)
// against 42.5 MB of packed weights (12.7 us at 3.35 TB/s): about 19.5 us,
// operations. This first version uses mma.sync on synchronously filled
// tiles, f64 attention and 85 grid barriers, and does not prefetch the
// next block's weights, so it is far from that.

#include <cooperative_groups.h>

#include "attention_core.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int NT = 256, NW = NT / 32;
constexpr int BM = 32, BN = 64, BK = 64, SK = BK + 16;
constexpr int QT = 8 * NW;    // query rows per attention unit
constexpr int MAX_D = 1024;   // a lane keeps D/32 values of a row
constexpr int HDMAX = 64;     // the attention core's head bound here
constexpr int MAX_PER_LANE = MAX_D / 32;

// quantizer scalars, rows of the [8][L] prm array
enum {
  P_ACT_D, P_ACT_T, P_OUT_D, P_OUT_T, P_MLP_D, P_MLP_T, P_HID_D, P_HID_T
};

struct Args {
  const void* x_in;  // [R, D] residual dtype
  void* x;           // [R, D] residual stream, the output
  int dt;
  // stacked per-block operands, weights n-major: [L][N][K] or [L][N][K/2]
  const int8_t *wq, *wp, *w1, *w2;
  int int4;
  const float *qs, *qb, *l1g, *l1b, *ps, *pb, *l2g, *l2b, *s1, *b1, *s2,
      *b2;
  const float* prm;  // [8][L]
  // scratch
  int8_t* lv;   // [R, D] LN levels
  float* qkv;   // [R, 3HD]
  int8_t* alv;  // [R, HD]
  int8_t* hlv;  // [R, hid]
  int* acc_p;   // [R, D]
  int* acc2;    // [R, D]
  void* x2;     // [R, D] residual dtype
  int L, j_imgs, n, n_valid, nk, D, heads, hd, hid;
  float q_mul;
  int act_pow, out_pow, mlp_pow, hid_pow;
  float act_top, out_top, mlp_top, hid_top, eps;
};

__device__ __forceinline__ float load_cg(const void* p, int dt, long long i) {
  if (dt == qvt::DT_F32) return __ldcg(static_cast<const float*>(p) + i);
  const unsigned short u = __ldcg(static_cast<const unsigned short*>(p) + i);
  return __uint_as_float(static_cast<uint32_t>(u) << 16);
}

__device__ __forceinline__ qvt::WeightT layer_w(const int8_t* w, int l, int K,
                                                int N, int int4) {
  const long long per = static_cast<long long>(N) * (int4 ? K / 2 : K);
  return qvt::WeightT{w + l * per, K, N, int4};
}

// One BM x BN output tile of A [M, K] (int8 levels written earlier in this
// launch, row stride K) times w (K x N), over k in [k0, k1); epi(row, col,
// acc) for each element inside [M, N]. 8 warps of 16 x 16.
template <class Epi>
__device__ __forceinline__ void gemm_tile(const int8_t* A, int M, int K,
                                          const qvt::WeightT& w, int m0,
                                          int n0, int k0, int k1, int8_t* As,
                                          int8_t* Bs, Epi epi) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = (warp & 1) * 16, wn = (warp >> 1) * 16;
  int acc[1][2][4];
  qvt::zero_acc(acc);
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  for (int kk = k0; kk < k1; kk += BK) {
    qvt::fill_rows16(As, BM, SK, BK, [&](int r, int c) -> uint4 {
      const int row = m0 + r, k = kk + c;
      if (row >= M || k >= k1) return zero;
      return __ldcg(reinterpret_cast<const uint4*>(
          A + static_cast<long long>(row) * K + k));
    });
    qvt::fill_rows16(Bs, BN, SK, BK, [&](int j, int c) -> uint4 {
      const int k = kk + c;
      return k < k1 ? w.vec16(k, n0 + j) : zero;
    });
    __syncthreads();
    qvt::warp_mma<1, 2>(acc, As, SK, Bs, SK, BK, wm, wn, lane);
    __syncthreads();
  }
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = m0 + wm + g + (r >= 2 ? 8 : 0);
      const int col = n0 + wn + j * 8 + t * 2 + (r & 1);
      if (row < M && col < w.N) epi(row, col, acc[0][j][r]);
    }
}

// A GEMM phase: every (row tile, column tile, K split) unit of A x w, the
// units spread over the grid. splits > 1 only with an additive epilogue.
template <class Epi>
__device__ __forceinline__ void gemm_phase(const int8_t* A, int M,
                                           const qvt::WeightT& w, int splits,
                                           int8_t* As, int8_t* Bs, Epi epi) {
  const int K = w.K;
  const int tm = (M + BM - 1) / BM, tn = (w.N + BN - 1) / BN;
  const int kc = ((K + splits - 1) / splits + BK - 1) / BK * BK;
  const int units = tm * tn * splits;
  for (int u = blockIdx.x; u < units; u += gridDim.x) {
    const int s = u % splits, tile = u / splits;
    const int k0 = s * kc, k1 = min(K, k0 + kc);
    if (k0 >= k1) continue;
    gemm_tile(A, M, K, w, (tile / tn) * BM, (tile % tn) * BN, k0, k1, As, Bs,
              epi);
  }
}

// K splits for an accumulating GEMM: enough units for the grid, and no
// more work per unit than a K = 768 tile
__device__ __forceinline__ int k_splits(int M, int N, int K) {
  const int tiles = ((M + BM - 1) / BM) * ((N + BN - 1) / BN);
  int s = max((static_cast<int>(gridDim.x) + tiles - 1) / tiles,
              (K + 767) / 768);
  return max(1, min(s, K / BK));
}

// A row phase: LN statistics of the row values v (the residual dtype's
// values, lane k%32 holding k), then the quantized levels into lv.
__device__ __forceinline__ void ln_quant_row(const float (&v)[MAX_PER_LANE],
                                             int D, long long r,
                                             const float* g, const float* b,
                                             float d, float t, float top,
                                             bool pow_map, float eps,
                                             int8_t* lv) {
  const int lane = threadIdx.x & 31;
  double s = 0.0, s2 = 0.0;
#pragma unroll
  for (int j = 0; j < MAX_PER_LANE; ++j) {
    if (j * 32 >= D) break;
    s += static_cast<double>(v[j]);
    s2 += static_cast<double>(v[j] * v[j]);
  }
  s = qvt::warp_sum(s);
  s2 = qvt::warp_sum(s2);
  const float inv_k = 1.0f / static_cast<float>(D);
  const float mu = static_cast<float>(s) * inv_k;
  const float var = fmaxf(static_cast<float>(s2) * inv_k - mu * mu, 0.f);
  const float rs = 1.0f / sqrtf(var + eps);
#pragma unroll
  for (int j = 0; j < MAX_PER_LANE; ++j) {
    if (j * 32 >= D) break;
    const int k = lane + 32 * j;
    const float y = (v[j] - mu) * rs * g[k] + b[k];
    lv[r * D + k] = qvt::quantize(y, d, t, top, pow_map, !pow_map);
  }
}

__global__ void __launch_bounds__(NT, 1) stack_kernel(Args a) {
  extern __shared__ __align__(16) int8_t smem[];
  cg::grid_group grid = cg::this_grid();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int D = a.D, hd = a.hd, HD = a.heads * hd, hid = a.hid, L = a.L;
  const int R = a.j_imgs * a.n;
  const int gwarp = blockIdx.x * NW + warp, nwarps = gridDim.x * NW;
  int8_t* As = smem;
  int8_t* Bs = smem + BM * SK;
  const int RQ = qvt::att_q_stride(hd), RV = qvt::att_v_stride(hd);
  float* q_s = reinterpret_cast<float*>(smem);
  float* k_s = q_s + QT * RQ;
  float* v_s = k_s + a.nk * RQ;

  QVT_GRID_STAMP(0);
  for (int l = 0; l <= L; ++l) {
    const float* P = a.prm;
    // ---- A: the residual after block l-1's MLP; LN1 + quant of block l
    for (int r = gwarp; r < R; r += nwarps) {
      float v[MAX_PER_LANE];
#pragma unroll
      for (int j = 0; j < MAX_PER_LANE; ++j) {
        if (j * 32 >= D) break;
        const long long i = static_cast<long long>(r) * D + lane + 32 * j;
        const int k = lane + 32 * j;
        float x;
        if (l == 0) {
          x = qvt::load_f(a.x_in, a.dt, i);
          a.acc_p[i] = 0;
        } else {
          float y = static_cast<float>(__ldcg(a.acc2 + i)) *
                    a.s2[(l - 1) * D + k];
          y = y + a.b2[(l - 1) * D + k];
          x = qvt::round_to(y + load_cg(a.x2, a.dt, i), a.dt);
        }
        qvt::store_f(a.x, a.dt, i, x);
        a.acc2[i] = 0;
        v[j] = x;
      }
      if (l < L)
        ln_quant_row(v, D, r, a.l1g + l * D, a.l1b + l * D,
                     P[P_ACT_D * L + l], P[P_ACT_T * L + l], a.act_top,
                     a.act_pow, a.eps, a.lv);
    }
    if (l == L) break;
    grid.sync();
    QVT_GRID_STAMP(l * 7 + 1);

    // ---- 1: qkv = lv @ Wq, dequant + bias, rounded to the residual dtype
    {
      const float* qs = a.qs + static_cast<long long>(l) * 3 * HD;
      const float* qb = a.qb + static_cast<long long>(l) * 3 * HD;
      gemm_phase(a.lv, R, layer_w(a.wq, l, D, 3 * HD, a.int4), 1, As, Bs,
                 [&](int row, int col, int acc) {
                   float y = static_cast<float>(acc) * qs[col];
                   y = y + qb[col];
                   a.qkv[static_cast<long long>(row) * 3 * HD + col] =
                       qvt::round_to(y, a.dt);
                 });
    }
    grid.sync();
    QVT_GRID_STAMP(l * 7 + 2);

    // ---- 2: attention per (image, head, query tile) -> alv
    {
      const int qtiles = (a.n + QT - 1) / QT;
      const int units = a.j_imgs * a.heads * qtiles;
      for (int u = blockIdx.x; u < units; u += gridDim.x) {
        const int qt = u % qtiles, h = (u / qtiles) % a.heads;
        const int jimg = u / (qtiles * a.heads);
        const long long img0 = static_cast<long long>(jimg) * a.n;
        const int q0 = qt * QT, nq = min(QT, a.n - q0);
        const int W = 3 * HD;
        const int rows = max(a.nk, nq);
        for (int i = threadIdx.x; i < rows * hd; i += NT) {
          const int r = i / hd, c = i - r * hd;
          const float* src = a.qkv + (img0 + r) * W + h * hd + c;
          if (r < a.nk) {
            k_s[r * RQ + c] = __ldcg(src + HD);
            v_s[r * RV + c] = __ldcg(src + 2 * HD);
          }
          if (r < nq)
            q_s[r * RQ + c] =
                __ldcg(src + static_cast<long long>(q0) * W);
        }
        __syncthreads();
        qvt::AttnArgs<> at;
        at.q = q_s;
        at.k = k_s;
        at.v = v_s;
        at.rq = RQ;
        at.rv = RV;
        at.nq = nq;
        at.n_kv = a.nk;
        at.n_valid = a.n_valid;
        at.hd = hd;
        at.q_mul = a.q_mul;
        at.sm_scale = 0.f;
        at.qkv_dt = a.dt;
        at.int_attn = false;
        at.out_mode = a.out_pow ? qvt::ATT_OUT_POW : qvt::ATT_OUT_LEVELS;
        at.out = a.alv;
        at.out_dt = qvt::DT_INT8;
        at.out_stride = HD;
        at.out_row0 = img0 + q0;
        at.out_col0 = h * hd;
        at.out_d = P[P_OUT_D * L + l];
        at.out_t = P[P_OUT_T * L + l];
        at.out_top = a.out_top;
        qvt::attention_rows<HDMAX>(at, warp, NW);
        __syncthreads();  // the next unit refills q/k/v
      }
    }
    grid.sync();
    QVT_GRID_STAMP(l * 7 + 3);

    // ---- 3: proj partial sums, int32 atomics (exact in any order)
    {
      const qvt::WeightT wp = layer_w(a.wp, l, HD, D, a.int4);
      gemm_phase(a.alv, R, wp, k_splits(R, D, HD), As, Bs,
                 [&](int row, int col, int acc) {
                   atomicAdd(a.acc_p + static_cast<long long>(row) * D + col,
                             acc);
                 });
    }
    grid.sync();
    QVT_GRID_STAMP(l * 7 + 4);

    // ---- B: x2 = x + proj, rounded; LN2 + quant
    for (int r = gwarp; r < R; r += nwarps) {
      float v[MAX_PER_LANE];
#pragma unroll
      for (int j = 0; j < MAX_PER_LANE; ++j) {
        if (j * 32 >= D) break;
        const int k = lane + 32 * j;
        const long long i = static_cast<long long>(r) * D + k;
        float y = static_cast<float>(__ldcg(a.acc_p + i)) * a.ps[l * D + k];
        y = y + a.pb[l * D + k];
        const float x2 = qvt::round_to(y + load_cg(a.x, a.dt, i), a.dt);
        qvt::store_f(a.x2, a.dt, i, x2);
        a.acc_p[i] = 0;
        v[j] = x2;
      }
      ln_quant_row(v, D, r, a.l2g + l * D, a.l2b + l * D, P[P_MLP_D * L + l],
                   P[P_MLP_T * L + l], a.mlp_top, a.mlp_pow, a.eps, a.lv);
    }
    grid.sync();
    QVT_GRID_STAMP(l * 7 + 5);

    // ---- 4: fc1 with the GELU + quant epilogue -> hidden levels
    {
      const float* s1 = a.s1 + static_cast<long long>(l) * hid;
      const float* b1 = a.b1 + static_cast<long long>(l) * hid;
      const float hid_d = P[P_HID_D * L + l];
      const float hid_t = P[P_HID_T * L + l];
      gemm_phase(a.lv, R, layer_w(a.w1, l, D, hid, a.int4), 1, As, Bs,
                 [&](int row, int col, int acc) {
                   float y = static_cast<float>(acc) * s1[col];
                   y = y + b1[col];
                   a.hlv[static_cast<long long>(row) * hid + col] =
                       a.hid_pow ? qvt::quantize(qvt::gelu(y), hid_d, hid_t,
                                                 a.hid_top, true, false)
                                 : qvt::gelu_quant_folded(y, hid_d,
                                                          a.hid_top);
                 });
    }
    grid.sync();
    QVT_GRID_STAMP(l * 7 + 6);

    // ---- 5: fc2 partial sums, int32 atomics
    {
      const qvt::WeightT w2 = layer_w(a.w2, l, hid, D, a.int4);
      gemm_phase(a.hlv, R, w2, k_splits(R, D, hid), As, Bs,
                 [&](int row, int col, int acc) {
                   atomicAdd(a.acc2 + static_cast<long long>(row) * D + col,
                             acc);
                 });
    }
    grid.sync();
    QVT_GRID_STAMP(l * 7 + 7);
  }
}

size_t smem_bytes(int nk, int hd) {
  const size_t attn =
      (static_cast<size_t>(QT + nk) * qvt::att_q_stride(hd) +
       static_cast<size_t>(nk) * qvt::att_v_stride(hd)) *
      sizeof(float);
  const size_t gemm = static_cast<size_t>(BM + BN) * SK;
  return attn > gemm ? attn : gemm;
}

// The scratch, each piece 256-byte aligned: lv | qkv | alv | hlv | acc_p |
// acc2 | x2. Returns its bytes; with a base, points a's scratch into it.
long long scratch_layout(long long R, int D, int HD, int hid, int dt_bytes,
                         char* base, Args* a) {
  auto up = [](long long b) { return (b + 255) / 256 * 256; };
  const long long sizes[7] = {R * D,       R * 3 * HD * 4, R * HD, R * hid,
                              R * D * 4,   R * D * 4,      R * D * dt_bytes};
  long long off[7], total = 0;
  for (int i = 0; i < 7; ++i) {
    off[i] = total;
    total += up(sizes[i]);
  }
  if (base) {
    a->lv = reinterpret_cast<int8_t*>(base + off[0]);
    a->qkv = reinterpret_cast<float*>(base + off[1]);
    a->alv = reinterpret_cast<int8_t*>(base + off[2]);
    a->hlv = reinterpret_cast<int8_t*>(base + off[3]);
    a->acc_p = reinterpret_cast<int*>(base + off[4]);
    a->acc2 = reinterpret_cast<int*>(base + off[5]);
    a->x2 = base + off[6];
  }
  return total;
}

}  // namespace

// bytes of scratch qvt_block_stack needs
extern "C" long long qvt_block_stack_scratch_bytes(int rows, int D, int HD,
                                                   int hid, int dt_bytes) {
  return scratch_layout(rows, D, HD, hid, dt_bytes, nullptr, nullptr);
}

// Co-resident blocks of the cooperative grid on this card (one per SM at
// most; 0 when the kernel does not fit an SM), or a negative CUDA error.
extern "C" int qvt_block_stack_grid(int nk, int hd) {
  const size_t smem = smem_bytes(nk, hd);
  cudaError_t e = cudaFuncSetAttribute(
      stack_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return -static_cast<int>(e);
  int dev = 0, sms = 0, coop = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, stack_kernel, NT,
                                                    smem);
  if (e != cudaSuccess) return -static_cast<int>(e);
  return coop && per_sm > 0 ? sms : 0;
}

extern "C" int qvt_block_stack(
    const void* x_in, void* x, int dt, const void* wq, const void* wp,
    const void* w1, const void* w2, int int4, const void* vecs,
    const void* prm, void* scratch, int L, int j_imgs, int n, int n_valid,
    int nk, int D, int heads, int hd, int hid, float q_mul, int act_pow,
    int out_pow, int mlp_pow, int hid_pow, int act_top, int out_top,
    int mlp_top, int hid_top, float eps, int grid, void* stream) {
  if (hd > HDMAX || hd % 8 || D > MAX_D || D % 32 || hid % 32 ||
      (heads * hd) % 32 || nk > n || grid < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.x_in = x_in;
  a.x = x;
  a.dt = dt;
  a.wq = static_cast<const int8_t*>(wq);
  a.wp = static_cast<const int8_t*>(wp);
  a.w1 = static_cast<const int8_t*>(w1);
  a.w2 = static_cast<const int8_t*>(w2);
  a.int4 = int4;
  // the per-block vectors, one f32 buffer: qs qb [L][3HD] | l1g l1b ps pb
  // [L][D] | l2g l2b [L][D] | s1 b1 [L][hid] | s2 b2 [L][D]
  const int HD = heads * hd;
  const float* v = static_cast<const float*>(vecs);
  const long long LD = static_cast<long long>(L) * D;
  a.qs = v;
  a.qb = a.qs + static_cast<long long>(L) * 3 * HD;
  a.l1g = a.qb + static_cast<long long>(L) * 3 * HD;
  a.l1b = a.l1g + LD;
  a.ps = a.l1b + LD;
  a.pb = a.ps + LD;
  a.l2g = a.pb + LD;
  a.l2b = a.l2g + LD;
  a.s1 = a.l2b + LD;
  a.b1 = a.s1 + static_cast<long long>(L) * hid;
  a.s2 = a.b1 + static_cast<long long>(L) * hid;
  a.b2 = a.s2 + LD;
  a.prm = static_cast<const float*>(prm);
  scratch_layout(static_cast<long long>(j_imgs) * n, D, HD, hid,
                 dt == qvt::DT_F32 ? 4 : 2, static_cast<char*>(scratch), &a);
  a.L = L;
  a.j_imgs = j_imgs;
  a.n = n;
  a.n_valid = n_valid;
  a.nk = nk;
  a.D = D;
  a.heads = heads;
  a.hd = hd;
  a.hid = hid;
  a.q_mul = q_mul;
  a.act_pow = act_pow;
  a.out_pow = out_pow;
  a.mlp_pow = mlp_pow;
  a.hid_pow = hid_pow;
  a.act_top = static_cast<float>(act_top);
  a.out_top = static_cast<float>(out_top);
  a.mlp_top = static_cast<float>(mlp_top);
  a.hid_top = static_cast<float>(hid_top);
  a.eps = eps;
  const size_t smem = smem_bytes(nk, hd);
  cudaError_t e = cudaFuncSetAttribute(
      stack_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  void* args[] = {&a};
  e = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(stack_kernel),
                                  dim3(grid), dim3(NT), args, smem,
                                  static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

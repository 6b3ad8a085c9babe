// K1: fused quantized matmul for Hopper (sm_90a).
//
// Replaces the TPU kernel quantized_vit_tpu/ops/fused.py:_fused_kernel
// (pallas_call in _fused_quant_matmul, fused.py:556):
//   lv  = prologue(x)            none (int8 levels) | quant | ln_quant |
//                                gelu_quant, f32 level math
//   acc = lv @ W                 int8 x int8 -> int32 (W int8, or packed
//                                int4 unpacked to int8 in shared memory)
//   out = epilogue(acc*scale+bias)   none | residual | quant | gelu_quant
//
// Design: a 64 x 64 output tile per block (4 warps, each 32 x 32 via
// mma.sync m16n8k32 s8), K walked in chunks of 64. Each chunk's A tile is
// computed from x by the prologue straight into shared memory (ln_quant
// first takes whole-row statistics over K for the block's rows). W arrives
// transposed, n-major (copied once per layer by ops/fused.py:plan_matmul),
// so its chunk is copied with 16-byte loads, packed int4 unpacked to int8
// in registers on the way. Ragged M, N and K edges are masked (zero levels
// and weights), so no host-side padding. The epilogue runs in registers, in
// f32. Constant folds (1/d into LN gamma/beta, 1/d or 2^-0.5 into
// scale/bias) are done once per layer by plan_matmul too.
//
// Bound on this card at the main path's shapes: the patch embed (x f32
// [B*196, 768], f32 out) moves ~39 MB for 7.4 G int8 ops, so it is
// memory-bound; the head ([B, 768] x [768, 1000]) is launch-bound; the
// attention proj (K3's second launch) is near the balance point. This
// first version uses synchronous tile fills and no TMA/wgmma, so it runs
// well below either bound.

#include "qvt_common.cuh"

namespace {

constexpr int BM = 64, BN = 64, BK = 64, SK = BK + 16, NT = 128;

enum { PRO_NONE = 0, PRO_QUANT = 1, PRO_LN = 2, PRO_GELU = 3 };
enum { EPI_NONE = 0, EPI_RES = 1, EPI_QUANT = 2, EPI_GELU = 3 };

struct Args {
  const void* x;
  int x_dt;
  qvt::WeightT w;  // transposed: [N][K] (int8) or [N][K/2] (packed int4)
  const float* scale;
  const float* bias;
  const float* ln_g;
  const float* ln_b;
  const void* res;
  int res_dt;
  const float* prm;  // act_d, act_t, out_d, out_t
  void* out;
  int out_dt;
  int M, K, N;
  int prologue, epilogue;
  int act_pow, out_pow, act_folded, out_folded;
  float act_top, out_top, eps;
};

__global__ void __launch_bounds__(NT) fqm_kernel(Args a) {
  __shared__ __align__(16) int8_t As[BM * SK];
  __shared__ __align__(16) int8_t Bs[BN * SK];
  __shared__ float s_mu[BM], s_rs[BM];

  const int m_base = blockIdx.y * BM, n_base = blockIdx.x * BN;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
  const float act_d = a.prm[0], act_t = a.prm[1];
  const float out_d = a.prm[2], out_t = a.prm[3];
  const int M = a.M, K = a.K, N = a.N;

  if (a.prologue == PRO_LN) {
    qvt::ln_stats(a.x, a.x_dt, m_base, BM, M - m_base, K, a.eps, s_mu, s_rs);
    __syncthreads();
  }

  const bool w_vec = a.w.vec_ok();
  // int8 levels in: copy 16-byte pieces of x rows
  const bool x_vec = a.prologue == PRO_NONE && K % 16 == 0 &&
                     (reinterpret_cast<uintptr_t>(a.x) & 15) == 0;
  int acc[2][4][4];
  qvt::zero_acc(acc);
  for (int k0 = 0; k0 < K; k0 += BK) {
    if (x_vec) {
      const int8_t* x8 = static_cast<const int8_t*>(a.x);
      qvt::fill_rows16(As, BM, SK, BK, [&](int r, int c) -> uint4 {
        const int row = m_base + r, k = k0 + c;
        if (row >= M || k >= K) return make_uint4(0u, 0u, 0u, 0u);
        return __ldg(reinterpret_cast<const uint4*>(
            x8 + static_cast<long long>(row) * K + k));
      });
    } else qvt::fill_rows(As, BM, SK, BK, [&](int r, int kk) -> int8_t {
      const int row = m_base + r, k = k0 + kk;
      if (row >= M || k >= K) return 0;
      const long long i = static_cast<long long>(row) * K + k;
      switch (a.prologue) {
        case PRO_NONE:
          return static_cast<const int8_t*>(a.x)[i];
        case PRO_QUANT:
          return qvt::quantize(qvt::load_f(a.x, a.x_dt, i), act_d, act_t,
                               a.act_top, a.act_pow, false);
        case PRO_LN: {
          float y = (qvt::load_f(a.x, a.x_dt, i) - s_mu[r]) * s_rs[r] *
                        a.ln_g[k] + a.ln_b[k];
          return qvt::quantize(y, act_d, act_t, a.act_top, a.act_pow,
                               a.act_folded);
        }
        default:
          return qvt::gelu_quant_folded(qvt::load_f(a.x, a.x_dt, i), act_d,
                                        a.act_top);
      }
    });
    if (w_vec)
      qvt::fill_rows16(Bs, BN, SK, BK, [&](int n, int c) -> uint4 {
        return a.w.vec16(k0 + c, n_base + n);
      });
    else
      qvt::fill_rows(Bs, BN, SK, BK, [&](int n, int kk) -> int8_t {
        return a.w.at(k0 + kk, n_base + n);
      });
    __syncthreads();
    qvt::warp_mma<2, 4>(acc, As, SK, Bs, SK, BK, wm, wn, lane);
    __syncthreads();
  }

  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int row = m_base + wm + i * 16 + g + (r >= 2 ? 8 : 0);
        const int col = n_base + wn + j * 8 + t * 2 + (r & 1);
        if (row >= M || col >= N) continue;
        const long long o = static_cast<long long>(row) * N + col;
        float v = static_cast<float>(acc[i][j][r]) * a.scale[col];
        if (a.bias) v = v + a.bias[col];
        switch (a.epilogue) {
          case EPI_NONE:
            qvt::store_f(a.out, a.out_dt, o, v);
            break;
          case EPI_RES:
            qvt::store_f(a.out, a.out_dt, o,
                         v + qvt::load_f(a.res, a.res_dt, o));
            break;
          case EPI_QUANT:
            static_cast<int8_t*>(a.out)[o] = qvt::quantize(
                v, out_d, out_t, a.out_top, a.out_pow, a.out_folded);
            break;
          default:
            static_cast<int8_t*>(a.out)[o] =
                a.out_folded
                    ? qvt::gelu_quant_folded(v, out_d, a.out_top)
                    : qvt::quantize(qvt::gelu(v), out_d, out_t, a.out_top,
                                    a.out_pow, false);
        }
      }
}

}  // namespace

extern "C" int qvt_fused_quant_matmul(
    const void* x, int x_dt, const void* w, int w_int4, const void* scale,
    const void* bias, const void* ln_g, const void* ln_b, const void* res,
    int res_dt, const void* prm, void* out, int out_dt, int M, int K, int N,
    int prologue, int epilogue, int act_pow, int out_pow, int act_folded,
    int out_folded, int act_top, int out_top, float eps, void* stream) {
  Args a;
  a.x = x;
  a.x_dt = x_dt;
  a.w = qvt::WeightT{static_cast<const int8_t*>(w), K, N, w_int4};
  a.scale = static_cast<const float*>(scale);
  a.bias = static_cast<const float*>(bias);
  a.ln_g = static_cast<const float*>(ln_g);
  a.ln_b = static_cast<const float*>(ln_b);
  a.res = res;
  a.res_dt = res_dt;
  a.prm = static_cast<const float*>(prm);
  a.out = out;
  a.out_dt = out_dt;
  a.M = M;
  a.K = K;
  a.N = N;
  a.prologue = prologue;
  a.epilogue = epilogue;
  a.act_pow = act_pow;
  a.out_pow = out_pow;
  a.act_folded = act_folded;
  a.out_folded = out_folded;
  a.act_top = static_cast<float>(act_top);
  a.out_top = static_cast<float>(out_top);
  a.eps = eps;
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  fqm_kernel<<<grid, NT, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

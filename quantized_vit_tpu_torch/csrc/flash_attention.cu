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
// of this port, the sums run in f64 and round once to f32 (bf16 and f32
// products are exact in f64), and the file is compiled with -fmad=false,
// so the plain version (ops/attention.py:flash_attention_plain) gives the
// same bits.
//
// Design: the TPU program keeps one (image, head)'s whole [N, N] f32
// score matrix in VMEM; at ViT-H/14's 272 tokens that is 296 KB, beyond a
// block's 227 KB of shared memory. So a block takes one (image, head,
// tile of qt query rows): the tile's q rows (f64) and its f32 score rows
// [qt][N] stay in shared memory, K and then V stream through one f64
// buffer in 64-key chunks. qt is 32, or smaller where N forces it, so the
// kernel has no token limit in practice (N up to ~50k at qt = 1).
//
// Bound on this card at ViT-B/16 batch 32 (q/k/v [32, 12, 208, 64] bf16):
// 4.25 GFLOP over 989 TFLOP/s = 4.3 us, 40.9 MB over 3.35 TB/s = 12.2 us:
// bytes. This first version runs its dots on the f64 pipe (one DMUL and
// one DADD per multiply-add), far above that bound.

#include "qvt_common.cuh"

namespace {

constexpr int NT = 256, KC = 64, QT_MAX = 32;

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

// stage rows [r0, r0 + rows) of one (b, h) slice of a [B, H, N, hd]
// tensor into shared f64 rows of stride hd + 1 (zeros past N)
__device__ __forceinline__ void stage(double* dst, const void* src, int dt,
                                      long long base, int r0, int rows,
                                      int N, int hd) {
  for (int i = threadIdx.x; i < rows * hd; i += NT) {
    const int r = i / hd, c = i - r * hd;
    const int row = r0 + r;
    dst[r * (hd + 1) + c] =
        row < N ? static_cast<double>(qvt::load_f(
                      src, dt, base + static_cast<long long>(row) * hd + c))
                : 0.0;
  }
}

template <int HDM>
__global__ void __launch_bounds__(NT) flash_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int hd = a.hd, N = a.N, qt = a.qt;
  double* Qs = reinterpret_cast<double*>(smem_raw);  // [qt][hd+1]
  double* Cs = Qs + qt * (hd + 1);                   // [KC][hd+1]
  float* S = reinterpret_cast<float*>(Cs + KC * (hd + 1));  // [qt][N]

  const int q0 = blockIdx.x * qt;
  const int rows = min(qt, N - q0);
  const long long base =
      (static_cast<long long>(blockIdx.z) * a.H + blockIdx.y) * N * hd;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  stage(Qs, a.q, a.q_dt, base, q0, rows, N, hd);

  // scores: s[r][j] = f32(sum_d q[r][d] k[j][d]) * scale, masked
  for (int j0 = 0; j0 < N; j0 += KC) {
    __syncthreads();
    stage(Cs, a.k, a.k_dt, base, j0, KC, N, hd);
    __syncthreads();
    const int kc = min(KC, N - j0);
    for (int i = threadIdx.x; i < rows * KC; i += NT) {
      const int r = i / KC, jj = i - r * KC;
      if (jj >= kc) continue;
      const double* qr = Qs + r * (hd + 1);
      const double* kr = Cs + jj * (hd + 1);
      double s = 0.0;
      for (int c = 0; c < hd; ++c) s += qr[c] * kr[c];
      const int j = j0 + jj;
      float sv = static_cast<float>(s) * a.scale;
      S[r * N + j] = j < a.n_valid ? sv : -1e30f;
    }
  }
  __syncthreads();

  // softmax per row, one warp a row: max, exp, f64 sum, divide, cast to
  // v's dtype
  for (int r = warp; r < rows; r += NT / 32) {
    float* sr = S + r * N;
    float mx = __int_as_float(0xff800000);  // -inf
    for (int j = lane; j < N; j += 32) mx = fmaxf(mx, sr[j]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    double sum = 0.0;
    for (int j = lane; j < N; j += 32) {
      const float p = expf(sr[j] - mx);
      sr[j] = p;
      sum += static_cast<double>(p);
    }
    const float tot = static_cast<float>(qvt::warp_sum(sum));
    for (int j = lane; j < N; j += 32)
      sr[j] = qvt::round_to(sr[j] / tot, a.v_dt);
  }

  // o[r][c] = f32(sum_j p[r][j] v[j][c]); a thread keeps OPT outputs
  constexpr int OPT = QT_MAX * HDM / NT;
  double acc[OPT];
#pragma unroll
  for (int u = 0; u < OPT; ++u) acc[u] = 0.0;
  for (int j0 = 0; j0 < N; j0 += KC) {
    __syncthreads();
    stage(Cs, a.v, a.v_dt, base, j0, KC, N, hd);
    __syncthreads();
    const int kc = min(KC, N - j0);
#pragma unroll
    for (int u = 0; u < OPT; ++u) {
      const int o = threadIdx.x + u * NT;
      const int r = o / hd, c = o - r * hd;
      if (r >= rows) continue;
      const float* pr = S + r * N + j0;
      double s = acc[u];
      for (int jj = 0; jj < kc; ++jj)
        s += static_cast<double>(pr[jj]) * Cs[jj * (hd + 1) + c];
      acc[u] = s;
    }
  }
  const float d = a.prm ? a.prm[0] : 1.f, t = a.prm ? a.prm[1] : 1.f;
#pragma unroll
  for (int u = 0; u < OPT; ++u) {
    const int o = threadIdx.x + u * NT;
    const int r = o / hd, c = o - r * hd;
    if (r >= rows) continue;
    const long long i = base + static_cast<long long>(q0 + r) * hd + c;
    const float v = static_cast<float>(acc[u]);
    if (a.out_dt == qvt::DT_INT8)
      static_cast<int8_t*>(a.out)[i] =
          qvt::quantize(v, d, t, a.top, a.out_pow, false);
    else
      qvt::store_f(a.out, a.out_dt, i, v);
  }
}

template <int HDM>
int launch(const Args& a, size_t smem, dim3 grid, cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(
      flash_kernel<HDM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  flash_kernel<HDM><<<grid, NT, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

size_t smem_bytes(int qt, int N, int hd) {
  return (static_cast<size_t>(qt) + KC) * (hd + 1) * sizeof(double) +
         static_cast<size_t>(qt) * N * sizeof(float);
}

}  // namespace

// query rows per block: 32, halved until the block fits (0: never fits)
extern "C" int qvt_flash_attention_rows(int N, int hd) {
  for (int qt = QT_MAX; qt >= 1; qt /= 2)
    if (smem_bytes(qt, N, hd) <= 232448) return qt;
  return 0;
}

extern "C" int qvt_flash_attention(const void* q, int q_dt, const void* k,
                                   int k_dt, const void* v, int v_dt,
                                   void* out, int out_dt, const void* prm,
                                   int B, int H, int N, int hd, int n_valid,
                                   float scale, int out_top, int out_pow,
                                   void* stream) {
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
  a.qt = qvt_flash_attention_rows(N, hd);
  a.scale = scale;
  a.top = static_cast<float>(out_top);
  a.out_pow = out_pow;
  if (a.qt == 0 || hd > 128 || B > 65535 || H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes(a.qt, N, hd);
  const dim3 grid((N + a.qt - 1) / a.qt, H, B);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (hd <= 64) return launch<64>(a, smem, grid, st);
  if (hd <= 80) return launch<80>(a, smem, grid, st);
  return launch<128>(a, smem, grid, st);
}

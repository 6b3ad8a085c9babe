// Native batch-preparation engine for the input pipeline.
//
// The reference feeds its trainer through torch DataLoader worker processes
// (train.py:278) whose main CPU cost is the uint8 -> normalized float32
// conversion and batch assembly. Here the same work runs in-process in C++
// (OpenMP over pixels/rows), avoiding the fork+pickle round trip entirely:
//
//  - qvt_normalize_u8_to_f32: fused u8 -> [0,1] -> (x - mean)/std, NHWC,
//    one pass over the batch.
//  - qvt_gather_rows_f32: parallel row gather (in-memory dataset batching).
//
// Built on demand by utils/native_prep.py (same pattern as
// artifact/native.py); a numpy fallback keeps everything working without a
// toolchain.

#include <cstdint>
#include <cstddef>

extern "C" {

// src: [n_pixels, c] uint8 (flattened NHWC), dst: same layout float32.
// dst[i, ch] = (src[i, ch]/255 - mean[ch]) / std[ch]
void qvt_normalize_u8_to_f32(const uint8_t* src, float* dst,
                             int64_t n_pixels, int64_t c,
                             const float* mean, const float* inv_std) {
    // precompute per-channel LUTs: 256 values each, cheap and exact
    // (u8 has only 256 states) — the hot loop becomes one table lookup
    float lut[8][256];
    if (c <= 8) {
        for (int64_t ch = 0; ch < c; ++ch)
            for (int v = 0; v < 256; ++v)
                lut[ch][v] = ((float)v * (1.0f / 255.0f) - mean[ch])
                             * inv_std[ch];
#pragma omp parallel for schedule(static)
        for (int64_t i = 0; i < n_pixels; ++i) {
            const uint8_t* s = src + i * c;
            float* d = dst + i * c;
            for (int64_t ch = 0; ch < c; ++ch) d[ch] = lut[ch][s[ch]];
        }
        return;
    }
#pragma omp parallel for schedule(static)
    for (int64_t i = 0; i < n_pixels; ++i) {
        const uint8_t* s = src + i * c;
        float* d = dst + i * c;
        for (int64_t ch = 0; ch < c; ++ch)
            d[ch] = ((float)s[ch] * (1.0f / 255.0f) - mean[ch]) * inv_std[ch];
    }
}

// NHWC [B, H, W, C] f32 -> patchified [B, (H/P)*(W/P), P*P*C] f32.
// A pure byte reorder: on TPU the same relayout costs ~220us/batch-32 on
// device (XLA materializes the patch transpose whether done as a strided
// conv or an explicit reshape — tools/exp_entry.py), while the host writes
// these bytes anyway when assembling the batch. Emitting the patch layout
// from the input pipeline makes the ViT patch embed an ordinary K=P*P*C
// fused matmul (serve/vit_int4.py images_layout="patches").
void qvt_patchify_f32(const float* src, float* dst, int64_t b, int64_t h,
                      int64_t w, int64_t c, int64_t p) {
    const int64_t gh = h / p, gw = w / p;
    const int64_t patch_elems = p * p * c;
#pragma omp parallel for schedule(static) collapse(2)
    for (int64_t bi = 0; bi < b; ++bi) {
        for (int64_t r = 0; r < gh; ++r) {
            const float* sb = src + bi * h * w * c;
            float* db = dst + (bi * gh * gw + r * gw) * patch_elems;
            for (int64_t dy = 0; dy < p; ++dy) {
                const float* row = sb + (r * p + dy) * w * c;
                for (int64_t s = 0; s < gw; ++s) {
                    const float* sp = row + s * p * c;
                    float* dp = db + s * patch_elems + dy * p * c;
                    for (int64_t j = 0; j < p * c; ++j) dp[j] = sp[j];
                }
            }
        }
    }
}

// out[b, :] = src[idx[b], :]
void qvt_gather_rows_f32(const float* src, const int64_t* idx, float* out,
                         int64_t n_rows, int64_t row_elems) {
#pragma omp parallel for schedule(static)
    for (int64_t b = 0; b < n_rows; ++b) {
        const float* s = src + idx[b] * row_elems;
        float* d = out + b * row_elems;
        for (int64_t j = 0; j < row_elems; ++j) d[j] = s[j];
    }
}

}  // extern "C"

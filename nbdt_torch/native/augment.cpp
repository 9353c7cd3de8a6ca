// Native batch augmentation for the host input pipeline of nbdt_torch.
//
// A copy of nbdt_tpu/native/augment.cpp, kept by the port so that it reads
// nothing of the JAX package. The host-side augmentation of a uint8 NHWC
// batch (pad -> random crop -> random hflip -> normalize) is fused into one
// OpenMP pass: each output pixel is read once from the padded source window
// and written once as normalized float32 NHWC, with no intermediate padded
// copy and no per-sample Python. Also a fused normalize (the eval path) and
// an index gather of uint8 samples (the loader's shuffle).
//
// A plain shared object with a C interface, called through ctypes:
// nbdt_torch/native/__init__.py compiles it with g++ at first use into
// build/nbdt_torch/ and takes its numpy twins when no library can be built.

#include <cstdint>
#include <cstddef>

extern "C" {

// images:  [n, h, w, c] uint8 source batch
// ys, xs:  [n] crop offsets in [0, 2*pad]
// flips:   [n] 0/1 horizontal mirror flags
// mean,std:[c] normalization constants (divide-by-255 folded in here)
// out:     [n, h, w, c] float32, normalized
void augment_batch(const uint8_t* images, int64_t n, int64_t h, int64_t w,
                   int64_t c, int64_t pad, const int32_t* ys,
                   const int32_t* xs, const uint8_t* flips, const float* mean,
                   const float* std, float* out) {
  // Precompute the 256-entry lookup table per channel:
  // lut[ch][v] = (v/255 - mean[ch]) / std[ch]. Turns the inner loop into a
  // single table load + store.
  const int64_t C = c;
  float lut[8][256];  // c <= 8 in practice (RGB=3); fall back if larger
  const bool use_lut = C <= 8;
  if (use_lut) {
    for (int64_t ch = 0; ch < C; ++ch) {
      const float inv = 1.0f / (255.0f * std[ch]);
      const float bias = mean[ch] / std[ch];
      for (int v = 0; v < 256; ++v) lut[ch][v] = (float)v * inv - bias;
    }
  }

#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < n; ++i) {
    const uint8_t* src = images + i * h * w * c;
    float* dst = out + i * h * w * c;
    const int64_t oy = (int64_t)ys[i] - pad;  // source row offset
    const int64_t ox = (int64_t)xs[i] - pad;
    const bool flip = flips[i] != 0;
    for (int64_t y = 0; y < h; ++y) {
      const int64_t sy = y + oy;
      const bool row_in = (sy >= 0 && sy < h);
      for (int64_t x = 0; x < w; ++x) {
        const int64_t out_x = flip ? (w - 1 - x) : x;
        float* po = dst + (y * w + out_x) * c;
        const int64_t sx = x + ox;
        if (row_in && sx >= 0 && sx < w) {
          const uint8_t* ps = src + (sy * w + sx) * c;
          if (use_lut) {
            for (int64_t ch = 0; ch < c; ++ch) po[ch] = lut[ch][ps[ch]];
          } else {
            for (int64_t ch = 0; ch < c; ++ch)
              po[ch] = ((float)ps[ch] / 255.0f - mean[ch]) / std[ch];
          }
        } else {  // zero-padded region: normalized value of 0
          if (use_lut) {
            for (int64_t ch = 0; ch < c; ++ch) po[ch] = lut[ch][0];
          } else {
            for (int64_t ch = 0; ch < c; ++ch) po[ch] = -mean[ch] / std[ch];
          }
        }
      }
    }
  }
}

// Plain normalize (eval path): out = (u8/255 - mean) / std, fused + parallel.
void normalize_batch(const uint8_t* images, int64_t n, int64_t hw, int64_t c,
                     const float* mean, const float* std, float* out) {
  float lut[8][256];
  const bool use_lut = c <= 8;
  if (use_lut) {
    for (int64_t ch = 0; ch < c; ++ch) {
      const float inv = 1.0f / (255.0f * std[ch]);
      const float bias = mean[ch] / std[ch];
      for (int v = 0; v < 256; ++v) lut[ch][v] = (float)v * inv - bias;
    }
  }
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < n * hw; ++i) {
    const uint8_t* ps = images + i * c;
    float* po = out + i * c;
    if (use_lut) {
      for (int64_t ch = 0; ch < c; ++ch) po[ch] = lut[ch][ps[ch]];
    } else {
      for (int64_t ch = 0; ch < c; ++ch)
        po[ch] = ((float)ps[ch] / 255.0f - mean[ch]) / std[ch];
    }
  }
}

// Index-gather of uint8 samples into a contiguous batch (shuffle support):
// out[j] = data[indices[j]] for j in [0, m). Parallel memcpy.
void gather_batch_u8(const uint8_t* data, const int64_t* indices, int64_t m,
                     int64_t sample_bytes, uint8_t* out) {
#pragma omp parallel for schedule(static)
  for (int64_t j = 0; j < m; ++j) {
    const uint8_t* src = data + indices[j] * sample_bytes;
    uint8_t* dst = out + j * sample_bytes;
    for (int64_t b = 0; b < sample_bytes; ++b) dst[b] = src[b];
  }
}

}  // extern "C"

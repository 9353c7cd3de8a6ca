// Fused LayerNorm over the last axis for Hopper (sm_90a), forward only.
//
// Replaces the TPU kernel nbdt_tpu/ops/layernorm.py::_ln_kernel (driven by
// fused_layernorm there). Per row of x [rows, D], f32 whatever x's type:
//
//   mean = sum(x) / D
//   var  = sum((x - mean)^2) / D        (the centred form, not E[x^2]-mean^2)
//   y    = (x - mean) * rsqrt(var + eps) * weight + bias,  cast to x's type
//
// Bound on an H100 SXM: each element is read once and written once, with
// about 8 f32 operations on it. At the ViT-B/16 shape (50,432 rows x 768,
// bf16) that is 155 MB of traffic, about 46 us at 3.35 TB/s, against 0.3
// GFLOP, about 5 us at 67 TFLOP/s f32. So it is memory-bound, and the design
// aims at one read and one write of x:
//  * One warp per row, kWarps rows per block; rows are independent, so any
//    row count works and nothing is padded.
//  * Lane l loads the row's 16-byte vectors l, l+32, l+64, ... (neighbouring
//    lanes on neighbouring addresses) and keeps them in registers, so the
//    two passes (mean, then the centred variance) read device memory once.
//    kMaxVec vectors per lane is a template argument (D=768: 6 in f32, 3 in
//    bf16); wider rows than 8 vectors per lane take the kMaxVec=0 instance,
//    which reads the row from memory in each pass instead (L1/L2 serve the
//    re-reads).
//  * Sums are warp shuffles in f32; weight and bias are f32 and read through
//    the read-only cache, shared by all rows.
//  * bf16 moves as raw 16-bit storage; it is widened to f32 on load and
//    rounded to nearest even on the one store.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarps = 4;  // rows (warps) per block
constexpr int kVecBytes = 16;

template <typename T>
struct Vec {
  static constexpr int kElems = kVecBytes / sizeof(T);  // 4 f32 or 8 bf16
};

__device__ __forceinline__ void unpack(const uint4& v, float* out, float) {
  out[0] = __uint_as_float(v.x); out[1] = __uint_as_float(v.y);
  out[2] = __uint_as_float(v.z); out[3] = __uint_as_float(v.w);
}
__device__ __forceinline__ void unpack(const uint4& v, float* out, __nv_bfloat16) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x; out[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ uint4 pack(const float* in, float) {
  return make_uint4(__float_as_uint(in[0]), __float_as_uint(in[1]),
                    __float_as_uint(in[2]), __float_as_uint(in[3]));
}
__device__ __forceinline__ uint4 pack(const float* in, __nv_bfloat16) {
  uint4 v;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(in[2 * i], in[2 * i + 1]);
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// weight/bias of the E elements of vector j, as f32.
template <int E>
__device__ __forceinline__ void load_affine(const float* __restrict__ p, int j, float* out) {
  const float4* q = reinterpret_cast<const float4*>(p) + j * (E / 4);
#pragma unroll
  for (int i = 0; i < E / 4; ++i) {
    const float4 f = __ldg(q + i);
    out[4 * i] = f.x; out[4 * i + 1] = f.y; out[4 * i + 2] = f.z; out[4 * i + 3] = f.w;
  }
}

template <typename T>
__device__ __forceinline__ void store_row_vec(T* __restrict__ y, int j, const float* xv,
                                              float mean, float rstd,
                                              const float* __restrict__ weight,
                                              const float* __restrict__ bias) {
  constexpr int E = Vec<T>::kElems;
  float w[E], b[E], o[E];
  load_affine<E>(weight, j, w);
  load_affine<E>(bias, j, b);
#pragma unroll
  for (int e = 0; e < E; ++e) o[e] = (xv[e] - mean) * rstd * w[e] + b[e];
  reinterpret_cast<uint4*>(y)[j] = pack(o, T());
}

// kMaxVec > 0: the row lives in registers. kMaxVec == 0: streamed per pass.
template <typename T, int kMaxVec>
__global__ void __launch_bounds__(kWarps * 32) layernorm_kernel(
    const T* __restrict__ x, const float* __restrict__ weight,
    const float* __restrict__ bias, T* __restrict__ y, long long rows, int D, float eps) {
  constexpr int E = Vec<T>::kElems;
  const int lane = threadIdx.x & 31;
  const long long row = static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;  // a whole warp leaves together
  const int nvec = D / E;
  const uint4* xr = reinterpret_cast<const uint4*>(x + row * D);
  T* yr = y + row * D;
  const float inv_d = 1.0f / static_cast<float>(D);

  if constexpr (kMaxVec > 0) {
    float v[kMaxVec][E];
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < kMaxVec; ++i) {
      const int j = lane + 32 * i;
      if (j < nvec) {
        unpack(xr[j], v[i], T());
#pragma unroll
        for (int e = 0; e < E; ++e) s += v[i][e];
      }
    }
    const float mean = warp_sum(s) * inv_d;
    float q = 0.f;
#pragma unroll
    for (int i = 0; i < kMaxVec; ++i) {
      if (lane + 32 * i < nvec) {
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const float c = v[i][e] - mean;
          q = fmaf(c, c, q);
        }
      }
    }
    const float rstd = rsqrtf(warp_sum(q) * inv_d + eps);
#pragma unroll
    for (int i = 0; i < kMaxVec; ++i) {
      const int j = lane + 32 * i;
      if (j < nvec) store_row_vec(yr, j, v[i], mean, rstd, weight, bias);
    }
  } else {
    float v[E];
    float s = 0.f;
    for (int j = lane; j < nvec; j += 32) {
      unpack(xr[j], v, T());
#pragma unroll
      for (int e = 0; e < E; ++e) s += v[e];
    }
    const float mean = warp_sum(s) * inv_d;
    float q = 0.f;
    for (int j = lane; j < nvec; j += 32) {
      unpack(xr[j], v, T());
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const float c = v[e] - mean;
        q = fmaf(c, c, q);
      }
    }
    const float rstd = rsqrtf(warp_sum(q) * inv_d + eps);
    for (int j = lane; j < nvec; j += 32) {
      unpack(xr[j], v, T());
      store_row_vec(yr, j, v, mean, rstd, weight, bias);
    }
  }
}

template <typename T, int kMaxVec>
cudaError_t launch_one(const void* x, const float* weight, const float* bias, void* y,
                       long long rows, int D, float eps, cudaStream_t stream) {
  const long long blocks = (rows + kWarps - 1) / kWarps;
  layernorm_kernel<T, kMaxVec><<<static_cast<unsigned>(blocks), kWarps * 32, 0, stream>>>(
      static_cast<const T*>(x), weight, bias, static_cast<T*>(y), rows, D, eps);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* x, const float* weight, const float* bias, void* y,
                   long long rows, int D, float eps, cudaStream_t stream) {
  const int per_lane = (D / Vec<T>::kElems + 31) / 32;
  switch (per_lane) {
    case 1: return launch_one<T, 1>(x, weight, bias, y, rows, D, eps, stream);
    case 2: return launch_one<T, 2>(x, weight, bias, y, rows, D, eps, stream);
    case 3: return launch_one<T, 3>(x, weight, bias, y, rows, D, eps, stream);
    case 4: return launch_one<T, 4>(x, weight, bias, y, rows, D, eps, stream);
    case 5: return launch_one<T, 5>(x, weight, bias, y, rows, D, eps, stream);
    case 6: return launch_one<T, 6>(x, weight, bias, y, rows, D, eps, stream);
    case 7: return launch_one<T, 7>(x, weight, bias, y, rows, D, eps, stream);
    case 8: return launch_one<T, 8>(x, weight, bias, y, rows, D, eps, stream);
    default: return launch_one<T, 0>(x, weight, bias, y, rows, D, eps, stream);
  }
}

}  // namespace

extern "C" {

// y = LayerNorm(x) over rows of D; x and y are [rows, D] f32 (bf16 == 0) or
// bf16 (bf16 == 1), weight and bias [D] f32. The caller guarantees D % 128 ==
// 0, 16-byte aligned pointers and rows / 4 < 2^31. Launches on `stream`;
// returns cudaGetLastError() after the launch (0 on success).
int nbdt_layernorm(const void* x, const void* weight, const void* bias, void* y,
                   long long rows, int D, float eps, int bf16, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* w = static_cast<const float*>(weight);
  const float* b = static_cast<const float*>(bias);
  if (bf16) return launch<__nv_bfloat16>(x, w, b, y, rows, D, eps, s);
  return launch<float>(x, w, b, y, rows, D, eps, s);
}

const char* nbdt_layernorm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

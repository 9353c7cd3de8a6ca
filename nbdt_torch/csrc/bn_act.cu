// Eval-mode BatchNorm, an optional residual and a ReLU as one
// in-place pass over a convolution's NCHW f32 output, for Hopper (sm_90a).
//
// Replaces no TPU kernel. nbdt_tpu leaves its convolutions, BatchNorms,
// adds and ReLUs to XLA, which fuses the elementwise ones into one pass; in
// PyTorch eager they are three library passes over each conv output
// (cuDNN's inference BatchNorm, the residual add, the ReLU), each reading
// and writing all of it. This kernel is the one pass. Per element of
// x [N, C, H, W], with c its channel:
//
//   s = weight[c] / sqrt(var[c] + eps)
//   y = (x - mean[c]) * s + bias[c]
//       (+ r, or + (r - mean'[c]) * s' + bias'[c] with the residual's own BatchNorm)
//   y = ReLU(y), written over x
//
// s comes from the BatchNorm's own tensors on every launch; nothing is
// cached between launches. The mean is subtracted before the scale, not
// folded into a shift (x * s + bias - mean * s): where a channel's mean is
// large against its spread, the folded form cancels digits (about 10x the
// error at a mean of 10 standard deviations).
//
// Bound on an H100 SXM: bytes. Each element is read once and written once,
// and the residual read once: 8 or 12 bytes for 2 to 6 flops, far below the
// card's 20 flops a byte. At ResNet18's first stage (8192 x 64 x 32 x 32)
// that is 4.3 GB, 1.28 ms at 3.35 TB/s. The design aims at one read and one
// write of each byte, with enough of them in flight:
//  * A block of 256 threads takes a chunk of up to 4096 consecutive
//    elements; a thread holds four 16-byte vectors of x (and of r), issued
//    before anything else, neighbouring threads on neighbouring vectors.
//  * While those loads are in flight, the block gathers mean, s and bias
//    (and the residual's) of the planes its chunk touches, at most 1026,
//    into shared memory.
//  * A vector holds 4 consecutive elements: one plane's where H*W % 4 == 0,
//    and possibly two planes' where it is not (HRNet's 65x65, 33x33, 17x17),
//    so each element finds its plane by one compare against the vector's
//    first. Planes of fewer than 4 elements (chunks of 1024 planes then)
//    divide per element.
//  * The arithmetic rounds where the plain PyTorch version rounds (IEEE
//    division and square root, no FMA), so the two agree bit for bit.
//  * x and r are 16-byte aligned (the caller refuses other pointers).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxChunk = 4096;                // elements a block
constexpr int kMaxPlanes = kMaxChunk / 4 + 2;  // planes a chunk can touch

struct Norm {
  const float* weight;
  const float* bias;
  const float* mean;
  const float* var;
  float eps;
};

// One channel's mean, s = weight / sqrt(var + eps) (rounded as PyTorch
// does) and bias, for the planes of a chunk in shared memory.
struct Plane {
  float mean, scale, bias;
};

__device__ __forceinline__ Plane plane_of(const Norm& n, int c) {
  return {__ldg(n.mean + c),
          __fdiv_rn(__ldg(n.weight + c), __fsqrt_rn(__fadd_rn(__ldg(n.var + c), n.eps))),
          __ldg(n.bias + c)};
}

__device__ __forceinline__ float normalize(float x, const Plane& p) {
  return __fadd_rn(__fmul_rn(__fsub_rn(x, p.mean), p.scale), p.bias);
}

__device__ __forceinline__ void load(const float* p, int j, float* out) {
  const float4 v = reinterpret_cast<const float4*>(p)[j];
  out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
}

__device__ __forceinline__ void load_ro(const float* __restrict__ p, int j, float* out) {
  const float4 v = __ldg(reinterpret_cast<const float4*>(p) + j);
  out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
}

__device__ __forceinline__ void store(float* p, int j, const float* in) {
  reinterpret_cast<float4*>(p)[j] = make_float4(in[0], in[1], in[2], in[3]);
}

// kRes: 0 no residual, 1 the residual as it is, 2 the residual through its
// own BatchNorm. q indexes the chunk's planes in shared memory.
template <int kRes>
__device__ __forceinline__ float apply(float x, float r, int q, const Plane* pl,
                                       const Plane* rpl) {
  float y = normalize(x, pl[q]);
  if constexpr (kRes == 1) y = __fadd_rn(y, r);
  if constexpr (kRes == 2) y = __fadd_rn(y, normalize(r, rpl[q]));
  return y < 0.f ? 0.f : y;  // NaN passes, as in F.relu
}

template <int kRes>
__global__ void __launch_bounds__(kThreads, 4) bn_act_kernel(
    float* x, const float* __restrict__ r, Norm bn, Norm rbn, long long total, int hw, int C,
    int chunk) {
  constexpr int kPer = kMaxChunk / (kThreads * 4);  // vectors a thread
  constexpr int kR = kRes ? 4 : 1;
  constexpr int kRPlanes = kRes == 2 ? kMaxPlanes : 1;
  __shared__ Plane pl[kMaxPlanes], rpl[kRPlanes];

  const long long start = static_cast<long long>(blockIdx.x) * chunk;
  const int len = static_cast<int>(min(static_cast<long long>(chunk), total - start));
  const long long p0 = start / hw;                   // the chunk's first plane
  const int off0 = static_cast<int>(start - p0 * hw);  // its first element in that plane
  const int planes = (off0 + len - 1) / hw + 1;
  float* xc = x + start;
  const float* rc = r + (kRes ? start : 0);
  const int nvec = len / 4;

  float xv[kPer][4], rv[kPer][kR];
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int j = k * kThreads + threadIdx.x;
    if (j < nvec) {
      load(xc, j, xv[k]);
      if constexpr (kRes != 0) load_ro(rc, j, rv[k]);
    }
  }
  for (int i = threadIdx.x; i < planes; i += kThreads) {
    const int c = static_cast<int>((p0 + i) % C);
    pl[i] = plane_of(bn, c);
    if constexpr (kRes == 2) rpl[i] = plane_of(rbn, c);
  }
  __syncthreads();

#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int j = k * kThreads + threadIdx.x;
    if (j < nvec) {
      const int o = off0 + j * 4;  // from the start of the chunk's first plane
      const int q = o / hw;
      const int rem = o - q * hw;
      float out[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qe = hw >= 4 ? q + (rem + e >= hw) : (o + e) / hw;
        out[e] = apply<kRes>(xv[k][e], rv[k][kRes ? e : 0], qe, pl, rpl);
      }
      store(xc, j, out);
    }
  }
  // elements past the last whole vector: a tensor of size % 4 != 0
  for (int o = nvec * 4 + threadIdx.x; o < len; o += kThreads) {
    float rr = 0.f;
    if constexpr (kRes != 0) rr = __ldg(rc + o);
    xc[o] = apply<kRes>(xc[o], rr, (off0 + o) / hw, pl, rpl);
  }
}

template <int kRes>
cudaError_t launch(float* x, const float* r, const Norm& bn, const Norm& rbn, long long total,
                   int hw, int C, cudaStream_t stream) {
  const int chunk = hw >= 4 ? kMaxChunk : 1024 * hw;  // at most kMaxPlanes planes a chunk
  const unsigned blocks = static_cast<unsigned>((total + chunk - 1) / chunk);
  bn_act_kernel<kRes><<<blocks, kThreads, 0, stream>>>(x, r, bn, rbn, total, hw, C, chunk);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x [total / (C * hw), C, hw] f32, contiguous, overwritten with the result.
// residual: 0 none (r and the r* BatchNorm pointers unused), 1 r added as it
// is, 2 r through its own BatchNorm (rweight, rbias, rmean, rvar, reps);
// r has x's shape and is contiguous; x and r are 16-byte aligned. Every
// BatchNorm tensor is f32 [C]. The caller guarantees 0 < total,
// 0 < hw < 2^30 and total / 1024 < 2^31.
// Launches on `stream`; returns cudaGetLastError() after the launch (0 on
// success).
int nbdt_bn_act(void* x, const void* r, const void* weight, const void* bias, const void* mean,
                const void* var, float eps, const void* rweight, const void* rbias,
                const void* rmean, const void* rvar, float reps, long long total, int hw, int C,
                int residual, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Norm bn{static_cast<const float*>(weight), static_cast<const float*>(bias),
                static_cast<const float*>(mean), static_cast<const float*>(var), eps};
  const Norm rbn{static_cast<const float*>(rweight), static_cast<const float*>(rbias),
                 static_cast<const float*>(rmean), static_cast<const float*>(rvar), reps};
  float* xp = static_cast<float*>(x);
  const float* rp = static_cast<const float*>(r);
  switch (residual) {
    case 0: return launch<0>(xp, rp, bn, rbn, total, hw, C, s);
    case 1: return launch<1>(xp, rp, bn, rbn, total, hw, C, s);
    case 2: return launch<2>(xp, rp, bn, rbn, total, hw, C, s);
    default: return cudaErrorInvalidValue;
  }
}

const char* nbdt_bn_act_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

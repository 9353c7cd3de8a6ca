// A depthwise k x k convolution (k 3 or 5, stride 1 or 2) with TF "SAME"
// or symmetric zero padding, its eval-mode BatchNorm and swish, as one pass
// over an NCHW f32 tensor, for Hopper (sm_90a).
//
// Replaces no TPU kernel. nbdt_tpu leaves EfficientNet's depthwise conv,
// BatchNorm and swish to XLA, which fuses the elementwise epilogue into the
// conv; in PyTorch eager they are up to four library passes (F.pad's copy
// at a stride-2 SAME conv, ATen's NCHW conv_depthwise2d, cuDNN's inference
// BatchNorm, the swish), each reading and writing a whole tensor. This
// kernel is the one pass. Per output of plane (n, c):
//
//   acc = sum over dy, dx of x_padded[n, c, s * i + dy, s * j + dx] * w[c, dy, dx]
//   s_c = weight[c] / sqrt(var[c] + eps)
//   y   = (acc - mean[c]) * s_c + bias[c]
//   out = y / (1 + exp(-y))
//
// The pad is never written: rows and columns outside the input load as
// zeros. The sum runs over dy, then dx, with fused multiply-adds; the
// BatchNorm rounds where bn_act.cu and the plain PyTorch version do (the mean
// subtracted before the scale, IEEE division and square root); swish uses
// the full-precision expf and an IEEE division, as F.silu does. No atomics:
// the result does not change from run to run.
//
// Bound on an H100 SXM: bytes. An output costs 2 k^2 flops (18 or 50) for
// its 4 bytes and a share of the input's (4 or 16 bytes at stride 1 or 2),
// under the card's 20 flops a byte. EfficientNet-B7b at 600px moves 68.4 GB
// a request of 64 images through its 55 depthwise convs: 20.4 ms at 3.35
// TB/s. But a float of output also takes some 40-60 instructions (the k^2
// fused multiply-adds, the accurate expf and the IEEE division), so the
// design reads each input byte once from HBM, writes each output byte once,
// and keeps the instructions around them few:
//  * A block of 256 threads takes a tile: one plane's band of TH output
//    rows (planes of 75-300 a side), or P whole planes (19 and 38 a side,
//    where one plane is too little work). Its input rows, halo included,
//    go to shared memory by 4-byte cp.async, all in flight at once, at most
//    kBudget floats (48 KB) a tile, four blocks an SM. Rows of 64 floats or more
//    go a warp a row, cp.async's zero fill writing the pad; narrower rows
//    (19, 38) would leave the warps' lanes idle and pay a row's overhead
//    for a few floats, so the tile is zeroed and the rows it needs, one run
//    of global memory, are copied flat, neighbouring threads on
//    neighbouring floats. Bands of one plane are neighbouring blocks, so a
//    band's halo rows come from L2. (Row strides of 19, 38, 75 and 150
//    floats are not 16-byte multiples, so TMA and 16-byte global loads are
//    left out.)
//  * A thread computes TY x 4 outputs (TY = 4 at k = 3, 2 at k = 5): it
//    reads each of its (TY - 1) s + k input rows as 16-byte vectors from
//    shared memory once (a staged row is a multiple of 4 floats wide) and
//    keeps them in registers for every output that needs them: 1.5 reads
//    an output at k = 5, s = 1, where one output alone takes 25 scalar
//    reads. Neighbouring threads take neighbouring column groups and step
//    through the tile's items digit by digit, with no division.
//  * The channel's k^2 weights and its BatchNorm mean, scale and bias live
//    in registers, reloaded from shared memory only when a thread's plane
//    changes. A row of 4 outputs is one 16-byte store where its address
//    allows, else four.

#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTX = 4;            // outputs a thread computes along a row
constexpr int kBudget = 12288;    // floats of input a tile stages (48 KB)
constexpr int kMaxPlanes = 16;    // whole planes a block takes
constexpr int kWideRow = 64;      // input rows from this width up are staged a warp a row
constexpr int kMaxSmem = 232448;  // bytes of shared memory a block may use

// Output rows a thread computes: 4 for a 3x3 filter, 2 for a 5x5 (its 25
// weights take the registers).
__host__ __device__ constexpr int rows_per_thread(int k) { return k == 3 ? 4 : 2; }

// 16-byte shared-memory reads a thread makes of an input row.
__host__ __device__ constexpr int row_vectors(int k, int s) {
  return ((kTX - 1) * s + k + 3) / 4;
}

struct Norm {
  const float* weight;
  const float* bias;
  const float* mean;
  const float* var;
  float eps;
};

struct Geometry {
  int C, H, W, Ho, Wo;
  int pad_t, pad_l;
  int NQ;      // groups of kTX output columns: ceil(Wo / kTX)
  int Wp;      // columns a tile stages, a multiple of 4: (NQ - 1) kTX s + 4 row_vectors
  int TH;      // output rows of a tile
  int RG;      // groups of TY output rows in a tile: ceil(TH / TY)
  int R;       // rows a tile stages: (RG TY - 1) s + k
  int tiles;   // tiles of a plane (1 where a block takes whole planes)
  int P;       // planes a block takes
  long long planes;  // N * C
};

// 4 bytes from global to shared memory, asynchronously; zeros where !ok
// (the source is then not read).
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool ok = true) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(ok ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ float bn_swish(float acc, float mean, float scale, float bias) {
  const float y = __fadd_rn(__fmul_rn(__fsub_rn(acc, mean), scale), bias);
  return __fdiv_rn(y, __fadd_rn(1.f, expf(-y)));
}

template <int K, int S>
__global__ void __launch_bounds__(kThreads, 4) dw_bn_swish_kernel(
    const float* __restrict__ x, const float* __restrict__ w, Norm bn, float* __restrict__ y,
    Geometry g) {
  constexpr int TY = rows_per_thread(K);
  constexpr int NV = row_vectors(K, S);
  constexpr int RIN = (TY - 1) * S + K;  // input rows a thread's outputs read
  extern __shared__ float4 tile4[];      // [np][R][Wp]
  float* tile = reinterpret_cast<float*>(tile4);
  __shared__ float s_w[kMaxPlanes * K * K];
  __shared__ float s_mean[kMaxPlanes], s_scale[kMaxPlanes], s_bias[kMaxPlanes];

  const long long pg = blockIdx.x / g.tiles;
  const int t = static_cast<int>(blockIdx.x - pg * g.tiles);
  const long long p0 = pg * g.P;                        // the block's first plane
  const int np = static_cast<int>(min(static_cast<long long>(g.P), g.planes - p0));
  const int row0 = t * g.TH;                            // its first output row
  const int rows = min(g.TH, g.Ho - row0);
  const int in_row0 = row0 * S - g.pad_t;               // its first staged input row
  const long long hw = static_cast<long long>(g.H) * g.W;

  if (g.W >= kWideRow) {
    // One warp a row, the pad and the columns past the input as cp.async's
    // zero fill: row r of the tile is row rr of plane q
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    int q = warp / g.R, rr = warp - q * g.R;
    for (int r = warp; r < np * g.R; r += kWarps) {
      const int ir = in_row0 + rr;
      const bool row_ok = static_cast<unsigned>(ir) < static_cast<unsigned>(g.H);
      const float* src = x + (p0 + q) * hw + static_cast<long long>(row_ok ? ir : 0) * g.W -
                         g.pad_l;
      float* dst = tile + r * g.Wp;
      for (int cc = lane; cc < g.Wp; cc += 32) {
        const bool ok =
            row_ok && static_cast<unsigned>(cc - g.pad_l) < static_cast<unsigned>(g.W);
        cp_async4(dst + cc, ok ? src + cc : x, ok);
      }
      for (rr += kWarps; rr >= g.R; rr -= g.R) ++q;
    }
  } else {
    // Narrow rows: zero the tile, then copy the input rows it stages over
    // it. Those rows are one run of global memory (over several planes,
    // where a block takes whole planes), copied element by element,
    // neighbouring threads on neighbouring floats.
    for (int i = threadIdx.x; i < np * g.R * g.Wp / 4; i += kThreads) {
      tile4[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
    __syncthreads();
    const int r_lo = max(in_row0, 0), nrows = min(in_row0 + g.R, g.H) - r_lo;
    const int cols = min(g.W, g.Wp - g.pad_l);  // input columns some output reads
    if (nrows > 0) {
      // element e of the run is column c of row r_lo + r of plane q
      const float* src = x + p0 * hw + static_cast<long long>(r_lo) * g.W;
      const long long skip = hw - static_cast<long long>(nrows) * g.W;  // a plane's other rows
      float* dst = tile + (r_lo - in_row0) * g.Wp + g.pad_l;
      const int step_r = kThreads / g.W, step_c = kThreads - step_r * g.W;
      int c = threadIdx.x % g.W, r = threadIdx.x / g.W, q = 0;
      for (; r >= nrows; r -= nrows) ++q;
      for (int e = threadIdx.x; e < np * nrows * g.W; e += kThreads) {
        if (c < cols) cp_async4(dst + (q * g.R + r) * g.Wp + c, src + e + q * skip);
        c += step_c;
        if (c >= g.W) {
          c -= g.W;
          ++r;
        }
        for (r += step_r; r >= nrows; r -= nrows) ++q;
      }
    }
  }
  // While those are in flight: each plane's weights, mean, scale and bias
  for (int i = threadIdx.x; i < np * K * K; i += kThreads) {
    s_w[i] = __ldg(w + static_cast<int>((p0 + i / (K * K)) % g.C) * K * K + i % (K * K));
  }
  for (int i = threadIdx.x; i < np; i += kThreads) {
    const int c = static_cast<int>((p0 + i) % g.C);
    s_mean[i] = __ldg(bn.mean + c);
    s_scale[i] =
        __fdiv_rn(__ldg(bn.weight + c), __fsqrt_rn(__fadd_rn(__ldg(bn.var + c), bn.eps)));
    s_bias[i] = __ldg(bn.bias + c);
  }
  cp_async_wait_all();
  __syncthreads();

  // Tiles of TY x kTX outputs, neighbouring threads on neighbouring column
  // groups. Item i is (plane q, row group rg, column group cq), cq fastest;
  // a thread steps i by kThreads, digit by digit.
  const int step_t = kThreads / g.NQ, step_cq = kThreads - step_t * g.NQ;
  const int step_q = step_t / g.RG, step_rg = step_t - step_q * g.RG;
  int cq = threadIdx.x % g.NQ, rg = threadIdx.x / g.NQ;
  int q = rg / g.RG;
  rg -= q * g.RG;
  int cur = -1;
  float wr[K * K], mean = 0.f, scale = 0.f, bias = 0.f;
  while (q < np) {
    if (q != cur) {
      cur = q;
#pragma unroll
      for (int j = 0; j < K * K; ++j) wr[j] = s_w[q * K * K + j];
      mean = s_mean[q];
      scale = s_scale[q];
      bias = s_bias[q];
    }
    const float4* b = reinterpret_cast<const float4*>(
        tile + (q * g.R + rg * TY * S) * g.Wp + cq * kTX * S);
    float acc[TY][kTX];
#pragma unroll
    for (int ty = 0; ty < TY; ++ty) {
#pragma unroll
      for (int tx = 0; tx < kTX; ++tx) acc[ty][tx] = 0.f;
    }
#pragma unroll
    for (int ir = 0; ir < RIN; ++ir) {
      float xr[NV * 4];
#pragma unroll
      for (int v = 0; v < NV; ++v) {
        const float4 f = b[ir * (g.Wp / 4) + v];
        xr[4 * v] = f.x;
        xr[4 * v + 1] = f.y;
        xr[4 * v + 2] = f.z;
        xr[4 * v + 3] = f.w;
      }
#pragma unroll
      for (int ty = 0; ty < TY; ++ty) {
        const int dy = ir - ty * S;
        if (dy >= 0 && dy < K) {
#pragma unroll
          for (int tx = 0; tx < kTX; ++tx) {
#pragma unroll
            for (int dx = 0; dx < K; ++dx) {
              acc[ty][tx] = __fmaf_rn(xr[tx * S + dx], wr[dy * K + dx], acc[ty][tx]);
            }
          }
        }
      }
    }
    const int orow = rg * TY, ocol = cq * kTX;
    float* out = y + (p0 + q) * static_cast<long long>(g.Ho) * g.Wo +
                 static_cast<long long>(row0 + orow) * g.Wo + ocol;
#pragma unroll
    for (int ty = 0; ty < TY; ++ty) {
      if (orow + ty < rows) {
        float o[kTX];
#pragma unroll
        for (int tx = 0; tx < kTX; ++tx) o[tx] = bn_swish(acc[ty][tx], mean, scale, bias);
        float* dst = out + ty * g.Wo;
        if (ocol + kTX <= g.Wo && (reinterpret_cast<uintptr_t>(dst) & 15) == 0) {
          *reinterpret_cast<float4*>(dst) = make_float4(o[0], o[1], o[2], o[3]);
        } else {
#pragma unroll
          for (int tx = 0; tx < kTX; ++tx) {
            if (ocol + tx < g.Wo) dst[tx] = o[tx];
          }
        }
      }
    }
    cq += step_cq;
    const int carry = cq >= g.NQ;
    cq -= carry * g.NQ;
    rg += step_rg + carry;
    q += step_q;
    if (rg >= g.RG) {
      rg -= g.RG;
      ++q;
    }
  }
}

template <int K, int S>
cudaError_t launch(const float* x, const float* w, const Norm& bn, float* y, Geometry g,
                   cudaStream_t stream) {
  constexpr int TY = rows_per_thread(K);
  const auto staged_rows = [](int th) { return ((th + TY - 1) / TY * TY - 1) * S + K; };
  g.NQ = (g.Wo + kTX - 1) / kTX;
  g.Wp = (g.NQ - 1) * kTX * S + 4 * row_vectors(K, S);
  const int whole = staged_rows(g.Ho) * g.Wp;
  if (whole <= kBudget) {  // whole planes, as many as fit
    g.TH = g.Ho;
    g.tiles = 1;
    g.P = static_cast<int>(
        std::min(static_cast<long long>(std::min(kMaxPlanes, kBudget / whole)), g.planes));
  } else {  // bands of one plane, of even height, as tall as fit
    int th = TY;
    while (th + TY < g.Ho && staged_rows(th + TY) * g.Wp <= kBudget) th += TY;
    g.tiles = (g.Ho + th - 1) / th;
    const int even = (g.Ho + g.tiles - 1) / g.tiles;
    g.TH = (even + TY - 1) / TY * TY;
    g.tiles = (g.Ho + g.TH - 1) / g.TH;
    g.P = 1;
  }
  g.RG = (g.TH + TY - 1) / TY;
  g.R = staged_rows(g.TH);
  const size_t smem = static_cast<size_t>(g.P) * g.R * g.Wp * sizeof(float);
  const size_t fixed = (kMaxPlanes * (K * K + 3)) * sizeof(float);
  if (smem + fixed > kMaxSmem) return cudaErrorInvalidValue;
  if (smem + fixed > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        dw_bn_swish_kernel<K, S>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const long long blocks = (g.planes + g.P - 1) / g.P * g.tiles;
  if (blocks >= (1LL << 31)) return cudaErrorInvalidValue;
  dw_bn_swish_kernel<K, S><<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
      x, w, bn, y, g);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x [N, C, H, W] f32, contiguous; w [C, 1, k, k] f32, contiguous; every
// BatchNorm tensor f32 [C]; y [N, C, Ho, Wo] f32, contiguous, written.
// k is 3 or 5, stride 1 or 2; pad_t and pad_l are the zeros before the
// first row and column, and Ho, Wo the output's sides (the bottom and right
// pads follow from them). The caller guarantees 0 < N * C, 0 < Ho, 0 < Wo,
// H * W < 2^31 and Ho * Wo < 2^31, and checks what this returns: 0 on
// success, else a cudaError_t (cudaErrorInvalidValue for a kernel size,
// stride or plane width outside the kernel's range).
// Launches on `stream`; returns cudaGetLastError() after the launch.
int nbdt_dw_bn_swish(const void* x, const void* w, const void* weight, const void* bias,
                     const void* mean, const void* var, float eps, void* y, int N, int C, int H,
                     int W, int Ho, int Wo, int k, int stride, int pad_t, int pad_l, int device,
                     void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Norm bn{static_cast<const float*>(weight), static_cast<const float*>(bias),
                static_cast<const float*>(mean), static_cast<const float*>(var), eps};
  Geometry g{};
  g.C = C;
  g.H = H;
  g.W = W;
  g.Ho = Ho;
  g.Wo = Wo;
  g.pad_t = pad_t;
  g.pad_l = pad_l;
  g.planes = static_cast<long long>(N) * C;
  const float* xp = static_cast<const float*>(x);
  const float* wp = static_cast<const float*>(w);
  float* yp = static_cast<float*>(y);
  if (k == 3 && stride == 1) return launch<3, 1>(xp, wp, bn, yp, g, s);
  if (k == 3 && stride == 2) return launch<3, 2>(xp, wp, bn, yp, g, s);
  if (k == 5 && stride == 1) return launch<5, 1>(xp, wp, bn, yp, g, s);
  if (k == 5 && stride == 2) return launch<5, 2>(xp, wp, bn, yp, g, s);
  return cudaErrorInvalidValue;
}

const char* nbdt_dw_bn_swish_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

// Fused soft-NBDT head for Hopper (sm_90a): classifier product, per-node
// child logits, exact per-node masked log-softmax and leaf path sum in one
// kernel.
//
// Replaces the TPU kernel nbdt_tpu/ops/soft_traversal.py::_head_kernel
// (driven by fused_soft_head there). Per batch row b it computes
//
//   x[b, c]     = sum_d feats[b, d] * W[d, c] + bias[c]
//   nl[b, s]    = sum_{c under slot s} membership[s, c] * x[b, c]
//   logp[b, s]  = nl[b, s] - logsumexp over the valid slots of s's node
//   leaf[b, c]  = sum_{slots s containing c} logp[b, s]
//
// Bound on an H100 SXM: at the main-path shape (B=8192, D=512, C=10, N=9,
// K=2) the kernel must read feats, 16.8 MB in f32 (8.4 MB in bf16), and
// write 328 KB of leaf log-probs: about 5 us at 3.35 TB/s. Its 84 MFLOP of
// f32 work take about 1.3 us at 67 TFLOP/s. So it is memory-bound.
//
// Design (first version, simple and right before fast; on an H100 SXM at
// the main-path shape it takes about 12x its bound, see PERF.md, and making
// it fast is later work):
//  * One block per tile of `tb` batch rows; nothing carries between blocks.
//    The feats tile is staged in shared memory as f32 (a bf16 product is
//    exact in f32, so bf16 inputs read bf16 and accumulate in f32), then x,
//    then the slot log-probs, all for this tile only.
//  * The classifier product runs here on CUDA cores in f32 FMA (no TF32,
//    no tensor cores); each thread owns one class column for 4 rows, so a
//    W load is reused 4 times and neighbouring threads read neighbouring
//    W addresses.
//  * The tree math is exact f32 on CUDA cores. The TPU kernel's dense,
//    128-lane padded M2T and U matrices fed its matrix unit and are mostly
//    zeros; here the host passes compact lists instead: for each slot the
//    classes under it with their membership weight, and for each class the
//    slots that contain it (taken from `under`, so on a DAG every containing
//    slot counts, as in the JAX rules). The result equals the dense
//    formulation up to f32 summation order.
//  * Wide trees are loops over classes and nodes inside the block; only the
//    per-row x and log-prob rows live in shared memory, and the host shrinks
//    `tb` until they fit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr float kNeg = -1e30f;
constexpr int kThreads = 256;
constexpr int kRowGroup = 4;  // rows of the classifier product per thread

__host__ __device__ inline int round_up(int n, int m) { return (n + m - 1) / m * m; }

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// Four consecutive elements as f32, from a 16-byte (f32) or 8-byte (bf16)
// aligned address.
__device__ __forceinline__ void load4(const float* p, float* out) {
  float4 v = *reinterpret_cast<const float4*>(p);
  out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float* out) {
  const __nv_bfloat162* q = reinterpret_cast<const __nv_bfloat162*>(p);
  float2 a = __bfloat1622float2(q[0]);
  float2 b = __bfloat1622float2(q[1]);
  out[0] = a.x; out[1] = a.y; out[2] = b.x; out[3] = b.y;
}

template <typename T>
__global__ void __launch_bounds__(kThreads) soft_head_kernel(
    const T* __restrict__ feats,                 // [B, D]
    const T* __restrict__ W,                     // [D, C]
    const float* __restrict__ bias,              // [C]
    const int* __restrict__ slot_ptr,            // [S + 1]
    const int* __restrict__ slot_cls,            // [nnz]
    const float* __restrict__ slot_w,            // [nnz]
    const unsigned char* __restrict__ slot_valid,  // [S]
    const int* __restrict__ class_ptr,           // [C + 1]
    const int* __restrict__ class_slot,          // [nnz]
    float* __restrict__ leaf,                    // [B, C]
    float* __restrict__ logits,                  // [B, C] or null
    float* __restrict__ logp,                    // [B, S] node-major, or null
    int B, int D, int C, int N, int K, int tb, int vec) {
  extern __shared__ float smem[];
  const int S = N * K;
  const int ldf = D + 1;  // odd row stride: rows of one column hit distinct banks
  float* f_s = smem;                                // [round_up(tb, 4), D + 1]
  float* x_s = f_s + round_up(tb, kRowGroup) * ldf;  // [tb, C]
  float* l_s = x_s + tb * C;                        // [tb, S]
  const int row0 = blockIdx.x * tb;
  const int rows = min(tb, B - row0);
  const T* ftile = feats + static_cast<size_t>(row0) * D;

  // 1. Stage the feats tile as f32.
  if (vec) {
    const int d4 = D / 4;
    for (int i = threadIdx.x; i < rows * d4; i += blockDim.x) {
      const int r = i / d4, d = (i - r * d4) * 4;
      float v[4];
      load4(ftile + static_cast<size_t>(r) * D + d, v);
      float* dst = f_s + r * ldf + d;
      dst[0] = v[0]; dst[1] = v[1]; dst[2] = v[2]; dst[3] = v[3];
    }
  } else {
    for (int i = threadIdx.x; i < rows * D; i += blockDim.x) {
      const int r = i / D, d = i - r * D;
      f_s[r * ldf + d] = to_f32(ftile[static_cast<size_t>(r) * D + d]);
    }
  }
  __syncthreads();

  // 2. Classifier: x = feats @ W + bias. Thread -> (row group, class), class
  //    fastest. Rows past `rows` in the last group read unused shared memory
  //    and are never stored.
  const int groups = (rows + kRowGroup - 1) / kRowGroup;
  for (int i = threadIdx.x; i < groups * C; i += blockDim.x) {
    const int g = i / C, c = i - g * C;
    const float* fr = f_s + g * kRowGroup * ldf;
    float acc[kRowGroup];
#pragma unroll
    for (int j = 0; j < kRowGroup; ++j) acc[j] = 0.f;
    for (int d = 0; d < D; ++d) {
      const float w = to_f32(W[static_cast<size_t>(d) * C + c]);
#pragma unroll
      for (int j = 0; j < kRowGroup; ++j) acc[j] = fmaf(fr[j * ldf + d], w, acc[j]);
    }
#pragma unroll
    for (int j = 0; j < kRowGroup; ++j) {
      const int r = g * kRowGroup + j;
      if (r < rows) {
        const float v = acc[j] + bias[c];
        x_s[r * C + c] = v;
        if (logits) logits[static_cast<size_t>(row0 + r) * C + c] = v;
      }
    }
  }
  __syncthreads();

  // 3. Node logits and the exact masked log-softmax over each node's K
  //    slots. Thread -> (row, node), node fastest.
  for (int i = threadIdx.x; i < rows * N; i += blockDim.x) {
    const int r = i / N, n = i - r * N;
    const float* xr = x_s + r * C;
    float* lr = l_s + r * S + n * K;
    float m = kNeg;
    for (int k = 0; k < K; ++k) {
      const int s = n * K + k;
      float v = 0.f;
      for (int j = slot_ptr[s]; j < slot_ptr[s + 1]; ++j) v = fmaf(slot_w[j], xr[slot_cls[j]], v);
      lr[k] = v;
      if (slot_valid[s]) m = fmaxf(m, v);
    }
    if (!(m > 0.5f * kNeg)) m = 0.f;  // a node whose slots are all padding
    float e = 0.f;
    for (int k = 0; k < K; ++k)
      if (slot_valid[n * K + k]) e += expf(lr[k] - m);
    const float lse = logf(fmaxf(e, 1e-30f)) + m;
    for (int k = 0; k < K; ++k) {
      const int s = n * K + k;
      const bool valid = slot_valid[s] != 0;
      const float lp = lr[k] - lse;
      lr[k] = valid ? lp : 0.f;  // padding is inert in the path sum
      if (logp) logp[static_cast<size_t>(row0 + r) * S + s] = valid ? lp : kNeg;
    }
  }
  __syncthreads();

  // 4. Leaf path sum. Thread -> (row, class), class fastest.
  for (int i = threadIdx.x; i < rows * C; i += blockDim.x) {
    const int r = i / C, c = i - r * C;
    const float* lr = l_s + r * S;
    float v = 0.f;
    for (int j = class_ptr[c]; j < class_ptr[c + 1]; ++j) v += lr[class_slot[j]];
    leaf[static_cast<size_t>(row0 + r) * C + c] = v;
  }
}

template <typename T>
cudaError_t launch(const void* feats, const void* W, const void* bias,
                   const void* slot_ptr, const void* slot_cls, const void* slot_w,
                   const void* slot_valid, const void* class_ptr, const void* class_slot,
                   void* leaf, void* logits, void* logp, int B, int D, int C, int N,
                   int K, int tb, size_t smem, cudaStream_t stream) {
  const int vec = (D % 4 == 0) && (reinterpret_cast<size_t>(feats) % 16 == 0);
  cudaError_t err = cudaFuncSetAttribute(
      soft_head_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  soft_head_kernel<T><<<(B + tb - 1) / tb, kThreads, smem, stream>>>(
      static_cast<const T*>(feats), static_cast<const T*>(W), static_cast<const float*>(bias),
      static_cast<const int*>(slot_ptr), static_cast<const int*>(slot_cls),
      static_cast<const float*>(slot_w), static_cast<const unsigned char*>(slot_valid),
      static_cast<const int*>(class_ptr), static_cast<const int*>(class_slot),
      static_cast<float*>(leaf), static_cast<float*>(logits), static_cast<float*>(logp),
      B, D, C, N, K, tb, vec);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Dynamic shared memory of one block of `tb` rows.
size_t nbdt_soft_head_smem_bytes(int tb, int D, int C, int S) {
  return sizeof(float) * (static_cast<size_t>(round_up(tb, kRowGroup)) * (D + 1) +
                          static_cast<size_t>(tb) * C + static_cast<size_t>(tb) * S);
}

// Launches on `stream`; returns cudaGetLastError() after the launch (0 on
// success). `logits` and `logp` are null when the caller wants no aux outputs.
int nbdt_soft_head(const void* feats, const void* W, const void* bias, const void* slot_ptr,
                   const void* slot_cls, const void* slot_w, const void* slot_valid,
                   const void* class_ptr, const void* class_slot, void* leaf, void* logits,
                   void* logp, int B, int D, int C, int N, int K, int tb, int bf16, int device,
                   void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const size_t smem = nbdt_soft_head_smem_bytes(tb, D, C, N * K);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch<__nv_bfloat16>(feats, W, bias, slot_ptr, slot_cls, slot_w, slot_valid,
                                 class_ptr, class_slot, leaf, logits, logp, B, D, C, N, K, tb,
                                 smem, s);
  return launch<float>(feats, W, bias, slot_ptr, slot_cls, slot_w, slot_valid, class_ptr,
                       class_slot, leaf, logits, logp, B, D, C, N, K, tb, smem, s);
}

const char* nbdt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

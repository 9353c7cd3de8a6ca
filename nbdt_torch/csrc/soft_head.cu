// Fused soft-NBDT head for Hopper (sm_90a): classifier product, per-node
// child logits, exact per-node masked log-softmax and leaf path sum in one
// launch per call.
//
// Replaces the TPU kernel nbdt_tpu/ops/soft_traversal.py::_head_kernel
// (driven by fused_soft_head there). Per batch row b it computes
//
//   x[b, c]     = sum_d feats[b, d] * W[d, c] + bias[c]
//   nl[b, s]    = sum_{c under slot s} membership[s, c] * x[b, c]
//   logp[b, s]  = nl[b, s] - logsumexp over the valid slots of s's node
//   leaf[b, c]  = sum_{slots s containing c} logp[b, s]
//
// The TPU kernel's dense, 128-lane padded M2T and U matrices fed its matrix
// unit and are mostly zeros; here the host passes compact lists instead: for
// each slot the classes under it with their membership weight, and for each
// class the slots that contain it (taken from `under`, so on a DAG every
// containing slot counts, as in the JAX rules). The classifier runs in f32
// FMA on CUDA cores (bf16 inputs are widened; a bf16 product is exact in
// f32); no TF32 anywhere. The tree math is exact f32.
//
// Bounds on an H100 SXM (published peaks: 3.35 TB/s, 67 TFLOP/s f32, 989
// TFLOP/s bf16 on tensor cores):
//  * ResNet18 head (B=8192, D=512, C=10, N=9, K=2): it must read 16.8 MB of
//    f32 feats and write 328 KB of leaf log-probs, about 5.1 us; its 84 MFLOP
//    take 1.3 us. Bytes bound it.
//  * ViT-B/16 head (B=256, D=768, C=1000, N=999, K=2): 393 M classifier
//    FLOP, about 6 us at the f32 peak, against 3.8 MB of bytes (1.1 us).
//    Operations bound it.
// The host (nbdt_torch/ops/soft_traversal.py::plan_soft_head) picks one of
// two instances by shape:
//
//  * Streaming instance (C <= 32, narrow trees; the bytes-bound ResNet
//    head): W (transposed) and every tree list sit in shared memory once per
//    block; two persistent blocks an SM, each warp walking groups of R rows
//    (R x padded C = 32). A lane holds its 16-byte vectors of the next
//    group's rows in registers while it works on the current group, so the
//    feats stream from HBM without a gap; it keeps R x C partial sums, and a
//    halving butterfly of 31 shuffles leaves each lane with one (row, class)
//    sum. The warp then runs the tree math for its rows out of shared memory
//    and writes the leaf rows coalesced.
//
//  * Cluster instance (wide trees; the operations-bound ViT head): a
//    thread-block cluster of Q <= 8 blocks, one an SM, shares one tile of up
//    to 20 rows (the host sizes tiles so that the batch fills one wave of
//    the clusters the card holds: 15 tiles of 18 rows at the ViT head).
//     - Classifier: rank r computes x for its class slice (a multiple of
//       128 classes, 16-byte aligned). W streams through a ring of up to
//       four 64-row chunks by cp.async. The feats tile follows in the same
//       64-column chunks: a thread holds its share of chunk k + 1 in
//       registers while the block works on chunk k, then stores it,
//       transposed and widened to f32, into one of two chunk buffers, so
//       shared memory does not grow with D. Warp w takes 8 of each chunk's rows
//       and each lane 10 rows x 8 classes of sums, so the 18 values it loads
//       a step feed 80 FMA; the warps' sums are then added in a fixed order.
//       f32 FMA on CUDA cores: shared-memory instruction traffic, not the
//       FMA rate, was the limit of thinner register tiles.
//     - Exchange: rank r takes rows r, r + Q, ... through the whole tree, so
//       it pulls only those rows of x from the other ranks (distributed
//       shared memory moves about 20 GB/s an SM here, so a 16 KB pull beats
//       all-gathering x and the slot log-probs for a split by nodes, which
//       cost 14 us of 54 in a measured version).
//     - Tree: the slot and class lists are staged in shared memory where
//       they fit (cp.async, beside the pull); a thread walks each short slot
//       list for four rows at once, and the long lists (the root's hold
//       about 500 classes) go round robin to whole warps; then each node's
//       log-softmax and each class's path sum, four rows at once.
//     Two cluster barriers: x made; every pull done (after it no block
//     touches another's shared memory, so any may leave).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr float kNeg = -1e30f;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxRanks = 8;     // portable cluster size
constexpr int kSlice = 128;      // classes of one classifier pass in a block
constexpr int kChunk = 64;       // W rows per ring stage
constexpr int kMaxStages = 4;    // W ring stages: up to three chunks in flight while one is used
constexpr int kTileRows = 20;    // most batch rows of a cluster tile (a float4 multiple)
constexpr int kFStride = 24;     // floats of one feats column: rows 0-9 at 0, rows 10-19 at 12
constexpr int kFeatBytes = 2 * 4 * kChunk * kFStride;  // two transposed f32 feats chunks
constexpr int kSmemLimit = 232448 - 2048;  // dynamic shared memory a block may use beside
                                           // the cluster instance's static arrays
constexpr int kMaxLong = 256;    // long slot lists a block queues for its warps
constexpr int kRedBytes = 4 * kWarps * kTileRows * kSlice;  // the warps' partial sums of a pass
constexpr int kLongList = 64;    // slot lists longer than this take a warp each

__host__ __device__ inline size_t round_up(size_t n, size_t m) { return (n + m - 1) / m * m; }

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// Elements of a 16-byte vector, widened to f32.
__device__ __forceinline__ void widen(const float4& v, float* out) {
  out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
}
__device__ __forceinline__ void widen(const uint4& v, float* out) {
  const uint32_t u[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    __nv_bfloat162 h;
    *reinterpret_cast<uint32_t*>(&h) = u[i];
    const float2 f = __bfloat1622float2(h);
    out[2 * i] = f.x; out[2 * i + 1] = f.y;
  }
}
template <typename T> struct Vec;
template <> struct Vec<float> { using type = float4; };
template <> struct Vec<__nv_bfloat16> { using type = uint4; };

struct Tree {
  const float* bias;              // [C]
  const int* slot_ptr;            // [S + 1]
  const int* slot_cls;            // [nnz_s]
  const float* slot_w;            // [nnz_s]
  const unsigned char* slot_valid;  // [S]
  const int* class_ptr;           // [C + 1]
  const int* class_slot;          // [nnz_c]
};

struct Out {
  float* leaf;    // [B, C]
  float* logits;  // [B, C] or null
  float* logp;    // [B, S] node-major, or null
};

// Logit of slot s for one row: the membership-weighted sum of the row's x.
__device__ __forceinline__ float slot_logit(const float* x, int s, const int* slot_ptr,
                                            const int* slot_cls, const float* slot_w) {
  float v = 0.f;
  for (int j = slot_ptr[s]; j < slot_ptr[s + 1]; ++j) v = fmaf(slot_w[j], x[slot_cls[j]], v);
  return v;
}

// Exact masked log-softmax over node n's K slots of one row, in place in the
// row's slot buffer `l` (which holds their logits): log-probs on valid
// slots, 0 on padding (inert in the path sum); the aux row gets -1e30 there.
__device__ __forceinline__ void node_softmax(float* l, int n, int K,
                                             const unsigned char* slot_valid, float* logp_row) {
  float m = kNeg;
  for (int k = 0; k < K; ++k)
    if (slot_valid[n * K + k]) m = fmaxf(m, l[n * K + k]);
  if (!(m > 0.5f * kNeg)) m = 0.f;  // a node whose slots are all padding
  float e = 0.f;
  for (int k = 0; k < K; ++k)
    if (slot_valid[n * K + k]) e += expf(l[n * K + k] - m);
  const float lse = logf(fmaxf(e, 1e-30f)) + m;
  for (int k = 0; k < K; ++k) {
    const int s = n * K + k;
    const bool valid = slot_valid[s] != 0;
    const float lp = l[s] - lse;
    l[s] = valid ? lp : 0.f;
    if (logp_row) logp_row[s] = valid ? lp : kNeg;
  }
}

// a if c else b, by bits: a select between two array elements can turn into
// a select between their addresses, which puts the array in local memory.
__device__ __forceinline__ float pick(bool c, float a, float b) {
  const int m = -static_cast<int>(c);
  return __int_as_float((__float_as_int(a) & m) | (__float_as_int(b) & ~m));
}

// Halving butterfly over a warp: each lane holds V partial sums; after it,
// lane l holds value (l % V) summed over all 32 lanes. A step of mask m
// keeps the half of the values whose index bit m matches the lane's bit m,
// plus the partner's copy of that half: V - 1 shuffles, then one for each
// lane bit above V. One step per instantiation, so every loop bound is a
// compile-time constant, the loops unroll fully and acc stays in registers.
template <int M>
__device__ __forceinline__ void butterfly(float* acc, int lane) {
  const bool upper = (lane & M) != 0;
#pragma unroll
  for (int i = 0; i < M; ++i) {
    const float lo = acc[i], hi = acc[i + M];
    const float send = pick(upper, lo, hi), keep = pick(upper, hi, lo);
    acc[i] = keep + __shfl_xor_sync(0xffffffffu, send, M);
  }
  if constexpr (M > 1) butterfly<M / 2>(acc, lane);
}

template <int V>
__device__ __forceinline__ float warp_reduce_scatter(float* acc, int lane) {
  static_assert(V >= 2 && V <= 32 && (V & (V - 1)) == 0, "V is a power of two up to 32");
  butterfly<V / 2>(acc, lane);
#pragma unroll
  for (int m = V; m < 32; m *= 2) acc[0] += __shfl_xor_sync(0xffffffffu, acc[0], m);
  return acc[0];
}

// ---------------------------------------------------------------------------
// Streaming instance
// ---------------------------------------------------------------------------

// Shared memory of the streaming instance (bytes): W^T (each class's row
// padded by 16 bytes, so the transposing stores spread over the banks),
// then f32/int lists, then the per-warp x and slot rows, then the
// slot-valid bytes.
__host__ __device__ inline size_t stream_smem(int D, int C, int S, int nnz_s, int nnz_c,
                                              int wbytes, int rows) {
  size_t n = static_cast<size_t>(C) * (D * wbytes + 16);
  n += 4 * (static_cast<size_t>(C) + nnz_s + static_cast<size_t>(kWarps) * rows * (C + S));
  n += 4 * (static_cast<size_t>(S) + 1 + nnz_s + C + 1 + nnz_c);
  n += S;
  return round_up(n, 16);
}

template <typename T, int R, int VL>
__device__ __forceinline__ void load_rows(typename Vec<T>::type (&buf)[R][VL], const T* feats,
                                          int row0, int B, int D, int nv, int lane) {
  using V = typename Vec<T>::type;
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int i = 0; i < VL; ++i) {
      const int v = lane + 32 * i;
      if (row0 + r < B && v < nv)
        buf[r][i] = __ldg(reinterpret_cast<const V*>(feats + static_cast<size_t>(row0 + r) * D) + v);
      else
        buf[r][i] = V{0, 0, 0, 0};
    }
}

template <typename T, int R, int CM>
__global__ void __launch_bounds__(kThreads) soft_head_stream(
    const T* __restrict__ feats, const T* __restrict__ W, Tree tree, Out out, int B, int D,
    int C, int N, int K, int nnz_s, int nnz_c) {
  static_assert(R * CM == 32, "one (row, class) sum per lane");
  using V = typename Vec<T>::type;
  constexpr int E = 16 / sizeof(T);  // elements of one 16-byte vector
  constexpr int VL = 8 / R;          // vectors of a row a lane holds: 8 a lane in flight
  extern __shared__ __align__(16) unsigned char smem[];
  const int S = N * K;
  const int ldw = D + E;                // padded W^T row
  T* w_s = reinterpret_cast<T*>(smem);  // [C, ldw]
  float* bias_s = reinterpret_cast<float*>(w_s + static_cast<size_t>(C) * ldw);
  float* slotw_s = bias_s + C;
  float* xw_s = slotw_s + nnz_s;           // [warps, R, C]
  float* lw_s = xw_s + kWarps * R * C;     // [warps, R, S]
  int* sptr_s = reinterpret_cast<int*>(lw_s + kWarps * R * S);
  int* scls_s = sptr_s + S + 1;
  int* cptr_s = scls_s + nnz_s;
  int* cslot_s = cptr_s + C + 1;
  unsigned char* valid_s = reinterpret_cast<unsigned char*>(cslot_s + nnz_c);

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nv = D / E;
  const int stride = gridDim.x * kWarps * R;
  int row0 = (blockIdx.x * kWarps + warp) * R;
  V cur[R][VL];
  load_rows<T, R, VL>(cur, feats, row0, B, D, nv, lane);  // in flight while the block stages

  for (int i = threadIdx.x; i < C * D; i += kThreads) {  // W [D, C] -> W^T [C, ldw]
    const int d = i / C, c = i - d * C;
    w_s[c * ldw + d] = W[i];
  }
  for (int i = threadIdx.x; i < C; i += kThreads) bias_s[i] = tree.bias[i];
  for (int i = threadIdx.x; i < nnz_s; i += kThreads) {
    slotw_s[i] = tree.slot_w[i];
    scls_s[i] = tree.slot_cls[i];
  }
  for (int i = threadIdx.x; i <= S; i += kThreads) sptr_s[i] = tree.slot_ptr[i];
  for (int i = threadIdx.x; i < S; i += kThreads) valid_s[i] = tree.slot_valid[i];
  for (int i = threadIdx.x; i <= C; i += kThreads) cptr_s[i] = tree.class_ptr[i];
  for (int i = threadIdx.x; i < nnz_c; i += kThreads) cslot_s[i] = tree.class_slot[i];
  __syncthreads();

  float* xw = xw_s + warp * R * C;
  float* lw = lw_s + warp * R * S;
  for (; row0 < B; row0 += stride) {
    const int rv = min(R, B - row0);
    V next[R][VL];
    load_rows<T, R, VL>(next, feats, row0 + stride, B, D, nv, lane);  // the next group's rows
    float acc[R * CM];
#pragma unroll
    for (int i = 0; i < R * CM; ++i) acc[i] = 0.f;
#pragma unroll
    for (int i = 0; i < VL; ++i) {
      const int v = lane + 32 * i;
      if (v < nv) {
        float f[R][E];
#pragma unroll
        for (int r = 0; r < R; ++r) widen(cur[r][i], f[r]);
#pragma unroll
        for (int c = 0; c < CM; ++c) {
          if (c < C) {
            float w[E];
            widen(*reinterpret_cast<const V*>(w_s + static_cast<size_t>(c) * ldw + v * E), w);
#pragma unroll
            for (int r = 0; r < R; ++r)
#pragma unroll
              for (int t = 0; t < E; ++t) acc[r * CM + c] = fmaf(f[r][t], w[t], acc[r * CM + c]);
          }
        }
      }
    }
    for (int v = lane + 32 * VL; v < nv; v += 32) {  // rows wider than the lanes hold
      float f[R][E];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (r < rv) {
          widen(__ldg(reinterpret_cast<const V*>(feats + static_cast<size_t>(row0 + r) * D) + v),
                f[r]);
        } else {
#pragma unroll
          for (int t = 0; t < E; ++t) f[r][t] = 0.f;
        }
      }
#pragma unroll
      for (int c = 0; c < CM; ++c) {
        if (c < C) {
          float w[E];
          widen(*reinterpret_cast<const V*>(w_s + static_cast<size_t>(c) * ldw + v * E), w);
#pragma unroll
          for (int r = 0; r < R; ++r)
#pragma unroll
            for (int t = 0; t < E; ++t) acc[r * CM + c] = fmaf(f[r][t], w[t], acc[r * CM + c]);
        }
      }
    }
    acc[0] = warp_reduce_scatter<32>(acc, lane);
    {
      const int r = lane / CM, c = lane - r * CM;
      if (c < C && r < rv) {
        const float x = acc[0] + bias_s[c];
        xw[r * C + c] = x;
        if (out.logits) out.logits[static_cast<size_t>(row0 + r) * C + c] = x;
      }
    }
    __syncwarp();
    for (int i = lane; i < rv * N; i += 32) {
      const int r = i / N, n = i - r * N;
      float* l = lw + r * S;
      for (int k = 0; k < K; ++k)
        l[n * K + k] = slot_logit(xw + r * C, n * K + k, sptr_s, scls_s, slotw_s);
      node_softmax(l, n, K, valid_s,
                   out.logp ? out.logp + static_cast<size_t>(row0 + r) * S : nullptr);
    }
    __syncwarp();
    for (int i = lane; i < rv * C; i += 32) {
      const int r = i / C, c = i - r * C;
      const float* l = lw + r * S;
      float s = 0.f;
      for (int j = cptr_s[c]; j < cptr_s[c + 1]; ++j) s += l[cslot_s[j]];
      out.leaf[static_cast<size_t>(row0) * C + i] = s;
    }
    __syncwarp();
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int i = 0; i < VL; ++i) cur[r][i] = next[r][i];
  }
}

// ---------------------------------------------------------------------------
// Cluster instance
// ---------------------------------------------------------------------------

// Float4 groups of tile rows each rank takes in the tree phases: rank r
// takes rows r, r + Q, r + 2Q, ..., four to a group.
__host__ __device__ inline int rank_groups(int rows, int q) { return ((rows + q - 1) / q + 3) / 4; }

// Bytes of the tree lists when staged in shared memory, each list 16-byte
// aligned: slot_ptr, slot_cls, slot_w, class_ptr, class_slot, slot_valid.
__host__ __device__ inline size_t list_bytes(int C, int S, int nnz_s, int nnz_c) {
  return round_up(4ull * (S + 1), 16) + 2 * round_up(4ull * nnz_s, 16) +
         round_up(4ull * (C + 1), 16) + round_up(4ull * nnz_c, 16) + round_up(S, 16);
}

// Shared memory of the cluster instance (bytes). First region: two
// transposed feats chunks and the W ring (D does not enter); once x is made it holds this
// rank's rows of x (per group, [Cx] float4), of the slot log-probs ([S]
// float4) and, where they fit, the tree lists. Then every rank's x for the
// other ranks to pull, grouped by the rank that takes each row:
// [Q, groups, class_slice] float4.
__host__ __device__ inline size_t cluster_smem(int D, int C, int S, int nnz_s, int nnz_c,
                                               int wbytes, int q, int class_slice, int stages,
                                               bool lists) {
  const size_t g = rank_groups(kTileRows, q);
  const size_t ring = 1ull * stages * kChunk * kSlice * wbytes;
  const size_t stage = kFeatBytes + (ring > kRedBytes ? ring : kRedBytes);
  const size_t tree = 16ull * (g * round_up(C, 4) + S) + (lists ? list_bytes(C, S, nnz_s, nnz_c) : 0);
  return round_up(stage > tree ? stage : tree, 16) + 16ull * q * g * class_slice;
}

// Whether the cluster instance stages the tree lists in shared memory: when
// they fit beside everything else with a ring of `stages` W chunks (the
// host takes a four-stage ring, and the lists where they fit).
__host__ __device__ inline bool lists_fit(int D, int C, int S, int nnz_s, int nnz_c, int wbytes,
                                          int q, int class_slice, int stages) {
  return cluster_smem(D, C, S, nnz_s, nnz_c, wbytes, q, class_slice, stages, true) <= kSmemLimit;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// Waits until at most n (0, 1 or 2) groups are pending.
__device__ __forceinline__ void cp_async_wait_upto(int n) {
  if (n >= 2) cp_async_wait<2>();
  else if (n == 1) cp_async_wait<1>();
  else cp_async_wait<0>();
}

// Starts copying `bytes` from global memory (16-byte aligned) to shared
// memory, 16 bytes a cp.async, the tail zero-filled; returns the next
// 16-byte aligned shared address.
__device__ __forceinline__ unsigned char* copy_async(unsigned char* dst, const void* src,
                                                     int bytes) {
  const unsigned char* s = static_cast<const unsigned char*>(src);
  for (int i = threadIdx.x * 16; i < bytes; i += kThreads * 16)
    cp_async16(dst + i, s + i, min(16, bytes - i));
  return dst + round_up(bytes, 16);
}

// Loads W rows [d0, d0 + kChunk) x classes [c0, c0 + kSlice) into `dst`
// ([kChunk, kSlice]), zeros past D and past the rank's last class. 16-byte
// cp.async when the rows are aligned (`vec`), else plain loads.
template <typename T>
__device__ __forceinline__ void load_w_chunk(T* dst, const T* W, int d0, int c0, int D, int C,
                                             int c_end, bool vec) {
  if (vec) {
    constexpr int E = 16 / sizeof(T);
    constexpr int per_row = kSlice / E;
    for (int i = threadIdx.x; i < kChunk * per_row; i += kThreads) {
      const int dd = i / per_row, cc = (i - dd * per_row) * E;
      const int d = d0 + dd, c = c0 + cc;
      const bool full = d < D && c < c_end;  // C % E == 0: a vector is all in or all out
      cp_async16(dst + dd * kSlice + cc, full ? W + static_cast<size_t>(d) * C + c : W,
                 full ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < kChunk * kSlice; i += kThreads) {
      const int dd = i / kSlice, cc = i - dd * kSlice;
      const int d = d0 + dd, c = c0 + cc;
      dst[i] = (d < D && c < c_end) ? W[static_cast<size_t>(d) * C + c] : T(0.f);
    }
  }
}

// The eight classes of lane octet `co` within a 128-class pass, as
// offsets: f32 takes 4co..4co+3 and 64+4co..64+4co+3, so that each of its
// two 16-byte loads of a W row covers 128 contiguous bytes a quarter warp
// (no bank conflict); bf16 takes 8co..8co+7, one 16-byte load.
template <typename T>
__device__ __forceinline__ int octet_class(int co, int j) {
  if constexpr (sizeof(T) == 4) return j < 4 ? 4 * co + j : 60 + 4 * co + j;
  else return 8 * co + j;
}

// The eight W values of octet `co` in one W row, as f32.
__device__ __forceinline__ void load_w8(const float* row, int co, float* w) {
  widen(reinterpret_cast<const float4*>(row)[co], w);
  widen(reinterpret_cast<const float4*>(row)[16 + co], w + 4);
}
__device__ __forceinline__ void load_w8(const __nv_bfloat16* row, int co, float* w) {
  widen(reinterpret_cast<const uint4*>(row)[co], w);
}

__device__ __forceinline__ void add4(float* a, float w, const float4& x) {
  a[0] = fmaf(w, x.x, a[0]);
  a[1] = fmaf(w, x.y, a[1]);
  a[2] = fmaf(w, x.z, a[2]);
  a[3] = fmaf(w, x.w, a[3]);
}

// Tile row r of a feats column: rows 0-9 at 0-9, rows 10-19 at 12-21, so
// each half starts 16-byte aligned.
__host__ __device__ inline int fcol(int r) { return r < 10 ? r : r + 2; }

// One thread's share of a feats chunk (the tile's rows x kChunk columns) as
// 16-byte vectors, held in registers between its load and its store.
template <typename T>
struct FeatChunk {
  static constexpr int E = 16 / sizeof(T);                  // elements of a vector
  static constexpr int kVecs = kTileRows * kChunk / E;      // vectors of a chunk
  static constexpr int kPer = (kVecs + kThreads - 1) / kThreads;  // a thread's vectors
  typename Vec<T>::type v[kPer];
};

// Starts loading columns [d0, d0 + kChunk) of the tile's rows (vector i:
// row i % kTileRows, columns from (i / kTileRows) * E); zeros past `rows`
// and past D. Needs D % E == 0 and 16-byte aligned rows.
template <typename T>
__device__ __forceinline__ void load_feats_chunk(FeatChunk<T>& fc, const T* ftile, int d0,
                                                 int rows, int D) {
  using FC = FeatChunk<T>;
#pragma unroll
  for (int u = 0; u < FC::kPer; ++u) {
    const int i = threadIdx.x + u * kThreads, r = i % kTileRows;
    const int d = d0 + (i / kTileRows) * FC::E;
    if (i < FC::kVecs && r < rows && d < D)
      fc.v[u] = __ldg(reinterpret_cast<const typename Vec<T>::type*>(
          ftile + static_cast<size_t>(r) * D + d));
    else
      fc.v[u] = typename Vec<T>::type{0, 0, 0, 0};
  }
}

// Stores a loaded chunk into `fs` ([kChunk, kFStride] f32), transposed:
// neighbouring threads hold neighbouring rows, so the stores spread over
// the banks.
template <typename T>
__device__ __forceinline__ void store_feats_chunk(float* fs, const FeatChunk<T>& fc) {
  using FC = FeatChunk<T>;
#pragma unroll
  for (int u = 0; u < FC::kPer; ++u) {
    const int i = threadIdx.x + u * kThreads;
    if (i < FC::kVecs) {
      const int r = i % kTileRows, d = (i / kTileRows) * FC::E;
      float f[FC::E];
      widen(fc.v[u], f);
#pragma unroll
      for (int t = 0; t < FC::E; ++t) fs[(d + t) * kFStride + fcol(r)] = f[t];
    }
  }
}

// The same chunk by scalar loads, straight into `fs`: for rows that are not
// whole 16-byte vectors.
template <typename T>
__device__ __forceinline__ void copy_feats_chunk(float* fs, const T* ftile, int d0, int rows,
                                                 int D) {
  for (int i = threadIdx.x; i < kTileRows * kChunk; i += kThreads) {
    const int r = i % kTileRows, dd = i / kTileRows, d = d0 + dd;
    fs[dd * kFStride + fcol(r)] =
        (r < rows && d < D) ? to_f32(ftile[static_cast<size_t>(r) * D + d]) : 0.f;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) soft_head_cluster(
    const T* __restrict__ feats, const T* __restrict__ W, Tree tree, Out out, int B, int D,
    int C, int N, int K, int nnz_s, int nnz_c, int tb, int class_slice, int stages, int vec_f,
    int vec_w) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int Q = static_cast<int>(cluster.num_blocks());
  const int S = N * K;
  const int Cx = static_cast<int>(round_up(C, 4));
  const int G = rank_groups(tb, Q);
  const bool lists = lists_fit(D, C, S, nnz_s, nnz_c, sizeof(T), Q, class_slice, stages);
  const size_t xo_offset =
      cluster_smem(D, C, S, nnz_s, nnz_c, sizeof(T), Q, class_slice, stages, lists) -
                           16ull * Q * rank_groups(kTileRows, Q) * class_slice;
  float* fs_s = reinterpret_cast<float*>(smem);                 // [2, kChunk, kFStride]
  T* ring = reinterpret_cast<T*>(smem + kFeatBytes);            // [stages, kChunk, kSlice]
  float* red_s = reinterpret_cast<float*>(ring);   // [kWarps, kTileRows, kSlice] partial sums
  float4* x_s = reinterpret_cast<float4*>(smem);   // [G, Cx] this rank's rows of x, after barrier 1
  float4* l_s = x_s + static_cast<size_t>(G) * Cx;  // [S] this rank's rows of the slot log-probs
  float4* xo_s = reinterpret_cast<float4*>(smem + xo_offset);  // [Q, G, class_slice]

  const int row0 = (blockIdx.x / Q) * tb;
  const int rows = min(tb, B - row0);
  const T* ftile = feats + static_cast<size_t>(row0) * D;
  const int c_begin = rank * class_slice, c_end = min(C, c_begin + class_slice);
  const int nchunks = (D + kChunk - 1) / kChunk;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  // Where tile row r's x goes in xo_s (in floats, before the class): rank
  // r % Q keeps it as its row r / Q, in group (r / Q) / 4, lane (r / Q) % 4.
  __shared__ int row_off[32];
  if (threadIdx.x < Q * G * 4) {
    const int r = threadIdx.x, jr = r / Q;
    row_off[r] = ((r % Q) * G + jr / 4) * class_slice * 4 + jr % 4;
  }

  // 1. Classifier for this rank's class slice, kSlice classes a pass. Each
  //    pass starts its first W chunks by cp.async, puts feats chunk 0 in
  //    buffer 0 and holds chunk 1 in registers; at chunk k every thread
  //    stores chunk k + 1 into the other buffer and loads chunk k + 2, so
  //    the feats loads ride one chunk ahead. Warp w takes rows [8w, 8w + 8)
  //    of every W chunk; lane -> (row half rh, class octet co, see
  //    octet_class): 10 rows x 8 classes of sums, so the 18 values a
  //    thread loads per step (two float4 and a float2 of feats, eight W)
  //    feed 80 FMA. The warps' sums are then added pairwise in a fixed
  //    order, and x goes to xo_s grouped by the rank that takes each row.
  const int rh = lane / 16, co = lane % 16;
  constexpr int kFeatFloats = kChunk * kFStride;  // one feats chunk buffer
  for (int c0 = c_begin; c0 < c_end; c0 += kSlice) {
    float acc[10][8];
#pragma unroll
    for (int r = 0; r < 10; ++r)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[r][j] = 0.f;
    for (int k = 0; k < stages - 1; ++k) {
      if (k < nchunks)
        load_w_chunk(ring + k * kChunk * kSlice, W, k * kChunk, c0, D, C, c_end, vec_w);
      cp_async_commit();
    }
    FeatChunk<T> fnext;
    if (vec_f) {
      load_feats_chunk(fnext, ftile, 0, rows, D);
      store_feats_chunk(fs_s, fnext);
      if (nchunks > 1) load_feats_chunk(fnext, ftile, kChunk, rows, D);
    } else {
      copy_feats_chunk(fs_s, ftile, 0, rows, D);
    }
    for (int k = 0; k < nchunks; ++k) {
      cp_async_wait_upto(stages - 2);
      __syncthreads();  // W chunk k and feats chunk k are in place for all
      const int next = k + stages - 1;  // into the stage every thread finished with
      if (next < nchunks)
        load_w_chunk(ring + (next % stages) * kChunk * kSlice, W, next * kChunk, c0, D, C,
                     c_end, vec_w);
      cp_async_commit();
      if (k + 1 < nchunks) {  // into the buffer every thread finished with at k - 1
        float* fs_next = fs_s + ((k + 1) & 1) * kFeatFloats;
        if (vec_f) {
          store_feats_chunk(fs_next, fnext);
          if (k + 2 < nchunks) load_feats_chunk(fnext, ftile, (k + 2) * kChunk, rows, D);
        } else {
          copy_feats_chunk(fs_next, ftile, (k + 1) * kChunk, rows, D);
        }
      }
      const int d_lo = warp * (kChunk / kWarps);
      const int d_hi = min(d_lo + kChunk / kWarps, D - k * kChunk);
      const T* wk = ring + (k % stages) * kChunk * kSlice;
      const float* fk = fs_s + (k & 1) * kFeatFloats + 12 * rh;
#pragma unroll 4
      for (int dd = d_lo; dd < d_hi; ++dd) {
        float w[8], f[10];
        load_w8(wk + dd * kSlice, co, w);
        const float* fp = fk + dd * kFStride;
        widen(reinterpret_cast<const float4*>(fp)[0], f);
        widen(reinterpret_cast<const float4*>(fp)[1], f + 4);
        const float2 f2 = reinterpret_cast<const float2*>(fp)[4];
        f[8] = f2.x;
        f[9] = f2.y;
#pragma unroll
        for (int r = 0; r < 10; ++r)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[r][j] = fmaf(f[r], w[j], acc[r][j]);
      }
    }
    // Every warp leaves its partial sums in the (now idle) ring; then each
    // thread adds the eight warps' sums of ten outputs in a fixed order,
    // adds the bias and puts x in xo_s for the rank that takes its row.
    __syncthreads();
#pragma unroll
    for (int r = 0; r < 10; ++r) {
      float* p = red_s + (warp * kTileRows + 10 * rh + r) * kSlice;
      *reinterpret_cast<float4*>(p + octet_class<T>(co, 0)) =
          make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
      *reinterpret_cast<float4*>(p + octet_class<T>(co, 4)) =
          make_float4(acc[r][4], acc[r][5], acc[r][6], acc[r][7]);
    }
    __syncthreads();
    {
      const int cl = threadIdx.x % kSlice, c = c0 + cl;
      if (c < c_end) {
        const float bc = tree.bias[c];
        float* xc = reinterpret_cast<float*>(xo_s + (c - c_begin));
        for (int r = threadIdx.x / kSlice; r < Q * G * 4; r += kThreads / kSlice) {
          float v = 0.f;  // rows past the tile stay zero for their rank
          if (r < rows) {
            v = bc;
#pragma unroll
            for (int w = 0; w < kWarps; ++w) v += red_s[(w * kTileRows + r) * kSlice + cl];
            if (out.logits) out.logits[static_cast<size_t>(row0 + r) * C + c] = v;
          }
          xc[row_off[r]] = v;
        }
      }
    }
    __syncthreads();  // the ring is free for the next pass
  }
  cluster.sync();  // barrier 1: every rank's x is made; every feats tile is dead

  // 2. Start staging the tree lists (where they fit), pull this rank's rows
  //    of x from every rank (distributed shared memory: 16 bytes a class,
  //    eight loads a thread in flight), then no block touches another's
  //    memory.
  const int* sptr = tree.slot_ptr;
  const int* scls = tree.slot_cls;
  const float* sw = tree.slot_w;
  const int* cptr = tree.class_ptr;
  const int* cslot = tree.class_slot;
  const unsigned char* valid = tree.slot_valid;
  if (lists) {
    unsigned char* p = reinterpret_cast<unsigned char*>(l_s + S);
    sptr = reinterpret_cast<const int*>(p);
    p = copy_async(p, tree.slot_ptr, 4 * (S + 1));
    scls = reinterpret_cast<const int*>(p);
    p = copy_async(p, tree.slot_cls, 4 * nnz_s);
    sw = reinterpret_cast<const float*>(p);
    p = copy_async(p, tree.slot_w, 4 * nnz_s);
    cptr = reinterpret_cast<const int*>(p);
    p = copy_async(p, tree.class_ptr, 4 * (C + 1));
    cslot = reinterpret_cast<const int*>(p);
    p = copy_async(p, tree.class_slot, 4 * nnz_c);
    valid = p;
    copy_async(p, tree.slot_valid, S);
    cp_async_commit();
  }
  for (int grp = 0; grp < G; ++grp) {
    constexpr int kBatch = 8;
    const int total = Q * class_slice;
    for (int i0 = threadIdx.x; i0 < total; i0 += kThreads * kBatch) {
      float4 v[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int i = i0 + u * kThreads, q = i / class_slice, cl = i - q * class_slice;
        if (i < total && q * class_slice + cl < C)
          v[u] = cluster.map_shared_rank(xo_s, q)[(rank * G + grp) * class_slice + cl];
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int i = i0 + u * kThreads;
        if (i < total && i < C) x_s[grp * Cx + i] = v[u];
      }
    }
  }
  cp_async_wait<0>();
  cluster.sync();  // barrier 2: every pull is done, so any block may leave after this

  // 3. The tree for this rank's rows, four at a time, in local shared
  //    memory: slot logits (a thread per short list, a warp per long one,
  //    as at the root of a 1000-class tree), each node's log-softmax, then
  //    the leaf path sums.
  const int my_rows = rank < rows ? (rows - 1 - rank) / Q + 1 : 0;
  // Queue the long slot lists, so that the warps share them round robin
  // (a 1000-class tree's longest lists sit side by side at its root).
  __shared__ int long_ids[kMaxLong];
  __shared__ int long_n;
  if (threadIdx.x == 0) long_n = 0;
  __syncthreads();
  for (int s = threadIdx.x; s < S; s += kThreads)
    if (sptr[s + 1] - sptr[s] > kLongList) {
      const int i = atomicAdd(&long_n, 1);
      if (i < kMaxLong) long_ids[i] = s;
    }
  __syncthreads();
  const bool queued = long_n <= kMaxLong;  // else every list takes the thread path
  for (int grp = 0; grp * 4 < my_rows; ++grp) {
    const float4* x = x_s + static_cast<size_t>(grp) * Cx;
    for (int s = threadIdx.x; s < S; s += kThreads) {
      const int lo = sptr[s], hi = sptr[s + 1];
      if (queued && hi - lo > kLongList) continue;
      float a[4] = {0.f, 0.f, 0.f, 0.f};
      for (int j = lo; j < hi; ++j) add4(a, sw[j], x[scls[j]]);
      l_s[s] = make_float4(a[0], a[1], a[2], a[3]);
    }
    for (int i = warp; queued && i < long_n; i += kWarps) {
      const int sl = long_ids[i];
      float a[4] = {0.f, 0.f, 0.f, 0.f};
      for (int j = sptr[sl] + lane; j < sptr[sl + 1]; j += 32) add4(a, sw[j], x[scls[j]]);
      const float v = warp_reduce_scatter<4>(a, lane);  // lane k: row k of the group
      if (lane < 4) reinterpret_cast<float*>(l_s + sl)[lane] = v;
    }
    __syncthreads();
    for (int n = threadIdx.x; n < N; n += kThreads) {
      float m[4] = {kNeg, kNeg, kNeg, kNeg}, e[4] = {0.f, 0.f, 0.f, 0.f};
      for (int k = 0; k < K; ++k) {
        if (!valid[n * K + k]) continue;
        const float4 l = l_s[n * K + k];
        m[0] = fmaxf(m[0], l.x); m[1] = fmaxf(m[1], l.y);
        m[2] = fmaxf(m[2], l.z); m[3] = fmaxf(m[3], l.w);
      }
#pragma unroll
      for (int t = 0; t < 4; ++t)
        if (!(m[t] > 0.5f * kNeg)) m[t] = 0.f;  // a node whose slots are all padding
      for (int k = 0; k < K; ++k) {
        if (!valid[n * K + k]) continue;
        const float4 l = l_s[n * K + k];
        e[0] += expf(l.x - m[0]); e[1] += expf(l.y - m[1]);
        e[2] += expf(l.z - m[2]); e[3] += expf(l.w - m[3]);
      }
#pragma unroll
      for (int t = 0; t < 4; ++t) m[t] += logf(fmaxf(e[t], 1e-30f));  // m is now the lse
      for (int k = 0; k < K; ++k) {
        const int s = n * K + k;
        const bool ok = valid[s] != 0;
        float* l = reinterpret_cast<float*>(l_s + s);
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          const float lp = l[t] - m[t];
          l[t] = ok ? lp : 0.f;  // padding is inert in the path sum
          const int jr = grp * 4 + t;
          if (out.logp && jr < my_rows)
            out.logp[static_cast<size_t>(row0 + rank + Q * jr) * S + s] = ok ? lp : kNeg;
        }
      }
    }
    __syncthreads();
    for (int c = threadIdx.x; c < C; c += kThreads) {
      float a[4] = {0.f, 0.f, 0.f, 0.f};
      for (int j = cptr[c]; j < cptr[c + 1]; ++j) add4(a, 1.f, l_s[cslot[j]]);
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const int jr = grp * 4 + t;
        if (jr < my_rows) out.leaf[static_cast<size_t>(row0 + rank + Q * jr) * C + c] = a[t];
      }
    }
    __syncthreads();  // the slot rows are free for the next group
  }
}

// Per kernel instance: the dynamic shared memory it was last allowed and
// what the occupancy calculator said for that shape, so a steady caller pays
// for neither query on every launch.
struct LaunchCache {
  int device = -1, q = 0, value = 0;
  size_t smem = 0;
};

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, LaunchCache& cache, int device, size_t smem) {
  if (cache.device == device && cache.smem == smem) return cudaSuccess;
  cache.device = -1;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

// Two blocks an SM at most: each block then walks several row groups, so
// its W and list staging is paid once for many rows.
constexpr int kStreamBlocksPerSM = 2;

template <typename T, int R, int CM>
cudaError_t launch_stream(const T* feats, const T* W, const Tree& tree, const Out& out, int B,
                          int D, int C, int N, int K, int nnz_s, int nnz_c, size_t smem,
                          cudaStream_t stream, int device, int* info) {
  static LaunchCache cache;  // value: blocks of the persistent grid
  auto kernel = soft_head_stream<T, R, CM>;
  cudaError_t err = allow_smem(kernel, cache, device, smem);
  if (err != cudaSuccess) return err;
  if (cache.device != device) {
    int per_sm = 0, sms = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
    if (err != cudaSuccess) return err;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    cache = {device, 1, sms * (per_sm < kStreamBlocksPerSM ? per_sm : kStreamBlocksPerSM), smem};
  }
  const int needed = (B + kWarps * R - 1) / (kWarps * R);
  const int grid = needed < cache.value ? needed : cache.value;
  info[0] = grid;
  info[1] = cache.value;
  kernel<<<grid, kThreads, smem, stream>>>(feats, W, tree, out, B, D, C, N, K, nnz_s, nnz_c);
  return cudaGetLastError();
}

inline cudaLaunchConfig_t cluster_config(cudaLaunchAttribute* attr, int blocks, int q,
                                         size_t smem, cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = q;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <typename T>
LaunchCache& cluster_cache() {
  static LaunchCache cache;  // value: clusters of q blocks that can be active at once
  return cache;
}

// Clusters of q blocks that can be active at once (the card's GPCs hold
// different numbers of SMs, so this can be less than SMs / q).
template <typename T>
cudaError_t max_clusters(int q, size_t smem, int device) {
  LaunchCache& cache = cluster_cache<T>();
  cudaError_t err = allow_smem(soft_head_cluster<T>, cache, device, smem);
  if (err != cudaSuccess) return err;
  if (cache.device == device && cache.q == q) return cudaSuccess;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = cluster_config(attr, q, q, smem, nullptr);
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, soft_head_cluster<T>, &cfg);
  if (err != cudaSuccess) return err;
  cache = {device, q, clusters, smem};
  return cudaSuccess;
}

template <typename T>
cudaError_t launch_cluster(const T* feats, const T* W, const Tree& tree, const Out& out, int B,
                           int D, int C, int N, int K, int nnz_s, int nnz_c, int tb, int q,
                           int class_slice, int stages, size_t smem, cudaStream_t stream,
                           int device, int* info) {
  cudaError_t err = max_clusters<T>(q, smem, device);
  if (err != cudaSuccess) return err;
  const int clusters = cluster_cache<T>().value;
  if (clusters < 1) return cudaErrorInvalidConfiguration;  // the shape cannot be placed
  constexpr int E = 16 / sizeof(T);
  const int vec_f = (D % E == 0) && (reinterpret_cast<uintptr_t>(feats) % 16 == 0);
  const int vec_w = (C % E == 0) && (reinterpret_cast<uintptr_t>(W) % 16 == 0);
  const int tiles = (B + tb - 1) / tb;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = cluster_config(attr, tiles * q, q, smem, stream);
  info[0] = tiles * q;
  info[1] = clusters;
  err = cudaLaunchKernelEx(&cfg, soft_head_cluster<T>, feats, W, tree, out, B, D, C, N, K, nnz_s,
                           nnz_c, tb, class_slice, stages, vec_f, vec_w);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* feats, const void* W, const Tree& tree, const Out& out, int B,
                     int D, int C, int N, int K, int nnz_s, int nnz_c, int instance, int rows,
                     int q, int class_slice, int stages, size_t smem, cudaStream_t stream,
                     int device, int* info) {
  const T* f = static_cast<const T*>(feats);
  const T* w = static_cast<const T*>(W);
  if (instance == 1)
    return launch_cluster<T>(f, w, tree, out, B, D, C, N, K, nnz_s, nnz_c, rows, q,
                             class_slice, stages, smem, stream, device, info);
  if (rows == 4 && C <= 8)
    return launch_stream<T, 4, 8>(f, w, tree, out, B, D, C, N, K, nnz_s, nnz_c, smem, stream,
                                  device, info);
  if (rows == 2 && C <= 16)
    return launch_stream<T, 2, 16>(f, w, tree, out, B, D, C, N, K, nnz_s, nnz_c, smem, stream,
                                   device, info);
  if (rows == 1 && C <= 32)
    return launch_stream<T, 1, 32>(f, w, tree, out, B, D, C, N, K, nnz_s, nnz_c, smem, stream,
                                   device, info);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Dynamic shared memory of one block: instance 0 is the streaming instance
// (`rows` rows a warp step), 1 the cluster instance (q ranks of
// `class_slice` classes, a W ring of `stages` chunks; any tile of up to 20
// rows).
size_t nbdt_soft_head_smem_bytes(int instance, int D, int C, int S, int nnz_s, int nnz_c,
                                 int bf16, int rows, int q, int class_slice, int stages) {
  const int wbytes = bf16 ? 2 : 4;
  if (instance == 1)
    return cluster_smem(D, C, S, nnz_s, nnz_c, wbytes, q, class_slice, stages,
                        lists_fit(D, C, S, nnz_s, nnz_c, wbytes, q, class_slice, stages));
  return stream_smem(D, C, S, nnz_s, nnz_c, wbytes, rows);
}

// Clusters of q blocks of the cluster instance, with `smem` bytes each, that
// the card can hold at once; a negative CUDA error code on failure.
int nbdt_soft_head_max_clusters(int q, size_t smem, int bf16, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err == cudaSuccess)
    err = bf16 ? max_clusters<__nv_bfloat16>(q, smem, device) : max_clusters<float>(q, smem, device);
  if (err != cudaSuccess) return -static_cast<int>(err);
  return bf16 ? cluster_cache<__nv_bfloat16>().value : cluster_cache<float>().value;
}

// Launches on `stream`; returns the CUDA error (0 on success). `logits` and
// `logp` are null when the caller wants no aux outputs. `info` (host, 2
// ints) receives the grid size and, for the cluster instance, the most
// clusters that can be active at once (for the streaming instance, the
// blocks of its persistent grid).
int nbdt_soft_head(const void* feats, const void* W, const void* bias, const void* slot_ptr,
                   const void* slot_cls, const void* slot_w, const void* slot_valid,
                   const void* class_ptr, const void* class_slot, void* leaf, void* logits,
                   void* logp, int B, int D, int C, int N, int K, int nnz_s, int nnz_c, int bf16,
                   int instance, int rows, int q, int class_slice, int stages, int device,
                   void* stream, int* info) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (instance == 1 && (q < 1 || q > kMaxRanks || rows < 1 || rows > kTileRows ||
                        class_slice % kSlice != 0 || (q - 1) * class_slice >= C ||
                        stages < 2 || stages > kMaxStages))
    return cudaErrorInvalidValue;
  const Tree tree{static_cast<const float*>(bias), static_cast<const int*>(slot_ptr),
                  static_cast<const int*>(slot_cls), static_cast<const float*>(slot_w),
                  static_cast<const unsigned char*>(slot_valid),
                  static_cast<const int*>(class_ptr), static_cast<const int*>(class_slot)};
  const Out out{static_cast<float*>(leaf), static_cast<float*>(logits),
                static_cast<float*>(logp)};
  const size_t smem =
      nbdt_soft_head_smem_bytes(instance, D, C, N * K, nnz_s, nnz_c, bf16, rows, q, class_slice,
                                stages);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return dispatch<__nv_bfloat16>(feats, W, tree, out, B, D, C, N, K, nnz_s, nnz_c, instance,
                                   rows, q, class_slice, stages, smem, s, device, info);
  return dispatch<float>(feats, W, tree, out, B, D, C, N, K, nnz_s, nnz_c, instance, rows, q,
                         class_slice, stages, smem, s, device, info);
}

const char* nbdt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

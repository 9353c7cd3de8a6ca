// 3x3 stride-1 SAME convolution, 64 -> 64 channels, + bias + ReLU, for
// Hopper (sm_90a), forward only.
//
// Replaces the three TPU kernels of tools/probe_pallas_conv.py, which are
// three Mosaic layouts of one function: make_kernel_a's body (:146, the
// dy-packed [rows,192]x[192,192] form), make_kernel_b's (:201, the row-pair
// [rows,768]x[768,128] form) and make_kernel_c's (:270, the full 9-tap
// im2col [rows,576]x[576,64] form). Their weight packings, the W padding to
// 40 columns and the f32 rolls answer Mosaic's layout rules, not the
// function, and are not carried over. Per image n, output pixel (h, w) and
// output channel co:
//
//   y[n,h,w,co] = bf16_rne(max(0, b[co] + sum_{dy,dx,ci}
//                     x[n,h+dy-1,w+dx-1,ci] * w[dy,dx,ci,co]))
//
// with zero padding at the edges, bf16 products accumulated in f32; x and y
// NHWC bf16, w HWIO [3,3,64,64] bf16, b [64] f32. Any N, H, W >= 1.
//
// Bound on an H100 SXM (700 W) at the probe's shape (N=8192, 32x32): the
// work is 2*8192*32*32*9*64*64 = 618.5 GFLOP, 0.6254 ms at the 989 TFLOP/s
// bf16 tensor-core peak; the bytes are x and y once each, 2 x 1.0737 GB,
// plus 74 KB of w and b, 0.6411 ms at 3.35 TB/s. So the bound is 0.641 ms,
// set by the bytes, and at 288 operations per byte the shape sits at the
// card's ridge (about 295): a kernel that reaches the bound must stream HBM
// at the full rate and keep the tensor cores fed at the same time.
//
// Design (first version, simple and right before fast; an implicit GEMM on
// warp-level bf16 tensor-core products, mma.sync m16n8k16 with f32
// accumulators; on an H100 SXM at the probe's shape it takes about 2.9x
// its bound, half the time of cuDNN's conv + bias + ReLU, see PERF.md):
//  * A block stages the whole weight once, transposed to [co][tap*64+ci]
//    (73.7 KB of bf16, with a 16-byte row pad so ldmatrix reads no bank
//    twice), then loops over output tiles of kTileH rows x kTileW columns
//    of one image, so the weight is read from L2 once per block and not once
//    per tile. Two blocks fit an SM (102 KB of dynamic shared memory each,
//    set with cudaFuncSetAttribute), so one block's loads overlap the
//    other's products; there is no finer pipeline.
//  * Per tile the block copies the (kTileH+2) x (kTileW+2) x 64 input
//    window, halo included, into shared memory with cp.async 16-byte copies
//    that zero-fill pixels outside the image (the SAME padding, and the
//    ragged edge of a tile that runs past the map). Pixel rows are padded to
//    72 channels so ldmatrix reads conflict-free.
//  * Warp r computes output row r of the tile, 32 pixels x 64 channels, as
//    the [32 x 576] x [576 x 64] product whose A rows are read straight out
//    of the shifted window (tap (dy, dx) of pixel p is window pixel
//    (r+dy, p+dx)): 9 taps x 4 k-steps of 16, each 2 A and 4 B ldmatrix.x4
//    and 16 mma.
//  * Epilogue: bias added to the f32 sum, ReLU, one round to nearest even,
//    staged through shared memory so that each thread writes whole 16-byte
//    vectors of 8 channels, masked at the image's edge.
// What it does not do yet, and the bound asks for: wgmma, TMA, overlap of a
// tile's loads with the previous tile's products, and a halo shared between
// neighbouring tiles (each tile reads 1.5x its rows of x, mostly from L2).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kC = 64;                       // input and output channels
constexpr int kTaps = 9;
constexpr int kK = kTaps * kC;               // 576, the GEMM depth
constexpr int kTileH = 4;                    // output rows per tile = warps per block
constexpr int kTileW = 32;                   // output columns per tile (2 m16 tiles)
constexpr int kThreads = 32 * kTileH;
constexpr int kWinH = kTileH + 2, kWinW = kTileW + 2;
constexpr int kWStride = kK + 8;             // bf16 per staged weight row (1168 B)
constexpr int kXStride = kC + 8;             // bf16 per staged window pixel (144 B)
constexpr int kWBytes = kC * kWStride * 2;                 // 74,752
constexpr int kXBytes = kWinH * kWinW * kXStride * 2;      // 29,376
constexpr int kSmemBytes = kWBytes + kXBytes;              // 104,128
static_assert(kTileH * kTileW * kXStride * 2 <= kXBytes, "output stage fits the window");

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; src_bytes == 0 writes zeros and reads nothing.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

// d += a (16x16, row-major) * b (16x8, column-major); bf16 in, f32 sum.
// Registers only, so not volatile: the compiler may interleave it with the
// shared-memory loads.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__global__ void __launch_bounds__(kThreads, 2) conv3x3_kernel(
    const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
    const float* __restrict__ bias, __nv_bfloat16* __restrict__ y, int N, int H, int W) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* ws = reinterpret_cast<__nv_bfloat16*>(smem);            // [co][kWStride]
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem + kWBytes);  // [kWinH*kWinW][kXStride]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  // Weight, once per block: w[tap][ci][co] -> ws[co][tap*64 + ci].
  for (int i = tid; i < kK * kC; i += kThreads) {
    const int k = i / kC, co = i % kC;
    ws[co * kWStride + k] = w[i];
  }

  const int tiles_h = (H + kTileH - 1) / kTileH, tiles_w = (W + kTileW - 1) / kTileW;
  const long long tiles = static_cast<long long>(N) * tiles_h * tiles_w;
  const uint32_t ws_base = smem_addr(ws), xs_base = smem_addr(xs);
  // Per-lane ldmatrix offsets: A rows are pixels (lane % 16), k halves
  // (lane / 16); B rows are output channels, k halves ((lane / 8) % 2).
  const int a_pix = lane & 15, a_k = (lane >> 4) * 8;
  const int b_row = (lane >> 4) * 8 + (lane & 7), b_k = ((lane >> 3) & 1) * 8;
  const int g = lane >> 2, t = lane & 3;  // mma fragment row group, column pair

  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int n = static_cast<int>(tile / (tiles_h * tiles_w));
    const int rem = static_cast<int>(tile % (tiles_h * tiles_w));
    const int h0 = (rem / tiles_w) * kTileH, w0 = (rem % tiles_w) * kTileW;

    __syncthreads();  // the previous tile's output stage has been written out
    // Input window with halo, 8 channels (16 bytes) per copy, zero outside.
    for (int i = tid; i < kWinH * kWinW * (kC / 8); i += kThreads) {
      const int v = i % (kC / 8), pix = i / (kC / 8);
      const int hh = h0 - 1 + pix / kWinW, ww = w0 - 1 + pix % kWinW;
      const bool in = hh >= 0 && hh < H && ww >= 0 && ww < W;
      const __nv_bfloat16* src =
          in ? x + ((static_cast<long long>(n) * H + hh) * W + ww) * kC + v * 8 : x;
      cp_async16(xs_base + (pix * kXStride + v * 8) * 2, src, in ? 16 : 0);
    }
    cp_async_wait_all();
    __syncthreads();

    float acc[2][8][4];
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[m][j][e] = 0.f;

#pragma unroll 1
    for (int tap = 0; tap < kTaps; ++tap) {
      const int dy = tap / 3, dx = tap % 3;
#pragma unroll
      for (int kc = 0; kc < kC; kc += 16) {
        uint32_t a[2][4];
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          const int pix = (warp + dy) * kWinW + m * 16 + a_pix + dx;
          ldmatrix_x4(xs_base + (pix * kXStride + kc + a_k) * 2, a[m]);
        }
#pragma unroll
        for (int jp = 0; jp < 4; ++jp) {  // output channels jp*16 .. jp*16+15
          uint32_t b[4];
          ldmatrix_x4(ws_base + ((jp * 16 + b_row) * kWStride + tap * kC + kc + b_k) * 2, b);
#pragma unroll
          for (int m = 0; m < 2; ++m) {
            mma_bf16(acc[m][2 * jp], a[m], b[0], b[1]);
            mma_bf16(acc[m][2 * jp + 1], a[m], b[2], b[3]);
          }
        }
      }
    }

    __syncthreads();  // every warp is done reading the window
    // Bias, ReLU, one rounding; stage [pixel][co] in the window's space.
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int co = j * 8 + 2 * t;
      const float b0 = __ldg(bias + co), b1 = __ldg(bias + co + 1);
#pragma unroll
      for (int m = 0; m < 2; ++m) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int p = warp * kTileW + m * 16 + g + 8 * half;
          const __nv_bfloat162 v = __floats2bfloat162_rn(
              fmaxf(acc[m][j][2 * half] + b0, 0.f), fmaxf(acc[m][j][2 * half + 1] + b1, 0.f));
          *reinterpret_cast<__nv_bfloat162*>(xs + p * kXStride + co) = v;
        }
      }
    }
    __syncthreads();
    for (int i = tid; i < kTileH * kTileW * (kC / 8); i += kThreads) {
      const int v = i % (kC / 8), p = i / (kC / 8);
      const int hh = h0 + p / kTileW, ww = w0 + p % kTileW;
      if (hh < H && ww < W) {
        *reinterpret_cast<uint4*>(y + ((static_cast<long long>(n) * H + hh) * W + ww) * kC +
                                  v * 8) =
            *reinterpret_cast<const uint4*>(xs + p * kXStride + v * 8);
      }
    }
  }
}

}  // namespace

extern "C" {

// y = relu(conv3x3(x, w) + b) for x, y [N,H,W,64] bf16 (NHWC), w [3,3,64,64]
// bf16 (HWIO), b [64] f32. The caller guarantees contiguous tensors, x and y
// 16-byte aligned, N, H, W >= 1. Launches on `stream`; returns
// cudaGetLastError() after the launch (0 on success).
int nbdt_conv3x3(const void* x, const void* w, const void* b, void* y, int N, int H, int W,
                 int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(conv3x3_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmemBytes);
  if (err != cudaSuccess) return err;
  int sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, conv3x3_kernel, kThreads,
                                                      kSmemBytes);
  if (err != cudaSuccess) return err;
  // Enough blocks to fill the card once; each loops over tiles.
  const long long tiles = static_cast<long long>(N) * ((H + kTileH - 1) / kTileH) *
                          ((W + kTileW - 1) / kTileW);
  const long long resident = static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
  const unsigned blocks = static_cast<unsigned>(tiles < resident ? tiles : resident);
  conv3x3_kernel<<<blocks, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w),
      static_cast<const float*>(b), static_cast<__nv_bfloat16*>(y), N, H, W);
  return cudaGetLastError();
}

const char* nbdt_conv3x3_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

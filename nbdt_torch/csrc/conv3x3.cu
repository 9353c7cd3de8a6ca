// 3x3 stride-1 SAME convolution, 64 -> 64 channels, + bias + ReLU, for
// Hopper (sm_90a), forward only.
//
// Replaces the three TPU kernels of tools/probe_pallas_conv.py, which are
// three Mosaic layouts of one function: make_kernel_a's body (:146, the
// dy-packed [rows,192]x[192,192] form), make_kernel_b's (:201, the row-pair
// [rows,768]x[768,128] form) and make_kernel_c's (:270, the full 9-tap
// im2col [rows,576]x[576,64] form). Their weight packings and f32 rolls
// answer Mosaic's layout rules, not the function, and are not carried over.
// Per image n, output pixel (h, w) and output channel co:
//
//   y[n,h,w,co] = bf16_rne(max(0, b[co] + sum_{dy,dx,ci}
//                     x[n,h+dy-1,w+dx-1,ci] * w[dy,dx,ci,co]))
//
// with zero padding at the edges, bf16 products accumulated in f32; x and y
// NHWC bf16, b [64] f32, and the weight packed by the wrapper from HWIO
// [3,3,64,64] to wpk [co][tap*64 + ci] ([64, 576] bf16, tap = dy*3 + dx).
// Any N, H, W >= 1.
//
// Bound on an H100 SXM (700 W) at the probe's shape (N=8192, 32x32): the
// work is 2*8192*32*32*9*64*64 = 618.5 GFLOP, 0.6254 ms at the 989 TFLOP/s
// bf16 tensor-core peak; the bytes are x and y once each, 2 x 1.0737 GB,
// plus 74 KB of w and b, 0.6411 ms at 3.35 TB/s. So the bound is 0.641 ms,
// set by the bytes, and at 288 operations per byte the shape sits at the
// card's ridge (about 295): the kernel has to stream HBM near the full rate
// and keep the tensor cores fed at the same time.
//
// Design: a persistent, warp-specialised implicit GEMM on wgmma, fed by TMA.
// Its choices were measured on an H100 (PERF.md; python -m
// nbdt_torch.tools.conv3x3_ablation times the alternatives).
//  * One block per SM (the host plan, ops/conv3x3.py's plan_conv3x3, sizes
//    the grid and the ring); each block walks output tiles t = blockIdx.x,
//    + gridDim.x, ... A tile is one image, 4 output rows and 32 columns.
//  * Warpgroup 0 is the producer: one thread issues TMA. It loads the packed
//    weight once (9 boxes of 64 co x 64 ci, 72 KB, resident for the whole
//    run), then for each tile the input window into a ring of stages with
//    full and empty mbarriers. The window is one box of a 4-D tensor map over
//    x [N,H,W,64]: 64 channels (128 B, the 128-byte swizzle span) by 34
//    pixels (the pitch: 32 columns and the halo) by 6 rows, at the signed
//    start (0, w0-1, h0-1, n). TMA zero-fills what lies outside x, which is
//    the SAME padding and the ragged edges. x comes from HBM about once; the
//    halo rows that neighbouring tiles share come mostly from L2.
//  * Warpgroups 1 and 2 are consumers and take alternate tiles. A tile is
//    D[co, pixel] = Wpk[co, k] . X[k, pixel]: A is the resident weight, B
//    the window, M = 64 output channels, N = 4 rows x 34 pitch = 136
//    pixels, so 9 taps x 4 k-steps =
//    36 wgmma.m64n136k16 into 68 f32 registers a thread. Tap (dy, dx) starts
//    B (dy*34 + dx) * 128 bytes into the window and a k-step adds 32 bytes
//    inside the 128-byte row. The hardware swizzles by the absolute address,
//    so B may start on any 128-byte row; the 2 of every 34 product columns
//    that straddle two rows are pad (1.0625x the MACs).
//  * The warpgroups issue their products in turn (two named barriers), so
//    the tensor cores work on one warpgroup's tile while the other runs its
//    epilogue: bias, ReLU and one round to bf16 in registers, transposed to
//    [pixel][co] by stmatrix.trans into a 128-byte-swizzled 16 KB stage,
//    then a TMA store of a 32-column box that the hardware clips at ragged
//    edges. The store runs while the warpgroup's next products do.
// Against its bound: on an H100 SXM at the probe's shape the tensor pipe
// issues at about 79% of its peak and HBM runs at about 76% of its rate
// (PERF.md). ptxas allocates the consumers within the launch bound's 168
// registers whatever setmaxnreg grants them at run time, so the weight stays
// in shared memory rather than in wgmma's A registers.

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kC = 64;                                // input and output channels
constexpr int kTaps = 9;
constexpr int kK = kTaps * kC;                        // 576, the GEMM depth
constexpr int kTileW = 32;                            // output columns of a tile
constexpr int kPitch = 34;                            // window pixels a row: kTileW + 2
constexpr int kBand = 4;                              // output rows of a tile
constexpr int kN = kBand * kPitch;                    // 136: wgmma N, the pixels of 4 window rows
constexpr int kAcc = kN / 2;                          // 68 f32 accumulators a thread
constexpr int kBlocks = kN / 8;                       // 17 column blocks of 8 pixels
constexpr int kPixBytes = kC * 2;                     // 128: one pixel, one swizzle row
constexpr int kLoadBytes = (kBand + 2) * kPitch * kPixBytes;  // 26,112: one window box
constexpr int kWTapBytes = kC * kC * 2;               // 8,192: one tap of the weight
constexpr int kWBytes = kTaps * kWTapBytes;           // 73,728
constexpr int kOutRows = kBand * kTileW;              // 128 pixels of a tile's output
constexpr int kOutBytes = kOutRows * kPixBytes;       // 16,384: what the TMA store reads
constexpr int kOutStage = kOutBytes + 8 * kPixBytes;  // + 8 rows that take the pad pixels
constexpr int kConsumers = 2;
constexpr int kThreads = 128 * (1 + kConsumers);
constexpr int kAlign = 1024;                          // the 128-byte swizzle repeats every 1 KB
constexpr int kMaxStages = 8;
constexpr long long kHangCycles = 1LL << 33;          // a barrier wait this long is a fault

// A window stage, rounded up to whole swizzle repeats so that every stage
// starts 1 KB aligned.
constexpr int kWinBytes = (kLoadBytes + kAlign - 1) / kAlign * kAlign;  // 26,624

int smem_bytes(int stages) {
  return kAlign + kWBytes + stages * kWinBytes + kConsumers * kOutStage + 8 * (1 + 2 * stages);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" :: "r"(bar) : "memory");
}

__device__ __forceinline__ bool mbar_try(uint32_t bar, uint32_t parity) {
  uint32_t ok;
  asm volatile(
      "{\n .reg .pred p;\n"
      " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      " selp.u32 %0, 1, 0, p;\n}"
      : "=r"(ok) : "r"(bar), "r"(parity) : "memory");
  return ok != 0;
}

// Waits for the phase of `bar` with this parity to complete. A wait of
// seconds means a fault in the pipeline: trap, so that the launch fails
// instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try(bar, parity)) {
    if (clock64() - t0 > kHangCycles) __trap();
  }
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2),
         "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map, uint32_t src, int c0, int c1,
                                             int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5}], [%1];"
      :: "l"(reinterpret_cast<uint64_t>(map)), "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

// The warpgroup's earlier TMA stores have finished reading shared memory.
__device__ __forceinline__ void store_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
}

__device__ __forceinline__ void store_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;" :: "r"(id), "r"(threads) : "memory");
}

// wgmma operand descriptor of a K-major, 128-byte-swizzled tile whose rows
// are 128 bytes and whose 8-row groups are 1 KB apart.
// The hardware applies the swizzle to the absolute shared-memory address, as
// TMA does when it writes, so a start on any 128-byte row of a 1 KB aligned
// stage reads the right bytes with the base-offset field left at 0.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
  uint64_t d = static_cast<uint64_t>((addr & 0x3FFFF) >> 4);
  d |= static_cast<uint64_t>(1) << 16;                  // leading offset (unused by this layout)
  d |= static_cast<uint64_t>(1024 >> 4) << 32;          // stride offset: 8 rows x 128 B
  d |= static_cast<uint64_t>(1) << 62;                  // 128-byte swizzle
  return d;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// d[64 x 136] (+)= A[64 x 16] * B[16 x 136], both K-major in shared memory;
// scale_d == 0 overwrites d.
__device__ __forceinline__ void wgmma_m64n136k16(float (&d)[68], uint64_t a, uint64_t b,
                                                 int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %70, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n136k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "
      "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67}, "
      "%68, %69, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]),
        "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67])
      : "l"(a), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void stmatrix_x2_trans(uint32_t addr, uint32_t r0, uint32_t r1) {
  asm volatile("stmatrix.sync.aligned.m8n8.x2.trans.shared.b16 [%0], {%1, %2};"
               :: "r"(addr), "r"(r0), "r"(r1) : "memory");
}

// Four 8x8 bf16 matrices, transposed on the way: thread l gives the address
// of row l % 8 of matrix l / 8.
__device__ __forceinline__ void stmatrix_x4_trans(uint32_t addr, uint32_t r0, uint32_t r1,
                                                  uint32_t r2, uint32_t r3) {
  asm volatile("stmatrix.sync.aligned.m8n8.x4.trans.shared.b16 [%0], {%1, %2, %3, %4};"
               :: "r"(addr), "r"(r0), "r"(r1), "r"(r2), "r"(r3) : "memory");
}

__device__ __forceinline__ uint32_t pack_relu_bf16(float lo, float hi, float bias) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(fmaxf(lo + bias, 0.f), fmaxf(hi + bias, 0.f));
  return *reinterpret_cast<const uint32_t*>(&v);
}

struct Tile {
  int n, h0, w0;
};

__device__ __forceinline__ Tile tile_at(long long t, int bands, int tiles_w) {
  const long long per_image = static_cast<long long>(bands) * tiles_w;
  const int rem = static_cast<int>(t % per_image);
  return {static_cast<int>(t / per_image), (rem / tiles_w) * kBand, (rem % tiles_w) * kTileW};
}

__global__ void __launch_bounds__(kThreads, 1) conv3x3_kernel(
    const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap wmap,
    const __grid_constant__ CUtensorMap ymap, const float* __restrict__ bias, int N, int H,
    int W, int stages) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + kAlign - 1) & ~static_cast<uint32_t>(kAlign - 1);
  const uint32_t w_s = base;                          // [9 taps][64 co][128 B], swizzled
  const uint32_t win_s = w_s + kWBytes;               // [stages][6 rows][34 px][128 B]
  const uint32_t out_s = win_s + stages * kWinBytes;  // [2 warpgroups][4 x 32 + 8 px][128 B]
  const uint32_t w_bar = out_s + kConsumers * kOutStage;
  const uint32_t full_bar = w_bar + 8, empty_bar = full_bar + 8 * stages;
  const int tiles_w = (W + kTileW - 1) / kTileW, bands = (H + kBand - 1) / kBand;
  const long long tiles = static_cast<long long>(N) * bands * tiles_w;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(w_bar, 1);
    for (int s = 0; s < stages; ++s) {
      mbar_init(full_bar + 8 * s, 1);
      mbar_init(empty_bar + 8 * s, 4);  // one arrival from each warp of the consumer
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // Producer: the weight once, then a window per tile into the ring.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (threadIdx.x == 0) {
      mbar_expect_tx(w_bar, kWBytes);
      for (int tap = 0; tap < kTaps; ++tap) tma_load_2d(w_s + tap * kWTapBytes, &wmap, w_bar,
                                                        tap * kC, 0);
      int j = 0;
      for (long long t = blockIdx.x; t < tiles; t += gridDim.x, ++j) {
        const int s = j % stages;
        mbar_wait(empty_bar + 8 * s, ((j / stages) & 1) ^ 1);
        const Tile tl = tile_at(t, bands, tiles_w);
        mbar_expect_tx(full_bar + 8 * s, kLoadBytes);
        tma_load_4d(win_s + s * kWinBytes, &xmap, full_bar + 8 * s, 0, tl.w0 - 1, tl.h0 - 1,
                    tl.n);
      }
    }
  } else {
    // Consumers: warpgroup g takes the block's tiles j = g, g + 2, ...
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
    const int g = wg - 1, ct = threadIdx.x - 128 * wg, warp = ct / 32, lane = ct % 32;
    // This thread's accumulator rows are output channels co and co + 8.
    const int co = 16 * warp + lane / 4;
    const float b_lo = __ldg(bias + co), b_hi = __ldg(bias + co + 8);
    const uint32_t out = out_s + g * kOutStage;
    const long long block_tiles = (tiles - blockIdx.x + gridDim.x - 1) / gridDim.x;
    float acc[kAcc];
#pragma unroll
    for (int i = 0; i < kAcc; ++i) acc[i] = 0.f;
    mbar_wait(w_bar, 0);

    int j = g;
    for (long long t = blockIdx.x + static_cast<long long>(g) * gridDim.x; t < tiles;
         t += static_cast<long long>(kConsumers) * gridDim.x, j += kConsumers) {
      const int s = j % stages;
      mbar_wait(full_bar + 8 * s, (j / stages) & 1);
      const uint32_t win = win_s + s * kWinBytes;
      // Turns: the warpgroups issue their products in tile order, so the
      // tensor cores take one tile while the other warpgroup runs its
      // epilogue. Barrier 3 + g is this warpgroup's turn.
      if (j >= 1) named_barrier(3 + g, 256);
      wgmma_fence();
#pragma unroll
      for (int tap = 0; tap < kTaps; ++tap) {
        const int dy = tap / 3, dx = tap % 3;
#pragma unroll
        for (int ks = 0; ks < kC / 16; ++ks) {
          const uint64_t a = desc_sw128(w_s + tap * kWTapBytes + ks * 32);
          const uint64_t b = desc_sw128(win + (dy * kPitch + dx) * kPixBytes + ks * 32);
          wgmma_m64n136k16(acc, a, b, (tap | ks) != 0);
        }
      }
      wgmma_commit();
      if (j + 1 < block_tiles)  // hand the turn to the other warpgroup's next tile
        asm volatile("bar.arrive %0, 256;" :: "r"(4 - g) : "memory");
      wgmma_wait_all();
      __syncwarp();
      if (lane == 0) mbar_arrive(empty_bar + 8 * s);  // this warp is done with the window

      // Epilogue: the stage is free once this warpgroup's previous store has read it.
      if (ct == 0) store_wait_read();
      named_barrier(1 + g, 128);
      // Accumulator column block jb holds pixels 8jb .. 8jb+7 of the tile's
      // 4 x 34; each goes out as two 8x8 matrices, channels co0 .. co0+7 and
      // co0+8 .. co0+15 of this warp, transposed to [pixel][co] rows of the
      // output stage. Lane l gives the row address of pixel 8 (jb + m / 2) +
      // l % 8 of matrix m = l / 8; a pad pixel goes to one of the 8 rows past
      // the stage, which the store does not read.
      const int rr = lane % 8, m = lane / 8;
#pragma unroll
      for (int jb = 0; jb < kBlocks; jb += 2) {
        const int p = 8 * (jb + m / 2) + rr, c = p % kPitch;
        const int prow = c < kTileW ? (p / kPitch) * kTileW + c : kOutRows + rr;
        const uint32_t addr = out + prow * kPixBytes + (((2 * warp + m % 2) ^ (prow & 7)) * 16);
        const uint32_t v0 = pack_relu_bf16(acc[4 * jb], acc[4 * jb + 1], b_lo);
        const uint32_t v1 = pack_relu_bf16(acc[4 * jb + 2], acc[4 * jb + 3], b_hi);
        if (jb + 1 < kBlocks) {
          stmatrix_x4_trans(addr, v0, v1, pack_relu_bf16(acc[4 * jb + 4], acc[4 * jb + 5], b_lo),
                            pack_relu_bf16(acc[4 * jb + 6], acc[4 * jb + 7], b_hi));
        } else {
          stmatrix_x2_trans(addr, v0, v1);
        }
      }
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");  // visible to the TMA store
      named_barrier(1 + g, 128);
      if (ct == 0) {
        const Tile tl = tile_at(t, bands, tiles_w);
        tma_store_4d(&ymap, out, 0, tl.w0, tl.h0, tl.n);
      }
    }
    if (ct == 0) store_wait_all();
  }
}

PFN_cuTensorMapEncodeTiled encode_fn() {
  static PFN_cuTensorMapEncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (q == cudaDriverEntryPointSuccess) fn = reinterpret_cast<PFN_cuTensorMapEncodeTiled>(p);
  }
  return fn;
}

// A tiled map over a bf16 tensor of `rank` dims (innermost first) whose
// innermost dim is 64 elements (128 B), with the 128-byte swizzle.
CUresult encode(CUtensorMap* map, const void* ptr, int rank, const uint64_t* dims,
                const uint64_t* strides, const uint32_t* box) {
  const uint32_t elem[4] = {1, 1, 1, 1};
  return encode_fn()(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(ptr), dims,
                     strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                     CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                     CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

constexpr int kEncodeError = 100000;  // + the CUresult of a failed encode

}  // namespace

extern "C" {

// Dynamic shared memory of one block with `stages` window stages
// (plan_conv3x3 computes the same).
int nbdt_conv3x3_smem_bytes(int stages) { return smem_bytes(stages); }

// y = relu(conv3x3(x, w) + b) for x, y [N,H,W,64] bf16 (NHWC), wpk [64, 576]
// bf16 (co-major, k = tap*64 + ci), b [64] f32, with the host plan's window
// stages, grid and shared-memory bytes. The caller guarantees contiguous
// tensors, x, y and wpk 16-byte aligned, N, H, W >= 1. Launches on `stream`;
// returns 0 on success, a cudaError_t, or kEncodeError + a CUresult when a
// tensor map cannot be encoded.
int nbdt_conv3x3(const void* x, const void* wpk, const void* b, void* y, int N, int H, int W,
                 int stages, int grid, int smem, int device, void* stream) {
  if (stages < 2 || stages > kMaxStages || grid < 1 || smem != smem_bytes(stages))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (!encode_fn()) return cudaErrorSymbolNotFound;
  CUtensorMap xmap, ymap, wmap;
  const uint64_t dims[4] = {kC, static_cast<uint64_t>(W), static_cast<uint64_t>(H),
                            static_cast<uint64_t>(N)};
  const uint64_t strides[3] = {kPixBytes, static_cast<uint64_t>(W) * kPixBytes,
                               static_cast<uint64_t>(W) * H * kPixBytes};
  const uint32_t xbox[4] = {kC, kPitch, kBand + 2, 1};  // the window, halo included
  const uint32_t ybox[4] = {kC, kTileW, kBand, 1};
  const uint64_t wdims[2] = {kK, kC}, wstrides[1] = {kK * 2};
  const uint32_t wbox[2] = {kC, kC};
  CUresult r = encode(&xmap, x, 4, dims, strides, xbox);
  if (r == CUDA_SUCCESS) r = encode(&ymap, y, 4, dims, strides, ybox);
  if (r == CUDA_SUCCESS) r = encode(&wmap, wpk, 2, wdims, wstrides, wbox);
  if (r != CUDA_SUCCESS) return kEncodeError + static_cast<int>(r);
  err = cudaFuncSetAttribute(conv3x3_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  conv3x3_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      xmap, wmap, ymap, static_cast<const float*>(b), N, H, W, stages);
  return cudaGetLastError();
}

const char* nbdt_conv3x3_error_string(int code) {
  if (code >= kEncodeError) return "cuTensorMapEncodeTiled failed (code - 100000 is its CUresult)";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

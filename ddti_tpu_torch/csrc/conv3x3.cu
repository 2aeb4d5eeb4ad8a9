// Fused 3x3 convolution + bias + ReLU for Hopper (sm_90a), plain C
// interface for ctypes.
//
// Replaces the TPU probe benchmarks/pallas_conv_probe.py:conv3x3_relu_pallas
// (body _kernel), which asks whether a hand-written fused conv + bias + ReLU
// at one ResUNet level comes close to the compiler's convolution:
//     y[n, h, w, o] = relu(b[o] + sum_{dy, dx, c} x[n, h + dy - 1,
//                          w + dx - 1, c] * wk[dy, dx, c, o]),
// x (N, H, W, C) bf16 NHWC with zeros outside the image ("SAME"), wk
// (3, 3, C, CO) bf16, b (CO,) float32, products summed in float32, y
// (N, H, W, CO) bf16.
//
// What bounds it on an H100, by its work: the tensor cores (it reaches
// about half of their rate: see the epilogue below). At the probe's N128 128^2
// C = CO = 128 it does 618.5 GFLOP, 0.625 ms at the dense bf16 peak of 989
// TFLOP/s, against ~1.08 GB of x, y and weights (0.32 ms at 3.35 TB/s).
// A first version, an implicit GEMM on mma.sync, streamed 9 C of x and 9 C
// of weights per 128 x 128 tile from L2, 9.66 GB a call, with two
// __syncthreads per 32-deep chunk; it reached 21% of the bound (2.95 ms on
// an H100 80GB HBM3 at 700 W, where cuDNN's chain takes 2.03).
//
// Design: an implicit GEMM, M = output pixels in rectangular tiles of
// kBH x kBW = 16 x 8, N = CO in tiles of 128, K = 9 C, on wgmma m64n128k16
// (bf16 in, float32 sums), fed by TMA. A persistent grid of one block a SM
// walks the tiles; a block is a producer warpgroup, one thread of which
// issues TMA loads into a ring of stages, and two consumer warpgroups of
// 64 pixels (8 image rows of 8) each.
//  - x through a 4-D tensor map (C, W, H, N): a stage holds one box of
//    (kBH + 2) x kBW pixels by CB channels (CB = 64, one 128-byte swizzled
//    row, or 32 where C % 64 != 0, 64-byte swizzle), shifted by dx - 1
//    columns and starting one row above the tile. TMA fills coordinates
//    outside the image with zeros: no padding, no per-thread address.
//  - The box serves the three taps (0..2, dx): tap dy reads it from pixel
//    row dy kBW on, dy kBW x 2 CB bytes further, a whole number of swizzle
//    atoms, so its wgmma descriptor is the box's advanced by that offset.
//    x's bytes a tile fall from 9 chunks to 3 (kBH + 2) / kBH = 3.375, and
//    a call moves 6.64 GB from L2 instead of 9.66.
//  - Weights through a 3-D map (C, 9, CO) over pack_weights' (CO, 9 C):
//    the stage's three taps' (128 channels, CB) tiles. (Sharing them
//    between the two blocks of a cluster by TMA multicast halved their
//    bytes, 4.2 GB a call, and made the kernel 1.7x slower on the H100,
//    2.34 against 1.37 ms at the probe's shape: every stage then waits for
//    both blocks of the pair.)
//  - The tensor cores' float32 accumulation rounds toward zero, so each
//    chunk (one tap, CB channels) is summed in a fresh accumulator and
//    added to the running sum on the CUDA cores, rounded to nearest. Two
//    fresh accumulators alternate: chunk j + 1's wgmma runs while chunk j
//    is added (wgmma_wait<1>).
//  - The epilogue adds the bias, applies ReLU and rounds to bf16 into the
//    tile's last stage, once both warpgroups' products are done with it
//    (stage_tile: 16-byte chunks, after a quad's lanes trade their pairs).
//    A storer warp of the producer's warpgroup writes it to y with two TMA
//    stores, which leave out pixels past H or W and channels past CO, and
//    then hands the stage back to the loads. With stores from registers
//    the kernel took 1.63 ms a call (4-byte pairs) and 1.37 ms (16-byte
//    chunks) on the H100 at the probe's shape; with TMA stores 1.24-1.29.
// The TPU grid (n, H / HT) left the last H % HT rows unwritten; HT, a TPU
// tiling knob, is not carried over.
//
// Takes C % 32 == 0, CO % 8 == 0, N H W < 2^31, x and wt 16-byte aligned
// (the wrapper checks).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

constexpr int kBH = 16, kBW = 8;  // pixel tile: image rows x columns
constexpr int kBN = 128;          // output channels a tile
constexpr int kConsumers = 2;     // warpgroups of 64 pixels (8 rows of 8)
constexpr int kThreads = 128 * (kConsumers + 1);
// setmaxnreg: the consumers hold a running sum and two fresh chunk sums
// (3 x 64 floats a thread), the producer its tile walk
constexpr int kConvConsumerRegs = 232, kConvProducerRegs = 40;
constexpr uint32_t kOutBox = kBH * kBW * 128;  // 64 bf16 channels a pixel

template <int CB>
struct ConvSmem {
  static_assert(CB == 32 || CB == 64, "CB");
  static constexpr uint32_t kRow = 2 * CB;                 // a pixel's chunk
  static constexpr uint32_t kAtom = 8 * kRow;              // swizzle repeat
  static constexpr uint32_t kXBox = (kBH + 2) * kBW * kRow;
  static constexpr uint32_t kWTile = kBN * kRow;           // one tap
  static constexpr uint32_t kStage = kXBox + 3 * kWTile;   // x box, 3 taps
  static constexpr int kStages = CB == 64 ? 3 : 6;
  static constexpr uint64_t kLayout = CB == 64 ? 1 : 2;    // 128B, 64B
  static constexpr CUtensorMapSwizzle kSwizzle =
      CB == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B;
  // full[kStages], empty[kStages], stored, drained
  static constexpr uint32_t bars = kStages * kStage;
  static constexpr size_t bytes = bars + 8 * (2 * kStages + 2) + 1024;
  static_assert(kXBox % 1024 == 0 && kWTile % 1024 == 0, "atoms");
  // a tile's output, two boxes of kBH x kBW pixels by 64 channels, lies in
  // its last stage once the stage's products are done
  static_assert(kStage >= 2 * kOutBox, "the output tile fits a stage");
};

// descriptor of k16 step kk of a K-major operand of CB-channel rows
template <int CB>
__device__ __forceinline__ uint64_t conv_desc(uint32_t addr, int kk) {
  return smem_desc(addr + kk * 32, 16, ConvSmem<CB>::kAtom,
                   ConvSmem<CB>::kLayout);
}

// The walk: tile q of the call is pixel tile q % P (image, tile row, tile
// column) of channel tile q / P; block b takes q = b, b + gridDim.x, ...
struct Walk {
  int th, tw, p, tiles;
  __device__ Walk(int n, int h, int w, int co) {
    th = (h + kBH - 1) / kBH;
    tw = (w + kBW - 1) / kBW;
    p = n * th * tw;
    tiles = p * ((co + kBN - 1) / kBN);
  }
};

// the two consumer warpgroups, named barrier 1 (the producer's warpgroup
// does not take part)
__device__ __forceinline__ void named_sync_consumers() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers * 128) : "memory");
}

// a consumer warp is done with a stage: one arrival on its barrier
__device__ __forceinline__ void release(uint64_t* empty, int lane) {
  __syncwarp();
  if (lane == 0) mbar_arrive(empty);
}

// A consumer's chunk j of a tile (stage j / 3 from ring position pos0 on,
// tap dy = j % 3): its CB / 16 k16 products into `cur`, a fresh sum; then,
// once chunk j - 1's products are done, its sum `prev` added to acc on the
// CUDA cores, rounded to nearest, and its stage released after its third
// tap.
template <int CB>
__device__ __forceinline__ void conv_chunk(float (&acc)[64],
                                           float (&cur)[64],
                                           float (&prev)[64], int j, int pos0,
                                           int wg, int lane, uint64_t* full,
                                           uint64_t* empty) {
  using L = ConvSmem<CB>;
  const int pos = pos0 + j / 3, dy = j % 3, st = pos % L::kStages;
  if (dy == 0) mbar_wait(full + st, (pos / L::kStages) & 1);
  // the ring lies below the barriers
  const uint32_t stage = smem_addr(full) - L::bars + st * L::kStage;
  const uint32_t a = stage + (8 * wg + dy) * L::kAtom;
  const uint32_t b = stage + L::kXBox + dy * L::kWTile;
  fence_acc(cur);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < CB / 16; ++kk)
    wgmma_m64n128k16_ss(cur, conv_desc<CB>(a, kk), conv_desc<CB>(b, kk), kk);
  wgmma_commit();
  if (j == 0) return;
  wgmma_wait<1>();
  fence_acc(prev);
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] += prev[i];
  if ((j - 1) % 3 == 2)
    release(empty + (pos0 + (j - 1) / 3) % L::kStages, lane);
}

// y = relu(acc + b) as bf16 for one warp's two tile rows row0, row0 + 1 at
// column g, channels co0 + 8 i + 2 t + {0, 1} (i < 16) in acc[4 i + 2
// half + {0, 1}], written into the output tile `out` that the TMA store
// reads: two boxes (channels 0-63, 64-127) of kBH x kBW pixels, a pixel a
// 128-byte row, 16-byte chunks swizzled as the 128-byte swizzle lays them
// (chunk ^ row % 8). The four lanes of a quad (t = 0..3, one pixel) trade
// their bf16 pairs so that lane t holds channels 32 m + 8 t .. + 7 for m =
// 0..3 and writes them as one 16-byte chunk.
__device__ __forceinline__ void stage_tile(const float (&acc)[64],
                                           const float* __restrict__ bias,
                                           unsigned char* out, int row0,
                                           int g, int co0, int co, int t) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int px = (row0 + half) * kBW + g;  // the pixel's row in a box
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      uint32_t p[4];  // this lane's pairs of groups 4 m .. 4 m + 3
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int i = 4 * m + k, o = min(co0 + 8 * i + 2 * t, co - 2);
        p[k] = pack_bf16(fmaxf(acc[4 * i + 2 * half] + bias[o], 0.f),
                         fmaxf(acc[4 * i + 2 * half + 1] + bias[o + 1], 0.f));
      }
      // round x: lane t takes lane (t ^ x)'s pair of group 4 m + t, which
      // lane s = t ^ x holds as p[s ^ x]; it is channel pair s of group t
      uint32_t got[4];
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const int k = t ^ x;
        const uint32_t send = k == 0 ? p[0] : k == 1 ? p[1] : k == 2 ? p[2]
                                                                   : p[3];
        got[x] = __shfl_xor_sync(0xffffffffu, send, x);
      }
      uint32_t v[4];  // v[s] = got[s ^ t]
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int x = j ^ t;
        v[j] = x == 0 ? got[0] : x == 1 ? got[1] : x == 2 ? got[2] : got[3];
      }
      const int chunk = (4 * (m & 1) + t) ^ (px & 7);
      *reinterpret_cast<uint4*>(out + (m >> 1) * kOutBox + px * 128 +
                                chunk * 16) = make_uint4(v[0], v[1], v[2],
                                                         v[3]);
    }
  }
}

template <int CB>
__global__ void __launch_bounds__(kThreads, 1)
conv3x3_relu_kernel(const __grid_constant__ CUtensorMap x_map,
                    const __grid_constant__ CUtensorMap w_map,
                    const __grid_constant__ CUtensorMap y_map,
                    const float* __restrict__ bias, int n_img, int h, int w,
                    int c, int co) {
  using L = ConvSmem<CB>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::bars);
  uint64_t* empty = full + L::kStages;
  uint64_t* stored = empty + L::kStages;  // a tile's output is in its stage
  uint64_t* drained = stored + 1;         // the TMA store has read it
  const int wg = threadIdx.x / 128;
  const Walk walk(n_img, h, w, co);
  const int stages_per_tile = 3 * (c / CB);

  if (threadIdx.x == 0) {
    for (int i = 0; i < L::kStages; ++i) {
      mbar_init(full + i, 1);
      mbar_init(empty + i, kConsumers * 4);  // one arrival a consumer warp
    }
    mbar_init(stored, kConsumers * 4);
    mbar_init(drained, 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == kConsumers) {  // the producer: loads, and stores
    regs_dealloc<kConvProducerRegs>();
    if (threadIdx.x == kConsumers * 128 + 32) {
      // the storer: each tile's output from its last stage to y, which it
      // then hands back to the loads (for the consumers' eight arrivals)
      int pos0 = 0, k = 0;
      for (int q = blockIdx.x; q < walk.tiles; q += gridDim.x, ++k) {
        const int st = (pos0 + stages_per_tile - 1) % L::kStages;
        pos0 += stages_per_tile;
        mbar_wait(stored, k & 1);
        const int pt = q % walk.p;
        const int img = pt / (walk.th * walk.tw);
        const int h0 = (pt / walk.tw) % walk.th * kBH;
        const int w0 = pt % walk.tw * kBW;
        const int co0 = q / walk.p * kBN;
#pragma unroll
        for (int b = 0; b < 2; ++b)
          if (co0 + 64 * b < co)
            tma_store(&y_map, smem + st * L::kStage + b * kOutBox,
                      co0 + 64 * b, w0, h0, img);
        bulk_commit();
        bulk_wait<true>();
        mbar_arrive(empty + st, kConsumers * 4);
        mbar_arrive(drained);
      }
      bulk_wait<false>();
    }
    if (threadIdx.x == kConsumers * 128) {
      int pos = 0;
      for (int q = blockIdx.x; q < walk.tiles; q += gridDim.x) {
        const int pt = q % walk.p;
        const int img = pt / (walk.th * walk.tw);
        const int h0 = (pt / walk.tw) % walk.th * kBH;
        const int w0 = pt % walk.tw * kBW;
        const int co0 = q / walk.p * kBN;
        for (int s = 0; s < stages_per_tile; ++s, ++pos) {
          const int c0 = s / 3 * CB, dx = s % 3;
          const int st = pos % L::kStages;
          mbar_wait(empty + st, ((pos / L::kStages) & 1) ^ 1);
          mbar_expect_tx(full + st, L::kStage);
          unsigned char* stage = smem + st * L::kStage;
          tma_load(stage, &x_map, full + st, c0, w0 + dx - 1, h0 - 1, img);
#pragma unroll
          for (int dy = 0; dy < 3; ++dy)
            tma_load(stage + L::kXBox + dy * L::kWTile, &w_map, full + st, c0,
                     3 * dy + dx, co0);
        }
      }
    }
  } else {  // a consumer: tile rows 8 wg .. 8 wg + 7
    regs_alloc<kConvConsumerRegs>();
    const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    const int g = lane / 4, t = lane % 4;
    const int chunks = 3 * stages_per_tile;  // chunk j: stage j / 3, dy j % 3
    float acc[64], f0[64], f1[64];
    int pos0 = 0;  // the ring position of the tile's first stage

    for (int q = blockIdx.x, k = 0; q < walk.tiles; q += gridDim.x, ++k) {
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[i] = 0.f;
#pragma unroll 1
      for (int j = 0; j < chunks; j += 2) {
        conv_chunk<CB>(acc, f0, f1, j, pos0, wg, lane, full, empty);
        if (j + 1 < chunks)
          conv_chunk<CB>(acc, f1, f0, j + 1, pos0, wg, lane, full, empty);
      }
      // the last chunk, in f0 where their count is odd
      wgmma_wait<0>();
      fence_acc(f0);
      fence_acc(f1);
      if (chunks & 1) {
#pragma unroll
        for (int i = 0; i < 64; ++i) acc[i] += f0[i];
      } else {
#pragma unroll
        for (int i = 0; i < 64; ++i) acc[i] += f1[i];
      }
      // epilogue: accumulator row 16 warp + g + 8 half is tile pixel
      // (8 wg + 2 warp + half, g), column 8 i + 2 t + e channel co0 + it.
      // The output tile takes the last stage once both warpgroups' products
      // are done with it, and once the storer has read the previous tile's
      // (so that `stored` runs at most one phase ahead of it).
      named_sync_consumers();
      if (k > 0) mbar_wait(drained, (k - 1) & 1);
      stage_tile(acc, bias,
                 smem + (pos0 + stages_per_tile - 1) % L::kStages * L::kStage,
                 8 * wg + 2 * warp, g, q / walk.p * kBN, co, t);
      fence_proxy_async();
      __syncwarp();
      if (lane == 0) mbar_arrive(stored);
      pos0 += stages_per_tile;
    }
  }
}

template <int CB>
cudaError_t launch(const void* x, const void* wt, const float* b,
                   __nv_bfloat16* y, int n, int h, int w, int c, int co,
                   int sms, cudaStream_t stream) {
  using L = ConvSmem<CB>;
  cudaError_t err;
  CUtensorMap xm, wm, ym;
  {
    const cuuint64_t dims[4] = {(cuuint64_t)c, (cuuint64_t)w, (cuuint64_t)h,
                                (cuuint64_t)n};
    const cuuint64_t strides[3] = {2ull * c, 2ull * c * w, 2ull * c * w * h};
    const cuuint32_t box[4] = {CB, kBW, kBH + 2, 1};
    if ((err = encode(&xm, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, x, dims,
                      strides, box, L::kSwizzle)))
      return err;
  }
  {
    const cuuint64_t dims[3] = {(cuuint64_t)c, 9, (cuuint64_t)co};
    const cuuint64_t strides[2] = {2ull * c, 18ull * c};
    const cuuint32_t box[3] = {CB, 1, kBN};
    if ((err = encode(&wm, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, wt, dims,
                      strides, box, L::kSwizzle)))
      return err;
  }
  {
    const cuuint64_t dims[4] = {(cuuint64_t)co, (cuuint64_t)w, (cuuint64_t)h,
                                (cuuint64_t)n};
    const cuuint64_t strides[3] = {2ull * co, 2ull * co * w,
                                   2ull * co * w * h};
    const cuuint32_t box[4] = {64, kBW, kBH, 1};
    if ((err = encode(&ym, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, y, dims,
                      strides, box, CU_TENSOR_MAP_SWIZZLE_128B)))
      return err;
  }
  const auto kernel = conv3x3_relu_kernel<CB>;
  static std::atomic<uint64_t> smem_set{0};
  if ((err = set_smem_once(kernel, L::bytes, smem_set))) return err;
  static const cudaError_t pool =
      check_register_pool<kConvConsumerRegs, kConvProducerRegs>(kernel,
                                                                kConsumers);
  if (pool != cudaSuccess) return pool;
  // one block a SM (the ring takes ~200 KB), no more than the tiles
  const long long tiles = (long long)n * ((h + kBH - 1) / kBH) *
                          ((w + kBW - 1) / kBW) * ((co + kBN - 1) / kBN);
  const int grid = (int)(tiles < sms ? tiles : sms);
  kernel<<<grid, kThreads, L::bytes, stream>>>(xm, wm, ym, b, n, h, w, c, co);
  return cudaGetLastError();
}

}  // namespace

// x: (n, h, w, c) bf16 NHWC, contiguous; wt: (co, 9 c) bf16, contiguous,
// wt[o, (3 dy + dx) c + ci] = wk[dy, dx, ci, o]; b: (co,) float32; y: (n, h,
// w, co) bf16. c % 32 == 0, co % 8 == 0, n h w < 2^31, x and wt 16-byte
// aligned. Launches on `stream` without synchronising and returns the
// launch's cudaError_t (0 = success).
extern "C" int ddti_conv3x3_relu(const void* x, const void* wt, const void* b,
                                 void* y, int n, int h, int w, int c, int co,
                                 int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const long long m = (long long)n * h * w;
  if (n <= 0 || h <= 0 || w <= 0 || c <= 0 || co <= 0 || c % 32 ||
      co % 8 || m >= (1ll << 31) || (reinterpret_cast<uintptr_t>(x) & 15) ||
      (reinterpret_cast<uintptr_t>(wt) & 15))
    return (int)cudaErrorInvalidValue;
  int sms;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    device)))
    return (int)err;
  const float* bias = static_cast<const float*>(b);
  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(y);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(c % 64 ? launch<32>(x, wt, bias, out, n, h, w, c, co, sms, st)
                      : launch<64>(x, wt, bias, out, n, h, w, c, co, sms,
                                   st));
}

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
// What bounds it on an H100: the tensor cores. At the probe's N128 128^2
// C = CO = 128 it does 618.5 GFLOP, 0.625 ms at the dense bf16 peak of 989
// TFLOP/s, against ~1.08 GB of x, y and weights (0.32 ms at 3.35 TB/s).
//
// Design: an implicit GEMM, M = N H W output pixels (flattened, so any H and
// W), N = CO, K = 9 C (tap-major: k = (3 dy + dx) C + c), on mma.sync
// m16n8k16 (bf16 in, float32 accumulate; the fragment layouts of sm90.cuh's
// header). A block of 8 warps computes 128 pixels x 128 channels, each warp
// 64 x 32 (4 x 4 tiles of m16n8). K advances in chunks of 32 that lie in
// one tap: cp.async stages the chunk's (128 pixels, 32 channels) slice of x
// and its (128 channels, 32) slice of the weights, relaid once outside the
// call to (CO, 9 C), K contiguous, into shared memory, double buffered,
// rows padded to 80 bytes so that ldmatrix reads them without bank
// conflicts. The halo is not padded in memory, as the TPU probe's jnp.pad
// did: a pixel row whose tap falls outside the image is a cp.async that
// reads 0 bytes and fills 16 zeros. The tensor cores' float32 accumulation
// rounds toward zero, so each chunk's two k16 products are summed in a
// fresh accumulator and added to the running sum on the CUDA cores, rounded
// to nearest (as sm90.cuh's acc_tile does for the flash kernels). Bias and
// ReLU are applied on the way out, stored as bf16 pairs. The TPU grid
// (n, H / HT) left the last H % HT rows unwritten; HT, a TPU tiling knob,
// is not carried over.
//
// Takes C % 32 == 0, CO % 8 == 0, N H W < 2^31 (the wrapper checks).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBM = 128;       // pixels a block
constexpr int kBN = 128;       // output channels a block
constexpr int kBK = 32;        // K a chunk (two k16 steps, one tap)
constexpr int kStride = 40;    // shared row, bf16 (80 bytes: 64 + padding)

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; `bytes` 0 fills the 16 bytes with zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

// d = a b + d, one m16n8k16 tile (bf16 in, float32 accumulate)
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__global__ void __launch_bounds__(kThreads, 2)
conv3x3_relu_kernel(const __nv_bfloat16* __restrict__ x,
                    const __nv_bfloat16* __restrict__ wt,
                    const float* __restrict__ bias,
                    __nv_bfloat16* __restrict__ y, int n_img, int h, int w,
                    int c, int co) {
  __shared__ __align__(128) __nv_bfloat16 sa[2][kBM][kStride];
  __shared__ __align__(128) __nv_bfloat16 sb[2][kBN][kStride];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 2, wn = warp & 3;   // 2 x 4 warps: 64 x 32 each
  const long long m = (long long)n_img * h * w;
  const long long m0 = (long long)blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;
  const long long k_all = 9ll * c;
  const int chunks_per_tap = c / kBK, chunks = 9 * chunks_per_tap;

  // the two pixel rows and the two weight rows this thread stages, and its
  // 16-byte column of them
  const int seg = tid & 3;
  int ph[2], pw[2];
  const __nv_bfloat16* px[2];
  const __nv_bfloat16* pwt[2];
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const int row = (tid >> 2) + 64 * q;
    const long long p = m0 + row;
    if (p < m) {
      pw[q] = (int)(p % w);
      ph[q] = (int)((p / w) % h);
      px[q] = x + p * c + seg * 8;
    } else {
      ph[q] = -4;  // outside every tap
      pw[q] = 0;
      px[q] = x;
    }
    const int o = n0 + row;
    pwt[q] = o < co ? wt + o * k_all + seg * 8 : nullptr;
  }

  auto load = [&](int stage, int kc) {
    const int tap = kc / chunks_per_tap;
    const int c0 = (kc - tap * chunks_per_tap) * kBK;
    const int dy = tap / 3 - 1, dx = tap % 3 - 1;
    const long long shift = ((long long)dy * w + dx) * c + c0;
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int row = (tid >> 2) + 64 * q;
      const int hh = ph[q] + dy, ww = pw[q] + dx;
      const bool in = hh >= 0 && hh < h && ww >= 0 && ww < w;
      cp_async16(&sa[stage][row][seg * 8], in ? px[q] + shift : x,
                 in ? 16 : 0);
      cp_async16(&sb[stage][row][seg * 8],
                 pwt[q] ? pwt[q] + (long long)kc * kBK : wt,
                 pwt[q] ? 16 : 0);
    }
  };

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[i][j][v] = 0.f;

  load(0, 0);
  cp_async_commit();
#pragma unroll 1
  for (int kc = 0; kc < chunks; ++kc) {
    if (kc + 1 < chunks) load((kc + 1) & 1, kc + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const int s = kc & 1;
    // B fragments of both k16 steps: for each pair of n8 tiles, ldmatrix
    // matrices (n 0-7, k 0-7), (n 0-7, k 8-15), (n 8-15, k 0-7), (n 8-15,
    // k 8-15) -> b[ks][tile][0..1]
    uint32_t b[2][4][2];
#pragma unroll
    for (int ks = 0; ks < 2; ++ks)
#pragma unroll
      for (int pr = 0; pr < 2; ++pr) {
        const int mat = lane >> 3;
        const int row = wn * 32 + pr * 16 + (mat >> 1) * 8 + (lane & 7);
        uint32_t r[4];
        ldmatrix_x4(r, &sb[s][row][ks * 16 + (mat & 1) * 8]);
        b[ks][2 * pr][0] = r[0];
        b[ks][2 * pr][1] = r[1];
        b[ks][2 * pr + 1][0] = r[2];
        b[ks][2 * pr + 1][1] = r[3];
      }
#pragma unroll
    for (int mi = 0; mi < 4; ++mi) {
      // A fragments: lanes 0-15 rows 0-15 at k 0, lanes 16-31 at k 8
      uint32_t a[2][4];
      const int row = wm * 64 + mi * 16 + (lane & 15);
#pragma unroll
      for (int ks = 0; ks < 2; ++ks)
        ldmatrix_x4(a[ks], &sa[s][row][ks * 16 + (lane >> 4) * 8]);
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        float t[4] = {0.f, 0.f, 0.f, 0.f};
        mma_bf16(t, a[0], b[0][ni][0], b[0][ni][1]);
        mma_bf16(t, a[1], b[1][ni][0], b[1][ni][1]);
#pragma unroll
        for (int v = 0; v < 4; ++v) acc[mi][ni][v] += t[v];
      }
    }
    __syncthreads();
  }

  // epilogue: thread (g, t) = (lane / 4, lane % 4) holds rows g and g + 8
  // of each m16 tile at columns 2t, 2t + 1 of each n8 tile
  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int ni = 0; ni < 4; ++ni) {
    const int o = n0 + wn * 32 + ni * 8 + 2 * t4;
    if (o >= co) continue;
    const float b0 = bias[o], b1 = bias[o + 1];
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const long long p = m0 + wm * 64 + mi * 16 + g + 8 * half;
        if (p >= m) continue;
        const __nv_bfloat162 v = __floats2bfloat162_rn(
            fmaxf(acc[mi][ni][2 * half] + b0, 0.f),
            fmaxf(acc[mi][ni][2 * half + 1] + b1, 0.f));
        *reinterpret_cast<__nv_bfloat162*>(y + p * co + o) = v;
      }
  }
}

}  // namespace

// x: (n, h, w, c) bf16 NHWC, contiguous; wt: (co, 9 c) bf16, contiguous,
// wt[o, (3 dy + dx) c + ci] = wk[dy, dx, ci, o]; b: (co,) float32; y: (n, h,
// w, co) bf16. c % 32 == 0, co % 8 == 0, n h w < 2^31. Launches on `stream`
// without synchronising and returns the launch's cudaError_t (0 = success).
extern "C" int ddti_conv3x3_relu(const void* x, const void* wt, const void* b,
                                 void* y, int n, int h, int w, int c, int co,
                                 int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const long long m = (long long)n * h * w;
  if (n <= 0 || h <= 0 || w <= 0 || c <= 0 || co <= 0 || c % kBK ||
      co % 8 || m >= (1ll << 31))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((m + kBM - 1) / kBM),
                  (unsigned)((co + kBN - 1) / kBN));
  conv3x3_relu_kernel<<<grid, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(wt), static_cast<const float*>(b),
      static_cast<__nv_bfloat16*>(y), n, h, w, c, co);
  return (int)cudaGetLastError();
}

// Exact Euclidean distance transform of a batch of binary masks, for Hopper
// (sm_90a). Replaces the TPU kernel ddti_tpu/ops/edt.py:_minplus_kernel
// (the min-plus row pass, called through _minplus_pallas) and the XLA
// column pass beside it (_column_pass).
//
// For every image n and pixel (i, j) whose mask value is nonzero:
//     out[n, i, j] = distance to the nearest zero pixel of image n,
// capped at h + w when image n has no zero at all (scipy's
// distance_transform_edt semantics, as in the JAX package).
//
// Two kernels, one launch each, in place in the float32 output buffer:
//   1. column pass: one thread per (image, column) sweeps the column down
//      and up and writes g^2, the squared distance to the nearest zero in
//      that column (capped at h + w);
//   2. row pass:    D^2[i, j] = min_k g^2[i, k] + (j - k)^2, then the finish
//      sqrt(min(D^2, (h + w)^2)). One block per row stages the row of g^2 in
//      shared memory (it then overwrites the row in place); each thread
//      keeps JPT output columns in registers and loops k over the whole row.
//
// Bound: the row pass does N*H*W*W candidate evaluations (2.1e9 at the
// training slice's 16 x 512 x 512), three FP32 instructions each (a
// subtract, an FMA, a min) against one broadcast shared-memory load per k
// for JPT columns. That is compute on the FP32 pipes, not bytes: the row is
// read once and written once. The TPU kernel's 8x128x128 tiling existed for
// its vector registers and is not carried over; a lower-envelope
// (Felzenszwalb-Huttenlocher) row pass, O(W) per row instead of O(W^2), is
// the later redesign (ROADMAP.md).
//
// Exactness: every candidate is fl(g^2 + d^2) of integers, the rounding the
// JAX package does in float32, so the result is bit-equal to its plain
// version for H, W <= 2048 (the wrapper's bound): true distances stay below
// 2^23 and the all-foreground cap (h + w)^2 <= 2^24 is exact.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxSide = 2048;     // the wrapper's bound; shared row size
constexpr int kColThreads = 128;
constexpr int kRowThreads = 128;
constexpr int kJpt = 4;            // output columns a thread keeps

__global__ void __launch_bounds__(kColThreads)
edt_column_kernel(const uint8_t* __restrict__ fg, float* __restrict__ out,
                  int64_t n_img, int h, int w) {
  const int64_t t = blockIdx.x * (int64_t)kColThreads + threadIdx.x;
  if (t >= n_img * w) return;
  const int64_t n = t / w;
  const int j = (int)(t - n * w);
  const int64_t base = n * (int64_t)h * w + j;
  const int cap = h + w;
  // down: distance to the nearest zero at or above, kept in out
  int last = -1;
#pragma unroll 8
  for (int i = 0; i < h; ++i) {
    const int64_t at = base + (int64_t)i * w;
    if (fg[at] == 0) last = i;
    out[at] = (float)(last >= 0 ? i - last : cap);
  }
  // up: nearest zero at or below; keep the smaller, square it
  int next = -1;
#pragma unroll 8
  for (int i = h - 1; i >= 0; --i) {
    const int64_t at = base + (int64_t)i * w;
    if (fg[at] == 0) next = i;
    const float below = (float)(next >= 0 ? next - i : cap);
    const float g = fminf(fminf(out[at], below), (float)cap);
    out[at] = g * g;
  }
}

__global__ void __launch_bounds__(kRowThreads)
edt_row_kernel(float* __restrict__ buf, int64_t rows, int w, float cap2) {
  __shared__ float row[kMaxSide];
  for (int64_t r = blockIdx.x; r < rows; r += gridDim.x) {
    float* src = buf + r * w;
    __syncthreads();  // the previous row's reads of `row` are done
    for (int k = threadIdx.x; k < w; k += kRowThreads) row[k] = src[k];
    __syncthreads();
    for (int j0 = threadIdx.x; j0 < w; j0 += kRowThreads * kJpt) {
      float jf[kJpt], best[kJpt];
#pragma unroll
      for (int m = 0; m < kJpt; ++m) {
        jf[m] = (float)(j0 + m * kRowThreads);
        best[m] = __int_as_float(0x7f800000);  // +inf
      }
      float kf = 0.f;
#pragma unroll 4
      for (int k = 0; k < w; ++k, kf += 1.f) {
        const float gk = row[k];
#pragma unroll
        for (int m = 0; m < kJpt; ++m) {
          const float d = jf[m] - kf;
          best[m] = fminf(best[m], fmaf(d, d, gk));
        }
      }
#pragma unroll
      for (int m = 0; m < kJpt; ++m) {
        const int j = j0 + m * kRowThreads;
        if (j < w) src[j] = sqrtf(fminf(best[m], cap2));
      }
    }
  }
}

}  // namespace

// fg: (n, h, w) uint8, nonzero = foreground; out: (n, h, w) float32.
// Returns the CUDA error of the launches (0 on success).
extern "C" int ddti_edt(const void* fg, void* out, long long n, int h, int w,
                        void* stream) {
  if (n <= 0 || h <= 0 || w <= 0 || h > kMaxSide || w > kMaxSide)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int64_t cols = (int64_t)n * w;
  const int64_t col_blocks = (cols + kColThreads - 1) / kColThreads;
  edt_column_kernel<<<(unsigned)col_blocks, kColThreads, 0, s>>>(
      (const uint8_t*)fg, (float*)out, n, h, w);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int64_t rows = (int64_t)n * h;
  const unsigned row_blocks = (unsigned)(rows < (1 << 30) ? rows : (1 << 30));
  const float cap = (float)(h + w);
  edt_row_kernel<<<row_blocks, kRowThreads, 0, s>>>((float*)out, rows, w,
                                                     cap * cap);
  return (int)cudaGetLastError();
}

// The message of a CUDA error code, for the Python wrappers' exceptions.
extern "C" const char* ddti_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

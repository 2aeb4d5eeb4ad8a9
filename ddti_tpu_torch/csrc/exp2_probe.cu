// The exp2 probe for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the TPU probe benchmarks/exp2_probe.py:make_kernel, which asks
// whether a polynomial exp2 beats the builtin one inside a kernel. Computes
// y = f(x) elementwise over a contiguous float32 array, f by `mode`:
//   0 copy     y = x (the memory floor)
//   1 builtin  2^x on the exp2 unit (ex2.approx.ftz, sm90.cuh:exp2_ftz,
//              what the flash kernels run by default)
//   4, 5, 6    2^x by sm90.cuh:exp2_poly<mode>, the polynomial the flash
//              kernels run when built with -DDDTI_POLY_EXP2=1
//
// What bounds it on an H100 (3.35 TB/s; 16 ex2 per clock per SM, 132 SMs at
// 1980 MHz): at the probe's (512, 16384) it reads 33.6 MB and writes as
// much, 0.0200 ms at the memory rate, against 8.4 M exponentials, 0.0020
// ms of the exp2 unit, and ~14 FP32 and integer instructions an element for
// the order-6 polynomial (~0.004 ms of issue). Every mode is bound by the
// bytes: on this card the probe measures the memory, not the exp2 trade,
// which shows only where the exponentials are not hidden behind loads (the
// flash kernels; ddti_tpu_torch/probes/flash_poly_ab.py). The TPU kernel's
// (256, 1024) blocks existed for its vector memory: here every thread moves
// 16 bytes a load and a store, in a grid-stride loop over as many blocks as
// fill the SMs, and the last n % 4 elements go one a thread.

#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;

template <int MODE>
__device__ __forceinline__ float probe_fn(float x) {
  if constexpr (MODE == 0) return x;
  else if constexpr (MODE == 1) return exp2_ftz(x);
  else return exp2_poly<MODE>(x);
}

template <int MODE>
__global__ void __launch_bounds__(kThreads)
exp2_probe_kernel(const float* __restrict__ x, float* __restrict__ y,
                  long long n) {
  const long long n4 = n / 4;
  const long long stride = (long long)gridDim.x * kThreads;
  const long long first = (long long)blockIdx.x * kThreads + threadIdx.x;
  const float4* x4 = reinterpret_cast<const float4*>(x);
  float4* y4 = reinterpret_cast<float4*>(y);
  // not unrolled: the unrolled loop's trip count is a 64-bit division,
  // which issues F2I
#pragma unroll 1
  for (long long i = first; i < n4; i += stride) {
    const float4 v = x4[i];
    y4[i] = make_float4(probe_fn<MODE>(v.x), probe_fn<MODE>(v.y),
                        probe_fn<MODE>(v.z), probe_fn<MODE>(v.w));
  }
  if (first < n - 4 * n4)
    y[4 * n4 + first] = probe_fn<MODE>(x[4 * n4 + first]);
}

template <int MODE>
cudaError_t launch(const float* x, float* y, long long n, int sms,
                   cudaStream_t stream) {
  const long long want = (n / 4 + kThreads - 1) / kThreads;
  const long long most = (long long)sms * kBlocksPerSm;
  const unsigned blocks = (unsigned)(want < 1 ? 1 : want < most ? want : most);
  exp2_probe_kernel<MODE><<<blocks, kThreads, 0, stream>>>(x, y, n);
  return cudaGetLastError();
}

}  // namespace

// x, y: contiguous float32 device arrays of n > 0 elements, 16-byte
// aligned; mode 0 (copy), 1 (the exp2 unit) or 4, 5, 6 (the polynomial of
// that order). Launches on `stream` without synchronising and returns the
// launch's cudaError_t (0 = success).
extern "C" int ddti_exp2_probe(const void* x, void* y, long long n, int mode,
                               int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n <= 0) return (int)cudaErrorInvalidValue;
  int sms;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    device)))
    return (int)err;
  const float* in = static_cast<const float*>(x);
  float* out = static_cast<float*>(y);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case 0: return (int)launch<0>(in, out, n, sms, st);
    case 1: return (int)launch<1>(in, out, n, sms, st);
    case 4: return (int)launch<4>(in, out, n, sms, st);
    case 5: return (int)launch<5>(in, out, n, sms, st);
    case 6: return (int)launch<6>(in, out, n, sms, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

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
// (256, 1024) blocks existed for its vector memory.
//
// The memory path. A block takes one tile of kThreads x kVecs 16-byte
// vectors (16 KB) and the grid covers the array once, with no grid-stride
// loop: ceil(n / kTileFloats) blocks. Each thread starts all kVecs loads
// of its tile before it computes or stores any of them, so a thread keeps
// 64 bytes in flight; the offsets inside a tile are 32-bit with trip counts
// fixed at compile time, so nothing divides and no F2I appears (the SASS
// check in chip_smoke.py forbids F2I and FRND on the poly paths, where they
// would run at the exp2 unit's rate). Loads stream past L1
// (ld.global.nc.L1::no_allocate) and stores are marked evict-first
// (st.global.cs): nothing is read twice. Only the last block can be
// partial; it masks its vectors and writes the last n % 4 elements one a
// thread. Moving each tile in and out of shared memory by bulk
// asynchronous copies (cp.async.bulk) instead was measured 6-9% slower on
// an H100 (PERF.md) and is not kept.

#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kVecs = 4;                       // 16-byte vectors a thread
constexpr int kTileVecs = kThreads * kVecs;    // a block's tile
constexpr long long kTileFloats = 4ll * kTileVecs;

template <int MODE>
__device__ __forceinline__ float probe_fn(float x) {
  if constexpr (MODE == 0) return x;
  else if constexpr (MODE == 1) return exp2_ftz(x);
  else return exp2_poly<MODE>(x);
}

template <int MODE>
__device__ __forceinline__ float4 probe_fn4(float4 v) {
  return make_float4(probe_fn<MODE>(v.x), probe_fn<MODE>(v.y),
                     probe_fn<MODE>(v.z), probe_fn<MODE>(v.w));
}

__device__ __forceinline__ float4 load_stream(const float4* p) {
  float4 v;
  asm volatile("ld.global.nc.L1::no_allocate.v4.f32 {%0, %1, %2, %3}, [%4];"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "l"(p));
  return v;
}

__device__ __forceinline__ void store_stream(float4* p, float4 v) {
  asm volatile("st.global.cs.v4.f32 [%0], {%1, %2, %3, %4};" ::"l"(p),
               "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w)
               : "memory");
}

// the n % 4 elements past the last whole vector, one a thread of the last
// block
template <int MODE>
__device__ __forceinline__ void tail(const float* x, float* y, long long n) {
  const long long at = (n & ~3ll) + threadIdx.x;
  if (at < n) y[at] = probe_fn<MODE>(x[at]);
}

template <int MODE>
__global__ void __launch_bounds__(kThreads)
exp2_probe_kernel(const float* __restrict__ x, float* __restrict__ y,
                  long long n) {
  const long long first = (long long)blockIdx.x * kTileVecs;
  const long long left = (n >> 2) - first;  // whole vectors from the tile on
  const float4* src = reinterpret_cast<const float4*>(x) + first;
  float4* dst = reinterpret_cast<float4*>(y) + first;
  float4 v[kVecs];
  if (left >= kTileVecs) {
#pragma unroll
    for (int k = 0; k < kVecs; ++k)
      v[k] = load_stream(src + k * kThreads + threadIdx.x);
#pragma unroll
    for (int k = 0; k < kVecs; ++k)
      store_stream(dst + k * kThreads + threadIdx.x, probe_fn4<MODE>(v[k]));
    return;
  }
  const int have = left > 0 ? (int)left : 0;
#pragma unroll
  for (int k = 0; k < kVecs; ++k)
    if (k * kThreads + (int)threadIdx.x < have)
      v[k] = load_stream(src + k * kThreads + threadIdx.x);
#pragma unroll
  for (int k = 0; k < kVecs; ++k)
    if (k * kThreads + (int)threadIdx.x < have)
      store_stream(dst + k * kThreads + threadIdx.x, probe_fn4<MODE>(v[k]));
  tail<MODE>(x, y, n);
}

template <int MODE>
cudaError_t launch(const float* x, float* y, long long n,
                   cudaStream_t stream) {
  const long long blocks = (n + kTileFloats - 1) / kTileFloats;
  if (blocks > 0x7fffffffll) return cudaErrorInvalidValue;
  exp2_probe_kernel<MODE><<<(unsigned)blocks, kThreads, 0, stream>>>(x, y, n);
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
  const float* in = static_cast<const float*>(x);
  float* out = static_cast<float*>(y);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case 0: return (int)launch<0>(in, out, n, st);
    case 1: return (int)launch<1>(in, out, n, st);
    case 4: return (int)launch<4>(in, out, n, st);
    case 5: return (int)launch<5>(in, out, n, st);
    case 6: return (int)launch<6>(in, out, n, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The warp-gather probes for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the Pallas gathers of the TPU probes benchmarks/gather_probe.py
// (build_a / build_b / build_c), benchmarks/gather_probe2.py (build_b2,
// build_f) and benchmarks/gather_probe3.py (build_p4 / p5 / p6), which ask
// what a per-element gather costs, the cost of the augmentation warp (8.4 M
// gathered elements per batch at N128 256^2). One float32 kernel, three
// modes, over a batch of N images of (R, C) and an int32 index of (IR, IC):
//   0 flat   out[n, i, j] = src[n].flat[idx[i, j]]      (jnp.take of the
//            image flattened; builder A)
//   1 rows   out[n, i, j] = src[n, idx[i, j], j]         (take_along_axis,
//            axis 0 of the image; B, B2, F, P4, P5; IC == C)
//   2 cols   out[n, i, j] = src[n, i, idx[i, j]]         (axis 1; C, P6;
//            IR == R)
// The index is shared by every image (idx_stride 0, builders A-C and B2) or
// has one plane per image (idx_stride IR * IC). Out-of-range indices follow
// JAX's default gather mode: k in [-len, -1] wraps to k + len, any other k
// outside [0, len) gives NaN (0x7fc00000); `promise_in_bounds` leaves them
// unspecified, so the same rule serves every builder.
//
// What bounds it on an H100 (3.35 TB/s): the bytes. At the probes' N128
// 256^2 a call moves 33.6 MB of src, 33.6 MB of out and, with a shared
// index, 0.26 MB of index: 0.0201 ms. The TPU kernels' (1, H, W) VMEM blocks
// existed for the TPU's vector memory; here a thread owns four neighbouring
// index elements, reads them once as one 16-byte load through the read-only
// path, and walks over a chunk of the images with the four offsets in
// registers (a shared index is read once per chunk, not once per image),
// storing 16 bytes per image. The gathered loads themselves are 4-byte
// loads at data-dependent addresses: a rotation's rows fall on few cache
// lines, so their sectors are mostly reused from L1 / L2. Where IR * IC is
// not a multiple of 4 (or a pointer is not 16-byte aligned) a thread takes
// one element.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr unsigned kNaN = 0x7fc00000u;

// the offset of index value k (at index element e = i * ic + j) inside one
// image, or -1 where k is out of range
template <int MODE>
__device__ __forceinline__ int offset(int k, int e, int r, int c, int ic) {
  const int len = MODE == 0 ? r * c : MODE == 1 ? r : c;
  if (k < 0) k += len;
  if ((unsigned)k >= (unsigned)len) return -1;
  if (MODE == 0) return k;
  if (MODE == 1) return k * c + e % ic;
  return (e / ic) * c + k;
}

__device__ __forceinline__ float fetch(const float* __restrict__ img,
                                       int off) {
  return off >= 0 ? __ldg(img + off) : __uint_as_float(kNaN);
}

// VEC: four index elements a thread (IR * IC % 4 == 0, 16-byte aligned
// index and output); SHARED: one index plane for every image
template <int MODE, bool VEC, bool SHARED>
__global__ void __launch_bounds__(kThreads)
gather_kernel(const float* __restrict__ src, const int* __restrict__ idx,
              float* __restrict__ out, int n, int r, int c, int ir, int ic,
              int images_per_block) {
  constexpr int E = VEC ? 4 : 1;
  const long long m = (long long)ir * ic;   // index elements an image
  const long long rc = (long long)r * c;
  const long long e0 = ((long long)blockIdx.x * kThreads + threadIdx.x) * E;
  if (e0 >= m) return;
  const int n0 = blockIdx.y * images_per_block;
  const int n1 = min(n, n0 + images_per_block);
  int off[E];
  auto load_offsets = [&](const int* plane) {
    if constexpr (VEC) {
      const int4 k = __ldg(reinterpret_cast<const int4*>(plane + e0));
      off[0] = offset<MODE>(k.x, (int)e0, r, c, ic);
      off[1] = offset<MODE>(k.y, (int)e0 + 1, r, c, ic);
      off[2] = offset<MODE>(k.z, (int)e0 + 2, r, c, ic);
      off[3] = offset<MODE>(k.w, (int)e0 + 3, r, c, ic);
    } else {
      off[0] = offset<MODE>(__ldg(plane + e0), (int)e0, r, c, ic);
    }
  };
  if constexpr (SHARED) load_offsets(idx);
#pragma unroll 2
  for (int b = n0; b < n1; ++b) {
    if constexpr (!SHARED) load_offsets(idx + b * m);
    const float* img = src + b * rc;
    float* dst = out + b * m + e0;
    if constexpr (VEC) {
      *reinterpret_cast<float4*>(dst) =
          make_float4(fetch(img, off[0]), fetch(img, off[1]),
                      fetch(img, off[2]), fetch(img, off[3]));
    } else {
      *dst = fetch(img, off[0]);
    }
  }
}

template <int MODE>
cudaError_t launch(const float* src, const int* idx, float* out, int n,
                   int r, int c, int ir, int ic, bool shared, bool vec,
                   int sms, cudaStream_t stream) {
  const long long m = (long long)ir * ic;
  const long long units = vec ? m / 4 : m;
  const unsigned bx = (unsigned)((units + kThreads - 1) / kThreads);
  // as many images a thread as keep about one wave of threads on the card
  // (2048 a SM): fewer where the index plane alone fills it
  const long long wave = (long long)sms * 2048;
  long long per = (units * n + wave - 1) / wave;
  const long long least = (n + 65534) / 65535;  // gridDim.y <= 65535
  per = per < least ? least : per > n ? n : per;
  const unsigned by = (unsigned)((n + per - 1) / per);
  const dim3 grid(bx, by);
#define DDTI_GATHER(V, S)                                              \
  gather_kernel<MODE, V, S><<<grid, kThreads, 0, stream>>>(            \
      src, idx, out, n, r, c, ir, ic, (int)per)
  if (vec && shared) DDTI_GATHER(true, true);
  else if (vec) DDTI_GATHER(true, false);
  else if (shared) DDTI_GATHER(false, true);
  else DDTI_GATHER(false, false);
#undef DDTI_GATHER
  return cudaGetLastError();
}

}  // namespace

// src: (n, r, c) float32, contiguous; idx: int32, contiguous, one (ir, ic)
// plane (idx_shared != 0) or n of them; out: (n, ir, ic) float32. mode 0
// (flat), 1 (along rows: ic == c) or 2 (along columns: ir == r). r * c and
// n * ir * ic below 2^31. Launches on `stream` without synchronising and
// returns the launch's cudaError_t (0 = success).
extern "C" int ddti_gather_probe(const void* src, const void* idx, void* out,
                                 int n, int r, int c, int ir, int ic,
                                 int idx_shared, int mode, int device,
                                 void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n <= 0 || r <= 0 || c <= 0 || ir <= 0 || ic <= 0 ||
      (long long)r * c >= (1ll << 31) ||
      (long long)n * ir * ic >= (1ll << 31) ||
      (mode == 1 && ic != c) || (mode == 2 && ir != r))
    return (int)cudaErrorInvalidValue;
  int sms;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    device)))
    return (int)err;
  const bool vec = ((long long)ir * ic) % 4 == 0 &&
                   (reinterpret_cast<uintptr_t>(idx) & 15) == 0 &&
                   (reinterpret_cast<uintptr_t>(out) & 15) == 0;
  const float* s = static_cast<const float*>(src);
  const int* i = static_cast<const int*>(idx);
  float* o = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case 0: return (int)launch<0>(s, i, o, n, r, c, ir, ic, idx_shared, vec,
                                  sms, st);
    case 1: return (int)launch<1>(s, i, o, n, r, c, ir, ic, idx_shared, vec,
                                  sms, st);
    case 2: return (int)launch<2>(s, i, o, n, r, c, ir, ic, idx_shared, vec,
                                  sms, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

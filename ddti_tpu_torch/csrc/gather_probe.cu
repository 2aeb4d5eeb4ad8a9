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
// existed for the TPU's vector memory. Here:
//  - The flat and row modes (tiled_gather_kernel) give a block a 64 x 64
//    tile of the output for a chunk of images. It reads its index tile once
//    (one plane for the chunk where the index is shared) and reduces the
//    tile's in-range source positions to a window: rows [rlo, rhi], and in
//    flat mode columns (k % C) too, rounded out to 16 bytes; in row mode
//    the tile's own columns. A rotation's tile reads a small window (about
//    80 x 80 floats at theta = 0.3), where a warp's 32 gathers along a
//    rotated output row touch ~32 sectors of ~10 source rows. Where the
//    window fits kStageCap (and rows are 16-byte aligned), the block copies
//    it once per image into shared memory with coalesced 16-byte cp.async
//    (one bulk copy a window row was slower on an H100: 0.0417 against
//    0.0396 ms at builder A), and gathers from there; a lane owns one
//    output column, so in row mode the reads hit distinct banks, and the
//    stores are coalesced rows. Otherwise (a scattering
//    index, such as builder F's random rows) the tile takes the direct
//    path: the same gathers from global memory through the read-only path.
//    The choice is the data's, tile by tile; ddti_tpu_torch/probes/
//    gather_probe.py:plan_windows computes it on the host, and a non-null
//    `staged` pointer makes the kernel count its staged (tile, image) pairs
//    there. Each block takes kBufs - 1 windows ahead of the one it
//    gathers, and the grid is one wave: a block takes as many images as
//    leave none waiting for a slot.
//  - The column mode, and flat and row calls of fewer tiles than the card
//    has SMs (builders F, P4, P5: one image; a window reused by no other
//    image would only add a round trip), take the per-element path
//    (gather_kernel): a thread owns four neighbouring index elements,
//    reads them once as one 16-byte load, and walks over a chunk of the
//    images with the four offsets in registers (a shared index is read
//    once per chunk), storing 16 bytes per image. Where IR * IC is not a
//    multiple of 4 (or a pointer is not 16-byte aligned) a thread takes
//    one element. In the column mode a warp's gathers stay in one source
//    row.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "sm90.cuh"  // set_smem_once

namespace {

constexpr int kThreads = 256;
constexpr unsigned kNaN = 0x7fc00000u;

// ---------------------------------------------------------------------------
// the per-element path: every column-mode call, and flat and row calls of
// fewer tiles than the card has SMs

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
                   int r, int c, int ir, int ic, bool shared, int sms,
                   cudaStream_t stream) {
  const long long m = (long long)ir * ic;
  const bool vec = m % 4 == 0 &&
                   (reinterpret_cast<uintptr_t>(idx) & 15) == 0 &&
                   (reinterpret_cast<uintptr_t>(out) & 15) == 0;
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

// ---------------------------------------------------------------------------
// flat and row modes: 64 x 64 output tiles, source windows staged in shared
// memory

constexpr int kTile = 64;
constexpr int kTileThreads = 256;                        // 64 columns x 4
constexpr int kPer = kTile * kTile / kTileThreads;       // rows a thread
constexpr int kStageCap = 32768;  // bytes of one window
constexpr int kBufs = 3;          // windows in flight: the next kBufs - 1
constexpr int kPosInvalid = -2;   // outside the index plane: nothing stored

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// a tile's source window, and whether the tile gathers from it staged
struct Window {
  int rlo, clo, rows, cols;  // cols: floats a window row, a multiple of 4
  bool staged;
};

// Reads the tile's index elements from `plane` (thread (row0, col) holds
// rows row0 + 4 q of column col) and plans the window: every thread gets
// the same answer (one __syncthreads inside; `red` is 4 x 8 ints of shared
// scratch). off[q]: the element's offset into the window where the tile
// stages, into the image otherwise; -1 an index out of range (NaN),
// kPosInvalid a position past the plane's edge.
template <int MODE>
__device__ __forceinline__ Window plan_tile(const int* __restrict__ plane,
                                            int (&off)[kPer], int i0, int j0,
                                            int r, int c, int ir, int ic,
                                            bool stage_ok, int* red) {
  const int col = threadIdx.x % kTile, row0 = threadIdx.x / kTile;
  const int j = j0 + col;
  const int len = MODE == 0 ? r * c : r;
  int rlo = INT_MAX, rhi = INT_MIN, clo = INT_MAX, chi = INT_MIN;
  int sr[kPer], sc[kPer];
#pragma unroll
  for (int q = 0; q < kPer; ++q) {
    const int i = i0 + row0 + 4 * q;
    off[q] = kPosInvalid;
    if (i >= ir || j >= ic) continue;
    int k = __ldg(plane + (long long)i * ic + j);
    if (k < 0) k += len;
    if ((unsigned)k >= (unsigned)len) {
      off[q] = -1;
      continue;
    }
    sr[q] = MODE == 0 ? k / c : k;
    sc[q] = MODE == 0 ? k % c : j;
    off[q] = 0;
    rlo = min(rlo, sr[q]);
    rhi = max(rhi, sr[q]);
    clo = min(clo, sc[q]);
    chi = max(chi, sc[q]);
  }
  rlo = __reduce_min_sync(0xffffffffu, rlo);
  rhi = __reduce_max_sync(0xffffffffu, rhi);
  clo = __reduce_min_sync(0xffffffffu, clo);
  chi = __reduce_max_sync(0xffffffffu, chi);
  const int warp = threadIdx.x / 32;
  if (threadIdx.x % 32 == 0) {
    red[warp] = rlo;
    red[8 + warp] = rhi;
    red[16 + warp] = clo;
    red[24 + warp] = chi;
  }
  __syncthreads();
#pragma unroll
  for (int v = 0; v < kTileThreads / 32; ++v) {
    rlo = min(rlo, red[v]);
    rhi = max(rhi, red[8 + v]);
    clo = min(clo, red[16 + v]);
    chi = max(chi, red[24 + v]);
  }
  Window win;
  if (MODE == 1) {  // the tile's own columns
    clo = j0;
    chi = min(j0 + kTile, ic) - 1;
  }
  win.rlo = rlo;
  win.clo = clo & ~3;
  win.rows = rhi >= rlo ? rhi - rlo + 1 : 0;
  win.cols = rhi >= rlo ? ((chi | 3) + 1) - win.clo : 0;
  win.staged = stage_ok && (long long)win.rows * win.cols * 4 <= kStageCap;
#pragma unroll
  for (int q = 0; q < kPer; ++q)
    if (off[q] == 0)
      off[q] = win.staged ? (sr[q] - win.rlo) * win.cols + sc[q] - win.clo
                          : sr[q] * c + sc[q];
  return win;
}

// the window of image `img` into `buf`, 16 bytes a cp.async
__device__ __forceinline__ void copy_window(float* buf, const float* img,
                                            const Window& win, int c) {
  const int quads = win.cols / 4, total = win.rows * quads;
  for (int u = threadIdx.x; u < total; u += kTileThreads) {
    const int rr = u / quads, cq = u - rr * quads;
    cp_async16(buf + rr * win.cols + 4 * cq,
               img + (long long)(win.rlo + rr) * c + win.clo + 4 * cq);
  }
}

// the tile's elements of one image: from the staged window `buf`, or
// (buf == nullptr) from the image itself
__device__ __forceinline__ void gather_tile(float* __restrict__ dst,
                                            const float* __restrict__ buf,
                                            const float* __restrict__ img,
                                            const int (&off)[kPer], int i0,
                                            int j0, int ic) {
  const int col = threadIdx.x % kTile, row0 = threadIdx.x / kTile;
#pragma unroll
  for (int q = 0; q < kPer; ++q) {
    if (off[q] == kPosInvalid) continue;
    const float v = off[q] < 0 ? __uint_as_float(kNaN)
                    : buf     ? buf[off[q]]
                              : __ldg(img + off[q]);
    dst[(long long)(i0 + row0 + 4 * q) * ic + j0 + col] = v;
  }
}

// MODE 0 (flat) or 1 (rows); grid (tiles of the index plane, chunks of
// images_per_block images)
template <int MODE, bool SHARED>
__global__ void __launch_bounds__(kTileThreads)
tiled_gather_kernel(const float* __restrict__ src, const int* __restrict__ idx,
                    float* __restrict__ out, unsigned long long* staged,
                    int n, int r, int c, int ir, int ic, int images_per_block,
                    bool stage_ok) {
  extern __shared__ __align__(16) float bufs[];  // kBufs x kStageCap bytes
  __shared__ int red[32];
  const int tiles_c = (ic + kTile - 1) / kTile;
  const int i0 = blockIdx.x / tiles_c * kTile;
  const int j0 = blockIdx.x % tiles_c * kTile;
  const int n0 = blockIdx.y * images_per_block;
  const int n1 = min(n, n0 + images_per_block);
  const long long m = (long long)ir * ic, rc = (long long)r * c;
  auto buf = [&](int b) { return bufs + (b - n0) % kBufs * (kStageCap / 4); };
  int off[kPer];
  unsigned long long count = 0;
  if constexpr (SHARED) {
    const Window win = plan_tile<MODE>(idx, off, i0, j0, r, c, ir, ic,
                                       stage_ok, red);
    if (win.staged) {
      count = n1 - n0;
      for (int b = n0; b < n0 + kBufs - 1; ++b) {
        if (b < n1) copy_window(buf(b), src + b * rc, win, c);
        cp_async_commit();
      }
    }
    for (int b = n0; b < n1; ++b) {
      if (win.staged) {
        // later images' windows land while this one is gathered
        const int ahead = b + kBufs - 1;
        if (ahead < n1) copy_window(buf(ahead), src + ahead * rc, win, c);
        cp_async_commit();
        cp_async_wait<kBufs - 1>();
        __syncthreads();
        gather_tile(out + b * m, buf(b), nullptr, off, i0, j0, ic);
        __syncthreads();  // the buffer is free for image b + kBufs
      } else {
        gather_tile(out + b * m, nullptr, src + b * rc, off, i0, j0, ic);
      }
    }
  } else {
    for (int b = n0; b < n1; ++b) {
      const Window win = plan_tile<MODE>(idx + b * m, off, i0, j0, r, c, ir,
                                         ic, stage_ok, red);
      if (win.staged) {
        ++count;
        copy_window(bufs, src + b * rc, win, c);
        cp_async_commit();
        cp_async_wait<0>();
        __syncthreads();
        gather_tile(out + b * m, bufs, nullptr, off, i0, j0, ic);
      } else {
        gather_tile(out + b * m, nullptr, src + b * rc, off, i0, j0, ic);
      }
      __syncthreads();  // red and the buffer are free for the next image
    }
  }
  if (staged && threadIdx.x == 0 && count) atomicAdd(staged, count);
}

template <int MODE, bool SHARED>
cudaError_t launch_tiled_kernel(const float* src, const int* idx, float* out,
                                unsigned long long* staged, int n, int r,
                                int c, int ir, int ic, long long tiles,
                                int sms, cudaStream_t stream) {
  const auto kernel = tiled_gather_kernel<MODE, SHARED>;
  constexpr size_t smem = kBufs * kStageCap;
  static std::atomic<uint64_t> smem_set{0};
  cudaError_t err;
  if ((err = set_smem_once(kernel, smem, smem_set))) return err;
  // one wave: as many images a block as leave no block waiting for a slot
  static int fit = 0;
  if (!fit && (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                   &fit, kernel, kTileThreads, smem)))
    return err;
  const long long wave = (long long)(fit > 0 ? fit : 1) * sms;
  long long per = (tiles * n + wave - 1) / wave;
  const long long least = (n + 65534) / 65535;  // gridDim.y <= 65535
  per = per < least ? least : per > n ? n : per;
  // whole 16-byte quads of a source row, from a 16-byte aligned image
  const bool stage_ok =
      c % 4 == 0 && (reinterpret_cast<uintptr_t>(src) & 15) == 0;
  kernel<<<dim3((unsigned)tiles, (unsigned)((n + per - 1) / per)),
           kTileThreads, smem, stream>>>(src, idx, out, staged, n, r, c, ir,
                                         ic, (int)per, stage_ok);
  return cudaGetLastError();
}

// the flat and row modes: tiled where the call has at least one tile a SM
// (a smaller call reuses no window and would leave SMs idle), else the
// per-element path
template <int MODE>
cudaError_t launch_tiled(const float* src, const int* idx, float* out,
                         unsigned long long* staged, int n, int r, int c,
                         int ir, int ic, bool shared, int sms,
                         cudaStream_t stream) {
  const long long tiles = (long long)((ir + kTile - 1) / kTile) *
                          ((ic + kTile - 1) / kTile);
  if (tiles * n < sms)
    return launch<MODE>(src, idx, out, n, r, c, ir, ic, shared, sms, stream);
  return shared ? launch_tiled_kernel<MODE, true>(src, idx, out, staged, n,
                                                  r, c, ir, ic, tiles, sms,
                                                  stream)
                : launch_tiled_kernel<MODE, false>(src, idx, out, staged, n,
                                                   r, c, ir, ic, tiles, sms,
                                                   stream);
}

}  // namespace

// src: (n, r, c) float32, contiguous; idx: int32, contiguous, one (ir, ic)
// plane (idx_shared != 0) or n of them; out: (n, ir, ic) float32. mode 0
// (flat), 1 (along rows: ic == c) or 2 (along columns: ir == r). r * c and
// n * ir * ic below 2^31. `staged`: null, or a device counter to which the
// flat and row modes add the (tile, image) pairs they gathered from a
// staged window. Launches on `stream` without synchronising and returns the
// launch's cudaError_t (0 = success).
extern "C" int ddti_gather_probe(const void* src, const void* idx, void* out,
                                 void* staged, int n, int r, int c, int ir,
                                 int ic, int idx_shared, int mode, int device,
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
  const float* s = static_cast<const float*>(src);
  const int* i = static_cast<const int*>(idx);
  float* o = static_cast<float*>(out);
  unsigned long long* count = static_cast<unsigned long long*>(staged);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case 0: return (int)launch_tiled<0>(s, i, o, count, n, r, c, ir, ic,
                                        idx_shared, sms, st);
    case 1: return (int)launch_tiled<1>(s, i, o, count, n, r, c, ir, ic,
                                        idx_shared, sms, st);
    case 2: return (int)launch<2>(s, i, o, n, r, c, ir, ic, idx_shared,
                                  sms, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Flash-attention forward for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the TPU kernels ddti_tpu/ops/attention.py:_fwd_kernel (one head
// per program) and _fwd_kernel_packed (G = 128/D heads packed on the 128-lane
// axis). The packing only existed to fill the TPU's lane-wide vector
// registers; here a head of any supported width is one (b*h) slice, so both
// TPU forms collapse into this one kernel.
//
// Head widths: every D with D % 8 == 0 and 8 <= D <= 256, which covers the
// JAX model's flash gate (blocks.py: hd % 8 == 0) up to 256. A kernel is
// instantiated for the padded widths DP = 32, 64, 128, 256 and takes the
// actual D at run time: columns D..DP-1 of the staged tiles are zeros, so
// they add nothing to the scores, and they are not written back.
//
// Computes, per (b*h) slice of contiguous (B, H, S, D) q/k/v:
//   o    = softmax(q k^T * D^-1/2) v            (same dtype as q)
//   lse2 = m + log2(l)                          ((B, H, S) float32)
// in the base-2 domain: D^-1/2 * log2(e) is folded into the scores and every
// exponential is exp2f, exactly as the TPU kernels do. Scores, the running
// max m, the running sum l and the output accumulator are float32; the
// probability tile is rounded to the input dtype before the PV product (as
// attention.py:131-133 casts p to v.dtype), while l sums the unrounded p.
//
// What bounds it on an H100: at the TransUNet serving shape (B=16, H=8,
// S=1024, D=32) one layer is 4*B*H*S^2*D = 17.2 GFLOP of products and
// B*H*S^2 = 134 M exp2 against ~34 MB of q/k/v/o in bf16, ~500 FLOP per byte:
// compute- and exp-bound, not memory-bound. The (S, S) score matrix never
// reaches device memory: each block keeps its 64x64 score tile on chip, so
// device traffic is one read of q/k/v per query tile and one write of o.
//
// Design (first versions, right and simple). Both dtypes: one block per
// (64-query tile, b*h slice); K/V tiles of 64 keys staged in shared memory,
// single-buffered; an online-softmax loop over the key tiles inside the
// block takes the place of the TPU's sequential grid axis. Any S is taken:
// the ragged key tile is masked to -inf and ragged query rows are computed
// on zeros and not written.
//  - bf16: the products run on the tensor cores, mma.sync.m16n8k16 with
//    float32 accumulation, in the FlashAttention-2 register layout: each of
//    4 warps owns 16 query rows, keeps its Q fragments and its 16x64 score
//    tile in registers, and reuses the score tile's accumulator layout as the
//    A operand of the PV product. V is staged transposed so that every B
//    fragment is a 32-bit shared-memory load; row strides are padded by 16
//    bytes so that a warp's fragment loads hit 32 distinct banks. What is
//    left bounds it: the single-buffered tile loads and the block barriers
//    around them (cp.async/TMA double-buffering and wgmma are later work).
//  - float32: tensor cores offer no full-precision float32 product, so the
//    products are scalar FMAs. Four threads own each query row: each
//    computes 16 of the row's 64 scores and DP/4 of its output columns; the
//    row's max and sum are reduced with two quad shuffles. Bound by
//    shared-memory loads, about one per FMA.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr double kLog2e = 1.4426950408889634;

// ---------------------------------------------------------------------------
// bfloat16: tensor cores (mma.sync)

constexpr int kMmaThreads = 128;  // 4 warps x 16 query rows

template <int DP>
constexpr size_t mma_smem_bytes() {
  // q and k tiles [64][DP + 8], v transposed [DP][64 + 8], all bf16
  return sizeof(__nv_bfloat16) *
         ((size_t)(kBlockQ + kBlockK) * (DP + 8) + (size_t)DP * (kBlockK + 8));
}

// DP: padded head width (template); D: actual head width, D % 8 == 0, D <= DP
template <int DP>
__global__ void __launch_bounds__(kMmaThreads)
flash_fwd_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                      const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v,
                      __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                      int S, int D, float scale_log2) {
  constexpr int QS = DP + 8;           // q/k tile row stride (bf16)
  constexpr int VS = kBlockK + 8;      // transposed v row stride (bf16)
  constexpr int kSteps = DP / 16;      // k-steps of q k^T
  constexpr int kOutTiles = DP / 8;    // n-tiles of the output
  constexpr int kScoreTiles = kBlockK / 8;
  constexpr int kPvSteps = kBlockK / 16;
  constexpr int kVec = 8;              // bf16 per 16-byte load
  constexpr int kVecPerRow = DP / kVec;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* ks = qs + kBlockQ * QS;
  __nv_bfloat16* vts = ks + kBlockK * QS;

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;  // mma fragment row group, column pair
  const int q0 = blockIdx.x * kBlockQ;
  const size_t base = (size_t)blockIdx.y * S * D;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);

  for (int i = tid; i < kBlockQ * kVecPerRow; i += kMmaThreads) {
    const int r = i / kVecPerRow, c = (i % kVecPerRow) * kVec;
    *reinterpret_cast<uint4*>(qs + r * QS + c) =
        q0 + r < S && c < D ? *reinterpret_cast<const uint4*>(
                                  q + base + (size_t)(q0 + r) * D + c)
                            : zero;
  }
  __syncthreads();

  // this warp's rows warp*16 + g and warp*16 + g + 8, as A fragments
  uint32_t qa[kSteps][4];
  const __nv_bfloat16* qrow = qs + (warp * 16 + g) * QS + t * 2;
#pragma unroll
  for (int kk = 0; kk < kSteps; ++kk) {
    qa[kk][0] = ld32(qrow + kk * 16);
    qa[kk][1] = ld32(qrow + 8 * QS + kk * 16);
    qa[kk][2] = ld32(qrow + kk * 16 + 8);
    qa[kk][3] = ld32(qrow + 8 * QS + kk * 16 + 8);
  }

  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};
  float acc[kOutTiles][4];
#pragma unroll
  for (int n = 0; n < kOutTiles; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  for (int k0 = 0; k0 < S; k0 += kBlockK) {
    __syncthreads();  // the previous tile's ks/vts are fully consumed
    for (int i = tid; i < kBlockK * kVecPerRow; i += kMmaThreads) {
      const int r = i / kVecPerRow, c = (i % kVecPerRow) * kVec;
      uint4 kv = zero, vv = zero;
      if (k0 + r < S && c < D) {
        const size_t off = base + (size_t)(k0 + r) * D + c;
        kv = *reinterpret_cast<const uint4*>(k + off);
        vv = *reinterpret_cast<const uint4*>(v + off);
      }
      *reinterpret_cast<uint4*>(ks + r * QS + c) = kv;
      const __nv_bfloat16* ve = reinterpret_cast<const __nv_bfloat16*>(&vv);
#pragma unroll
      for (int j = 0; j < kVec; ++j) vts[(c + j) * VS + r] = ve[j];
    }
    __syncthreads();

    // scores: 16 rows x 64 keys per warp, in 8 accumulator tiles
    float s[kScoreTiles][4];
#pragma unroll
    for (int n = 0; n < kScoreTiles; ++n) {
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
      const __nv_bfloat16* krow = ks + (n * 8 + g) * QS + t * 2;
#pragma unroll
      for (int kk = 0; kk < kSteps; ++kk)
        mma_16816(s[n], qa[kk], ld32(krow + kk * 16), ld32(krow + kk * 16 + 8));
    }

    // online softmax; element e of a tile is row g + 8*(e >> 1),
    // column n*8 + 2t + (e & 1)
    float tile_max[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < kScoreTiles; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + n * 8 + t * 2 + (e & 1);
        s[n][e] = col < S ? s[n][e] * scale_log2 : -INFINITY;
        tile_max[e >> 1] = fmaxf(tile_max[e >> 1], s[n][e]);
      }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      tile_max[r] = fmaxf(tile_max[r],
                          __shfl_xor_sync(0xffffffffu, tile_max[r], 1));
      tile_max[r] = fmaxf(tile_max[r],
                          __shfl_xor_sync(0xffffffffu, tile_max[r], 2));
      // every tile holds at least one valid key, so the new max is finite
      const float m_new = fmaxf(m[r], tile_max[r]);
      alpha[r] = exp2f(m[r] - m_new);
      m[r] = m_new;
    }

    // p in bf16, laid out as the A fragments of the PV product: score tiles
    // 2j and 2j+1 form k-step j
    uint32_t pa[kPvSteps][4];
    float tile_sum[2] = {0.f, 0.f};
#pragma unroll
    for (int n = 0; n < kScoreTiles; ++n) {
      const float p0 = exp2f(s[n][0] - m[0]), p1 = exp2f(s[n][1] - m[0]);
      const float p2 = exp2f(s[n][2] - m[1]), p3 = exp2f(s[n][3] - m[1]);
      tile_sum[0] += p0 + p1;
      tile_sum[1] += p2 + p3;
      pa[n >> 1][(n & 1) * 2] = pack_bf16(p0, p1);
      pa[n >> 1][(n & 1) * 2 + 1] = pack_bf16(p2, p3);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      tile_sum[r] += __shfl_xor_sync(0xffffffffu, tile_sum[r], 1);
      tile_sum[r] += __shfl_xor_sync(0xffffffffu, tile_sum[r], 2);
      l[r] = l[r] * alpha[r] + tile_sum[r];
    }

#pragma unroll
    for (int n = 0; n < kOutTiles; ++n) {
      acc[n][0] *= alpha[0];
      acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1];
      acc[n][3] *= alpha[1];
      const __nv_bfloat16* vrow = vts + (n * 8 + g) * VS + t * 2;
#pragma unroll
      for (int j = 0; j < kPvSteps; ++j)
        mma_16816(acc[n], pa[j], ld32(vrow + j * 16), ld32(vrow + j * 16 + 8));
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int gr = q0 + warp * 16 + g + 8 * r;
    if (gr >= S) continue;
    const float inv_l = 1.f / l[r];
    __nv_bfloat16* orow = o + base + (size_t)gr * D + t * 2;
#pragma unroll
    for (int n = 0; n < kOutTiles; ++n)
      if (n * 8 < D)
        *reinterpret_cast<uint32_t*>(orow + n * 8) =
            pack_bf16(acc[n][2 * r] * inv_l, acc[n][2 * r + 1] * inv_l);
    if (t == 0) lse[(size_t)blockIdx.y * S + gr] = m[r] + log2f(l[r]);
  }
}

// ---------------------------------------------------------------------------
// float32: scalar FMAs

constexpr int kFmaThreads = 256;  // 4 threads per query row

template <int DP>
constexpr size_t fma_smem_bytes() {
  // q, k, v tiles with row stride DP+1, and the probability tile with row
  // stride kBlockK+1, all float32 (DP = 256: 209 KiB of the 227 KiB a block
  // may hold)
  return sizeof(float) * ((size_t)(kBlockQ + 2 * kBlockK) * (DP + 1) +
                          (size_t)kBlockQ * (kBlockK + 1));
}

// DP: padded head width (template); D: actual head width, D % 8 == 0, D <= DP
template <int DP>
__global__ void __launch_bounds__(kFmaThreads)
flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o,
                     float* __restrict__ lse, int S, int D, float scale_log2) {
  constexpr int RS = DP + 1;       // q/k/v tile row stride (float32)
  constexpr int BKP = kBlockK + 1;
  constexpr int kColsPerThread = kBlockK / 4;
  constexpr int kDimsPerThread = DP / 4;

  extern __shared__ float smem[];
  float* qs = smem;                // [kBlockQ][RS]
  float* ks = qs + kBlockQ * RS;   // [kBlockK][RS]
  float* vs = ks + kBlockK * RS;   // [kBlockK][RS]
  float* ps = vs + kBlockK * RS;   // [kBlockQ][BKP]

  const int tid = threadIdx.x;
  const int row = tid >> 2;   // query row inside the tile
  const int quad = tid & 3;   // this thread's lane in the row's quad
  const int q0 = blockIdx.x * kBlockQ;
  const size_t base = (size_t)blockIdx.y * S * D;

  for (int i = tid; i < kBlockQ * DP; i += kFmaThreads) {
    const int r = i / DP, c = i % DP;
    const int gr = q0 + r;
    qs[r * RS + c] = gr < S && c < D ? q[base + (size_t)gr * D + c] : 0.f;
  }

  float m = -INFINITY;
  float l = 0.f;
  float acc[kDimsPerThread];
#pragma unroll
  for (int j = 0; j < kDimsPerThread; ++j) acc[j] = 0.f;

  for (int k0 = 0; k0 < S; k0 += kBlockK) {
    __syncthreads();  // the previous tile's ks/vs/ps are fully consumed
    for (int i = tid; i < kBlockK * DP; i += kFmaThreads) {
      const int r = i / DP, c = i % DP;
      const int gr = k0 + r;
      const size_t off = base + (size_t)gr * D + c;
      const bool ok = gr < S && c < D;
      ks[r * RS + c] = ok ? k[off] : 0.f;
      vs[r * RS + c] = ok ? v[off] : 0.f;
    }
    __syncthreads();

    // scores for columns quad, quad+4, ..., quad+60 of this tile
    float s[kColsPerThread];
#pragma unroll
    for (int j = 0; j < kColsPerThread; ++j) s[j] = 0.f;
    const float* qrow = qs + row * RS;
#pragma unroll 4
    for (int d = 0; d < DP; ++d) {
      const float qd = qrow[d];
#pragma unroll
      for (int j = 0; j < kColsPerThread; ++j)
        s[j] = fmaf(qd, ks[(quad + 4 * j) * RS + d], s[j]);
    }

    float tile_max = -INFINITY;
#pragma unroll
    for (int j = 0; j < kColsPerThread; ++j) {
      const int col = k0 + quad + 4 * j;
      s[j] = col < S ? s[j] * scale_log2 : -INFINITY;
      tile_max = fmaxf(tile_max, s[j]);
    }
    tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, 1));
    tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, 2));
    // every tile holds at least one valid key, so m_new is finite
    const float m_new = fmaxf(m, tile_max);
    const float alpha = exp2f(m - m_new);
    float tile_sum = 0.f;
    float* prow = ps + row * BKP;
#pragma unroll
    for (int j = 0; j < kColsPerThread; ++j) {
      const float p = exp2f(s[j] - m_new);
      tile_sum += p;
      prow[quad + 4 * j] = p;
    }
    tile_sum += __shfl_xor_sync(0xffffffffu, tile_sum, 1);
    tile_sum += __shfl_xor_sync(0xffffffffu, tile_sum, 2);
    l = l * alpha + tile_sum;
    m = m_new;
#pragma unroll
    for (int j = 0; j < kDimsPerThread; ++j) acc[j] *= alpha;
    // a row's probabilities are written and read by the same quad, which
    // lies inside one warp
    __syncwarp();

#pragma unroll 4
    for (int c = 0; c < kBlockK; ++c) {
      const float p = prow[c];
      const float* vrow = vs + c * RS;
#pragma unroll
      for (int j = 0; j < kDimsPerThread; ++j)
        acc[j] = fmaf(p, vrow[quad + 4 * j], acc[j]);
    }
  }

  const int gr = q0 + row;
  if (gr < S) {
    const float inv_l = 1.f / l;
    float* orow = o + base + (size_t)gr * D;
#pragma unroll
    for (int j = 0; j < kDimsPerThread; ++j)
      if (quad + 4 * j < D) orow[quad + 4 * j] = acc[j] * inv_l;
    if (quad == 0) lse[(size_t)blockIdx.y * S + gr] = m + log2f(l);
  }
}

// ---------------------------------------------------------------------------
// launch

template <int DP>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   void* lse, int bh, int s, int d, bool bf16,
                   cudaStream_t stream) {
  const float scale_log2 = (float)(kLog2e / sqrt((double)d));
  const dim3 grid((s + kBlockQ - 1) / kBlockQ, bh);
  cudaError_t err;
  if (bf16) {
    constexpr size_t smem = mma_smem_bytes<DP>();
    err = cudaFuncSetAttribute(flash_fwd_bf16_kernel<DP>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return err;
    flash_fwd_bf16_kernel<DP><<<grid, kMmaThreads, smem, stream>>>(
        static_cast<const __nv_bfloat16*>(q),
        static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v),
        static_cast<__nv_bfloat16*>(o), static_cast<float*>(lse), s, d,
        scale_log2);
  } else {
    constexpr size_t smem = fma_smem_bytes<DP>();
    err = cudaFuncSetAttribute(flash_fwd_f32_kernel<DP>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return err;
    flash_fwd_f32_kernel<DP><<<grid, kFmaThreads, smem, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(o),
        static_cast<float*>(lse), s, d, scale_log2);
  }
  return cudaGetLastError();
}

}  // namespace

// q, k, v, o: contiguous (bh, s, d) device arrays of float32 (is_bf16 == 0)
// or bfloat16 (is_bf16 == 1), 16-byte aligned, d % 8 == 0 and 8 <= d <= 256;
// lse: (bh, s) float32.
// Launches on `stream` without synchronising and returns the launch's
// cudaError_t (0 = success).
extern "C" int ddti_flash_fwd(const void* q, const void* k, const void* v,
                              void* o, void* lse, int bh, int s, int d,
                              int is_bf16, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (bh <= 0 || bh > 65535 || s <= 0 || d < 8 || d > 256 || d % 8)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool bf16 = is_bf16 != 0;
  if (d <= 32) return (int)launch<32>(q, k, v, o, lse, bh, s, d, bf16, st);
  if (d <= 64) return (int)launch<64>(q, k, v, o, lse, bh, s, d, bf16, st);
  if (d <= 128) return (int)launch<128>(q, k, v, o, lse, bh, s, d, bf16, st);
  return (int)launch<256>(q, k, v, o, lse, bh, s, d, bf16, st);
}

// Flash-attention backward for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the TPU kernels of ddti_tpu/ops/attention.py:
//   _dkdv_kernel and _dkdv_kernel_packed -> flash_bwd_dkdv_*_kernel
//   _dq_kernel and _dq_kernel_packed     -> flash_bwd_dq_*_kernel
// and the per-tile delta = rowsum(dO * O) both TPU kernels compute inline ->
// flash_bwd_delta_kernel, a pre-pass. The head packing of the *_packed forms
// only existed to fill the TPU's 128-lane vector registers; here a head of
// any supported width is one (b*h) slice, so each TPU pair is one kernel.
//
// Per (b*h) slice of contiguous (B, H, S, D) q/k/v/o/dO, with lse2 the
// forward's base-2 logsumexp ((B, H, S) float32), c = D^-1/2 * log2(e):
//   delta = sum_d dO * O                              (float32)
//   P     = exp2(q k^T * c - lse2)                    (float32, recomputed)
//   dV    = P^T dO                                    (P rounded to dO's dtype)
//   dS    = P * (dO v^T - delta)                      (float32)
//   dK    = D^-1/2 * dS^T q,  dQ = D^-1/2 * dS k      (dS rounded to q's dtype)
// with float32 accumulation and outputs in the input dtype, as the TPU
// kernels do. dQ has its own kernel (no atomics): every output element is
// summed by one thread in a fixed order, so the result does not depend on
// block scheduling.
//
// Head widths: every D with D % 8 == 0 and 8 <= D <= 128, instantiated for
// the padded widths DP = 32, 64, 128 with the actual D at run time (columns
// D..DP-1 of the staged tiles are zeros and are not written back). Wider
// heads are refused: a warp keeps its 16 rows of dK and dV (2 * DP float32
// accumulators per thread in bf16) in registers, which run out past 128.
//
// What bounds it on an H100: at the TransUNet training shape (B=16, H=8,
// S=1024, D=32) dK/dV does four (S, S, D) products per (b*h), 34 GFLOP,
// plus B*H*S^2 = 134 M exp2; dQ three products, 26 GFLOP, and the same
// exp2 count again. Against ~40 MB of q/k/v/o/dO traffic that is compute-
// and exp-bound, not memory-bound. Neither kernel writes an (S, S) tile to
// device memory.
//
// Design (first versions, right and simple):
//  - bf16: products on the tensor cores, mma.sync.m16n8k16 with float32
//    accumulation. dK/dV: one block per (64-key tile, b*h), 4 warps of 16
//    keys; K/V stay in shared memory and each warp computes its transposed
//    score tile s^T = K q^T (16 keys x 64 queries), so P^T and dS^T come out
//    in the accumulator layout that is the A operand of dV += P^T dO and
//    dK += dS^T q. The query tile is staged twice, row-major (B operand of
//    the score and dP products) and transposed (B operand of the dK/dV
//    products), with dO likewise. dQ: one block per (64-query tile, b*h),
//    4 warps of 16 queries, K staged row-major and transposed. Row strides
//    are padded by 16 bytes so a warp's fragment loads hit 32 distinct
//    banks. Single-buffered tile loads with block barriers, as in the
//    forward (cp.async/TMA pipelining and wgmma are later work).
//  - float32: scalar FMAs (tensor cores have no full float32 product). Four
//    threads own each row of the block's tile; each computes 16 of the
//    row's 64 scores and DP/4 of its output columns; the row's P or dS tile
//    passes through shared memory within the quad's warp.
//  - Ragged S is masked in the kernels: query rows past S get lse2 = +inf
//    (so P = 0) and zero dO, key columns past S are masked in dQ, and rows
//    past S are not written.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr double kLog2e = 1.4426950408889634;
constexpr int kMmaThreads = 128;  // 4 warps x 16 rows
constexpr int kFmaThreads = 256;  // 4 threads per row
constexpr int kDeltaThreads = 256;
typedef __nv_bfloat16 bf16;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }

// ---------------------------------------------------------------------------
// delta = rowsum(dO * O): one warp per row

template <typename T>
__global__ void __launch_bounds__(kDeltaThreads)
flash_bwd_delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                       float* __restrict__ delta, size_t rows, int D) {
  const size_t row =
      ((size_t)blockIdx.x * kDeltaThreads + threadIdx.x) / 32;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;  // the whole warp leaves together
  const size_t base = row * D;
  float acc = 0.f;
  for (int c = lane; c < D; c += 32)
    acc = fmaf(to_f32(dout[base + c]), to_f32(o[base + c]), acc);
#pragma unroll
  for (int off = 16; off; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) delta[row] = acc;
}

// ---------------------------------------------------------------------------
// bfloat16: tensor cores (mma.sync)

// Stage rows [r0, r0 + 64) of a (S, D) bf16 slice as a row-major [64][DP+8]
// tile and, when `tr` is given, also transposed as [DP][64+8]; rows past S
// and columns past D are zeros.
template <int DP>
__device__ __forceinline__ void stage_bf16(const bf16* __restrict__ src,
                                           int r0, int S, int D, bf16* rm,
                                           bf16* tr) {
  constexpr int RS = DP + 8, TS = kBlockQ + 8, kVec = 8;
  constexpr int kVecPerRow = DP / kVec;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  for (int i = threadIdx.x; i < kBlockQ * kVecPerRow; i += kMmaThreads) {
    const int r = i / kVecPerRow, c = (i % kVecPerRow) * kVec;
    const uint4 val = r0 + r < S && c < D
        ? *reinterpret_cast<const uint4*>(src + (size_t)(r0 + r) * D + c)
        : zero;
    *reinterpret_cast<uint4*>(rm + r * RS + c) = val;
    if (tr) {
      const bf16* e = reinterpret_cast<const bf16*>(&val);
#pragma unroll
      for (int j = 0; j < kVec; ++j) tr[(c + j) * TS + r] = e[j];
    }
  }
}

// acc[n] += A B over a 16-row strip, where A's fragments are read from the
// row-major tile `arow` (this warp's rows, offset by 2t) and B[k][n] is the
// row-major tile `b` read with its rows as the n index: a product over the
// head dimension, (16 x DP) x (DP x 64) -> 16 x 64 in 8 accumulator tiles.
template <int DP>
__device__ __forceinline__ void mma_rows_by_rows(float (&acc)[8][4],
                                                 const bf16* arow,
                                                 const bf16* b, int g, int t) {
  constexpr int RS = DP + 8;
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    const uint32_t a[4] = {ld32(arow + kk * 16), ld32(arow + 8 * RS + kk * 16),
                           ld32(arow + kk * 16 + 8),
                           ld32(arow + 8 * RS + kk * 16 + 8)};
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const bf16* brow = b + (n * 8 + g) * RS + t * 2 + kk * 16;
      mma_16816(acc[n], a, ld32(brow), ld32(brow + 8));
    }
  }
}

// Round two accumulator tiles per k-step to the A fragments of the next
// product over their 64 columns: tiles 2j and 2j+1 form k-step j.
__device__ __forceinline__ void to_a_fragments(const float (&x)[8][4],
                                               uint32_t (&a)[4][4]) {
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    a[n >> 1][(n & 1) * 2] = pack_bf16(x[n][0], x[n][1]);
    a[n >> 1][(n & 1) * 2 + 1] = pack_bf16(x[n][2], x[n][3]);
  }
}

// acc[nt] += A B, A = 16 x 64 in fragments, B[k][n] the transposed tile
// `bt` ([DP][64+8], k = its column): (16 x 64) x (64 x DP) -> 16 x DP.
template <int DP>
__device__ __forceinline__ void mma_frag_by_tr(float (&acc)[DP / 8][4],
                                               const uint32_t (&a)[4][4],
                                               const bf16* bt, int g, int t) {
  constexpr int TS = kBlockQ + 8;
#pragma unroll
  for (int nt = 0; nt < DP / 8; ++nt) {
    const bf16* col = bt + (nt * 8 + g) * TS + t * 2;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      mma_16816(acc[nt], a[j], ld32(col + j * 16), ld32(col + j * 16 + 8));
  }
}

// Write this warp's 16 rows x D of acc * mul as bf16 rows of `out`.
template <int DP>
__device__ __forceinline__ void store_rows_bf16(const float (&acc)[DP / 8][4],
                                                bf16* out, int row0, int S,
                                                int D, float mul, int g,
                                                int t) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + g + 8 * r;
    if (row >= S) continue;
    bf16* orow = out + (size_t)row * D + t * 2;
#pragma unroll
    for (int nt = 0; nt < DP / 8; ++nt)
      if (nt * 8 < D)
        *reinterpret_cast<uint32_t*>(orow + nt * 8) =
            pack_bf16(acc[nt][2 * r] * mul, acc[nt][2 * r + 1] * mul);
  }
}

template <int DP>
constexpr size_t dkdv_bf16_smem_bytes() {
  // k, v, q, dO tiles [64][DP + 8] and q, dO transposed [DP][64 + 8] in
  // bf16; lse2 and delta of the query tile in float32
  return sizeof(bf16) * (4 * (size_t)kBlockK * (DP + 8) +
                         2 * (size_t)DP * (kBlockQ + 8)) +
         2 * kBlockQ * sizeof(float);
}

template <int DP>
__global__ void __launch_bounds__(kMmaThreads)
flash_bwd_dkdv_bf16_kernel(const bf16* __restrict__ q,
                           const bf16* __restrict__ k,
                           const bf16* __restrict__ v,
                           const bf16* __restrict__ dout,
                           const float* __restrict__ lse,
                           const float* __restrict__ delta,
                           bf16* __restrict__ dk, bf16* __restrict__ dv,
                           int S, int D, float scale_log2, float scale) {
  constexpr int RS = DP + 8;
  constexpr int TS = kBlockQ + 8;
  constexpr int kOutTiles = DP / 8;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* vs = ks + kBlockK * RS;
  bf16* qs = vs + kBlockK * RS;
  bf16* dos = qs + kBlockQ * RS;
  bf16* qts = dos + kBlockQ * RS;
  bf16* dots = qts + DP * TS;
  float* lse_s = reinterpret_cast<float*>(dots + DP * TS);
  float* delta_s = lse_s + kBlockQ;

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int k0 = blockIdx.x * kBlockK;
  const size_t base = (size_t)blockIdx.y * S * D;
  const size_t rbase = (size_t)blockIdx.y * S;

  stage_bf16<DP>(k + base, k0, S, D, ks, nullptr);
  stage_bf16<DP>(v + base, k0, S, D, vs, nullptr);

  float dk_acc[kOutTiles][4], dv_acc[kOutTiles][4];
#pragma unroll
  for (int n = 0; n < kOutTiles; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[n][e] = dv_acc[n][e] = 0.f;

  // this warp's 16 keys, as A fragments (offset by the fragment column 2t)
  const bf16* krow = ks + (warp * 16 + g) * RS + t * 2;
  const bf16* vrow = vs + (warp * 16 + g) * RS + t * 2;

  for (int q0 = 0; q0 < S; q0 += kBlockQ) {
    __syncthreads();  // the previous query tile is fully consumed
    stage_bf16<DP>(q + base, q0, S, D, qs, qts);
    stage_bf16<DP>(dout + base, q0, S, D, dos, dots);
    for (int i = tid; i < kBlockQ; i += kMmaThreads) {
      const bool ok = q0 + i < S;
      lse_s[i] = ok ? lse[rbase + q0 + i] : INFINITY;  // P = 0 past S
      delta_s[i] = ok ? delta[rbase + q0 + i] : 0.f;
    }
    __syncthreads();

    // P^T = exp2(K q^T * c - lse2): 16 keys x 64 queries; element e of tile
    // n is key g + 8*(e >> 1), query n*8 + 2t + (e & 1)
    float p[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) p[n][0] = p[n][1] = p[n][2] = p[n][3] = 0.f;
    mma_rows_by_rows<DP>(p, krow, qs, g, t);
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        p[n][e] = exp2f(p[n][e] * scale_log2 - lse_s[n * 8 + t * 2 + (e & 1)]);

    // dV += P^T dO, P rounded to bf16
    uint32_t pa[4][4];
    to_a_fragments(p, pa);
    mma_frag_by_tr<DP>(dv_acc, pa, dots, g, t);

    // dS^T = P^T * (V dO^T - delta)
    float ds[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) ds[n][0] = ds[n][1] = ds[n][2] = ds[n][3] = 0.f;
    mma_rows_by_rows<DP>(ds, vrow, dos, g, t);
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        ds[n][e] = p[n][e] * (ds[n][e] - delta_s[n * 8 + t * 2 + (e & 1)]);

    // dK += dS^T q, dS rounded to bf16 (the scale comes once, at the end)
    uint32_t dsa[4][4];
    to_a_fragments(ds, dsa);
    mma_frag_by_tr<DP>(dk_acc, dsa, qts, g, t);
  }

  store_rows_bf16<DP>(dk_acc, dk + base, k0 + warp * 16, S, D, scale, g, t);
  store_rows_bf16<DP>(dv_acc, dv + base, k0 + warp * 16, S, D, 1.f, g, t);
}

template <int DP>
constexpr size_t dq_bf16_smem_bytes() {
  // q, dO, k, v tiles [64][DP + 8] and k transposed [DP][64 + 8], bf16
  return sizeof(bf16) * (4 * (size_t)kBlockQ * (DP + 8) +
                         (size_t)DP * (kBlockK + 8));
}

template <int DP>
__global__ void __launch_bounds__(kMmaThreads)
flash_bwd_dq_bf16_kernel(const bf16* __restrict__ q,
                         const bf16* __restrict__ k,
                         const bf16* __restrict__ v,
                         const bf16* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         bf16* __restrict__ dq, int S, int D,
                         float scale_log2, float scale) {
  constexpr int RS = DP + 8;
  constexpr int kOutTiles = DP / 8;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* dos = qs + kBlockQ * RS;
  bf16* ks = dos + kBlockQ * RS;
  bf16* vs = ks + kBlockK * RS;
  bf16* kts = vs + kBlockK * RS;

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * kBlockQ;
  const size_t base = (size_t)blockIdx.y * S * D;
  const size_t rbase = (size_t)blockIdx.y * S;

  stage_bf16<DP>(q + base, q0, S, D, qs, nullptr);
  stage_bf16<DP>(dout + base, q0, S, D, dos, nullptr);

  // this thread's two query rows, g and g + 8 of the warp's strip
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + warp * 16 + g + 8 * r;
    lse_r[r] = row < S ? lse[rbase + row] : INFINITY;
    delta_r[r] = row < S ? delta[rbase + row] : 0.f;
  }

  float acc[kOutTiles][4];
#pragma unroll
  for (int n = 0; n < kOutTiles; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  const bf16* qrow = qs + (warp * 16 + g) * RS + t * 2;
  const bf16* dorow = dos + (warp * 16 + g) * RS + t * 2;

  for (int k0 = 0; k0 < S; k0 += kBlockK) {
    __syncthreads();  // the previous key tile is fully consumed
    stage_bf16<DP>(k + base, k0, S, D, ks, kts);
    stage_bf16<DP>(v + base, k0, S, D, vs, nullptr);
    __syncthreads();

    // P = exp2(q K^T * c - lse2), 0 for keys past S; element e of tile n is
    // query g + 8*(e >> 1), key n*8 + 2t + (e & 1)
    float p[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) p[n][0] = p[n][1] = p[n][2] = p[n][3] = 0.f;
    mma_rows_by_rows<DP>(p, qrow, ks, g, t);
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        p[n][e] = k0 + n * 8 + t * 2 + (e & 1) < S
                      ? exp2f(p[n][e] * scale_log2 - lse_r[e >> 1])
                      : 0.f;

    // dS = P * (dO V^T - delta)
    float ds[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) ds[n][0] = ds[n][1] = ds[n][2] = ds[n][3] = 0.f;
    mma_rows_by_rows<DP>(ds, dorow, vs, g, t);
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        ds[n][e] = p[n][e] * (ds[n][e] - delta_r[e >> 1]);

    // dQ += dS K, dS rounded to bf16
    uint32_t dsa[4][4];
    to_a_fragments(ds, dsa);
    mma_frag_by_tr<DP>(acc, dsa, kts, g, t);
  }

  store_rows_bf16<DP>(acc, dq + base, q0 + warp * 16, S, D, scale, g, t);
}

// ---------------------------------------------------------------------------
// float32: scalar FMAs

// Stage rows [r0, r0 + 64) of a (S, D) float32 slice as [64][DP + 1]; rows
// past S and columns past D are zeros.
template <int DP>
__device__ __forceinline__ void stage_f32(const float* __restrict__ src,
                                          int r0, int S, int D, float* dst) {
  for (int i = threadIdx.x; i < kBlockQ * DP; i += kFmaThreads) {
    const int r = i / DP, c = i % DP;
    dst[r * (DP + 1) + c] =
        r0 + r < S && c < D ? src[(size_t)(r0 + r) * D + c] : 0.f;
  }
}

// out[j] = sum_d a_row[d] * b[(quad + 4j)][d] for the 16 columns of this
// thread's quad: one row of a (row x 64) product over the head dimension.
template <int DP>
__device__ __forceinline__ void fma_row_by_rows(float (&out)[16],
                                                const float* arow,
                                                const float* b, int quad) {
  constexpr int RS = DP + 1;
#pragma unroll
  for (int j = 0; j < 16; ++j) out[j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < DP; ++d) {
    const float ad = arow[d];
#pragma unroll
    for (int j = 0; j < 16; ++j)
      out[j] = fmaf(ad, b[(quad + 4 * j) * RS + d], out[j]);
  }
}

// acc[j] += sum_c w_row[c] * b[c][quad + 4j]: one row of (row x 64) x
// (64 x DP), for this thread's DP/4 output columns.
template <int DP>
__device__ __forceinline__ void fma_row_by_tile(float (&acc)[DP / 4],
                                                const float* wrow,
                                                const float* b, int quad) {
  constexpr int RS = DP + 1;
#pragma unroll 4
  for (int c = 0; c < kBlockK; ++c) {
    const float w = wrow[c];
    const float* brow = b + c * RS;
#pragma unroll
    for (int j = 0; j < DP / 4; ++j)
      acc[j] = fmaf(w, brow[quad + 4 * j], acc[j]);
  }
}

template <int DP>
constexpr size_t bwd_f32_smem_bytes() {
  // four [64][DP + 1] tiles, the P / dS tile [64][65], and two 64-vectors,
  // float32 (DP = 128: 149 KiB of the 227 KiB a block may hold)
  return sizeof(float) * (4 * (size_t)kBlockQ * (DP + 1) +
                          (size_t)kBlockQ * (kBlockK + 1) + 2 * kBlockQ);
}

template <int DP>
__global__ void __launch_bounds__(kFmaThreads)
flash_bwd_dkdv_f32_kernel(const float* __restrict__ q,
                          const float* __restrict__ k,
                          const float* __restrict__ v,
                          const float* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          float* __restrict__ dk, float* __restrict__ dv,
                          int S, int D, float scale_log2, float scale) {
  constexpr int RS = DP + 1;
  constexpr int BKP = kBlockQ + 1;
  constexpr int kDims = DP / 4;

  extern __shared__ float smem[];
  float* ks = smem;
  float* vs = ks + kBlockK * RS;
  float* qs = vs + kBlockK * RS;
  float* dos = qs + kBlockQ * RS;
  float* ps = dos + kBlockQ * RS;  // [64 keys][BKP]: P^T, then dS^T
  float* lse_s = ps + kBlockK * BKP;
  float* delta_s = lse_s + kBlockQ;

  const int tid = threadIdx.x;
  const int row = tid >> 2;  // key row inside the tile
  const int quad = tid & 3;
  const int k0 = blockIdx.x * kBlockK;
  const size_t base = (size_t)blockIdx.y * S * D;
  const size_t rbase = (size_t)blockIdx.y * S;

  stage_f32<DP>(k + base, k0, S, D, ks);
  stage_f32<DP>(v + base, k0, S, D, vs);

  float dk_acc[kDims], dv_acc[kDims];
#pragma unroll
  for (int j = 0; j < kDims; ++j) dk_acc[j] = dv_acc[j] = 0.f;
  float* prow = ps + row * BKP;

  for (int q0 = 0; q0 < S; q0 += kBlockQ) {
    __syncthreads();  // the previous query tile is fully consumed
    stage_f32<DP>(q + base, q0, S, D, qs);
    stage_f32<DP>(dout + base, q0, S, D, dos);
    for (int i = tid; i < kBlockQ; i += kFmaThreads) {
      const bool ok = q0 + i < S;
      lse_s[i] = ok ? lse[rbase + q0 + i] : INFINITY;  // P = 0 past S
      delta_s[i] = ok ? delta[rbase + q0 + i] : 0.f;
    }
    __syncthreads();

    // P^T for queries quad + 4j of this key row
    float p[16];
    fma_row_by_rows<DP>(p, ks + row * RS, qs, quad);
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      p[j] = exp2f(p[j] * scale_log2 - lse_s[quad + 4 * j]);
      prow[quad + 4 * j] = p[j];
    }
    __syncwarp();  // a row's quad lies inside one warp
    fma_row_by_tile<DP>(dv_acc, prow, dos, quad);

    float ds[16];
    fma_row_by_rows<DP>(ds, vs + row * RS, dos, quad);
    __syncwarp();  // the quad is done reading P^T
#pragma unroll
    for (int j = 0; j < 16; ++j)
      prow[quad + 4 * j] = p[j] * (ds[j] - delta_s[quad + 4 * j]);
    __syncwarp();
    fma_row_by_tile<DP>(dk_acc, prow, qs, quad);
  }

  const int key = k0 + row;
  if (key < S) {
#pragma unroll
    for (int j = 0; j < kDims; ++j) {
      const int c = quad + 4 * j;
      if (c < D) {
        dk[base + (size_t)key * D + c] = dk_acc[j] * scale;
        dv[base + (size_t)key * D + c] = dv_acc[j];
      }
    }
  }
}

template <int DP>
__global__ void __launch_bounds__(kFmaThreads)
flash_bwd_dq_f32_kernel(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v,
                        const float* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        float* __restrict__ dq, int S, int D,
                        float scale_log2, float scale) {
  constexpr int RS = DP + 1;
  constexpr int BKP = kBlockK + 1;
  constexpr int kDims = DP / 4;

  extern __shared__ float smem[];
  float* qs = smem;
  float* dos = qs + kBlockQ * RS;
  float* ks = dos + kBlockQ * RS;
  float* vs = ks + kBlockK * RS;
  float* ps = vs + kBlockK * RS;  // [64 queries][BKP]: dS

  const int tid = threadIdx.x;
  const int row = tid >> 2;  // query row inside the tile
  const int quad = tid & 3;
  const int q0 = blockIdx.x * kBlockQ;
  const size_t base = (size_t)blockIdx.y * S * D;
  const int gr = q0 + row;
  const float lse_r =
      gr < S ? lse[(size_t)blockIdx.y * S + gr] : INFINITY;
  const float delta_r = gr < S ? delta[(size_t)blockIdx.y * S + gr] : 0.f;

  stage_f32<DP>(q + base, q0, S, D, qs);
  stage_f32<DP>(dout + base, q0, S, D, dos);

  float acc[kDims];
#pragma unroll
  for (int j = 0; j < kDims; ++j) acc[j] = 0.f;
  float* prow = ps + row * BKP;

  for (int k0 = 0; k0 < S; k0 += kBlockK) {
    __syncthreads();  // the previous key tile and dS row are consumed
    stage_f32<DP>(k + base, k0, S, D, ks);
    stage_f32<DP>(v + base, k0, S, D, vs);
    __syncthreads();

    // P and dP for keys quad + 4j, then dS
    float p[16], dp[16];
    fma_row_by_rows<DP>(p, qs + row * RS, ks, quad);
    fma_row_by_rows<DP>(dp, dos + row * RS, vs, quad);
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const float pj = k0 + quad + 4 * j < S
                           ? exp2f(p[j] * scale_log2 - lse_r)
                           : 0.f;
      prow[quad + 4 * j] = pj * (dp[j] - delta_r);
    }
    __syncwarp();  // a row's quad lies inside one warp
    fma_row_by_tile<DP>(acc, prow, ks, quad);
  }

  if (gr < S) {
#pragma unroll
    for (int j = 0; j < kDims; ++j) {
      const int c = quad + 4 * j;
      if (c < D) dq[base + (size_t)gr * D + c] = acc[j] * scale;
    }
  }
}

// ---------------------------------------------------------------------------
// launch

template <typename Kernel>
cudaError_t set_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

cudaError_t launch_delta(const void* o, const void* dout, float* delta,
                         int bh, int s, int d, bool use_bf16,
                         cudaStream_t st) {
  const size_t rows = (size_t)bh * s;
  const unsigned blocks =
      (unsigned)((rows * 32 + kDeltaThreads - 1) / kDeltaThreads);
  if (use_bf16)
    flash_bwd_delta_kernel<bf16><<<blocks, kDeltaThreads, 0, st>>>(
        static_cast<const bf16*>(o), static_cast<const bf16*>(dout), delta,
        rows, d);
  else
    flash_bwd_delta_kernel<float><<<blocks, kDeltaThreads, 0, st>>>(
        static_cast<const float*>(o), static_cast<const float*>(dout), delta,
        rows, d);
  return cudaGetLastError();
}

template <int DP>
cudaError_t launch_dkdv(const void* q, const void* k, const void* v,
                        const void* dout, const float* lse,
                        const float* delta, void* dk, void* dv, int bh,
                        int s, int d, bool use_bf16, cudaStream_t st) {
  const float scale = (float)(1.0 / sqrt((double)d));
  const float scale_log2 = (float)(kLog2e / sqrt((double)d));
  const dim3 grid((s + kBlockK - 1) / kBlockK, bh);
  cudaError_t err;
  if (use_bf16) {
    constexpr size_t smem = dkdv_bf16_smem_bytes<DP>();
    if ((err = set_smem(flash_bwd_dkdv_bf16_kernel<DP>, smem))) return err;
    flash_bwd_dkdv_bf16_kernel<DP><<<grid, kMmaThreads, smem, st>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), static_cast<const bf16*>(dout), lse,
        delta, static_cast<bf16*>(dk), static_cast<bf16*>(dv), s, d,
        scale_log2, scale);
  } else {
    constexpr size_t smem = bwd_f32_smem_bytes<DP>();
    if ((err = set_smem(flash_bwd_dkdv_f32_kernel<DP>, smem))) return err;
    flash_bwd_dkdv_f32_kernel<DP><<<grid, kFmaThreads, smem, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(dout), lse,
        delta, static_cast<float*>(dk), static_cast<float*>(dv), s, d,
        scale_log2, scale);
  }
  return cudaGetLastError();
}

template <int DP>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* dout, const float* lse, const float* delta,
                      void* dq, int bh, int s, int d, bool use_bf16,
                      cudaStream_t st) {
  const float scale = (float)(1.0 / sqrt((double)d));
  const float scale_log2 = (float)(kLog2e / sqrt((double)d));
  const dim3 grid((s + kBlockQ - 1) / kBlockQ, bh);
  cudaError_t err;
  if (use_bf16) {
    constexpr size_t smem = dq_bf16_smem_bytes<DP>();
    if ((err = set_smem(flash_bwd_dq_bf16_kernel<DP>, smem))) return err;
    flash_bwd_dq_bf16_kernel<DP><<<grid, kMmaThreads, smem, st>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), static_cast<const bf16*>(dout), lse,
        delta, static_cast<bf16*>(dq), s, d, scale_log2, scale);
  } else {
    constexpr size_t smem = bwd_f32_smem_bytes<DP>();
    if ((err = set_smem(flash_bwd_dq_f32_kernel<DP>, smem))) return err;
    flash_bwd_dq_f32_kernel<DP><<<grid, kFmaThreads, smem, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(dout), lse,
        delta, static_cast<float*>(dq), s, d, scale_log2, scale);
  }
  return cudaGetLastError();
}

bool bad_shape(int bh, int s, int d) {
  return bh <= 0 || bh > 65535 || s <= 0 || d < 8 || d > 128 || d % 8;
}

}  // namespace

// q, k, v, o, dout, dk, dv: contiguous (bh, s, d) device arrays of float32
// (is_bf16 == 0) or bfloat16 (is_bf16 == 1), 16-byte aligned, d % 8 == 0 and
// 8 <= d <= 128; lse (the forward's lse2) and delta: (bh, s) float32.
// Launches the delta pre-pass (delta = rowsum(dout * o), written for
// ddti_flash_bwd_dq) and the dK/dV kernel on `stream` without
// synchronising; returns the first cudaError_t (0 = success).
extern "C" int ddti_flash_bwd_dkdv(const void* q, const void* k,
                                   const void* v, const void* o,
                                   const void* dout, const void* lse,
                                   void* delta, void* dk, void* dv, int bh,
                                   int s, int d, int is_bf16, int device,
                                   void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (bad_shape(bh, s, d)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool bf = is_bf16 != 0;
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  if ((err = launch_delta(o, dout, dl, bh, s, d, bf, st))) return (int)err;
  if (d <= 32)
    return (int)launch_dkdv<32>(q, k, v, dout, l, dl, dk, dv, bh, s, d, bf, st);
  if (d <= 64)
    return (int)launch_dkdv<64>(q, k, v, dout, l, dl, dk, dv, bh, s, d, bf, st);
  return (int)launch_dkdv<128>(q, k, v, dout, l, dl, dk, dv, bh, s, d, bf, st);
}

// As ddti_flash_bwd_dkdv, for dq; delta must hold what ddti_flash_bwd_dkdv
// wrote for the same (o, dout), earlier on the same stream.
extern "C" int ddti_flash_bwd_dq(const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse,
                                 const void* delta, void* dq, int bh, int s,
                                 int d, int is_bf16, int device,
                                 void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (bad_shape(bh, s, d)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool bf = is_bf16 != 0;
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  if (d <= 32)
    return (int)launch_dq<32>(q, k, v, dout, l, dl, dq, bh, s, d, bf, st);
  if (d <= 64)
    return (int)launch_dq<64>(q, k, v, dout, l, dl, dq, bh, s, d, bf, st);
  return (int)launch_dq<128>(q, k, v, dout, l, dl, dq, bh, s, d, bf, st);
}

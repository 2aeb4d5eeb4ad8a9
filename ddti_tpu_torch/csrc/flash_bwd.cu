// Flash-attention backward for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the TPU kernels of ddti_tpu/ops/attention.py:
//   _dkdv_kernel and _dkdv_kernel_packed -> flash_bwd_dkdv_*_kernel
//   _dq_kernel and _dq_kernel_packed     -> flash_bwd_dq_*_kernel
// and the per-tile delta = rowsum(dO * O) both TPU kernels compute inline ->
// a pre-pass (flash_bwd_rows_bf16_kernel, flash_bwd_rows_f32_kernel). The
// head packing of the *_packed forms only existed to fill the TPU's 128-lane
// vector registers; here a head of any supported width is one (b*h) slice,
// so each TPU pair is one kernel.
//
// Per (b*h) slice of contiguous (B, H, S, D) q/k/v/o/dO, with lse2 the
// forward's base-2 logsumexp ((B, H, S) float32), c = D^-1/2 * log2(e):
//   delta = sum_d dO * O                              (float32)
//   P     = exp2(q k^T * c - lse2)                    (float32, recomputed)
//   dV    = P^T dO                                    (P rounded to dO's dtype)
//   dS    = P * (dO v^T - delta)                      (float32)
//   dK    = D^-1/2 * dS^T q,  dQ = D^-1/2 * dS k      (dS rounded to q's dtype)
// with float32 accumulation and outputs in the input dtype, as the TPU
// kernels do (in float32 nothing is rounded: every product is 3xTF32). dQ has its own kernel (no atomics): every output element is
// summed by one thread in a fixed order, so the result does not depend on
// block scheduling.
//
// Head widths: every D with D % 8 == 0 (the wrapper pads any other D with
// zero columns and passes the true width, scale_d, for the scales). Up to
// 128, kernels instantiated for the padded widths DP = 32, 64, 128 with the
// actual D at run time (columns D..DP-1 of the staged tiles are zeros and
// are not written back). The dK and dV accumulators live in registers (DP
// / 2 float32 of each per consumer thread, beside those of S^T and dP^T),
// which run out past 128: wider heads run the wide kernels ("D > 128"
// below), each block of which owns 128 of the outputs' columns. B*H: any;
// blocks run over (row block, slice) on gridDim.x alone.
//
// What bounds it on an H100 (dense peaks 989 TFLOP/s bf16 and 495 TF32,
// 3.35 TB/s, 16 exp2 per clock per SM at the 1980 MHz boost clock): at the
// TransUNet training shape (B=16, H=8, S=1024, D=32) the pair does five
// (S, S, D) products, 42.9 GFLOP; dK/dV alone four (S^T, dP^T, dV, dK: 34.4
// GFLOP), dQ three (S, dP, dQ: 25.8 GFLOP). In bf16 that is 0.0434 ms at
// the tensor-core peak against 67.6 MB in and out (0.020 ms); in float32,
// as 3xTF32 products at 165 TFLOP/s, 0.260 ms against 134.7 MB (0.040 ms).
// Each kernel recomputes P, B*H*S^2 = 134 M exp2: 0.032 ms of the exp2
// unit alone, so a pair without atomics has an exp2 floor of 0.064 ms,
// above its bf16 tensor-core bound. Neither kernel writes an (S, S) tile to
// device memory.
//
// Design, bf16. The first versions (mma.sync) ran at 13% of the bf16 peak,
// held back three ways; what replaced each, in both kernels:
//   1. tiles staged by blocking 16-byte loads between two block barriers per
//      tile, single-buffered -> one producer warpgroup, one thread of which
//      issues TMA loads into a ring of kStages slots under mbarriers (full:
//      the slot landed; empty: every consumer is done with it), kept ahead
//      of the consumers; no block-wide barrier in the loop. Each tensor is a
//      3-D map (D, S, b*h), so rows past S of a slice read as zeros, never as
//      the next slice's, and so do columns D..DP-1;
//   2. q and dO (dK/dV) or K (dQ) staged a second time transposed, one 2-byte
//      store at a time with 4-way bank conflicts -> wgmma reads them MN-major
//      straight from the row-major tiles, which TMA writes with the swizzle
//      wgmma reads; no transposed copy;
//   3. mma.sync.m16n8k16 fed by 32-bit shared loads, 16 rows a warp ->
//      wgmma, 64 rows a warpgroup, operands by shared-memory descriptor.
// A block is 128 rows of one slice (BwdSmem): two consumer warpgroups of 64
// rows, whose resident tiles load once, share every streamed tile (half the
// load traffic per row), and setmaxnreg hands the producer's registers to
// them; at DP = 128, where two would spill, one consumer of 64 rows.
//  - dK/dV: 64 keys a consumer (K and V resident), streaming 64-query tiles
//    of q and dO with the tile's lse2 and delta. Per tile: S^T = K q^T and
//    dP^T = V dO^T by wgmma.m64n64k16, all four operands K-major;
//    P^T = exp2(S^T c - lse2) and dS^T = P^T (dP^T - delta) in registers;
//    then dV += P^T dO and dK += dS^T q by wgmma.m64nDPk16 with P^T and
//    dS^T from registers (the accumulators rounded to bf16 are the A
//    fragments) and dO, q MN-major; dS^T is computed while dV runs.
//  - dQ: 64 queries a consumer (q and dO resident, lse2 and delta of its
//    rows in registers), streaming 64-key tiles of K and V. Per tile:
//    S = q K^T and dP = dO V^T, P = exp2(S c - lse2) with key columns past
//    S masked to 0, dS = P (dP - delta), then dQ += dS K with dS from
//    registers and K MN-major. It reads delta as the pre-pass wrote it,
//    (bh, s) float32.
//
// Design, float32 (BwdSmemF32). The first versions, scalar-FMA loops, ran
// at 6-9% of the float32 bound, held back by one shared-memory load per FMA
// and synchronous staging. Now the bf16 kernels' shape (a producer warpgroup
// feeding TMA loads into an mbarrier ring, consumer warpgroups of 64 rows
// on wgmma, setmaxnreg, no block-wide barrier in the loop) with every
// product as three TF32 products (sm90.cuh: x = hi + lo, a_lo b_hi + a_hi
// b_lo + a_hi b_hi, the small terms first), which keep float32's accuracy
// on the tensor cores at a third of the TF32 rate. What that took:
//   1. tf32 wgmma reads K-major operands only, so the products whose B
//      operand is naturally MN-major (dV += P^T dO, dK += dS^T q, dQ += dS
//      K) read transposed planes: the pre-pass writes q^T, dO^T and K^T,
//      and every operand's hi and lo planes, to scratch (14 planes, written
//      and read once), and TMA loads ready tiles;
//   2. an accumulator holds columns 2t, 2t + 1 of each 8-column group where
//      a tf32 A fragment wants t, t + 4: the transposed planes store each
//      group of 8 in the order {0, 2, 4, 6, 1, 3, 5, 7} (free in the
//      pre-pass), so P^T and dS (split k8 step by k8 step) are A fragments
//      as they stand;
//   3. hi + lo doubles float32 tiles: the ring's slots hold one part each
//      (one operand's hi and lo planes), released as soon as its product
//      is done, as many as fit beside the resident tiles (8 at DP = 32, 4
//      at 64, 3 at 128); two consumers at DP = 32, one above; 32-row
//      streamed tiles at DP = 128.
// dK/dV streams parts q, dO (S^T, dP^T), dO^T (dV), q^T (dK) a tile; dQ
// streams K, V (S, dP), K^T (dQ).
//
// Ragged S: query rows past S get lse2 = +inf, so P = 0 there (the bf16 row
// pre-pass pads the rows that dK/dV loads by TMA so; the other kernels set
// it), key columns past S are masked in dQ, and rows past S are not written.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr double kLog2e = 1.4426950408889634;
constexpr int kDeltaThreads = 256;
constexpr int kMaxD = 128;
typedef __nv_bfloat16 bf16;

__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }

// ---------------------------------------------------------------------------
// bfloat16: TMA + wgmma

// delta = rowsum(dO * O) for dQ ((bh, s) float32) and, for the dK/dV
// kernel's TMA loads, `rows` (bh, 2, sp) float32 with sp = s rounded up to
// 64: lse2, +inf past s (so P = 0 there), then delta, 0 past s. (The q and
// dO rows past s load as zeros, which already make P^T dO and dS^T q zero
// there; the +inf keeps P itself zero.) LPR threads per row, 16 bytes of dO
// and O each at a time.
template <int LPR>
__global__ void __launch_bounds__(kDeltaThreads)
flash_bwd_rows_bf16_kernel(const bf16* __restrict__ o,
                           const bf16* __restrict__ dout,
                           const float* __restrict__ lse,
                           float* __restrict__ delta,
                           float* __restrict__ rows, int bh, int s, int sp,
                           int D) {
  const size_t i = (size_t)blockIdx.x * kDeltaThreads + threadIdx.x;
  const size_t slice = i / LPR / sp;
  const int r = (int)(i / LPR % sp), part = (int)(i % LPR);
  const bool live = slice < (size_t)bh && r < s;
  float acc = 0.f;
  if (live) {
    const size_t base = (slice * s + r) * D;
    for (int c = part * 8; c < D; c += LPR * 8) {
      const uint4 a = *reinterpret_cast<const uint4*>(dout + base + c);
      const uint4 b = *reinterpret_cast<const uint4*>(o + base + c);
      const bf16* ae = reinterpret_cast<const bf16*>(&a);
      const bf16* be = reinterpret_cast<const bf16*>(&b);
#pragma unroll
      for (int j = 0; j < 8; ++j) acc = fmaf(to_f32(ae[j]), to_f32(be[j]), acc);
    }
  }
#pragma unroll
  for (int off = LPR / 2; off; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (part == 0 && slice < (size_t)bh) {
    if (live) delta[slice * s + r] = acc;
    rows[2 * slice * sp + r] = live ? lse[slice * s + r] : INFINITY;
    rows[(2 * slice + 1) * sp + r] = acc;
  }
}

// A backward block: C consumer warpgroups, each with two resident 64-row
// tiles (dK/dV: its K and V; dQ: its q and dO), and a producer warpgroup
// that streams the other two tiles (dK/dV: q and dO with the tile's lse2
// and delta rows; dQ: K and V) into a ring of kStages slots. Shared memory:
// the resident tiles (all first tiles, then all second ones), the ring, the
// rows (dK/dV), then the mbarriers full[kStages], empty[kStages] and
// resident_full.
template <int DP, bool kRows>
struct BwdSmem {
  using T = Tile<DP>;
  // consumer warpgroups: one at DP = 128, where two spill registers
  static constexpr int kConsumers = DP == 128 ? 1 : 2;
  static constexpr int kThreads = 128 * (kConsumers + 1);
  static constexpr int kStages = 4;
  static constexpr uint32_t kStage = 2 * T::kBytes;
  static constexpr uint32_t kRowBytes = kRows ? 2 * kTileRows * 4 : 0;
  static constexpr uint32_t resident = 0;
  static constexpr uint32_t stages = 2 * kConsumers * T::kBytes;
  static constexpr uint32_t rows = stages + kStages * kStage;
  static constexpr uint32_t bars = rows + kStages * kRowBytes;
  static constexpr size_t bytes = bars + 8 * (2 * kStages + 1) + 1024;
};

// Rows row0 + 16 warp + g + 8 r (r = 0, 1) of a wgmma accumulator times
// `mul`, as bf16 rows of `out` (row stride D; the rows before S, the
// columns below min(D, cols): a wide kernel's slice ends at cols).
template <int DP>
__device__ __forceinline__ void store_rows(const float (&acc)[DP / 2],
                                           bf16* out, int row0, int S,
                                           int D, float mul, int warp, int g,
                                           int t, int cols = 1 << 30) {
  const int end = min(D, cols);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + warp * 16 + g + 8 * r;
    if (row >= S) continue;
    bf16* orow = out + (size_t)row * D + 2 * t;
#pragma unroll
    for (int n = 0; n < DP / 8; ++n)
      if (n * 8 < end)
        *reinterpret_cast<uint32_t*>(orow + n * 8) = pack_bf16(
            acc[4 * n + 2 * r] * mul, acc[4 * n + 2 * r + 1] * mul);
  }
}

// One streamed tile of the bf16 dK/dV kernels, from S^T (p) and dP^T (ds)
// of 64 keys x 64 queries: P^T = exp2(S^T c - lse2) and dV += P^T dO (P
// rounded to bf16), then, while dV runs, dS^T = P^T (dP^T - delta) and
// dK += dS^T q (dS rounded to bf16; the scale comes once, at the end).
// lse_s, delta_s: the tile's queries' rows; do_tile, q_tile: its dO and q
// tiles (or their slices), read with their rows as k. Waits for both.
template <int DP>
__device__ __forceinline__ void dkdv_tile(float (&p)[32], float (&ds)[32],
                                          float (&dk_acc)[DP / 2],
                                          float (&dv_acc)[DP / 2],
                                          const float* lse_s,
                                          const float* delta_s,
                                          uint32_t do_tile, uint32_t q_tile,
                                          float scale_log2, int t) {
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    const float2 l2 = *reinterpret_cast<const float2*>(lse_s + 8 * n + 2 * t);
#pragma unroll
    for (int e = 0; e < 4; ++e)
      p[4 * n + e] = flash_exp2(
          fmaf(p[4 * n + e], scale_log2, -(e & 1 ? l2.y : l2.x)));
  }
  uint32_t pa[4][4];
  to_a_fragments(p, pa);
  fence_acc(dv_acc);
  wgmma_fence();
#pragma unroll
  for (int j = 0; j < 4; ++j)
    wgmma_rs_mn<DP>(dv_acc, pa[j], desc_mn_major<DP>(do_tile, j));
  wgmma_commit();

#pragma unroll
  for (int n = 0; n < 8; ++n) {
    const float2 d2 =
        *reinterpret_cast<const float2*>(delta_s + 8 * n + 2 * t);
#pragma unroll
    for (int e = 0; e < 4; ++e)
      ds[4 * n + e] = p[4 * n + e] * (ds[4 * n + e] - (e & 1 ? d2.y : d2.x));
  }
  uint32_t dsa[4][4];
  to_a_fragments(ds, dsa);
  fence_acc(dk_acc);
  wgmma_fence();
#pragma unroll
  for (int j = 0; j < 4; ++j)
    wgmma_rs_mn<DP>(dk_acc, dsa[j], desc_mn_major<DP>(q_tile, j));
  wgmma_commit();
  wgmma_wait<0>();
  fence_acc(dv_acc);
  fence_acc(dk_acc);
}

// The dQ kernels' dS of one streamed tile, in place of dP (ds): P =
// exp2(S c - lse2), 0 for keys past S (TMA's zero rows there would give
// exp2(-lse2)), dS = P (dP - delta), in float32; N accumulator elements a
// thread over the 2N keys from k0; lse_r, delta_r: the thread's two query
// rows'.
template <int N>
__device__ __forceinline__ void dq_scores(const float (&p)[N],
                                          float (&ds)[N],
                                          const float (&lse_r)[2],
                                          const float (&delta_r)[2], int k0,
                                          int S, float scale_log2, int t) {
  const bool ragged = k0 + 2 * N > S;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const int r = (i >> 1) & 1;
    float pi = flash_exp2(fmaf(p[i], scale_log2, -lse_r[r]));
    if (ragged && k0 + (i / 4) * 8 + 2 * t + (i & 1) >= S) pi = 0.f;
    ds[i] = pi * (ds[i] - delta_r[r]);
  }
}

// dQ += dS K over one tile of 64 keys, bf16: dS rounded to bf16 as the A
// fragments, K's tile (or slice) read with its rows (keys) as k; waits for
// the product
template <int DP>
__device__ __forceinline__ void dq_product(const float (&ds)[32],
                                           float (&dq_acc)[DP / 2],
                                           uint32_t k_tile) {
  uint32_t dsa[4][4];
  to_a_fragments(ds, dsa);
  fence_acc(dq_acc);
  wgmma_fence();
#pragma unroll
  for (int j = 0; j < 4; ++j)
    wgmma_rs_mn<DP>(dq_acc, dsa[j], desc_mn_major<DP>(k_tile, j));
  wgmma_commit();
  wgmma_wait<0>();
  fence_acc(dq_acc);
}

template <int DP>
__global__ void __launch_bounds__(BwdSmem<DP, true>::kThreads, 1)
flash_bwd_dkdv_bf16_kernel(const __grid_constant__ CUtensorMap q_map,
                           const __grid_constant__ CUtensorMap k_map,
                           const __grid_constant__ CUtensorMap v_map,
                           const __grid_constant__ CUtensorMap do_map,
                           const __grid_constant__ CUtensorMap rows_map,
                           bf16* __restrict__ dk, bf16* __restrict__ dv,
                           int S, int D, float scale_log2, float scale) {
  using T = Tile<DP>;
  using L = BwdSmem<DP, true>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::bars);
  uint64_t* empty = full + L::kStages;
  uint64_t* kv_full = empty + L::kStages;
  // blocks run over (key block, slice) on gridDim.x alone, so B*H has no
  // 65535 bound
  constexpr int kRows = L::kConsumers * kTileRows;
  const int n_blocks = (S + kRows - 1) / kRows;
  const int slice = blockIdx.x / n_blocks;
  const int k0 = (blockIdx.x % n_blocks) * kRows;
  const int n_tiles = (S + kBlockQ - 1) / kBlockQ;
  const int wg = threadIdx.x / 128;
  init_ring<L>(full);

  if (wg == L::kConsumers) {  // the producer
    regs_dealloc<kProducerRegs>();
    if (threadIdx.x == L::kConsumers * 128) {
      mbar_expect_tx(kv_full, 2 * L::kConsumers * T::kBytes);
      for (int c = 0; c < L::kConsumers; ++c) {
        tma_load_tile<DP>(smem + L::resident + c * T::kBytes, &k_map,
                          kv_full, k0 + c * kTileRows, slice);
        tma_load_tile<DP>(
            smem + L::resident + (L::kConsumers + c) * T::kBytes, &v_map,
            kv_full, k0 + c * kTileRows, slice);
      }
      for (int it = 0; it < n_tiles; ++it) {
        const int st = it % L::kStages;
        mbar_wait(empty + st, ((it / L::kStages) & 1) ^ 1);
        mbar_expect_tx(full + st, L::kStage + L::kRowBytes);
        unsigned char* qd = smem + L::stages + st * L::kStage;
        tma_load_tile<DP>(qd, &q_map, full + st, it * kBlockQ, slice);
        tma_load_tile<DP>(qd + T::kBytes, &do_map, full + st, it * kBlockQ,
                          slice);
        tma_load(smem + L::rows + st * L::kRowBytes, &rows_map, full + st,
                 it * kBlockQ, 2 * slice);
      }
    }
  } else {  // a consumer: keys k0 + 64 wg .. + 63
    regs_alloc<kConsumerRegs>();
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, t = lane % 4;
    const uint32_t k_tile = smem_addr(smem + L::resident + wg * T::kBytes);
    const uint32_t v_tile =
        smem_addr(smem + L::resident + (L::kConsumers + wg) * T::kBytes);
    float dk_acc[DP / 2], dv_acc[DP / 2];
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;
    mbar_wait(kv_full, 0);

    for (int it = 0; it < n_tiles; ++it) {
      const int st = it % L::kStages;
      mbar_wait(full + st, (it / L::kStages) & 1);
      const uint32_t q_tile = smem_addr(smem + L::stages + st * L::kStage);
      const uint32_t do_tile = q_tile + T::kBytes;
      const float* lse_s =
          reinterpret_cast<const float*>(smem + L::rows + st * L::kRowBytes);
      const float* delta_s = lse_s + kTileRows;

      // S^T = K q^T and dP^T = V dO^T: element 4n + e is key g + 8 (e >> 1),
      // query it * 64 + 8n + 2t + (e & 1)
      float p[32], ds[32];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk)
        wgmma_m64n64k16_ss(p, desc_k_major<DP>(k_tile, kk),
                           desc_k_major<DP>(q_tile, kk), kk);
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk)
        wgmma_m64n64k16_ss(ds, desc_k_major<DP>(v_tile, kk),
                           desc_k_major<DP>(do_tile, kk), kk);
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(p);
      fence_acc(ds);

      dkdv_tile<DP>(p, ds, dk_acc, dv_acc, lse_s, delta_s, do_tile, q_tile,
                    scale_log2, t);
      mbar_arrive(empty + st);
    }

    const size_t base = (size_t)slice * S * D;
    const int row0 = k0 + wg * kTileRows;
    store_rows<DP>(dk_acc, dk + base, row0, S, D, scale, warp, g, t);
    store_rows<DP>(dv_acc, dv + base, row0, S, D, 1.f, warp, g, t);
  }
}

template <int DP>
__global__ void __launch_bounds__(BwdSmem<DP, false>::kThreads, 1)
flash_bwd_dq_bf16_kernel(const __grid_constant__ CUtensorMap q_map,
                         const __grid_constant__ CUtensorMap k_map,
                         const __grid_constant__ CUtensorMap v_map,
                         const __grid_constant__ CUtensorMap do_map,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         bf16* __restrict__ dq, int S, int D,
                         float scale_log2, float scale) {
  using T = Tile<DP>;
  using L = BwdSmem<DP, false>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::bars);
  uint64_t* empty = full + L::kStages;
  uint64_t* qdo_full = empty + L::kStages;
  constexpr int kRows = L::kConsumers * kTileRows;
  const int n_blocks = (S + kRows - 1) / kRows;
  const int slice = blockIdx.x / n_blocks;
  const int q0 = (blockIdx.x % n_blocks) * kRows;
  const int n_tiles = (S + kBlockK - 1) / kBlockK;
  const int wg = threadIdx.x / 128;
  init_ring<L>(full);

  if (wg == L::kConsumers) {  // the producer
    regs_dealloc<kProducerRegs>();
    if (threadIdx.x == L::kConsumers * 128) {
      mbar_expect_tx(qdo_full, 2 * L::kConsumers * T::kBytes);
      for (int c = 0; c < L::kConsumers; ++c) {
        tma_load_tile<DP>(smem + L::resident + c * T::kBytes, &q_map,
                          qdo_full, q0 + c * kTileRows, slice);
        tma_load_tile<DP>(
            smem + L::resident + (L::kConsumers + c) * T::kBytes, &do_map,
            qdo_full, q0 + c * kTileRows, slice);
      }
      for (int it = 0; it < n_tiles; ++it) {
        const int st = it % L::kStages;
        mbar_wait(empty + st, ((it / L::kStages) & 1) ^ 1);
        mbar_expect_tx(full + st, L::kStage);
        unsigned char* kv = smem + L::stages + st * L::kStage;
        tma_load_tile<DP>(kv, &k_map, full + st, it * kBlockK, slice);
        tma_load_tile<DP>(kv + T::kBytes, &v_map, full + st, it * kBlockK,
                          slice);
      }
    }
  } else {  // a consumer: queries q0 + 64 wg .. + 63
    regs_alloc<kConsumerRegs>();
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, t = lane % 4;
    const int row0 = q0 + wg * kTileRows;
    const uint32_t q_tile = smem_addr(smem + L::resident + wg * T::kBytes);
    const uint32_t do_tile =
        smem_addr(smem + L::resident + (L::kConsumers + wg) * T::kBytes);
    // this thread's query rows g and g + 8 of its warp's 16: lse2 (+inf
    // past S, so P = 0 there) and delta
    float lse_r[2], delta_r[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + warp * 16 + g + 8 * r;
      lse_r[r] = row < S ? lse[(size_t)slice * S + row] : INFINITY;
      delta_r[r] = row < S ? delta[(size_t)slice * S + row] : 0.f;
    }
    float dq_acc[DP / 2];
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) dq_acc[i] = 0.f;
    mbar_wait(qdo_full, 0);

    for (int it = 0; it < n_tiles; ++it) {
      const int st = it % L::kStages;
      mbar_wait(full + st, (it / L::kStages) & 1);
      const uint32_t k_tile = smem_addr(smem + L::stages + st * L::kStage);
      const uint32_t v_tile = k_tile + T::kBytes;

      // S = q K^T and dP = dO V^T: element 4n + e is query g + 8 (e >> 1),
      // key it * 64 + 8n + 2t + (e & 1)
      float p[32], ds[32];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk)
        wgmma_m64n64k16_ss(p, desc_k_major<DP>(q_tile, kk),
                           desc_k_major<DP>(k_tile, kk), kk);
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk)
        wgmma_m64n64k16_ss(ds, desc_k_major<DP>(do_tile, kk),
                           desc_k_major<DP>(v_tile, kk), kk);
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(p);
      fence_acc(ds);

      dq_scores(p, ds, lse_r, delta_r, it * kBlockK, S, scale_log2, t);
      dq_product<DP>(ds, dq_acc, k_tile);
      mbar_arrive(empty + st);
    }

    store_rows<DP>(dq_acc, dq + (size_t)slice * S * D, row0, S, D, scale,
                   warp, g, t);
  }
}

// ---------------------------------------------------------------------------
// float32: 3xTF32 on wgmma, TMA

// The float32 pre-pass, per 64-row block of one slice: delta = rowsum(dO *
// O) ((bh, s) for dQ, and the (bh, 2, sp) lse2 / delta rows of dK/dV as in
// bf16), and the operand planes both kernels load by TMA, each hi then lo
// (split_tf32):
//   `split` (4, bh, 2, s, d): q, K, V, dO as they are (row-major);
//   `trans` (3, bh, 2, d, sp): q^T, dO^T, K^T, zero past s, with the s
//   positions of each group of 8 in the order {0, 2, 4, 6, 1, 3, 5, 7}
//   that split_fragments expects of a B operand met by an accumulator.
// Four threads a row for delta, 16 bytes at a time; the transposes pass
// through shared memory, kMaxD columns at a time (any D).
__global__ void __launch_bounds__(kDeltaThreads)
flash_bwd_rows_f32_kernel(const float* __restrict__ q,
                          const float* __restrict__ k,
                          const float* __restrict__ v,
                          const float* __restrict__ o,
                          const float* __restrict__ dout,
                          const float* __restrict__ lse,
                          float* __restrict__ delta, float* __restrict__ rows,
                          float* __restrict__ split, float* __restrict__ trans,
                          int bh, int s, int sp, int D) {
  __shared__ float tile[kTileRows][kMaxD + 1];
  const int n_blocks = sp / kTileRows;
  const int slice = blockIdx.x / n_blocks;
  const int r0 = blockIdx.x % n_blocks * kTileRows;
  const int tid = threadIdx.x, D4 = D / 4;  // 16-byte chunks of a row
  {
    const int r = tid / 4, part = tid % 4, row = r0 + r;
    const bool live = row < s;
    const size_t base = ((size_t)slice * s + row) * D;
    float acc = 0.f;
    if (live)
      for (int c = part; c < D4; c += 4) {
        const float4 a = reinterpret_cast<const float4*>(dout + base)[c];
        const float4 b = reinterpret_cast<const float4*>(o + base)[c];
        acc = fmaf(a.x, b.x, fmaf(a.y, b.y, fmaf(a.z, b.z, fmaf(a.w, b.w,
                                                                acc))));
      }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    acc += __shfl_xor_sync(0xffffffffu, acc, 2);
    if (part == 0) {
      if (live) delta[(size_t)slice * s + row] = acc;
      rows[2 * (size_t)slice * sp + row] =
          live ? lse[(size_t)slice * s + row] : INFINITY;
      rows[(2 * (size_t)slice + 1) * sp + row] = acc;
    }
  }
  const float* src[4] = {q, k, v, dout};
  const int to_trans[4] = {0, 2, -1, 1};  // q -> q^T, K -> K^T, dO -> dO^T
  const size_t plane = (size_t)s * D, tplane = (size_t)D * sp;
  for (int x = 0; x < 4; ++x) {
    const float* in = src[x] + (size_t)slice * plane;
    float* out = split + ((size_t)x * bh + slice) * 2 * plane;
    for (int c0 = 0; c0 < D; c0 += kMaxD) {
      const int C4 = min(kMaxD, D - c0) / 4;  // 16-byte chunks of the chunk
      for (int i = tid; i < kTileRows * C4; i += kDeltaThreads) {
        const int r = i / C4, cc = 4 * (i - r * C4), c = c0 + cc;
        const int row = r0 + r;
        float val[4] = {0.f, 0.f, 0.f, 0.f};
        if (row < s) {
          const float4 f =
              *reinterpret_cast<const float4*>(in + (size_t)row * D + c);
          val[0] = f.x, val[1] = f.y, val[2] = f.z, val[3] = f.w;
          uint32_t hi[4], lo[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) split_tf32(val[j], hi[j], lo[j]);
          *reinterpret_cast<uint4*>(out + (size_t)row * D + c) =
              make_uint4(hi[0], hi[1], hi[2], hi[3]);
          *reinterpret_cast<uint4*>(out + plane + (size_t)row * D + c) =
              make_uint4(lo[0], lo[1], lo[2], lo[3]);
        }
        if (to_trans[x] >= 0)
#pragma unroll
          for (int j = 0; j < 4; ++j) tile[r][cc + j] = val[j];
      }
      if (to_trans[x] < 0) continue;
      __syncthreads();
      store_trans_split<kDeltaThreads>(
          tile,
          trans + ((size_t)to_trans[x] * bh + slice) * 2 * tplane +
              (size_t)c0 * sp,
          tplane, sp, r0, 4 * C4);
      __syncthreads();
    }
  }
}

// A float32 backward block: C consumer warpgroups of 64 rows, each with two
// resident tiles split hi / lo (dK/dV: K and V; dQ: q and dO), and a
// producer warpgroup that streams tiles of kBlk rows of the other side as
// kParts parts a tile through a ring of kStages slots, one part (hi and lo
// planes of one operand) a slot: dK/dV q, dO, dO^T, q^T (with the tile's
// lse2 / delta rows beside q); dQ K, V, K^T. Each part is released as soon
// as its product is done, so the ring holds what fits of 227 KB. Shared
// memory: the resident planes (consumer c: X hi, X lo, Y hi, Y lo), the
// slots, the rows (dK/dV), the mbarriers.
template <int DP, int kParts>
struct BwdSmemF32 {
  static constexpr bool kRows = kParts == 4;
  // consumer warpgroups: two at DP = 32; one above, where two tiles' split
  // planes leave no room for the ring
  static constexpr int kConsumers = DP == 32 ? 2 : 1;
  static constexpr int kThreads = 128 * (kConsumers + 1);
  // streamed rows a tile: 32 at DP = 128, where a 64-row part (64 KB) and
  // the resident 128 KB leave room for one slot
  static constexpr int kBlk = DP == 128 ? 32 : 64;
  static constexpr uint32_t kRes = kTileRows * DP * 4;  // one plane
  static constexpr uint32_t kPlane = kBlk * DP * 4;
  static constexpr uint32_t kPart = 2 * kPlane;
  static constexpr uint32_t kRowBytes = kRows ? 2 * kBlk * 4 : 0;
  static constexpr uint32_t resident = 0;
  static constexpr uint32_t stages = 4 * kConsumers * kRes;
  static constexpr int kFit =
      (int)((232448 - 1024 - 8 * 17 - stages) / (kPart + kRowBytes));
  static constexpr int kStages = kFit < 8 ? kFit : 8;
  static_assert(kStages >= 2, "ring");
  static constexpr uint32_t rows = stages + kStages * kPart;
  static constexpr uint32_t bars = rows + kStages * kRowBytes;
  static constexpr size_t bytes = bars + 8 * (2 * kStages + 1) + 1024;
};

template <int DP>
__device__ __forceinline__ void store_rows_f32(const float (&acc)[DP / 2],
                                               float* out, int row0, int S,
                                               int D, float mul, int warp,
                                               int g, int t,
                                               int cols = 1 << 30) {
  const int end = min(D, cols);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + warp * 16 + g + 8 * r;
    if (row >= S) continue;
    float* orow = out + (size_t)row * D + 2 * t;
#pragma unroll
    for (int n = 0; n < DP / 8; ++n)
      if (n * 8 < end)
        *reinterpret_cast<float2*>(orow + n * 8) = make_float2(
            acc[4 * n + 2 * r] * mul, acc[4 * n + 2 * r + 1] * mul);
  }
}

// The float32 dK/dV kernels' P^T = exp2(S^T c - lse2) and dS^T = P^T (dP^T
// - delta), in place of S^T (p) and dP^T (dp), of 64 keys x B queries;
// lse_s, delta_s: the tile's queries' rows
template <int B>
__device__ __forceinline__ void dkdv_scores_f32(float (&p)[B / 2],
                                                float (&dp)[B / 2],
                                                const float* lse_s,
                                                const float* delta_s,
                                                float scale_log2, int t) {
#pragma unroll
  for (int j = 0; j < B / 8; ++j) {
    const float2 l2 = *reinterpret_cast<const float2*>(lse_s + 8 * j + 2 * t);
    const float2 d2 =
        *reinterpret_cast<const float2*>(delta_s + 8 * j + 2 * t);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = 4 * j + e;
      p[i] = flash_exp2(fmaf(p[i], scale_log2, -(e & 1 ? l2.y : l2.x)));
      dp[i] = p[i] * (dp[i] - (e & 1 ? d2.y : d2.x));
    }
  }
}

template <int DP>
__global__ void __launch_bounds__(BwdSmemF32<DP, 4>::kThreads, 1)
flash_bwd_dkdv_f32_kernel(const __grid_constant__ CUtensorMap k_map,
                          const __grid_constant__ CUtensorMap v_map,
                          const __grid_constant__ CUtensorMap q_map,
                          const __grid_constant__ CUtensorMap do_map,
                          const __grid_constant__ CUtensorMap dot_map,
                          const __grid_constant__ CUtensorMap qt_map,
                          const __grid_constant__ CUtensorMap rows_map,
                          float* __restrict__ dk, float* __restrict__ dv,
                          int S, int D, float scale_log2, float scale) {
  using L = BwdSmemF32<DP, 4>;
  constexpr int B = L::kBlk;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::bars);
  uint64_t* empty = full + L::kStages;
  uint64_t* kv_full = empty + L::kStages;
  constexpr int kRows = L::kConsumers * kTileRows;
  const int n_blocks = (S + kRows - 1) / kRows;
  const int slice = blockIdx.x / n_blocks;
  const int k0 = (blockIdx.x % n_blocks) * kRows;
  const int n_tiles = (S + B - 1) / B;
  const int wg = threadIdx.x / 128;
  init_ring<L>(full);

  if (wg == L::kConsumers) {  // the producer
    regs_dealloc<kProducerRegs>();
    if (threadIdx.x == L::kConsumers * 128) {
      mbar_expect_tx(kv_full, 4 * L::kConsumers * L::kRes);
      for (int c = 0; c < L::kConsumers; ++c) {
        unsigned char* res = smem + L::resident + c * 4 * L::kRes;
        tma_load_split<DP, kTileRows>(res, &k_map, kv_full,
                                      k0 + c * kTileRows, slice);
        tma_load_split<DP, kTileRows>(res + 2 * L::kRes, &v_map, kv_full,
                                      k0 + c * kTileRows, slice);
      }
      for (int n = 0; n < 4 * n_tiles; ++n) {
        const int st = n % L::kStages, it = n / 4, part = n % 4;
        mbar_wait(empty + st, ((n / L::kStages) & 1) ^ 1);
        mbar_expect_tx(full + st, L::kPart + (part ? 0 : L::kRowBytes));
        unsigned char* dst = smem + L::stages + st * L::kPart;
        if (part == 0) {
          tma_load_split<DP, B>(dst, &q_map, full + st, it * B, slice);
          tma_load(smem + L::rows + st * L::kRowBytes, &rows_map, full + st,
                   it * B, 2 * slice);
        } else if (part == 1) {
          tma_load_split<DP, B>(dst, &do_map, full + st, it * B, slice);
        } else {
          tma_load_trans<DP, B>(dst, part == 2 ? &dot_map : &qt_map,
                                full + st, it * B, slice);
        }
      }
    }
  } else {  // a consumer: keys k0 + 64 wg .. + 63
    regs_alloc<kConsumerRegs>();
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, t = lane % 4;
    const uint32_t k_hi = smem_addr(smem + L::resident + wg * 4 * L::kRes);
    const uint32_t k_lo = k_hi + L::kRes, v_hi = k_lo + L::kRes,
                   v_lo = v_hi + L::kRes;
    float dk_acc[DP / 2], dv_acc[DP / 2];
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;
    mbar_wait(kv_full, 0);

    for (int it = 0; it < n_tiles; ++it) {
      const int n = 4 * it;
      const uint32_t q_hi = wait_part<L>(full, smem, n);
      const uint32_t do_hi = wait_part<L>(full, smem, n + 1);

      // S^T = K q^T and dP^T = V dO^T: element 4n + e is key g + 8 (e >> 1),
      // query it * B + 8n + 2t + (e & 1)
      float p[B / 2], dp[B / 2];
      wgmma_fence();
      product3_ss<B, kTileRows, DP / 8>(p, k_hi, k_lo, q_hi,
                                        q_hi + L::kPlane);
      product3_ss<B, kTileRows, DP / 8>(dp, v_hi, v_lo, do_hi,
                                        do_hi + L::kPlane);
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(p);
      fence_acc(dp);

      const float* lse_s = reinterpret_cast<const float*>(
          smem + L::rows + (n % L::kStages) * L::kRowBytes);
      dkdv_scores_f32<B>(p, dp, lse_s, lse_s + B, scale_log2, t);
      mbar_arrive(empty + n % L::kStages);
      mbar_arrive(empty + (n + 1) % L::kStages);

      // dV += P^T dO (dO^T's rows), then dK += dS^T q (q^T's rows), each
      // tile's product summed apart (acc_tile)
      uint32_t ph[B / 8][4], pl[B / 8][4];
      split_fragments<B>(p, ph, pl);
      const uint32_t dot_hi = wait_part<L>(full, smem, n + 2);
      acc_tile<DP, B>(dv_acc, ph, pl, dot_hi, dot_hi + L::kPlane);
      mbar_arrive(empty + (n + 2) % L::kStages);
      uint32_t sh[B / 8][4], sl[B / 8][4];
      split_fragments<B>(dp, sh, sl);
      const uint32_t qt_hi = wait_part<L>(full, smem, n + 3);
      acc_tile<DP, B>(dk_acc, sh, sl, qt_hi, qt_hi + L::kPlane);
      mbar_arrive(empty + (n + 3) % L::kStages);
    }

    const size_t base = (size_t)slice * S * D;
    const int row0 = k0 + wg * kTileRows;
    store_rows_f32<DP>(dk_acc, dk + base, row0, S, D, scale, warp, g, t);
    store_rows_f32<DP>(dv_acc, dv + base, row0, S, D, 1.f, warp, g, t);
  }
}

template <int DP>
__global__ void __launch_bounds__(BwdSmemF32<DP, 3>::kThreads, 1)
flash_bwd_dq_f32_kernel(const __grid_constant__ CUtensorMap q_map,
                        const __grid_constant__ CUtensorMap do_map,
                        const __grid_constant__ CUtensorMap k_map,
                        const __grid_constant__ CUtensorMap v_map,
                        const __grid_constant__ CUtensorMap kt_map,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        float* __restrict__ dq, int S, int D,
                        float scale_log2, float scale) {
  using L = BwdSmemF32<DP, 3>;
  constexpr int B = L::kBlk;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::bars);
  uint64_t* empty = full + L::kStages;
  uint64_t* qdo_full = empty + L::kStages;
  constexpr int kRows = L::kConsumers * kTileRows;
  const int n_blocks = (S + kRows - 1) / kRows;
  const int slice = blockIdx.x / n_blocks;
  const int q0 = (blockIdx.x % n_blocks) * kRows;
  const int n_tiles = (S + B - 1) / B;
  const int wg = threadIdx.x / 128;
  init_ring<L>(full);

  if (wg == L::kConsumers) {  // the producer
    regs_dealloc<kProducerRegs>();
    if (threadIdx.x == L::kConsumers * 128) {
      mbar_expect_tx(qdo_full, 4 * L::kConsumers * L::kRes);
      for (int c = 0; c < L::kConsumers; ++c) {
        unsigned char* res = smem + L::resident + c * 4 * L::kRes;
        tma_load_split<DP, kTileRows>(res, &q_map, qdo_full,
                                      q0 + c * kTileRows, slice);
        tma_load_split<DP, kTileRows>(res + 2 * L::kRes, &do_map, qdo_full,
                                      q0 + c * kTileRows, slice);
      }
      for (int n = 0; n < 3 * n_tiles; ++n) {
        const int st = n % L::kStages, it = n / 3, part = n % 3;
        mbar_wait(empty + st, ((n / L::kStages) & 1) ^ 1);
        mbar_expect_tx(full + st, L::kPart);
        unsigned char* dst = smem + L::stages + st * L::kPart;
        if (part < 2)
          tma_load_split<DP, B>(dst, part ? &v_map : &k_map, full + st,
                                it * B, slice);
        else
          tma_load_trans<DP, B>(dst, &kt_map, full + st, it * B, slice);
      }
    }
  } else {  // a consumer: queries q0 + 64 wg .. + 63
    regs_alloc<kConsumerRegs>();
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, t = lane % 4;
    const int row0 = q0 + wg * kTileRows;
    const uint32_t q_hi = smem_addr(smem + L::resident + wg * 4 * L::kRes);
    const uint32_t q_lo = q_hi + L::kRes, do_hi = q_lo + L::kRes,
                   do_lo = do_hi + L::kRes;
    // this thread's query rows g and g + 8 of its warp's 16: lse2 (+inf
    // past S, so P = 0 there) and delta
    float lse_r[2], delta_r[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + warp * 16 + g + 8 * r;
      lse_r[r] = row < S ? lse[(size_t)slice * S + row] : INFINITY;
      delta_r[r] = row < S ? delta[(size_t)slice * S + row] : 0.f;
    }
    float dq_acc[DP / 2];
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) dq_acc[i] = 0.f;
    mbar_wait(qdo_full, 0);

    for (int it = 0; it < n_tiles; ++it) {
      const int n = 3 * it;
      const uint32_t k_hi = wait_part<L>(full, smem, n);
      const uint32_t v_hi = wait_part<L>(full, smem, n + 1);

      // S = q K^T and dP = dO V^T: element 4n + e is query g + 8 (e >> 1),
      // key it * B + 8n + 2t + (e & 1)
      float p[B / 2], ds[B / 2];
      wgmma_fence();
      product3_ss<B, kTileRows, DP / 8>(p, q_hi, q_lo, k_hi,
                                        k_hi + L::kPlane);
      product3_ss<B, kTileRows, DP / 8>(ds, do_hi, do_lo, v_hi,
                                        v_hi + L::kPlane);
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(p);
      fence_acc(ds);
      mbar_arrive(empty + n % L::kStages);
      mbar_arrive(empty + (n + 1) % L::kStages);

      dq_scores(p, ds, lse_r, delta_r, it * B, S, scale_log2, t);
      // dQ += dS K (K^T's rows), each tile's product summed apart
      uint32_t sh[B / 8][4], sl[B / 8][4];
      split_fragments<B>(ds, sh, sl);
      const uint32_t kt_hi = wait_part<L>(full, smem, n + 2);
      acc_tile<DP, B>(dq_acc, sh, sl, kt_hi, kt_hi + L::kPlane);
      mbar_arrive(empty + (n + 2) % L::kStages);
    }

    store_rows_f32<DP>(dq_acc, dq + (size_t)slice * S * D, row0, S, D, scale,
                       warp, g, t);
  }
}

// ---------------------------------------------------------------------------
// D > 128: the wide kernels, TMA + wgmma over D-chunks, nothing resident
//
// A block is one consumer warpgroup of 64 rows (dK/dV: keys; dQ: queries)
// and the output columns [128 j, 128 j + 128) (slice j of ceil(D / 128)),
// and a producer warpgroup whose one thread streams everything a tile of
// the other side needs through a ring: the D-chunks of the two score
// products (a chunk's two operands a slot), then the slice's operands of
// the output products. Each block recomputes P and dS over the whole of D
// for its slice, so the scores' products run once per slice: with n
// slices the pair does (2 + 2n) (dK/dV) and (2 + n) (dQ) units of an
// (S, S, D) product where one pass would do 4 and 3. Nothing is resident,
// so D has no bound but that of the grid.

struct WideBwdSmem {
  using T = Tile<128>;
  static constexpr int kConsumers = 1;
  static constexpr int kThreads = 256;
  static constexpr int kStages = 6;
  static constexpr uint32_t kPart = 2 * T::kBytes;
  static constexpr uint32_t kRowBytes = 2 * kTileRows * 4;
  static constexpr uint32_t stages = 0;
  static constexpr uint32_t rows = kStages * kPart;
  static constexpr uint32_t bars = rows + kStages * kRowBytes;
  static constexpr size_t bytes = bars + 8 * (2 * kStages + 1) + 1024;
};

__global__ void __launch_bounds__(WideBwdSmem::kThreads, 1)
flash_bwd_dkdv_wide_bf16_kernel(const __grid_constant__ CUtensorMap q_map,
                                const __grid_constant__ CUtensorMap k_map,
                                const __grid_constant__ CUtensorMap v_map,
                                const __grid_constant__ CUtensorMap do_map,
                                const __grid_constant__ CUtensorMap rows_map,
                                bf16* __restrict__ dk, bf16* __restrict__ dv,
                                int S, int D, float scale_log2, float scale) {
  using T = Tile<128>;
  using L = WideBwdSmem;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::bars);
  uint64_t* empty = full + L::kStages;
  const int n_blocks = (S + kTileRows - 1) / kTileRows;
  const int n_chunks = (D + 127) / 128;
  const int rest = blockIdx.x / n_blocks;
  const int k0 = blockIdx.x % n_blocks * kTileRows;
  const int j = rest % n_chunks, slice = rest / n_chunks;
  const int n_tiles = (S + kBlockQ - 1) / kBlockQ;
  const int parts = 2 * n_chunks + 1;  // ring slots a query tile
  const int wg = threadIdx.x / 128;
  init_ring<L>(full);

  if (wg == 1) {  // the producer
    regs_dealloc<kProducerRegs>();
    if (threadIdx.x == 128) {
      for (int n = 0; n < n_tiles * parts; ++n) {
        const int it = n / parts, c = n % parts, st = n % L::kStages;
        const int q0 = it * kBlockQ;
        mbar_wait(empty + st, ((n / L::kStages) & 1) ^ 1);
        unsigned char* dst = smem + st * L::kPart;
        if (c < 2 * n_chunks) {
          // S^T's chunks (K_c, q_c), then dP^T's (V_c, dO_c)
          const bool s_part = c < n_chunks;
          const int col = 128 * (c % n_chunks);
          mbar_expect_tx(full + st, 2 * T::kBytes);
          tma_load_tile<128>(dst, s_part ? &k_map : &v_map, full + st, k0,
                             slice, col);
          tma_load_tile<128>(dst + T::kBytes, s_part ? &q_map : &do_map,
                             full + st, q0, slice, col);
        } else {
          // the slice's dO and q, with the tile's lse2 and delta rows
          mbar_expect_tx(full + st, 2 * T::kBytes + L::kRowBytes);
          tma_load_tile<128>(dst, &do_map, full + st, q0, slice, 128 * j);
          tma_load_tile<128>(dst + T::kBytes, &q_map, full + st, q0, slice,
                             128 * j);
          tma_load(smem + L::rows + st * L::kRowBytes, &rows_map, full + st,
                   q0, 2 * slice);
        }
      }
    }
  } else {  // the consumer: keys k0 .. k0 + 63
    regs_alloc<kConsumerRegs>();
    const int tid = threadIdx.x;
    const int warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, t = lane % 4;
    float dk_acc[64], dv_acc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) dk_acc[i] = dv_acc[i] = 0.f;

    for (int it = 0; it < n_tiles; ++it) {
      // S^T = K q^T and dP^T = V dO^T over every chunk: element 4n + e is
      // key g + 8 (e >> 1), query it * 64 + 8n + 2t + (e & 1)
      const int n0 = it * parts;
      float p[32], ds[32];
      chunk_scores<L>(p, full, smem, n0, n_chunks);
      chunk_scores<L>(ds, full, smem, n0 + n_chunks, n_chunks);
      const int n = n0 + 2 * n_chunks, st = n % L::kStages;
      // the slice's dO and q tiles, with the tile's rows
      const uint32_t do_tile = wait_part<L>(full, smem, n);
      const float* lse_s =
          reinterpret_cast<const float*>(smem + L::rows + st * L::kRowBytes);
      dkdv_tile<128>(p, ds, dk_acc, dv_acc, lse_s, lse_s + kTileRows,
                     do_tile, do_tile + T::kBytes, scale_log2, t);
      mbar_arrive(empty + st);
    }

    const size_t base = (size_t)slice * S * D + 128 * j;
    store_rows<128>(dk_acc, dk + base, k0, S, D, scale, warp, g, t,
                    D - 128 * j);
    store_rows<128>(dv_acc, dv + base, k0, S, D, 1.f, warp, g, t,
                    D - 128 * j);
  }
}

__global__ void __launch_bounds__(WideBwdSmem::kThreads, 1)
flash_bwd_dq_wide_bf16_kernel(const __grid_constant__ CUtensorMap q_map,
                              const __grid_constant__ CUtensorMap k_map,
                              const __grid_constant__ CUtensorMap v_map,
                              const __grid_constant__ CUtensorMap do_map,
                              const float* __restrict__ lse,
                              const float* __restrict__ delta,
                              bf16* __restrict__ dq, int S, int D,
                              float scale_log2, float scale) {
  using T = Tile<128>;
  using L = WideBwdSmem;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::bars);
  uint64_t* empty = full + L::kStages;
  const int n_blocks = (S + kTileRows - 1) / kTileRows;
  const int n_chunks = (D + 127) / 128;
  const int rest = blockIdx.x / n_blocks;
  const int q0 = blockIdx.x % n_blocks * kTileRows;
  const int j = rest % n_chunks, slice = rest / n_chunks;
  const int n_tiles = (S + kBlockK - 1) / kBlockK;
  const int parts = 2 * n_chunks + 1;  // ring slots a key tile
  const int wg = threadIdx.x / 128;
  init_ring<L>(full);

  if (wg == 1) {  // the producer
    regs_dealloc<kProducerRegs>();
    if (threadIdx.x == 128) {
      for (int n = 0; n < n_tiles * parts; ++n) {
        const int it = n / parts, c = n % parts, st = n % L::kStages;
        const int kt = it * kBlockK;
        mbar_wait(empty + st, ((n / L::kStages) & 1) ^ 1);
        unsigned char* dst = smem + st * L::kPart;
        if (c < 2 * n_chunks) {
          // S's chunks (q_c, K_c), then dP's (dO_c, V_c)
          const bool s_part = c < n_chunks;
          const int col = 128 * (c % n_chunks);
          mbar_expect_tx(full + st, 2 * T::kBytes);
          tma_load_tile<128>(dst, s_part ? &q_map : &do_map, full + st, q0,
                             slice, col);
          tma_load_tile<128>(dst + T::kBytes, s_part ? &k_map : &v_map,
                             full + st, kt, slice, col);
        } else {  // K's slice
          mbar_expect_tx(full + st, T::kBytes);
          tma_load_tile<128>(dst, &k_map, full + st, kt, slice, 128 * j);
        }
      }
    }
  } else {  // the consumer: queries q0 .. q0 + 63
    regs_alloc<kConsumerRegs>();
    const int tid = threadIdx.x;
    const int warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, t = lane % 4;
    float lse_r[2], delta_r[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = q0 + warp * 16 + g + 8 * r;
      lse_r[r] = row < S ? lse[(size_t)slice * S + row] : INFINITY;
      delta_r[r] = row < S ? delta[(size_t)slice * S + row] : 0.f;
    }
    float dq_acc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) dq_acc[i] = 0.f;

    for (int it = 0; it < n_tiles; ++it) {
      // S = q K^T and dP = dO V^T over every chunk: element 4n + e is
      // query g + 8 (e >> 1), key it * 64 + 8n + 2t + (e & 1)
      const int n0 = it * parts;
      float p[32], ds[32];
      chunk_scores<L>(p, full, smem, n0, n_chunks);
      chunk_scores<L>(ds, full, smem, n0 + n_chunks, n_chunks);

      dq_scores(p, ds, lse_r, delta_r, it * kBlockK, S, scale_log2, t);
      // dQ += dS K over K's slice
      const int n = n0 + 2 * n_chunks;
      dq_product<128>(ds, dq_acc, wait_part<L>(full, smem, n));
      mbar_arrive(empty + n % L::kStages);
    }

    store_rows<128>(dq_acc, dq + (size_t)slice * S * D + 128 * j, q0, S, D,
                    scale, warp, g, t, D - 128 * j);
  }
}

// float32: the same blocks on the 3xTF32 planes of the pre-pass. A score
// chunk is 64 columns: the block's own 64 rows (dK/dV: K or V; dQ: q or
// dO) and kBlk = 32 rows of the streamed side, hi and lo planes each, one
// slot; each chunk's product is summed in a fresh accumulator and added on
// the CUDA cores (as acc_tile does); the output products read the slice's
// 128 rows of the transposed planes (dO^T and q^T; K^T), one slot each.
struct WideBwdSmemF32 {
  static constexpr int kConsumers = 1;
  static constexpr int kThreads = 256;
  static constexpr int kW = 64;    // columns of a score chunk
  static constexpr int kBlk = 32;  // streamed rows a tile
  static constexpr uint32_t kOwnPlane = kTileRows * kW * 4;  // 16 KB
  static constexpr uint32_t kStrPlane = kBlk * kW * 4;       // 8 KB
  static constexpr uint32_t kOutPlane = 128 * kBlk * 4;      // 16 KB
  static constexpr uint32_t kPart = 2 * kOwnPlane + 2 * kStrPlane;
  static_assert(2 * kOutPlane <= kPart, "slot");
  static constexpr int kStages = 4;
  static constexpr uint32_t kRowBytes = 2 * kBlk * 4;
  static constexpr uint32_t stages = 0;
  static constexpr uint32_t rows = kStages * kPart;
  static constexpr uint32_t bars = rows + kStages * kRowBytes;
  static constexpr size_t bytes = bars + 8 * (2 * kStages + 1) + 1024;
};

// d (64 x kBlk) = sum over `chunks` score chunks at ring positions n0 ..,
// each the block's rows A_c and the streamed rows B_c, split hi / lo
__device__ __forceinline__ void chunk_scores_f32(float (&d)[16],
                                                 uint64_t* full,
                                                 unsigned char* smem, int n0,
                                                 int chunks) {
  using L = WideBwdSmemF32;
#pragma unroll
  for (int i = 0; i < 16; ++i) d[i] = 0.f;
  for (int c = 0; c < chunks; ++c) {
    const uint32_t a = wait_part<L>(full, smem, n0 + c);
    const uint32_t b = a + 2 * L::kOwnPlane;
    float tmp[16];
    wgmma_fence();
    product3_ss<L::kBlk, kTileRows, L::kW / 8>(tmp, a, a + L::kOwnPlane, b,
                                               b + L::kStrPlane);
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(tmp);
    mbar_arrive(full + L::kStages + (n0 + c) % L::kStages);
#pragma unroll
    for (int i = 0; i < 16; ++i) d[i] += tmp[i];
  }
}

__global__ void __launch_bounds__(WideBwdSmemF32::kThreads, 1)
flash_bwd_dkdv_wide_f32_kernel(const __grid_constant__ CUtensorMap k_map,
                               const __grid_constant__ CUtensorMap v_map,
                               const __grid_constant__ CUtensorMap q_map,
                               const __grid_constant__ CUtensorMap do_map,
                               const __grid_constant__ CUtensorMap dot_map,
                               const __grid_constant__ CUtensorMap qt_map,
                               const __grid_constant__ CUtensorMap rows_map,
                               float* __restrict__ dk, float* __restrict__ dv,
                               int S, int D, float scale_log2, float scale) {
  using L = WideBwdSmemF32;
  constexpr int B = L::kBlk;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::bars);
  uint64_t* empty = full + L::kStages;
  const int n_blocks = (S + kTileRows - 1) / kTileRows;
  const int n_chunks = (D + L::kW - 1) / L::kW;
  const int n_slices = (D + 127) / 128;
  const int rest = blockIdx.x / n_blocks;
  const int k0 = blockIdx.x % n_blocks * kTileRows;
  const int j = rest % n_slices, slice = rest / n_slices;
  const int n_tiles = (S + B - 1) / B;
  const int parts = 2 * n_chunks + 2;  // ring slots a query tile
  const int wg = threadIdx.x / 128;
  init_ring<L>(full);

  if (wg == 1) {  // the producer
    regs_dealloc<kProducerRegs>();
    if (threadIdx.x == 128) {
      for (int n = 0; n < n_tiles * parts; ++n) {
        const int it = n / parts, c = n % parts, st = n % L::kStages;
        mbar_wait(empty + st, ((n / L::kStages) & 1) ^ 1);
        unsigned char* dst = smem + st * L::kPart;
        if (c < 2 * n_chunks) {
          // S^T's chunks (K_c, q_c), then dP^T's (V_c, dO_c)
          const bool s_part = c < n_chunks;
          const int col = L::kW * (c % n_chunks);
          mbar_expect_tx(full + st, L::kPart);
          tma_load_split<L::kW, kTileRows>(dst, s_part ? &k_map : &v_map,
                                           full + st, k0, slice, col);
          tma_load_split<L::kW, B>(dst + 2 * L::kOwnPlane,
                                   s_part ? &q_map : &do_map, full + st,
                                   it * B, slice, col);
        } else if (c == 2 * n_chunks) {  // dO^T's slice, lse2 and delta
          mbar_expect_tx(full + st, 2 * L::kOutPlane + L::kRowBytes);
          tma_load_trans<128, B>(dst, &dot_map, full + st, it * B, slice,
                                 128 * j);
          tma_load(smem + L::rows + st * L::kRowBytes, &rows_map, full + st,
                   it * B, 2 * slice);
        } else {  // q^T's slice
          mbar_expect_tx(full + st, 2 * L::kOutPlane);
          tma_load_trans<128, B>(dst, &qt_map, full + st, it * B, slice,
                                 128 * j);
        }
      }
    }
  } else {  // the consumer: keys k0 .. k0 + 63
    regs_alloc<kConsumerRegs>();
    const int tid = threadIdx.x;
    const int warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, t = lane % 4;
    float dk_acc[64], dv_acc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) dk_acc[i] = dv_acc[i] = 0.f;

    for (int it = 0; it < n_tiles; ++it) {
      const int n0 = it * parts;
      float p[B / 2], dp[B / 2];
      chunk_scores_f32(p, full, smem, n0, n_chunks);
      chunk_scores_f32(dp, full, smem, n0 + n_chunks, n_chunks);
      const int n = n0 + 2 * n_chunks;
      const uint32_t dot_hi = wait_part<L>(full, smem, n);
      const float* lse_s = reinterpret_cast<const float*>(
          smem + L::rows + (n % L::kStages) * L::kRowBytes);
      dkdv_scores_f32<B>(p, dp, lse_s, lse_s + B, scale_log2, t);
      // dV += P^T dO (dO^T's rows), then dK += dS^T q (q^T's rows)
      uint32_t ph[B / 8][4], pl[B / 8][4];
      split_fragments<B>(p, ph, pl);
      acc_tile<128, B>(dv_acc, ph, pl, dot_hi, dot_hi + L::kOutPlane);
      mbar_arrive(empty + n % L::kStages);
      uint32_t sh[B / 8][4], sl[B / 8][4];
      split_fragments<B>(dp, sh, sl);
      const uint32_t qt_hi = wait_part<L>(full, smem, n + 1);
      acc_tile<128, B>(dk_acc, sh, sl, qt_hi, qt_hi + L::kOutPlane);
      mbar_arrive(empty + (n + 1) % L::kStages);
    }

    const size_t base = (size_t)slice * S * D + 128 * j;
    store_rows_f32<128>(dk_acc, dk + base, k0, S, D, scale, warp, g, t,
                        D - 128 * j);
    store_rows_f32<128>(dv_acc, dv + base, k0, S, D, 1.f, warp, g, t,
                        D - 128 * j);
  }
}

__global__ void __launch_bounds__(WideBwdSmemF32::kThreads, 1)
flash_bwd_dq_wide_f32_kernel(const __grid_constant__ CUtensorMap q_map,
                             const __grid_constant__ CUtensorMap do_map,
                             const __grid_constant__ CUtensorMap k_map,
                             const __grid_constant__ CUtensorMap v_map,
                             const __grid_constant__ CUtensorMap kt_map,
                             const float* __restrict__ lse,
                             const float* __restrict__ delta,
                             float* __restrict__ dq, int S, int D,
                             float scale_log2, float scale) {
  using L = WideBwdSmemF32;
  constexpr int B = L::kBlk;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::bars);
  uint64_t* empty = full + L::kStages;
  const int n_blocks = (S + kTileRows - 1) / kTileRows;
  const int n_chunks = (D + L::kW - 1) / L::kW;
  const int n_slices = (D + 127) / 128;
  const int rest = blockIdx.x / n_blocks;
  const int q0 = blockIdx.x % n_blocks * kTileRows;
  const int j = rest % n_slices, slice = rest / n_slices;
  const int n_tiles = (S + B - 1) / B;
  const int parts = 2 * n_chunks + 1;  // ring slots a key tile
  const int wg = threadIdx.x / 128;
  init_ring<L>(full);

  if (wg == 1) {  // the producer
    regs_dealloc<kProducerRegs>();
    if (threadIdx.x == 128) {
      for (int n = 0; n < n_tiles * parts; ++n) {
        const int it = n / parts, c = n % parts, st = n % L::kStages;
        mbar_wait(empty + st, ((n / L::kStages) & 1) ^ 1);
        unsigned char* dst = smem + st * L::kPart;
        if (c < 2 * n_chunks) {
          // S's chunks (q_c, K_c), then dP's (dO_c, V_c)
          const bool s_part = c < n_chunks;
          const int col = L::kW * (c % n_chunks);
          mbar_expect_tx(full + st, L::kPart);
          tma_load_split<L::kW, kTileRows>(dst, s_part ? &q_map : &do_map,
                                           full + st, q0, slice, col);
          tma_load_split<L::kW, B>(dst + 2 * L::kOwnPlane,
                                   s_part ? &k_map : &v_map, full + st,
                                   it * B, slice, col);
        } else {  // K^T's slice
          mbar_expect_tx(full + st, 2 * L::kOutPlane);
          tma_load_trans<128, B>(dst, &kt_map, full + st, it * B, slice,
                                 128 * j);
        }
      }
    }
  } else {  // the consumer: queries q0 .. q0 + 63
    regs_alloc<kConsumerRegs>();
    const int tid = threadIdx.x;
    const int warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, t = lane % 4;
    float lse_r[2], delta_r[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = q0 + warp * 16 + g + 8 * r;
      lse_r[r] = row < S ? lse[(size_t)slice * S + row] : INFINITY;
      delta_r[r] = row < S ? delta[(size_t)slice * S + row] : 0.f;
    }
    float dq_acc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) dq_acc[i] = 0.f;

    for (int it = 0; it < n_tiles; ++it) {
      const int n0 = it * parts;
      float p[B / 2], ds[B / 2];
      chunk_scores_f32(p, full, smem, n0, n_chunks);
      chunk_scores_f32(ds, full, smem, n0 + n_chunks, n_chunks);
      dq_scores(p, ds, lse_r, delta_r, it * B, S, scale_log2, t);
      // dQ += dS K (K^T's rows)
      uint32_t sh[B / 8][4], sl[B / 8][4];
      split_fragments<B>(ds, sh, sl);
      const int n = n0 + 2 * n_chunks;
      const uint32_t kt_hi = wait_part<L>(full, smem, n);
      acc_tile<128, B>(dq_acc, sh, sl, kt_hi, kt_hi + L::kOutPlane);
      mbar_arrive(empty + n % L::kStages);
    }

    store_rows_f32<128>(dq_acc, dq + (size_t)slice * S * D + 128 * j, q0, S,
                        D, scale, warp, g, t, D - 128 * j);
  }
}

// ---------------------------------------------------------------------------
// launch

// the (bh, 2, sp) row buffer as a 2-D map (sp, 2 bh): one box is a
// streamed tile's lse2 and delta (`box` rows)
cudaError_t rows_map(CUtensorMap* map, const float* rows, int bh, int sp,
                     int box = kTileRows) {
  const cuuint64_t dims[2] = {(cuuint64_t)sp, 2ull * bh};
  const cuuint64_t strides[1] = {4ull * sp};
  const cuuint32_t box_dims[2] = {(cuuint32_t)box, 2};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, rows, dims, strides,
                box_dims, CU_TENSOR_MAP_SWIZZLE_NONE);
}

// the float32 scratch: split planes of q, K, V, dO (4 x bh x 2 x s x d),
// then transposed planes of q, dO, K (3 x bh x 2 x d x sp)
struct F32Planes {
  float* split;
  float* trans;
  size_t plane, tplane;
  F32Planes(void* scratch, int bh, int s, int sp, int d)
      : split(static_cast<float*>(scratch)),
        trans(split + 8 * (size_t)bh * s * d),
        plane(2 * (size_t)bh * s * d),
        tplane(2 * (size_t)bh * d * sp) {}
  const float* q() const { return split; }
  const float* k() const { return split + plane; }
  const float* v() const { return split + 2 * plane; }
  const float* dout() const { return split + 3 * plane; }
  const float* qt() const { return trans; }
  const float* dot() const { return trans + tplane; }
  const float* kt() const { return trans + 2 * tplane; }
};

// a one-dimensional grid of row blocks times `bh` slices times `slices`
// output slices, or 0 where it exceeds gridDim.x's 2^31 - 1
unsigned grid_of(int s, int rows, int bh, int slices = 1) {
  const long long n = (long long)((s + rows - 1) / rows) * bh * slices;
  return n <= 0x7fffffffll ? (unsigned)n : 0u;
}

// The pre-pass: delta, the padded rows, and in float32 the operand planes.
// LPR (bf16): threads a row, 8 columns each at a time.
template <int LPR>
cudaError_t launch_rows(const void* q, const void* k, const void* v,
                        const void* o, const void* dout, const float* lse,
                        float* delta, float* rows, void* scratch, int bh,
                        int s, int d, bool use_bf16, cudaStream_t st) {
  const int sp = round_up_tile(s);
  if (use_bf16) {
    const size_t threads = (size_t)bh * sp * LPR;
    const size_t blocks = (threads + kDeltaThreads - 1) / kDeltaThreads;
    if (blocks > 0x7fffffffull) return cudaErrorInvalidValue;
    flash_bwd_rows_bf16_kernel<LPR><<<(unsigned)blocks, kDeltaThreads, 0,
                                      st>>>(
        static_cast<const bf16*>(o), static_cast<const bf16*>(dout), lse,
        delta, rows, bh, s, sp, d);
  } else {
    const F32Planes f(scratch, bh, s, sp, d);
    const unsigned grid = grid_of(sp, kTileRows, bh);
    if (!grid) return cudaErrorInvalidValue;
    flash_bwd_rows_f32_kernel<<<grid, kDeltaThreads, 0, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(o),
        static_cast<const float*>(dout), lse, delta, rows, f.split, f.trans,
        bh, s, sp, d);
  }
  return cudaGetLastError();
}

// the scores' scales D^-1/2 and D^-1/2 log2(e) of the head width `d`
struct Scales {
  float scale, scale_log2;
  explicit Scales(int d)
      : scale((float)(1.0 / sqrt((double)d))),
        scale_log2((float)(kLog2e / sqrt((double)d))) {}
};

template <int DP>
cudaError_t launch_dkdv(const void* q, const void* k, const void* v,
                        const void* dout, void* rows, void* scratch, void* dk,
                        void* dv, int bh, int s, int d, Scales sc,
                        bool use_bf16, cudaStream_t st) {
  const float scale = sc.scale, scale_log2 = sc.scale_log2;
  const int sp = round_up_tile(s);
  cudaError_t err;
  if (use_bf16) {
    CUtensorMap qm, km, vm, dom, rm;
    if ((err = tile_map<DP>(&qm, q, bh, s, d)) ||
        (err = tile_map<DP>(&km, k, bh, s, d)) ||
        (err = tile_map<DP>(&vm, v, bh, s, d)) ||
        (err = tile_map<DP>(&dom, dout, bh, s, d)) ||
        (err = rows_map(&rm, static_cast<float*>(rows), bh, sp)))
      return err;
    using L = BwdSmem<DP, true>;
    static std::atomic<uint64_t> smem_set{0};
    if ((err = set_smem_once(flash_bwd_dkdv_bf16_kernel<DP>, L::bytes,
                             smem_set)))
      return err;
    static const cudaError_t pool = check_register_pool(
        flash_bwd_dkdv_bf16_kernel<DP>, L::kConsumers);
    if (pool != cudaSuccess) return pool;
    const unsigned grid = grid_of(s, L::kConsumers * kTileRows, bh);
    if (!grid) return cudaErrorInvalidValue;
    flash_bwd_dkdv_bf16_kernel<DP><<<grid, L::kThreads, L::bytes, st>>>(
        qm, km, vm, dom, rm, static_cast<bf16*>(dk), static_cast<bf16*>(dv),
        s, d, scale_log2, scale);
  } else {
    const F32Planes f(scratch, bh, s, sp, d);
    using L = BwdSmemF32<DP, 4>;
    CUtensorMap km, vm, qm, dom, dotm, qtm, rm;
    if ((err = split_map(&km, f.k(), bh, s, d, kTileRows)) ||
        (err = split_map(&vm, f.v(), bh, s, d, kTileRows)) ||
        (err = split_map(&qm, f.q(), bh, s, d, L::kBlk)) ||
        (err = split_map(&dom, f.dout(), bh, s, d, L::kBlk)) ||
        (err = trans_map(&dotm, f.dot(), bh, d, sp, DP)) ||
        (err = trans_map(&qtm, f.qt(), bh, d, sp, DP)) ||
        (err = rows_map(&rm, static_cast<float*>(rows), bh, sp, L::kBlk)))
      return err;
    static std::atomic<uint64_t> smem_set{0};
    if ((err = set_smem_once(flash_bwd_dkdv_f32_kernel<DP>, L::bytes,
                             smem_set)))
      return err;
    static const cudaError_t pool = check_register_pool(
        flash_bwd_dkdv_f32_kernel<DP>, L::kConsumers);
    if (pool != cudaSuccess) return pool;
    const unsigned grid = grid_of(s, L::kConsumers * kTileRows, bh);
    if (!grid) return cudaErrorInvalidValue;
    flash_bwd_dkdv_f32_kernel<DP><<<grid, L::kThreads, L::bytes, st>>>(
        km, vm, qm, dom, dotm, qtm, rm, static_cast<float*>(dk),
        static_cast<float*>(dv), s, d, scale_log2, scale);
  }
  return cudaGetLastError();
}

cudaError_t launch_dkdv_wide(const void* q, const void* k, const void* v,
                             const void* dout, void* rows, void* scratch,
                             void* dk, void* dv, int bh, int s, int d,
                             Scales sc, bool use_bf16, cudaStream_t st) {
  const float scale = sc.scale, scale_log2 = sc.scale_log2;
  const int sp = round_up_tile(s);
  const int slices = (d + 127) / 128;
  cudaError_t err;
  if (use_bf16) {
    using L = WideBwdSmem;
    CUtensorMap qm, km, vm, dom, rm;
    if ((err = tile_map<128>(&qm, q, bh, s, d)) ||
        (err = tile_map<128>(&km, k, bh, s, d)) ||
        (err = tile_map<128>(&vm, v, bh, s, d)) ||
        (err = tile_map<128>(&dom, dout, bh, s, d)) ||
        (err = rows_map(&rm, static_cast<float*>(rows), bh, sp)))
      return err;
    static std::atomic<uint64_t> smem_set{0};
    if ((err = set_smem_once(flash_bwd_dkdv_wide_bf16_kernel, L::bytes,
                             smem_set)))
      return err;
    static const cudaError_t pool =
        check_register_pool(flash_bwd_dkdv_wide_bf16_kernel, L::kConsumers);
    if (pool != cudaSuccess) return pool;
    const unsigned grid = grid_of(s, kTileRows, bh, slices);
    if (!grid) return cudaErrorInvalidValue;
    flash_bwd_dkdv_wide_bf16_kernel<<<grid, L::kThreads, L::bytes, st>>>(
        qm, km, vm, dom, rm, static_cast<bf16*>(dk), static_cast<bf16*>(dv),
        s, d, scale_log2, scale);
  } else {
    using L = WideBwdSmemF32;
    const F32Planes f(scratch, bh, s, sp, d);
    CUtensorMap km, vm, qm, dom, dotm, qtm, rm;
    if ((err = split_map(&km, f.k(), bh, s, d, kTileRows)) ||
        (err = split_map(&vm, f.v(), bh, s, d, kTileRows)) ||
        (err = split_map(&qm, f.q(), bh, s, d, L::kBlk)) ||
        (err = split_map(&dom, f.dout(), bh, s, d, L::kBlk)) ||
        (err = trans_map(&dotm, f.dot(), bh, d, sp, 128)) ||
        (err = trans_map(&qtm, f.qt(), bh, d, sp, 128)) ||
        (err = rows_map(&rm, static_cast<float*>(rows), bh, sp, L::kBlk)))
      return err;
    static std::atomic<uint64_t> smem_set{0};
    if ((err = set_smem_once(flash_bwd_dkdv_wide_f32_kernel, L::bytes,
                             smem_set)))
      return err;
    static const cudaError_t pool =
        check_register_pool(flash_bwd_dkdv_wide_f32_kernel, L::kConsumers);
    if (pool != cudaSuccess) return pool;
    const unsigned grid = grid_of(s, kTileRows, bh, slices);
    if (!grid) return cudaErrorInvalidValue;
    flash_bwd_dkdv_wide_f32_kernel<<<grid, L::kThreads, L::bytes, st>>>(
        km, vm, qm, dom, dotm, qtm, rm, static_cast<float*>(dk),
        static_cast<float*>(dv), s, d, scale_log2, scale);
  }
  return cudaGetLastError();
}

template <int DP>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* dout, const float* lse, const float* delta,
                      void* scratch, void* dq, int bh, int s, int d,
                      Scales sc, bool use_bf16, cudaStream_t st) {
  const float scale = sc.scale, scale_log2 = sc.scale_log2;
  cudaError_t err;
  if (use_bf16) {
    CUtensorMap qm, km, vm, dom;
    if ((err = tile_map<DP>(&qm, q, bh, s, d)) ||
        (err = tile_map<DP>(&km, k, bh, s, d)) ||
        (err = tile_map<DP>(&vm, v, bh, s, d)) ||
        (err = tile_map<DP>(&dom, dout, bh, s, d)))
      return err;
    using L = BwdSmem<DP, false>;
    static std::atomic<uint64_t> smem_set{0};
    if ((err = set_smem_once(flash_bwd_dq_bf16_kernel<DP>, L::bytes,
                             smem_set)))
      return err;
    static const cudaError_t pool =
        check_register_pool(flash_bwd_dq_bf16_kernel<DP>, L::kConsumers);
    if (pool != cudaSuccess) return pool;
    const unsigned grid = grid_of(s, L::kConsumers * kTileRows, bh);
    if (!grid) return cudaErrorInvalidValue;
    flash_bwd_dq_bf16_kernel<DP><<<grid, L::kThreads, L::bytes, st>>>(
        qm, km, vm, dom, lse, delta, static_cast<bf16*>(dq), s, d,
        scale_log2, scale);
  } else {
    const int sp = round_up_tile(s);
    const F32Planes f(scratch, bh, s, sp, d);
    using L = BwdSmemF32<DP, 3>;
    CUtensorMap qm, dom, km, vm, ktm;
    if ((err = split_map(&qm, f.q(), bh, s, d, kTileRows)) ||
        (err = split_map(&dom, f.dout(), bh, s, d, kTileRows)) ||
        (err = split_map(&km, f.k(), bh, s, d, L::kBlk)) ||
        (err = split_map(&vm, f.v(), bh, s, d, L::kBlk)) ||
        (err = trans_map(&ktm, f.kt(), bh, d, sp, DP)))
      return err;
    static std::atomic<uint64_t> smem_set{0};
    if ((err = set_smem_once(flash_bwd_dq_f32_kernel<DP>, L::bytes,
                             smem_set)))
      return err;
    static const cudaError_t pool =
        check_register_pool(flash_bwd_dq_f32_kernel<DP>, L::kConsumers);
    if (pool != cudaSuccess) return pool;
    const unsigned grid = grid_of(s, L::kConsumers * kTileRows, bh);
    if (!grid) return cudaErrorInvalidValue;
    flash_bwd_dq_f32_kernel<DP><<<grid, L::kThreads, L::bytes, st>>>(
        qm, dom, km, vm, ktm, lse, delta, static_cast<float*>(dq), s, d,
        scale_log2, scale);
  }
  return cudaGetLastError();
}

cudaError_t launch_dq_wide(const void* q, const void* k, const void* v,
                           const void* dout, const float* lse,
                           const float* delta, void* scratch, void* dq,
                           int bh, int s, int d, Scales sc, bool use_bf16,
                           cudaStream_t st) {
  const float scale = sc.scale, scale_log2 = sc.scale_log2;
  const int slices = (d + 127) / 128;
  cudaError_t err;
  if (use_bf16) {
    using L = WideBwdSmem;
    CUtensorMap qm, km, vm, dom;
    if ((err = tile_map<128>(&qm, q, bh, s, d)) ||
        (err = tile_map<128>(&km, k, bh, s, d)) ||
        (err = tile_map<128>(&vm, v, bh, s, d)) ||
        (err = tile_map<128>(&dom, dout, bh, s, d)))
      return err;
    static std::atomic<uint64_t> smem_set{0};
    if ((err = set_smem_once(flash_bwd_dq_wide_bf16_kernel, L::bytes,
                             smem_set)))
      return err;
    static const cudaError_t pool =
        check_register_pool(flash_bwd_dq_wide_bf16_kernel, L::kConsumers);
    if (pool != cudaSuccess) return pool;
    const unsigned grid = grid_of(s, kTileRows, bh, slices);
    if (!grid) return cudaErrorInvalidValue;
    flash_bwd_dq_wide_bf16_kernel<<<grid, L::kThreads, L::bytes, st>>>(
        qm, km, vm, dom, lse, delta, static_cast<bf16*>(dq), s, d,
        scale_log2, scale);
  } else {
    using L = WideBwdSmemF32;
    const int sp = round_up_tile(s);
    const F32Planes f(scratch, bh, s, sp, d);
    CUtensorMap qm, dom, km, vm, ktm;
    if ((err = split_map(&qm, f.q(), bh, s, d, kTileRows)) ||
        (err = split_map(&dom, f.dout(), bh, s, d, kTileRows)) ||
        (err = split_map(&km, f.k(), bh, s, d, L::kBlk)) ||
        (err = split_map(&vm, f.v(), bh, s, d, L::kBlk)) ||
        (err = trans_map(&ktm, f.kt(), bh, d, sp, 128)))
      return err;
    static std::atomic<uint64_t> smem_set{0};
    if ((err = set_smem_once(flash_bwd_dq_wide_f32_kernel, L::bytes,
                             smem_set)))
      return err;
    static const cudaError_t pool =
        check_register_pool(flash_bwd_dq_wide_f32_kernel, L::kConsumers);
    if (pool != cudaSuccess) return pool;
    const unsigned grid = grid_of(s, kTileRows, bh, slices);
    if (!grid) return cudaErrorInvalidValue;
    flash_bwd_dq_wide_f32_kernel<<<grid, L::kThreads, L::bytes, st>>>(
        qm, dom, km, vm, ktm, lse, delta, static_cast<float*>(dq), s, d,
        scale_log2, scale);
  }
  return cudaGetLastError();
}

bool bad_shape(int bh, int s, int d, int scale_d) {
  return bh <= 0 || s <= 0 || d < 8 || d % 8 || scale_d <= 0;
}

}  // namespace

// q, k, v, o, dout, dk, dv: contiguous (bh, s, d) device arrays of float32
// (is_bf16 == 0) or bfloat16 (is_bf16 == 1), 16-byte aligned, d % 8 == 0 and
// d >= 8; lse (the forward's lse2) and delta: (bh, s) float32; rows: a
// 16-byte aligned (bh, 2, sp) float32 scratch, sp = s rounded up to 64;
// scratch (float32 only, else unused): a 16-byte aligned float32 scratch of
// 8 bh s d + 6 bh d sp elements. The scores are scaled by scale_d^-1/2
// (scale_d: d, or the true width of a head padded with zero columns to d).
// Launches the pre-pass (delta = rowsum(dout * o), written for
// ddti_flash_bwd_dq, the padded rows, and in float32 the split and
// transposed operand planes in `scratch`) and the dK/dV kernel (d > 128:
// the wide kernel) on `stream` without synchronising; returns the first
// cudaError_t (0 = success).
extern "C" int ddti_flash_bwd_dkdv(const void* q, const void* k,
                                   const void* v, const void* o,
                                   const void* dout, const void* lse,
                                   void* delta, void* rows, void* scratch,
                                   void* dk, void* dv, int bh, int s, int d,
                                   int scale_d, int is_bf16, int device,
                                   void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (bad_shape(bh, s, d, scale_d)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool bf = is_bf16 != 0;
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  float* r = static_cast<float*>(rows);
  const Scales sc(scale_d);
  err = d <= 32   ? launch_rows<4>(q, k, v, o, dout, l, dl, r, scratch, bh, s,
                                   d, bf, st)
        : d <= 64 ? launch_rows<8>(q, k, v, o, dout, l, dl, r, scratch, bh,
                                   s, d, bf, st)
                  : launch_rows<16>(q, k, v, o, dout, l, dl, r, scratch, bh,
                                    s, d, bf, st);
  if (err != cudaSuccess) return (int)err;
  if (d <= 32)
    return (int)launch_dkdv<32>(q, k, v, dout, r, scratch, dk, dv, bh, s, d,
                                sc, bf, st);
  if (d <= 64)
    return (int)launch_dkdv<64>(q, k, v, dout, r, scratch, dk, dv, bh, s, d,
                                sc, bf, st);
  if (d <= 128)
    return (int)launch_dkdv<128>(q, k, v, dout, r, scratch, dk, dv, bh, s, d,
                                 sc, bf, st);
  return (int)launch_dkdv_wide(q, k, v, dout, r, scratch, dk, dv, bh, s, d,
                               sc, bf, st);
}

// As ddti_flash_bwd_dkdv, for dq; delta (and in float32 scratch) must hold
// what ddti_flash_bwd_dkdv wrote for the same inputs, earlier on the same
// stream.
extern "C" int ddti_flash_bwd_dq(const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse,
                                 const void* delta, void* scratch, void* dq,
                                 int bh, int s, int d, int scale_d,
                                 int is_bf16, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (bad_shape(bh, s, d, scale_d)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool bf = is_bf16 != 0;
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  const Scales sc(scale_d);
  if (d <= 32)
    return (int)launch_dq<32>(q, k, v, dout, l, dl, scratch, dq, bh, s, d,
                              sc, bf, st);
  if (d <= 64)
    return (int)launch_dq<64>(q, k, v, dout, l, dl, scratch, dq, bh, s, d,
                              sc, bf, st);
  if (d <= 128)
    return (int)launch_dq<128>(q, k, v, dout, l, dl, scratch, dq, bh, s, d,
                               sc, bf, st);
  return (int)launch_dq_wide(q, k, v, dout, l, dl, scratch, dq, bh, s, d,
                             sc, bf, st);
}

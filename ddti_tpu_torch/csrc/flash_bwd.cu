// Flash-attention backward for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the TPU kernels of ddti_tpu/ops/attention.py:
//   _dkdv_kernel and _dkdv_kernel_packed -> flash_bwd_dkdv_*_kernel
//   _dq_kernel and _dq_kernel_packed     -> flash_bwd_dq_*_kernel
// and the per-tile delta = rowsum(dO * O) both TPU kernels compute inline ->
// a pre-pass (flash_bwd_rows_bf16_kernel, flash_bwd_delta_f32_kernel). The
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
// kernels do. dQ has its own kernel (no atomics): every output element is
// summed by one thread in a fixed order, so the result does not depend on
// block scheduling.
//
// Head widths: every D with D % 8 == 0 and 8 <= D <= 128, instantiated for
// the padded widths DP = 32, 64, 128 with the actual D at run time (columns
// D..DP-1 of the staged tiles are zeros and are not written back). Wider
// heads are refused: the dK and dV accumulators live in registers (in bf16
// DP / 2 float32 of each per consumer thread, beside 64 of S^T and dP^T),
// which run out past 128.
//
// What bounds it on an H100 (bf16 dense peak 989 TFLOP/s, 3.35 TB/s, 16
// exp2 per clock per SM at the 1980 MHz boost clock): at the TransUNet
// training shape (B=16, H=8, S=1024, D=32) the pair does five (S, S, D)
// products, 42.9 GFLOP (0.0434 ms at the tensor-core peak), against 67.6 MB
// of q/k/v/o/dO/lse2 in and dq/dk/dv out (0.020 ms); dK/dV alone does four
// of them (S^T, dP^T, dV, dK: 34.4 GFLOP, 0.035 ms), dQ three (S, dP, dQ:
// 25.8 GFLOP, 0.026 ms). Each kernel recomputes P, B*H*S^2 = 134 M exp2:
// 0.032 ms of the exp2 unit alone, so a pair without atomics has an exp2
// floor of 0.064 ms, above its tensor-core bound. Neither kernel writes an
// (S, S) tile to device memory.
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
// Design, float32: scalar FMAs (tensor cores have no full float32 product).
// Four threads own each row of the block's tile; each computes 16 of the
// row's 64 scores and DP/4 of its output columns; the row's P or dS tile
// passes through shared memory within the quad's warp.
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
constexpr int kFmaThreads = 256;  // 4 threads per row
constexpr int kDeltaThreads = 256;
typedef __nv_bfloat16 bf16;

__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }

// ---------------------------------------------------------------------------
// delta = rowsum(dO * O): one warp per row

__global__ void __launch_bounds__(kDeltaThreads)
flash_bwd_delta_f32_kernel(const float* __restrict__ o,
                           const float* __restrict__ dout,
                           float* __restrict__ delta, size_t rows, int D) {
  const size_t row =
      ((size_t)blockIdx.x * kDeltaThreads + threadIdx.x) / 32;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;  // the whole warp leaves together
  const size_t base = row * D;
  float acc = 0.f;
  for (int c = lane; c < D; c += 32)
    acc = fmaf(dout[base + c], o[base + c], acc);
#pragma unroll
  for (int off = 16; off; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) delta[row] = acc;
}

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
// `mul`, as bf16 rows of `out` (the rows before S, the columns below D).
template <int DP>
__device__ __forceinline__ void store_rows(const float (&acc)[DP / 2],
                                           bf16* out, int row0, int S,
                                           int D, float mul, int warp, int g,
                                           int t) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + warp * 16 + g + 8 * r;
    if (row >= S) continue;
    bf16* orow = out + (size_t)row * D + 2 * t;
#pragma unroll
    for (int n = 0; n < DP / 8; ++n)
      if (n * 8 < D)
        *reinterpret_cast<uint32_t*>(orow + n * 8) = pack_bf16(
            acc[4 * n + 2 * r] * mul, acc[4 * n + 2 * r + 1] * mul);
  }
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
  const int slice = blockIdx.y;
  const int k0 = blockIdx.x * L::kConsumers * kTileRows;
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

      // P^T = exp2(S^T c - lse2); dV += P^T dO, P rounded to bf16
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const float2 l2 =
            *reinterpret_cast<const float2*>(lse_s + 8 * n + 2 * t);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          p[4 * n + e] =
              exp2_ftz(fmaf(p[4 * n + e], scale_log2, -(e & 1 ? l2.y : l2.x)));
      }
      uint32_t pa[4][4];
      to_a_fragments(p, pa);
      fence_acc(dv_acc);
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < 4; ++j)
        wgmma_rs_mn<DP>(dv_acc, pa[j], desc_mn_major<DP>(do_tile, j));
      wgmma_commit();

      // dS^T = P^T (dP^T - delta) while dV runs; dK += dS^T q, dS rounded
      // to bf16 (the scale comes once, at the end)
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const float2 d2 =
            *reinterpret_cast<const float2*>(delta_s + 8 * n + 2 * t);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          ds[4 * n + e] =
              p[4 * n + e] * (ds[4 * n + e] - (e & 1 ? d2.y : d2.x));
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
  const int slice = blockIdx.y;
  const int q0 = blockIdx.x * L::kConsumers * kTileRows;
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

      // P = exp2(S c - lse2), 0 for keys past S (TMA's zero rows there
      // would give exp2(-lse2)); dS = P (dP - delta)
      const int k0 = it * kBlockK;
      const bool ragged = k0 + kBlockK > S;
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int r = (i >> 1) & 1;
        float pi = exp2_ftz(fmaf(p[i], scale_log2, -lse_r[r]));
        if (ragged && k0 + (i / 4) * 8 + 2 * t + (i & 1) >= S) pi = 0.f;
        ds[i] = pi * (ds[i] - delta_r[r]);
      }
      // dQ += dS K, dS rounded to bf16, K read with its rows (keys) as k
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
      mbar_arrive(empty + st);
    }

    store_rows<DP>(dq_acc, dq + (size_t)slice * S * D, row0, S, D, scale,
                   warp, g, t);
  }
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

cudaError_t launch_delta_f32(const void* o, const void* dout, float* delta,
                             int bh, int s, int d, cudaStream_t st) {
  const size_t rows = (size_t)bh * s;
  const unsigned blocks =
      (unsigned)((rows * 32 + kDeltaThreads - 1) / kDeltaThreads);
  flash_bwd_delta_f32_kernel<<<blocks, kDeltaThreads, 0, st>>>(
      static_cast<const float*>(o), static_cast<const float*>(dout), delta,
      rows, d);
  return cudaGetLastError();
}

// the (bh, 2, sp) row buffer as a 2-D map (sp, 2 bh): one box is a query
// tile's lse2 and delta
cudaError_t rows_map(CUtensorMap* map, const float* rows, int bh, int sp) {
  const cuuint64_t dims[2] = {(cuuint64_t)sp, 2ull * bh};
  const cuuint64_t strides[1] = {4ull * sp};
  const cuuint32_t box[2] = {kTileRows, 2};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, rows, dims, strides,
                box, CU_TENSOR_MAP_SWIZZLE_NONE);
}

template <int DP>
cudaError_t launch_dkdv(const void* q, const void* k, const void* v,
                        const void* o, const void* dout, const float* lse,
                        float* delta, float* rows, void* dk, void* dv, int bh,
                        int s, int d, bool use_bf16, cudaStream_t st) {
  const float scale = (float)(1.0 / sqrt((double)d));
  const float scale_log2 = (float)(kLog2e / sqrt((double)d));
  cudaError_t err;
  if (use_bf16) {
    const int sp = (s + kTileRows - 1) / kTileRows * kTileRows;
    constexpr int kLpr = DP / 8;  // threads per row, 8 columns each
    const size_t threads = (size_t)bh * sp * kLpr;
    flash_bwd_rows_bf16_kernel<kLpr>
        <<<(unsigned)((threads + kDeltaThreads - 1) / kDeltaThreads),
           kDeltaThreads, 0, st>>>(static_cast<const bf16*>(o),
                                   static_cast<const bf16*>(dout), lse,
                                   delta, rows, bh, s, sp, d);
    if ((err = cudaGetLastError())) return err;
    CUtensorMap qm, km, vm, dom, rm;
    if ((err = tile_map<DP>(&qm, q, bh, s, d)) ||
        (err = tile_map<DP>(&km, k, bh, s, d)) ||
        (err = tile_map<DP>(&vm, v, bh, s, d)) ||
        (err = tile_map<DP>(&dom, dout, bh, s, d)) ||
        (err = rows_map(&rm, rows, bh, sp)))
      return err;
    using L = BwdSmem<DP, true>;
    static std::atomic<uint64_t> smem_set{0};
    if ((err = set_smem_once(flash_bwd_dkdv_bf16_kernel<DP>, L::bytes,
                             smem_set)))
      return err;
    static const cudaError_t pool = check_register_pool(
        flash_bwd_dkdv_bf16_kernel<DP>, L::kConsumers);
    if (pool != cudaSuccess) return pool;
    constexpr int kRowsPerBlock = L::kConsumers * kTileRows;
    const dim3 grid((s + kRowsPerBlock - 1) / kRowsPerBlock, bh);
    flash_bwd_dkdv_bf16_kernel<DP><<<grid, L::kThreads, L::bytes, st>>>(
        qm, km, vm, dom, rm, static_cast<bf16*>(dk), static_cast<bf16*>(dv),
        s, d, scale_log2, scale);
  } else {
    if ((err = launch_delta_f32(o, dout, delta, bh, s, d, st))) return err;
    constexpr size_t smem = bwd_f32_smem_bytes<DP>();
    static std::atomic<uint64_t> smem_set{0};
    if ((err = set_smem_once(flash_bwd_dkdv_f32_kernel<DP>, smem, smem_set)))
      return err;
    const dim3 grid((s + kBlockK - 1) / kBlockK, bh);
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
    constexpr int kRowsPerBlock = L::kConsumers * kTileRows;
    const dim3 grid((s + kRowsPerBlock - 1) / kRowsPerBlock, bh);
    flash_bwd_dq_bf16_kernel<DP><<<grid, L::kThreads, L::bytes, st>>>(
        qm, km, vm, dom, lse, delta, static_cast<bf16*>(dq), s, d,
        scale_log2, scale);
  } else {
    constexpr size_t smem = bwd_f32_smem_bytes<DP>();
    static std::atomic<uint64_t> smem_set{0};
    if ((err = set_smem_once(flash_bwd_dq_f32_kernel<DP>, smem, smem_set)))
      return err;
    const dim3 grid((s + kBlockQ - 1) / kBlockQ, bh);
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
// 8 <= d <= 128; lse (the forward's lse2) and delta: (bh, s) float32; rows
// (bf16 only, else unused): a 16-byte aligned (bh, 2, sp) float32 scratch,
// sp = s rounded up to 64. Launches the pre-pass (delta = rowsum(dout * o),
// written for ddti_flash_bwd_dq, and in bf16 the padded rows) and the dK/dV
// kernel on `stream` without synchronising; returns the first cudaError_t
// (0 = success).
extern "C" int ddti_flash_bwd_dkdv(const void* q, const void* k,
                                   const void* v, const void* o,
                                   const void* dout, const void* lse,
                                   void* delta, void* rows, void* dk,
                                   void* dv, int bh, int s, int d,
                                   int is_bf16, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (bad_shape(bh, s, d)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool bf = is_bf16 != 0;
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  float* r = static_cast<float*>(rows);
  if (d <= 32)
    return (int)launch_dkdv<32>(q, k, v, o, dout, l, dl, r, dk, dv, bh, s, d,
                                bf, st);
  if (d <= 64)
    return (int)launch_dkdv<64>(q, k, v, o, dout, l, dl, r, dk, dv, bh, s, d,
                                bf, st);
  return (int)launch_dkdv<128>(q, k, v, o, dout, l, dl, r, dk, dv, bh, s, d,
                               bf, st);
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

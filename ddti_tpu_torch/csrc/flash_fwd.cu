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
// What bounds it on an H100 (bf16 dense peak 989 TFLOP/s, 3.35 TB/s, 16
// exp2 per clock per SM): at the TransUNet shape (B=16, H=8, S=1024, D=32)
// one call is 4*B*H*S^2*D = 17.2 GFLOP of products, 0.0174 ms at the
// tensor-core peak, against 34 MB of q/k/v/o/lse2 (0.010 ms), and
// B*H*S^2 = 134 M exp2, 0.032 ms for the exp2 unit alone at the boost
// clock: the exp2 floor, not the tensor cores or the memory, bounds it. The
// (S, S) score matrix never reaches device memory.
//
// Design.
//  - bf16 (Hopper). The first version (mma.sync fed by 32-bit shared loads,
//    K/V staged by blocking loads between block barriers, V staged a
//    second time transposed) ran at 10% of the roofline bound. Now one
//    block per (128 queries, b*h) holds two consumer warpgroups of 64 query
//    rows and a producer, one thread of which issues TMA loads: the block's
//    q tiles once, then K and V tiles of 64 keys into a ring of kStages
//    slots under mbarriers (full: the tile landed; empty: both consumers
//    are done with it). The loop has no block-wide barrier. A consumer
//    computes S = q K^T by wgmma.m64n64k16 with q and K both K-major in
//    shared memory, the online softmax on the float32 accumulator (rows g
//    and g + 8 of each warp, their max and sum reduced over the quad), then
//    O += P V by wgmma.m64nDPk16 with P from registers (the accumulator
//    rounded to bf16 is the A fragment) and V read MN-major straight from
//    its row-major tile: no transposed copy. The exp2 unit sets the pace,
//    so what matters is how many warps keep it fed: at DP = 32 a consumer
//    needs 88 registers, and two blocks share an SM, each with a producer
//    warp; wider heads take one block per SM with a producer warpgroup
//    whose registers setmaxnreg hands to the consumers (at DP = 256 one
//    consumer of 64 rows, where two would spill). TMA zero-fills rows past
//    S and columns past D; key columns past S are masked to -inf before
//    the max, query rows past S are not written.
//  - float32: tensor cores offer no full-precision float32 product, so the
//    products are scalar FMAs. One block per (64 queries, b*h); four
//    threads own each query row: each computes 16 of the row's 64 scores
//    and DP/4 of its output columns; the row's max and sum are reduced with
//    two quad shuffles. Bound by shared-memory loads, about one per FMA.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr double kLog2e = 1.4426950408889634;
typedef __nv_bfloat16 bf16;

// ---------------------------------------------------------------------------
// bfloat16: TMA + wgmma

template <int DP>
struct FwdSmem {
  using T = Tile<DP>;
  // consumer warpgroups: one at DP = 256, where two spill registers
  static constexpr int kConsumers = DP == 256 ? 1 : 2;
  // DP = 32 needs few registers: two blocks share an SM, each with a
  // producer warp and no setmaxnreg, so that four consumer warps per
  // scheduler keep the exp2 unit busy; wider heads take one block of a
  // producer warpgroup whose registers setmaxnreg hands to the consumers
  static constexpr bool kGrowRegs = DP != 32;
  static constexpr int kBlocksPerSm = kGrowRegs ? 1 : 2;
  static constexpr int kThreads = 128 * kConsumers + (kGrowRegs ? 128 : 32);
  static constexpr int kStages = DP == 256 ? 2 : 4;
  static constexpr uint32_t kStage = 2 * T::kBytes;  // K tile, V tile
  static constexpr uint32_t q = 0;                   // the consumers' q tiles
  static constexpr uint32_t kv = kConsumers * T::kBytes;
  // full[kStages], empty[kStages], q_full
  static constexpr uint32_t bars = kv + kStages * kStage;
  static constexpr size_t bytes = bars + 8 * (2 * kStages + 1) + 1024;
};

// DP: padded head width (template); D: actual head width, D % 8 == 0, D <= DP
template <int DP>
__global__ void __launch_bounds__(FwdSmem<DP>::kThreads,
                                  FwdSmem<DP>::kBlocksPerSm)
flash_fwd_bf16_kernel(const __grid_constant__ CUtensorMap q_map,
                      const __grid_constant__ CUtensorMap k_map,
                      const __grid_constant__ CUtensorMap v_map,
                      bf16* __restrict__ o, float* __restrict__ lse, int S,
                      int D, float scale_log2) {
  using T = Tile<DP>;
  using L = FwdSmem<DP>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::bars);
  uint64_t* empty = full + L::kStages;
  uint64_t* q_full = empty + L::kStages;
  const int slice = blockIdx.y;
  const int q0 = blockIdx.x * L::kConsumers * kTileRows;
  const int n_tiles = (S + kBlockK - 1) / kBlockK;
  const int wg = threadIdx.x / 128;
  init_ring<L>(full);

  if (wg == L::kConsumers) {  // the producer
    if constexpr (L::kGrowRegs) regs_dealloc<kProducerRegs>();
    if (threadIdx.x == L::kConsumers * 128) {
      mbar_expect_tx(q_full, L::kConsumers * T::kBytes);
      for (int c = 0; c < L::kConsumers; ++c)
        tma_load_tile<DP>(smem + L::q + c * T::kBytes, &q_map, q_full,
                          q0 + c * kTileRows, slice);
      for (int it = 0; it < n_tiles; ++it) {
        const int st = it % L::kStages;
        mbar_wait(empty + st, ((it / L::kStages) & 1) ^ 1);
        mbar_expect_tx(full + st, L::kStage);
        unsigned char* kv = smem + L::kv + st * L::kStage;
        tma_load_tile<DP>(kv, &k_map, full + st, it * kBlockK, slice);
        tma_load_tile<DP>(kv + T::kBytes, &v_map, full + st, it * kBlockK,
                          slice);
      }
    }
  } else {  // a consumer: query rows q0 + 64 wg .. + 63
    if constexpr (L::kGrowRegs) regs_alloc<kConsumerRegs>();
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, t = lane % 4;
    const uint32_t q_tile = smem_addr(smem + L::q + wg * T::kBytes);
    float acc[DP / 2];
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;
    // rows g and g + 8 of this warp's 16, in the base-2 scaled domain
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
    mbar_wait(q_full, 0);

    for (int it = 0; it < n_tiles; ++it) {
      const int st = it % L::kStages;
      mbar_wait(full + st, (it / L::kStages) & 1);
      const uint32_t k_tile = smem_addr(smem + L::kv + st * L::kStage);
      const uint32_t v_tile = k_tile + T::kBytes;

      // raw scores q K^T: element 4n + e is row g + 8 (e >> 1), key
      // it * 64 + 8n + 2t + (e & 1)
      float s[32];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk)
        wgmma_m64n64k16_ss(s, desc_k_major<DP>(q_tile, kk),
                           desc_k_major<DP>(k_tile, kk), kk);
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(s);

      const int k0 = it * kBlockK;
      if (k0 + kBlockK > S) {
#pragma unroll
        for (int i = 0; i < 32; ++i)
          if (k0 + (i / 4) * 8 + 2 * t + (i & 1) >= S) s[i] = -INFINITY;
      }
      float alpha[2], bias[2], tile_sum[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = fmaxf(s[2 * r], s[2 * r + 1]);
#pragma unroll
        for (int n = 1; n < 8; ++n)
          mx = fmaxf(mx, fmaxf(s[4 * n + 2 * r], s[4 * n + 2 * r + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        // every tile holds at least one valid key, so m_new is finite
        const float m_new = fmaxf(m[r], mx * scale_log2);
        alpha[r] = exp2_ftz(m[r] - m_new);
        m[r] = m_new;
        bias[r] = -m_new;
      }
      // p = exp2(s c - m) rounded to bf16 as the A fragments of P V; l sums
      // it unrounded
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        s[i] = exp2_ftz(fmaf(s[i], scale_log2, bias[(i >> 1) & 1]));
        tile_sum[(i >> 1) & 1] += s[i];
      }
      uint32_t pa[4][4];
      to_a_fragments(s, pa);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        tile_sum[r] += __shfl_xor_sync(0xffffffffu, tile_sum[r], 1);
        tile_sum[r] += __shfl_xor_sync(0xffffffffu, tile_sum[r], 2);
        l[r] = l[r] * alpha[r] + tile_sum[r];
      }
#pragma unroll
      for (int i = 0; i < DP / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];

      wgmma_fence();
#pragma unroll
      for (int j = 0; j < 4; ++j)
        wgmma_rs_mn<DP>(acc, pa[j], desc_mn_major<DP>(v_tile, j));
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(acc);
      mbar_arrive(empty + st);
    }

    const size_t base = (size_t)slice * S;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = q0 + wg * kTileRows + warp * 16 + g + 8 * r;
      if (row >= S) continue;
      const float inv_l = 1.f / l[r];
      bf16* orow = o + (base + row) * D + 2 * t;
#pragma unroll
      for (int n = 0; n < DP / 8; ++n)
        if (n * 8 < D)
          *reinterpret_cast<uint32_t*>(orow + n * 8) = pack_bf16(
              acc[4 * n + 2 * r] * inv_l, acc[4 * n + 2 * r + 1] * inv_l);
      if (t == 0) lse[base + row] = m[r] + log2f(l[r]);
    }
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
                   void* lse, int bh, int s, int d, bool use_bf16,
                   cudaStream_t stream) {
  const float scale_log2 = (float)(kLog2e / sqrt((double)d));
  cudaError_t err;
  if (use_bf16) {
    CUtensorMap qm, km, vm;
    if ((err = tile_map<DP>(&qm, q, bh, s, d)) ||
        (err = tile_map<DP>(&km, k, bh, s, d)) ||
        (err = tile_map<DP>(&vm, v, bh, s, d)))
      return err;
    constexpr size_t smem = FwdSmem<DP>::bytes;
    static std::atomic<uint64_t> smem_set{0};
    if ((err = set_smem_once(flash_fwd_bf16_kernel<DP>, smem, smem_set)))
      return err;
    if constexpr (FwdSmem<DP>::kGrowRegs) {
      static const cudaError_t pool = check_register_pool(
          flash_fwd_bf16_kernel<DP>, FwdSmem<DP>::kConsumers);
      if (pool != cudaSuccess) return pool;
    }
    constexpr int kRowsPerBlock = FwdSmem<DP>::kConsumers * kTileRows;
    const dim3 grid((s + kRowsPerBlock - 1) / kRowsPerBlock,
                    bh);
    flash_fwd_bf16_kernel<DP><<<grid, FwdSmem<DP>::kThreads, smem, stream>>>(
        qm, km, vm, static_cast<bf16*>(o), static_cast<float*>(lse), s, d,
        scale_log2);
  } else {
    constexpr size_t smem = fma_smem_bytes<DP>();
    static std::atomic<uint64_t> smem_set{0};
    if ((err = set_smem_once(flash_fwd_f32_kernel<DP>, smem, smem_set)))
      return err;
    const dim3 grid((s + kBlockQ - 1) / kBlockQ, bh);
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
  const bool use_bf16 = is_bf16 != 0;
  if (d <= 32) return (int)launch<32>(q, k, v, o, lse, bh, s, d, use_bf16, st);
  if (d <= 64) return (int)launch<64>(q, k, v, o, lse, bh, s, d, use_bf16, st);
  if (d <= 128) return (int)launch<128>(q, k, v, o, lse, bh, s, d, use_bf16, st);
  return (int)launch<256>(q, k, v, o, lse, bh, s, d, use_bf16, st);
}

// Flash-attention forward for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the TPU kernels ddti_tpu/ops/attention.py:_fwd_kernel (one head
// per program) and _fwd_kernel_packed (G = 128/D heads packed on the 128-lane
// axis). The packing only existed to fill the TPU's lane-wide vector
// registers; here a head of any supported width is one (b*h) slice, so both
// TPU forms collapse into this one kernel.
//
// Head widths: every D with D % 8 == 0 (the wrapper pads any other D with
// zero columns and passes the true width, scale_d, for the scale). bf16 up
// to 256 and float32 up to 128 run kernels of one tile, instantiated for
// the padded widths DP = 32, 64, 128 (256 in bf16) with the actual D at
// run time: columns D..DP-1 of the staged tiles are zeros, so they add
// nothing to the scores, and they are not written back. Wider heads run
// the wide kernels below, whose blocks each own a slice of o's columns and
// recompute the scores over the whole of D. B*H: any; blocks run over
// (row block, slice) on gridDim.x alone.
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
// clock: the exp2 floor, not the tensor cores or the memory, bounds it. In
// float32 the products run as 3xTF32 at 495 / 3 TFLOP/s: 0.104 ms at that
// shape, above the exp2 floor and the 67 MB of float32 traffic (0.020 ms).
// The (S, S) score matrix never reaches device memory.
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
//  - float32 (FwdSmemF32). The first version, scalar-FMA loops, ran at 8%
//    of the float32 bound (one shared-memory load per FMA, K and V staged
//    by blocking loads between block barriers). Now the bf16 kernel's
//    shape with every product as three TF32 products on wgmma (sm90.cuh:
//    x = hi + lo, a_lo b_hi + a_hi b_lo + a_hi b_hi), which keeps float32's
//    accuracy at a third of the TF32 rate, as the float32 backward does.
//    A pre-pass (flash_fwd_split_f32_kernel, its own entry point) writes
//    the TF32 hi and lo planes of q and K (row-major) and of V^T (tf32
//    wgmma reads K-major operands only, and P V's B operand is V read with
//    the keys as k), each group of 8 keys in the order {0, 2, 4, 6, 1, 3,
//    5, 7}, so that P, split k8 step by k8 step, is an A fragment as it
//    stands. A block is C consumer warpgroups of 64 query rows with their
//    q planes resident and a producer warpgroup whose one thread streams
//    tiles of kBlk keys as two parts, K and V^T (hi and lo planes each),
//    through a ring of slots, each released as soon as its product is
//    done. Per tile: S = q K^T (3 x DP/8 k8 steps in one accumulator), the
//    online softmax on the CUDA cores as in bf16 (p stays float32), acc *=
//    alpha, then P V summed in a fresh accumulator and added to acc on the
//    CUDA cores (acc_tile): the tensor cores' float32 sums round toward
//    zero, and summed over the whole sequence in one accumulator they
//    would drift with S. Two consumers and 8 slots at DP = 32, two and 5
//    at 64, one and 5 slots of 32-key tiles at 128.
//    D > 128 runs the first version's FMA loops (flash_fwd_f32_fma_kernel):
//    q's planes alone and one K part take 256 KB at DP = 256, more than a
//    block may hold. A block owns 256 of o's columns (a slice of
//    ceil(D / 256)) and sums the scores over D in chunks of 256 staged one
//    after another (q stays staged where D <= 256); every slice computes
//    the same scores in the same order, so m and l agree bit for bit and
//    slice 0 writes lse2. At D = 512 the scores' products run twice.
//  - bf16, D > 256 (flash_fwd_wide_bf16_kernel): the bf16 kernel's shape
//    with one consumer of 64 rows and nothing resident. A block owns 128 of
//    o's columns (slice j); per key tile the producer streams the D-chunks
//    (q_c, K_c) of 128 columns, a pair a slot, and the consumer sums
//    S = sum_c q_c K_c^T in one accumulator (chunk_scores), then streams V's
//    slice j for O += P V. As in float32, every slice computes bit-equal m
//    and l and slice 0 writes lse2; each slice recomputes the scores, so
//    the products are (n + 1) / 2 times one pass's with n = D / 128 slices.
//  - Variants. Built with -DDDTI_POLY_EXP2=1 (ddti_tpu_torch/ops/_build.py),
//    every exponential of every kernel here is sm90.cuh's order-6 polynomial
//    on the FMA pipes (flash_exp2, flash_exp2f) instead of the exp2 unit,
//    the TPU kernels' DDTI_POLY_EXP2 switch. ddti_flash_fwd_mskip runs the
//    bf16 kernel with kSkipRescale (the port of the TPU probe
//    benchmarks/flash_mskip_ab.py:fwd; see the kernel).

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

// DP: padded head width (template); D: actual head width, D % 8 == 0, D <= DP.
// kSkipRescale: the m-skip variant (ddti_flash_fwd_mskip), which replaces
// the TPU probe benchmarks/flash_mskip_ab.py:fwd. Where none of a warp's
// 16 rows raised its running max on a tile (one __any_sync vote, the
// probe's lax.cond(grew, rescale, stale) at the granularity a GPU votes
// at), the warp skips alpha's two exponentials, l *= alpha and acc *=
// alpha. alpha would be exp2(0) = 1 there, so o and lse2 are bit for bit
// the baseline's; what a skip saves is 2 of ~34 exponentials and the
// DP / 2 multiplies of acc *= alpha a thread a tile.
template <int DP, bool kSkipRescale>
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
  // blocks run over (query block, slice) on gridDim.x alone, so B*H has
  // no 65535 bound
  constexpr int kRows = L::kConsumers * kTileRows;
  const int n_blocks = (S + kRows - 1) / kRows;
  const int slice = blockIdx.x / n_blocks;
  const int q0 = (blockIdx.x % n_blocks) * kRows;
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
      const float m_prev[2] = {m[0], m[1]};
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
        if constexpr (!kSkipRescale) alpha[r] = flash_exp2(m[r] - m_new);
        m[r] = m_new;
        bias[r] = -m_new;
      }
      bool rescale = true;
      if constexpr (kSkipRescale) {
        rescale = __any_sync(0xffffffffu,
                             m[0] > m_prev[0] || m[1] > m_prev[1]);
        if (rescale) {
#pragma unroll
          for (int r = 0; r < 2; ++r)
            alpha[r] = flash_exp2(m_prev[r] - m[r]);
        }
      }
      // p = exp2(s c - m) rounded to bf16 as the A fragments of P V; l sums
      // it unrounded
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        s[i] = flash_exp2(fmaf(s[i], scale_log2, bias[(i >> 1) & 1]));
        tile_sum[(i >> 1) & 1] += s[i];
      }
      uint32_t pa[4][4];
      to_a_fragments(s, pa);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        tile_sum[r] += __shfl_xor_sync(0xffffffffu, tile_sum[r], 1);
        tile_sum[r] += __shfl_xor_sync(0xffffffffu, tile_sum[r], 2);
        // fmaf(l, 1, x) == l + x: the skip changes no bit
        l[r] = rescale ? fmaf(l[r], alpha[r], tile_sum[r])
                       : l[r] + tile_sum[r];
      }
      if (rescale) {
#pragma unroll
        for (int i = 0; i < DP / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];
      }

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
// float32, D <= 128: 3xTF32 on wgmma, TMA

constexpr int kSplitThreads = 256;
constexpr int kMaxSplitD = 128;

// The float32 pre-pass, per 64-row block of one slice: q and K as TF32 hi
// and lo planes (split_tf32), `split` (2, bh, 2, s, d), and V^T as `trans`
// (bh, 2, d, sp), zero past s, each group of 8 keys in the order {0, 2, 4,
// 6, 1, 3, 5, 7} (store_trans_split). 16 bytes a thread at a time; V's
// transpose passes through shared memory.
__global__ void __launch_bounds__(kSplitThreads)
flash_fwd_split_f32_kernel(const float* __restrict__ q,
                           const float* __restrict__ k,
                           const float* __restrict__ v,
                           float* __restrict__ split,
                           float* __restrict__ trans, int bh, int s, int sp,
                           int D) {
  __shared__ float tile[kTileRows][kMaxSplitD + 1];
  const int n_blocks = sp / kTileRows;
  const int slice = blockIdx.x / n_blocks;
  const int r0 = blockIdx.x % n_blocks * kTileRows;
  const int D4 = D / 4;  // 16-byte chunks of a row
  const size_t plane = (size_t)s * D, tplane = (size_t)D * sp;
  for (int x = 0; x < 3; ++x) {
    const float* in = (x == 0 ? q : x == 1 ? k : v) + (size_t)slice * plane;
    float* out = split + ((size_t)x * bh + slice) * 2 * plane;  // x < 2
    for (int i = threadIdx.x; i < kTileRows * D4; i += kSplitThreads) {
      const int r = i / D4, c = 4 * (i - r * D4), row = r0 + r;
      float4 f = make_float4(0.f, 0.f, 0.f, 0.f);
      if (row < s)
        f = *reinterpret_cast<const float4*>(in + (size_t)row * D + c);
      if (x == 2) {
        tile[r][c] = f.x, tile[r][c + 1] = f.y;
        tile[r][c + 2] = f.z, tile[r][c + 3] = f.w;
      } else if (row < s) {
        uint32_t hi[4], lo[4];
        split_tf32(f.x, hi[0], lo[0]);
        split_tf32(f.y, hi[1], lo[1]);
        split_tf32(f.z, hi[2], lo[2]);
        split_tf32(f.w, hi[3], lo[3]);
        *reinterpret_cast<uint4*>(out + (size_t)row * D + c) =
            make_uint4(hi[0], hi[1], hi[2], hi[3]);
        *reinterpret_cast<uint4*>(out + plane + (size_t)row * D + c) =
            make_uint4(lo[0], lo[1], lo[2], lo[3]);
      }
    }
  }
  __syncthreads();
  store_trans_split<kSplitThreads>(tile, trans + (size_t)slice * 2 * tplane,
                                   tplane, sp, r0, D);
}

// A float32 forward block: C consumer warpgroups of 64 query rows, each
// with its q planes (hi, lo) resident, and a producer warpgroup that streams
// tiles of kBlk keys as two parts a tile, K (kBlk rows) and V^T (DP rows of
// kBlk keys), hi and lo planes each, through a ring of kStages slots, as
// many as fit of 227 KB. Shared memory: the q planes (consumer c: hi, lo),
// the slots, the mbarriers.
template <int DP>
struct FwdSmemF32 {
  // consumer warpgroups: two up to DP = 64; one at 128, where two q tiles'
  // planes leave room for three 32-key slots only
  static constexpr int kConsumers = DP == 128 ? 1 : 2;
  static constexpr int kThreads = 128 * (kConsumers + 1);
  // keys a streamed tile: 32 at DP = 128, so that the ring holds five
  static constexpr int kBlk = DP == 128 ? 32 : 64;
  static constexpr uint32_t kRes = kTileRows * DP * 4;  // one q plane
  static constexpr uint32_t kPlane = kBlk * DP * 4;
  static constexpr uint32_t kPart = 2 * kPlane;
  static constexpr uint32_t resident = 0;
  static constexpr uint32_t stages = 2 * kConsumers * kRes;
  static constexpr int kFit =
      (int)((232448 - 1024 - 8 * 17 - stages) / kPart);
  static constexpr int kStages = kFit < 8 ? kFit : 8;
  static_assert(kStages >= 2, "ring");
  static constexpr uint32_t bars = stages + kStages * kPart;
  static constexpr size_t bytes = bars + 8 * (2 * kStages + 1) + 1024;
};

// DP: padded head width (template); D: actual head width, D % 8 == 0, D <= DP
template <int DP>
__global__ void __launch_bounds__(FwdSmemF32<DP>::kThreads, 1)
flash_fwd_f32_kernel(const __grid_constant__ CUtensorMap q_map,
                     const __grid_constant__ CUtensorMap k_map,
                     const __grid_constant__ CUtensorMap vt_map,
                     float* __restrict__ o, float* __restrict__ lse, int S,
                     int D, float scale_log2) {
  using L = FwdSmemF32<DP>;
  constexpr int B = L::kBlk;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::bars);
  uint64_t* empty = full + L::kStages;
  uint64_t* q_full = empty + L::kStages;
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
      mbar_expect_tx(q_full, 2 * L::kConsumers * L::kRes);
      for (int c = 0; c < L::kConsumers; ++c)
        tma_load_split<DP, kTileRows>(smem + L::resident + c * 2 * L::kRes,
                                      &q_map, q_full, q0 + c * kTileRows,
                                      slice);
      for (int n = 0; n < 2 * n_tiles; ++n) {
        const int st = n % L::kStages, it = n / 2;
        mbar_wait(empty + st, ((n / L::kStages) & 1) ^ 1);
        mbar_expect_tx(full + st, L::kPart);
        unsigned char* dst = smem + L::stages + st * L::kPart;
        if (n % 2 == 0)
          tma_load_split<DP, B>(dst, &k_map, full + st, it * B, slice);
        else
          tma_load_trans<DP, B>(dst, &vt_map, full + st, it * B, slice);
      }
    }
  } else {  // a consumer: query rows q0 + 64 wg .. + 63
    regs_alloc<kConsumerRegs>();
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, t = lane % 4;
    const uint32_t q_hi = smem_addr(smem + L::resident + wg * 2 * L::kRes);
    const uint32_t q_lo = q_hi + L::kRes;
    float acc[DP / 2];
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;
    // rows g and g + 8 of this warp's 16, in the base-2 scaled domain
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
    mbar_wait(q_full, 0);

    for (int it = 0; it < n_tiles; ++it) {
      const int n = 2 * it;
      const uint32_t k_hi = wait_part<L>(full, smem, n);

      // raw scores q K^T: element 4n + e is row g + 8 (e >> 1), key
      // it * B + 8n + 2t + (e & 1)
      float s[B / 2];
      wgmma_fence();
      product3_ss<B, kTileRows, DP / 8>(s, q_hi, q_lo, k_hi,
                                        k_hi + L::kPlane);
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(s);
      mbar_arrive(empty + n % L::kStages);

      const int k0 = it * B;
      if (k0 + B > S) {
#pragma unroll
        for (int i = 0; i < B / 2; ++i)
          if (k0 + (i / 4) * 8 + 2 * t + (i & 1) >= S) s[i] = -INFINITY;
      }
      float alpha[2], bias[2], tile_sum[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = fmaxf(s[2 * r], s[2 * r + 1]);
#pragma unroll
        for (int j = 1; j < B / 8; ++j)
          mx = fmaxf(mx, fmaxf(s[4 * j + 2 * r], s[4 * j + 2 * r + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        // every tile holds at least one valid key, so m_new is finite
        const float m_new = fmaxf(m[r], mx * scale_log2);
        alpha[r] = flash_exp2(m[r] - m_new);
        m[r] = m_new;
        bias[r] = -m_new;
      }
      // p = exp2(s c - m), float32 throughout: l sums it, P V takes it
      // split into TF32 hi and lo A fragments
#pragma unroll
      for (int i = 0; i < B / 2; ++i) {
        s[i] = flash_exp2(fmaf(s[i], scale_log2, bias[(i >> 1) & 1]));
        tile_sum[(i >> 1) & 1] += s[i];
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        tile_sum[r] += __shfl_xor_sync(0xffffffffu, tile_sum[r], 1);
        tile_sum[r] += __shfl_xor_sync(0xffffffffu, tile_sum[r], 2);
        l[r] = l[r] * alpha[r] + tile_sum[r];
      }
#pragma unroll
      for (int i = 0; i < DP / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];

      // O += P V (V^T's rows), this tile's product summed apart
      uint32_t ph[B / 8][4], pl[B / 8][4];
      split_fragments<B>(s, ph, pl);
      const uint32_t vt_hi = wait_part<L>(full, smem, n + 1);
      acc_tile<DP, B>(acc, ph, pl, vt_hi, vt_hi + L::kPlane);
      mbar_arrive(empty + (n + 1) % L::kStages);
    }

    const size_t base = (size_t)slice * S;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = q0 + wg * kTileRows + warp * 16 + g + 8 * r;
      if (row >= S) continue;
      const float inv_l = 1.f / l[r];
      float* orow = o + (base + row) * D + 2 * t;
#pragma unroll
      for (int n = 0; n < DP / 8; ++n)
        if (n * 8 < D)
          *reinterpret_cast<float2*>(orow + n * 8) = make_float2(
              acc[4 * n + 2 * r] * inv_l, acc[4 * n + 2 * r + 1] * inv_l);
      if (t == 0) lse[base + row] = m[r] + log2f(l[r]);
    }
  }
}

// ---------------------------------------------------------------------------
// float32, D > 128: scalar FMAs

constexpr int kFmaThreads = 256;  // 4 threads per query row
constexpr int kFmaD = 256;        // the columns a block stages and outputs

constexpr size_t fma_smem_bytes() {
  // q, k, v tiles with row stride kFmaD + 1, and the probability tile with
  // row stride kBlockK + 1, all float32 (209 KiB of the 227 KiB a block may
  // hold)
  return sizeof(float) * ((size_t)(kBlockQ + 2 * kBlockK) * (kFmaD + 1) +
                          (size_t)kBlockQ * (kBlockK + 1));
}

// rows [r0, r0 + 64) and columns [c0, c0 + kFmaD) of a (S, D) float32
// slice into a tile of row stride kFmaD + 1, zeros past S and D
__device__ __forceinline__ void fma_stage(float* dst, const float* src,
                                          int r0, int c0, int S, int D) {
  for (int i = threadIdx.x; i < kTileRows * kFmaD; i += kFmaThreads) {
    const int r = i / kFmaD, c = i % kFmaD, gr = r0 + r, gc = c0 + c;
    dst[r * (kFmaD + 1) + c] =
        gr < S && gc < D ? src[(size_t)gr * D + gc] : 0.f;
  }
}

// D: the actual head width, D % 8 == 0. A block takes 64 query rows and
// the output columns [256 j, 256 j + 256) (slice j of ceil(D / 256)): the
// scores q k^T run over the whole of D in chunks of 256 columns staged one
// after another (q stays staged where D <= 256), then P V over its slice
// of V. Every slice of a row computes the same scores in the same order,
// so m and l agree bit for bit across slices; slice 0 writes lse2.
__global__ void __launch_bounds__(kFmaThreads)
flash_fwd_f32_fma_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v, float* __restrict__ o,
                         float* __restrict__ lse, int S, int D,
                         float scale_log2) {
  constexpr int RS = kFmaD + 1;    // q/k/v tile row stride (float32)
  constexpr int BKP = kBlockK + 1;
  constexpr int kColsPerThread = kBlockK / 4;
  constexpr int kDimsPerThread = kFmaD / 4;

  extern __shared__ float smem[];
  float* qs = smem;                // [kBlockQ][RS]
  float* ks = qs + kBlockQ * RS;   // [kBlockK][RS]
  float* vs = ks + kBlockK * RS;   // [kBlockK][RS]
  float* ps = vs + kBlockK * RS;   // [kBlockQ][BKP]

  const int tid = threadIdx.x;
  const int row = tid >> 2;   // query row inside the tile
  const int quad = tid & 3;   // this thread's lane in the row's quad
  const int n_blocks = (S + kBlockQ - 1) / kBlockQ;
  const int n_chunks = (D + kFmaD - 1) / kFmaD;
  const int rest = blockIdx.x / n_blocks;
  const int q0 = blockIdx.x % n_blocks * kBlockQ;
  const int j = rest % n_chunks, slice = rest / n_chunks;
  const size_t base = (size_t)slice * S * D;

  if (n_chunks == 1) fma_stage(qs, q + base, q0, 0, S, D);

  float m = -INFINITY;
  float l = 0.f;
  float acc[kDimsPerThread];
#pragma unroll
  for (int jj = 0; jj < kDimsPerThread; ++jj) acc[jj] = 0.f;

  for (int k0 = 0; k0 < S; k0 += kBlockK) {
    // scores for columns quad, quad+4, ..., quad+60 of this tile, summed
    // chunk by chunk; V's slice is staged with the last chunk
    float s[kColsPerThread];
#pragma unroll
    for (int jj = 0; jj < kColsPerThread; ++jj) s[jj] = 0.f;
    for (int c = 0; c < n_chunks; ++c) {
      __syncthreads();  // the previous chunk's or tile's tiles are consumed
      if (n_chunks > 1) fma_stage(qs, q + base, q0, c * kFmaD, S, D);
      fma_stage(ks, k + base, k0, c * kFmaD, S, D);
      if (c == n_chunks - 1) fma_stage(vs, v + base, k0, j * kFmaD, S, D);
      __syncthreads();
      const float* qrow = qs + row * RS;
#pragma unroll 4
      for (int d = 0; d < kFmaD; ++d) {
        const float qd = qrow[d];
#pragma unroll
        for (int jj = 0; jj < kColsPerThread; ++jj)
          s[jj] = fmaf(qd, ks[(quad + 4 * jj) * RS + d], s[jj]);
      }
    }

    float tile_max = -INFINITY;
#pragma unroll
    for (int jj = 0; jj < kColsPerThread; ++jj) {
      const int col = k0 + quad + 4 * jj;
      s[jj] = col < S ? s[jj] * scale_log2 : -INFINITY;
      tile_max = fmaxf(tile_max, s[jj]);
    }
    tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, 1));
    tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, 2));
    // every tile holds at least one valid key, so m_new is finite
    const float m_new = fmaxf(m, tile_max);
    const float alpha = flash_exp2f(m - m_new);
    float tile_sum = 0.f;
    float* prow = ps + row * BKP;
#pragma unroll
    for (int jj = 0; jj < kColsPerThread; ++jj) {
      const float p = flash_exp2f(s[jj] - m_new);
      tile_sum += p;
      prow[quad + 4 * jj] = p;
    }
    tile_sum += __shfl_xor_sync(0xffffffffu, tile_sum, 1);
    tile_sum += __shfl_xor_sync(0xffffffffu, tile_sum, 2);
    l = l * alpha + tile_sum;
    m = m_new;
#pragma unroll
    for (int jj = 0; jj < kDimsPerThread; ++jj) acc[jj] *= alpha;
    // a row's probabilities are written and read by the same quad, which
    // lies inside one warp
    __syncwarp();

#pragma unroll 4
    for (int c = 0; c < kBlockK; ++c) {
      const float p = prow[c];
      const float* vrow = vs + c * RS;
#pragma unroll
      for (int jj = 0; jj < kDimsPerThread; ++jj)
        acc[jj] = fmaf(p, vrow[quad + 4 * jj], acc[jj]);
    }
  }

  const int gr = q0 + row;
  if (gr < S) {
    const float inv_l = 1.f / l;
    float* orow = o + base + (size_t)gr * D + j * kFmaD;
#pragma unroll
    for (int jj = 0; jj < kDimsPerThread; ++jj)
      if (j * kFmaD + quad + 4 * jj < D) orow[quad + 4 * jj] = acc[jj] * inv_l;
    if (quad == 0 && j == 0) lse[(size_t)slice * S + gr] = m + log2f(l);
  }
}

// ---------------------------------------------------------------------------
// bfloat16, D > 256: TMA + wgmma over D-chunks

// A wide block: one consumer warpgroup of 64 query rows and the output
// columns [128 j, 128 j + 128) (slice j of ceil(D / 128)), and a producer
// warpgroup that streams, a key tile at a time, the D-chunks (q_c, K_c) of
// 128 columns, two tiles a slot, then the slot of V's slice j. Nothing is
// resident, so D has no bound but that of the grid.
struct WideSmem {
  using T = Tile<128>;
  static constexpr int kConsumers = 1;
  static constexpr int kThreads = 256;
  static constexpr int kStages = 6;
  static constexpr uint32_t kPart = 2 * T::kBytes;
  static constexpr uint32_t stages = 0;
  static constexpr uint32_t bars = kStages * kPart;
  static constexpr size_t bytes = bars + 8 * (2 * kStages + 1) + 1024;
};

__global__ void __launch_bounds__(WideSmem::kThreads, 1)
flash_fwd_wide_bf16_kernel(const __grid_constant__ CUtensorMap q_map,
                           const __grid_constant__ CUtensorMap k_map,
                           const __grid_constant__ CUtensorMap v_map,
                           bf16* __restrict__ o, float* __restrict__ lse,
                           int S, int D, float scale_log2) {
  using T = Tile<128>;
  using L = WideSmem;
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
  const int parts = n_chunks + 1;  // ring slots a key tile
  const int wg = threadIdx.x / 128;
  init_ring<L>(full);

  if (wg == 1) {  // the producer
    regs_dealloc<kProducerRegs>();
    if (threadIdx.x == 128) {
      for (int n = 0; n < n_tiles * parts; ++n) {
        const int it = n / parts, c = n % parts, st = n % L::kStages;
        mbar_wait(empty + st, ((n / L::kStages) & 1) ^ 1);
        unsigned char* dst = smem + st * L::kPart;
        if (c < n_chunks) {
          mbar_expect_tx(full + st, 2 * T::kBytes);
          tma_load_tile<128>(dst, &q_map, full + st, q0, slice, 128 * c);
          tma_load_tile<128>(dst + T::kBytes, &k_map, full + st,
                             it * kBlockK, slice, 128 * c);
        } else {
          mbar_expect_tx(full + st, T::kBytes);
          tma_load_tile<128>(dst, &v_map, full + st, it * kBlockK, slice,
                             128 * j);
        }
      }
    }
  } else {  // the consumer
    regs_alloc<kConsumerRegs>();
    const int tid = threadIdx.x;
    const int warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, t = lane % 4;
    float acc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

    for (int it = 0; it < n_tiles; ++it) {
      // raw scores q K^T over every chunk: element 4n + e is row
      // g + 8 (e >> 1), key it * 64 + 8n + 2t + (e & 1)
      float s[32];
      chunk_scores<L>(s, full, smem, it * parts, n_chunks);

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
        const float m_new = fmaxf(m[r], mx * scale_log2);
        alpha[r] = flash_exp2(m[r] - m_new);
        m[r] = m_new;
        bias[r] = -m_new;
      }
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        s[i] = flash_exp2(fmaf(s[i], scale_log2, bias[(i >> 1) & 1]));
        tile_sum[(i >> 1) & 1] += s[i];
      }
      uint32_t pa[4][4];
      to_a_fragments(s, pa);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        tile_sum[r] += __shfl_xor_sync(0xffffffffu, tile_sum[r], 1);
        tile_sum[r] += __shfl_xor_sync(0xffffffffu, tile_sum[r], 2);
        l[r] = fmaf(l[r], alpha[r], tile_sum[r]);
      }
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[i] *= alpha[(i >> 1) & 1];

      const int n = it * parts + n_chunks;
      const uint32_t va = wait_part<L>(full, smem, n);
      wgmma_fence();
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
        wgmma_rs_mn<128>(acc, pa[jj], desc_mn_major<128>(va, jj));
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(acc);
      mbar_arrive(empty + n % L::kStages);
    }

    const size_t base = (size_t)slice * S;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = q0 + warp * 16 + g + 8 * r;
      if (row >= S) continue;
      const float inv_l = 1.f / l[r];
      bf16* orow = o + (base + row) * D + 128 * j + 2 * t;
#pragma unroll
      for (int n = 0; n < 16; ++n)
        if (128 * j + n * 8 < D)
          *reinterpret_cast<uint32_t*>(orow + n * 8) = pack_bf16(
              acc[4 * n + 2 * r] * inv_l, acc[4 * n + 2 * r + 1] * inv_l);
      if (t == 0 && j == 0) lse[base + row] = m[r] + log2f(l[r]);
    }
  }
}

// ---------------------------------------------------------------------------
// launch

// the scale of the scores, D^-1/2 log2(e), from the head width `d` whose
// root scales them (the caller's own where it pads the head)
float scale_log2_of(int d) { return (float)(kLog2e / sqrt((double)d)); }

// a one-dimensional grid of `blocks` row blocks times `bh` slices times
// `slices` output slices, or 0 where it exceeds gridDim.x's 2^31 - 1
unsigned grid_of(int s, int rows, int bh, int slices = 1) {
  const long long n = (long long)((s + rows - 1) / rows) * bh * slices;
  return n <= 0x7fffffffll ? (unsigned)n : 0u;
}

template <int DP, bool kSkipRescale>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* o,
                        void* lse, int bh, int s, int d, float scale_log2,
                        cudaStream_t stream) {
  cudaError_t err;
  CUtensorMap qm, km, vm;
  if ((err = tile_map<DP>(&qm, q, bh, s, d)) ||
      (err = tile_map<DP>(&km, k, bh, s, d)) ||
      (err = tile_map<DP>(&vm, v, bh, s, d)))
    return err;
  const auto kernel = flash_fwd_bf16_kernel<DP, kSkipRescale>;
  constexpr size_t smem = FwdSmem<DP>::bytes;
  static std::atomic<uint64_t> smem_set{0};
  if ((err = set_smem_once(kernel, smem, smem_set))) return err;
  if constexpr (FwdSmem<DP>::kGrowRegs) {
    static const cudaError_t pool =
        check_register_pool(kernel, FwdSmem<DP>::kConsumers);
    if (pool != cudaSuccess) return pool;
  }
  const unsigned grid = grid_of(s, FwdSmem<DP>::kConsumers * kTileRows, bh);
  if (!grid) return cudaErrorInvalidValue;
  flash_fwd_bf16_kernel<DP, kSkipRescale>
      <<<grid, FwdSmem<DP>::kThreads, smem, stream>>>(
          qm, km, vm, static_cast<bf16*>(o), static_cast<float*>(lse), s, d,
          scale_log2);
  return cudaGetLastError();
}

cudaError_t launch_wide_bf16(const void* q, const void* k, const void* v,
                             void* o, void* lse, int bh, int s, int d,
                             float scale_log2, cudaStream_t stream) {
  using L = WideSmem;
  cudaError_t err;
  CUtensorMap qm, km, vm;
  if ((err = tile_map<128>(&qm, q, bh, s, d)) ||
      (err = tile_map<128>(&km, k, bh, s, d)) ||
      (err = tile_map<128>(&vm, v, bh, s, d)))
    return err;
  static std::atomic<uint64_t> smem_set{0};
  if ((err = set_smem_once(flash_fwd_wide_bf16_kernel, L::bytes, smem_set)))
    return err;
  static const cudaError_t pool =
      check_register_pool(flash_fwd_wide_bf16_kernel, L::kConsumers);
  if (pool != cudaSuccess) return pool;
  const unsigned grid = grid_of(s, kTileRows, bh, (d + 127) / 128);
  if (!grid) return cudaErrorInvalidValue;
  flash_fwd_wide_bf16_kernel<<<grid, L::kThreads, L::bytes, stream>>>(
      qm, km, vm, static_cast<bf16*>(o), static_cast<float*>(lse), s, d,
      scale_log2);
  return cudaGetLastError();
}

cudaError_t launch_fma(const void* q, const void* k, const void* v, void* o,
                       void* lse, int bh, int s, int d, float scale_log2,
                       cudaStream_t stream) {
  constexpr size_t smem = fma_smem_bytes();
  static std::atomic<uint64_t> smem_set{0};
  cudaError_t err;
  if ((err = set_smem_once(flash_fwd_f32_fma_kernel, smem, smem_set)))
    return err;
  const unsigned grid = grid_of(s, kBlockQ, bh, (d + kFmaD - 1) / kFmaD);
  if (!grid) return cudaErrorInvalidValue;
  flash_fwd_f32_fma_kernel<<<grid, kFmaThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o),
      static_cast<float*>(lse), s, d, scale_log2);
  return cudaGetLastError();
}

template <int DP>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o,
                       void* lse, const float* scratch, int bh, int s, int d,
                       float scale_log2, cudaStream_t stream) {
  using L = FwdSmemF32<DP>;
  const size_t plane = 2 * (size_t)bh * s * d;  // one operand's hi + lo
  cudaError_t err;
  CUtensorMap qm, km, vtm;
  if ((err = split_map(&qm, scratch, bh, s, d, kTileRows)) ||
      (err = split_map(&km, scratch + plane, bh, s, d, L::kBlk)) ||
      (err = trans_map(&vtm, scratch + 2 * plane, bh, d, round_up_tile(s),
                       DP)))
    return err;
  static std::atomic<uint64_t> smem_set{0};
  if ((err = set_smem_once(flash_fwd_f32_kernel<DP>, L::bytes, smem_set)))
    return err;
  static const cudaError_t pool =
      check_register_pool(flash_fwd_f32_kernel<DP>, L::kConsumers);
  if (pool != cudaSuccess) return pool;
  const unsigned grid = grid_of(s, L::kConsumers * kTileRows, bh);
  if (!grid) return cudaErrorInvalidValue;
  flash_fwd_f32_kernel<DP><<<grid, L::kThreads, L::bytes, stream>>>(
      qm, km, vtm, static_cast<float*>(o), static_cast<float*>(lse), s, d,
      scale_log2);
  return cudaGetLastError();
}

bool bad_shape(int bh, int s, int d, int max_d) {
  return bh <= 0 || s <= 0 || d < 8 || d > max_d || d % 8;
}

}  // namespace

// q, k, v: contiguous (bh, s, d) float32 device arrays, 16-byte aligned,
// d % 8 == 0 and 8 <= d <= 128; scratch: a 16-byte aligned float32 array of
// 4 bh s d + 2 bh d sp elements, sp = s rounded up to 64. Launches the
// float32 forward's pre-pass on `stream` without synchronising: the TF32 hi
// and lo planes of q and K, then of V^T, into `scratch`, for a later
// ddti_flash_fwd on the same stream. Returns the launch's cudaError_t (0 =
// success).
extern "C" int ddti_flash_fwd_split_f32(const void* q, const void* k,
                                        const void* v, void* scratch, int bh,
                                        int s, int d, int device,
                                        void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (bad_shape(bh, s, d, kMaxSplitD)) return (int)cudaErrorInvalidValue;
  const int sp = round_up_tile(s);
  const unsigned grid = grid_of(sp, kTileRows, bh);
  if (!grid) return (int)cudaErrorInvalidValue;
  float* split = static_cast<float*>(scratch);
  flash_fwd_split_f32_kernel<<<grid, kSplitThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), split, split + 4 * (size_t)bh * s * d, bh,
      s, sp, d);
  return (int)cudaGetLastError();
}

// q, k, v, o: contiguous (bh, s, d) device arrays of float32 (is_bf16 == 0)
// or bfloat16 (is_bf16 == 1), 16-byte aligned, d % 8 == 0 and d >= 8; lse:
// (bh, s) float32; scratch: in float32 with d <= 128, what
// ddti_flash_fwd_split_f32 wrote for the same q, k, v earlier on the same
// stream, else unused. The scores are scaled by scale_d^-1/2: scale_d is d,
// or the true width of a head the caller padded with zero columns to d.
// Routes: bf16 d <= 256 and float32 d <= 128 on the kernels of one tile
// of the padded width; bf16 d > 256 on the wide kernel (output slices of
// 128 columns); float32 d > 128 on the FMA kernel (slices of 256).
// Launches on `stream` without synchronising and returns the launch's
// cudaError_t (0 = success).
extern "C" int ddti_flash_fwd(const void* q, const void* k, const void* v,
                              void* o, void* lse, const void* scratch, int bh,
                              int s, int d, int scale_d, int is_bf16,
                              int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const bool bf = is_bf16 != 0;
  if (bad_shape(bh, s, d, 1 << 30) || scale_d <= 0 ||
      (!bf && d <= kMaxSplitD && !scratch))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float sl = scale_log2_of(scale_d);
  const float* sc = static_cast<const float*>(scratch);
  cudaError_t e;
  if (bf)
    e = d <= 32    ? launch_bf16<32, false>(q, k, v, o, lse, bh, s, d, sl, st)
        : d <= 64  ? launch_bf16<64, false>(q, k, v, o, lse, bh, s, d, sl, st)
        : d <= 128 ? launch_bf16<128, false>(q, k, v, o, lse, bh, s, d, sl,
                                             st)
        : d <= 256 ? launch_bf16<256, false>(q, k, v, o, lse, bh, s, d, sl,
                                             st)
                   : launch_wide_bf16(q, k, v, o, lse, bh, s, d, sl, st);
  else
    e = d <= 32    ? launch_f32<32>(q, k, v, o, lse, sc, bh, s, d, sl, st)
        : d <= 64  ? launch_f32<64>(q, k, v, o, lse, sc, bh, s, d, sl, st)
        : d <= 128 ? launch_f32<128>(q, k, v, o, lse, sc, bh, s, d, sl, st)
                   : launch_fma(q, k, v, o, lse, bh, s, d, sl, st);
  return (int)e;
}

// As ddti_flash_fwd, through the m-skip variant of the bf16 kernel (the
// port of benchmarks/flash_mskip_ab.py:fwd): bfloat16 only, d <= 256
// (is_bf16 == 0 returns cudaErrorInvalidValue); scratch is unused.
extern "C" int ddti_flash_fwd_mskip(const void* q, const void* k,
                                    const void* v, void* o, void* lse,
                                    const void* scratch, int bh, int s, int d,
                                    int is_bf16, int device, void* stream) {
  (void)scratch;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (bad_shape(bh, s, d, 256) || !is_bf16) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float sl = scale_log2_of(d);
  return (int)(
      d <= 32    ? launch_bf16<32, true>(q, k, v, o, lse, bh, s, d, sl, st)
      : d <= 64  ? launch_bf16<64, true>(q, k, v, o, lse, bh, s, d, sl, st)
      : d <= 128 ? launch_bf16<128, true>(q, k, v, o, lse, bh, s, d, sl, st)
                 : launch_bf16<256, true>(q, k, v, o, lse, bh, s, d, sl, st));
}

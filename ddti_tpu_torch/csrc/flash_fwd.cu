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
// the wide kernels below, which stream D in chunks and give each consumer
// warpgroup a slice of o's columns (bf16: a block a slice of 128, each
// recomputing the scores; float32: two slices of at most 128 a block,
// which share the scores). B*H: any; blocks run over (row block,
// slice, b*h) on gridDim.x alone.
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
//  - float32, D > 128 (flash_fwd_wide_f32_kernel, WideSmemF32). The first
//    version's scalar-FMA loops ran these widths at 2-5% of the 3xTF32
//    bound on an H100 (0.73-1.45 ms at (2, 2, 1024, 136-512), whose bound
//    is 0.014-0.052 ms of products against 0.003-0.011 ms of q, k, v and
//    o: the products bound it, as at every width). Now 3xTF32 on wgmma
//    like D <= 128, on the pre-pass's planes (for every D), built around
//    what does not fit: q's planes for 64 rows take 512 D bytes (128 KB at
//    D = 256), and a consumer's accumulator 64 registers a thread for 128
//    of o's columns. Nothing stays resident: per tile of 64 keys a block
//    streams the score chunks (q_c, K_c) of 32 columns, then the V^T parts
//    (64 of o's columns by the tile's keys), hi and lo planes each, as 32
//    KB slots of a six-slot mbarrier ring. The scores sum each 64 columns
//    of D (two chunks) in a fresh accumulator, added on the CUDA cores
//    like each part's P V, so that no tensor-core sum runs over the whole
//    of D or S. A consumer owns a slice of at most 128 of o's columns; a
//    block holds two, and P goes through shared memory: each
//    consumer computes the scores of 32 of the tile's keys, the two swap
//    their row maxima, write their probabilities split into TF32 hi and lo
//    planes in V^T's key order, and both read the whole of P as the A
//    operand of their P V products (wgmma with both operands in shared
//    memory), so the scores run once for the block's two slices. Heads
//    past 256 columns run blocks of two slices, each computing the scores:
//    at the 168 registers a thread that three warpgroups may have, one SM
//    holds no more than two consumers' accumulators (a consumer with 128
//    registers of accumulator spilled there). Every block of a row
//    computes the same scores in the same order, so m agrees; the block of
//    slice 0 writes lse2. What bounds it is shared memory: wgmma reads both
//    operands from it (4 KB a 32-clock m64n64k8, 3 KB a 16-clock m64n32k8
//    score product) beside the slots TMA writes, more than the SM's 128
//    bytes a clock; keeping q resident (16 KB slots) or a second
//    accumulator in flight (spills) ran slower.
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
//    on the FMA pipes (flash_exp2) instead of the exp2 unit,
//    the TPU kernels' DDTI_POLY_EXP2 switch. ddti_flash_fwd_mskip runs the
//    bf16 kernel with kSkipRescale (the port of the TPU probe
//    benchmarks/flash_mskip_ab.py:fwd; see the kernel).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

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
constexpr int kSplitCols = 128;  // the columns of a pre-pass block

// The float32 pre-pass, per 64-row block and kSplitCols-column chunk of one
// slice: q and K as TF32 hi and lo planes (split_tf32), `split` (2, bh, 2,
// s, d), and V^T as `trans` (bh, 2, d, sp), zero past s, each group of 8
// keys in the order {0, 2, 4, 6, 1, 3, 5, 7} (store_trans_split). 16 bytes
// a thread at a time; V's transpose passes through shared memory. The
// column chunks are blocks of their own, so that a wide head's pre-pass
// fills the SMs.
__global__ void __launch_bounds__(kSplitThreads)
flash_fwd_split_f32_kernel(const float* __restrict__ q,
                           const float* __restrict__ k,
                           const float* __restrict__ v,
                           float* __restrict__ split,
                           float* __restrict__ trans, int bh, int s, int sp,
                           int D) {
  __shared__ float tile[kTileRows][kSplitCols + 1];
  const int n_blocks = sp / kTileRows;
  const int n_cols = (D + kSplitCols - 1) / kSplitCols;
  const int r0 = blockIdx.x % n_blocks * kTileRows;
  const int rest = blockIdx.x / n_blocks;
  const int c0 = rest % n_cols * kSplitCols, slice = rest / n_cols;
  const int C4 = min(kSplitCols, D - c0) / 4;  // 16-byte chunks of a row
  const size_t plane = (size_t)s * D, tplane = (size_t)D * sp;
  for (int x = 0; x < 3; ++x) {
    const float* in = (x == 0 ? q : x == 1 ? k : v) + (size_t)slice * plane;
    float* out = split + ((size_t)x * bh + slice) * 2 * plane;  // x < 2
    for (int i = threadIdx.x; i < kTileRows * C4; i += kSplitThreads) {
      const int r = i / C4, c = 4 * (i - r * C4), row = r0 + r;
      float4 f = make_float4(0.f, 0.f, 0.f, 0.f);
      if (row < s)
        f = *reinterpret_cast<const float4*>(in + (size_t)row * D + c0 + c);
      if (x == 2) {
        tile[r][c] = f.x, tile[r][c + 1] = f.y;
        tile[r][c + 2] = f.z, tile[r][c + 3] = f.w;
      } else if (row < s) {
        uint32_t hi[4], lo[4];
        split_tf32(f.x, hi[0], lo[0]);
        split_tf32(f.y, hi[1], lo[1]);
        split_tf32(f.z, hi[2], lo[2]);
        split_tf32(f.w, hi[3], lo[3]);
        *reinterpret_cast<uint4*>(out + (size_t)row * D + c0 + c) =
            make_uint4(hi[0], hi[1], hi[2], hi[3]);
        *reinterpret_cast<uint4*>(out + plane + (size_t)row * D + c0 + c) =
            make_uint4(lo[0], lo[1], lo[2], lo[3]);
      }
    }
  }
  __syncthreads();
  store_trans_split<kSplitThreads>(
      tile, trans + (size_t)slice * 2 * tplane + (size_t)c0 * sp, tplane, sp,
      r0, 4 * C4);
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
// float32, D > 128: 3xTF32 on wgmma over D-chunks, TMA

// A wide float32 block: 64 query rows, two consumer warpgroups and a
// producer warpgroup. Consumer c owns o's columns of slice 2 grp + c
// (n_slices slices of D, whole 8-column groups, at most kMaxW columns
// each). Nothing
// is resident: per tile of kBlk keys the producer streams, a slot each, the
// score chunks (q_c, K_c) of kChunk columns, then each consumer's parts of
// V^T (kPartRows of o's columns by the tile's keys), hi and lo planes each.
// A consumer computes the scores of N = kBlk / 2 keys of the tile over
// every chunk, the consumers exchange their row maxima, and each
// writes its keys' probabilities, split into TF32 hi and lo planes, to the
// block's P tile in shared memory, in V^T's key order; then every consumer
// reads the whole of P as the A operand of its P V products. The scores
// are computed once for the block's two slices.
struct WideSmemF32 {
  static constexpr int kConsumers = 2;
  static constexpr int kThreads = 128 * (kConsumers + 1);
  static constexpr int kBlk = 64;       // keys a tile
  static constexpr int kChunk = 32;     // q's and K's columns a score slot
  static constexpr int kPartRows = 64;  // o's columns a V^T part
  static constexpr int kMaxW = 128;     // o's columns a consumer
  static constexpr int kStages = 6;
  // setmaxnreg's split of the SM's 65536 registers: the producer's loop
  // tracks two consumers' parts; 128 (2 x 232 + 40) = 64512
  static constexpr int kProducerRegs = 40;
  static constexpr int kConsumerRegs = 232;
  static constexpr uint32_t kBox = kTileRows * 128;  // 64 rows of 32 floats
  // a slot: q_c hi, q_c lo, K_c hi, K_c lo; or V^T's part, hi (keys 0-31,
  // 32-63), then lo
  static constexpr uint32_t kPart = 4 * kBox;
  static constexpr uint32_t stages = 0;
  static constexpr uint32_t p = kStages * kPart;  // P: hi (2 boxes), lo
  static constexpr uint32_t red = p + 4 * kBox;   // [2][2][64] floats
  static constexpr uint32_t bars = red + 2 * kConsumers * kTileRows * 4;
  static constexpr size_t bytes = bars + 8 * (2 * kStages + 1) + 1024;
  static_assert(bytes <= 232448, "shared memory");
};

// slice j of n of a head of width D: o's columns col0 .. col0 + w - 1, D / 8
// groups of 8 shared out evenly, the first D / 8 % n slices one group wider;
// w = 0 past the last slice
__device__ __forceinline__ void wide_slice(int j, int n, int D, int& col0,
                                           int& w) {
  const int groups = D / 8, base = groups / n, extra = groups % n;
  col0 = 8 * (j * base + min(j, extra));
  w = j < n ? 8 * (base + (j < extra ? 1 : 0)) : 0;
}

// the block's consumer warpgroups, named barrier 1
__device__ __forceinline__ void sync_consumers() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(WideSmemF32::kConsumers * 128)
               : "memory");
}

// d (64 x N) = q_c K_c^T over KS k8 steps of the score slots at shared
// addresses a0 (k8 steps 0-3) and a1 (4-7) as three TF32 products, the
// small terms first; K_c's rows from k_off bytes into its planes
template <typename L, int N, int KS>
__device__ __forceinline__ void wide_chunk_product(float (&d)[N / 2],
                                                   uint32_t a0, uint32_t a1,
                                                   uint32_t k_off) {
#pragma unroll
  for (int term = 0; term < 3; ++term)
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      const uint32_t slot = kk < 4 ? a0 : a1;
      // a_lo b_hi, a_hi b_lo, a_hi b_hi
      const uint32_t a = slot + (term == 0 ? L::kBox : 0);
      const uint32_t b = slot + (term == 1 ? 3 : 2) * L::kBox + k_off;
      wgmma_tf32_ss<N>(d, desc_f32<kTileRows>(a, kk % 4),
                       desc_f32<kTileRows>(b, kk % 4), term > 0 || kk > 0);
    }
}

// s (64 x N) = q K^T for one key tile, from its score slots at ring
// positions n .. n + ceil(D / kChunk) - 1: each 64 columns of D (two
// slots; the last perhaps fewer) summed in a fresh accumulator and added on
// the CUDA cores, as acc_tile sums P V, so that no sum over the whole of D
// runs in a tensor-core accumulator
template <typename L, int N>
__device__ __forceinline__ void wide_scores(float (&s)[N / 2],
                                            uint64_t* full,
                                            unsigned char* smem, int n, int D,
                                            uint32_t k_off) {
  const int n_chunks = (D + L::kChunk - 1) / L::kChunk;
  for (int c = 0; c < n_chunks; c += 2) {
    const int ks = min(8, (D - L::kChunk * c) / 8);  // k8 steps
    const uint32_t a0 = wait_part<L>(full, smem, n + c);
    const uint32_t a1 = ks > 4 ? wait_part<L>(full, smem, n + c + 1) : a0;
    float tmp[N / 2];
    wgmma_fence();
#define WIDE_CHUNK(KS)                                         \
  wide_chunk_product<L, N, KS>(tmp, a0, a1, k_off); \
  break
    switch (ks) {
      case 1: WIDE_CHUNK(1);
      case 2: WIDE_CHUNK(2);
      case 3: WIDE_CHUNK(3);
      case 4: WIDE_CHUNK(4);
      case 5: WIDE_CHUNK(5);
      case 6: WIDE_CHUNK(6);
      case 7: WIDE_CHUNK(7);
      default: WIDE_CHUNK(8);
    }
#undef WIDE_CHUNK
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(tmp);
    mbar_arrive(full + L::kStages + (n + c) % L::kStages);
    if (ks > 4) mbar_arrive(full + L::kStages + (n + c + 1) % L::kStages);
#pragma unroll
    for (int i = 0; i < N / 2; ++i) s[i] = c ? s[i] + tmp[i] : tmp[i];
  }
}

// columns OFF .. OFF + N - 1 of a part's product (64 x 64, float32) = P V
// over the tile's 64 keys, as three TF32 products: P (hi, lo at p + 2 kBox)
// and the V^T part (hi, lo at v + 2 kBox) K-major in shared memory
template <typename L, int N, int OFF>
__device__ __forceinline__ void wide_pv_piece(float (&d)[32], uint32_t p,
                                              uint32_t v) {
  float(&x)[N / 2] = *reinterpret_cast<float(*)[N / 2]>(&d[OFF / 2]);
  const uint32_t b = v + OFF * 128;
#pragma unroll
  for (int term = 0; term < 3; ++term)
#pragma unroll
    for (int kk = 0; kk < L::kBlk / 8; ++kk)
      wgmma_tf32_ss<N>(
          x, desc_f32<kTileRows>(p + (term == 0 ? 2 * L::kBox : 0), kk),
          desc_f32<kTileRows>(b + (term == 1 ? 2 * L::kBox : 0), kk),
          term > 0 || kk > 0);
}

// the first R columns of a part's product, R % 8 == 0: pieces of 64, or 32,
// 16 and 8 (wgmma's N)
template <typename L, int R>
__device__ __forceinline__ void wide_pv_columns(float (&d)[32], uint32_t p,
                                                uint32_t v) {
  if constexpr (R == 64) {
    wide_pv_piece<L, 64, 0>(d, p, v);
  } else {
    if constexpr ((R & 32) != 0) wide_pv_piece<L, 32, 0>(d, p, v);
    if constexpr ((R & 16) != 0) wide_pv_piece<L, 16, (R & 32)>(d, p, v);
    if constexpr ((R & 8) != 0) wide_pv_piece<L, 8, (R & 48)>(d, p, v);
  }
}

template <typename L>
__device__ __forceinline__ void wide_pv_part(float (&d)[32], int r,
                                             uint32_t p, uint32_t v) {
#define WIDE_COLUMNS(R)                \
  wide_pv_columns<L, R>(d, p, v); \
  break
  switch (r) {
    case 8: WIDE_COLUMNS(8);
    case 16: WIDE_COLUMNS(16);
    case 24: WIDE_COLUMNS(24);
    case 32: WIDE_COLUMNS(32);
    case 40: WIDE_COLUMNS(40);
    case 48: WIDE_COLUMNS(48);
    case 56: WIDE_COLUMNS(56);
    default: WIDE_COLUMNS(64);
  }
#undef WIDE_COLUMNS
}

// D: the actual head width, D % 8 == 0; n_slices: the slices of D, at most
// kMaxW columns each. Blocks run over (row block, slice group, b*h) on
// gridDim.x alone.
__global__ void __launch_bounds__(WideSmemF32::kThreads, 1)
flash_fwd_wide_f32_kernel(const __grid_constant__ CUtensorMap q_map,
                          const __grid_constant__ CUtensorMap k_map,
                          const __grid_constant__ CUtensorMap vt_map,
                          float* __restrict__ o, float* __restrict__ lse,
                          int S, int D, int n_slices, float scale_log2) {
  using L = WideSmemF32;
  constexpr int C = L::kConsumers;
  constexpr int N = L::kBlk / C;  // a consumer's keys of a tile
  constexpr int kParts = L::kMaxW / L::kPartRows;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::bars);
  uint64_t* empty = full + L::kStages;
  const int n_blocks = (S + kTileRows - 1) / kTileRows;
  const int n_groups = (n_slices + C - 1) / C;
  const int rest = blockIdx.x / n_blocks;
  const int q0 = blockIdx.x % n_blocks * kTileRows;
  const int grp = rest % n_groups, slice = rest / n_groups;
  const int n_tiles = (S + L::kBlk - 1) / L::kBlk;
  const int n_chunks = (D + L::kChunk - 1) / L::kChunk;
  const int wg = threadIdx.x / 128;
  // each consumer's slice and V^T parts; a tile's ring positions: its score
  // slots, then consumer 0's parts, then consumer 1's
  int col0[C], parts[C], per_tile = n_chunks;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    int w;
    wide_slice(grp * C + c, n_slices, D, col0[c], w);
    parts[c] = (w + L::kPartRows - 1) / L::kPartRows;
    per_tile += parts[c];
  }
  init_ring<L>(full);

  if (wg == C) {  // the producer
    regs_dealloc<L::kProducerRegs>();
    if (threadIdx.x == C * 128) {
      int n = 0;
      for (int it = 0; it < n_tiles; ++it) {
        for (int x = 0; x < per_tile; ++x, ++n) {
          const int st = n % L::kStages;
          mbar_wait(empty + st, ((n / L::kStages) & 1) ^ 1);
          mbar_expect_tx(full + st, L::kPart);
          unsigned char* dst = smem + L::stages + st * L::kPart;
          if (x < n_chunks) {
            tma_load_split<L::kChunk, kTileRows>(dst, &q_map, full + st, q0,
                                                 slice, L::kChunk * x);
            tma_load_split<L::kChunk, L::kBlk>(dst + 2 * L::kBox, &k_map,
                                               full + st, it * L::kBlk, slice,
                                               L::kChunk * x);
          } else {
            const int pp = x - n_chunks;  // consumer 1's from parts[0] on
            const bool second = pp >= parts[0];
            tma_load_trans<L::kPartRows, L::kBlk>(
                dst, &vt_map, full + st, it * L::kBlk, slice,
                second ? col0[C - 1] + L::kPartRows * (pp - parts[0])
                       : col0[0] + L::kPartRows * pp);
          }
        }
      }
    }
  } else {  // a consumer: o's columns of its slice in rows q0 .. q0 + 63
    regs_alloc<L::kConsumerRegs>();
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, t = lane % 4;
    int my_col0, w;
    wide_slice(grp * C + wg, n_slices, D, my_col0, w);
    const int n_parts = (w + L::kPartRows - 1) / L::kPartRows;
    // the V^T parts of the other consumer, before or after this one's
    const int before = wg > 0 ? parts[0] : 0;
    const int after = per_tile - n_chunks - before - n_parts;
    float* red = reinterpret_cast<float*>(smem + L::red);
    unsigned char* p_tile = smem + L::p;
    const uint32_t p_addr = smem_addr(p_tile);
    const int rows[2] = {warp * 16 + g, warp * 16 + g + 8};
    float acc[L::kMaxW / 2];
#pragma unroll
    for (int i = 0; i < L::kMaxW / 2; ++i) acc[i] = 0.f;
    // rows g and g + 8 of this warp's 16, in the base-2 scaled domain; l
    // sums this consumer's keys only
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

    for (int it = 0; it < n_tiles; ++it) {
      const int n0 = it * per_tile;
      // raw scores q K^T: element 4j + e is row g + 8 (e >> 1), key
      // k0 + 8j + 2t + (e & 1)
      float s[N / 2];
      wide_scores<L, N>(s, full, smem, n0, D, wg * N * 128);
      const int k0 = it * L::kBlk + wg * N;
      if (k0 + N > S) {
#pragma unroll
        for (int i = 0; i < N / 2; ++i)
          if (k0 + (i / 4) * 8 + 2 * t + (i & 1) >= S) s[i] = -INFINITY;
      }
      float mx[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(s[2 * r], s[2 * r + 1]);
#pragma unroll
        for (int j = 1; j < N / 8; ++j)
          mx[r] = fmaxf(mx[r], fmaxf(s[4 * j + 2 * r], s[4 * j + 2 * r + 1]));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      }
      // every consumer is done with the last tile's P; the consumers' row
      // maxima meet
      if (t == 0) {
        red[wg * kTileRows + rows[0]] = mx[0];
        red[wg * kTileRows + rows[1]] = mx[1];
      }
      sync_consumers();
#pragma unroll
      for (int r = 0; r < 2; ++r)
        mx[r] = fmaxf(red[rows[r]], red[kTileRows + rows[r]]);
      float alpha[2], bias[2], tile_sum[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        // every tile holds at least one valid key, so m_new is finite
        const float m_new = fmaxf(m[r], mx[r] * scale_log2);
        alpha[r] = flash_exp2(m[r] - m_new);
        m[r] = m_new;
        bias[r] = -m_new;
      }
      // p = exp2(s c - m), float32: l sums it, and P's planes take it split
      // into TF32 hi and lo at the position of its key in V^T's order
      // {0, 2, 4, 6, 1, 3, 5, 7} (key 2t at t, 2t + 1 at t + 4), through
      // the 128-byte swizzle (16-byte chunk ^ row % 8)
#pragma unroll
      for (int i = 0; i < N / 2; ++i) {
        s[i] = flash_exp2(fmaf(s[i], scale_log2, bias[(i >> 1) & 1]));
        tile_sum[(i >> 1) & 1] += s[i];
        const int row = rows[(i >> 1) & 1];
        const int pos = wg * N + 8 * (i / 4) + t + 4 * (i & 1);
        const uint32_t off = (pos / 32) * L::kBox + row * 128 +
                             ((((pos % 32) >> 2) ^ (row & 7)) << 4) + 4 * t;
        uint32_t hi, lo;
        split_tf32(s[i], hi, lo);
        *reinterpret_cast<uint32_t*>(p_tile + off) = hi;
        *reinterpret_cast<uint32_t*>(p_tile + 2 * L::kBox + off) = lo;
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        tile_sum[r] += __shfl_xor_sync(0xffffffffu, tile_sum[r], 1);
        tile_sum[r] += __shfl_xor_sync(0xffffffffu, tile_sum[r], 2);
        l[r] = l[r] * alpha[r] + tile_sum[r];
      }
#pragma unroll
      for (int i = 0; i < L::kMaxW / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];
      // P, written by every consumer, to the tensor cores
      fence_proxy_async();
      sync_consumers();

      // O += P V: the other consumer's parts released as they land, this
      // one's each summed in a fresh accumulator and added on the CUDA
      // cores
      int n = n0 + n_chunks;
      for (int j = 0; j < before; ++j, ++n) {
        wait_part<L>(full, smem, n);
        mbar_arrive(empty + n % L::kStages);
      }
#pragma unroll
      for (int pp = 0; pp < kParts; ++pp) {
        if (pp < n_parts) {
          const uint32_t v = wait_part<L>(full, smem, n);
          // a part of fewer than 64 columns writes only the first of cur;
          // the rest goes to acc's columns past w, never stored
          float cur[32] = {};
          wgmma_fence();
          wide_pv_part<L>(cur, w - L::kPartRows * pp, p_addr, v);
          wgmma_commit();
          wgmma_wait<0>();
          fence_acc(cur);
#pragma unroll
          for (int i = 0; i < 32; ++i) acc[32 * pp + i] += cur[i];
          mbar_arrive(empty + n % L::kStages);
          ++n;
        }
      }
      for (int j = 0; j < after; ++j, ++n) {
        wait_part<L>(full, smem, n);
        mbar_arrive(empty + n % L::kStages);
      }
    }

    // l over every key
    float* red_l = red + C * kTileRows;
    if (t == 0) {
      red_l[wg * kTileRows + rows[0]] = l[0];
      red_l[wg * kTileRows + rows[1]] = l[1];
    }
    sync_consumers();
#pragma unroll
    for (int r = 0; r < 2; ++r)
      l[r] = red_l[rows[r]] + red_l[kTileRows + rows[r]];
    const size_t base = (size_t)slice * S;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = q0 + rows[r];
      if (row >= S) continue;
      const float inv_l = 1.f / l[r];
      float* orow = o + (base + row) * D + my_col0 + 2 * t;
#pragma unroll
      for (int j = 0; j < L::kMaxW / 8; ++j)
        if (j * 8 < w)
          *reinterpret_cast<float2*>(orow + j * 8) = make_float2(
              acc[4 * j + 2 * r] * inv_l, acc[4 * j + 2 * r + 1] * inv_l);
      if (t == 0 && grp * C + wg == 0) lse[base + row] = m[r] + log2f(l[r]);
    }
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

// float32, d > 128, on the pre-pass's planes: slices of at most kMaxW of
// o's columns, two a block, which compute the scores once
cudaError_t launch_wide_f32(void* o, void* lse, const float* scratch, int bh,
                            int s, int d, float scale_log2,
                            cudaStream_t stream) {
  using L = WideSmemF32;
  const size_t plane = 2 * (size_t)bh * s * d;  // one operand's hi + lo
  cudaError_t err;
  CUtensorMap qm, km, vtm;
  if ((err = split_map(&qm, scratch, bh, s, d, kTileRows)) ||
      (err = split_map(&km, scratch + plane, bh, s, d, L::kBlk)) ||
      (err = trans_map(&vtm, scratch + 2 * plane, bh, d, round_up_tile(s),
                       L::kPartRows)))
    return err;
  static std::atomic<uint64_t> smem_set{0};
  if ((err = set_smem_once(flash_fwd_wide_f32_kernel, L::bytes, smem_set)))
    return err;
  static const cudaError_t pool =
      check_register_pool<L::kConsumerRegs, L::kProducerRegs>(
          flash_fwd_wide_f32_kernel, L::kConsumers);
  if (pool != cudaSuccess) return pool;
  const int n_slices = (d + L::kMaxW - 1) / L::kMaxW;
  const unsigned grid = grid_of(s, kTileRows, bh,
                                (n_slices + L::kConsumers - 1) / L::kConsumers);
  if (!grid) return cudaErrorInvalidValue;
  flash_fwd_wide_f32_kernel<<<grid, L::kThreads, L::bytes, stream>>>(
      qm, km, vtm, static_cast<float*>(o), static_cast<float*>(lse), s, d,
      n_slices, scale_log2);
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
// d % 8 == 0 and d >= 8; scratch: a 16-byte aligned float32 array of
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
  if (bad_shape(bh, s, d, 1 << 30)) return (int)cudaErrorInvalidValue;
  const int sp = round_up_tile(s);
  const unsigned grid =
      grid_of(sp, kTileRows, bh, (d + kSplitCols - 1) / kSplitCols);
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
// (bh, s) float32; scratch: in float32, what ddti_flash_fwd_split_f32 wrote
// for the same q, k, v earlier on the same stream, else unused. The scores
// are scaled by scale_d^-1/2: scale_d is d, or the true width of a head the
// caller padded with zero columns to d. Routes: bf16 d <= 256 and float32
// d <= 128 on the kernels of one tile of the padded width; bf16 d > 256 on
// the wide kernel (output slices of 128 columns); float32 d > 128 on the
// wide float32 kernel (slices of at most 128).
// Launches on `stream` without synchronising and returns the launch's
// cudaError_t (0 = success).
extern "C" int ddti_flash_fwd(const void* q, const void* k, const void* v,
                              void* o, void* lse, const void* scratch, int bh,
                              int s, int d, int scale_d, int is_bf16,
                              int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const bool bf = is_bf16 != 0;
  if (bad_shape(bh, s, d, 1 << 30) || scale_d <= 0 || (!bf && !scratch))
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
                   : launch_wide_f32(o, lse, sc, bh, s, d, sl, st);
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

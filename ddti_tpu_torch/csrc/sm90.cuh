// Hopper (sm_90a) building blocks of the flash-attention kernels (and of
// the conv3x3 probe's and the int8 conv's), in inline PTX: TMA tile loads
// that complete on mbarriers (and TMA stores), wgmma with shared-memory
// matrix descriptors (bf16; tf32 for float32 as three TF32 products, see
// "3xTF32" below; s8 x s8 -> s32), setmaxnreg, and the host-side encoding
// of the TMA tensor maps (cuTensorMapEncodeTiled, looked up in libcuda at
// run time, so the plain-C library links no -lcuda).
//
// Tiles. An operand tile is 64 rows of a contiguous (bh, S, D) bf16 array,
// padded to DP columns (D <= DP; TMA fills columns past D and rows past S
// with zeros). TMA loads it as DP / 64 boxes of [64 rows][64 columns] (one
// box of [64][32] at DP = 32) with the swizzle that matches a box row's
// bytes, 64 B at DP = 32 and 128 B otherwise; eight box rows are the
// swizzle's repeat (the "atom", 512 or 1024 bytes), and every box starts on
// a 1024-byte boundary. wgmma reads such a tile
//   K-major, where the head dimension is the product's k (q K^T, K q^T):
//     k-step kk (16 columns) starts in box 16 kk / 64 at byte 32 (kk % 4)
//     of the row, 8-row groups one atom apart (SBO);
//   MN-major, where the rows are the product's k (P V, P^T dO, dS^T q):
//     k-step kk (16 rows) starts 16 rows down, 8-row groups one atom apart
//     (SBO) and 64-column boxes along N one box apart (LBO).
// Accumulators follow wgmma's m64nN layout: warp w of the warpgroup holds
// rows 16w + g and 16w + g + 8 (g = lane / 4) at columns 8n + 2t and
// 8n + 2t + 1 (t = lane % 4) in d[4n .. 4n + 3]. That is mma.sync's C
// layout tile by tile, so two adjacent 8-column tiles rounded to bf16 are
// the register A fragment of one k16 step (to_a_fragments).

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kTileRows = 64;
// A block is C consumer warpgroups of 64 rows each and a producer, one
// thread of which issues the TMA loads. Where the consumers need more
// registers than an even share, the producer is a whole warpgroup and
// setmaxnreg takes it down to kProducerRegs and the consumers up to
// kConsumerRegs: the register file is four quadrants of 16 K, one per warp
// scheduler, so a lone ninth warp would cap every thread at 168 just as a
// producer warpgroup does, and at C = 2, 168 x 384 = 240 x 256 + 24 x 128.
constexpr int kConsumerRegs = 240;
constexpr int kProducerRegs = 24;

template <int DP>
struct Tile {
  static_assert(DP == 32 || DP == 64 || DP == 128 || DP == 256, "DP");
  static constexpr int kBoxCols = DP < 64 ? DP : 64;
  static constexpr int kBoxes = DP / kBoxCols;
  static constexpr uint32_t kRowBytes = 2 * kBoxCols;
  static constexpr uint32_t kBoxBytes = kTileRows * kRowBytes;
  static constexpr uint32_t kBytes = kBoxes * kBoxBytes;
  static constexpr uint32_t kAtom = 8 * kRowBytes;
  static constexpr uint64_t kLayout = DP == 32 ? 2 : 1;  // wgmma: 64B, 128B
  static constexpr CUtensorMapSwizzle kSwizzle =
      DP == 32 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_128B;
};

// ---------------------------------------------------------------------------
// device

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// the dynamic shared memory rounded up to the swizzle's 1024-byte boundary
// (the kernels ask for 1024 bytes more than they use)
__device__ __forceinline__ unsigned char* align_1024(unsigned char* p) {
  return p + ((1024 - (smem_addr(p) & 1023)) & 1023);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// arrive, and expect `bytes` more of TMA traffic before the phase completes
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// Wait for the phase of parity `parity` to complete. A barrier that stays
// open for 2^34 clocks (seconds) means a broken pipeline: trap, so the
// launch fails with an error instead of hanging the device.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_addr(bar);
  long long start = 0;
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
    if (done) return;
    const long long now = clock64();
    if (!start) start = now;
    else if (now - start > (1ll << 34)) __trap();
  }
}

// The barriers of a block's ring of L::kStages slots, from `full` on, and
// the block's sync: full[i] completes when slot i's tiles land (one
// arrival, the producer's, plus the TMA bytes), empty[i] = full[kStages +
// i] when all L::kConsumers consumer warpgroups are done with it, and
// full[2 kStages] when the tiles the block loads once land.
template <typename L>
__device__ __forceinline__ void init_ring(uint64_t* full) {
  if (threadIdx.x == 0) {
    for (int i = 0; i < L::kStages; ++i) {
      mbar_init(full + i, 1);
      mbar_init(full + L::kStages + i, L::kConsumers * 128);
    }
    mbar_init(full + 2 * L::kStages, 1);
    mbar_fence_init();
  }
  __syncthreads();
}

// 2^x on the exp2 unit alone: exp2f adds a fix-up for subnormal results
// around it, which probabilities below 2^-126 do not need
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// The Taylor coefficient ln2^k / k! of 2^f = e^(f ln2), k = 0..6, rounded
// to float32 (ddti_tpu_torch/ops/attention.py:EXP2_POLY_COEFFS)
__device__ __forceinline__ constexpr float exp2_coeff(int k) {
  return k == 1   ? 0x1.62e430p-1f
         : k == 2 ? 0x1.ebfbe0p-3f
         : k == 3 ? 0x1.c6b08ep-5f
         : k == 4 ? 0x1.3b2ab6p-7f
         : k == 5 ? 0x1.5d87fep-10f
         : k == 6 ? 0x1.430912p-13f
                  : 1.0f;
}

// 2^x on the FMA pipes: the TPU kernels' polynomial exp2
// (ddti_tpu/ops/attention.py:_exp2_poly, benchmarks/exp2_probe.py:
// _poly_exp2). 2^x = 2^i P(f), i = x rounded half to even, f = x - i in
// [-0.5, 0.5], P the Taylor polynomial of order ORDER by Horner (one FMA a
// term), i clamped to [-126, 127] and 2^i built as (i + 127) << 23. The
// rounding is the add of 1.5 * 2^23, which leaves i in the sum's low
// mantissa bits: no FRND and no F2I, which issue at the exp2 unit's rate.
// x is first clamped to >= -2^22, where the add is exact, so -inf and the
// -1e30 sentinel give 2^-126 (the TPU kernels' value at their sentinel),
// never NaN. Max relative error against float64 on [-20, 3]: 5.6e-5,
// 3.3e-6 and 2.2e-7 at orders 4, 5, 6.
template <int ORDER>
__device__ __forceinline__ float exp2_poly(float x) {
  static_assert(ORDER >= 4 && ORDER <= 6, "order");
  constexpr float kRound = 12582912.f;  // 1.5 * 2^23
  x = fmaxf(x, -4194304.f);             // -2^22
  const float r = __fadd_rn(x, kRound);
  const float f = __fsub_rn(x, __fsub_rn(r, kRound));
  const int i = min(max(__float_as_int(r) - 0x4B400000, -126), 127);
  float p = exp2_coeff(ORDER);
#pragma unroll
  for (int k = ORDER - 1; k >= 0; --k) p = fmaf(p, f, exp2_coeff(k));
  return p * __int_as_float((i + 127) << 23);
}

// The flash kernels' exponential: the exp2 unit, or where the library is
// built with -DDDTI_POLY_EXP2=1 (ddti_tpu_torch/ops/_build.py) the order-6
// polynomial on the FMA pipes, as the TPU kernels' DDTI_POLY_EXP2 switch
// does.
#ifndef DDTI_POLY_EXP2
#define DDTI_POLY_EXP2 0
#endif

__device__ __forceinline__ float flash_exp2(float x) {
#if DDTI_POLY_EXP2
  return exp2_poly<6>(x);
#else
  return exp2_ftz(x);
#endif
}

__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1,
                                         int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1,
                                         int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// arrive `count` times at once
__device__ __forceinline__ void mbar_arrive(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

// the box at `src` in shared memory to global memory (coordinates past the
// tensor's edges are not written), in the thread's bulk async-group
__device__ __forceinline__ void tma_store(const CUtensorMap* map,
                                          const void* src, int c0, int c1,
                                          int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(smem_addr(src)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_store(const CUtensorMap* map,
                                          const void* src, int c0, int c1,
                                          int c2, int c3, int c4) {
  asm volatile(
      "cp.async.bulk.tensor.5d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4, %5, %6}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(smem_addr(src)), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(c4)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// wait until the thread's bulk stores have read their shared memory (READ)
// or are complete
template <bool READ>
__device__ __forceinline__ void bulk_wait() {
  if constexpr (READ)
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  else
    asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// generic-proxy writes to shared memory visible to the async proxy (TMA)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// rows [row, row + 64) of slice `slice`, columns [col, col + DP), as a
// DP-wide tile at `dst`
template <int DP>
__device__ __forceinline__ void tma_load_tile(unsigned char* dst,
                                              const CUtensorMap* map,
                                              uint64_t* bar, int row,
                                              int slice, int col = 0) {
#pragma unroll
  for (int b = 0; b < Tile<DP>::kBoxes; ++b)
    tma_load(dst + b * Tile<DP>::kBoxBytes, map, bar,
             col + b * Tile<DP>::kBoxCols, row, slice);
}

__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, uint64_t layout) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         (uint64_t)((lbo >> 4) & 0x3FFF) << 16 |
         (uint64_t)((sbo >> 4) & 0x3FFF) << 32 | layout << 62;
}

// descriptor of k-step kk of the tile at shared address `tile`, read with
// the head dimension as k
template <int DP>
__device__ __forceinline__ uint64_t desc_k_major(uint32_t tile, int kk) {
  using T = Tile<DP>;
  return smem_desc(tile + (kk * 16 / T::kBoxCols) * T::kBoxBytes +
                       (kk * 16 % T::kBoxCols) * 2,
                   16, T::kAtom, T::kLayout);
}

// descriptor of k-step kk of the tile, read with its rows as k
template <int DP>
__device__ __forceinline__ uint64_t desc_mn_major(uint32_t tile, int kk) {
  using T = Tile<DP>;
  return smem_desc(tile + kk * 16 * T::kRowBytes, T::kBoxBytes, T::kAtom,
                   T::kLayout);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keep the compiler from moving reads or writes of an accumulator across
// the asynchronous wgmma that owns it
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int R>
__device__ __forceinline__ void regs_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}

template <int R>
__device__ __forceinline__ void regs_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// a 64-column accumulator rounded to bf16 as the A fragments of four k16
// steps over its columns
__device__ __forceinline__ void to_a_fragments(const float (&x)[32],
                                               uint32_t (&a)[4][4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      a[j][i] = pack_bf16(x[8 * j + 2 * i], x[8 * j + 2 * i + 1]);
}

// d (64 x N, float32) += A B over one k16 step: A (64 x 16) from registers
// (a k16 A fragment), B (16 x N) MN-major in shared memory
template <int N>
__device__ __forceinline__ void wgmma_rs_mn(float (&d)[N / 2],
                                            const uint32_t (&a)[4],
                                            uint64_t b);


// d (64 x 128, float32) {=, +=} A B over one k16 step: A (64 x 16) and B
// (16 x 128) both K-major in shared memory; accumulate = 0 overwrites d.
__device__ __forceinline__ void wgmma_m64n128k16_ss(float (&d)[64], uint64_t a,
                                                    uint64_t b,
                                                    int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12,"
      "%13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34,"
      "%35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45,"
      "%46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56,"
      "%57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (64 x 64, float32) {=, +=} A B over one k16 step: A (64 x 16) and B
// (16 x 64, its 64 rows of k) both K-major in shared memory; accumulate = 0
// overwrites d.
__device__ __forceinline__ void wgmma_m64n64k16_ss(float (&d)[32], uint64_t a,
                                                   uint64_t b,
                                                   int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12,"
      "%13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_rs_mn<32>(float (&d)[16],
                                                const uint32_t (&a)[4],
                                                uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12,"
      "%13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs_mn<64>(float (&d)[32],
                                                const uint32_t (&a)[4],
                                                uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12,"
      "%13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs_mn<128>(float (&d)[64],
                                                const uint32_t (&a)[4],
                                                uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12,"
      "%13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34,"
      "%35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45,"
      "%46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56,"
      "%57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs_mn<256>(float (&d)[128],
                                                const uint32_t (&a)[4],
                                                uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12,"
      "%13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34,"
      "%35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45,"
      "%46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56,"
      "%57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67,"
      "%68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78,"
      "%79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89,"
      "%90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100,"
      "%101, %102, %103, %104, %105, %106, %107, %108, %109,"
      "%110, %111, %112, %113, %114, %115, %116, %117, %118,"
      "%119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// ---------------------------------------------------------------------------
// int8 products (csrc/conv_s8.cu): s8 x s8 -> s32, exact. For 8-bit
// operands wgmma reads A and B only K-major from shared memory (there is
// no transpose bit); a k32 step is 32 bytes of each row, as a bf16 k16
// step is, so the descriptors are the bf16 ones. The accumulator layout
// is the float32 one, in int32 registers.

template <int N>
__device__ __forceinline__ void fence_acc(int (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// d (64 x 64, int32) {=, +=} A B over one k32 step, s8 x s8 -> s32:
// A (64 x 32) and B (32 x 64) both K-major in shared memory (8-bit
// operands take no other layout); accumulate = 0 overwrites d.
__device__ __forceinline__ void wgmma_m64n64k32_s8(int (&d)[32], uint64_t a,
                                                   uint64_t b,
                                                   int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31"
      "}, %32, %33, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (64 x 128, int32) {=, +=} A B over one k32 step, s8 x s8 -> s32:
// A (64 x 32) and B (32 x 128) both K-major in shared memory (8-bit
// operands take no other layout); accumulate = 0 overwrites d.
__device__ __forceinline__ void wgmma_m64n128k32_s8(int (&d)[64],
                                                    uint64_t a, uint64_t b,
                                                    int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
        "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]),
        "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
        "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),
        "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(a), "l"(b), "r"(accumulate));
}

// ---------------------------------------------------------------------------
// float32 products as three TF32 products (3xTF32)
//
// x = hi + lo with hi = tf32(x) and lo = tf32(x - hi), both rounded to
// nearest (cvt.rna), so the tensor core's truncation of the low 13 bits
// never applies; a b = a_lo b_hi + a_hi b_lo + a_hi b_hi leaves about 2^-21
// of each term (a_lo b_lo, ~2^-22, is dropped). tf32 wgmma takes K-major
// operands only. A float32 operand region of R rows is loaded by TMA as
// 32-column boxes of R x 128 bytes with the 128-byte swizzle: byte for byte
// a bf16 tile of twice the columns, and a k8 step is 32 bytes, as a bf16
// k16 step is. The register A fragment of a k8 step holds, per thread, rows
// g and g + 8 at columns t and t + 4 (CUTLASS's ALayout_64x8), while an
// accumulator holds columns 2t and 2t + 1 of each 8-column group: the B
// operand that meets an accumulator as A stores its k positions of each
// group of 8 in the order {0, 2, 4, 6, 1, 3, 5, 7} (split_fragments).

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

// an m64nK accumulator (K / 2 floats a thread) as the hi and lo A
// fragments of its K / 8 k8 steps, k permuted as the B operand stores it
template <int K>
__device__ __forceinline__ void split_fragments(const float (&x)[K / 2],
                                               uint32_t (&hi)[K / 8][4],
                                               uint32_t (&lo)[K / 8][4]) {
#pragma unroll
  for (int j = 0; j < K / 8; ++j) {
    split_tf32(x[4 * j], hi[j][0], lo[j][0]);      // row g,     k t
    split_tf32(x[4 * j + 2], hi[j][1], lo[j][1]);  // row g + 8, k t
    split_tf32(x[4 * j + 1], hi[j][2], lo[j][2]);  // row g,     k t + 4
    split_tf32(x[4 * j + 3], hi[j][3], lo[j][3]);  // row g + 8, k t + 4
  }
}

// keep A fragments live (and in place) until the wgmma reading them is
// waited for
template <int N>
__device__ __forceinline__ void fence_frag(uint32_t (&a)[N][4]) {
#pragma unroll
  for (int j = 0; j < N; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(a[j][i])::"memory");
}

// descriptor of k8 step kk of a float32 region of R rows (K-major)
template <int R>
__device__ __forceinline__ uint64_t desc_f32(uint32_t region, int kk) {
  return smem_desc(region + (kk / 4) * R * 128 + (kk % 4) * 32, 16, 1024, 1);
}

// d (64 x N, float32) {=, +=} A B over one k8 step, tf32: A (64 x 8) and
// B (8 x N) K-major in shared memory
template <int N>
__device__ __forceinline__ void wgmma_tf32_ss(float (&d)[N / 2], uint64_t a,
                                              uint64_t b, int accumulate);

// d (64 x N, float32) += A B over one k8 step, tf32: A from registers, B
// K-major in shared memory
template <int N>
__device__ __forceinline__ void wgmma_tf32_rs(float (&d)[N / 2],
                                              const uint32_t (&a)[4],
                                              uint64_t b);

template <>
__device__ __forceinline__ void wgmma_tf32_ss<8>(float (&d)[4], uint64_t a,
                                                 uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3"
      "}, %4, %5, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "l"(a), "l"(b), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_tf32_ss<16>(float (&d)[8], uint64_t a,
                                                  uint64_t b,
                                                  int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, %8, %9, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(a), "l"(b), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_tf32_ss<32>(float (&d)[16], uint64_t a,
                                                  uint64_t b,
                                                  int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12,"
      "%13, %14, %15"
      "}, %16, %17, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_tf32_ss<64>(float (&d)[32], uint64_t a,
                                                  uint64_t b,
                                                  int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12,"
      "%13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_tf32_rs<32>(float (&d)[16],
                                                  const uint32_t (&a)[4],
                                                  uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12,"
      "%13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_tf32_rs<64>(float (&d)[32],
                                                  const uint32_t (&a)[4],
                                                  uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12,"
      "%13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_tf32_rs<128>(float (&d)[64],
                                                   const uint32_t (&a)[4],
                                                   uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12,"
      "%13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34,"
      "%35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45,"
      "%46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56,"
      "%57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d = A B^T over k = 8 ksteps, A (64 rows) and B (N rows) float32 regions
// split hi / lo, K-major, as three TF32 products, the small terms first:
// every a_lo b_hi, then every a_hi b_lo, then every a_hi b_hi
template <int N, int R_A, int ksteps>
__device__ __forceinline__ void product3_ss(float (&d)[N / 2], uint32_t a_hi,
                                            uint32_t a_lo, uint32_t b_hi,
                                            uint32_t b_lo) {
#pragma unroll
  for (int kk = 0; kk < ksteps; ++kk)
    wgmma_tf32_ss<N>(d, desc_f32<R_A>(a_lo, kk), desc_f32<N>(b_hi, kk), kk);
#pragma unroll
  for (int kk = 0; kk < ksteps; ++kk)
    wgmma_tf32_ss<N>(d, desc_f32<R_A>(a_hi, kk), desc_f32<N>(b_lo, kk), 1);
#pragma unroll
  for (int kk = 0; kk < ksteps; ++kk)
    wgmma_tf32_ss<N>(d, desc_f32<R_A>(a_hi, kk), desc_f32<N>(b_hi, kk), 1);
}

// d += A B over K columns of A from registers (split_fragments) and a
// float32 B region (N rows, boxes of R rows) split hi / lo, as three TF32
// products
template <int N, int K, int R>
__device__ __forceinline__ void product3_rs(float (&d)[N / 2],
                                            const uint32_t (&a_hi)[K / 8][4],
                                            const uint32_t (&a_lo)[K / 8][4],
                                            uint32_t b_hi, uint32_t b_lo) {
#pragma unroll
  for (int j = 0; j < K / 8; ++j)
    wgmma_tf32_rs<N>(d, a_lo[j], desc_f32<R>(b_hi, j));
#pragma unroll
  for (int j = 0; j < K / 8; ++j)
    wgmma_tf32_rs<N>(d, a_hi[j], desc_f32<R>(b_lo, j));
#pragma unroll
  for (int j = 0; j < K / 8; ++j)
    wgmma_tf32_rs<N>(d, a_hi[j], desc_f32<R>(b_hi, j));
}

// acc (64 x N) += A B for one streamed tile, A (64 x K) split in registers,
// B (N rows, K columns) split hi / lo in shared memory. The tensor cores'
// float32 accumulation rounds toward zero, so summing a whole sequence in
// one wgmma accumulator drifts by about its number of k8 steps times
// 2^-24 (~1e-5 of the result at S = 1024, 4e-5 at 4096): each tile's
// product is summed in a fresh accumulator instead, at most 64 columns at
// a time, and added to `acc` on the CUDA cores, rounded to nearest. Waits
// for its products, so the fragments are free again on return.
template <int N, int K>
__device__ __forceinline__ void acc_tile(float (&acc)[N / 2],
                                         uint32_t (&a_hi)[K / 8][4],
                                         uint32_t (&a_lo)[K / 8][4],
                                         uint32_t b_hi, uint32_t b_lo) {
  constexpr int NT = N < 64 ? N : 64;
#pragma unroll
  for (int h = 0; h < N / NT; ++h) {
    float tmp[NT / 2];
#pragma unroll
    for (int i = 0; i < NT / 2; ++i) tmp[i] = 0.f;
    fence_acc(tmp);
    wgmma_fence();
    product3_rs<NT, K, N>(tmp, a_hi, a_lo, b_hi + h * NT * 128,
                          b_lo + h * NT * 128);
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(tmp);
    fence_frag(a_hi);
    fence_frag(a_lo);
#pragma unroll
    for (int i = 0; i < NT / 2; ++i) acc[h * NT / 2 + i] += tmp[i];
  }
}

// Float32 operands reach the tf32 kernels as TF32 hi and lo planes that a
// pre-pass writes to scratch: row-major (bh, 2, s, d), or transposed (bh,
// 2, d, sp) with sp = s rounded up to 64 and zeros past s.

// rows [row, row + R), columns [col, col + DP) of a (bh, 2, s, d) split
// plane pair, hi then lo, as DP / 32 boxes each
template <int DP, int R>
__device__ __forceinline__ void tma_load_split(unsigned char* dst,
                                               const CUtensorMap* map,
                                               uint64_t* bar, int row,
                                               int slice, int col = 0) {
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int b = 0; b < DP / 32; ++b)
      tma_load(dst + h * R * DP * 4 + b * R * 128, map, bar, col + 32 * b,
               row, 2 * slice + h);
}

// columns [col, col + C) of a (bh, 2, d, sp) transposed plane pair, DP
// rows from row d0, hi then lo, as C / 32 boxes each
template <int DP, int C>
__device__ __forceinline__ void tma_load_trans(unsigned char* dst,
                                               const CUtensorMap* map,
                                               uint64_t* bar, int col,
                                               int slice, int d0 = 0) {
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int b = 0; b < C / 32; ++b)
      tma_load(dst + h * DP * C * 4 + b * DP * 128, map, bar, col + 32 * b,
               d0, 2 * slice + h);
}

// slot of ring position n of a block whose ring of L::kStages slots of
// L::kPart bytes starts at L::stages, waited for
template <typename L>
__device__ __forceinline__ uint32_t wait_part(uint64_t* full,
                                              unsigned char* smem, int n) {
  const int st = n % L::kStages;
  mbar_wait(full + st, (n / L::kStages) & 1);
  return smem_addr(smem + L::stages + st * L::kPart);
}

// The wide kernels' scores (heads wider than one tile): d (64 x 64) = sum
// over `chunks` D-chunks of A_c B_c^T, bf16, from ring positions n0 ..
// n0 + chunks - 1, each slot A_c then B_c (64 x 128 tiles, both K-major),
// one accumulator over every chunk; each slot is released once its
// product is done.
template <typename L>
__device__ __forceinline__ void chunk_scores(float (&d)[32], uint64_t* full,
                                             unsigned char* smem, int n0,
                                             int chunks) {
  for (int c = 0; c < chunks; ++c) {
    const uint32_t a = wait_part<L>(full, smem, n0 + c);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 8; ++kk)
      wgmma_m64n64k16_ss(d, desc_k_major<128>(a, kk),
                         desc_k_major<128>(a + Tile<128>::kBytes, kk),
                         c > 0 || kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(d);
    mbar_arrive(full + L::kStages + (n0 + c) % L::kStages);
  }
}

// A pre-pass block's 64 rows r0 .. r0 + 63 of one float32 operand, staged
// in `tile` (zeros past s), as columns r0 .. r0 + 63 of the operand's
// transposed hi and lo planes (`out`, out + tplane: d rows of sp columns),
// the positions of each group of 8 in the order {0, 2, 4, 6, 1, 3, 5, 7}
// that split_fragments expects of a B operand met by an accumulator. Four
// positions p .. p + 3 of a transposed row a thread: the tile rows
// (p & ~7) + {0, 2, 4, 6} where p % 8 = 0, + {1, 3, 5, 7} where it is 4.
template <int kThreads, int kLd>
__device__ __forceinline__ void store_trans_split(const float (*tile)[kLd],
                                                  float* out, size_t tplane,
                                                  int sp, int r0, int d) {
  for (int i = threadIdx.x; i < d * kTileRows / 4; i += kThreads) {
    const int c = i / (kTileRows / 4), p = 4 * (i % (kTileRows / 4));
    const int r = (p & ~7) | (p & 4 ? 1 : 0);
    uint32_t hi[4], lo[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) split_tf32(tile[r + 2 * j][c], hi[j], lo[j]);
    *reinterpret_cast<uint4*>(out + (size_t)c * sp + r0 + p) =
        make_uint4(hi[0], hi[1], hi[2], hi[3]);
    *reinterpret_cast<uint4*>(out + tplane + (size_t)c * sp + r0 + p) =
        make_uint4(lo[0], lo[1], lo[2], lo[3]);
  }
}

// ---------------------------------------------------------------------------
// host

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled() {
  static const EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    return cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p,
                                            12000, cudaEnableDefault,
                                            &found) == cudaSuccess &&
                   found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiledFn>(p)
               : nullptr;
  }();
  return fn;
}

inline cudaError_t encode(CUtensorMap* map, CUtensorMapDataType type,
                          cuuint32_t rank, const void* base,
                          const cuuint64_t* dims, const cuuint64_t* strides,
                          const cuuint32_t* box, CUtensorMapSwizzle swizzle) {
  const EncodeTiledFn fn = encode_tiled();
  if (!fn) return cudaErrorNotSupported;
  const cuuint32_t ones[5] = {1, 1, 1, 1, 1};
  return fn(map, type, rank, const_cast<void*>(base), dims, strides, box,
            ones, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS
             ? cudaSuccess
             : cudaErrorInvalidValue;
}

// The dynamic shared memory a kernel may use, set once per kernel and
// device (cudaFuncSetAttribute costs host time on every launch otherwise).
// `done` is the caller's flag word for this one kernel, one bit per device
// 0..63: a static here would be shared by every kernel of the same
// signature, such as one kernel's instantiations for several widths.
template <typename Kernel>
cudaError_t set_smem_once(Kernel kernel, size_t bytes,
                          std::atomic<uint64_t>& done) {
  int dev;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const uint64_t bit = dev < 64 ? 1ull << dev : 0;
  if (done.load() & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess) done.fetch_or(bit);
  return err;
}

// setmaxnreg.inc waits until the block's register pool, fixed at launch,
// holds what it asks for: refuse a kernel whose pool is too small rather
// than launch it into a hang (the check runs once per kernel)
template <int kConsumer = kConsumerRegs, int kProducer = kProducerRegs,
          typename Kernel>
cudaError_t check_register_pool(Kernel kernel, int consumers) {
  cudaFuncAttributes a;
  const cudaError_t err = cudaFuncGetAttributes(&a, kernel);
  if (err != cudaSuccess) return err;
  return a.numRegs * 128 * (consumers + 1) >=
                 128 * (kConsumer * consumers + kProducer)
             ? cudaSuccess
             : cudaErrorInvalidConfiguration;
}

// a contiguous (bh, s, d) bf16 array as DP-wide tiles of 64 rows: a 3-D map
// (d, s, bh), so rows past s of one slice read as zeros and never as the
// next slice's, and so do columns d..DP-1
template <int DP>
cudaError_t tile_map(CUtensorMap* map, const void* base, int bh, int s,
                     int d) {
  const cuuint64_t dims[3] = {(cuuint64_t)d, (cuuint64_t)s, (cuuint64_t)bh};
  const cuuint64_t strides[2] = {2ull * d, 2ull * d * s};
  const cuuint32_t box[3] = {(cuuint32_t)Tile<DP>::kBoxCols, kTileRows, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, base, dims,
                strides, box, Tile<DP>::kSwizzle);
}

// float32 split planes (bh, 2, s, d) as a 3-D map (d, s, 2 bh) of boxes of
// `box_rows` rows and 32 columns (128 bytes, the 128-byte swizzle); rows
// past s and columns past d read as zeros
inline cudaError_t split_map(CUtensorMap* map, const float* planes, int bh,
                             int s, int d, int box_rows) {
  const cuuint64_t dims[3] = {(cuuint64_t)d, (cuuint64_t)s, 2ull * bh};
  const cuuint64_t strides[2] = {4ull * d, 4ull * d * s};
  const cuuint32_t box[3] = {32, (cuuint32_t)box_rows, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, planes, dims,
                strides, box, CU_TENSOR_MAP_SWIZZLE_128B);
}

// float32 transposed planes (bh, 2, d, sp) as a 3-D map (sp, d, 2 bh) of
// boxes of DP rows (d, zeros past it) and 32 columns
inline cudaError_t trans_map(CUtensorMap* map, const float* planes, int bh,
                             int d, int sp, int dp) {
  const cuuint64_t dims[3] = {(cuuint64_t)sp, (cuuint64_t)d, 2ull * bh};
  const cuuint64_t strides[2] = {4ull * sp, 4ull * sp * d};
  const cuuint32_t box[3] = {32, (cuuint32_t)dp, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, planes, dims,
                strides, box, CU_TENSOR_MAP_SWIZZLE_128B);
}

inline int round_up_tile(int s) {
  return (s + kTileRows - 1) / kTileRows * kTileRows;
}

}  // namespace

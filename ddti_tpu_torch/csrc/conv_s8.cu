// The int8 convolution of the int8 serving graph, for Hopper (sm_90a),
// plain C interface for ctypes.
//
// Replaces no Pallas kernel. The JAX package's int8 serving graph runs every
// quantized conv as XLA's s8 x s8 -> s32 convolution
// (ddti_tpu/train/quantize.py:_quant_interceptor, lax.conv_general_dilated /
// lax.conv_transpose with preferred_element_type=int32) after quantizing
// its input, xq = clip(rint(x / sx), -127, 127); PyTorch offers no int8
// convolution on CUDA, so the port writes its own. It computes
//
//   acc[m, co] = sum_k A[m, k] * B[k, co]      exact int32
//   y[m, co]   = float(acc) * (sx * sw[co]) (+ bias[co])   -> f32 or bf16
//
// as an implicit GEMM over NHWC activations: m is an output pixel (n, oy,
// ox), k a tap and an input channel, A[m, k] = xq[n, oy*s - pt + kh*d,
// ox*s - pl + kw*d, ci] (zero outside the frame, so any SAME, VALID or
// asymmetric padding is the bounds check), B the int8 weights packed by the
// wrapper, k contiguous. x is the int8 activation, or its bf16 or float32
// value, which the kernel quantizes as it loads it: x / sx correctly
// rounded (quant_fast: a product with the reciprocal where it decides
// alike, __fdiv_rn elsewhere; the library is built without
// --use_fast_math), clamped to +-127 and rounded half to even, bit for bit
// JAX's and torch's arithmetic, so the int8 activation never reaches
// device memory.
// The epilogue rounds as JAX's graph does, in its order: sx * sw first,
// then the product, then the bias, each correctly rounded (__fmul_rn /
// __fadd_rn, so no FMA contracts them), then the cast.
//
// The transposed conv of the decoders (k = 2, s = 2, VALID, flax's kernel
// orientation) gives each output pixel exactly one tap, chosen by its
// parity: y[2a + r] = x[a] * w[1 - r] on each axis. It runs as four GEMMs,
// one per parity, over the input pixels with K = C.
//
// Two routes; the wrapper (ops/conv_s8.py:route_of) picks one from the
// geometry before the launch.
//
// Route "wgmma" (ddti_conv_s8_wgmma): stride 1 (any k, a dilation whose
// box fits shared memory) and the transposed conv, C % 16 == 0, Cout rows
// of whole 16 bytes. What bounds it on an H100: at the flagship's first
// level (16 x 512^2 x 64 -> 64, bf16 in and out) the bytes (x read once,
// y written once at 3.35 TB/s: 0.32 ms) exceed the operations (2 M Cout 9
// C at 1,979 TOP/s int8: 0.156 ms); at the deeper levels the operations
// lead. Design, after csrc/conv3x3.cu, a persistent grid of one block a SM
// and four warpgroups, each stage ahead of the next under mbarriers:
//  - tiles of 16 x 8 output pixels by BN = 64 or 128 output channels, the
//    channel tile fastest (a pixel tile's x is read from device memory
//    once); the transposed conv's tiles also walk its four parities.
//  - producers (one thread each): x through a 4-D tensor map (C, W, H, N)
//    in its own type, the tile's whole box for a chunk of 64 channels,
//    (16 + (k-1)d) x (8 + (k-1)d) pixels, one load (TMA writes zeros
//    outside the frame, which quantize to 0); weights through a 3-D map
//    (Kp, Cout, parities) of the packed (P, Cout, taps Cp) table, C zero-
//    padded to Cp, a multiple of 64, a tap's BN x 64 tile a ring slot;
//    TMA stores of the output.
//  - the quantizer warpgroup: each box once into an s8 A tile in wgmma's
//    K-major layout without swizzle, eight consecutive pixels of a box row
//    a core matrix (generic-proxy writes, then fence.proxy.async). Tap
//    (kh, kw) of a warpgroup's 8 x 8 pixels starts at box pixel (8 w + kh
//    d, kw d), rows bw pixels apart: one tile serves all k^2 taps of both
//    consumers. The division is a product with 1 / sx, exact unless the
//    quotient lies within 2^-14 of a half-integer, where __fdiv_rn decides
//    (quant_fast): a branch a value kept the values' chains apart.
//  - two consumer warpgroups of 8 x 8 pixels on wgmma m64nBNk32 s8 x s8 ->
//    s32, a group a tap, one left running. Integer sums are exact:
//    one accumulator a tile (conv3x3's fresh chunk sums, a float32
//    workaround, are not needed). The epilogue writes each warpgroup's 64
//    pixels into its staging area as boxes of 128-byte rows in the
//    128-byte swizzle (bf16 pairs land in 32 distinct banks), which the
//    storer writes with TMA stores; they leave out pixels past the frame
//    and channels past Cout. The transposed conv's output goes through a
//    5-D map (Cout, rx, W, ry, N H) over y, so a parity's 8 x 8 input
//    pixels land at (2a + ry, 2b + rx) as one box.
// On an H100 80GB HBM3 at 700 W it reaches 33-41% of the bound at the
// flagship's five 3x3 levels with bf16 x (0.38-0.90 ms); taking its parts
// out one at a time (probes/conv_s8_ablate.py) leaves no byte stream that
// bounds it: the products and the quantization add to the floor that a
// tile's handoffs through the stages set (PERF.md).
//
// Route "mma" (ddti_conv_s8), the first design, for what route "wgmma"
// does not take (strided convs, C % 16 != 0: the first conv's one channel
// padded to 4, the heads' Cout = 1, a dilation whose box outgrows shared
// memory): a block of 4 warps computes a 64 x 64 tile of (pixels, output
// channels) with mma.sync.m16n8k32 s8 x s8 -> s32, each warp 32 x 32 (2 x
// 4 instructions a k-step of 32). A and B tiles of 64 x 32 bytes sit in
// shared memory with rows of 48 bytes (12 words: the fragment reads of a
// warp hit 32 distinct banks); each thread stages one 16-byte piece of
// each tile a step, loading (and quantizing) the next step's pieces while
// the tensor cores run the current one. A piece of A lies in one tap when
// C % 16 == 0; otherwise (C = 4, 8, 12) it is four 4-channel words, each
// with its own tap. It took 6-10x the first level's bound, limited
// by issue and latency. The weights are packed once per table
// (ops/conv_s8.py:packed_weights), not per call.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

// ---------------------------------------------------------------------------
// the activation's quantization, shared by both routes

// The scale and its correctly rounded reciprocal, made once a thread.
struct Scale {
  float sx, rb;
};

__device__ __forceinline__ Scale make_scale(const float* sx_p) {
  const float sx = *sx_p;
  return Scale{sx, __frcp_rn(sx)};
}

// x / sx correctly rounded (__fdiv_rn), clamped to +-127 and rounded half
// to even, returned as the bits of 1.5 * 2^23 + q, whose low byte is q as
// an int8 (the add rounds; no FRND and no F2I, which issue at a quarter
// rate). Clamping before rounding gives clamp(rint(.)) exactly.
__device__ __forceinline__ uint32_t quant_exact(float x, float sx) {
  const float q = fminf(fmaxf(__fdiv_rn(x, sx), -127.f), 127.f);
  return __float_as_uint(__fadd_rn(q, 12582912.f));
}

// The same without a division: q = x * rb lies within 1.5 * 2^-23 |q| of
// the correctly rounded x / sx (rb is within 2^-24 of 1 / sx, and each
// product rounds once), at most 2^-15.4 where |q| <= 128, and both clamp
// alike past +-127. So the two round to one integer unless q lies within
// 2^-14 of a half-integer: `near` is set there, and the caller takes
// quant_exact instead (a branch-free path; __fdiv_rn's own slow-path
// branch kept the compiler from interleaving the values' chains).
__device__ __forceinline__ uint32_t quant_fast(float x, Scale s, bool& near) {
  const float q = fminf(fmaxf(__fmul_rn(x, s.rb), -127.f), 127.f);
  const float r = __fadd_rn(q, 12582912.f);
  const float d = __fsub_rn(q, __fsub_rn(r, 12582912.f));
  near |= fabsf(fabsf(d) - 0.5f) < 0x1p-14f;
  return __float_as_uint(r);
}

// the low bytes of a, b, c, d as one word, a lowest
__device__ __forceinline__ uint32_t pack4(uint32_t a, uint32_t b, uint32_t c,
                                          uint32_t d) {
  return __byte_perm(__byte_perm(a, b, 0x0040), __byte_perm(c, d, 0x0040),
                     0x5410);
}

// N float values quantized into N / 4 words
template <int N>
__device__ __forceinline__ void quant_n(const float (&f)[N], Scale s,
                                        uint32_t (&out)[N / 4]) {
  uint32_t b[N];
  bool near = false;
#pragma unroll
  for (int i = 0; i < N; ++i) b[i] = quant_fast(f[i], s, near);
  if (near) {
#pragma unroll
    for (int i = 0; i < N; ++i) b[i] = quant_exact(f[i], s.sx);
  }
#pragma unroll
  for (int i = 0; i < N / 4; ++i)
    out[i] = pack4(b[4 * i], b[4 * i + 1], b[4 * i + 2], b[4 * i + 3]);
}

// N channels of x at p (N = 4: 4-, 8- or 16-byte aligned; N = 16: 16-,
// 32- or 64-byte aligned) as N / 4 words of int8
template <int N, typename XT>
__device__ __forceinline__ void quant_load(const XT* p, Scale s,
                                           uint32_t (&out)[N / 4]) {
  static_assert(N == 4 || N == 16, "N");
  if constexpr (sizeof(XT) == 1) {
    if constexpr (N == 16) {
      const uint4 v = *reinterpret_cast<const uint4*>(p);
      out[0] = v.x;
      out[1] = v.y;
      out[2] = v.z;
      out[3] = v.w;
    } else {
      out[0] = *reinterpret_cast<const uint32_t*>(p);
    }
  } else {
    float f[N];
    if constexpr (sizeof(XT) == 2) {  // bf16 pairs, 16 or 8 bytes a load
      uint32_t u[N / 2];
      if constexpr (N == 16) {
        const uint4 a = reinterpret_cast<const uint4*>(p)[0];
        const uint4 b = reinterpret_cast<const uint4*>(p)[1];
        u[0] = a.x; u[1] = a.y; u[2] = a.z; u[3] = a.w;
        u[4] = b.x; u[5] = b.y; u[6] = b.z; u[7] = b.w;
      } else {
        const uint2 a = *reinterpret_cast<const uint2*>(p);
        u[0] = a.x;
        u[1] = a.y;
      }
#pragma unroll
      for (int i = 0; i < N / 2; ++i) {
        f[2 * i] = __uint_as_float(u[i] << 16);
        f[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
      }
    } else {  // float32, 16 bytes a load
#pragma unroll
      for (int i = 0; i < N / 4; ++i) {
        const float4 v = reinterpret_cast<const float4*>(p)[i];
        f[4 * i] = v.x;
        f[4 * i + 1] = v.y;
        f[4 * i + 2] = v.z;
        f[4 * i + 3] = v.w;
      }
    }
    quant_n<N>(f, s, out);
  }
}

// 4 channels of x at p as 4 int8 bytes
template <typename XT>
__device__ __forceinline__ uint32_t quant4(const XT* p, Scale s) {
  uint32_t w[1];
  quant_load<4>(p, s, w);
  return w[0];
}

// 16 channels of x at p as 16 int8 bytes
template <typename XT>
__device__ __forceinline__ uint4 quant16(const XT* p, Scale s) {
  uint32_t w[4];
  quant_load<16>(p, s, w);
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// ---------------------------------------------------------------------------
// route "wgmma": TMA-fed s8 wgmma

constexpr int kTH = 16, kTW = 8;      // output tile: rows x columns
constexpr int kWgRows = 8;            // output rows a consumer warpgroup
constexpr int kCB = 64;               // channels a chunk: a 64-byte s8 row
constexpr uint32_t kWAtom = 8 * kCB;  // a weight tile's 64-byte swizzle
// two consumer warpgroups, the quantizer's, the producers' (x, weights,
// stores: one thread each)
constexpr int kWgThreads = 512;
constexpr int kQuantWg = 2, kProducerWg = 3;
constexpr int kASlots = 3;               // s8 A tiles: a chunk a slot
constexpr uint32_t kOutBox = 64 * 128;  // 64 pixels of 128-byte rows
constexpr uint32_t kSmemLimit = 232448;  // a block's opt-in shared memory
constexpr int kMaxSlots = 16;            // weight tiles in flight at most

// The geometry and shared-memory plan of one launch (host-computed; the
// Python wrapper's ops/conv_s8.py:wgmma_plan mirrors the plan).
struct WgGeo {
  int n, h, w, c, cout;    // x's frame (transposed: n = 1, h = N H)
  int k, dil, pt, pl;      // taps k x k (transposed: 1), dilation, padding
  int ho, wo;              // the GEMM's frame (transposed: x's)
  int cp, taps, chunks;    // C padded to 64; k^2; Cp / 64
  int bh, bw, jp;          // x box rows, columns; its pixels, padded (the
                           // s8 A tile's k-chunk step, in 16 bytes)
  int parities, transpose;
  int th, tw, ctiles, tiles;
  int nf, nb;              // x box slots, weight slots
  uint32_t xslot, aslot, bslot, oslot;
  uint32_t xoff, aoff, boff, ooff, baroff, total;
};

struct TileAt {
  int ct, par, img, oy0, ox0;
};

// a position in a ring of n slots: the slot and the parity of its use
struct Ring {
  int slot = 0, phase = 0;
  __device__ __forceinline__ void next(int n) {
    if (++slot == n) {
      slot = 0;
      phase ^= 1;
    }
  }
};

// tile q: channel tile fastest, then parity, then pixel tile (image, tile
// row, tile column)
__device__ __forceinline__ TileAt tile_at(const WgGeo& g, int q) {
  TileAt t;
  t.ct = q % g.ctiles;
  const int r = q / g.ctiles;
  t.par = r % g.parities;
  const int p = r / g.parities;
  t.img = p / (g.th * g.tw);
  t.oy0 = (p / g.tw) % g.th * kTH;
  t.ox0 = p % g.tw * kTW;
  return t;
}

// a warp is done with a slot: one arrival on its barrier
__device__ __forceinline__ void release(uint64_t* empty, int lane) {
  __syncwarp();
  if (lane == 0) mbar_arrive(empty);
}

// The s8 A tile of a chunk: the whole x box quantized once, in wgmma's
// K-major layout without swizzle: 16-byte core rows, k-chunk q (16
// channels) of box pixel p = row bw + column at q jp + p (x 16 bytes).
// Eight consecutive pixels of a box row are a core matrix, so tap (kh, kw)
// of output row r, columns 0..7, is the 8 pixels from (r + kh d, kw d) on:
// its descriptor starts there, the next row (8-row group) bw pixels on
// (SBO), the next k-chunk jp pixels on (LBO). One copy serves all k^2
// taps of both consumer warpgroups.
__device__ __forceinline__ uint64_t a_desc(uint32_t addr, const WgGeo& g) {
  return smem_desc(addr, 16u * g.jp, 16u * g.bw, 0);
}

// a weight tile: K-major, 64-byte rows in the 64-byte swizzle (TMA's)
__device__ __forceinline__ uint64_t b_desc(uint32_t addr) {
  return smem_desc(addr, 16, kWAtom, 2);
}

// acc += A B over one 64-channel chunk of one tap: two k32 steps
template <int BN>
__device__ __forceinline__ void mma_chunk(int (&acc)[BN / 2], uint32_t a,
                                          uint32_t b, const WgGeo& g) {
#pragma unroll
  for (int kk = 0; kk < 2; ++kk) {
    const uint64_t da = a_desc(a + 2 * kk * 16 * g.jp, g);
    if constexpr (BN == 128)
      wgmma_m64n128k32_s8(acc, da, b_desc(b + 32 * kk), 1);
    else
      wgmma_m64n64k32_s8(acc, da, b_desc(b + 32 * kk), 1);
  }
}

// One x box quantized into an s8 A tile at a (a_desc's layout) by the
// quantizer warpgroup; a thread takes 16 channels of a pixel, the four of
// a pixel side by side (jp = 2 mod 8: a quarter-warp's 16-byte stores fall
// in 8 distinct banks)
template <typename XT>
__device__ __forceinline__ void quantize_box(const unsigned char* box,
                                             unsigned char* a,
                                             const WgGeo& g, int tid,
                                             Scale sx) {
  const int pixels = g.bh * g.bw;
  const XT* x = reinterpret_cast<const XT*>(box);
  for (int i = tid; i < 4 * pixels; i += 128) {
    const int p = i >> 2, q = i & 3;
    *reinterpret_cast<uint4*>(a + 16 * (q * g.jp + p)) =
        quant16<XT>(x + p * kCB + 16 * q, sx);
  }
}

// y = float(acc) * (sx * sw) (+ bias) for one warp's 16 accumulator rows,
// channels co0 + 8 i + 2 t + {0, 1}, into the warpgroup's staging area:
// boxes of 128-byte rows (64 bf16 or 32 float32 channels), pixel m a row,
// 16-byte chunks in the 128-byte swizzle (chunk ^ m % 8), which the y map's
// TMA stores read.
template <int BN, bool BF16>
__device__ __forceinline__ void stage_out(const int (&acc)[BN / 2],
                                          unsigned char* out, float sx,
                                          const float* __restrict__ sw,
                                          const float* __restrict__ bias,
                                          int co0, int cout, int warp,
                                          int lane) {
  const int g = lane / 4, t = lane % 4;
  // float(acc) exactly: below 2^22 in magnitude as the bits of 1.5 * 2^23
  // + acc less 1.5 * 2^23 (two full-rate adds), else __int2float_rn (a
  // quarter-rate conversion) for the thread's every sum
  bool big = false;
#pragma unroll
  for (int i = 0; i < BN / 2; ++i)
    big |= acc[i] >= (1 << 22) || acc[i] <= -(1 << 22);
  const auto to_float = [big](int a) {
    return big ? __int2float_rn(a)
               : __fsub_rn(__int_as_float(a + 0x4B400000), 12582912.f);
  };
#pragma unroll
  for (int i = 0; i < BN / 8; ++i) {
    const int c0 = min(co0 + 8 * i + 2 * t, cout - 1);
    const int c1 = min(co0 + 8 * i + 2 * t + 1, cout - 1);
    const float s0 = __fmul_rn(sx, sw[c0]), s1 = __fmul_rn(sx, sw[c1]);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int m = 16 * warp + g + 8 * half;
      float v0 = __fmul_rn(to_float(acc[4 * i + 2 * half]), s0);
      float v1 = __fmul_rn(to_float(acc[4 * i + 2 * half + 1]), s1);
      if (bias != nullptr) {
        v0 = __fadd_rn(v0, bias[c0]);
        v1 = __fadd_rn(v1, bias[c1]);
      }
      if constexpr (BF16) {
        *reinterpret_cast<uint32_t*>(out + (i / 8) * kOutBox + m * 128 +
                                     (((i % 8) ^ (m & 7)) << 4) + 4 * t) =
            pack_bf16(v0, v1);
      } else {
        *reinterpret_cast<float2*>(
            out + (i / 4) * kOutBox + m * 128 +
            (((2 * (i % 4) + t / 2) ^ (m & 7)) << 4) + 8 * (t & 1)) =
            make_float2(v0, v1);
      }
    }
  }
}

template <typename XT, int BN, bool BF16>
__global__ void __launch_bounds__(kWgThreads, 1)
conv_s8_wgmma_kernel(const __grid_constant__ CUtensorMap x_map,
                     const __grid_constant__ CUtensorMap w_map,
                     const __grid_constant__ CUtensorMap y_map,
                     const float* __restrict__ sx_p,
                     const float* __restrict__ sw,
                     const float* __restrict__ bias, const WgGeo g) {
  constexpr int kBoxC = BF16 ? 64 : 32;  // output channels a staged box
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  uint64_t* xfull = reinterpret_cast<uint64_t*>(smem + g.baroff);
  uint64_t* xempty = xfull + g.nf;
  uint64_t* afull = xempty + g.nf;
  uint64_t* aempty = afull + kASlots;
  uint64_t* bfull = aempty + kASlots;
  uint64_t* bempty = bfull + g.nb;
  uint64_t* stored = bempty + g.nb;  // a warpgroup's output is staged
  uint64_t* drained = stored + 2;    // the TMA stores have read it
  const int wgi = threadIdx.x / 128, tid = threadIdx.x % 128;
  const int warp = tid / 32, lane = tid % 32;

  if (threadIdx.x == 0) {
    for (int i = 0; i < g.nf; ++i) {
      mbar_init(xfull + i, 1);
      mbar_init(xempty + i, 4);  // one arrival a quantizer warp
    }
    for (int i = 0; i < kASlots; ++i) {
      mbar_init(afull + i, 4);
      mbar_init(aempty + i, 8);  // one arrival a consumer warp
    }
    for (int i = 0; i < g.nb; ++i) {
      mbar_init(bfull + i, 1);
      mbar_init(bempty + i, 8);
    }
    for (int w = 0; w < 2; ++w) {
      mbar_init(stored + w, 4);
      mbar_init(drained + w, 1);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wgi == kProducerWg) {  // loads of x and of weights, and stores
    if (tid == 0) {  // x boxes, each as soon as its slot is free
      const uint32_t xbytes = g.bh * g.bw * kCB * sizeof(XT);
      Ring r;
      for (int q = blockIdx.x; q < g.tiles; q += gridDim.x) {
        const TileAt t = tile_at(g, q);
        for (int ch = 0; ch < g.chunks; ++ch, r.next(g.nf)) {
          mbar_wait(xempty + r.slot, r.phase ^ 1);
          mbar_expect_tx(xfull + r.slot, xbytes);
          tma_load(smem + g.xoff + r.slot * g.xslot, &x_map, xfull + r.slot,
                   ch * kCB, t.ox0 - g.pl, t.oy0 - g.pt, t.img);
        }
      }
    } else if (tid == 32) {  // weight tiles, likewise
      Ring r;
      for (int q = blockIdx.x; q < g.tiles; q += gridDim.x) {
        const TileAt t = tile_at(g, q);
        for (int ch = 0; ch < g.chunks; ++ch) {
          for (int tap = 0; tap < g.taps; ++tap, r.next(g.nb)) {
            mbar_wait(bempty + r.slot, r.phase ^ 1);
            mbar_expect_tx(bfull + r.slot, g.bslot);
            tma_load(smem + g.boff + r.slot * g.bslot, &w_map,
                     bfull + r.slot, tap * g.cp + ch * kCB, t.ct * BN,
                     t.par);
          }
        }
      }
    } else if (tid == 64) {
      // the storer: each warpgroup's staged output to y, then handed back
      int k = 0;
      for (int q = blockIdx.x; q < g.tiles; q += gridDim.x, ++k) {
        const TileAt t = tile_at(g, q);
        for (int w = 0; w < 2; ++w) {
          mbar_wait(stored + w, k & 1);
          const unsigned char* out = smem + g.ooff + w * g.oslot;
          for (int b = 0; b * kBoxC < BN; ++b) {
            const int co = t.ct * BN + b * kBoxC;
            if (co >= g.cout) break;
            if (g.transpose)
              tma_store(&y_map, out + b * kOutBox, co, t.par & 1, t.ox0,
                        t.par >> 1, t.oy0 + kWgRows * w);
            else
              tma_store(&y_map, out + b * kOutBox, co, t.ox0,
                        t.oy0 + kWgRows * w, t.img);
          }
          bulk_commit();
          bulk_wait<true>();
          mbar_arrive(drained + w);
        }
      }
      bulk_wait<false>();
    }
  } else if (wgi == kQuantWg) {
    // the quantizer: each chunk's x box into a free s8 A tile, read once
    const Scale sx = make_scale(sx_p);
    Ring xr, ar;
    for (int q = blockIdx.x; q < g.tiles; q += gridDim.x) {
      for (int ch = 0; ch < g.chunks; ++ch, xr.next(g.nf), ar.next(kASlots)) {
        mbar_wait(aempty + ar.slot, ar.phase ^ 1);
        mbar_wait(xfull + xr.slot, xr.phase);
        quantize_box<XT>(smem + g.xoff + xr.slot * g.xslot,
                         smem + g.aoff + ar.slot * g.aslot, g, tid, sx);
        fence_proxy_async();  // the s8 tile, visible to wgmma
        release(xempty + xr.slot, lane);
        release(afull + ar.slot, lane);
      }
    }
  } else {  // a consumer: output rows 8 wgi .. 8 wgi + 7 of each tile
    const int w = wgi;
    const float sx = *sx_p;
    int acc[BN / 2];
    // A tiles taken and released, weight slots taken and released: a
    // group a tap with only the last one left running (as fast as up to
    // six on the card, and weight slots free sooner), so a tap's weight
    // slot is free once the next tap's group is issued, and the last
    // chunk's A tile once a chunk's taps are
    Ring ar, arel, br, brel;
    int k = 0;
    for (int q = blockIdx.x; q < g.tiles; q += gridDim.x, ++k) {
      const TileAt t = tile_at(g, q);
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
      bool first = true;
      for (int ch = 0; ch < g.chunks; ++ch, ar.next(kASlots)) {
        mbar_wait(afull + ar.slot, ar.phase);
        const uint32_t a0 = smem_addr(smem + g.aoff + ar.slot * g.aslot) +
                            16 * kWgRows * w * g.bw;
        for (int kh = 0; kh < g.k; ++kh) {
          for (int kw = 0; kw < g.k; ++kw, br.next(g.nb)) {
            mbar_wait(bfull + br.slot, br.phase);
            fence_acc(acc);
            wgmma_fence();
            mma_chunk<BN>(acc, a0 + 16 * g.dil * (kh * g.bw + kw),
                          smem_addr(smem + g.boff + br.slot * g.bslot), g);
            wgmma_commit();
            wgmma_wait<1>();
            fence_acc(acc);
            if (first) {
              first = false;
            } else {
              release(bempty + brel.slot, lane);
              brel.next(g.nb);
            }
          }
        }
        if (ch > 0) {  // the last chunk's products are done
          release(aempty + arel.slot, lane);
          arel.next(kASlots);
        }
      }
      wgmma_wait<0>();
      fence_acc(acc);
      release(bempty + brel.slot, lane);
      brel.next(g.nb);
      release(aempty + arel.slot, lane);
      arel.next(kASlots);
      // the staging area is free once the storer has read the last tile's
      if (k > 0) mbar_wait(drained + w, (k - 1) & 1);
      stage_out<BN, BF16>(acc, smem + g.ooff + w * g.oslot, sx, sw, bias,
                          t.ct * BN, g.cout, warp, lane);
      fence_proxy_async();
      __syncwarp();
      if (lane == 0) mbar_arrive(stored + w);
    }
  }
}

inline uint32_t round_1024(uint32_t b) { return (b + 1023) / 1024 * 1024; }

// The shared-memory plan: three s8 A slots, two staging areas, three x
// slots where 8 weight slots still fit beside them, else two (one where
// two do not fit), and as many weight slots (3..kMaxSlots) as fit.
// Returns false where no plan fits (the geometry takes route "mma").
inline bool plan(WgGeo& g, int xbytes, int bn, int obytes) {
  g.bh = kTH + (g.k - 1) * g.dil;
  g.bw = kTW + (g.k - 1) * g.dil;
  // pixels padded to 2 mod 8 (quantize_box's stores)
  g.jp = g.bh * g.bw + ((10 - g.bh * g.bw % 8) % 8);
  if (g.bh > 256 || g.bw > 256) return false;
  g.xslot = round_1024((uint32_t)g.bh * g.bw * kCB * xbytes);
  g.aslot = round_1024(4u * 16 * g.jp);
  g.bslot = bn * kCB;
  g.oslot = 64u * bn * obytes;
  const uint32_t fixed = kASlots * g.aslot + 2 * g.oslot + 1024 + 1024;
  for (int nf = 3; nf >= 1; --nf) {
    const uint32_t used = fixed + nf * g.xslot;
    if (used > kSmemLimit) continue;
    const uint32_t fit = (kSmemLimit - used) / g.bslot;
    const int nb = fit < (uint32_t)kMaxSlots ? (int)fit : kMaxSlots;
    if (nb < (nf == 3 ? 8 : 3)) continue;
    g.nf = nf;
    g.nb = nb;
    g.xoff = 0;
    g.aoff = nf * g.xslot;
    g.boff = g.aoff + kASlots * g.aslot;
    g.ooff = g.boff + nb * g.bslot;
    g.baroff = g.ooff + 2 * g.oslot;
    g.total = g.baroff + 1024 + 1024;  // barriers, alignment slack
    return true;
  }
  return false;
}

template <typename XT>
constexpr CUtensorMapDataType tma_type() {
  return sizeof(XT) == 1   ? CU_TENSOR_MAP_DATA_TYPE_UINT8
         : sizeof(XT) == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                           : CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
}

template <typename XT, int BN, bool BF16>
cudaError_t launch_wgmma(const void* x, const void* wp, const float* sx,
                         const float* sw, const float* bias, void* y,
                         WgGeo g, int sms, cudaStream_t stream) {
  constexpr int ob = BF16 ? 2 : 4;
  if (!plan(g, sizeof(XT), BN, ob)) return cudaErrorInvalidConfiguration;
  g.th = (g.ho + kTH - 1) / kTH;
  g.tw = (g.wo + kTW - 1) / kTW;
  g.ctiles = (g.cout + BN - 1) / BN;
  const long long tiles =
      (long long)g.n * g.th * g.tw * g.parities * g.ctiles;
  if (tiles >= (1ll << 31)) return cudaErrorInvalidConfiguration;
  g.tiles = (int)tiles;
  cudaError_t err;
  CUtensorMap xm, wm, ym;
  {
    const cuuint64_t xs = sizeof(XT);
    const cuuint64_t dims[4] = {(cuuint64_t)g.c, (cuuint64_t)g.w,
                                (cuuint64_t)g.h, (cuuint64_t)g.n};
    const cuuint64_t strides[3] = {xs * g.c, xs * g.c * g.w,
                                   xs * g.c * g.w * g.h};
    const cuuint32_t box[4] = {kCB, (cuuint32_t)g.bw, (cuuint32_t)g.bh, 1};
    if ((err = encode(&xm, tma_type<XT>(), 4, x, dims, strides, box,
                      CU_TENSOR_MAP_SWIZZLE_NONE)))
      return err;
  }
  {
    const cuuint64_t kp = (cuuint64_t)g.taps * g.cp;
    const cuuint64_t dims[3] = {kp, (cuuint64_t)g.cout,
                                (cuuint64_t)g.parities};
    const cuuint64_t strides[2] = {kp, kp * g.cout};
    const cuuint32_t box[3] = {kCB, BN, 1};
    if ((err = encode(&wm, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, wp, dims,
                      strides, box, CU_TENSOR_MAP_SWIZZLE_64B)))
      return err;
  }
  {
    const CUtensorMapDataType yt = BF16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                        : CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
    const cuuint64_t co = (cuuint64_t)g.cout * ob;
    const cuuint32_t boxc = 128 / ob;
    if (g.transpose) {  // (Cout, rx, W, ry, N H) over y (N, 2H, 2W, Cout)
      const cuuint64_t dims[5] = {(cuuint64_t)g.cout, 2, (cuuint64_t)g.w, 2,
                                  (cuuint64_t)g.h};
      const cuuint64_t strides[4] = {co, 2 * co, 2 * co * g.w,
                                     4 * co * g.w};
      const cuuint32_t box[5] = {boxc, 1, kTW, 1, kWgRows};
      err = encode(&ym, yt, 5, y, dims, strides, box,
                   CU_TENSOR_MAP_SWIZZLE_128B);
    } else {
      const cuuint64_t dims[4] = {(cuuint64_t)g.cout, (cuuint64_t)g.wo,
                                  (cuuint64_t)g.ho, (cuuint64_t)g.n};
      const cuuint64_t strides[3] = {co, co * g.wo, co * g.wo * g.ho};
      const cuuint32_t box[4] = {boxc, kTW, kWgRows, 1};
      err = encode(&ym, yt, 4, y, dims, strides, box,
                   CU_TENSOR_MAP_SWIZZLE_128B);
    }
    if (err) return err;
  }
  const auto kernel = conv_s8_wgmma_kernel<XT, BN, BF16>;
  static std::atomic<uint64_t> smem_set{0};
  if ((err = set_smem_once(kernel, kSmemLimit, smem_set))) return err;
  const int grid = g.tiles < sms ? g.tiles : sms;
  kernel<<<grid, kWgThreads, g.total, stream>>>(xm, wm, ym, sx, sw, bias, g);
  return cudaGetLastError();
}

template <typename XT>
cudaError_t dispatch_wgmma(const void* x, const void* wp, const float* sx,
                           const float* sw, const float* bias, void* y,
                           const WgGeo& g, int bf16, int sms,
                           cudaStream_t st) {
  if (g.cout <= 64)
    return bf16 ? launch_wgmma<XT, 64, true>(x, wp, sx, sw, bias, y, g, sms,
                                             st)
                : launch_wgmma<XT, 64, false>(x, wp, sx, sw, bias, y, g, sms,
                                              st);
  return bf16 ? launch_wgmma<XT, 128, true>(x, wp, sx, sw, bias, y, g, sms,
                                            st)
              : launch_wgmma<XT, 128, false>(x, wp, sx, sw, bias, y, g, sms,
                                             st);
}

// ---------------------------------------------------------------------------
// route "mma": the first design's mma.sync kernel, quantizing as it loads

constexpr int kBM = 64;        // output pixels a block
constexpr int kBN = 64;        // output channels a block
constexpr int kBK = 32;        // k (bytes) a step
constexpr int kRowWords = 12;  // shared row stride in 32-bit words (48 B)
constexpr int kThreads = 128;

struct Geometry {
  int n, h, w, c;        // input, NHWC, c % 4 == 0
  int cout, kh, kw;      // weights
  int stride, dil, pt, pl;
  int ho, wo;            // output frame
  int kp;                // packed K (multiple of 32)
  int transpose;         // 1: the k = 2, s = 2 VALID transposed conv
};

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The 16 bytes of A at row (pixel) [n, oy, ox] and k in [k, k + 16),
// quantized: one 16-channel piece when C % 16 == 0 (one tap), else four
// 4-channel words, each its own tap.
template <typename XT, bool VEC>
__device__ __forceinline__ uint4 load_a(const XT* __restrict__ x,
                                        const Geometry& g, bool row_ok,
                                        int n, int iy0, int ix0, int k,
                                        Scale sx) {
  uint4 v = make_uint4(0, 0, 0, 0);
  if (!row_ok) return v;
  const int taps = g.kh * g.kw;
  if constexpr (VEC) {
    const int tap = k / g.c;
    if (tap >= taps) return v;
    const int ci = k - tap * g.c;
    const int iy = iy0 + (tap / g.kw) * g.dil;
    const int ix = ix0 + (tap % g.kw) * g.dil;
    if (iy < 0 || iy >= g.h || ix < 0 || ix >= g.w) return v;
    const long long off =
        (((long long)n * g.h + iy) * g.w + ix) * g.c + ci;
    return quant16<XT>(x + off, sx);
  } else {
    uint32_t wds[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int kk = k + 4 * j;
      const int tap = kk / g.c;
      wds[j] = 0;
      if (tap >= taps) continue;
      const int ci = kk - tap * g.c;
      const int iy = iy0 + (tap / g.kw) * g.dil;
      const int ix = ix0 + (tap % g.kw) * g.dil;
      if (iy < 0 || iy >= g.h || ix < 0 || ix >= g.w) continue;
      const long long off =
          (((long long)n * g.h + iy) * g.w + ix) * g.c + ci;
      wds[j] = quant4<XT>(x + off, sx);
    }
    v.x = wds[0]; v.y = wds[1]; v.z = wds[2]; v.w = wds[3];
    return v;
  }
}

template <typename XT, bool VEC, bool BF16>
__global__ void __launch_bounds__(kThreads)
conv_s8_kernel(const XT* __restrict__ x, const int8_t* __restrict__ wp,
               const float* __restrict__ sx_p, const float* __restrict__ sw,
               const float* __restrict__ bias, void* __restrict__ y,
               Geometry g) {
  __shared__ __align__(16) uint32_t As[kBM * kRowWords];
  __shared__ __align__(16) uint32_t Bs[kBN * kRowWords];

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int parity = blockIdx.z;  // transposed conv: (ry, rx)
  const Scale scale = make_scale(sx_p);
  const float sx = scale.sx;
  // rows of the GEMM: output pixels, or input pixels of one parity
  const int rh = g.transpose ? g.h : g.ho;
  const int rw = g.transpose ? g.w : g.wo;
  const long long m_total = (long long)g.n * rh * rw;
  const long long m0 = (long long)blockIdx.x * kBM;
  const int co0 = blockIdx.y * kBN;
  const int8_t* wb = wp + (long long)parity * g.cout * g.kp;

  // each thread stages row tid / 2 of both tiles, bytes 16 * (tid % 2)
  const int srow = tid >> 1, shalf = tid & 1;
  const long long m = m0 + srow;
  const bool row_ok = m < m_total;
  int n = 0, iy0 = 0, ix0 = 0;
  if (row_ok) {
    n = (int)(m / ((long long)rh * rw));
    const int rem = (int)(m - (long long)n * rh * rw);
    const int oy = rem / rw, ox = rem - (rem / rw) * rw;
    if (g.transpose) {
      iy0 = oy;
      ix0 = ox;
    } else {
      iy0 = oy * g.stride - g.pt;
      ix0 = ox * g.stride - g.pl;
    }
  }
  const int co_s = co0 + srow;
  const bool co_ok = co_s < g.cout;
  const int8_t* brow = wb + (long long)(co_ok ? co_s : 0) * g.kp;
  // the transposed conv's one tap: its weights are packed per parity
  Geometry ga = g;
  if (g.transpose) {
    ga.kh = ga.kw = 1;
    ga.stride = 1;
    ga.dil = 1;
  }

  int acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0;

  const int nk = g.kp / kBK;
  uint4 ra =
      load_a<XT, VEC>(x, ga, row_ok, n, iy0, ix0, 16 * shalf, scale);
  uint4 rb = co_ok ? *reinterpret_cast<const uint4*>(brow + 16 * shalf)
                   : make_uint4(0, 0, 0, 0);
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
  for (int kt = 0; kt < nk; ++kt) {
    *reinterpret_cast<uint4*>(&As[srow * kRowWords + 4 * shalf]) = ra;
    *reinterpret_cast<uint4*>(&Bs[srow * kRowWords + 4 * shalf]) = rb;
    __syncthreads();
    if (kt + 1 < nk) {  // the next step's pieces, in flight during the mma
      const int k = (kt + 1) * kBK + 16 * shalf;
      ra = load_a<XT, VEC>(x, ga, row_ok, n, iy0, ix0, k, scale);
      rb = co_ok ? *reinterpret_cast<const uint4*>(brow + k)
                 : make_uint4(0, 0, 0, 0);
    }
    uint32_t af[2][4], bf[4][2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r0 = (wm + 16 * i + gid) * kRowWords;
      const int r1 = r0 + 8 * kRowWords;
      af[i][0] = As[r0 + tig];
      af[i][1] = As[r1 + tig];
      af[i][2] = As[r0 + tig + 4];
      af[i][3] = As[r1 + tig + 4];
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = (wn + 8 * j + gid) * kRowWords;
      bf[j][0] = Bs[r + tig];
      bf[j][1] = Bs[r + tig + 4];
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) mma_s8(acc[i][j], af[i], bf[j]);
    __syncthreads();
  }

  // epilogue: (float(acc) * (sx * sw[co])) (+ bias[co]), JAX's rounding
  const int ry = parity >> 1, rx = parity & 1;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const long long mm = m0 + wm + 16 * i + gid + 8 * half;
      if (mm >= m_total) continue;
      long long out_pix = mm;
      if (g.transpose) {
        const int nn = (int)(mm / ((long long)rh * rw));
        const int rem = (int)(mm - (long long)nn * rh * rw);
        const int iy = rem / rw, ix = rem - (rem / rw) * rw;
        out_pix = ((long long)nn * g.ho + 2 * iy + ry) * g.wo + 2 * ix + rx;
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int co = co0 + wn + 8 * j + 2 * tig + e;
          if (co >= g.cout) continue;
          float v = __fmul_rn(__int2float_rn(acc[i][j][2 * half + e]),
                              __fmul_rn(sx, sw[co]));
          if (bias != nullptr) v = __fadd_rn(v, bias[co]);
          const long long o = out_pix * g.cout + co;
          if (BF16)
            static_cast<__nv_bfloat16*>(y)[o] = __float2bfloat16_rn(v);
          else
            static_cast<float*>(y)[o] = v;
        }
      }
    }
  }
}

template <typename XT, bool VEC, bool BF16>
cudaError_t launch_mma(const void* x, const int8_t* wp, const float* sx,
                       const float* sw, const float* bias, void* y,
                       const Geometry& g, cudaStream_t st) {
  const long long rows = (long long)g.n * (g.transpose ? g.h * g.w
                                                       : g.ho * g.wo);
  const long long bx = (rows + kBM - 1) / kBM;
  if (bx > 0x7fffffffll) return cudaErrorInvalidConfiguration;
  dim3 grid((unsigned)bx, (g.cout + kBN - 1) / kBN, g.transpose ? 4 : 1);
  conv_s8_kernel<XT, VEC, BF16><<<grid, kThreads, 0, st>>>(
      static_cast<const XT*>(x), wp, sx, sw, bias, y, g);
  return cudaGetLastError();
}

template <typename XT>
cudaError_t dispatch_mma(const void* x, const int8_t* wp, const float* sx,
                         const float* sw, const float* bias, void* y,
                         const Geometry& g, int bf16, cudaStream_t st) {
  if (g.c % 16 == 0)
    return bf16 ? launch_mma<XT, true, true>(x, wp, sx, sw, bias, y, g, st)
                : launch_mma<XT, true, false>(x, wp, sx, sw, bias, y, g, st);
  return bf16 ? launch_mma<XT, false, true>(x, wp, sx, sw, bias, y, g, st)
              : launch_mma<XT, false, false>(x, wp, sx, sw, bias, y, g, st);
}

}  // namespace

// Route "mma". x: (n, h, w, c) NHWC, c % 4 == 0, int8 (xtype 0) or bf16
// (1) or float32 (2), quantized by sx as it is loaded; wp: int8 (taps,
// cout, kp) packed by ops/conv_s8.py (taps = 4 for the transposed conv,
// else 1); sx: float32 (); sw, bias: float32 (cout,), bias may be NULL; y:
// (n, ho, wo, cout) float32 or, with bf16 = 1, bfloat16.
extern "C" int ddti_conv_s8(const void* x, const void* wp, const void* sx,
                            const void* sw, const void* bias, void* y, int n,
                            int h, int w, int c, int cout, int kh, int kw,
                            int stride, int dil, int pt, int pl, int ho,
                            int wo, int kp, int transpose, int xtype,
                            int bf16, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n <= 0 || c <= 0 || c % 4 || cout <= 0 || kp % kBK ||
      xtype < 0 || xtype > 2 ||
      (long long)(transpose ? 1 : kh * kw) * c > kp ||
      (transpose && (kh != 2 || kw != 2 || stride != 2)))
    return (int)cudaErrorInvalidValue;
  Geometry g{n, h, w, c, cout, kh, kw, stride, dil, pt, pl, ho, wo, kp,
             transpose};
  const int8_t* wi = static_cast<const int8_t*>(wp);
  const float* sxf = static_cast<const float*>(sx);
  const float* swf = static_cast<const float*>(sw);
  const float* bf = static_cast<const float*>(bias);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (xtype == 0)
    return (int)dispatch_mma<int8_t>(x, wi, sxf, swf, bf, y, g, bf16, st);
  if (xtype == 1)
    return (int)dispatch_mma<__nv_bfloat16>(x, wi, sxf, swf, bf, y, g, bf16,
                                            st);
  return (int)dispatch_mma<float>(x, wi, sxf, swf, bf, y, g, bf16, st);
}

// Route "wgmma". x: (n, h, w, c) NHWC, c % 16 == 0, int8 (xtype 0), bf16
// (1) or float32 (2), 16-byte aligned; wp: int8 (parities, cout, k^2 cp)
// packed by ops/conv_s8.py, cp = c rounded up to 64 (parities = 4 for the
// transposed conv, k = 2, s = 2, whose k here is 1; else 1); y: (n, ho, wo,
// cout) float32 or bf16, cout of whole 16-byte rows, 16-byte aligned. A
// stride-1 conv of k x k taps, dilation dil, padding (pt, pl), or the
// transposed conv (transpose = 1: ho = 2 h, wo = 2 w). Refuses
// (cudaErrorInvalidConfiguration) a geometry whose shared-memory plan does
// not fit.
extern "C" int ddti_conv_s8_wgmma(const void* x, const void* wp,
                                  const void* sx, const void* sw,
                                  const void* bias, void* y, int n, int h,
                                  int w, int c, int cout, int k, int dil,
                                  int pt, int pl, int ho, int wo, int cp,
                                  int transpose, int xtype, int bf16,
                                  int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int ob = bf16 ? 2 : 4;
  if (n <= 0 || h <= 0 || w <= 0 || c <= 0 || c % 16 || cout <= 0 ||
      (cout * ob) % 16 || cp % kCB || cp < c || k <= 0 || dil <= 0 ||
      xtype < 0 || xtype > 2 || (transpose && (k != 1 || dil != 1)) ||
      (reinterpret_cast<uintptr_t>(x) & 15) ||
      (reinterpret_cast<uintptr_t>(wp) & 15) ||
      (reinterpret_cast<uintptr_t>(y) & 15))
    return (int)cudaErrorInvalidValue;
  int sms;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    device)))
    return (int)err;
  WgGeo g{};
  g.n = n; g.h = h; g.w = w; g.c = c; g.cout = cout;
  g.k = k; g.dil = dil; g.pt = pt; g.pl = pl; g.ho = ho; g.wo = wo;
  g.cp = cp; g.taps = k * k; g.chunks = cp / kCB;
  g.parities = 1; g.transpose = transpose;
  if (transpose) {  // one GEMM a parity over x's pixels, rows merged
    g.h = n * h; g.n = 1; g.ho = g.h; g.wo = w; g.pt = g.pl = 0;
    g.parities = 4;
  }
  const float* sxf = static_cast<const float*>(sx);
  const float* swf = static_cast<const float*>(sw);
  const float* bf = static_cast<const float*>(bias);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (xtype == 0)
    return (int)dispatch_wgmma<int8_t>(x, wp, sxf, swf, bf, y, g, bf16, sms,
                                       st);
  if (xtype == 1)
    return (int)dispatch_wgmma<__nv_bfloat16>(x, wp, sxf, swf, bf, y, g,
                                              bf16, sms, st);
  return (int)dispatch_wgmma<float>(x, wp, sxf, swf, bf, y, g, bf16, sms, st);
}

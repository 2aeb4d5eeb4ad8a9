// The int8 convolution of the int8 serving graph, for Hopper (sm_90a),
// plain C interface for ctypes.
//
// Replaces no Pallas kernel. The JAX package's int8 serving graph runs every
// quantized conv as XLA's s8 x s8 -> s32 convolution
// (ddti_tpu/train/quantize.py:_quant_interceptor, lax.conv_general_dilated /
// lax.conv_transpose with preferred_element_type=int32); PyTorch offers no
// int8 convolution on CUDA, so the port writes its own. It computes
//
//   acc[m, co] = sum_k A[m, k] * B[k, co]      exact int32
//   y[m, co]   = float(acc) * (sx * sw[co]) (+ bias[co])   -> f32 or bf16
//
// as an implicit GEMM over NHWC int8 activations: m is an output pixel (n,
// oy, ox), k = (kh * KW + kw) * C + ci a tap and an input channel, A[m, k] =
// x[n, oy*s - pt + kh*d, ox*s - pl + kw*d, ci] (zero outside the frame, so
// any SAME, VALID or asymmetric padding is the bounds check), B the weights
// packed by the wrapper as (Cout, Kp), k contiguous, Kp = K rounded up to 32
// with zeros. The epilogue rounds as JAX's graph does, in its order: sx *
// sw first, then the product, then the bias, each correctly rounded
// (__fmul_rn / __fadd_rn, so no FMA contracts them), then the cast.
//
// The transposed conv of the decoders (k = 2, s = 2, VALID, flax's
// kernel orientation) gives each output pixel exactly one tap, chosen by
// its parity: y[2a + r] = x[a] * w[1 - r] on each axis. It runs as four
// GEMMs, one per parity (blockIdx.z), over the input pixels with K = C; the
// wrapper packs the four taps' weights one after the other.
//
// Design (a first, simple kernel): a block of 4 warps computes a 64 x 64
// tile of (pixels, output channels) with mma.sync.m16n8k32 s8 x s8 -> s32,
// each warp 32 x 32 (2 x 4 instructions a k-step of 32). A and B tiles of
// 64 x 32 bytes sit in shared memory with rows of 48 bytes (12 words: the
// fragment reads of a warp hit 32 distinct banks); each thread stages one
// 16-byte piece of each tile a step and prefetches the next step's pieces
// into registers while the tensor cores run the current one. A piece of A
// lies in one tap when C % 16 == 0 and is one 16-byte load; otherwise (C =
// 4, 8, 12: the first conv's one channel padded to 4) four 4-byte words,
// each with its own tap. What bounds it: at the flagship's first-level 3x3
// conv (16 x 512^2 x 64 -> 64, bf16 out) the bytes (x read once, y written
// once at 3.35 TB/s: 0.240 ms) exceed the operations (2 * M * Cout * 9 * C
// at 1,979 TOP/s: 0.156 ms); at its deeper levels the operations lead.
// This kernel takes 6-10x that bound at every level, limited by issue and
// latency; wgmma, TMA and a deeper ring are later work. The weights are
// packed once per table (ops/conv_s8.py:packed_weights), not per call.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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

// The 16 bytes of A at row (pixel) [n, oy, ox] and k in [k, k + 16): a 16-
// byte load when C % 16 == 0 (one tap), else four words, each its own tap.
template <bool VEC>
__device__ __forceinline__ uint4 load_a(const int8_t* __restrict__ x,
                                        const Geometry& g, bool row_ok,
                                        int n, int iy0, int ix0, int k) {
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
    return *reinterpret_cast<const uint4*>(x + off);
  }
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
    wds[j] = *reinterpret_cast<const uint32_t*>(x + off);
  }
  v.x = wds[0]; v.y = wds[1]; v.z = wds[2]; v.w = wds[3];
  return v;
}

template <bool VEC, bool BF16>
__global__ void __launch_bounds__(kThreads)
conv_s8_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ wp,
               const float* __restrict__ sx_p, const float* __restrict__ sw,
               const float* __restrict__ bias, void* __restrict__ y,
               Geometry g) {
  __shared__ __align__(16) uint32_t As[kBM * kRowWords];
  __shared__ __align__(16) uint32_t Bs[kBN * kRowWords];

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int parity = blockIdx.z;  // transposed conv: (ry, rx)
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
  uint4 ra = load_a<VEC>(x, ga, row_ok, n, iy0, ix0, 16 * shalf);
  uint4 rb = co_ok ? *reinterpret_cast<const uint4*>(brow + 16 * shalf)
                   : make_uint4(0, 0, 0, 0);
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
  for (int kt = 0; kt < nk; ++kt) {
    *reinterpret_cast<uint4*>(&As[srow * kRowWords + 4 * shalf]) = ra;
    *reinterpret_cast<uint4*>(&Bs[srow * kRowWords + 4 * shalf]) = rb;
    __syncthreads();
    if (kt + 1 < nk) {  // the next step's pieces, in flight during the mma
      const int k = (kt + 1) * kBK + 16 * shalf;
      ra = load_a<VEC>(x, ga, row_ok, n, iy0, ix0, k);
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
  const float sx = *sx_p;
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

template <bool VEC, bool BF16>
cudaError_t launch(const int8_t* x, const int8_t* wp, const float* sx,
                   const float* sw, const float* bias, void* y,
                   const Geometry& g, cudaStream_t st) {
  const long long rows = (long long)g.n * (g.transpose ? g.h * g.w
                                                       : g.ho * g.wo);
  const long long bx = (rows + kBM - 1) / kBM;
  if (bx > 0x7fffffffll) return cudaErrorInvalidConfiguration;
  dim3 grid((unsigned)bx, (g.cout + kBN - 1) / kBN, g.transpose ? 4 : 1);
  conv_s8_kernel<VEC, BF16><<<grid, kThreads, 0, st>>>(x, wp, sx, sw, bias,
                                                       y, g);
  return cudaGetLastError();
}

}  // namespace

// x: int8 (n, h, w, c) with c % 4 == 0; wp: int8 (taps, cout, kp) packed by
// ops/conv_s8.py (taps = 4 for the transposed conv, else 1); sx: float32
// (); sw, bias: float32 (cout,), bias may be NULL; y: (n, ho, wo, cout)
// float32 or, with bf16 = 1, bfloat16.
extern "C" int ddti_conv_s8(const void* x, const void* wp, const void* sx,
                            const void* sw, const void* bias, void* y, int n,
                            int h, int w, int c, int cout, int kh, int kw,
                            int stride, int dil, int pt, int pl, int ho,
                            int wo, int kp, int transpose, int bf16,
                            int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n <= 0 || c <= 0 || c % 4 || cout <= 0 || kp % kBK ||
      (long long)(transpose ? 1 : kh * kw) * c > kp ||
      (transpose && (kh != 2 || kw != 2 || stride != 2)))
    return (int)cudaErrorInvalidValue;
  Geometry g{n, h, w, c, cout, kh, kw, stride, dil, pt, pl, ho, wo, kp,
             transpose};
  const int8_t* xi = static_cast<const int8_t*>(x);
  const int8_t* wi = static_cast<const int8_t*>(wp);
  const float* sxf = static_cast<const float*>(sx);
  const float* swf = static_cast<const float*>(sw);
  const float* bf = static_cast<const float*>(bias);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool vec = c % 16 == 0;
  if (vec)
    return (int)(bf16 ? launch<true, true>(xi, wi, sxf, swf, bf, y, g, st)
                      : launch<true, false>(xi, wi, sxf, swf, bf, y, g, st));
  return (int)(bf16 ? launch<false, true>(xi, wi, sxf, swf, bf, y, g, st)
                    : launch<false, false>(xi, wi, sxf, swf, bf, y, g, st));
}

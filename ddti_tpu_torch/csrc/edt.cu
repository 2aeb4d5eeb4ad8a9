// Exact Euclidean distance transform of a batch of binary masks, for Hopper
// (sm_90a). Replaces the TPU kernel ddti_tpu/ops/edt.py:_minplus_kernel
// (the min-plus row pass, called through _minplus_pallas) and the XLA
// column pass beside it (_column_pass).
//
// For every image n and pixel (i, j) whose mask value is nonzero:
//     out[n, i, j] = distance to the nearest zero pixel of image n,
// capped at h + w when image n has no zero at all (scipy's
// distance_transform_edt semantics, as in the JAX package).
//
// Two kernels, one launch each, in place in the float32 output buffer:
//   1. column pass: g[i, j], the distance from (i, j) to the nearest zero
//      in column j (h + w where the column has none), written as uint16 in
//      the first 2w bytes of row i's 4w bytes of `out`;
//   2. row pass: D^2[i, j] = min_k g[i, k]^2 + (j - k)^2 by the lower
//      envelope of the parabolas k -> g^2[i, k] + (j - k)^2, O(w) a row in
//      integer arithmetic, then out = sqrtf(min(D^2, (h + w)^2)) over the
//      whole row.
//
// Column pass. A block takes a strip of 32 V columns of one image, its 32
// warps the rows in segments of s = ceil(h / 32) <= 64, a thread V
// neighbouring columns (V = 4, 2 or 1 mask bytes, one coalesced load a
// row: the widest that w and the alignment allow and whose grid still
// reaches three quarters of the SMs; column_bytes says what was measured).
// The thread reads its rows once and keeps, for each of
// its columns, a word with bit r set where row r of its segment is zero.
// The segments' first and last zeros go through shared memory, where a
// thread a column turns them into the last zero above each segment and the
// first zero below it; then each thread writes g for its rows from its
// bits (the next zero below a row is the lowest set bit of the word
// shifted to it), coalesced. That is n h w / (V s) threads (131,072 at
// 16 x 512 x 512, V = 2) where the first form had n w, each with its loads
// independent of each other. Past h = 2048 a segment outgrows a 64-bit
// word: edt_column_long_kernel keeps the blocks, segments and scan, and a
// thread reads its rows three times instead (first and last zero; g
// downward from the last zero above; upward, min'd, from the first below).
//
// Row pass. D^2[j] = min_k g[k]^2 + (j - k)^2 is the lower envelope of the
// parabolas of the row's sites k, evaluated at each column. A warp takes
// a row, its lanes bands of ceil(w / 32) columns (narrower rows: 4 to 16
// lanes of 32 columns, two to eight rows a warp), in three steps (phase
// 2 of Cao, Tang, Mulder & Wong, "Parallel Banding Algorithm to Compute
// Exact Distance Transform with the GPU", I3D 2010):
//   1. each lane builds the envelope of its band's parabolas on a stack
//      (Felzenszwalb & Huttenlocher's scan, "Distance Transforms of Sampled
//      Functions", 2012): a site is dropped where the one before it and
//      the new one hide it;
//   2. neighbouring groups of bands merge, 1 + 1, 2 + 2, ... 16 + 16: the
//      left group's last sites and the right group's first ones go while
//      the three sites around the junction hide the middle one (each
//      band's stack keeps a range [lo, hi) of survivors);
//   3. each lane finds the lowest parabola at its first column by a walk
//      from the nearest site on its left, then walks forward column by
//      column and writes sqrtf(min(D^2, (h + w)^2)) to its columns.
// A block holds up to four warps, as many as their shared memory (about
// 4 x 32 x w / 16 bytes a warp) allows: one past w = 8192.
// A column with no zero in its column (g = h + w) is no site: its parabola
// lies at or above (h + w)^2, where the result is clamped anyway. That
// leaves rows above and below a nodule with the few columns that cross it.
// "b hides between a and c" compares the abscissae where b starts to beat
// a and where c starts to beat b, (b^2 - a^2 + g_b^2 - g_a^2) / (2 (b -
// a)) against the same for (b, c): both numerators may be negative, and
// the comparison is made cross-multiplied, in 64-bit integers, with no
// division, floor or float at all. The values along the envelope at a
// fixed column fall to the lowest and then rise, which is what makes the
// walks of step 3 right; sites that own no integer column may stay on the
// envelope and cost a step of a walk, never a wrong value. A lane's chain
// is ~w / 32 sites long, where one thread a row (Meijster's scans, the
// first redesign measured) ran a chain of w.
//
// Exactness. The row pass takes only sites with g < h + w, so g <= h - 1;
// with j, k < w every parabola's value (j - k)^2 + g^2 and every
// separator's numerator lies within +-(h + w)^2 < 2^31 while h + w <=
// kMaxSum = 46340: exact in int32, and their cross products (below 2^46)
// exact in int64; within one band of a frame with h + w <= 4096 (band <=
// 64) the products stay below 2^30 and int32 holds them (hidden_near). So
// the row pass gives the exact integer minimum D^2 <= (h + w)^2. Its root:
// where h + w <= 4096, D^2 <= 2^24 is exact in float32 and sqrtf rounds it
// correctly; above, the double root of the exact integer rounded to float32
// (sqrt in double is correctly rounded, and 53 >= 2 x 24 + 2 makes the
// double rounding innocuous where D^2 < 2^24): scipy's float64 EDT cast to
// float32, bit for bit. The plain version (ops/edt.py) computes min(min_k
// g_k^2 + d^2, (h + w)^2) in float32 where h + w <= 4096 (every candidate at
// or below the clamp exact, any above it rounding to at least the clamp)
// and in float64 above, then the same root. Ties between sites do not
// matter: only the value is written. The JAX package's Pallas kernel and
// plain path agree bit for bit where h + w <= 4096; above, its float32 sums
// round.
//
// Bound: uint8 in, float32 out, 5 bytes a pixel (21 MB, 0.0063 ms at
// 3.35 TB/s, at the training slice's 16 x 512 x 512), against ~26 integer
// operations a pixel over both passes, 0.0065 ms on the INT32 lanes (64 a
// clock per SM at 1980 MHz). The uint16 intermediate (8 MB there) stays in
// the 50 MB L2 between the two launches. The TPU kernel's 8x128x128 tiling
// and its O(w^2) min-plus existed for its vector units and are not
// carried over.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

// h + w at most: every d^2 and separator numerator below 2^31 (int32)
constexpr int kMaxSum = 46340;
constexpr int kMaxSmem = 232448;       // shared memory a block may hold
constexpr int kSegs = 32;              // row segments of a strip: warps
constexpr int kRowWarps = 4;           // row-pass warps a block
constexpr int kMinBand = 32;           // row-pass columns a lane, at least
constexpr int kFar = 1 << 20;          // no zero on that side

// ---------------------------------------------------------------------------
// column pass

template <int V>
__device__ __forceinline__ void store_g(uint16_t* p, const uint32_t (&g)[V]) {
  if constexpr (V == 4)
    *reinterpret_cast<uint2*>(p) = make_uint2(g[0] | g[1] << 16,
                                              g[2] | g[3] << 16);
  else if constexpr (V == 2)
    *reinterpret_cast<uint32_t*>(p) = g[0] | g[1] << 16;
  else
    *p = (uint16_t)g[0];
}

__device__ __forceinline__ int lowest_bit(uint32_t x) { return __ffs(x) - 1; }
__device__ __forceinline__ int lowest_bit(uint64_t x) {
  return __ffsll((long long)x) - 1;
}
__device__ __forceinline__ int highest_bit(uint32_t x) {
  return 31 - __clz(x);
}
__device__ __forceinline__ int highest_bit(uint64_t x) {
  return 63 - __clzll((long long)x);
}

// A block's segments' first and last zeros, [segment][v][lane] in shared
// memory, turned by a thread a column into the last zero above each
// segment (a running max down the segments) and the first zero below it (a
// running min up)
template <int V>
__device__ __forceinline__ void scan_segments(int* first_zero,
                                              int* last_zero) {
  if (threadIdx.x < 32 * V) {
    const int col = threadIdx.x;  // v * 32 + lane
    int run = -kFar;
    for (int k0 = 0; k0 < kSegs; k0 += 8) {
      int x[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) x[k] = last_zero[(k0 + k) * V * 32 + col];
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        last_zero[(k0 + k) * V * 32 + col] = run;
        run = max(run, x[k]);
      }
    }
    run = kFar;
    for (int k0 = kSegs - 8; k0 >= 0; k0 -= 8) {
      int x[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) x[k] = first_zero[(k0 + k) * V * 32 + col];
#pragma unroll
      for (int k = 7; k >= 0; --k) {
        first_zero[(k0 + k) * V * 32 + col] = run;
        run = min(run, x[k]);
      }
    }
  }
}

// V mask bytes as one load, and V uint16 g values
template <int V>
using MaskWord = std::conditional_t<
    V == 4, uint32_t, std::conditional_t<V == 2, uint16_t, uint8_t>>;

template <int V>
__device__ __forceinline__ void load_g(const uint16_t* p, uint32_t (&g)[V]) {
  if constexpr (V == 4) {
    const uint2 x = *reinterpret_cast<const uint2*>(p);
    g[0] = x.x & 0xffff, g[1] = x.x >> 16, g[2] = x.y & 0xffff,
    g[3] = x.y >> 16;
  } else if constexpr (V == 2) {
    const uint32_t x = *reinterpret_cast<const uint32_t*>(p);
    g[0] = x & 0xffff, g[1] = x >> 16;
  } else {
    g[0] = *p;
  }
}

// A block: one strip of 32 V columns of one image; warp s the rows
// [s seg, s seg + seg) of it, lane l the V columns from 32 V strip + V l.
// Word holds a bit a row of the segment.
template <int V, typename Word>
__global__ void __launch_bounds__(32 * kSegs)
edt_column_kernel(const uint8_t* __restrict__ fg, float* __restrict__ out,
                  int h, int w, int strips) {
  // the segments' first and last zero of each column: [segment][v][lane]
  __shared__ int first_zero[kSegs * V * 32], last_zero[kSegs * V * 32];
  const long long img = blockIdx.x / strips;
  const int strip = blockIdx.x - (int)img * strips;
  const int lane = threadIdx.x % 32, sg = threadIdx.x / 32;
  const int c = (strip * 32 + lane) * V;
  const bool on = c < w;  // w % V == 0
  const int seg = (h + kSegs - 1) / kSegs;
  const int r0 = sg * seg, r1 = min(h, r0 + seg);
  const uint8_t* src = fg + img * h * w + c;
  uint16_t* dst = reinterpret_cast<uint16_t*>(out + img * h * w) + c;
  using T = MaskWord<V>;  // V mask bytes, one load

  // the thread's rows, a bit a zero: coalesced V-byte loads, eight rows
  // in flight
  Word bits[V];
#pragma unroll
  for (int v = 0; v < V; ++v) bits[v] = 0;
  if (on) {
    for (int r = r0; r < r1; r += 8) {
      T b[8];
#pragma unroll
      for (int k = 0; k < 8; ++k)
        if (r + k < r1)
          b[k] = __ldg(
              reinterpret_cast<const T*>(src + (long long)(r + k) * w));
#pragma unroll
      for (int k = 0; k < 8; ++k)
        if (r + k < r1) {
#pragma unroll
          for (int v = 0; v < V; ++v)
            bits[v] |= (Word)(((b[k] >> (8 * v)) & 0xff) == 0) << (r + k - r0);
        }
    }
  }
#pragma unroll
  for (int v = 0; v < V; ++v) {
    const int at = (sg * V + v) * 32 + lane;
    first_zero[at] = bits[v] ? r0 + lowest_bit(bits[v]) : kFar;
    last_zero[at] = bits[v] ? r0 + highest_bit(bits[v]) : -kFar;
  }
  __syncthreads();
  scan_segments<V>(first_zero, last_zero);
  __syncthreads();
  if (!on) return;

  int above[V], below[V];
#pragma unroll
  for (int v = 0; v < V; ++v) {
    above[v] = last_zero[(sg * V + v) * 32 + lane];
    below[v] = first_zero[(sg * V + v) * 32 + lane];
  }
  const int cap = h + w;
  for (int r = r0; r < r1; ++r) {
    uint32_t g[V];
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const Word rest = bits[v] >> (r - r0);  // rows r.. of the segment
      if (rest & 1) above[v] = r;
      const int next = rest ? r + lowest_bit(rest) : below[v];
      g[v] = (uint32_t)min(min(r - above[v], next - r), cap);
    }
    // g of row r in the first 2w bytes of the row's 4w bytes of out
    store_g<V>(dst + 2ll * r * w, g);
  }
}


// The column pass where h > 32 x 64, so that a segment of ceil(h / 32)
// rows no longer fits one 64-bit word: the same blocks, segments and scan,
// but a thread reads its rows three times instead of keeping their bits:
// for its segment's first and last zero, then downward writing the
// distance to the last zero at or above, then upward taking the min with
// the distance to the first zero at or below (g reread from `out`).
template <int V>
__global__ void __launch_bounds__(32 * kSegs)
edt_column_long_kernel(const uint8_t* __restrict__ fg, float* __restrict__ out,
                       int h, int w, int strips) {
  __shared__ int first_zero[kSegs * V * 32], last_zero[kSegs * V * 32];
  const long long img = blockIdx.x / strips;
  const int strip = blockIdx.x - (int)img * strips;
  const int lane = threadIdx.x % 32, sg = threadIdx.x / 32;
  const int c = (strip * 32 + lane) * V;
  const bool on = c < w;  // w % V == 0
  const int seg = (h + kSegs - 1) / kSegs;
  const int r0 = sg * seg, r1 = min(h, r0 + seg);
  const uint8_t* src = fg + img * h * w + c;
  uint16_t* dst = reinterpret_cast<uint16_t*>(out + img * h * w) + c;
  using T = MaskWord<V>;
  auto zero = [&](T b, int v) { return ((b >> (8 * v)) & 0xff) == 0; };

  int first[V], last[V];
#pragma unroll
  for (int v = 0; v < V; ++v) first[v] = kFar, last[v] = -kFar;
  if (on)
    for (int r = r0; r < r1; ++r) {
      const T b = __ldg(reinterpret_cast<const T*>(src + (long long)r * w));
#pragma unroll
      for (int v = 0; v < V; ++v)
        if (zero(b, v)) {
          first[v] = min(first[v], r);
          last[v] = r;
        }
    }
#pragma unroll
  for (int v = 0; v < V; ++v) {
    const int at = (sg * V + v) * 32 + lane;
    first_zero[at] = first[v];
    last_zero[at] = last[v];
  }
  __syncthreads();
  scan_segments<V>(first_zero, last_zero);
  __syncthreads();
  if (!on) return;

  int above[V], below[V];
#pragma unroll
  for (int v = 0; v < V; ++v) {
    above[v] = last_zero[(sg * V + v) * 32 + lane];
    below[v] = first_zero[(sg * V + v) * 32 + lane];
  }
  const int cap = h + w;
  for (int r = r0; r < r1; ++r) {
    const T b = __ldg(reinterpret_cast<const T*>(src + (long long)r * w));
    uint32_t g[V];
#pragma unroll
    for (int v = 0; v < V; ++v) {
      if (zero(b, v)) above[v] = r;
      g[v] = (uint32_t)min(r - above[v], cap);
    }
    store_g<V>(dst + 2ll * r * w, g);
  }
  for (int r = r1 - 1; r >= r0; --r) {
    const T b = __ldg(reinterpret_cast<const T*>(src + (long long)r * w));
    uint32_t g[V];
    load_g<V>(dst + 2ll * r * w, g);
#pragma unroll
    for (int v = 0; v < V; ++v) {
      if (zero(b, v)) below[v] = r;
      g[v] = (uint32_t)min((int)g[v], min(below[v] - r, cap));
    }
    store_g<V>(dst + 2ll * r * w, g);
  }
}

// ---------------------------------------------------------------------------
// row pass

// the parabola of site s (G = g(s)^2) at column x
__device__ __forceinline__ int parabola(int x, int s, int G) {
  return (x - s) * (x - s) + G;
}

// Site b (a < b < c) is lowest nowhere that a or c is not: the abscissa
// from which b beats a, (b^2 - a^2 + Gb - Ga) / (2 (b - a)), is at or past
// the one from which c beats b. Cross-multiplied: exact in 64 bits.
__device__ __forceinline__ bool hidden(int a, int ga, int b, int gb, int c,
                                       int gc) {
  const long long ab = b * b - a * a + gb - ga, bc = c * c - b * b + gc - gb;
  return ab * (c - b) >= bc * (b - a);
}

// hidden() for three sites of one band (c - a < band <= 64) of a frame
// with h + w <= 4096: the cross products stay below 2^24 * 2^6, and int32
// holds them
__device__ __forceinline__ bool hidden_near(int a, int ga, int b, int gb,
                                            int c, int gc) {
  const int ab = b * b - a * a + gb - ga, bc = c * c - b * b + gc - gb;
  return ab * (c - b) >= bc * (b - a);
}

// A warp takes 32 / L rows, L lanes a row, a band of columns a lane: band
// = ceil(w / 32) rounded up to a power of two (so that a column's band is
// a shift), and while it is below kMinBand, half the lanes a row and twice
// the band (L >= 4), so that rows share a warp's fixed costs (the merges,
// the walks' first steps) rather than leave lanes with a few columns each:
// w = 512 takes 16 lanes of 32, w = 256 8 of 32, w = 2048 32 of 64. (On
// an H100, at 16 columns a lane the row pass took 1.18 and 1.14 times as
// long at 16 x 512 x 512 and 128 x 256 x 256, at 64 1.35 and 1.41 times.)
struct RowShape {
  int band, lanes;
};
__host__ __device__ __forceinline__ RowShape row_shape(int w) {
  RowShape r{2, 32};
  while (32 * r.band < w) r.band *= 2;
  while (r.band < kMinBand && r.lanes > 4) r.band *= 2, r.lanes /= 2;
  return r;
}
// bp / 2 words odd: lanes at the same place in their own bands touch
// different banks
__host__ __device__ __forceinline__ int row_bp(int band) {
  return 2 * ((band / 2) | 1);
}
// A warp's shared memory: g and the bands' stacks of sites ([32][bp]
// uint16 each), and each band's surviving range [lo, hi) of its stack.
__host__ __device__ __forceinline__ int row_smem(int w) {
  return 2 * 2 * 32 * row_bp(row_shape(w).band) + 2 * 4 * 32;
}

// The stack position after (b, i) on the row's envelope: the band's next
// entry, or the first of the next band (of the row's bands in `full`) that
// has any (b = -1: none).
__device__ __forceinline__ void step_next(int& b, int& i, const int* lo,
                                          const int* hi, unsigned full) {
  if (i + 1 < hi[b]) {
    ++i;
    return;
  }
  const unsigned m = full & ~((2u << b) - 1u);
  b = m ? __ffs(m) - 1 : -1;
  if (b >= 0) i = lo[b];
}

__device__ __forceinline__ void step_prev(int& b, int& i, const int* lo,
                                          const int* hi, unsigned full) {
  if (i - 1 >= lo[b]) {
    --i;
    return;
  }
  const unsigned m = full & ((1u << b) - 1u);
  b = m ? 31 - __clz(m) : -1;
  if (b >= 0) i = hi[b] - 1;
}

// A block is 1 to kRowWarps warps (blockDim.x / 32): as many as the
// warps' shared memory allows, one at w > 8192.
__global__ void __launch_bounds__(32 * kRowWarps)
edt_row_kernel(float* __restrict__ buf, long long rows, int w, int cap) {
  extern __shared__ __align__(16) unsigned char smem[];
  const RowShape shape = row_shape(w);
  const int band = shape.band, nl = shape.lanes, bp = row_bp(band);
  const int shift = __ffs(band) - 1;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int warps = blockDim.x / 32;
  // int32 separators within a band while h + w <= 4096 and band <= 64
  const bool narrow = cap <= 4096 && band <= 64;
  const int sub = lane / nl, l = lane % nl;  // the warp's row, its band
  unsigned char* mine = smem + warp * row_smem(w);
  uint16_t* gs = reinterpret_cast<uint16_t*>(mine);          // [32][bp]
  uint16_t* st = gs + 32 * bp;                                // [32][bp]
  int* lo = reinterpret_cast<int*>(st + 32 * bp);
  int* hi = lo + 32;
  const long long row =
      ((long long)blockIdx.x * warps + warp) * (32 / nl) + sub;
  const bool on = row < rows;
  float* out = buf + (on ? row : 0) * w;
  // band b of the row holds columns [(b - b0) band, ...); its g at
  // gs[b bp + column - (b - b0) band] = gs[b bp + column + off - b band]
  const int b0 = sub * nl, off = b0 * band;

  // g (the first 2w bytes of the row), coalesced
  if (on && w % 2 == 0) {
    const uint32_t* src = reinterpret_cast<const uint32_t*>(out);
    for (int k = 2 * l; k < w; k += 2 * nl) {
      const int b = b0 + (k >> shift);
      *reinterpret_cast<uint32_t*>(gs + b * bp + k + off - b * band) =
          src[k / 2];
    }
  } else if (on) {
    const uint16_t* src = reinterpret_cast<const uint16_t*>(out);
    for (int k = l; k < w; k += nl) {
      const int b = b0 + (k >> shift);
      gs[b * bp + k + off - b * band] = src[k];
    }
  }
  __syncwarp();

  // 1. the lane's band: the lower envelope of its columns' parabolas on a
  // stack, the top two sites in registers. A column with no zero (g = cap)
  // is no site: its parabola lies at or above cap^2, where the result is
  // clamped anyway.
  const int j0 = l * band, j1 = on ? min(w, j0 + band) : j0;
  const uint16_t* gb = gs + lane * bp;
  uint16_t* sb = st + lane * bp;
  // The lanes step through their columns together: every lane takes
  // `band` steps and the warp meets after each, or lanes that skip a column
  // or pop a different number of sites drift apart and the warp runs
  // their paths one after another.
  int cnt = 0, s1 = 0, g1 = 0, s0 = 0, g0 = 0;
  for (int k = j0; k < j0 + band; ++k) {
    const int gk = k < j1 ? gb[k - j0] : cap;
    if (gk < cap) {
      const int g2 = gk * gk;
      while (cnt >= 2 && (narrow ? hidden_near(s0, g0, s1, g1, k, g2)
                               : hidden(s0, g0, s1, g1, k, g2))) {
        --cnt;
        s1 = s0;
        g1 = g0;
        if (cnt >= 2) {
          s0 = sb[cnt - 2];
          g0 = gb[s0 - j0] * gb[s0 - j0];
        }
      }
      sb[cnt++] = (uint16_t)k;
      s0 = s1;
      g0 = g1;
      s1 = k;
      g1 = g2;
    }
    __syncwarp();
  }
  lo[lane] = 0;
  hi[lane] = cnt;
  __syncwarp();

  // 2. merge neighbouring groups of a row's bands, 1 + 1, 2 + 2, ...: drop
  // the left group's last sites and the right group's first ones while the
  // junction hides one
  for (int span = 1; span < nl; span *= 2) {
    if (l % (2 * span) == 0) {
      const int end = lane + 2 * span;
      int tb = lane + span - 1, hb = lane + span;
      while (tb >= lane && hi[tb] == lo[tb]) --tb;
      while (hb < end && hi[hb] == lo[hb]) ++hb;
      while (tb >= lane && hb < end) {
        const int t = st[tb * bp + hi[tb] - 1], h = st[hb * bp + lo[hb]];
        const int gt = gs[tb * bp + t + off - tb * band],
                  gh = gs[hb * bp + h + off - hb * band];
        const int gt2 = gt * gt, gh2 = gh * gh;
        // the site before t
        int pb = tb, pi = hi[tb] - 2;
        if (pi < lo[tb]) {
          for (pb = tb - 1; pb >= lane && hi[pb] == lo[pb];) --pb;
          pi = pb >= lane ? hi[pb] - 1 : 0;
        }
        if (pb >= lane) {
          const int p = st[pb * bp + pi];
          const int gp = gs[pb * bp + p + off - pb * band];
          if (hidden(p, gp * gp, t, gt2, h, gh2)) {
            if (--hi[tb] == lo[tb]) tb = pb;
            continue;
          }
        }
        // the site after h
        int nb = hb, ni = lo[hb] + 1;
        if (ni >= hi[hb]) {
          for (nb = hb + 1; nb < end && hi[nb] == lo[nb];) ++nb;
          ni = nb < end ? lo[nb] : 0;
        }
        if (nb < end) {
          const int q = st[nb * bp + ni];
          const int gq = gs[nb * bp + q + off - nb * band];
          if (hidden(t, gt2, h, gh2, q, gq * gq)) {
            if (++lo[hb] == hi[hb]) hb = nb;
            continue;
          }
        }
        break;
      }
    }
    __syncwarp();
  }

  // 3. each lane its band's columns: the lowest parabola at j0 by a walk
  // from the nearest site on the left (the values along the envelope at a
  // fixed column fall to the lowest, then rise), then forward, column by
  // column, with the next site in registers; the distances go straight to
  // the row (g is all in shared memory by now), 16 bytes at a time where
  // the row allows
  const unsigned rows_bands = nl == 32 ? ~0u : ((1u << nl) - 1u) << b0;
  const unsigned full =
      __ballot_sync(0xffffffffu, hi[lane] > lo[lane]) & rows_bands;
  const int cap2 = cap * cap;
  // d^2 <= cap^2: exact in float32 while cap <= 4096, where sqrtf of it
  // is correctly rounded; above, the correctly rounded double root of the
  // exact integer, rounded to float32 (scipy's float64 EDT as float32;
  // below 2^24 the two agree, since 53 >= 2 x 24 + 2 makes the double
  // rounding innocuous)
  const bool f32_root = cap <= 4096;
  const bool vec = w % 4 == 0 && (uintptr_t)buf % 16 == 0;
  const bool walks = j0 < j1 && full;  // columns, and sites to walk
  int cb = 0, ci = 0, cs = 0, cg = 0, nb = -1, ni = 0, ns = 0, ng = 0;
  if (walks) {
    const unsigned left = full & ((1u << lane) - 1u);
    cb = left ? 31 - __clz(left) : __ffs(full) - 1;
    ci = left ? hi[cb] - 1 : lo[cb];
    cs = st[cb * bp + ci];
    cg = gs[cb * bp + cs + off - cb * band];
    cg *= cg;
    for (;;) {
      int b = cb, i = ci;
      step_prev(b, i, lo, hi, full);
      if (b < 0) break;
      const int s = st[b * bp + i], g = gs[b * bp + s + off - b * band];
      if (parabola(j0, s, g * g) > parabola(j0, cs, cg)) break;
      cb = b, ci = i, cs = s, cg = g * g;
    }
    nb = cb, ni = ci;
    step_next(nb, ni, lo, hi, full);
    if (nb >= 0) {
      ns = st[nb * bp + ni];
      ng = gs[nb * bp + ns + off - nb * band];
      ng *= ng;
    }
  }
  __syncwarp();
  auto distance = [&](int j) {
    if (!walks) return (float)cap;  // exact: cap < 2^24
    while (nb >= 0 && parabola(j, ns, ng) <= parabola(j, cs, cg)) {
      cb = nb, ci = ni, cs = ns, cg = ng;
      step_next(nb, ni, lo, hi, full);
      if (nb >= 0) {
        ns = st[nb * bp + ni];
        ng = gs[nb * bp + ns + off - nb * band];
        ng *= ng;
      }
    }
    const int d2 = min(parabola(j, cs, cg), cap2);
    return f32_root ? sqrtf((float)d2)
                    : __double2float_rn(__dsqrt_rn((double)d2));
  };
  // as in step 1, the lanes take `band` columns in step
  if (vec) {  // j0 and j1 are multiples of 4
    for (int j = j0; j < j0 + band; j += 4) {
      float4 q;
      q.x = distance(j);
      q.y = distance(j + 1);
      q.z = distance(j + 2);
      q.w = distance(j + 3);
      if (j < j1) *reinterpret_cast<float4*>(out + j) = q;
      __syncwarp();
    }
  } else {
    for (int j = j0; j < j0 + band; ++j) {
      const float d = distance(j);
      if (j < j1) out[j] = d;
      __syncwarp();
    }
  }
}

template <int V>
cudaError_t launch_columns(const uint8_t* fg, float* out, long long n, int h,
                           int w, cudaStream_t s) {
  const int strips = (w + 32 * V - 1) / (32 * V);
  const long long blocks = n * strips;
  if (blocks > 0x7fffffffll) return cudaErrorInvalidValue;
  // segments past 32 rows take 64-bit words, past 64 three reads a row
  if (h > 64 * kSegs)
    edt_column_long_kernel<V><<<(unsigned)blocks, 32 * kSegs, 0, s>>>(
        fg, out, h, w, strips);
  else if (h > 32 * kSegs)
    edt_column_kernel<V, uint64_t><<<(unsigned)blocks, 32 * kSegs, 0, s>>>(
        fg, out, h, w, strips);
  else
    edt_column_kernel<V, uint32_t><<<(unsigned)blocks, 32 * kSegs, 0, s>>>(
        fg, out, h, w, strips);
  return cudaGetLastError();
}

// Once a device: every kernel's shared-memory carveout at its largest
// (left at its default, most of an SM's 256 KB may stay L1 and fewer
// blocks run an SM: the row pass took 1.1 times as long on an H100), and
// the SM count. Returns the count, or 0 with `err` set.
int configure(int dev, cudaError_t& err) {
  static int sms[64];  // 0: not yet configured
  if (dev >= 0 && dev < 64 && sms[dev]) return sms[dev];
  const void* kernels[] = {
      (const void*)edt_row_kernel,
      (const void*)edt_column_long_kernel<4>,
      (const void*)edt_column_long_kernel<2>,
      (const void*)edt_column_long_kernel<1>,
      (const void*)edt_column_kernel<4, uint32_t>,
      (const void*)edt_column_kernel<4, uint64_t>,
      (const void*)edt_column_kernel<2, uint32_t>,
      (const void*)edt_column_kernel<2, uint64_t>,
      (const void*)edt_column_kernel<1, uint32_t>,
      (const void*)edt_column_kernel<1, uint64_t>};
  int n = 0;
  for (const void* k : kernels)
    if ((err = cudaFuncSetAttribute(
             k, cudaFuncAttributePreferredSharedMemoryCarveout,
             cudaSharedmemCarveoutMaxShared)))
      return 0;
  // rows wider than 2048 stage more than the 48 KB a block gets unasked
  if ((err = cudaFuncSetAttribute(
           (const void*)edt_row_kernel,
           cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem)))
    return 0;
  if ((err = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev)))
    return 0;
  if (dev >= 0 && dev < 64) sms[dev] = n;
  return n;
}

// The widest load (4, 2 or 1 mask bytes a thread) that w and the buffers'
// alignment allow and whose grid still reaches three quarters of the SMs.
// A wider load moves the same bytes in fewer load and store instructions:
// on an H100 (132 SMs; probes/edt_column_widths.py) the column pass took
// 0.63-0.65 of V = 1's time at V = 4 and 0.81-0.82 at V = 2, at (64, 512,
// 512) and (128, 256, 256), where V = 4 has 256 blocks. At (16, 512, 512)
// V = 4's 64 blocks took 1.10 of V = 1's time and V = 2's 128 blocks 0.79.
int column_bytes(const void* fg, const void* out, long long n, int w,
                 int sms) {
  for (int v = 4; v > 1; v /= 2)
    if (w % v == 0 && (uintptr_t)fg % v == 0 && (uintptr_t)out % (2 * v) == 0
        && 4 * n * ((w + 32 * v - 1) / (32 * v)) >= 3ll * sms)
      return v;
  return 1;
}

}  // namespace

// fg: (n, h, w) uint8, nonzero = foreground; out: (n, h, w) float32;
// h + w <= 46340 and w <= 32768 (a row warp's shared memory). Returns the
// CUDA error of the launches (0 on success).
extern "C" int ddti_edt(const void* fg, void* out, long long n, int h, int w,
                        void* stream) {
  if (n <= 0 || h <= 0 || w <= 0 || (long long)h + w > kMaxSum ||
      row_smem(w) > kMaxSmem)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const uint8_t* in = (const uint8_t*)fg;
  float* o = (float*)out;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  const int sms = configure(dev, err);
  if (!sms) return (int)err;
  const int v = column_bytes(fg, out, n, w, sms);
  err = v == 4   ? launch_columns<4>(in, o, n, h, w, s)
        : v == 2 ? launch_columns<2>(in, o, n, h, w, s)
                 : launch_columns<1>(in, o, n, h, w, s);
  if (err != cudaSuccess) return (int)err;

  const long long rows = n * h;
  // 4 x 8,704 bytes at w = 2048; one warp of 131,584 at w = 32768
  const int fit = kMaxSmem / row_smem(w);
  const int warps = fit < kRowWarps ? fit : kRowWarps;
  const int per_block = warps * (32 / row_shape(w).lanes);
  const long long blocks = (rows + per_block - 1) / per_block;
  if (blocks > 0x7fffffffll) return (int)cudaErrorInvalidValue;
  edt_row_kernel<<<(unsigned)blocks, 32 * warps, warps * row_smem(w), s>>>(
      o, rows, w, h + w);
  return (int)cudaGetLastError();
}

// The message of a CUDA error code, for the Python wrappers' exceptions.
extern "C" const char* ddti_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// Row helpers shared by the hand-written Hopper (sm_90a) kernels: one warp
// owns one block-row of 128*NV4 floats, each lane NV4 float4 chunks (chunk
// i*32+lane, so every warp-wide load is 512 contiguous bytes), and per-row
// reductions are warp reductions (__reduce_*_sync); digit_select ranks its
// last candidates in 32 words of shared memory.
// Included by exactly one translation unit per library; everything here
// has internal linkage.
#pragma once

#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;              // 8 warps per thread block
constexpr int kWarps = kThreads / 32;

// Max over the warp of non-negative floats, through their bit patterns.
__device__ __forceinline__ float warp_max_nonneg(float v) {
  return __uint_as_float(__reduce_max_sync(kFull, __float_as_uint(v)));
}

template <int NV4>
__device__ __forceinline__ void load_row(const float* __restrict__ row,
                                         float (&x)[4 * NV4], int lane) {
  const float4* p = reinterpret_cast<const float4*>(row);
#pragma unroll
  for (int i = 0; i < NV4; ++i) {
    const float4 t = p[i * 32 + lane];
    x[4 * i] = t.x;
    x[4 * i + 1] = t.y;
    x[4 * i + 2] = t.z;
    x[4 * i + 3] = t.w;
  }
}

template <int NV4>
__device__ __forceinline__ void store_row(float* __restrict__ row,
                                          const float (&x)[4 * NV4],
                                          int lane) {
  float4* p = reinterpret_cast<float4*>(row);
#pragma unroll
  for (int i = 0; i < NV4; ++i) {
    p[i * 32 + lane] =
        make_float4(x[4 * i], x[4 * i + 1], x[4 * i + 2], x[4 * i + 3]);
  }
}

__device__ __forceinline__ unsigned abs_bits(float v) {
  return __float_as_uint(v) & 0x7fffffffu;
}

// Copy a block-row (128*NV4 floats) from global to shared memory without
// passing through registers (cp.async, cached in L2 only): lane copies the
// float4 chunks i*32+lane, the ones it reads back itself.
template <int NV4>
__device__ __forceinline__ void stage_row(float* dst,
                                          const float* __restrict__ src,
                                          int lane) {
#pragma unroll
  for (int i = 0; i < NV4; ++i) {
    const unsigned d = static_cast<unsigned>(
        __cvta_generic_to_shared(dst + 4 * (i * 32 + lane)));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
                 "l"(src + 4 * (i * 32 + lane)));
  }
}

template <int NV4>
__device__ __forceinline__ void shared_row(const float* src,
                                           float (&x)[4 * NV4], int lane) {
#pragma unroll
  for (int i = 0; i < NV4; ++i) {
    const float4 t = reinterpret_cast<const float4*>(src)[i * 32 + lane];
    x[4 * i] = t.x;
    x[4 * i + 1] = t.y;
    x[4 * i + 2] = t.z;
    x[4 * i + 3] = t.w;
  }
}

// ---------------------------------------------------------------------------
// The exact k-th largest |x| of a warp's row: digit_select.
//
// |x| is taken as the uint32 bit pattern of |x|, which is monotone for
// non-negative floats, so the k-th largest pattern is the sort threshold bit
// for bit (ties kept; 0 when fewer than k entries are nonzero).  The
// candidates are the entries whose higher bits equal those chosen so far,
// and ``rank`` is the rank still sought among them.  The select is bound by
// the integer pipe (half the FP32 rate) and its warp reductions, so each
// step is chosen for few integer instructions:
//   1. The top 8-bit digit (the sign bit, 0, and seven exponent bits): float
//      magnitudes crowd into a few exponents, so the walk goes down the top
//      digits present, each step a count and, where the rank lies lower,
//      the next digit present (typically one step).  A row whose rank lies
//      below its first digit is checked for fewer than k nonzero entries (a
//      padded block): its threshold is 0.
//   2. While more than 32 candidates are left, one bit at a time halves
//      them (a count and a warp reduction per bit); a bit that splits none
//      off sends the select to the highest bit at which the candidates
//      differ (their minimum and maximum), or ends it where they are all
//      equal (ties).  When exactly ``rank`` are left, the answer is the
//      least of them.
//   3. The last <= 32 candidates are compacted into 32 words of shared
//      memory and each lane counts the candidates greater than its own; the
//      answer is the least candidate with fewer than ``rank`` greater.
// Where the row holds normal finite floats, the walk's first count, the
// bit passes' counts and step 3's comparisons are saturated fused
// multiply-adds on the FP32 pipe, exact for patterns within one top digit.
// ``s`` is 32 words of shared memory private to the warp, 16-byte aligned.
// Every lane must call with the same k, 1 <= k <= row length.
// ---------------------------------------------------------------------------

// The largest |x| pattern of the warp's row.
template <int N>
__device__ __forceinline__ unsigned row_max(const unsigned (&u)[N]) {
  unsigned m = 0;
#pragma unroll
  for (int j = 0; j < N; ++j) m = max(m, u[j]);
  return __reduce_max_sync(kFull, m);
}

// This lane's entries whose bits above ``shift`` equal prefix.
template <int N>
__device__ __forceinline__ unsigned count_candidates(const unsigned (&u)[N],
                                                     unsigned prefix,
                                                     int shift) {
  const unsigned mask = kFull << shift;
  unsigned c = 0;
#pragma unroll
  for (int j = 0; j < N; ++j) c += (u[j] & mask) == prefix ? 1u : 0u;
  return c;
}

template <int N>
__device__ __forceinline__ unsigned least_candidate(const unsigned (&u)[N],
                                                   unsigned prefix,
                                                   int shift) {
  const unsigned mask = kFull << shift;
  unsigned least = kFull;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    if ((u[j] & mask) == prefix) least = min(least, u[j]);
  }
  return __reduce_min_sync(kFull, least);
}

// 2^(24-e) for the top digit whose binades are [2^e, 2^(e+2)),
// e = 2 digit - 127; a normal float for 12 <= digit <= 126.
__device__ __forceinline__ float digit_scale(unsigned digit) {
  return __uint_as_float((278u - 2u * digit) << 23);
}

// This lane's entries whose pattern is >= m, for m in the binades of the
// top digit that ``scale`` (digit_scale) belongs to and no entry NaN or
// infinite, counted on the FP32 pipe: the entries in those binades are
// multiples of 2^(e-23) and pred(m) is one of them or 2^e - 2^(e-24), so
// (x - pred(m)) 2^(24-e), formed by one fused multiply-add, is >= 1 where
// x >= m (at least 4 above the binades) and <= 0 elsewhere, and saturates
// to exactly 1 or 0.
template <int N>
__device__ __forceinline__ unsigned count_at_least(const unsigned (&u)[N],
                                                   unsigned m, float scale) {
  const float base = -__fmul_rn(__uint_as_float(m - 1), scale);
  float g0 = 0.0f, g1 = 0.0f;
#pragma unroll
  for (int j = 0; j < N; j += 2) {
    g0 += __saturatef(__fmaf_rn(__uint_as_float(u[j]), scale, base));
    g1 += __saturatef(__fmaf_rn(__uint_as_float(u[j + 1]), scale, base));
  }
  return static_cast<unsigned>(g0 + g1);
}

// Step 3: the rank-th largest of the n <= 32 candidates (bits above shift
// equal prefix), c of them in this lane.
template <int N>
__device__ __forceinline__ unsigned rank_candidates(const unsigned (&u)[N],
                                                   unsigned prefix, int shift,
                                                   unsigned c, unsigned n,
                                                   unsigned rank,
                                                   unsigned* s) {
  const int lane = threadIdx.x & 31;
  const unsigned mask = kFull << shift;
  unsigned pos = c;                          // inclusive scan of c
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned v = __shfl_up_sync(kFull, pos, o);
    if (lane >= o) pos += v;
  }
  pos -= c;
  s[lane] = kFull;                           // filler, below every candidate
  __syncwarp();
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const bool mine = (u[j] & mask) == prefix;
    if (mine) s[pos] = u[j];
    pos += mine ? 1u : 0u;
  }
  __syncwarp();
  // t is the least candidate v with fewer than ``rank`` candidates > v
  const unsigned v = s[lane];
  const unsigned top = prefix >> 24;
  unsigned gt;
  if (top >= 12 && top <= 126) {
    // Candidates share a top digit, so they lie in [2^e, 2^(e+2)) with
    // e = 2 top - 127, as multiples of 2^(e-23): (a - v) 2^(23-e) is an
    // integer, formed exactly by one fused multiply-add, and saturates to
    // 1 for a > v, else 0 (the NaN filler to 0 too).
    const float scale = __uint_as_float((277u - 2u * top) << 23);
    const float base = -__fmul_rn(__uint_as_float(v), scale);
    const float4* s4 = reinterpret_cast<const float4*>(s);
    float g[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int m = 0; m < 8; ++m) {
      const float4 q = s4[m];
      g[0] += __saturatef(__fmaf_rn(q.x, scale, base));
      g[1] += __saturatef(__fmaf_rn(q.y, scale, base));
      g[2] += __saturatef(__fmaf_rn(q.z, scale, base));
      g[3] += __saturatef(__fmaf_rn(q.w, scale, base));
    }
    gt = static_cast<unsigned>((g[0] + g[1]) + (g[2] + g[3]));
  } else {
    // as int, candidates (< 2^31) are >= 0 and the filler is -1
    const int iv = static_cast<int>(v);
    const int4* s4 = reinterpret_cast<const int4*>(s);
    unsigned g[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int m = 0; m < 8; ++m) {
      const int4 q = s4[m];
      g[0] += q.x > iv ? 1u : 0u;
      g[1] += q.y > iv ? 1u : 0u;
      g[2] += q.z > iv ? 1u : 0u;
      g[3] += q.w > iv ? 1u : 0u;
    }
    gt = g[0] + g[1] + g[2] + g[3];
  }
  const bool win = static_cast<unsigned>(lane) < n && gt < rank;
  return __reduce_min_sync(kFull, win ? v : kFull);
}

// The k-th largest |x| pattern of the warp's row: u holds this lane's N
// patterns, top the row_max.
template <int N>
__device__ __forceinline__ unsigned digit_select(const unsigned (&u)[N],
                                                 unsigned top, int k,
                                                 unsigned* s) {
  if (top == 0) return 0u;               // an all-zero row
  unsigned rank = static_cast<unsigned>(k), digit = top >> 24, in_bin, c;
  unsigned above = 0;                    // this lane's entries above them
  for (bool first = true;; first = false) {
    // c: this lane's entries in ``digit`` (on the first step, all entries
    // at or above its lowest pattern)
    if (first && digit >= 12 && digit <= 126) {
      c = count_at_least<N>(u, digit << 24, digit_scale(digit));
    } else {
      unsigned c0 = 0, c1 = 0;
#pragma unroll
      for (int j = 0; j < N; j += 2) {
        c0 += u[j] >> 24 == digit ? 1u : 0u;
        c1 += u[j + 1] >> 24 == digit ? 1u : 0u;
      }
      c = c0 + c1;
    }
    in_bin = __reduce_add_sync(kFull, c);
    if (in_bin >= rank) break;
    if (first && __reduce_add_sync(kFull, N - count_candidates<N>(u, 0u, 0)) <
                     static_cast<unsigned>(k)) {
      return 0u;                         // fewer than k nonzero entries
    }
    // the next digit present below: digit - 1 - min(digit - 1 - d) over
    // the entries, in uint32 (entries at or above digit wrap high)
    const unsigned dm1 = digit - 1;
    unsigned g0 = kFull, g1 = kFull;
#pragma unroll
    for (int j = 0; j < N; j += 2) {
      g0 = min(g0, dm1 - (u[j] >> 24));
      g1 = min(g1, dm1 - (u[j + 1] >> 24));
    }
    rank -= in_bin;
    above += c;
    digit = dm1 - __reduce_min_sync(kFull, min(g0, g1));
  }
  // one bit at a time below the top digit while more than 32 candidates
  // are left: those with the bit set, and this lane's share of them
  unsigned prefix = digit << 24;
  int shift = 24;
  // no NaN or infinity in the row (its largest pattern is below digit 127)
  const bool fp = digit >= 12 && top >> 24 <= 126;
  const float scale = digit_scale(digit);
  while (in_bin > 32 && in_bin != rank && shift > 0) {
    const unsigned mid = prefix | (1u << --shift);
    const unsigned hi = fp ? count_at_least<N>(u, mid, scale) - above
                           : count_candidates<N>(u, mid, shift);
    const unsigned upper = __reduce_add_sync(kFull, hi);
    if (upper == 0 || upper == in_bin) {
      // the bit does not split them (ties, sparse mantissas): go to the
      // highest bit at which the candidates differ, if any
      const unsigned fixed = kFull << (shift + 1);
      unsigned lo = kFull, hi_u = 0;
#pragma unroll
      for (int j = 0; j < N; ++j) {
        if ((u[j] & fixed) == prefix) {
          lo = min(lo, u[j]);
          hi_u = max(hi_u, u[j]);
        }
      }
      lo = __reduce_min_sync(kFull, lo);
      hi_u = __reduce_max_sync(kFull, hi_u);
      if (lo == hi_u) return lo;           // all candidates are equal
      shift = 32 - __clz(lo ^ hi_u);       // the next pass splits there
      prefix = hi_u & (kFull << shift);
      continue;
    }
    if (upper >= rank) {
      prefix = mid;
      in_bin = upper;
      c = hi;
    } else {
      rank -= upper;
      in_bin -= upper;
      c -= hi;
      above += hi;
    }
  }
  if (in_bin == rank) return least_candidate<N>(u, prefix, shift);
  if (in_bin > 32) return prefix;       // all bits fixed: the candidates tie
  return rank_candidates<N>(u, prefix, shift, c, in_bin, rank, s);
}

// Symmetric per-row quantize -> dequantize with qmax = 2^(bits-1) - 1.
template <int N>
__device__ __forceinline__ void quantize_row(float (&x)[N], float qmax) {
  float m = 0.0f;
#pragma unroll
  for (int j = 0; j < N; ++j) m = fmaxf(m, fabsf(x[j]));
  m = warp_max_nonneg(m);
  float scale = m / qmax;
  if (scale == 0.0f) scale = 1.0f;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const float q = fminf(fmaxf(rintf(x[j] / scale), -qmax - 1.0f), qmax);
    x[j] = q * scale;
  }
}

__device__ __forceinline__ float qmax_for(int bits) {
  return static_cast<float>((1 << (bits - 1)) - 1);
}

inline unsigned row_blocks(long long R) {
  return static_cast<unsigned>((R + kWarps - 1) / kWarps);
}

inline bool rows_ok(long long R, int block) {
  return R > 0 && (R + kWarps - 1) / kWarps <= 0x7fffffffLL &&
         (block == 128 || block == 256 || block == 512 || block == 1024);
}

}  // namespace

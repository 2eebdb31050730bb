// Row helpers shared by the hand-written Hopper (sm_90a) kernels: one warp
// owns one block-row of 128*NV4 floats, each lane NV4 float4 chunks (chunk
// i*32+lane, so every warp-wide load is 512 contiguous bytes), and per-row
// reductions are warp reductions (__reduce_*_sync); only digit_select's
// histogram lives in shared memory.
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

// The k-th largest |x| of the warp's row (1 <= k <= row length), as the
// uint32 bit pattern of |x| (monotone for non-negative floats): the largest
// pattern t with count(|x| >= t) >= k, built one bit at a time from the
// top.  ``u`` holds each lane's |x| bit patterns.
template <int N>
__device__ __forceinline__ unsigned topk_threshold(const unsigned (&u)[N],
                                                   int k) {
  unsigned t = 0;
  for (int b = 31; b >= 0; --b) {
    const unsigned cand = t | (1u << b);
    unsigned c = 0;
#pragma unroll
    for (int j = 0; j < N; ++j) c += (u[j] >= cand) ? 1u : 0u;
    c = __reduce_add_sync(kFull, c);
    if (c >= static_cast<unsigned>(k)) t = cand;
  }
  return t;
}

__device__ __forceinline__ unsigned abs_bits(float v) {
  return __float_as_uint(v) & 0x7fffffffu;
}

// Zero every entry of the warp's row whose |x| is below the k-th largest
// |x| of the row, ties kept.
template <int N>
__device__ __forceinline__ void topk_row(float (&x)[N], int k) {
  unsigned u[N];
#pragma unroll
  for (int j = 0; j < N; ++j) u[j] = abs_bits(x[j]);
  const unsigned t = topk_threshold<N>(u, k);
#pragma unroll
  for (int j = 0; j < N; ++j) {
    if (u[j] < t) x[j] = 0.0f;
  }
}

// The least candidate (an entry whose bits above ``shift`` equal
// ``prefix``) of the warp's row.
template <int N>
__device__ __forceinline__ unsigned least_candidate(const float (&x)[N],
                                                   unsigned prefix,
                                                   int shift) {
  const unsigned mask = kFull << shift;
  unsigned least = kFull;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const unsigned u = abs_bits(x[j]);
    if ((u & mask) == prefix) least = min(least, u);
  }
  return __reduce_min_sync(kFull, least);
}

// The k-th largest |x| of the warp's row (1 <= k <= row length), as the
// uint32 bit pattern of |x|, exactly: the same value as topk_threshold, in
// four 8-bit digit passes from the top instead of 32 one-bit passes.  The
// candidates are the entries whose higher digits equal those chosen so
// far; each pass picks the digit that holds the rank still sought among
// them, and when that digit's candidates number exactly that rank, the
// answer is the least of them and the passes stop.
//   * The top digit: float magnitudes crowd into a few exponents, where a
//     histogram's atomics would collide, so the pass walks down the top
//     digits present with warp reductions (typically one or two digits).
//   * The other three: a 256-bin histogram in ``hist`` (256 words of shared
//     memory, 16-byte aligned, private to the warp), then a warp scan over
//     the bins from the highest.
// Every lane of the warp must call this with the same k.
template <int N>
__device__ __forceinline__ unsigned digit_select(const float (&x)[N], int k,
                                                 unsigned* hist) {
  const int lane = threadIdx.x & 31;
  unsigned rank = static_cast<unsigned>(k);  // sought among the candidates
  unsigned top = 0;
#pragma unroll
  for (int j = 0; j < N; ++j) top = max(top, abs_bits(x[j]) >> 24);
  unsigned digit = __reduce_max_sync(kFull, top), in_bin;
  while (true) {
    unsigned c = 0, below = 0;             // below: the next digit down, + 1
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const unsigned d = abs_bits(x[j]) >> 24;
      c += d == digit ? 1u : 0u;
      if (d < digit) below = max(below, d + 1);
    }
    in_bin = __reduce_add_sync(kFull, c);
    if (in_bin >= rank) break;
    rank -= in_bin;
    digit = __reduce_max_sync(kFull, below) - 1;
  }
  unsigned prefix = digit << 24;            // the digits chosen so far
  if (in_bin == rank) return least_candidate<N>(x, prefix, 24);
  uint4* h4 = reinterpret_cast<uint4*>(hist);
  for (int shift = 16; shift >= 0; shift -= 8) {
    const unsigned above = kFull << (shift + 8);
    h4[lane] = make_uint4(0u, 0u, 0u, 0u);
    h4[lane + 32] = make_uint4(0u, 0u, 0u, 0u);
    __syncwarp();
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const unsigned u = abs_bits(x[j]);
      if ((u & above) == prefix) atomicAdd(hist + ((u >> shift) & 0xffu), 1u);
    }
    __syncwarp();
    // lane l owns bins 255 - 8l down to 248 - 8l; c[0] is the highest
    const uint4 lo = h4[62 - 2 * lane], hi = h4[63 - 2 * lane];
    const unsigned c[8] = {hi.w, hi.z, hi.y, hi.x, lo.w, lo.z, lo.y, lo.x};
    unsigned sum = 0;
#pragma unroll
    for (int i = 0; i < 8; ++i) sum += c[i];
    unsigned incl = sum;                 // candidates in the bins >= mine
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const unsigned t = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl += t;
    }
    const unsigned excl = incl - sum;
    const int owner =
        __ffs(__ballot_sync(kFull, excl < rank && rank <= incl)) - 1;
    unsigned higher = 0, run = excl;
    bool found = false;
    digit = 0;
    in_bin = 0;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      if (!found && run + c[i] >= rank) {
        found = true;
        digit = 255u - 8u * lane - i;
        higher = run;
        in_bin = c[i];
      }
      run += c[i];
    }
    digit = __shfl_sync(kFull, digit, owner);
    higher = __shfl_sync(kFull, higher, owner);
    in_bin = __shfl_sync(kFull, in_bin, owner);
    prefix |= digit << shift;
    rank -= higher;
    __syncwarp();                        // the bins are read before reuse
    if (in_bin == rank && shift > 0) {
      return least_candidate<N>(x, prefix, shift);
    }
  }
  return prefix;
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

// Row helpers shared by the hand-written Hopper (sm_90a) kernels: one warp
// owns one block-row of 128*NV4 floats, each lane NV4 float4 chunks (chunk
// i*32+lane, so every warp-wide load is 512 contiguous bytes), and per-row
// reductions are warp reductions (__reduce_*_sync) with no shared memory.
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

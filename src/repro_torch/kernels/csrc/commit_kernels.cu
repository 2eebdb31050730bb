// Hand-written Hopper (sm_90a) kernels for the federated commit path.
//
// Four kernels replace the four Pallas TPU kernels the sync FedAvg commit
// runs (file:function of the reference package, src/repro/kernels/):
//
//   fused_accum    <- fused_accum.py:fused_accum_blocks (_kernel)
//                     out = sum_i w_i * (1 + s_i)^(-a) * x_i over K slots
//   plain_commit   <- fused_quant_mask.py:plain_commit_blocks (_plain_kernel)
//                     per-slot per-block top-k -> per-slot per-block
//                     symmetric quantize -> discounted slot sum
//   quantize_rows  <- quantize.py:quantize_dequant_blocks (_kernel)
//                     per-row symmetric int{bits} quantize -> dequantize
//   topk_rows      <- topk_sparsify.py:topk_sparsify_blocks (_kernel)
//                     keep |x| >= the k-th largest |x| per row, ties kept
//
// Bound on an H100 SXM (3.35 TB/s HBM, 67 TFLOP/s f32): all four are bound
// by bytes.  Each reads its input once and writes its output once; the
// arithmetic per element (at most a 32-pass select, a division and a
// multiply-add) stays far under the card's rate.  At the CIFAR CNN's
// commit, a [20, 4671, 256] f32 stack (95.7 MB), fused_accum and
// plain_commit move ~100 MB (~30 us); a per-leaf quantize_rows/topk_rows
// call on dense1_w, [20*4096, 256], moves 2 x 83.9 MB (~50 us).
//
// Design for that bound.  The TPU kernels keep a whole [K, rows, block]
// tile in VMEM and walk rows on a sequential grid.  Here nothing carries
// across thread blocks, so:
//   * the row kernels give one warp to one block-row of 128*NV4 floats; each
//     lane holds NV4 float4 chunks (chunk i*32+lane, so every warp-wide load
//     is 512 contiguous bytes) in registers, and the per-row max, count and
//     select run as warp reductions (__reduce_*_sync) with no shared memory
//     and no __syncthreads (the helpers in row_ops.cuh, which
//     secure_commit.cu shares);
//   * plain_commit loops over the K slots inside the warp, so each slot's
//     row is read once and only the reduced row is written;
//   * fused_accum gives one float4 of the output to one thread and loops
//     over the K slots inside the thread;
//   * the discounted slot weights w_i * (1+s_i)^(-a) are computed once per
//     thread block into shared memory.
//
// Numerics match the plain PyTorch versions (kernels/ref.py): x / scale is
// an IEEE division (no reciprocal multiply, built without fast math),
// rintf rounds half to even like torch.round and jnp.round, a zero scale
// becomes 1, and q is clipped to [-qmax-1, qmax].  The top-k threshold is
// the exact k-th largest |x|, found by a 32-pass radix select on the uint32
// bit pattern of |x| (monotone for non-negative floats), so it equals the
// sort threshold bit for bit, ties kept.  The slot sums use fused
// multiply-adds, in slot order; that is the only difference from the
// plain versions.
//
// Every entry point launches on the caller's stream, allocates nothing,
// and returns cudaGetLastError() (or cudaErrorInvalidValue for a shape it
// does not take), which the Python wrapper turns into an exception.

#include "row_ops.cuh"

namespace {

constexpr int kMaxSlots = 12288;           // 48 KB of slot weights

// Discounted slot weights into shared memory; every thread of the block
// must reach this (it ends in __syncthreads).
__device__ __forceinline__ void slot_weights(float* weff,
                                             const float* __restrict__ w,
                                             const float* __restrict__ s,
                                             float a, int K) {
  for (int i = threadIdx.x; i < K; i += blockDim.x) {
    weff[i] = w[i] * powf(1.0f + s[i], -a);
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads)
fused_accum_kernel(const float4* __restrict__ x, const float* __restrict__ w,
                   const float* __restrict__ s, float a,
                   float4* __restrict__ out, int K, long long n4) {
  extern __shared__ float weff[];
  slot_weights(weff, w, s, a, K);
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (i >= n4) return;
  float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    const float4 v = x[static_cast<long long>(k) * n4 + i];
    const float c = weff[k];
    acc.x = fmaf(c, v.x, acc.x);
    acc.y = fmaf(c, v.y, acc.y);
    acc.z = fmaf(c, v.z, acc.z);
    acc.w = fmaf(c, v.w, acc.w);
  }
  out[i] = acc;
}

template <int NV4>
__global__ void __launch_bounds__(kThreads)
plain_commit_kernel(const float* __restrict__ x, const float* __restrict__ w,
                    const float* __restrict__ s, float a,
                    float* __restrict__ out, int K, long long R, int bits,
                    int k) {
  constexpr int N = 4 * NV4;
  constexpr long long B = 128 * NV4;
  extern __shared__ float weff[];
  slot_weights(weff, w, s, a, K);
  const int lane = threadIdx.x & 31;
  const long long row =
      static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (row >= R) return;  // warp-uniform: the whole warp leaves together
  const float qmax = bits ? qmax_for(bits) : 0.0f;
  float acc[N];
#pragma unroll
  for (int j = 0; j < N; ++j) acc[j] = 0.0f;
  for (int slot = 0; slot < K; ++slot) {
    float v[N];
    load_row<NV4>(x + (static_cast<long long>(slot) * R + row) * B, v, lane);
    if (k) topk_row<N>(v, k);
    if (bits) quantize_row<N>(v, qmax);
    const float c = weff[slot];
#pragma unroll
    for (int j = 0; j < N; ++j) acc[j] = fmaf(c, v[j], acc[j]);
  }
  store_row<NV4>(out + row * B, acc, lane);
}

template <int NV4>
__global__ void __launch_bounds__(kThreads)
quantize_rows_kernel(const float* __restrict__ x, float* __restrict__ y,
                     long long R, int bits) {
  constexpr int N = 4 * NV4;
  constexpr long long B = 128 * NV4;
  const int lane = threadIdx.x & 31;
  const long long row =
      static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (row >= R) return;
  float v[N];
  load_row<NV4>(x + row * B, v, lane);
  quantize_row<N>(v, qmax_for(bits));
  store_row<NV4>(y + row * B, v, lane);
}

template <int NV4>
__global__ void __launch_bounds__(kThreads)
topk_rows_kernel(const float* __restrict__ x, float* __restrict__ y,
                 long long R, int k) {
  constexpr int N = 4 * NV4;
  constexpr long long B = 128 * NV4;
  const int lane = threadIdx.x & 31;
  const long long row =
      static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (row >= R) return;
  float v[N];
  load_row<NV4>(x + row * B, v, lane);
  topk_row<N>(v, k);
  store_row<NV4>(y + row * B, v, lane);
}

template <int NV4>
void plain_commit_launch(const float* x, const float* w, const float* s,
                         float a, float* out, int K, long long R, int bits,
                         int k, cudaStream_t st) {
  plain_commit_kernel<NV4><<<row_blocks(R), kThreads, K * sizeof(float), st>>>(
      x, w, s, a, out, K, R, bits, k);
}

template <int NV4>
void quantize_rows_launch(const float* x, float* y, long long R, int bits,
                          cudaStream_t st) {
  quantize_rows_kernel<NV4><<<row_blocks(R), kThreads, 0, st>>>(x, y, R,
                                                                bits);
}

template <int NV4>
void topk_rows_launch(const float* x, float* y, long long R, int k,
                      cudaStream_t st) {
  topk_rows_kernel<NV4><<<row_blocks(R), kThreads, 0, st>>>(x, y, R, k);
}

}  // namespace

extern "C" {

const char* commit_kernels_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// x: [K, n] f32 (n % 4 == 0, 16-byte aligned), w, s: [K] f32 -> out: [n].
int fused_accum(const float* x, const float* w, const float* s, float a,
                float* out, int K, long long n, void* stream) {
  if (K < 1 || K > kMaxSlots || n < 4 || n % 4) return cudaErrorInvalidValue;
  const long long n4 = n / 4;
  const long long grid = (n4 + kThreads - 1) / kThreads;
  if (grid > 0x7fffffffLL) return cudaErrorInvalidValue;
  fused_accum_kernel<<<static_cast<unsigned>(grid), kThreads,
                       K * sizeof(float), static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(x), w, s, a,
      reinterpret_cast<float4*>(out), K, n4);
  return static_cast<int>(cudaGetLastError());
}

// x: [K, R, block] f32, w, s: [K] f32 -> out: [R, block]; bits in {0} or
// [2, 16]; 0 <= k <= block.
int plain_commit(const float* x, const float* w, const float* s, float a,
                 float* out, int K, long long R, int block, int bits, int k,
                 void* stream) {
  if (K < 1 || K > kMaxSlots || !rows_ok(R, block) || k < 0 || k > block ||
      (bits && (bits < 2 || bits > 16)))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (block) {
    case 128: plain_commit_launch<1>(x, w, s, a, out, K, R, bits, k, st); break;
    case 256: plain_commit_launch<2>(x, w, s, a, out, K, R, bits, k, st); break;
    case 512: plain_commit_launch<4>(x, w, s, a, out, K, R, bits, k, st); break;
    default: plain_commit_launch<8>(x, w, s, a, out, K, R, bits, k, st); break;
  }
  return static_cast<int>(cudaGetLastError());
}

// x, y: [R, block] f32; bits in [2, 16].
int quantize_rows(const float* x, float* y, long long R, int block, int bits,
                  void* stream) {
  if (!rows_ok(R, block) || bits < 2 || bits > 16) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (block) {
    case 128: quantize_rows_launch<1>(x, y, R, bits, st); break;
    case 256: quantize_rows_launch<2>(x, y, R, bits, st); break;
    case 512: quantize_rows_launch<4>(x, y, R, bits, st); break;
    default: quantize_rows_launch<8>(x, y, R, bits, st); break;
  }
  return static_cast<int>(cudaGetLastError());
}

// x, y: [R, block] f32; 1 <= k <= block.
int topk_rows(const float* x, float* y, long long R, int block, int k,
              void* stream) {
  if (!rows_ok(R, block) || k < 1 || k > block) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (block) {
    case 128: topk_rows_launch<1>(x, y, R, k, st); break;
    case 256: topk_rows_launch<2>(x, y, R, k, st); break;
    case 512: topk_rows_launch<4>(x, y, R, k, st); break;
    default: topk_rows_launch<8>(x, y, R, k, st); break;
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

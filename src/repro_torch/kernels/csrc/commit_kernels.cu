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
// fused_accum, designed for that bound on this card.  It is a pure stream:
// K slot rows in, one row out, two flops per float read, so the only aim is
// to keep the memory system full from the first cycle to the last.
//   * Persistent grid: the SM count times the blocks an SM holds at once
//     (cudaOccupancyMaxActiveBlocksPerMultiprocessor, queried once per
//     device and cached here), so every block is resident from the start and
//     there is no second, nearly empty wave.  Each block takes one
//     contiguous share of the float4 columns (shares differ by at most one
//     column) and its threads walk it with a stride of the block size, so
//     every warp-wide load is 512 contiguous bytes of one slot.
//   * Loads in flight: a thread issues the 16-byte loads of kAccumCols
//     columns for a group of kAccumGroup slots before it does their
//     multiply-adds (8 loads, 128 bytes, per thread; at 4 resident blocks
//     of 256 threads that is 128 KB per SM in flight, where 3.35 TB/s at
//     ~700 ns of latency needs ~18 KB).  The stack is read exactly once, so
//     loads and stores use the streaming (evict-first) cache hints, __ldcs
//     and __stcs.
//   * The discounted slot weights are computed once per block into shared
//     memory, with the block's first loads already issued before the
//     barrier.
// Each output's multiply-adds run in slot order, the plain version's order
// of summation (phase 3 of chip_smoke.py holds card against CPU to 1e-4).
//
// The row kernels (plain_commit, quantize_rows, topk_rows) give one warp to
// one block-row of 128*NV4 floats; each lane holds NV4 float4 chunks (chunk
// i*32+lane, so every warp-wide load is 512 contiguous bytes) in registers,
// and the per-row max, count and select run as warp reductions
// (__reduce_*_sync) with no shared memory and no __syncthreads (the helpers
// in row_ops.cuh).  plain_commit loops over the K slots inside the warp, so
// each slot's row is read once and only the reduced row is written, with
// the discounted slot weights computed once per thread block into shared
// memory.
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

constexpr int kAccumThreads = 256;
constexpr int kAccumCols = 2;              // float4 columns per thread
constexpr int kAccumGroup = 4;             // slots whose loads fly together
constexpr int kAccumMinBlocks = 4;         // resident blocks per SM (<= 64
//                                            registers a thread)
constexpr int kMaxDevices = 64;

// The loads of slots [k0, k0 + kAccumGroup) of columns c + j *
// kAccumThreads, each if its slot and its column (< end) exist.
__device__ __forceinline__ void accum_loads(
    float4 (&v)[kAccumGroup][kAccumCols], const float4* __restrict__ x,
    long long n4, int K, int k0, long long c, long long end) {
#pragma unroll
  for (int g = 0; g < kAccumGroup; ++g) {
#pragma unroll
    for (int j = 0; j < kAccumCols; ++j) {
      const long long col = c + static_cast<long long>(j) * kAccumThreads;
      if (k0 + g < K && col < end) {
        v[g][j] = __ldcs(x + static_cast<long long>(k0 + g) * n4 + col);
      }
    }
  }
}

__global__ void __launch_bounds__(kAccumThreads, kAccumMinBlocks)
fused_accum_kernel(const float4* __restrict__ x, const float* __restrict__ w,
                   const float* __restrict__ s, float a,
                   float4* __restrict__ out, int K, long long n4) {
  extern __shared__ float weff[];
  // this block's contiguous share of the columns
  const long long share = n4 / gridDim.x, left = n4 % gridDim.x;
  const long long b = blockIdx.x;
  const long long begin = b * share + (b < left ? b : left);
  const long long end = begin + share + (b < left ? 1 : 0);
  long long c = begin + threadIdx.x;
  float4 v[kAccumGroup][kAccumCols];
  accum_loads(v, x, n4, K, 0, c, end);       // in flight across the barrier
  for (int i = threadIdx.x; i < K; i += kAccumThreads) {
    weff[i] = w[i] * powf(1.0f + s[i], -a);
  }
  __syncthreads();
  constexpr long long kStep = static_cast<long long>(kAccumThreads) *
                              kAccumCols;
  while (c < end) {
    float4 acc[kAccumCols];
#pragma unroll
    for (int j = 0; j < kAccumCols; ++j) {
      acc[j] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
    for (int k0 = 0; k0 < K; k0 += kAccumGroup) {
      if (k0) accum_loads(v, x, n4, K, k0, c, end);
#pragma unroll
      for (int g = 0; g < kAccumGroup; ++g) {
        if (k0 + g < K) {
          const float wk = weff[k0 + g];
#pragma unroll
          for (int j = 0; j < kAccumCols; ++j) {
            acc[j].x = fmaf(wk, v[g][j].x, acc[j].x);
            acc[j].y = fmaf(wk, v[g][j].y, acc[j].y);
            acc[j].z = fmaf(wk, v[g][j].z, acc[j].z);
            acc[j].w = fmaf(wk, v[g][j].w, acc[j].w);
          }
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kAccumCols; ++j) {
      const long long col = c + static_cast<long long>(j) * kAccumThreads;
      if (col < end) __stcs(out + col, acc[j]);
    }
    c += kStep;
    if (c < end) accum_loads(v, x, n4, K, 0, c, end);
  }
}

// Blocks of fused_accum_kernel resident at once on the current device: SMs
// times blocks per SM, queried once per device (with the most slot weights'
// shared memory; registers hold it to kAccumMinBlocks all the same).
int accum_grid(int* grid) {
  static int cached[kMaxDevices];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev < kMaxDevices && cached[dev] > 0) {
    *grid = cached[dev];
    return 0;
  }
  int sms = 0, per_sm = 0;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, fused_accum_kernel, kAccumThreads,
        kMaxSlots * sizeof(float));
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  *grid = sms * (per_sm > 0 ? per_sm : 1);
  if (dev < kMaxDevices) cached[dev] = *grid;
  return 0;
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
  int grid = 0;
  const int err = accum_grid(&grid);
  if (err) return err;
  const long long n4 = n / 4;
  const long long needed = (n4 + kAccumThreads - 1) / kAccumThreads;
  if (needed < grid) grid = static_cast<int>(needed);
  fused_accum_kernel<<<grid, kAccumThreads, K * sizeof(float),
                       static_cast<cudaStream_t>(stream)>>>(
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

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
// arithmetic per element (a share of one exact select, a division or its
// exact reciprocal form, a multiply-add) stays under the card's rate.  At
// the CIFAR CNN's commit, a [20, 4671, 256] f32 stack (95.7 MB),
// fused_accum and plain_commit move ~100 MB (~30 us); a per-leaf
// quantize_rows/topk_rows call on dense1_w, [20*4096, 256], moves
// 2 x 83.9 MB (~50 us).
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
//     barrier.  Shared memory holds the first kStagedWeights of them (48
//     KB); a slot past those takes its weight from w and s in device
//     memory, computed by the same expression, so K has no limit and every
//     weight is the same float either way.
// Each output's multiply-adds run in slot order, the plain version's order
// of summation (phase 3 of chip_smoke.py holds card against CPU to 1e-4).
//
// The row kernels give one warp to one block-row of 128*NV4 floats; each
// lane holds NV4 float4 chunks (chunk i*32+lane, so every warp-wide load is
// 512 contiguous bytes), and the per-row max and count run as warp
// reductions (the helpers in row_ops.cuh).  quantize_rows is the plain
// form: one warp per row, load, max, quantize, store.
//
// topk_rows and plain_commit spend their arithmetic in the exact top-k
// select, digit_select (row_ops.cuh): the top exponent digit by a walk of
// warp reductions, one bit at a time while more than 32 candidates are
// left, then the last candidates ranked against each other in 32 words of
// shared memory (fused multiply-adds on the FP32 pipe).  A 256-wide row
// costs a few hundred instructions, most of them on the integer pipe,
// which runs at half the FP32 rate; the 32-pass select it replaces cost
// about three times as many.
//   * topk_rows: one warp per row, as many warps as rows (the small leaves'
//     grids clamp themselves), loads and stores with the streaming hints
//     (__ldcs/__stcs), signs kept as a bit mask so that 40 warps fit on an
//     SM.  The selects' instructions overlap the other warps' loads: it is
//     bound by bytes.  A persistent grid whose warps walk many rows with
//     the next row's loads in flight measured slower on an H100, for the
//     select and for a plain copy alike, so the simple grid stays.
//   * plain_commit: one thread block of kCommitWarps warps per block-row
//     (at K = 20, four slots a warp).  Every warp stages its slots' rows in
//     shared memory with cp.async, all copies in flight at once, so each
//     slot is read from device memory once; then each warp runs select,
//     scale and quantize per slot in place, and after one barrier each
//     thread adds its columns over the K quantized rows in slot order with
//     fmaf, so the output is bit for bit that of one thread summing the
//     slots in order.  The scale needs no threshold: top-k keeps the row's
//     largest |x|, so the max over the kept entries is the row max.
//     q = rint(x / scale) uses the correctly rounded reciprocal and falls
//     back to the IEEE division where the product could round differently
//     (quantize_kept).  Slots beyond kCommitStageBytes of staging are taken
//     in further chunks, each with its own slot weights, their running sums
//     kept in shared memory, so K has no limit and the slot order of the
//     sum is the same for every K.  It is
//     bound by the selects' integer instructions, not by bytes: the run
//     with k = 0 moves the same bytes in about half the time.
//
// Numerics match the plain PyTorch versions (kernels/ref.py): x / scale is
// the IEEE quotient (built without fast math), rintf rounds half to even
// like torch.round and jnp.round, a zero scale becomes 1, and q is clipped
// to [-qmax-1, qmax].  The top-k threshold is the exact k-th largest |x| as
// a uint32 bit pattern (monotone for non-negative floats), so it equals the
// sort threshold bit for bit, ties kept.  The slot sums use fused
// multiply-adds, in slot order; that is the only difference from the plain
// versions.
//
// Every entry point launches on the caller's stream, allocates nothing,
// and returns cudaGetLastError() (or cudaErrorInvalidValue for a shape it
// does not take), which the Python wrapper turns into an exception.

#include "row_ops.cuh"

namespace {

constexpr int kStagedWeights = 12288;      // 48 KB of slot weights

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

// Slot k's discounted weight: staged in shared memory for the first
// kStagedWeights slots, computed from device memory past them.
__device__ __forceinline__ float accum_weight(const float* weff,
                                              const float* __restrict__ w,
                                              const float* __restrict__ s,
                                              float a, int k) {
  if (k < kStagedWeights) return weff[k];
  return __ldg(w + k) * powf(1.0f + __ldg(s + k), -a);
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
  const int staged = K < kStagedWeights ? K : kStagedWeights;
  for (int i = threadIdx.x; i < staged; i += kAccumThreads) {
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
          const float wk = accum_weight(weff, w, s, a, k0 + g);
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
        kStagedWeights * sizeof(float));
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  *grid = sms * (per_sm > 0 ? per_sm : 1);
  if (dev < kMaxDevices) cached[dev] = *grid;
  return 0;
}

// plain_commit: one thread block of kCommitWarps warps per block-row; its
// slot rows are staged in chunks of kCommitStageBytes (at K = 20 and block
// 256, all 20 in one chunk, 4 per warp).
constexpr int kCommitWarps = 5;
constexpr int kCommitThreads = 32 * kCommitWarps;
constexpr int kCommitStageBytes = 32768;

template <int NV4>
constexpr int commit_min_blocks() {        // 40 warps an SM at block <= 256
  return NV4 <= 2 ? 8 : NV4 == 4 ? 5 : 3;
}

// Slots staged per chunk, and the dynamic shared memory: per warp 32 words
// of select scratch, the staged rows, the chunk's slot weights, and the
// running sums when the slots take several chunks.
inline int commit_chunk(int K, int block) {
  const int S = kCommitStageBytes / (block * 4);
  return K < S ? K : S;
}

inline size_t commit_smem(int K, int block) {
  const int S = commit_chunk(K, block);
  return sizeof(float) * (kCommitWarps * 32 + static_cast<size_t>(S) * block +
                          S + (S < K ? block : 0));
}

// Symmetric quantize -> dequantize of a staged slot row, its entries below
// the top-k threshold t zeroed first; top is the row's largest |x| pattern,
// which is also the largest kept one.  q = rint(y / scale), with the
// division replaced by a product with the correctly rounded reciprocal:
// r = y * (1/scale) is within |r| 2^-22 of the IEEE quotient d (each of the
// reciprocal, the product and the quotient rounds once, 2^-24 relative),
// so where r lies farther than |r| 2^-20 from every half-integer, rint(d)
// equals rint(r) exactly.  Where some lane's entry lies closer, or scale is
// not a normal finite float, the warp divides (__fdiv_rn) instead.
template <int N>
__device__ __forceinline__ void quantize_kept(float (&v)[N],
                                              const unsigned (&u)[N],
                                              unsigned t, unsigned top,
                                              float qmax) {
  float scale = __fdiv_rn(__uint_as_float(top), qmax);
  if (scale == 0.0f) scale = 1.0f;
  const float inv = __frcp_rn(scale);
  bool near = !(scale >= 0x1p-126f && scale <= 0x1.fffffep127f);
  float q[N];
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const float r = __fmul_rn(u[j] >= t ? v[j] : 0.0f, inv);
    q[j] = rintf(r);
    near |= __fsub_rn(0.5f, fabsf(__fsub_rn(r, q[j]))) <=
            __fmul_rn(fabsf(r), 0x1p-20f);
  }
  if (__any_sync(kFull, near)) {
#pragma unroll
    for (int j = 0; j < N; ++j) {
      q[j] = rintf(__fdiv_rn(u[j] >= t ? v[j] : 0.0f, scale));
    }
  }
#pragma unroll
  for (int j = 0; j < N; ++j) {
    v[j] = __fmul_rn(fminf(fmaxf(q[j], -qmax - 1.0f), qmax), scale);
  }
}

// Top-k and quantize one staged slot row in place.
template <int NV4>
__device__ __forceinline__ void commit_row(float* row, int k, int bits,
                                           float qmax, unsigned* scratch,
                                           int lane) {
  constexpr int N = 4 * NV4;
  unsigned u[N];
  {
    float v[N];
    shared_row<NV4>(row, v, lane);
#pragma unroll
    for (int j = 0; j < N; ++j) u[j] = abs_bits(v[j]);
  }
  const unsigned top = row_max<N>(u);
  const unsigned t = k ? digit_select<N>(u, top, k, scratch) : 0u;
  float v[N];
  shared_row<NV4>(row, v, lane);
  if (bits) {
    quantize_kept<N>(v, u, t, top, qmax);
  } else {
#pragma unroll
    for (int j = 0; j < N; ++j) {
      if (u[j] < t) v[j] = 0.0f;
    }
  }
#pragma unroll
  for (int i = 0; i < NV4; ++i) {
    reinterpret_cast<float4*>(row)[i * 32 + lane] =
        make_float4(v[4 * i], v[4 * i + 1], v[4 * i + 2], v[4 * i + 3]);
  }
}

// Per chunk of S slots: every warp stages its slot rows (slots warp, warp
// + kCommitWarps, ...) with cp.async, all in flight at once, and the block
// computes the chunk's slot weights; each warp then runs top-k and quantize
// on its rows in place; after one barrier each thread adds its columns'
// quantized values in slot order with fmaf, carried across chunks in
// shared memory.
template <int NV4>
__global__ void __launch_bounds__(kCommitThreads, commit_min_blocks<NV4>())
plain_commit_kernel(const float* __restrict__ x, const float* __restrict__ w,
                    const float* __restrict__ s, float a,
                    float* __restrict__ out, int K, long long R, int bits,
                    int k, int S) {
  constexpr int B = 128 * NV4;
  extern __shared__ __align__(16) float smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  unsigned* scratch = reinterpret_cast<unsigned*>(smem) + warp * 32;
  float* stage = smem + kCommitWarps * 32;
  float* weff = stage + S * B;
  float* part = weff + S;
  const long long row = blockIdx.x;
  const float qmax = bits ? qmax_for(bits) : 0.0f;
  for (int s0 = 0; s0 < K; s0 += S) {
    const int sn = min(S, K - s0);
    for (int i = warp; i < sn; i += kCommitWarps) {
      stage_row<NV4>(stage + i * B,
                     x + (static_cast<long long>(s0 + i) * R + row) * B, lane);
    }
    for (int i = threadIdx.x; i < sn; i += kCommitThreads) {
      weff[i] = w[s0 + i] * powf(1.0f + s[s0 + i], -a);
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    if (k || bits) {
      for (int i = warp; i < sn; i += kCommitWarps) {
        commit_row<NV4>(stage + i * B, k, bits, qmax, scratch, lane);
      }
    }
    __syncthreads();
    const bool last = s0 + sn >= K;
    for (int e = threadIdx.x; e < B; e += kCommitThreads) {
      float acc = s0 ? part[e] : 0.0f;
      for (int j = 0; j < sn; ++j) acc = fmaf(weff[j], stage[j * B + e], acc);
      if (last) {
        __stcs(out + row * B + e, acc);
      } else {
        part[e] = acc;
      }
    }
    if (!last) __syncthreads();
  }
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

// One warp per block-row, as many warps as rows: streaming loads and
// stores around digit_select.
template <int NV4>
constexpr int topk_min_blocks() {          // 40 warps an SM at block <= 256
  return NV4 <= 2 ? 5 : NV4 == 4 ? 3 : 2;
}

template <int NV4>
__global__ void __launch_bounds__(kThreads, topk_min_blocks<NV4>())
topk_rows_kernel(const float* __restrict__ x, float* __restrict__ y,
                 long long R, int k) {
  constexpr int N = 4 * NV4;
  constexpr long long B = 128 * NV4;
  __shared__ __align__(16) unsigned scratch[kWarps][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long row = static_cast<long long>(blockIdx.x) * kWarps + warp;
  if (row >= R) return;  // warp-uniform: the whole warp leaves together
  const float4* src = reinterpret_cast<const float4*>(x + row * B);
  unsigned u[N], sign = 0;                  // |x| patterns and sign bits
#pragma unroll
  for (int i = 0; i < NV4; ++i) {
    const float4 q = __ldcs(src + i * 32 + lane);
    const float f[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      u[4 * i + e] = abs_bits(f[e]);
      sign |= (__float_as_uint(f[e]) >> 31) << (4 * i + e);
    }
  }
  const unsigned t = digit_select<N>(u, row_max<N>(u), k, scratch[warp]);
  float4* dst = reinterpret_cast<float4*>(y + row * B);
#pragma unroll
  for (int i = 0; i < NV4; ++i) {
    float f[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int j = 4 * i + e;
      f[e] = u[j] >= t ? __uint_as_float(u[j] | (sign >> j << 31)) : 0.0f;
    }
    __stcs(dst + i * 32 + lane, make_float4(f[0], f[1], f[2], f[3]));
  }
}

template <int NV4>
int plain_commit_launch(const float* x, const float* w, const float* s,
                        float a, float* out, int K, long long R, int bits,
                        int k, cudaStream_t st) {
  constexpr int B = 128 * NV4;
  if (R > 0x7fffffffLL) return cudaErrorInvalidValue;
  plain_commit_kernel<NV4>
      <<<static_cast<unsigned>(R), kCommitThreads, commit_smem(K, B), st>>>(
          x, w, s, a, out, K, R, bits, k, commit_chunk(K, B));
  return 0;
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
  if (K < 1 || n < 4 || n % 4) return cudaErrorInvalidValue;
  int grid = 0;
  const int err = accum_grid(&grid);
  if (err) return err;
  const long long n4 = n / 4;
  const long long needed = (n4 + kAccumThreads - 1) / kAccumThreads;
  if (needed < grid) grid = static_cast<int>(needed);
  const int staged = K < kStagedWeights ? K : kStagedWeights;
  fused_accum_kernel<<<grid, kAccumThreads, staged * sizeof(float),
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
  if (K < 1 || !rows_ok(R, block) || k < 0 || k > block ||
      (bits && (bits < 2 || bits > 16)))
    return cudaErrorInvalidValue;
  const auto launch = block == 128   ? plain_commit_launch<1>
                      : block == 256 ? plain_commit_launch<2>
                      : block == 512 ? plain_commit_launch<4>
                                     : plain_commit_launch<8>;
  const int err = launch(x, w, s, a, out, K, R, bits, k,
                         static_cast<cudaStream_t>(stream));
  return err ? err : static_cast<int>(cudaGetLastError());
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

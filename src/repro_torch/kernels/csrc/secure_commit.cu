// Hand-written Hopper (sm_90a) kernel: the integer-domain secure commit.
//
// Replaces the Pallas kernel src/repro/kernels/fused_quant_mask.py:
// secure_commit_blocks (body _secure_kernel, PRF hash_u32/mask_total_u32).
// Over a blocked [K, R, block] f32 stack of K client slots:
//   1. per-slot per-row top-k: keep |x| >= the k-th largest, ties kept;
//   2. y = w_i * x;
//   3. ONE commit-common scale per row, max over slots and lanes |y| / qmax
//      (a zero scale becomes 1), so that every slot quantizes onto one grid;
//   4. q = clip(rint(y / scale)) as int32, or floor(y / scale + u) with a
//      uniform [0, 1) noise operand (stochastic rounding);
//   5. slot i's wire word q_i + sum_j coef[i,j] * hash_u32(idx * 0x9E3779B9
//      + seeds[i,j]) in uint32 that wraps, idx = base + r * block + c the
//      global element index, or base + rows[r] * block + c with a row table
//      (the rows of a share of the whole bucket: each row's global
//      block-row index, so that a split commit keeps every element's
//      unsplit mask word);
//   6. the wire words summed over slots, read as int32, times the scale.
// Output [R, block] f32.
//
// Bound on an H100 SXM.  Bytes: the stack is read once and the rows written
// once, ~100 MB at the CIFAR CNN's [20, 4671, 256] commit (~30 us at
// 3.35 TB/s; stochastic rounding adds the same again for the noise, a row
// table 4 bytes a row).
// Integer operations: a PRF word costs 10 (the seed add, three shift-xor
// pairs, two multiplies, the coefficient multiply-add; idx*G once per
// element).  The function needs one word per seed whose coefficients do
// not sum to 0 mod 2^32: with the main path's cancelling coefficients none,
// and the bound is the bytes; with the upper triangle alone at K=20, 190
// words, ~2.3e9 operations, ~0.07 ms at 33.4e12 integer operations/s (4 x
// 32 lanes dispatched per SM per clock x 132 SMs x 1.98 GHz).
//
// Design for that bound.
//   * Fold the mask words before the element loop (secure_fold_kernel on
//     the same stream, a grid over the K^2 entries with one atomic per
//     warp for the count, which a memset zeroes first).  The [K, K] pair
//     entries become a
//     compact list of (seed, net coefficient) words whose net is nonzero
//     mod 2^32: a diagonal entry stands alone; (i, j) and (j, i), i < j,
//     merge when their seeds are equal; every other entry stays separate.
//     Exact for any seeds and coefficients, since words with equal seeds
//     are equal and the wrapped sum does not depend on order (the plain
//     version is kernels/ref.py fold_mask_words).  On the main path the
//     list is empty; the upper triangle gives K(K-1)/2 words.  The list
//     holds at most K^2 words (all seeds distinct, no coefficient zero), so
//     the wrapper gives it 1 + 2 K^2 words of scratch: 134 MB at K = 4096,
//     beside the 134 MB of int64 seeds the caller already holds.  The
//     commit kernel reads the count from device memory: no host sync.
//   * One thread block per block-row, kSecureWarps warps; warp w takes the
//     slots w, w + kSecureWarps, ...  Each warp first stages its slots'
//     rows in shared memory with cp.async (all copies in flight at once,
//     no registers held), so every slot is read from device memory once
//     and the kernel needs few registers: 4-5 blocks (32-40 warps) fit on
//     an SM.  Where a warp has
//     more slots than kStageBytes of shared memory holds, it reads the rest
//     from memory again in the second phase and stays correct.
//   * The scale needs no threshold: top-k keeps each slot's largest |x|,
//     and |w x| rounds monotonically in |x|, so the max of |w x| over the
//     kept entries equals the max over all entries, exactly.  Each warp
//     takes its slots' max while it runs their selects; the block reduces
//     the warps' maxima in shared memory at one barrier.
//   * The exact k-th largest |x| per slot: digit_select (row_ops.cuh),
//     the top 8-bit digit by warp reductions over the few exponents
//     present, then at most 32 candidates ranked against each other in
//     shared memory (8-bit histogram passes first where more share the top
//     digit).  A warp keeps its slots' thresholds from phase 1 to phase 2
//     in the [R, K] scratch array in device memory that the wrapper passes
//     (4 bytes per slot per block-row, 1/block of the stack), so K has no
//     limit.
//   * Each warp then quantizes its own slots onto the common grid (the
//     noise row, with stochastic rounding, read once beside its slot) and
//     adds its share of the folded mask words (word p goes to warp p mod
//     kSecureWarps); idx * 0x9E3779B9 is computed once per element.  The
//     warps' uint32 partial sums reduce in shared memory: they wrap, so the
//     order does not matter and the result stays bit-exact.
//
// Numerics equal the plain version (kernels/ref.py fused_secure_commit_ref)
// bit for bit: IEEE division (__fdiv_rn), rintf (half to even), the exact
// k-th largest |x|, integer sums that are order-free under wraparound.
//
// The entry points launch on the caller's stream, allocate nothing (the
// wrapper passes the word list's memory), and return cudaGetLastError()
// (or cudaErrorInvalidValue for a shape they do not take), which the Python
// wrapper turns into an exception.

#include "row_ops.cuh"

namespace {

constexpr int kSecureWarps = 8;
constexpr int kSecureThreads = 32 * kSecureWarps;
constexpr int kFoldThreads = 256;
constexpr int kFoldMaxBlocks = 1024;
// The word count is one uint32 and the list holds up to K^2 words, so K^2
// must stay below 2^32; the [K, K] int64 seeds alone are 34 GB there.
constexpr int kMaxPairSlots = 65535;
constexpr int kSecureMinBlocks = 4;  // resident blocks per SM (<= 64
//                                      registers a thread)
constexpr int kStageBytes = 32768;   // shared memory for staged slot rows
constexpr unsigned kGolden = 0x9E3779B9u;

// "lowbias32"-style avalanche hash, uint32 -> uint32.
__device__ __forceinline__ unsigned hash_u32(unsigned x) {
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x;
}

// words[0] += n, then n (seed, net coefficient) pairs after the words
// already there: the mask words of the [K, K] seeds (the low 32 bits of each
// int64) and coefficients that do not cancel.  words[0] must be 0 at the
// launch.  Each warp walks 32 consecutive entries at a time and takes its
// words' places with one atomic; the order of the words is not fixed.
__global__ void __launch_bounds__(kFoldThreads)
secure_fold_kernel(const long long* __restrict__ seeds,
                   const int* __restrict__ coef, int K,
                   unsigned* __restrict__ words) {
  const int lane = threadIdx.x & 31;
  const long long n = static_cast<long long>(K) * K;
  const long long stride = static_cast<long long>(gridDim.x) * kFoldThreads;
  for (long long e0 = static_cast<long long>(blockIdx.x) * kFoldThreads +
                      (threadIdx.x & ~31);
       e0 < n; e0 += stride) {                 // warp-uniform
    const long long e = e0 + lane;
    unsigned s = 0, c = 0;
    if (e < n) {
      const long long i = e / K, j = e % K;
      s = static_cast<unsigned>(seeds[e]);
      c = static_cast<unsigned>(coef[e]);
      if (i != j && s == static_cast<unsigned>(seeds[j * K + i])) {
        // merged into (j, i) when i > j
        c = i > j ? 0u : c + static_cast<unsigned>(coef[j * K + i]);
      }
    }
    const unsigned emit = __ballot_sync(kFull, c != 0u);
    if (!emit) continue;
    unsigned p0 = 0;
    if (lane == 0) p0 = atomicAdd(words, static_cast<unsigned>(__popc(emit)));
    p0 = __shfl_sync(kFull, p0, 0);
    if (c) {
      const size_t p = p0 + __popc(emit & ((1u << lane) - 1u));
      words[1 + 2 * p] = s;
      words[2 + 2 * p] = c;
    }
  }
}

// Zero the count, then fold: both on the caller's stream.
int fold_launch(const long long* seeds, const int* coef, int K,
                unsigned* words, cudaStream_t st) {
  cudaError_t e = cudaMemsetAsync(words, 0, sizeof(unsigned), st);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long n = static_cast<long long>(K) * K;
  const long long need = (n + kFoldThreads - 1) / kFoldThreads;
  const int grid = need < kFoldMaxBlocks ? static_cast<int>(need)
                                         : kFoldMaxBlocks;
  secure_fold_kernel<<<grid, kFoldThreads, 0, st>>>(seeds, coef, K, words);
  return 0;
}

// Quantize one slot's row onto the common grid and add it to acc.
template <int N>
__device__ __forceinline__ void quantize_add(const float (&v)[N],
                                             const float* __restrict__ u_row,
                                             unsigned t, float c, float scale,
                                             float qmax, unsigned (&acc)[N],
                                             int lane) {
  float u[N];
  if (u_row) load_row<N / 4>(u_row, u, lane);
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const float y = abs_bits(v[j]) >= t ? __fmul_rn(v[j], c) : 0.0f;
    const float r = __fdiv_rn(y, scale);
    float q = u_row ? floorf(__fadd_rn(r, u[j])) : rintf(r);
    q = fminf(fmaxf(q, -qmax - 1.0f), qmax);
    acc[j] += static_cast<unsigned>(static_cast<int>(q));
  }
}

// Slots per warp staged in shared memory: all of the warp's slots, up to
// kStageBytes for the block.
inline int staged_slots(int K, int block) {
  const int per_warp = (K + kSecureWarps - 1) / kSecureWarps;
  const int fit = kStageBytes / (kSecureWarps * block * 4);
  return per_warp < fit ? per_warp : fit;
}

// One thread block per block-row.  Dynamic shared memory: kSecureWarps x
// ``staged`` rows of slot values, warp w's first; after its quantize a warp
// reuses the start of its own area for its partial sums.
template <int NV4>
__global__ void __launch_bounds__(kSecureThreads, kSecureMinBlocks)
secure_commit_kernel(const float* __restrict__ x, const float* __restrict__ w,
                     const unsigned* __restrict__ words, unsigned base,
                     const unsigned* __restrict__ rows,
                     const float* __restrict__ noise,
                     unsigned* __restrict__ thresh, float* __restrict__ out,
                     int K, long long R, int bits, int k, int staged) {
  constexpr int N = 4 * NV4;                 // floats a lane holds of a row
  constexpr int B = 128 * NV4;
  extern __shared__ __align__(16) float stage[];
  __shared__ __align__(16) unsigned scratch[kSecureWarps][32];
  __shared__ float wmax[kSecureWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long row = blockIdx.x;
  thresh += row * K;     // each slot's top-k threshold, phase 1 to phase 2
  const float* xrow = x + row * B;           // slot i's row: xrow + i * R * B
  const long long slot_stride = R * B;
  float* mine = stage + warp * staged * B;   // this warp's staged rows
  const float qmax = qmax_for(bits);

  // phase 1: stage this warp's slots (all copies in flight at once), then
  // each slot's threshold and the max of |w x|
  for (int i = 0; i < staged; ++i) {
    const int slot = warp + i * kSecureWarps;
    if (slot < K) stage_row<NV4>(mine + i * B, xrow + slot * slot_stride, lane);
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  float m = 0.0f;
  for (int slot = warp, i = 0; slot < K; slot += kSecureWarps, ++i) {
    float v[N];
    if (i < staged) {
      shared_row<NV4>(mine + i * B, v, lane);
    } else {
      load_row<NV4>(xrow + slot * slot_stride, v, lane);
    }
    const float c = __ldg(w + slot);
#pragma unroll
    for (int j = 0; j < N; ++j) m = fmaxf(m, fabsf(__fmul_rn(v[j], c)));
    if (k) {
      unsigned u[N];
#pragma unroll
      for (int j = 0; j < N; ++j) u[j] = abs_bits(v[j]);
      const unsigned t = digit_select<N>(u, row_max<N>(u), k, scratch[warp]);
      if (lane == 0) thresh[slot] = t;
    } else if (lane == 0) {
      thresh[slot] = 0u;
    }
  }
  m = warp_max_nonneg(m);
  if (lane == 0) wmax[warp] = m;
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kSecureWarps; ++i) m = fmaxf(m, wmax[i]);
  float scale = __fdiv_rn(m, qmax);
  if (scale == 0.0f) scale = 1.0f;

  // phase 2: this warp's slots onto the common grid, and its mask words
  unsigned acc[N];
#pragma unroll
  for (int j = 0; j < N; ++j) acc[j] = 0u;
  for (int slot = warp, i = 0; slot < K; slot += kSecureWarps, ++i) {
    float v[N];
    if (i < staged) {
      shared_row<NV4>(mine + i * B, v, lane);
    } else {
      load_row<NV4>(xrow + slot * slot_stride, v, lane);
    }
    quantize_add<N>(v, noise ? noise + slot * slot_stride + row * B : nullptr,
                    thresh[slot], __ldg(w + slot), scale, qmax, acc, lane);
  }
  const unsigned n_words = words[0];
  if (static_cast<unsigned>(warp) < n_words) {
    unsigned ig[N];                          // idx * golden, per element
    const unsigned grow = rows ? __ldg(rows + row)
                               : static_cast<unsigned>(row);
    const unsigned row0 = base + grow * static_cast<unsigned>(B);
#pragma unroll
    for (int i = 0; i < NV4; ++i) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const unsigned col = 4u * static_cast<unsigned>(i * 32 + lane) + e;
        ig[4 * i + e] = (row0 + col) * kGolden;
      }
    }
    for (unsigned p = warp; p < n_words; p += kSecureWarps) {
      const unsigned s = words[1 + 2 * size_t{p}];
      const unsigned cu = words[2 + 2 * size_t{p}];
#pragma unroll
      for (int j = 0; j < N; ++j) acc[j] += cu * hash_u32(ig[j] + s);
    }
  }

  // phase 3: the warps' partial sums, wrapped, then dequantized
  __syncwarp();                  // this warp's staged rows are all read
  unsigned* part = reinterpret_cast<unsigned*>(stage);    // [warp][staged*B]
#pragma unroll
  for (int i = 0; i < NV4; ++i) {
    reinterpret_cast<uint4*>(part + warp * staged * B)[i * 32 + lane] =
        make_uint4(acc[4 * i], acc[4 * i + 1], acc[4 * i + 2], acc[4 * i + 3]);
  }
  __syncthreads();
  for (int e = threadIdx.x; e < B; e += kSecureThreads) {
    unsigned total = 0;
#pragma unroll
    for (int i = 0; i < kSecureWarps; ++i) total += part[i * staged * B + e];
    out[row * B + e] =
        __fmul_rn(static_cast<float>(static_cast<int>(total)), scale);
  }
}

template <int NV4>
void secure_commit_launch(const float* x, const float* w,
                          const unsigned* words, unsigned base,
                          const unsigned* rows, const float* noise,
                          unsigned* thresh, float* out, int K, long long R,
                          int bits, int k, cudaStream_t st) {
  const int staged = staged_slots(K, 128 * NV4);
  secure_commit_kernel<NV4>
      <<<static_cast<unsigned>(R), kSecureThreads,
         kSecureWarps * staged * 128 * NV4 * sizeof(float), st>>>(
          x, w, words, base, rows, noise, thresh, out, K, R, bits, k, staged);
}

}  // namespace

extern "C" {

const char* secure_commit_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// seeds: [K, K] int64 (the low 32 bits are the uint32 seed); coef: [K, K]
// int32; words: 1 + 2 K^2 uint32, filled with the count and the (seed, net
// coefficient) words that do not cancel.
int secure_fold(const long long* seeds, const int* coef, unsigned* words,
                int K, void* stream) {
  if (K < 1 || K > kMaxPairSlots) return cudaErrorInvalidValue;
  const int err = fold_launch(seeds, coef, K, words,
                              static_cast<cudaStream_t>(stream));
  return err ? err : static_cast<int>(cudaGetLastError());
}

// x: [K, R, block] f32; w: [K] f32 effective slot weights; seeds: [K, K]
// int64 holding uint32; coef: [K, K] int32; base: the global element index
// of row 0; rows: [R] uint32, each row's global block-row index, or null
// (row r at base + r * block); noise: [K, R, block] f32 uniform [0, 1) or
// null (round half to even); words: 1 + 2 K^2 uint32 of scratch for the
// folded mask words; thresh: [R, K] uint32 of scratch for the per-slot
// thresholds; out: [R, block] f32.  bits in [2, 16]; 0 <= k <= block (0:
// no top-k).
int secure_commit(const float* x, const float* w, const long long* seeds,
                  const int* coef, unsigned base, const unsigned* rows,
                  const float* noise, unsigned* words, unsigned* thresh,
                  float* out, int K, long long R, int block, int bits, int k,
                  void* stream) {
  if (K < 1 || K > kMaxPairSlots || R < 1 || R > 0x7fffffffLL || k < 0 ||
      k > block || bits < 2 || bits > 16 ||
      (block != 128 && block != 256 && block != 512 && block != 1024))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int err = fold_launch(seeds, coef, K, words, st);
  if (err) return err;
  switch (block) {
    case 128:
      secure_commit_launch<1>(x, w, words, base, rows, noise, thresh, out,
                              K, R, bits, k, st);
      break;
    case 256:
      secure_commit_launch<2>(x, w, words, base, rows, noise, thresh, out,
                              K, R, bits, k, st);
      break;
    case 512:
      secure_commit_launch<4>(x, w, words, base, rows, noise, thresh, out,
                              K, R, bits, k, st);
      break;
    default:
      secure_commit_launch<8>(x, w, words, base, rows, noise, thresh, out,
                              K, R, bits, k, st);
      break;
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

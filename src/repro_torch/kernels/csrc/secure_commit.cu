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
//      global element index;
//   6. the wire words summed over slots, read as int32, times the scale.
// Output [R, block] f32.  The masks cancel in the sum exactly when coef is
// antisymmetric and seeds symmetric; the kernel does not rely on it and is
// right for any coef (chip_smoke.py holds it against the plain version with
// coefficients that do not cancel).
//
// Bound on an H100 SXM.  Bytes: the stack is read once and the rows written
// once, ~100 MB at the CIFAR CNN's [20, 4671, 256] commit (~30 us at
// 3.35 TB/s; stochastic rounding adds the same again for the noise).
// Integer operations: a PRF word costs 10 (the seed add, three shift-xor
// pairs, two multiplies, the coefficient multiply-add; idx*G once per
// element).  The function needs one word per distinct seed whose
// coefficients do not sum to 0: under symmetric seeds, one per pair with
// c_ij + c_ji != 0.  With cancelling coefficients that is none, and the
// bound is the bytes; with the upper triangle alone at K=20 it is 190
// words, ~2.3e9 operations, ~0.07 ms at 33.4e12 integer operations/s (4 x
// 32 lanes dispatched per SM per clock x 132 SMs x 1.98 GHz).  This kernel
// computes one word per nonzero coefficient of each slot, as each client
// would mask its own upload: 2x the pairs' words, or 342 words per element
// that cancel on the main path (one slot out of 20).
//
// Design for that bound (simple and right first).  One warp per block-row
// (row_ops.cuh), looping over the K slots inside the warp.  The common
// scale needs every slot of a row before any slot quantizes, so the row is
// read twice (20 KB at K=20, the second read mostly from L2): pass 1 runs
// the exact radix select per slot and keeps its threshold in shared memory
// (K words per warp), and takes the max |y|; pass 2 re-reads each slot,
// applies its stored threshold (no second select), quantizes, and adds the
// slot's wire word.  idx * 0x9E3779B9 is computed once per element; a zero
// coefficient costs nothing (0 * word = 0 exactly, the diagonal and every
// pair touching a non-participant).  uint32 multiplies wrap by definition;
// a coefficient enters as its two's-complement uint32.
//
// Numerics equal the plain version (kernels/ref.py fused_secure_commit_ref)
// bit for bit: IEEE division (__fdiv_rn), rintf (half to even), the exact
// k-th largest |x|, integer sums that are order-free under wraparound.
//
// The entry point launches on the caller's stream, allocates nothing, and
// returns cudaGetLastError() (or cudaErrorInvalidValue for a shape it does
// not take), which the Python wrapper turns into an exception.

#include "row_ops.cuh"

namespace {

constexpr int kMaxSecureSlots = 1024;      // 32 KB of thresholds per block
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

template <int NV4>
__global__ void __launch_bounds__(kThreads)
secure_commit_kernel(const float* __restrict__ x, const float* __restrict__ w,
                     const unsigned* __restrict__ seeds,
                     const int* __restrict__ coef, unsigned base,
                     const float* __restrict__ noise, float* __restrict__ out,
                     int K, long long R, int bits, int k) {
  constexpr int N = 4 * NV4;
  constexpr long long B = 128 * NV4;
  extern __shared__ unsigned thresh_all[];     // [kWarps][K]
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long row = static_cast<long long>(blockIdx.x) * kWarps + warp;
  if (row >= R) return;  // warp-uniform: the whole warp leaves together
  unsigned* thresh = thresh_all + warp * K;
  const float qmax = qmax_for(bits);

  // pass 1: each slot's top-k threshold (0 keeps everything) and the
  // commit-common max |w_i x_i| of the row
  float m = 0.0f;
  for (int slot = 0; slot < K; ++slot) {
    float v[N];
    load_row<NV4>(x + (static_cast<long long>(slot) * R + row) * B, v, lane);
    unsigned t = 0;
    if (k) {
      unsigned u[N];
#pragma unroll
      for (int j = 0; j < N; ++j) u[j] = abs_bits(v[j]);
      t = topk_threshold<N>(u, k);
    }
    if (lane == 0) thresh[slot] = t;
    const float c = __ldg(w + slot);
#pragma unroll
    for (int j = 0; j < N; ++j) {
      if (abs_bits(v[j]) >= t) m = fmaxf(m, fabsf(__fmul_rn(v[j], c)));
    }
  }
  __syncwarp();
  m = warp_max_nonneg(m);
  float scale = __fdiv_rn(m, qmax);
  if (scale == 0.0f) scale = 1.0f;

  // pass 2: quantize every slot onto the common grid and add its wire word
  unsigned ig[N];                              // idx * golden, per element
  unsigned acc[N];
  const unsigned row0 = base + static_cast<unsigned>(row) *
                                   static_cast<unsigned>(B);
#pragma unroll
  for (int i = 0; i < NV4; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const unsigned col = 4u * static_cast<unsigned>(i * 32 + lane) + e;
      ig[4 * i + e] = (row0 + col) * kGolden;
      acc[4 * i + e] = 0u;
    }
  }
  for (int slot = 0; slot < K; ++slot) {
    const long long off = (static_cast<long long>(slot) * R + row) * B;
    float v[N];
    load_row<NV4>(x + off, v, lane);
    float u[N];
    if (noise) load_row<NV4>(noise + off, u, lane);
    const unsigned t = thresh[slot];
    const float c = __ldg(w + slot);
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const float y = abs_bits(v[j]) >= t ? __fmul_rn(v[j], c) : 0.0f;
      const float r = __fdiv_rn(y, scale);
      float q = noise ? floorf(__fadd_rn(r, u[j])) : rintf(r);
      q = fminf(fmaxf(q, -qmax - 1.0f), qmax);
      acc[j] += static_cast<unsigned>(static_cast<int>(q));
    }
    const unsigned* srow = seeds + static_cast<long long>(slot) * K;
    const int* crow = coef + static_cast<long long>(slot) * K;
    for (int p = 0; p < K; ++p) {
      const int cf = __ldg(crow + p);
      if (cf == 0) continue;                     // warp-uniform
      const unsigned cu = static_cast<unsigned>(cf);
      const unsigned s = __ldg(srow + p);
#pragma unroll
      for (int j = 0; j < N; ++j) acc[j] += cu * hash_u32(ig[j] + s);
    }
  }
  float o[N];
#pragma unroll
  for (int j = 0; j < N; ++j) {
    o[j] = __fmul_rn(static_cast<float>(static_cast<int>(acc[j])), scale);
  }
  store_row<NV4>(out + row * B, o, lane);
}

template <int NV4>
void secure_commit_launch(const float* x, const float* w,
                          const unsigned* seeds, const int* coef,
                          unsigned base, const float* noise, float* out,
                          int K, long long R, int bits, int k,
                          cudaStream_t st) {
  secure_commit_kernel<NV4>
      <<<row_blocks(R), kThreads, kWarps * K * sizeof(unsigned), st>>>(
          x, w, seeds, coef, base, noise, out, K, R, bits, k);
}

}  // namespace

extern "C" {

const char* secure_commit_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// x: [K, R, block] f32; w: [K] f32 effective slot weights; seeds: [K, K]
// uint32; coef: [K, K] int32; base: the global element index of row 0;
// noise: [K, R, block] f32 uniform [0, 1) or null (round half to even);
// out: [R, block] f32.  bits in [2, 16]; 0 <= k <= block (0: no top-k).
int secure_commit(const float* x, const float* w, const unsigned* seeds,
                  const int* coef, unsigned base, const float* noise,
                  float* out, int K, long long R, int block, int bits, int k,
                  void* stream) {
  if (K < 1 || K > kMaxSecureSlots || !rows_ok(R, block) || k < 0 ||
      k > block || bits < 2 || bits > 16)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (block) {
    case 128:
      secure_commit_launch<1>(x, w, seeds, coef, base, noise, out, K, R, bits,
                              k, st);
      break;
    case 256:
      secure_commit_launch<2>(x, w, seeds, coef, base, noise, out, K, R, bits,
                              k, st);
      break;
    case 512:
      secure_commit_launch<4>(x, w, seeds, coef, base, noise, out, K, R, bits,
                              k, st);
      break;
    default:
      secure_commit_launch<8>(x, w, seeds, coef, base, noise, out, K, R, bits,
                              k, st);
      break;
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

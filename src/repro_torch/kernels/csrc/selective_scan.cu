// Hand-written Hopper (sm_90a) kernel: one chunk of Mamba's selective scan,
// the diagonal linear recurrence
//
//     h_t = a_t * h_{t-1} + b_t,   t = 0 .. L-1,   h_{-1} = h0
//
// over a [B, L, D, N] chunk, emitting every h_t (hs) and the last state.
// Replaces the Pallas kernel src/repro/kernels/selective_scan.py:
// selective_scan_chunk_kernel (body _kernel).  The Pallas kernel tiles
// (batch, D/128) over a sequential grid with an [L, 128, N] block in VMEM;
// that tiling is the TPU's, not the recurrence's, and is not carried over.
//
// Bound on an H100 SXM: bytes.  The recurrence is independent per
// (b, d, n) lane and does 2 f32 operations per element, while each element
// costs 12 bytes (a and b read, hs written) plus h0 and h_last once per
// lane.  At the Mamba mixer's prefill chunk of Jamba-1.5-Large (B=1,
// L=128, D=16384, N=16) one call moves 404.75 MB: 0.1208 ms at 3.35 TB/s.
//
// Design for that bound: one thread owns one lane and runs the L steps in
// a loop, keeping h in a register.  Within a (b, t) plane neighbouring
// threads take neighbouring d*N + n, so every warp-wide load and store is
// 128 contiguous bytes.  The loop loads kUnroll steps of a and b before it
// computes them, so each thread keeps 2*kUnroll independent loads in
// flight.  Grid: blockIdx.x covers D*N in blocks of 256 threads (ragged
// edge masked; no D % 128 condition), blockIdx.y is the batch row.  a and
// b come with their own batch strides: the caller passes chunk views
// a[:, i*L:(i+1)*L] of a whole [B, S, D, N] tensor, which are contiguous
// within a batch row but not across rows, and copying them would double
// the bytes.  hs and h_last are fresh and contiguous.  The step is written
// with __fmul_rn/__fadd_rn, which nvcc never contracts into a fused
// multiply-add, so the kernel equals the sequential plain version
// (kernels/ref.py selective_scan_chunk_ref) bit for bit.
//
// The entry point launches on the caller's stream, allocates nothing, and
// returns cudaGetLastError() (or cudaErrorInvalidValue for a shape it does
// not take), which the Python wrapper turns into an exception.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 8;

__global__ void __launch_bounds__(kThreads)
selective_scan_kernel(const float* __restrict__ a, const float* __restrict__ b,
                      const float* __restrict__ h0, float* __restrict__ hs,
                      float* __restrict__ h_last, int L, long long dn,
                      long long a_batch_stride, long long b_batch_stride) {
  const long long lane = static_cast<long long>(blockIdx.x) * blockDim.x +
                         threadIdx.x;
  if (lane >= dn) return;
  const long long row = blockIdx.y;
  const float* pa = a + row * a_batch_stride + lane;
  const float* pb = b + row * b_batch_stride + lane;
  float* ph = hs + row * L * dn + lane;
  float h = h0[row * dn + lane];
  int t = 0;
  for (; t + kUnroll <= L; t += kUnroll) {
    float av[kUnroll], bv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      av[u] = __ldg(pa + (t + u) * dn);
      bv[u] = __ldg(pb + (t + u) * dn);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      h = __fadd_rn(__fmul_rn(av[u], h), bv[u]);
      ph[(t + u) * dn] = h;
    }
  }
  for (; t < L; ++t) {
    h = __fadd_rn(__fmul_rn(__ldg(pa + t * dn), h), __ldg(pb + t * dn));
    ph[t * dn] = h;
  }
  h_last[row * dn + lane] = h;
}

}  // namespace

extern "C" {

const char* selective_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// a, b: [B, L, D*N] f32, contiguous within a batch row, batch strides (in
// elements) a_batch_stride and b_batch_stride; h0, h_last: [B, D*N] f32;
// hs: [B, L, D*N] f32, contiguous.  1 <= B <= 65535, L >= 1.
int selective_scan(const float* a, const float* b, const float* h0, float* hs,
                   float* h_last, int B, int L, long long dn,
                   long long a_batch_stride, long long b_batch_stride,
                   void* stream) {
  const long long grid = (dn + kThreads - 1) / kThreads;
  if (B < 1 || B > 65535 || L < 1 || dn < 1 || grid > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  const dim3 blocks(static_cast<unsigned>(grid), static_cast<unsigned>(B));
  selective_scan_kernel<<<blocks, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      a, b, h0, hs, h_last, L, dn, a_batch_stride, b_batch_stride);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

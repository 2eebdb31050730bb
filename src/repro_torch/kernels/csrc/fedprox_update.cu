// Hand-written Hopper (sm_90a) kernel: the fused FedProx local SGD update
//
//     out = w - lr * (g + mu * (w - w0))
//
// Replaces the Pallas kernel src/repro/kernels/fedprox_update.py:
// fedprox_update_flat (body _kernel).  The port's local training runs all C
// clients of a round as one stacked [C, ...] tensor per leaf, so the kernel
// takes w and g as [C, N] and the global params w0 as [N]: the C clients
// share one read of w0 instead of C materialised copies.
//
// Bound on an H100 SXM: bytes.  It reads w, g once each ([C, N]) and w0 once
// ([N]), writes out once ([C, N]), and does 5 f32 operations per element.
// At the CIFAR CNN's dense1_w leaf, 20 clients x 1,048,576 params, one call
// moves 256 MB: ~76 us at 3.35 TB/s.
//
// Design for that bound: one pass, one thread per element, coalesced 4-byte
// loads; blockIdx.y is the client, so w0 is indexed by the element's
// position in the leaf with no division.  The expression is written with
// __fsub_rn/__fmul_rn/__fadd_rn, which nvcc never contracts into fused
// multiply-adds, so it equals the plain version (kernels/ref.py
// fedprox_update_ref: one rounding per operation) bit for bit.
//
// The entry point launches on the caller's stream, allocates nothing, and
// returns cudaGetLastError() (or cudaErrorInvalidValue for a shape it does
// not take), which the Python wrapper turns into an exception.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
fedprox_update_kernel(const float* __restrict__ w, const float* __restrict__ g,
                      const float* __restrict__ w0, float* __restrict__ out,
                      float lr, float mu, long long n) {
  const long long j = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (j >= n) return;
  const long long i = static_cast<long long>(blockIdx.y) * n + j;
  const float wi = w[i];
  const float corr = __fmul_rn(mu, __fsub_rn(wi, w0[j]));
  out[i] = __fsub_rn(wi, __fmul_rn(lr, __fadd_rn(g[i], corr)));
}

}  // namespace

extern "C" {

const char* fedprox_update_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// w, g, out: [C, n] f32; w0: [n] f32.  1 <= C <= 65535.
int fedprox_update(const float* w, const float* g, const float* w0,
                   float* out, float lr, float mu, int C, long long n,
                   void* stream) {
  const long long grid = (n + kThreads - 1) / kThreads;
  if (C < 1 || C > 65535 || n < 1 || grid > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  const dim3 blocks(static_cast<unsigned>(grid), static_cast<unsigned>(C));
  fedprox_update_kernel<<<blocks, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(w, g, w0, out,
                                                               lr, mu, n);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

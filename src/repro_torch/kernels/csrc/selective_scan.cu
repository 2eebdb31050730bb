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
// The second kernel, selective_scan_bwd, is the scan's backward: the
// reverse-time recurrence of the reference's custom VJP
// (src/repro/kernels/ops.py: _ss_bwd, a lax.associative_scan there, not a
// Pallas kernel):
//
//     G_{L-1} = g_hs_{L-1} + g_hl,   G_t = g_hs_t + a_{t+1} * G_{t+1},
//     ga_t = G_t * h_{t-1} (h_{-1} = h0),   gb_t = G_t,   gh0 = a_0 * G_0.
//
// Bound on an H100 SXM: bytes.  Per element it reads a, hs and g_hs and
// writes ga and gb (20 bytes) for 3 f32 operations; h0, g_hl and gh0 cost
// one word per lane.  At Jamba-1.5-Large's training chunk (B=1, L=128,
// D=16384, N=16) one call moves 674.2 MB: 0.2013 ms at 3.35 TB/s.
//
// Its design is the forward's: one thread owns one (b, d*N+n) lane and
// walks t from L-1 down to 0 with G in a register, reusing the a_{t+1} it
// loaded one step earlier; kUnroll steps of a, g_hs and hs are loaded
// before they are computed; warp accesses are coalesced along d*N+n; a,
// hs and g_hs come with their own batch strides.  __fmul_rn/__fadd_rn in
// the plain version's order keep it equal to kernels/ref.py
// selective_scan_chunk_bwd_ref bit for bit.  g_hl may be null (no
// gradient reached the last state).
//
// Each entry point launches on the caller's stream, allocates nothing, and
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

__global__ void __launch_bounds__(kThreads)
selective_scan_bwd_kernel(const float* __restrict__ a,
                          const float* __restrict__ hs,
                          const float* __restrict__ h0,
                          const float* __restrict__ g_hs,
                          const float* __restrict__ g_hl,
                          float* __restrict__ ga, float* __restrict__ gb,
                          float* __restrict__ gh0, int L, long long dn,
                          long long a_batch_stride, long long hs_batch_stride,
                          long long g_batch_stride) {
  const long long lane = static_cast<long long>(blockIdx.x) * blockDim.x +
                         threadIdx.x;
  if (lane >= dn) return;
  const long long row = blockIdx.y;
  const float* pa = a + row * a_batch_stride + lane;
  const float* ph = hs + row * hs_batch_stride + lane;
  const float* pg = g_hs + row * g_batch_stride + lane;
  float* pga = ga + row * L * dn + lane;
  float* pgb = gb + row * L * dn + lane;
  const float h_init = __ldg(h0 + row * dn + lane);
  // t = L-1: G starts from the last step's cotangent and g_hl
  int t = L - 1;
  float G = __ldg(pg + t * dn);
  if (g_hl != nullptr) G = __fadd_rn(G, __ldg(g_hl + row * dn + lane));
  float a_next = __ldg(pa + t * dn);
  pga[t * dn] = __fmul_rn(G, t > 0 ? __ldg(ph + (t - 1) * dn) : h_init);
  pgb[t * dn] = G;
  for (t = L - 2; t + 1 >= kUnroll; t -= kUnroll) {
    float av[kUnroll], gv[kUnroll], hv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int s = t - u;
      av[u] = __ldg(pa + s * dn);
      gv[u] = __ldg(pg + s * dn);
      hv[u] = s > 0 ? __ldg(ph + (s - 1) * dn) : h_init;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int s = t - u;
      G = __fadd_rn(gv[u], __fmul_rn(a_next, G));
      pga[s * dn] = __fmul_rn(G, hv[u]);
      pgb[s * dn] = G;
      a_next = av[u];
    }
  }
  for (; t >= 0; --t) {
    G = __fadd_rn(__ldg(pg + t * dn), __fmul_rn(a_next, G));
    pga[t * dn] = __fmul_rn(G, t > 0 ? __ldg(ph + (t - 1) * dn) : h_init);
    pgb[t * dn] = G;
    a_next = __ldg(pa + t * dn);
  }
  gh0[row * dn + lane] = __fmul_rn(a_next, G);
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

// a, hs, g_hs: [B, L, D*N] f32, contiguous within a batch row, batch
// strides (in elements) a_batch_stride, hs_batch_stride and g_batch_stride;
// h0, gh0: [B, D*N] f32; g_hl: [B, D*N] f32 or null; ga, gb: [B, L, D*N]
// f32, contiguous.  1 <= B <= 65535, L >= 1.
int selective_scan_bwd(const float* a, const float* hs, const float* h0,
                       const float* g_hs, const float* g_hl, float* ga,
                       float* gb, float* gh0, int B, int L, long long dn,
                       long long a_batch_stride, long long hs_batch_stride,
                       long long g_batch_stride, void* stream) {
  const long long grid = (dn + kThreads - 1) / kThreads;
  if (B < 1 || B > 65535 || L < 1 || dn < 1 || grid > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  const dim3 blocks(static_cast<unsigned>(grid), static_cast<unsigned>(B));
  selective_scan_bwd_kernel<<<blocks, kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      a, hs, h0, g_hs, g_hl, ga, gb, gh0, L, dn, a_batch_stride,
      hs_batch_stride, g_batch_stride);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

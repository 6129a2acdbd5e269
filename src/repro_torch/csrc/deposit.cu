// CIC charge deposit: scatter q at x onto the nc+1 nodes.
//
// Replaces the TPU kernel src/repro/kernels/deposit.py::_deposit_kernel
// (launched by deposit_pallas). The TPU kernel expands each tile into a
// one-hot (128, ng) plane and reduces it, because a TPU has no fast scatter;
// the H100 has atomics in L2, so here each thread takes one element and
// issues two atomicAdds into the raw (times dx) accumulator. The caller
// divides by dx.
//
// Bound on the H100: bytes, 8 B read per element (x, q) plus one write of the
// (nc+1,) result. The accumulator (400 KB at the paper's size) does not fit
// in a block's 227 KB of shared memory, so the atomics go to L2. The CIC
// arithmetic is pic_common.cuh's, shared with the fused kernel.
#include "pic_common.cuh"

namespace {

__global__ void deposit_kernel(const float* __restrict__ x,
                               const float* __restrict__ q,
                               float* __restrict__ rho, long long n, Grid g) {
  const long long k = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= n) return;
  deposit_one(x[k], q[k], g, rho);
}

}  // namespace

// Returns cudaGetLastError() after the launch; the caller raises if not 0.
extern "C" int deposit(const void* x, const void* q, void* rho, long long n,
                       float x0, float dx, int nc, void* stream) {
  constexpr int kThreads = 256;
  const Grid g{x0, dx, 0.0f, 0.0f, nc};
  const unsigned blocks = (unsigned)((n + kThreads - 1) / kThreads);
  deposit_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)q, (float*)rho, n, g);
  return (int)cudaGetLastError();
}

// CIC charge deposit: scatter q at x onto the nc+1 nodes.
//
// Replaces the TPU kernel src/repro/kernels/deposit.py::_deposit_kernel
// (launched by deposit_pallas). The TPU kernel expands each tile into a
// one-hot (128, ng) plane and reduces it into a (1, ng) block that stays in
// VMEM across the grid, so device memory sees one write. The caller divides
// the raw (times dx) result by dx.
//
// Bound on the H100: bytes: q (4 B an element), x where q != 0 (4 B), and
// one write of the (nc+1,) result. What holds it back is its float adds
// (~21 M for the §3.3 electron density), not bytes. Two forms, picked by
// kernels/deposit.py by grid size before the launch (pic_common.cuh):
// - deposit_block_kernel where the nodes fit one block's shared memory
//   (ng <= 58,112, an engine domain's grid): the accumulator on chip, as on
//   the TPU; persistent blocks, each thread walking the elements with a
//   grid stride, kBlockIlp in flight, reading q first and x only where
//   q != 0 (the births carry charge on few rows); one flush of ng floats a
//   block.
// - deposit_kernel with PairAcc above (the paper's 102,401 nodes, 400 KB):
//   one thread an element, one float2 reduction in L2 a charged element,
//   then the pair finish.
#include "pic_common.cuh"

namespace {

__global__ void deposit_kernel(const float* __restrict__ x,
                               const float* __restrict__ q, PairAcc acc,
                               long long n, Grid g) {
  const long long k = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= n) return;
  deposit_one(x[k], q[k], g, acc);
}

__global__ void __launch_bounds__(kBlockThreads, 1) deposit_block_kernel(
    const float* __restrict__ x, const float* __restrict__ q,
    float* __restrict__ rows, long long n, Grid g) {
  extern __shared__ float nodes[];
  const int ng = g.nc + 1;
  const BlockAcc acc = block_begin(nodes, ng);
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long k = (long long)blockIdx.x * blockDim.x + threadIdx.x; k < n;
       k += kBlockIlp * stride) {
    float qk[kBlockIlp];
#pragma unroll
    for (int u = 0; u < kBlockIlp; ++u)
      qk[u] = k + u * stride < n ? q[k + u * stride] : 0.0f;
#pragma unroll
    for (int u = 0; u < kBlockIlp; ++u)
      if (qk[u] != 0.0f) deposit_one(x[k + u * stride], qk[u], g, acc);
  }
  block_end(nodes, ng, rows);
}

}  // namespace

// The pair form: one thread an element, one float2 atomic an element into
// `pair` (nc+1, 2), zeroed by the caller, then rho (nc+1,) written from the
// pairs. Returns cudaGetLastError() after the launches; the caller raises
// if not 0.
extern "C" int deposit(const void* x, const void* q, void* rho, void* pair,
                       long long n, float x0, float inv_dx, int nc,
                       void* stream) {
  constexpr int kThreads = 256;
  const Grid g{x0, inv_dx, 0.0f, 0.0f, nc};
  const unsigned blocks = (unsigned)((n + kThreads - 1) / kThreads);
  const cudaStream_t s = (cudaStream_t)stream;
  deposit_kernel<<<blocks, kThreads, 0, s>>>(
      (const float*)x, (const float*)q, PairAcc{(float2*)pair}, n, g);
  const int ng = nc + 1;
  pair_finish_kernel<float2><<<(ng + 255) / 256, 256, 0, s>>>(
      (const float2*)pair, (float*)rho, ng);
  return (int)cudaGetLastError();
}

// The block form: n_blocks persistent blocks, each holding the nc+1 nodes
// in its shared memory and flushing them into its row of `rows`
// (n_blocks, nc+1); a second kernel sums the rows into rho. Returns the
// first CUDA error; the caller raises if not 0.
extern "C" int deposit_block(const void* x, const void* q, void* rows,
                             void* rho, long long n, float x0, float inv_dx,
                             int nc, int n_blocks, void* stream) {
  const Grid g{x0, inv_dx, 0.0f, 0.0f, nc};
  return (int)launch_blocks(deposit_block_kernel, n_blocks,
                            (cudaStream_t)stream, (const float*)rows,
                            (float*)rho, nc + 1, (const float*)x,
                            (const float*)q, (float*)rows, n, g);
}

// pic_common.cuh block_info for the block kernel at ng nodes: out =
// {registers, local bytes, static shared bytes, blocks that fit}.
extern "C" int deposit_block_info(int ng, int* out) {
  return block_info(deposit_block_kernel, ng, out);
}

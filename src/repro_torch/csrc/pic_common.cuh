// Device code shared by the three particle kernels of the PIC cycle:
// cloud-in-cell weights, one particle's gather + Boris push + drift +
// boundary, and the accumulators the CIC deposit adds into. The arithmetic
// follows src/repro/kernels/ref.py operation by operation; the sources are
// compiled with -fmad=false so that no multiply and add are contracted into
// one rounding, which keeps each kernel equal to its plain PyTorch version
// (kernels/*.py) on the same card.
//
// The deposit's accumulator is deposit_one's policy, one of two forms that
// kernels/deposit.py picks by grid size before the launch:
// - BlockAcc, where the (nc+1,) array fits one block's 227 KB of shared
//   memory (ng <= 58,112): each persistent block adds its share of the
//   slots into its own copy on chip (block_begin, block_end) and flushes it
//   once, as the TPU kernel keeps its accumulator in VMEM. sm_90 has no
//   float add for shared memory: ptxas makes a compare-and-swap loop of
//   each add, still faster than L2 where every add stays on the SM.
// - PairAcc above (the paper's 102,401 nodes): node pairs
//   P[i] += (q(1-f), q f), one 8-byte float2 reduction in L2 a charged
//   slot, half the atomics of two float adds; then pair_finish_kernel.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

enum Boundary : int { kPeriodic = 0, kAbsorb = 1, kOpen = 2 };

// Geometry of one 1D domain. inv_dx = float32(1 / float32(dx)) and
// clamp_hi = float32(length) * float32(1 - 1e-7) are computed once by the
// host, where the plain version computes them too.
struct Grid {
  float x0;
  float inv_dx;
  float length;
  float clamp_hi;
  int nc;
};

// Left node i in [0, nc-1] and fraction f in [0, 1]. A position exactly on
// `length` (a periodic wrap can round there) gets i = nc-1, f = 1: node nc
// takes the charge and nothing reads past node nc = ng-1. The cell
// coordinate is (x - x0) * inv_dx, which is how jitted JAX rounds the
// reference's (x - x0) / dx: XLA turns a division by a constant into a
// multiply by its float32 reciprocal.
__device__ __forceinline__ void cic(float x, const Grid& g, int& i, float& f) {
  const float s = (x - g.x0) * g.inv_dx;
  const float fl = fminf(fmaxf(floorf(s), 0.0f), (float)(g.nc - 1));
  i = (int)fl;
  f = fminf(fmaxf(s - fl, 0.0f), 1.0f);
}

// Gather E at x, Boris push (half kick, optional rotation about the constant
// b, half kick), drift, boundary. Updates the particle in registers; hl/hr
// are the wall masks (absorb only). Dead particles feel no field.
template <int BOUNDARY, bool ROTATE>
__device__ __forceinline__ void push_one(float& x, float& vx, float& vy,
                                         float& vz, bool& alive, bool& hl,
                                         bool& hr, const float* __restrict__ e,
                                         const Grid& g, float qm_dt, float dt,
                                         float bx, float by, float bz) {
  int i;
  float f;
  cic(x, g, i, f);
  const float af = alive ? 1.0f : 0.0f;
  const float ex = (__ldg(e + i) * (1.0f - f) + __ldg(e + i + 1) * f) * af;

  const float half = 0.5f * qm_dt;
  vx = vx + half * ex;
  if (ROTATE) {
    const float tx = bx * half, ty = by * half, tz = bz * half;
    const float t2 = tx * tx + ty * ty + tz * tz;
    const float sx = 2.0f * tx / (1.0f + t2);
    const float sy = 2.0f * ty / (1.0f + t2);
    const float sz = 2.0f * tz / (1.0f + t2);
    const float vpx = vx + (vy * tz - vz * ty);
    const float vpy = vy + (vz * tx - vx * tz);
    const float vpz = vz + (vx * ty - vy * tx);
    const float nx = vx + (vpy * sz - vpz * sy);
    const float ny = vy + (vpz * sx - vpx * sz);
    const float nz = vz + (vpx * sy - vpy * sx);
    vx = nx;
    vy = ny;
    vz = nz;
  }
  vx = vx + half * ex;

  float xn = x + vx * dt;
  hl = false;
  hr = false;
  if (BOUNDARY == kPeriodic) {
    xn = xn - floorf(xn / g.length) * g.length;
  } else if (BOUNDARY == kAbsorb) {
    hl = alive && (xn < 0.0f);
    hr = alive && (xn >= g.length);
    alive = alive && !(hl || hr);
    xn = fminf(fmaxf(xn, 0.0f), g.clamp_hi);
  }
  x = xn;
}

// Node pairs (i, i+1) in one float2 of device memory, one 8-byte vector
// reduction a charged slot; pair_finish_kernel folds the pairs into nodes.
struct PairAcc {
  float2* pair;
  __device__ __forceinline__ void add(int i, float lo, float hi) const {
    atomicAdd(pair + i, make_float2(lo, hi));
  }
};

// rho[j] = P[j].x + P[j-1].y: what node j took as the left node of its
// cell and as the right node of the cell before.
template <typename T>
__global__ void pair_finish_kernel(const T* __restrict__ pair,
                                   float* __restrict__ rho, int ng) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= ng) return;
  rho[j] = j > 0 ? pair[j].x + pair[j - 1].y : pair[j].x;
}

// Threads a block of the persistent block kernels (kernels/deposit.py's
// BLOCK_THREADS mirrors it), and the slots each thread has in flight.
constexpr int kBlockThreads = 1024;
constexpr int kBlockIlp = 2;

// The (nc+1,) node array in this block's dynamic shared memory. The add is
// written in PTX so that it stays in the shared window (a generic atomic
// would have to test the address).
struct BlockAcc {
  float* acc;
  __device__ __forceinline__ void red(int i, float v) const {
    asm volatile("red.shared::cta.add.f32 [%0], %1;"
                 :
                 : "r"((unsigned)__cvta_generic_to_shared(acc + i)), "f"(v));
  }
  __device__ __forceinline__ void add(int i, float lo, float hi) const {
    red(i, lo);
    red(i + 1, hi);
  }
};

// CIC scatter of charge q at x into the raw (times dx) node accumulator.
// Zero charge (dead slots, neutral species, refused births) adds nothing.
template <class Acc>
__device__ __forceinline__ void deposit_one(float x, float q, const Grid& g,
                                            const Acc& acc) {
  if (q == 0.0f) return;
  int i;
  float f;
  cic(x, g, i, f);
  acc.add(i, q * (1.0f - f), q * f);
}

// Zeroes this block's ng nodes, then waits for every thread of the block.
__device__ __forceinline__ BlockAcc block_begin(float* acc, int ng) {
  for (int j = threadIdx.x; j < ng; j += blockDim.x) acc[j] = 0.0f;
  __syncthreads();
  return BlockAcc{acc};
}

// Waits until every thread of the block has added its last charge, then
// writes the block's nodes with plain coalesced stores into row blockIdx.x
// of an (n_blocks, ng) scratch, which sum_rows_kernel adds up in block
// order: L2 sees no atomic.
__device__ __forceinline__ void block_end(const float* acc, int ng,
                                          float* rows) {
  __syncthreads();
  float* row = rows + (long long)blockIdx.x * ng;
  for (int j = threadIdx.x; j < ng; j += blockDim.x) row[j] = acc[j];
}

// rho[j] = the sum of rows[0..n_rows)[j] in row order, one thread a node,
// so the order across blocks is fixed.
template <typename T>
__global__ void sum_rows_kernel(const T* __restrict__ rows,
                                T* __restrict__ rho, int n_rows, int ng) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= ng) return;
  T acc = rows[j];
  for (int r = 1; r < n_rows; ++r) acc += rows[(long long)r * ng + j];
  rho[j] = acc;
}

// Opts `kernel` in to `smem` bytes of dynamic shared memory; a launch with
// more than 48 KB is refused without it.
template <typename... Exp>
cudaError_t allow_smem(void (*kernel)(Exp...), size_t smem) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

// n_blocks persistent blocks of kBlockThreads, each with ng floats of
// dynamic shared memory, then the sum of their rows into rho. Returns the
// first error.
template <typename... Exp, typename... Act>
cudaError_t launch_blocks(void (*kernel)(Exp...), int n_blocks,
                          cudaStream_t stream, const float* rows, float* rho,
                          int ng, Act... args) {
  const size_t smem = (size_t)ng * sizeof(float);
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<n_blocks, kBlockThreads, smem, stream>>>(args...);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  constexpr int kThreads = 256;
  sum_rows_kernel<float><<<(ng + kThreads - 1) / kThreads, kThreads, 0,
                           stream>>>(rows, rho, n_blocks, ng);
  return cudaGetLastError();
}

// What the compiler and the occupancy calculator say of a block instance
// with ng floats of dynamic shared memory: out = {registers a thread, local
// bytes a thread (spills and stack), static shared bytes, blocks that fit
// on the card at once}.
template <typename... Exp>
int block_info(void (*kernel)(Exp...), int ng, int* out) {
  const size_t smem = (size_t)ng * sizeof(float);
  cudaFuncAttributes a;
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaFuncGetAttributes(&a, kernel);
  if (err == cudaSuccess) err = allow_smem(kernel, smem);
  if (err == cudaSuccess) err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kBlockThreads, smem);
  if (err != cudaSuccess) return (int)err;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = (int)a.sharedSizeBytes;
  out[3] = per_sm * sms;
  return 0;
}

#define REPRO_DISPATCH_BOUNDARY(boundary, B, ...)   \
  switch (boundary) {                                \
    case kPeriodic: {                                \
      constexpr int B = kPeriodic;                   \
      __VA_ARGS__;                                   \
    } break;                                         \
    case kAbsorb: {                                  \
      constexpr int B = kAbsorb;                     \
      __VA_ARGS__;                                   \
    } break;                                         \
    case kOpen: {                                    \
      constexpr int B = kOpen;                       \
      __VA_ARGS__;                                   \
    } break;                                         \
    default:                                         \
      return (int)cudaErrorInvalidValue;             \
  }

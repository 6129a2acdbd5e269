// Takizuka-Abe pair deflection: du = u' - u for each pair's relative
// velocity u, turned through theta with tan(theta/2) = delta about the
// azimuth phi, so that |u + du| = |u|.
//
// Replaces the TPU kernel src/repro/kernels/collide.py::_ta_kernel
// (launched by ta_kick_pallas). The TPU kernel streams u, delta and phi as
// (rows, 128) planes through VMEM; here one thread takes one pair row of the
// (M, 3) layout the caller already holds, so no plane is built or unpacked.
//
// Bound on the H100: bytes, 32 B a row (u 12, delta 4, phi 4 read; du 12
// written). The arithmetic (a divide for 1/(1+d2), two square roots, cosf
// and sinf, four divides by u_perp, some thirty multiplies and adds) is far
// below the card's float32 rate at that traffic. The order of operations is
// _ta_kernel's, and the file is compiled with -fmad=false, so the kernel
// rounds as its plain version (kernels/collide.py::ta_kick_plain) does.
// cosf/sinf are the accurate library functions: phi reaches 2 pi, where the
// __cosf/__sinf intrinsics lose digits.
//
// coulomb_pairs: the whole Coulomb operator after the cell-shuffled order,
// pairing and deflection in one pass (see kernels/collide.py for its bound
// and design). It replaces the scan over segment starts of the reference's
// pair_in_cells (src/repro/core/collisions.py) folded together with
// _ta_kernel's deflection, which runs here as ta_deflect, the one body both
// kernels compile.
//
// cell_density: the per-cell density of the collision menu (see
// kernels/collide.py for its bound and design). It replaces no TPU kernel:
// its origin is the reference's .at[c].add histogram in cell_density
// (src/repro/core/collisions.py), which parks every row it does not count
// in a sentinel bin nc. Here such a row never reaches an atomic.
#include <cuda_runtime.h>

namespace {

// du of one row; the body of _ta_kernel.
__device__ __forceinline__ void ta_deflect(float ux, float uy, float uz,
                                           float d, float p, float& dx,
                                           float& dy, float& dz) {
  const float d2 = d * d;
  const float inv = 1.0f / (1.0f + d2);
  const float cos_t = (1.0f - d2) * inv;
  const float sin_t = 2.0f * d * inv;
  const float one_m = 1.0f - cos_t;
  const float uperp2 = ux * ux + uy * uy;
  const float uperp = sqrtf(uperp2);
  const float umag = sqrtf(uperp2 + uz * uz);
  const float cphi = cosf(p), sphi = sinf(p);

  if (uperp > 1e-12f * fmaxf(umag, 1.0f)) {
    const float up = uperp;
    dx = (ux / up) * uz * sin_t * cphi - (uy / up) * umag * sin_t * sphi -
         ux * one_m;
    dy = (uy / up) * uz * sin_t * cphi + (ux / up) * umag * sin_t * sphi -
         uy * one_m;
    dz = -up * sin_t * cphi - uz * one_m;
  } else {
    // u along z: scatter straight off the z axis
    dx = uz * sin_t * cphi;
    dy = uz * sin_t * sphi;
    dz = -uz * one_m;
  }
}

__global__ void ta_kick_kernel(const float* __restrict__ u,
                               const float* __restrict__ delta,
                               const float* __restrict__ phi,
                               float* __restrict__ du, long long m) {
  const long long k = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= m) return;
  float dx, dy, dz;
  ta_deflect(u[3 * k], u[3 * k + 1], u[3 * k + 2], delta[k], phi[k], dx, dy,
             dz);
  du[3 * k] = dx;
  du[3 * k + 1] = dy;
  du[3 * k + 2] = dz;
}

// Pass 1: cs[t] = cell[order[t]], and first[c] = the sorted position where
// cell c's segment starts, written by that position alone (no atomics, no
// scan). The sentinel segment (cell nc, ineligible rows) gets no entry;
// those rows are copied here instead, by slot, so that the copy reads and
// writes v in order (in the sorted order they lie shuffled). Thread 0 also
// zeroes the pair count that pass 2 adds into.
__global__ void coulomb_bounds_kernel(const long long* __restrict__ order,
                                      const int* __restrict__ cell,
                                      const float* __restrict__ v,
                                      float* __restrict__ out,
                                      int* __restrict__ cs,
                                      long long* __restrict__ first,
                                      int* __restrict__ count, long long n,
                                      int nc) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t == 0) *count = 0;
  if (t < n && cell[t] == nc) {
    out[3 * t] = v[3 * t];
    out[3 * t + 1] = v[3 * t + 1];
    out[3 * t + 2] = v[3 * t + 2];
  }
  const int c = t < n ? __ldg(cell + order[t]) : -1;
  // the key at t - 1 from the lane below; lane 0 reads it itself
  int prev = __shfl_up_sync(0xffffffffu, c, 1);
  if ((threadIdx.x & 31) == 0) prev = (t > 0 && t < n) ?
      __ldg(cell + order[t - 1]) : -1;
  if (t >= n) return;
  cs[t] = c;
  if (c != nc && c != prev) first[c] = t;
}

// Pass 2: position t of the order is a pair head where pair_in_cells'
// `valid` is: an even offset within its cell's segment, a successor in the
// same cell, and an eligible cell (cs != nc covers ok[ia] and ok[ib]). A
// head deflects its pair and writes both rows; a position at an odd offset
// is its head's partner and writes nothing; the last row of an odd segment
// is copied (pass 1 copied the ineligible rows). So each row of the output
// is written once, by one thread.
//
// The arithmetic is coulomb_intra's, operation by operation:
//   u = v[ia] - v[ib]; umag = sqrt(u0^2 + u1^2 + u2^2);
//   var = ((rate n_cell) dt) / clamp((umag umag) umag, 1e-12);
//   delta = sqrt(var) nrm; du = ta_deflect(u, delta, phi);
//   v[ia] + 0.5 du, v[ib] + (-0.5 du).
// The one order PyTorch leaves open is torch.sum's over the three squares;
// it is taken here as (u0^2 + u2^2) + u1^2, the order in which torch's
// reduction kernel on the card combines a 3-wide innermost row (two
// threads a row: one holds elements 0 and 2, the other element 1).
// Against index_add's copy the output differs only in the sign of a zero:
// index_add adds +0.0 to each row that is no pair head, which turns a -0.0
// into +0.0, where this kernel copies the row as it is.
__global__ void coulomb_pairs_kernel(
    const long long* __restrict__ order, const int* __restrict__ cs,
    const long long* __restrict__ first, const float* __restrict__ v,
    const float* __restrict__ n_cell, const float* __restrict__ nrm,
    const float* __restrict__ phi, const float* __restrict__ rate_p,
    float rate_v, const float* __restrict__ dt_p, float dt_v,
    float* __restrict__ out, int* __restrict__ count, long long n, int nc) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  int head = 0;
  const int c = t < n ? cs[t] : nc;
  if (c != nc) {
    const bool even = ((t - first[c]) & 1) == 0;
    head = even && t + 1 < n && cs[t + 1] == c;
    const long long ra = order[t];
    if (head) {
      const long long rb = order[t + 1];
      const float ax = v[3 * ra], ay = v[3 * ra + 1], az = v[3 * ra + 2];
      const float bx = v[3 * rb], by = v[3 * rb + 1], bz = v[3 * rb + 2];
      const float ux = ax - bx, uy = ay - by, uz = az - bz;
      const float umag = sqrtf((ux * ux + uz * uz) + uy * uy);
      const float rate = rate_p ? *rate_p : rate_v;
      const float dt = dt_p ? *dt_p : dt_v;
      const float cube = (umag * umag) * umag;
      // torch.clamp(min=) keeps a NaN, as fmaxf would not
      const float den = cube < 1e-12f ? 1e-12f : cube;
      const float var = ((rate * __ldg(n_cell + c)) * dt) / den;
      const float d = sqrtf(var) * nrm[t];
      float dx, dy, dz;
      ta_deflect(ux, uy, uz, d, phi[t], dx, dy, dz);
      out[3 * ra] = ax + 0.5f * dx;
      out[3 * ra + 1] = ay + 0.5f * dy;
      out[3 * ra + 2] = az + 0.5f * dz;
      out[3 * rb] = bx + -0.5f * dx;
      out[3 * rb + 1] = by + -0.5f * dy;
      out[3 * rb + 2] = bz + -0.5f * dz;
    } else if (even) {        // an odd offset is written by its head
      out[3 * ra] = v[3 * ra];
      out[3 * ra + 1] = v[3 * ra + 1];
      out[3 * ra + 2] = v[3 * ra + 2];
    }
  }
  // integer adds are exact: the count equals valid.sum() in any order
  const int pairs = __syncthreads_count(head);
  if (threadIdx.x == 0 && pairs) atomicAdd(count, pairs);
}

// The per-cell sum of the weights of the rows alive inside [0, length).
// A dead or outside row returns before any atomic (kernels/collide.py's
// eligible); an eligible row's cell is cell_keys' rule, floor(x * inv_dx)
// in float32 clamped to [0, nc - 1], and its weight is added into the
// zeroed (nc,) histogram.
__global__ void cell_density_kernel(const float* __restrict__ x,
                                    const bool* __restrict__ alive,
                                    const float* __restrict__ w,
                                    float* __restrict__ hist, float inv_dx,
                                    float length, long long n, int nc) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n || !alive[t]) return;
  const float xt = x[t];
  if (!(xt >= 0.0f && xt < length)) return;
  const int c = (int)floorf(xt * inv_dx);
  atomicAdd(hist + min(max(c, 0), nc - 1), w[t]);
}

}  // namespace

// Returns cudaGetLastError() after the launch; the caller raises if not 0.
extern "C" int ta_kick(const void* u, const void* delta, const void* phi,
                       void* du, long long m, void* stream) {
  constexpr int kThreads = 256;
  const unsigned blocks = (unsigned)((m + kThreads - 1) / kThreads);
  ta_kick_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)u, (const float*)delta, (const float*)phi, (float*)du, m);
  return (int)cudaGetLastError();
}

// Both passes on the stream, n >= 1 rows. rate_p / dt_p: a 0-d float32
// tensor on the card, or null and the value in rate_v / dt_v. cs (n,) and
// first (nc,) are the caller's scratch; count (1,) int32 the pair count.
extern "C" int coulomb_pairs(const void* order, const void* cell,
                             const void* v, const void* n_cell,
                             const void* nrm, const void* phi,
                             const void* rate_p, float rate_v,
                             const void* dt_p, float dt_v, void* out,
                             void* cs, void* first, void* count, long long n,
                             int nc, void* stream) {
  constexpr int kThreads = 256;
  const unsigned blocks = (unsigned)((n + kThreads - 1) / kThreads);
  const cudaStream_t s = (cudaStream_t)stream;
  coulomb_bounds_kernel<<<blocks, kThreads, 0, s>>>(
      (const long long*)order, (const int*)cell, (const float*)v,
      (float*)out, (int*)cs, (long long*)first, (int*)count, n, nc);
  const int err = (int)cudaGetLastError();
  if (err != 0) return err;
  coulomb_pairs_kernel<<<blocks, kThreads, 0, s>>>(
      (const long long*)order, (const int*)cs, (const long long*)first,
      (const float*)v, (const float*)n_cell, (const float*)nrm,
      (const float*)phi, (const float*)rate_p, rate_v, (const float*)dt_p,
      dt_v, (float*)out, (int*)count, n, nc);
  return (int)cudaGetLastError();
}

// hist (nc,) float32 is zeroed on the stream, then the eligible rows of
// x, alive, w (n,) add into it; n >= 1.
extern "C" int cell_density(const void* x, const void* alive, const void* w,
                            void* hist, float inv_dx, float length,
                            long long n, int nc, void* stream) {
  constexpr int kThreads = 256;
  const unsigned blocks = (unsigned)((n + kThreads - 1) / kThreads);
  const cudaStream_t s = (cudaStream_t)stream;
  const int err = (int)cudaMemsetAsync(hist, 0, (size_t)nc * sizeof(float), s);
  if (err != 0) return err;
  cell_density_kernel<<<blocks, kThreads, 0, s>>>(
      (const float*)x, (const bool*)alive, (const float*)w, (float*)hist,
      inv_dx, length, n, nc);
  return (int)cudaGetLastError();
}

// Particle mover for one species: gather E + Boris push + drift + boundary.
//
// Replaces the TPU kernel src/repro/kernels/mover.py::_mover_kernel
// (launched by mover_push_pallas); it serves strategy='explicit', one launch
// per species. The device code is the fused kernel's (pic_common.cuh) without
// the weight plane and the deposit. q*m*dt, dt and b arrive as float
// arguments at run time, where the TPU kernel baked them in at compile time.
//
// Bound on the H100: bytes. Each slot reads x, v (AoS, 12 B) and alive
// (17 B) and writes x, v, alive and the two wall masks (19 B). One thread per
// slot, coalesced; E is read through __ldg from L2 (400 KB at the paper's
// size, above the 227 KB of shared memory a block may use).
#include "pic_common.cuh"

namespace {

template <int BOUNDARY, bool ROTATE>
__global__ void mover_push_kernel(const float* __restrict__ x,
                                  const float* __restrict__ v,
                                  const uint8_t* __restrict__ alive,
                                  const float* __restrict__ e,
                                  float* __restrict__ xo,
                                  float* __restrict__ vo,
                                  uint8_t* __restrict__ ao,
                                  uint8_t* __restrict__ hlo,
                                  uint8_t* __restrict__ hro, long long n,
                                  Grid g, float qm_dt, float dt, float bx,
                                  float by, float bz) {
  const long long k = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= n) return;
  float px = x[k];
  float vx = v[3 * k], vy = v[3 * k + 1], vz = v[3 * k + 2];
  bool a = alive[k] != 0;
  bool hl, hr;
  push_one<BOUNDARY, ROTATE>(px, vx, vy, vz, a, hl, hr, e, g, qm_dt, dt, bx,
                             by, bz);
  xo[k] = px;
  vo[3 * k] = vx;
  vo[3 * k + 1] = vy;
  vo[3 * k + 2] = vz;
  ao[k] = a;
  hlo[k] = hl;
  hro[k] = hr;
}

}  // namespace

// Returns cudaGetLastError() after the launch; the caller raises if not 0.
extern "C" int mover_push(const void* x, const void* v, const void* alive,
                          const void* e, void* xo, void* vo, void* ao,
                          void* hlo, void* hro, long long n, float x0,
                          float inv_dx, int nc, float length, float clamp_hi,
                          float qm_dt, float dt, float bx, float by, float bz,
                          int boundary, void* stream) {
  constexpr int kThreads = 256;
  const Grid g{x0, inv_dx, length, clamp_hi, nc};
  const bool rotate = bx != 0.0f || by != 0.0f || bz != 0.0f;
  const unsigned blocks = (unsigned)((n + kThreads - 1) / kThreads);
#define REPRO_ARGS                                                        \
  (const float*)x, (const float*)v, (const uint8_t*)alive,                \
      (const float*)e, (float*)xo, (float*)vo, (uint8_t*)ao,              \
      (uint8_t*)hlo, (uint8_t*)hro, n, g, qm_dt, dt, bx, by, bz
  REPRO_DISPATCH_BOUNDARY(boundary, B, {
    if (rotate)
      mover_push_kernel<B, true>
          <<<blocks, kThreads, 0, (cudaStream_t)stream>>>(REPRO_ARGS);
    else
      mover_push_kernel<B, false>
          <<<blocks, kThreads, 0, (cudaStream_t)stream>>>(REPRO_ARGS);
  })
#undef REPRO_ARGS
  return (int)cudaGetLastError();
}

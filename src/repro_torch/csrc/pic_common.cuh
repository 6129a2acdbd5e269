// Device code shared by the three particle kernels of the PIC cycle:
// cloud-in-cell weights and one particle's gather + Boris push + drift +
// boundary. The arithmetic follows src/repro/kernels/ref.py operation by
// operation; the sources are compiled with -fmad=false so that no multiply
// and add are contracted into one rounding, which keeps each kernel equal to
// its plain PyTorch version (kernels/*.py) on the same card.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

enum Boundary : int { kPeriodic = 0, kAbsorb = 1, kOpen = 2 };

// Geometry of one 1D domain. clamp_hi = float32(length) * float32(1 - 1e-7)
// is computed once by the host, where the plain version computes it too.
struct Grid {
  float x0;
  float dx;
  float length;
  float clamp_hi;
  int nc;
};

// Left node i in [0, nc-1] and fraction f in [0, 1]. A position exactly on
// `length` (a periodic wrap can round there) gets i = nc-1, f = 1: node nc
// takes the charge and nothing reads past node nc = ng-1.
__device__ __forceinline__ void cic(float x, const Grid& g, int& i, float& f) {
  const float s = (x - g.x0) / g.dx;
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

// CIC scatter of charge q at x into the raw (times dx) node accumulator.
// Zero charge (dead slots, neutral species, refused births) adds nothing.
__device__ __forceinline__ void deposit_one(float x, float q, const Grid& g,
                                            float* __restrict__ rho) {
  if (q == 0.0f) return;
  int i;
  float f;
  cic(x, g, i, f);
  atomicAdd(rho + i, q * (1.0f - f));
  atomicAdd(rho + i + 1, q * f);
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

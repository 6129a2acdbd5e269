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
#include <cuda_runtime.h>

namespace {

__global__ void ta_kick_kernel(const float* __restrict__ u,
                               const float* __restrict__ delta,
                               const float* __restrict__ phi,
                               float* __restrict__ du, long long m) {
  const long long k = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= m) return;
  const float ux = u[3 * k], uy = u[3 * k + 1], uz = u[3 * k + 2];
  const float d = delta[k], p = phi[k];

  const float d2 = d * d;
  const float inv = 1.0f / (1.0f + d2);
  const float cos_t = (1.0f - d2) * inv;
  const float sin_t = 2.0f * d * inv;
  const float one_m = 1.0f - cos_t;
  const float uperp2 = ux * ux + uy * uy;
  const float uperp = sqrtf(uperp2);
  const float umag = sqrtf(uperp2 + uz * uz);
  const float cphi = cosf(p), sphi = sinf(p);

  float dx, dy, dz;
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
  du[3 * k] = dx;
  du[3 * k + 1] = dy;
  du[3 * k + 2] = dz;
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

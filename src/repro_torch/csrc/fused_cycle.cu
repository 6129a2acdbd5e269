// Fused push + deposit over stacked species: the hot loop of the PIC cycle.
//
// Replaces the TPU kernel src/repro/kernels/fused_cycle.py::_fused_kernel
// (launched by fused_push_deposit_pallas). One thread per particle slot of an
// (S, cap) stack; blockIdx.y is the species. Per thread: CIC gather of E,
// Boris push, drift, boundary, w *= alive, then the CIC deposit of the
// post-push charge charge[s] * w into a raw (times dx) accumulator. The
// per-species scalars qm*dt, dt and charge are (S,) device arrays read at
// run time; b is three floats. Nothing is baked at compile time except the
// boundary, whether b rotates, and whether to deposit.
//
// Bound on the H100: bytes. Each slot reads x, v (AoS, 12 B), w and alive
// (21 B) and writes x, v, w, alive and the two wall masks (23 B); the
// arithmetic is about 40 flops a slot, far below the f32 rate. Design:
// neighbouring threads touch neighbouring slots, so every plane streams
// coalesced. The node field E (102,401 f32 = 400 KB at the paper's size) does
// not fit in the 227 KB of shared memory a block may use, so it is read with
// __ldg and stays in the 50 MB L2. The deposit is two global atomicAdds per
// charged slot into the (nc+1,) accumulator, which lives in L2 as well;
// uncharged slots skip it.
#include "pic_common.cuh"

namespace {

template <int BOUNDARY, bool ROTATE, bool DEPOSIT>
__global__ void fused_push_deposit_kernel(
    const float* __restrict__ x, const float* __restrict__ v,
    const float* __restrict__ w, const uint8_t* __restrict__ alive,
    const float* __restrict__ e, const float* __restrict__ qm_dt,
    const float* __restrict__ dt, const float* __restrict__ charge,
    float* __restrict__ xo, float* __restrict__ vo, float* __restrict__ wo,
    uint8_t* __restrict__ ao, uint8_t* __restrict__ hlo,
    uint8_t* __restrict__ hro, float* __restrict__ rho, long long cap,
    Grid g, float bx, float by, float bz) {
  const int s = blockIdx.y;
  const long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= cap) return;
  const long long k = (long long)s * cap + j;

  float px = x[k];
  float vx = v[3 * k], vy = v[3 * k + 1], vz = v[3 * k + 2];
  bool a = alive[k] != 0;
  bool hl, hr;
  push_one<BOUNDARY, ROTATE>(px, vx, vy, vz, a, hl, hr, e, g,
                             __ldg(qm_dt + s), __ldg(dt + s), bx, by, bz);
  // the input w stays untouched: the wall-power diagnostic reads it
  const float wn = w[k] * (a ? 1.0f : 0.0f);

  xo[k] = px;
  vo[3 * k] = vx;
  vo[3 * k + 1] = vy;
  vo[3 * k + 2] = vz;
  wo[k] = wn;
  ao[k] = a;
  hlo[k] = hl;
  hro[k] = hr;
  if (DEPOSIT) deposit_one(px, __ldg(charge + s) * wn, g, rho);
}

template <int BOUNDARY, bool ROTATE, bool DEPOSIT>
void launch(const float* x, const float* v, const float* w,
            const uint8_t* alive, const float* e, const float* qm_dt,
            const float* dt, const float* charge, float* xo, float* vo,
            float* wo, uint8_t* ao, uint8_t* hlo, uint8_t* hro, float* rho,
            long long cap, int num_species, Grid g, float bx, float by,
            float bz, cudaStream_t stream) {
  constexpr int kThreads = 256;
  const dim3 grid((unsigned)((cap + kThreads - 1) / kThreads),
                  (unsigned)num_species);
  fused_push_deposit_kernel<BOUNDARY, ROTATE, DEPOSIT>
      <<<grid, kThreads, 0, stream>>>(x, v, w, alive, e, qm_dt, dt, charge,
                                      xo, vo, wo, ao, hlo, hro, rho, cap, g,
                                      bx, by, bz);
}

}  // namespace

// Returns cudaGetLastError() after the launch; the caller raises if not 0.
extern "C" int fused_push_deposit(
    const void* x, const void* v, const void* w, const void* alive,
    const void* e, const void* qm_dt, const void* dt, const void* charge,
    void* xo, void* vo, void* wo, void* ao, void* hlo, void* hro, void* rho,
    long long cap, int num_species, float x0, float dx, int nc, float length,
    float clamp_hi, float bx, float by, float bz, int boundary, int deposit,
    void* stream) {
  const Grid g{x0, dx, length, clamp_hi, nc};
  const bool rotate = bx != 0.0f || by != 0.0f || bz != 0.0f;
#define REPRO_ARGS                                                          \
  (const float*)x, (const float*)v, (const float*)w, (const uint8_t*)alive, \
      (const float*)e, (const float*)qm_dt, (const float*)dt,               \
      (const float*)charge, (float*)xo, (float*)vo, (float*)wo,             \
      (uint8_t*)ao, (uint8_t*)hlo, (uint8_t*)hro, (float*)rho, cap,         \
      num_species, g, bx, by, bz, (cudaStream_t)stream
  REPRO_DISPATCH_BOUNDARY(boundary, B, {
    if (rotate) {
      if (deposit) launch<B, true, true>(REPRO_ARGS);
      else launch<B, true, false>(REPRO_ARGS);
    } else {
      if (deposit) launch<B, false, true>(REPRO_ARGS);
      else launch<B, false, false>(REPRO_ARGS);
    }
  })
#undef REPRO_ARGS
  return (int)cudaGetLastError();
}

// Fused push + deposit over stacked species: the hot loop of the PIC cycle.
//
// Replaces the TPU kernel src/repro/kernels/fused_cycle.py::_fused_kernel
// (launched by fused_push_deposit_pallas). Per particle slot of an (S, cap)
// stack: CIC gather of E, Boris push, drift, boundary, w *= alive, then the
// CIC deposit of the post-push charge charge[s] * w into a raw (times dx)
// accumulator. The per-species scalars qm*dt, dt and charge are (S,) device
// arrays read at run time; b is three floats. Nothing is baked at compile
// time except the boundary, whether b rotates, and (in the one-thread-a-slot
// form) whether to deposit.
//
// Bound on the H100: bytes. Each slot reads x, v (AoS, 12 B), w and alive
// (21 B) and writes x, v, w, alive and the two wall masks (23 B); the
// arithmetic is about 40 flops a slot, far below the f32 rate. Neighbouring
// threads touch neighbouring slots, so every plane streams coalesced. The
// node field E (102,401 f32 = 400 KB at the paper's size) is read with
// __ldg and stays in the 50 MB L2.
//
// What held the deposit back was not bytes but atomics: the TPU kernel keeps
// its (1, ng) accumulator in VMEM across the grid, and two global
// atomicAdds a charged slot (~42 M a §3.3 step) run at the L2's
// float-atomic rate on scattered addresses. Two forms, picked by
// kernels/deposit.py by grid size before the launch (pic_common.cuh):
// - fused_block_kernel where the nodes fit one block's shared memory
//   (ng <= 58,112, an engine domain's grid): persistent blocks that hold
//   the accumulator on chip, each thread walking every species' slots with
//   a grid stride, kBlockIlp slots in flight, so that no thread leaves
//   before the block's two barriers; one flush a block.
// - fused_push_deposit_kernel with DEPOSIT above (the paper's 102,401
//   nodes, 400 KB): one thread a slot, blockIdx.y the species, one float2
//   reduction in L2 a charged slot (half the atomics of two float adds),
//   then the pair finish. Without a deposit (DEPOSIT = false) the same
//   launch needs no accumulator.
#include "pic_common.cuh"

namespace {

// One slot's state in registers.
struct Slot {
  float x, vx, vy, vz, w;
  bool a;
};

__device__ __forceinline__ Slot load_slot(const float* __restrict__ x,
                                          const float* __restrict__ v,
                                          const float* __restrict__ w,
                                          const uint8_t* __restrict__ alive,
                                          long long k) {
  return Slot{x[k], v[3 * k], v[3 * k + 1], v[3 * k + 2], w[k], alive[k] != 0};
}

// Push one slot and write it back; returns the post-push w (the input w
// stays untouched: the wall-power diagnostic reads it).
template <int BOUNDARY, bool ROTATE>
__device__ __forceinline__ float push_store(
    Slot& p, long long k, const float* __restrict__ e, const Grid& g,
    float qm_dt, float dt, float bx, float by, float bz,
    float* __restrict__ xo, float* __restrict__ vo, float* __restrict__ wo,
    uint8_t* __restrict__ ao, uint8_t* __restrict__ hlo,
    uint8_t* __restrict__ hro) {
  bool hl, hr;
  push_one<BOUNDARY, ROTATE>(p.x, p.vx, p.vy, p.vz, p.a, hl, hr, e, g, qm_dt,
                             dt, bx, by, bz);
  const float wn = p.w * (p.a ? 1.0f : 0.0f);
  xo[k] = p.x;
  vo[3 * k] = p.vx;
  vo[3 * k + 1] = p.vy;
  vo[3 * k + 2] = p.vz;
  wo[k] = wn;
  ao[k] = p.a;
  hlo[k] = hl;
  hro[k] = hr;
  return wn;
}

template <int BOUNDARY, bool ROTATE, bool DEPOSIT>
__global__ void fused_push_deposit_kernel(
    const float* __restrict__ x, const float* __restrict__ v,
    const float* __restrict__ w, const uint8_t* __restrict__ alive,
    const float* __restrict__ e, const float* __restrict__ qm_dt,
    const float* __restrict__ dt, const float* __restrict__ charge,
    float* __restrict__ xo, float* __restrict__ vo, float* __restrict__ wo,
    uint8_t* __restrict__ ao, uint8_t* __restrict__ hlo,
    uint8_t* __restrict__ hro, PairAcc acc, long long cap, Grid g, float bx,
    float by, float bz) {
  const int s = blockIdx.y;
  const long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= cap) return;
  const long long k = (long long)s * cap + j;
  Slot p = load_slot(x, v, w, alive, k);
  const float wn = push_store<BOUNDARY, ROTATE>(
      p, k, e, g, __ldg(qm_dt + s), __ldg(dt + s), bx, by, bz, xo, vo, wo,
      ao, hlo, hro);
  if (DEPOSIT) deposit_one(p.x, __ldg(charge + s) * wn, g, acc);
}

template <int BOUNDARY, bool ROTATE>
__global__ void __launch_bounds__(kBlockThreads, 1) fused_block_kernel(
    const float* __restrict__ x, const float* __restrict__ v,
    const float* __restrict__ w, const uint8_t* __restrict__ alive,
    const float* __restrict__ e, const float* __restrict__ qm_dt,
    const float* __restrict__ dt, const float* __restrict__ charge,
    float* __restrict__ xo, float* __restrict__ vo, float* __restrict__ wo,
    uint8_t* __restrict__ ao, uint8_t* __restrict__ hlo,
    uint8_t* __restrict__ hro, float* __restrict__ rows, long long cap,
    int num_species, Grid g, float bx, float by, float bz) {
  extern __shared__ float nodes[];
  const int ng = g.nc + 1;
  const BlockAcc acc = block_begin(nodes, ng);
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  for (int s = 0; s < num_species; ++s) {
    const float qm = __ldg(qm_dt + s), dts = __ldg(dt + s);
    const float q = __ldg(charge + s);
    const long long base = (long long)s * cap;
    for (long long j = t; j < cap; j += kBlockIlp * stride) {
      Slot p[kBlockIlp];
#pragma unroll
      for (int u = 0; u < kBlockIlp; ++u)
        if (j + u * stride < cap)
          p[u] = load_slot(x, v, w, alive, base + j + u * stride);
#pragma unroll
      for (int u = 0; u < kBlockIlp; ++u) {
        const long long k = base + j + u * stride;
        if (j + u * stride < cap) {
          const float wn = push_store<BOUNDARY, ROTATE>(
              p[u], k, e, g, qm, dts, bx, by, bz, xo, vo, wo, ao, hlo, hro);
          deposit_one(p[u].x, q * wn, g, acc);
        }
      }
    }
  }
  block_end(nodes, ng, rows);
}

struct Args {
  const float *x, *v, *w;
  const uint8_t* alive;
  const float *e, *qm_dt, *dt, *charge;
  float *xo, *vo, *wo;
  uint8_t *ao, *hlo, *hro;
  long long cap;
  int num_species;
  Grid g;
  float bx, by, bz;
  cudaStream_t stream;
};

template <int BOUNDARY, bool ROTATE, bool DEPOSIT>
cudaError_t launch_per_slot(const Args& a, PairAcc acc) {
  constexpr int kThreads = 256;
  const dim3 grid((unsigned)((a.cap + kThreads - 1) / kThreads),
                  (unsigned)a.num_species);
  fused_push_deposit_kernel<BOUNDARY, ROTATE, DEPOSIT>
      <<<grid, kThreads, 0, a.stream>>>(a.x, a.v, a.w, a.alive, a.e, a.qm_dt,
                                         a.dt, a.charge, a.xo, a.vo, a.wo,
                                         a.ao, a.hlo, a.hro, acc, a.cap, a.g,
                                         a.bx, a.by, a.bz);
  return cudaGetLastError();
}

// Calls fn with the block instance for (boundary, rotate).
template <typename F>
int by_instance(int boundary, bool rotate, F&& fn) {
  REPRO_DISPATCH_BOUNDARY(boundary, B, {
    return rotate ? fn(fused_block_kernel<B, true>)
                  : fn(fused_block_kernel<B, false>);
  })
  return (int)cudaErrorInvalidValue;
}

Args make_args(const void* x, const void* v, const void* w, const void* alive,
               const void* e, const void* qm_dt, const void* dt,
               const void* charge, void* xo, void* vo, void* wo, void* ao,
               void* hlo, void* hro, long long cap, int num_species, float x0,
               float inv_dx, int nc, float length, float clamp_hi, float bx,
               float by, float bz, void* stream) {
  return Args{(const float*)x,      (const float*)v,   (const float*)w,
              (const uint8_t*)alive, (const float*)e,  (const float*)qm_dt,
              (const float*)dt,     (const float*)charge, (float*)xo,
              (float*)vo,           (float*)wo,        (uint8_t*)ao,
              (uint8_t*)hlo,        (uint8_t*)hro,     cap,
              num_species,          Grid{x0, inv_dx, length, clamp_hi, nc},
              bx,                   by,                bz,
              (cudaStream_t)stream};
}

}  // namespace

// One thread a slot. pair null: no deposit (rho unused). Else one float2
// atomic a charged slot into `pair` (nc+1, 2), zeroed by the caller, then
// rho (nc+1,) written from the pairs. Returns cudaGetLastError() after the
// launches; the caller raises if not 0.
extern "C" int fused_push_deposit(
    const void* x, const void* v, const void* w, const void* alive,
    const void* e, const void* qm_dt, const void* dt, const void* charge,
    void* xo, void* vo, void* wo, void* ao, void* hlo, void* hro, void* rho,
    void* pair, long long cap, int num_species, float x0, float inv_dx,
    int nc, float length, float clamp_hi, float bx, float by, float bz,
    int boundary, void* stream) {
  const Args a = make_args(x, v, w, alive, e, qm_dt, dt, charge, xo, vo, wo,
                           ao, hlo, hro, cap, num_species, x0, inv_dx, nc,
                           length, clamp_hi, bx, by, bz, stream);
  const bool rotate = bx != 0.0f || by != 0.0f || bz != 0.0f;
  const PairAcc acc{(float2*)pair};
  cudaError_t err = cudaSuccess;
  REPRO_DISPATCH_BOUNDARY(boundary, B, {
    if (pair == nullptr)
      err = rotate ? launch_per_slot<B, true, false>(a, acc)
                   : launch_per_slot<B, false, false>(a, acc);
    else
      err = rotate ? launch_per_slot<B, true, true>(a, acc)
                   : launch_per_slot<B, false, true>(a, acc);
  })
  if (err == cudaSuccess && pair != nullptr) {
    const int ng = nc + 1;
    pair_finish_kernel<float2><<<(ng + 255) / 256, 256, 0, a.stream>>>(
        (const float2*)pair, (float*)rho, ng);
    err = cudaGetLastError();
  }
  return (int)err;
}

// The block form: n_blocks persistent blocks, each holding the nc+1 nodes
// in its shared memory and flushing them into its row of `rows`
// (n_blocks, nc+1); a second kernel sums the rows into rho. Returns the
// first CUDA error; the caller raises if not 0.
extern "C" int fused_push_deposit_block(
    const void* x, const void* v, const void* w, const void* alive,
    const void* e, const void* qm_dt, const void* dt, const void* charge,
    void* xo, void* vo, void* wo, void* ao, void* hlo, void* hro, void* rows,
    void* rho, long long cap, int num_species, float x0, float inv_dx,
    int nc, float length, float clamp_hi, float bx, float by, float bz,
    int boundary, int n_blocks, void* stream) {
  const Args a = make_args(x, v, w, alive, e, qm_dt, dt, charge, xo, vo, wo,
                           ao, hlo, hro, cap, num_species, x0, inv_dx, nc,
                           length, clamp_hi, bx, by, bz, stream);
  const bool rotate = bx != 0.0f || by != 0.0f || bz != 0.0f;
  return by_instance(boundary, rotate, [&](auto kernel) {
    return (int)launch_blocks(kernel, n_blocks, a.stream, (const float*)rows,
                              (float*)rho, nc + 1, a.x, a.v, a.w, a.alive,
                              a.e, a.qm_dt, a.dt, a.charge, a.xo, a.vo, a.wo,
                              a.ao, a.hlo, a.hro, (float*)rows, a.cap,
                              a.num_species, a.g, a.bx, a.by, a.bz);
  });
}

// pic_common.cuh block_info for the block instance of (boundary, rotate)
// at ng nodes: out = {registers, local bytes, static shared bytes, blocks
// that fit}.
extern "C" int fused_block_info(int boundary, int rotate, int ng, int* out) {
  return by_instance(boundary, rotate != 0, [&](auto kernel) {
    return block_info(kernel, ng, out);
  });
}

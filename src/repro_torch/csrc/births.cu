// Births of the MC sources written in place: the k-th masked candidate, in
// index order, lands in the k-th dead slot, in slot order, of each target
// buffer, for k below n = min(hits, each target's free count); later
// candidates are dropped and counted. With a kill buffer, a landed
// candidate's own row dies (alive = false, w = w * 0, kill's w * alive).
//
// It replaces no TPU kernel: its origin is the reference's inject_masked
// (src/repro/core/particles.py), a free-slot scan, a gather of the slots by
// rank and a scatter of every candidate row, with a scratch row for those
// that do not land. On a 16,777,216-slot buffer that scatter moves all M
// candidate rows to write a few thousand. Here the work of the scatter
// scales with the births: one thread a birth k finds its candidate i and its
// slot j by binary search in the inclusive prefix sums the caller made (the
// hits' rank, and each target's alive count, from which the dead count
// through j is (j + 1) - alive_rank[j]) and copies one row. Nothing reads n
// on the host: every thread reads the sums' last entries, and a fixed grid
// strides over the births. See kernels/births.py for the bound.
//
// A row is copied, never computed, so the kernel gives its plain version's
// bits. No pointer is __restrict__: a target's source and the kill buffer
// may be one array (ionization reads the neutral's w, then kills it).
#include <cuda_runtime.h>

namespace {

constexpr int kMaxTargets = 2;

struct Targets {
  int count;
  long long cap[kMaxTargets];
  const int* alive_rank[kMaxTargets];   // inclusive prefix sum of alive
  float* x[kMaxTargets];
  float* v[kMaxTargets];                // (cap, 3)
  float* w[kMaxTargets];
  bool* alive[kMaxTargets];
  const float* src_x[kMaxTargets];      // (m,) candidate rows
  const float* src_v[kMaxTargets];      // (m, 3)
  const float* src_w[kMaxTargets];
};

// One step of a binary search for the smallest x in [lo, hi] with
// key(x) > k, the key non-decreasing and key(hi) > k: the hits' rank, or
// a target's dead count through x, (x + 1) - alive_rank[x].
__device__ __forceinline__ void halve(const int* rank, bool dead,
                                      long long k, long long& lo,
                                      long long& hi) {
  const long long mid = lo + (hi - lo) / 2;
  const long long key = dead ? mid + 1 - rank[mid] : rank[mid];
  if (key > k) hi = mid; else lo = mid + 1;
}

// counts[0] = n, counts[1] = hits - n; ok (m,) is zeroed and each landed
// candidate's entry set; m >= 1.
__global__ void place_births_kernel(const int* hit_rank, long long m,
                                    Targets tg, bool* kill_alive,
                                    float* kill_w, int* counts, bool* ok) {
  const int hits = hit_rank[m - 1];
  int n = hits;
  for (int t = 0; t < tg.count; ++t) {
    const long long cap = tg.cap[t];
    const int free = cap ? (int)(cap - tg.alive_rank[t][cap - 1]) : 0;
    n = min(n, free);
  }
  const long long first = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (first == 0) {
    counts[0] = n;
    counts[1] = hits - n;
  }
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long k = first; k < n; k += stride) {
    // the candidate's search and each target's run in lockstep, so that
    // their loads are in flight together
    long long lo[1 + kMaxTargets] = {}, hi[1 + kMaxTargets];
    hi[0] = m - 1;
    for (int t = 0; t < kMaxTargets; ++t) hi[1 + t] = tg.cap[t] - 1;
    for (bool busy = true; busy;) {
      busy = lo[0] < hi[0];
      if (busy) halve(hit_rank, false, k, lo[0], hi[0]);
#pragma unroll
      for (int t = 0; t < kMaxTargets; ++t) {
        if (t < tg.count && lo[1 + t] < hi[1 + t]) {
          halve(tg.alive_rank[t], true, k, lo[1 + t], hi[1 + t]);
          busy = true;
        }
      }
    }
    const long long i = lo[0];
#pragma unroll
    for (int t = 0; t < kMaxTargets; ++t) {
      if (t >= tg.count) break;
      const long long j = lo[1 + t];
      tg.x[t][j] = tg.src_x[t][i];
      tg.v[t][3 * j] = tg.src_v[t][3 * i];
      tg.v[t][3 * j + 1] = tg.src_v[t][3 * i + 1];
      tg.v[t][3 * j + 2] = tg.src_v[t][3 * i + 2];
      tg.w[t][j] = tg.src_w[t][i];
      tg.alive[t][j] = true;
    }
    ok[i] = true;
    if (kill_alive) {
      kill_alive[i] = false;
      kill_w[i] = kill_w[i] * 0.0f;
    }
  }
}

}  // namespace

// ok zeroed, then the kernel, on the stream; m >= 1 candidates,
// 1 <= count <= 2 targets. ptrs holds eight pointers a target:
// alive_rank, x, v, w, alive, src_x, src_v, src_w. kill_alive / kill_w:
// the candidates' own (m,) buffer, or null. counts (2,) int32 and ok (m,)
// bool are written. blocks: the kernel's grid, which strides over the
// births.
extern "C" int place_births(const void* hit_rank, long long m, int count,
                            const long long* caps, void* const* ptrs,
                            void* kill_alive, void* kill_w, void* counts,
                            void* ok, int blocks, void* stream) {
  constexpr int kThreads = 256;
  if (count < 1 || count > kMaxTargets) return (int)cudaErrorInvalidValue;
  Targets tg{};
  tg.count = count;
  for (int t = 0; t < count; ++t) {
    void* const* p = ptrs + 8 * t;
    tg.cap[t] = caps[t];
    tg.alive_rank[t] = (const int*)p[0];
    tg.x[t] = (float*)p[1];
    tg.v[t] = (float*)p[2];
    tg.w[t] = (float*)p[3];
    tg.alive[t] = (bool*)p[4];
    tg.src_x[t] = (const float*)p[5];
    tg.src_v[t] = (const float*)p[6];
    tg.src_w[t] = (const float*)p[7];
  }
  const cudaStream_t s = (cudaStream_t)stream;
  const int err = (int)cudaMemsetAsync(ok, 0, (size_t)m, s);
  if (err != 0) return err;
  place_births_kernel<<<blocks, kThreads, 0, s>>>(
      (const int*)hit_rank, m, tg, (bool*)kill_alive, (float*)kill_w,
      (int*)counts, (bool*)ok);
  return (int)cudaGetLastError();
}

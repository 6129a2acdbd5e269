// Flash attention: softmax(q k^T * D^-1/2, masked) v by an online softmax,
// causal and/or windowed, grouped-query (GQA) without repeating K/V.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py::_flash_kernel
// (launched by flash_attention_pallas). The TPU kernel takes heads folded
// into the batch, (b*h, s, hd), with K/V of a whole row resident in VMEM and
// the query blocks of that row run in order. Here the inputs stay in the
// model's own layout, q (B, Sq, H, D) and k, v (B, Skv, KVH, D): one block of
// 256 threads takes 64 query rows of one (b, h), query head h reads KV head
// h / (H / KVH), and K/V stream through shared memory in tiles of BK keys.
// Blocks run in parallel and carry nothing from one to the next.
//
// Arithmetic, in the Pallas kernel's order: q is cast to f32 and multiplied
// by the scale; masked scores are -1e30 (never -inf: an all-masked tile must
// give exp(-1e30 - -1e30) = 1 and be wiped later by corr = exp(-1e30 - m) =
// 0); per tile m_new = max(m, rowmax), p = exp(s - m_new), corr =
// exp(m - m_new), l = l*corr + sum(p), o = o*corr + p v; out = o /
// max(l, 1e-30). Accumulators are f32 for f32 and bf16 inputs alike. Keys at
// or beyond Skv are masked and rows at or beyond Sq are not stored, so Sq
// and Skv may be any length. The key loop stops after the diagonal tile when
// causal, as the Pallas kernel does; with a window it starts at the first
// tile that any row of the block can see (when every row of the block is
// below Skv and so sees at least one key there): the tiles it skips would
// be multiplied by an exact 0.
//
// Four threads share a row: each holds a quarter of the row's q and o (D/4
// floats each, as runs of 4 dims for 16-byte shared-memory loads), and two
// shuffles finish each dot product. The BK scores of a tile stay in
// registers. hd 256 keeps 64 + 64 + 32 floats a thread.
//
// Bound on the H100 at the main-path shape (B 8, S 4096, H 14, KVH 2, D 64,
// causal, bf16): 240.6 GFLOP (4 D flops per unmasked (q, k) pair) take
// 0.243 ms at 989 TFLOP/s of bf16 tensor cores; 0.94 G exponentials some
// 0.24 ms of special-function throughput; 134 MB of q, k, v and o 0.040 ms
// at 3.35 TB/s. So compute bounds it, at 0.243 ms. This simple design runs
// the products on CUDA cores in f32, whose ceiling is 67 TFLOP/s (3.6 ms for
// the same work); tensor cores (mma.sync / wgmma), TMA and warp
// specialisation are a later redesign.
//
// Every source compiles with -fmad=false (kernels/_build.py); the score and
// p v sums here are written as fmaf() instead. The plain version
// (kernels/flash_attention.py::flash_attention_plain) sums in another order
// anyway, and the two are held to a tolerance, not to bitwise equality.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kRows = 64;           // query rows a block
constexpr int kPart = 4;            // threads a row
constexpr int kThreads = kRows * kPart;
constexpr float kNegInf = -1e30f;

// keys a tile; kernels/flash_attention.py::BLOCK_K holds the same numbers
template <int D>
constexpr int block_k() { return D <= 64 ? 64 : 32; }

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

template <typename T, int D, int BK>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ o, int Sq, int Skv,
             int H, int KVH, int causal, int window, float scale) {
  constexpr int NC = D / 16;        // runs of 4 dims a thread holds
  extern __shared__ float smem[];
  float* ks = smem;                 // (BK, D)
  float* vs = smem + BK * D;        // (BK, D)

  const int tid = threadIdx.x;
  const int row = tid / kPart, part = tid % kPart;
  // heaviest causal blocks first
  const int qb = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KVH);
  const int q0 = qb * kRows;
  const int qpos = q0 + row;

  float qr[4 * NC], acc[4 * NC];
  const long long qoff = (((long long)b * Sq + qpos) * H + h) * D;
#pragma unroll
  for (int c = 0; c < NC; ++c) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int d = c * 16 + part * 4 + e;
      qr[c * 4 + e] = qpos < Sq ? to_f32(q[qoff + d]) * scale : 0.0f;
      acc[c * 4 + e] = 0.0f;
    }
  }
  float m = kNegInf, l = 0.0f;

  int kend = Skv;
  if (causal) kend = min(Skv, q0 + kRows);
  int kstart = 0;
  if (window > 0 && min(q0 + kRows, Sq) <= Skv)
    kstart = max(0, q0 - window + 1) / BK * BK;

  const long long kbase = (long long)b * Skv * KVH * D + (long long)kvh * D;
  for (int k0 = kstart; k0 < kend; k0 += BK) {
    __syncthreads();
    for (int idx = tid; idx < BK * D; idx += kThreads) {
      const int j = idx / D, d = idx % D;
      float kk = 0.0f, vv = 0.0f;
      if (k0 + j < Skv) {
        const long long off = kbase + (long long)(k0 + j) * KVH * D + d;
        kk = to_f32(k[off]);
        vv = to_f32(v[off]);
      }
      ks[idx] = kk;
      vs[idx] = vv;
    }
    __syncthreads();

    float s[BK];
    float mt = kNegInf;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      const float* kr = ks + j * D + part * 4;
      float a = 0.0f;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float4 kk = *reinterpret_cast<const float4*>(kr + c * 16);
        a = fmaf(qr[c * 4], kk.x, a);
        a = fmaf(qr[c * 4 + 1], kk.y, a);
        a = fmaf(qr[c * 4 + 2], kk.z, a);
        a = fmaf(qr[c * 4 + 3], kk.w, a);
      }
      a += __shfl_xor_sync(0xffffffffu, a, 1);
      a += __shfl_xor_sync(0xffffffffu, a, 2);
      const int kpos = k0 + j;
      bool ok = kpos < Skv;
      if (causal) ok = ok && kpos <= qpos;
      if (window > 0) ok = ok && kpos > qpos - window;
      s[j] = ok ? a : kNegInf;
      mt = fmaxf(mt, s[j]);
    }
    const float m_new = fmaxf(m, mt);
    const float corr = expf(m - m_new);
#pragma unroll
    for (int i = 0; i < 4 * NC; ++i) acc[i] *= corr;
    float psum = 0.0f;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      const float p = expf(s[j] - m_new);
      psum += p;
      const float* vr = vs + j * D + part * 4;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float4 vv = *reinterpret_cast<const float4*>(vr + c * 16);
        acc[c * 4] = fmaf(p, vv.x, acc[c * 4]);
        acc[c * 4 + 1] = fmaf(p, vv.y, acc[c * 4 + 1]);
        acc[c * 4 + 2] = fmaf(p, vv.z, acc[c * 4 + 2]);
        acc[c * 4 + 3] = fmaf(p, vv.w, acc[c * 4 + 3]);
      }
    }
    l = fmaf(l, corr, psum);
    m = m_new;
  }

  if (qpos >= Sq) return;
  const float denom = fmaxf(l, 1e-30f);
#pragma unroll
  for (int c = 0; c < NC; ++c) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int d = c * 16 + part * 4 + e;
      store(o + qoff + d, acc[c * 4 + e] / denom);
    }
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int Sq, int Skv, int H, int KVH, int causal, int window,
           float scale, cudaStream_t stream) {
  constexpr int BK = block_k<D>();
  constexpr int smem = 2 * BK * D * (int)sizeof(float);
  auto kern = flash_kernel<T, D, BK>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Sq + kRows - 1) / kRows, H, B);
  kern<<<grid, kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, Sq, Skv, H, KVH, causal,
      window, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_d(const void* q, const void* k, const void* v, void* o, int B,
             int Sq, int Skv, int H, int KVH, int D, int causal, int window,
             float scale, cudaStream_t stream) {
  switch (D) {
    case 16:
      return launch<T, 16>(q, k, v, o, B, Sq, Skv, H, KVH, causal, window,
                           scale, stream);
    case 32:
      return launch<T, 32>(q, k, v, o, B, Sq, Skv, H, KVH, causal, window,
                           scale, stream);
    case 64:
      return launch<T, 64>(q, k, v, o, B, Sq, Skv, H, KVH, causal, window,
                           scale, stream);
    case 128:
      return launch<T, 128>(q, k, v, o, B, Sq, Skv, H, KVH, causal, window,
                            scale, stream);
    case 256:
      return launch<T, 256>(q, k, v, o, B, Sq, Skv, H, KVH, causal, window,
                            scale, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q (B, Sq, H, D), k and v (B, Skv, KVH, D), o (B, Sq, H, D), contiguous,
// all float32 (bf16 = 0) or all bfloat16 (bf16 = 1); D in {16, 32, 64, 128,
// 256} (the model configs' head dims, smoke sizes included).
// Returns cudaGetLastError() after the launch; the caller raises if not 0.
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* o, int B, int Sq, int Skv, int H,
                               int KVH, int D, int bf16, int causal,
                               int window, float scale, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (bf16)
    return launch_d<__nv_bfloat16>(q, k, v, o, B, Sq, Skv, H, KVH, D, causal,
                                   window, scale, st);
  return launch_d<float>(q, k, v, o, B, Sq, Skv, H, KVH, D, causal, window,
                         scale, st);
}

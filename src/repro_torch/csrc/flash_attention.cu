// Flash attention: softmax(q k^T * D^-1/2, masked) v by an online softmax,
// causal and/or windowed, grouped-query (GQA) without repeating K/V.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py::_flash_kernel
// (launched by flash_attention_pallas). The TPU kernel takes heads folded
// into the batch, (b*h, s, hd), with K/V of a whole row resident in VMEM and
// the query blocks of that row run in order. Here the inputs stay in the
// model's own layout, q (B, Sq, H, D) and k, v (B, Skv, KVH, D): one block
// takes a tile of query rows of one (b, h), query head h reads KV head
// h / (H / KVH), and K/V stream through shared memory in tiles of BK keys.
// Blocks run in parallel and carry nothing from one to the next.
//
// The online softmax, in the Pallas kernel's order: masked scores are -1e30
// (never -inf: an all-masked tile must give p = 1 and be wiped later by corr
// = 0); per tile m_new = max(m, rowmax), p = exp(s - m_new), corr = exp(m -
// m_new), l = l*corr + sum(p), o = o*corr + p v; out = o / max(l, 1e-30).
// Accumulators are f32. Keys at or beyond Skv are zero-filled and masked,
// rows at or beyond Sq are not stored, so Sq and Skv may be any length. The
// key loop stops after the diagonal tile when causal, as the Pallas kernel
// does; with a window it starts at the first tile that any row of the block
// can see (when every row of the block is below Skv and so sees at least
// one key there): the tiles it skips would be multiplied by an exact 0.
//
// Two kernels, chosen by the input dtype:
//
// bf16, the serving path: Hopper's tensor cores through wgmma, fed by TMA,
// warp-specialised. A block takes 64 query rows of one (b, h) for each of
// its consumer warpgroups (two, or one at D = 256). Its first warpgroup is
// the producer: one thread issues every copy, the Q tile once and
// then K and V tiles of BK keys into a ring of STAGES slots, each a TMA
// box from a 4-d tensor map of the (B, S, heads, D) tensor (keys and rows
// past the end read as zeros), completing on the slot's "full" mbarrier.
// The consumer warpgroups take 64 rows each: they wait on "full",
// compute, and arrive on the slot's "empty" mbarrier, which the producer
// waits on before it refills the slot. S = Q K^T is wgmma m64nBKk16 with
// both operands in shared memory (K-major); O += P V is wgmma m64nDk16
// with P in registers and V in shared memory (MN-major, transposed by the
// instruction). TMA writes each tile in the swizzle (32, 64 or 128 bytes,
// the row of one box, at most 64 dims) that the wgmma descriptors read.
// The products of bf16 q and k are exact; the scale comes after, folded
// with log2(e) into one __fmaf_rn in front of exp2f. p stays (nearly) f32:
// it enters P V as two bf16 halves, p_hi = bf16(p) and p_lo = bf16(p -
// p_hi), two wgmma into one accumulator (relative error about 2^-17, 1.5x
// the MMA work of a bf16 p). The A-fragments of P are packed straight from
// S's accumulators (the wgmma accumulator layout of a warp's 16 rows is
// the A layout), so P never goes through shared memory. A row whose
// scores are all masked so far takes p = 1, as exp(s - m_new) gives in the
// Pallas kernel. A causal tile past every row of a consumer warpgroup is
// skipped by that warpgroup: it would add an exact 0.
//
// f32, the correctness route: CUDA cores, four threads a row, each holding
// a quarter of the row's q (cast to f32 and scaled first) and o, two
// shuffles finishing each dot product, expf. Tensor cores would mean TF32
// there.
//
// Bound on the H100 at the main-path shape (B 8, S 4096, H 14, KVH 2, D 64,
// causal, bf16): 240.6 GFLOP (4 D flops per unmasked (q, k) pair) take
// 0.243 ms at 989 TFLOP/s of bf16 tensor cores; 0.94 G exponentials some
// 0.24 ms of special-function throughput; 134 MB of q, k, v and o 0.040 ms
// at 3.35 TB/s. So compute bounds it, at 0.243 ms. The split p adds half
// again to the MMA work, and each consumer warpgroup runs its softmax
// between its two products instead of beside them.
//
// Every source compiles with -fmad=false (kernels/_build.py); the sums here
// are written as fmaf() / __fmaf_rn() instead. The tensor map encoder is
// the driver's, found at run time (cudaGetDriverEntryPoint), so nothing
// links libcuda. The plain version
// (kernels/flash_attention.py::flash_attention_plain) repeats each kernel's
// arithmetic by the same key tiles but sums in another order, and the two
// are held to a tolerance, not to bitwise equality.
#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

// ------------------------------------------------------------- f32 kernel --

constexpr int kRows = 64;           // query rows a block
constexpr int kPart = 4;            // threads a row
constexpr int kThreads = kRows * kPart;

// keys a tile of the f32 kernel; kernels/flash_attention.py::BLOCK_K holds
// the same numbers (a test reads this line)
template <int D>
constexpr int block_k() { return D <= 64 ? 64 : 32; }

template <int D, int BK>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, float* __restrict__ o, int Sq,
             int Skv, int H, int KVH, int causal, int window, float scale) {
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
      qr[c * 4 + e] = qpos < Sq ? q[qoff + d] * scale : 0.0f;
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
        kk = k[off];
        vv = v[off];
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
      o[qoff + d] = acc[c * 4 + e] / denom;
    }
  }
}

template <int D>
int launch_f32(const void* q, const void* k, const void* v, void* o, int B,
               int Sq, int Skv, int H, int KVH, int causal, int window,
               float scale, cudaStream_t stream) {
  constexpr int BK = block_k<D>();
  constexpr int smem = 2 * BK * D * (int)sizeof(float);
  auto kern = flash_kernel<D, BK>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Sq + kRows - 1) / kRows, H, B);
  kern<<<grid, kThreads, smem, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)o, Sq, Skv,
      H, KVH, causal, window, scale);
  return (int)cudaGetLastError();
}

// ------------------------------------------------------------ bf16 kernel --

// The bf16 kernel's tiles: CONSUMERS warpgroups of 64 query rows each
// beside the producer warpgroup, and BK keys a tile in a ring of STAGES
// slots. D 64 and 128 take the faster of the (BK, STAGES) pairs tried at
// the configs' shapes on an H100. Two consumers share the SM's
// registers by setmaxnreg, 240 each, but ptxas allocates them within the
// launch's 168: D = 256, whose o accumulator alone is 128 registers, would
// spill there, and runs one consumer with 255. kernels/flash_attention.py::
// BLOCK_K holds the same BK (a test reads these lines).
template <int D> struct MmaTile;
template <> struct MmaTile<16> { static constexpr int BK = 64, STAGES = 4, CONSUMERS = 2; };
template <> struct MmaTile<32> { static constexpr int BK = 64, STAGES = 4, CONSUMERS = 2; };
template <> struct MmaTile<64> { static constexpr int BK = 128, STAGES = 2, CONSUMERS = 2; };
template <> struct MmaTile<128> { static constexpr int BK = 64, STAGES = 3, CONSUMERS = 2; };
template <> struct MmaTile<256> { static constexpr int BK = 64, STAGES = 2, CONSUMERS = 1; };

// A tile lives in shared memory as D/64 atoms (one for D < 64) of (rows,
// RB bytes), RB = min(2 D, 128): the row of one TMA box, written by TMA in
// the matching swizzle (32, 64 or 128 bytes), which wgmma reads back.
template <int D> constexpr int atom_row_bytes() { return D < 64 ? 2 * D : 128; }
template <int D> constexpr int atoms() { return D < 64 ? 1 : D / 64; }

template <int D>
struct MmaSmem {
  static constexpr int RB = atom_row_bytes<D>(), NA = atoms<D>();
  static constexpr int BK = MmaTile<D>::BK, STAGES = MmaTile<D>::STAGES;
  static constexpr int C = MmaTile<D>::CONSUMERS;
  static constexpr int BM = 64 * C;              // query rows a block
  static constexpr int THREADS = 128 * (C + 1);  // + the producer
  static constexpr int Q = NA * BM * RB;         // the Q tile
  static constexpr int KV = NA * BK * RB;        // a K or a V tile
  static constexpr int SLOT = 2 * KV;
  static constexpr int BARS = 8 * (1 + 2 * STAGES);
  // + 1024: the base is rounded up to the 1024-byte swizzle period
  static constexpr int BYTES = 1024 + Q + STAGES * SLOT + BARS;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(bar) : "memory");
}

__device__ __forceinline__ bool mbar_try(uint32_t bar, int parity) {
  uint32_t ok;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(ok) : "r"(bar), "r"(parity) : "memory");
  return ok != 0;
}

// until the phase of parity `parity` of the barrier has completed; traps
// (an error at the next synchronise) rather than hang if it never does
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  if (mbar_try(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try(bar, parity))
    if (clock64() - t0 > (1LL << 34)) __trap();
}

// one box of a 4-d tensor map into shared memory; completes on `bar`
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         int c0, int c1, int c2, int c3,
                                         uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
         "r"(c2), "r"(c3), "r"(bar)
      : "memory");
}

// wgmma shared-memory descriptor: start address, leading and stride byte
// offsets (in bytes, stored in 16-byte units), and the swizzle of a row of
// RB bytes
template <int RB>
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  constexpr uint64_t layout = RB == 128 ? 1 : RB == 64 ? 2 : 3;
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (layout << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keep the compiler from moving reads or writes of wgmma's registers across
// the asynchronous product
template <int R>
__device__ __forceinline__ void fence_regs(float (&r)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}

// d (64 x 64 f32) = a b (+ d if scale_d): a (64 x 16) and b (16 x 64)
// bf16 in shared memory, both K-major
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (64 x 128 f32) = a b (+ d if scale_d): a (64 x 16) and b (16 x 128)
// bf16 in shared memory, both K-major
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (64 x 16 f32) += a b: a (64 x 16 bf16) in registers, b (16 x 16 bf16)
// in shared memory, MN-major
__device__ __forceinline__ void wgmma_rs_n16(float (&d)[8],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 32 f32) += a b: a (64 x 16 bf16) in registers, b (16 x 32 bf16)
// in shared memory, MN-major
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 64 f32) += a b: a (64 x 16 bf16) in registers, b (16 x 64 bf16)
// in shared memory, MN-major
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 128 f32) += a b: a (64 x 16 bf16) in registers, b (16 x 128 bf16)
// in shared memory, MN-major
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 256 f32) += a b: a (64 x 16 bf16) in registers, b (16 x 256 bf16)
// in shared memory, MN-major
__device__ __forceinline__ void wgmma_rs_n256(float (&d)[128],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da,
                                         uint64_t db, int scale_d) {
  static_assert(N == 64 || N == 128, "no wgmma_ss for this BK");
  if constexpr (N == 64) wgmma_ss_n64(d, da, db, scale_d);
  if constexpr (N == 128) wgmma_ss_n128(d, da, db, scale_d);
}

template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  static_assert(N == 16 || N == 32 || N == 64 || N == 128 || N == 256,
                "no wgmma_rs for this head dim");
  if constexpr (N == 16) wgmma_rs_n16(d, a, db);
  if constexpr (N == 32) wgmma_rs_n32(d, a, db);
  if constexpr (N == 64) wgmma_rs_n64(d, a, db);
  if constexpr (N == 128) wgmma_rs_n128(d, a, db);
  if constexpr (N == 256) wgmma_rs_n256(d, a, db);
}

__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 x) {
  return *reinterpret_cast<uint32_t*>(&x);
}

// (x, y) -> two packed bf16 pairs, hi = bf16(x, y) and lo = bf16 of what hi
// leaves out; the lower half holds x, the lower column of an A-fragment
__device__ __forceinline__ void split_p(float x, float y, uint32_t& hi,
                                        uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  hi = as_u32(h);
  lo = as_u32(__floats2bfloat162_rn(x - __low2float(h),
                                    y - __high2float(h)));
}

template <int D>
__global__ void __launch_bounds__(MmaSmem<D>::THREADS, 1)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                   const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv,
                   __nv_bfloat16* __restrict__ o, int Sq, int Skv, int H,
                   int KVH, int causal, int window, float scale_log2) {
  using L = MmaSmem<D>;
  constexpr int RB = L::RB, NA = L::NA, BK = L::BK, STAGES = L::STAGES;
  constexpr int BM = L::BM;
  constexpr int NS = BK / 8;        // 8-key column blocks of S
  extern __shared__ unsigned char smem_raw[];
  const uint32_t q_s = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t ring_s = q_s + L::Q;
  const uint32_t bars = ring_s + STAGES * L::SLOT;
  const uint32_t q_full = bars;
  auto full = [&](int s) { return bars + 8 + 8 * s; };
  auto empty = [&](int s) { return bars + 8 + 8 * STAGES + 8 * s; };

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  // heaviest causal blocks first
  const int qb = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KVH);
  const int q0 = qb * BM;

  int kend = Skv;
  if (causal) kend = min(Skv, q0 + BM);
  int kstart = 0;
  if (window > 0 && min(q0 + BM, Sq) <= Skv)
    kstart = max(0, q0 - window + 1) / BK * BK;
  const int ntiles = kend > kstart ? (kend - kstart + BK - 1) / BK : 0;

  if (tid == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 4 * L::C);  // a lane of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp < 4) {
    // producer warpgroup: one thread issues every copy; with two consumer
    // warpgroups it hands its registers over to them
    if constexpr (L::C > 1) asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (tid == 0) {
      mbar_expect_tx(q_full, L::Q);
      for (int a = 0; a < NA; ++a)
        tma_load(q_s + a * BM * RB, &tq, a * 64, h, q0, b, q_full);
      int stage = 0, phase = 0;
      for (int t = 0; t < ntiles; ++t) {
        mbar_wait(empty(stage), phase ^ 1);
        mbar_expect_tx(full(stage), L::SLOT);
        const int k0 = kstart + t * BK;
        const uint32_t ks = ring_s + stage * L::SLOT;
        for (int a = 0; a < NA; ++a) {
          tma_load(ks + a * BK * RB, &tk, a * 64, kvh, k0, b, full(stage));
          tma_load(ks + L::KV + a * BK * RB, &tv, a * 64, kvh, k0, b,
                   full(stage));
        }
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
  } else {
    // consumer warpgroups: 64 query rows each, 16 a warp
    if constexpr (L::C > 1) asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int cw = (warp >> 2) - 1, wq = warp & 3;
    const int g = lane >> 2, tig = lane & 3;
    const int w0 = q0 + cw * 64 + wq * 16;  // the warp's first row
    const int r0 = w0 + g;                  // this thread's rows r0, r0 + 8
    const int wg_last = q0 + cw * 64 + 63;

    float oacc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) oacc[i] = 0.0f;
    float m[2] = {kNegInf, kNegInf};
    float l[2] = {0.0f, 0.0f};       // this thread's part of each row's sum

    mbar_wait(q_full, 0);
    int stage = 0, phase = 0;
    for (int t = 0; t < ntiles; ++t) {
      const int k0 = kstart + t * BK;
      mbar_wait(full(stage), phase);
      // a causal tile past every row of this warpgroup adds an exact 0
      if (!(causal && k0 > wg_last)) {
        const uint32_t ks = ring_s + stage * L::SLOT, vs = ks + L::KV;
        // S = Q K^T, both K-major: 16 dims (32 bytes) a step along a row
        float s[BK / 2];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const int a = kk * 32 / RB, off = kk * 32 % RB;
          wgmma_ss<BK>(s,
                       gmma_desc<RB>(q_s + a * BM * RB + cw * 64 * RB + off,
                                     16, 8 * RB),
                       gmma_desc<RB>(ks + a * BK * RB + off, 16, 8 * RB),
                       kk > 0);
        }
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(s);

        const bool full_tile = k0 + BK <= Skv &&
                               (!causal || k0 + BK - 1 <= w0) &&
                               (window <= 0 || k0 > w0 + 15 - window);
        if (!full_tile) {
#pragma unroll
          for (int j = 0; j < NS; ++j) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int kpos = k0 + j * 8 + tig * 2 + (e & 1);
              const int qpos = r0 + (e >> 1) * 8;
              bool ok = kpos < Skv;
              if (causal) ok = ok && kpos <= qpos;
              if (window > 0) ok = ok && kpos > qpos - window;
              if (!ok) s[j * 4 + e] = kNegInf;
            }
          }
        }

        float mx[2] = {m[0], m[1]};
#pragma unroll
        for (int j = 0; j < NS; ++j) {
          mx[0] = fmaxf(mx[0], fmaxf(s[j * 4], s[j * 4 + 1]));
          mx[1] = fmaxf(mx[1], fmaxf(s[j * 4 + 2], s[j * 4 + 3]));
        }
        float cs[2], mc[2], corr[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
          // p = exp2(s*c - m*c) with c = scale*log2(e); a row masked so far
          // takes c = 0, so p = 1 there (s*c - m*c would round to +-1e22)
          cs[r] = mx[r] == kNegInf ? 0.0f : scale_log2;
          mc[r] = mx[r] * cs[r];
          corr[r] = exp2f(__fmaf_rn(m[r], cs[r], -mc[r]));
          m[r] = mx[r];
        }
        float ps[2] = {0.0f, 0.0f};
#pragma unroll
        for (int j = 0; j < NS; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = e >> 1;
            s[j * 4 + e] = exp2f(__fmaf_rn(s[j * 4 + e], cs[r], -mc[r]));
            ps[r] += s[j * 4 + e];
          }
        }
#pragma unroll
        for (int r = 0; r < 2; ++r) l[r] = __fmaf_rn(l[r], corr[r], ps[r]);
#pragma unroll
        for (int n = 0; n < D / 8; ++n) {
          oacc[n * 4] *= corr[0];
          oacc[n * 4 + 1] *= corr[0];
          oacc[n * 4 + 2] *= corr[1];
          oacc[n * 4 + 3] *= corr[1];
        }

        // O += P_hi V + P_lo V: P's A-fragments straight from S's
        // accumulators; V MN-major, 16 keys (16 rows) a step
        uint32_t hi[BK / 16][4], lo[BK / 16][4];
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            split_p(s[kk * 8 + e * 2], s[kk * 8 + e * 2 + 1], hi[kk][e],
                    lo[kk][e]);
        }
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
          const uint64_t dv = gmma_desc<RB>(vs + kk * 16 * RB, BK * RB, 8 * RB);
          wgmma_rs<D>(oacc, hi[kk], dv);
          wgmma_rs<D>(oacc, lo[kk], dv);
        }
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(oacc);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty(stage));
      if (++stage == STAGES) {
        stage = 0;
        phase ^= 1;
      }
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      const int qpos = r0 + r * 8;
      if (qpos >= Sq) continue;
      const float denom = fmaxf(l[r], 1e-30f);
      __nv_bfloat16* orow = o + (((long long)b * Sq + qpos) * H + h) * D;
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        *reinterpret_cast<__nv_bfloat162*>(orow + n * 8 + tig * 2) =
            __floats2bfloat162_rn(oacc[n * 4 + 2 * r] / denom,
                                  oacc[n * 4 + 2 * r + 1] / denom);
      }
    }
  }
}

// cuTensorMapEncodeTiled from the driver, found at run time, so that
// nothing links libcuda
PFN_cuTensorMapEncodeTiled_v12000 tensor_map_encoder() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(p);
  }
  return fn;
}

// the map of a (B, S, heads, D) bf16 tensor, boxes of (RB/2 dims, 1 head,
// rows, 1 batch) in the swizzle of an RB-byte row; rows past S read zeros
template <int D>
bool encode_map(CUtensorMap* map, const void* ptr, int B, int S, int heads,
                int rows) {
  constexpr int RB = atom_row_bytes<D>();
  const auto enc = tensor_map_encoder();
  if (!enc) return false;
  cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)heads,
                        (cuuint64_t)max(S, 1), (cuuint64_t)B};
  cuuint64_t strides[3] = {(cuuint64_t)D * 2, (cuuint64_t)heads * D * 2,
                           (cuuint64_t)max(S, 1) * heads * D * 2};
  cuuint32_t box[4] = {(cuuint32_t)RB / 2, 1, (cuuint32_t)rows, 1};
  cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle sw = RB == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
                                : RB == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                           : CU_TENSOR_MAP_SWIZZLE_32B;
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
             dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, sw,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
int launch_mma(const void* q, const void* k, const void* v, void* o, int B,
               int Sq, int Skv, int H, int KVH, int causal, int window,
               float scale, cudaStream_t stream) {
  using L = MmaSmem<D>;
  CUtensorMap tq, tk, tv;
  if (!encode_map<D>(&tq, q, B, Sq, H, L::BM) ||
      !encode_map<D>(&tk, k, B, Skv, KVH, L::BK) ||
      !encode_map<D>(&tv, v, B, Skv, KVH, L::BK))
    return (int)cudaErrorInvalidValue;
  auto kern = flash_wgmma_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, L::BYTES);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Sq + L::BM - 1) / L::BM, H, B);
  kern<<<grid, L::THREADS, L::BYTES, stream>>>(
      tq, tk, tv, (__nv_bfloat16*)o, Sq, Skv, H, KVH, causal, window,
      scale * kLog2e);
  return (int)cudaGetLastError();
}

// f(std::integral_constant<int, D>) for the runtime head dim D
template <typename F>
int by_head_dim(int D, F&& f) {
  switch (D) {
    case 16: return f(std::integral_constant<int, 16>{});
    case 32: return f(std::integral_constant<int, 32>{});
    case 64: return f(std::integral_constant<int, 64>{});
    case 128: return f(std::integral_constant<int, 128>{});
    case 256: return f(std::integral_constant<int, 256>{});
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q (B, Sq, H, D), k and v (B, Skv, KVH, D), o (B, Sq, H, D), contiguous,
// all float32 (bf16 = 0) or all bfloat16 (bf16 = 1, 16-byte aligned); D in
// {16, 32, 64, 128, 256} (the model configs' head dims, smoke sizes
// included). Returns cudaGetLastError() after the launch; the caller raises
// if not 0.
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* o, int B, int Sq, int Skv, int H,
                               int KVH, int D, int bf16, int causal,
                               int window, float scale, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  return by_head_dim(D, [&](auto d) {
    constexpr int DD = decltype(d)::value;
    return bf16 ? launch_mma<DD>(q, k, v, o, B, Sq, Skv, H, KVH, causal,
                                 window, scale, st)
                : launch_f32<DD>(q, k, v, o, B, Sq, Skv, H, KVH, causal,
                                 window, scale, st);
  });
}

// The compiled kernel for head dim D and dtype (bf16 = 1 or f32 = 0):
// out = {registers a thread, local memory bytes a thread (spills and
// stack), static shared bytes, dynamic shared bytes a launch asks}.
// Returns a cudaError_t as int.
extern "C" int flash_attention_attributes(int D, int bf16, int* out) {
  return by_head_dim(D, [&](auto d) {
    constexpr int DD = decltype(d)::value;
    cudaFuncAttributes a;
    cudaError_t err =
        bf16 ? cudaFuncGetAttributes(&a, flash_wgmma_kernel<DD>)
             : cudaFuncGetAttributes(&a, flash_kernel<DD, block_k<DD>()>);
    if (err != cudaSuccess) return (int)err;
    out[0] = a.numRegs;
    out[1] = (int)a.localSizeBytes;
    out[2] = (int)a.sharedSizeBytes;
    out[3] = bf16 ? MmaSmem<DD>::BYTES
                  : 2 * block_k<DD>() * DD * (int)sizeof(float);
    return 0;
  });
}

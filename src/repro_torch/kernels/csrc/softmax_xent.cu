// Fused LM-head cross-entropy for Hopper (sm_90a), forward and backward:
// every product on the tensor cores (wgmma) from bf16 pieces of the
// operands, accumulated in f32.
//
// Replaces the TPU kernels repro/kernels/softmax_xent.py:
// softmax_xent_fwd (Pallas body `_fwd_kernel`) and softmax_xent_bwd
// (`_bwd_dh_kernel`, `_bwd_dw_kernel`). Same function: for h [T,D],
// w [D,V] (each f32 or bf16) and labels [T],
//
//   logits = h . w   lse = logsumexp(logits)   loss = lse - logits[label]
//   ds = g * (exp(logits - lse) - onehot(label))
//   dh = ds . w^T    dw = h^T . ds
//
// in f32 (the TPU kernel upcasts both tiles), without ever holding [T, V]
// logits in device memory. A label outside [0, V) has no gold logit
// (loss = lse) and no one-hot: a model rank of the vocab-parallel CE runs
// these kernels on its shard of w with labels less its first column, and
// the backward on the global lse.
//
// What bounds it on an H100: operations. One product h . w at the train
// shape (T 4088, D 3072, V 256000) is 2TDV = 6.43 TFLOP; the tensor cores
// take it in 6.50 ms at bf16's 989 TFLOP/s, against ~2 ms for the bytes
// (the pieces of h and w, read once, written once by the split pass).
// An f32 operand enters as two bf16 pieces, x = hi + lo with hi =
// bf16_rn(x), lo = bf16_rn(x - hi), |x - hi - lo| <= 2^-16 |x|; a bf16
// operand is exact as one piece. A product of two split operands is
// hi.hi + hi.lo + lo.hi (lo.lo, ~2^-16 of the whole, dropped): 3 bf16
// products; a split and an exact operand make 2, two exact ones 1. ds is
// always split. So, in bf16 products a call (forward; backward = logits
// again + dh + dw):
//
//   h f32,  w f32  (train, ssm_train, hybrid_train)   3;  3 + 3 + 3 = 9
//   h bf16, w f32  (train_bf16: bf16 h, f32 head)      2;  2 + 3 + 2 = 7
//   h bf16, w bf16                                     1;  1 + 2 + 2 = 5
//
// The split's error, measured on the CPU (T 256, D 3072, V 4096, h ~
// N(0,1), w ~ N(0,1/D), the pieces model against the f64 product), f32 h
// and w: loss 1.5e-6, dh 1.13e-5, dw 1.02e-5 of each output's largest
// element, within half the card check's 1e-4; so two pieces an operand
// suffice. A |x| within 2^-9 of f32's largest value rounds to bf16's inf:
// hi = inf, lo = -inf, and the products it enters are NaN. h, w and ds
// never come near that; logits are never split.
//
// What the design does about the bound: one GEMM mainloop on the tensor
// cores with three epilogues.
//  * A split pass writes the bf16 pieces of each f32 operand (and a padded
//    copy of a bf16 w whose rows are not 16-byte aligned): h to [T, D], w
//    to [D, V_pad], V_pad = V rounded up to 8 (hymba's V 32001 gives rows
//    of 64002 bytes, which TMA cannot address). Pad columns are zero.
//  * The GEMM: a block computes a 128 x 256 output tile. Warpgroup 0 is
//    the producer: one thread keeps a ring of shared-memory stages full by
//    TMA (cp.async.bulk.tensor, completion on mbarriers; out-of-bounds rows
//    and columns read as zero, which masks the ragged T, V and slab edges
//    of the K sweep). Warpgroups 1 and 2 each own 64 rows and run
//    wgmma.mma_async m64n256k16 on every piece product of a 32-deep stage
//    into one f32 accumulator of 128 registers a thread, the small terms
//    first, keeping one stage's products in flight while the previous
//    stage is released. Operands are K-major (64-byte rows, 64-byte
//    swizzle) or MN-major (128-byte swizzle) as they lie in memory (wgmma
//    transposes 16-bit operands itself): no copy of h, w or ds is ever
//    transposed. Stages: as many as fit 225 KB, up to 8 (4 of 48 KB for
//    two split operands). The depth is what holds the rate: with 64-deep
//    stages only two 96 KB stages fit, and the f32 routes ran at ~50 % of
//    their bound rate against ~70 % for routes with 3-4 stages; 32-deep
//    stages brought them to ~63 % (PERF.md).
//  * forward (EPI_STATS): M = T, N = V, K = D. The epilogue reduces each
//    row's 256 columns (masked to col < V) to a partial (max, sum of exp,
//    gold) across the four lanes of a quad; a merge kernel folds the
//    V/256 partials of a token into lse and loss. The TPU kernel's
//    in-order vocab sweep does not carry over: blocks run in no order.
//  * backward: the vocab in slabs of SLAB = 8192 columns, each three GEMMs:
//    (1) EPI_DS: logits of the slab (as the forward), ds = g(exp(logit -
//    lse) - onehot) in f32, stored straight away as its two bf16 pieces in
//    a [2, T, 8192] scratch (134 MB at T 4088); (2) dh += ds . w_slab^T
//    (M = T, N = D, K = slab; A = ds K-major, B = the w pieces read
//    K-major) into an f32 accumulator; (3) dw_slab = h^T . ds (M = D,
//    N = slab, K = T; A = h read MN-major in place, B = ds MN-major), in
//    w's dtype, unpadded. 8192 rather than 4096: half the launches (32
//    slabs at V 256000) and half the dh read-modify-write, for 67 MB more
//    scratch; the dw GEMM still has 768 blocks for 132 SMs.
// TMA descriptors come from the CUDA driver API's cuTensorMapEncodeTiled,
// reached through cudaGetDriverEntryPoint, so the library needs no -lcuda.
// Still open: fusing a slab's three GEMMs, split-V for dh, TMA multicast
// of the shared operand across a cluster, a persistent schedule.

#include <cuda.h>   // CUtensorMap and the driver API's types (no -lcuda)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int BM = 128;        // output rows a block: two warpgroups of 64
constexpr int BN = 256;        // output columns a block (wgmma n256)
constexpr int BK = 32;         // K a stage: a 64-byte swizzled K-major row
constexpr int THREADS = 384;   // producer warpgroup + two consumers
constexpr int SLAB = 8192;     // vocab columns a backward slab
constexpr int SMEM_BUDGET = 225 * 1024;
constexpr float NEG_INF = (float)(-0.7 * 3.4028234663852886e38);

constexpr int A_TILE = BM * BK * 2;   // bytes of one piece's A tile
constexpr int B_TILE = BN * BK * 2;   // and of one piece's B tile
// 4 KB: 64 rows of a K-major tile (64 bytes a row), or one 64-wide chunk
// of an MN-major tile (32 K rows of 128 bytes)
constexpr int CHUNK = 64 * BK * 2;
constexpr int MAX_STAGES = 8;

__host__ __device__ constexpr int stage_bytes(int pa, int pb) {
  return pa * A_TILE + pb * B_TILE;
}
__host__ __device__ constexpr int n_stages(int pa, int pb) {
  return SMEM_BUDGET / stage_bytes(pa, pb) > MAX_STAGES
             ? MAX_STAGES
             : SMEM_BUDGET / stage_bytes(pa, pb);
}
// stages, 1 KB to align the base to the 128-byte swizzle's 1024-byte
// period, and the full and empty barriers
__host__ __device__ constexpr int smem_bytes(int pa, int pb) {
  return n_stages(pa, pb) * stage_bytes(pa, pb) + 1024 +
         16 * n_stages(pa, pb);
}

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const bf16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void st(float* p, float x) { *p = x; }
__device__ __forceinline__ void st(bf16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// ---------------------------------------------------------------------------
// mbarriers, TMA, wgmma

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count));
}

// Spin until the barrier's phase of this parity has completed. A wait
// that outlasts 20 s (a broken pipeline) traps: the launch then fails with
// an error instead of holding the card.
__device__ __forceinline__ void bar_wait(uint32_t bar, int parity) {
  uint64_t start = 0;
  for (uint32_t i = 1;; ++i) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if ((i & 0xffffu) == 0) {
      uint64_t now;
      asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(now));
      if (!start) start = now;
      else if (now - start > 20000000000ull) __trap();
    }
  }
}

__device__ __forceinline__ void bar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void bar_expect(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

// A 2-D tile of `map` at element coordinates (c0 inner, c1 outer) into
// shared memory at dst; completes `bar`'s transaction bytes.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         int c0, int c1, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

// wgmma shared-memory matrix descriptors, in 16-byte units: start
// address, leading byte offset, stride byte offset (from 8 rows to the
// next 8) and the swizzle. A K-major tile has 64-byte rows (BK = 32 bf16)
// in the 64-byte swizzle: 8 rows are 512 bytes, the leading offset is
// unused. An MN-major tile is 64-element chunks of 32 K rows of 128 bytes
// in the 128-byte swizzle: 8 K rows are 1024 bytes, and the leading offset
// is from one chunk to the next.
__device__ __forceinline__ uint64_t desc(uint32_t addr, bool mn_major) {
  const uint64_t lbo = mn_major ? CHUNK : 0, sbo = mn_major ? 1024 : 512;
  const uint64_t swizzle = mn_major ? 1 : 2;   // 128-byte : 64-byte
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((lbo >> 4) << 16) |
         ((sbo >> 4) << 32) | (swizzle << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keep the compiler from moving accumulator reads or writes across the
// asynchronous wgmma (its registers change under the compiler's feet).
__device__ __forceinline__ void fence_acc(float (&d)[128]) {
#pragma unroll
  for (int i = 0; i < 128; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d[64 x 256] += A[64 x 16] . B[16 x 256], bf16 in, f32 accumulate; TA /
// TB: the operand is MN-major (1) or K-major (0) in shared memory.
// Accumulator fragment: warp w of the warpgroup, lane l, holds rows
// 16w + l/4 (d[4j], d[4j+1]) and 16w + l/4 + 8 (d[4j+2], d[4j+3]) at
// columns 8j + 2(l%4) + {0, 1}, j = 0..31.
template <int TA, int TB>
__device__ __forceinline__ void wgmma256(float (&d)[128], uint64_t da,
                                         uint64_t db) {
#define D(i) "+f"(d[i])
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, "
      "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, "
      "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, %131, %132;\n}\n"
      : D(0), D(1), D(2), D(3), D(4), D(5), D(6), D(7),
        D(8), D(9), D(10), D(11), D(12), D(13), D(14), D(15),
        D(16), D(17), D(18), D(19), D(20), D(21), D(22), D(23),
        D(24), D(25), D(26), D(27), D(28), D(29), D(30), D(31),
        D(32), D(33), D(34), D(35), D(36), D(37), D(38), D(39),
        D(40), D(41), D(42), D(43), D(44), D(45), D(46), D(47),
        D(48), D(49), D(50), D(51), D(52), D(53), D(54), D(55),
        D(56), D(57), D(58), D(59), D(60), D(61), D(62), D(63),
        D(64), D(65), D(66), D(67), D(68), D(69), D(70), D(71),
        D(72), D(73), D(74), D(75), D(76), D(77), D(78), D(79),
        D(80), D(81), D(82), D(83), D(84), D(85), D(86), D(87),
        D(88), D(89), D(90), D(91), D(92), D(93), D(94), D(95),
        D(96), D(97), D(98), D(99), D(100), D(101), D(102), D(103),
        D(104), D(105), D(106), D(107), D(108), D(109), D(110), D(111),
        D(112), D(113), D(114), D(115), D(116), D(117), D(118), D(119),
        D(120), D(121), D(122), D(123), D(124), D(125), D(126), D(127)
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
#undef D
}

// ---------------------------------------------------------------------------
// the GEMM

enum Epi { EPI_STATS = 0, EPI_DS = 1, EPI_STORE = 2 };

struct EpiArgs {
  // EPI_STATS: partial (max, normaliser, gold) of block column tile
  // blockIdx.y, written at [blockIdx.y * M + row].
  float* part_m;
  float* part_l;
  float* part_g;
  // EPI_STATS and EPI_DS: labels [M] and the vocab column of the GEMM's
  // column 0.
  const int* labels;
  int col0;
  // EPI_DS: lse and g [M].
  const float* lse;
  const float* g;
  // EPI_DS: the two bf16 pieces of ds at C[row * ldc + col], C2 likewise.
  // EPI_STORE: C[row * ldc + col] of type TC, added to when accumulate.
  void* C;
  void* C2;
  int ldc;
  int accumulate;
};

// The bf16 pieces of the two operands: a[i] (A, [M, K]) and b[j]
// (B, [K, N]), each a 2-D map. K-major A: dims {K, M}, box {32, 128};
// MN-major A: dims {M, K}, box {64, 32}. K-major B: dims {K, N}, box
// {32, 256}; MN-major B: dims {N, K}, box {64, 32}.
struct Maps {
  CUtensorMap a[2];
  CUtensorMap b[2];
};

// C[M, N] = sum over the piece products a[i] . b[j], i + j <= 1, with one
// of three epilogues. One 128 x 256 output tile a block; grid (M tiles,
// N tiles), M fastest, so the blocks in flight share their B tiles.
template <int EPI, bool A_MN, bool B_MN, int PA, int PB, typename TC>
__global__ void __launch_bounds__(THREADS, 1)
gemm_kernel(const __grid_constant__ Maps maps, int M, int N, int K,
            EpiArgs ep) {
  constexpr int S = n_stages(PA, PB);
  constexpr int SB = stage_bytes(PA, PB);
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t full = base + S * SB;   // S barriers, then S more
  const uint32_t empty = full + 8 * S;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int nk = (K + BK - 1) / BK;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      bar_init(full + 8 * s, 1);
      bar_init(empty + 8 * s, 2);   // one arrival per consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // the producer: one thread issues every copy
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0) {
      for (int kt = 0; kt < nk; ++kt) {
        const int s = kt % S;
        bar_wait(empty + 8 * s, ((kt / S) & 1) ^ 1);
        const uint32_t fb = full + 8 * s;
        bar_expect(fb, SB);   // out-of-bounds zeros count too
        const uint32_t at = base + s * SB, bt = at + PA * A_TILE;
        const int k0 = kt * BK;
#pragma unroll
        for (int i = 0; i < PA; ++i) {
          if (A_MN) {
            tma_load(at + i * A_TILE, &maps.a[i], m0, k0, fb);
            tma_load(at + i * A_TILE + CHUNK, &maps.a[i], m0 + 64, k0, fb);
          } else {
            tma_load(at + i * A_TILE, &maps.a[i], k0, m0, fb);
          }
        }
#pragma unroll
        for (int j = 0; j < PB; ++j) {
          if (B_MN) {
#pragma unroll
            for (int c = 0; c < BN / 64; ++c)
              tma_load(bt + j * B_TILE + c * CHUNK, &maps.b[j], n0 + 64 * c,
                       k0, fb);
          } else {
            tma_load(bt + j * B_TILE, &maps.b[j], k0, n0, fb);
          }
        }
      }
    }
    return;
  }

  // a consumer: 64 rows of the tile
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int c = wg - 1;
  float acc[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.f;
  fence_acc(acc);
  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt % S;
    bar_wait(full + 8 * s, (kt / S) & 1);
    // the warpgroup's 64 rows of A: the c-th 4 KB of the tile, K-major
    // (64 rows) or MN-major (the c-th 64-wide chunk) alike
    const uint32_t at = base + s * SB + c * CHUNK;
    const uint32_t bt = base + s * SB + PA * A_TILE;
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      // a 16-deep step: 32 bytes along a K-major row, 16 K rows (2048
      // bytes) down an MN-major chunk
#pragma unroll
      for (int i = PA - 1; i >= 0; --i) {
#pragma unroll
        for (int j = PB - 1; j >= 0; --j) {
          if (i + j > 1) continue;   // lo . lo
          const uint64_t da =
              desc(at + i * A_TILE + kk * (A_MN ? 2048 : 32), A_MN);
          const uint64_t db =
              desc(bt + j * B_TILE + kk * (B_MN ? 2048 : 32), B_MN);
          wgmma256<A_MN, B_MN>(acc, da, db);
        }
      }
    }
    wg_commit();
    if (kt > 0) {   // the previous stage's products are done: release it
      wg_wait<1>();
      if (threadIdx.x % 128 == 0) bar_arrive(empty + 8 * ((kt - 1) % S));
    }
  }
  wg_wait<0>();
  fence_acc(acc);

  const int lane = threadIdx.x % 32, warp = (threadIdx.x % 128) / 32;
  const int q = lane % 4;
  const int row0 = m0 + c * 64 + warp * 16 + lane / 4;

  if (EPI == EPI_STATS) {
    // per row: max, sum of exp and gold over the tile's valid columns,
    // across the four lanes of a quad
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = row0 + 8 * half;
      const int lab = r < M ? ep.labels[r] - ep.col0 : -1;
      float mx = NEG_INF, gold = 0.f;
#pragma unroll
      for (int j = 0; j < 32; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = n0 + 8 * j + 2 * q + e;
          const float x = acc[4 * j + 2 * half + e];
          if (col < N) {
            mx = fmaxf(mx, x);
            if (col == lab) gold += x;
          }
        }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
        gold += __shfl_xor_sync(0xffffffffu, gold, off);
      }
      float l = 0.f;
#pragma unroll
      for (int j = 0; j < 32; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          if (n0 + 8 * j + 2 * q + e < N)
            l += expf(acc[4 * j + 2 * half + e] - mx);
#pragma unroll
      for (int off = 1; off < 4; off <<= 1)
        l += __shfl_xor_sync(0xffffffffu, l, off);
      if (q == 0 && r < M) {
        const size_t o = (size_t)blockIdx.y * M + r;
        ep.part_m[o] = mx;
        ep.part_l[o] = l;
        ep.part_g[o] = gold;
      }
    }
  } else if (EPI == EPI_DS) {
    bf16* hi = static_cast<bf16*>(ep.C);
    bf16* lo = static_cast<bf16*>(ep.C2);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = row0 + 8 * half;
      if (r >= M) continue;
      const float lse = ep.lse[r], g = ep.g[r];
      const int lab = ep.labels[r] - ep.col0;
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const int col = n0 + 8 * j + 2 * q;
        if (col >= N) continue;
        float v[2];
#pragma unroll
        for (int e = 0; e < 2; ++e)
          v[e] = (expf(acc[4 * j + 2 * half + e] - lse) -
                  (col + e == lab ? 1.f : 0.f)) * g;
        const __nv_bfloat162 h2 = __floats2bfloat162_rn(v[0], v[1]);
        const __nv_bfloat162 l2 = __floats2bfloat162_rn(
            v[0] - __low2float(h2), v[1] - __high2float(h2));
        const size_t o = (size_t)r * ep.ldc + col;
        if (col + 1 < N) {   // ldc and col even: 4-byte aligned pairs
          *reinterpret_cast<__nv_bfloat162*>(hi + o) = h2;
          *reinterpret_cast<__nv_bfloat162*>(lo + o) = l2;
        } else {
          hi[o] = __low2bfloat16(h2);
          lo[o] = __low2bfloat16(l2);
        }
      }
    }
  } else {
    TC* C = static_cast<TC*>(ep.C);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = row0 + 8 * half;
      if (r >= M) continue;
#pragma unroll
      for (int j = 0; j < 32; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = n0 + 8 * j + 2 * q + e;
          if (col >= N) continue;
          TC* p = C + (size_t)r * ep.ldc + col;
          const float x = acc[4 * j + 2 * half + e];
          st(p, ep.accumulate ? ld(p) + x : x);
        }
    }
  }
}

// The bf16 pieces of src [R, C] (row stride C) into hi and lo [R, Cp],
// the columns from C on zero; lo == nullptr: one piece (a padded copy).
template <typename T>
__global__ void split_kernel(const T* __restrict__ src, int R, int C,
                             bf16* __restrict__ hi, bf16* __restrict__ lo,
                             int Cp) {
  for (int r = blockIdx.y; r < R; r += gridDim.y) {
    const T* s = src + (size_t)r * C;
    const size_t o = (size_t)r * Cp;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int c = blockIdx.x * 1024 + k * 256 + threadIdx.x;
      if (c >= Cp) break;
      const float x = c < C ? ld(s + c) : 0.f;
      const bf16 h = __float2bfloat16_rn(x);
      hi[o + c] = h;
      if (lo) lo[o + c] = __float2bfloat16_rn(x - __bfloat162float(h));
    }
  }
}

// lse and loss of each token from its partials over the vocab tiles.
__global__ void merge_kernel(const float* __restrict__ part_m,
                             const float* __restrict__ part_l,
                             const float* __restrict__ part_g, int T,
                             int ntiles, float* __restrict__ loss,
                             float* __restrict__ lse) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= T) return;
  float m = NEG_INF;
  for (int i = 0; i < ntiles; ++i) m = fmaxf(m, part_m[(size_t)i * T + t]);
  float l = 0.f, gold = 0.f;
  for (int i = 0; i < ntiles; ++i) {
    const size_t o = (size_t)i * T + t;
    l += part_l[o] * expf(part_m[o] - m);
    gold += part_g[o];
  }
  const float s = m + logf(fmaxf(l, 1e-30f));
  lse[t] = s;
  loss[t] = s - gold;
}

// ---------------------------------------------------------------------------
// host side

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A bf16 matrix with rows of `inner` elements `ld` apart (ld a multiple of
// 8), `outer` rows, read in boxes of box_inner x box_outer with a 64- or
// 128-byte swizzle (box_inner x 2 bytes); out-of-bounds elements read as
// zero.
bool make_map(CUtensorMap* m, const bf16* p, int inner, int outer,
              long long ld, int box_inner, int box_outer) {
  const EncodeTiled enc = encode_tiled();
  if (!enc) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)inner, (cuuint64_t)outer};
  const cuuint64_t strides[1] = {(cuuint64_t)ld * 2};
  const cuuint32_t box[2] = {(cuuint32_t)box_inner, (cuuint32_t)box_outer};
  const cuuint32_t es[2] = {1, 1};
  return enc(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
             const_cast<bf16*>(p), dims, strides, box, es,
             CU_TENSOR_MAP_INTERLEAVE_NONE,
             box_inner == 64 ? CU_TENSOR_MAP_SWIZZLE_128B
                             : CU_TENSOR_MAP_SWIZZLE_64B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// One operand's pieces: p[0] = hi (or the bf16 operand), p[1] = lo;
// rows `ld` elements apart.
struct Pieces {
  const bf16* p[2];
  int n;
  long long ld;
};

// Maps of an operand's pieces, each offset by `off` elements along its
// rows. K-major (rows = 0 for MN-major): `inner` = K elements a row,
// `outer` rows of M or N, boxes of BK x rows. MN-major: `inner` = M or N,
// `outer` = K, boxes of 64 x BK.
bool maps_of(CUtensorMap* out, const Pieces& x, long long off, int inner,
             int outer, int rows) {
  for (int i = 0; i < x.n; ++i)
    if (!make_map(out + i, x.p[i] + off, inner, outer, x.ld,
                  rows ? BK : 64, rows ? rows : BK))
      return false;
  return true;
}

template <int EPI, bool AMN, bool BMN, int PA, int PB, typename TC>
cudaError_t gemm(const Maps& maps, int M, int N, int K, const EpiArgs& ep,
                 cudaStream_t stream) {
  constexpr int smem = smem_bytes(PA, PB);
  auto kern = gemm_kernel<EPI, AMN, BMN, PA, PB, TC>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN);
  kern<<<grid, THREADS, smem, stream>>>(maps, M, N, K, ep);
  return cudaGetLastError();
}

// The kernel for the operands' piece counts.
template <int EPI, bool AMN, bool BMN, typename TC>
cudaError_t gemm_pieces(int pa, int pb, const Maps& maps, int M, int N,
                        int K, const EpiArgs& ep, cudaStream_t stream) {
  if (pa == 2 && pb == 2)
    return gemm<EPI, AMN, BMN, 2, 2, TC>(maps, M, N, K, ep, stream);
  if (pa == 2) return gemm<EPI, AMN, BMN, 2, 1, TC>(maps, M, N, K, ep, stream);
  if (pb == 2) return gemm<EPI, AMN, BMN, 1, 2, TC>(maps, M, N, K, ep, stream);
  return gemm<EPI, AMN, BMN, 1, 1, TC>(maps, M, N, K, ep, stream);
}

// The split pass: the pieces of h [T, D] and w [D, V]. dtype 0 = f32
// (two pieces, into hp [2, T, Dp] or wp [2, D, Vp]), 1 = bf16 (read in
// place when hp or wp is null, else copied padded into hp [1, T, Dp] or
// wp [1, D, Vp]).
cudaError_t split_into(int dt, const void* src, void* dst, int R, int C,
                       int Cp, cudaStream_t stream, Pieces& out) {
  if (!dst) {
    out = {{static_cast<const bf16*>(src), nullptr}, 1, C};
    return cudaSuccess;
  }
  bf16* p = static_cast<bf16*>(dst);
  bf16* lo = dt == 0 ? p + (size_t)R * Cp : nullptr;
  out = {{p, lo}, dt == 0 ? 2 : 1, Cp};
  const dim3 grid((Cp + 1023) / 1024, R < 65535 ? R : 65535);
  if (dt == 0)
    split_kernel<float><<<grid, 256, 0, stream>>>(
        static_cast<const float*>(src), R, C, p, lo, Cp);
  else
    split_kernel<bf16><<<grid, 256, 0, stream>>>(
        static_cast<const bf16*>(src), R, C, p, nullptr, Cp);
  return cudaGetLastError();
}

cudaError_t prepare(int hdt, int wdt, const void* h, const void* w,
                    void* hp, void* wp, int T, int D, int V, int Dp, int Vp,
                    cudaStream_t stream, Pieces& ph, Pieces& pw) {
  const cudaError_t err = split_into(hdt, h, hp, T, D, Dp, stream, ph);
  if (err != cudaSuccess) return err;
  return split_into(wdt, w, wp, D, V, Vp, stream, pw);
}

// Each operand with no scratch must be bf16 with 16-byte aligned rows.
bool bad_args(int hdt, int wdt, const void* hp, const void* wp, int T,
              int D, int V, int Dp, int Vp) {
  return T <= 0 || D <= 0 || V <= 0 || Dp < D || Dp % 8 || Vp < V ||
         Vp % 8 || (unsigned)hdt > 1 || (unsigned)wdt > 1 ||
         (!hp && (hdt == 0 || D % 8)) || (!wp && (wdt == 0 || V % 8)) ||
         (V + BN - 1) / BN > 65535 || (D + BN - 1) / BN > 65535;
}

}  // namespace

extern "C" {

// Rows of the forward's f32 partials (times T).
int softmax_xent_fwd_scratch(int T, int V) {
  (void)T;
  return 3 * ((V + BN - 1) / BN);
}
// Columns of the backward's ds scratch [2, T, slab] (bf16).
int softmax_xent_bwd_slab() { return SLAB; }

// hdt, wdt: 0 = float32, 1 = bfloat16, for h and w each. Contiguous
// h [T, D], w [D, V], labels [T] int32 (a label outside [0, V) has no gold
// logit and no one-hot: the epilogues compare labels with column indices
// and never index by one; a vocab shard runs on labels - its first column).
// Dp, Vp: D and V rounded
// up to 8. hp: bf16 [2, T, Dp] when h is f32, [1, T, Dp] when h is bf16
// and D % 8 != 0, else null (h read in place); wp likewise [., D, Vp] for
// w. part: f32 scratch of softmax_xent_fwd_scratch(T, V) * T elements;
// loss and lse [T] f32.
int softmax_xent_fwd(int hdt, int wdt, const void* h, const void* w,
                     const void* labels, void* hp, void* wp, void* part,
                     void* loss, void* lse, int T, int D, int V, int Dp,
                     int Vp, void* stream) {
  if (bad_args(hdt, wdt, hp, wp, T, D, V, Dp, Vp))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Pieces ph, pw;
  cudaError_t err =
      prepare(hdt, wdt, h, w, hp, wp, T, D, V, Dp, Vp, st, ph, pw);
  if (err != cudaSuccess) return (int)err;
  Maps maps{};
  // logits [T, V] = h . w: A = h K-major, B = w MN-major
  if (!maps_of(maps.a, ph, 0, D, T, BM) ||
      !maps_of(maps.b, pw, 0, V, D, 0))
    return (int)cudaErrorInvalidValue;
  const int ntiles = (V + BN - 1) / BN;
  EpiArgs ep{};
  ep.part_m = static_cast<float*>(part);
  ep.part_l = ep.part_m + (size_t)ntiles * T;
  ep.part_g = ep.part_m + 2 * (size_t)ntiles * T;
  ep.labels = static_cast<const int*>(labels);
  err = gemm_pieces<EPI_STATS, false, true, float>(ph.n, pw.n, maps, T, V, D,
                                                   ep, st);
  if (err != cudaSuccess) return (int)err;
  merge_kernel<<<(T + 255) / 256, 256, 0, st>>>(
      ep.part_m, ep.part_l, ep.part_g, T, ntiles, static_cast<float*>(loss),
      static_cast<float*>(lse));
  return (int)cudaGetLastError();
}

// As the forward, + lse and g [T] f32; ds: bf16 scratch
// [2, T, softmax_xent_bwd_slab()]; dh_acc: f32 [T, D] (overwritten, then
// accumulated); dw [D, V] in w's dtype (overwritten).
int softmax_xent_bwd(int hdt, int wdt, const void* h, const void* w,
                     const void* labels, const void* lse, const void* g,
                     void* hp, void* wp, void* ds, void* dh_acc, void* dw,
                     int T, int D, int V, int Dp, int Vp,
                     void* stream) {
  if (bad_args(hdt, wdt, hp, wp, T, D, V, Dp, Vp))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Pieces ph, pw;
  cudaError_t err =
      prepare(hdt, wdt, h, w, hp, wp, T, D, V, Dp, Vp, st, ph, pw);
  if (err != cudaSuccess) return (int)err;
  bf16* ds_hi = static_cast<bf16*>(ds);
  const Pieces pds = {{ds_hi, ds_hi + (size_t)T * SLAB}, 2, SLAB};
  Maps m_ds{}, m_dh{}, m_dw{};
  // h as A of the logits (K-major) and of dw (MN-major), for every slab
  if (!maps_of(m_ds.a, ph, 0, D, T, BM) ||
      !maps_of(m_dw.a, ph, 0, D, T, 0))
    return (int)cudaErrorInvalidValue;
  for (int v0 = 0; v0 < V; v0 += SLAB) {
    const int n = V - v0 < SLAB ? V - v0 : SLAB;
    // (1) ds [T, n] from the logits h . w[:, v0 : v0 + n]
    EpiArgs ep{};
    ep.labels = static_cast<const int*>(labels);
    ep.col0 = v0;
    ep.lse = static_cast<const float*>(lse);
    ep.g = static_cast<const float*>(g);
    ep.C = ds_hi;
    ep.C2 = ds_hi + (size_t)T * SLAB;
    ep.ldc = SLAB;
    if (!maps_of(m_ds.b, pw, v0, n, D, 0))
      return (int)cudaErrorInvalidValue;
    err = gemm_pieces<EPI_DS, false, true, float>(ph.n, pw.n, m_ds, T, n, D,
                                                  ep, st);
    if (err != cudaSuccess) return (int)err;
    // (2) dh [T, D] (+)= ds . w_slab^T: A = ds K-major, B = w K-major
    EpiArgs eh{};
    eh.C = dh_acc;
    eh.ldc = D;
    eh.accumulate = v0 > 0;
    if (!maps_of(m_dh.a, pds, 0, n, T, BM) ||
        !maps_of(m_dh.b, pw, v0, n, D, BN))
      return (int)cudaErrorInvalidValue;
    err = pw.n == 2 ? gemm<EPI_STORE, false, false, 2, 2, float>(
                          m_dh, T, D, n, eh, st)
                    : gemm<EPI_STORE, false, false, 2, 1, float>(
                          m_dh, T, D, n, eh, st);
    if (err != cudaSuccess) return (int)err;
    // (3) dw[:, v0 : v0 + n] = h^T . ds: A = h MN-major, B = ds MN-major
    if (!maps_of(m_dw.b, pds, 0, n, T, 0))
      return (int)cudaErrorInvalidValue;
    EpiArgs ew{};
    ew.ldc = V;
    if (wdt == 0) {
      ew.C = static_cast<float*>(dw) + v0;
      err = ph.n == 2 ? gemm<EPI_STORE, true, true, 2, 2, float>(
                            m_dw, D, n, T, ew, st)
                      : gemm<EPI_STORE, true, true, 1, 2, float>(
                            m_dw, D, n, T, ew, st);
    } else {
      ew.C = static_cast<bf16*>(dw) + v0;
      err = ph.n == 2 ? gemm<EPI_STORE, true, true, 2, 2, bf16>(
                            m_dw, D, n, T, ew, st)
                      : gemm<EPI_STORE, true, true, 1, 2, bf16>(
                            m_dw, D, n, T, ew, st);
    }
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

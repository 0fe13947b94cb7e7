// Building blocks of the flash-attention kernels' tensor-core routes on
// Hopper (sm_90a): warp-level mma.sync.m16n8k16 with bf16 operands and f32
// accumulators, fragments loaded from shared memory by ldmatrix, tiles
// copied into shared memory by cp.async (16 bytes a thread, zero-filled
// past the ragged edge), the bf16 pieces of f32 tiles and fragments (the
// f32 route: x = hi + lo, three products a product), and the attention
// mask by absolute positions. Used by flash_attention_fwd.cu and
// flash_attention_bwd.cu.
//
// Fragment layouts of mma.m16n8k16 (PTX ISA), with g = lane / 4 and
// t = lane % 4:
//   A (16x16, row-major): a0 (g, 2t..2t+1), a1 (g+8, 2t..), a2 (g, 2t+8..),
//                         a3 (g+8, 2t+8..)
//   B (16x8, k x n):      b0 (k 2t..2t+1, n g), b1 (k 2t+8..2t+9, n g)
//   C (16x8, f32):        c0, c1 (g, 2t..2t+1), c2, c3 (g+8, 2t..2t+1)
// so the C fragments of two neighbouring 8-column tiles are, packed to
// bf16 pairs, the A fragment of one 16-deep step (the P.V and dS.K
// products take their left operand straight from registers).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace flash_tc {

constexpr float NEG_INF = (float)(-0.7 * 3.4028234663852886e38);
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// bf16 elements of a padded shared-memory row: HDP + 8, so that the 8
// rows one ldmatrix reads start 16 bytes apart modulo 128 (no bank
// conflicts), and every row start stays 16-byte aligned for cp.async.
template <int HDP>
__host__ __device__ constexpr int ld() {
  return HDP + 8;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x = lo: low half
  return *reinterpret_cast<uint32_t*>(&v);
}

// Four 8x8 b16 matrices; lanes 8i..8i+7 give the row addresses of matrix i.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// c += a . b on the tensor cores (bf16 in, f32 accumulate).
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The A fragment of a 16x16 block at (row r0, col c0) of a row-major
// shared tile with `ld` elements a row.
__device__ __forceinline__ void load_a(uint32_t (&a)[4],
                                       const __nv_bfloat16* tile, int ld,
                                       int r0, int c0, int lane) {
  ldsm_x4(a, tile + (r0 + (lane & 15)) * ld + c0 + (lane >> 4) * 8);
}

// B fragments of two 8-column tiles (n0, n0 + 8), 16 deep from k0, of a
// tile stored [n][k] (as K is for Q.K^T): b[0], b[1] for n0; b[2], b[3]
// for n0 + 8.
__device__ __forceinline__ void load_b_nk(uint32_t (&b)[4],
                                          const __nv_bfloat16* tile, int ld,
                                          int n0, int k0, int lane) {
  ldsm_x4(b, tile + (n0 + (lane & 7) + ((lane >> 4) << 3)) * ld + k0 +
                 ((lane >> 3) & 1) * 8);
}

// The same from a tile stored [k][n] (as V is for P.V): transposed loads.
__device__ __forceinline__ void load_b_kn(uint32_t (&b)[4],
                                          const __nv_bfloat16* tile, int ld,
                                          int k0, int n0, int lane) {
  ldsm_x4_t(b, tile + (k0 + (lane & 15)) * ld + n0 + (lane >> 4) * 8);
}

// A fragment of one 16-deep step from the f32 C fragments of two
// neighbouring 8-column tiles, each value rounded to bf16.
__device__ __forceinline__ void c_to_a(uint32_t (&a)[4], const float (&c0)[4],
                                       const float (&c1)[4]) {
  a[0] = pack_bf16(c0[0], c0[1]);
  a[1] = pack_bf16(c0[2], c0[3]);
  a[2] = pack_bf16(c1[0], c1[1]);
  a[3] = pack_bf16(c1[2], c1[3]);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Copy `rows` rows of a [*, hd] bf16 slab into a padded shared tile
// [rows][HDP + 8]: row r comes from src + r * stride (elements); rows at
// or past `valid_rows` and columns at or past hd read as zero. With hd a
// multiple of 8 (16-byte rows) each thread issues 16-byte cp.async copies
// (the caller commits and waits); otherwise it copies element by element
// and the caller's barrier publishes the tile.
template <int HDP, int THREADS>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src,
                                          size_t stride, int rows,
                                          int valid_rows, int hd, int tid) {
  constexpr int CH = HDP / 8;  // 16-byte chunks a row
  constexpr int LD = ld<HDP>();
  if (hd % 8 == 0) {
    for (int i = tid; i < rows * CH; i += THREADS) {
      const int r = i / CH, c = (i % CH) * 8;
      const bool in = r < valid_rows && c < hd;
      cp_async16(dst + r * LD + c, in ? src + (size_t)r * stride + c : src,
                 in ? 16 : 0);
    }
  } else {
    for (int i = tid; i < rows * HDP; i += THREADS) {
      const int r = i / HDP, c = i % HDP;
      dst[r * LD + c] = (r < valid_rows && c < hd)
                            ? src[(size_t)r * stride + c]
                            : __float2bfloat16(0.f);
    }
  }
}

// The f32 route's pieces. A value x is hi + lo with hi = rn(x) and lo =
// rn(x - hi), both bf16: |x - hi - lo| <= 2^-16 |x|, and a product of two
// split operands is lo.hi + hi.lo + hi.hi (lo.lo, at most 2^-18 |a| |b|,
// dropped), each exact in f32 and summed in the f32 accumulator.
__device__ __forceinline__ void split2(float a, float b, uint32_t& hi,
                                       uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);  // .x = a: low half
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(a - hf.x, b - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// c += a . b from pieces, the small terms first.
__device__ __forceinline__ void mma3(float (&c)[4], const uint32_t (&ahi)[4],
                                     const uint32_t (&alo)[4], uint32_t bh0,
                                     uint32_t bh1, uint32_t bl0,
                                     uint32_t bl1) {
  mma(c, alo, bh0, bh1);
  mma(c, ahi, bl0, bl1);
  mma(c, ahi, bh0, bh1);
}

// The hi and lo A fragments of one 16-deep step from the f32 C fragments
// of two neighbouring 8-column tiles (as c_to_a, each value split).
__device__ __forceinline__ void c_to_a_split(uint32_t (&hi)[4],
                                             uint32_t (&lo)[4],
                                             const float (&c0)[4],
                                             const float (&c1)[4]) {
  split2(c0[0], c0[1], hi[0], lo[0]);
  split2(c0[2], c0[3], hi[1], lo[1]);
  split2(c1[0], c1[1], hi[2], lo[2]);
  split2(c1[2], c1[3], hi[3], lo[3]);
}

// c[j] (8-column tile j of this warp's 16 rows) += A . B^T over the
// HDP-deep padded tiles, from pieces: A's rows r0..r0+15 of the [*][ld]
// tile pair (ah_t, al_t), B's rows (the output columns) 0..8*NT-1 of the
// pair (bh_t, bl_t).
template <int HDP, int NT>
__device__ __forceinline__ void mma3_abt(float (&c)[NT][4],
                                         const __nv_bfloat16* ah_t,
                                         const __nv_bfloat16* al_t,
                                         const __nv_bfloat16* bh_t,
                                         const __nv_bfloat16* bl_t, int r0,
                                         int lane) {
  constexpr int LD = ld<HDP>();
#pragma unroll
  for (int kk = 0; kk < HDP / 16; ++kk) {
    uint32_t ah[4], al[4];
    load_a(ah, ah_t, LD, r0, kk * 16, lane);
    load_a(al, al_t, LD, r0, kk * 16, lane);
#pragma unroll
    for (int nj = 0; nj < NT / 2; ++nj) {
      uint32_t bh[4], bl[4];
      load_b_nk(bh, bh_t, LD, nj * 16, kk * 16, lane);
      load_b_nk(bl, bl_t, LD, nj * 16, kk * 16, lane);
      mma3(c[2 * nj], ah, al, bh[0], bh[1], bl[0], bl[1]);
      mma3(c[2 * nj + 1], ah, al, bh[2], bh[3], bl[2], bl[3]);
    }
  }
}

// acc[j] (8-column tile j of the HDP outputs of this warp's 16 rows) +=
// P . B, from pieces: P is this warp's f32 C fragments p[0..NT-1] (8*NT
// deep), split in registers into the A operands; B is rows 0..8*NT-1 of
// the [*][ld] tile pair (bh_t, bl_t), read by transposed loads.
template <int HDP, int NT>
__device__ __forceinline__ void mma3_pb(float (&acc)[HDP / 8][4],
                                        const float (&p)[NT][4],
                                        const __nv_bfloat16* bh_t,
                                        const __nv_bfloat16* bl_t,
                                        int lane) {
  constexpr int LD = ld<HDP>();
#pragma unroll
  for (int kk = 0; kk < NT / 2; ++kk) {
    uint32_t ah[4], al[4];
    c_to_a_split(ah, al, p[2 * kk], p[2 * kk + 1]);
#pragma unroll
    for (int nd = 0; nd < HDP / 16; ++nd) {
      uint32_t bh[4], bl[4];
      load_b_kn(bh, bh_t, LD, kk * 16, nd * 16, lane);
      load_b_kn(bl, bl_t, LD, kk * 16, nd * 16, lane);
      mma3(acc[2 * nd], ah, al, bh[0], bh[1], bl[0], bl[1]);
      mma3(acc[2 * nd + 1], ah, al, bh[2], bh[3], bl[2], bl[3]);
    }
  }
}

// Copy `rows` rows of a [*, hd] f32 slab into an f32 staging tile
// [rows][HDP]: row r comes from src + r * stride (elements); rows at or
// past `valid_rows` and columns at or past hd read as zero. 16-byte
// cp.async copies where the slab's rows are 16-byte aligned (hd a multiple
// of 4 and src aligned; the caller commits and waits), else element by
// element (the caller's barrier publishes the tile).
template <int HDP, int THREADS>
__device__ __forceinline__ void load_tile_f32(float* dst, const float* src,
                                              size_t stride, int rows,
                                              int valid_rows, int hd,
                                              int tid) {
  constexpr int CH = HDP / 4;  // 16-byte chunks a row
  if (hd % 4 == 0 && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    for (int i = tid; i < rows * CH; i += THREADS) {
      const int r = i / CH, c = (i % CH) * 4;
      const bool in = r < valid_rows && c < hd;
      cp_async16(dst + r * HDP + c, in ? src + (size_t)r * stride + c : src,
                 in ? 16 : 0);
    }
  } else {
    for (int i = tid; i < rows * HDP; i += THREADS) {
      const int r = i / HDP, c = i % HDP;
      dst[r * HDP + c] =
          (r < valid_rows && c < hd) ? src[(size_t)r * stride + c] : 0.f;
    }
  }
}

// Split a staged f32 tile [rows][HDP], times `scale`, into its bf16 hi and
// lo tiles in the padded ldmatrix layout [rows][HDP + 8]: four values a
// thread a step, 16-byte reads and 8-byte writes.
template <int HDP, int THREADS>
__device__ __forceinline__ void split_tile(__nv_bfloat16* hi,
                                           __nv_bfloat16* lo,
                                           const float* src, int rows,
                                           float scale, int tid) {
  constexpr int CH = HDP / 4;
  constexpr int LD = ld<HDP>();
  for (int i = tid; i < rows * CH; i += THREADS) {
    const int r = i / CH, c = (i % CH) * 4;
    const float4 x = *reinterpret_cast<const float4*>(src + r * HDP + c);
    uint2 h, l;
    // __fmul_rn: the scaled value is rounded to f32 before its split (no
    // contraction into the residual's subtraction)
    split2(__fmul_rn(x.x, scale), __fmul_rn(x.y, scale), h.x, l.x);
    split2(__fmul_rn(x.z, scale), __fmul_rn(x.w, scale), h.y, l.y);
    *reinterpret_cast<uint2*>(hi + r * LD + c) = h;
    *reinterpret_cast<uint2*>(lo + r * LD + c) = l;
  }
}

__device__ __forceinline__ bool pair_ok(int qp, int kp, bool kvalid,
                                        int causal, int window) {
  return kvalid && (!causal || kp <= qp) && (window <= 0 || qp - kp < window);
}

// Whether a key at position kp (valid) can pair with any query whose
// position lies in [qmin, qmax]. Exact for a contiguous run of queries,
// conservative (never a false "no") otherwise.
__device__ __forceinline__ bool key_reaches(int kp, int qmin, int qmax,
                                           int causal, int window) {
  return (!causal || kp <= qmax) && (window <= 0 || qmin - kp < window);
}

// Whether a valid key at kp passes with every query in [qmin, qmax].
__device__ __forceinline__ bool key_passes_all(int kp, int qmin, int qmax,
                                               int causal, int window) {
  return (!causal || kp <= qmin) && (window <= 0 || qmax - kp < window);
}

// The same from the query's side, for keys with positions in [kmin, kmax].
__device__ __forceinline__ bool query_reaches(int qp, int kmin, int kmax,
                                              int causal, int window) {
  return (!causal || kmin <= qp) && (window <= 0 || qp - kmax < window);
}

// Whether a query at qp passes with every key in [kmin, kmax].
__device__ __forceinline__ bool query_passes_all(int qp, int kmin, int kmax,
                                                 int causal, int window) {
  return (!causal || kmax <= qp) && (window <= 0 || qp - kmin < window);
}

// Two bitmasks over the tiles of a sequence of n items (keys or queries,
// TILE a tile, a multiple of 32), in shared memory: bit t of reach[t / 32]
// where some item of tile t may pass the mask with some partner, and (if
// `full` is given) bit t of full[t / 32] where every item of the tile
// passes with every partner, so that the tile needs no mask at all.
// test(i) returns bit 0 and bit 1 of those for item i. One warp a tile;
// every item's test is issued before any is needed, so the prepass costs
// about one memory latency, and the main loop then skips empty tiles
// without touching device memory. Ends with a barrier.
template <int TILE, int THREADS, typename F>
__device__ __forceinline__ void build_reach(unsigned* reach, unsigned* full,
                                            int n, F test) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int ntiles = (n + TILE - 1) / TILE;
  for (int w = threadIdx.x; w < (ntiles + 31) / 32; w += THREADS) {
    reach[w] = 0;
    if (full) full[w] = 0;
  }
  __syncthreads();
#pragma unroll 2
  for (int t = warp; t < ntiles; t += THREADS / 32) {
    bool any = false, all = true;
#pragma unroll
    for (int e = 0; e < TILE / 32; ++e) {
      const int i = t * TILE + e * 32 + lane;
      const int bits = i < n ? test(i) : 0;
      any |= bits & 1;
      all &= (bits >> 1) & 1;
    }
    any = __any_sync(0xffffffffu, any);
    all = __all_sync(0xffffffffu, all);
    if (lane == 0) {
      if (any) atomicOr(&reach[t >> 5], 1u << (t & 31));
      if (all && full) atomicOr(&full[t >> 5], 1u << (t & 31));
    }
  }
  __syncthreads();
}

__device__ __forceinline__ bool bit(const unsigned* mask, int t) {
  return (mask[t >> 5] >> (t & 31)) & 1u;
}

// The first tile from t whose bit is set, or ntiles.
__device__ __forceinline__ int next_tile(const unsigned* reach, int t,
                                         int ntiles) {
  while (t < ntiles) {
    const unsigned w = reach[t >> 5] >> (t & 31);
    if (w) return t + __ffs(w) - 1;
    t = (t | 31) + 1;
  }
  return ntiles;
}

}  // namespace flash_tc

// Flash-attention forward for Hopper (sm_90a), f32 or bf16 I/O.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py:
// flash_attention_fwd (Pallas body `_fwd_kernel`). Same function: GQA
// attention masked by absolute int32 positions (causal, sliding window,
// per-key validity), online softmax in f32, emitting o [B,Sq,H,hd] in the
// input dtype and the row log-sum-exp lse [B,H,Sq] in f32. A row with no
// valid key gives o = 0 and lse = 0.
//
// Three routes, chosen by dtype and shape (fixed at build time per
// instantiation; nothing is tried at run time):
//
//  * bf16, tiled (`tc::kernel`): one block of 4 warps per (64-row query
//    tile, q head, batch); each warp owns 16 query rows. QK^T and PV run
//    on the tensor cores as mma.sync.m16n8k16 (bf16 operands, f32
//    accumulators), their fragments loaded by ldmatrix from shared
//    memory. K/V tiles of 64 keys stream through a double-buffered
//    shared ring filled by cp.async, so the next tile's copy overlaps this
//    tile's products; the online softmax stays in registers, and P goes
//    from the QK^T accumulators straight into the A operand of PV. A key
//    tile that no (query, key) pair of the block can pass is skipped
//    before its copy is issued (half the tiles of causal prefill). Query
//    tiles run longest-first.
//  * f32, tiled (`simt::fwd_kernel`): the CUDA-core kernel of the first
//    port (no TF32: the f32 contract holds); 64-row query tiles, 32-key
//    tiles staged in shared memory as f32, 4 x 4 scores a thread.
//  * split-KV (`split::kernel` + `split::combine`), f32 or bf16, for calls
//    whose G q heads x Sq queries fit 16 rows (every decode step): one
//    block per (key chunk, kv head, batch) takes the G heads of its kv
//    head together, so each cached K/V row is read once, not G times, and
//    the chunks fill the card where 64-row query tiles would leave it
//    idle. Each chunk writes a normalised partial o (f32) and its lse,
//    -inf when no key of the chunk passes the mask (so an empty chunk
//    merges with weight 0); the combine kernel merges the chunks by lse.
//
// What bounds it on an H100: at prefill (B=4, S=512, H=24, hd=128,
// causal) the work is 6.4 GFLOP: in bf16 on the tensor cores (989
// TFLOP/s) that is 6.5 us, against 10 us to move its 34 MB, so the bound
// is bytes; mma.sync, whose issue rate is below wgmma's, and the
// softmax between the two products keep the kernel well above it. At
// decode (Sq=1) the bound is bytes: the valid part of the cache, read
// once. In f32 the bound is the 67 TFLOP/s of the CUDA cores.
//
// Numerics. f32 route: s = (q * scale) . k with the scale applied to q
// first, as the TPU kernel does. Tensor-core route: s = (q . k) * scale in
// f32, the scale applied after the product (rounding q * scale to bf16
// would add an error the TPU does not make); exponentials in base 2 of
// s * log2(e). All routes: p masked explicitly, rounded to v's dtype for
// the PV product while l sums it in f32; o = acc / max(l, 1e-30);
// lse = m + log(l) where l > 0, else 0.
//
// The new kernels state their minimum blocks an SM in __launch_bounds__:
// left to itself, ptxas held some of them to 128 registers and spilled.
//
// Left for later: wgmma with TMA and a warp-specialised producer, and a
// persistent schedule over the query tiles.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "flash_tc.cuh"

namespace {

namespace ft = flash_tc;
using bf16 = __nv_bfloat16;

template <typename T> __device__ __forceinline__ float to_f32(T x);
template <> __device__ __forceinline__ float to_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(
    __nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(
    float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch's .to()
}

// ---------------------------------------------------------------------------
// f32: the CUDA-core kernel

namespace simt {

constexpr int BQ = 64;               // query rows per block
constexpr int BK = 32;               // keys per tile
constexpr int THREADS = 128;
constexpr int TX = 8;                // threads sharing one query row
constexpr int RPT = BQ / (THREADS / TX);   // rows per thread (4)
constexpr int CPT = BK / TX;               // score columns per thread (4)
using ft::NEG_INF;

template <int HDP>
constexpr size_t smem_bytes() {
  return sizeof(float) * (BQ * (HDP + 1) + BK * (HDP + 1) + BK * HDP +
                          BQ * (BK + 1)) +
         sizeof(int) * 2 * BK;
}

// HDP: head dim padded up to 16/32/64/128; columns >= hd are zero.
template <typename T, int HDP>
__global__ void __launch_bounds__(THREADS)
fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
           const T* __restrict__ v, const int* __restrict__ q_pos,
           const int* __restrict__ k_pos, const uint8_t* __restrict__ k_valid,
           T* __restrict__ o, float* __restrict__ lse, int Sq, int Sk, int H,
           int KH, int hd, float scale, int causal, int window) {
  constexpr int QS = HDP + 1;        // padded row strides
  constexpr int PS = BK + 1;
  constexpr int DPT = HDP / TX;      // output columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;                  // [BQ][QS], pre-scaled
  float* Ks = Qs + BQ * QS;          // [BK][QS]
  float* Vs = Ks + BK * QS;          // [BK][HDP]
  float* Ps = Vs + BK * HDP;         // [BQ][PS]
  int* kp_s = reinterpret_cast<int*>(Ps + BQ * PS);  // [BK] key positions
  int* kv_s = kp_s + BK;                              // [BK] key usable

  const int tid = threadIdx.x;
  const int tx = tid % TX, ty = tid / TX;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (H / KH);

  for (int i = tid; i < BQ * HDP; i += THREADS) {
    const int r = i / HDP, d = i % HDP, s = q0 + r;
    float x = 0.f;
    if (s < Sq && d < hd)
      x = to_f32(q[(((size_t)b * Sq + s) * H + h) * hd + d]) * scale;
    Qs[r * QS + d] = x;
  }

  int qp[RPT];
  bool row_ok[RPT];
  float m[RPT], l[RPT], acc[RPT][DPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int s = q0 + ty * RPT + i;
    row_ok[i] = s < Sq;
    qp[i] = row_ok[i] ? q_pos[(size_t)b * Sq + s] : 0;
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DPT; ++j) acc[i][j] = 0.f;
  }

  for (int k0 = 0; k0 < Sk; k0 += BK) {
    __syncthreads();  // the previous tile is consumed; Qs is written
    if (tid < BK) {
      const int c = k0 + tid;
      const bool valid = c < Sk && k_valid[(size_t)b * Sk + c];
      kv_s[tid] = valid;
      kp_s[tid] = valid ? k_pos[(size_t)b * Sk + c] : 0;
    }
    __syncthreads();

    bool ok[RPT][CPT];
    int any = 0;
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int c = tx + TX * j;
        const int kp = kp_s[c];
        ok[i][j] = row_ok[i] && kv_s[c] && (!causal || kp <= qp[i]) &&
                   (window <= 0 || qp[i] - kp < window);
        any |= ok[i][j];
      }
    }
    // A fully masked tile changes nothing (m, l, acc stay as they are).
    if (!__syncthreads_or(any)) continue;

    for (int i = tid; i < BK * HDP; i += THREADS) {
      const int c = i / HDP, d = i % HDP, s = k0 + c;
      float kx = 0.f, vx = 0.f;
      if (s < Sk && d < hd) {
        const size_t off = (((size_t)b * Sk + s) * KH + kh) * hd + d;
        kx = to_f32(k[off]);
        vx = to_f32(v[off]);
      }
      Ks[c * QS + d] = kx;
      Vs[c * HDP + d] = vx;
    }
    __syncthreads();

    float s_[RPT][CPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < CPT; ++j) s_[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HDP; ++d) {
      float qv[RPT], kv[CPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) qv[i] = Qs[(ty * RPT + i) * QS + d];
#pragma unroll
      for (int j = 0; j < CPT; ++j) kv[j] = Ks[(tx + TX * j) * QS + d];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < CPT; ++j) s_[i][j] = fmaf(qv[i], kv[j], s_[i][j]);
    }

    // Online softmax. A row's TX threads are 8 neighbouring lanes of one
    // warp, so xor-shuffles over 4, 2, 1 reduce exactly within the row.
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < CPT; ++j) mx = fmaxf(mx, ok[i][j] ? s_[i][j] : NEG_INF);
#pragma unroll
      for (int off = TX / 2; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const float p = ok[i][j] ? expf(s_[i][j] - m_new) : 0.f;
        rs += p;
        // p is rounded to v's dtype for the PV product; l keeps it in f32
        Ps[(ty * RPT + i) * PS + tx + TX * j] = to_f32(from_f32<T>(p));
      }
#pragma unroll
      for (int off = TX / 2; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      const float corr = expf(m[i] - m_new);
      l[i] = l[i] * corr + rs;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DPT; ++j) acc[i][j] *= corr;
    }
    // Each thread reads back only its own rows of Ps, written by the 8
    // lanes of its own row group: a warp barrier orders them.
    __syncwarp();

#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float pv[RPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) pv[i] = Ps[(ty * RPT + i) * PS + c];
#pragma unroll
      for (int j = 0; j < DPT; ++j) {
        const float vv = Vs[c * HDP + tx + TX * j];
#pragma unroll
        for (int i = 0; i < RPT; ++i) acc[i][j] = fmaf(pv[i], vv, acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    if (!row_ok[i]) continue;
    const int s = q0 + ty * RPT + i;
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < DPT; ++j) {
      const int d = tx + TX * j;
      if (d < hd)
        o[(((size_t)b * Sq + s) * H + h) * hd + d] = from_f32<T>(acc[i][j] / den);
    }
    if (tx == 0)
      lse[((size_t)b * H + h) * Sq + s] = l[i] > 0.f ? m[i] + logf(den) : 0.f;
  }
}

}  // namespace simt

// ---------------------------------------------------------------------------
// bf16: the tensor-core kernel

namespace tc {
constexpr int BQ = 64;        // query rows per block, 16 per warp
constexpr int BK = 64;        // keys per tile
constexpr int THREADS = 128;

// Shared memory: the Q tile, the K/V ring, the key positions of the ring,
// and the bitmasks of reachable and of unmasked key tiles (a word per 32).
template <int HDP>
size_t smem_bytes(int Sk) {
  return sizeof(bf16) * (BQ + 4 * BK) * ft::ld<HDP>() + sizeof(int) * 4 * BK +
         2 * sizeof(unsigned) * ((Sk + 32 * BK - 1) / (32 * BK));
}

// HDP: head dim padded to 32/64/96/128; columns >= hd are zero.
template <int HDP>
__global__ void __launch_bounds__(THREADS, 1)
kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
       const bf16* __restrict__ v, const int* __restrict__ q_pos,
       const int* __restrict__ k_pos, const uint8_t* __restrict__ k_valid,
       bf16* __restrict__ o, float* __restrict__ lse, int Sq, int Sk, int H,
       int KH, int hd, float scale, int causal, int window) {
  constexpr int LD = ft::ld<HDP>();
  constexpr int NT = BK / 8;       // 8-key score tiles a warp
  constexpr int NO = HDP / 8;      // 8-column output tiles a warp
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);      // [BQ][LD]
  bf16* Ks = Qs + BQ * LD;                            // [2][BK][LD]
  bf16* Vs = Ks + 2 * BK * LD;                        // [2][BK][LD]
  int* kp_s = reinterpret_cast<int*>(Vs + 2 * BK * LD);  // [2][BK]
  int* kv_s = kp_s + 2 * BK;                             // [2][BK]
  const int nkt = (Sk + BK - 1) / BK;
  unsigned* reach = reinterpret_cast<unsigned*>(kv_s + 2 * BK);
  unsigned* full = reach + (nkt + 31) / 32;
  __shared__ int wmin[THREADS / 32], wmax[THREADS / 32];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // longest rows first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (H / KH);
  const int nq = min(BQ, Sq - q0);
  const size_t kstride = (size_t)KH * hd;

  const int* kpos = k_pos + (size_t)b * Sk;
  const uint8_t* kval = k_valid + (size_t)b * Sk;
  // a tile's key positions travel in registers while the tile before it
  // is computed, and land in kp_s / kv_s[buf] after
  int kp_r = 0, kv_r = 0;
  auto fetch_pos = [&](int t) {
    const int c = t * BK + tid;
    if (tid < BK && c < Sk) {
      kp_r = kpos[c];
      kv_r = kval[c];
    } else {
      kv_r = 0;
    }
  };
  auto stage_pos = [&](int buf) {
    if (tid < BK) {
      kp_s[buf * BK + tid] = kp_r;
      kv_s[buf * BK + tid] = kv_r;
    }
  };
  auto load_kv = [&](int t, int buf) {
    const int k0 = t * BK;
    const size_t off = (((size_t)b * Sk + k0) * KH + kh) * hd;
    const int nk = min(BK, Sk - k0);
    ft::load_tile<HDP, THREADS>(Ks + buf * BK * LD, k + off, kstride, BK, nk,
                                hd, tid);
    ft::load_tile<HDP, THREADS>(Vs + buf * BK * LD, v + off, kstride, BK, nk,
                                hd, tid);
    ft::cp_async_commit();
  };

  // Q and, before anything is known, key tile 0 (the first tile of every
  // causal block; elsewhere the copy is dropped), so that their latency
  // overlaps the prologue's own loads
  ft::load_tile<HDP, THREADS>(Qs, q + (((size_t)b * Sq + q0) * H + h) * hd,
                              (size_t)H * hd, BQ, nq, hd, tid);
  load_kv(0, 0);
  fetch_pos(0);

  // this thread's two query rows (g and g + 8 of its warp's 16)
  const int g = lane >> 2, t4 = lane & 3;
  const int r0 = warp * 16 + g, r1 = r0 + 8;
  const bool ok0 = r0 < nq, ok1 = r1 < nq;
  const int qp0 = ok0 ? q_pos[(size_t)b * Sq + q0 + r0] : 0;
  const int qp1 = ok1 ? q_pos[(size_t)b * Sq + q0 + r1] : 0;

  // the block's position range, for skipping key tiles no pair can pass
  int mn = INT_MAX, mx = INT_MIN;
  if (tid < nq) mn = mx = q_pos[(size_t)b * Sq + q0 + tid];
  mn = __reduce_min_sync(0xffffffffu, mn);
  mx = __reduce_max_sync(0xffffffffu, mx);
  if (lane == 0) {
    wmin[warp] = mn;
    wmax[warp] = mx;
  }
  __syncthreads();
  int qmin = wmin[0], qmax = wmax[0];
#pragma unroll
  for (int w = 1; w < THREADS / 32; ++w) {
    qmin = min(qmin, wmin[w]);
    qmax = max(qmax, wmax[w]);
  }

  // the key tiles some pair of the block may pass, and those every pair
  // passes (one memory latency)
  ft::build_reach<BK, THREADS>(reach, full, Sk, [&](int c) {
    const int kp = kpos[c];
    const bool valid = kval[c];
    return (valid && ft::key_reaches(kp, qmin, qmax, causal, window)) |
           (valid && ft::key_passes_all(kp, qmin, qmax, causal, window)) << 1;
  });
  float acc[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j)
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  float m0 = ft::NEG_INF, m1 = ft::NEG_INF, l0 = 0.f, l1 = 0.f;
  const float sl2 = scale * ft::LOG2E;

  int buf = 0;
  int t = ft::next_tile(reach, 0, nkt);
  if (t > 0 && t < nkt) {   // tile 0 is not needed: copy the first tile
    ft::cp_async_wait<0>();   // (each thread's tile-0 copy lands first)
    load_kv(t, 0);
    fetch_pos(t);
  }
  stage_pos(0);
  // Q's A fragments stay in registers for every tile
  uint32_t qf[HDP / 16][4];
  if (t < nkt) {
    ft::cp_async_wait<0>();
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < HDP / 16; ++kk)
      ft::load_a(qf[kk], Qs, LD, warp * 16, kk * 16, lane);
  }
  while (t < nkt) {
    const int tn = ft::next_tile(reach, t + 1, nkt);
    if (tn < nkt) {
      load_kv(tn, buf ^ 1);
      fetch_pos(tn);
      ft::cp_async_wait<1>();   // all but the copy just issued have landed
    } else {
      ft::cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* Kb = Ks + buf * BK * LD;
    const bf16* Vb = Vs + buf * BK * LD;
    const int* kpb = kp_s + buf * BK;
    const int* kvb = kv_s + buf * BK;

    // S = Q K^T on the tensor cores
    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < HDP / 16; ++kk) {
#pragma unroll
      for (int nj = 0; nj < NT / 2; ++nj) {
        uint32_t bb[4];
        ft::load_b_nk(bb, Kb, LD, nj * 16, kk * 16, lane);
        ft::mma(s[2 * nj], qf[kk], bb[0], bb[1]);
        ft::mma(s[2 * nj + 1], qf[kk], bb[2], bb[3]);
      }
    }

    // mask (not on a tile every pair passes); s * scale in base-2 units; a
    // masked pair becomes -inf, so its p = exp2(-inf - m) is exactly 0.
    // (Rows past Sq stay unmasked on a full tile: never written.)
    float mx0 = -INFINITY, mx1 = -INFINITY;
    if (ft::bit(full, t)) {
#pragma unroll
      for (int j = 0; j < NT; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          s[j][e] *= sl2;
          s[j][2 + e] *= sl2;
          mx0 = fmaxf(mx0, s[j][e]);
          mx1 = fmaxf(mx1, s[j][2 + e]);
        }
      }
    } else {
#pragma unroll
      for (int j = 0; j < NT; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = j * 8 + t4 * 2 + e;
          const int kp = kpb[c];
          const bool kv = kvb[c];
          s[j][e] = (ok0 && ft::pair_ok(qp0, kp, kv, causal, window))
                        ? s[j][e] * sl2 : -INFINITY;
          s[j][2 + e] = (ok1 && ft::pair_ok(qp1, kp, kv, causal, window))
                            ? s[j][2 + e] * sl2 : -INFINITY;
          mx0 = fmaxf(mx0, s[j][e]);
          mx1 = fmaxf(mx1, s[j][2 + e]);
        }
      }
    }
    // a row's 16 columns lie in the 4 lanes of one quad
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float c0 = exp2f(m0 - mn0), c1 = exp2f(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      s[j][0] = exp2f(s[j][0] - mn0);
      s[j][1] = exp2f(s[j][1] - mn0);
      s[j][2] = exp2f(s[j][2] - mn1);
      s[j][3] = exp2f(s[j][3] - mn1);
      rs0 += s[j][0] + s[j][1];
      rs1 += s[j][2] + s[j][3];
    }
    l0 = l0 * c0 + rs0;   // this lane's columns; the quad sums at the end
    l1 = l1 * c1 + rs1;
#pragma unroll
    for (int j = 0; j < NO; ++j) {
      acc[j][0] *= c0;
      acc[j][1] *= c0;
      acc[j][2] *= c1;
      acc[j][3] *= c1;
    }

    // O += P V: p rounded to bf16 as the A operand, V^T by transposed loads
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t a[4];
      ft::c_to_a(a, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int nd = 0; nd < HDP / 16; ++nd) {
        uint32_t bb[4];
        ft::load_b_kn(bb, Vb, LD, kk * 16, nd * 16, lane);
        ft::mma(acc[2 * nd], a, bb[0], bb[1]);
        ft::mma(acc[2 * nd + 1], a, bb[2], bb[3]);
      }
    }
    if (tn < nkt) stage_pos(buf ^ 1);
    __syncthreads();   // this buffer is consumed before it is refilled
    t = tn;
    buf ^= 1;
  }
  ft::cp_async_wait<0>();   // a block with no tile still copied its Q

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
  const float i0 = 1.f / d0, i1 = 1.f / d1;   // o is rounded to bf16 after
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const bool ok = half ? ok1 : ok0;
    if (!ok) continue;
    const int r = half ? r1 : r0;
    const float den = half ? d1 : d0, inv = half ? i1 : i0;
    bf16* orow = o + (((size_t)b * Sq + q0 + r) * H + h) * hd;
#pragma unroll
    for (int j = 0; j < NO; ++j) {
      const int c = j * 8 + t4 * 2;
      const float x0 = acc[j][2 * half] * inv, x1 = acc[j][2 * half + 1] * inv;
      if (c + 1 < hd && hd % 2 == 0) {
        *reinterpret_cast<__nv_bfloat162*>(orow + c) =
            __floats2bfloat162_rn(x0, x1);
      } else {
        if (c < hd) orow[c] = __float2bfloat16(x0);
        if (c + 1 < hd) orow[c + 1] = __float2bfloat16(x1);
      }
    }
    const float l = half ? l1 : l0, m = half ? m1 : m0;
    if (t4 == 0)
      lse[((size_t)b * H + h) * Sq + q0 + r] =
          l > 0.f ? m * ft::LN2 + logf(den) : 0.f;
  }
}
}  // namespace tc

// ---------------------------------------------------------------------------
// split-KV: one block per (key chunk, kv head, batch), then a combine

namespace split {
constexpr int ROWS = 16;      // G q heads x Sq queries a block, at most
constexpr int TK = 64;        // keys per tile
constexpr int THREADS = 128;

// K/V rows stay in their own dtype in shared memory, padded by 16 bytes so
// that a thread per key reading 16-byte vectors of its row meets no bank
// conflict.
template <typename T>
__host__ __device__ constexpr int vec() {
  return 16 / (int)sizeof(T);
}

template <typename T, int HDP>
size_t smem_bytes(int chunk) {
  return sizeof(T) * 2 * TK * (HDP + vec<T>()) +
         sizeof(float) * (ROWS * HDP + ROWS * (TK + 1) + 3 * ROWS) +
         sizeof(int) * (2 * TK + ROWS) +
         sizeof(unsigned) * ((chunk + 32 * TK - 1) / (32 * TK));
}

__device__ __forceinline__ void load_vec(const float* p, float (&x)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  x[0] = v.x;
  x[1] = v.y;
  x[2] = v.z;
  x[3] = v.w;
}

__device__ __forceinline__ void load_vec(const bf16* p, float (&x)[8]) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}

// Copy a tile of TK rows ([*, hd] in T, `stride` elements apart) into the
// padded shared tile; rows at or past `valid` and columns at or past hd
// read as zero. 16-byte cp.async copies where rows are 16-byte multiples,
// else element by element (the caller commits, waits and syncs).
template <typename T, int HDP>
__device__ __forceinline__ void load_rows(T* dst, const T* src, size_t stride,
                                          int valid, int hd, int tid) {
  constexpr int VEC = vec<T>(), LDT = HDP + VEC, CH = HDP / VEC;
  if (hd % VEC == 0) {
    for (int i = tid; i < TK * CH; i += THREADS) {
      const int r = i / CH, c = (i % CH) * VEC;
      const bool in = r < valid && c < hd;
      ft::cp_async16(dst + r * LDT + c,
                     in ? src + (size_t)r * stride + c : src, in ? 16 : 0);
    }
  } else {
    for (int i = tid; i < TK * HDP; i += THREADS) {
      const int r = i / HDP, c = i % HDP;
      dst[r * LDT + c] = (r < valid && c < hd) ? src[(size_t)r * stride + c]
                                               : from_f32<T>(0.f);
    }
  }
}

// HDP: head dim padded to 32/64/128; columns >= hd are zero. Row r of a
// block is query r / G of q head kh * G + r % G.
template <typename T, int HDP>
__global__ void __launch_bounds__(THREADS, 1)
kernel(const T* __restrict__ q, const T* __restrict__ k,
       const T* __restrict__ v, const int* __restrict__ q_pos,
       const int* __restrict__ k_pos, const uint8_t* __restrict__ k_valid,
       float* __restrict__ o_part, float* __restrict__ lse_part, int Sq,
       int Sk, int H, int KH, int hd, float scale, int causal, int window,
       int chunk) {
  constexpr int VEC = vec<T>();
  constexpr int LDT = HDP + VEC;
  constexpr int PS = TK + 1;
  constexpr int RG = THREADS / HDP;      // row groups of the PV product
  constexpr int RPT = ROWS / RG;         // rows a thread accumulates
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Ks = reinterpret_cast<T*>(smem_raw);            // [TK][LDT]
  T* Vs = Ks + TK * LDT;                             // [TK][LDT]
  float* Qs = reinterpret_cast<float*>(Vs + TK * LDT);   // [ROWS][HDP]
  float* Ps = Qs + ROWS * HDP;           // [ROWS][PS]
  float* m_s = Ps + ROWS * PS;           // [ROWS] running max
  float* l_s = m_s + ROWS;               // [ROWS] running sum
  float* c_s = l_s + ROWS;               // [ROWS] this tile's correction
  int* kp_s = reinterpret_cast<int*>(c_s + ROWS);   // [TK]
  int* kv_s = kp_s + TK;                            // [TK]
  int* qp_s = kv_s + TK;                            // [ROWS]
  unsigned* reach = reinterpret_cast<unsigned*>(qp_s + ROWS);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int c = blockIdx.x, nc = gridDim.x, kh = blockIdx.y, b = blockIdx.z;
  const int G = H / KH, R = G * Sq;
  const int kbeg = c * chunk, kend = min(Sk, kbeg + chunk);
  const int* kpos = k_pos + (size_t)b * Sk + kbeg;
  const uint8_t* kval = k_valid + (size_t)b * Sk + kbeg;
  const int nt = (kend - kbeg + TK - 1) / TK;

  // a tile's key positions (plain loads) and its K/V rows (cp.async)
  auto load_pos = [&](int t) {
    if (tid < TK) {
      const int c = t * TK + tid;
      const bool in = c < kend - kbeg;
      kp_s[tid] = in ? kpos[c] : 0;
      kv_s[tid] = in && kval[c];
    }
  };
  auto load_kv = [&](int t) {
    const int k0 = kbeg + t * TK, nk = min(TK, kend - k0);
    const size_t off = (((size_t)b * Sk + k0) * KH + kh) * hd;
    load_rows<T, HDP>(Ks, k + off, (size_t)KH * hd, nk, hd, tid);
    load_rows<T, HDP>(Vs, v + off, (size_t)KH * hd, nk, hd, tid);
    ft::cp_async_commit();
  };
  // the first tile's positions load beside the queries' (one latency)
  load_pos(0);

  for (int i = tid; i < ROWS * HDP; i += THREADS) {
    const int r = i / HDP, d = i % HDP;
    float x = 0.f;
    if (r < R && d < hd)
      x = to_f32(q[(((size_t)b * Sq + r / G) * H + kh * G + r % G) * hd + d]) *
          scale;
    Qs[r * HDP + d] = x;
  }
  if (tid < ROWS) {
    qp_s[tid] = tid < R ? q_pos[(size_t)b * Sq + tid / G] : 0;
    m_s[tid] = ft::NEG_INF;
    l_s[tid] = 0.f;
  }
  __syncthreads();
  int qmin = qp_s[0], qmax = qp_s[0];
  for (int r = 1; r < R; ++r) {
    qmin = min(qmin, qp_s[r]);
    qmax = max(qmax, qp_s[r]);
  }
  // the chunk's tiles some pair may pass: empty ones are never copied
  if (nt == 1) {   // one tile, whose positions this thread staged itself
    const bool any = tid < TK && kv_s[tid] &&
                     ft::key_reaches(kp_s[tid], qmin, qmax, causal, window);
    const int reached = __syncthreads_or(any);
    if (tid == 0) reach[0] = reached ? 1u : 0u;
    __syncthreads();
  } else {
    ft::build_reach<TK, THREADS>(reach, nullptr, kend - kbeg, [&](int i) {
      const int kp = kpos[i];
      return (int)(kval[i] &&
                   ft::key_reaches(kp, qmin, qmax, causal, window));
    });
  }

  const int dcol = tid % HDP, rg = tid / HDP;
  float acc[RPT];
#pragma unroll
  for (int j = 0; j < RPT; ++j) acc[j] = 0.f;

  for (int t = ft::next_tile(reach, 0, nt); t < nt;
       t = ft::next_tile(reach, t + 1, nt)) {
    load_kv(t);
    if (t > 0) load_pos(t);   // tile 0's are staged already
    ft::cp_async_wait<0>();
    __syncthreads();

    // scores: thread -> one key, rows tid / TK, + 2, ...; 16-byte reads
    {
      const int key = tid % TK;
      const int kp = kp_s[key];
      const bool kv = kv_s[key];
      const T* krow = Ks + key * LDT;
      for (int r = tid / TK; r < R; r += THREADS / TK) {
        const float* qrow = Qs + r * HDP;
        float s = 0.f;
#pragma unroll 4
        for (int d = 0; d < HDP; d += VEC) {
          float kx[VEC];
          load_vec(krow + d, kx);
#pragma unroll
          for (int e = 0; e < VEC; ++e) s = fmaf(qrow[d + e], kx[e], s);
        }
        Ps[r * PS + key] =
            ft::pair_ok(qp_s[r], kp, kv, causal, window) ? s : -INFINITY;
      }
    }
    __syncthreads();

    // online softmax: warp w takes rows w, w + 4, ...
    for (int r = warp; r < R; r += THREADS / 32) {
      const float x0 = Ps[r * PS + lane], x1 = Ps[r * PS + lane + 32];
      float mx = fmaxf(x0, x1);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, mx);
      const float p0 = expf(x0 - m_new), p1 = expf(x1 - m_new);  // -inf -> 0
      float rs = p0 + p1;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      // p is rounded to v's dtype for the PV product; l keeps it in f32
      Ps[r * PS + lane] = to_f32(from_f32<T>(p0));
      Ps[r * PS + lane + 32] = to_f32(from_f32<T>(p1));
      __syncwarp();
      if (lane == 0) {
        const float corr = expf(m_old - m_new);
        c_s[r] = corr;
        l_s[r] = l_s[r] * corr + rs;
        m_s[r] = m_new;
      }
    }
    __syncthreads();

    // acc += P V: thread -> one column, rows rg, rg + RG, ...
#pragma unroll
    for (int j = 0; j < RPT; ++j) {
      const int r = rg + j * RG;
      if (r >= R) break;
      float a = acc[j] * c_s[r];
#pragma unroll 8
      for (int key = 0; key < TK; ++key)
        a = fmaf(Ps[r * PS + key], to_f32(Vs[key * LDT + dcol]), a);
      acc[j] = a;
    }
    __syncthreads();   // the tile is consumed before the next copy
  }

  // the chunk's partial: o normalised in f32, lse = -inf when no key passed
  const size_t row0 = ((size_t)(b * KH + kh) * nc + c) * R;
#pragma unroll
  for (int j = 0; j < RPT; ++j) {
    const int r = rg + j * RG;
    if (r >= R) break;
    if (dcol < hd)
      o_part[(row0 + r) * hd + dcol] = acc[j] / fmaxf(l_s[r], 1e-30f);
  }
  if (tid < R) {
    const float l = l_s[tid];
    lse_part[row0 + tid] = l > 0.f ? m_s[tid] + logf(l) : -INFINITY;
  }
}

// One block per output row (b, query, q head), a thread per column:
// merges the chunks' partials by their lse into o (T) and lse in the TPU
// kernel's form. Chunks are read 8 at a time, every load of a batch
// issued before any is used.
template <typename T>
__global__ void __launch_bounds__(THREADS)
combine(const float* __restrict__ o_part, const float* __restrict__ lse_part,
        T* __restrict__ o, float* __restrict__ lse, int B, int Sq, int H,
        int KH, int hd, int nc) {
  constexpr int NB = 8;
  const int G = H / KH, R = G * Sq;
  const int row = blockIdx.x, d = threadIdx.x;
  const int b = row / (KH * R), kh = (row / R) % KH, r = row % R;
  const int i = r / G, h = kh * G + r % G;
  const size_t first = (size_t)(b * KH + kh) * nc * R + r;   // chunk 0
  float m = -INFINITY;
  for (int c0 = 0; c0 < nc; c0 += NB) {
    float l[NB];
#pragma unroll
    for (int j = 0; j < NB; ++j)
      l[j] = c0 + j < nc ? lse_part[first + (size_t)(c0 + j) * R] : -INFINITY;
#pragma unroll
    for (int j = 0; j < NB; ++j) m = fmaxf(m, l[j]);
  }
  T* orow = o + (((size_t)b * Sq + i) * H + h) * hd;
  const size_t lrow = ((size_t)b * H + h) * Sq + i;
  if (m == -INFINITY) {   // no key of any chunk: o = 0, lse = 0
    if (d < hd) orow[d] = from_f32<T>(0.f);
    if (d == 0) lse[lrow] = 0.f;
    return;
  }
  float a = 0.f, wsum = 0.f;   // an empty chunk (lse -inf) has weight 0
  for (int c0 = 0; c0 < nc; c0 += NB) {
    float l[NB], x[NB];
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      const bool in = c0 + j < nc;
      const size_t pr = first + (size_t)(c0 + j) * R;
      l[j] = in ? lse_part[pr] : -INFINITY;
      x[j] = in && d < hd ? o_part[pr * hd + d] : 0.f;
    }
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      const float w = expf(l[j] - m);
      wsum += w;
      a = fmaf(w, x[j], a);
    }
  }
  if (d < hd) orow[d] = from_f32<T>(a / wsum);
  if (d == 0) lse[lrow] = m + logf(wsum);
}
}  // namespace split

// ---------------------------------------------------------------------------
// launches

template <typename K>
cudaError_t allow_smem(K kernel_fn, size_t smem) {
  return cudaFuncSetAttribute(kernel_fn,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

template <int HDP>
cudaError_t launch_simt(const void* q, const void* k, const void* v,
                        const void* q_pos, const void* k_pos,
                        const void* k_valid, void* o, void* lse, int B,
                        int Sq, int Sk, int H, int KH, int hd, float scale,
                        int causal, int window, cudaStream_t stream) {
  const size_t smem = simt::smem_bytes<HDP>();
  cudaError_t err = allow_smem(simt::fwd_kernel<float, HDP>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + simt::BQ - 1) / simt::BQ, H, B);
  simt::fwd_kernel<float, HDP><<<grid, simt::THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const int*>(q_pos),
      static_cast<const int*>(k_pos), static_cast<const uint8_t*>(k_valid),
      static_cast<float*>(o), static_cast<float*>(lse), Sq, Sk, H, KH, hd,
      scale, causal, window);
  return cudaGetLastError();
}

template <int HDP>
cudaError_t launch_tc(const void* q, const void* k, const void* v,
                      const void* q_pos, const void* k_pos,
                      const void* k_valid, void* o, void* lse, int B, int Sq,
                      int Sk, int H, int KH, int hd, float scale, int causal,
                      int window, cudaStream_t stream) {
  const size_t smem = tc::smem_bytes<HDP>(Sk);
  cudaError_t err = allow_smem(tc::kernel<HDP>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + tc::BQ - 1) / tc::BQ, H, B);
  tc::kernel<HDP><<<grid, tc::THREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const int*>(q_pos),
      static_cast<const int*>(k_pos), static_cast<const uint8_t*>(k_valid),
      static_cast<bf16*>(o), static_cast<float*>(lse), Sq, Sk, H, KH, hd,
      scale, causal, window);
  return cudaGetLastError();
}

template <typename T, int HDP>
cudaError_t launch_split(const void* q, const void* k, const void* v,
                         const void* q_pos, const void* k_pos,
                         const void* k_valid, void* o, void* lse,
                         void* o_part, void* lse_part, int B, int Sq, int Sk,
                         int H, int KH, int hd, float scale, int causal,
                         int window, int nc, int chunk, cudaStream_t stream) {
  const size_t smem = split::smem_bytes<T, HDP>(chunk);
  cudaError_t err = allow_smem(split::kernel<T, HDP>, smem);
  if (err != cudaSuccess) return err;
  split::kernel<T, HDP><<<dim3(nc, KH, B), split::THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(q_pos),
      static_cast<const int*>(k_pos), static_cast<const uint8_t*>(k_valid),
      static_cast<float*>(o_part), static_cast<float*>(lse_part), Sq, Sk, H,
      KH, hd, scale, causal, window, chunk);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int rows = B * H * Sq;   // = B * KH * (G * Sq); hd <= THREADS
  split::combine<T><<<rows, split::THREADS, 0, stream>>>(
      static_cast<const float*>(o_part), static_cast<const float*>(lse_part),
      static_cast<T*>(o), static_cast<float*>(lse), B, Sq, H, KH, hd, nc);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The tiled routes. dtype: 0 = float32 (CUDA cores), 1 = bfloat16 (tensor
// cores). Tensors are contiguous: q/o [B,Sq,H,hd], k/v [B,Sk,KH,hd], q_pos
// [B,Sq] and k_pos [B,Sk] int32, k_valid [B,Sk] bool (one byte each), lse
// [B,H,Sq] f32. Launches on `stream` without synchronising and returns
// cudaGetLastError().
int flash_attention_fwd(int dtype, const void* q, const void* k,
                        const void* v, const void* q_pos, const void* k_pos,
                        const void* k_valid, void* o, void* lse, int B,
                        int Sq, int Sk, int H, int KH, int hd, float scale,
                        int causal, int window, void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || H <= 0 || KH <= 0 || H % KH != 0 ||
      hd <= 0 || hd > 128 || B > 65535 || H > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define REPRO_FA_ARGS                                                        \
  q, k, v, q_pos, k_pos, k_valid, o, lse, B, Sq, Sk, H, KH, hd, scale,      \
      causal, window, st
  if (dtype == 0) {
    if (hd <= 16) return (int)launch_simt<16>(REPRO_FA_ARGS);
    if (hd <= 32) return (int)launch_simt<32>(REPRO_FA_ARGS);
    if (hd <= 64) return (int)launch_simt<64>(REPRO_FA_ARGS);
    return (int)launch_simt<128>(REPRO_FA_ARGS);
  }
  if (dtype == 1) {
    if (hd <= 32) return (int)launch_tc<32>(REPRO_FA_ARGS);
    if (hd <= 64) return (int)launch_tc<64>(REPRO_FA_ARGS);
    if (hd <= 96) return (int)launch_tc<96>(REPRO_FA_ARGS);
    return (int)launch_tc<128>(REPRO_FA_ARGS);
  }
#undef REPRO_FA_ARGS
  return (int)cudaErrorInvalidValue;
}

// The split-KV route, for (H / KH) * Sq <= 16 rows a kv head: `nc` chunks
// of `chunk` keys cover [0, Sk). o_part [B,KH,nc,R,hd] and lse_part
// [B,KH,nc,R] f32 (R = (H / KH) * Sq) are the caller's scratch. Same
// dtypes and layouts as above; launches the split kernel, then the
// combine, on `stream`.
int flash_attention_fwd_split(int dtype, const void* q, const void* k,
                              const void* v, const void* q_pos,
                              const void* k_pos, const void* k_valid, void* o,
                              void* lse, void* o_part, void* lse_part, int B,
                              int Sq, int Sk, int H, int KH, int hd,
                              float scale, int causal, int window, int nc,
                              int chunk, void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || H <= 0 || KH <= 0 || H % KH != 0 ||
      hd <= 0 || hd > 128 || B > 65535 || KH > 65535 ||
      (H / KH) * Sq > split::ROWS || nc <= 0 || nc > 65535 || chunk <= 0 ||
      (long long)nc * chunk < Sk || (long long)(nc - 1) * chunk >= Sk)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define REPRO_FA_ARGS                                                        \
  q, k, v, q_pos, k_pos, k_valid, o, lse, o_part, lse_part, B, Sq, Sk, H,   \
      KH, hd, scale, causal, window, nc, chunk, st
  if (dtype == 0) {
    if (hd <= 32) return (int)launch_split<float, 32>(REPRO_FA_ARGS);
    if (hd <= 64) return (int)launch_split<float, 64>(REPRO_FA_ARGS);
    return (int)launch_split<float, 128>(REPRO_FA_ARGS);
  }
  if (dtype == 1) {
    if (hd <= 32) return (int)launch_split<bf16, 32>(REPRO_FA_ARGS);
    if (hd <= 64) return (int)launch_split<bf16, 64>(REPRO_FA_ARGS);
    return (int)launch_split<bf16, 128>(REPRO_FA_ARGS);
  }
#undef REPRO_FA_ARGS
  return (int)cudaErrorInvalidValue;
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

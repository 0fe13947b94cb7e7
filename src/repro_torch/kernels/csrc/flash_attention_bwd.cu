// Flash-attention backward for Hopper (sm_90a), f32 or bf16 I/O.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py:
// flash_attention_bwd (Pallas bodies `_bwd_dq_kernel` and
// `_bwd_dkv_kernel`). Same function: given the forward's residuals
// (q, k, v, positions, key validity, o, lse) and dO, with
// delta = rowsum(dO * O) (the dq kernel computes it for its rows and
// leaves it for the dk/dv kernel; the TPU's caller computed it),
//
//   s  = (q * scale) . k          p  = exp(s - lse) where the mask holds
//   dp = dO . v                   ds = p * (dp - delta)
//   dq = ds . k * scale           dk = ds^T . (q * scale)    dv = p^T . dO
//
// GQA: q head h reads kv head h / G; dk/dv of a kv head sum its G query
// heads. Nothing of shape [Sq, Sk] is ever written to device memory.
//
// Both routes keep the TPU's two-kernel split, with the sequential grid
// axis turned into a loop inside the block: dq per query tile, looping
// over key tiles; dk/dv per key tile, looping over query tiles and the G
// heads of its kv head. Each block owns its outputs, so there are no
// atomics and every run gives the same bits. Both skip, before loading
// it, a tile that no (query, key) pair can pass (about half the tiles at
// causal training shapes).
//
//  * bf16 (`tc_dq`, `tc_dkv`): the five products S = QK^T, dP = dO V^T,
//    dV = P^T dO, dK = dS^T Q and dQ = dS K run on the tensor cores as
//    mma.sync.m16n8k16 (bf16 operands, f32 accumulators) with ldmatrix
//    fragment loads. dq: 4 warps x 16 query rows, 64-key K/V tiles in a
//    double-buffered cp.async ring; dk/dv: 4 warps x 16 keys, 32-query
//    Q/dO tiles (one per query tile and head) in the same kind of ring.
//    p and ds stay in registers and become the A operands of the next
//    products.
//  * f32 (`dq`, `dkv`): the CUDA-core kernels of the first port (no TF32).
//    dq: 256 threads, 4 rows x 8 columns of dq a thread, so nothing spills
//    at hd 128; dk/dv: 128 threads, 2 keys x hd/8 columns each of dk, dv.
//
// What bounds it on an H100: at the train shape (B=8, S=512, H=24, KH=8,
// hd=128, causal) the function is ~32 GFLOP; in bf16 the tensor cores
// would take 33 us for it against 40 us to move its ~134 MB, so the
// bound is bytes. The two-kernel split computes S and dP twice (7
// products for 5) and mma.sync issues below wgmma's rate, so the kernel
// stays above that bound. In f32 the CUDA cores' 67 TFLOP/s bound it.
//
// Numerics of the tensor-core route: s = (q . k) * scale in f32, the scale
// applied after the product; p = exp2(s * log2(e) - lse * log2(e)). p and
// ds are rounded to bf16 before their products (dV = P^T dO, dK = dS^T Q,
// dQ = dS K); the TPU keeps both in f32. That is this route's one
// deviation, within bf16's tolerance (2^-8 relative a rounding).
//
// Every kernel states its minimum blocks an SM in __launch_bounds__: left
// to itself, ptxas held the f32 kernels to 128 registers and spilled.
//
// Left for later: wgmma with TMA, a fused single-pass dq (atomics), and
// a persistent schedule.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "flash_tc.cuh"

namespace {

namespace ft = flash_tc;
using bf16 = __nv_bfloat16;

constexpr int THREADS = 128;

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
  return __float2bfloat16(x);
}

// The range [lo, hi] of the values `x` that the block's threads offer
// (`have` false offers nothing: an empty set gives lo > hi).
__device__ __forceinline__ void block_range(int x, bool have, int* red,
                                            int& lo, int& hi) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int mn = __reduce_min_sync(0xffffffffu, have ? x : INT_MAX);
  int mx = __reduce_max_sync(0xffffffffu, have ? x : INT_MIN);
  if (lane == 0) {
    red[warp] = mn;
    red[THREADS / 32 + warp] = mx;
  }
  __syncthreads();
  lo = red[0];
  hi = red[THREADS / 32];
#pragma unroll
  for (int w = 1; w < THREADS / 32; ++w) {
    lo = min(lo, red[w]);
    hi = max(hi, red[THREADS / 32 + w]);
  }
}

// ---------------------------------------------------------------------------
// f32: the CUDA-core kernels. dq

namespace dq {
constexpr int THREADS = 256;               // 8 dq columns a thread at hd 128
constexpr int BQ = 64;                     // query rows per block
constexpr int BK = 32;                     // keys per tile
constexpr int TX = 16;                     // threads sharing one query row
constexpr int RPT = BQ / (THREADS / TX);   // rows per thread (4)
constexpr int CPT = BK / TX;               // key columns per thread (2)

template <int HDP>
constexpr size_t smem_bytes() {
  return sizeof(float) * (2 * BQ * (HDP + 1) + 2 * BK * (HDP + 1) +
                          BQ * (BK + 1)) +
         sizeof(int) * 2 * BK;
}

// Two blocks an SM (128 registers a thread): the d loop is unrolled by 2,
// not 4, so that nothing spills within them.
template <typename T, int HDP>
__global__ void __launch_bounds__(THREADS, 2)
kernel(const T* __restrict__ q, const T* __restrict__ k,
       const T* __restrict__ v, const int* __restrict__ q_pos,
       const int* __restrict__ k_pos, const uint8_t* __restrict__ k_valid,
       const T* __restrict__ o, const T* __restrict__ dout,
       const float* __restrict__ lse, float* __restrict__ delta,
       T* __restrict__ dq_out, int Sq, int Sk, int H, int KH, int hd,
       float scale, int causal, int window) {
  constexpr int S = HDP + 1;                 // padded row stride
  constexpr int PS = BK + 1;
  constexpr int DPT = HDP / TX;              // dq columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;                          // [BQ][S], q * scale
  float* dOs = Qs + BQ * S;                  // [BQ][S]
  float* Ks = dOs + BQ * S;                  // [BK][S]
  float* Vs = Ks + BK * S;                   // [BK][S]
  float* dSs = Vs + BK * S;                  // [BQ][PS]
  int* kp_s = reinterpret_cast<int*>(dSs + BQ * PS);
  int* kv_s = kp_s + BK;

  const int tid = threadIdx.x;
  const int tx = tid % TX, ty = tid / TX;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (H / KH);

  for (int i = tid; i < BQ * HDP; i += THREADS) {
    const int r = i / HDP, d = i % HDP, s = q0 + r;
    float x = 0.f, g = 0.f;
    if (s < Sq && d < hd) {
      const size_t off = (((size_t)b * Sq + s) * H + h) * hd + d;
      x = to_f32(q[off]) * scale;
      g = to_f32(dout[off]);
    }
    Qs[r * S + d] = x;
    dOs[r * S + d] = g;
  }

  int qp[RPT];
  bool row_ok[RPT];
  float lse_r[RPT], delta_r[RPT], acc[RPT][DPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int s = q0 + ty * RPT + i;
    row_ok[i] = s < Sq;
    qp[i] = row_ok[i] ? q_pos[(size_t)b * Sq + s] : 0;
    const size_t r = ((size_t)b * H + h) * Sq + s;
    lse_r[i] = row_ok[i] ? lse[r] : 0.f;
    // delta = rowsum(dO * O) in f32, written for the dk/dv kernel: the
    // row's TX lanes (one half-warp) each sum a stride of its columns
    float part = 0.f;
    if (row_ok[i]) {
      const size_t off = (((size_t)b * Sq + s) * H + h) * hd;
      for (int d = tx; d < hd; d += TX)
        part = fmaf(to_f32(dout[off + d]), to_f32(o[off + d]), part);
    }
#pragma unroll
    for (int sh = TX / 2; sh > 0; sh >>= 1)
      part += __shfl_xor_sync(0xffffffffu, part, sh);
    delta_r[i] = part;
    if (row_ok[i] && tx == 0) delta[r] = part;
#pragma unroll
    for (int j = 0; j < DPT; ++j) acc[i][j] = 0.f;
  }

  for (int k0 = 0; k0 < Sk; k0 += BK) {
    __syncthreads();  // the previous tile is consumed; Qs/dOs are written
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
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int c = tx + TX * j;
        ok[i][j] = row_ok[i] && ft::pair_ok(qp[i], kp_s[c], kv_s[c], causal,
                                        window);
        any |= ok[i][j];
      }
    if (!__syncthreads_or(any)) continue;   // the tile changes nothing

    for (int i = tid; i < BK * HDP; i += THREADS) {
      const int c = i / HDP, d = i % HDP, s = k0 + c;
      float kx = 0.f, vx = 0.f;
      if (s < Sk && d < hd) {
        const size_t off = (((size_t)b * Sk + s) * KH + kh) * hd + d;
        kx = to_f32(k[off]);
        vx = to_f32(v[off]);
      }
      Ks[c * S + d] = kx;
      Vs[c * S + d] = vx;
    }
    __syncthreads();

    float s_[RPT][CPT], dp[RPT][CPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < CPT; ++j) s_[i][j] = dp[i][j] = 0.f;
#pragma unroll 2
    for (int d = 0; d < HDP; ++d) {
      float qv[RPT], gv[RPT], kv[CPT], vv[CPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        qv[i] = Qs[(ty * RPT + i) * S + d];
        gv[i] = dOs[(ty * RPT + i) * S + d];
      }
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        kv[j] = Ks[(tx + TX * j) * S + d];
        vv[j] = Vs[(tx + TX * j) * S + d];
      }
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < CPT; ++j) {
          s_[i][j] = fmaf(qv[i], kv[j], s_[i][j]);
          dp[i][j] = fmaf(gv[i], vv[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const float p = ok[i][j] ? expf(s_[i][j] - lse_r[i]) : 0.f;
        dSs[(ty * RPT + i) * PS + tx + TX * j] = p * (dp[i][j] - delta_r[i]);
      }
    // a thread reads back only its own rows of dSs, written by the 16
    // lanes of its own row group (one half-warp)
    __syncwarp();

#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float dsv[RPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) dsv[i] = dSs[(ty * RPT + i) * PS + c];
#pragma unroll
      for (int j = 0; j < DPT; ++j) {
        const float kv = Ks[c * S + tx + TX * j];
#pragma unroll
        for (int i = 0; i < RPT; ++i) acc[i][j] = fmaf(dsv[i], kv, acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    if (!row_ok[i]) continue;
    const int s = q0 + ty * RPT + i;
#pragma unroll
    for (int j = 0; j < DPT; ++j) {
      const int d = tx + TX * j;
      if (d < hd)
        dq_out[(((size_t)b * Sq + s) * H + h) * hd + d] =
            from_f32<T>(acc[i][j] * scale);
    }
  }
}
}  // namespace dq

// ---------------------------------------------------------------------------
// dk / dv

namespace dkv {
constexpr int BK = 32;                     // keys per block
constexpr int BQ = 32;                     // queries per tile
constexpr int TX = 8;                      // threads sharing one key row
constexpr int KPT = BK / (THREADS / TX);   // keys per thread (2)
constexpr int QPT = BQ / TX;               // query columns per thread (4)

template <int HDP>
constexpr size_t smem_bytes() {
  return sizeof(float) * (2 * BK * (HDP + 1) + 2 * BQ * (HDP + 1) +
                          2 * BK * (BQ + 1) + 2 * BQ) +
         sizeof(int) * 2 * BQ;
}

template <typename T, int HDP>
__global__ void __launch_bounds__(THREADS, 1)
kernel(const T* __restrict__ q, const T* __restrict__ k,
       const T* __restrict__ v, const int* __restrict__ q_pos,
       const int* __restrict__ k_pos, const uint8_t* __restrict__ k_valid,
       const T* __restrict__ dout, const float* __restrict__ lse,
       const float* __restrict__ delta, T* __restrict__ dk_out,
       T* __restrict__ dv_out, int Sq, int Sk, int H, int KH, int hd,
       float scale, int causal, int window) {
  constexpr int S = HDP + 1;
  constexpr int PS = BQ + 1;
  constexpr int DPT = HDP / TX;
  extern __shared__ float smem[];
  float* Ks = smem;                          // [BK][S]
  float* Vs = Ks + BK * S;                   // [BK][S]
  float* Qs = Vs + BK * S;                   // [BQ][S], q * scale
  float* dOs = Qs + BQ * S;                  // [BQ][S]
  float* Ps = dOs + BQ * S;                  // [BK][PS]
  float* dSs = Ps + BK * PS;                 // [BK][PS]
  float* lse_s = dSs + BK * PS;              // [BQ]
  float* delta_s = lse_s + BQ;               // [BQ]
  int* qp_s = reinterpret_cast<int*>(delta_s + BQ);   // [BQ]
  int* qok_s = qp_s + BQ;                             // [BQ]

  const int tid = threadIdx.x;
  const int tx = tid % TX, ty = tid / TX;
  const int k0 = blockIdx.x * BK;
  const int kh = blockIdx.y, b = blockIdx.z;
  const int G = H / KH;

  for (int i = tid; i < BK * HDP; i += THREADS) {
    const int c = i / HDP, d = i % HDP, s = k0 + c;
    float kx = 0.f, vx = 0.f;
    if (s < Sk && d < hd) {
      const size_t off = (((size_t)b * Sk + s) * KH + kh) * hd + d;
      kx = to_f32(k[off]);
      vx = to_f32(v[off]);
    }
    Ks[c * S + d] = kx;
    Vs[c * S + d] = vx;
  }

  int kp[KPT];
  bool kv[KPT];
  float dk_acc[KPT][DPT], dv_acc[KPT][DPT];
#pragma unroll
  for (int i = 0; i < KPT; ++i) {
    const int s = k0 + ty * KPT + i;
    kv[i] = s < Sk && k_valid[(size_t)b * Sk + s];
    kp[i] = kv[i] ? k_pos[(size_t)b * Sk + s] : 0;
#pragma unroll
    for (int j = 0; j < DPT; ++j) dk_acc[i][j] = dv_acc[i][j] = 0.f;
  }

  for (int q0 = 0; q0 < Sq; q0 += BQ) {
    __syncthreads();  // the previous tile is consumed; Ks/Vs are written
    if (tid < BQ) {
      const int s = q0 + tid;
      qok_s[tid] = s < Sq;
      qp_s[tid] = s < Sq ? q_pos[(size_t)b * Sq + s] : 0;
    }
    __syncthreads();

    bool ok[KPT][QPT];
    int any = 0;
#pragma unroll
    for (int i = 0; i < KPT; ++i)
#pragma unroll
      for (int j = 0; j < QPT; ++j) {
        const int c = tx + TX * j;
        ok[i][j] = qok_s[c] &&
                   ft::pair_ok(qp_s[c], kp[i], kv[i], causal, window);
        any |= ok[i][j];
      }
    if (!__syncthreads_or(any)) continue;   // no head of this tile sees a key

    for (int gi = 0; gi < G; ++gi) {
      const int h = kh * G + gi;
      __syncthreads();   // the previous head's tiles are consumed
      for (int i = tid; i < BQ * HDP; i += THREADS) {
        const int r = i / HDP, d = i % HDP, s = q0 + r;
        float x = 0.f, g = 0.f;
        if (s < Sq && d < hd) {
          const size_t off = (((size_t)b * Sq + s) * H + h) * hd + d;
          x = to_f32(q[off]) * scale;
          g = to_f32(dout[off]);
        }
        Qs[r * S + d] = x;
        dOs[r * S + d] = g;
      }
      if (tid < BQ) {
        const int s = q0 + tid;
        const size_t r = ((size_t)b * H + h) * Sq + s;
        lse_s[tid] = s < Sq ? lse[r] : 0.f;
        delta_s[tid] = s < Sq ? delta[r] : 0.f;
      }
      __syncthreads();

      float s_[KPT][QPT], dp[KPT][QPT];
#pragma unroll
      for (int i = 0; i < KPT; ++i)
#pragma unroll
        for (int j = 0; j < QPT; ++j) s_[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
      for (int d = 0; d < HDP; ++d) {
        float kx[KPT], vx[KPT], qx[QPT], gx[QPT];
#pragma unroll
        for (int i = 0; i < KPT; ++i) {
          kx[i] = Ks[(ty * KPT + i) * S + d];
          vx[i] = Vs[(ty * KPT + i) * S + d];
        }
#pragma unroll
        for (int j = 0; j < QPT; ++j) {
          qx[j] = Qs[(tx + TX * j) * S + d];
          gx[j] = dOs[(tx + TX * j) * S + d];
        }
#pragma unroll
        for (int i = 0; i < KPT; ++i)
#pragma unroll
          for (int j = 0; j < QPT; ++j) {
            s_[i][j] = fmaf(kx[i], qx[j], s_[i][j]);
            dp[i][j] = fmaf(vx[i], gx[j], dp[i][j]);
          }
      }
#pragma unroll
      for (int i = 0; i < KPT; ++i)
#pragma unroll
        for (int j = 0; j < QPT; ++j) {
          const int c = tx + TX * j;
          const float p = ok[i][j] ? expf(s_[i][j] - lse_s[c]) : 0.f;
          Ps[(ty * KPT + i) * PS + c] = p;
          dSs[(ty * KPT + i) * PS + c] = p * (dp[i][j] - delta_s[c]);
        }
      // a thread reads back only its own key rows, written by the 8 lanes
      // of its own row group
      __syncwarp();

#pragma unroll 4
      for (int c = 0; c < BQ; ++c) {
        float pv[KPT], dsv[KPT];
#pragma unroll
        for (int i = 0; i < KPT; ++i) {
          pv[i] = Ps[(ty * KPT + i) * PS + c];
          dsv[i] = dSs[(ty * KPT + i) * PS + c];
        }
#pragma unroll
        for (int j = 0; j < DPT; ++j) {
          const float gv = dOs[c * S + tx + TX * j];
          const float qv = Qs[c * S + tx + TX * j];
#pragma unroll
          for (int i = 0; i < KPT; ++i) {
            dv_acc[i][j] = fmaf(pv[i], gv, dv_acc[i][j]);
            dk_acc[i][j] = fmaf(dsv[i], qv, dk_acc[i][j]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < KPT; ++i) {
    const int s = k0 + ty * KPT + i;
    if (s >= Sk) continue;
#pragma unroll
    for (int j = 0; j < DPT; ++j) {
      const int d = tx + TX * j;
      if (d < hd) {
        const size_t off = (((size_t)b * Sk + s) * KH + kh) * hd + d;
        dk_out[off] = from_f32<T>(dk_acc[i][j]);
        dv_out[off] = from_f32<T>(dv_acc[i][j]);
      }
    }
  }
}
}  // namespace dkv

// ---------------------------------------------------------------------------
// bf16: the tensor-core kernels. dq

namespace tc_dq {
constexpr int BQ = 64;      // query rows per block, 16 per warp
constexpr int BK = 64;      // keys per tile

// Q and dO tiles, the K/V ring, its key positions, and the bitmasks of
// reachable and of unmasked key tiles.
template <int HDP>
size_t smem_bytes(int Sk) {
  return sizeof(bf16) * (2 * BQ + 4 * BK) * ft::ld<HDP>() +
         sizeof(int) * 4 * BK +
         2 * sizeof(unsigned) * ((Sk + 32 * BK - 1) / (32 * BK));
}

template <int HDP>
__global__ void __launch_bounds__(THREADS, 1)
kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
       const bf16* __restrict__ v, const int* __restrict__ q_pos,
       const int* __restrict__ k_pos, const uint8_t* __restrict__ k_valid,
       const bf16* __restrict__ o, const bf16* __restrict__ dout,
       const float* __restrict__ lse, float* __restrict__ delta,
       bf16* __restrict__ dq_out, int Sq, int Sk, int H, int KH, int hd,
       float scale, int causal, int window) {
  constexpr int LD = ft::ld<HDP>();
  constexpr int NT = BK / 8;
  constexpr int NO = HDP / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);      // [BQ][LD]
  bf16* dOs = Qs + BQ * LD;                           // [BQ][LD]
  bf16* Ks = dOs + BQ * LD;                           // [2][BK][LD]
  bf16* Vs = Ks + 2 * BK * LD;                        // [2][BK][LD]
  int* kp_s = reinterpret_cast<int*>(Vs + 2 * BK * LD);  // [2][BK]
  int* kv_s = kp_s + 2 * BK;                             // [2][BK]
  const int nkt = (Sk + BK - 1) / BK;
  unsigned* reach = reinterpret_cast<unsigned*>(kv_s + 2 * BK);
  unsigned* full = reach + (nkt + 31) / 32;
  __shared__ int red[2 * THREADS / 32];
  __shared__ float dl_s[BQ];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // longest rows first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (H / KH);
  const int nq = min(BQ, Sq - q0);
  const size_t qoff = (((size_t)b * Sq + q0) * H + h) * hd;
  const size_t kstride = (size_t)KH * hd;

  ft::load_tile<HDP, THREADS>(Qs, q + qoff, (size_t)H * hd, BQ, nq, hd, tid);
  ft::load_tile<HDP, THREADS>(dOs, dout + qoff, (size_t)H * hd, BQ, nq, hd,
                              tid);
  ft::cp_async_commit();

  const int g = lane >> 2, t4 = lane & 3;
  const int r0 = warp * 16 + g, r1 = r0 + 8;
  const bool ok0 = r0 < nq, ok1 = r1 < nq;
  const size_t row = ((size_t)b * H + h) * Sq + q0;
  const int qp0 = ok0 ? q_pos[(size_t)b * Sq + q0 + r0] : 0;
  const int qp1 = ok1 ? q_pos[(size_t)b * Sq + q0 + r1] : 0;
  const float lse0 = ok0 ? lse[row + r0] * ft::LOG2E : 0.f;
  const float lse1 = ok1 ? lse[row + r1] * ft::LOG2E : 0.f;
  // delta = rowsum(dO * O) in f32 for this block's rows, written for the
  // dk/dv kernel (launched after on the same stream): two lanes a row
  {
    const int r = tid >> 1;
    float part = 0.f;
    if (r < nq) {
      const bf16* orow = o + qoff + (size_t)r * H * hd;
      const bf16* grow = dout + qoff + (size_t)r * H * hd;
      if (hd % 8 == 0) {   // 16-byte loads, every one issued before use
        uint4 ov[HDP / 16], gv[HDP / 16];
#pragma unroll
        for (int i = 0; i < HDP / 16; ++i) {
          const int c = ((tid & 1) + 2 * i) * 8;
          if (c < hd) {
            ov[i] = *reinterpret_cast<const uint4*>(orow + c);
            gv[i] = *reinterpret_cast<const uint4*>(grow + c);
          } else {
            ov[i] = gv[i] = make_uint4(0u, 0u, 0u, 0u);
          }
        }
#pragma unroll
        for (int i = 0; i < HDP / 16; ++i) {
          const auto* o2 = reinterpret_cast<const __nv_bfloat162*>(&ov[i]);
          const auto* g2 = reinterpret_cast<const __nv_bfloat162*>(&gv[i]);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float2 of = __bfloat1622float2(o2[e]);
            const float2 gf = __bfloat1622float2(g2[e]);
            part = fmaf(gf.x, of.x, fmaf(gf.y, of.y, part));
          }
        }
      } else {
        for (int d = tid & 1; d < hd; d += 2)
          part = fmaf(__bfloat162float(grow[d]), __bfloat162float(orow[d]),
                      part);
      }
    }
    part += __shfl_xor_sync(0xffffffffu, part, 1);
    if (!(tid & 1)) {
      dl_s[r] = part;
      if (r < nq) delta[row + r] = part;
    }
  }
  int qmin, qmax;   // (block_range's barrier also publishes dl_s)
  block_range(tid < nq ? q_pos[(size_t)b * Sq + q0 + min(tid, nq - 1)] : 0,
              tid < nq, red, qmin, qmax);
  const float dl0 = ok0 ? dl_s[r0] : 0.f;
  const float dl1 = ok1 ? dl_s[r1] : 0.f;

  const int* kpos = k_pos + (size_t)b * Sk;
  const uint8_t* kval = k_valid + (size_t)b * Sk;
  ft::build_reach<BK, THREADS>(reach, full, Sk, [&](int c) {
    const int kp = kpos[c];
    const bool valid = kval[c];
    return (valid && ft::key_reaches(kp, qmin, qmax, causal, window)) |
           (valid && ft::key_passes_all(kp, qmin, qmax, causal, window)) << 1;
  });
  int kp_r = 0, kv_r = 0;   // the next tile's key positions, in flight
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

  float acc[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j)
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  const float sl2 = scale * ft::LOG2E;

  int buf = 0;
  int t = ft::next_tile(reach, 0, nkt);
  if (t < nkt) {
    load_kv(t, 0);
    fetch_pos(t);
    stage_pos(0);
  }
  while (t < nkt) {
    const int tn = ft::next_tile(reach, t + 1, nkt);
    if (tn < nkt) {
      load_kv(tn, buf ^ 1);
      fetch_pos(tn);
      ft::cp_async_wait<1>();
    } else {
      ft::cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* Kb = Ks + buf * BK * LD;
    const bf16* Vb = Vs + buf * BK * LD;
    const int* kpb = kp_s + buf * BK;
    const int* kvb = kv_s + buf * BK;

    // S = Q K^T and dP = dO V^T
    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < HDP / 16; ++kk) {
      uint32_t a[4], a2[4];
      ft::load_a(a, Qs, LD, warp * 16, kk * 16, lane);
      ft::load_a(a2, dOs, LD, warp * 16, kk * 16, lane);
#pragma unroll
      for (int nj = 0; nj < NT / 2; ++nj) {
        uint32_t bb[4];
        ft::load_b_nk(bb, Kb, LD, nj * 16, kk * 16, lane);
        ft::mma(s[2 * nj], a, bb[0], bb[1]);
        ft::mma(s[2 * nj + 1], a, bb[2], bb[3]);
        ft::load_b_nk(bb, Vb, LD, nj * 16, kk * 16, lane);
        ft::mma(dp[2 * nj], a2, bb[0], bb[1]);
        ft::mma(dp[2 * nj + 1], a2, bb[2], bb[3]);
      }
    }
    // ds = p * (dp - delta), p rebuilt from lse; masked pairs give 0 (no
    // mask on a tile every pair passes: rows past Sq have zero q, dO and
    // delta there, so their ds is 0 all the same)
    const bool full_t = ft::bit(full, t);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = j * 8 + t4 * 2 + e;
        const int kp = kpb[c];
        const bool kv = kvb[c];
        const float p0 =
            (full_t || (ok0 && ft::pair_ok(qp0, kp, kv, causal, window)))
                ? exp2f(s[j][e] * sl2 - lse0) : 0.f;
        const float p1 =
            (full_t || (ok1 && ft::pair_ok(qp1, kp, kv, causal, window)))
                ? exp2f(s[j][2 + e] * sl2 - lse1) : 0.f;
        s[j][e] = p0 * (dp[j][e] - dl0);
        s[j][2 + e] = p1 * (dp[j][2 + e] - dl1);
      }
    }
    // dQ += dS K: ds rounded to bf16 as the A operand, K^T by transposed
    // loads
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t a[4];
      ft::c_to_a(a, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int nd = 0; nd < HDP / 16; ++nd) {
        uint32_t bb[4];
        ft::load_b_kn(bb, Kb, LD, kk * 16, nd * 16, lane);
        ft::mma(acc[2 * nd], a, bb[0], bb[1]);
        ft::mma(acc[2 * nd + 1], a, bb[2], bb[3]);
      }
    }
    if (tn < nkt) stage_pos(buf ^ 1);
    __syncthreads();
    t = tn;
    buf ^= 1;
  }
  ft::cp_async_wait<0>();

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    if (!(half ? ok1 : ok0)) continue;
    bf16* out = dq_out + qoff + (size_t)(half ? r1 : r0) * H * hd;
#pragma unroll
    for (int j = 0; j < NO; ++j) {
      const int c = j * 8 + t4 * 2;
      const float x0 = acc[j][2 * half] * scale;
      const float x1 = acc[j][2 * half + 1] * scale;
      if (c + 1 < hd && hd % 2 == 0) {
        *reinterpret_cast<__nv_bfloat162*>(out + c) =
            __floats2bfloat162_rn(x0, x1);
      } else {
        if (c < hd) out[c] = __float2bfloat16(x0);
        if (c + 1 < hd) out[c + 1] = __float2bfloat16(x1);
      }
    }
  }
}
}  // namespace tc_dq

// ---------------------------------------------------------------------------
// bf16: dk / dv

namespace tc_dkv {
constexpr int BK = 64;      // keys per block, 16 per warp
constexpr int BQ = 32;      // queries per step (one query tile, one head)

// K and V tiles, the Q/dO ring with its rows' positions, lse and delta,
// and the bitmasks of reachable and of unmasked query tiles.
template <int HDP>
size_t smem_bytes(int Sq) {
  return sizeof(bf16) * (2 * BK + 4 * BQ) * ft::ld<HDP>() +
         sizeof(float) * 4 * BQ + sizeof(int) * 2 * BQ +
         2 * sizeof(unsigned) * ((Sq + 32 * BQ - 1) / (32 * BQ));
}

template <int HDP>
__global__ void __launch_bounds__(THREADS, 1)
kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
       const bf16* __restrict__ v, const int* __restrict__ q_pos,
       const int* __restrict__ k_pos, const uint8_t* __restrict__ k_valid,
       const bf16* __restrict__ dout, const float* __restrict__ lse,
       const float* __restrict__ delta, bf16* __restrict__ dk_out,
       bf16* __restrict__ dv_out, int Sq, int Sk, int H, int KH, int hd,
       float scale, int causal, int window) {
  constexpr int LD = ft::ld<HDP>();
  constexpr int NT = BQ / 8;
  constexpr int NO = HDP / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);      // [BK][LD]
  bf16* Vs = Ks + BK * LD;                            // [BK][LD]
  bf16* Qs = Vs + BK * LD;                            // [2][BQ][LD]
  bf16* dOs = Qs + 2 * BQ * LD;                       // [2][BQ][LD]
  float* lse_s = reinterpret_cast<float*>(dOs + 2 * BQ * LD);  // [2][BQ]
  float* dl_s = lse_s + 2 * BQ;                                // [2][BQ]
  int* qp_s = reinterpret_cast<int*>(dl_s + 2 * BQ);           // [2][BQ]
  const int nqt = (Sq + BQ - 1) / BQ;
  unsigned* reach = reinterpret_cast<unsigned*>(qp_s + 2 * BQ);
  unsigned* full = reach + (nqt + 31) / 32;
  __shared__ int red[2 * THREADS / 32];
  __shared__ int tile_s[2];   // the query tile in each buffer

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int k0 = blockIdx.x * BK;
  const int kh = blockIdx.y, b = blockIdx.z;
  const int G = H / KH;
  const int nk = min(BK, Sk - k0);
  const size_t koff = (((size_t)b * Sk + k0) * KH + kh) * hd;
  const size_t qstride = (size_t)H * hd;

  ft::load_tile<HDP, THREADS>(Ks, k + koff, (size_t)KH * hd, BK, nk, hd, tid);
  ft::load_tile<HDP, THREADS>(Vs, v + koff, (size_t)KH * hd, BK, nk, hd, tid);
  ft::cp_async_commit();

  // this thread's two keys (g and g + 8 of its warp's 16)
  const int g = lane >> 2, t4 = lane & 3;
  const int r0 = warp * 16 + g, r1 = r0 + 8;
  const bool kv0 = r0 < nk && k_valid[(size_t)b * Sk + k0 + r0];
  const bool kv1 = r1 < nk && k_valid[(size_t)b * Sk + k0 + r1];
  const int kp0 = kv0 ? k_pos[(size_t)b * Sk + k0 + r0] : 0;
  const int kp1 = kv1 ? k_pos[(size_t)b * Sk + k0 + r1] : 0;
  bool have = false;
  int mykp = 0;
  if (tid < nk) {
    have = k_valid[(size_t)b * Sk + k0 + tid];
    mykp = have ? k_pos[(size_t)b * Sk + k0 + tid] : 0;
  }
  int kmin, kmax;
  block_range(mykp, have, red, kmin, kmax);
  // every key of the block valid: a query tile may then need no mask
  const bool keys_full = __syncthreads_and(tid >= BK || have);

  // the query tiles some pair of the block may pass, and those every pair
  // passes (one memory latency)
  const int* qpos = q_pos + (size_t)b * Sq;
  ft::build_reach<BQ, THREADS>(reach, full, Sq, [&](int i) {
    const int qp = qpos[i];
    return ft::query_reaches(qp, kmin, kmax, causal, window) |
           (keys_full &&
            ft::query_passes_all(qp, kmin, kmax, causal, window)) << 1;
  });
  // steps: (reachable query tile t, head gi) as s = t * G + gi
  const int nsteps = nqt * G;
  auto next_step = [&](int s) {
    if (s % G) return s;   // the next head of a reachable tile
    const int t = ft::next_tile(reach, s / G, nqt);
    return t < nqt ? t * G : nsteps;
  };
  // a step's tiles and its rows' positions, lse and delta, copied into
  // buffer `buf` by one cp.async group (rows past Sq read as zero)
  auto load_step = [&](int s, int buf) {
    const int t = s / G, h = kh * G + s % G;
    const int q0 = t * BQ;
    const size_t off = (((size_t)b * Sq + q0) * H + h) * hd;
    const int nq = min(BQ, Sq - q0);
    ft::load_tile<HDP, THREADS>(Qs + buf * BQ * LD, q + off, qstride, BQ, nq,
                                hd, tid);
    ft::load_tile<HDP, THREADS>(dOs + buf * BQ * LD, dout + off, qstride, BQ,
                                nq, hd, tid);
    if (tid < BQ) {
      const int in = tid < nq ? 4 : 0;
      const size_t r = ((size_t)b * H + h) * Sq + q0 + (in ? tid : 0);
      ft::cp_async4(qp_s + buf * BQ + tid, qpos + q0 + (in ? tid : 0), in);
      ft::cp_async4(lse_s + buf * BQ + tid, lse + r, in);
      ft::cp_async4(dl_s + buf * BQ + tid, delta + r, in);
    }
    if (tid == 0) tile_s[buf] = t;
    ft::cp_async_commit();
  };

  float dk[NO][4], dv[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[j][e] = dv[j][e] = 0.f;
  const float sl2 = scale * ft::LOG2E;

  int buf = 0;
  int s = next_step(0);
  if (s < nsteps) load_step(s, 0);
  while (s < nsteps) {
    const int sn = next_step(s + 1);
    if (sn < nsteps) {
      load_step(sn, buf ^ 1);
      ft::cp_async_wait<1>();
    } else {
      ft::cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* Qb = Qs + buf * BQ * LD;
    const bf16* dOb = dOs + buf * BQ * LD;
    const float* lseb = lse_s + buf * BQ;
    const float* dlb = dl_s + buf * BQ;
    const int* qpb = qp_s + buf * BQ;
    const int nqb = Sq - tile_s[buf] * BQ;   // rows of this step below Sq
    // no mask on a tile every pair passes (rows past Sq and keys past Sk
    // have zero operands and delta there: p is finite, ds and dv gain 0)
    const bool full_t = ft::bit(full, tile_s[buf]);

    // S^T = K Q^T and dP^T = V dO^T: rows are this warp's keys
    float st[NT][4], dpt[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[j][e] = dpt[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < HDP / 16; ++kk) {
      uint32_t a[4], a2[4];
      ft::load_a(a, Ks, LD, warp * 16, kk * 16, lane);
      ft::load_a(a2, Vs, LD, warp * 16, kk * 16, lane);
#pragma unroll
      for (int nj = 0; nj < NT / 2; ++nj) {
        uint32_t bb[4];
        ft::load_b_nk(bb, Qb, LD, nj * 16, kk * 16, lane);
        ft::mma(st[2 * nj], a, bb[0], bb[1]);
        ft::mma(st[2 * nj + 1], a, bb[2], bb[3]);
        ft::load_b_nk(bb, dOb, LD, nj * 16, kk * 16, lane);
        ft::mma(dpt[2 * nj], a2, bb[0], bb[1]);
        ft::mma(dpt[2 * nj + 1], a2, bb[2], bb[3]);
      }
    }
    // p^T and ds^T; masked pairs give 0
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = j * 8 + t4 * 2 + e;
        const int qp = qpb[c];
        const bool okq = c < nqb;
        const float l2 = lseb[c] * ft::LOG2E, dl = dlb[c];
        const float p0 =
            (full_t || (okq && ft::pair_ok(qp, kp0, kv0, causal, window)))
                ? exp2f(st[j][e] * sl2 - l2) : 0.f;
        const float p1 =
            (full_t || (okq && ft::pair_ok(qp, kp1, kv1, causal, window)))
                ? exp2f(st[j][2 + e] * sl2 - l2) : 0.f;
        st[j][e] = p0;
        st[j][2 + e] = p1;
        dpt[j][e] = p0 * (dpt[j][e] - dl);
        dpt[j][2 + e] = p1 * (dpt[j][2 + e] - dl);
      }
    }
    // dV += P^T dO and dK += dS^T Q: p and ds rounded to bf16 as the A
    // operands, dO and Q by transposed loads
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      uint32_t ap[4], ad[4];
      ft::c_to_a(ap, st[2 * kk], st[2 * kk + 1]);
      ft::c_to_a(ad, dpt[2 * kk], dpt[2 * kk + 1]);
#pragma unroll
      for (int nd = 0; nd < HDP / 16; ++nd) {
        uint32_t bb[4];
        ft::load_b_kn(bb, dOb, LD, kk * 16, nd * 16, lane);
        ft::mma(dv[2 * nd], ap, bb[0], bb[1]);
        ft::mma(dv[2 * nd + 1], ap, bb[2], bb[3]);
        ft::load_b_kn(bb, Qb, LD, kk * 16, nd * 16, lane);
        ft::mma(dk[2 * nd], ad, bb[0], bb[1]);
        ft::mma(dk[2 * nd + 1], ad, bb[2], bb[3]);
      }
    }
    __syncthreads();
    s = sn;
    buf ^= 1;
  }
  ft::cp_async_wait<0>();   // a block with no step still copied its K/V

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = half ? r1 : r0;
    if (r >= nk) continue;
    bf16* dko = dk_out + koff + (size_t)r * KH * hd;
    bf16* dvo = dv_out + koff + (size_t)r * KH * hd;
#pragma unroll
    for (int j = 0; j < NO; ++j) {
      const int c = j * 8 + t4 * 2;
      const float k0v = dk[j][2 * half] * scale;
      const float k1v = dk[j][2 * half + 1] * scale;
      const float v0v = dv[j][2 * half], v1v = dv[j][2 * half + 1];
      if (c + 1 < hd && hd % 2 == 0) {
        *reinterpret_cast<__nv_bfloat162*>(dko + c) =
            __floats2bfloat162_rn(k0v, k1v);
        *reinterpret_cast<__nv_bfloat162*>(dvo + c) =
            __floats2bfloat162_rn(v0v, v1v);
      } else {
        if (c < hd) {
          dko[c] = __float2bfloat16(k0v);
          dvo[c] = __float2bfloat16(v0v);
        }
        if (c + 1 < hd) {
          dko[c + 1] = __float2bfloat16(k1v);
          dvo[c + 1] = __float2bfloat16(v1v);
        }
      }
    }
  }
}
}  // namespace tc_dkv

// ---------------------------------------------------------------------------
// launches

template <typename K>
cudaError_t allow_smem(K kernel_fn, size_t smem) {
  return cudaFuncSetAttribute(kernel_fn,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

// One backward call's arguments, as the C entry receives them.
struct Args {
  const void *q, *k, *v, *q_pos, *k_pos, *k_valid, *o, *dout, *lse;
  void *delta, *dq, *dk, *dv;
  int B, Sq, Sk, H, KH, hd;
  float scale;
  int causal, window;
  cudaStream_t stream;
};

template <typename T, typename KQ, typename KKV>
cudaError_t launch_pair(const Args& a, KQ kq, size_t smem_q, int bq,
                        int threads_q, KKV kkv, size_t smem_kv, int bk) {
  cudaError_t err = allow_smem(kq, smem_q);
  if (err != cudaSuccess) return err;
  err = allow_smem(kkv, smem_kv);
  if (err != cudaSuccess) return err;
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const int* qp = static_cast<const int*>(a.q_pos);
  const int* kp = static_cast<const int*>(a.k_pos);
  const uint8_t* kv = static_cast<const uint8_t*>(a.k_valid);
  const T* dout = static_cast<const T*>(a.dout);
  const float* lse = static_cast<const float*>(a.lse);
  float* delta = static_cast<float*>(a.delta);
  kq<<<dim3((a.Sq + bq - 1) / bq, a.H, a.B), threads_q, smem_q, a.stream>>>(
      q, k, v, qp, kp, kv, static_cast<const T*>(a.o), dout, lse, delta,
      static_cast<T*>(a.dq), a.Sq, a.Sk, a.H, a.KH, a.hd, a.scale, a.causal,
      a.window);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  kkv<<<dim3((a.Sk + bk - 1) / bk, a.KH, a.B), THREADS, smem_kv, a.stream>>>(
      q, k, v, qp, kp, kv, dout, lse, delta, static_cast<T*>(a.dk),
      static_cast<T*>(a.dv), a.Sq, a.Sk, a.H, a.KH, a.hd, a.scale, a.causal,
      a.window);
  return cudaGetLastError();
}

template <int HDP>
cudaError_t launch_simt(const Args& a) {
  return launch_pair<float>(a, dq::kernel<float, HDP>, dq::smem_bytes<HDP>(),
                            dq::BQ, dq::THREADS, dkv::kernel<float, HDP>,
                            dkv::smem_bytes<HDP>(), dkv::BK);
}

template <int HDP>
cudaError_t launch_tc(const Args& a) {
  return launch_pair<bf16>(a, tc_dq::kernel<HDP>, tc_dq::smem_bytes<HDP>(a.Sk),
                           tc_dq::BQ, THREADS, tc_dkv::kernel<HDP>,
                           tc_dkv::smem_bytes<HDP>(a.Sq), tc_dkv::BK);
}

}  // namespace

extern "C" {

// dtype: 0 = float32 (CUDA cores), 1 = bfloat16 (tensor cores). Tensors
// are contiguous: q/o/dout/dq [B,Sq,H,hd], k/v/dk/dv [B,Sk,KH,hd], q_pos
// [B,Sq] and k_pos [B,Sk] int32, k_valid [B,Sk] bool (one byte each), lse
// [B,H,Sq] f32; delta [B,H,Sq] f32 is scratch: the dq kernel writes
// rowsum(dO * O) there for the dk/dv kernel. Launches the dq kernel, then
// the dk/dv kernel, on `stream` without synchronising; returns the first
// CUDA error.
int flash_attention_bwd(int dtype, const void* q, const void* k,
                        const void* v, const void* q_pos, const void* k_pos,
                        const void* k_valid, const void* o, const void* dout,
                        const void* lse, void* delta, void* dq_out,
                        void* dk_out, void* dv_out, int B, int Sq, int Sk,
                        int H, int KH, int hd, float scale, int causal,
                        int window, void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || H <= 0 || KH <= 0 || H % KH != 0 ||
      hd <= 0 || hd > 128 || B > 65535 || H > 65535)
    return (int)cudaErrorInvalidValue;
  const Args a{q, k, v, q_pos, k_pos, k_valid, o, dout, lse, delta, dq_out,
               dk_out, dv_out, B, Sq, Sk, H, KH, hd, scale, causal, window,
               static_cast<cudaStream_t>(stream)};
  if (dtype == 0) {
    if (hd <= 16) return (int)launch_simt<16>(a);
    if (hd <= 32) return (int)launch_simt<32>(a);
    if (hd <= 64) return (int)launch_simt<64>(a);
    return (int)launch_simt<128>(a);
  }
  if (dtype == 1) {
    if (hd <= 32) return (int)launch_tc<32>(a);
    if (hd <= 64) return (int)launch_tc<64>(a);
    if (hd <= 96) return (int)launch_tc<96>(a);
    return (int)launch_tc<128>(a);
  }
  return (int)cudaErrorInvalidValue;
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

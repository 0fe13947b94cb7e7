// Flash-attention backward for Hopper (sm_90a), f32 or bf16 I/O.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py:
// flash_attention_bwd (Pallas bodies `_bwd_dq_kernel` and
// `_bwd_dkv_kernel`). Same function: given the forward's residuals
// (q, k, v, positions, key validity, lse) and dO, with
// delta = rowsum(dO * O) computed by the caller,
//
//   s  = (q * scale) . k          p  = exp(s - lse) where the mask holds
//   dp = dO . v                   ds = p * (dp - delta)
//   dq = ds . k * scale           dk = ds^T . (q * scale)    dv = p^T . dO
//
// GQA: q head h reads kv head h / G; dk/dv of a kv head sum its G query
// heads. Nothing of shape [Sq, Sk] is ever written to device memory.
//
// What bounds it on an H100: at the train shapes (B=8, S=512, H=24, KH=8,
// hd=128, causal) the two kernels do ~2.5x the forward's products,
// ~16 GFLOP of f32 against ~100 MB of I/O: bound by operations (67 TFLOP/s
// f32 outside the tensor cores).
//
// What this first design does about it: the TPU's two-kernel split, with
// the sequential grid axis turned into a loop inside the block.
//  * dq:  one block per (64-row query tile, q head, batch) loops over key
//         tiles of 32; dq accumulates in registers (4 rows x hd/8 columns
//         per thread); ds goes through shared memory for the ds . k product.
//  * dkv: one block per (32-key tile, kv head, batch) loops over query
//         tiles of 32 and, inside, over the G query heads of its kv head;
//         dk and dv accumulate in registers (2 keys x hd/8 columns each per
//         thread). Each block owns its keys, so no atomics are needed.
// Both skip a tile in which no (query, key) pair passes the mask before
// loading it, as the forward kernel does (about half the tiles at causal
// training shapes). Ragged edges are masked by bounds: a key outside
// [0, Sk) is invalid, a query outside [0, Sq) has no valid key. The
// products run on the CUDA cores in f32; wgmma and TMA are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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

__device__ __forceinline__ bool pair_ok(int qp, int kp, bool kvalid,
                                        int causal, int window) {
  return kvalid && (!causal || kp <= qp) && (window <= 0 || qp - kp < window);
}

// ---------------------------------------------------------------------------
// dq

namespace dq {
constexpr int BQ = 64;                     // query rows per block
constexpr int BK = 32;                     // keys per tile
constexpr int TX = 8;                      // threads sharing one query row
constexpr int RPT = BQ / (THREADS / TX);   // rows per thread (4)
constexpr int CPT = BK / TX;               // key columns per thread (4)

template <int HDP>
constexpr size_t smem_bytes() {
  return sizeof(float) * (2 * BQ * (HDP + 1) + 2 * BK * (HDP + 1) +
                          BQ * (BK + 1)) +
         sizeof(int) * 2 * BK;
}

template <typename T, int HDP>
__global__ void __launch_bounds__(THREADS)
kernel(const T* __restrict__ q, const T* __restrict__ k,
       const T* __restrict__ v, const int* __restrict__ q_pos,
       const int* __restrict__ k_pos, const uint8_t* __restrict__ k_valid,
       const T* __restrict__ dout, const float* __restrict__ lse,
       const float* __restrict__ delta, T* __restrict__ dq_out, int Sq,
       int Sk, int H, int KH, int hd, float scale, int causal, int window) {
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
    delta_r[i] = row_ok[i] ? delta[r] : 0.f;
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
        ok[i][j] = row_ok[i] && pair_ok(qp[i], kp_s[c], kv_s[c], causal,
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
#pragma unroll 4
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
    // a thread reads back only its own rows of dSs, written by the 8 lanes
    // of its own row group
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
__global__ void __launch_bounds__(THREADS)
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
        ok[i][j] = qok_s[c] && pair_ok(qp_s[c], kp[i], kv[i], causal, window);
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

template <typename T, int HDP>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* q_pos, const void* k_pos, const void* k_valid,
                   const void* dout, const void* lse, const void* delta,
                   void* dq_out, void* dk_out, void* dv_out, int B, int Sq,
                   int Sk, int H, int KH, int hd, float scale, int causal,
                   int window, cudaStream_t stream) {
  const size_t smem_q = dq::smem_bytes<HDP>();
  cudaError_t err = cudaFuncSetAttribute(
      dq::kernel<T, HDP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem_q);
  if (err != cudaSuccess) return err;
  const size_t smem_kv = dkv::smem_bytes<HDP>();
  err = cudaFuncSetAttribute(dkv::kernel<T, HDP>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem_kv);
  if (err != cudaSuccess) return err;

  const T* q_ = static_cast<const T*>(q);
  const T* k_ = static_cast<const T*>(k);
  const T* v_ = static_cast<const T*>(v);
  const int* qp_ = static_cast<const int*>(q_pos);
  const int* kp_ = static_cast<const int*>(k_pos);
  const uint8_t* kv_ = static_cast<const uint8_t*>(k_valid);
  const T* do_ = static_cast<const T*>(dout);
  const float* lse_ = static_cast<const float*>(lse);
  const float* delta_ = static_cast<const float*>(delta);

  const dim3 grid_q((Sq + dq::BQ - 1) / dq::BQ, H, B);
  dq::kernel<T, HDP><<<grid_q, THREADS, smem_q, stream>>>(
      q_, k_, v_, qp_, kp_, kv_, do_, lse_, delta_, static_cast<T*>(dq_out),
      Sq, Sk, H, KH, hd, scale, causal, window);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const dim3 grid_kv((Sk + dkv::BK - 1) / dkv::BK, KH, B);
  dkv::kernel<T, HDP><<<grid_kv, THREADS, smem_kv, stream>>>(
      q_, k_, v_, qp_, kp_, kv_, do_, lse_, delta_, static_cast<T*>(dk_out),
      static_cast<T*>(dv_out), Sq, Sk, H, KH, hd, scale, causal, window);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_hd(const void* q, const void* k, const void* v,
                        const void* q_pos, const void* k_pos,
                        const void* k_valid, const void* dout,
                        const void* lse, const void* delta, void* dq_out,
                        void* dk_out, void* dv_out, int B, int Sq, int Sk,
                        int H, int KH, int hd, float scale, int causal,
                        int window, cudaStream_t stream) {
#define REPRO_FA_BWD_LAUNCH(HDP)                                              \
  return launch<T, HDP>(q, k, v, q_pos, k_pos, k_valid, dout, lse, delta,    \
                        dq_out, dk_out, dv_out, B, Sq, Sk, H, KH, hd, scale, \
                        causal, window, stream)
  if (hd <= 16) REPRO_FA_BWD_LAUNCH(16);
  if (hd <= 32) REPRO_FA_BWD_LAUNCH(32);
  if (hd <= 64) REPRO_FA_BWD_LAUNCH(64);
  REPRO_FA_BWD_LAUNCH(128);
#undef REPRO_FA_BWD_LAUNCH
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. Tensors are contiguous: q/dout/dq
// [B,Sq,H,hd], k/v/dk/dv [B,Sk,KH,hd], q_pos [B,Sq] and k_pos [B,Sk]
// int32, k_valid [B,Sk] bool (one byte each), lse and delta [B,H,Sq] f32.
// Launches the dq kernel, then the dk/dv kernel, on `stream` without
// synchronising; returns the first CUDA error.
int flash_attention_bwd(int dtype, const void* q, const void* k,
                        const void* v, const void* q_pos, const void* k_pos,
                        const void* k_valid, const void* dout,
                        const void* lse, const void* delta, void* dq_out,
                        void* dk_out, void* dv_out, int B, int Sq, int Sk,
                        int H, int KH, int hd, float scale, int causal,
                        int window, void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || H <= 0 || KH <= 0 || H % KH != 0 ||
      hd <= 0 || hd > 128 || B > 65535 || H > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)dispatch_hd<float>(q, k, v, q_pos, k_pos, k_valid, dout, lse,
                                   delta, dq_out, dk_out, dv_out, B, Sq, Sk,
                                   H, KH, hd, scale, causal, window, st);
  if (dtype == 1)
    return (int)dispatch_hd<__nv_bfloat16>(
        q, k, v, q_pos, k_pos, k_valid, dout, lse, delta, dq_out, dk_out,
        dv_out, B, Sq, Sk, H, KH, hd, scale, causal, window, st);
  return (int)cudaErrorInvalidValue;
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

// Flash-attention forward for Hopper (sm_90a), f32 or bf16 I/O.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py:
// flash_attention_fwd (Pallas body `_fwd_kernel`). Same function: GQA
// attention masked by absolute int32 positions (causal, sliding window,
// per-key validity), online softmax in f32, emitting o [B,Sq,H,hd] in the
// input dtype and the row log-sum-exp lse [B,H,Sq] in f32. A row with no
// valid key gives o = 0 and lse = 0.
//
// What bounds it on an H100: at prefill (B=4, S=512, H=24, hd=128) the
// work is ~6.4 GFLOP of f32 products against ~67 MB of I/O, so it is
// bound by operations (67 TFLOP/s f32 outside the tensor cores, 989
// bf16 inside them). At decode (Sq=1) it is bound by bytes: each launch
// must read the valid part of the K/V cache once.
//
// What this first design does about it: one thread block per
// (query tile of 64 rows, q head, batch); q head h reads kv head h / G.
// The block loops over key tiles of 32, staged in shared memory as f32
// with padded strides so column walks hit distinct banks. Each thread
// owns 4 query rows x 4 key columns of the score tile and 4 rows x hd/8
// output columns of the f32 accumulator, in registers; the running max
// and normaliser of its rows live in registers too, and a row's 8
// threads share them through warp shuffles. A key tile in which no
// (row, key) pair passes the mask is skipped before its K/V are loaded:
// that halves causal prefill and skips the empty cache slots at decode.
// The products run on the CUDA cores (no wgmma, no TMA, no split over
// keys for decode); those are later work.
//
// Semantics kept from the TPU kernel: s = (q * scale) . k in f32 with
// the scale applied to q first; p masked explicitly (not only through
// the NEG_INF bias); p rounded to v's dtype before the PV product;
// o = acc / max(l, 1e-30); lse = m + log(l) where l > 0, else 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;               // query rows per block
constexpr int BK = 32;               // keys per tile
constexpr int THREADS = 128;
constexpr int TX = 8;                // threads sharing one query row
constexpr int RPT = BQ / (THREADS / TX);   // rows per thread (4)
constexpr int CPT = BK / TX;               // score columns per thread (4)
constexpr float NEG_INF = (float)(-0.7 * 3.4028234663852886e38);

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

template <typename T, int HDP>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* q_pos, const void* k_pos, const void* k_valid,
                   void* o, void* lse, int B, int Sq, int Sk, int H, int KH,
                   int hd, float scale, int causal, int window,
                   cudaStream_t stream) {
  const size_t smem = smem_bytes<HDP>();
  cudaError_t err = cudaFuncSetAttribute(
      fwd_kernel<T, HDP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + BQ - 1) / BQ, H, B);
  fwd_kernel<T, HDP><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(q_pos),
      static_cast<const int*>(k_pos), static_cast<const uint8_t*>(k_valid),
      static_cast<T*>(o), static_cast<float*>(lse), Sq, Sk, H, KH, hd, scale,
      causal, window);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_hd(const void* q, const void* k, const void* v,
                        const void* q_pos, const void* k_pos,
                        const void* k_valid, void* o, void* lse, int B,
                        int Sq, int Sk, int H, int KH, int hd, float scale,
                        int causal, int window, cudaStream_t stream) {
#define REPRO_FA_LAUNCH(HDP)                                                \
  return launch<T, HDP>(q, k, v, q_pos, k_pos, k_valid, o, lse, B, Sq, Sk, \
                        H, KH, hd, scale, causal, window, stream)
  if (hd <= 16) REPRO_FA_LAUNCH(16);
  if (hd <= 32) REPRO_FA_LAUNCH(32);
  if (hd <= 64) REPRO_FA_LAUNCH(64);
  REPRO_FA_LAUNCH(128);
#undef REPRO_FA_LAUNCH
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. Tensors are contiguous: q/o
// [B,Sq,H,hd], k/v [B,Sk,KH,hd], q_pos [B,Sq] and k_pos [B,Sk] int32,
// k_valid [B,Sk] bool (one byte each), lse [B,H,Sq] f32. Launches on
// `stream` without synchronising and returns cudaGetLastError().
int flash_attention_fwd(int dtype, const void* q, const void* k,
                        const void* v, const void* q_pos, const void* k_pos,
                        const void* k_valid, void* o, void* lse, int B,
                        int Sq, int Sk, int H, int KH, int hd, float scale,
                        int causal, int window, void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || H <= 0 || KH <= 0 || H % KH != 0 ||
      hd <= 0 || hd > 128 || B > 65535 || H > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)dispatch_hd<float>(q, k, v, q_pos, k_pos, k_valid, o, lse, B,
                                   Sq, Sk, H, KH, hd, scale, causal, window,
                                   st);
  if (dtype == 1)
    return (int)dispatch_hd<__nv_bfloat16>(q, k, v, q_pos, k_pos, k_valid, o,
                                           lse, B, Sq, Sk, H, KH, hd, scale,
                                           causal, window, st);
  return (int)cudaErrorInvalidValue;
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

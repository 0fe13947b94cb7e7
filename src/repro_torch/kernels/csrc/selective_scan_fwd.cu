// Mamba-1 selective scan, forward, for Hopper (sm_90a), f32 or bf16 inputs.
//
// Replaces the TPU kernel repro/kernels/selective_scan.py:
// selective_scan_fwd (Pallas body `_kernel`). Same function, with the state
// in f32 whatever the inputs' dtype; A = -exp(A_log):
//
//   a_t = exp(dt_t A)   h_t = a_t * h_{t-1} + (dt_t x_t) B_t   y_t = h_t . C_t
//
// x, dt, y [batch, S, di]; B, C [batch, S, ds]; A_log [di, ds] f32; h0
// [batch, di, ds] f32 (or null: zeros). Writes y (x's dtype), h_final =
// h_{S-1} and h_ckpt [batch, nc, di, ds], the state entering each chunk of
// `chunk` steps (nc = ceil(S / chunk); h_ckpt[:, 0] = h0), the residual the
// backward recomputes from.
//
// What bounds it on an H100: it reads x and dt and writes y once (3 x 4
// bytes a (b, t, d) in f32), plus B, C and the checkpoints; at the train
// shape (batch 8, S 512, di 8192, ds 16) ~0.41 GB, ~0.12 ms at 3.35 TB/s.
// Its operations (ds exps, ~5 flops per state a step: ~0.54 G state
// updates) are ~0.04 ms at 67 TFLOP/s: bound by bytes. In practice expf
// (IEEE, no fast math) costs ~10 instructions, so the issue rate is the
// first limit of this simple design.
//
// What this design does about it. The TPU keeps a [block_d, ds] state in
// VMEM across a sequential grid axis over chunks and steps t with a
// fori_loop. Here blocks run in parallel and in no order, so the
// sequential axis is a loop inside the block: one thread owns one (batch,
// channel d) and keeps its ds states, and its ds values of A, in registers
// for all S steps. A block is 128 channels of one batch row (grid
// ceil(di/128) x batch: 512 blocks at the train shape). x_t, dt_t and y_t
// move coalesced across the channels; each thread loads its next TT steps
// of x and dt into registers before it steps them, so TT loads are in
// flight at once. B_t and C_t, shared by every channel, are staged in
// shared memory TT steps at a time. A whole tile, with any chunk entry on
// its first step, runs its TT steps with no branch between them, so the
// compiler can overlap one step's exps with the last one's state update;
// a ragged last tile (or a chunk that is no multiple of TT) takes a
// guarded loop. Ragged d (hymba: 3200) and a ragged last chunk are masked,
// not padded. expf, not __expf, and no fast math: the kernel agrees with
// the plain version to f32 noise.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 128;   // channels per block
constexpr int TT = 16;         // time steps staged at a time

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// One step of one channel's recurrence: h advances, y_t is returned. The
// sum over d_state runs as four partial sums, so it is not one chain of DS
// dependent FMAs.
template <int DS>
__device__ __forceinline__ float step(float (&h)[DS], const float (&a_neg)[DS],
                                      float x, float dt, const float* sb,
                                      const float* sc) {
  const float dx = dt * x;
  float y[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int s = 0; s < DS; ++s) {
    const float a = expf(dt * a_neg[s]);
    h[s] = a * h[s] + dx * sb[s];
    y[s % 4] += h[s] * sc[s];
  }
  return (y[0] + y[1]) + (y[2] + y[3]);
}

template <typename T, int DS>
__global__ void __launch_bounds__(THREADS)
scan_fwd_kernel(const T* __restrict__ x, const T* __restrict__ dt,
       const T* __restrict__ bm, const T* __restrict__ cm,
       const float* __restrict__ a_log, const float* __restrict__ h0,
       T* __restrict__ y, float* __restrict__ h_final,
       float* __restrict__ h_ckpt, int S, int di, int chunk, int nc) {
  __shared__ float sb[TT][DS];
  __shared__ float sc[TT][DS];
  const int tid = threadIdx.x;
  const int d = blockIdx.x * THREADS + tid;
  const size_t b = blockIdx.y;
  const bool valid = d < di;

  float a_neg[DS], h[DS];
#pragma unroll
  for (int s = 0; s < DS; ++s) {
    a_neg[s] = valid ? -expf(a_log[(size_t)d * DS + s]) : 0.f;
    h[s] = (valid && h0 != nullptr) ? h0[(b * di + d) * DS + s] : 0.f;
  }
  auto checkpoint = [&](int t) {           // the state entering a chunk
    if (!valid) return;
    float* ck = h_ckpt + ((b * nc + t / chunk) * di + d) * DS;
#pragma unroll
    for (int s = 0; s < DS; ++s) ck[s] = h[s];
  };

  const T* xb = x + b * S * di + d;
  const T* db = dt + b * S * di + d;
  T* yb = y + b * S * di + d;
  // a whole tile whose chunk entries can only fall on its first step
  // steps with no branch, so the compiler may interleave its steps
  const bool aligned = chunk % TT == 0;
  for (int t0 = 0; t0 < S; t0 += TT) {
    const int n = min(TT, S - t0);
    __syncthreads();                       // the last tile's B, C are read
    for (int k = tid; k < TT * DS; k += THREADS) {
      const int i = k / DS, s = k % DS;
      const size_t off = (b * S + t0 + i) * DS + s;
      sb[i][s] = i < n ? to_f32(bm[off]) : 0.f;
      sc[i][s] = i < n ? to_f32(cm[off]) : 0.f;
    }
    float xs[TT], dts[TT];
#pragma unroll
    for (int i = 0; i < TT; ++i) {
      const bool ok = valid && i < n;
      xs[i] = ok ? to_f32(xb[(size_t)(t0 + i) * di]) : 0.f;
      dts[i] = ok ? to_f32(db[(size_t)(t0 + i) * di]) : 0.f;
    }
    __syncthreads();
    if (aligned && n == TT) {
      if (t0 % chunk == 0) checkpoint(t0);
      float ys[TT];
#pragma unroll
      for (int i = 0; i < TT; ++i)
        ys[i] = step<DS>(h, a_neg, xs[i], dts[i], sb[i], sc[i]);
      if (valid) {
#pragma unroll
        for (int i = 0; i < TT; ++i) store(yb + (size_t)(t0 + i) * di, ys[i]);
      }
    } else {                               // a ragged or unaligned tile
      for (int i = 0; i < n; ++i) {
        const int t = t0 + i;
        if (t % chunk == 0) checkpoint(t);
        float xi = 0.f, di_ = 0.f;
#pragma unroll
        for (int k = 0; k < TT; ++k)       // registers: no dynamic index
          if (k == i) xi = xs[k], di_ = dts[k];
        const float yv = step<DS>(h, a_neg, xi, di_, sb[i], sc[i]);
        if (valid) store(yb + (size_t)t * di, yv);
      }
    }
  }
  if (valid) {
#pragma unroll
    for (int s = 0; s < DS; ++s) h_final[(b * di + d) * DS + s] = h[s];
  }
}

template <typename T>
int launch(int ds, const void* x, const void* dt, const void* bm,
           const void* cm, const float* a_log, const float* h0, void* y,
           float* h_final, float* h_ckpt, int batch, int S, int di,
           int chunk, cudaStream_t st) {
  const dim3 grid((di + THREADS - 1) / THREADS, batch);
  const int nc = (S + chunk - 1) / chunk;
  const T* xx = static_cast<const T*>(x);
  const T* dd = static_cast<const T*>(dt);
  const T* bb = static_cast<const T*>(bm);
  const T* cc = static_cast<const T*>(cm);
  T* yy = static_cast<T*>(y);
  switch (ds) {
    case 4:
      scan_fwd_kernel<T, 4><<<grid, THREADS, 0, st>>>(
          xx, dd, bb, cc, a_log, h0, yy, h_final, h_ckpt, S, di, chunk, nc);
      break;
    case 8:
      scan_fwd_kernel<T, 8><<<grid, THREADS, 0, st>>>(
          xx, dd, bb, cc, a_log, h0, yy, h_final, h_ckpt, S, di, chunk, nc);
      break;
    case 16:
      scan_fwd_kernel<T, 16><<<grid, THREADS, 0, st>>>(
          xx, dd, bb, cc, a_log, h0, yy, h_final, h_ckpt, S, di, chunk, nc);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (x, dt, B, C and y); ds in {4, 8, 16}.
// Every pointer is contiguous device memory; h0 may be null. Launches on
// `stream` without synchronising and returns cudaGetLastError().
int selective_scan_fwd(int dtype, int ds, const void* x, const void* dt,
                       const void* bm, const void* cm, const void* a_log,
                       const void* h0, void* y, void* h_final, void* h_ckpt,
                       int batch, int S, int di, int chunk, void* stream) {
  if (batch <= 0 || S <= 0 || di <= 0 || chunk <= 0 || batch > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* al = static_cast<const float*>(a_log);
  const float* hh = static_cast<const float*>(h0);
  float* hf = static_cast<float*>(h_final);
  float* hc = static_cast<float*>(h_ckpt);
  if (dtype == 0)
    return launch<float>(ds, x, dt, bm, cm, al, hh, y, hf, hc, batch, S, di,
                         chunk, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(ds, x, dt, bm, cm, al, hh, y, hf, hc, batch,
                                 S, di, chunk, st);
  return (int)cudaErrorInvalidValue;
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

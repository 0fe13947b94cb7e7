// Mamba-1 selective scan, backward, for Hopper (sm_90a), f32 or bf16 inputs.
//
// Replaces the TPU kernel repro/kernels/selective_scan.py:
// selective_scan_bwd (Pallas body `_bwd_kernel`). For the forward
// h_t = a_t h_{t-1} + (dt_t x_t) B_t, y_t = h_t . C_t, a_t = exp(dt_t A),
// A = -exp(A_log), it sweeps the chunks of `chunk` steps in reverse,
// recomputes each chunk's states from its checkpoint h_ckpt[:, c] and runs
// the adjoint, with the carry g entering as gh (the cotangent of h_final):
//
//   lam = g + gy_t C_t            sb = lam . B_t      dadt = lam h_{t-1} a_t
//   dx_t = dt_t sb                ddt_t = x_t sb + dadt . A
//   db_t = sum_d (dt_t x_t) lam   dc_t = sum_d gy_t h_t
//   dA_log += dadt dt_t A         g = a_t lam         (dh0 = the last g)
//
// Outputs: dx, ddt [batch, S, di] in the inputs' dtype; db/dc per-block
// partials [batch, nd, S, ds] and dA_log per-batch partials [batch, di,
// ds], f32, summed by the wrapper (no atomics: the result does not depend
// on the order the blocks run in); dh0 [batch, di, ds] f32.
//
// What bounds it on an H100: it reads x, dt, gy and h_ckpt and writes dx,
// ddt and the partials, ~0.7 GB at the train shape (batch 8, S 512, di
// 8192, ds 16): ~0.2 ms at 3.35 TB/s; bound by bytes. It recomputes every
// state twice (two exps a state a step; the adjoint reuses the second's
// a_t), so the issue rate is the first limit of this simple design.
//
// What this design does about it. The TPU recomputes a whole chunk's
// states into a [chunk, block_d, ds] VMEM scratch (8 MB at chunk 256,
// block_d 512); that does not fit 227 KB of shared memory, and a global
// [batch, chunk, di, ds] scratch would be 1 GB. So the recompute has two
// levels: walk the chunk forward once, keeping the state entering each
// sub-chunk of SUB = 16 steps in shared memory; then, for each sub-chunk
// in reverse, recompute its SUB states into registers and run the adjoint
// back through them. The recurrence is never inverted (h_{t-1} = (h_t -
// bx_t) / a_t): a_t underflows toward 0.
//
// One thread owns one (batch, channel d, state s): ds lanes make a
// channel, a block of 256 threads holds 256 / ds channels of one batch row.
// A thread then keeps only its own state's lam, dA_log sum and 17
// recomputed states (registers) and its sub-chunk entries (64 bytes of
// shared memory a thread at chunk 256); one thread per (batch, d) would
// keep 16 of each, 2 KB of shared memory a thread, and fit 3 warps on an
// SM. The sums over s (sb, dadt . A) are xor shuffles over the channel's
// lanes; the sums over d (db, dc) are xor shuffles over the warp's
// channels, then a fixed-order sum over the block's warps in shared memory,
// one sub-chunk at a time. A whole sub-chunk runs its adjoint steps with
// no branch between them. Ragged d and a ragged last chunk are masked:
// lanes past di carry zeros through every sum. expf, not __expf, and no
// fast math: the kernel agrees with the plain version to f32 noise.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int NWARPS = THREADS / 32;
constexpr int SUB = 16;           // steps of a recomputed sub-chunk
constexpr int MAX_CHUNK = 2048;   // sub-chunk entries: 128 KB of shared memory

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// The sum of v over the DS lanes of a channel, in every one of them.
template <int DS>
__device__ __forceinline__ float channel_sum(float v) {
#pragma unroll
  for (int m = 1; m < DS; m *= 2) v += __shfl_xor_sync(0xffffffffu, v, m);
  return v;
}

// The sum of v over the warp's channels (lanes equal mod DS).
template <int DS>
__device__ __forceinline__ float warp_channels_sum(float v) {
#pragma unroll
  for (int m = DS; m < 32; m *= 2) v += __shfl_xor_sync(0xffffffffu, v, m);
  return v;
}

size_t smem_bytes(int chunk, int ds) {
  const int nsub = (chunk + SUB - 1) / SUB;
  return (size_t)nsub * THREADS * sizeof(float)          // sub-chunk entries
         + (size_t)SUB * NWARPS * 2 * ds * sizeof(float);  // db / dc sums
}

template <typename T, int DS>
__global__ void __launch_bounds__(THREADS, 2)
scan_bwd_kernel(const T* __restrict__ x, const T* __restrict__ dt,
       const T* __restrict__ bm, const T* __restrict__ cm,
       const float* __restrict__ a_log, const float* __restrict__ h_ckpt,
       const T* __restrict__ gy, const float* __restrict__ gh,
       T* __restrict__ dx, T* __restrict__ ddt, float* __restrict__ db_part,
       float* __restrict__ dc_part, float* __restrict__ da_part,
       float* __restrict__ dh0, int S, int di, int chunk, int nc) {
  constexpr int CH = THREADS / DS;        // channels a block
  extern __shared__ float smem[];
  const int nsub_max = (chunk + SUB - 1) / SUB;
  float* ent = smem;                                   // [nsub_max][THREADS]
  float* red = smem + (size_t)nsub_max * THREADS;      // [SUB][NWARPS][2][DS]

  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const int s = tid % DS;
  const int d = blockIdx.x * CH + tid / DS;
  const size_t b = blockIdx.y;
  const int nd = gridDim.x;
  const bool valid = d < di;

  const float A = valid ? -expf(a_log[(size_t)d * DS + s]) : 0.f;
  float g = valid ? gh[(b * di + d) * DS + s] : 0.f;   // lam carry
  float dA = 0.f;

  const size_t row = b * S;                 // first (b, t) row
  for (int c = nc - 1; c >= 0; --c) {
    const int t0 = c * chunk;
    const int L = min(chunk, S - t0);
    const int nsub = (L + SUB - 1) / SUB;

    // level 1: the state entering each sub-chunk
    float h = valid ? h_ckpt[((b * nc + c) * di + d) * DS + s] : 0.f;
    for (int j = 0; j < nsub; ++j) {
      ent[j * THREADS + tid] = h;
      if (j == nsub - 1) break;
#pragma unroll
      for (int i = 0; i < SUB; ++i) {
        const size_t r = row + t0 + j * SUB + i;
        const float xv = valid ? to_f32(x[r * di + d]) : 0.f;
        const float dv = valid ? to_f32(dt[r * di + d]) : 0.f;
        h = expf(dv * A) * h + (dv * xv) * to_f32(bm[r * DS + s]);
      }
    }

    // level 2: each sub-chunk in reverse
    for (int j = nsub - 1; j >= 0; --j) {
      const int ts = t0 + j * SUB;
      const int len = min(SUB, L - j * SUB);
      float xs[SUB], dts[SUB], bs[SUB], as[SUB], hs[SUB + 1];
      hs[0] = ent[j * THREADS + tid];
#pragma unroll
      for (int i = 0; i < SUB; ++i) {
        const bool ok = i < len;
        const size_t r = row + ts + i;
        xs[i] = ok && valid ? to_f32(x[r * di + d]) : 0.f;
        dts[i] = ok && valid ? to_f32(dt[r * di + d]) : 0.f;
        bs[i] = ok ? to_f32(bm[r * DS + s]) : 0.f;
      }
#pragma unroll
      for (int i = 0; i < SUB; ++i) {
        as[i] = expf(dts[i] * A);
        hs[i + 1] = as[i] * hs[i] + (dts[i] * xs[i]) * bs[i];
      }
      // the adjoint of step i of the sub-chunk (t = ts + i)
      auto adjoint = [&](int i) {
        const size_t r = row + ts + i;
        const float gyt = valid ? to_f32(gy[r * di + d]) : 0.f;
        const float ct = to_f32(cm[r * DS + s]);
        const float lam = g + gyt * ct;
        const float sb = channel_sum<DS>(lam * bs[i]);
        const float dadt = lam * hs[i] * as[i];
        const float tda = channel_sum<DS>(dadt * A);
        if (valid && s == 0) {
          store(dx + r * di + d, dts[i] * sb);
          store(ddt + r * di + d, xs[i] * sb + tda);
        }
        dA += dadt * dts[i] * A;
        g = as[i] * lam;
        const float cb = warp_channels_sum<DS>((dts[i] * xs[i]) * lam);
        const float cc = warp_channels_sum<DS>(gyt * hs[i + 1]);
        if (lane < DS) {
          red[((i * NWARPS + warp) * 2 + 0) * DS + s] = cb;
          red[((i * NWARPS + warp) * 2 + 1) * DS + s] = cc;
        }
      };
      if (len == SUB) {       // a whole sub-chunk: no branch between steps
#pragma unroll
        for (int i = SUB - 1; i >= 0; --i) adjoint(i);
      } else {
#pragma unroll
        for (int i = SUB - 1; i >= 0; --i)
          if (i < len) adjoint(i);        // uniform across the block
      }
      __syncthreads();
      for (int k = tid; k < len * 2 * DS; k += THREADS) {
        const int i = k / (2 * DS), which = (k / DS) % 2, s2 = k % DS;
        float sum = 0.f;
#pragma unroll
        for (int w = 0; w < NWARPS; ++w)
          sum += red[((i * NWARPS + w) * 2 + which) * DS + s2];
        float* out = which ? dc_part : db_part;
        out[((b * nd + blockIdx.x) * S + ts + i) * DS + s2] = sum;
      }
      __syncthreads();                      // red is written again next
    }
  }
  if (valid) {
    da_part[(b * di + d) * DS + s] = dA;
    dh0[(b * di + d) * DS + s] = g;
  }
}

template <typename T, int DS>
int launch_ds(const void* x, const void* dt, const void* bm, const void* cm,
              const float* a_log, const float* h_ckpt, const void* gy,
              const float* gh, void* dx, void* ddt, float* db_part,
              float* dc_part, float* da_part, float* dh0, int batch, int S,
              int di, int chunk, cudaStream_t st) {
  constexpr int CH = THREADS / DS;
  const size_t smem = smem_bytes(chunk, DS);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        scan_bwd_kernel<T, DS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((di + CH - 1) / CH, batch);
  const int nc = (S + chunk - 1) / chunk;
  scan_bwd_kernel<T, DS><<<grid, THREADS, smem, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(dt),
      static_cast<const T*>(bm), static_cast<const T*>(cm), a_log, h_ckpt,
      static_cast<const T*>(gy), gh, static_cast<T*>(dx),
      static_cast<T*>(ddt), db_part, dc_part, da_part, dh0, S, di, chunk,
      nc);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(int ds, const void* x, const void* dt, const void* bm,
           const void* cm, const float* a_log, const float* h_ckpt,
           const void* gy, const float* gh, void* dx, void* ddt,
           float* db_part, float* dc_part, float* da_part, float* dh0,
           int batch, int S, int di, int chunk, cudaStream_t st) {
  switch (ds) {
    case 4:
      return launch_ds<T, 4>(x, dt, bm, cm, a_log, h_ckpt, gy, gh, dx, ddt,
                             db_part, dc_part, da_part, dh0, batch, S, di,
                             chunk, st);
    case 8:
      return launch_ds<T, 8>(x, dt, bm, cm, a_log, h_ckpt, gy, gh, dx, ddt,
                             db_part, dc_part, da_part, dh0, batch, S, di,
                             chunk, st);
    case 16:
      return launch_ds<T, 16>(x, dt, bm, cm, a_log, h_ckpt, gy, gh, dx, ddt,
                              db_part, dc_part, da_part, dh0, batch, S, di,
                              chunk, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Channels a block covers (the partials' nd = ceil(di / this)).
int selective_scan_bwd_channels(int ds) { return THREADS / ds; }

int selective_scan_bwd_max_chunk() { return MAX_CHUNK; }

// dtype: 0 = float32, 1 = bfloat16 (x, dt, B, C, gy, dx and ddt); ds in
// {4, 8, 16}; chunk <= MAX_CHUNK. Every pointer is contiguous device
// memory. Launches on `stream` without synchronising and returns
// cudaGetLastError().
int selective_scan_bwd(int dtype, int ds, const void* x, const void* dt,
                       const void* bm, const void* cm, const void* a_log,
                       const void* h_ckpt, const void* gy, const void* gh,
                       void* dx, void* ddt, void* db_part, void* dc_part,
                       void* da_part, void* dh0, int batch, int S, int di,
                       int chunk, void* stream) {
  if (batch <= 0 || S <= 0 || di <= 0 || chunk <= 0 || chunk > MAX_CHUNK ||
      batch > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* al = static_cast<const float*>(a_log);
  const float* hc = static_cast<const float*>(h_ckpt);
  const float* g = static_cast<const float*>(gh);
  float* dbp = static_cast<float*>(db_part);
  float* dcp = static_cast<float*>(dc_part);
  float* dap = static_cast<float*>(da_part);
  float* h0 = static_cast<float*>(dh0);
  if (dtype == 0)
    return launch<float>(ds, x, dt, bm, cm, al, hc, gy, g, dx, ddt, dbp, dcp,
                         dap, h0, batch, S, di, chunk, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(ds, x, dt, bm, cm, al, hc, gy, g, dx, ddt,
                                 dbp, dcp, dap, h0, batch, S, di, chunk, st);
  return (int)cudaErrorInvalidValue;
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

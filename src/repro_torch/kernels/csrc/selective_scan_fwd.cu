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
// What bounds it on an H100. Bytes: x and dt in, y out (3 x 4 bytes a (b,
// t, d) in f32), plus B, C and the checkpoints; at falcon-mamba's train
// shape (batch 8, S 512, di 8192, ds 16) ~0.44 GB with a checkpoint every
// 64 steps, 0.13 ms at 3.35 TB/s. Exponentials: one a state a step,
// B*S*di*ds = 537 M there, on the SFU at 16 a clock an SM (132 SMs, 1.98
// GHz: 4.18 T/s), 0.13 ms. The other f32 work (~4 operations a
// state-step) is ~0.03 ms at 67 TFLOP/s. So the exps and the bytes bound
// it about equally.
//
// Design. One thread owns one (batch, channel d) and keeps its ds states
// and its ds values of A * log2(e) in registers; a block is 128 channels
// of one batch row. x_t, dt_t and y_t move coalesced across the channels,
// TT steps of x and dt are loaded into registers before they are stepped,
// and B_t, C_t (shared by every channel) are staged in shared memory TT
// steps at a time. A whole tile steps with no branch. (4 states a thread,
// y_t summed over a channel's lanes by a transpose-reduce, was timed
// against it on an H100 and was slower at every main-path shape; PERF.md,
// PR 16.) Registers (ptxas, sm_90a): the sweep 128 at ds 16 and 72-90
// at ds 4 and 8, with no spill; the bf16 local pass at ds 16 takes 96 and
// spills 4 bytes (the f32 one does not); the combine 32. chip_smoke.py
// fails the build on a larger spill.
//
// Where batch * di is too small to fill the card (hymba-1.5b's prefill, B 4
// x di 3200, is 100 blocks of 4 warps on 132 SMs, each thread 1536
// dependent steps), the sequence is split into segments of whole chunks
// (`seg_chunks` chunks each), since the recurrence is linear:
//   1. `local`: every segment but the last runs from a zero state and
//      writes its end state into the h_ckpt slot of the next segment's
//      entry, and the sum of its dt per channel into `seg_dt` [batch, nseg,
//      di] (its decay is exp(A * that sum));
//   2. `combine`: one thread per (batch, d, state) walks the segments in
//      order, h_entry(k+1) = exp(A * seg_dt_k) h_entry(k) + local_k, in
//      place in h_ckpt: the true state entering each segment;
//   3. `sweep`: every segment runs again from its true entry and writes y,
//      the chunk checkpoints inside it and (the last) h_final.
// The split doubles the exps of all but the last segment, so the wrapper
// takes it only where the grid is small (selective_scan.fwd_seg_chunks).
// The scratch is seg_dt alone: the local end states live in h_ckpt.
//
// The decay is ex2.approx.ftz(dt * A log2(e)) in place of expf(dt * A):
// one SFU instruction and a multiply instead of expf's range reduction (or
// exp2f's range test and scaling). Its cost in accuracy: A log2(e) is
// rounded once (half an ulp), the product once more, and ex2.approx errs by
// up to 2 ulp, so a_t is within ~2 + 1.5 |dt A log2(e)| ulp of the exact
// value (a few ulp at the paths' dt), and a decay under 2^-126 becomes 0
// (it multiplies a state that is then below 1e-38 of its size). On the card
// the outputs stay within 3e-6 of the plain version's largest element (the
// tolerance is 1e-4). The segment split sums the decay as exp(A * sum dt)
// rather than a product of exps: the same number up to f32 rounding.
// Ragged d (hymba: 3200) and a ragged last chunk are masked, not padded.
// Block order never changes a result: no atomics, and every value is
// computed by one thread in a fixed order.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 128;
constexpr int TT = 16;         // time steps staged at a time
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// ex2.approx.ftz: 2^x on the SFU, results below 2^-126 flushed to 0 (a
// decay under 1.2e-38); exp2f without -ftz adds a range test and two
// scaling multiplies around the same instruction.
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// One step of a channel's G states: h advances and y_t is returned (0 in
// the local pass, which has no C). The sum runs as two partial sums, not
// one chain of G dependent FMAs.
template <int G, bool WITH_Y>
__device__ __forceinline__ float step(float (&h)[G], const float (&a2)[G],
                                      float x, float dt, const float* sb,
                                      const float* sc) {
  const float dx = dt * x;
  float y[2] = {0.f, 0.f};
#pragma unroll
  for (int k = 0; k < G; ++k) {
    h[k] = exp2_ftz(dt * a2[k]) * h[k] + dx * sb[k];
    if (WITH_Y) y[k % 2] += h[k] * sc[k];
  }
  return y[0] + y[1];
}

// A thread owns the DS states of one (batch, channel); a block holds
// THREADS channels.
//
// LOCAL: segment blockIdx.z (never the last) from a zero state; writes its
// end state to h_ckpt at the next segment's entry and its sum of dt to
// seg_dt. Otherwise: segment blockIdx.z from its entry (h0 or zeros for the
// first, h_ckpt for the others); writes y, every chunk entry inside the
// segment and, for the last segment, h_final.
template <typename T, int DS, bool LOCAL>
__global__ void __launch_bounds__(THREADS)
sweep_kernel(const T* __restrict__ x, const T* __restrict__ dt,
             const T* __restrict__ bm, const T* __restrict__ cm,
             const float* __restrict__ a_log, const float* __restrict__ h0,
             T* __restrict__ y, float* __restrict__ h_final,
             float* __restrict__ h_ckpt, float* __restrict__ seg_dt, int S,
             int di, int chunk, int nc, int seg_chunks) {
  __shared__ float sb[TT][DS];
  __shared__ float sc[TT][DS];
  const int tid = threadIdx.x;
  const int d = blockIdx.x * THREADS + tid;
  const size_t b = blockIdx.y;
  const int seg = blockIdx.z;
  const bool valid = d < di;
  const int t_begin = seg * seg_chunks * chunk;
  const int t_end = min(S, t_begin + seg_chunks * chunk);

  float a2[DS], h[DS];
  const float* entry =
      LOCAL ? nullptr
            : (seg == 0 ? (h0 == nullptr ? nullptr : h0 + b * di * DS)
                        : h_ckpt + (b * nc + seg * seg_chunks) * di * DS);
#pragma unroll
  for (int k = 0; k < DS; ++k) {
    a2[k] = valid ? -expf(a_log[(size_t)d * DS + k]) * LOG2E : 0.f;
    h[k] = (valid && entry != nullptr) ? entry[(size_t)d * DS + k] : 0.f;
  }
  auto checkpoint = [&](int t) {           // the state entering a chunk
    if (LOCAL || !valid) return;
    float* ck = h_ckpt + ((b * nc + t / chunk) * di + d) * DS;
#pragma unroll
    for (int k = 0; k < DS; ++k) ck[k] = h[k];
  };

  const T* xb = x + b * S * di + d;
  const T* dtb = dt + b * S * di + d;
  T* yb = y + b * S * di + d;
  float dt_sum = 0.f;
  // a whole tile whose chunk entries can only fall on its first step
  // steps with no branch, so the compiler may interleave its steps
  const bool aligned = chunk % TT == 0;
  for (int t0 = t_begin; t0 < t_end; t0 += TT) {
    const int n = min(TT, t_end - t0);
    __syncthreads();                       // the last tile's B, C are read
    for (int k = tid; k < TT * DS; k += THREADS) {
      const int i = k / DS, s = k % DS;
      const size_t off = (b * S + t0 + i) * DS + s;
      sb[i][s] = i < n ? to_f32(bm[off]) : 0.f;
      if (!LOCAL) sc[i][s] = i < n ? to_f32(cm[off]) : 0.f;
    }
    float xs[TT], dts[TT], ys[TT];
#pragma unroll
    for (int i = 0; i < TT; ++i) {
      const bool ok = valid && i < n;
      xs[i] = ok ? to_f32(xb[(size_t)(t0 + i) * di]) : 0.f;
      dts[i] = ok ? to_f32(dtb[(size_t)(t0 + i) * di]) : 0.f;
    }
    __syncthreads();
    if (aligned && n == TT) {
      if (t0 % chunk == 0) checkpoint(t0);
#pragma unroll
      for (int i = 0; i < TT; ++i)
        ys[i] = step<DS, !LOCAL>(h, a2, xs[i], dts[i], sb[i], sc[i]);
    } else {                               // a ragged or unaligned tile
#pragma unroll
      for (int i = 0; i < TT; ++i) {
        ys[i] = 0.f;
        if (i < n) {                       // uniform across the block
          if ((t0 + i) % chunk == 0) checkpoint(t0 + i);
          ys[i] = step<DS, !LOCAL>(h, a2, xs[i], dts[i], sb[i], sc[i]);
        }
      }
    }
    if (LOCAL) {
#pragma unroll
      for (int i = 0; i < TT; ++i) dt_sum += dts[i];
    } else if (valid) {
#pragma unroll
      for (int i = 0; i < TT; ++i)
        if (i < n) store(yb + (size_t)(t0 + i) * di, ys[i]);
    }
  }
  if (!valid) return;
  if (LOCAL) {
    const int nseg = gridDim.z + 1;
    seg_dt[(b * nseg + seg) * di + d] = dt_sum;
    float* out = h_ckpt + ((b * nc + (seg + 1) * seg_chunks) * di + d) * DS;
#pragma unroll
    for (int k = 0; k < DS; ++k) out[k] = h[k];
  } else if (t_end == S) {
#pragma unroll
    for (int k = 0; k < DS; ++k) h_final[(b * di + d) * DS + k] = h[k];
  }
}

// The true state entering each segment, from the local end states (in
// h_ckpt at each segment's entry) and the segments' dt sums; one thread per
// (batch, d, state), the segments in order.
template <int DS>
__global__ void __launch_bounds__(256)
combine_kernel(const float* __restrict__ a_log, const float* __restrict__ h0,
               float* __restrict__ h_ckpt, const float* __restrict__ seg_dt,
               int batch, int di, int nc, int seg_chunks, int nseg) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (size_t)batch * di * DS) return;
  const size_t b = i / ((size_t)di * DS);
  const int d = (int)(i / DS % di), s = (int)(i % DS);
  const float a2 = -expf(a_log[(size_t)d * DS + s]) * LOG2E;
  float h = h0 != nullptr ? h0[i] : 0.f;
  for (int k = 0; k + 1 < nseg; ++k) {
    float* ck = h_ckpt + ((b * nc + (size_t)(k + 1) * seg_chunks) * di + d)
                             * DS + s;
    h = exp2_ftz(a2 * seg_dt[(b * nseg + k) * di + d]) * h + *ck;
    *ck = h;
  }
}

template <typename T, int DS>
int launch_ds(const void* x, const void* dt, const void* bm, const void* cm,
              const float* a_log, const float* h0, void* y, float* h_final,
              float* h_ckpt, float* seg_dt, int batch, int S, int di,
              int chunk, int seg_chunks, cudaStream_t st) {
  const int nc = (S + chunk - 1) / chunk;
  const int nseg = (nc + seg_chunks - 1) / seg_chunks;
  const T* xx = static_cast<const T*>(x);
  const T* dd = static_cast<const T*>(dt);
  const T* bb = static_cast<const T*>(bm);
  const T* cc = static_cast<const T*>(cm);
  T* yy = static_cast<T*>(y);
  const int gx = (di + THREADS - 1) / THREADS;
  if (nseg > 1) {
    sweep_kernel<T, DS, true>
        <<<dim3(gx, batch, nseg - 1), THREADS, 0, st>>>(
            xx, dd, bb, cc, a_log, h0, yy, h_final, h_ckpt, seg_dt, S, di,
            chunk, nc, seg_chunks);
    const size_t n = (size_t)batch * di * DS;
    combine_kernel<DS><<<(unsigned)((n + 255) / 256), 256, 0, st>>>(
        a_log, h0, h_ckpt, seg_dt, batch, di, nc, seg_chunks, nseg);
  }
  sweep_kernel<T, DS, false><<<dim3(gx, batch, nseg), THREADS, 0, st>>>(
      xx, dd, bb, cc, a_log, h0, yy, h_final, h_ckpt, seg_dt, S, di, chunk,
      nc, seg_chunks);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(int ds, const void* x, const void* dt, const void* bm,
           const void* cm, const float* a_log, const float* h0, void* y,
           float* h_final, float* h_ckpt, float* seg_dt, int batch, int S,
           int di, int chunk, int seg_chunks, cudaStream_t st) {
  switch (ds) {
    case 4:
      return launch_ds<T, 4>(x, dt, bm, cm, a_log, h0, y, h_final, h_ckpt,
                             seg_dt, batch, S, di, chunk, seg_chunks, st);
    case 8:
      return launch_ds<T, 8>(x, dt, bm, cm, a_log, h0, y, h_final, h_ckpt,
                             seg_dt, batch, S, di, chunk, seg_chunks, st);
    case 16:
      return launch_ds<T, 16>(x, dt, bm, cm, a_log, h0, y, h_final, h_ckpt,
                              seg_dt, batch, S, di, chunk, seg_chunks, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (x, dt, B, C and y); ds in {4, 8, 16}.
// seg_chunks: chunks a segment (>= nc: one sweep, seg_dt unused and may be
// null); otherwise seg_dt points at [batch, ceil(nc / seg_chunks), di] f32
// scratch. Every pointer is contiguous device memory; h0 may be null.
// Launches on `stream` without synchronising and returns
// cudaGetLastError().
int selective_scan_fwd(int dtype, int ds, const void* x, const void* dt,
                       const void* bm, const void* cm, const void* a_log,
                       const void* h0, void* y, void* h_final, void* h_ckpt,
                       void* seg_dt, int batch, int S, int di, int chunk,
                       int seg_chunks, void* stream) {
  if (batch <= 0 || S <= 0 || di <= 0 || chunk <= 0 || seg_chunks <= 0 ||
      batch > 65535)
    return (int)cudaErrorInvalidValue;
  const int nc = (S + chunk - 1) / chunk;
  if (seg_chunks < nc && (seg_dt == nullptr ||
                          (nc + seg_chunks - 1) / seg_chunks > 65535))
    return (int)cudaErrorInvalidValue;
  if (seg_chunks > nc) seg_chunks = nc;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* al = static_cast<const float*>(a_log);
  const float* hh = static_cast<const float*>(h0);
  float* hf = static_cast<float*>(h_final);
  float* hc = static_cast<float*>(h_ckpt);
  float* sd = static_cast<float*>(seg_dt);
  if (dtype == 0)
    return launch<float>(ds, x, dt, bm, cm, al, hh, y, hf, hc, sd, batch, S,
                         di, chunk, seg_chunks, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(ds, x, dt, bm, cm, al, hh, y, hf, hc, sd,
                                 batch, S, di, chunk, seg_chunks, st);
  return (int)cudaErrorInvalidValue;
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

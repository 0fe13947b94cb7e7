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
// on the order the blocks run in); dh0 [batch, di, ds] f32. nd = ceil(di /
// 64): 128 at falcon-mamba's di 8192, so each
// partial is 33.5 MB at its train shape (batch 8, S 512, ds 16), against
// 268 MB (nd 512) in the first design.
//
// What bounds it on an H100. Bytes: x, dt, gy and h_ckpt in, dx, ddt and
// the partials out, ~0.7 GB at the train shape with a checkpoint every 64
// steps: 0.21 ms at 3.35 TB/s. Exponentials: at least one a state a step,
// 537 M there, 0.13 ms on the SFU (16 a clock an SM). The f32 work, ~22
// operations a state-step, is 0.18 ms at 67 TFLOP/s. So bytes, exps and
// f32 issue are all near the same limit; the first design lost to issue
// (16-lane shuffles for every sum over the states) and to its partials.
//
// Design. A thread owns one (batch, channel d, group of G states): NG =
// ds / G threads make a channel, CPW = 32 / NG channels a warp, and a block
// covers CH channels of one batch row (CH * NG threads). Each chunk is
// taken in pieces of PIECE = NENT * SUB steps, in reverse. A piece's B, C
// and its channels' x, dt and gy are staged in shared memory first (one
// coalesced pass, so no step waits on device memory); then
//   level 1 walks the piece forward from its entry state once and keeps
//     the state entering each sub-chunk of SUB steps in shared memory
//     (NENT x G floats a thread);
//   level 2 takes each sub-chunk in reverse, recomputes its SUB states and
//     decays into registers (hs, as) and runs the adjoint back through them.
// So every state is computed twice (two exps a state-step, the least this
// layout allows: keeping a whole piece's states would take PIECE x G
// registers). The port's train path checkpoints every PIECE steps
// (selective_scan.kernel_chunk): a piece is a chunk, and h_ckpt is 8 x 4.2
// MB at falcon-mamba's train shape instead of 2 x 4.2 MB (+25 MB; at
// hymba's, +10 MB), alive only inside one remat block's backward. A longer
// chunk finds a later piece's entry by walking from the chunk's checkpoint,
// which is right for any chunk up to MAX_CHUNK and slower.
//
// The sums. Over the states (sb and the dt term): G in the thread, then
// log2(NG) xor shuffles for each of the two. Over the channels (db, dc):
// each thread has 2G values a step; a transpose-reduce over the warp's
// CPW channels (halving: the lane keeps half its values and adds the
// partner's other half) leaves each value's warp sum in one lane after
// 2G - 1 shuffles, then a fixed-order sum over the block's warps in shared
// memory every sub-chunk. With G = 4 and ds 16 that is 11 shuffles for 4
// state-steps, against the first design's ~40.
//
// Sizes: G 4, SUB 8, 64 channels a block. Timed against it on an H100
// (PERF.md, PR 16) and slower at every main-path shape: G 2 with 32
// channels a block (more shuffles). Before the staging the same layout
// read x, dt and gy from device memory at each step, and was slower; so
// were G 8 with 4-step sub-chunks, one block an SM without the register
// cap, and taking the adjoint's exp again instead of keeping the decays.
// Registers (ptxas, sm_90a, PERF.md): at ds 16 the two-blocks-an-SM cap
// of 128 holds hs, as, g, dA, a2 and v with 88 bytes of spill stores and
// 108 of loads a thread (L1-resident; chip_smoke.py fails the build past
// that); ds 4 and 8 run fewer threads a block and do not spill.
//
// The decay is ex2.approx.ftz(dt * A log2(e)), as in the forward (a few
// ulp a decay; see selective_scan_fwd.cu). Ragged d and a ragged last
// chunk are masked: lanes past di carry zeros through every sum.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int MAX_CHUNK = 2048;
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

// The work layout: G states a thread, SUB steps a sub-chunk, NENT
// sub-chunk entries a piece, CH channels a block (CH * ds / G threads; two
// blocks an SM, so at most 128 registers a thread at 256 threads).
template <int DS>
struct Map {
  static constexpr int G = DS < 4 ? DS : 4;
  static constexpr int SUB = 8;
  static constexpr int NENT = 8;
  static constexpr int NG = DS / G;            // threads a channel
  static constexpr int CPW = 32 / NG;          // channels a warp
  static constexpr int CH = 64;                // channels a block
  static constexpr int THREADS = CH * NG;
  static constexpr int NWARPS = THREADS / 32;
  static_assert(CH % CPW == 0, "a block is whole warps");
  static constexpr int PIECE = NENT * SUB;
  static constexpr int V = 2 * G;              // db, dc values a step
  static_assert(CPW >= V, "a warp must hold a lane for every db/dc value");
  static size_t smem_bytes() {
    return sizeof(float) * ((size_t)NENT * G * THREADS   // sub-chunk entries
                            + (size_t)PIECE * 2 * DS     // B, C of a piece
                            + (size_t)PIECE * 3 * CH     // x, dt, gy
                            + (size_t)SUB * NWARPS * 2 * DS);  // warp sums
  }
};

// The sum of v over the NG lanes of a channel (neighbouring lanes).
template <int NG>
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int m = 1; m < NG; m *= 2) v += __shfl_xor_sync(0xffffffffu, v, m);
  return v;
}

// Transpose-reduce over the warp's channels (lanes that differ in the bits
// above log2(NG)): on return v[0] holds the warp's sum of value `idx`,
// which the lane's channel bits pick. V - 1 shuffles, then a butterfly over
// the channel bits left, so lanes that differ only there hold the same sum.
template <int V, int NG, int CPW>
__device__ __forceinline__ int transpose_reduce(float (&v)[V], int lane) {
  int idx = 0;
  int m = NG * CPW / 2;
#pragma unroll
  for (int n = V; n > 1; n /= 2, m /= 2) {
    const bool up = (lane & m) != 0;
#pragma unroll
    for (int i = 0; i < n / 2; ++i) {
      const float send = up ? v[i] : v[i + n / 2];
      const float keep = up ? v[i + n / 2] : v[i];
      v[i] = keep + __shfl_xor_sync(0xffffffffu, send, m);
    }
    if (up) idx += n / 2;
  }
#pragma unroll
  for (; m >= NG; m /= 2) v[0] += __shfl_xor_sync(0xffffffffu, v[0], m);
  return idx;
}

template <typename T, int DS>
__global__ void __launch_bounds__(Map<DS>::THREADS, 2)
scan_bwd_kernel(const T* __restrict__ x, const T* __restrict__ dt,
       const T* __restrict__ bm, const T* __restrict__ cm,
       const float* __restrict__ a_log, const float* __restrict__ h_ckpt,
       const T* __restrict__ gy, const float* __restrict__ gh,
       T* __restrict__ dx, T* __restrict__ ddt, float* __restrict__ db_part,
       float* __restrict__ dc_part, float* __restrict__ da_part,
       float* __restrict__ dh0, int S, int di, int chunk, int nc) {
  using P = Map<DS>;
  constexpr int G = P::G, SUB = P::SUB, THREADS = P::THREADS, NG = P::NG;
  constexpr int CPW = P::CPW, NWARPS = P::NWARPS, PIECE = P::PIECE;
  constexpr int V = P::V, NENT = P::NENT, CH = P::CH;
  extern __shared__ float smem[];
  float* ent = smem;                              // [NENT][G][THREADS]
  float* sbc = ent + NENT * G * THREADS;          // [PIECE][2][DS]
  float* sx = sbc + PIECE * 2 * DS;               // [PIECE][CH] x
  float* sdt = sx + PIECE * CH;                   // [PIECE][CH] dt
  float* sgy = sdt + PIECE * CH;                  // [PIECE][CH] gy
  float* red = sgy + PIECE * CH;                  // [SUB][NWARPS][2 DS]

  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const int grp = lane % NG, cw = lane / NG;
  const int s0 = grp * G;                         // this thread's states
  const int ch = warp * CPW + cw;                 // its channel in the block
  const int d0 = blockIdx.x * CH;
  const int d = d0 + ch;
  const size_t b = blockIdx.y;
  const int nd = gridDim.x;
  const bool valid = d < di;
  // the lane that stores its transpose-reduced value (one of the lanes
  // that the closing butterfly made equal)
  const bool canonical = cw % (CPW / V) == 0;

  float a2[G], g[G], dA[G];
#pragma unroll
  for (int k = 0; k < G; ++k) {
    a2[k] = valid ? -expf(a_log[(size_t)d * DS + s0 + k]) * LOG2E : 0.f;
    g[k] = valid ? gh[(b * di + d) * DS + s0 + k] : 0.f;
    dA[k] = 0.f;                                  // sum of dadt dt
  }

  for (int c = nc - 1; c >= 0; --c) {
    const int t0c = c * chunk;
    const int Lc = min(chunk, S - t0c);
    for (int p = (Lc - 1) / PIECE; p >= 0; --p) {
      const int tp = t0c + p * PIECE;
      const int Lp = min(PIECE, Lc - p * PIECE);
      __syncthreads();                  // the last piece's staging is read
      // stage the piece: B, C, and x, dt, gy of the block's channels
      for (int k = tid; k < PIECE * 2 * DS; k += THREADS) {
        const int i = k / (2 * DS), which = (k / DS) % 2, s = k % DS;
        const T* src = which ? cm : bm;
        sbc[k] = i < Lp ? to_f32(src[(b * S + tp + i) * DS + s]) : 0.f;
      }
      for (int k = tid; k < PIECE * CH; k += THREADS) {
        const int i = k / CH, dc = d0 + k % CH;
        const bool ok = i < Lp && dc < di;
        const size_t r = (b * S + tp + i) * (size_t)di + dc;
        sx[k] = ok ? to_f32(x[r]) : 0.f;
        sdt[k] = ok ? to_f32(dt[r]) : 0.f;
        sgy[k] = ok ? to_f32(gy[r]) : 0.f;
      }
      float h[G];
#pragma unroll
      for (int k = 0; k < G; ++k)
        h[k] = valid ? h_ckpt[((b * nc + c) * di + d) * DS + s0 + k] : 0.f;
      // a chunk longer than a piece: this piece's entry from the chunk's
      for (int t = t0c; t < tp; ++t) {
        const size_t r = (b * S + t) * (size_t)di + d;
        const float dv = valid ? to_f32(dt[r]) : 0.f;
        const float bx = dv * (valid ? to_f32(x[r]) : 0.f);
#pragma unroll
        for (int k = 0; k < G; ++k)
          h[k] = exp2_ftz(dv * a2[k]) * h[k]
                 + bx * to_f32(bm[(b * S + t) * DS + s0 + k]);
      }
      __syncthreads();                  // the piece is staged

      // level 1: the state entering each sub-chunk
      const int nsub = (Lp + SUB - 1) / SUB;
      for (int j = 0; j < nsub; ++j) {
#pragma unroll
        for (int k = 0; k < G; ++k) ent[(j * G + k) * THREADS + tid] = h[k];
        if (j == nsub - 1) break;       // only the last can be ragged
#pragma unroll
        for (int i = 0; i < SUB; ++i) {
          const int q = j * SUB + i;
          const float dv = sdt[q * CH + ch], bx = dv * sx[q * CH + ch];
          const float* bt = sbc + q * 2 * DS + s0;
#pragma unroll
          for (int k = 0; k < G; ++k)
            h[k] = exp2_ftz(dv * a2[k]) * h[k] + bx * bt[k];
        }
      }

      // level 2: each sub-chunk in reverse
      for (int j = nsub - 1; j >= 0; --j) {
        const int ts = tp + j * SUB;
        const int len = min(SUB, Lp - j * SUB);
        float as[SUB][G], hs[SUB + 1][G];
#pragma unroll
        for (int k = 0; k < G; ++k) hs[0][k] = ent[(j * G + k) * THREADS + tid];
#pragma unroll
        for (int i = 0; i < SUB; ++i) {
          const int q = j * SUB + i;    // zeros past the piece: a = 1
          const float dv = sdt[q * CH + ch], bx = dv * sx[q * CH + ch];
          const float* bt = sbc + q * 2 * DS + s0;
#pragma unroll
          for (int k = 0; k < G; ++k) {
            as[i][k] = exp2_ftz(dv * a2[k]);
            hs[i + 1][k] = as[i][k] * hs[i][k] + bx * bt[k];
          }
        }
        // the adjoint of step i of the sub-chunk (t = ts + i)
        auto adjoint = [&](int i) {
          const int q = j * SUB + i;
          const float* bt = sbc + q * 2 * DS + s0;
          const float* ct = bt + DS;
          const float xv = sx[q * CH + ch], dv = sdt[q * CH + ch];
          const float gyv = sgy[q * CH + ch], dtx = dv * xv;
          float sbp = 0.f, tda = 0.f, v[V];
#pragma unroll
          for (int k = 0; k < G; ++k) {
            const float lam = g[k] + gyv * ct[k];
            sbp += lam * bt[k];
            const float dadt = lam * hs[i][k] * as[i][k];
            tda += dadt * a2[k];
            dA[k] += dadt * dv;
            g[k] = as[i][k] * lam;
            v[k] = dtx * lam;
            v[G + k] = gyv * hs[i + 1][k];
          }
          // ddt's state sum: x sb + dadt . A, with A = a2 ln 2
          float ddp = xv * sbp + tda * 0.6931471805599453f;
          const float sb = group_sum<NG>(sbp);
          ddp = group_sum<NG>(ddp);
          if (valid && grp == 0) {
            const size_t r = (b * S + ts + i) * (size_t)di + d;
            store(dx + r, dv * sb);
            store(ddt + r, ddp);
          }
          const int idx = transpose_reduce<V, NG, CPW>(v, lane);
          if (canonical)
            red[(i * NWARPS + warp) * 2 * DS + (idx / G) * DS + s0 + idx % G] =
                v[0];
        };
        if (len == SUB) {       // a whole sub-chunk: no branch between steps
#pragma unroll
          for (int i = SUB - 1; i >= 0; --i) adjoint(i);
        } else {
#pragma unroll
          for (int i = SUB - 1; i >= 0; --i)
            if (i < len) adjoint(i);      // uniform across the block
        }
        __syncthreads();
        for (int k = tid; k < len * 2 * DS; k += THREADS) {
          const int i = k / (2 * DS), r = k % (2 * DS);
          float sum = 0.f;
#pragma unroll
          for (int w = 0; w < NWARPS; ++w)
            sum += red[(i * NWARPS + w) * 2 * DS + r];
          float* out = r < DS ? db_part : dc_part;
          out[((b * nd + blockIdx.x) * S + ts + i) * DS + r % DS] = sum;
        }
        __syncthreads();                  // red is written again next
      }
    }
  }
  if (valid) {
#pragma unroll
    for (int k = 0; k < G; ++k) {
      const size_t o = (b * di + d) * DS + s0 + k;
      da_part[o] = dA[k] * (a2[k] * 0.6931471805599453f);  // times A
      dh0[o] = g[k];
    }
  }
}

// the wrapper mirrors these sizes
static_assert(Map<16>::PIECE == 64, "selective_scan.PIECE");
static_assert(Map<16>::SUB == 8, "selective_scan.BWD_SUB");
static_assert(Map<4>::CH == 64 && Map<8>::CH == 64 && Map<16>::CH == 64,
              "selective_scan.BWD_CHANNELS");

template <typename T, int DS>
int launch_ds(const void* x, const void* dt, const void* bm, const void* cm,
              const float* a_log, const float* h_ckpt, const void* gy,
              const float* gh, void* dx, void* ddt, float* db_part,
              float* dc_part, float* da_part, float* dh0, int batch, int S,
              int di, int chunk, cudaStream_t st) {
  using P = Map<DS>;
  const size_t smem = P::smem_bytes();
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        scan_bwd_kernel<T, DS>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((di + P::CH - 1) / P::CH, batch);
  const int nc = (S + chunk - 1) / chunk;
  scan_bwd_kernel<T, DS><<<grid, P::THREADS, smem, st>>>(
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

int selective_scan_bwd_max_chunk() { return MAX_CHUNK; }

// dtype: 0 = float32, 1 = bfloat16 (x, dt, B, C, gy, dx and ddt); ds in
// {4, 8, 16}; chunk <= MAX_CHUNK. Every pointer is contiguous device
// memory; db_part and dc_part are [batch, nd, S, ds] with nd = ceil(di /
// 64). Launches on `stream` without
// synchronising and returns cudaGetLastError().
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

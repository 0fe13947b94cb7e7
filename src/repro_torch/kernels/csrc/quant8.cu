// Per-row symmetric int-k quant-dequant for Hopper (sm_90a), f32 or bf16.
//
// Replaces the TPU kernel repro/kernels/quant8.py: quant_dequant_fwd
// (Pallas bodies `_kernel`, `_kernel_sr_threaded`, `_kernel_sr_tpu`). Same
// function, per row of x [rows, d]:
//
//   scale = max(max|x| * (1 / qmax), 1e-12)   (f32 reciprocal, as XLA
//                                              computes it under jit)
//   q = clip(round(x / scale), -qmax, qmax)          (mode 0: nearest even)
//   q = clip(floor(x / scale + u), -qmax, qmax)      (stochastic rounding)
//   y = q * scale, in x's dtype
//
// with the uniforms u either streamed in (mode 1, as `_kernel_sr_threaded`
// takes them; fed the same u it gives the plain version's bits) or drawn
// in the kernel (mode 2) from a counter-based Philox4x32-10 keyed by a
// 64-bit seed that the wrapper draws from its torch.Generator into device
// memory, in the place of the TPU's hardware PRNG (`pltpu.prng_seed`).
// Mode 2 gives other bits than any host generator: it is held to the
// plain version for range and unbiasedness only.
//
// What bounds it on an H100: one read of x (and of u in mode 1) and one
// write of y, ~0.15 flop a byte: bound by bytes (3.35 TB/s).
//
// What this design does about it: one 256-thread block per row. A row of
// at most 4096 elements is held in registers (16 a thread) between the max
// reduction and the quantisation, so x is read from device memory once. A
// wider row (nemotron-4-15b's 6144, command-r-plus-104b's 12288) is read
// twice: once for the max, once to quantise; the second read finds the row
// (24-48 KB) in L1 or L2, so device memory still sees it about once. The
// max does not depend on the order it is taken in and every element's
// arithmetic is the same in both routes, so both give the plain version's
// bits. Divisions are IEEE (no fast math), as the plain version's. Vector
// loads are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int PER_THREAD = 16;
constexpr int MAX_D = THREADS * PER_THREAD;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// Philox4x32-10 (Salmon et al., SC'11): counter (c0..c3), key (k0, k1).
__device__ __forceinline__ uint4 philox(uint4 c, uint32_t k0, uint32_t k1) {
#pragma unroll
  for (int i = 0; i < 10; ++i) {
    const uint32_t hi0 = __umulhi(0xD2511F53u, c.x), lo0 = 0xD2511F53u * c.x;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c.z), lo1 = 0xCD9E8D57u * c.z;
    c = make_uint4(hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0);
    k0 += 0x9E3779B9u;
    k1 += 0xBB67AE85u;
  }
  return c;
}

// WIDE: d > MAX_D, the row read twice; otherwise held in registers.
template <typename T, bool WIDE>
__global__ void __launch_bounds__(THREADS)
kernel(const T* __restrict__ x, const float* __restrict__ u,
       const unsigned long long* __restrict__ seed, T* __restrict__ y,
       int d, float qmax, int mode) {
  __shared__ float red[THREADS / 32];
  const int tid = threadIdx.x;
  const size_t row = blockIdx.x;
  const T* xr = x + row * d;

  float v[WIDE ? 1 : PER_THREAD];
  float amax = 0.f;
  if (WIDE) {
    for (int c = tid; c < d; c += THREADS)
      amax = fmaxf(amax, fabsf(to_f32(xr[c])));
  } else {
#pragma unroll
    for (int i = 0; i < PER_THREAD; ++i) {
      const int c = tid + i * THREADS;
      v[i] = c < d ? to_f32(xr[c]) : 0.f;
      amax = fmaxf(amax, fabsf(v[i]));
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  if (tid % 32 == 0) red[tid / 32] = amax;
  __syncthreads();
  amax = red[0];
#pragma unroll
  for (int w = 1; w < THREADS / 32; ++w) amax = fmaxf(amax, red[w]);
  const float scale = fmaxf(amax * (1.0f / qmax), 1e-12f);

  uint32_t k0 = 0, k1 = 0;
  if (mode == 2) {
    const unsigned long long s = *seed;
    k0 = (uint32_t)s;
    k1 = (uint32_t)(s >> 32);
  }
  const int n = WIDE ? (d + THREADS - 1) / THREADS : PER_THREAD;
#pragma unroll
  for (int i = 0; i < n; ++i) {
    const int c = tid + i * THREADS;
    if (c >= d) continue;
    const float xv = WIDE ? to_f32(xr[c]) : v[i];
    float qv;
    if (mode == 0) {
      qv = rintf(xv / scale);              // half to even, as jnp.round
    } else {
      float uu;
      if (mode == 1) {
        uu = u[row * d + c];
      } else {
        // one Philox block per element: counter (element index, 0, 0, 0)
        const unsigned long long e = row * d + c;
        const uint4 r = philox(make_uint4((uint32_t)e, (uint32_t)(e >> 32),
                                          0u, 0u), k0, k1);
        uu = (float)(r.x >> 8) * 5.9604644775390625e-08f;   // 2^-24: [0, 1)
      }
      qv = floorf(xv / scale + uu);
    }
    qv = fminf(fmaxf(qv, -qmax), qmax);
    store(y + row * d + c, qv * scale);
  }
}

template <typename T>
void launch(const T* x, const float* u, const unsigned long long* seed, T* y,
            int rows, int d, float qmax, int mode, cudaStream_t st) {
  if (d > MAX_D)
    kernel<T, true><<<rows, THREADS, 0, st>>>(x, u, seed, y, d, qmax, mode);
  else
    kernel<T, false><<<rows, THREADS, 0, st>>>(x, u, seed, y, d, qmax, mode);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. x, y [rows, d] contiguous; mode 0:
// round to nearest; mode 1: u [rows, d] f32 uniforms in [0, 1); mode 2:
// seed points at one uint64 in device memory. Launches on `stream`
// without synchronising and returns cudaGetLastError().
int quant_dequant(int dtype, const void* x, const void* u, const void* seed,
                  void* y, int rows, int d, float qmax, int mode,
                  void* stream) {
  if (rows <= 0 || d <= 0 || mode < 0 || mode > 2 ||
      (mode == 1 && u == nullptr) || (mode == 2 && seed == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* uu = static_cast<const float*>(u);
  const unsigned long long* s = static_cast<const unsigned long long*>(seed);
  if (dtype == 0)
    launch(static_cast<const float*>(x), uu, s, static_cast<float*>(y), rows,
           d, qmax, mode, st);
  else if (dtype == 1)
    launch(static_cast<const __nv_bfloat16*>(x), uu, s,
           static_cast<__nv_bfloat16*>(y), rows, d, qmax, mode, st);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

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
//   y = q * scale, in x's dtype (bf16: rounded to nearest even)
//
// The uniforms u are streamed in (mode 1, as `_kernel_sr_threaded` takes
// them) or drawn in the kernel (mode 2), in the place of the TPU's
// hardware PRNG (`pltpu.prng_seed`), from this stream:
//
//   element (r, c) takes word c mod 4 of Philox4x32-10 (Salmon et al.,
//   SC'11) at counter (g_lo, g_hi, 0, 0), g = (row0 + r) * ceil(d / 4) +
//   c / 4,
//   under the key (seed_lo, seed_hi), the two 32-bit words of a 64-bit
//   seed that the wrapper draws from its torch.Generator into device
//   memory; u = (word >> 8) * 2^-24, in [0, 1).
//
// row0 is the global index of x's first row: a data rank that quantises
// its own clients' rows of a stacked tensor passes their offset, and draws
// the bits the whole tensor's call draws for them. One draw serves four
// neighbouring elements of a row and no draw straddles two rows, so both routes below give the same bits at any d, and so does
// the wrapper's plain version (`quant8.philox_uniforms`, torch integer
// ops). In every mode the kernel gives the plain version's bits: the same
// f32 operations in the same order, IEEE divisions (no fast math).
//
// What bounds it on an H100: one read of x (and of u in mode 1) and one
// write of y, ~0.15 flop a byte: bytes, at 3.35 TB/s. A whole Philox
// block (10 rounds of four 32-bit multiplies) for each element would cost
// ~40 integer multiplies an element and hold mode 2 under half the bytes'
// rate, bf16 (half the bytes) no faster than f32; one draw for four
// elements costs ~10. What is left beside the bytes is the IEEE division
// and the draws, ~35 instructions an element: near the bytes' time in
// bf16, where mode 2 is held by the draws' multiplies (PERF.md).
//
// What this design does about it:
// - A chunk is K neighbouring elements read and written together. Vector
//   route: one 16-byte access (K = 4 f32 or 8 bf16), one draw for each 4
//   elements. Scalar route (d not a whole number of vectors, or a pointer
//   off 16-byte alignment; the wrapper picks it from the shape and the
//   pointers): K = 4 elements, one access each, masked at the row's end,
//   one draw a chunk.
// - The block is sized to the row: a thread holds CPT = 4 chunks in
//   registers, so a row of nch chunks takes W = ceil(nch / 4) threads, at
//   stride W (a warp's accesses are neighbours). f32 1600, 2048, 3072 and
//   4096 take 100, 128, 192 and 256 threads, bf16 3072 96: every one holds
//   4 whole chunks. The block is W rounded up to a whole warp (threads past
//   W hold nothing: a warp shuffle needs its 32 lanes), one row a block.
//   x is read from device memory once. The max is a warp shuffle, then the
//   warps' maxima through shared memory.
// - A short row (W <= 32: d < 256 f32, < 1024 bf16) shares a 128-thread
//   block with others: W is rounded up to a power of two, so the rows of a
//   warp reduce apart by shuffles alone, and a block's rows past `rows`
//   load nothing and store nothing.
// - A row wider than 512 threads hold (W > 512: f32 past 8192, bf16 past
//   16384) is read twice, in 512-thread blocks: once for the max, once to
//   quantise; the second read finds the row (32 KB or more) in L2.
// - Dtype, mode and route are template arguments, so a kernel carries only
//   its own arithmetic.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace quant8 {

constexpr int MAX_THREADS = 512;   // threads of a block
constexpr int CPT = 4;             // chunks a thread holds in registers
constexpr int SHORT_BLOCK = 128;   // threads of a block of short rows

// Philox4x32-10: counter (c0..c3), key (k0, k1).
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

__device__ __forceinline__ float uniform(uint32_t word) {
  return (float)(word >> 8) * 5.9604644775390625e-08f;   // 2^-24: [0, 1)
}

__device__ __forceinline__ uint32_t bits(float v) {
  return __float_as_uint(v);
}
__device__ __forceinline__ uint32_t bits(__nv_bfloat16 v) {
  return __bfloat16_as_ushort(v);
}

// A chunk of a row in registers, as 32-bit words: the 16 bytes (vector
// route) or element i's bits in w[i] (scalar route).
template <typename T, bool VEC>
struct Chunk {
  static constexpr int K = VEC ? 16 / (int)sizeof(T) : 4;
  uint32_t w[4];

  // p: the chunk's first element; n: the elements left in the row
  __device__ __forceinline__ void load(const T* p, int n) {
    if constexpr (VEC) {
      const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
      w[0] = v.x, w[1] = v.y, w[2] = v.z, w[3] = v.w;
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) w[i] = i < n ? bits(p[i]) : 0u;
    }
  }
  __device__ __forceinline__ void clear() {
#pragma unroll
    for (int i = 0; i < 4; ++i) w[i] = 0u;
  }
  // element i as f32 (bf16 is the top half of an f32)
  __device__ __forceinline__ float at(int i) const {
    if constexpr (sizeof(T) == 4) return __uint_as_float(w[i]);
    else if constexpr (VEC)
      return __uint_as_float(i % 2 ? w[i / 2] & 0xFFFF0000u : w[i / 2] << 16);
    else return __uint_as_float(w[i] << 16);
  }
  __device__ __forceinline__ float absmax() const {
    float m = 0.f;
#pragma unroll
    for (int i = 0; i < K; ++i) m = fmaxf(m, fabsf(at(i)));
    return m;
  }
};

template <typename T, bool VEC>
__device__ __forceinline__ void store(T* p, const float* q, int n) {
  if constexpr (VEC && sizeof(T) == 4) {
    *reinterpret_cast<uint4*>(p) =
        make_uint4(bits(q[0]), bits(q[1]), bits(q[2]), bits(q[3]));
  } else if constexpr (VEC) {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(q[2 * i], q[2 * i + 1]);
      w[i] = bits(h.x) | bits(h.y) << 16;
    }
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (i < n) {
        if constexpr (sizeof(T) == 4) p[i] = q[i];
        else p[i] = __float2bfloat16_rn(q[i]);
      }
  }
}

// Quantise one chunk and store it. e: the chunk's first element's index in
// x; n: the elements left in its row; g: its first Philox counter.
template <typename T, int MODE, bool VEC>
__device__ __forceinline__ void quantise(const Chunk<T, VEC>& c, T* y,
                                         const float* u, size_t e, int n,
                                         unsigned long long g, float scale,
                                         float qmax, uint32_t k0,
                                         uint32_t k1) {
  constexpr int K = Chunk<T, VEC>::K;
  float uu[K];
  if constexpr (MODE == 1 && VEC) {
#pragma unroll
    for (int i = 0; i < K; i += 4) {
      const float4 v = __ldg(reinterpret_cast<const float4*>(u + e + i));
      uu[i] = v.x, uu[i + 1] = v.y, uu[i + 2] = v.z, uu[i + 3] = v.w;
    }
  } else if constexpr (MODE == 1) {
#pragma unroll
    for (int i = 0; i < K; ++i) uu[i] = i < n ? __ldg(u + e + i) : 0.f;
  } else if constexpr (MODE == 2) {
#pragma unroll
    for (int i = 0; i < K; i += 4) {
      const unsigned long long gi = g + i / 4;
      const uint4 r = philox(make_uint4((uint32_t)gi, (uint32_t)(gi >> 32),
                                        0u, 0u), k0, k1);
      uu[i] = uniform(r.x), uu[i + 1] = uniform(r.y);
      uu[i + 2] = uniform(r.z), uu[i + 3] = uniform(r.w);
    }
  }
  float q[K];
#pragma unroll
  for (int i = 0; i < K; ++i) {
    float v;
    if constexpr (MODE == 0) v = rintf(c.at(i) / scale);   // half to even
    else v = floorf(c.at(i) / scale + uu[i]);
    q[i] = fminf(fmaxf(v, -qmax), qmax) * scale;
  }
  store<T, VEC>(y + e, q, n);
}

// The max of m over the `group` threads of each row: shuffles within a
// warp (group a power of two up to 32, or a whole number of warps), then,
// for a row of several warps (one row a block), the warps' maxima.
__device__ __forceinline__ float row_max(float m, int group, float* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    if (off < group) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
  if (group <= 32) return m;
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = m;
  __syncthreads();
  m = red[0];
  for (int w = 1; w < group / 32; ++w) m = fmaxf(m, red[w]);
  return m;
}

// WIDE: the row read twice (max, then quantise); otherwise held in
// registers, CPT chunks a thread at stride W.
template <typename T, int MODE, bool VEC, bool WIDE>
__global__ void __launch_bounds__(MAX_THREADS)
kernel(const T* __restrict__ x, const float* __restrict__ u,
       const unsigned long long* __restrict__ seed, T* __restrict__ y,
       int rows, int d, int group, float qmax, long long row0) {
  using C = Chunk<T, VEC>;
  constexpr int K = C::K;
  __shared__ float red[MAX_THREADS / 32];
  const int nch = (d + K - 1) / K;
  const int t = threadIdx.x % group;        // the thread's place in its row
  const long long row =
      (long long)blockIdx.x * (blockDim.x / group) + threadIdx.x / group;
  const bool live = row < rows;
  const size_t base = (size_t)row * d;
  const int stride = WIDE ? group : (nch + CPT - 1) / CPT;

  C v[WIDE ? 1 : CPT];
  float amax = 0.f;
  if constexpr (WIDE) {
    if (live) {
#pragma unroll 4
      for (int j = t; j < nch; j += stride) {
        v[0].load(x + base + (size_t)j * K, d - j * K);
        amax = fmaxf(amax, v[0].absmax());
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < CPT; ++i) {
      const int j = t + i * stride;
      if (live && t < stride && j < nch)
        v[i].load(x + base + (size_t)j * K, d - j * K);
      else
        v[i].clear();
      amax = fmaxf(amax, v[i].absmax());
    }
  }
  amax = row_max(amax, group, red);
  const float scale = fmaxf(amax * (1.0f / qmax), 1e-12f);
  if (!live) return;                              // after the block's sync

  uint32_t k0 = 0, k1 = 0;
  if constexpr (MODE == 2) {
    const unsigned long long s = *seed;
    k0 = (uint32_t)s;
    k1 = (uint32_t)(s >> 32);
  }
  const unsigned long long g0 =
      (unsigned long long)(row0 + row) * ((d + 3) / 4);
  if constexpr (WIDE) {
#pragma unroll 4
    for (int j = t; j < nch; j += stride) {
      const size_t e = base + (size_t)j * K;
      v[0].load(x + e, d - j * K);
      quantise<T, MODE, VEC>(v[0], y, u, e, d - j * K, g0 + j * (K / 4),
                             scale, qmax, k0, k1);
    }
  } else {
#pragma unroll
    for (int i = 0; i < CPT; ++i) {
      const int j = t + i * stride;
      if (t < stride && j < nch)
        quantise<T, MODE, VEC>(v[i], y, u, base + (size_t)j * K, d - j * K,
                               g0 + j * (K / 4), scale, qmax, k0, k1);
    }
  }
}

template <typename T, int MODE, bool VEC>
void launch(const T* x, const float* u, const unsigned long long* seed, T* y,
            int rows, int d, float qmax, long long row0, cudaStream_t st) {
  constexpr int K = Chunk<T, VEC>::K;
  const int w = ((d + K - 1) / K + CPT - 1) / CPT;   // threads a row holds
  if (w > MAX_THREADS) {
    kernel<T, MODE, VEC, true><<<rows, MAX_THREADS, 0, st>>>(
        x, u, seed, y, rows, d, MAX_THREADS, qmax, row0);
  } else if (w > 32) {
    const int group = (w + 31) / 32 * 32;
    kernel<T, MODE, VEC, false><<<rows, group, 0, st>>>(
        x, u, seed, y, rows, d, group, qmax, row0);
  } else {
    int group = 1;
    while (group < w) group *= 2;
    const int per_block = SHORT_BLOCK / group;
    kernel<T, MODE, VEC, false>
        <<<(rows + per_block - 1) / per_block, SHORT_BLOCK, 0, st>>>(
            x, u, seed, y, rows, d, group, qmax, row0);
  }
}

template <typename T>
int dispatch(const T* x, const float* u, const unsigned long long* seed,
             T* y, int rows, int d, float qmax, int mode, bool vec,
             long long row0, cudaStream_t st) {
  if (vec) {
    const bool aligned = d % (16 / (int)sizeof(T)) == 0 &&
                         (uintptr_t)x % 16 == 0 && (uintptr_t)y % 16 == 0 &&
                         (mode != 1 || (uintptr_t)u % 16 == 0);
    if (!aligned) return (int)cudaErrorInvalidValue;
  }
  switch (mode * 2 + vec) {
    case 0: launch<T, 0, false>(x, u, seed, y, rows, d, qmax, row0, st); break;
    case 1: launch<T, 0, true>(x, u, seed, y, rows, d, qmax, row0, st); break;
    case 2: launch<T, 1, false>(x, u, seed, y, rows, d, qmax, row0, st); break;
    case 3: launch<T, 1, true>(x, u, seed, y, rows, d, qmax, row0, st); break;
    case 4: launch<T, 2, false>(x, u, seed, y, rows, d, qmax, row0, st); break;
    default: launch<T, 2, true>(x, u, seed, y, rows, d, qmax, row0, st); break;
  }
  return (int)cudaGetLastError();
}

}  // namespace quant8

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. x, y [rows, d] contiguous; mode 0:
// round to nearest; mode 1: u [rows, d] f32 uniforms in [0, 1); mode 2:
// seed points at one uint64 in device memory. vec: 1 for the vector route
// (d a whole number of 16-byte vectors, x, y and u 16-byte aligned; the
// call is refused otherwise), 0 for the scalar route. row0 >= 0: the global
// index of x's first row in the Philox counter (mode 2). Launches on
// `stream` without synchronising and returns cudaGetLastError().
int quant_dequant(int dtype, const void* x, const void* u, const void* seed,
                  void* y, int rows, int d, float qmax, int mode, int vec,
                  long long row0, void* stream) {
  if (rows <= 0 || d <= 0 || mode < 0 || mode > 2 || row0 < 0 ||
      (mode == 1 && u == nullptr) || (mode == 2 && seed == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* uu = static_cast<const float*>(u);
  const unsigned long long* s = static_cast<const unsigned long long*>(seed);
  if (dtype == 0)
    return quant8::dispatch(static_cast<const float*>(x), uu, s,
                            static_cast<float*>(y), rows, d, qmax, mode,
                            vec != 0, row0, st);
  if (dtype == 1)
    return quant8::dispatch(static_cast<const __nv_bfloat16*>(x), uu, s,
                            static_cast<__nv_bfloat16*>(y), rows, d, qmax,
                            mode, vec != 0, row0, st);
  return (int)cudaErrorInvalidValue;
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

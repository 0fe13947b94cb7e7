// Fused LM-head cross-entropy for Hopper (sm_90a), forward and backward;
// h and w in f32 or bf16, every sum in f32.
//
// Replaces the TPU kernels repro/kernels/softmax_xent.py:
// softmax_xent_fwd (Pallas body `_fwd_kernel`) and softmax_xent_bwd
// (`_bwd_dh_kernel`, `_bwd_dw_kernel`). Same function: for h [T,D],
// w [D,V] and labels [T],
//
//   logits = h . w   lse = logsumexp(logits)   loss = lse - logits[label]
//   ds = g * (softmax(logits) - onehot(label))
//   dh = ds . w^T    dw = h^T . ds
//
// without ever holding [T, V] logits in device memory.
//
// What bounds it on an H100: at the train shapes (T=4088, D=3072,
// V=256000) the forward is 2*T*D*V = 6.4 TFLOP and the backward three
// such products (logits again, dh, dw) = 19.3 TFLOP, against ~3 GB of
// I/O: bound by operations (67 TFLOP/s f32 outside the tensor cores).
//
// What this first design does about it: every product runs through one
// tiled f32 GEMM (128 x 128 output tile per 256-thread block, two blocks
// per SM, 8 x 8 outputs per thread in registers, K in steps of 8 through
// a double-buffered shared-memory stage) with the TPU kernel's per-tile
// work fused into its epilogue.
//  * forward: the TPU kernel walks the 63 vocab tiles of a token block in
//    order, carrying (max, normaliser, gold) in scratch. Here the vocab is
//    split across blocks instead (one block per 128-token x 128-column
//    tile, 64000 blocks at the train shapes, where one block per token
//    tile would give only 32 for 132 SMs): each block writes the partial
//    (max, normaliser, gold) of its 128 columns, and a merge kernel folds
//    the 2000 partials of each token into lse and loss. The partials are
//    [V/128, T], 1/128 of the logits.
//  * backward: the TPU's dw kernel keeps a [D, block_v] accumulator in
//    VMEM (768 KB at D=3072, far over the 227 KB of shared memory). Here
//    the vocab is walked in slabs of 4096 columns: ds of one slab is
//    rebuilt from (h, w, lse) into a [T, 4096] f32 scratch by the GEMM's
//    ds epilogue, then dh += ds . w_slab^T and dw_slab = h^T . ds are two
//    more GEMMs. The scratch (67 MB at the train shapes) is the only
//    intermediate. The wrapper allocates it and the f32 dh accumulator.
// Ragged T and V are masked by bounds: columns >= V and rows >= T are
// never read or written. wgmma/TMA (after rounding h and w to bf16 or
// TF32, which would change the numbers) is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BM = 128, BN = 128, BKK = 8;   // GEMM tile
constexpr int THREADS = 256;                 // 16 x 16 threads, 8 x 8 each
constexpr int SLAB = 4096;                   // vocab columns per bwd slab
constexpr float NEG_INF = (float)(-0.7 * 3.4028234663852886e38);

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void st(float* p, float x) { *p = x; }
__device__ __forceinline__ void st(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

enum Epi { EPI_STATS = 0, EPI_DS = 1, EPI_STORE = 2 };

struct EpiArgs {
  // EPI_STATS: partial (max, normaliser, gold) of block column tile
  // blockIdx.x, written at [blockIdx.x * M + row].
  float* part_m;
  float* part_l;
  float* part_g;
  // EPI_STATS and EPI_DS: labels [M], global column offset of the GEMM's
  // column 0 and the vocab size (columns >= V do not exist).
  const int* labels;
  int col0;
  int V;
  // EPI_DS: lse and g [M].
  const float* lse;
  const float* g;
  // EPI_DS and EPI_STORE: output C[row * ldc + col]; EPI_STORE adds to C
  // when accumulate is set.
  void* C;
  int ldc;
  int accumulate;
};

// C[M,N] = A[M,K] . B[K,N] with element (m,k) of A at A[m*lda + k] when
// A_KCONTIG else A[k*lda + m], and (k,n) of B at B[n*ldb + k] when
// B_KCONTIG else B[k*ldb + n]. TC is the output type of EPI_STORE.
// Two blocks per SM: ptxas then holds each thread to 128 registers and
// spills a few bytes, and the GEMMs run faster than at one block of up to
// 159 registers (PERF.md).
template <typename TA, typename TB, typename TC, bool A_KCONTIG,
          bool B_KCONTIG, int EPI>
__global__ void __launch_bounds__(THREADS, 2)
gemm_kernel(const TA* __restrict__ A, int lda, const TB* __restrict__ B,
            int ldb, int M, int N, int K, EpiArgs ep) {
  // float4 reads need 16-byte alignment (row strides are 528 bytes)
  __shared__ __align__(16) float As[2][BKK][BM + 4];
  __shared__ __align__(16) float Bs[2][BKK][BN + 4];

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;

  // each thread stages 4 elements of A's tile and 4 of B's per K step;
  // neighbouring threads take neighbouring addresses
  float ra[4], rb[4];
  auto load_a = [&](int k0) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int idx = tid + e * THREADS;
      int mm, kk;
      if (A_KCONTIG) { kk = idx % BKK; mm = idx / BKK; }
      else { mm = idx % BM; kk = idx / BM; }
      const int m = m0 + mm, k = k0 + kk;
      float x = 0.f;
      if (m < M && k < K)
        x = ld(A_KCONTIG ? A + (size_t)m * lda + k : A + (size_t)k * lda + m);
      ra[e] = x;
    }
  };
  auto load_b = [&](int k0) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int idx = tid + e * THREADS;
      int nn, kk;
      if (B_KCONTIG) { kk = idx % BKK; nn = idx / BKK; }
      else { nn = idx % BN; kk = idx / BN; }
      const int n = n0 + nn, k = k0 + kk;
      float x = 0.f;
      if (n < N && k < K)
        x = ld(B_KCONTIG ? B + (size_t)n * ldb + k : B + (size_t)k * ldb + n);
      rb[e] = x;
    }
  };
  auto store_tiles = [&](int buf) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int idx = tid + e * THREADS;
      if (A_KCONTIG) As[buf][idx % BKK][idx / BKK] = ra[e];
      else As[buf][idx / BM][idx % BM] = ra[e];
      if (B_KCONTIG) Bs[buf][idx % BKK][idx / BKK] = rb[e];
      else Bs[buf][idx / BN][idx % BN] = rb[e];
    }
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  load_a(0);
  load_b(0);
  store_tiles(0);
  __syncthreads();
  int buf = 0;
  for (int k0 = 0; k0 < K; k0 += BKK) {
    const bool more = k0 + BKK < K;
    if (more) {            // the next stage's loads overlap this stage's FMAs
      load_a(k0 + BKK);
      load_b(k0 + BKK);
    }
#pragma unroll
    for (int kk = 0; kk < BKK; ++kk) {
      // rows ty*4 + {0..3} and 64 + ty*4 + {0..3}; columns likewise by tx
      const float4 a0 = *reinterpret_cast<const float4*>(&As[buf][kk][ty * 4]);
      const float4 a1 =
          *reinterpret_cast<const float4*>(&As[buf][kk][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[buf][kk][tx * 4]);
      const float4 b1 =
          *reinterpret_cast<const float4*>(&Bs[buf][kk][64 + tx * 4]);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    if (more) {
      store_tiles(buf ^ 1);
      __syncthreads();
      buf ^= 1;
    }
  }

  int rows[8], cols[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    rows[i] = m0 + (i / 4) * 64 + ty * 4 + i % 4;
    cols[i] = n0 + (i / 4) * 64 + tx * 4 + i % 4;
  }

  if (EPI == EPI_STATS) {
    // per row: max, sum of exp and gold over this block's valid columns;
    // a row's 128 columns lie with the 16 lanes of one half-warp (same ty)
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = rows[i];
      const int lab = r < M ? ep.labels[r] : -1;
      float mx = NEG_INF, gold = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = ep.col0 + cols[j];
        if (cols[j] < N && c < ep.V) {
          mx = fmaxf(mx, acc[i][j]);
          if (c == lab) gold += acc[i][j];
        }
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) {
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
        gold += __shfl_xor_sync(0xffffffffu, gold, off);
      }
      float l = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = ep.col0 + cols[j];
        if (cols[j] < N && c < ep.V) l += expf(acc[i][j] - mx);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        l += __shfl_xor_sync(0xffffffffu, l, off);
      if (tx == 0 && r < M) {
        const size_t o = (size_t)blockIdx.x * M + r;
        ep.part_m[o] = mx;
        ep.part_l[o] = l;
        ep.part_g[o] = gold;
      }
    }
  } else if (EPI == EPI_DS) {
    float* C = static_cast<float*>(ep.C);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = rows[i];
      if (r >= M) continue;
      const float lse = ep.lse[r], g = ep.g[r];
      const int lab = ep.labels[r];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (cols[j] >= N) continue;
        const int c = ep.col0 + cols[j];
        const float p = expf(acc[i][j] - lse);
        C[(size_t)r * ep.ldc + cols[j]] = (p - (c == lab ? 1.f : 0.f)) * g;
      }
    }
  } else {
    TC* C = static_cast<TC*>(ep.C);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = rows[i];
      if (r >= M) continue;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (cols[j] >= N) continue;
        TC* p = C + (size_t)r * ep.ldc + cols[j];
        st(p, ep.accumulate ? ld(p) + acc[i][j] : acc[i][j]);
      }
    }
  }
}

// lse and loss of each token from its partials over the vocab tiles.
__global__ void merge_kernel(const float* __restrict__ part_m,
                             const float* __restrict__ part_l,
                             const float* __restrict__ part_g, int T,
                             int ntiles, float* __restrict__ loss,
                             float* __restrict__ lse) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= T) return;
  float m = NEG_INF;
  for (int i = 0; i < ntiles; ++i) m = fmaxf(m, part_m[(size_t)i * T + t]);
  float l = 0.f, gold = 0.f;
  for (int i = 0; i < ntiles; ++i) {
    const size_t o = (size_t)i * T + t;
    l += part_l[o] * expf(part_m[o] - m);
    gold += part_g[o];
  }
  const float s = m + logf(fmaxf(l, 1e-30f));
  lse[t] = s;
  loss[t] = s - gold;
}

template <typename TA, typename TB, typename TC, bool AK, bool BK, int EPI>
cudaError_t gemm(const TA* A, int lda, const TB* B, int ldb, int M, int N,
                 int K, const EpiArgs& ep, cudaStream_t stream) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  gemm_kernel<TA, TB, TC, AK, BK, EPI>
      <<<grid, THREADS, 0, stream>>>(A, lda, B, ldb, M, N, K, ep);
  return cudaGetLastError();
}

template <typename T>
cudaError_t fwd(const T* h, const T* w, const int* labels, float* part,
                float* loss, float* lse, int Tn, int D, int V,
                cudaStream_t stream) {
  const int ntiles = (V + BN - 1) / BN;
  EpiArgs ep{};
  ep.part_m = part;
  ep.part_l = part + (size_t)ntiles * Tn;
  ep.part_g = part + 2 * (size_t)ntiles * Tn;
  ep.labels = labels;
  ep.col0 = 0;
  ep.V = V;
  // logits tile (t, v) = sum_d h[t, d] w[d, v]
  cudaError_t err = gemm<T, T, float, true, false, EPI_STATS>(
      h, D, w, V, Tn, V, D, ep, stream);
  if (err != cudaSuccess) return err;
  merge_kernel<<<(Tn + 255) / 256, 256, 0, stream>>>(
      ep.part_m, ep.part_l, ep.part_g, Tn, ntiles, loss, lse);
  return cudaGetLastError();
}

template <typename T>
cudaError_t bwd(const T* h, const T* w, const int* labels, const float* lse,
                const float* g, float* ds, float* dh_acc, T* dw, int Tn,
                int D, int V, cudaStream_t stream) {
  for (int v0 = 0; v0 < V; v0 += SLAB) {
    const int n = V - v0 < SLAB ? V - v0 : SLAB;
    EpiArgs ep{};
    ep.labels = labels;
    ep.col0 = v0;
    ep.V = V;
    ep.lse = lse;
    ep.g = g;
    ep.C = ds;
    ep.ldc = n;
    // ds[t, c] for the slab's columns, rebuilt from h . w_slab and lse
    cudaError_t err = gemm<T, T, float, true, false, EPI_DS>(
        h, D, w + v0, V, Tn, n, D, ep, stream);
    if (err != cudaSuccess) return err;
    // dh[t, d] (+)= sum_c ds[t, c] w[d, v0 + c]
    EpiArgs eh{};
    eh.C = dh_acc;
    eh.ldc = D;
    eh.accumulate = v0 > 0;
    err = gemm<float, T, float, true, true, EPI_STORE>(ds, n, w + v0, V, Tn,
                                                       D, n, eh, stream);
    if (err != cudaSuccess) return err;
    // dw[d, v0 + c] = sum_t h[t, d] ds[t, c]
    EpiArgs ew{};
    ew.C = dw + v0;
    ew.ldc = V;
    err = gemm<T, float, T, false, false, EPI_STORE>(h, D, ds, n, D, n, Tn,
                                                     ew, stream);
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace

extern "C" {

// Sizes of the scratch buffers the wrapper allocates (f32 elements).
int softmax_xent_fwd_scratch(int T, int V) {
  (void)T;
  return 3 * ((V + BN - 1) / BN);   // times T
}
int softmax_xent_bwd_slab() { return SLAB; }

// dtype: 0 = float32, 1 = bfloat16 (h and w). Contiguous h [T,D],
// w [D,V], labels [T] int32 in [0, V); part: f32 scratch of
// softmax_xent_fwd_scratch(T, V) * T elements; loss and lse [T] f32.
int softmax_xent_fwd(int dtype, const void* h, const void* w,
                     const void* labels, void* part, void* loss, void* lse,
                     int T, int D, int V, void* stream) {
  if (T <= 0 || D <= 0 || V <= 0 || (T + BM - 1) / BM > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* lab = static_cast<const int*>(labels);
  float* p = static_cast<float*>(part);
  if (dtype == 0)
    return (int)fwd<float>(static_cast<const float*>(h),
                           static_cast<const float*>(w), lab, p,
                           static_cast<float*>(loss),
                           static_cast<float*>(lse), T, D, V, st);
  if (dtype == 1)
    return (int)fwd<__nv_bfloat16>(static_cast<const __nv_bfloat16*>(h),
                                   static_cast<const __nv_bfloat16*>(w), lab,
                                   p, static_cast<float*>(loss),
                                   static_cast<float*>(lse), T, D, V, st);
  return (int)cudaErrorInvalidValue;
}

// + lse and g [T] f32; ds: f32 scratch [T, softmax_xent_bwd_slab()];
// dh_acc: f32 [T, D] (overwritten, then accumulated); dw [D, V] in w's
// dtype (overwritten).
int softmax_xent_bwd(int dtype, const void* h, const void* w,
                     const void* labels, const void* lse, const void* g,
                     void* ds, void* dh_acc, void* dw, int T, int D, int V,
                     void* stream) {
  if (T <= 0 || D <= 0 || V <= 0 || (T + BM - 1) / BM > 65535 ||
      (D + BM - 1) / BM > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* lab = static_cast<const int*>(labels);
  const float* l = static_cast<const float*>(lse);
  const float* gg = static_cast<const float*>(g);
  float* s = static_cast<float*>(ds);
  float* acc = static_cast<float*>(dh_acc);
  if (dtype == 0)
    return (int)bwd<float>(static_cast<const float*>(h),
                           static_cast<const float*>(w), lab, l, gg, s, acc,
                           static_cast<float*>(dw), T, D, V, st);
  if (dtype == 1)
    return (int)bwd<__nv_bfloat16>(
        static_cast<const __nv_bfloat16*>(h),
        static_cast<const __nv_bfloat16*>(w), lab, l, gg, s, acc,
        static_cast<__nv_bfloat16*>(dw), T, D, V, st);
  return (int)cudaErrorInvalidValue;
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

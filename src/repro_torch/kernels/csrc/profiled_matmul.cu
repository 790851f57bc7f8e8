// Hopper (sm_90a) kernel for the profiled matmul: C = A @ B with an fp32
// accumulator, plus one in-band profile word per (bm, bn) output tile, the
// tile's max |acc| taken from the fp32 accumulator before the cast to the
// output type -- the paper's Listing 1 inside a GEMM.
//
// Replaces the Pallas TPU kernel `_matmul_kernel` of
// src/repro/kernels/profiled_matmul.py (called through `profiled_matmul`).
//
// What bounds it: at M = N = K = 4096 the product does 2*4096^3 = 1.37e11
// FLOP on 100 MB of bf16 operands, far above the card's ~295 FLOP/byte
// ridge, so it is bound by operations, not bytes.  This first version is a
// plain shared-memory tiled GEMM on the fp32 FMA units (no tensor cores, no
// TMA): right first, fast in a later change (wgmma + TMA).
//
// Design.  Each block of 256 threads computes a 128x128 output tile, walking
// K in steps of 8 through shared memory; each thread keeps an 8x8 register
// tile and reads its operands from shared memory as float4.  bf16 inputs are
// widened to fp32 on their way into shared memory and accumulated in fp32,
// as the Pallas body does.  The Pallas grid runs in order on one core and
// carries the accumulator across the K walk; here the K walk is a loop
// inside each block, and the blocks run in parallel in no order.
//
// The Pallas block_m / block_n fix only the profile's granularity: a
// profile tile may span several CUDA blocks, or several profile tiles may
// cut through one block.  Each block reduces |acc| per profile tile (one
// block-wide reduction when the whole block lies in one tile, else per
// thread and tile) and folds the result into the zero-initialised profile
// with atomicMax on the int bits of the non-negative float: an order-free
// max, so the profile is deterministic.  NaN propagates as in jnp.max: |NaN|
// has the largest int bits of all.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int BM = 128, BN = 128, BK = 8;   // block tile
constexpr int TM = 8, TN = 8;               // per-thread register tile
constexpr int THREADS = (BM / TM) * (BN / TN);
static_assert(THREADS == 256, "one 8x8 register tile per thread");
static_assert((BM * BK) % THREADS == 0 && (BK * BN) % THREADS == 0,
              "tile loads split evenly over the threads");

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);  // round to nearest even, as torch's cast
}

// max that propagates NaN, as jnp.max and torch.amax do
__device__ __forceinline__ float nan_max(float a, float b) {
  return (b > a || b != b) ? b : a;
}

// fold a non-negative value (or a NaN with its sign cleared) into the
// profile: for such floats the int order is the float order
__device__ __forceinline__ void fold(float* prof, int idx, float v) {
  atomicMax(reinterpret_cast<int*>(prof) + idx, __float_as_int(v));
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
profiled_matmul_kernel(const T* __restrict__ A, const T* __restrict__ B,
                       T* __restrict__ C, float* __restrict__ prof,
                       int M, int N, int K, int bm, int bn) {
  __shared__ __align__(16) float As[BK][BM + 4];  // A tile, transposed
  __shared__ __align__(16) float Bs[BK][BN + 4];
  __shared__ float warp_max[THREADS / 32];

  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN);
  const int ty = tid / (BN / TN);
  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BN;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK) {
#pragma unroll
    for (int i = 0; i < (BM * BK) / THREADS; ++i) {
      const int e = tid + i * THREADS;
      const int r = e / BK, c = e % BK;
      const int gr = row0 + r, gc = k0 + c;
      As[c][r] = (gr < M && gc < K) ? to_f32(A[(size_t)gr * K + gc]) : 0.f;
    }
#pragma unroll
    for (int i = 0; i < (BK * BN) / THREADS; ++i) {
      const int e = tid + i * THREADS;
      const int r = e / BN, c = e % BN;
      const int gr = k0 + r, gc = col0 + c;
      Bs[r][c] = (gr < K && gc < N) ? to_f32(B[(size_t)gr * N + gc]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[kk][ty * TM]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[kk][ty * TM + 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[kk][tx * TN]);
      const float4 b1 = *reinterpret_cast<const float4*>(&Bs[kk][tx * TN + 4]);
      const float a[TM] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[TN] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  // epilogue 1: the output tile, cast to the output type
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = row0 + ty * TM + i;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int c = col0 + tx * TN + j;
      if (r < M && c < N) store(C + (size_t)r * N + c, acc[i][j]);
    }
  }
  if (prof == nullptr) return;  // profile=False

  // epilogue 2: the profile words, from the fp32 accumulator
  const int prof_cols = N / bn;
  const int r_last = min(row0 + BM, M) - 1;
  const int c_last = min(col0 + BN, N) - 1;
  if (row0 / bm == r_last / bm && col0 / bn == c_last / bn) {
    // the whole block lies in one profile tile: one reduction, one atomic
    float m = 0.f;
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j)
        if (row0 + ty * TM + i < M && col0 + tx * TN + j < N)
          m = nan_max(m, fabsf(acc[i][j]));
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      m = nan_max(m, __shfl_xor_sync(0xffffffffu, m, off));
    if (tid % 32 == 0) warp_max[tid / 32] = m;
    __syncthreads();
    if (tid == 0) {
      float blk = 0.f;
#pragma unroll
      for (int w = 0; w < THREADS / 32; ++w) blk = nan_max(blk, warp_max[w]);
      fold(prof, (row0 / bm) * prof_cols + col0 / bn, blk);
    }
  } else {
    // profile tiles cut through the block: fold per thread and tile.  Both
    // loops unroll fully, so acc is indexed by constants and stays in
    // registers.
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int r = row0 + ty * TM + i;
      int cur = -1;
      float m = 0.f;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int c = col0 + tx * TN + j;
        if (r < M && c < N) {
          const int t = (r / bm) * prof_cols + c / bn;
          if (t != cur) {
            if (cur >= 0) fold(prof, cur, m);
            cur = t;
            m = 0.f;
          }
          m = nan_max(m, fabsf(acc[i][j]));
        }
      }
      if (cur >= 0) fold(prof, cur, m);
    }
  }
}

template <typename T>
int launch(const void* a, const void* b, void* c, void* prof, int M, int N,
           int K, int bm, int bn, void* stream) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  profiled_matmul_kernel<T><<<grid, THREADS, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), static_cast<T*>(c),
      static_cast<float*>(prof), M, N, K, bm, bn);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface, loaded with ctypes.  A, B, C row-major and contiguous;
// prof is a zeroed [M/bm, N/bn] float32 buffer, or null for profile=False.
// Launches on `stream` and returns the launch's cudaError_t (0 = success).
extern "C" int profiled_matmul_f32(const void* a, const void* b, void* c,
                                   void* prof, int M, int N, int K, int bm,
                                   int bn, void* stream) {
  return launch<float>(a, b, c, prof, M, N, K, bm, bn, stream);
}

extern "C" int profiled_matmul_bf16(const void* a, const void* b, void* c,
                                    void* prof, int M, int N, int K, int bm,
                                    int bn, void* stream) {
  return launch<__nv_bfloat16>(a, b, c, prof, M, N, K, bm, bn, stream);
}

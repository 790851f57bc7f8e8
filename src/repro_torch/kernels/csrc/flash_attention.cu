// Hopper (sm_90a) kernel for flash attention with an in-band profile:
// out = softmax(q k^T / sqrt(D)) v, causal or not, over q [BH, T, D] and
// k, v [BH, S, D] (KV heads already broadcast), bf16 or fp32 in, fp32
// online softmax, output in the input type; plus one profile word per
// (bh, q_block), the running max of the scaled logits of that block's rows.
//
// Replaces the Pallas TPU kernel `_flash_fwd_kernel` of
// src/repro/kernels/flash_attention.py (called through `flash_attention`).
//
// What bounds it: operations.  At the zamba2-1.2b prefill shape
// [2, 32, 4096, 64] causal it does 4 * D FLOP per (q, k) pair of the causal
// triangle, 1.37e11 FLOP on 67 MB of bf16 operands and output, far above
// the card's ridge: 0.139 ms at 989 TFLOP/s (bf16 tensor cores), against
// 0.040 ms for the bytes.  This first version is a plain shared-memory
// kernel on the fp32 FMA units (no tensor cores, no TMA), so it cannot
// approach that bound: right first, fast in a later change (wgmma on bf16
// tiles, as FlashAttention-3 does).
//
// Design.  One block of 128 threads per (bh, 64-row q tile), the heaviest
// causal tiles scheduled first.  The q tile is scaled by 1/sqrt(D) in fp32
// on its way into shared memory (as the Pallas body scales q before the
// dot).  The block walks 64-column K/V tiles of the causal prefix only
// (flash_attention.py:42-46); each step stages K (transposed) and V in
// shared memory, computes the 64x64 logit tile from a 4x8 register tile
// per thread, masks it (-1e30 above the diagonal, as the reference, and on
// the ragged edge past S), folds it into the per-row online softmax state
// (m, l) with two threads per row, and adds P V into a 4x(D/8) fp32
// accumulator per thread after rescaling by exp(m_old - m_new).  The output
// is acc / max(l, 1e-30), cast once.  Rows past T (a ragged last tile) are
// computed on zeros and never written.
//
// The profile.  q_block fixes only the profile's granularity: one profile
// word may span several 64-row blocks (q_block 128) and one block may cut
// through several words (q_block 32, or a ragged q_block = T).  Every row
// folds its final m into its word with atomicMax on an order-preserving
// unsigned key (sign bit flipped for non-negative floats, all bits flipped
// for negative ones), because the max logit may be negative and the int
// bits of negative floats run backwards.  The zeroed buffer is below every
// key; a second small kernel turns the keys back into floats.  The max is
// order-free, so the profile is deterministic.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64, BK = 64;        // q rows and kv columns per tile
constexpr int THREADS = 128;
constexpr int TR = 4, TC = 8;          // logit micro-tile per thread
constexpr int PAD = 4;                 // keeps float4 alignment, spreads banks
constexpr float NEG_INF = -1e30f;
static_assert((BQ / TR) * (BK / TC) == THREADS, "one micro-tile a thread");

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);  // round to nearest even, as torch's cast
}

// order-preserving float -> unsigned key, and back
__device__ __forceinline__ unsigned to_key(float f) {
  const unsigned u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}
__device__ __forceinline__ float from_key(unsigned k) {
  return __uint_as_float((k & 0x80000000u) ? (k ^ 0x80000000u) : ~k);
}

template <int D>
constexpr int smem_floats() {
  return D * (BQ + PAD)      // Qt [D][BQ+PAD], q transposed and scaled
         + D * (BK + PAD)    // Kt [D][BK+PAD], k transposed
         + BK * D            // Vs [BK][D]
         + BK * (BQ + PAD)   // Pt [BK][BQ+PAD], logits then p, transposed
         + 3 * BQ;           // m, l, alpha per row
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out,
                 unsigned* __restrict__ prof, int Tq, int S, int q_blk,
                 int causal, float scale) {
  constexpr int DC = D / (BK / TC);   // output columns per thread
  static_assert(DC * (BK / TC) == D && (DC % 2) == 0, "D split over tx");
  extern __shared__ __align__(16) float smem[];
  float* Qt = smem;
  float* Kt = Qt + D * (BQ + PAD);
  float* Vs = Kt + D * (BK + PAD);
  float* Pt = Vs + BK * D;
  float* m_s = Pt + BK * (BQ + PAD);
  float* l_s = m_s + BQ;
  float* a_s = l_s + BQ;

  const int tid = threadIdx.x;
  const int tx = tid % (BK / TC);     // 0..7
  const int ty = tid / (BK / TC);     // 0..15
  const int bh = blockIdx.x;
  const int n_qt = (Tq + BQ - 1) / BQ;
  const int q0 = (n_qt - 1 - (int)blockIdx.y) * BQ;  // heaviest tiles first
  const T* qb = q + (size_t)bh * Tq * D;
  const T* kb = k + (size_t)bh * S * D;
  const T* vb = v + (size_t)bh * S * D;

  for (int e = tid; e < BQ * D; e += THREADS) {
    const int r = e / D, d = e % D;
    Qt[d * (BQ + PAD) + r] =
        (q0 + r < Tq) ? to_f32(qb[(size_t)(q0 + r) * D + d]) * scale : 0.f;
  }
  if (tid < BQ) {
    m_s[tid] = NEG_INF;
    l_s[tid] = 0.f;
  }

  float acc[TR][DC];
#pragma unroll
  for (int i = 0; i < TR; ++i)
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;

  const int kv_end = causal ? min(S, q0 + BQ) : S;
  for (int j0 = 0; j0 < kv_end; j0 += BK) {
    __syncthreads();  // the previous step is done with Kt, Vs, Pt
    for (int e = tid; e < BK * D; e += THREADS) {
      const int c = e / D, d = e % D;
      const bool ok = j0 + c < S;
      Kt[d * (BK + PAD) + c] = ok ? to_f32(kb[(size_t)(j0 + c) * D + d]) : 0.f;
      Vs[c * D + d] = ok ? to_f32(vb[(size_t)(j0 + c) * D + d]) : 0.f;
    }
    __syncthreads();

    // logits: rows ty*TR.., columns tx*TC..
    float s[TR][TC];
#pragma unroll
    for (int i = 0; i < TR; ++i)
#pragma unroll
      for (int j = 0; j < TC; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(
          &Qt[d * (BQ + PAD) + ty * TR]);
      const float4 b0 = *reinterpret_cast<const float4*>(
          &Kt[d * (BK + PAD) + tx * TC]);
      const float4 b1 = *reinterpret_cast<const float4*>(
          &Kt[d * (BK + PAD) + tx * TC + 4]);
      const float qa[TR] = {a.x, a.y, a.z, a.w};
      const float kbv[TC] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < TR; ++i)
#pragma unroll
        for (int j = 0; j < TC; ++j) s[i][j] = fmaf(qa[i], kbv[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < TR; ++i) {
      const int row = q0 + ty * TR + i;
#pragma unroll
      for (int j = 0; j < TC; ++j) {
        const int col = j0 + tx * TC + j;
        const bool masked = col >= S || (causal && col > row);
        Pt[(tx * TC + j) * (BQ + PAD) + ty * TR + i] =
            masked ? NEG_INF : s[i][j];
      }
    }
    __syncthreads();

    // online softmax state: two threads per row, 32 columns each
    {
      const int r = tid >> 1, half = tid & 1;
      float mx = NEG_INF;
      for (int j = half * (BK / 2); j < (half + 1) * (BK / 2); ++j)
        mx = fmaxf(mx, Pt[j * (BQ + PAD) + r]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int j = half * (BK / 2); j < (half + 1) * (BK / 2); ++j) {
        const float p = expf(Pt[j * (BQ + PAD) + r] - m_new);
        Pt[j * (BQ + PAD) + r] = p;
        sum += p;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      __syncwarp();
      if (half == 0) {
        const float alpha = expf(m_old - m_new);
        a_s[r] = alpha;
        l_s[r] = l_s[r] * alpha + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * alpha + P V: rows ty*TR.., columns tx*DC..
#pragma unroll
    for (int i = 0; i < TR; ++i) {
      const float alpha = a_s[ty * TR + i];
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[i][c] *= alpha;
    }
#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      const float4 p4 = *reinterpret_cast<const float4*>(
          &Pt[j * (BQ + PAD) + ty * TR]);
      const float p[TR] = {p4.x, p4.y, p4.z, p4.w};
      float vv[DC];
#pragma unroll
      for (int c = 0; c < DC; c += 2) {
        const float2 t = *reinterpret_cast<const float2*>(
            &Vs[j * D + tx * DC + c]);
        vv[c] = t.x;
        vv[c + 1] = t.y;
      }
#pragma unroll
      for (int i = 0; i < TR; ++i)
#pragma unroll
        for (int c = 0; c < DC; ++c) acc[i][c] = fmaf(p[i], vv[c], acc[i][c]);
    }
  }
  __syncthreads();

  // epilogue: the output rows, then the profile words
#pragma unroll
  for (int i = 0; i < TR; ++i) {
    const int r = ty * TR + i;
    if (q0 + r >= Tq) continue;
    const float inv_l = 1.f / fmaxf(l_s[r], 1e-30f);
    T* dst = out + ((size_t)bh * Tq + q0 + r) * D + tx * DC;
#pragma unroll
    for (int c = 0; c < DC; ++c) store(dst + c, acc[i][c] * inv_l);
  }
  if (prof != nullptr && tid < BQ && q0 + tid < Tq) {
    const int n_qb = Tq / q_blk;
    atomicMax(prof + (size_t)bh * n_qb + (q0 + tid) / q_blk, to_key(m_s[tid]));
  }
}

__global__ void keys_to_floats(unsigned* __restrict__ prof, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) {
    const float f = from_key(prof[i]);
    reinterpret_cast<float*>(prof)[i] = f;
  }
}

template <typename T, int D>
int launch_d(const void* q, const void* k, const void* v, void* out,
             void* prof, int BH, int Tq, int S, int q_blk, int causal,
             float scale, cudaStream_t stream) {
  constexpr size_t smem = smem_floats<D>() * sizeof(float);
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const dim3 grid(BH, (Tq + BQ - 1) / BQ);
  flash_fwd_kernel<T, D><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out),
      static_cast<unsigned*>(prof), Tq, S, q_blk, causal, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || prof == nullptr) return static_cast<int>(err);
  const int n = BH * (Tq / q_blk);
  keys_to_floats<<<(n + 255) / 256, 256, 0, stream>>>(
      static_cast<unsigned*>(prof), n);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out,
           void* prof, int BH, int Tq, int S, int D, int q_blk, int causal,
           float scale, void* stream) {
  if (BH == 0 || Tq == 0) return 0;
  if (S == 0 || q_blk <= 0 || Tq % q_blk)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return launch_d<T, 16>(q, k, v, out, prof, BH, Tq, S, q_blk, causal, scale, st);
    case 32: return launch_d<T, 32>(q, k, v, out, prof, BH, Tq, S, q_blk, causal, scale, st);
    case 64: return launch_d<T, 64>(q, k, v, out, prof, BH, Tq, S, q_blk, causal, scale, st);
    case 128: return launch_d<T, 128>(q, k, v, out, prof, BH, Tq, S, q_blk, causal, scale, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Plain C interface, loaded with ctypes.  q [BH, T, D], k and v [BH, S, D],
// out [BH, T, D], row-major and contiguous; prof a zeroed [BH, T/q_blk]
// 32-bit buffer (float on return), or null for profile=False.  D is one of
// 16, 32, 64, 128.  Launches on `stream` and returns the first launch's
// cudaError_t (0 = success).
extern "C" int flash_attention_f32(const void* q, const void* k,
                                   const void* v, void* out, void* prof,
                                   int BH, int T, int S, int D, int q_blk,
                                   int causal, float scale, void* stream) {
  return launch<float>(q, k, v, out, prof, BH, T, S, D, q_blk, causal, scale,
                       stream);
}

extern "C" int flash_attention_bf16(const void* q, const void* k,
                                    const void* v, void* out, void* prof,
                                    int BH, int T, int S, int D, int q_blk,
                                    int causal, float scale, void* stream) {
  return launch<__nv_bfloat16>(q, k, v, out, prof, BH, T, S, D, q_blk,
                               causal, scale, stream);
}

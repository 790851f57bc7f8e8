// Hopper (sm_90a) kernel for Mamba2's SSD inter-chunk state passing: an
// exclusive scan over chunks of per-chunk states,
//
//     out[c]    = s                  (the state BEFORE chunk c)
//     s         = decay[c] * s + S[c]
//
// on states [B, NC, H, P, N] and decays [B, NC, H], fp32, with s starting
// from an optional init_state [B, H, P, N] (zero when it is null).
//
// Replaces the Pallas TPU kernel `_state_passing_kernel` of
// src/repro/kernels/ssd_scan.py (called through `ssd_state_passing`).
//
// What bounds it: memory.  Each state word is read once and written once,
// with one multiply and one add in between (0.125 FLOP per byte, far below
// the card's ~20 FLOP/byte fp32 ridge).  At the zamba2-1.2b prefill shape
// [2, 32, 64, 64, 64] that is 2 x 67.1 MB, 0.040 ms at 3.35 TB/s.
//
// Design.  The Pallas kernel walks the chunks as the sequential grid
// dimension and carries [head_block, P, N] in VMEM scratch; its layout
// shuffle and head blocks are TPU tiling.  Here every (b, h, p, n) element
// is an independent recurrence, so one thread owns one element and walks
// the chunks with the running state in a register.  Neighbouring threads
// take neighbouring n, so every load and store of a warp is one coalesced
// 128-byte line; the chunk loop is unrolled so the loads of later chunks
// (which do not depend on the running state) are in flight together.  The
// update is __fmul_rn then __fadd_rn: two correctly rounded operations with
// no FMA contraction, exactly the plain PyTorch version's two tensor ops, so
// the two agree bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
ssd_state_passing_kernel(const float* __restrict__ states,
                         const float* __restrict__ decays,
                         const float* __restrict__ init,
                         float* __restrict__ out, int B, int NC, int H,
                         int PN) {
  const int64_t hpn = (int64_t)H * PN;
  const int64_t e = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  if (e >= (int64_t)B * hpn) return;
  const int64_t b = e / hpn;
  const int64_t r = e - b * hpn;        // (h, p, n) flattened
  const int64_t h = r / PN;
  float s = init ? init[e] : 0.f;
  const float* src = states + b * NC * hpn + r;
  float* dst = out + b * NC * hpn + r;
  const float* dec = decays + b * NC * H + h;
#pragma unroll 8
  for (int c = 0; c < NC; ++c) {
    dst[(int64_t)c * hpn] = s;
    s = __fadd_rn(__fmul_rn(dec[(int64_t)c * H], s), src[(int64_t)c * hpn]);
  }
}

}  // namespace

// Plain C interface, loaded with ctypes.  states [B, NC, H, P, N], decays
// [B, NC, H], out [B, NC, H, P, N], init [B, H, P, N] or null; fp32,
// contiguous.  Launches on `stream` and returns the launch's cudaError_t
// (0 = success).
extern "C" int ssd_state_passing_f32(const void* states, const void* decays,
                                     const void* init, void* out, int B,
                                     int NC, int H, int P, int N,
                                     void* stream) {
  const int64_t total = (int64_t)B * H * P * N;
  if (total == 0 || NC == 0) return 0;
  const int64_t blocks = (total + THREADS - 1) / THREADS;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  ssd_state_passing_kernel<<<(unsigned)blocks, THREADS, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(states), static_cast<const float*>(decays),
      static_cast<const float*>(init), static_cast<float*>(out), B, NC, H,
      P * N);
  return static_cast<int>(cudaGetLastError());
}

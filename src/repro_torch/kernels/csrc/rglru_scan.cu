// Diagonal linear recurrence, the core of the RG-LRU:
//
//   h_t = a_t * h_{t-1} + b_t        per channel, from h_{-1} = h0 (or 0)
//
// a, b: (B, T, D) f32; returns h (B, T, D) f32.
//
// Replaces the TPU kernel `lru_scan_btd` of the JAX package
// (src/repro/kernels/rglru_scan/rglru_scan.py). The TPU kernel tiles
// (T, D) into (256, 128) blocks, pads both axes to them and carries h
// across time blocks in VMEM scratch; here one thread per (b, d) walks all
// of T with h in a register, so nothing is padded and any T and D run.
//
// What bounds it on the card: device memory. It reads a and b and writes h
// once (12 B an element against 2 flops). Loads and stores are coalesced
// along d, each thread's next step is one row further on, and the time
// loop is unrolled so the loads of several steps are in flight together.
// At the model's shapes B*D is 16K threads (recurrentgemma-9b, B=4), 64
// blocks on 132 SMs: the card is under-filled and the scan stays below the
// bound at long T (a later PR can split T into chunks and combine them
// with a second pass).
//
// Numerics: explicitly rounded f32 operations (__fmul_rn, __fadd_rn: no
// FMA contraction), so one step is a*h + b rounded twice, as the plain
// version and JAX's fold of h0 into b_0 compute it: T = 1 (decode) is
// bitwise equal to both. At T > 1 the plain version composes the steps in
// jax.lax.associative_scan's order (a tolerance).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

// grid (ceil(D / kThreads), B)
__global__ void lru_scan_kernel(const float* __restrict__ a,
                                const float* __restrict__ b,
                                const float* __restrict__ h0,
                                float* __restrict__ h, int T, int D) {
  const int d = blockIdx.x * blockDim.x + threadIdx.x;
  if (d >= D) return;
  const int64_t bi = blockIdx.y;
  float x = h0 ? h0[bi * D + d] : 0.f;
  int64_t idx = bi * T * D + d;
  // unrolled so that the loads of several steps (independent of h) are in
  // flight together
#pragma unroll 8
  for (int t = 0; t < T; ++t, idx += D) {
    x = __fadd_rn(__fmul_rn(a[idx], x), b[idx]);
    h[idx] = x;
  }
}

}  // namespace

// a, b, h: (B, T, D) contiguous f32; h0: (B, D) contiguous f32 or null.
// Returns a cudaError_t.
extern "C" int lru_scan_launch(const float* a, const float* b,
                               const float* h0, float* h, int B, int T, int D,
                               void* stream) {
  dim3 grid((D + kThreads - 1) / kThreads, B);
  lru_scan_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(a, b, h0, h, T,
                                                               D);
  return (int)cudaGetLastError();
}

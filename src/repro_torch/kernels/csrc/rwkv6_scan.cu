// RWKV-6 WKV recurrence with a matrix-valued state per (batch, head):
//
//   o_t = r_t (S + diag(u) k_t v_t^T)        o_j = sum_i r_i (S_ij + u_i k_i v_j)
//   S   = diag(w_t) S + k_t v_t^T            S_ij = w_i S_ij + k_i v_j
//
// over t = 0..T-1 from S = s0 (or 0); returns o (B, T, H, hd) and the final
// state S_T (B, H, hd, hd) f32.
//
// Replaces the TPU kernel `wkv_scan_bht` of the JAX package
// (src/repro/kernels/rwkv6_scan/rwkv6_scan.py). The TPU kernel folds (B, H)
// into one grid axis, pads T to its time block and carries S across time
// blocks in VMEM scratch; here one block per (b, h) walks all of T itself,
// so neither the fold nor the pad touches memory.
//
// What bounds it on the card: at decode (T = 1) device memory, the state
// read and written once (2 * hd * hd * 4 B per head against ~6 flops an
// element), and at small B*H the launch itself. At long T the serial
// dependence on S: each step is hd^2 multiply-adds a head, and only
// B*H blocks run. The design answers that by keeping the state out of
// memory for the whole scan: thread j of the block holds column j of S
// (hd f32 values) in registers, r/k/v/w of a chunk of CT steps are staged
// in shared memory with one load each (coalesced along hd), and each step
// costs no barrier, only shared-memory broadcasts of r_i, k_i, w_i, u_i.
//
// Numerics: f32 throughout (bf16 inputs widened on load, o rounded to the
// input dtype on store). The state update uses explicitly rounded
// operations (__fmul_rn, __fadd_rn: no FMA contraction) in the plain
// PyTorch version's order, so S_T equals it bitwise; o's sum over i runs
// in another order than the plain version's matmul (a tolerance).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChunk = 16;   // time steps staged in shared memory at once

__device__ __forceinline__ float load(const float* p, int64_t i) {
  return p[i];
}
__device__ __forceinline__ float load(const __nv_bfloat16* p, int64_t i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void store(float* p, int64_t i, float x) {
  p[i] = x;
}
__device__ __forceinline__ void store(__nv_bfloat16* p, int64_t i, float x) {
  p[i] = __float2bfloat16_rn(x);
}

// grid (B*H), block HD threads; thread j owns column j of the state
template <typename T, int HD>
__global__ void wkv_scan_kernel(const T* __restrict__ r,
                                const T* __restrict__ k,
                                const T* __restrict__ v,
                                const T* __restrict__ w,
                                const float* __restrict__ u,
                                const float* __restrict__ s0,
                                T* __restrict__ o, float* __restrict__ sT,
                                int nT, int H) {
  __shared__ float sr[kChunk][HD], sk[kChunk][HD], sw[kChunk][HD],
      sv[kChunk][HD], su[HD];
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int j = threadIdx.x;
  const int64_t state_off = (int64_t)bh * HD * HD;

  float s[HD];
#pragma unroll
  for (int i = 0; i < HD; ++i)
    s[i] = s0 ? s0[state_off + (int64_t)i * HD + j] : 0.f;
  su[j] = u[h * HD + j];

  for (int t0 = 0; t0 < nT; t0 += kChunk) {
    const int n = min(kChunk, nT - t0);
    __syncthreads();   // the previous chunk's reads are done
    for (int c = 0; c < n; ++c) {
      const int64_t idx = (((int64_t)b * nT + t0 + c) * H + h) * HD + j;
      sr[c][j] = load(r, idx);
      sk[c][j] = load(k, idx);
      sv[c][j] = load(v, idx);
      sw[c][j] = load(w, idx);
    }
    __syncthreads();
    for (int c = 0; c < n; ++c) {
      const float vj = sv[c][j];
      float acc = 0.f;
#pragma unroll
      for (int i = 0; i < HD; ++i) {
        const float kv = __fmul_rn(sk[c][i], vj);
        acc += sr[c][i] * __fadd_rn(s[i], __fmul_rn(su[i], kv));
        s[i] = __fadd_rn(__fmul_rn(sw[c][i], s[i]), kv);
      }
      store(o, (((int64_t)b * nT + t0 + c) * H + h) * HD + j, acc);
    }
  }
#pragma unroll
  for (int i = 0; i < HD; ++i) sT[state_off + (int64_t)i * HD + j] = s[i];
}

template <typename T, int HD>
int launch(const void* r, const void* k, const void* v, const void* w,
           const float* u, const float* s0, void* o, float* sT, int B, int nT,
           int H, cudaStream_t stream) {
  wkv_scan_kernel<T, HD><<<B * H, HD, 0, stream>>>(
      (const T*)r, (const T*)k, (const T*)v, (const T*)w, u, s0, (T*)o, sT,
      nT, H);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(int hd, const void* r, const void* k, const void* v,
             const void* w, const float* u, const float* s0, void* o,
             float* sT, int B, int nT, int H, cudaStream_t stream) {
  switch (hd) {
    case 16: return launch<T, 16>(r, k, v, w, u, s0, o, sT, B, nT, H, stream);
    case 32: return launch<T, 32>(r, k, v, w, u, s0, o, sT, B, nT, H, stream);
    case 64: return launch<T, 64>(r, k, v, w, u, s0, o, sT, B, nT, H, stream);
    case 128:
      return launch<T, 128>(r, k, v, w, u, s0, o, sT, B, nT, H, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// r, k, v, w, o: (B, T, H, hd) contiguous, dtype 0 = f32, 1 = bf16; u:
// (H, hd) f32; s0: (B, H, hd, hd) f32 or null (zero state); sT: (B, H, hd,
// hd) f32. hd in {16, 32, 64, 128}, T >= 1. Returns a cudaError_t.
extern "C" int wkv_scan_launch(int dtype, const void* r, const void* k,
                               const void* v, const void* w, const float* u,
                               const float* s0, void* o, float* sT, int B,
                               int T, int H, int hd, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return dispatch<float>(hd, r, k, v, w, u, s0, o, sT, B, T, H, st);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(hd, r, k, v, w, u, s0, o, sT, B, T, H, st);
  return (int)cudaErrorInvalidValue;
}

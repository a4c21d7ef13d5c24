// Fused outer-update plane: the outer Nesterov step and the delivery stage
// (Eq. 3 blending or Algorithm-1 delay compensation, with offline-worker
// masking) over the flat fragment plane, (rows, 1024) f32 buffers.
//
// Replaces the TPU kernels `nesterov_2d` and `deliver_2d` of the JAX
// package (src/repro/kernels/outer_update/outer_update.py).
//
// What bounds them on the card: device memory. Per element nesterov reads
// theta, momentum, delta and writes theta', momentum' (20 B, ~5 flops);
// deliver reads local (+ snapshot) and the shared global fragment and writes
// local' (blend ~12 B/elem of the worker stack and 4 flops, compensate ~16 B
// and ~10 flops): at most 0.7 flop/B, far below the card's ~20 flop/B f32
// ridge. The design answers that with one pass over the data: each thread
// walks a grid-stride loop of 16-byte (float4) loads and stores, neighbouring
// threads on neighbouring addresses, and keeps every intermediate in
// registers. rows x 1024 is always a multiple of 4, so no tail handling. The
// TPU kernel's worker grid axis becomes the high part of the flat index of
// the (M, rows, 1024) stack: worker w = i / n4, and the (rows, 1024) global
// fragment is read at i % n4 instead of being broadcast in memory. The
// scalar operands (the TPU kernels' SMEM operand) and the (M,) availability
// vector are read from device memory, so the host never syncs to build them.
//
// Numerics: every multiply, add and divide is an explicitly rounded f32
// operation (__fmul_rn, __fadd_rn, __fdiv_rn: IEEE, no FMA contraction), in
// the order of the plain PyTorch version, so the kernel reproduces it.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 132 * 16;

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float dvd(float a, float b) { return __fdiv_rn(a, b); }

// m' = mu*m + d ; t' = t + lr*(d + mu*m')
__device__ __forceinline__ void nesterov1(float t, float m, float d, float lr,
                                          float mu, float& t_out,
                                          float& m_out) {
  const float mn = add(mul(mu, m), d);
  m_out = mn;
  t_out = add(t, mul(lr, add(d, mul(mu, mn))));
}

// Inputs and outputs may alias exactly (in-place update): each element is
// read before it is written, by the same thread.
__global__ void nesterov_kernel(const float4* t, const float4* m,
                                const float4* d, float4* t_out,
                                float4* m_out, const float* scalars,
                                int64_t n4) {
  const float lr = scalars[0], mu = scalars[1];
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n4;
       i += stride) {
    const float4 tv = t[i], mv = m[i], dv = d[i];
    float4 to, mo;
    nesterov1(tv.x, mv.x, dv.x, lr, mu, to.x, mo.x);
    nesterov1(tv.y, mv.y, dv.y, lr, mu, to.y, mo.y);
    nesterov1(tv.z, mv.z, dv.z, lr, mu, to.z, mo.z);
    nesterov1(tv.w, mv.w, dv.w, lr, mu, to.w, mo.w);
    t_out[i] = to;
    m_out[i] = mo;
  }
}

// new = (1 - alpha)*l + alpha*g
__device__ __forceinline__ float blend1(float l, float g, float one_m_alpha,
                                        float alpha) {
  return add(mul(one_m_alpha, l), mul(alpha, g));
}

// gr = sign*(l - s)/tau ; gc = gr + lam*gr*gr*(g - s)/h ; new = g + gc*tau
__device__ __forceinline__ float compensate1(float l, float s, float g,
                                             float tau, float lam, float h,
                                             float sign) {
  const float gr = dvd(mul(sign, sub(l, s)), tau);
  const float gc = add(gr, dvd(mul(mul(mul(lam, gr), gr), sub(g, s)), h));
  return add(g, mul(gc, tau));
}

// mode 0 = blend, 1 = compensate. out: (M, n4) float4; l/s: M planes of n4
// float4 each, worker w's at w * l_ws / w * s_ws (the snapshot is a row
// slice of the full-model plane, so its workers are not adjacent); g: (n4,)
// float4; avail: (M,) f32 (0 = offline: keeps l); scalars: [alpha, tau,
// lam, H, sign]
template <int kMode>
__global__ void deliver_kernel(const float4* l, const float4* s,
                               const float4* g, const float* avail,
                               const float* scalars, float4* out,
                               int64_t m, int64_t n4, int64_t l_ws,
                               int64_t s_ws) {
  const float alpha = scalars[0], tau = scalars[1], lam = scalars[2],
              h = scalars[3], sign = scalars[4];
  const float one_m_alpha = sub(1.0f, alpha);
  const int64_t total = m * n4;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
       i < total; i += stride) {
    const int64_t w = i / n4;
    const int64_t j = i - w * n4;
    const float4 lv = l[w * l_ws + j];
    if (avail[w] == 0.0f) {
      out[i] = lv;
      continue;
    }
    const float4 gv = g[j];
    float4 o;
    if (kMode == 0) {
      o.x = blend1(lv.x, gv.x, one_m_alpha, alpha);
      o.y = blend1(lv.y, gv.y, one_m_alpha, alpha);
      o.z = blend1(lv.z, gv.z, one_m_alpha, alpha);
      o.w = blend1(lv.w, gv.w, one_m_alpha, alpha);
    } else {
      const float4 sv = s[w * s_ws + j];
      o.x = compensate1(lv.x, sv.x, gv.x, tau, lam, h, sign);
      o.y = compensate1(lv.y, sv.y, gv.y, tau, lam, h, sign);
      o.z = compensate1(lv.z, sv.z, gv.z, tau, lam, h, sign);
      o.w = compensate1(lv.w, sv.w, gv.w, tau, lam, h, sign);
    }
    out[i] = o;
  }
}

int blocks_for(int64_t n) {
  int64_t b = (n + kThreads - 1) / kThreads;
  if (b > kMaxBlocks) b = kMaxBlocks;
  return (int)(b < 1 ? 1 : b);
}

}  // namespace

// n: elements of each plane (a multiple of 4). Returns a cudaError_t.
extern "C" int nesterov_2d_launch(const float* theta, const float* momentum,
                                  const float* delta, const float* scalars,
                                  float* theta_out, float* momentum_out,
                                  int64_t n, void* stream) {
  const int64_t n4 = n / 4;
  nesterov_kernel<<<blocks_for(n4), kThreads, 0, (cudaStream_t)stream>>>(
      (const float4*)theta, (const float4*)momentum, (const float4*)delta,
      (float4*)theta_out, (float4*)momentum_out, scalars, n4);
  return (int)cudaGetLastError();
}

// mode: 0 = blend, 1 = compensate (snapshot ignored for blend).
// m: workers; n: elements of one worker's plane (a multiple of 4);
// local_ws / snap_ws: elements between two workers' planes (multiples of 4).
extern "C" int deliver_2d_launch(int mode, const float* local,
                                 const float* snapshot, const float* g,
                                 const float* avail, const float* scalars,
                                 float* out, int64_t m, int64_t n,
                                 int64_t local_ws, int64_t snap_ws,
                                 void* stream) {
  const int64_t n4 = n / 4;
  const int blocks = blocks_for(m * n4);
  cudaStream_t st = (cudaStream_t)stream;
  if (mode == 0) {
    deliver_kernel<0><<<blocks, kThreads, 0, st>>>(
        (const float4*)local, nullptr, (const float4*)g, avail, scalars,
        (float4*)out, m, n4, local_ws / 4, 0);
  } else {
    deliver_kernel<1><<<blocks, kThreads, 0, st>>>(
        (const float4*)local, (const float4*)snapshot, (const float4*)g,
        avail, scalars, (float4*)out, m, n4, local_ws / 4, snap_ws / 4);
  }
  return (int)cudaGetLastError();
}

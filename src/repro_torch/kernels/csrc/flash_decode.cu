// One-token GQA attention over the slotted KV cache, for Hopper (sm_90a).
//
// Replaces the TPU kernel `flash_decode_bkv` of the JAX package
// (src/repro/kernels/flash_decode/flash_decode.py). Same semantics: per-slot
// positions (kv_pos (B, C), -1 = empty; q_pos (B,)), causal kv_pos <= q_pos,
// optional sliding window q_pos - kv_pos < window, online softmax in f32,
// and 0 for a query row with no valid key.
//
// What bounds it: device memory. Each decode step reads every valid K and V
// row of the layer once (B * C * KV * hd * 2 elements) and does ~4 flops per
// element read, far below the H100's ridge (~295 flops per byte in bf16).
//
// What the design does about it:
//   * one block per (slot b, kv head h): the G query heads that share a kv
//     head are processed together, so each K/V row is read from device
//     memory once for all G heads (the TPU kernel's (G, hd) panel);
//   * the TPU's sequential grid axis over cache blocks becomes a loop over
//     tiles inside the block, carrying the running max m, sum l (shared
//     memory) and accumulator acc (registers) in f32;
//   * K and V are read straight from the models' (B, C, KV, hd) cache layer
//     through its strides: no transposed copy, no padding of C (the ragged
//     last tile is masked here);
//   * keys that are masked (empty, in the future, or outside the window) are
//     never loaded, so a slot reads only the rows it attends to;
//   * with 64 blocks at qwen3 the time is memory latency, so each block runs
//     16 warps and issues its loads in batches: 4 K rows a warp, and for V
//     4 key groups a dim, each thread loading its 16 rows of a tile at once
//     and keeping a partial accumulator; the groups are summed at the end.
// Not done yet: with 8 slots x 8 kv heads, 64 blocks underfill 132 SMs;
// splitting the cache across blocks (split-K) is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 64;                          // cache rows per tile
constexpr int kMaxG = 16;                          // query heads per kv head
constexpr int kMaxHd = 256;                        // head dim
constexpr int kLaneElems = kMaxHd / 32;            // K elements per lane
constexpr int kKeysPerWarp = kTile / kWarps;       // score rows per warp (4)
constexpr int kDimThreads = 128;                   // threads across the dims
constexpr int kKeyGroups = kThreads / kDimThreads; // V key groups (4)
constexpr int kDimsPerThread = kMaxHd / kDimThreads;
constexpr int kKeysPerGroup = kTile / kKeyGroups;  // V rows per thread (16)
constexpr float kNegInf = -1e30f;                  // the TPU kernel's NEG_INF

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) flash_decode_kernel(
    const T* __restrict__ q,              // (B, KV * G, hd), contiguous
    const T* __restrict__ k,              // (B, C, KV, hd) through strides
    const T* __restrict__ v,
    const int32_t* __restrict__ kv_pos,   // (B, C), contiguous
    const int32_t* __restrict__ q_pos,    // (B,)
    T* __restrict__ out,                  // (B, KV * G, hd), contiguous
    int C, int KV, int G, int hd,
    int64_t k_sb, int64_t k_sc, int64_t k_sh,
    int64_t v_sb, int64_t v_sc, int64_t v_sh,
    int window, float scale) {
  __shared__ float q_s[kMaxG * kMaxHd];   // scaled queries, f32
  __shared__ float p_s[kMaxG][kTile];     // scores, then probabilities
  __shared__ float red_s[kKeyGroups][kMaxHd];  // final sum over key groups
  __shared__ bool valid_s[kTile];
  __shared__ float m_s[kMaxG], l_s[kMaxG], alpha_s[kMaxG];

  const int b = blockIdx.x, h = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int dt = tid % kDimThreads, kg = tid / kDimThreads;
  const int H = KV * G;
  const int qp = q_pos[b];

  const T* qb = q + ((int64_t)b * H + (int64_t)h * G) * hd;
  for (int i = tid; i < G * hd; i += kThreads) q_s[i] = to_f32(qb[i]) * scale;
  if (tid < G) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }
  // this thread's share of acc: dims dt + kDimThreads * j, summed over the
  // keys of its key group kg (the groups are added up at the end)
  float acc[kMaxG][kDimsPerThread];
#pragma unroll
  for (int g = 0; g < kMaxG; ++g)
#pragma unroll
    for (int j = 0; j < kDimsPerThread; ++j) acc[g][j] = 0.f;

  const T* kb = k + b * k_sb + h * k_sh;
  const T* vb = v + b * v_sb + h * v_sh;
  const int32_t* pb = kv_pos + (int64_t)b * C;

  for (int c0 = 0; c0 < C; c0 += kTile) {
    // 0. the tile's mask, one row per thread
    if (tid < kTile) {
      const int c = c0 + tid;
      bool valid = false;
      if (c < C) {
        const int kp = pb[c];
        valid = kp >= 0 && kp <= qp && (window <= 0 || qp - kp < window);
      }
      valid_s[tid] = valid;
    }
    __syncthreads();

    // 1. scores: each warp takes kKeysPerWarp rows, lanes split the head
    //    dim; the rows' loads are issued together (masked rows not loaded)
    {
      float kr[kKeysPerWarp][kLaneElems];
#pragma unroll
      for (int r = 0; r < kKeysPerWarp; ++r) {
        const int t = warp * kKeysPerWarp + r;
        const bool valid = valid_s[t];
        const T* row = kb + (int64_t)(c0 + t) * k_sc;
#pragma unroll
        for (int j = 0; j < kLaneElems; ++j) {
          const int d = lane + 32 * j;
          kr[r][j] = (valid && d < hd) ? to_f32(row[d]) : 0.f;
        }
      }
#pragma unroll
      for (int r = 0; r < kKeysPerWarp; ++r) {
        const int t = warp * kKeysPerWarp + r;
#pragma unroll
        for (int g = 0; g < kMaxG; ++g) {
          if (g >= G) break;
          float s = 0.f;
#pragma unroll
          for (int j = 0; j < kLaneElems; ++j) {
            const int d = lane + 32 * j;
            if (d < hd) s += q_s[g * hd + d] * kr[r][j];
          }
#pragma unroll
          for (int off = 16; off > 0; off >>= 1)
            s += __shfl_xor_sync(0xffffffffu, s, off);
          if (lane == 0) p_s[g][t] = s;
        }
      }
    }
    __syncthreads();

    // 2. online-softmax statistics, one warp per query row
    for (int g = warp; g < G; g += kWarps) {
      const float m_prev = m_s[g];
      float mx = kNegInf;
      for (int t = lane; t < kTile; t += 32)
        if (valid_s[t]) mx = fmaxf(mx, p_s[g][t]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int t = lane; t < kTile; t += 32) {
        const float p = valid_s[t] ? expf(p_s[g][t] - m_new) : 0.f;
        p_s[g][t] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        alpha_s[g] = alpha;
        l_s[g] = alpha * l_s[g] + sum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();

    // 3. acc = alpha * acc + p @ V over this thread's key group; its
    //    kKeysPerGroup V loads are issued together (masked rows: p = 0, not
    //    loaded)
#pragma unroll
    for (int j = 0; j < kDimsPerThread; ++j) {
      const int d = dt + kDimThreads * j;
      if (d >= hd) continue;
      float vv[kKeysPerGroup];
#pragma unroll
      for (int i = 0; i < kKeysPerGroup; ++i) {
        const int t = kg + kKeyGroups * i;
        vv[i] = valid_s[t] ? to_f32(vb[(int64_t)(c0 + t) * v_sc + d]) : 0.f;
      }
#pragma unroll
      for (int g = 0; g < kMaxG; ++g) {
        if (g >= G) break;
        float a = acc[g][j] * alpha_s[g];
#pragma unroll
        for (int i = 0; i < kKeysPerGroup; ++i)
          a += p_s[g][kg + kKeyGroups * i] * vv[i];
        acc[g][j] = a;
      }
    }
    __syncthreads();
  }

  // sum the key groups' partial accumulators, one query row at a time
#pragma unroll
  for (int g = 0; g < kMaxG; ++g) {
    if (g >= G) break;
#pragma unroll
    for (int j = 0; j < kDimsPerThread; ++j) {
      const int d = dt + kDimThreads * j;
      if (d < hd) red_s[kg][d] = acc[g][j];
    }
    __syncthreads();
    for (int d = tid; d < hd; d += kThreads) {
      float a = 0.f;
#pragma unroll
      for (int gi = 0; gi < kKeyGroups; ++gi) a += red_s[gi][d];
      const float l = l_s[g] == 0.f ? 1.f : l_s[g];  // no valid key -> 0
      store(&out[((int64_t)b * H + (int64_t)h * G + g) * hd + d], a / l);
    }
    __syncthreads();
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Launches on `stream` without
// synchronising; returns cudaGetLastError() (0 = launched).
extern "C" int flash_decode_launch(
    int dtype, const void* q, const void* k, const void* v,
    const void* kv_pos, const void* q_pos, void* out,
    int B, int C, int KV, int G, int hd,
    int64_t k_sb, int64_t k_sc, int64_t k_sh,
    int64_t v_sb, int64_t v_sc, int64_t v_sh,
    int window, float scale, void* stream) {
  if (B < 1 || KV < 1 || KV > 65535 || G < 1 || G > kMaxG || hd < 1 ||
      hd > kMaxHd || C < 0)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(B, KV);
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) {
    flash_decode_kernel<float><<<grid, kThreads, 0, s>>>(
        (const float*)q, (const float*)k, (const float*)v,
        (const int32_t*)kv_pos, (const int32_t*)q_pos, (float*)out, C, KV, G,
        hd, k_sb, k_sc, k_sh, v_sb, v_sc, v_sh, window, scale);
  } else if (dtype == 1) {
    flash_decode_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
        (const __nv_bfloat16*)v, (const int32_t*)kv_pos,
        (const int32_t*)q_pos, (__nv_bfloat16*)out, C, KV, G, hd, k_sb, k_sc,
        k_sh, v_sb, v_sc, v_sh, window, scale);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

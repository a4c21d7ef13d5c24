// Delta wire codec: per-block absmax int8/int4 quantization of the
// pseudo-gradient payload (quantize + pack) and its inverse (unpack +
// dequantize), over a flat f32 array cut into `block`-element blocks:
//
//   scale = absmax(block) * f32(1/levels)          levels = 127 | 7
//   code  = clip(rint(x / (scale > 0 ? scale : 1)), -levels, levels)
//   int8: the codes verbatim; int4: byte i of a block holds element i of
//   the block's first half in its low nibble and element i + block/2 in
//   its high nibble
//   x_hat = float(code) * scale
//
// Replaces the TPU kernels `quantize_pack_2d` and `dequantize_unpack_2d` of
// the JAX package (src/repro/kernels/delta_codec/delta_codec.py).
//
// What bounds them on the card: device memory. Encode reads 4 B and writes
// 1 B (int8) or 0.5 B (int4) an element plus 4 B a block; decode mirrors
// it; ~3 flops an element, far below the ridge. The design: one warp per
// quantization block, in a grid-stride loop over blocks (8 warps a thread
// block), so the absmax is a register max plus five warp shuffles, with no
// shared memory and no barrier; a second pass over the block (an L1 hit)
// quantizes and writes the codes. Where the block is a multiple of 8
// elements and the pointers are aligned (checked here, at launch), lanes
// move 16-byte float4 loads and 4-byte char4 stores; other blocks (any even
// size the spec admits, 2..65536) take one element a lane. The TPU
// kernel's (rows, 128)-lane scale broadcast and its pad of the block axis to
// a multiple of 256 are gone: the scales are one f32 a block, and a ragged
// array's last block reads its missing elements as 0 instead of a padded
// copy (zeros never change a block's absmax; their codes are 0).
//
// Numerics: bitwise equal to the plain version. The scale is a multiply by
// the f32 rounding of the double 1/levels (__fmul_rn), x / safe an IEEE
// division (__fdiv_rn; the library is not built with fast math), rint rounds
// half to even like torch.round, and decode is one rounded multiply.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;                 // 8 warps: 8 blocks at a time
constexpr int kWarps = kThreads / 32;
constexpr int64_t kMaxBlocks = 132 * 16;

template <int BITS>
struct Levels;
template <>
struct Levels<8> {
  static constexpr float kMax = 127.0f;
  static constexpr double kInv = 1.0 / 127.0;
};
template <>
struct Levels<4> {
  static constexpr float kMax = 7.0f;
  static constexpr double kInv = 1.0 / 7.0;
};

template <int BITS>
__device__ __forceinline__ int quant1(float x, float safe) {
  const float r = rintf(__fdiv_rn(x, safe));
  return (int)fminf(fmaxf(r, -Levels<BITS>::kMax), Levels<BITS>::kMax);
}

__device__ __forceinline__ float absmax4(float4 v) {
  return fmaxf(fmaxf(fabsf(v.x), fabsf(v.y)), fmaxf(fabsf(v.z), fabsf(v.w)));
}

__device__ __forceinline__ signed char nibbles(int lo, int hi) {
  return (signed char)((lo & 0xF) | ((hi & 0xF) << 4));
}

__device__ __forceinline__ int sext4(int v) { return ((v & 0xF) ^ 8) - 8; }

// x: n f32; packed: nblocks * block * BITS / 8 int8; scales: nblocks f32.
// `vec`: block % 8 == 0, x 16-byte and packed 4-byte aligned.
template <int BITS>
__global__ void quantize_pack_kernel(const float* __restrict__ x, int64_t n,
                                     int block, int64_t nblocks, int vec,
                                     signed char* __restrict__ packed,
                                     float* __restrict__ scales) {
  const int lane = threadIdx.x & 31;
  const int64_t nwarps = ((int64_t)gridDim.x * blockDim.x) >> 5;
  const float inv = (float)Levels<BITS>::kInv;
  const int half = block / 2;
  for (int64_t qb = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
       qb < nblocks; qb += nwarps) {
    const int64_t base = qb * block;
    const float* xb = x + base;
    const int64_t have = n - base;            // elements of this block in x
    const bool fast = vec && have >= block;   // warp-uniform
    const float4* x4 = reinterpret_cast<const float4*>(xb);
    float amax = 0.0f;
    if (fast) {
      for (int j = lane; j < block / 4; j += 32) amax = fmaxf(amax, absmax4(x4[j]));
    } else {
      for (int j = lane; j < block && j < have; j += 32)
        amax = fmaxf(amax, fabsf(xb[j]));
    }
    for (int o = 16; o > 0; o >>= 1)
      amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
    const float scale = __fmul_rn(amax, inv);
    const float safe = scale > 0.0f ? scale : 1.0f;
    if (lane == 0) scales[qb] = scale;

    if (BITS == 8) {
      signed char* out = packed + base;
      if (fast) {
        char4* o4 = reinterpret_cast<char4*>(out);
        for (int j = lane; j < block / 4; j += 32) {
          const float4 v = x4[j];
          o4[j] = make_char4(quant1<8>(v.x, safe), quant1<8>(v.y, safe),
                             quant1<8>(v.z, safe), quant1<8>(v.w, safe));
        }
      } else {
        for (int j = lane; j < block; j += 32)
          out[j] = (signed char)(j < have ? quant1<8>(xb[j], safe) : 0);
      }
    } else {
      signed char* out = packed + qb * half;
      if (fast) {
        const float4* h4 = reinterpret_cast<const float4*>(xb + half);
        char4* o4 = reinterpret_cast<char4*>(out);
        for (int j = lane; j < half / 4; j += 32) {
          const float4 a = x4[j], b = h4[j];
          o4[j] = make_char4(nibbles(quant1<4>(a.x, safe), quant1<4>(b.x, safe)),
                             nibbles(quant1<4>(a.y, safe), quant1<4>(b.y, safe)),
                             nibbles(quant1<4>(a.z, safe), quant1<4>(b.z, safe)),
                             nibbles(quant1<4>(a.w, safe), quant1<4>(b.w, safe)));
        }
      } else {
        for (int i = lane; i < half; i += 32) {
          const int lo = i < have ? quant1<4>(xb[i], safe) : 0;
          const int hi = i + half < have ? quant1<4>(xb[i + half], safe) : 0;
          out[i] = nibbles(lo, hi);
        }
      }
    }
  }
}

// packed, scales as above; out: nblocks * block f32 (the padded layout).
// `vec`: block % 8 == 0, packed 4-byte and out 16-byte aligned.
template <int BITS>
__global__ void dequantize_unpack_kernel(const signed char* __restrict__ packed,
                                         const float* __restrict__ scales,
                                         int block, int64_t nblocks, int vec,
                                         float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int64_t nwarps = ((int64_t)gridDim.x * blockDim.x) >> 5;
  const int half = block / 2;
  for (int64_t qb = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
       qb < nblocks; qb += nwarps) {
    const float s = scales[qb];
    float* ob = out + qb * block;
    if (BITS == 8) {
      const signed char* pb = packed + qb * block;
      if (vec) {
        const char4* p4 = reinterpret_cast<const char4*>(pb);
        float4* o4 = reinterpret_cast<float4*>(ob);
        for (int j = lane; j < block / 4; j += 32) {
          const char4 c = p4[j];
          o4[j] = make_float4(__fmul_rn((float)c.x, s), __fmul_rn((float)c.y, s),
                              __fmul_rn((float)c.z, s), __fmul_rn((float)c.w, s));
        }
      } else {
        for (int j = lane; j < block; j += 32) ob[j] = __fmul_rn((float)pb[j], s);
      }
    } else {
      const signed char* pb = packed + qb * half;
      if (vec) {
        const char4* p4 = reinterpret_cast<const char4*>(pb);
        float4* lo4 = reinterpret_cast<float4*>(ob);
        float4* hi4 = reinterpret_cast<float4*>(ob + half);
        for (int j = lane; j < half / 4; j += 32) {
          const char4 c = p4[j];
          lo4[j] = make_float4(__fmul_rn((float)sext4(c.x), s),
                               __fmul_rn((float)sext4(c.y), s),
                               __fmul_rn((float)sext4(c.z), s),
                               __fmul_rn((float)sext4(c.w), s));
          hi4[j] = make_float4(__fmul_rn((float)sext4(c.x >> 4), s),
                               __fmul_rn((float)sext4(c.y >> 4), s),
                               __fmul_rn((float)sext4(c.z >> 4), s),
                               __fmul_rn((float)sext4(c.w >> 4), s));
        }
      } else {
        for (int i = lane; i < half; i += 32) {
          const int b = pb[i];
          ob[i] = __fmul_rn((float)sext4(b), s);
          ob[i + half] = __fmul_rn((float)sext4(b >> 4), s);
        }
      }
    }
  }
}

int grid_for(int64_t nblocks) {
  int64_t b = (nblocks + kWarps - 1) / kWarps;
  if (b > kMaxBlocks) b = kMaxBlocks;
  return (int)(b < 1 ? 1 : b);
}

bool bad_args(int64_t count, int block, int bits) {
  return count <= 0 || block < 2 || block > 65536 || block % 2 ||
         (bits != 8 && bits != 4);
}

}  // namespace

// x: n contiguous f32 (n > 0); packed: ceil(n / block) * block * bits / 8
// int8; scales: ceil(n / block) f32. Returns a cudaError_t.
extern "C" int quantize_pack_launch(const float* x, int64_t n, int block,
                                    int bits, signed char* packed,
                                    float* scales, void* stream) {
  if (bad_args(n, block, bits)) return (int)cudaErrorInvalidValue;
  const int64_t nblocks = (n + block - 1) / block;
  const int vec = block % 8 == 0 && (uintptr_t)x % 16 == 0 &&
                  (uintptr_t)packed % 4 == 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (bits == 8)
    quantize_pack_kernel<8><<<grid_for(nblocks), kThreads, 0, s>>>(
        x, n, block, nblocks, vec, packed, scales);
  else
    quantize_pack_kernel<4><<<grid_for(nblocks), kThreads, 0, s>>>(
        x, n, block, nblocks, vec, packed, scales);
  return (int)cudaGetLastError();
}

// packed: nblocks * block * bits / 8 int8; scales: nblocks f32; out:
// nblocks * block f32. Returns a cudaError_t.
extern "C" int dequantize_unpack_launch(const signed char* packed,
                                        const float* scales, int64_t nblocks,
                                        int block, int bits, float* out,
                                        void* stream) {
  if (bad_args(nblocks, block, bits)) return (int)cudaErrorInvalidValue;
  const int vec = block % 8 == 0 && (uintptr_t)packed % 4 == 0 &&
                  (uintptr_t)out % 16 == 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (bits == 8)
    dequantize_unpack_kernel<8><<<grid_for(nblocks), kThreads, 0, s>>>(
        packed, scales, block, nblocks, vec, out);
  else
    dequantize_unpack_kernel<4><<<grid_for(nblocks), kThreads, 0, s>>>(
        packed, scales, block, nblocks, vec, out);
  return (int)cudaGetLastError();
}

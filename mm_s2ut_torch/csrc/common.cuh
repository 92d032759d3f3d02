// Shared helpers for the port's hand-written sm_90a kernels.
//
// The SIMT kernels are templated on their element type T (float or
// __nv_bfloat16): loads convert to fp32, softmax and accumulation run in
// fp32, stores round back to T (round-to-nearest-even for bf16). The
// bf16 tensor-core kernels (flash_attention_mma.cuh) also round the
// softmax weights to bf16 before their second product; the fp32 ones
// (flash_attention.cu, flash_attention_bwd.cu) split every operand, the
// weights included, into two tf32 halves.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace mm {

// Element-type codes of the C interface (ops/_build.py passes them).
enum DType : int { kFloat32 = 0, kBFloat16 = 1 };

// The logit of a (query, key) pair outside the causal/window band.
constexpr float kMasked = -1e9f;

template <typename T> __device__ __forceinline__ float to_f32(T x);
template <> __device__ __forceinline__ float to_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// Attention dropout: the reference's counter hash (mm_s2ut/ops/attention.py
// _mix, dropout_keep) of the absolute coordinates (bh = b.H + h, query t,
// key s) and a per-call seed, in uint32 arithmetic that wraps as JAX's does.
// Weight (bh, t, s) is kept iff the top 24 bits, as a float in [0, 1), are
// >= the rate (a float32, as JAX's weak typing compares it).
__device__ __forceinline__ uint32_t hash_mix(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

__device__ __forceinline__ bool hash_keep(uint32_t bh, uint32_t t, uint32_t s, uint32_t seed,
                                          float rate) {
  const uint32_t h = hash_mix((t * 0x27D4EB2Fu) ^ (s * 0x85EBCA6Bu) ^ (bh * 0xC2B2AE35u) ^ seed);
  return (float)(int)(h >> 8) * (1.0f / 16777216.0f) >= rate;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

}  // namespace mm

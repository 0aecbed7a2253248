// Shared toolkit of the attention kernels: element conversions, vector
// loads and the constants both kernels take from the reference.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>

namespace attn {

// masked score and the floor of the softmax denominator, as in
// src/repro/kernels/flash_attention.py and decode_attention.py
constexpr float kNegInf = -2.0e38f;
constexpr float kMinDenom = 1e-37f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// E consecutive elements at p (aligned to E elements) as float32; one
// vector load of 4 to 16 bytes.
template <typename T, int E>
struct alignas(sizeof(T) * E) Vec {
  T v[E];
};

template <typename T, int E>
__device__ __forceinline__ void load_f32(const T* p, float* out) {
  const Vec<T, E> r = *reinterpret_cast<const Vec<T, E>*>(p);
#pragma unroll
  for (int e = 0; e < E; ++e) out[e] = to_f32(r.v[e]);
}

__device__ __forceinline__ float cap_score(float s, float softcap) {
  return softcap > 0.f ? softcap * tanhf(s / softcap) : s;
}

}  // namespace attn

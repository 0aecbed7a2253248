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

// +inf: the log-sum-exp of a row that admits no key, which makes every
// p = exp(s - lse) of that row 0 in the backward
__device__ __forceinline__ float pos_inf() { return __int_as_float(0x7f800000); }

// The flash mask, shared by the forward and the backward kernels so that
// the two cannot drift apart: query qi sees key kj < Skv when kj <= qi or
// kj < prefix (causal; the prefix-LM mask when prefix > 0) and, with a
// window, kj > qi - window.  causal = 0 admits every key (bidirectional and
// cross attention).
__device__ __forceinline__ bool admitted(int qi, int kj, int Skv, int causal,
                                         int window, int prefix) {
  bool ok = kj < Skv;
  if (causal) ok = ok && (kj <= qi || kj < prefix);
  if (window > 0) ok = ok && kj > qi - window;
  return ok;
}

struct Range {
  int lo, hi;  // [lo, hi)
};

// The keys the mask admits for some query row in [q0, q_last]; lo is not
// rounded to a tile.
__device__ __forceinline__ Range kv_range(int q0, int q_last, int Skv,
                                          int causal, int window, int prefix) {
  Range r;
  r.hi = causal ? min(Skv, max(q_last + 1, prefix)) : Skv;
  r.lo = window > 0 ? max(0, q0 - window + 1) : 0;
  return r;
}

// The query rows the mask admits for some key in [k0, k_last] (the
// backward's dK/dV blocks walk these); lo is not rounded to a tile.
__device__ __forceinline__ Range q_range(int k0, int k_last, int Sq,
                                         int causal, int window, int prefix) {
  Range r;
  r.lo = causal && k0 >= prefix ? min(k0, Sq) : 0;
  r.hi = window > 0 ? min(Sq, k_last + window) : Sq;
  return r;
}

// Whether admitted() holds for every pair of query rows [q0, q_last] and
// keys [k0, k_last], all of them below Sq and Skv: such a tile needs no
// per-element mask (the backward's wgmma kernels test each tile with it).
__device__ __forceinline__ bool tile_admitted(int q0, int q_last, int k0,
                                              int k_last, int Sq, int Skv,
                                              int causal, int window,
                                              int prefix) {
  bool all = q_last < Sq && k_last < Skv;
  if (causal) all = all && (k_last <= q0 || k_last < prefix);
  if (window > 0) all = all && k0 > q_last - window;
  return all;
}

}  // namespace attn

// Shared toolkit of the keyed-plane kernels: wrapping integer atomics and
// the launch-shape helpers.  Every entry point has a plain C interface
// (pointers as void*, the stream as void*) and returns cudaGetLastError(),
// so the Python side binds it with ctypes and raises on a refused launch.
#pragma once

#include <cuda_runtime.h>
#include <cstdint>

namespace keyed {

// Integer accumulators wrap modulo 2^32 / 2^64 exactly like the reference's
// int32 (JAX) and int64 (numpy np.add.at) sums: the add is done on the
// unsigned type, whose overflow is defined.
__device__ __forceinline__ void atomic_acc(int32_t* p, int32_t v) {
  atomicAdd(reinterpret_cast<unsigned int*>(p), static_cast<unsigned int>(v));
}

__device__ __forceinline__ void atomic_acc(int64_t* p, int64_t v) {
  atomicAdd(reinterpret_cast<unsigned long long*>(p),
            static_cast<unsigned long long>(v));
}

__device__ __forceinline__ void atomic_acc(float* p, float v) {
  atomicAdd(p, v);
}

inline unsigned int grid_for(int64_t work, int threads) {
  int64_t blocks = (work + threads - 1) / threads;
  // grid-stride loops cover the rest; 2^20 blocks keeps every SM busy
  const int64_t cap = int64_t(1) << 20;
  return static_cast<unsigned int>(blocks < cap ? blocks : cap);
}

}  // namespace keyed

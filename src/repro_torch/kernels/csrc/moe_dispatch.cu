// MoE token gather and its backward, for sm_90a.
//
// Replaces the TPU kernel src/repro/kernels/moe_dispatch.py (moe_gather /
// _kernel).  Same function: out[r] = x[row_token[r]] for a token in
// [0, T), and a zero row for any other token (the dummy T marks a buffer
// row no token filled).  A pure copy, so the result is bit-exact for any
// element type: the kernel moves bytes.
//
// Design.  The TPU kernel scalar-prefetches row_token so that its index map
// routes one (1, d) block per grid step.  Here one warp copies one row: it
// reads its token once and moves the row in 16-byte units, neighbouring
// lanes on neighbouring addresses; a row whose byte length or address is
// not a multiple of 16 is moved in 4- or 2-byte units instead (the wrapper
// picks the widest unit that divides the row and both base addresses).
// 8 warps per block, one block per 8 rows.
//
// What bounds it on an H100: bytes.  It reads each gathered row once and
// writes every output row once (R * d elements), with no arithmetic.
// Times and the bound are in PERF.md.
//
// The backward (gather_rows_backward, moe_gather_backward): dx[t] = the sum
// of the gradient's rows r with row_token[r] == t, for t < T; a dummy row
// gives nothing.  The reference has no kernel for it: jax.grad
// differentiates its take_along_axis (src/repro/models/moe.py:140-144).
// One warp per token reads the token's at most k rows, named by a table
// [T, k] of buffer indices in buffer order (R = no row; index preparation
// by a stable sort, shared with the combine's plain version), and sums
// them in float32 in that order, rounding once: the plain version's
// additions in the plain version's order, so the two agree bit for bit,
// and a second call gives the same bits (no atomics).  Lanes take 16-byte
// units of the row where it and both base addresses allow, else single
// elements.  What bounds it: bytes (each live row of the gradient read
// once, dx written once, the table read once).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>

namespace moe {

constexpr int kWarps = 8;

template <typename U>
__global__ void __launch_bounds__(kWarps * 32)
gather_rows(const U* __restrict__ x, const int32_t* __restrict__ row_token,
            U* __restrict__ out, int64_t R, int T, int64_t units) {
  const int64_t r = int64_t(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (r >= R) return;
  const int lane = threadIdx.x & 31;
  const int tok = row_token[r];
  U* dst = out + r * units;
  if (tok >= 0 && tok < T) {
    const U* src = x + int64_t(tok) * units;
    for (int64_t i = lane; i < units; i += 32) dst[i] = src[i];
  } else {
    const U zero{};
    for (int64_t i = lane; i < units; i += 32) dst[i] = zero;
  }
}

template <typename U>
int launch(const void* x, const void* row_token, void* out, int64_t R, int T,
           int64_t row_bytes, void* stream) {
  const int64_t blocks = (R + kWarps - 1) / kWarps;
  gather_rows<U><<<static_cast<unsigned>(blocks), kWarps * 32, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const U*>(x), static_cast<const int32_t*>(row_token),
      static_cast<U*>(out), R, T, row_bytes / int64_t(sizeof(U)));
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int E>
struct alignas(sizeof(T) * E) Vec {
  T v[E];
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// E elements per lane step: 16 bytes, or 1
template <typename T, int E>
__global__ void __launch_bounds__(kWarps * 32)
gather_rows_backward(const T* __restrict__ dout,
                     const int32_t* __restrict__ table, T* __restrict__ dx,
                     int T_, int k, int64_t R, int64_t d) {
  const int64_t t = int64_t(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (t >= T_) return;
  const int lane = threadIdx.x & 31;
  const int32_t* rows = table + t * k;
  using V = Vec<T, E>;
  for (int64_t u = lane; u * E < d; u += 32) {
    float acc[E];
#pragma unroll
    for (int e = 0; e < E; ++e) acc[e] = 0.f;
    for (int j = 0; j < k; ++j) {
      const int64_t r = rows[j];
      if (r >= R) continue;  // no row
      const V v = reinterpret_cast<const V*>(dout + r * d)[u];
#pragma unroll
      for (int e = 0; e < E; ++e) acc[e] += to_f32(v.v[e]);
    }
    V o;
#pragma unroll
    for (int e = 0; e < E; ++e) o.v[e] = from_f32<T>(acc[e]);
    reinterpret_cast<V*>(dx + t * d)[u] = o;
  }
}

template <typename T>
int launch_backward(const void* dout, const void* table, void* dx, int T_,
                    int k, int64_t R, int64_t d, bool vec, void* stream) {
  const unsigned blocks =
      static_cast<unsigned>((int64_t(T_) + kWarps - 1) / kWarps);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const T* src = static_cast<const T*>(dout);
  const int32_t* rows = static_cast<const int32_t*>(table);
  T* dst = static_cast<T*>(dx);
  if (vec)
    gather_rows_backward<T, 16 / sizeof(T)><<<blocks, kWarps * 32, 0, s>>>(
        src, rows, dst, T_, k, R, d);
  else
    gather_rows_backward<T, 1><<<blocks, kWarps * 32, 0, s>>>(
        src, rows, dst, T_, k, R, d);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace moe

extern "C" {

// x [T, row_bytes] and out [R, row_bytes] as raw bytes, row_token int32 [R].
// unit: the bytes moved per lane step, 16, 4 or 2; it must divide row_bytes
// and both base addresses.  Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for arguments the kernel does not take (the wrapper
// refuses those first).
int moe_gather_forward(const void* x, const void* row_token, void* out,
                       long long R, int T, long long row_bytes, int unit,
                       void* stream) {
  if (R <= 0 || T < 0 || row_bytes <= 0 || unit <= 0 || row_bytes % unit ||
      (R + moe::kWarps - 1) / moe::kWarps > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  if (unit == 16)
    return moe::launch<uint4>(x, row_token, out, R, T, row_bytes, stream);
  if (unit == 4)
    return moe::launch<uint32_t>(x, row_token, out, R, T, row_bytes, stream);
  if (unit == 2)
    return moe::launch<uint16_t>(x, row_token, out, R, T, row_bytes, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

// dout [R, d] and dx [T, d] of dtype (0 = float32, 1 = bfloat16); table
// int32 [T, k]: each token's rows in buffer order, R for none.  vec: 16-byte
// units (d * element bytes and both base addresses multiples of 16).
// Returns cudaGetLastError() after the launch, or cudaErrorInvalidValue for
// arguments the kernel does not take (the wrapper refuses those first).
int moe_gather_backward(const void* dout, const void* table, void* dx, int T,
                        int k, long long R, long long d, int dtype, int vec,
                        void* stream) {
  if (T <= 0 || k <= 0 || R < 0 || d <= 0 ||
      (int64_t(T) + moe::kWarps - 1) / moe::kWarps > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0)
    return moe::launch_backward<float>(dout, table, dx, T, k, R, d, vec != 0,
                                       stream);
  if (dtype == 1)
    return moe::launch_backward<__nv_bfloat16>(dout, table, dx, T, k, R, d,
                                               vec != 0, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"

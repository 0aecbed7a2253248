// MoE token gather, for sm_90a.
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

}  // extern "C"

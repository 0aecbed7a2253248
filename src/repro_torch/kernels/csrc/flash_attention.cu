// Causal / sliding-window flash attention (prefill), for sm_90a.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py
// (flash_attention / _kernel).  Same function: scores q.k / sqrt(hd) in
// float32, optional softcap c*tanh(s/c), mask k <= q (causal) and
// k > q - window (window > 0) with masked scores -2e38, online softmax, and
// the output acc / max(l, 1e-37) in q's dtype.  GQA: q head h reads kv head
// h / (Hq / Hkv).  Layouts: q, o [B, Hq, Sq, hd]; k, v [B, Hkv, Skv, hd],
// all contiguous, float32 or bfloat16 (the math is float32 either way).
//
// Design.  The TPU kernel walks the kv axis as the innermost, sequential
// grid dimension and carries m / l / acc in VMEM scratch from one grid step
// to the next, skipping masked blocks with pl.when.  Blocks on Hopper run in
// parallel and carry nothing, so here one block owns one (b, q head, 64-row
// q tile) and loops over the kv tiles itself, visiting only the tiles the
// mask admits ([q0 - window + 1, q_last] rounded to tiles).  The q tile
// (pre-scaled) stays in shared memory; each 64-row kv tile is staged there
// twice per step, first K transposed for the score product, then V row-major
// for the P.V product, in one buffer.  256 threads; thread (ty, tx) owns
// score rows 4ty..4ty+3 and columns tx + 16j, so a row's max and sum are
// shuffles across the 16 lanes that share it, and output columns
// tx + 16j of the same rows.  m, l and acc stay in registers, in float32.
// The TPU kernel asserts Sq % block_q == 0; this one masks the ragged edge
// (rows >= Sq are computed on zeros and never stored; keys >= Skv masked).
//
// What bounds it on an H100: operations.  At the serving path's shapes
// (Sq = Skv = 6,144, hd 128) each admitted (q, k) pair costs 4 * hd flops,
// hundreds per byte moved.  This first version does them as float32 FMAs
// on the CUDA cores out of shared memory (no tensor cores), so it runs far
// from the 989 TFLOP/s bf16 tensor-core bound; wgmma tiles are a later
// change.  The measured time and bound are in PERF.md.

#include <cmath>

#include "attention_common.cuh"

namespace attn {

constexpr int kFlashBQ = 64;
constexpr int kFlashBK = 64;
constexpr int kFlashThreads = 256;

template <int HD>
constexpr int flash_smem_floats() {
  // Q [BQ][HD+1], K^T [HD][BK+1] (V [BK][HD] reuses it), P [BQ][BK+1]
  return kFlashBQ * (HD + 1) + HD * (kFlashBK + 1) + kFlashBQ * (kFlashBK + 1);
}

template <typename T, int HD>
__global__ void __launch_bounds__(kFlashThreads)
flash_forward(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, T* __restrict__ o, int Hq, int Hkv,
              int Sq, int Skv, int causal, int window, float softcap,
              float scale) {
  constexpr int BQ = kFlashBQ, BK = kFlashBK, NT = kFlashThreads;
  constexpr int QS = HD + 1, KS = BK + 1, PS = BK + 1;
  constexpr int DJ = HD / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;
  float* KV = Qs + BQ * QS;
  float* Ps = KV + HD * KS;

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const T* qp = q + (int64_t(b) * Hq + h) * Sq * HD;
  const T* kp = k + (int64_t(b) * Hkv + hk) * Skv * HD;
  const T* vp = v + (int64_t(b) * Hkv + hk) * Skv * HD;
  T* op = o + (int64_t(b) * Hq + h) * Sq * HD;
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;

  for (int e = tid * 4; e < BQ * HD; e += NT * 4) {
    const int r = e / HD, d = e % HD;
    float f[4] = {0.f, 0.f, 0.f, 0.f};
    if (q0 + r < Sq) load_f32<T, 4>(qp + int64_t(q0 + r) * HD + d, f);
#pragma unroll
    for (int i = 0; i < 4; ++i) Qs[r * QS + d + i] = f[i] * scale;
  }

  float m[4], l[4], acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;
  }

  // kv tiles the mask admits for rows [q0, q_last]
  const int q_last = min(q0 + BQ, Sq) - 1;
  const int k_hi = causal ? min(Skv, q_last + 1) : Skv;
  int k_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  k_lo = (k_lo / BK) * BK;

  for (int k0 = k_lo; k0 < k_hi; k0 += BK) {
    __syncthreads();  // the previous tile's V and P are consumed
    for (int e = tid * 4; e < BK * HD; e += NT * 4) {
      const int c = e / HD, d = e % HD;
      float f[4] = {0.f, 0.f, 0.f, 0.f};
      if (k0 + c < Skv) load_f32<T, 4>(kp + int64_t(k0 + c) * HD + d, f);
#pragma unroll
      for (int i = 0; i < 4; ++i) KV[(d + i) * KS + c] = f[i];
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      float a[4], bk[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = Qs[(ty * 4 + i) * QS + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) bk[j] = KV[d * KS + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], bk[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + ty * 4 + i;
      float rmax = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kj = k0 + tx + 16 * j;
        bool ok = kj < Skv;
        if (causal) ok = ok && kj <= qi;
        if (window > 0) ok = ok && kj > qi - window;
        const float x = ok ? cap_score(s[i][j], softcap) : kNegInf;
        s[i][j] = x;
        rmax = fmaxf(rmax, x);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rmax = fmaxf(rmax, __shfl_xor_sync(0xffffffffu, rmax, off));
      const float m_new = fmaxf(m[i], rmax);
      const float alpha = expf(m[i] - m_new);
      float rsum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        rsum += s[i][j];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rsum += __shfl_xor_sync(0xffffffffu, rsum, off);
      l[i] = l[i] * alpha + rsum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();  // every thread is done with K^T

    for (int e = tid * 4; e < BK * HD; e += NT * 4) {
      const int c = e / HD, d = e % HD;
      float f[4] = {0.f, 0.f, 0.f, 0.f};
      if (k0 + c < Skv) load_f32<T, 4>(vp + int64_t(k0 + c) * HD + d, f);
#pragma unroll
      for (int i = 0; i < 4; ++i) KV[c * HD + d + i] = f[i];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) Ps[(ty * 4 + i) * PS + tx + 16 * j] = s[i][j];
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float a[4], bv[DJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = Ps[(ty * 4 + i) * PS + c];
#pragma unroll
      for (int j = 0; j < DJ; ++j) bv[j] = KV[c * HD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < DJ; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty * 4 + i;
    if (qi < Sq) {
      const float denom = fmaxf(l[i], kMinDenom);
#pragma unroll
      for (int j = 0; j < DJ; ++j)
        op[int64_t(qi) * HD + tx + 16 * j] = from_f32<T>(acc[i][j] / denom);
    }
  }
}

template <typename T, int HD>
int launch_flash(const void* q, const void* k, const void* v, void* o, int B,
                 int Hq, int Hkv, int Sq, int Skv, int causal, int window,
                 float softcap, void* stream) {
  constexpr int smem = flash_smem_floats<HD>() * int(sizeof(float));
  // above 48 KB of dynamic shared memory needs the opt-in (per device, so
  // it is set on every launch; the call costs about a microsecond)
  const cudaError_t err = cudaFuncSetAttribute(
      flash_forward<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Sq + kFlashBQ - 1) / kFlashBQ, Hq, B);
  flash_forward<T, HD><<<grid, kFlashThreads, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), Hq, Hkv, Sq, Skv, causal,
      window, softcap, static_cast<float>(1.0 / std::sqrt(double(HD))));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace attn

extern "C" {

// dtype: 0 = float32, 1 = bfloat16; hd: 64 or 128.  Returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue for a shape
// the kernel does not take (the wrapper refuses those before calling).
int attn_flash_forward(const void* q, const void* k, const void* v, void* o,
                       int B, int Hq, int Hkv, int Sq, int Skv, int hd,
                       int dtype, int causal, int window, float softcap,
                       void* stream) {
  if (B <= 0 || Hkv <= 0 || Hq % Hkv != 0 || Sq <= 0 || Skv < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0 && hd == 128)
    return attn::launch_flash<float, 128>(q, k, v, o, B, Hq, Hkv, Sq, Skv,
                                          causal, window, softcap, stream);
  if (dtype == 0 && hd == 64)
    return attn::launch_flash<float, 64>(q, k, v, o, B, Hq, Hkv, Sq, Skv,
                                         causal, window, softcap, stream);
  if (dtype == 1 && hd == 128)
    return attn::launch_flash<__nv_bfloat16, 128>(
        q, k, v, o, B, Hq, Hkv, Sq, Skv, causal, window, softcap, stream);
  if (dtype == 1 && hd == 64)
    return attn::launch_flash<__nv_bfloat16, 64>(
        q, k, v, o, B, Hq, Hkv, Sq, Skv, causal, window, softcap, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"

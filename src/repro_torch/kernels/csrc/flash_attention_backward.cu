// The backward of flash attention (training), for sm_90a.
//
// The JAX package has no backward kernel: it trains through the jnp
// block-chunked attention of src/repro/models/attention.py, which JAX
// differentiates.  The port's training path runs the hand-written forward
// (flash_attention.cu, src/repro/kernels/flash_attention.py:125's
// counterpart), so its gradient is this kernel, reached through the
// torch.autograd.Function of kernels/flash_attention.py.
//
// Function: with s = softcap(q.k * scale) (s = c tanh(r / c) when c > 0)
// over the admitted keys of attention_common.cuh's admitted(), P = exp(s -
// lse) from the forward's row log-sum-exp, O = P.V and the output's
// gradient dO:
//   D  = rowsum(dO o O)                       (flash_bwd_delta)
//   dP = dO.V^T,  dS = P o (dP - D) o (1 - (s / c)^2)
//   dV = P^T.dO,  dK = dS^T.Q * scale          (flash_bwd_dkdv)
//   dQ = dS.K * scale                          (flash_bwd_dq)
// A row whose lse is +inf (it admits no key) contributes nothing.  Layouts
// and options are the forward's: q, o, dO, dq [B, Hq, Sq, hd]; k, v, dk, dv
// [B, Hkv, Skv, hd]; lse, D float32 [B, Hq, Sq]; causal, sliding window,
// prefix-LM, bidirectional and cross (Sq != Skv); softcap; GQA (any Hq %
// Hkv == 0); hd 64, 128, 256; float32 or bfloat16, the gradients in the
// inputs' dtype.
//
// Design (FlashAttention-2's split, float32 math on the CUDA cores):
// - dK/dV: one block per (kv tile, kv head, batch).  It keeps its K and V
//   tiles in shared memory and dK, dV in registers, and walks the q heads
//   of its group and, for each, the q tiles q_range() admits, recomputing
//   S and P from Q and lse.  A kv head's gradient sums over its group's q
//   heads inside the block.
// - dQ: one block per (q tile, q head, batch); it walks the kv tiles
//   kv_range() admits (the forward's range) and keeps dQ in registers.
// - No atomics: every output element is written once by one thread, and
//   every sum runs in a fixed order, so two calls give the same bits (a
//   restart of training is bit-exact only if its gradients are).
// - The mask predicate and both ranges are attention_common.cuh's, shared
//   with the forward, so the two masks cannot drift apart.
// - Every product is a small float32 GEMM out of shared memory (mm below),
//   each thread owning a (rows / 16) x (columns / 16) piece of the output
//   on rows ty + 16 i and columns tx + 16 j.  Tiles are stored row-major
//   with one float of padding (an odd row stride), so reading a tile along
//   its rows or its columns hits distinct banks.
// - bfloat16 inputs are widened on load; each gradient is rounded once.
//
// What bounds it on an H100: operations.  Per admitted (q, k) pair and head
// it does 4 * hd (dK/dV: S, dP, dV, dK) + 3 * hd (dQ: S, dP, dQ) multiply-
// adds, 2.5x the forward's 2 * 2 * hd flops counted as products at the bf16
// tensor-core rate (the same products as the reference's differentiated
// attention); here they run as float32 FMAs at the CUDA cores' 67 TFLOP/s,
// far below that bound.  The tensor-core redesign (wgmma, TMA) is queued
// (ROADMAP Queue 2).

#include <cmath>

#include "attention_common.cuh"

namespace attn {
namespace bwd {

constexpr int kThreads = 256;  // 16 x 16: tx over columns, ty over rows

// Tile sizes: (kvBQ q rows) x (kvBK kv rows) in the dK/dV kernel, (qBQ) x
// (qBK) in the dQ kernel; hd 256 halves the tile whose rows the block keeps
// in registers, so that each block fits 227 KB of shared memory.
template <int HD>
struct Tiles {
  static constexpr int kvBQ = 64, kvBK = HD == 256 ? 32 : 64;
  static constexpr int qBQ = HD == 256 ? 32 : 64, qBK = 64;
};

// Shared memory of a kernel with key tiles of BK rows and q tiles of BQ
// rows: two [BK][HD + 1] tiles (K, V), two [BQ][HD + 1] tiles (Q, dO), two
// [BQ][BK + 1] tiles (P, dS), lse and D of the BQ rows.
template <int HD, int BQ, int BK>
constexpr int smem_bytes() {
  return int(sizeof(float))
         * (2 * BK * (HD + 1) + 2 * BQ * (HD + 1) + 2 * BQ * (BK + 1)
            + 2 * BQ);
}

// acc[M][N] += A[M][K] B[K][N], A(r, c) at A[r * ar + c * ac] and B(r, c)
// at B[r * br + c * bc], all in shared memory; this thread's piece of the
// output is rows ty + 16 i, columns tx + 16 j.
template <int M, int N, int K>
__device__ __forceinline__ void mm(const float* __restrict__ A, int ar,
                                   int ac, const float* __restrict__ B,
                                   int br, int bc,
                                   float (&acc)[M / 16][N / 16], int ty,
                                   int tx) {
#pragma unroll 4
  for (int kk = 0; kk < K; ++kk) {
    float a[M / 16], b[N / 16];
#pragma unroll
    for (int i = 0; i < M / 16; ++i) a[i] = A[(ty + 16 * i) * ar + kk * ac];
#pragma unroll
    for (int j = 0; j < N / 16; ++j) b[j] = B[kk * br + (tx + 16 * j) * bc];
#pragma unroll
    for (int i = 0; i < M / 16; ++i)
#pragma unroll
      for (int j = 0; j < N / 16; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

template <int M, int N>
__device__ __forceinline__ void zero(float (&acc)[M][N]) {
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int j = 0; j < N; ++j) acc[i][j] = 0.f;
}

// rows [r0, r0 + R) of a [rows, HD] tensor into dst [R][HD + 1] as float32,
// zeros past `rows`
template <typename T, int R, int HD>
__device__ __forceinline__ void load_rows(const T* __restrict__ src, int r0,
                                          int rows, float* __restrict__ dst,
                                          int tid) {
  for (int e = tid * 4; e < R * HD; e += kThreads * 4) {
    const int r = e / HD, d = e % HD;
    float f[4] = {0.f, 0.f, 0.f, 0.f};
    if (r0 + r < rows) load_f32<T, 4>(src + int64_t(r0 + r) * HD + d, f);
#pragma unroll
    for (int i = 0; i < 4; ++i) dst[r * (HD + 1) + d + i] = f[i];
  }
}

// lse and D of q rows [q0, q0 + R) of one (b, head) from row `row0`; a row
// past Sq gets lse +inf (P = 0) and D 0
template <int R>
__device__ __forceinline__ void load_stats(const float* __restrict__ lse,
                                           const float* __restrict__ delta,
                                           int64_t row0, int q0, int Sq,
                                           float* lse_s, float* d_s, int tid) {
  for (int r = tid; r < R; r += kThreads) {
    const bool in = q0 + r < Sq;
    lse_s[r] = in ? lse[row0 + q0 + r] : pos_inf();
    d_s[r] = in ? delta[row0 + q0 + r] : 0.f;
  }
}

// One score tile's P and dS in place: s holds Q.K^T (unscaled) and dp holds
// dO.V^T for this thread's rows ty + 16 i (q rows q0 + ...) and columns
// tx + 16 j (keys k0 + ...); masked pairs, rows past Sq and keys past Skv
// get P = dS = 0.
template <int BQ, int BK>
__device__ __forceinline__ void probs_and_grads(
    float (&s)[BQ / 16][BK / 16], float (&dp)[BQ / 16][BK / 16], int q0,
    int k0, int Sq, int Skv, int causal, int window, int prefix,
    float softcap, float scale, const float* lse_s, const float* d_s, int ty,
    int tx) {
  const float inv_cap = softcap > 0.f ? 1.f / softcap : 0.f;
#pragma unroll
  for (int i = 0; i < BQ / 16; ++i) {
    const int r = ty + 16 * i;
    const int qi = q0 + r;
#pragma unroll
    for (int j = 0; j < BK / 16; ++j) {
      const int kj = k0 + tx + 16 * j;
      float x = s[i][j] * scale, dcap = 1.f;
      if (softcap > 0.f) {
        const float t = tanhf(x * inv_cap);
        x = softcap * t;
        dcap = 1.f - t * t;
      }
      const bool ok = qi < Sq && admitted(qi, kj, Skv, causal, window, prefix);
      const float p = ok ? expf(x - lse_s[r]) : 0.f;
      s[i][j] = p;
      dp[i][j] = ok ? p * (dp[i][j] - d_s[r]) * dcap : 0.f;
    }
  }
}

// D = rowsum(dO o O) in float32: one warp a row
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_bwd_delta(const T* __restrict__ o, const T* __restrict__ dout,
                float* __restrict__ delta, int64_t rows) {
  const int64_t row = int64_t(blockIdx.x) * (kThreads / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  float acc = 0.f;
  for (int d = lane * 4; d < HD; d += 128) {
    float a[4], g[4];
    load_f32<T, 4>(o + row * HD + d, a);
    load_f32<T, 4>(dout + row * HD + d, g);
#pragma unroll
    for (int i = 0; i < 4; ++i) acc = fmaf(a[i], g[i], acc);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) delta[row] = acc;
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, const T* __restrict__ dout,
               const float* __restrict__ lse, const float* __restrict__ delta,
               T* __restrict__ dk, T* __restrict__ dv, int Hq, int Hkv,
               int Sq, int Skv, int causal, int window, float softcap,
               int prefix, float scale) {
  constexpr int BQ = Tiles<HD>::kvBQ, BK = Tiles<HD>::kvBK;
  constexpr int HS = HD + 1, PS = BK + 1;
  extern __shared__ float smem[];
  float* Ks = smem;
  float* Vs = Ks + BK * HS;
  float* Qs = Vs + BK * HS;
  float* dOs = Qs + BQ * HS;
  float* Ps = dOs + BQ * HS;
  float* dSs = Ps + BQ * PS;
  float* lse_s = dSs + BQ * PS;
  float* d_s = lse_s + BQ;

  const int k0 = blockIdx.x * BK;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int group = Hq / Hkv;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int64_t kv_row0 = (int64_t(b) * Hkv + hk) * Skv;
  load_rows<T, BK, HD>(k + kv_row0 * HD, k0, Skv, Ks, tid);
  load_rows<T, BK, HD>(v + kv_row0 * HD, k0, Skv, Vs, tid);

  float dk_acc[BK / 16][HD / 16], dv_acc[BK / 16][HD / 16];
  zero(dk_acc);
  zero(dv_acc);
  // the q rows the mask admits for keys [k0, k_last]
  const Range qr = q_range(k0, min(k0 + BK, Skv) - 1, Sq, causal, window,
                           prefix);
  for (int g = 0; g < group; ++g) {
    const int64_t row0 = (int64_t(b) * Hq + hk * group + g) * Sq;
    for (int q0 = (qr.lo / BQ) * BQ; q0 < qr.hi; q0 += BQ) {
      __syncthreads();  // the previous tile's Q, dO, P and dS are consumed
      load_rows<T, BQ, HD>(q + row0 * HD, q0, Sq, Qs, tid);
      load_rows<T, BQ, HD>(dout + row0 * HD, q0, Sq, dOs, tid);
      load_stats<BQ>(lse, delta, row0, q0, Sq, lse_s, d_s, tid);
      __syncthreads();

      float s[BQ / 16][BK / 16], dp[BQ / 16][BK / 16];
      zero(s);
      zero(dp);
      mm<BQ, BK, HD>(Qs, HS, 1, Ks, 1, HS, s, ty, tx);    // Q.K^T
      mm<BQ, BK, HD>(dOs, HS, 1, Vs, 1, HS, dp, ty, tx);  // dO.V^T
      probs_and_grads<BQ, BK>(s, dp, q0, k0, Sq, Skv, causal, window, prefix,
                              softcap, scale, lse_s, d_s, ty, tx);
#pragma unroll
      for (int i = 0; i < BQ / 16; ++i)
#pragma unroll
        for (int j = 0; j < BK / 16; ++j) {
          Ps[(ty + 16 * i) * PS + tx + 16 * j] = s[i][j];
          dSs[(ty + 16 * i) * PS + tx + 16 * j] = dp[i][j];
        }
      __syncthreads();
      mm<BK, HD, BQ>(Ps, 1, PS, dOs, HS, 1, dv_acc, ty, tx);   // P^T.dO
      mm<BK, HD, BQ>(dSs, 1, PS, Qs, HS, 1, dk_acc, ty, tx);   // dS^T.Q
    }
  }

#pragma unroll
  for (int i = 0; i < BK / 16; ++i) {
    const int kj = k0 + ty + 16 * i;
    if (kj < Skv) {
#pragma unroll
      for (int j = 0; j < HD / 16; ++j) {
        const int64_t at = (kv_row0 + kj) * HD + tx + 16 * j;
        dk[at] = from_f32<T>(dk_acc[i][j] * scale);
        dv[at] = from_f32<T>(dv_acc[i][j]);
      }
    }
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, const T* __restrict__ dout,
             const float* __restrict__ lse, const float* __restrict__ delta,
             T* __restrict__ dq, int Hq, int Hkv, int Sq, int Skv, int causal,
             int window, float softcap, int prefix, float scale) {
  constexpr int BQ = Tiles<HD>::qBQ, BK = Tiles<HD>::qBK;
  constexpr int HS = HD + 1, PS = BK + 1;
  extern __shared__ float smem[];
  float* Ks = smem;
  float* Vs = Ks + BK * HS;
  float* Qs = Vs + BK * HS;
  float* dOs = Qs + BQ * HS;
  float* dSs = dOs + BQ * HS;
  float* lse_s = dSs + 2 * BQ * PS;  // the P tile's room stays unused
  float* d_s = lse_s + BQ;

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int64_t row0 = (int64_t(b) * Hq + h) * Sq;
  const int64_t kv_row0 = (int64_t(b) * Hkv + hk) * Skv;
  load_rows<T, BQ, HD>(q + row0 * HD, q0, Sq, Qs, tid);
  load_rows<T, BQ, HD>(dout + row0 * HD, q0, Sq, dOs, tid);
  load_stats<BQ>(lse, delta, row0, q0, Sq, lse_s, d_s, tid);

  float dq_acc[BQ / 16][HD / 16];
  zero(dq_acc);
  // the forward's kv range for rows [q0, q_last]
  const Range kr = kv_range(q0, min(q0 + BQ, Sq) - 1, Skv, causal, window,
                            prefix);
  for (int k0 = (kr.lo / BK) * BK; k0 < kr.hi; k0 += BK) {
    __syncthreads();  // the previous tile's K, V and dS are consumed
    load_rows<T, BK, HD>(k + kv_row0 * HD, k0, Skv, Ks, tid);
    load_rows<T, BK, HD>(v + kv_row0 * HD, k0, Skv, Vs, tid);
    __syncthreads();

    float s[BQ / 16][BK / 16], dp[BQ / 16][BK / 16];
    zero(s);
    zero(dp);
    mm<BQ, BK, HD>(Qs, HS, 1, Ks, 1, HS, s, ty, tx);    // Q.K^T
    mm<BQ, BK, HD>(dOs, HS, 1, Vs, 1, HS, dp, ty, tx);  // dO.V^T
    probs_and_grads<BQ, BK>(s, dp, q0, k0, Sq, Skv, causal, window, prefix,
                            softcap, scale, lse_s, d_s, ty, tx);
#pragma unroll
    for (int i = 0; i < BQ / 16; ++i)
#pragma unroll
      for (int j = 0; j < BK / 16; ++j)
        dSs[(ty + 16 * i) * PS + tx + 16 * j] = dp[i][j];
    __syncthreads();
    mm<BQ, HD, BK>(dSs, PS, 1, Ks, HS, 1, dq_acc, ty, tx);     // dS.K
  }

#pragma unroll
  for (int i = 0; i < BQ / 16; ++i) {
    const int qi = q0 + ty + 16 * i;
    if (qi < Sq) {
#pragma unroll
      for (int j = 0; j < HD / 16; ++j)
        dq[(row0 + qi) * HD + tx + 16 * j] = from_f32<T>(dq_acc[i][j] * scale);
    }
  }
}

template <typename T, int HD>
int launch_backward(const void* q, const void* k, const void* v,
                    const void* o, const float* lse, const void* dout,
                    void* dq, void* dk, void* dv, float* delta, int B, int Hq,
                    int Hkv, int Sq, int Skv, int causal, int window,
                    float softcap, int prefix, cudaStream_t stream) {
  using Tl = Tiles<HD>;
  constexpr int kv_smem = smem_bytes<HD, Tl::kvBQ, Tl::kvBK>();
  constexpr int q_smem = smem_bytes<HD, Tl::qBQ, Tl::qBK>();
  static_assert(kv_smem <= 232448 && q_smem <= 232448,
                "a block's shared memory exceeds 227 KB");
  const float scale = static_cast<float>(1.0 / std::sqrt(double(HD)));
  const T* Q = static_cast<const T*>(q);
  const T* K = static_cast<const T*>(k);
  const T* V = static_cast<const T*>(v);
  const T* dO = static_cast<const T*>(dout);

  const int64_t rows = int64_t(B) * Hq * Sq;
  const int64_t delta_blocks = (rows + kThreads / 32 - 1) / (kThreads / 32);
  if (delta_blocks > 2147483647LL)
    return static_cast<int>(cudaErrorInvalidValue);
  flash_bwd_delta<T, HD><<<unsigned(delta_blocks), kThreads, 0, stream>>>(
      static_cast<const T*>(o), dO, delta, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  // above 48 KB of dynamic shared memory needs the opt-in (per device, so
  // it is set on every launch)
  err = cudaFuncSetAttribute(flash_bwd_dkdv<T, HD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kv_smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 kv_grid((Skv + Tl::kvBK - 1) / Tl::kvBK, Hkv, B);
  flash_bwd_dkdv<T, HD><<<kv_grid, kThreads, kv_smem, stream>>>(
      Q, K, V, dO, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv), Hq,
      Hkv, Sq, Skv, causal, window, softcap, prefix, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  err = cudaFuncSetAttribute(flash_bwd_dq<T, HD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             q_smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 q_grid((Sq + Tl::qBQ - 1) / Tl::qBQ, Hq, B);
  flash_bwd_dq<T, HD><<<q_grid, kThreads, q_smem, stream>>>(
      Q, K, V, dO, lse, delta, static_cast<T*>(dq), Hq, Hkv, Sq, Skv, causal,
      window, softcap, prefix, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace bwd
}  // namespace attn

extern "C" {

// q, k, v, o, dout as the forward's (o its output, dout the gradient of o),
// lse the forward's float32 [B, Hq, Sq]; dq, dk, dv the gradients, written
// in full; delta float32 [B, Hq, Sq] scratch.  dtype: 0 = float32, 1 =
// bfloat16; hd: 64, 128 or 256; the mask options as attn_flash_forward's.
// Three launches on `stream` (D, dK/dV, dQ).  Returns the first nonzero
// cudaGetLastError(), or cudaErrorInvalidValue for a shape the kernels do
// not take (the wrapper refuses most before calling).
int attn_flash_backward(const void* q, const void* k, const void* v,
                        const void* o, const void* lse, const void* dout,
                        void* dq, void* dk, void* dv, void* delta, int B,
                        int Hq, int Hkv, int Sq, int Skv, int hd, int dtype,
                        int causal, int window, float softcap, int prefix_len,
                        void* stream) {
  if (B <= 0 || B > 65535 || Hkv <= 0 || Hq > 65535 || Hq % Hkv != 0
      || Sq <= 0 || Skv <= 0 || prefix_len < 0 || prefix_len > Skv
      || (prefix_len > 0 && (!causal || window > 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  const float* L = static_cast<const float*>(lse);
  float* D = static_cast<float*>(delta);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int P = prefix_len;
#define ATTN_BWD(T, HD)                                                     \
  return attn::bwd::launch_backward<T, HD>(q, k, v, o, L, dout, dq, dk, dv, \
                                           D, B, Hq, Hkv, Sq, Skv, causal,  \
                                           window, softcap, P, st)
  if (dtype == 0 && hd == 64) ATTN_BWD(float, 64);
  if (dtype == 0 && hd == 128) ATTN_BWD(float, 128);
  if (dtype == 0 && hd == 256) ATTN_BWD(float, 256);
  if (dtype == 1 && hd == 64) ATTN_BWD(__nv_bfloat16, 64);
  if (dtype == 1 && hd == 128) ATTN_BWD(__nv_bfloat16, 128);
  if (dtype == 1 && hd == 256) ATTN_BWD(__nv_bfloat16, 256);
#undef ATTN_BWD
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"

// Mamba-2 chunked SSD scan, for sm_90a.
//
// Replaces the TPU kernel src/repro/kernels/ssd_scan.py (ssd_scan /
// _kernel).  Same function, from a zero state: within a chunk of positions
//   y_i = sum_{j<=i} (C_i . B_j) exp(cum_i - cum_j) x_j dt_j
//         + exp(cum_i) C_i h,
// across chunks
//   h <- exp(total) h + sum_j exp(total - cum_j) B_j (x_j dt_j)^T,
// with cum the running sum of dt * A inside the chunk, total its last value
// and every decay clipped to [-60, 0].  Returns y (x's dtype) and the final
// state h [B, H, N, P] in float32.  All arithmetic is float32.
//
// Layouts.  Every input is addressed through (batch, head, seq) strides in
// elements with a contiguous last axis, so the model passes its
// [B, S, H, P] activations and [B, S, N] shared B/C group as views
// ([B, H, S, P] with the head stride 0 for B/C): nothing is transposed or
// expanded in memory.  dt is float32 with its own strides, A float32 [H],
// y is written through strides, h contiguous.
//
// Design.  One block per (b, h, 32-wide slice of P) walks the sequence in
// chunks of kChunk = 64 positions (the TPU kernel's 256-row chunk would put
// B and C alone at 256 KB, over the 227 KB a block may hold; the chunk
// changes the result only through the clip and rounding).  The carried
// state slice h [N, 32] stays in shared memory for the whole walk; each
// chunk loads B, C [64, N] and x dt [64, 32] as float32 into shared memory,
// takes the running sum of dt A with a warp scan, forms the masked scores
// (C B^T o L) [64, 64], then y and the new h, all with float32 FMAs on the
// CUDA cores.  Each thread keeps a register tile (4 x 4 scores, 2 rows x 4
// columns of y, 4 x 4 of h) fed by 16-byte shared-memory loads, so a load
// feeds 4-8 FMAs.  A tail chunk is padded with zero rows (dt = 0 leaves the
// state unchanged) and its y rows are not stored.  Splitting P gives 2
// blocks per head at P = 64 (96 for one Mamba2-780M prompt of 48 heads) at
// the cost of recomputing the scores per slice.
//
// What bounds it on an H100: the chunked formulation's operations are
// about 2 (c^2/2 (N + P) + 2 c N P) per chunk and head, which at the bf16
// tensor-core rate is about the time its bytes take, so the function's bound
// is near both; this kernel runs float32 FMAs with no tensor cores and far
// from either.  `wgmma` on the three products and sharing the scores of
// one B/C group across heads are later work.  Times are in PERF.md.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>

namespace ssd {

constexpr int kChunk = 64;     // positions per chunk
constexpr int kPSlice = 32;    // columns of P per block
constexpr int kThreads = 256;  // 8 warps
constexpr int kLdG = kChunk + 4;  // row pitch of the scores
constexpr float kClip = -60.f;

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

__device__ __forceinline__ float clip_exp(float v) {
  return expf(fminf(fmaxf(v, kClip), 0.f));
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

struct Strides {
  int64_t b, h, s;  // in elements; the last axis is contiguous
};

// Shared memory, float32, every array 16-byte aligned: B and C
// [kChunk][N + 4] (the pad puts 8 consecutive rows on distinct banks), x dt
// [kChunk][kPSlice], h [N][kPSlice], the scores [kChunk][kLdG], and per
// position dt, cum, exp(cum), exp(total - cum).  N is a multiple of 4.
__host__ __device__ inline int smem_floats(int N) {
  return 2 * kChunk * (N + 4) + kChunk * kPSlice + N * kPSlice +
         kChunk * kLdG + 4 * kChunk;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_forward(const T* __restrict__ x, Strides sx, const float* __restrict__ dt,
            Strides sdt, const float* __restrict__ A,
            const T* __restrict__ Bm, Strides sb, const T* __restrict__ Cm,
            Strides sc, T* __restrict__ y, Strides sy,
            float* __restrict__ h_out, int H, int S, int P, int N) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int ldn = N + 4;
  float* sB = smem;
  float* sC = sB + kChunk * ldn;
  float* sX = sC + kChunk * ldn;
  float* sH = sX + kChunk * kPSlice;
  float* sG = sH + N * kPSlice;
  float* sDt = sG + kChunk * kLdG;
  float* sCum = sDt + kChunk;
  float* sOut = sCum + kChunk;
  float* sIn = sOut + kChunk;

  const int p0 = blockIdx.x * kPSlice;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int pw = min(kPSlice, P - p0);  // live columns of this slice
  const float a = A[h];
  // register tiles: 4 columns of P at p4, and the row / state index groups
  const int p4 = (tid & 7) * 4;
  const int r = tid >> 3;               // y rows r and r + 32
  const int n4 = r * 4;                 // h rows n4 + 128 k .. + 3

  const T* xb = x + b * sx.b + h * sx.h + p0;
  const float* dtb = dt + b * sdt.b + h * sdt.h;
  const T* Bb = Bm + b * sb.b + h * sb.h;
  const T* Cb = Cm + b * sc.b + h * sc.h;
  T* yb = y + b * sy.b + h * sy.h + p0;

  for (int i = tid; i < N * kPSlice; i += kThreads) sH[i] = 0.f;

  for (int t0 = 0; t0 < S; t0 += kChunk) {
    const int len = min(kChunk, S - t0);
    // -- load the chunk (rows past S are zeros) --------------------------
    if (tid < kChunk) sDt[tid] = tid < len ? dtb[(t0 + tid) * sdt.s] : 0.f;
#pragma unroll 4
    for (int i = tid; i < kChunk * N; i += kThreads) {
      const int row = i / N, n = i - row * N;
      const bool live = row < len;
      sB[row * ldn + n] = live ? to_f32(Bb[(t0 + row) * sb.s + n]) : 0.f;
      sC[row * ldn + n] = live ? to_f32(Cb[(t0 + row) * sc.s + n]) : 0.f;
    }
    __syncthreads();  // sDt ready (and the previous chunk's h update done)
#pragma unroll
    for (int i = tid; i < kChunk * kPSlice; i += kThreads) {
      const int row = i / kPSlice, p = i - row * kPSlice;
      sX[i] = (row < len && p < pw)
                  ? to_f32(xb[(t0 + row) * sx.s + p]) * sDt[row]
                  : 0.f;
    }
    if (warp == 0) {  // running sum of dt A: lane l owns positions 2l, 2l+1
      const float a0 = sDt[2 * lane] * a, a1 = sDt[2 * lane + 1] * a;
      const float pair = a0 + a1;
      float incl = pair;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float v = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl += v;
      }
      sCum[2 * lane] = incl - pair + a0;
      sCum[2 * lane + 1] = incl;
    }
    __syncthreads();
    const float total = sCum[kChunk - 1];
    if (tid < kChunk) {
      sOut[tid] = clip_exp(sCum[tid]);
      sIn[tid] = clip_exp(total - sCum[tid]);
    }

    // -- scores G[i][j] = (C_i . B_j) exp(cum_i - cum_j), j <= i ----------
    {
      const int ti = tid >> 4, tj = tid & 15;  // i = ti + 16u, j = tj + 16v
      float acc[4][4] = {};
      for (int n = 0; n < N; n += 4) {
        float4 cv[4], bv[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) cv[u] = ld4(sC + (ti + 16 * u) * ldn + n);
#pragma unroll
        for (int v = 0; v < 4; ++v) bv[v] = ld4(sB + (tj + 16 * v) * ldn + n);
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int v = 0; v < 4; ++v) {
            float t = acc[u][v];
            t = fmaf(cv[u].x, bv[v].x, t);
            t = fmaf(cv[u].y, bv[v].y, t);
            t = fmaf(cv[u].z, bv[v].z, t);
            acc[u][v] = fmaf(cv[u].w, bv[v].w, t);
          }
      }
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          const int i = ti + 16 * u, j = tj + 16 * v;
          sG[i * kLdG + j] =
              j <= i ? acc[u][v] * clip_exp(sCum[i] - sCum[j]) : 0.f;
        }
    }
    __syncthreads();

    // -- y_i = sum_j G[i][j] xdt_j + exp(cum_i) C_i h, rows r and r + 32 --
    {
      float acc[2][4] = {}, off[2][4] = {};
      const int jmax = min(len, r + 33);  // G[i][j] = 0 for j > i
      for (int j = 0; j < jmax; ++j) {
        const float4 xv = ld4(sX + j * kPSlice + p4);
        const float g[2] = {sG[r * kLdG + j], sG[(r + 32) * kLdG + j]};
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          acc[k][0] = fmaf(g[k], xv.x, acc[k][0]);
          acc[k][1] = fmaf(g[k], xv.y, acc[k][1]);
          acc[k][2] = fmaf(g[k], xv.z, acc[k][2]);
          acc[k][3] = fmaf(g[k], xv.w, acc[k][3]);
        }
      }
      for (int n = 0; n < N; n += 4) {
        const float4 c[2] = {ld4(sC + r * ldn + n),
                             ld4(sC + (r + 32) * ldn + n)};
        float4 hv[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) hv[q] = ld4(sH + (n + q) * kPSlice + p4);
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          const float cq[4] = {c[k].x, c[k].y, c[k].z, c[k].w};
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            off[k][0] = fmaf(cq[q], hv[q].x, off[k][0]);
            off[k][1] = fmaf(cq[q], hv[q].y, off[k][1]);
            off[k][2] = fmaf(cq[q], hv[q].z, off[k][2]);
            off[k][3] = fmaf(cq[q], hv[q].w, off[k][3]);
          }
        }
      }
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const int row = r + 32 * k;
        if (row >= len) continue;
        const float e = sOut[row];
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (p4 + q < pw)
            yb[(t0 + row) * sy.s + p4 + q] =
                from_f32<T>(fmaf(e, off[k][q], acc[k][q]));
      }
    }
    __syncthreads();  // every y read h before it changes

    // -- h <- exp(total) h + sum_j exp(total - cum_j) B_j xdt_j ------------
    const float keep = clip_exp(total);
    for (int nb = n4; nb < N; nb += 4 * kThreads / 8) {
      float acc[4][4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float4 hv = ld4(sH + (nb + k) * kPSlice + p4);
        acc[k][0] = hv.x * keep;
        acc[k][1] = hv.y * keep;
        acc[k][2] = hv.z * keep;
        acc[k][3] = hv.w * keep;
      }
      for (int j = 0; j < len; ++j) {
        const float s = sIn[j];
        const float4 bv = ld4(sB + j * ldn + nb);
        const float4 xv = ld4(sX + j * kPSlice + p4);
        const float bs[4] = {bv.x * s, bv.y * s, bv.z * s, bv.w * s};
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          acc[k][0] = fmaf(bs[k], xv.x, acc[k][0]);
          acc[k][1] = fmaf(bs[k], xv.y, acc[k][1]);
          acc[k][2] = fmaf(bs[k], xv.z, acc[k][2]);
          acc[k][3] = fmaf(bs[k], xv.w, acc[k][3]);
        }
      }
#pragma unroll
      for (int k = 0; k < 4; ++k)
        *reinterpret_cast<float4*>(sH + (nb + k) * kPSlice + p4) =
            make_float4(acc[k][0], acc[k][1], acc[k][2], acc[k][3]);
    }
    __syncthreads();  // before the next chunk overwrites B, C, x
  }

  float* hb = h_out + ((int64_t(b) * H + h) * N) * P + p0;
  for (int i = tid; i < N * kPSlice; i += kThreads) {
    const int n = i / kPSlice, p = i - n * kPSlice;
    if (p < pw) hb[int64_t(n) * P + p] = sH[i];
  }
}

template <typename T>
int launch(const void* x, const int64_t* sx, const void* dt,
           const int64_t* sdt, const void* A, const void* Bm,
           const int64_t* sb, const void* Cm, const int64_t* sc, void* y,
           const int64_t* sy, void* h_out, int B, int H, int S, int P, int N,
           void* stream) {
  const int smem = smem_floats(N) * int(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      ssd_forward<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((P + kPSlice - 1) / kPSlice, H, B);
  auto st = [](const int64_t* s) { return Strides{s[0], s[1], s[2]}; };
  ssd_forward<T><<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), st(sx), static_cast<const float*>(dt),
      st(sdt), static_cast<const float*>(A), static_cast<const T*>(Bm),
      st(sb), static_cast<const T*>(Cm), st(sc), static_cast<T*>(y), st(sy),
      static_cast<float*>(h_out), H, S, P, N);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace ssd

extern "C" {

// dtype (of x, Bm, Cm and y): 0 = float32, 1 = bfloat16.  Each stride
// argument points to three int64 (batch, head, seq) strides in elements, in
// host memory.  N a multiple of 4, at most 256.  Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for a shape the kernel does not take (the wrapper
// refuses those first).
int ssd_scan_forward(const void* x, const int64_t* sx, const void* dt,
                     const int64_t* sdt, const void* A, const void* Bm,
                     const int64_t* sb, const void* Cm, const int64_t* sc,
                     void* y, const int64_t* sy, void* h_out, int B, int H,
                     int S, int P, int N, int dtype, void* stream) {
  if (B <= 0 || B > 65535 || H <= 0 || H > 65535 || S <= 0 || P <= 0 ||
      N <= 0 || N > 256 || N % 4)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0)
    return ssd::launch<float>(x, sx, dt, sdt, A, Bm, sb, Cm, sc, y, sy, h_out,
                              B, H, S, P, N, stream);
  if (dtype == 1)
    return ssd::launch<__nv_bfloat16>(x, sx, dt, sdt, A, Bm, sb, Cm, sc, y,
                                      sy, h_out, B, H, S, P, N, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"

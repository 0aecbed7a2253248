// The backward of the Mamba-2 chunked SSD scan (training), for sm_90a.
//
// The JAX package has no backward kernel: it trains through the jnp
// chunked scan src/repro/models/mamba2.py:79 (ssd_chunked), which JAX
// differentiates.  The port's training path runs the hand-written forward
// (ssd_scan.cu, src/repro/kernels/ssd_scan.py:98's counterpart), so its
// gradient is this kernel, reached through the torch.autograd.Function of
// kernels/ssd_scan.py.
//
// Function: the gradients (dx, ddt, dA, dB, dC) of the forward's (y, h) for
// their gradients dy and dh_final (none: zero).  Per chunk of positions
// (u = x dt; cum the running sum of dt A; e_i = exp(cum_i), w_j = exp(total
// - cum_j), L_ij = exp(cum_i - cum_j) for j <= i, each clipped to [-60, 0];
// h_{k-1} the state entering chunk k, g_k the gradient of the state leaving
// it):
//   g_{k-1} = exp(total_k) g_k + sum_i e_i C_i dy_i^T,  g_last = dh_final
//   du_j = sum_{i>=j} (B_j . C_i) L_ij dy_i + w_j g_k^T B_j
//   dC_i = sum_{j<=i} L_ij (dy_i . u_j) B_j + e_i h_{k-1} dy_i
//   dB_j = sum_{i>=j} L_ij (dy_i . u_j) C_i + w_j g_k u_j
// and the gradient of cum from every decay (zero where its clip is active),
// the last position also taking total's, turned into that of dt A by a
// reverse running sum inside the chunk: ddt = du . x + A d(dt A), dA =
// sum d(dt A) dt.  Layouts are the forward's: every input through (batch,
// head, seq) strides with a contiguous last axis; dx and ddt written
// through strides; dB and dC [B, G, S, N] contiguous, G = 1 (one group read
// by every head, its heads' gradients summed) or H.
//
// Design, four passes (five launches) run in the forward's order reversed:
// (a) ssd_bwd_chunk_dstate, one block per (chunk, group of heads, batch):
//     each chunk's Q_k = sum_i C_i^T (e_i dy_i) [N, P] into a float32
//     workspace (the forward's (a) with C for B, dy for x and e for w).
// (b) ssd_bwd_state_pass, one thread per state element of a (batch,
//     head): from the last chunk back, g_k written over Q_k in place, then
//     g_{k-1} = exp(total_k) g_k + Q_k, the decays read from the forward's
//     workspace.  Elementwise, serial only in the chunk.
// (c) ssd_bwd_chunk, one block per (chunk, group of heads, batch), the
//     chunk's heads in turn.  Warp w owns rows 16w..16w+15 of the chunk
//     and computes, for them, in two layouts of the chunk's c x c tiles:
//     rows as outputs i (C B^T, dy x^T; dC's two parts, the carry-in's
//     share of d cum) and rows as inputs j (B C^T, x dy^T; du's and dB's two
//     parts, the carry-out's share of d cum).  The two layouts keep every
//     sum a warp's own, so no sum crosses warps; the states h_{k-1} (from
//     the forward's workspace, the forward's own rounding) and g_k go
//     through shared memory in slices of 64 state rows.  dB and dC are
//     summed over the block's heads into a float32 partial per (group of
//     heads) in a fixed order (the block's own rows: no atomics); d cum is
//     turned into ddt and a dA partial per (batch, head, chunk).
// (d) ssd_bwd_reduce: dB, dC summed over their partials and rounded once;
//     ssd_bwd_reduce_dA: dA summed over batches and chunks; each in a fixed
//     order.
// No float atomics anywhere, so a second call gives the same bits.
//
// Products, the forward's two routes, every sum in the accumulator layout
// of an m16n8 tile (lane l holds rows l/4 and l/4 + 8 at columns 8t +
// 2(l%4) + {0, 1} of tile t):
// - bfloat16 (chunk 128, 8 warps): mma.sync on the tensor cores, operands
//   from shared memory by ldmatrix, float32 sums.  B, C, x and dy enter as
//   they are (exact bf16); each float32 operand is split into bf16 hi and
//   lo, two products, so it keeps about 16 bits: the states (the forward's
//   own hi/lo planes of h_{k-1}, and g_k), e dy in (a), and the register
//   tiles L o (C B^T) and L o (dy u^T) that multiply dy, B and C.
// - float32 (chunk 64, 4 warps): the same passes in float32 FMAs on the
//   CUDA cores (TF32 would break the 2e-4 tolerance).
// Each output is rounded once.  The chunk is the forward's: the states
// entering each chunk are the forward's.  P <= 64 (one slice of P; every
// configuration has head_dim 64), N a multiple of 4 up to 256, any S (a
// tail chunk is zero rows, dt = 0).
//
// The tensor-core route (ssd_scan_backward_wgmma; bfloat16 with one B/C
// group, P and N multiples of 8, P <= 64, N <= 128, N P a multiple of 128:
// Mamba2's layers; the wrapper sends other shapes to the route above).  The
// same function and split operands in five launches of their own, designed
// for the H100 rather than carried over:
// (a) ssd_bwd_dstate_wgmma: C by TMA once per block, dy through two TMA
//     stages, e dy split into bf16 planes by the block, Q_k = C^T (e dy) as
//     wgmma with both operands transposed; two blocks an SM.
// (b) ssd_bwd_state_pass_split: g_k written as bf16 hi/lo planes (the
//     layout TMA loads in (c)), the loads of U chunks ahead of the chain,
//     and d total's h_{k-1} . g_k by warps.
// (c) ssd_bwd_chunk_wgmma: one block of two warpgroups per (chunk, group of
//     heads), one wave of blocks on the card's SMs.  The score tile C B^T is
//     the forward's, already in its workspace for a shared group: it is
//     built once per chunk and group, copied to shared memory once per
//     block, and read by every head in both layouts.  Every product is
//     wgmma (m64n128 / m64n64, k16) fed by TMA: B, C once per block; x and
//     dy through two stages, so the next head's arrive while this head's
//     products run; h_{k-1} and then g_k through one buffer.  dB and dC go
//     to one float32 plane per head (stores only), summed by (d).
// (d) as above.  Each output is written once by one thread and every sum
//     runs in a fixed order: no atomics, the same bits from call to call.
//
// What bounds it on an H100: bytes.  The function reads x, dt, B, C, dy
// and writes dx, ddt, dB and dC (for one Mamba2-780M layer of 4,096 bf16
// tokens 81 MB, 24 us at 3.35 TB/s); its least operations, the
// recurrence's backward at the tensor cores' rate, take less.  The chunked
// form adds the forward's states entering each chunk (read), Q/g (written
// and read twice, the size of the forward's chunk states) and the dB/dC
// partials; at that layer the tensor-core route moves about 0.78 GB (h_{k-1}
// 50 MB read twice, Q and g_k 50 MB each written and read, the per-head
// dB/dC planes 201 MB written and read), about 0.23 ms at the memory rate.
// Its c x c tiles' exps run in both layouts for every head.  Times are in
// PERF.md.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>

#include "hopper.cuh"

namespace ssdb {

using bf16 = __nv_bfloat16;

constexpr float kClip = -60.f;
constexpr int kHeads = 4;      // heads per block of passes (a) and (c)
constexpr int kPMax = 64;      // P columns of a tile (P <= 64)
constexpr int kSlice = 64;     // state rows per slice
constexpr int kPassThreads = 256;

// chunk per dtype (the forward's); kSplits: planes of a float32 operand
// (hi, lo) in the products
template <typename T>
struct Route;
template <>
struct Route<bf16> {
  static constexpr int kChunk = 128;
  static constexpr int kPad = 8;  // pitch pads in elements
  static constexpr int kSplits = 2;
};
template <>
struct Route<float> {
  static constexpr int kChunk = 64;
  static constexpr int kPad = 4;
  static constexpr int kSplits = 1;
};

struct Strides {
  int64_t b, h, s;  // in elements; the last axis is contiguous
};

struct Params {
  const void* x;
  Strides sx;
  const float* dt;
  Strides sdt;
  const float* A;
  const void* Bm;
  Strides sb;
  const void* Cm;
  Strides sc;
  const void* dy;
  Strides sdy;
  const void* hprev;   // the forward's [B, H, nc, splits, N, P] of T
  int splits;          // 2 for bf16 (hi, lo), 1 for float32
  const float* decay;  // the forward's [B, H, nc]
  void* dx;
  Strides sdx;
  float* ddt;
  Strides sddt;
  float* gstate;  // [B, H, nc, N, P]: Q_k, then g_k
  float* dB_part;  // [B, planes, S, N]
  float* dC_part;
  float* dA_part;  // [B, H, nc]
  const float* scores;  // tensor-core route: the forward's C B^T tiles
  int hpb;              // tensor-core route: heads per block of (c)
  int H, S, P, N, nc, head_groups, n_slices, planes;
  bool one_group;  // dB, dC per group of all heads (else per head)
};

__device__ __forceinline__ float clip_exp(float v) {
  return __expf(fminf(fmaxf(v, kClip), 0.f));
}
// where the clip passes a gradient (both ends included, as autograd's)
__device__ __forceinline__ bool clip_live(float v) {
  return v >= kClip && v <= 0.f;
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T cvt(float v);
template <>
__device__ __forceinline__ float cvt<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 cvt<bf16>(float v) {
  return __float2bfloat16(v);
}

__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

// sum of a value over the four lanes of a row (lanes 4g .. 4g + 3)
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// A [rows x cols] tile at (b, h, t0) of a strided input into shared memory
// at pitch `pitch` (in D), rows >= rows_live and columns >= cols_live as
// zeros, converted to D; every thread of the block
template <typename D, typename S>
__device__ void stage(D* dst, int pitch, const S* src, int64_t stride,
                      int rows, int rows_live, int cols, int cols_live) {
  for (int i = threadIdx.x; i < rows * cols; i += blockDim.x) {
    const int r = i / cols, c = i - r * cols;
    dst[r * pitch + c] = (r < rows_live && c < cols_live)
                             ? cvt<D>(to_f32(src[r * stride + c]))
                             : cvt<D>(0.f);
  }
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack(bf16 lo, bf16 hi) {
  return uint32_t(__bfloat16_as_ushort(lo)) |
         (uint32_t(__bfloat16_as_ushort(hi)) << 16);
}

// acc[nt] += A[16 x K] . B[K x 8 NT] for one warp, tiles nt0 <= nt < nt1
// (both even), summed over kPlanes planes of B `plane` elements apart (a
// split operand's hi and lo).  A(m, k) = a[m lda + k], or a[k lda + m] with
// kATrans; B(k, n) = b[n ldb + k], or b[k ldb + n] with kBTrans.
// bfloat16: mma.sync on the tensor cores, operands by ldmatrix (rows 16-byte
// aligned, K a multiple of 16, zeros padding it), float32 sums
template <int NT, bool kATrans, bool kBTrans, int kPlanes = 1>
__device__ __forceinline__ void product(float (&acc)[NT][4], const bf16* a,
                                        int lda, const bf16* b, int ldb,
                                        int K, int nt0, int nt1,
                                        int plane = 0) {
  const int lane = threadIdx.x & 31, q = lane >> 3, r = lane & 7;
  for (int k0 = 0; k0 < K; k0 += 16) {
    uint32_t af[4];
    if (kATrans)
      ldsm_x4_t(af, a + (k0 + (q >> 1) * 8 + r) * lda + (q & 1) * 8);
    else
      ldsm_x4(af, a + ((q & 1) * 8 + r) * lda + k0 + (q >> 1) * 8);
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      if (2 * np >= nt0 && 2 * np < nt1) {
#pragma unroll
        for (int pl = 0; pl < kPlanes; ++pl) {
          const bf16* bp = b + pl * plane;
          uint32_t bf[4];
          if (kBTrans)
            ldsm_x4_t(bf, bp + (k0 + (q & 1) * 8 + r) * ldb + np * 16 +
                              (q >> 1) * 8);
          else
            ldsm_x4(bf, bp + (np * 16 + (q >> 1) * 8 + r) * ldb + k0 +
                            (q & 1) * 8);
          mma(acc[2 * np], af, bf[0], bf[1]);
          mma(acc[2 * np + 1], af, bf[2], bf[3]);
        }
      }
    }
  }
}

// the same product in float32 FMAs, the accumulator in the same layout (one
// plane: float32 operands are not split)
template <int NT, bool kATrans, bool kBTrans, int kPlanes = 1>
__device__ __forceinline__ void product(float (&acc)[NT][4], const float* a,
                                        int lda, const float* b, int ldb,
                                        int K, int nt0, int nt1, int = 0) {
  static_assert(kPlanes == 1, "float32 operands have one plane");
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  for (int k = 0; k < K; ++k) {
    const float a0 = kATrans ? a[k * lda + g] : a[g * lda + k];
    const float a1 = kATrans ? a[k * lda + g + 8] : a[(g + 8) * lda + k];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      if (nt >= nt0 && nt < nt1) {
        const int n = nt * 8 + 2 * t;
        float b0, b1;
        if (kBTrans) {
          const float2 v = load2(b + k * ldb + n);
          b0 = v.x;
          b1 = v.y;
        } else {
          b0 = b[n * ldb + k];
          b1 = b[(n + 1) * ldb + k];
        }
        acc[nt][0] = fmaf(a0, b0, acc[nt][0]);
        acc[nt][1] = fmaf(a0, b1, acc[nt][1]);
        acc[nt][2] = fmaf(a1, b0, acc[nt][2]);
        acc[nt][3] = fmaf(a1, b1, acc[nt][3]);
      }
    }
  }
}

// acc[8 tiles] += G[16 x 16] . X[16 x 64] for one warp: G the accumulator
// tiles 2kk and 2kk + 1 of a c x c tile in registers (gv = their 8 values),
// X the 16 rows x_rows of a shared-memory tile.  bfloat16: G split into hi
// and lo, two products on the tensor cores
__device__ __forceinline__ void diag_step(float (&acc)[8][4],
                                          const float (&gv)[8],
                                          const bf16* x_rows, int ldx) {
  uint32_t hi[4], lo[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const bf16 h0 = __float2bfloat16(gv[2 * i]);
    const bf16 h1 = __float2bfloat16(gv[2 * i + 1]);
    hi[i] = pack(h0, h1);
    lo[i] = pack(__float2bfloat16(gv[2 * i] - __bfloat162float(h0)),
                 __float2bfloat16(gv[2 * i + 1] - __bfloat162float(h1)));
  }
  const int lane = threadIdx.x & 31, q = lane >> 3, r = lane & 7;
#pragma unroll
  for (int np = 0; np < 4; ++np) {
    uint32_t bf[4];
    ldsm_x4_t(bf, x_rows + ((q & 1) * 8 + r) * ldx + np * 16 + (q >> 1) * 8);
    mma(acc[2 * np], hi, bf[0], bf[1]);
    mma(acc[2 * np], lo, bf[0], bf[1]);
    mma(acc[2 * np + 1], hi, bf[2], bf[3]);
    mma(acc[2 * np + 1], lo, bf[2], bf[3]);
  }
}

// float32: each G value goes to the lanes of its row by shuffle
__device__ __forceinline__ void diag_step(float (&acc)[8][4],
                                          const float (&gv)[8],
                                          const float* x_rows, int ldx) {
  const int lane = threadIdx.x & 31, t = lane & 3, row = lane & ~3;
#pragma unroll
  for (int half = 0; half < 2; ++half)
#pragma unroll
    for (int e = 0; e < 2; ++e)
#pragma unroll
      for (int tp = 0; tp < 4; ++tp) {
        const float a0 = __shfl_sync(0xffffffffu, gv[half * 4 + e], row | tp);
        const float a1 =
            __shfl_sync(0xffffffffu, gv[half * 4 + 2 + e], row | tp);
        const float* xr = x_rows + (half * 8 + 2 * tp + e) * ldx + 2 * t;
#pragma unroll
        for (int pn = 0; pn < 8; ++pn) {
          const float2 xv = load2(xr + pn * 8);
          acc[pn][0] = fmaf(a0, xv.x, acc[pn][0]);
          acc[pn][1] = fmaf(a0, xv.y, acc[pn][1]);
          acc[pn][2] = fmaf(a1, xv.x, acc[pn][2]);
          acc[pn][3] = fmaf(a1, xv.y, acc[pn][3]);
        }
      }
}

// acc[8] += T[16 x c] . X[c x 64] over the column blocks kk0 <= kk < kk1
// of a register tile T (NT tiles)
template <int NT, typename TX>
__device__ __forceinline__ void diag_product(float (&acc)[8][4],
                                             const float (&tile)[NT][4],
                                             const TX* x, int ldx, int kk0,
                                             int kk1) {
#pragma unroll
  for (int kk = 0; kk < NT / 2; ++kk) {
    if (kk < kk0 || kk >= kk1) continue;
    float gv[8];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      gv[e] = tile[2 * kk][e];
      gv[4 + e] = tile[2 * kk + 1][e];
    }
    diag_step(acc, gv, x + 16 * kk * ldx, ldx);
  }
}

// -- shared-memory plan ------------------------------------------------------

template <typename T>
struct Plan {
  static constexpr int C = Route<T>::kChunk;
  static constexpr int kWarps = C / 16;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int NT = C / 8;
  static constexpr int kSplits = Route<T>::kSplits;
  // pitch of x, dy and e dy rows and of a state slice's rows (P columns)
  static constexpr int kLdp = kPMax + Route<T>::kPad;
  // a state slice's planes: kSlice rows of the state, hi then lo (bf16)
  static constexpr int kSliceElems = kSplits * kSlice * kLdp;
  int n_cols, ldn;  // N padded to whole slices, and the B / C pitch
  __host__ __device__ explicit Plan(int N)
      : n_cols((N + kSlice - 1) / kSlice * kSlice),
        ldn((N + kSlice - 1) / kSlice * kSlice + Route<T>::kPad) {}
  // (c): two state slices, B, C, x, dy in T; dt, cum, d cum, ddt and a
  // reduction row per warp, two, in float32
  __host__ __device__ int chunk_bytes() const {
    return int(sizeof(T)) * (2 * kSliceElems + 2 * C * ldn + 2 * C * kLdp) +
           4 * (4 * C + 2 * kWarps);
  }
  // (a): e dy (split), C in T; dt and cum
  __host__ __device__ int dstate_bytes() const {
    return int(sizeof(T)) * (kSplits * C * kLdp + C * ldn) + 4 * 2 * C;
  }
};

// dt of head h for the chunk (zeros past S) into sDt and its running sum of
// dt A into sCum; every thread takes part, warp 0 scans
// the running sum of dt A over a chunk's sDt into sCum, by warp 0
template <int C>
__device__ __forceinline__ void scan_cum(float a, const float* sDt,
                                         float* sCum) {
  constexpr int E = C / 32;
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    float v[E];
    float run = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      run += sDt[lane * E + e] * a;
      v[e] = run;
    }
    float incl = run;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float u = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += u;
    }
    const float before = incl - run;
#pragma unroll
    for (int e = 0; e < E; ++e) sCum[lane * E + e] = v[e] + before;
  }
}

template <typename T>
__device__ void load_cum(const Params& p, int b, int h, int t0, int len,
                         float* sDt, float* sCum) {
  constexpr int C = Plan<T>::C;
  for (int j = threadIdx.x; j < C; j += blockDim.x)
    sDt[j] = j < len ? p.dt[b * p.sdt.b + h * p.sdt.h + (t0 + j) * p.sdt.s]
                     : 0.f;
  __syncthreads();
  scan_cum<C>(p.A[h], sDt, sCum);
  __syncthreads();
}

template <typename T>
__device__ __forceinline__ const T* at(const void* base, const Strides& s,
                                       int b, int h, int t) {
  return static_cast<const T*>(base) + b * s.b + h * s.h + t * s.s;
}

// v into a split operand: float32 as it is; bf16 hi = bf16(v) and, `plane`
// elements on, lo = bf16(v - hi), which keep v to about 2^-17
__device__ __forceinline__ void put_split(float* o, int, float v) { *o = v; }
__device__ __forceinline__ void put_split(bf16* o, int plane, float v) {
  const bf16 hi = __float2bfloat16(v);
  o[0] = hi;
  o[plane] = __float2bfloat16(v - __bfloat162float(hi));
}

// the value of a split operand
__device__ __forceinline__ float get_split(const float* o, int) {
  return *o;
}
__device__ __forceinline__ float get_split(const bf16* o, int plane) {
  return __bfloat162float(o[0]) + __bfloat162float(o[plane]);
}

// -- (a) each chunk's share of the state's gradient --------------------------

template <typename T>
__global__ void __launch_bounds__(Plan<T>::kThreads)
ssd_bwd_chunk_dstate(Params p) {
  using PL = Plan<T>;
  constexpr int C = PL::C, W = PL::kWarps, kLdp = PL::kLdp;
  const PL plan(p.N);
  const int k = blockIdx.x, b = blockIdx.z;
  const int h0 = blockIdx.y * kHeads, hn = min(kHeads, p.H - h0);
  const int t0 = k * C, len = min(C, p.S - t0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  extern __shared__ float4 smem4[];
  T* sEdy = reinterpret_cast<T*>(smem4);  // e_i dy_i [C x kLdp], hi, lo
  T* sC = sEdy + PL::kSplits * C * kLdp;
  float* sDt = reinterpret_cast<float*>(sC + C * plan.ldn);
  float* sCum = sDt + C;
  const int64_t np = int64_t(p.N) * p.P;

  for (int hh = 0; hh < hn; ++hh) {
    const int h = h0 + hh;
    if (hh == 0 || p.sc.h != 0)
      stage(sC, plan.ldn, at<T>(p.Cm, p.sc, b, h, t0), p.sc.s, C, len,
            plan.n_cols, p.N);
    load_cum<T>(p, b, h, t0, len, sDt, sCum);
    const T* dyb = at<T>(p.dy, p.sdy, b, h, t0);
    for (int i = threadIdx.x; i < C * kPMax; i += blockDim.x) {
      const int r = i / kPMax, c = i - r * kPMax;
      put_split(sEdy + r * kLdp + c, C * kLdp,
                (r < len && c < p.P)
                    ? clip_exp(sCum[r]) * to_f32(dyb[r * p.sdy.s + c])
                    : 0.f);
    }
    __syncthreads();
    // Q[n][p] = sum_i C[i][n] (e dy)[i][p]: warp w takes rows n of 16w,
    // 16(w + W), ...
    float* dst = p.gstate + ((int64_t(b) * p.H + h) * p.nc + k) * np;
    for (int mt = warp; mt * 16 < p.N; mt += W) {
      float acc[8][4] = {};
      product<8, true, true, PL::kSplits>(acc, sC + mt * 16, plan.ldn, sEdy,
                                          kLdp, C, 0, 8, C * kLdp);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int n = mt * 16 + g + (e >> 1) * 8;
          const int col = nt * 8 + 2 * tq + (e & 1);
          if (n < p.N && col < p.P) dst[int64_t(n) * p.P + col] = acc[nt][e];
        }
    }
    __syncthreads();  // before the next head's tiles
  }
}

// -- (b) the state's gradient passed backwards, serial in the chunk -------

__global__ void __launch_bounds__(kPassThreads)
ssd_bwd_state_pass(float* __restrict__ gstate, const float* __restrict__ decay,
                   const float* __restrict__ dh_final, int64_t total,
                   int64_t np, int nc) {
  const int64_t e = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= total) return;
  const int64_t bh = e / np, r = e - bh * np;
  float gv = dh_final ? dh_final[e] : 0.f;
  float* s = gstate + bh * nc * np + r;
  const float* d = decay + bh * nc;
  for (int k = nc - 1; k >= 0; --k) {
    const float q = s[k * np];
    s[k * np] = gv;
    gv = fmaf(d[k], gv, q);
  }
}

// -- (c) the chunks' gradients -----------------------------------------------

// a state slice (rows n0 .. n0 + kSlice of N, P columns) into shared
// memory as a split operand (bf16: hi and lo planes): the forward's h_{k-1}
// (its own planes, copied) or g_k (float32, split here)
template <typename T>
__device__ void stage_state(T* dst, const Params& p, const T* hprev,
                            const float* g, int64_t plane, int n0) {
  constexpr int kLdp = Plan<T>::kLdp, kPlane = kSlice * kLdp;
  for (int i = threadIdx.x; i < kSlice * kPMax; i += blockDim.x) {
    const int r = i / kPMax, c = i - r * kPMax, n = n0 + r;
    T* o = dst + r * kLdp + c;
    const bool live = n < p.N && c < p.P;
    const int64_t at = int64_t(n) * p.P + c;
    if (g || Route<T>::kSplits == 1) {
      float v = 0.f;
      if (live) v = g ? g[at] : to_f32(hprev[at]);
      put_split(o, kPlane, v);
    } else {
      o[0] = live ? hprev[at] : cvt<T>(0.f);
      o[kPlane] = live ? hprev[plane + at] : cvt<T>(0.f);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(Plan<T>::kThreads)
ssd_bwd_chunk(Params p) {
  using PL = Plan<T>;
  constexpr int C = PL::C, W = PL::kWarps, NT = PL::NT, kLdp = PL::kLdp;
  const PL plan(p.N);
  const int ldn = plan.ldn;
  const int k = blockIdx.x, b = blockIdx.z;
  const int h0 = blockIdx.y * kHeads, hn = min(kHeads, p.H - h0);
  const int t0 = k * C, len = min(C, p.S - t0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3, rb = warp;
  const int r0 = 16 * rb + g, r1 = r0 + 8;  // this lane's rows
  constexpr int kSplits = PL::kSplits, kPlane = kSlice * kLdp;
  extern __shared__ float4 smem4[];
  T* sS = reinterpret_cast<T*>(smem4);  // a state slice, split
  T* sS2 = sS + PL::kSliceElems;        // h_{k-1}'s (for d total)
  T* sB = sS2 + PL::kSliceElems;
  T* sC = sB + C * ldn;
  T* sX = sC + C * ldn;
  T* sDY = sX + C * kLdp;
  float* sDt = reinterpret_cast<float*>(sDY + C * kLdp);
  float* sCum = sDt + C;
  float* sDcum = sCum + C;
  float* sDdt = sDcum + C;
  float* sRed = sDdt + C;  // [2][W]
  const int64_t np = int64_t(p.N) * p.P;

  for (int hh = 0; hh < hn; ++hh) {
    const int h = h0 + hh;
    const int64_t bhk = (int64_t(b) * p.H + h) * p.nc + k;
    const T* hprev = static_cast<const T*>(p.hprev) + bhk * p.splits * np;
    const float* gk = p.gstate + bhk * np;
    if (hh == 0 || p.sb.h != 0)
      stage(sB, ldn, at<T>(p.Bm, p.sb, b, h, t0), p.sb.s, C, len,
            plan.n_cols, p.N);
    if (hh == 0 || p.sc.h != 0)
      stage(sC, ldn, at<T>(p.Cm, p.sc, b, h, t0), p.sc.s, C, len,
            plan.n_cols, p.N);
    stage(sX, kLdp, at<T>(p.x, p.sx, b, h, t0), p.sx.s, C, len, kPMax, p.P);
    stage(sDY, kLdp, at<T>(p.dy, p.sdy, b, h, t0), p.sdy.s, C, len, kPMax,
          p.P);
    load_cum<T>(p, b, h, t0, len, sDt, sCum);  // (its barriers cover both)
    const float total = sCum[C - 1];
    const float c0 = sCum[r0], c1 = sCum[r1];
    const float dt0 = sDt[r0], dt1 = sDt[r1];
    float dcum0 = 0.f, dcum1 = 0.f;  // d cum of rows r0, r1
    const int plane = p.one_group ? blockIdx.y : h;
    const bool first = !p.one_group || hh == 0;
    float* dCb = p.dC_part + (int64_t(b) * p.planes + plane) * p.S * p.N +
                 int64_t(t0) * p.N;
    float* dBb = p.dB_part + (int64_t(b) * p.planes + plane) * p.S * p.N +
                 int64_t(t0) * p.N;

    // -- rows as outputs i: dC, the carry-in's and L's share of d cum ------
    {
      float sc[NT][4] = {}, d[NT][4] = {};
      const int nt1 = 2 * rb + 2;  // the column tiles j <= i
      product<NT, false, false>(sc, sC + 16 * rb * ldn, ldn, sB, ldn,
                                plan.n_cols, 0, nt1);
      product<NT, false, false>(d, sDY + 16 * rb * kLdp, kLdp, sX, kLdp,
                                kPMax, 0, nt1);
      float m0 = 0.f, m1 = 0.f;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        if (nt >= nt1) continue;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e < 2 ? r0 : r1;
          const int j = nt * 8 + 2 * tq + (e & 1);
          const float v = (e < 2 ? c0 : c1) - sCum[j];
          const float dyu = sDt[j] * d[nt][e];  // dy_i . u_j
          const float L = j <= i ? clip_exp(v) : 0.f;
          const float m = clip_live(v) ? sc[nt][e] * dyu * L : 0.f;
          if (e < 2)
            m0 += m;
          else
            m1 += m;
          d[nt][e] = L * dyu;
        }
      }
      dcum0 += quad_sum(m0);
      dcum1 += quad_sum(m1);
      float de0 = 0.f, de1 = 0.f;  // C_i . (h dy_i)
      const float e0 = clip_exp(c0), e1 = clip_exp(c1);
      for (int ns = 0; ns < p.n_slices; ++ns) {
        const int n0 = ns * kSlice;
        stage_state<T>(sS, p, hprev, nullptr, np, n0);
        __syncthreads();
        float acc[8][4] = {}, dh[8][4] = {};
        diag_product<NT>(acc, d, sB + n0, ldn, 0, rb + 1);
        product<8, false, false, kSplits>(dh, sDY + 16 * rb * kLdp, kLdp, sS,
                                          kLdp, kPMax, 0, 8, kPlane);
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = e < 2 ? r0 : r1;
            const int n = n0 + nt * 8 + 2 * tq + (e & 1);
            const float cv = to_f32(sC[i * ldn + n]);  // 0 past N
            if (e < 2)
              de0 = fmaf(cv, dh[nt][e], de0);
            else
              de1 = fmaf(cv, dh[nt][e], de1);
            if (i < len && n < p.N) {
              const float v = acc[nt][e] + (e < 2 ? e0 : e1) * dh[nt][e];
              float* o = dCb + int64_t(i) * p.N + n;
              *o = first ? v : *o + v;
            }
          }
        __syncthreads();  // before the next slice
      }
      de0 = quad_sum(de0);
      de1 = quad_sum(de1);
      if (clip_live(c0)) dcum0 += e0 * de0;
      if (clip_live(c1)) dcum1 += e1 * de1;
    }

    // -- rows as inputs j: du, dB, the carry-out's and L's share of d cum --
    float du[8][4] = {};
    float dw0 = 0.f, dw1 = 0.f, dd = 0.f;
    {
      float sc[NT][4] = {}, d[NT][4] = {};
      const int nt0 = 2 * rb;  // the column tiles i >= j
      product<NT, false, false>(sc, sB + 16 * rb * ldn, ldn, sC, ldn,
                                plan.n_cols, nt0, NT);
      product<NT, false, false>(d, sX + 16 * rb * kLdp, kLdp, sDY, kLdp,
                                kPMax, nt0, NT);
      float m0 = 0.f, m1 = 0.f;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        if (nt < nt0) continue;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = e < 2 ? r0 : r1;
          const int i = nt * 8 + 2 * tq + (e & 1);
          const float v = sCum[i] - (e < 2 ? c0 : c1);
          const float dyu = (e < 2 ? dt0 : dt1) * d[nt][e];  // dy_i . u_j
          const float L = i >= j ? clip_exp(v) : 0.f;
          const float m = clip_live(v) ? sc[nt][e] * dyu * L : 0.f;
          if (e < 2)
            m0 += m;
          else
            m1 += m;
          sc[nt][e] *= L;
          d[nt][e] = L * dyu;
        }
      }
      dcum0 -= quad_sum(m0);
      dcum1 -= quad_sum(m1);
      diag_product<NT>(du, sc, sDY, kLdp, rb, NT / 2);
      const float w0 = clip_exp(total - c0), w1 = clip_exp(total - c1);
      for (int ns = 0; ns < p.n_slices; ++ns) {
        const int n0 = ns * kSlice;
        stage_state<T>(sS, p, hprev, gk, np, n0);
        stage_state<T>(sS2, p, hprev, nullptr, np, n0);
        __syncthreads();
        for (int i = threadIdx.x; i < kSlice * kPMax; i += blockDim.x) {
          const int at = (i / kPMax) * kLdp + i % kPMax;
          dd = fmaf(get_split(sS + at, kPlane), get_split(sS2 + at, kPlane),
                    dd);  // h_{k-1} . g_k
        }
        {
          float acc[8][4] = {}, xg[8][4] = {};
          diag_product<NT>(acc, d, sC + n0, ldn, rb, NT / 2);
          product<8, false, false, kSplits>(xg, sX + 16 * rb * kLdp, kLdp,
                                            sS, kLdp, kPMax, 0, 8, kPlane);
#pragma unroll
          for (int nt = 0; nt < 8; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int j = e < 2 ? r0 : r1;
              const int n = n0 + nt * 8 + 2 * tq + (e & 1);
              if (j < len && n < p.N) {
                const float v =
                    acc[nt][e] + (e < 2 ? w0 * dt0 : w1 * dt1) * xg[nt][e];
                float* o = dBb + int64_t(j) * p.N + n;
                *o = first ? v : *o + v;
              }
            }
        }
        {
          float bg[8][4] = {};  // B_j . g_k[:, p] over the slice's rows
          product<8, false, true, kSplits>(bg, sB + 16 * rb * ldn + n0, ldn,
                                           sS, kLdp, kSlice, 0, 8, kPlane);
#pragma unroll
          for (int nt = 0; nt < 8; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int j = e < 2 ? r0 : r1;
              const int col = nt * 8 + 2 * tq + (e & 1);
              const float xv = to_f32(sX[j * kLdp + col]);  // 0 past P
              du[nt][e] = fmaf(e < 2 ? w0 : w1, bg[nt][e], du[nt][e]);
              if (e < 2)
                dw0 = fmaf(bg[nt][e], xv, dw0);
              else
                dw1 = fmaf(bg[nt][e], xv, dw1);
            }
        }
        __syncthreads();  // before the next slice
      }
      // dw_j = (g_k^T B_j) . u_j; its share goes to d cum_j and to total
      dw0 = quad_sum(dw0) * dt0;
      dw1 = quad_sum(dw1) * dt1;
      dw0 = clip_live(total - c0) ? w0 * dw0 : 0.f;
      dw1 = clip_live(total - c1) ? w1 * dw1 : 0.f;
      dcum0 -= dw0;
      dcum1 -= dw1;
    }

    // dx = du dt; ddt's share du . x; the rows' d cum into shared memory
    float dx0 = 0.f, dx1 = 0.f;
    {
      T* dxb = static_cast<T*>(p.dx) + b * p.sdx.b + h * p.sdx.h +
               t0 * p.sdx.s;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = e < 2 ? r0 : r1;
          const int col = nt * 8 + 2 * tq + (e & 1);
          const float xv = to_f32(sX[j * kLdp + col]);
          if (e < 2)
            dx0 = fmaf(du[nt][e], xv, dx0);
          else
            dx1 = fmaf(du[nt][e], xv, dx1);
          if (j < len && col < p.P)
            dxb[j * p.sdx.s + col] = cvt<T>(du[nt][e] * (e < 2 ? dt0 : dt1));
        }
    }
    dx0 = quad_sum(dx0);
    dx1 = quad_sum(dx1);
    dd = warp_sum(dd);
    const float wsum = warp_sum(tq == 0 ? dw0 + dw1 : 0.f);
    if (tq == 0) {
      sDcum[r0] = dcum0;
      sDcum[r1] = dcum1;
      sDdt[r0] = dx0;
      sDdt[r1] = dx1;
    }
    if (lane == 0) {
      sRed[warp] = wsum;
      sRed[W + warp] = dd;
    }
    __syncthreads();
    // d total = the carry-out's share + exp(total)'s; d(dt A) is the
    // reverse running sum of d cum inside the chunk
    if (warp == 0) {
      constexpr int E = C / 32;
      float tot = 0.f, ddec = 0.f;
      for (int w = 0; w < W; ++w) {
        tot += sRed[w];
        ddec += sRed[W + w];
      }
      if (clip_live(total)) tot += clip_exp(total) * ddec;
      float v[E];
      float run = 0.f;
#pragma unroll
      for (int e = E - 1; e >= 0; --e) {
        float dc = sDcum[lane * E + e];
        if (lane * E + e == C - 1) dc += tot;
        run += dc;
        v[e] = run;
      }
      float incl = run;  // suffix sums over the lanes above
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float u = __shfl_down_sync(0xffffffffu, incl, off);
        if (lane + off < 32) incl += u;
      }
      const float after = incl - run;
      const float a = p.A[h];
      float dA = 0.f;
      float* ddtb = p.ddt + b * p.sddt.b + h * p.sddt.h + t0 * p.sddt.s;
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const int j = lane * E + e;
        const float da = v[e] + after;
        dA = fmaf(da, sDt[j], dA);
        if (j < len) ddtb[j * p.sddt.s] = fmaf(da, a, sDdt[j]);
      }
      dA = warp_sum(dA);
      if (lane == 0) p.dA_part[bhk] = dA;
    }
    __syncthreads();  // before the next head's tiles
  }
}

// -- the tensor-core route: (b) and (c) for bfloat16, one B/C group --------

// (b) as ssd_bwd_state_pass, four state elements a thread, each g_k written
// as bf16 hi and lo planes [B, H, nc, 2, N, P] (the layout of the forward's
// h_{k-1}, which TMA loads whole) instead of over Q_k; the Q_k and decays
// of a group of U chunks are loaded before the group's chain, so the walk
// does not wait on each load in turn.  It also takes d total's h_{k-1} .
// g_k, per warp (32 x 4 state elements of one batch and head, N P a
// multiple of 128) into hg_part [B H, nc, N P / 128], which pass (c) sums in
// a fixed order.
__global__ void __launch_bounds__(kPassThreads)
ssd_bwd_state_pass_split(const float* __restrict__ qstate,
                         bf16* __restrict__ gsplit,
                         const float* __restrict__ decay,
                         const float* __restrict__ dh_final,
                         const bf16* __restrict__ hprev,
                         float* __restrict__ hg_part, int64_t total4,
                         int64_t np4, int nc) {
  const int64_t e = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= total4) return;  // whole warps: total4 is a multiple of 32
  const int64_t bh = e / np4, r = e - bh * np4, plane = 4 * np4;
  const int64_t warps = np4 / 32, w = r / 32;
  float4 gv = dh_final ? reinterpret_cast<const float4*>(dh_final)[e]
                       : make_float4(0.f, 0.f, 0.f, 0.f);
  const float4* q = reinterpret_cast<const float4*>(qstate) + bh * nc * np4 +
                    r;
  bf16* o = gsplit + bh * nc * 2 * plane + 4 * r;
  const bf16* hp = hprev + bh * nc * 2 * plane + 4 * r;
  const float* d = decay + bh * nc;
  float* hg = hg_part + bh * nc * warps + w;
  constexpr int U = 8;
  float4 v[U];
  float f[U];
  for (int k0 = nc - 1; k0 >= 0; k0 -= U) {
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (k0 - u >= 0) {
        v[u] = q[int64_t(k0 - u) * np4];
        f[u] = d[k0 - u];
      }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int k = k0 - u;
      if (k < 0) break;
      const float g4[4] = {gv.x, gv.y, gv.z, gv.w};
      const int64_t at = int64_t(k) * 2 * plane;
      const uint2 h_hi = *reinterpret_cast<const uint2*>(hp + at);
      const uint2 h_lo = *reinterpret_cast<const uint2*>(hp + at + plane);
      const bf16* hh = reinterpret_cast<const bf16*>(&h_hi);
      const bf16* hl = reinterpret_cast<const bf16*>(&h_lo);
      __align__(8) bf16 hi[4], lo[4];
      float dot = 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        hi[i] = __float2bfloat16(g4[i]);
        lo[i] = __float2bfloat16(g4[i] - __bfloat162float(hi[i]));
        dot = fmaf(__bfloat162float(hh[i]) + __bfloat162float(hl[i]),
                   g4[i], dot);
      }
      *reinterpret_cast<uint2*>(o + at) = *reinterpret_cast<const uint2*>(hi);
      *reinterpret_cast<uint2*>(o + at + plane) =
          *reinterpret_cast<const uint2*>(lo);
      dot = warp_sum(dot);
      if ((threadIdx.x & 31) == 0) hg[int64_t(k) * warps] = dot;
      gv = make_float4(fmaf(f[u], gv.x, v[u].x), fmaf(f[u], gv.y, v[u].y),
                       fmaf(f[u], gv.z, v[u].z), fmaf(f[u], gv.w, v[u].w));
    }
  }
}

namespace wg {

constexpr int C = 128;          // the bf16 chunk
constexpr int kThreads = 256;   // two warpgroups of 64 rows
constexpr int kTile = C * 128;  // 128 rows of 128 bytes (64 bf16)
// the forward's score tiles a block keeps: row block rb's column tiles nt <
// 2 rb + 2 (those up to the diagonal), 512 bytes each, rb after rb
constexpr int kScoreTiles = 72;
__host__ __device__ constexpr int tiles_before(int rb) { return rb * (rb + 1); }
// shared memory, 1,024-byte aligned regions: B and C (two 64-column blocks
// each), x and dy (two stages), one state (h_{k-1}, then g_k: hi and lo
// planes), then the score tiles
constexpr int kB = 0, kC = 2 * kTile, kX = 4 * kTile, kDY = 6 * kTile,
              kSt = 8 * kTile, kScores = 10 * kTile,
              kBytes = kScores + kScoreTiles * 512;
constexpr int kAlloc = kBytes + 1024;

__device__ __forceinline__ uint8_t* align_1024(uint8_t* p) {
  return p + ((1024 - (hopper::smem_u32(p) & 1023)) & 1023);
}

// element (row, col) of a 128-byte swizzled tile of 64-column blocks
// `block` bytes apart (TMA's CU_TENSOR_MAP_SWIZZLE_128B)
__device__ __forceinline__ float sw_at(const uint8_t* tile, int block,
                                       int row, int col) {
  const int c = col & 63;
  const int off = (col >> 6) * block + row * 128 +
                  ((((c >> 3) ^ (row & 7)) << 4) | ((c & 7) << 1));
  return __bfloat162float(*reinterpret_cast<const bf16*>(tile + off));
}

// K-major operand: rows from `addr` (a multiple of 8 rows in), 16 columns
// at k step kk of a 64-column block
__device__ __forceinline__ uint64_t kdesc(uint32_t addr, int kk) {
  return hopper::sw128_desc(addr + (kk & 3) * 32, 16, 1024);
}
// MN-major (transposed) B operand: k step t is rows 16t.. of a tile whose
// 64-column blocks lie kTile bytes apart
__device__ __forceinline__ uint64_t tdesc(uint32_t addr, int t) {
  return hopper::sw128_desc(addr + t * 2048, kTile, 1024);
}

template <int N>
__device__ __forceinline__ void zero(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) d[i] = 0.f;
}

// a 64 x 128 accumulator as eight k steps of wgmma's register A operand,
// each value split into bf16 hi and lo (x = hi + lo to about 2^-17)
__device__ __forceinline__ void split(const float (&x)[64],
                                      uint32_t (&hi)[8][4],
                                      uint32_t (&lo)[8][4]) {
#pragma unroll
  for (int c = 0; c < 8; ++c)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float x0 = x[8 * c + 2 * i], x1 = x[8 * c + 2 * i + 1];
      const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
      const __nv_bfloat162 l = __floats2bfloat162_rn(x0 - __low2float(h),
                                                     x1 - __high2float(h));
      hi[c][i] = *reinterpret_cast<const uint32_t*>(&h);
      lo[c][i] = *reinterpret_cast<const uint32_t*>(&l);
    }
}

// a 64 x 128 accumulator's rows r0 and r0 + 8 (columns 8c + 2tq + {0, 1})
// into a float32 [rows][N]
__device__ __forceinline__ void store_part(float* out, int N, int len, int r0,
                                           int tq, const float (&acc)[64]) {
#pragma unroll
  for (int e = 0; e < 64; e += 2) {
    const int i = (e & 2) ? r0 + 8 : r0;
    const int n = 8 * (e >> 2) + 2 * tq;
    if (i < len && n < N)
      *reinterpret_cast<float2*>(out + int64_t(i) * N + n) =
          make_float2(acc[e], acc[e + 1]);
  }
}

}  // namespace wg

// (a) on the tensor cores: one block per (chunk, group of heads, batch), two
// warpgroups (warpgroup w owns state rows 64w..64w+63); C arrives once per
// block by TMA, each head's dy through two stages.  Per head the block
// writes e_i dy_i split into bf16 hi and lo planes in the swizzled layout
// the dy tile arrived in (a 16-byte chunk's row, so its e_i, follows from
// its offset), and Q_k = C^T (e dy) runs as wgmma with both operands
// transposed (C^T from the C tile, e dy as [chunk rows x P]).
__global__ void __launch_bounds__(wg::kThreads, 2)
ssd_bwd_dstate_wgmma(const __grid_constant__ CUtensorMap tm_c,
                     const __grid_constant__ CUtensorMap tm_dy, int hpb,
                     Params p) {
  using namespace wg;
  using hopper::fence_regs;
  using hopper::mbar_wait;
  using hopper::smem_u32;
  extern __shared__ uint8_t smem_raw[];
  __shared__ uint64_t bar_c, bar_dy[2];
  __shared__ float sDt[C], sCum[C];
  uint8_t* base = align_1024(smem_raw);
  uint8_t* sC = base;                 // 2 column blocks
  uint8_t* sDY = base + 2 * kTile;    // 2 stages
  uint8_t* sE = base + 4 * kTile;     // hi, lo planes
  const uint32_t c_addr = smem_u32(sC), e_addr = smem_u32(sE);
  const int k = blockIdx.x, b = blockIdx.z;
  const int h0 = blockIdx.y * hpb, hn = min(hpb, p.H - h0);
  const int t0 = k * C, len = min(C, p.S - t0);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wgi = warp >> 2, g = lane >> 2, tq = lane & 3;
  const int n0 = 16 * warp + g;  // this thread's state rows n0, n0 + 8
  const int64_t np = int64_t(p.N) * p.P;

  if (tid == 0) {
    hopper::mbar_init(&bar_c, 1);
    hopper::mbar_init(&bar_dy[0], 1);
    hopper::mbar_init(&bar_dy[1], 1);
    hopper::mbar_init_fence();
  }
  __syncthreads();
  auto load_dy = [&](int hh) {
    const int st = hh & 1;
    hopper::mbar_expect_tx(&bar_dy[st], kTile);
    hopper::tma_load_4d(sDY + st * kTile, &tm_dy, &bar_dy[st], 0, t0,
                        h0 + hh, b);
  };
  if (tid == 0) {
    hopper::mbar_expect_tx(&bar_c, 2 * kTile);
    hopper::tma_load_3d(sC, &tm_c, &bar_c, 0, t0, b);
    hopper::tma_load_3d(sC + kTile, &tm_c, &bar_c, 64, t0, b);
    load_dy(0);
    if (hn > 1) load_dy(1);
  }
  const float* dtb = p.dt + b * p.sdt.b + t0 * p.sdt.s;
  float dt_next = tid < len ? dtb[h0 * p.sdt.h + tid * p.sdt.s] : 0.f;
  mbar_wait(&bar_c, 0);

  for (int hh = 0; hh < hn; ++hh) {
    const int h = h0 + hh, st = hh & 1;
    if (tid < C) sDt[tid] = dt_next;
    if (hh + 1 < hn)
      dt_next = tid < len ? dtb[(h + 1) * p.sdt.h + tid * p.sdt.s] : 0.f;
    __syncthreads();
    scan_cum<C>(p.A[h], sDt, sCum);
    __syncthreads();
    mbar_wait(&bar_dy[st], (hh >> 1) & 1);
    // e_i dy_i, split, chunk by chunk of 8 values (zeros past S and P
    // stay zero)
    const uint8_t* dy = sDY + st * kTile;
#pragma unroll
    for (int u = 0; u < kTile / 16 / kThreads; ++u) {
      const int off = (tid + u * kThreads) * 16;
      const float e = clip_exp(sCum[off >> 7]);
      const uint4 raw = *reinterpret_cast<const uint4*>(dy + off);
      const __nv_bfloat162* v2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
      uint4 hi4, lo4;
      uint32_t* hw = reinterpret_cast<uint32_t*>(&hi4);
      uint32_t* lw = reinterpret_cast<uint32_t*>(&lo4);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 f = __bfloat1622float2(v2[i]);
        const float x0 = e * f.x, x1 = e * f.y;
        const __nv_bfloat162 hv = __floats2bfloat162_rn(x0, x1);
        const __nv_bfloat162 lv = __floats2bfloat162_rn(
            x0 - __low2float(hv), x1 - __high2float(hv));
        hw[i] = *reinterpret_cast<const uint32_t*>(&hv);
        lw[i] = *reinterpret_cast<const uint32_t*>(&lv);
      }
      *reinterpret_cast<uint4*>(sE + off) = hi4;
      *reinterpret_cast<uint4*>(sE + kTile + off) = lo4;
    }
    hopper::fence_proxy_async();
    __syncthreads();  // e dy written; this stage's dy read
    if (tid == 0 && hh + 2 < hn) load_dy(hh + 2);
    float acc[32];
    zero(acc);
    fence_regs(acc);
    hopper::wgmma_fence();
#pragma unroll
    for (int pl = 0; pl < 2; ++pl)
#pragma unroll
      for (int t = 0; t < 8; ++t)
        hopper::wgmma_ss_n64_tt(acc, tdesc(c_addr + wgi * kTile, t),
                                tdesc(e_addr + pl * kTile, t), 1);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    fence_regs(acc);
    float* dst = p.gstate + ((int64_t(b) * p.H + h) * p.nc + k) * np;
#pragma unroll
    for (int e = 0; e < 32; e += 2) {
      const int n = (e & 2) ? n0 + 8 : n0;
      const int col = 8 * (e >> 2) + 2 * tq;
      if (n < p.N && col < p.P)
        *reinterpret_cast<float2*>(dst + int64_t(n) * p.P + col) =
            make_float2(acc[e], acc[e + 1]);
    }
    __syncthreads();  // the products read e dy before the next head's
  }
}

// (c) on the tensor cores: one block per (chunk, group of hpb heads, batch),
// two consumer warpgroups (warpgroup w owns rows 64w..64w+63 of the chunk,
// warp v of the block rows 16v..16v+15, the row block of the forward's
// score tiles) and no producer: thread 0 issues the TMA loads.  Once per
// block: B and C, and the forward's score tiles C B^T of the chunk up to
// the diagonal (bulk copies of the forward's workspace, in the layout its
// warps wrote: row block, column tile, lane), which every head reads from
// shared memory in both layouts.  Per head: x and dy through two stages
// (the next head's while this head's products run), and one state buffer
// that holds h_{k-1} until the first product has read it, then g_k (loaded
// while the rest of the rows-as-outputs half runs), then the next head's
// h_{k-1}.  Every product is a wgmma m64nN k16 chain with float32 sums: x,
// dy, B, C as they are, the float32 operands split into bf16 hi and lo
// (h_{k-1} and g_k as planes, the register tiles L o (dy u^T) and L o C B^T
// in registers).  dB and dC go to one float32 plane per head (stores only).
__global__ void __launch_bounds__(wg::kThreads, 1)
ssd_bwd_chunk_wgmma(const __grid_constant__ CUtensorMap tm_b,
                    const __grid_constant__ CUtensorMap tm_c,
                    const __grid_constant__ CUtensorMap tm_x,
                    const __grid_constant__ CUtensorMap tm_dy,
                    const __grid_constant__ CUtensorMap tm_h,
                    const __grid_constant__ CUtensorMap tm_g,
                    const float* __restrict__ hg_part, int hg_parts,
                    Params p) {
  using namespace wg;
  using hopper::fence_regs;
  using hopper::mbar_wait;
  using hopper::smem_u32;
  using hopper::wgmma_commit;
  using hopper::wgmma_fence;
  using hopper::wgmma_wait;
  extern __shared__ uint8_t smem_raw[];
  __shared__ uint64_t bar_bc, bar_xd[2], bar_st;
  __shared__ float sDt[C], sCum[C], sDcum[C], sDdt[C], sRed[8];
  uint8_t* base = align_1024(smem_raw);
  uint8_t* sB = base + kB;
  uint8_t* sC = base + kC;
  uint8_t* sSt = base + kSt;
  const float* sS = reinterpret_cast<const float*>(base + kScores);
  const uint32_t b_addr = smem_u32(sB), c_addr = smem_u32(sC),
                 st_addr = smem_u32(sSt);

  const int k = blockIdx.x, b = blockIdx.z;
  const int h0 = blockIdx.y * p.hpb, hn = min(p.hpb, p.H - h0);
  const int t0 = k * C, len = min(C, p.S - t0);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wgi = warp >> 2;  // warpgroup
  const int g = lane >> 2, tq = lane & 3;
  const int r0 = 16 * warp + g, r1 = r0 + 8;  // this thread's rows
  const uint32_t own = wgi * 64 * 128;        // the warpgroup's rows

  if (tid == 0) {
    hopper::mbar_init(&bar_bc, 1);
    hopper::mbar_init(&bar_xd[0], 1);
    hopper::mbar_init(&bar_xd[1], 1);
    hopper::mbar_init(&bar_st, 1);
    hopper::mbar_init_fence();
  }
  __syncthreads();
  // thread 0's loads: x and dy of head hh into stage hh % 2; a state's
  // (h_{k-1} or g_k) two planes.  The state buffer completes its phases in
  // the order h(0), g(0), h(1), ...: h at parity 0, g at parity 1.
  auto load_xd = [&](int hh) {
    const int st = hh & 1;
    hopper::mbar_expect_tx(&bar_xd[st], 2 * kTile);
    hopper::tma_load_4d(base + kX + st * kTile, &tm_x, &bar_xd[st], 0, t0,
                        h0 + hh, b);
    hopper::tma_load_4d(base + kDY + st * kTile, &tm_dy, &bar_xd[st], 0, t0,
                        h0 + hh, b);
  };
  auto load_state = [&](const CUtensorMap* m, int hh) {
    const int z = int(2 * ((int64_t(b) * p.H + h0 + hh) * p.nc + k));
    hopper::mbar_expect_tx(&bar_st, 2 * kTile);
    hopper::tma_load_3d(sSt, m, &bar_st, 0, 0, z);
    hopper::tma_load_3d(sSt + kTile, m, &bar_st, 0, 0, z + 1);
  };
  if (tid == 0) {
    const uint8_t* tiles = reinterpret_cast<const uint8_t*>(p.scores) +
                           (int64_t(b) * p.nc + k) * 8 * 16 * 512;
    hopper::mbar_expect_tx(&bar_bc, 4 * kTile + kScoreTiles * 512);
    hopper::tma_load_3d(sB, &tm_b, &bar_bc, 0, t0, b);
    hopper::tma_load_3d(sB + kTile, &tm_b, &bar_bc, 64, t0, b);
    hopper::tma_load_3d(sC, &tm_c, &bar_bc, 0, t0, b);
    hopper::tma_load_3d(sC + kTile, &tm_c, &bar_bc, 64, t0, b);
    for (int rb = 0; rb < 8; ++rb)
      hopper::bulk_load(base + kScores + tiles_before(rb) * 512,
                        tiles + rb * 16 * 512, (2 * rb + 2) * 512, &bar_bc);
    load_xd(0);
    if (hn > 1) load_xd(1);
    load_state(&tm_h, 0);
  }
  // S[i][j] for rows j = r0, r1 (q / 2) and column tile t of i (t >= 2
  // warp): row block i / 16, column tile j / 8, lane 4 (i % 8) + (j % 8) /
  // 2, element 2 ((i / 8) % 2) + j % 2
  auto score_t = [&](int t, int q) {
    return sS[(tiles_before(t >> 1) + 2 * warp + (q >> 1)) * 128 +
              (4 * (2 * tq + (q & 1)) + (g >> 1)) * 4 + 2 * (t & 1) +
              (g & 1)];
  };
  const float4* my_scores =
      reinterpret_cast<const float4*>(sS) + tiles_before(warp) * 32 + lane;
  const float* dtb = p.dt + b * p.sdt.b + t0 * p.sdt.s;
  float dt_next = tid < len ? dtb[h0 * p.sdt.h + tid * p.sdt.s] : 0.f;
  mbar_wait(&bar_bc, 0);

  for (int hh = 0; hh < hn; ++hh) {
    const int h = h0 + hh, st = hh & 1;
    const int64_t bhk = (int64_t(b) * p.H + h) * p.nc + k;
    uint8_t* sX = base + kX + st * kTile;
    const uint32_t x_addr = smem_u32(sX);
    const uint32_t dy_addr = smem_u32(base + kDY + st * kTile);
    // this head's dB and dC, each in a plane of its own (stores only: an
    // update of one plane per block over its heads made every head wait
    // on its loads)
    float* dCb = p.dC_part + (int64_t(b) * p.H + h) * p.S * p.N +
                 int64_t(t0) * p.N;
    float* dBb = p.dB_part + (int64_t(b) * p.H + h) * p.S * p.N +
                 int64_t(t0) * p.N;
    // this head's dt (loaded during the last head) and running sum; the
    // next head's dt on its way
    if (tid < C) sDt[tid] = dt_next;
    if (hh + 1 < hn)
      dt_next = tid < len ? dtb[(h + 1) * p.sdt.h + tid * p.sdt.s] : 0.f;
    __syncthreads();
    scan_cum<C>(p.A[h], sDt, sCum);
    __syncthreads();
    const float total = sCum[C - 1];
    const float c0 = sCum[r0], c1 = sCum[r1];
    const float dt0 = sDt[r0], dt1 = sDt[r1];
    float dcum0 = 0.f, dcum1 = 0.f;  // d cum of rows r0, r1
    // h_{k-1} . g_k from pass (b)'s partials, warp 0's lanes each summing
    // theirs in a fixed order (loaded now, added up in the tail)
    float hg_lane = 0.f;
    if (warp == 0)
      for (int i = lane; i < hg_parts; i += 32)
        hg_lane += hg_part[bhk * hg_parts + i];
    mbar_wait(&bar_xd[st], (hh >> 1) & 1);
    mbar_wait(&bar_st, 0);  // h_{k-1}

    // -- rows as outputs i: dC, the carry-in's and L's share of d cum ----
    {
      const float e0 = clip_exp(c0), e1 = clip_exp(c1);
      float acc[64];  // dy h^T, then dC
      float d[64];    // dy_i . x_j, then L o (dy u^T)
      zero(acc);
      zero(d);
      fence_regs(acc);
      fence_regs(d);
      wgmma_fence();
#pragma unroll
      for (int pl = 0; pl < 2; ++pl)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          hopper::wgmma_ss_n128(acc, kdesc(dy_addr + own, kk),
                                kdesc(st_addr + pl * kTile, kk), 1);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        hopper::wgmma_ss_n128(d, kdesc(dy_addr + own, kk),
                              kdesc(x_addr, kk), 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      fence_regs(d);
      __syncthreads();  // every product that reads h_{k-1} is done
      if (tid == 0) load_state(&tm_g, hh);
      float de0 = 0.f, de1 = 0.f;  // C_i . (h dy_i)
#pragma unroll
      for (int e = 0; e < 64; ++e) {
        const int n = 8 * (e >> 2) + 2 * tq + (e & 1);
        const float cv = sw_at(sC, kTile, (e & 2) ? r1 : r0, n);  // 0 past N
        if (e & 2)
          de1 = fmaf(cv, acc[e], de1);
        else
          de0 = fmaf(cv, acc[e], de0);
        acc[e] *= (e & 2) ? e1 : e0;
      }
      de0 = quad_sum(de0);
      de1 = quad_sum(de1);
      if (clip_live(c0)) dcum0 += e0 * de0;
      if (clip_live(c1)) dcum1 += e1 * de1;

      float m0 = 0.f, m1 = 0.f;
#pragma unroll
      for (int t = 0; t < 16; ++t) {
        if (t < 2 * warp + 2) {  // the column tiles j <= i
          const float4 sv = my_scores[t * 32];
          const float s4[4] = {sv.x, sv.y, sv.z, sv.w};
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int e = 4 * t + q;
            const int i = (q & 2) ? r1 : r0;
            const int j = 8 * t + 2 * tq + (q & 1);
            const float v = ((q & 2) ? c1 : c0) - sCum[j];
            const float dyu = sDt[j] * d[e];
            const bool live = j <= i;
            const float L = live ? clip_exp(v) : 0.f;
            const float m = live && clip_live(v) ? s4[q] * dyu * L : 0.f;
            if (q & 2)
              m1 += m;
            else
              m0 += m;
            d[e] = L * dyu;
          }
        } else {
#pragma unroll
          for (int q = 0; q < 4; ++q) d[4 * t + q] = 0.f;
        }
      }
      dcum0 += quad_sum(m0);
      dcum1 += quad_sum(m1);
      uint32_t hi[8][4], lo[8][4];
      split(d, hi, lo);
      // dC = e (h dy) + (L o dy u^T) B; every column step, those past the
      // warpgroup's rows adding zeros (a step skipped in one warpgroup only
      // would make ptxas serialize the products)
      fence_regs(acc);
      hopper::fence_regs(hi);
      hopper::fence_regs(lo);
      wgmma_fence();
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        hopper::wgmma_rs_n128(acc, hi[t], tdesc(b_addr, t));
        hopper::wgmma_rs_n128(acc, lo[t], tdesc(b_addr, t));
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      hopper::fence_regs(hi);
      hopper::fence_regs(lo);
      store_part(dCb, p.N, len, r0, tq, acc);
    }

    // -- rows as inputs j: dB, du, the carry-out's and L's share of d cum --
    // (dB first, then du with L o C B^T built again from the score tiles, so
    // that no two 64 x 128 register tiles of this half are live at once)
    const float w0 = clip_exp(total - c0), w1 = clip_exp(total - c1);
    float dx0 = 0.f, dx1 = 0.f, dw0 = 0.f, dw1 = 0.f;
    mbar_wait(&bar_st, 1);  // g_k
    {
      float d[64];    // x_j . dy_i, then L o (dy u^T) transposed
      float acc[64];  // x_j . g_k^T, then dB
      zero(d);
      zero(acc);
      fence_regs(d);
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        hopper::wgmma_ss_n128(d, kdesc(x_addr + own, kk),
                              kdesc(dy_addr, kk), 1);
      wgmma_fence();
#pragma unroll
      for (int pl = 0; pl < 2; ++pl)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          hopper::wgmma_ss_n128(acc, kdesc(x_addr + own, kk),
                                kdesc(st_addr + pl * kTile, kk), 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(d);
      fence_regs(acc);
      float m0 = 0.f, m1 = 0.f;
#pragma unroll
      for (int t = 0; t < 16; ++t) {
        if (t >= 2 * warp) {  // the column tiles i >= j
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int e = 4 * t + q;
            const int j = (q & 2) ? r1 : r0;
            const int i = 8 * t + 2 * tq + (q & 1);
            const float v = sCum[i] - ((q & 2) ? c1 : c0);
            const float dyu = ((q & 2) ? dt1 : dt0) * d[e];
            const bool live = i >= j;
            const float L = live ? clip_exp(v) : 0.f;
            const float m =
                live && clip_live(v) ? score_t(t, q) * dyu * L : 0.f;
            if (q & 2)
              m1 += m;
            else
              m0 += m;
            d[e] = L * dyu;
          }
        } else {
#pragma unroll
          for (int q = 0; q < 4; ++q) d[4 * t + q] = 0.f;
        }
      }
      dcum0 -= quad_sum(m0);
      dcum1 -= quad_sum(m1);
      uint32_t hi[8][4], lo[8][4];
      split(d, hi, lo);

      // dB = w dt (x g^T) + (L o dy u^T)^T C (zeros in the row steps i < j)
      const float s0 = w0 * dt0, s1 = w1 * dt1;
#pragma unroll
      for (int e = 0; e < 64; ++e) acc[e] *= (e & 2) ? s1 : s0;
      fence_regs(acc);
      hopper::fence_regs(hi);
      hopper::fence_regs(lo);
      wgmma_fence();
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        hopper::wgmma_rs_n128(acc, hi[t], tdesc(c_addr, t));
        hopper::wgmma_rs_n128(acc, lo[t], tdesc(c_addr, t));
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      hopper::fence_regs(hi);
      hopper::fence_regs(lo);
      store_part(dBb, p.N, len, r0, tq, acc);
    }
    {
      float du[32];
      float bg[32];  // B_j . g_k[:, p]
      {
        // L o C B^T transposed (rows j, columns i), split
        uint32_t hi[8][4], lo[8][4];
#pragma unroll
        for (int t = 0; t < 16; ++t)
#pragma unroll
          for (int q = 0; q < 4; q += 2) {
            float v2[2];
#pragma unroll
            for (int c = 0; c < 2; ++c) {
              const int qq = q + c;
              const int j = (qq & 2) ? r1 : r0;
              const int i = 8 * t + 2 * tq + c;
              const bool live = t >= 2 * warp && i >= j;
              v2[c] = live ? score_t(t, qq) *
                                 clip_exp(sCum[i] - ((qq & 2) ? c1 : c0))
                           : 0.f;
            }
            // element e = 4t + q of the tile: k step t / 2, pair
            // (t % 2) * 2 + q / 2
            const __nv_bfloat162 hv = __floats2bfloat162_rn(v2[0], v2[1]);
            const __nv_bfloat162 lv = __floats2bfloat162_rn(
                v2[0] - __low2float(hv), v2[1] - __high2float(hv));
            hi[t >> 1][(t & 1) * 2 + (q >> 1)] =
                *reinterpret_cast<const uint32_t*>(&hv);
            lo[t >> 1][(t & 1) * 2 + (q >> 1)] =
                *reinterpret_cast<const uint32_t*>(&lv);
          }
        zero(du);
        zero(bg);
        fence_regs(du);
        fence_regs(bg);
        hopper::fence_regs(hi);
        hopper::fence_regs(lo);
        wgmma_fence();
#pragma unroll
        for (int t = 0; t < 8; ++t) {  // zeros in the row steps i < j
          hopper::wgmma_rs_n64(du, hi[t], tdesc(dy_addr, t));
          hopper::wgmma_rs_n64(du, lo[t], tdesc(dy_addr, t));
        }
        wgmma_fence();
#pragma unroll
        for (int pl = 0; pl < 2; ++pl)
#pragma unroll
          for (int kk = 0; kk < 8; ++kk)
            hopper::wgmma_ss_n64_tb(
                bg, kdesc(b_addr + (kk >> 2) * kTile + own, kk),
                tdesc(st_addr + pl * kTile, kk), 1);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(du);
        fence_regs(bg);
        hopper::fence_regs(hi);
        hopper::fence_regs(lo);
      }
      // du += w B g; dw_j = (g^T B_j) . u_j; dx = du dt; ddt's du . x
      bf16* dxb = static_cast<bf16*>(p.dx) + b * p.sdx.b + h * p.sdx.h +
                  t0 * p.sdx.s;
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const int j = (e & 2) ? r1 : r0;
        const int col = 8 * (e >> 2) + 2 * tq + (e & 1);
        const float xv = sw_at(sX, kTile, j, col);  // 0 past P
        du[e] = fmaf((e & 2) ? w1 : w0, bg[e], du[e]);
        if (e & 2) {
          dw1 = fmaf(bg[e], xv, dw1);
          dx1 = fmaf(du[e], xv, dx1);
        } else {
          dw0 = fmaf(bg[e], xv, dw0);
          dx0 = fmaf(du[e], xv, dx0);
        }
      }
#pragma unroll
      for (int e = 0; e < 32; e += 2) {
        const int j = (e & 2) ? r1 : r0;
        const int col = 8 * (e >> 2) + 2 * tq;
        const float dtj = (e & 2) ? dt1 : dt0;
        if (j < len && col < p.P)
          *reinterpret_cast<__nv_bfloat162*>(dxb + j * p.sdx.s + col) =
              __floats2bfloat162_rn(du[e] * dtj, du[e + 1] * dtj);
      }
      // dw_j's share goes to d cum_j and to total
      dw0 = quad_sum(dw0) * dt0;
      dw1 = quad_sum(dw1) * dt1;
      dw0 = clip_live(total - c0) ? w0 * dw0 : 0.f;
      dw1 = clip_live(total - c1) ? w1 * dw1 : 0.f;
      dcum0 -= dw0;
      dcum1 -= dw1;
    }

    // the rows' d cum and du . x into shared memory; d total; ddt and dA
    dx0 = quad_sum(dx0);
    dx1 = quad_sum(dx1);
    const float wsum = warp_sum(tq == 0 ? dw0 + dw1 : 0.f);
    if (tq == 0) {
      sDcum[r0] = dcum0;
      sDcum[r1] = dcum1;
      sDdt[r0] = dx0;
      sDdt[r1] = dx1;
    }
    if (lane == 0) sRed[warp] = wsum;
    __syncthreads();  // this head's x, dy and g_k are read
    if (tid == 0) {
      if (hh + 1 < hn) load_state(&tm_h, hh + 1);
      if (hh + 2 < hn) load_xd(hh + 2);
    }
    if (warp == 0) {
      constexpr int E = C / 32;
      const float ddec = warp_sum(hg_lane);  // h_{k-1} . g_k
      float tot = 0.f;
      for (int w = 0; w < 8; ++w) tot += sRed[w];
      if (clip_live(total)) tot += clip_exp(total) * ddec;
      float v[E];
      float run = 0.f;
#pragma unroll
      for (int e = E - 1; e >= 0; --e) {
        float dc = sDcum[lane * E + e];
        if (lane * E + e == C - 1) dc += tot;
        run += dc;
        v[e] = run;
      }
      float incl = run;  // suffix sums over the lanes above
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float u = __shfl_down_sync(0xffffffffu, incl, off);
        if (lane + off < 32) incl += u;
      }
      const float after = incl - run;
      const float a = p.A[h];
      float dA = 0.f;
      float* ddtb = p.ddt + b * p.sddt.b + h * p.sddt.h + t0 * p.sddt.s;
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const int j = lane * E + e;
        const float da = v[e] + after;
        dA = fmaf(da, sDt[j], dA);
        if (j < len) ddtb[j * p.sddt.s] = fmaf(da, a, sDdt[j]);
      }
      dA = warp_sum(dA);
      if (lane == 0) p.dA_part[bhk] = dA;
    }
    __syncthreads();  // this head's scalars are read
  }
}

// -- (d) the partial sums, in a fixed order ----------------------------------

template <typename T>
__global__ void __launch_bounds__(kPassThreads)
ssd_bwd_reduce(const float* __restrict__ dB_part,
               const float* __restrict__ dC_part, T* __restrict__ dB,
               T* __restrict__ dC, int64_t per_batch, int64_t total,
               int parts) {
  // element e of dB / dC [B, G, S, N]; its partials are parts consecutive
  // planes of per_batch / G... laid out [B, G * parts, S, N]
  const int64_t e = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= total) return;
  const int64_t plane = per_batch;  // S * N
  const int64_t bg = e / plane, r = e - bg * plane;
  const float* pb = dB_part + bg * parts * plane + r;
  const float* pc = dC_part + bg * parts * plane + r;
  float sb = 0.f, sc = 0.f;
  for (int q = 0; q < parts; ++q) {
    sb += pb[q * plane];
    sc += pc[q * plane];
  }
  dB[e] = cvt<T>(sb);
  dC[e] = cvt<T>(sc);
}

__global__ void ssd_bwd_reduce_dA(const float* __restrict__ dA_part,
                                  float* __restrict__ dA, int B, int H,
                                  int nc) {
  const int h = blockIdx.x * blockDim.x + threadIdx.x;
  if (h >= H) return;
  float s = 0.f;
  for (int b = 0; b < B; ++b)
    for (int k = 0; k < nc; ++k) s += dA_part[(int64_t(b) * H + h) * nc + k];
  dA[h] = s;
}

// -- launch ------------------------------------------------------------------

template <typename T>
int launch(Params p, const float* dh_final, void* dB, void* dC, float* dA,
           int B, int groups, void* stream) {
  using PL = Plan<T>;
  constexpr int C = PL::C;
  p.nc = (p.S + C - 1) / C;
  p.head_groups = (p.H + kHeads - 1) / kHeads;
  p.n_slices = (p.N + kSlice - 1) / kSlice;
  p.splits = sizeof(T) == 2 ? 2 : 1;
  const PL plan(p.N);
  const int smem_a = plan.dstate_bytes(), smem_c = plan.chunk_bytes();
  cudaError_t err = cudaFuncSetAttribute(
      ssd_bwd_chunk_dstate<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_a);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(ssd_bwd_chunk<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem_c);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(p.nc, p.head_groups, B);
  ssd_bwd_chunk_dstate<T><<<grid, PL::kThreads, smem_a, s>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  const int64_t np = int64_t(p.N) * p.P, states = int64_t(B) * p.H * np;
  ssd_bwd_state_pass<<<unsigned((states + kPassThreads - 1) / kPassThreads),
                       kPassThreads, 0, s>>>(p.gstate, p.decay, dh_final,
                                             states, np, p.nc);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  ssd_bwd_chunk<T><<<grid, PL::kThreads, smem_c, s>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  const int64_t outs = int64_t(B) * groups * p.S * p.N;
  ssd_bwd_reduce<T><<<unsigned((outs + kPassThreads - 1) / kPassThreads),
                      kPassThreads, 0, s>>>(
      p.dB_part, p.dC_part, static_cast<T*>(dB), static_cast<T*>(dC),
      int64_t(p.S) * p.N, outs, p.planes / groups);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  ssd_bwd_reduce_dA<<<(p.H + 127) / 128, 128, 0, s>>>(p.dA_part, dA, B, p.H,
                                                     p.nc);
  return static_cast<int>(cudaGetLastError());
}

// the tensor-core route (bfloat16, one group, P and N multiples of 8, P <=
// 64, N <= 128): (a) as above, (b) with g_k split into planes, (c) on wgmma
// fed by TMA, (d) as above over the planes of hpb heads
int launch_wgmma(Params p, const float* dh_final, const int64_t* x_dims,
                 const int64_t* dy_dims, void* gsplit, float* hg_part,
                 void* dB, void* dC, float* dA, int B, void* stream) {
  constexpr int C = wg::C;
  p.nc = (p.S + C - 1) / C;
  const int wg_groups = (p.H + p.hpb - 1) / p.hpb;
  p.planes = p.H;  // (c) writes one dB / dC plane per head
  const int64_t np = int64_t(p.N) * p.P;
  // TMA maps: B and C [B, S, N] (the group's strides), x and dy [B, H, S,
  // P] through their strides, h_{k-1} and g_k [B H nc 2, N, P]
  const uint64_t bc_dims[3] = {uint64_t(p.N), uint64_t(p.S), uint64_t(B)};
  const uint64_t b_str[2] = {uint64_t(p.sb.s) * 2, uint64_t(p.sb.b) * 2};
  const uint64_t c_str[2] = {uint64_t(p.sc.s) * 2, uint64_t(p.sc.b) * 2};
  const uint64_t xd_dims[4] = {uint64_t(p.P), uint64_t(p.S), uint64_t(p.H),
                               uint64_t(B)};
  const uint64_t x_str[3] = {uint64_t(x_dims[0]) * 2, uint64_t(x_dims[1]) * 2,
                             uint64_t(x_dims[2]) * 2};
  const uint64_t dy_str[3] = {uint64_t(dy_dims[0]) * 2,
                              uint64_t(dy_dims[1]) * 2,
                              uint64_t(dy_dims[2]) * 2};
  const uint64_t st_dims[3] = {uint64_t(p.P), uint64_t(p.N),
                               uint64_t(B) * p.H * p.nc * 2};
  const uint64_t st_str[2] = {uint64_t(p.P) * 2, uint64_t(np) * 2};
  CUtensorMap tm_b, tm_c, tm_x, tm_dy, tm_h, tm_g;
  using hopper::encode_map_strided;
  if (!encode_map_strided(&tm_b, p.Bm, 3, bc_dims, b_str, C) ||
      !encode_map_strided(&tm_c, p.Cm, 3, bc_dims, c_str, C) ||
      !encode_map_strided(&tm_x, p.x, 4, xd_dims, x_str, C) ||
      !encode_map_strided(&tm_dy, p.dy, 4, xd_dims, dy_str, C) ||
      !encode_map_strided(&tm_h, p.hprev, 3, st_dims, st_str, C) ||
      !encode_map_strided(&tm_g, gsplit, 3, st_dims, st_str, C))
    return static_cast<int>(cudaErrorInvalidValue);

  // (a) in blocks of half as many heads as (c): two blocks an SM
  const int hpb_a = (p.hpb + 1) / 2;
  const int smem_a = 6 * wg::kTile + 1024;
  cudaError_t err = cudaFuncSetAttribute(
      ssd_bwd_dstate_wgmma, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_a);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(ssd_bwd_chunk_wgmma,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               wg::kAlloc);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  ssd_bwd_dstate_wgmma<<<dim3(p.nc, (p.H + hpb_a - 1) / hpb_a, B),
                         wg::kThreads, smem_a, s>>>(tm_c, tm_dy, hpb_a, p);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  const int64_t states4 = int64_t(B) * p.H * np / 4;
  ssd_bwd_state_pass_split<<<unsigned((states4 + kPassThreads - 1) /
                                      kPassThreads),
                             kPassThreads, 0, s>>>(
      p.gstate, static_cast<bf16*>(gsplit), p.decay, dh_final,
      static_cast<const bf16*>(p.hprev), hg_part, states4, np / 4, p.nc);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  ssd_bwd_chunk_wgmma<<<dim3(p.nc, wg_groups, B), wg::kThreads, wg::kAlloc,
                        s>>>(tm_b, tm_c, tm_x, tm_dy, tm_h, tm_g, hg_part,
                             int(np / 128), p);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  const int64_t outs = int64_t(B) * p.S * p.N;
  ssd_bwd_reduce<bf16><<<unsigned((outs + kPassThreads - 1) / kPassThreads),
                         kPassThreads, 0, s>>>(
      p.dB_part, p.dC_part, static_cast<bf16*>(dB), static_cast<bf16*>(dC),
      int64_t(p.S) * p.N, outs, p.planes);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  ssd_bwd_reduce_dA<<<(p.H + 127) / 128, 128, 0, s>>>(p.dA_part, dA, B, p.H,
                                                     p.nc);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace ssdb

extern "C" {

// dtype (of x, Bm, Cm, dy, dx, dB, dC): 0 = float32, 1 = bfloat16.  Each
// stride argument points to three int64 (batch, head, seq) strides in
// elements, in host memory; Bm and Cm are read as [B, H, S, N] views (head
// stride 0 for a shared group).  hprev and decay: the forward's workspace
// regions (ssd_scan.cu's Workspace) of the same inputs.  dh_final [B, H, N,
// P] float32 or null (zero).  gstate [B, H, nc, N, P], dA_part [B, H, nc]
// and dB_part, dC_part [B, planes, S, N], float32 scratch; planes = the
// head groups (ceil(H / 4)) when groups == 1, else H.  dB, dC [B, groups,
// S, N] of dtype, dA [H] float32.  Returns cudaGetLastError() after the
// launches, or cudaErrorInvalidValue for a shape the kernels do not take
// (the wrapper refuses those first).
int ssd_scan_backward(const void* x, const int64_t* sx, const void* dt,
                      const int64_t* sdt, const void* A, const void* Bm,
                      const int64_t* sb, const void* Cm, const int64_t* sc,
                      const void* dy, const int64_t* sdy,
                      const void* dh_final, const void* hprev,
                      const void* decay, void* dx, const int64_t* sdx,
                      void* ddt, const int64_t* sddt, void* dA, void* dB,
                      void* dC, void* gstate, void* dB_part, void* dC_part,
                      void* dA_part, int B, int H, int S, int P, int N,
                      int groups, int dtype, void* stream) {
  if (B <= 0 || B > 65535 || H <= 0 || H > 65535 || S <= 0 || P <= 0 ||
      P > ssdb::kPMax || N <= 0 || N > 256 || N % 4 ||
      (groups != 1 && groups != H))
    return static_cast<int>(cudaErrorInvalidValue);
  auto st = [](const int64_t* s) { return ssdb::Strides{s[0], s[1], s[2]}; };
  ssdb::Params p;
  p.x = x;
  p.sx = st(sx);
  p.dt = static_cast<const float*>(dt);
  p.sdt = st(sdt);
  p.A = static_cast<const float*>(A);
  p.Bm = Bm;
  p.sb = st(sb);
  p.Cm = Cm;
  p.sc = st(sc);
  p.dy = dy;
  p.sdy = st(sdy);
  p.hprev = hprev;
  p.decay = static_cast<const float*>(decay);
  p.dx = dx;
  p.sdx = st(sdx);
  p.ddt = static_cast<float*>(ddt);
  p.sddt = st(sddt);
  p.gstate = static_cast<float*>(gstate);
  p.dB_part = static_cast<float*>(dB_part);
  p.dC_part = static_cast<float*>(dC_part);
  p.dA_part = static_cast<float*>(dA_part);
  p.H = H;
  p.S = S;
  p.P = P;
  p.N = N;
  p.one_group = groups == 1;
  p.planes = groups == 1 ? (H + ssdb::kHeads - 1) / ssdb::kHeads : H;
  const float* dh = static_cast<const float*>(dh_final);
  if (dtype == 0)
    return ssdb::launch<float>(p, dh, dB, dC, static_cast<float*>(dA), B,
                               groups, stream);
  if (dtype == 1)
    return ssdb::launch<ssdb::bf16>(p, dh, dB, dC, static_cast<float*>(dA), B,
                                    groups, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The tensor-core route's entry: the arguments of ssd_scan_backward for
// bfloat16 and one group (groups = 1, dtype 1), and besides: scores, the
// forward's score tiles (its workspace's last region, of the same inputs);
// gsplit, bf16 scratch [B, H, nc, 2, N, P] (g_k's planes); hg_part,
// float32 scratch [B, H, nc, N P / 128] (h_{k-1} . g_k by warps); hpb,
// heads per block of the chunk pass; dB_part, dC_part [B, H, S, N].  P and
// N multiples of 8 with N P a multiple of 128, P <= 64, N <= 128; x, dy,
// Bm, Cm with 16-byte
// aligned addresses and strides (the wrapper checks, and takes the
// mma.sync route otherwise).  Five launches.  Returns cudaGetLastError()
// after them, or cudaErrorInvalidValue for a shape it does not take or a
// TMA map that does not encode.
int ssd_scan_backward_wgmma(
    const void* x, const int64_t* sx, const void* dt, const int64_t* sdt,
    const void* A, const void* Bm, const int64_t* sb, const void* Cm,
    const int64_t* sc, const void* dy, const int64_t* sdy,
    const void* dh_final, const void* hprev, const void* decay, void* dx,
    const int64_t* sdx, void* ddt, const int64_t* sddt, void* dA, void* dB,
    void* dC, void* gstate, void* dB_part, void* dC_part, void* dA_part,
    const void* scores, void* gsplit, void* hg_part, int hpb, int B, int H,
    int S, int P, int N, void* stream) {
  if (B <= 0 || B > 65535 || H <= 0 || H > 65535 || S <= 0 || P <= 0 ||
      P > 64 || P % 8 || N <= 0 || N > 128 || N % 8 || (N * P) % 128 ||
      hpb <= 0 ||
      (H > 1 && (sb[1] != 0 || sc[1] != 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  auto st = [](const int64_t* s) { return ssdb::Strides{s[0], s[1], s[2]}; };
  ssdb::Params p;
  p.x = x;
  p.sx = st(sx);
  p.dt = static_cast<const float*>(dt);
  p.sdt = st(sdt);
  p.A = static_cast<const float*>(A);
  p.Bm = Bm;
  p.sb = st(sb);
  p.Cm = Cm;
  p.sc = st(sc);
  p.dy = dy;
  p.sdy = st(sdy);
  p.hprev = hprev;
  p.decay = static_cast<const float*>(decay);
  p.dx = dx;
  p.sdx = st(sdx);
  p.ddt = static_cast<float*>(ddt);
  p.sddt = st(sddt);
  p.gstate = static_cast<float*>(gstate);
  p.dB_part = static_cast<float*>(dB_part);
  p.dC_part = static_cast<float*>(dC_part);
  p.dA_part = static_cast<float*>(dA_part);
  p.scores = static_cast<const float*>(scores);
  p.hpb = hpb;
  p.H = H;
  p.S = S;
  p.P = P;
  p.N = N;
  // x and dy strides as the maps take them: seq, head, batch
  const int64_t x_dims[3] = {sx[2], sx[1], sx[0]};
  const int64_t dy_dims[3] = {sdy[2], sdy[1], sdy[0]};
  return ssdb::launch_wgmma(p, static_cast<const float*>(dh_final), x_dims,
                            dy_dims, gsplit, static_cast<float*>(hg_part), dB,
                            dC, static_cast<float*>(dA), B, stream);
}

}  // extern "C"

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
// What bounds it on an H100: bytes.  The function reads x, dt, B, C, dy
// and writes dx, ddt, dB and dC (for one Mamba2-780M layer of 4,096 bf16
// tokens 81 MB, 24 us at 3.35 TB/s); its least operations, the
// recurrence's backward at the tensor cores' rate, take less.  The chunked
// form adds the forward's states entering each chunk (read), Q/g (written
// and read twice, the size of the forward's chunk states) and the dB/dC
// partials, and its c x c tiles' exps and products run four times a chunk
// and head (two layouts, two tiles each).  Times are in PERF.md.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>

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
template <typename T>
__device__ void load_cum(const Params& p, int b, int h, int t0, int len,
                         float* sDt, float* sCum) {
  constexpr int C = Plan<T>::C, E = C / 32;
  for (int j = threadIdx.x; j < C; j += blockDim.x)
    sDt[j] = j < len ? p.dt[b * p.sdt.b + h * p.sdt.h + (t0 + j) * p.sdt.s]
                     : 0.f;
  __syncthreads();
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    const float a = p.A[h];
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

}  // extern "C"

// Mamba-2 chunked SSD scan, for sm_90a: a chunk-parallel scan.
//
// Replaces the TPU kernel src/repro/kernels/ssd_scan.py:98 (ssd_scan /
// _kernel).  Same function, from a zero state: within a chunk of positions
//   y_i = sum_{j<=i} (C_i . B_j) exp(cum_i - cum_j) x_j dt_j
//         + exp(cum_i) C_i h,
// across chunks
//   h <- exp(total) h + sum_j exp(total - cum_j) B_j (x_j dt_j)^T,
// with cum the running sum of dt * A inside the chunk, total its last value
// and every decay clipped to [-60, 0].  Returns y (x's dtype) and the final
// state h [B, H, N, P] in float32.
//
// Layouts.  Every input is addressed through (batch, head, seq) strides in
// elements with a contiguous last axis, so the model passes its
// [B, S, H, P] activations and [B, S, N] shared B/C group as views
// ([B, H, S, P] with the head stride 0 for B/C): nothing is transposed or
// expanded in memory.  dt is float32 with its own strides, A float32 [H],
// y is written through strides, h contiguous.
//
// Design.  The TPU kernel walks the chunks of one head in series, carrying
// h in VMEM.  Here the work is split as the JAX model's ssd_chunked splits
// it, into three launches, of which only the middle one is serial in the
// chunk, and it is elementwise:
// (a) ssd_chunk_state, one block per (chunk, group of 8 heads, batch):
//     each head's running sum cum, the chunk's decay exp(total) and its
//     state contribution S_k = sum_j B_j^T (x_j w_j), w_j = exp(total -
//     cum_j) dt_j, into a float32 workspace [B, H, nc, N, P].  Extra blocks
//     compute the score tiles C B^T: one per (chunk, batch) when B and C
//     have head stride 0 (one group shared by every head, as the model
//     passes Mamba2-780M's), else one per head.
// (b) ssd_state_pass, one thread per 4 state elements of a (batch, head):
//     h_k = exp(total_k) h_{k-1} + S_k over the chunks, writing each h_{k-1}
//     in the form (c) multiplies it in (bf16: two planes, hi and lo) and the
//     last h to the output.
// (c) ssd_chunk_output, one block per (chunk, group of 8 heads, batch): for
//     each head y = exp(cum_i) C_i h_{k-1} + (C B^T o L)(x dt), the scores
//     read into registers once for all the block's heads when shared, and
//     each head's L = exp(cum_i - cum_j) dt_j, j <= i, applied there.
//     Each warp owns 16 rows of the chunk and skips the tiles above the
//     diagonal; the two warps of a scheduler take a long and a short row
//     block.  While one item's products run, the next item's h and x tiles
//     arrive by cp.async.
// Heads wider than 64 columns of P run as several items of a block.
//
// Products.  Each warp runs its products as m16n8k16 tiles whose sums every
// route keeps in the same registers (the mma accumulator layout: lane l
// holds rows l/4 and l/4 + 8 at columns 8t + 2(l%4) + {0, 1} of tile t).
// - bfloat16 (chunk 128, 8 warps): mma.sync on the tensor cores, operands
//   from shared memory by ldmatrix, float32 sums.  B and C enter as they
//   are (exact bf16), and so does x in (c).  Each float32 operand is split
//   into two bf16 halves, hi = bf16(v) and lo = bf16(v - hi), two products,
//   so it keeps about 16 bits (error ~2^-17): x w in (a), the carried h and
//   the scores G = C B^T o L in (c).  The position scalars are folded into
//   those split operands (w_j into x, L and dt_j into G), exp(cum_i) is
//   applied to the float32 sums.
// - float32 (chunk 64, 4 warps): the same passes with float32 FMAs on the
//   CUDA cores, out of shared memory in float32 (TF32 keeps about three
//   digits and would break the 2e-4 tolerance), G passed between the lanes
//   of a row by shuffles.
// A tail chunk is padded with zero rows (dt = 0 leaves the state unchanged)
// and its y rows are not stored.
//
// What bounds it on an H100: bytes.  The function reads x, B, C, dt once
// and writes y and h (108 MB for one Mamba2-780M layer of 8,192 tokens, 32
// us at 3.35 TB/s); its operations at the tensor cores' rate take less.
// The chunked form adds the chunk states: at chunk 128, 100.7 MB of S_k
// and as much of h_{k-1} for that layer, each written once and read once,
// about 4x the function's own bytes.  Chunk 128 halves them against 64; a
// larger chunk would not keep a warp's row of scores in its registers.
// Times are in PERF.md.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>

namespace ssd {

using bf16 = __nv_bfloat16;

constexpr float kClip = -60.f;
constexpr int kHeadGroup = 8;  // heads per block of passes (a) and (c)
constexpr int kPTile = 64;     // columns of P per item (8 tiles of 8)
constexpr int kPassThreads = 256;

// chunk per dtype: bf16 128 positions (8 warps of 16 rows), float32 64;
// kSplits: planes of a float32 operand (hi, lo) in the products
template <typename T>
struct Route;
template <>
struct Route<bf16> {
  static constexpr int kChunk = 128;
  static constexpr int kSplits = 2;
};
template <>
struct Route<float> {
  static constexpr int kChunk = 64;
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
  void* y;
  Strides sy;
  float* states;  // [B, H, nc, N, P]: S_k
  void* hprev;    // [B, H, nc, splits, N, P] of T: h_{k-1}
  float* decay;   // [B, H, nc]: exp(total_k)
  float* scores;  // [B, H or 1, nc, warps, chunk / 8, 32, 4]: C B^T
  int H, S, P, N, nc, head_groups, p_tiles;
  bool shared;  // B and C have head stride 0: one score tile per chunk
  bool vec_x, vec_b, vec_c, vec_y;  // 16-byte copies allowed
};

// exp of a decay clipped to [-60, 0], by the hardware's exp2 (relative
// error under 5e-6 at -60, ~1e-7 near 0)
__device__ __forceinline__ float clip_exp(float v) {
  return __expf(fminf(fmaxf(v, kClip), 0.f));
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

template <typename T, int E>
struct alignas(sizeof(T) * E) Vec {
  T v[E];
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory by the copy engine; src_bytes 0
// writes zeros (src is then not read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most N committed groups of this thread are pending
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// A [rows x cols] tile of src (row stride `stride`, contiguous columns) into
// shared memory at pitch `pitch`, rows >= rows_live and columns >=
// cols_live as zeros, by every thread of the block in 16-byte groups:
// cp.async where `vec` (src and stride 16-byte aligned) and the group is
// whole, else plain loads (a ragged last group, or unaligned views).  cols
// is a multiple of the group.  Complete after cp_async_wait and a barrier.
template <typename T>
__device__ void stage(T* dst, int pitch, const T* src, int64_t stride,
                      int rows, int rows_live, int cols, int cols_live,
                      bool vec) {
  constexpr int E = 16 / sizeof(T);
  const int groups = cols / E;
  for (int i = threadIdx.x; i < rows * groups; i += blockDim.x) {
    const int r = i / groups, c0 = (i - r * groups) * E;
    T* d = dst + r * pitch + c0;
    if (r >= rows_live || c0 >= cols_live) {
      cp_async16(d, src, 0);
    } else if (vec && c0 + E <= cols_live) {
      cp_async16(d, src + r * stride + c0, 16);
    } else {
      const T* s = src + r * stride + c0;
#pragma unroll
      for (int e = 0; e < E; ++e)
        d[e] = c0 + e < cols_live ? s[e] : cvt<T>(0.f);
    }
  }
}

// dst (hi, and lo when bf16) = src [rows x cols] scaled by row_scale, in
// shared memory, as the split operand of a product: hi = T(v), lo =
// bf16(v - hi) keeps v to ~2^-17.  cols a multiple of 16 bytes.
template <typename T>
__device__ void scale_split(T* hi, T* lo, const T* src, int pitch, int rows,
                            int cols, const float* row_scale) {
  constexpr int E = 16 / sizeof(T);
  const int groups = cols / E;
  for (int i = threadIdx.x; i < rows * groups; i += blockDim.x) {
    const int r = i / groups, at = r * pitch + (i - r * groups) * E;
    const float f = row_scale[r];
    const Vec<T, E> in = *reinterpret_cast<const Vec<T, E>*>(src + at);
    Vec<T, E> h;
    float v[E];
#pragma unroll
    for (int e = 0; e < E; ++e) {
      v[e] = to_f32(in.v[e]) * f;
      h.v[e] = cvt<T>(v[e]);
    }
    *reinterpret_cast<Vec<T, E>*>(hi + at) = h;
    if constexpr (Route<T>::kSplits == 2) {
      Vec<T, E> l;
#pragma unroll
      for (int e = 0; e < E; ++e) l.v[e] = cvt<T>(v[e] - to_f32(h.v[e]));
      *reinterpret_cast<Vec<T, E>*>(lo + at) = l;
    }
  }
}

// -- warp products -----------------------------------------------------------

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

// acc[t] += A[16 x K] . B[K x 8 NT] for one warp, tiles t < nt_live (even),
// summed over kPlanes planes of B `plane` elements apart (a split operand's
// hi and lo) that share A's fragments.  A(m, k) = a[m lda + k], or a[k lda
// + m] with kATrans; B(k, n) = b[n ldb + k], or b[k ldb + n] with kBTrans.
// K a multiple of 16 (bf16; zeros pad it).
template <int NT, bool kATrans, bool kBTrans, int kPlanes = 1>
__device__ __forceinline__ void product(float (&acc)[NT][4], const bf16* a,
                                        int lda, const bf16* b, int ldb,
                                        int K, int nt_live, int plane = 0) {
  const int lane = threadIdx.x & 31, q = lane >> 3, r = lane & 7;
  for (int k0 = 0; k0 < K; k0 += 16) {
    uint32_t af[4];
    if (kATrans)
      ldsm_x4_t(af, a + (k0 + (q >> 1) * 8 + r) * lda + (q & 1) * 8);
    else
      ldsm_x4(af, a + ((q & 1) * 8 + r) * lda + k0 + (q >> 1) * 8);
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      if (2 * np < nt_live) {
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
                                        int K, int nt_live, int = 0) {
  static_assert(kPlanes == 1, "float32 operands have one plane");
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  for (int k = 0; k < K; ++k) {
    const float a0 = kATrans ? a[k * lda + g] : a[g * lda + k];
    const float a1 = kATrans ? a[k * lda + g + 8] : a[(g + 8) * lda + k];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      if (nt < nt_live) {
        const int n = nt * 8 + 2 * t;
        float b0, b1;
        if (kBTrans) {
          const float2 v = *reinterpret_cast<const float2*>(b + k * ldb + n);
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

// acc[8 tiles of P] += G[16 x 16] . X[16 x 64] for one warp, G the
// accumulator tiles of columns 16kk..16kk+15 (gv = tile 2kk, then 2kk + 1),
// x_rows the 16 rows of X; bf16: G split into hi and lo, two products
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

// float32: each G value of the row goes to the lanes of that row by shuffle
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
          const float2 xv = *reinterpret_cast<const float2*>(xr + pn * 8);
          acc[pn][0] = fmaf(a0, xv.x, acc[pn][0]);
          acc[pn][1] = fmaf(a0, xv.y, acc[pn][1]);
          acc[pn][2] = fmaf(a1, xv.x, acc[pn][2]);
          acc[pn][3] = fmaf(a1, xv.y, acc[pn][3]);
        }
      }
}

// -- shared-memory plan ------------------------------------------------------

template <typename T>
struct Plan {
  static constexpr int C = Route<T>::kChunk;
  static constexpr int kWarps = C / 16;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kNtScores = C / 8;  // score tiles of a row block
  static constexpr int kSplits = Route<T>::kSplits;
  static constexpr int kPad = 16 / sizeof(T);
  static constexpr int kLdx = kPTile + kPad;  // pitch of x, y and h tiles
  // dt, cum and (a)'s w of a group's heads, float32
  static constexpr int kScalarBytes = 3 * kHeadGroup * C * 4;
  int n_pad, ldn;  // N padded to 16, and the pitch of B / C rows
  __host__ __device__ explicit Plan(int N)
      : n_pad((N + 15) / 16 * 16), ldn((N + 15) / 16 * 16 + kPad) {}
  __host__ __device__ int tile_bytes(int rows, int pitch) const {
    return rows * pitch * int(sizeof(T));
  }
  // (a): B, x as loaded, x w (hi, lo); its score blocks: C and B
  __host__ __device__ int state_bytes() const {
    const int own = tile_bytes(C, ldn) + (1 + kSplits) * tile_bytes(C, kLdx);
    const int scores = 2 * tile_bytes(C, ldn);
    return kScalarBytes + (own > scores ? own : scores);
  }
  // (c): C, h_{k-1} (hi, lo), x, y
  __host__ __device__ int output_bytes() const {
    return kScalarBytes + tile_bytes(C, ldn) +
           kSplits * tile_bytes(n_pad, kLdx) + 2 * tile_bytes(C, kLdx);
  }
};

// dt of the group's heads for the chunk (zeros past S and past H) and each
// head's running sum of dt A, one warp per head
template <typename T>
__device__ void load_cum(const Params& p, int b, int h0, int hg, int t0,
                         int len, float* sDt, float* sCum) {
  constexpr int C = Plan<T>::C;
  for (int i = threadIdx.x; i < kHeadGroup * C; i += blockDim.x) {
    const int j = i / kHeadGroup, hh = i - j * kHeadGroup;  // heads fastest
    sDt[hh * C + j] =
        (hh < hg && j < len)
            ? p.dt[b * p.sdt.b + (h0 + hh) * p.sdt.h + (t0 + j) * p.sdt.s]
            : 0.f;
  }
  __syncthreads();
  const int lane = threadIdx.x & 31;
  constexpr int E = C / 32;
  for (int hh = threadIdx.x >> 5; hh < hg; hh += Plan<T>::kWarps) {
    const float a = p.A[h0 + hh];
    float v[E];
    float run = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      run += sDt[hh * C + lane * E + e] * a;
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
    for (int e = 0; e < E; ++e) sCum[hh * C + lane * E + e] = v[e] + before;
  }
  __syncthreads();
}

// the block of 16 rows a warp owns in the score and output passes: warps
// w and w + 4 share a scheduler, so the light row blocks pair with the heavy
// ones (block w has w + 1 column blocks up to the diagonal)
template <typename T>
__device__ __forceinline__ int row_block(int warp) {
  constexpr int W = Plan<T>::kWarps;
  return W == 8 && warp >= 4 ? 11 - warp : warp;
}

// the score tiles of (b, head hs of the score heads, chunk k) in the
// accumulator layout of the warps of pass (c): row block rb, tile t, lane l
template <typename T>
__device__ __forceinline__ float4* score_tile(const Params& p, int b, int hs,
                                              int k, int rb) {
  constexpr int W = Plan<T>::kWarps, NT = Plan<T>::kNtScores;
  const int heads = p.shared ? 1 : p.H;
  return reinterpret_cast<float4*>(p.scores) +
         (((int64_t(b) * heads + hs) * p.nc + k) * W + rb) * NT * 32;
}

// -- (a) chunk states, and the score tiles -----------------------------------

template <typename T>
__global__ void __launch_bounds__(Plan<T>::kThreads)
ssd_chunk_state(Params p) {
  using PL = Plan<T>;
  constexpr int C = PL::C, W = PL::kWarps, NT = PL::kNtScores;
  const PL plan(p.N);
  const int k = blockIdx.x, b = blockIdx.z;
  const int t0 = k * C, len = min(C, p.S - t0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  extern __shared__ float4 smem4[];
  float* sDt = reinterpret_cast<float*>(smem4);
  float* sCum = sDt + kHeadGroup * C;
  float* sW = sCum + kHeadGroup * C;
  T* tiles = reinterpret_cast<T*>(sW + kHeadGroup * C);
  const T* Bb = static_cast<const T*>(p.Bm) + b * p.sb.b + t0 * p.sb.s;

  if (blockIdx.y >= p.head_groups) {  // C B^T: the shared tile, or per head
    T* sC = tiles;
    T* sB = sC + C * plan.ldn;
    const T* Cb = static_cast<const T*>(p.Cm) + b * p.sc.b + t0 * p.sc.s;
    const int first = (blockIdx.y - p.head_groups) * kHeadGroup;
    const int count = p.shared ? 1 : min(kHeadGroup, p.H - first);
    const int rb = row_block<T>(warp);
    for (int hh = 0; hh < count; ++hh) {
      const int h = first + hh;
      stage(sC, plan.ldn, Cb + h * p.sc.h, p.sc.s, C, len, plan.n_pad, p.N,
            p.vec_c);
      stage(sB, plan.ldn, Bb + h * p.sb.h, p.sb.s, C, len, plan.n_pad, p.N,
            p.vec_b);
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
      float sc[NT][4] = {};
      product<NT, false, false>(sc, sC + 16 * rb * plan.ldn, plan.ldn, sB,
                                plan.ldn, plan.n_pad, 2 * rb + 2);
      float4* out = score_tile<T>(p, b, h, k, rb);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
        if (nt < 2 * rb + 2)
          out[nt * 32 + lane] = make_float4(sc[nt][0], sc[nt][1], sc[nt][2],
                                            sc[nt][3]);
      __syncthreads();  // before the next head's tiles
    }
    return;
  }

  const int h0 = blockIdx.y * kHeadGroup, hg = min(kHeadGroup, p.H - h0);
  T* sB = tiles;
  T* sX = sB + C * plan.ldn;  // x as loaded
  T* sXw = sX + C * PL::kLdx;  // x w, hi then lo
  const int items = hg * p.p_tiles;
  auto stage_x = [&](int item) {
    const int hh = item / p.p_tiles, p0 = (item - hh * p.p_tiles) * kPTile;
    stage(sX, PL::kLdx,
          static_cast<const T*>(p.x) + b * p.sx.b + (h0 + hh) * p.sx.h +
              t0 * p.sx.s + p0,
          p.sx.s, C, len, kPTile, min(kPTile, p.P - p0), p.vec_x);
  };
  stage(sB, plan.ldn, Bb + h0 * p.sb.h, p.sb.s, C, len, plan.n_pad, p.N,
        p.vec_b);
  stage_x(0);
  cp_async_commit();
  load_cum<T>(p, b, h0, hg, t0, len, sDt, sCum);
  for (int i = threadIdx.x; i < hg * C; i += blockDim.x) {
    const int hh = i / C;  // w_j = exp(total - cum_j) dt_j
    sW[i] = clip_exp(sCum[hh * C + C - 1] - sCum[i]) * sDt[i];
  }
  if (threadIdx.x < hg)
    p.decay[(int64_t(b) * p.H + h0 + threadIdx.x) * p.nc + k] =
        clip_exp(sCum[threadIdx.x * C + C - 1]);

  const int64_t np_elems = int64_t(p.N) * p.P;
  const int g = lane >> 2, tq = lane & 3;
  for (int item = 0; item < items; ++item) {
    const int hh = item / p.p_tiles, pt = item - hh * p.p_tiles;
    const int h = h0 + hh, p0 = pt * kPTile, pw = min(kPTile, p.P - p0);
    if (!p.shared && pt == 0 && item > 0) {  // this head's own B
      stage(sB, plan.ldn, Bb + h * p.sb.h, p.sb.s, C, len, plan.n_pad, p.N,
            p.vec_b);
      cp_async_commit();
    }
    cp_async_wait<0>();
    __syncthreads();  // B and x arrived; w written
    scale_split(sXw, sXw + C * PL::kLdx, sX, PL::kLdx, C, kPTile,
                sW + hh * C);
    __syncthreads();
    if (item + 1 < items) stage_x(item + 1);  // lands during the products
    cp_async_commit();
    // S[n][p] = sum_j B[j][n] (x w)[j][p]: warp w takes rows n of 16w,
    // 16(w + W), ...
    const int nt_live = (pw + 15) / 16 * 2;
    float* dst = p.states + ((int64_t(b) * p.H + h) * p.nc + k) * np_elems;
    for (int mt = warp; mt * 16 < plan.n_pad; mt += W) {
      float acc[8][4] = {};
      product<8, true, true, PL::kSplits>(acc, sB + mt * 16, plan.ldn, sXw,
                                          PL::kLdx, C, nt_live, C * PL::kLdx);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int n = mt * 16 + g + 8 * half, col = nt * 8 + 2 * tq;
          if (n >= p.N) continue;
          float* o = dst + int64_t(n) * p.P + p0 + col;
          if (col + 1 < pw && (p.P & 1) == 0) {
            *reinterpret_cast<float2*>(o) =
                make_float2(acc[nt][2 * half], acc[nt][2 * half + 1]);
          } else {
            if (col < pw) o[0] = acc[nt][2 * half];
            if (col + 1 < pw) o[1] = acc[nt][2 * half + 1];
          }
        }
    }
    __syncthreads();  // before x w and B are replaced
  }
}

// -- (b) the state passing, serial in the chunk ------------------------------

// h_{k-1} as pass (c) reads it: float32, or bf16 hi and lo planes N P apart
__device__ __forceinline__ void put_state(float* o, int64_t, float4 h) {
  *reinterpret_cast<float4*>(o) = h;
}
__device__ __forceinline__ void put_state(bf16* o, int64_t plane, float4 h) {
  const float v[4] = {h.x, h.y, h.z, h.w};
  Vec<bf16, 4> hi, lo;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    hi.v[e] = __float2bfloat16(v[e]);
    lo.v[e] = __float2bfloat16(v[e] - __bfloat162float(hi.v[e]));
  }
  *reinterpret_cast<Vec<bf16, 4>*>(o) = hi;
  *reinterpret_cast<Vec<bf16, 4>*>(o + plane) = lo;
}

template <typename T>
__global__ void __launch_bounds__(kPassThreads)
ssd_state_pass(const float* __restrict__ states,
               const float* __restrict__ decay, T* __restrict__ hprev,
               float* __restrict__ h_out, int64_t n4, int64_t np4, int nc) {
  constexpr int kSplits = Route<T>::kSplits;
  const int64_t e = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= n4) return;
  const int64_t bh = e / np4, r = e - bh * np4, plane = 4 * np4;
  const float4* s = reinterpret_cast<const float4*>(states) + bh * nc * np4 + r;
  T* o = hprev + bh * nc * kSplits * plane + 4 * r;
  const float* d = decay + bh * nc;
  float4 h = make_float4(0.f, 0.f, 0.f, 0.f);
  // chunks in groups of U, the next group's loads issued before this
  // group's chain
  constexpr int U = 8;
  float4 v[U], next[U];
#pragma unroll
  for (int u = 0; u < U; ++u)
    if (u < nc) v[u] = s[u * np4];
  for (int k0 = 0; k0 < nc; k0 += U) {
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (k0 + U + u < nc) next[u] = s[(k0 + U + u) * np4];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (k0 + u >= nc) break;
      put_state(o + (k0 + u) * kSplits * plane, plane, h);
      const float f = d[k0 + u];
      h = make_float4(fmaf(f, h.x, v[u].x), fmaf(f, h.y, v[u].y),
                      fmaf(f, h.z, v[u].z), fmaf(f, h.w, v[u].w));
    }
#pragma unroll
    for (int u = 0; u < U; ++u) v[u] = next[u];
  }
  reinterpret_cast<float4*>(h_out)[e] = h;
}

// -- (c) the chunk outputs ---------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(Plan<T>::kThreads)
ssd_chunk_output(Params p) {
  using PL = Plan<T>;
  constexpr int C = PL::C, NT = PL::kNtScores;
  const PL plan(p.N);
  const int k = blockIdx.x, b = blockIdx.z;
  const int h0 = blockIdx.y * kHeadGroup, hg = min(kHeadGroup, p.H - h0);
  const int t0 = k * C, len = min(C, p.S - t0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3, rb = row_block<T>(warp);
  extern __shared__ float4 smem4[];
  float* sDt = reinterpret_cast<float*>(smem4);
  float* sCum = sDt + kHeadGroup * C;
  // (the scalars' third row is pass (a)'s w)
  T* sC = reinterpret_cast<T*>(sCum + 2 * kHeadGroup * C);
  T* sH = sC + C * plan.ldn;  // h_{k-1}, hi then lo
  T* sX = sH + PL::kSplits * plan.n_pad * PL::kLdx;
  T* sY = sX + C * PL::kLdx;

  const int items = hg * p.p_tiles;
  const T* Cb = static_cast<const T*>(p.Cm) + b * p.sc.b + t0 * p.sc.s;
  const int64_t np_elems = int64_t(p.N) * p.P;
  const bool vec_h = (p.P * int(sizeof(T))) % 16 == 0;
  // an item's C (per head) and h_{k-1}; its x
  auto stage_h = [&](int item) {
    const int hh = item / p.p_tiles, pt = item - hh * p.p_tiles;
    const int h = h0 + hh, p0 = pt * kPTile, pw = min(kPTile, p.P - p0);
    if (!p.shared && pt == 0)
      stage(sC, plan.ldn, Cb + h * p.sc.h, p.sc.s, C, len, plan.n_pad, p.N,
            p.vec_c);
    if (k == 0) return;  // h_{-1} = 0
    const T* src = static_cast<const T*>(p.hprev) +
                   ((int64_t(b) * p.H + h) * p.nc + k) * PL::kSplits *
                       np_elems + p0;
#pragma unroll
    for (int s = 0; s < PL::kSplits; ++s)
      stage(sH + s * plan.n_pad * PL::kLdx, PL::kLdx, src + s * np_elems,
            p.P, plan.n_pad, p.N, kPTile, pw, vec_h);
  };
  auto stage_x = [&](int item) {
    const int hh = item / p.p_tiles, p0 = (item - hh * p.p_tiles) * kPTile;
    stage(sX, PL::kLdx,
          static_cast<const T*>(p.x) + b * p.sx.b + (h0 + hh) * p.sx.h +
              t0 * p.sx.s + p0,
          p.sx.s, C, len, kPTile, min(kPTile, p.P - p0), p.vec_x);
  };
  auto load_scores = [&](float (&sc)[NT][4], int hs) {
    const float4* in = score_tile<T>(p, b, hs, k, rb);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const float4 v = nt < 2 * rb + 2 ? in[nt * 32 + lane]
                                         : make_float4(0.f, 0.f, 0.f, 0.f);
      sc[nt][0] = v.x;
      sc[nt][1] = v.y;
      sc[nt][2] = v.z;
      sc[nt][3] = v.w;
    }
  };

  // two groups of copies are in flight when an item starts: its h_{k-1},
  // then its x
  if (p.shared)
    stage(sC, plan.ldn, Cb, p.sc.s, C, len, plan.n_pad, p.N, p.vec_c);
  stage_h(0);
  cp_async_commit();
  stage_x(0);
  cp_async_commit();
  load_cum<T>(p, b, h0, hg, t0, len, sDt, sCum);
  // scores of rows 16 rb.. against every column tile up to the diagonal
  float sc[NT][4];
  if (p.shared) load_scores(sc, 0);

  const int i0 = 16 * rb + g, i1 = i0 + 8;  // this lane's rows
  for (int item = 0; item < items; ++item) {
    const int hh = item / p.p_tiles, pt = item - hh * p.p_tiles;
    const int h = h0 + hh, p0 = pt * kPTile, pw = min(kPTile, p.P - p0);
    const float* cum = sCum + hh * C;
    const float* dtc = sDt + hh * C;
    if (!p.shared && pt == 0) load_scores(sc, h);
    cp_async_wait<1>();
    __syncthreads();  // C and h_{k-1} arrived

    const int nt_live = (pw + 15) / 16 * 2;
    float acc[8][4] = {};
    if (k > 0) {  // exp(cum_i) C_i h_{k-1}
      const T* a = sC + 16 * rb * plan.ldn;
      product<8, false, true, PL::kSplits>(acc, a, plan.ldn, sH, PL::kLdx,
                                           plan.n_pad, nt_live,
                                           plan.n_pad * PL::kLdx);
      const float e0 = clip_exp(cum[i0]), e1 = clip_exp(cum[i1]);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        acc[nt][0] *= e0;
        acc[nt][1] *= e0;
        acc[nt][2] *= e1;
        acc[nt][3] *= e1;
      }
    }
    cp_async_wait<0>();
    __syncthreads();  // x arrived; C and h are free
    if (item + 1 < items) stage_h(item + 1);  // lands during the diagonal
    cp_async_commit();

    // + (C B^T o L)(x dt), L_ij = exp(cum_i - cum_j) for j <= i, over the
    // column blocks up to the diagonal
    const float c0 = cum[i0], c1 = cum[i1];
#pragma unroll
    for (int kk = 0; kk < NT / 2; ++kk) {
      if (kk > rb) break;
      float gv[8];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int nt = 2 * kk + half;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int j = nt * 8 + 2 * tq + e;
          const float wj = dtc[j], cj = cum[j];
          // a select, not a branch, keeps the unrolled loop one block the
          // compiler can interleave with the products (branches cost a
          // fifth of the pass); above the diagonal the clip gives exp(0)
          gv[half * 4 + e] =
              sc[nt][e] * clip_exp(c0 - cj) * (j <= i0 ? wj : 0.f);
          gv[half * 4 + 2 + e] =
              sc[nt][2 + e] * clip_exp(c1 - cj) * (j <= i1 ? wj : 0.f);
        }
      }
      diag_step(acc, gv, sX + 16 * kk * PL::kLdx, PL::kLdx);
    }

    // y: the warp's 16 rows through shared memory, then 16-byte stores
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        T* o = sY + (i0 + 8 * half) * PL::kLdx + nt * 8 + 2 * tq;
        o[0] = cvt<T>(acc[nt][2 * half]);
        o[1] = cvt<T>(acc[nt][2 * half + 1]);
      }
    __syncwarp();
    constexpr int E = 16 / sizeof(T), G = kPTile / E;
    T* yb = static_cast<T*>(p.y) + b * p.sy.b + h * p.sy.h + t0 * p.sy.s + p0;
    for (int i = lane; i < 16 * G; i += 32) {
      const int row = 16 * rb + i / G, c = (i % G) * E;
      if (row >= len) continue;
      const T* s = sY + row * PL::kLdx + c;
      T* d = yb + row * p.sy.s + c;
      if (p.vec_y && c + E <= pw) {
        *reinterpret_cast<Vec<T, E>*>(d) =
            *reinterpret_cast<const Vec<T, E>*>(s);
      } else {
        for (int e = 0; e < E && c + e < pw; ++e) d[e] = s[e];
      }
    }
    __syncthreads();  // x is free
    if (item + 1 < items) stage_x(item + 1);  // lands during the next carry
    cp_async_commit();
  }
}

// -- launch ------------------------------------------------------------------

inline int64_t align256(int64_t v) { return (v + 255) / 256 * 256; }

// workspace: S_k, h_{k-1}, the decays, the score tiles, each 256-byte
// aligned (the wrapper's workspace_bytes computes the same)
struct Workspace {
  int64_t hprev_at, decay_at, scores_at, bytes;
};

template <typename T>
Workspace workspace(int B, int H, int S, int P, int N, bool shared) {
  constexpr int C = Route<T>::kChunk;
  const int64_t nc = (S + C - 1) / C;
  const int64_t states = int64_t(B) * H * nc * N * P * 4;
  Workspace w;
  w.hprev_at = align256(states);
  w.decay_at = align256(w.hprev_at + states);
  w.scores_at = align256(w.decay_at + int64_t(B) * H * nc * 4);
  w.bytes = w.scores_at + int64_t(B) * (shared ? 1 : H) * nc * C * C * 4;
  return w;
}

inline bool aligned16(const void* ptr, const int64_t* s, int elem) {
  const int64_t e = 16 / elem;
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0 && s[0] % e == 0 &&
         s[1] % e == 0 && s[2] % e == 0;
}

template <typename T>
int launch(const void* x, const int64_t* sx, const void* dt,
           const int64_t* sdt, const void* A, const void* Bm,
           const int64_t* sb, const void* Cm, const int64_t* sc, void* y,
           const int64_t* sy, void* h_out, void* workspace_ptr,
           int64_t workspace_size, int B, int H, int S, int P, int N,
           void* stream) {
  using PL = Plan<T>;
  constexpr int C = PL::C;
  auto st = [](const int64_t* s) { return Strides{s[0], s[1], s[2]}; };
  Params p;
  p.x = x;
  p.sx = st(sx);
  p.dt = static_cast<const float*>(dt);
  p.sdt = st(sdt);
  p.A = static_cast<const float*>(A);
  p.Bm = Bm;
  p.sb = st(sb);
  p.Cm = Cm;
  p.sc = st(sc);
  p.y = y;
  p.sy = st(sy);
  p.H = H;
  p.S = S;
  p.P = P;
  p.N = N;
  p.nc = (S + C - 1) / C;
  p.head_groups = (H + kHeadGroup - 1) / kHeadGroup;
  p.shared = sb[1] == 0 && sc[1] == 0;
  p.p_tiles = (P + kPTile - 1) / kPTile;
  const int elem = int(sizeof(T));
  p.vec_x = aligned16(x, sx, elem);
  p.vec_b = aligned16(Bm, sb, elem);
  p.vec_c = aligned16(Cm, sc, elem);
  p.vec_y = aligned16(y, sy, elem);
  const Workspace ws = workspace<T>(B, H, S, P, N, p.shared);
  if (ws.bytes > workspace_size)
    return static_cast<int>(cudaErrorInvalidValue);
  char* base = static_cast<char*>(workspace_ptr);
  p.states = reinterpret_cast<float*>(base);
  p.hprev = base + ws.hprev_at;
  p.decay = reinterpret_cast<float*>(base + ws.decay_at);
  p.scores = reinterpret_cast<float*>(base + ws.scores_at);

  const PL plan(N);
  const int smem_a = plan.state_bytes(), smem_c = plan.output_bytes();
  cudaError_t err = cudaFuncSetAttribute(
      ssd_chunk_state<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_a);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(ssd_chunk_output<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem_c);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // (a)'s blocks, then its score blocks: one per chunk, or per 8 heads
  const int score_groups = p.shared ? 1 : p.head_groups;
  ssd_chunk_state<T><<<dim3(p.nc, p.head_groups + score_groups, B),
                       PL::kThreads, smem_a, s>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  const int64_t np4 = int64_t(N) * P / 4, n4 = int64_t(B) * H * np4;
  ssd_state_pass<T><<<unsigned((n4 + kPassThreads - 1) / kPassThreads),
                      kPassThreads, 0, s>>>(
      p.states, p.decay, static_cast<T*>(p.hprev),
      static_cast<float*>(h_out), n4, np4, p.nc);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  ssd_chunk_output<T><<<dim3(p.nc, p.head_groups, B), PL::kThreads, smem_c,
                        s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace ssd

extern "C" {

// dtype (of x, Bm, Cm and y): 0 = float32, 1 = bfloat16.  Each stride
// argument points to three int64 (batch, head, seq) strides in elements, in
// host memory.  N a multiple of 4, at most 256.  `workspace` (256-byte
// aligned, `workspace_size` bytes) holds the chunk states, the states
// passed on, the decays and the score tiles (ssd::workspace; the wrapper
// computes the same size).  Returns cudaGetLastError() after the launches,
// or cudaErrorInvalidValue for a shape the kernels do not take (the wrapper
// refuses those first).
int ssd_scan_forward(const void* x, const int64_t* sx, const void* dt,
                     const int64_t* sdt, const void* A, const void* Bm,
                     const int64_t* sb, const void* Cm, const int64_t* sc,
                     void* y, const int64_t* sy, void* h_out, void* workspace,
                     int64_t workspace_size, int B, int H, int S, int P,
                     int N, int dtype, void* stream) {
  if (B <= 0 || B > 65535 || H <= 0 || H > 65535 || S <= 0 || P <= 0 ||
      N <= 0 || N > 256 || N % 4 ||
      reinterpret_cast<uintptr_t>(workspace) % 256)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0)
    return ssd::launch<float>(x, sx, dt, sdt, A, Bm, sb, Cm, sc, y, sy, h_out,
                              workspace, workspace_size, B, H, S, P, N,
                              stream);
  if (dtype == 1)
    return ssd::launch<ssd::bf16>(x, sx, dt, sdt, A, Bm, sb, Cm, sc, y, sy,
                                  h_out, workspace, workspace_size, B, H, S,
                                  P, N, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"

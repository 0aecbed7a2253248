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
// Design (FlashAttention-2's split in two kernels after D, every route):
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
//
// What bounds it on an H100: operations.  Per admitted (q, k) pair and head
// it does 4 * hd (dK/dV: S, dP, dV, dK) + 3 * hd (dQ: S, dP, dQ) multiply-
// adds, 2.5x the forward's 2 * 2 * hd flops counted as products at the bf16
// tensor-core rate (the same products as the reference's differentiated
// attention); each pair also takes an exp (and a tanh under a softcap) in
// both kernels, on the special-function units.
//
// bfloat16 (the training dtype), hd 64, 128 and 256: flash_bwd_dkdv_wgmma
// and flash_bwd_dq_wgmma.  Every product runs on the tensor cores as wgmma
// with float32 sums, fed by TMA, in the forward's plan (flash_attention.cu);
// BwdPlan below holds the tile plan by head_dim.
// - A block: 128 own rows (kv rows in dK/dV, q rows in dQ) as two consumer
//   warpgroups of 64, and a producer warpgroup whose registers go to the
//   consumers (setmaxnreg 24 / 240).  The own rows' two tiles (K and V, or
//   Q and dO) arrive once by TMA; the streamed tiles of 64 rows (Q and dO,
//   or K and V) through a ring of three stages with mbarriers, all in the
//   128-byte swizzle, through 3-D [B*H, S, hd] maps whose zero fill never
//   reads the next head's rows.  In dK/dV, the producer warp's lanes also
//   copy the stage's 64 lse and D values into shared memory (the rows past
//   Sq as lse +inf, D 0), since a q tile's stats need not lie on 16 bytes
//   for a bulk copy.
// - dK/dV, per q tile and warpgroup: S^T = K.Q^T and dP^T = V.dO^T with
//   both operands K-major; P^T = exp(softcap(scale S^T) - lse) and dS^T =
//   P^T o (dP^T - D) o (1 - (s/c)^2) in float32 registers; dV += P^T.dO and
//   dK += dS^T.Q with the A operand the packed accumulator (as the forward
//   packs P) and dO, Q MN-major through the transpose bit.  dK, dV stay in
//   registers (64 + 64 a thread at hd 128) until the epilogue scales dK by
//   1/sqrt(hd) and rounds each once to bf16.
// - dQ, per kv tile: S = Q.K^T, dP = dO.V^T, dS in registers, dQ += dS.K
//   with K MN-major; each thread's two rows' lse and D in registers.
// - Precision: P and dS are the only values the products round; Q, K, V
//   and dO are bf16 already and the sums float32.  Each of the three
//   products that read P or dS takes it split, x = bf16(x) + bf16(x -
//   bf16(x)), two products (about 16 bits of x, as the forward splits P):
//   one bf16 rounding (2^-9) moves a gradient of a row with few admitted
//   keys by up to a rounding step of bf16 (tests/test_torch_flash_backward.py
//   holds a CPU model of this arithmetic, split and not, to the limits).
//   10 products of hd multiply-adds a pair instead of 7 (12 at hd 256,
//   below): the bound stays the function's.
// - Each warpgroup skips the streamed tiles its own rows' range does not
//   reach (it still waits for and frees each stage); the per-element mask
//   runs only on tiles tile_admitted() does not pass whole, and rows past
//   Sq (TMA's zero fill) are masked there, never read through exp(x - 0).
// - The blocks with the most tiles launch first: low kv tiles in dK/dV,
//   high q tiles in dQ (the causal mask's long ranges).
// - After each pair of products the warpgroup waits for them, and every
//   product opens with its own wgmma.fence (or ptxas serializes them, see
//   flash_attention.cu); S and dP are zeroed before each tile's products,
//   so the previous tile's values are dead while dK and dV are live.
// - hd 256 (BwdPlan<256>).  dK/dV: dK and dV of 64 rows x 256 columns take
//   256 float32 registers a thread in one warpgroup, so a block owns 64 kv
//   rows and each warpgroup 128 of their columns (64 + 64 registers, as at
//   hd 128).  The S^T and dP^T products contract over all 256 columns:
//   each warpgroup computes the whole 64 x 64 tile of both itself (no
//   exchange through shared memory and no barrier between the warpgroups,
//   at 1.33x the dK/dV tensor work of computing each once), then dV and dK
//   over its columns (m64n128,
//   the tile's column blocks 2 wg and 2 wg + 1).  K and V (64 KB) and two
//   stages of Q and dO tiles (128 KB) fill 193 KB; three stages would take
//   257 KB.  With 64-row kv tiles a kv head has ceil(Skv / 64) blocks,
//   68 at PaliGemma-3B's 4,352 training positions with its one kv head,
//   for 132 SMs: the group's q heads are split over head_splits blocks a kv
//   tile (the wrapper picks the smallest divisor of the group that gives
//   at least 1.5 blocks an SM: 4 there, 272 blocks), each writing float32
//   partials of dK and dV, and flash_bwd_dkdv_sum adds them in split order
//   (no atomics), scales dK and rounds each once.  dQ: 128 own q rows of Q
//   and dO take 128 KB, so the kv tiles are 32 rows (m64n32 S and dP, two
//   k steps of m64n256 for dQ) in three stages (96 KB; 225 KB in all); dQ
//   is 128 float32 registers a thread, as the forward's O at hd 256.
//
// float32 (flash_bwd_dkdv, flash_bwd_dq): float32 FMAs on the CUDA cores.
// TF32 (10-bit mantissa) could not hold float32 gradients to 1e-4 of their
// largest.  Each product is a small float32 GEMM out of shared memory (mm
// below), each thread owning a (rows / 16) x (columns / 16) piece of the
// output on rows ty + 16 i and columns tx + 16 j; tiles are stored
// row-major with one float of padding (an odd row stride), so reading a
// tile along its rows or its columns hits distinct banks; each gradient is
// rounded once.  They run at the CUDA cores' 67 TFLOP/s, far below the
// tensor cores' bound.

#include <cmath>
#include <type_traits>

#include "attention_common.cuh"
#include "hopper.cuh"

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

// rows [r0, r0 + R) of a [rows, HD] tensor into dst [R][HD + 1], zeros past
// `rows`
template <int R, int HD>
__device__ __forceinline__ void load_rows(const float* __restrict__ src,
                                          int r0,
                                          int rows, float* __restrict__ dst,
                                          int tid) {
  for (int e = tid * 4; e < R * HD; e += kThreads * 4) {
    const int r = e / HD, d = e % HD;
    float f[4] = {0.f, 0.f, 0.f, 0.f};
    if (r0 + r < rows) load_f32<float, 4>(src + int64_t(r0 + r) * HD + d, f);
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

template <int HD>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, const float* __restrict__ dout,
               const float* __restrict__ lse, const float* __restrict__ delta,
               float* __restrict__ dk, float* __restrict__ dv, int Hq,
               int Hkv,
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
  load_rows<BK, HD>(k + kv_row0 * HD, k0, Skv, Ks, tid);
  load_rows<BK, HD>(v + kv_row0 * HD, k0, Skv, Vs, tid);

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
      load_rows<BQ, HD>(q + row0 * HD, q0, Sq, Qs, tid);
      load_rows<BQ, HD>(dout + row0 * HD, q0, Sq, dOs, tid);
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
        dk[at] = dk_acc[i][j] * scale;
        dv[at] = dv_acc[i][j];
      }
    }
  }
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, const float* __restrict__ dout,
             const float* __restrict__ lse, const float* __restrict__ delta,
             float* __restrict__ dq, int Hq, int Hkv, int Sq, int Skv,
             int causal,
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
  load_rows<BQ, HD>(q + row0 * HD, q0, Sq, Qs, tid);
  load_rows<BQ, HD>(dout + row0 * HD, q0, Sq, dOs, tid);
  load_stats<BQ>(lse, delta, row0, q0, Sq, lse_s, d_s, tid);

  float dq_acc[BQ / 16][HD / 16];
  zero(dq_acc);
  // the forward's kv range for rows [q0, q_last]
  const Range kr = kv_range(q0, min(q0 + BQ, Sq) - 1, Skv, causal, window,
                            prefix);
  for (int k0 = (kr.lo / BK) * BK; k0 < kr.hi; k0 += BK) {
    __syncthreads();  // the previous tile's K, V and dS are consumed
    load_rows<BK, HD>(k + kv_row0 * HD, k0, Skv, Ks, tid);
    load_rows<BK, HD>(v + kv_row0 * HD, k0, Skv, Vs, tid);
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
        dq[(row0 + qi) * HD + tx + 16 * j] = dq_acc[i][j] * scale;
    }
  }
}

// -- bfloat16: wgmma products fed by TMA -------------------------------------

constexpr int kWgConsumers = 2;
// + a producer warpgroup (registers are granted per 128 threads, so it
// hands its share to the consumers)
constexpr int kWgThreads = (kWgConsumers + 1) * 128;
constexpr int kSwRow = 128;   // bytes of a swizzled row: 64 bf16

// The tile plan by head_dim (the header's bf16 design).  dK/dV: a block's
// own kv rows, the first own row and the first dK/dV column of warpgroup 1
// (warpgroup 0 starts at 0), its dK/dV columns, the streamed q tile's rows
// and the ring's stages.  dQ: a block's own q rows (two warpgroups of 64),
// the streamed kv tile's rows and the stages.
template <int HD>
struct BwdPlan {
  static constexpr bool kWide = HD == 256;   // the hd-256 plan
  static constexpr int kKvOwn = kWide ? 64 : 128;
  static constexpr int kKvRowStep = kWide ? 0 : 64;
  static constexpr int kKvColStep = kWide ? 128 : 0;
  static constexpr int kKvCols = kWide ? 128 : HD;
  static constexpr int kQTile = 64;
  static constexpr int kKvStages = kWide ? 2 : 3;
  static constexpr int kQOwn = 128;
  static constexpr int kKvTile = kWide ? 32 : 64;
  static constexpr int kQStages = 3;
  static constexpr int kKvAlloc =
      2 * kKvOwn * HD * 2 + kKvStages * 2 * kQTile * HD * 2 + 1024;
  static constexpr int kQAlloc =
      2 * kQOwn * HD * 2 + kQStages * 2 * kKvTile * HD * 2 + 1024;
  // the extra 1,024 bytes align the ring to the swizzle atoms; a block's
  // static shared memory (barriers, stats) is under 2 KB
  static_assert(kKvAlloc + 2048 <= 232448 && kQAlloc + 2048 <= 232448,
                "above a block's shared memory");
};

// Registers of a producer and a consumer thread, every head_dim: producer
// * 128 + consumer * 256 must not exceed the 168 * 384 the block is
// launched with.  At 40 / 232 the dK/dV kernel spilled 8-16 bytes at hd
// 128 and 256 (ptxas); the producer's lse / D copy fits in 24.
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;
static_assert(kProducerRegs * 128 + kConsumerRegs * 256 <= 168 * 384,
              "above the block's registers");

// The float32 [B, Hq, Sq] D at the start of the workspace, rounded up to
// 64 floats; the hd-256 dK/dV partials follow it (kernels/flash_attention.py
// sizes the workspace by the same rule)
inline int64_t delta_floats(int64_t rows) { return (rows + 63) / 64 * 64; }

// the swizzle atoms need 1,024-byte aligned shared addresses
__device__ __forceinline__ uint8_t* align_1024(uint8_t* p) {
  return p + ((1024 - (hopper::smem_u32(p) & 1023)) & 1023);
}

// D[64 x N] = A.B^T over the head dim, issued (not waited for): A the
// warpgroup's 64 rows at a_addr in column blocks of a_rows rows, B N rows
// at b_addr in column blocks of b_rows rows, both K-major
template <int HD, int N>
__device__ __forceinline__ void product_ss(float (&d)[N / 2], uint32_t a_addr,
                                           int a_rows, uint32_t b_addr,
                                           int b_rows) {
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const uint32_t off = (kk % 4) * 32;  // 16 columns
    const uint64_t da = hopper::sw128_desc(
        a_addr + (kk / 4) * a_rows * kSwRow + off, 16, 1024);
    const uint64_t db = hopper::sw128_desc(
        b_addr + (kk / 4) * b_rows * kSwRow + off, 16, 1024);
    if constexpr (N == 64) hopper::wgmma_ss_n64(d, da, db, kk > 0);
    else hopper::wgmma_ss_n32(d, da, db, kk > 0);
  }
}

// acc[64 x N] += X.B, issued: X's 16 KS columns as bf16 hi and lo parts in
// registers, B a streamed tile at b_addr, MN-major (a k step is 16 rows,
// 2,048 bytes; its 64-column blocks lie lbo bytes apart)
template <int N, int KS>
__device__ __forceinline__ void product_rs(float (&acc)[N / 2],
                                           const uint32_t (&hi)[KS][4],
                                           const uint32_t (&lo)[KS][4],
                                           uint32_t b_addr, uint32_t lbo) {
#pragma unroll
  for (int c = 0; c < KS; ++c) {
    const uint64_t db = hopper::sw128_desc(b_addr + c * 16 * kSwRow, lbo,
                                           1024);
    if constexpr (N == 256) {
      hopper::wgmma_rs_n256(acc, hi[c], db);
      hopper::wgmma_rs_n256(acc, lo[c], db);
    } else if constexpr (N == 128) {
      hopper::wgmma_rs_n128(acc, hi[c], db);
      hopper::wgmma_rs_n128(acc, lo[c], db);
    } else {
      hopper::wgmma_rs_n64(acc, hi[c], db);
      hopper::wgmma_rs_n64(acc, lo[c], db);
    }
  }
}

constexpr float kLog2e = 1.4426950408889634f;

// One score's P and dS in place: s holds q.k (unscaled), dp holds dO.v,
// lse2 and d its q row's lse * log2(e) and D; P = exp2(x log2(e) - lse2)
// with x the scaled (CAP: soft-capped) score; scale2 = scale * log2(e)
template <bool CAP>
__device__ __forceinline__ void p_and_ds(float& s, float& dp, float lse2,
                                         float d, float scale, float scale2,
                                         float softcap, float inv_cap) {
  if constexpr (CAP) {
    const float t = tanhf(s * scale * inv_cap);
    const float p = exp2f(fmaf(softcap * t, kLog2e, -lse2));
    s = p;
    dp = p * (dp - d) * (1.f - t * t);
  } else {
    const float p = exp2f(fmaf(s, scale2, -lse2));
    s = p;
    dp = p * (dp - d);
  }
}

template <int N>
__device__ __forceinline__ void zero_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) d[i] = 0.f;
}

// part: null below hd 256; there float32 [2][splits][B * Hkv * Skv][HD],
// dK's partials (unscaled) before dV's, one per head split
template <int HD>
__global__ void __launch_bounds__(kWgThreads, 1)
flash_bwd_dkdv_wgmma(const __grid_constant__ CUtensorMap tm_q,
                     const __grid_constant__ CUtensorMap tm_do,
                     const __grid_constant__ CUtensorMap tm_k,
                     const __grid_constant__ CUtensorMap tm_v,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta,
                     __nv_bfloat16* __restrict__ dk,
                     __nv_bfloat16* __restrict__ dv, float* __restrict__ part,
                     int Hq, int Hkv, int Sq, int Skv, int causal, int window,
                     float softcap, int prefix, float scale, int splits) {
  using namespace hopper;
  using L = BwdPlan<HD>;
  constexpr int BK = L::kKvOwn, BQ = L::kQTile, ST = L::kKvStages;
  constexpr int NC = L::kKvCols;
  constexpr int NCB = HD / 64;  // 64-column blocks of a row
  constexpr int kOwn = BK * HD * 2, kTile = BQ * HD * 2;
  extern __shared__ uint8_t smem_raw[];
  __shared__ uint64_t bar_kv, bar_full[ST], bar_free[ST];
  // lse * log2(e) and D of each stage's q rows
  __shared__ float stats[ST][2][BQ];
  uint8_t* Ks = align_1024(smem_raw);
  uint8_t* Vs = Ks + kOwn;
  uint8_t* Qs = Vs + kOwn;            // stage s at Qs + s * kTile
  uint8_t* dOs = Qs + ST * kTile;

  // the low kv tiles, which the causal mask gives the most q tiles, first:
  // blockIdx.z runs slowest
  const int k0 = blockIdx.z * BK;
  const int hk = blockIdx.x / splits, split = blockIdx.x % splits;
  const int b = blockIdx.y;
  // this block's q heads: a 1 / splits share of the group
  const int heads = Hq / Hkv / splits;
  const int h0 = hk * (Hq / Hkv) + split * heads;
  // the q rows the mask admits for keys [k0, k_last]; the stream is the
  // block's q heads times these q tiles
  const Range qr = q_range(k0, min(k0 + BK, Skv) - 1, Sq, causal, window,
                           prefix);
  const int q_lo = (qr.lo / BQ) * BQ;
  const int n_qt = qr.hi > q_lo ? (qr.hi - q_lo + BQ - 1) / BQ : 0;
  const int n_tiles = heads * n_qt;

  const int tid = threadIdx.x;
  if (tid == 0) {
    mbar_init(&bar_kv, 1);
    for (int s = 0; s < ST; ++s) {
      mbar_init(&bar_full[s], 32);  // the producer warp's lanes
      mbar_init(&bar_free[s], kWgConsumers);
    }
    mbar_init_fence();
  }
  __syncthreads();
  // the warp index broadcast from lane 0, so that ptxas keeps it and every
  // descriptor derived from it in uniform registers (flash_attention.cu)
  const int warp = __shfl_sync(0xffffffffu, tid / 32, 0);
  const int lane = tid % 32;

  if (warp >= kWgConsumers * 4) {
    // producer: one warp; tile j goes to stage j % ST once both warpgroups
    // have freed tile j - ST there.  Its lanes copy the tile's lse and D,
    // lane 0 issues the loads.
    setmaxnreg_dec<kProducerRegs>();
    if (warp == kWgConsumers * 4) {
      if (lane == 0) {
        const int zk = b * Hkv + hk;
        mbar_expect_tx(&bar_kv, 2 * kOwn);
        for (int c = 0; c < NCB; ++c) {
          tma_load_3d(Ks + c * BK * kSwRow, &tm_k, &bar_kv, c * 64, k0, zk);
          tma_load_3d(Vs + c * BK * kSwRow, &tm_v, &bar_kv, c * 64, k0, zk);
        }
      }
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % ST;
        if (j >= ST) mbar_wait(&bar_free[s], ((j / ST) - 1) & 1);
        const int h = h0 + j / n_qt;
        const int q0 = q_lo + (j % n_qt) * BQ;
        const int64_t row0 = (int64_t(b) * Hq + h) * Sq;
        for (int r = lane; r < BQ; r += 32) {
          const bool in = q0 + r < Sq;
          stats[s][0][r] = in ? lse[row0 + q0 + r] * kLog2e : pos_inf();
          stats[s][1][r] = in ? delta[row0 + q0 + r] : 0.f;
        }
        if (lane == 0) {
          const int zq = b * Hq + h;
          uint8_t* qd = Qs + s * kTile;
          uint8_t* dd = dOs + s * kTile;
          mbar_expect_tx(&bar_full[s], 2 * kTile);
          for (int c = 0; c < NCB; ++c) {
            tma_load_3d(qd + c * BQ * kSwRow, &tm_q, &bar_full[s], c * 64,
                        q0, zq);
            tma_load_3d(dd + c * BQ * kSwRow, &tm_do, &bar_full[s], c * 64,
                        q0, zq);
          }
        } else {
          mbar_arrive(&bar_full[s]);
        }
      }
    }
    return;
  }

  // consumer warpgroup wg: kv rows ka..ka+63 and dK/dV columns
  // col0..col0+NC-1; this thread holds rows r0 and r0 + 8 at columns
  // 8i + cq + {0, 1} of every accumulator (q columns of S^T and dP^T,
  // head-dim columns of dK and dV)
  setmaxnreg_inc<kConsumerRegs>();
  const int wg = warp / 4;
  const int ka = k0 + wg * L::kKvRowStep;
  const int col0 = wg * L::kKvColStep;
  const int r0 = ka + (warp % 4) * 16 + lane / 4;
  const int cq = 2 * (lane % 4);
  const uint32_t k_addr = smem_u32(Ks) + wg * L::kKvRowStep * kSwRow;
  const uint32_t v_addr = smem_u32(Vs) + wg * L::kKvRowStep * kSwRow;
  // this warpgroup's dK/dV columns in a streamed tile: their first
  // 64-column block
  const uint32_t col_off = (col0 / 64) * BQ * kSwRow;
  const float inv_cap = softcap > 0.f ? 1.f / softcap : 0.f;
  const float scale2 = scale * kLog2e;
  // the q rows this warpgroup's own keys admit (none past Skv)
  const Range wr = ka < Skv ? q_range(ka, min(ka + 63, Skv - 1), Sq, causal,
                                      window, prefix)
                            : Range{0, 0};

  float dk_acc[NC / 2], dv_acc[NC / 2];
  zero_regs(dk_acc);
  zero_regs(dv_acc);
  float sc[BQ / 2], dp[BQ / 2];
  uint32_t p_hi[BQ / 16][4], p_lo[BQ / 16][4], ds_hi[BQ / 16][4],
      ds_lo[BQ / 16][4];

  mbar_wait(&bar_kv, 0);
  for (int j = 0; j < n_tiles; ++j) {
    const int s = j % ST;
    const int q0 = q_lo + (j % n_qt) * BQ;
    mbar_wait(&bar_full[s], (j / ST) & 1);
    if (q0 < wr.hi && q0 + BQ > wr.lo) {
      const uint32_t q_addr = smem_u32(Qs + s * kTile);
      const uint32_t do_addr = smem_u32(dOs + s * kTile);
      // S^T = K.Q^T, dP^T = V.dO^T (at hd 256 both warpgroups compute the
      // whole tile: the contraction runs over every column)
      zero_regs(sc);
      zero_regs(dp);
      fence_regs(sc);
      fence_regs(dp);
      wgmma_fence();
      product_ss<HD, BQ>(sc, k_addr, BK, q_addr, BQ);
      wgmma_fence();
      product_ss<HD, BQ>(dp, v_addr, BK, do_addr, BQ);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);
      fence_regs(dp);
      // P^T and dS^T; the mask only on a tile that crosses an edge
      const float* lse_s = stats[s][0];
      const float* d_s = stats[s][1];
      auto scores = [&](auto cap) {
#pragma unroll
        for (int e = 0; e < BQ / 2; ++e) {
          const int c = (e / 4) * 8 + cq + (e & 1);  // q row q0 + c
          p_and_ds<decltype(cap)::value>(sc[e], dp[e], lse_s[c], d_s[c],
                                         scale, scale2, softcap, inv_cap);
        }
      };
      if (softcap > 0.f) scores(std::true_type{});
      else scores(std::false_type{});
      if (!tile_admitted(q0, q0 + BQ - 1, ka, ka + 63, Sq, Skv, causal,
                         window, prefix)) {
#pragma unroll
        for (int e = 0; e < BQ / 2; ++e) {
          const int qi = q0 + (e / 4) * 8 + cq + (e & 1);
          const int kj = r0 + ((e & 2) ? 8 : 0);
          if (!(qi < Sq && admitted(qi, kj, Skv, causal, window, prefix))) {
            sc[e] = 0.f;
            dp[e] = 0.f;
          }
        }
      }
      // dV += P^T.dO, then (its operand packed while dV runs) dK += dS^T.Q,
      // each over this warpgroup's columns
      split_bf16(sc, p_hi, p_lo);
      fence_regs(dv_acc);
      fence_regs(p_hi);
      fence_regs(p_lo);
      wgmma_fence();
      product_rs<NC, BQ / 16>(dv_acc, p_hi, p_lo, do_addr + col_off,
                              BQ * kSwRow);
      wgmma_commit();
      split_bf16(dp, ds_hi, ds_lo);
      fence_regs(dk_acc);
      fence_regs(ds_hi);
      fence_regs(ds_lo);
      wgmma_fence();  // a fence per product, or ptxas serializes them
      product_rs<NC, BQ / 16>(dk_acc, ds_hi, ds_lo, q_addr + col_off,
                              BQ * kSwRow);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dv_acc);
      fence_regs(dk_acc);
      fence_regs(p_hi);
      fence_regs(p_lo);
      fence_regs(ds_hi);
      fence_regs(ds_lo);
    }
    // this warpgroup's products of the stage are complete (a product
    // starts only once all four warps have issued it, after their reads of
    // the stage's stats): its thread 0 frees the stage
    if ((warp % 4) == 0 && lane == 0) mbar_arrive(&bar_free[s]);
  }

  // epilogue: below hd 256, dK scaled by 1/sqrt(hd) and each gradient
  // rounded once; at 256, this head split's float32 partials
  // (flash_bwd_dkdv_sum scales, sums and rounds them)
  const int64_t kv_base = (int64_t(b) * Hkv + hk) * Skv;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int kj = r0 + 8 * r;
    if (kj < Skv) {
      if constexpr (L::kWide) {
        const int64_t plane = int64_t(gridDim.y) * Hkv * Skv * HD;
        float* krow = part + split * plane + (kv_base + kj) * HD + col0 + cq;
        float* vrow = krow + splits * plane;
#pragma unroll
        for (int i = 0; i < NC / 8; ++i) {
          *reinterpret_cast<float2*>(krow + 8 * i) =
              make_float2(dk_acc[4 * i + 2 * r], dk_acc[4 * i + 2 * r + 1]);
          *reinterpret_cast<float2*>(vrow + 8 * i) =
              make_float2(dv_acc[4 * i + 2 * r], dv_acc[4 * i + 2 * r + 1]);
        }
      } else {
        __nv_bfloat16* krow = dk + (kv_base + kj) * HD + cq;
        __nv_bfloat16* vrow = dv + (kv_base + kj) * HD + cq;
#pragma unroll
        for (int i = 0; i < NC / 8; ++i) {
          *reinterpret_cast<__nv_bfloat162*>(krow + 8 * i) =
              __floats2bfloat162_rn(dk_acc[4 * i + 2 * r] * scale,
                                    dk_acc[4 * i + 2 * r + 1] * scale);
          *reinterpret_cast<__nv_bfloat162*>(vrow + 8 * i) =
              __floats2bfloat162_rn(dv_acc[4 * i + 2 * r],
                                    dv_acc[4 * i + 2 * r + 1]);
        }
      }
    }
  }
}

// hd 256: dK and dV from the head splits' float32 partials (part as
// flash_bwd_dkdv_wgmma's, n = B * Hkv * Skv * 256 elements a split), summed
// in split order, dK scaled by 1/sqrt(hd), each rounded once; four
// elements a thread
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_sum(const float* __restrict__ part, int splits, int64_t n,
                   __nv_bfloat16* __restrict__ dk,
                   __nv_bfloat16* __restrict__ dv, float scale) {
  const int64_t i = (int64_t(blockIdx.x) * kThreads + threadIdx.x) * 4;
  if (i >= n) return;
#pragma unroll
  for (int t = 0; t < 2; ++t) {
    float4 acc = *reinterpret_cast<const float4*>(part + t * splits * n + i);
    for (int s = 1; s < splits; ++s) {
      const float4 x = *reinterpret_cast<const float4*>(
          part + (t * splits + s) * n + i);
      acc.x += x.x;
      acc.y += x.y;
      acc.z += x.z;
      acc.w += x.w;
    }
    const float f = t == 0 ? scale : 1.f;
    __nv_bfloat162* out =
        reinterpret_cast<__nv_bfloat162*>((t == 0 ? dk : dv) + i);
    out[0] = __floats2bfloat162_rn(acc.x * f, acc.y * f);
    out[1] = __floats2bfloat162_rn(acc.z * f, acc.w * f);
  }
}

template <int HD>
__global__ void __launch_bounds__(kWgThreads, 1)
flash_bwd_dq_wgmma(const __grid_constant__ CUtensorMap tm_q,
                   const __grid_constant__ CUtensorMap tm_do,
                   const __grid_constant__ CUtensorMap tm_k,
                   const __grid_constant__ CUtensorMap tm_v,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta,
                   __nv_bfloat16* __restrict__ dq, int Hq, int Hkv, int Sq,
                   int Skv, int causal, int window, float softcap, int prefix,
                   float scale) {
  using namespace hopper;
  using L = BwdPlan<HD>;
  constexpr int BQ = L::kQOwn, BK = L::kKvTile, ST = L::kQStages;
  constexpr int NCB = HD / 64;
  constexpr int kOwn = BQ * HD * 2, kTile = BK * HD * 2;
  extern __shared__ uint8_t smem_raw[];
  __shared__ uint64_t bar_q, bar_full[ST], bar_free[ST];
  uint8_t* Qs = align_1024(smem_raw);
  uint8_t* dOs = Qs + kOwn;
  uint8_t* Ks = dOs + kOwn;           // stage s at Ks + s * kTile
  uint8_t* Vs = Ks + ST * kTile;

  // the q tiles with the most kv tiles (the last, under the causal mask)
  // first: blockIdx.z runs slowest
  const int q0 = int(gridDim.z - 1 - blockIdx.z) * BQ;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int hk = h / (Hq / Hkv);
  const Range kr = kv_range(q0, min(q0 + BQ, Sq) - 1, Skv, causal, window,
                            prefix);
  const int k_lo = (kr.lo / BK) * BK;
  const int n_tiles = kr.hi > k_lo ? (kr.hi - k_lo + BK - 1) / BK : 0;

  const int tid = threadIdx.x;
  if (tid == 0) {
    mbar_init(&bar_q, 1);
    for (int s = 0; s < ST; ++s) {
      mbar_init(&bar_full[s], 1);
      mbar_init(&bar_free[s], kWgConsumers);
    }
    mbar_init_fence();
  }
  __syncthreads();
  const int warp = __shfl_sync(0xffffffffu, tid / 32, 0);
  const int lane = tid % 32;

  if (warp >= kWgConsumers * 4) {
    // producer: one thread issues every load
    setmaxnreg_dec<kProducerRegs>();
    if (warp == kWgConsumers * 4 && lane == 0) {
      const int zq = b * Hq + h, zk = b * Hkv + hk;
      mbar_expect_tx(&bar_q, 2 * kOwn);
      for (int c = 0; c < NCB; ++c) {
        tma_load_3d(Qs + c * BQ * kSwRow, &tm_q, &bar_q, c * 64, q0, zq);
        tma_load_3d(dOs + c * BQ * kSwRow, &tm_do, &bar_q, c * 64, q0, zq);
      }
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % ST;
        if (j >= ST) mbar_wait(&bar_free[s], ((j / ST) - 1) & 1);
        const int kt = k_lo + j * BK;
        uint8_t* kd = Ks + s * kTile;
        uint8_t* vd = Vs + s * kTile;
        mbar_expect_tx(&bar_full[s], 2 * kTile);
        for (int c = 0; c < NCB; ++c) {
          tma_load_3d(kd + c * BK * kSwRow, &tm_k, &bar_full[s], c * 64, kt,
                      zk);
          tma_load_3d(vd + c * BK * kSwRow, &tm_v, &bar_full[s], c * 64, kt,
                      zk);
        }
      }
    }
    return;
  }

  // consumer warpgroup wg: q rows qa..qa+63; this thread holds rows r0 and
  // r0 + 8 (kv columns of S and dP, head-dim columns of dQ)
  setmaxnreg_inc<kConsumerRegs>();
  const int wg = warp / 4;
  const int qa = q0 + wg * 64;
  const int r0 = qa + (warp % 4) * 16 + lane / 4;
  const int cq = 2 * (lane % 4);
  const uint32_t q_addr = smem_u32(Qs) + wg * 64 * kSwRow;
  const uint32_t do_addr = smem_u32(dOs) + wg * 64 * kSwRow;
  const float inv_cap = softcap > 0.f ? 1.f / softcap : 0.f;
  const float scale2 = scale * kLog2e;
  const int64_t row0 = (int64_t(b) * Hq + h) * Sq;
  // this thread's rows' lse * log2(e) and D; a row past Sq gets lse +inf
  // (P = 0)
  float lse_r[2], d_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = r0 + 8 * r;
    lse_r[r] = qi < Sq ? lse[row0 + qi] * kLog2e : pos_inf();
    d_r[r] = qi < Sq ? delta[row0 + qi] : 0.f;
  }
  // the keys this warpgroup's own rows admit (none past Sq)
  const Range wr = qa < Sq ? kv_range(qa, min(qa + 63, Sq - 1), Skv, causal,
                                      window, prefix)
                           : Range{0, 0};

  float dq_acc[HD / 2];
  zero_regs(dq_acc);
  float sc[BK / 2], dp[BK / 2];
  uint32_t ds_hi[BK / 16][4], ds_lo[BK / 16][4];

  mbar_wait(&bar_q, 0);
  for (int j = 0; j < n_tiles; ++j) {
    const int s = j % ST;
    const int kt = k_lo + j * BK;
    mbar_wait(&bar_full[s], (j / ST) & 1);
    if (kt < wr.hi && kt + BK > wr.lo) {
      const uint32_t k_addr = smem_u32(Ks + s * kTile);
      const uint32_t v_addr = smem_u32(Vs + s * kTile);
      // S = Q.K^T, dP = dO.V^T
      zero_regs(sc);
      zero_regs(dp);
      fence_regs(sc);
      fence_regs(dp);
      wgmma_fence();
      product_ss<HD, BK>(sc, q_addr, BQ, k_addr, BK);
      wgmma_fence();
      product_ss<HD, BK>(dp, do_addr, BQ, v_addr, BK);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);
      fence_regs(dp);
      // P and dS; the mask only on a tile that crosses an edge
      auto scores = [&](auto cap) {
#pragma unroll
        for (int e = 0; e < BK / 2; ++e) {
          const int r = (e >> 1) & 1;
          p_and_ds<decltype(cap)::value>(sc[e], dp[e], lse_r[r], d_r[r],
                                         scale, scale2, softcap, inv_cap);
        }
      };
      if (softcap > 0.f) scores(std::true_type{});
      else scores(std::false_type{});
      if (!tile_admitted(qa, qa + 63, kt, kt + BK - 1, Sq, Skv, causal,
                         window, prefix)) {
#pragma unroll
        for (int e = 0; e < BK / 2; ++e) {
          const int qi = r0 + ((e & 2) ? 8 : 0);
          const int kj = kt + (e / 4) * 8 + cq + (e & 1);
          if (!(qi < Sq && admitted(qi, kj, Skv, causal, window, prefix))) {
            sc[e] = 0.f;
            dp[e] = 0.f;
          }
        }
      }
      // dQ += dS.K
      split_bf16(dp, ds_hi, ds_lo);
      fence_regs(dq_acc);
      fence_regs(ds_hi);
      fence_regs(ds_lo);
      wgmma_fence();
      product_rs<HD, BK / 16>(dq_acc, ds_hi, ds_lo, k_addr, BK * kSwRow);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dq_acc);
      fence_regs(ds_hi);
      fence_regs(ds_lo);
    }
    if ((warp % 4) == 0 && lane == 0) mbar_arrive(&bar_free[s]);
  }

  // epilogue: scaled by 1/sqrt(hd), rounded once
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = r0 + 8 * r;
    if (qi < Sq) {
      __nv_bfloat16* qrow = dq + (row0 + qi) * HD + cq;
#pragma unroll
      for (int i = 0; i < HD / 8; ++i)
        *reinterpret_cast<__nv_bfloat162*>(qrow + 8 * i) =
            __floats2bfloat162_rn(dq_acc[4 * i + 2 * r] * scale,
                                  dq_acc[4 * i + 2 * r + 1] * scale);
    }
  }
}

// D = rowsum(dO o O) for every row, launched first on either route
template <typename T, int HD>
cudaError_t launch_delta(const void* o, const void* dout, float* delta,
                         int64_t rows, cudaStream_t stream) {
  const int64_t blocks = (rows + kThreads / 32 - 1) / (kThreads / 32);
  if (blocks > 2147483647LL) return cudaErrorInvalidValue;
  flash_bwd_delta<T, HD><<<unsigned(blocks), kThreads, 0, stream>>>(
      static_cast<const T*>(o), static_cast<const T*>(dout), delta, rows);
  return cudaGetLastError();
}

// float32: D, then the FMA kernels
template <int HD>
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
  const float* Q = static_cast<const float*>(q);
  const float* K = static_cast<const float*>(k);
  const float* V = static_cast<const float*>(v);
  const float* dO = static_cast<const float*>(dout);

  cudaError_t err = launch_delta<float, HD>(o, dout, delta,
                                            int64_t(B) * Hq * Sq, stream);
  if (err != cudaSuccess) return static_cast<int>(err);

  // above 48 KB of dynamic shared memory needs the opt-in (per device, so
  // it is set on every launch)
  err = cudaFuncSetAttribute(flash_bwd_dkdv<HD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kv_smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 kv_grid((Skv + Tl::kvBK - 1) / Tl::kvBK, Hkv, B);
  flash_bwd_dkdv<HD><<<kv_grid, kThreads, kv_smem, stream>>>(
      Q, K, V, dO, lse, delta, static_cast<float*>(dk),
      static_cast<float*>(dv), Hq, Hkv, Sq, Skv, causal, window, softcap,
      prefix, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  err = cudaFuncSetAttribute(flash_bwd_dq<HD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             q_smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 q_grid((Sq + Tl::qBQ - 1) / Tl::qBQ, Hq, B);
  flash_bwd_dq<HD><<<q_grid, kThreads, q_smem, stream>>>(
      Q, K, V, dO, lse, delta, static_cast<float*>(dq), Hq, Hkv, Sq, Skv,
      causal, window, softcap, prefix, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int HD>
int launch_backward_wgmma(const void* q, const void* k, const void* v,
                          const void* o, const float* lse, const void* dout,
                          void* dq, void* dk, void* dv, float* ws, int B,
                          int Hq, int Hkv, int Sq, int Skv, int causal,
                          int window, float softcap, int prefix, int splits,
                          cudaStream_t stream) {
  using hopper::encode_map;
  using L = BwdPlan<HD>;
  const int n_kt = (Skv + L::kKvOwn - 1) / L::kKvOwn;
  const int n_qt = (Sq + L::kQOwn - 1) / L::kQOwn;
  // a head split below hd 256 would have its blocks write the same rows
  if (n_kt > 65535 || n_qt > 65535 || splits < 1 || (Hq / Hkv) % splits
      || (!L::kWide && splits != 1) || int64_t(Hkv) * splits > 2147483647LL)
    return static_cast<int>(cudaErrorInvalidValue);
  // dK/dV's streamed q tiles and own kv rows, dQ's own q rows and streamed
  // kv tiles
  CUtensorMap q_tile, do_tile, k_own, v_own, q_own, do_own, k_tile, v_tile;
  if (!encode_map(&q_tile, q, B * Hq, Sq, HD, L::kQTile)
      || !encode_map(&do_tile, dout, B * Hq, Sq, HD, L::kQTile)
      || !encode_map(&k_own, k, B * Hkv, Skv, HD, L::kKvOwn)
      || !encode_map(&v_own, v, B * Hkv, Skv, HD, L::kKvOwn)
      || !encode_map(&q_own, q, B * Hq, Sq, HD, L::kQOwn)
      || !encode_map(&do_own, dout, B * Hq, Sq, HD, L::kQOwn)
      || !encode_map(&k_tile, k, B * Hkv, Skv, HD, L::kKvTile)
      || !encode_map(&v_tile, v, B * Hkv, Skv, HD, L::kKvTile))
    return static_cast<int>(cudaErrorInvalidValue);
  const float scale = static_cast<float>(1.0 / std::sqrt(double(HD)));
  float* delta = ws;
  float* part = L::kWide ? ws + delta_floats(int64_t(B) * Hq * Sq) : nullptr;
  auto* dk16 = static_cast<__nv_bfloat16*>(dk);
  auto* dv16 = static_cast<__nv_bfloat16*>(dv);

  cudaError_t err = launch_delta<__nv_bfloat16, HD>(
      o, dout, delta, int64_t(B) * Hq * Sq, stream);
  if (err != cudaSuccess) return static_cast<int>(err);

  err = cudaFuncSetAttribute(flash_bwd_dkdv_wgmma<HD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             L::kKvAlloc);
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_bwd_dkdv_wgmma<HD>
      <<<dim3(Hkv * splits, B, n_kt), kWgThreads, L::kKvAlloc, stream>>>(
          q_tile, do_tile, k_own, v_own, lse, delta, dk16, dv16, part, Hq,
          Hkv, Sq, Skv, causal, window, softcap, prefix, scale, splits);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  err = cudaFuncSetAttribute(flash_bwd_dq_wgmma<HD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             L::kQAlloc);
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_bwd_dq_wgmma<HD><<<dim3(Hq, B, n_qt), kWgThreads, L::kQAlloc,
                           stream>>>(
      q_own, do_own, k_tile, v_tile, lse, delta,
      static_cast<__nv_bfloat16*>(dq), Hq, Hkv, Sq, Skv, causal, window,
      softcap, prefix, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess || !L::kWide) return static_cast<int>(err);

  const int64_t n = int64_t(B) * Hkv * Skv * HD;
  const int64_t blocks = (n / 4 + kThreads - 1) / kThreads;
  if (blocks > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  flash_bwd_dkdv_sum<<<unsigned(blocks), kThreads, 0, stream>>>(
      part, splits, n, dk16, dv16, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace bwd
}  // namespace attn

extern "C" {

// q, k, v, o, dout as the forward's (o its output, dout the gradient of o),
// lse the forward's float32 [B, Hq, Sq]; dq, dk, dv the gradients, written
// in full; workspace float32 scratch: D [B, Hq, Sq] rounded up to 64
// floats, then, for bfloat16 at hd 256 only, the dK/dV partials
// [2][head_splits][B * Hkv * Skv][256].  dtype: 0 = float32 (the
// float32-FMA kernels), 1 = bfloat16 (flash_bwd_*_wgmma); hd: 64, 128 or
// 256; the mask options as attn_flash_forward's; head_splits: the dK/dV
// blocks a kv tile's group of q heads is split over (a divisor of Hq / Hkv;
// 1 except for bfloat16 at hd 256).  Three launches on `stream` (D, dK/dV,
// dQ), a fourth at hd 256 in bfloat16 (the partials' sum).  Returns the
// first nonzero cudaGetLastError(), or cudaErrorInvalidValue for a shape the
// kernels do not take (the wrapper refuses most before calling).
int attn_flash_backward(const void* q, const void* k, const void* v,
                        const void* o, const void* lse, const void* dout,
                        void* dq, void* dk, void* dv, void* workspace, int B,
                        int Hq, int Hkv, int Sq, int Skv, int hd, int dtype,
                        int causal, int window, float softcap, int prefix_len,
                        int head_splits, void* stream) {
  if (B <= 0 || B > 65535 || Hkv <= 0 || Hq > 65535 || Hq % Hkv != 0
      || Sq <= 0 || Skv <= 0 || prefix_len < 0 || prefix_len > Skv
      || (prefix_len > 0 && (!causal || window > 0))
      || (dtype == 0 && head_splits != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const float* L = static_cast<const float*>(lse);
  float* W = static_cast<float*>(workspace);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int P = prefix_len;
  if (dtype == 0 && hd == 64)
    return attn::bwd::launch_backward<64>(
        q, k, v, o, L, dout, dq, dk, dv, W, B, Hq, Hkv, Sq, Skv, causal,
        window, softcap, P, st);
  if (dtype == 0 && hd == 128)
    return attn::bwd::launch_backward<128>(
        q, k, v, o, L, dout, dq, dk, dv, W, B, Hq, Hkv, Sq, Skv, causal,
        window, softcap, P, st);
  if (dtype == 0 && hd == 256)
    return attn::bwd::launch_backward<256>(
        q, k, v, o, L, dout, dq, dk, dv, W, B, Hq, Hkv, Sq, Skv, causal,
        window, softcap, P, st);
#define ATTN_BWD_WGMMA(HD)                                                  \
  return attn::bwd::launch_backward_wgmma<HD>(                              \
      q, k, v, o, L, dout, dq, dk, dv, W, B, Hq, Hkv, Sq, Skv, causal,      \
      window, softcap, P, head_splits, st)
  if (dtype == 1 && hd == 64) ATTN_BWD_WGMMA(64);
  if (dtype == 1 && hd == 128) ATTN_BWD_WGMMA(128);
  if (dtype == 1 && hd == 256) ATTN_BWD_WGMMA(256);
#undef ATTN_BWD_WGMMA
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"

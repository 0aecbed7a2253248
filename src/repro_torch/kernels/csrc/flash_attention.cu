// Causal / sliding-window / prefix-LM / bidirectional flash attention
// (prefill), for sm_90a.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py:125
// (flash_attention / _kernel).  Same function: scores q.k / sqrt(hd) in
// float32, optional softcap c*tanh(s/c), mask k <= q (causal) and
// k > q - window (window > 0) with masked scores -2e38, online softmax, and
// the output acc / max(l, 1e-37) in q's dtype.  GQA: q head h reads kv head
// h / (Hq / Hkv).  Layouts: q, o [B, Hq, Sq, hd]; k, v [B, Hkv, Skv, hd],
// all contiguous, float32 or bfloat16, hd 64, 128 or 256.  The TPU kernel walks
// the kv axis as its innermost, sequential grid dimension and carries m / l
// / acc in VMEM scratch; blocks on Hopper run in parallel and carry nothing,
// so here a block owns a tile of q rows of one (b, q head) and loops over
// the kv tiles the mask admits ([q0 - window + 1, q_last] rounded to
// tiles).  The TPU kernel asserts Sq % block_q == 0; these mask the ragged
// edge (rows >= Sq are computed and never stored; keys >= Skv masked).
// The prefix-LM mask (causal with prefix_len P > 0: k <= q or k < P, the
// reference model's PREFIX mode, which its Pallas kernel does not take)
// widens a q tile's kv range to max(q_last + 1, P); a kv tile wholly
// below P needs no per-element mask.  causal = 0 is the bidirectional and
// cross mode (every key < Skv, Sq != Skv allowed).
// The mask and a q tile's kv range are attention_common.cuh's admitted()
// and kv_range(), which the backward kernels (flash_attention_backward.cu)
// share.  For training, each kernel also writes, when given an lse
// pointer, every row's log-sum-exp m + log(l) from the thread that writes
// its output row (+inf for a row that admits no key); serving passes null.
//
// What bounds it on an H100: operations.  Each admitted (q, k) pair costs
// 4 * hd flops of products, hundreds per byte moved, so the bound is the
// bf16 tensor cores' 989 TFLOP/s; with a softcap, each score also takes a
// tanh and an exp on the special-function units (about 0.3-0.8 ms of the
// serve path's local + global layer pair), near that bound.
//
// bfloat16 inputs (the serving dtype), hd 64, 128 and 256:
// flash_forward_wgmma.  Both products run on the tensor cores as wgmma with
// float32 sums.
// - One block: 128 q rows as two consumer warpgroups of 64 rows, and a
//   producer warpgroup whose one thread issues the loads and whose
//   registers go to the consumers (setmaxnreg: registers are granted per
//   128 threads, so even a lone producer warp costs a warpgroup's share).
//   kv tiles of 64 rows: the scores S (64 x 64), the output O (64 x hd) and
//   P as bf16 registers fit without spills (the ptxas report is printed by
//   chip_smoke.py and kept in PERF.md).
// - S = Q.K^T: wgmma m64n64k16 over hd / 16 k steps, Q and K K-major in
//   shared memory.  Scaled by 1/sqrt(hd) in float32 after the product, as
//   the plain version does (2^-3.5 is not exact in bf16, so q is not
//   pre-scaled).
// - O += P.V: P from registers (the S accumulator packed into bf16 pairs is
//   already wgmma's A register layout), V MN-major from shared memory
//   through the transpose bit, one m64n{hd}k16 product per k step.  P is
//   split, P_hi = bf16(p) and P_lo = bf16(p - P_hi), two products, so P
//   keeps about 16 bits (error ~2^-17) where one bf16 rounding (2^-9) would
//   move an output of a row with few admitted keys by ~1e-3, beyond one
//   bf16 rounding step of a value near zero.  l sums the unrounded p in
//   float32.  The split costs 1.5x the tensor work; the bound stays the
//   function's 4 * hd flops per pair.
// - Each warpgroup issues tile j's S, then tile j-1's P.V, and runs S's
//   softmax while that P.V runs (FlashAttention-3's intra-warpgroup
//   overlap); O is rescaled and P packed only after the P.V is waited for,
//   and each product opens with its own wgmma.fence: otherwise ptxas
//   serializes the products.
// - The softcap uses tanhf (accurate), not tanh.approx (2^-11 relative).
// - K and V come by TMA (cuTensorMapEncodeTiled, reached through
//   cudaGetDriverEntryPoint, so no -lcuda) into a ring of stages with
//   mbarriers, in the 128-byte swizzle the wgmma descriptors read.  A K
//   tile is freed once both warpgroups' S products have read it, a V tile
//   once their P.V products have, so the next K load starts a whole tile
//   before its S is issued.  The maps are 3-D [B*H, S, hd]: a tile past
//   the end of one (b, h)'s rows reads TMA's zero fill, never the next
//   head's rows.
// - The per-element mask runs only on tiles that cross the diagonal, the
//   window's lower edge or Skv for some row of the warpgroup.  A tile none
//   of a row's keys lie in adds exp(-2e38 - m) = 0 to it (before its first
//   admitted key, ones that the next rescale by exp(-2e38 - m) = 0
//   removes, as in the float32 kernel).  The q tiles with the most kv
//   tiles are launched first.
// - hd 256 (WgPlan<256>): the 128-row Q tile is 64 KB and a stage of K
//   and V 64 KB, so the ring has two stages (193 KB with the alignment;
//   three would take 257 KB, above the 227 KB a block may have).  32-row
//   kv tiles with three stages (160 KB) would halve S and P, but S's
//   m64n32 products read 1.5x the shared-memory bytes per flop of m64n64.
//   O takes 128 float32 registers a thread, S 32 and P's two halves 32
//   more while the P.V before runs: the producer keeps 24 registers and
//   each consumer takes 240 (24 * 128 + 240 * 256 = 168 * 384, the
//   block's allocation).
//
// float32 inputs: flash_forward, float32 FMAs on the CUDA cores out of
// shared memory (q pre-scaled in float32), hd 64, 128 and 256 (149 KB of
// shared memory at 256).  It stays because TF32 (10-bit mantissa) cannot
// hold the float32 model to 1e-4 logits nor the kernel to 3e-5 of the
// plain version.

#include <cmath>

#include "attention_common.cuh"
#include "hopper.cuh"

namespace attn {

constexpr int kFlashBQ = 64;
constexpr int kFlashBK = 64;
constexpr int kFlashThreads = 256;

template <int HD>
constexpr int flash_smem_floats() {
  // Q [BQ][HD+1], K^T [HD][BK+1] (V [BK][HD] reuses it), P [BQ][BK+1]
  return kFlashBQ * (HD + 1) + HD * (kFlashBK + 1) + kFlashBQ * (kFlashBK + 1);
}

template <int HD>
__global__ void __launch_bounds__(kFlashThreads)
flash_forward(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ o,
              float* __restrict__ lse, int Hq, int Hkv, int Sq, int Skv,
              int causal, int window, float softcap, int prefix,
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
  const float* qp = q + (int64_t(b) * Hq + h) * Sq * HD;
  const float* kp = k + (int64_t(b) * Hkv + hk) * Skv * HD;
  const float* vp = v + (int64_t(b) * Hkv + hk) * Skv * HD;
  float* op = o + (int64_t(b) * Hq + h) * Sq * HD;
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;

  for (int e = tid * 4; e < BQ * HD; e += NT * 4) {
    const int r = e / HD, d = e % HD;
    float f[4] = {0.f, 0.f, 0.f, 0.f};
    if (q0 + r < Sq) load_f32<float, 4>(qp + int64_t(q0 + r) * HD + d, f);
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
  const Range kr = kv_range(q0, min(q0 + BQ, Sq) - 1, Skv, causal, window,
                            prefix);

  for (int k0 = (kr.lo / BK) * BK; k0 < kr.hi; k0 += BK) {
    __syncthreads();  // the previous tile's V and P are consumed
    for (int e = tid * 4; e < BK * HD; e += NT * 4) {
      const int c = e / HD, d = e % HD;
      float f[4] = {0.f, 0.f, 0.f, 0.f};
      if (k0 + c < Skv) load_f32<float, 4>(kp + int64_t(k0 + c) * HD + d, f);
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
        const bool ok = admitted(qi, kj, Skv, causal, window, prefix);
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
      if (k0 + c < Skv) load_f32<float, 4>(vp + int64_t(k0 + c) * HD + d, f);
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
        op[int64_t(qi) * HD + tx + 16 * j] = acc[i][j] / denom;
      // m stays kNegInf exactly when the row admits no key
      if (lse != nullptr && tx == 0)
        lse[(int64_t(b) * Hq + h) * Sq + qi] =
            m[i] == kNegInf ? pos_inf() : m[i] + logf(l[i]);
    }
  }
}

template <int HD>
int launch_flash(const void* q, const void* k, const void* v, void* o,
                 float* lse, int B, int Hq, int Hkv, int Sq, int Skv,
                 int causal, int window, float softcap, int prefix,
                 void* stream) {
  constexpr int smem = flash_smem_floats<HD>() * int(sizeof(float));
  // above 48 KB of dynamic shared memory needs the opt-in (per device, so
  // it is set on every launch; the call costs about a microsecond)
  const cudaError_t err = cudaFuncSetAttribute(
      flash_forward<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Sq + kFlashBQ - 1) / kFlashBQ, Hq, B);
  flash_forward<HD><<<grid, kFlashThreads, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), lse, Hq, Hkv, Sq,
      Skv, causal, window, softcap, prefix,
      static_cast<float>(1.0 / std::sqrt(double(HD))));
  return static_cast<int>(cudaGetLastError());
}

// -- bfloat16: wgmma products fed by TMA -------------------------------------

constexpr int kWgBQ = 128;   // q rows per block: two warpgroups of 64
constexpr int kWgBK = 64;    // kv rows per tile
constexpr int kWgConsumers = 2;
// + a producer warpgroup: registers are granted per 128 threads, so it
// hands its share to the consumers (setmaxnreg) and one of its threads
// issues the loads
constexpr int kWgThreads = (kWgConsumers + 1) * 128;
constexpr int kSwRow = 128;  // bytes of a swizzled row: 64 bf16

// The tile plan by head_dim: the ring's stages, the shared memory, and the
// registers of a producer and a consumer thread (producer * 128 + consumer
// * 256 must not exceed the 168 * 384 the block is launched with).
template <int HD>
struct WgPlan {
  static constexpr int kStages = HD == 256 ? 2 : 3;
  static constexpr int kProducerRegs = HD == 256 ? 24 : 40;
  static constexpr int kConsumerRegs = HD == 256 ? 240 : 232;
  static constexpr int kQ = kWgBQ * HD * 2;     // Q, hd/64 column blocks
  static constexpr int kKV = kWgBK * HD * 2;    // one K or V tile
  static constexpr int kBytes = kQ + kStages * 2 * kKV;
  static constexpr int kAlloc = kBytes + 1024;  // room to align to 1,024
  static_assert(kAlloc <= 232448, "above a block's shared memory");
  static_assert(kProducerRegs * 128 + kConsumerRegs * 256 <= 168 * 384,
                "above the block's registers");
};

// One kv tile's scores -> probabilities, in place, for this thread's two
// rows r0, r0 + 8: scale, softcap and (on tiles that cross the diagonal,
// the window's lower edge, the prefix's end or Skv) the mask, in float32;
// the online softmax update of m, l (this thread's share of the row sums,
// of the unrounded p) and alpha, the factor of the output so far.
__device__ __forceinline__ void softmax_tile(
    float (&sc)[kWgBK / 2], int k0, bool edge, int r0, int cq, int Skv,
    int causal, int window, int prefix, float softcap, float inv_cap,
    float scale, float (&m)[2], float (&l)[2], float (&alpha)[2]) {
#pragma unroll
  for (int e = 0; e < kWgBK / 2; ++e) {
    float x = sc[e] * scale;
    if (softcap > 0.f) x = softcap * tanhf(x * inv_cap);
    sc[e] = x;
  }
  if (edge) {
    // each row's admitted keys as one interval [lo, hi) (kv_range of the
    // row alone: admitted() for one query), relative to this thread's first
    // column k0 + cq, so an element's test is two compares with constants
    int lo[2], hi[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const Range a = kv_range(r0 + 8 * r, r0 + 8 * r, Skv, causal, window,
                               prefix);
      lo[r] = a.lo - k0 - cq;
      hi[r] = a.hi - k0 - cq;
    }
#pragma unroll
    for (int e = 0; e < kWgBK / 2; ++e) {
      const int r = (e >> 1) & 1, c = (e / 4) * 8 + (e & 1);
      if (c < lo[r] || c >= hi[r]) sc[e] = kNegInf;
    }
  }
  // a row's kWgBK scores lie on the 4 lanes that share it
  float mx[2] = {kNegInf, kNegInf};
#pragma unroll
  for (int e = 0; e < kWgBK / 2; ++e)
    mx[(e >> 1) & 1] = fmaxf(mx[(e >> 1) & 1], sc[e]);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float m_new = fmaxf(m[r], mx[r]);
    alpha[r] = expf(m[r] - m_new);
    m[r] = m_new;
    l[r] *= alpha[r];
  }
#pragma unroll
  for (int e = 0; e < kWgBK / 2; ++e) {
    const int r = (e >> 1) & 1;
    sc[e] = expf(sc[e] - m[r]);
    l[r] += sc[e];
  }
}

template <int HD>
__global__ void __launch_bounds__(kWgThreads, 1)
flash_forward_wgmma(const __grid_constant__ CUtensorMap tm_q,
                    const __grid_constant__ CUtensorMap tm_k,
                    const __grid_constant__ CUtensorMap tm_v,
                    __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                    int Hq, int Hkv, int Sq, int Skv, int causal, int window,
                    float softcap, int prefix, float scale) {
  using namespace hopper;
  using L = WgPlan<HD>;
  constexpr int BQ = kWgBQ, BK = kWgBK, ST = L::kStages;
  constexpr int NCB = HD / 64;  // 64-column blocks of a row
  extern __shared__ uint8_t smem_raw[];
  // full: a tile has arrived; free: both warpgroups' products read it
  __shared__ uint64_t bar_q, bar_k[ST], bar_v[ST], bar_kfree[ST],
      bar_vfree[ST];
  // the swizzle atoms need 1,024-byte aligned shared addresses
  uint8_t* Qs = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* Ks = Qs + L::kQ;           // stage s at Ks + s * L::kKV
  uint8_t* Vs = Ks + ST * L::kKV;

  // the q tiles with the most kv tiles first: blockIdx.z runs slowest
  const int q0 = int(gridDim.z - 1 - blockIdx.z) * BQ;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int hk = h / (Hq / Hkv);
  // kv tiles the mask admits for rows [q0, q_last]
  const Range kr = kv_range(q0, min(q0 + BQ, Sq) - 1, Skv, causal, window,
                            prefix);
  const int k_lo = (kr.lo / BK) * BK, k_hi = kr.hi;
  const int n_tiles = k_hi > k_lo ? (k_hi - k_lo + BK - 1) / BK : 0;

  const int tid = threadIdx.x;
  if (tid == 0) {
    mbar_init(&bar_q, 1);
    for (int s = 0; s < ST; ++s) {
      mbar_init(&bar_k[s], 1);
      mbar_init(&bar_v[s], 1);
      mbar_init(&bar_kfree[s], kWgConsumers);
      mbar_init(&bar_vfree[s], kWgConsumers);
    }
    mbar_init_fence();
  }
  __syncthreads();
  // the warp index broadcast from lane 0: ptxas then knows it (and the
  // warpgroup, the stage indices and every wgmma descriptor derived from
  // it) to be warp-uniform and keeps them in uniform registers, which the
  // consumers' accumulators and P do not compete for
  const int warp = __shfl_sync(0xffffffffu, tid / 32, 0);
  const int lane = tid % 32;

  if (warp >= kWgConsumers * 4) {
    // producer: one thread issues every load; tile j's K (V) goes to
    // stage j % ST once both warpgroups have freed tile j - ST's K (V)
    setmaxnreg_dec<L::kProducerRegs>();
    if (warp == kWgConsumers * 4 && lane == 0) {
      const int zq = b * Hq + h, zk = b * Hkv + hk;
      mbar_expect_tx(&bar_q, L::kQ);
      for (int c = 0; c < NCB; ++c)
        tma_load_3d(Qs + c * BQ * kSwRow, &tm_q, &bar_q, c * 64, q0, zq);
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % ST;
        const uint32_t parity = ((j / ST) - 1) & 1;
        const int k0 = k_lo + j * BK;
        uint8_t* kd = Ks + s * L::kKV;
        uint8_t* vd = Vs + s * L::kKV;
        if (j >= ST) mbar_wait(&bar_kfree[s], parity);
        mbar_expect_tx(&bar_k[s], L::kKV);
        for (int c = 0; c < NCB; ++c)
          tma_load_3d(kd + c * BK * kSwRow, &tm_k, &bar_k[s], c * 64, k0, zk);
        if (j >= ST) mbar_wait(&bar_vfree[s], parity);
        mbar_expect_tx(&bar_v[s], L::kKV);
        for (int c = 0; c < NCB; ++c)
          tma_load_3d(vd + c * BK * kSwRow, &tm_v, &bar_v[s], c * 64, k0, zk);
      }
    }
    return;
  }

  // consumer warpgroup wg: q rows qa..qa+63; this thread holds rows r0 and
  // r0 + 8 at columns 8i + cq + {0, 1} of every accumulator
  setmaxnreg_inc<L::kConsumerRegs>();
  const int wg = warp / 4;
  const int qa = q0 + wg * 64;
  const int r0 = qa + (warp % 4) * 16 + lane / 4;
  const int cq = 2 * (lane % 4);
  // the wgmma descriptors of this warpgroup's Q rows and of stage 0's K and
  // V tiles; another column block, k step or stage is a byte offset / 16
  // added to one (the 14-bit address field cannot carry: every shared
  // address lies below 256 KB)
  const uint64_t dq = sw128_desc(smem_u32(Qs) + wg * 64 * kSwRow, 16, 1024);
  const uint64_t dk = sw128_desc(smem_u32(Ks), 16, 1024);
  const uint64_t dv = sw128_desc(smem_u32(Vs), BK * kSwRow, 1024);
  const float inv_cap = softcap > 0.f ? 1.f / softcap : 0.f;

  float acc[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};  // this thread's share of the row sums
  float alpha[2];
  float sc[BK / 2];
  // P of the tile whose P.V is next
  uint32_t p_hi[BK / 16][4], p_lo[BK / 16][4];

  // S = Q.K^T of the tile in stage s, issued (not waited for)
  auto issue_s = [&](int s) {
    const uint64_t ks = dk + uint32_t(s * (L::kKV / 16));
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const uint32_t off = (kk % 4) * 32;  // 16 columns
      wgmma_ss_n64(sc, dq + ((kk / 4) * BQ * kSwRow + off) / 16,
                   ks + ((kk / 4) * BK * kSwRow + off) / 16, kk > 0);
    }
    wgmma_commit();
  };
  // O += P.V of the tile in stage s, issued: V's 64-column blocks lie
  // BK * 128 bytes apart (LBO), a k step is 16 kv rows (2,048 bytes)
  auto issue_pv = [&](int s) {
    const uint64_t vs = dv + uint32_t(s * (L::kKV / 16));
#pragma unroll
    for (int c = 0; c < BK / 16; ++c) {
      const uint64_t d = vs + c * 16 * kSwRow / 16;
      if constexpr (HD == 256) {
        wgmma_rs_n256(acc, p_hi[c], d);
        wgmma_rs_n256(acc, p_lo[c], d);
      } else if constexpr (HD == 128) {
        wgmma_rs_n128(acc, p_hi[c], d);
        wgmma_rs_n128(acc, p_lo[c], d);
      } else {
        wgmma_rs_n64(acc, p_hi[c], d);
        wgmma_rs_n64(acc, p_lo[c], d);
      }
    }
    wgmma_commit();
  };
  // the per-element mask is needed only where a tile crosses the diagonal,
  // the window's lower edge or Skv for some row of this warpgroup; with a
  // prefix, a key above the diagonal is masked only at or past the prefix,
  // so a tile wholly below it needs none
  auto edge = [&](int k0) {
    return (causal && k0 + BK - 1 > qa && k0 + BK - 1 >= prefix)
           || (window > 0 && k0 <= qa + 63 - window) || k0 + BK > Skv;
  };
  // this warpgroup's products that read the K (V) tile in stage s are
  // complete: its thread 0 frees that tile
  auto free_tile = [&](uint64_t* bars, int s) {
    if ((warp % 4) == 0 && lane == 0) mbar_arrive(&bars[s]);
  };

  mbar_wait(&bar_q, 0);
  if (n_tiles > 0) {
    // tile 0: its scores and P
    mbar_wait(&bar_k[0], 0);
    fence_regs(sc);
    wgmma_fence();
    issue_s(0);
    wgmma_wait<0>();
    fence_regs(sc);
    free_tile(bar_kfree, 0);
    softmax_tile(sc, k_lo, edge(k_lo), r0, cq, Skv, causal, window, prefix,
                 softcap, inv_cap, scale, m, l, alpha);
    split_bf16(sc, p_hi, p_lo);
    // tile j: S_j is issued, then the tile before's O += P.V, so the tensor
    // cores run that P.V while the CUDA cores run S_j's softmax; O is
    // rescaled and P_j packed once that P.V is complete, so no register of
    // a product in flight is written.
    for (int j = 1; j < n_tiles; ++j) {
      const int s = j % ST, sp = (j - 1) % ST;
      const int k0 = k_lo + j * BK;
      mbar_wait(&bar_k[s], (j / ST) & 1);
      fence_regs(sc);
      fence_regs(acc);
      fence_regs(p_hi);
      fence_regs(p_lo);
      wgmma_fence();
      issue_s(s);
      mbar_wait(&bar_v[sp], ((j - 1) / ST) & 1);
      wgmma_fence();  // a fence per product, or ptxas serializes them
      issue_pv(sp);
      wgmma_wait<1>();  // S_j is done
      fence_regs(sc);
      free_tile(bar_kfree, s);
      softmax_tile(sc, k0, edge(k0), r0, cq, Skv, causal, window, prefix,
                   softcap, inv_cap, scale, m, l, alpha);
      wgmma_wait<0>();  // the tile before's P.V is done
      fence_regs(acc);
      fence_regs(p_hi);
      fence_regs(p_lo);
      free_tile(bar_vfree, sp);
#pragma unroll
      for (int i = 0; i < HD / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];
      split_bf16(sc, p_hi, p_lo);
    }
    // the last tile's P.V
    const int sl = (n_tiles - 1) % ST;
    mbar_wait(&bar_v[sl], ((n_tiles - 1) / ST) & 1);
    fence_regs(acc);
    wgmma_fence();
    issue_pv(sl);
    wgmma_wait<0>();
    fence_regs(acc);
    free_tile(bar_vfree, sl);
  }

  // epilogue: row sums over the 4 lanes, the log-sum-exp from the same
  // rows that write O (m is already the row's on all 4 lanes; kNegInf
  // exactly when the row admits no key), divide, round once to bf16
  const int64_t row_base = (int64_t(b) * Hq + h) * Sq;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int qi = r0 + 8 * r;
    if (lse != nullptr && (lane % 4) == 0 && qi < Sq)
      lse[row_base + qi] = m[r] == kNegInf ? pos_inf() : m[r] + logf(l[r]);
    l[r] = fmaxf(l[r], kMinDenom);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = r0 + 8 * r;
    if (qi < Sq) {
      __nv_bfloat16* orow = o + (row_base + qi) * HD + cq;
#pragma unroll
      for (int i = 0; i < HD / 8; ++i) {
        *reinterpret_cast<__nv_bfloat162*>(orow + 8 * i) =
            __floats2bfloat162_rn(acc[4 * i + 2 * r] / l[r],
                                  acc[4 * i + 2 * r + 1] / l[r]);
      }
    }
  }
}

template <int HD>
int launch_flash_wgmma(const void* q, const void* k, const void* v, void* o,
                       float* lse, int B, int Hq, int Hkv, int Sq, int Skv,
                       int causal, int window, float softcap, int prefix,
                       void* stream) {
  const int n_qt = (Sq + kWgBQ - 1) / kWgBQ;
  if (Skv <= 0 || n_qt > 65535 || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap tm_q, tm_k, tm_v;
  if (!hopper::encode_map(&tm_q, q, B * Hq, Sq, HD, kWgBQ)
      || !hopper::encode_map(&tm_k, k, B * Hkv, Skv, HD, kWgBK)
      || !hopper::encode_map(&tm_v, v, B * Hkv, Skv, HD, kWgBK))
    return static_cast<int>(cudaErrorInvalidValue);
  constexpr int smem = WgPlan<HD>::kAlloc;
  const cudaError_t err = cudaFuncSetAttribute(
      flash_forward_wgmma<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(Hq, B, n_qt);
  flash_forward_wgmma<HD><<<grid, kWgThreads, smem,
                            static_cast<cudaStream_t>(stream)>>>(
      tm_q, tm_k, tm_v, static_cast<__nv_bfloat16*>(o), lse, Hq, Hkv, Sq,
      Skv, causal, window, softcap, prefix,
      static_cast<float>(1.0 / std::sqrt(double(HD))));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace attn

extern "C" {

// dtype: 0 = float32 (flash_forward), 1 = bfloat16 (flash_forward_wgmma);
// hd: 64, 128 or 256; prefix_len: the keys every
// query sees under the causal mask (0 <= prefix_len <= Skv, and 0 without
// the causal mask or with a window).  lse: null, or float32 [B, Hq, Sq]
// that receives each row's log-sum-exp of its scaled, soft-capped, masked
// scores (natural log; +inf for a row that admits no key), which the
// backward (flash_attention_backward.cu) reads.  Returns cudaGetLastError()
// after the launch, or cudaErrorInvalidValue for a shape the kernel does
// not take (the wrapper refuses most before calling) or a tensor map the
// CUDA driver refuses.
int attn_flash_forward(const void* q, const void* k, const void* v, void* o,
                       void* lse, int B, int Hq, int Hkv, int Sq, int Skv,
                       int hd, int dtype, int causal, int window,
                       float softcap, int prefix_len, void* stream) {
  if (B <= 0 || Hkv <= 0 || Hq % Hkv != 0 || Sq <= 0 || Skv < 0
      || prefix_len < 0 || prefix_len > Skv
      || (prefix_len > 0 && (!causal || window > 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  const int P = prefix_len;
  float* L = static_cast<float*>(lse);
  if (dtype == 0 && hd == 256)
    return attn::launch_flash<256>(q, k, v, o, L, B, Hq, Hkv, Sq, Skv, causal,
                                   window, softcap, P, stream);
  if (dtype == 0 && hd == 128)
    return attn::launch_flash<128>(q, k, v, o, L, B, Hq, Hkv, Sq, Skv, causal,
                                   window, softcap, P, stream);
  if (dtype == 0 && hd == 64)
    return attn::launch_flash<64>(q, k, v, o, L, B, Hq, Hkv, Sq, Skv, causal,
                                  window, softcap, P, stream);
  if (dtype == 1 && hd == 256)
    return attn::launch_flash_wgmma<256>(q, k, v, o, L, B, Hq, Hkv, Sq, Skv,
                                         causal, window, softcap, P, stream);
  if (dtype == 1 && hd == 128)
    return attn::launch_flash_wgmma<128>(q, k, v, o, L, B, Hq, Hkv, Sq, Skv,
                                         causal, window, softcap, P, stream);
  if (dtype == 1 && hd == 64)
    return attn::launch_flash_wgmma<64>(q, k, v, o, L, B, Hq, Hkv, Sq, Skv,
                                        causal, window, softcap, P, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"

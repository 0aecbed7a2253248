// One-token decode attention against the KV cache, for sm_90a.
//
// Replaces the TPU kernel src/repro/kernels/decode_attention.py
// (decode_attention / _kernel).  Same function: each query row q[b, h]
// attends the cached rows p of kv head h / (Hq / Hkv) with
// p < valid_len and, for window > 0, p > valid_len - window; scores
// q.k / sqrt(hd) in float32, optional softcap, online softmax, output
// acc / max(l, 1e-37) in q's dtype.  Layouts: q, o [B, Hq, hd];
// cache k, v [B, Hkv, S, hd], each slot's [Hkv, S, hd] dense and slots
// kv_slot >= Hkv heads apart (a block of kv heads read in place from a
// cache that holds more); valid_len int32 [B], one length per slot (the
// TPU kernel took one scalar for the whole batch; the engine's slots are
// ragged); hd 64, 128 or 256; any number g = Hq / Hkv of q heads per kv
// head.  valid_len > S reads S rows.  A row with no admitted position
// (valid_len 0, or a window past the cache's end) gets what the reference
// gives: its finite mask (-2e38) weighs every one of the S rows alike, so
// the output is the mean of V over all S rows; here such a slot reads all S
// rows with every score set to 0.
//
// Split-KV (flash-decoding), both routes.  The TPU kernel streams the
// whole cache through a sequential kv grid axis with a [S] bias vector of
// 0 / -2e38.  Here the grid is (split, kv head x chunk, slot) with
// n_splits splits (the wrapper's num_splits, from the shapes alone), and
// each block serves the q heads of one chunk of its kv head's group, so
// each cached row is read once per chunk.  A slot's admitted positions
// [first, hi) are cut on the card into runs of len = ceil((hi - first) /
// n_splits) rounded up to whole tiles, at least 4 tiles (run_length): a
// short slot is spread over blocks too, while no block is so short that
// its set-up and merge outweigh its reads.  A block past its slot's last
// run reads nothing: the masked part of the cache is never read, and no
// length is read on the host.  The runs merge in the same launch, in a
// fixed order, so two calls on the same input are bit-identical.
//
// Which route (decode_route_mma, the wrapper's route()): a pure function
// of the dtype and the group g.
//
// decode_split (float32 at any g; bf16 at g <= 2): the CUDA cores.  Chunks
// of at most 8 q heads, at most 64 splits.  Thread 0 fetches each 8 KB
// tile of K and of V with one bulk copy (cp.async.bulk) into a 2-stage
// ring (32 KB; 6 blocks fit an SM at g <= 2).  L = min(hd * sizeof(T) /
// 16, 32) lanes hold one row (16-byte loads), each lane group keeps its own
// online softmax per q head over tile / groups rows a step, the dot
// products are L-lane shuffle sums, V is read from shared memory only for
// the P.V update.  A block past its slot's last run exits at once; a slot
// whose rows fit one run is written by that block.  Otherwise each block
// writes its (acc[hd], m, l) per q head to the float32 workspace [B, Hq,
// splits, hd + 2], fences, and counts itself on its (slot, kv head,
// chunk)'s counter; the block that counts last merges every split in split
// order, writes the output and resets the counter to 0 for the next
// launch.  At g <= 2 it does 4 * hd * g flops per 4 * hd bytes of K and V
// and runs at 0.67 of its bound (PERF.md).  float32 stays here: TF32
// operands cannot hold the 3e-5 float32 and the partial entry's o are
// held to.
//
// decode_mma (bf16 at g >= 4): the tensor cores, mma.sync.m16n8k16.  At g
// = 8 the CUDA-core kernel spends 2 * g * hd FMAs, g L-lane shuffle sums
// and g exps computed by every lane of a row group per cached row, and
// holds q, acc and the scores of 8 heads in ~200 registers a thread: it is
// bound by issue, not by its bytes (0.34 of the bound at Jamba's layer).
// The group's q heads are the 16 rows of the tile (as FlashAttention-2
// packs query rows; chunks of 16 heads, so a group of 16 reads each row
// once), the cached rows its columns:
// - S = Q.K^T: Q's A fragments from shared memory (held in registers at
//   hd <= 128), K's B fragments by ldmatrix; S scaled in float32 after the
//   product (1/sqrt(128) is no power of two, so Q is not pre-scaled in
//   bf16), soft-capped, masked by position.
// - The online softmax runs along the cached rows inside a lane quad (each
//   lane holds 2 of every 8 columns), its l summed from the unrounded p.
// - O += P.V: P from the S accumulator, packed into bf16 pairs, is already
//   the A fragment; V's B fragments by ldmatrix.trans.  P is split into
//   bf16 hi + lo (as flash_forward_wgmma does), so P keeps about 16 bits:
//   the partial entry's float32 o is held at 3e-5, which one bf16 rounding
//   of P (2^-9) misses by two orders of magnitude.  At g <= 8 the tile's
//   rows 8-15 would be zero: there the A fragment carries P_lo in rows
//   8-15 (a register move, the same lane holds row r and r + 8), so one
//   product gives P_hi.V in rows 0-7 and P_lo.V in rows 8-15, added at the
//   end.  At g > 8 P_hi and P_lo are two products.
// - K and V come by TMA (3-D maps over rows (b * kv_slot + hk) * S + p, so
//   a narrowed cache is read in place; zero fill past S) in the 128-byte
//   swizzle, so ldmatrix's eight 16-byte rows fall on eight bank groups (an
//   unswizzled 256-byte row pitch puts them all on one).  One producer warp
//   keeps a ring of 6 stages of K and V tiles (8 at hd 64) full, 32 KB a
//   stage at hd 128 and 256 (192 KB, one block an SM); consumers free a
//   stage on an mbarrier.  A block streams at the bytes it keeps in flight
//   over the memory's latency: with 3 stages (two blocks an SM) a block
//   read 44-56 GB/s (PERF.md), so a slot's 8 runs took 1 MB each at 20 µs.
// - Two teams of four consumer warps take alternate tiles.  At hd 64 and
//   128 each warp of a team takes 16 rows of a 64-row tile and holds O[16,
//   hd] (64 floats a lane at 128).  At hd 256 O[16, 256] would be 128
//   floats a lane, so two warps share 16 rows of a 32-row tile, each
//   computing the same S (the redundant Q.K^T is cheap) and holding 128 of
//   O's columns; Q's fragments are read from shared memory at each step
//   there.  The warps' states merge in shared memory.
// - The tensor work is about 1% of the time: the design is judged by the
//   bytes in flight and the few instructions it spends a row.
// - The merge: the splits of one (slot, kv head, chunk), at most 8 (the
//   portable cluster; at 16 a cluster spans more SMs than some GPCs give
//   at once, and Jamba's block took 0.42 ms where 8 took 0.35), are one
//   thread-block cluster.  Each block leaves its state (m, l, acc[hd]
//   per q head) in its shared memory, and after a cluster barrier every
//   block takes its share of the (head, column) outputs and sums the
//   cluster's states for them in rank order, read from the other blocks'
//   shared memory (distributed shared memory).  No workspace, no counter,
//   no fence, and the merge is spread over the cluster: the split route's
//   global-memory merge (workspace stores, fences, a counter and two rounds
//   of reads in one block) took half of the time at PaliGemma's and a group
//   of 16's shapes, and a merge of the same design on the tensor-core runs
//   still 0.40-0.56 of it (PERF.md, tools/decode_merge_split.py).  A block
//   past its slot's last run joins the merge with a zero weight.
//
// A block of global positions (lse given).  A cache whose sequence is
// split over ranks (the reference's long-context decode, its caches'
// sequence over the data axes) holds rows [pos0, pos0 + S) of the whole
// cache.  Both routes then admit local row r when pos0 + r < valid_len
// and, with a window, pos0 + r > valid_len - window: the window's lower
// bound stays on global positions (a length clamped to the local rows
// first would move it).  They write o = acc / l in float32, unrounded, and
// lse = m + log l per (slot, q head), from which the ranks' blocks merge;
// a block with no admitted row writes o = 0 and lse = -inf, a zero weight
// in that merge, and reads no row (the whole-cache entry's mean of V over
// S rows is its own rule).  The whole-cache call passes pos0 = 0 and no
// lse.
//
// What bounds it on an H100: bytes (2 * hd * sizeof(T) per admitted row per
// kv head and chunk).  The measured times and bounds are in PERF.md.

#include <cmath>

#include <cooperative_groups.h>

#include "attention_common.cuh"
#include "hopper.cuh"

namespace attn {

constexpr int kMaxSplits = 64;        // splits per slot (the merge's table)
constexpr int kMinRunTiles = 4;       // the shortest run but a slot's last

// the admitted local rows [first, hi) of a slot: global positions pos0 + r
// below valid_len and, with a window, above valid_len - window; false when
// there is none
__device__ __forceinline__ bool admitted_rows(int valid, int pos0, int S,
                                              int window, int& first,
                                              int& hi) {
  hi = min(valid - pos0, S);
  first = window > 0 ? max(0, valid - window + 1 - pos0) : 0;
  return hi > first;
}

// rows of a run of a slot with `rows` admitted rows: whole tiles, at least
// kMinRunTiles of them, at most n_splits runs
__device__ __forceinline__ int run_length(int rows, int n_splits, int tile) {
  const int per = (rows + n_splits - 1) / n_splits;
  return max((per + tile - 1) / tile, kMinRunTiles) * tile;
}

// o = 0 and lse = -inf for the g q heads from q_row: a block of positions
// that admits no row, the merge's zero weight
template <int HD>
__device__ __forceinline__ void write_empty(float* o, float* lse,
                                            int64_t q_row, int g) {
  for (int t = threadIdx.x; t < g * HD; t += blockDim.x) o[q_row * HD + t] = 0.f;
  for (int h = threadIdx.x; h < g; h += blockDim.x)
    lse[q_row + h] = -__int_as_float(0x7f800000);
}

// -- decode_split: the CUDA cores (float32; bf16 at g <= 2) ------------------

constexpr int kDecThreads = 128;
constexpr int kDecWarps = kDecThreads / 32;
constexpr int kDecStages = 2;
constexpr int kDecTileBytes = 8192;   // one tile of K (and one of V)
constexpr int kMaxGroup = 8;          // q heads one block serves
constexpr int kDecRing = kDecStages * 2 * kDecTileBytes;

template <typename T, int HD, int G>
struct DecodeShape {
  static constexpr int kVec = 16 / int(sizeof(T));   // elements per load
  static constexpr int kLanes = HD / kVec < 32 ? HD / kVec : 32;  // per row
  static constexpr int kPerLane = HD / kLanes;       // elements per lane
  static constexpr int kStride = kLanes * kVec;      // between its loads
  static constexpr int kRowsPerLoad = 32 / kLanes;   // rows per warp load
  static constexpr int kGroups = kDecWarps * kRowsPerLoad;
  static constexpr int kRowBytes = HD * int(sizeof(T));
  static constexpr int kTile = kDecTileBytes / kRowBytes;   // rows
  static constexpr int kRows = kTile / kGroups;      // per group and step
  static_assert(kPerLane % kVec == 0, "a lane takes whole loads");
  static_assert(kRows >= 1 && kTile == kGroups * kRows,
                "a tile is one step of rows");
  // the ring, reused for the lane groups' partial states once drained
  static constexpr int kMerge = kGroups * G * (HD + 2) * 4;
  static constexpr int kSmem = kMerge > kDecRing ? kMerge : kDecRing;
  static_assert(kSmem <= 48 * 1024, "no shared-memory opt-in needed");
};

// the kPerLane elements of one lane at column col of a row, as float32
template <typename T, int HD>
__device__ __forceinline__ void load_lane(const T* row, int col, float* out) {
  using Sh = DecodeShape<T, HD, 1>;
#pragma unroll
  for (int c = 0; c < Sh::kPerLane / Sh::kVec; ++c)
    load_f32<T, Sh::kVec>(row + col + c * Sh::kStride, out + c * Sh::kVec);
}

// G: q heads the registers are sized for (1, 2, 4 or 8); a block serves
// min(G, g - chunk * G) q heads of its kv head's g = Hq / Hkv
template <typename T, int HD, int G>
__global__ void __launch_bounds__(kDecThreads)
decode_split(const T* __restrict__ q, const T* __restrict__ ck,
             const T* __restrict__ cv, const int32_t* __restrict__ valid_len,
             void* __restrict__ o, float* __restrict__ lse,
             float* __restrict__ ws, int* __restrict__ counters, int Hq,
             int Hkv, int kv_slot, int S, int pos0, int window, float softcap,
             float scale) {
  using Sh = DecodeShape<T, HD, G>;
  constexpr int E = Sh::kPerLane;
  constexpr int L = Sh::kLanes;
  constexpr int U = Sh::kRows;
  constexpr int TILE = Sh::kTile;
  constexpr int W = HD + 2;   // a partial state: acc[hd], m, l
  const int split = blockIdx.x;
  const int n_chunks = gridDim.y / Hkv;
  const int hk = blockIdx.y / n_chunks;
  const int h0 = (blockIdx.y % n_chunks) * G;   // first q head in the group
  const int b = blockIdx.z;
  const int n_splits = gridDim.x;
  const int g = min(G, Hq / Hkv - h0);          // q heads of this block
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int grp = warp * Sh::kRowsPerLoad + lane / L;
  const int col = (lane % L) * Sh::kVec;
  // the row's column of a lane's element e
  auto col_of = [&](int e) {
    return (e / Sh::kVec) * Sh::kStride + col + e % Sh::kVec;
  };
  const int64_t q_row =   // first q head
      int64_t(b) * Hq + int64_t(hk) * (Hq / Hkv) + h0;
  // a block of positions (lse given) writes float32 o; the whole cache o in T
  const bool partial = lse != nullptr;
  auto store = [&](int64_t i, float val) {
    if (partial)
      static_cast<float*>(o)[i] = val;
    else
      static_cast<T*>(o)[i] = from_f32<T>(val);
  };

  int first, hi;
  const bool uniform = !admitted_rows(valid_len[b], pos0, S, window, first,
                                      hi);
  if (uniform && partial) {
    if (split == 0) write_empty<HD>(static_cast<float*>(o), lse, q_row, g);
    return;
  }
  // nothing admitted in the whole cache: every row weighs alike, as under
  // the reference's finite mask
  if (uniform) {
    first = 0;
    hi = S;
  }
  const int len = run_length(hi - first, n_splits, TILE);
  const int n_act = (hi - first + len - 1) / len;
  if (split >= n_act) return;
  const int start = first + split * len;
  const int end = min(start + len, hi);
  const int n_tiles = (end - start + TILE - 1) / TILE;

  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ uint64_t full[kDecStages];
  __shared__ int merges;
  T* ring = reinterpret_cast<T*>(smem);   // [stage][K, V][TILE * HD]
  const int64_t kv = (int64_t(b) * kv_slot + hk) * S * HD;

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < kDecStages; ++s) hopper::mbar_init(&full[s], 1);
    hopper::mbar_init_fence();
  }
  __syncthreads();
  // tile i of this split into stage i % kDecStages (thread 0 only)
  auto fetch = [&](int i) {
    const int p = start + i * TILE;
    const uint32_t bytes = uint32_t(min(TILE, end - p)) * Sh::kRowBytes;
    uint64_t* bar = &full[i % kDecStages];
    T* dst = ring + (i % kDecStages) * 2 * TILE * HD;
    hopper::mbar_expect_tx(bar, 2 * bytes);
    hopper::bulk_load(dst, ck + kv + int64_t(p) * HD, bytes, bar);
    hopper::bulk_load(dst + TILE * HD, cv + kv + int64_t(p) * HD, bytes, bar);
  };
  if (tid == 0)
    for (int i = 0; i < min(kDecStages, n_tiles); ++i) fetch(i);

  float qf[G][E], acc[G][E], m[G], l[G];
#pragma unroll
  for (int h = 0; h < G; ++h) {
    m[h] = kNegInf;
    l[h] = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      qf[h][e] = 0.f;
      acc[h][e] = 0.f;
    }
    if (h < g) {
      load_lane<T, HD>(q + (q_row + h) * HD, col, qf[h]);
#pragma unroll
      for (int e = 0; e < E; ++e) qf[h][e] *= scale;
    }
  }

  for (int i = 0; i < n_tiles; ++i) {
    const int st = i % kDecStages;
    const int rows = min(TILE, end - (start + i * TILE));
    hopper::mbar_wait(&full[st], (i / kDecStages) & 1);
    const T* kt = ring + st * 2 * TILE * HD;
    const T* vt = kt + TILE * HD;
    float s[G][U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int r = u * Sh::kGroups + grp;
      float kf[E];
#pragma unroll
      for (int e = 0; e < E; ++e) kf[e] = 0.f;
      if (r < rows) load_lane<T, HD>(kt + r * HD, col, kf);
#pragma unroll
      for (int h = 0; h < G; ++h) {
        float dot = 0.f;
#pragma unroll
        for (int e = 0; e < E; ++e) dot = fmaf(qf[h][e], kf[e], dot);
#pragma unroll
        for (int off = L / 2; off > 0; off >>= 1)
          dot += __shfl_xor_sync(0xffffffffu, dot, off);
        s[h][u] = r >= rows ? kNegInf
                  : uniform ? 0.f : cap_score(dot, softcap);
      }
    }
    // online softmax: rescale by the new maximum, the scores become p
#pragma unroll
    for (int h = 0; h < G; ++h) {
      if (h >= g) continue;
      float mx = m[h];
#pragma unroll
      for (int u = 0; u < U; ++u) mx = fmaxf(mx, s[h][u]);
      const float alpha = expf(m[h] - mx);
      l[h] *= alpha;
#pragma unroll
      for (int e = 0; e < E; ++e) acc[h][e] *= alpha;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        s[h][u] = u * Sh::kGroups + grp < rows ? expf(s[h][u] - mx) : 0.f;
        l[h] += s[h][u];
      }
      m[h] = mx;
    }
    // acc += p . V, one V row of shared memory at a time
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int r = u * Sh::kGroups + grp;
      if (r >= rows) continue;
      float vf[E];
      load_lane<T, HD>(vt + r * HD, col, vf);
#pragma unroll
      for (int h = 0; h < G; ++h)
#pragma unroll
        for (int e = 0; e < E; ++e) acc[h][e] = fmaf(s[h][u], vf[e], acc[h][e]);
    }
    __syncthreads();   // every thread is done with stage st
    if (tid == 0 && i + kDecStages < n_tiles) fetch(i + kDecStages);
  }

  // merge the lane groups' states in the drained ring: [grp][h] m, l and
  // [grp][h][HD] acc
  float* sm_m = reinterpret_cast<float*>(smem);
  float* sm_l = sm_m + Sh::kGroups * G;
  float* sm_acc = sm_l + Sh::kGroups * G;
#pragma unroll
  for (int h = 0; h < G; ++h) {
    if (h >= g) continue;
    if (lane % L == 0) {
      sm_m[grp * G + h] = m[h];
      sm_l[grp * G + h] = l[h];
    }
#pragma unroll
    for (int e = 0; e < E; ++e)
      sm_acc[(grp * G + h) * HD + col_of(e)] = acc[h][e];
  }
  __syncthreads();
  const bool alone = n_act == 1;
  for (int t = tid; t < g * HD; t += kDecThreads) {
    const int h = t / HD, d = t % HD;
    float mx = kNegInf;
    for (int r = 0; r < Sh::kGroups; ++r) mx = fmaxf(mx, sm_m[r * G + h]);
    float den = 0.f, num = 0.f;
    for (int r = 0; r < Sh::kGroups; ++r) {
      const float f = expf(sm_m[r * G + h] - mx);
      den = fmaf(sm_l[r * G + h], f, den);
      num = fmaf(sm_acc[(r * G + h) * HD + d], f, num);
    }
    if (alone) {
      store((q_row + h) * HD + d, num / fmaxf(den, kMinDenom));
      if (partial && d == 0) lse[q_row + h] = mx + logf(den);
    } else {
      float* part = ws + ((q_row + h) * n_splits + split) * W;
      part[d] = num;
      if (d == 0) {
        part[HD] = mx;
        part[HD + 1] = den;
      }
    }
  }
  if (alone) return;

  // count this split in; the last of the slot's splits merges them all
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    int* counter = counters + int64_t(b) * gridDim.y + blockIdx.y;
    merges = atomicAdd(counter, 1) == n_act - 1;
    if (merges) *counter = 0;
  }
  __syncthreads();
  if (!merges) return;
  __threadfence();

  // per q head: each split's weight exp(m_s - M) and the denominator, one
  // warp per head, a lane per split (two rounds of 32)
  float* wt = reinterpret_cast<float*>(smem);   // [G][kMaxSplits]
  float* dens = wt + G * kMaxSplits;            // [G]
  float* maxs = dens + G;                       // [G]
  for (int h = warp; h < g; h += kDecWarps) {
    const float* part = ws + (q_row + h) * n_splits * W;
    float ms[kMaxSplits / 32], ls[kMaxSplits / 32];
    float mx = kNegInf;
#pragma unroll
    for (int j = 0; j < kMaxSplits / 32; ++j) {
      const int s = lane + 32 * j;
      ms[j] = s < n_act ? __ldcg(part + s * W + HD) : kNegInf;
      ls[j] = s < n_act ? __ldcg(part + s * W + HD + 1) : 0.f;
      mx = fmaxf(mx, ms[j]);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    float den = 0.f;
#pragma unroll
    for (int j = 0; j < kMaxSplits / 32; ++j) {
      const int s = lane + 32 * j;
      const float f = s < n_act ? expf(ms[j] - mx) : 0.f;
      wt[h * kMaxSplits + s] = f;
      den = fmaf(ls[j], f, den);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      den += __shfl_xor_sync(0xffffffffu, den, off);
    if (lane == 0) {
      dens[h] = den;
      maxs[h] = mx;
    }
  }
  __syncthreads();
  for (int t = tid; t < g * HD; t += kDecThreads) {
    const int h = t / HD, d = t % HD;
    const float* part = ws + (q_row + h) * n_splits * W + d;
    const float* f = wt + h * kMaxSplits;
    float num = 0.f;
#pragma unroll 4
    for (int s = 0; s < n_act; ++s) num = fmaf(__ldcg(part + s * W), f[s], num);
    store((q_row + h) * HD + d, num / fmaxf(dens[h], kMinDenom));
    if (partial && d == 0) lse[q_row + h] = maxs[h] + logf(dens[h]);
  }
}

template <typename T, int HD, int G>
int launch_decode(const void* q, const void* k, const void* v,
                  const void* valid_len, void* o, float* lse, void* ws,
                  void* counters, int B, int Hq, int Hkv, int kv_slot, int S,
                  int pos0, int n_splits, int window, float softcap,
                  void* stream) {
  const int n_chunks = (Hq / Hkv + kMaxGroup - 1) / kMaxGroup;
  const dim3 grid(n_splits, Hkv * n_chunks, B);
  decode_split<T, HD, G><<<grid, kDecThreads, DecodeShape<T, HD, G>::kSmem,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int32_t*>(valid_len), o,
      lse, static_cast<float*>(ws), static_cast<int*>(counters), Hq, Hkv,
      kv_slot, S, pos0, window, softcap,
      static_cast<float>(1.0 / std::sqrt(double(HD))));
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int HD>
int launch_decode_group(const void* q, const void* k, const void* v,
                        const void* valid_len, void* o, float* lse, void* ws,
                        void* counters, int B, int Hq, int Hkv, int kv_slot,
                        int S, int pos0, int n_splits, int window,
                        float softcap, void* stream) {
  const int g = Hq / Hkv;
#define ATTN_DECODE_ARGS \
  q, k, v, valid_len, o, lse, ws, counters, B, Hq, Hkv, kv_slot, S, pos0, \
      n_splits, window, softcap, stream
  if (g == 1) return launch_decode<T, HD, 1>(ATTN_DECODE_ARGS);
  if (g == 2) return launch_decode<T, HD, 2>(ATTN_DECODE_ARGS);
  if (g <= 4) return launch_decode<T, HD, 4>(ATTN_DECODE_ARGS);
  return launch_decode<T, HD, 8>(ATTN_DECODE_ARGS);
#undef ATTN_DECODE_ARGS
}

// -- decode_mma: the tensor cores (bf16 at g >= 4) --------------------------

constexpr int kMmaGroup = 16;      // q heads one block serves: the tile's rows
constexpr int kMmaTeams = 2;       // teams of consumer warps, alternate tiles
constexpr int kTeamWarps = 4;      // warps of a team: one tile's rows
constexpr int kMmaConsumers = kMmaTeams * kTeamWarps;
constexpr int kMmaWarps = kMmaConsumers + 1;   // + the producer warp
constexpr int kMmaThreads = kMmaWarps * 32;
constexpr int kMmaStep = 16;       // cached rows a warp takes from a tile
constexpr int kMaxCluster = 8;     // splits: the blocks of one cluster

template <int HD>
struct MmaShape {
  static constexpr int kCols = HD < 128 ? HD : 128;   // O columns a warp holds
  static constexpr int kColWarps = HD / kCols;        // warps sharing rows
  static constexpr int kGroups = kTeamWarps / kColWarps;   // a team's rows
  static constexpr int kTile = kGroups * kMmaStep;    // rows of a tile
  // a 192 KB ring (128 KB at hd 64): one block an SM, most of it in flight
  static constexpr int kStages = HD == 64 ? 8 : 6;
  static constexpr int kTileBytes = kTile * HD * 2;   // one of K (or V)
  static constexpr int kRing = kStages * 2 * kTileBytes;
  static constexpr int kQPitch = HD + 8;   // a Q row in shared memory
  static constexpr int kQBytes = kMmaGroup * kQPitch * 2;
  static constexpr bool kQRegs = HD <= 128;   // Q's fragments in registers
  static constexpr int kNT = kCols / 8;       // O's n-tiles a warp holds
  // the drained ring holds the teams' row groups' states, then the block's
  // state that the cluster reads and the states' weights; the cluster
  // merge's weights reuse the groups' part
  static constexpr int kStates = kMmaTeams * kGroups;
  static constexpr int kGroupMerge = kStates * kMmaGroup * (HD + 2) * 4;
  static constexpr int kState = kMmaGroup * (HD + 2) * 4;
  static constexpr int kWeights = kMmaGroup * (kMaxCluster + 2) * 4;
  static_assert(kGroupMerge + kState + kStates * kMmaGroup * 4 <= kRing &&
                    kWeights <= kGroupMerge,
                "the merges fit the ring");
  static constexpr int kSmem = 1024 + kRing + kQBytes;   // + alignment
  static_assert(kSmem <= 227 * 1024, "a block's shared memory");
};

// byte offset of 16-byte chunk c (columns 8c..8c+7) of row r in a tile of
// TILE rows as TMA writes it: 64-column boxes TILE * 128 bytes apart, each
// row's eight chunks XOR-swizzled by r mod 8 (CU_TENSOR_MAP_SWIZZLE_128B)
template <int TILE>
__device__ __forceinline__ uint32_t sw_off(int r, int c) {
  return uint32_t((c >> 3) * (TILE * 128) + r * 128 + (((c & 7) ^ (r & 7)) << 4));
}

// One cluster of n_splits blocks per (slot, kv head, chunk), a block per
// run.  kPack (g <= 8): rows 8-15 of the P.V product carry P_lo (see the
// header).
template <int HD, bool kPack>
__global__ void __launch_bounds__(kMmaThreads, 1)
decode_mma(const __grid_constant__ CUtensorMap tm_k,
           const __grid_constant__ CUtensorMap tm_v,
           const __nv_bfloat16* __restrict__ q,
           const int32_t* __restrict__ valid_len, void* __restrict__ o,
           float* __restrict__ lse, int Hq, int Hkv, int kv_slot, int S,
           int pos0, int window, float softcap, float scale) {
  using namespace hopper;
  using Sh = MmaShape<HD>;
  constexpr int TILE = Sh::kTile, ST = Sh::kStages, NT = Sh::kNT;
  constexpr int NR = kPack ? 1 : 2;   // accumulator rows a lane owns
  const int split = blockIdx.x;       // the block's rank in its cluster
  const int n_splits = gridDim.x;     // the cluster's blocks
  const int n_chunks = gridDim.y / Hkv;
  const int hk = blockIdx.y / n_chunks;
  const int h0 = (blockIdx.y % n_chunks) * kMmaGroup;
  const int b = blockIdx.z;
  const int g = min(kMmaGroup, Hq / Hkv - h0);
  const int tid = threadIdx.x;
  // broadcast from lane 0: warp-uniform, so ptxas keeps what derives from
  // it in uniform registers
  const int warp = __shfl_sync(0xffffffffu, tid / 32, 0);
  const int lane = tid & 31;
  const int64_t q_row = int64_t(b) * Hq + int64_t(hk) * (Hq / Hkv) + h0;
  const bool partial = lse != nullptr;

  int first, hi;
  const bool uniform = !admitted_rows(valid_len[b], pos0, S, window, first,
                                      hi);
  if (uniform && partial) {   // the whole cluster leaves: no merge
    if (split == 0) write_empty<HD>(static_cast<float*>(o), lse, q_row, g);
    return;
  }
  if (uniform) {
    first = 0;
    hi = S;
  }
  const int len = run_length(hi - first, n_splits, TILE);
  const int n_act = (hi - first + len - 1) / len;
  const int start = first + split * len;
  const int end = min(start + len, hi);
  // a block past the slot's last run reads nothing, and joins the merge
  // with a zero weight
  const int n_tiles = split < n_act ? (end - start + TILE - 1) / TILE : 0;

  extern __shared__ uint8_t smem_raw[];
  __shared__ uint64_t full[ST], empty[ST];
  // the swizzle atoms need 1,024-byte aligned shared addresses
  uint8_t* ring = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(ring + Sh::kRing);
  const uint32_t ring_u32 = smem_u32(ring);
  const uint32_t qs_u32 = smem_u32(Qs);

  if (tid == 0) {
    for (int s = 0; s < ST; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kTeamWarps);
    }
    mbar_init_fence();
  }
  // the chunk's q rows, zero past g, 16 bytes a thread
  for (int t = tid; t < kMmaGroup * HD / 8; t += kMmaThreads) {
    const int r = t / (HD / 8), c = t % (HD / 8);
    uint4 val = make_uint4(0, 0, 0, 0);
    if (r < g)
      val = *reinterpret_cast<const uint4*>(q + (q_row + r) * HD + c * 8);
    *reinterpret_cast<uint4*>(Qs + r * Sh::kQPitch + c * 8) = val;
  }
  __syncthreads();

  const int team = warp / kTeamWarps;     // tiles team, team + 2, ...
  const int grp = warp % kTeamWarps / Sh::kColWarps;   // rows grp * 16..
  const int cw = warp % Sh::kColWarps;    // O columns cw * kCols..
  const int state = team * Sh::kGroups + grp;   // its merge's slot
  const int mi = lane >> 3, r8 = lane & 7;   // ldmatrix: matrix, its row
  float oacc[NT][4];
  float m[NR], l[NR];

  if (warp == kMmaConsumers) {
    // producer: tile i into stage i % ST once the consumers freed tile i -
    // ST; the box rows past S read TMA's zero fill
    if (lane == 0) {
      const int zk = b * kv_slot + hk;
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % ST;
        if (i >= ST) mbar_wait(&empty[s], ((i / ST) - 1) & 1);
        uint8_t* kd = ring + s * 2 * Sh::kTileBytes;
        uint8_t* vd = kd + Sh::kTileBytes;
        const int p = start + i * TILE;
        mbar_expect_tx(&full[s], 2 * Sh::kTileBytes);
#pragma unroll
        for (int c = 0; c < HD / 64; ++c) {
          tma_load_3d(kd + c * TILE * 128, &tm_k, &full[s], c * 64, p, zk);
          tma_load_3d(vd + c * TILE * 128, &tm_v, &full[s], c * 64, p, zk);
        }
      }
    }
    __syncwarp();
  } else {
    // Q's A fragments: the 16 rows x 16 columns of k step ks
    auto q_frag = [&](uint32_t (&a)[4], int ks) {
      ldsm_x4(a, qs_u32 + (((mi & 1) * 8 + r8) * Sh::kQPitch + ks * 16 +
                           (mi >> 1) * 8) * 2);
    };
    uint32_t qa[Sh::kQRegs ? HD / 16 : 1][4];
    if constexpr (Sh::kQRegs) {
#pragma unroll
      for (int ks = 0; ks < HD / 16; ++ks) q_frag(qa[ks], ks);
    }
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) oacc[n][e] = 0.f;
#pragma unroll
    for (int r = 0; r < NR; ++r) {
      m[r] = kNegInf;
      l[r] = 0.f;
    }
    const int r0 = grp * kMmaStep;   // this warp's rows of a tile
    const int c2 = 2 * (lane & 3);   // the lane's columns of an n-tile

    for (int i = team; i < n_tiles; i += kMmaTeams) {
      const int st = i % ST;
      mbar_wait(&full[st], (i / ST) & 1);
      const uint32_t kt = ring_u32 + st * 2 * Sh::kTileBytes;
      const uint32_t vt = kt + Sh::kTileBytes;
      // S[16 heads x 16 rows] = Q . K^T over hd, the even and the odd k
      // steps in two sums: two dependent chains of hd / 32 products each
      // n-tile, where one would be hd / 16 long
      float s[2][4], s_odd[2][4];
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = s_odd[n][e] = 0.f;
#pragma unroll
      for (int ks = 0; ks < HD / 16; ++ks) {
        float (&acc)[2][4] = ks % 2 ? s_odd : s;
        uint32_t kb[4];
        ldsm_x4(kb, kt + sw_off<TILE>(r0 + (mi >> 1) * 8 + r8,
                                      2 * ks + (mi & 1)));
        if constexpr (Sh::kQRegs) {
          mma_16816(acc[0], qa[ks], kb[0], kb[1]);
          mma_16816(acc[1], qa[ks], kb[2], kb[3]);
        } else {
          uint32_t a[4];
          q_frag(a, ks);
          mma_16816(acc[0], a, kb[0], kb[1]);
          mma_16816(acc[1], a, kb[2], kb[3]);
        }
      }
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] += s_odd[n][e];
      // scaled, capped and masked by position; then the online softmax of
      // each owned row along the 16 columns (the lane quad holds them)
      const int p0 = start + i * TILE + r0 + c2;
      bool ok[2][2];
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int j = 0; j < 2; ++j) ok[n][j] = p0 + 8 * n + j < end;
      float alpha[NR];
#pragma unroll
      for (int r = 0; r < NR; ++r) {
        float mx = m[r];
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            float& x = s[n][2 * r + j];
            x = !ok[n][j] ? kNegInf
                : uniform ? 0.f : cap_score(x * scale, softcap);
            mx = fmaxf(mx, x);
          }
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        alpha[r] = expf(m[r] - mx);
        l[r] *= alpha[r];
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            float& x = s[n][2 * r + j];
            x = ok[n][j] ? expf(x - mx) : 0.f;
            l[r] += x;
          }
        m[r] = mx;
      }
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) oacc[n][e] *= alpha[kPack ? 0 : e >> 1];
      // P's A fragments, split into bf16 hi + lo
      uint32_t ph[4], pl[4];
      if constexpr (kPack) {
        ph[0] = pack_bf16(s[0][0], s[0][1]);
        ph[1] = pack_bf16_rest(s[0][0], s[0][1]);
        ph[2] = pack_bf16(s[1][0], s[1][1]);
        ph[3] = pack_bf16_rest(s[1][0], s[1][1]);
      } else {
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            ph[2 * n + r] = pack_bf16(s[n][2 * r], s[n][2 * r + 1]);
            pl[2 * n + r] = pack_bf16_rest(s[n][2 * r], s[n][2 * r + 1]);
          }
      }
      // O[:, cw * kCols..] += P . V
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t vb[4];
        ldsm_x4_t(vb, vt + sw_off<TILE>(r0 + (mi & 1) * 8 + r8,
                                        (cw * Sh::kCols + np * 16) / 8 +
                                            (mi >> 1)));
        mma_16816(oacc[2 * np], ph, vb[0], vb[1]);
        mma_16816(oacc[2 * np + 1], ph, vb[2], vb[3]);
        if constexpr (!kPack) {
          mma_16816(oacc[2 * np], pl, vb[0], vb[1]);
          mma_16816(oacc[2 * np + 1], pl, vb[2], vb[3]);
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[st]);
    }
  }
  __syncthreads();   // the ring is drained: every load landed and was read

  // merge the teams' row groups' states in the ring: [state][16] m, l,
  // then [state][16][HD] acc; then the block's state m[16], l[16],
  // acc[16][HD]
  float* sm_m = reinterpret_cast<float*>(ring);
  float* sm_l = sm_m + Sh::kStates * kMmaGroup;
  float* sm_o = sm_l + Sh::kStates * kMmaGroup;
  float* st_m = sm_o + Sh::kStates * kMmaGroup * HD;
  float* st_l = st_m + kMmaGroup;
  float* st_acc = st_l + kMmaGroup;
  if (warp < kMmaConsumers) {
    const int c2 = 2 * (lane & 3);
#pragma unroll
    for (int r = 0; r < NR; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      const int row = lane / 4 + 8 * r;
      if (cw == 0 && (lane & 3) == 0) {
        sm_m[state * kMmaGroup + row] = m[r];
        sm_l[state * kMmaGroup + row] = l[r];
      }
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          sm_o[(state * kMmaGroup + row) * HD + cw * Sh::kCols + 8 * n + c2 +
               j] = kPack ? oacc[n][j] + oacc[n][2 + j] : oacc[n][2 * r + j];
    }
  }
  __syncthreads();
  // per q head: each state's weight exp(m_r - M) (in sm_f), the block's
  // m = M and l; then acc, one (head, column) a thread
  float* sm_f = st_acc + kMmaGroup * HD;   // [state][16]
  for (int h = tid; h < g; h += kMmaThreads) {
    float mx = kNegInf;
#pragma unroll
    for (int r = 0; r < Sh::kStates; ++r)
      mx = fmaxf(mx, sm_m[r * kMmaGroup + h]);
    float den = 0.f;
#pragma unroll
    for (int r = 0; r < Sh::kStates; ++r) {
      const float f = expf(sm_m[r * kMmaGroup + h] - mx);
      sm_f[r * kMmaGroup + h] = f;
      den = fmaf(sm_l[r * kMmaGroup + h], f, den);
    }
    st_m[h] = mx;
    st_l[h] = den;
  }
  __syncthreads();
  for (int t = tid; t < g * HD; t += kMmaThreads) {
    const int h = t / HD;
    float num = 0.f;
#pragma unroll
    for (int r = 0; r < Sh::kStates; ++r)
      num = fmaf(sm_o[(r * kMmaGroup + h) * HD + t % HD],
                 sm_f[r * kMmaGroup + h], num);
    st_acc[t] = num;
  }

  // The cluster's merge: every block takes its share of the (head, column)
  // outputs and sums the blocks' states for them in rank order, read from
  // their shared memory (distributed shared memory): no workspace, no
  // counter, and every block of the cluster merges at once.
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();   // every block's state is written
  float* wt = reinterpret_cast<float*>(ring);   // [16][kMaxCluster]
  float* dens = wt + kMmaGroup * kMaxCluster;   // [16]
  float* maxs = dens + kMmaGroup;               // [16]
  for (int h = tid; h < g; h += kMmaThreads) {
    float mx = kNegInf;
    for (int r = 0; r < n_splits; ++r)
      mx = fmaxf(mx, cluster.map_shared_rank(st_m, r)[h]);
    float den = 0.f;
    for (int r = 0; r < n_splits; ++r) {
      const float f = expf(cluster.map_shared_rank(st_m, r)[h] - mx);
      wt[h * kMaxCluster + r] = f;
      den = fmaf(cluster.map_shared_rank(st_l, r)[h], f, den);
    }
    dens[h] = den;
    maxs[h] = mx;
  }
  __syncthreads();
  const int per = (g * HD + n_splits - 1) / n_splits;
  const int t_end = min(g * HD, (split + 1) * per);
  for (int t = split * per + tid; t < t_end; t += kMmaThreads) {
    const int h = t / HD, d = t % HD;
    float num = 0.f;
#pragma unroll 4
    for (int r = 0; r < n_splits; ++r)
      num = fmaf(cluster.map_shared_rank(st_acc, r)[t],
                 wt[h * kMaxCluster + r], num);
    const float val = num / fmaxf(dens[h], kMinDenom);
    if (partial) {
      static_cast<float*>(o)[(q_row + h) * HD + d] = val;
      if (d == 0) lse[q_row + h] = maxs[h] + logf(dens[h]);
    } else {
      static_cast<__nv_bfloat16*>(o)[(q_row + h) * HD + d] =
          __float2bfloat16(val);
    }
  }
  cluster.sync();   // no block leaves while another reads its state
}

template <int HD, bool kPack>
int launch_decode_mma(const void* q, const void* k, const void* v,
                      const void* valid_len, void* o, float* lse, int B,
                      int Hq, int Hkv, int kv_slot, int S, int pos0,
                      int n_splits, int window, float softcap, void* stream) {
  using Sh = MmaShape<HD>;
  // rows (b * kv_slot + hk) * S + p of the heads the view spans
  const int heads = (B - 1) * kv_slot + Hkv;
  CUtensorMap tm_k, tm_v;
  if (!hopper::encode_map(&tm_k, k, heads, S, HD, Sh::kTile)
      || !hopper::encode_map(&tm_v, v, heads, S, HD, Sh::kTile))
    return static_cast<int>(cudaErrorInvalidValue);
  auto* kernel = decode_mma<HD, kPack>;
  // above 48 KB of dynamic shared memory needs the opt-in (per device, so
  // it is set on every launch, as flash_attention.cu does)
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Sh::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_splits, Hkv * ((Hq / Hkv + kMmaGroup - 1) / kMmaGroup),
                     B);
  cfg.blockDim = dim3(kMmaThreads);
  cfg.dynamicSmemBytes = Sh::kSmem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = n_splits;
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = 1;
  cfg.attrs = &cluster;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(
      &cfg, kernel, tm_k, tm_v, static_cast<const __nv_bfloat16*>(q),
      static_cast<const int32_t*>(valid_len), o, lse, Hq, Hkv, kv_slot, S,
      pos0, window, softcap, static_cast<float>(1.0 / std::sqrt(double(HD))));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <int HD>
int launch_decode_mma_group(const void* q, const void* k, const void* v,
                            const void* valid_len, void* o, float* lse,
                            int B, int Hq, int Hkv, int kv_slot, int S,
                            int pos0, int n_splits, int window,
                            float softcap, void* stream) {
#define ATTN_DECODE_ARGS \
  q, k, v, valid_len, o, lse, B, Hq, Hkv, kv_slot, S, pos0, n_splits, window, \
      softcap, stream
  if (Hq / Hkv <= 8) return launch_decode_mma<HD, true>(ATTN_DECODE_ARGS);
  return launch_decode_mma<HD, false>(ATTN_DECODE_ARGS);
#undef ATTN_DECODE_ARGS
}

// the route: the tensor cores for bf16 at g >= 4 (wrapper: route())
inline bool decode_route_mma(int dtype, int g) { return dtype == 1 && g >= 4; }

}  // namespace attn

extern "C" {

// The decode over the whole cache (lse null: o in q's dtype; pos0 0) or
// over the block of global positions [pos0, pos0 + S) that the cache
// holds (lse float32 [B, Hq]: o float32 [B, Hq, hd] and each row's
// log-sum-exp).  dtype: 0 = float32, 1 = bfloat16; hd: 64, 128 or 256;
// any Hq / Hkv = g, in chunks = ceil(g / 16) blocks per kv head for bf16
// at g >= 4 (decode_mma), ceil(g / 8) otherwise (decode_split); kv_slot:
// the heads between two slots' caches (Hkv for a contiguous cache).
// n_splits in [1, 64] for decode_split, [1, 8] (a cluster) for
// decode_mma.  decode_split's merge: ws float32, B * Hq * n_splits * (hd +
// 2); counters int32 [B, Hkv * chunks], zero before the launch and zero
// after it (decode_mma reads neither).
// Returns cudaGetLastError() after the launch, or cudaErrorInvalidValue
// for a shape the kernel does not take (the wrapper refuses those first)
// or a tensor map cuTensorMapEncodeTiled refuses.
int attn_decode(const void* q, const void* k, const void* v,
                const void* valid_len, void* o, void* lse, void* ws,
                void* counters, int B, int Hq, int Hkv, int kv_slot, int S,
                int pos0, int hd, int dtype, int window, float softcap,
                int n_splits, void* stream) {
  if (B <= 0 || B > 65535 || Hkv <= 0 || Hq <= 0 || Hq % Hkv != 0 ||
      kv_slot < Hkv || S <= 0 || pos0 < 0 || n_splits <= 0 ||
      n_splits > attn::kMaxSplits)
    return static_cast<int>(cudaErrorInvalidValue);
  const int g = Hq / Hkv;
  const bool mma = attn::decode_route_mma(dtype, g);
  const int per = mma ? attn::kMmaGroup : attn::kMaxGroup;
  if (int64_t(Hkv) * ((g + per - 1) / per) > 65535 ||
      (mma && n_splits > attn::kMaxCluster))
    return static_cast<int>(cudaErrorInvalidValue);
  float* lse_f = static_cast<float*>(lse);
  if (mma) {
#define ATTN_DECODE_ARGS \
  q, k, v, valid_len, o, lse_f, B, Hq, Hkv, kv_slot, S, pos0, n_splits, \
      window, softcap, stream
    if (hd == 256) return attn::launch_decode_mma_group<256>(ATTN_DECODE_ARGS);
    if (hd == 128) return attn::launch_decode_mma_group<128>(ATTN_DECODE_ARGS);
    if (hd == 64) return attn::launch_decode_mma_group<64>(ATTN_DECODE_ARGS);
#undef ATTN_DECODE_ARGS
    return static_cast<int>(cudaErrorInvalidValue);
  }
#define ATTN_DECODE_ARGS \
  q, k, v, valid_len, o, lse_f, ws, counters, B, Hq, Hkv, kv_slot, S, pos0, \
      n_splits, window, softcap, stream
  if (dtype == 0 && hd == 256)
    return attn::launch_decode_group<float, 256>(ATTN_DECODE_ARGS);
  if (dtype == 0 && hd == 128)
    return attn::launch_decode_group<float, 128>(ATTN_DECODE_ARGS);
  if (dtype == 0 && hd == 64)
    return attn::launch_decode_group<float, 64>(ATTN_DECODE_ARGS);
  if (dtype == 1 && hd == 256)
    return attn::launch_decode_group<__nv_bfloat16, 256>(ATTN_DECODE_ARGS);
  if (dtype == 1 && hd == 128)
    return attn::launch_decode_group<__nv_bfloat16, 128>(ATTN_DECODE_ARGS);
  if (dtype == 1 && hd == 64)
    return attn::launch_decode_group<__nv_bfloat16, 64>(ATTN_DECODE_ARGS);
#undef ATTN_DECODE_ARGS
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"

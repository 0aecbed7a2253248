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
// Design: split-KV (flash-decoding).  The TPU kernel streams the whole
// cache through a sequential kv grid axis with a [S] bias vector of
// 0 / -2e38.  Here the grid is (split, kv head, slot) with n_splits splits
// (the wrapper picks ceil(S / 256), more when B * Hkv is too small for
// several waves on 132 SMs, at most 64), and each block serves the q heads
// of its group, at most 8 (kMaxGroup), so each cached row is read once per
// group; a larger group is cut into chunks of 8 along the grid's second
// axis (Hkv * chunks), each chunk reading the rows once.  A slot's
// admitted positions [first, hi) are cut on the card into runs of
// len = ceil((hi - first) / n_splits) rounded up to whole tiles, at least
// 4 tiles: a full 8,192-row cache gets 32 runs of 256 rows, a 1,000-row one
// 8 runs of 128, so a short slot is spread over blocks too, while no block
// is so short that its set-up and merge outweigh its reads.  A block past
// its slot's last run exits at once: the masked part of the cache is never
// read, and no length is read on the host.
//
// Bytes in flight.  K and V rows of one (slot, kv head) are contiguous, so
// a tile of rows is one span: thread 0 fetches each tile of K and of V with
// one bulk copy (cp.async.bulk, completion on an mbarrier) into a 2-stage
// ring of 8 KB tiles (32 KB; 6 blocks fit an SM at g <= 2), so up to 16 KB
// per block stay in flight while the other stage is read.  The 128 threads
// read a tile row by row from shared memory, 16 bytes a load: L = min(hd *
// sizeof(T) / 16, 32) lanes hold one row (a lane takes hd / L elements,
// one or two 16-byte loads, L * 16 bytes apart), a warp covers 32 / L rows
// per load, and each lane group keeps its own online softmax (m, l, acc)
// per q head over tile / groups rows a step (4, or 2 for float32 at hd 256,
// whose 8 KB tile is 8 rows); the dot products are L-lane shuffle sums.
// The tile stays 8 KB at every hd, so a run of at least 4 tiles moves the
// same bytes whatever the row width.  V is read from shared memory only
// for the P.V update, so the registers hold q, acc and the scores, not 4
// rows of V.  The CUDA cores and not wgmma: with at most 8 query rows per
// block the kernel does 4 * hd * g flops per
// 4 * hd bytes of K and V, far below the card's ridge point, and a 64-row
// wgmma tile would be 7/8 empty.
//
// Merge.  The block merges its lane groups in shared memory.  A slot whose
// admitted rows fit one split writes the output directly.  Otherwise each
// block writes its (m, l, acc[hd]) per q head to the float32 workspace
// [B, Hq, splits, hd + 2], fences, and counts itself on its (slot, kv
// head, chunk)'s counter; the block that counts last merges every split in
// split order (so two calls on the same input are bit-identical), writes the
// output and resets the counter to 0 for the next launch.  One launch, no
// second kernel.
//
// A block of global positions (attn_decode_partial).  A cache whose
// sequence is split over ranks (the reference's long-context decode, its
// caches' sequence over the data axes) holds rows [pos0, pos0 + S) of the
// whole cache.  The same kernel then admits local row r when pos0 + r <
// valid_len and, with a window, pos0 + r > valid_len - window: the window's
// lower bound stays on global positions (a length clamped to the local rows
// first would move it).  It writes o = acc / l in float32, unrounded, and
// lse = m + log l per (slot, q head), from which the ranks' blocks merge; a
// block with no admitted row writes o = 0 and lse = -inf, a zero weight in
// that merge, and reads no row (the whole-cache entry's mean of V over S
// rows is its own rule).  The whole-cache entry passes pos0 = 0 and no lse.
//
// What bounds it on an H100: bytes (2 * hd * sizeof(T) per admitted row per
// kv head).  The measured time and bound are in PERF.md.

#include <cmath>

#include "attention_common.cuh"
#include "hopper.cuh"

namespace attn {

constexpr int kDecThreads = 128;
constexpr int kDecWarps = kDecThreads / 32;
constexpr int kDecStages = 2;
constexpr int kDecTileBytes = 8192;   // one tile of K (and one of V)
constexpr int kMaxGroup = 8;          // q heads one block serves
constexpr int kMaxSplits = 64;        // splits per slot (the merge's table)
constexpr int kMinRunTiles = 4;       // the shortest run but a slot's last
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

  // the admitted local rows [first, hi): global positions pos0 + r below
  // valid_len and, with a window, above valid_len - window
  const int valid = valid_len[b];
  int hi = min(valid - pos0, S);
  int first = window > 0 ? max(0, valid - window + 1 - pos0) : 0;
  const bool uniform = hi <= first;
  if (uniform && partial) {
    // no admitted row: o = 0 and lse = -inf, the merge's zero weight
    if (split == 0) {
      for (int t = tid; t < g * HD; t += kDecThreads) store(q_row * HD + t, 0.f);
      for (int h = tid; h < g; h += kDecThreads)
        lse[q_row + h] = -__int_as_float(0x7f800000);
    }
    return;
  }
  // nothing admitted in the whole cache: every row weighs alike, as under
  // the reference's finite mask
  if (uniform) {
    first = 0;
    hi = S;
  }
  // this slot's runs: whole tiles, at most n_splits of them
  const int per = (hi - first + n_splits - 1) / n_splits;
  const int len = max((per + TILE - 1) / TILE, kMinRunTiles) * TILE;
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

}  // namespace attn

namespace {

int decode_entry(const void* q, const void* k, const void* v,
                 const void* valid_len, void* o, float* lse, void* ws,
                 void* counters, int B, int Hq, int Hkv, int kv_slot, int S,
                 int pos0, int hd, int dtype, int window, float softcap,
                 int n_splits, void* stream) {
  if (B <= 0 || B > 65535 || Hkv <= 0 || Hq % Hkv != 0 || Hq <= 0 ||
      kv_slot < Hkv ||
      int64_t(Hkv) * ((Hq / Hkv + attn::kMaxGroup - 1) / attn::kMaxGroup) >
          65535 ||
      S <= 0 || pos0 < 0 || n_splits <= 0 || n_splits > attn::kMaxSplits)
    return static_cast<int>(cudaErrorInvalidValue);
#define ATTN_DECODE_ARGS \
  q, k, v, valid_len, o, lse, ws, counters, B, Hq, Hkv, kv_slot, S, pos0, \
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

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16; hd: 64, 128 or 256; any Hq / Hkv, in
// chunks = ceil(Hq / Hkv / 8) blocks per kv head; kv_slot: the heads
// between two slots' caches (Hkv for a contiguous cache).  ws: float32
// [B, Hq, n_splits, hd + 2]; counters: int32 [B, Hkv * chunks], zero before
// the launch and zero after it; n_splits in [1, 64].  Returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue for a
// shape the kernel does not take (the wrapper refuses those first).
int attn_decode_forward(const void* q, const void* k, const void* v,
                        const void* valid_len, void* o, void* ws,
                        void* counters, int B, int Hq, int Hkv, int kv_slot,
                        int S, int hd, int dtype, int window, float softcap,
                        int n_splits, void* stream) {
  return decode_entry(q, k, v, valid_len, o, nullptr, ws, counters, B, Hq,
                      Hkv, kv_slot, S, 0, hd, dtype, window, softcap,
                      n_splits, stream);
}

// The same over the block of global positions [pos0, pos0 + S) that the
// cache holds (pos0 >= 0): o float32 [B, Hq, hd], lse float32 [B, Hq].
int attn_decode_partial(const void* q, const void* k, const void* v,
                        const void* valid_len, void* o, void* lse, void* ws,
                        void* counters, int B, int Hq, int Hkv, int kv_slot,
                        int S, int pos0, int hd, int dtype, int window,
                        float softcap, int n_splits, void* stream) {
  return decode_entry(q, k, v, valid_len, o, static_cast<float*>(lse), ws,
                      counters, B, Hq, Hkv, kv_slot, S, pos0, hd, dtype,
                      window, softcap, n_splits, stream);
}

}  // extern "C"

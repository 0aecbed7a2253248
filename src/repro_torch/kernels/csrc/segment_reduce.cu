// Segment sum and scatter-add for the keyed plane, for sm_90a.
//
// Replaces the TPU kernels of src/repro/kernels/segment_reduce.py:
//   segment_sum  (:115, _segment_sum_kernel / _onehot_partial)
//   scatter_add  (:160, _scatter_add_kernel)
// The TPU versions contract a one-hot [rows, segments] block against the
// value rows on the MXU and carry the sum across a sequential grid.  Blocks
// here run in parallel and in no order, so the two become:
//
// * segment_sum_sorted: a single-pass reduce-by-key over ids sorted
//   ascending (the keyed layer sorts the rows by cell before the reduce, as
//   the reference does).  Each block claims a tile of kSortedTile rows from
//   a counter, loads it as 16-byte vectors, and finds each run of equal ids
//   and its sum by a segmented scan (per thread, then warp shuffles, then
//   across the warps in shared memory).  The block that holds a run's LAST
//   row writes that segment with a plain store, and zeros for the empty ids
//   between it and the next row's id (clipped to [0, S)); the tile with row
//   0 zero-fills [0, first id), the last run fills up to S.  So every output
//   row is written exactly once, the output needs no zeroing launch, and a
//   call is one launch.  A run that began in an earlier tile takes its
//   earlier part in one of two ways.  A short run, whose head lies among
//   the 32 rows before the tile (the keyed main path's runs are one or two
//   rows), is summed by warp 0 from those rows, waiting on no other tile.
//   A longer one (a hot key's) takes it from a decoupled look-back: every
//   tile publishes a record (its trailing run's partial sum, and whether
//   the tile holds a run head) before it waits on anything; the writer
//   sums the records of the tiles back to the nearest one with a head, the
//   whole block reading 128 of them per step, so a run costs
//   O(run / tile / 128) steps.  Blocks claim tiles from a counter in the
//   order they start, so a tile waits only on tiles whose blocks are
//   already running: no deadlock.  The records are tagged with the tile's
//   ticket from a counter that is never reset (the wrapper keeps the
//   running total), so they need no zeroing per call, and each record word
//   carries its tag beside its value, so it is published by one relaxed
//   store with no fence.  Waiting on the previous tile's record, even one
//   published at once, puts that tile's whole load and scan ahead of this
//   tile's writes; the short path's one read of the rows does not.
//   Float32 partials combine in a fixed order (in the tile by the scan's
//   fixed tree, before it by a fixed tree over the short run's rows or over
//   the records back to the nearest head; which of the two, the data
//   decides), so two calls are bit-identical.
//
// * scatter_add: one thread per row.  It reads its id once and its row,
//   and the row's columns are added with red.global.add (the atomic whose
//   result is unused); d = 2 is unrolled, an int64 row comes in as one
//   16-byte load, and a warp's adds go out as lane pairs, one column each
//   (see scatter_rows); index arithmetic is 32-bit wherever R*d and C*d
//   fit.  Repeats stay allowed.  The order-blind segment_sum is this
//   scatter into an output that the wrapper zeroes.
//
// What bounds them on an H100: bytes, each input read once and each output
// written once (3.35 TB/s); at the keyed main path's sizes (about 65k rows
// of d = 2, under 1.3 MB) that is under 0.4 us for segment_sum and 1 us
// for scatter_add, below what one launch takes (a one-row kernel's device
// time is about 1.2 us), so the launch and a few dependent memory round
// trips set the time.  Removing the zeroing launch and the host's second
// launch is what the reduce-by-key buys there; a hot key's long run is
// what the look-back is for.
//
// Accumulators: int32 wraps modulo 2^32 (the reference's i32 partials),
// int64 wraps modulo 2^64 (the table's np.add.at columns); float32 sums in
// segment_sum_sorted follow the fixed order above, in scatter_add the order
// in which the atomics land.  Ids outside [0, n_out) contribute nothing.
// segment_sum_sorted's precondition (not checked, as in the reference):
// ids sorted ascending; unsorted ids leave output rows wrong or unwritten.

#include "keyed_common.cuh"

#include <climits>

namespace keyed {

// ---------------------------------------------------------------------------
// scatter_add: one thread per row
// ---------------------------------------------------------------------------

template <typename T>
struct alignas(2 * sizeof(T)) Pair {
  T a, b;
};

__device__ __forceinline__ int32_t shfl_row(int32_t v, int src) {
  return __shfl_sync(0xffffffffu, v, src);
}
__device__ __forceinline__ int64_t shfl_row(int64_t v, int src) {
  return __shfl_sync(0xffffffffu, static_cast<long long>(v), src);
}
__device__ __forceinline__ float shfl_row(float v, int src) {
  return __shfl_sync(0xffffffffu, v, src);
}

// One thread per row: it reads the row's id once and the row itself.
// D = 2 (the window table's value and count): the row is one Pair load (16
// bytes for int64, 8 for 32-bit types; launched only where rows are so
// aligned), and the warp then adds its 32 rows in two instructions of 16
// rows each, a lane pair per row and one column per lane, so each
// instruction's adds to a row land in one sector, as two threads per row
// would give; a thread adding both columns of its own row issues twice the
// sector operations, and ran slower than the element-per-thread scatter it
// replaces.
// D = 0: any d, each thread adds its row's columns.
template <typename T, int D, typename I>
__global__ void __launch_bounds__(256)
scatter_rows(const int32_t* __restrict__ ids, const T* __restrict__ rows,
             T* __restrict__ out, I n_rows, int32_t d, int32_t n_out) {
  const I stride = I(gridDim.x) * blockDim.x;
  if constexpr (D == 2) {
    const int lane = threadIdx.x & 31;
    // whole warps walk the rows, so every lane takes part in the shuffles
    for (I base = I(blockIdx.x) * blockDim.x + (threadIdx.x & ~31);
         base < n_rows; base += stride) {
      const I r = base + lane;
      int32_t id = -1;
      Pair<T> v{T(0), T(0)};
      if (r < n_rows) {
        id = __ldg(ids + r);
        v = *reinterpret_cast<const Pair<T>*>(rows + r * 2);
      }
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int src = half * 16 + (lane >> 1);
        const int32_t row_id = __shfl_sync(0xffffffffu, id, src);
        const T a = shfl_row(v.a, src), b = shfl_row(v.b, src);
        if (static_cast<uint32_t>(row_id) < static_cast<uint32_t>(n_out)) {
          red_acc(out + I(row_id) * 2 + (lane & 1), (lane & 1) ? b : a);
        }
      }
    }
  } else {
    for (I r = I(blockIdx.x) * blockDim.x + threadIdx.x; r < n_rows;
         r += stride) {
      const int32_t id = __ldg(ids + r);
      if (static_cast<uint32_t>(id) >= static_cast<uint32_t>(n_out)) continue;
      const T* src = rows + r * d;
      T* dst = out + I(id) * d;
      for (int32_t c = 0; c < d; ++c) red_acc(dst + c, src[c]);
    }
  }
}

template <typename T, int D, typename I>
void launch_rows(const void* ids, const void* rows, void* out,
                 long long n_rows, int d, int n_out, cudaStream_t stream) {
  constexpr int kThreads = 256;
  scatter_rows<T, D, I><<<grid_for(n_rows, kThreads), kThreads, 0, stream>>>(
      static_cast<const int32_t*>(ids), static_cast<const T*>(rows),
      static_cast<T*>(out), I(n_rows), d, n_out);
}

template <typename T>
int launch_scatter(const void* ids, const void* rows, void* out,
                   long long n_rows, int d, int n_out, void* stream_) {
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  const bool pair = d == 2 &&
      reinterpret_cast<uintptr_t>(rows) % (2 * sizeof(T)) == 0;
  const bool narrow = n_rows * d < INT_MAX && (long long)n_out * d < INT_MAX;
  if (pair && narrow) {
    launch_rows<T, 2, int32_t>(ids, rows, out, n_rows, d, n_out, stream);
  } else if (pair) {
    launch_rows<T, 2, int64_t>(ids, rows, out, n_rows, d, n_out, stream);
  } else if (narrow) {
    launch_rows<T, 0, int32_t>(ids, rows, out, n_rows, d, n_out, stream);
  } else {
    launch_rows<T, 0, int64_t>(ids, rows, out, n_rows, d, n_out, stream);
  }
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// segment_sum_sorted: single-pass reduce-by-key
// ---------------------------------------------------------------------------

constexpr int kSortedThreads = 128;
constexpr int kSortedItems = 4;  // consecutive rows per thread
constexpr int kSortedTile = kSortedThreads * kSortedItems;
constexpr int kSortedWarps = kSortedThreads / 32;
constexpr int kShortRows = 32;  // a run's earlier rows summed directly
static_assert(kSortedItems == 4, "the id load unpacks one int4 per thread");

// V columns of one row (V = 2 for d = 2, else 1 column per pass)
template <typename T, int V>
struct Vec {
  T v[V];
};

template <typename T> __device__ __forceinline__ T from_bits(int b);
template <> __device__ __forceinline__ int32_t from_bits<int32_t>(int b) {
  return b;
}
template <> __device__ __forceinline__ float from_bits<float>(int b) {
  return __int_as_float(b);
}

__device__ __forceinline__ int64_t min64(int32_t a, int32_t b) {
  return a < b ? a : b;
}

__device__ __forceinline__ int32_t wrap_add(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) +
                              static_cast<uint32_t>(b));
}
__device__ __forceinline__ float wrap_add(float a, float b) { return a + b; }

template <typename T, int V>
__device__ __forceinline__ Vec<T, V> operator+(const Vec<T, V>& a,
                                               const Vec<T, V>& b) {
  Vec<T, V> r;
#pragma unroll
  for (int j = 0; j < V; ++j) r.v[j] = wrap_add(a.v[j], b.v[j]);
  return r;
}

template <typename T, int V>
__device__ __forceinline__ Vec<T, V> zero_vec() {
  Vec<T, V> r;
#pragma unroll
  for (int j = 0; j < V; ++j) r.v[j] = T(0);
  return r;
}

template <typename T, int V>
__device__ __forceinline__ Vec<T, V> shfl_up(const Vec<T, V>& x, int off) {
  Vec<T, V> r;
#pragma unroll
  for (int j = 0; j < V; ++j) r.v[j] = __shfl_up_sync(0xffffffffu, x.v[j], off);
  return r;
}

template <typename T, int V>
__device__ __forceinline__ Vec<T, V> shfl_xor(const Vec<T, V>& x, int m) {
  Vec<T, V> r;
#pragma unroll
  for (int j = 0; j < V; ++j) r.v[j] = __shfl_xor_sync(0xffffffffu, x.v[j], m);
  return r;
}

template <typename T, int V>
__device__ __forceinline__ void store_vec(T* p, const Vec<T, V>& x) {
  if constexpr (V == 2) {
    *reinterpret_cast<Pair<T>*>(p) = Pair<T>{x.v[0], x.v[1]};
  } else {
    *p = x.v[0];
  }
}

// A look-back record word: (tag << 33) | (has_head << 32) | value bits.  It
// carries its own tag, so it is published by one relaxed 64-bit store with
// no fence, and a reader that sees the tag it waits for sees the value.
__device__ __forceinline__ unsigned long long load_word(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];"
               : "=l"(v) : "l"(__cvta_generic_to_global(p)) : "memory");
  return v;
}

__device__ __forceinline__ void store_word(unsigned long long* p,
                                           unsigned long long v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;"
               :: "l"(__cvta_generic_to_global(p)), "l"(v) : "memory");
}

__device__ __forceinline__ unsigned int to_bits(int32_t v) {
  return static_cast<unsigned int>(v);
}
__device__ __forceinline__ unsigned int to_bits(float v) {
  return __float_as_uint(v);
}

// Zeros for output rows [lo, hi) of the column pass at c0, each lane
// offering its own range; the warp fills them one range after another.
template <typename T, int V>
__device__ __forceinline__ void warp_fill(T* out, int32_t d, int32_t c0,
                                          int64_t lo, int64_t hi) {
  const int lane = threadIdx.x & 31;
  unsigned todo = __ballot_sync(0xffffffffu, hi > lo);
  while (todo) {
    const int src = __ffs(todo) - 1;
    todo &= todo - 1;
    const int64_t a = __shfl_sync(0xffffffffu, lo, src);
    const int64_t b = __shfl_sync(0xffffffffu, hi, src);
    for (int64_t g = a + lane; g < b; g += 32) {
      store_vec(out + g * d + c0, zero_vec<T, V>());
    }
  }
}

// Workspace: word 0 is the tile counter, then one record word per (tile,
// column), tagged with the tile's ticket + 1 (base + tile + 1 < 2^31; the
// host starts a zeroed workspace before the tags would reach 2^31).  The
// last tile publishes none (no tile looks back at it).
template <typename T, int V>
__global__ void __launch_bounds__(kSortedThreads)
segment_sum_sorted_kernel(const int32_t* __restrict__ ids,
                          const T* __restrict__ values, T* __restrict__ out,
                          int32_t n_rows, int32_t d, int32_t n_seg,
                          unsigned long long* __restrict__ workspace,
                          unsigned long long base) {
  unsigned long long* const rec = workspace + 1;
  __shared__ int32_t s_tile;
  __shared__ int32_t s_first_id, s_last_id;
  __shared__ int s_first_continues, s_last_ends;
  __shared__ int s_nearest;    // look-back: the nearest record with a head
  __shared__ int s_short;      // the run's earlier part came from its rows
  __shared__ int s_warp_flag[kSortedWarps];
  __shared__ Vec<T, V> s_warp_val[kSortedWarps];
  __shared__ Vec<T, V> s_carry;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  if (tid == 0) {
    s_tile = static_cast<int32_t>(atomicAdd(workspace, 1ull) - base);
  }
  __syncthreads();
  const int32_t tile = s_tile;
  const int32_t row0 = tile * kSortedTile;
  const int32_t first = row0 + tid * kSortedItems;
  const bool full = row0 + kSortedTile <= n_rows;
  const int32_t tile_last = min(row0 + kSortedTile, n_rows) - 1;

  // -- ids, values, heads and run ends ----------------------------------------
  int32_t id[kSortedItems];
  if (full && reinterpret_cast<uintptr_t>(ids) % 16 == 0) {
    const int4 x = __ldg(reinterpret_cast<const int4*>(ids + first));
    id[0] = x.x; id[1] = x.y; id[2] = x.z; id[3] = x.w;
  } else {
#pragma unroll
    for (int k = 0; k < kSortedItems; ++k) {
      id[k] = first + k < n_rows ? __ldg(ids + first + k) : 0;
    }
  }
  // a row of V columns as whole 16-byte vectors, issued with the ids
  constexpr int kVecs = kSortedItems * V * sizeof(T) / 16;
  const bool vector_rows = V == d && full &&
                           reinterpret_cast<uintptr_t>(values) % 16 == 0;
  int bits[4 * kVecs];
  if (vector_rows) {
    const int4* src = reinterpret_cast<const int4*>(values + int64_t(first) * V);
#pragma unroll
    for (int i = 0; i < kVecs; ++i) {
      const int4 q = __ldg(src + i);
      bits[4 * i] = q.x; bits[4 * i + 1] = q.y;
      bits[4 * i + 2] = q.z; bits[4 * i + 3] = q.w;
    }
  }
  const int32_t last = first + kSortedItems - 1;  // this thread's last row
  const int32_t prev = first > 0 && first <= n_rows ? __ldg(ids + first - 1)
                                                    : 0;
  const int32_t next = last + 1 < n_rows ? __ldg(ids + last + 1) : 0;
  bool head[kSortedItems], end[kSortedItems];
  int64_t gap_hi[kSortedItems];  // a run end: zeros up to this row
#pragma unroll
  for (int k = 0; k < kSortedItems; ++k) {
    const int32_t r = first + k;
    const bool valid = r < n_rows;
    const int32_t before = k ? id[k - 1] : prev;
    const bool final_row = r == n_rows - 1;
    const int32_t after = k + 1 < kSortedItems ? id[k + 1] : next;
    head[k] = valid && (r == 0 || id[k] != before);
    end[k] = valid && (final_row || id[k] != after);
    gap_hi[k] = final_row ? int64_t(n_seg) : min64(after, n_seg);
  }
  // what decides the look-back: the tile's first row (does its run begin in
  // an earlier tile, with an id in range?) and its last (does that run end
  // here?), read after the first barrier below
  if (tid == 0) {
    s_first_id = id[0];
    s_first_continues = !head[0];
  }
#pragma unroll
  for (int k = 0; k < kSortedItems; ++k) {
    if (first + k == tile_last) {
      s_last_id = id[k];
      s_last_ends = end[k];
    }
  }
  const bool publishes = tile_last < n_rows - 1;
  const int n_pass = d / V;

  for (int pass = 0; pass < n_pass; ++pass) {
    const int32_t c0 = pass * V;
    // -- values ------------------------------------------------------------
    Vec<T, V> x[kSortedItems];
    if (vector_rows) {
#pragma unroll
      for (int k = 0; k < kSortedItems; ++k) {
#pragma unroll
        for (int j = 0; j < V; ++j) x[k].v[j] = from_bits<T>(bits[k * V + j]);
      }
    } else {
#pragma unroll
      for (int k = 0; k < kSortedItems; ++k) {
#pragma unroll
        for (int j = 0; j < V; ++j) {
          x[k].v[j] = first + k < n_rows
              ? __ldg(values + int64_t(first + k) * d + c0 + j) : T(0);
        }
      }
    }
    // -- segmented inclusive scan in the thread ------------------------------
    Vec<T, V> in_run[kSortedItems];  // the run's sum from its head or the
    bool seen[kSortedItems];         // thread's first row; a head so far
    Vec<T, V> acc = zero_vec<T, V>();
    bool any = false;
#pragma unroll
    for (int k = 0; k < kSortedItems; ++k) {
      acc = head[k] ? x[k] : acc + x[k];
      any = any || head[k];
      in_run[k] = acc;
      seen[k] = any;
    }
    // -- segmented scan of the threads' aggregates: the warp ----------------
    int f = any;
    Vec<T, V> v = acc;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int fu = __shfl_up_sync(0xffffffffu, f, off);
      const Vec<T, V> vu = shfl_up(v, off);
      if (lane >= off) {
        if (!f) v = vu + v;
        f |= fu;
      }
    }
    if (lane == 31) {
      s_warp_flag[warp] = f;
      s_warp_val[warp] = v;
    }
    int ef = __shfl_up_sync(0xffffffffu, f, 1);  // the lane's exclusive prefix
    Vec<T, V> ev = shfl_up(v, 1);
    if (lane == 0) {
      ef = 0;
      ev = zero_vec<T, V>();
    }
    __syncthreads();
    // the tile's first run began in an earlier tile, holds an id in range,
    // and ends in this tile: its writer looks back
    const bool need = s_first_continues &&
                      static_cast<uint32_t>(s_first_id) <
                          static_cast<uint32_t>(n_seg) &&
                      (s_last_id != s_first_id || s_last_ends);
    // -- ... and the warps before this one ------------------------------------
    int pf = 0;
    Vec<T, V> pv = zero_vec<T, V>();
    for (int w = 0; w < warp; ++w) {
      const Vec<T, V> wv = s_warp_val[w];
      pv = s_warp_flag[w] ? wv : pv + wv;
      pf |= s_warp_flag[w];
    }
    if (warp) {
      ev = ef ? ev : pv + ev;
      ef |= pf;
    }
    // -- publish the tile's record ---------------------------------------------
    if (publishes && tid == kSortedThreads - 1) {
      const Vec<T, V> tail = any ? acc : ev + acc;
      const unsigned long long tag =
          ((base + static_cast<unsigned long long>(tile) + 1ull) << 1) |
          ((ef | any) ? 1ull : 0ull);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        store_word(rec + int64_t(tile) * d + c0 + j,
                   (tag << 32) | to_bits(tail.v[j]));
      }
    }
    // -- look back for the first run's earlier part ----------------------------
    if (need && warp == 0) {
      // a short run: its head lies among the kShortRows rows before the
      // tile, which warp 0 reads and sums (a fixed tree) without waiting on
      // any other tile
      const int32_t r = row0 - 1 - lane;  // lane 0: the nearest row
      Vec<T, V> part = zero_vec<T, V>();
      bool same = false;
      if (r >= 0) {
        same = __ldg(ids + r) == s_first_id;
#pragma unroll
        for (int j = 0; j < V; ++j) {
          part.v[j] = __ldg(values + int64_t(r) * d + c0 + j);
        }
      }
      const unsigned differ = __ballot_sync(0xffffffffu, !same);
      const int stop = differ ? __ffs(differ) - 1 : kShortRows;
      if (lane >= stop) part = zero_vec<T, V>();
#pragma unroll
      for (int m = 16; m; m >>= 1) part = part + shfl_xor(part, m);
      if (lane == 0) {
        s_carry = part;
        s_short = stop < kShortRows;
      }
    }
    if (need) __syncthreads();
    if (need && !s_short) {
      // a long run: block-wide windows of kSortedThreads records, nearest
      // first; each thread sums the records it reads, then a fixed tree
      // sums the threads
      Vec<T, V> part = zero_vec<T, V>();
      for (int32_t top = tile - 1;; top -= kSortedThreads) {
        const int32_t j = top - tid;
        bool has_head = false;
        Vec<T, V> rv = zero_vec<T, V>();
        if (j >= 0) {
          const unsigned long long want =
              base + static_cast<unsigned long long>(j) + 1ull;
#pragma unroll
          for (int jj = 0; jj < V; ++jj) {
            const unsigned long long* p = rec + int64_t(j) * d + c0 + jj;
            unsigned long long w;
            while (((w = load_word(p)) >> 33) != want) __nanosleep(20);
            has_head = (w >> 32) & 1ull;
            rv.v[jj] = from_bits<T>(static_cast<int>(w & 0xffffffffull));
          }
        }
        if (tid == 0) s_nearest = INT_MAX;
        __syncthreads();
        if (has_head) atomicMin(&s_nearest, tid);
        __syncthreads();
        const int nearest = s_nearest;
        if (j >= 0 && tid <= nearest) part = part + rv;
        __syncthreads();  // s_nearest is reset by the next window
        if (nearest != INT_MAX) break;
      }
#pragma unroll
      for (int m = 16; m; m >>= 1) part = part + shfl_xor(part, m);
      if (lane == 0) s_warp_val[warp] = part;
      __syncthreads();
      if (tid == 0) {
        Vec<T, V> carry = s_warp_val[0];
        for (int w = 1; w < kSortedWarps; ++w) carry = carry + s_warp_val[w];
        s_carry = carry;
      }
      __syncthreads();
    }
    // -- write each run that ends here, and the empty ids after it -------------
    int64_t lo[kSortedItems], hi[kSortedItems];
#pragma unroll
    for (int k = 0; k < kSortedItems; ++k) {
      lo[k] = hi[k] = 0;
      if (!end[k]) continue;
      Vec<T, V> sum = in_run[k];
      if (!seen[k]) sum = ef ? ev + sum : (need ? s_carry + (ev + sum)
                                                   : ev + sum);
      if (static_cast<uint32_t>(id[k]) < static_cast<uint32_t>(n_seg)) {
        store_vec(out + int64_t(id[k]) * d + c0, sum);
      }
      lo[k] = id[k] < 0 ? int64_t(0) : int64_t(id[k]) + 1;
      hi[k] = gap_hi[k];
    }
#pragma unroll
    for (int k = 0; k < kSortedItems; ++k) {
      warp_fill<T, V>(out, d, c0, lo[k], hi[k]);
    }
    if (tile == 0 && warp == 0) {
      // ids below the first row's
      warp_fill<T, V>(out, d, c0, 0,
                      tid == 0 ? min64(id[0], n_seg) : int64_t(0));
    }
    __syncthreads();  // shared memory is reused by the next pass
  }
}

template <typename T>
int launch_sorted(const void* ids, const void* values, void* out,
                  long long n_rows, int d, int n_seg, void* workspace,
                  unsigned long long base, void* stream_) {
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  const unsigned int tiles =
      static_cast<unsigned int>((n_rows + kSortedTile - 1) / kSortedTile);
  const auto* i = static_cast<const int32_t*>(ids);
  auto* w = static_cast<unsigned long long*>(workspace);
  if (d == 2) {
    segment_sum_sorted_kernel<T, 2><<<tiles, kSortedThreads, 0, stream>>>(
        i, static_cast<const T*>(values), static_cast<T*>(out),
        int32_t(n_rows), d, n_seg, w, base);
  } else {
    segment_sum_sorted_kernel<T, 1><<<tiles, kSortedThreads, 0, stream>>>(
        i, static_cast<const T*>(values), static_cast<T*>(out),
        int32_t(n_rows), d, n_seg, w, base);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace keyed

extern "C" {

// values [n_rows, d], ids [n_rows] sorted ascending, out [n_seg, d] (need
// not be zeroed); workspace: 1 + d * tiles uint64 words, zeroed once when
// allocated; base = the tiles claimed from its counter by earlier calls,
// base + tiles < 2^31.  Tiles of 512 rows; n_rows < 2^31 - 1024.
int keyed_segment_sum_sorted_i32(const void* ids, const void* values,
                                 void* out, long long n_rows, int d,
                                 int n_seg, void* workspace,
                                 unsigned long long base, void* stream) {
  return keyed::launch_sorted<int32_t>(ids, values, out, n_rows, d, n_seg,
                                       workspace, base, stream);
}

int keyed_segment_sum_sorted_f32(const void* ids, const void* values,
                                 void* out, long long n_rows, int d,
                                 int n_seg, void* workspace,
                                 unsigned long long base, void* stream) {
  return keyed::launch_sorted<float>(ids, values, out, n_rows, d, n_seg,
                                     workspace, base, stream);
}

// out [n_seg, d] must be zeroed by the caller; values [n_rows, d]; ids [n_rows]
int keyed_segment_sum_i32(const void* ids, const void* values, void* out,
                          long long n_rows, int d, int n_seg, void* stream) {
  return keyed::launch_scatter<int32_t>(ids, values, out, n_rows, d, n_seg,
                                        stream);
}

int keyed_segment_sum_f32(const void* ids, const void* values, void* out,
                          long long n_rows, int d, int n_seg, void* stream) {
  return keyed::launch_scatter<float>(ids, values, out, n_rows, d, n_seg,
                                      stream);
}

// table [n_cells, d] is updated in place; rows [n_rows, d]; ids [n_rows]
int keyed_scatter_add_i64(const void* ids, const void* rows, void* table,
                          long long n_rows, int d, int n_cells, void* stream) {
  return keyed::launch_scatter<int64_t>(ids, rows, table, n_rows, d, n_cells,
                                        stream);
}

int keyed_scatter_add_i32(const void* ids, const void* rows, void* table,
                          long long n_rows, int d, int n_cells, void* stream) {
  return keyed::launch_scatter<int32_t>(ids, rows, table, n_rows, d, n_cells,
                                        stream);
}

int keyed_scatter_add_f32(const void* ids, const void* rows, void* table,
                          long long n_rows, int d, int n_cells, void* stream) {
  return keyed::launch_scatter<float>(ids, rows, table, n_rows, d, n_cells,
                                      stream);
}

}  // extern "C"

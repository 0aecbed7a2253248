// Window-table row match for the keyed plane, for sm_90a: the probe-window
// lookup.
//
// Replaces the TPU kernels of src/repro/kernels/hash_table.py:
//   table_lookup          (_table_lookup_kernel / _match_candidates)
//   batched_table_lookup  (_batched_table_lookup_kernel /
//                          _batched_match_candidates)
//
// The function.  For each cell (key, start) -- and, batched, its owner
// shard -- take its home h = cell_hash(key, start, capacity): the uint64
// wraparound hash of src/repro_torch/keyed/table.py (mix = key * M + start *
// X, home = (mix * M) mod capacity, M = 2654435761, X = 0x9E3779B97F4A7C15,
// keys and starts as their two's-complement uint64 bits).  Its candidate
// rows are owner * capacity + (h + p) % capacity for p in 0 .. max_probes-1
// (owner 0 for the one-shard lookup, where capacity is the table's rows).
// The result is the FIRST candidate, in probe order, that is occupied and
// whose key and start equal the cell's; a miss gives n_rows, the rows of
// the planes.  An owner outside [0, n_rows / capacity) has no segment and
// misses, as in the TPU kernels, whose owner plane holds no such owner.
//
// The TPU kernels scan the whole table and return the least matching row.
// Under the table's invariant -- every live cell has exactly one row, and
// it lies inside the cell's probe window, because every mutator places
// rows through the probe-window claim and lookups scan the whole window --
// the two are the same row.  On a table that breaks the invariant they
// differ: a live copy outside the window is not found here, and of two
// live copies inside it the first in probe order wins, not the lower row.
// No table of the port or of the reference builds such a table.
//
// Design: 16 lanes per cell, one probe per lane, two cells per warp.
// Consecutive lanes read consecutive rows, so a window's keys and starts
// are two coalesced spans of 16 int64 (4-5 sectors each) and its occupancy
// 16 bytes; the home is computed in the kernel, so the caller launches no
// hash of its own.  __ballot_sync over "occupied and equal" and __ffs give
// the first match in probe order (the ballot's bit is p, not the row, so a
// window that wraps the segment's end stays ordered by p); max_probes above
// 16 loops in chunks of 16 and stops at the first chunk with a match.
//
// What bounds it on an H100: bytes.  Each cell reads its key and start
// (16 bytes), writes its row (4), and reads at most max_probes rows of 17
// bytes of the planes (int64 key, int64 start, the occupancy byte); the
// 64-bit remainder of the hash and the compares are a few dozen operations
// per cell.  The full scan it replaces was O(cells x rows) compares.

#include "keyed_common.cuh"

namespace keyed {

constexpr int kThreads = 256;
constexpr int kLanes = 16;   // probes per pass, one per lane
constexpr uint64_t kHashMultiplier = 2654435761ull;
constexpr uint64_t kStartMix = 0x9E3779B97F4A7C15ull;

__device__ __forceinline__ uint64_t cell_home(int64_t key, int64_t start,
                                              uint64_t capacity) {
  const uint64_t mix = static_cast<uint64_t>(key) * kHashMultiplier +
                       static_cast<uint64_t>(start) * kStartMix;
  return (mix * kHashMultiplier) % capacity;
}

__global__ void __launch_bounds__(kThreads)
table_match(const int32_t* __restrict__ cell_owner,   // nullptr: one shard
            const int64_t* __restrict__ cell_key,
            const int64_t* __restrict__ cell_start,
            const int64_t* __restrict__ row_key,
            const int64_t* __restrict__ row_start,
            const uint8_t* __restrict__ row_occ,
            int32_t* __restrict__ out, int64_t n_cells, int32_t n_rows,
            int32_t capacity, int32_t max_probes) {
  const int64_t cell =
      (int64_t(blockIdx.x) * blockDim.x + threadIdx.x) / kLanes;
  if (cell >= n_cells) return;   // whole 16-lane groups leave together
  const int lane = threadIdx.x % kLanes;
  const unsigned int group = 0xFFFFu << (threadIdx.x & 16);  // this cell's
  const int64_t key = cell_key[cell];
  const int64_t start = cell_start[cell];
  const int32_t owner = cell_owner != nullptr ? cell_owner[cell] : 0;
  int32_t found = n_rows;
  if (owner >= 0 && owner < n_rows / capacity) {
    const int64_t base = int64_t(owner) * capacity;
    const int64_t home = static_cast<int64_t>(
        cell_home(key, start, static_cast<uint64_t>(capacity)));
    for (int p0 = 0; p0 < max_probes; p0 += kLanes) {
      const int p = p0 + lane;
      // home + p < 2 * capacity, since max_probes <= capacity
      int64_t slot = home + p;
      if (slot >= capacity) slot -= capacity;
      const int64_t row = base + slot;
      const bool hit = p < max_probes && row_occ[row] != 0 &&
                       row_key[row] == key && row_start[row] == start;
      const unsigned int ballot =
          (__ballot_sync(group, hit) & group) >> (threadIdx.x & 16);
      if (ballot != 0) {
        int64_t first = home + p0 + __ffs(ballot) - 1;
        if (first >= capacity) first -= capacity;
        found = static_cast<int32_t>(base + first);
        break;
      }
    }
  }
  if (lane == 0) out[cell] = found;
}

int launch_match(const void* cell_owner, const void* cell_key,
                 const void* cell_start, const void* row_key,
                 const void* row_start, const void* row_occ, void* out,
                 long long n_cells, int n_rows, int capacity, int max_probes,
                 void* stream) {
  if (n_cells < 0 || n_rows < 0 || capacity <= 0 || max_probes <= 0 ||
      max_probes > capacity ||
      n_cells > (int64_t(1) << 31) * kThreads / kLanes)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_cells == 0) return static_cast<int>(cudaSuccess);
  const unsigned int blocks = static_cast<unsigned int>(
      (n_cells * kLanes + kThreads - 1) / kThreads);
  table_match<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(cell_owner),
      static_cast<const int64_t*>(cell_key),
      static_cast<const int64_t*>(cell_start),
      static_cast<const int64_t*>(row_key),
      static_cast<const int64_t*>(row_start),
      static_cast<const uint8_t*>(row_occ), static_cast<int32_t*>(out),
      n_cells, n_rows, capacity, max_probes);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace keyed

extern "C" {

// cells [n_cells] int64 key/start; table [capacity] int64 key/start + uint8
// occupancy; out [n_cells] int32 (capacity = miss); 1 <= max_probes <=
// capacity
int keyed_table_lookup(const void* cell_key, const void* cell_start,
                       const void* row_key, const void* row_start,
                       const void* row_occ, void* out, long long n_cells,
                       int capacity, int max_probes, void* stream) {
  return keyed::launch_match(nullptr, cell_key, cell_start, row_key,
                             row_start, row_occ, out, n_cells, capacity,
                             capacity, max_probes, stream);
}

// as keyed_table_lookup over n_rows = n_w * capacity stacked rows, with an
// int32 owner per cell: its window lies in rows [owner * capacity,
// (owner + 1) * capacity); out = n_rows on a miss
int keyed_batched_table_lookup(const void* cell_owner, const void* cell_key,
                               const void* cell_start, const void* row_key,
                               const void* row_start, const void* row_occ,
                               void* out, long long n_cells, int n_rows,
                               int capacity, int max_probes, void* stream) {
  return keyed::launch_match(cell_owner, cell_key, cell_start, row_key,
                             row_start, row_occ, out, n_cells, n_rows,
                             capacity, max_probes, stream);
}

}  // extern "C"

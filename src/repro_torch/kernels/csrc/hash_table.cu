// Window-table row match for the keyed plane, for sm_90a.
//
// Replaces the TPU kernels of src/repro/kernels/hash_table.py:
//   table_lookup          (_table_lookup_kernel / _match_candidates)
//   batched_table_lookup  (_batched_table_lookup_kernel /
//                          _batched_match_candidates)
// Both return, for every cell (key, start) -- and, batched, its owner
// shard -- the LEAST occupied row of the whole table whose planes equal the
// cell's, or n_rows on a miss.  The TPU kernels compare int32 lo/hi halves
// because its vector unit has no 64-bit lanes; here int64 is compared
// directly.  The function is kept exactly: the minimum over the whole table,
// not over the cell's probe window, so the result does not depend on the
// table invariant that makes the two agree.
//
// Design: one thread per cell, a block of kThreads cells.  The block walks
// the row range in tiles of kTile rows staged in shared memory (key, start,
// owner, occupancy); every thread compares its cell against the tile, all
// threads reading the same shared address (a broadcast).  Rows are scanned
// in ascending order, so a thread's first match is its minimum and it stops
// comparing; when every cell of the block has matched the block stops too.
//
// What bounds it on an H100: operations.  It is an O(cells x rows) scan:
// at the main path's shapes (about 65k cells against 2.1M rows) that is
// 1.4e11 cell-row compares per call, while the bytes it must move are a few
// tens of MB.  The shared-memory tiles make each row cost one global read
// per block instead of one per cell.  A probe-window lookup that takes the
// table invariant as a precondition would need O(cells x probes) work; that
// redesign is left to a later change.

#include "keyed_common.cuh"

namespace keyed {

constexpr int kThreads = 128;
constexpr int kTile = 1024;

__global__ void __launch_bounds__(kThreads)
table_match(const int32_t* __restrict__ cell_owner,   // nullptr: one shard
            const int64_t* __restrict__ cell_key,
            const int64_t* __restrict__ cell_start,
            const int32_t* __restrict__ row_owner,    // nullptr: one shard
            const int64_t* __restrict__ row_key,
            const int64_t* __restrict__ row_start,
            const uint8_t* __restrict__ row_occ,
            int32_t* __restrict__ out, int64_t n_cells, int32_t n_rows) {
  __shared__ int64_t s_key[kTile];
  __shared__ int64_t s_start[kTile];
  __shared__ int32_t s_owner[kTile];
  __shared__ uint8_t s_occ[kTile];

  const int64_t cell = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  const bool valid = cell < n_cells;
  const int64_t key = valid ? cell_key[cell] : 0;
  const int64_t start = valid ? cell_start[cell] : 0;
  const int32_t owner = (valid && cell_owner != nullptr) ? cell_owner[cell] : 0;
  int32_t best = n_rows;

  for (int32_t base = 0; base < n_rows; base += kTile) {
    const int32_t len = min(kTile, n_rows - base);
    for (int32_t j = threadIdx.x; j < len; j += blockDim.x) {
      const int32_t row = base + j;
      s_key[j] = row_key[row];
      s_start[j] = row_start[row];
      s_owner[j] = row_owner != nullptr ? row_owner[row] : 0;
      s_occ[j] = row_occ[row];
    }
    __syncthreads();
    if (valid && best == n_rows) {
      for (int32_t j = 0; j < len; ++j) {
        if (s_key[j] == key && s_start[j] == start && s_owner[j] == owner &&
            s_occ[j] != 0) {
          best = base + j;
          break;
        }
      }
    }
    // also the barrier before the next tile overwrites shared memory
    if (__syncthreads_and(!valid || best != n_rows)) break;
  }
  if (valid) out[cell] = best;
}

int launch_match(const void* cell_owner, const void* cell_key,
                 const void* cell_start, const void* row_owner,
                 const void* row_key, const void* row_start,
                 const void* row_occ, void* out, long long n_cells,
                 int n_rows, void* stream) {
  const unsigned int blocks =
      static_cast<unsigned int>((n_cells + kThreads - 1) / kThreads);
  table_match<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(cell_owner),
      static_cast<const int64_t*>(cell_key),
      static_cast<const int64_t*>(cell_start),
      static_cast<const int32_t*>(row_owner),
      static_cast<const int64_t*>(row_key),
      static_cast<const int64_t*>(row_start),
      static_cast<const uint8_t*>(row_occ), static_cast<int32_t*>(out),
      n_cells, n_rows);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace keyed

extern "C" {

// cells [n_cells] int64 key/start; table [n_rows] int64 key/start + uint8
// occupancy; out [n_cells] int32 (n_rows = miss)
int keyed_table_lookup(const void* cell_key, const void* cell_start,
                       const void* row_key, const void* row_start,
                       const void* row_occ, void* out, long long n_cells,
                       int n_rows, void* stream) {
  return keyed::launch_match(nullptr, cell_key, cell_start, nullptr, row_key,
                             row_start, row_occ, out, n_cells, n_rows, stream);
}

// as keyed_table_lookup plus int32 owner planes for cells and rows
int keyed_batched_table_lookup(const void* cell_owner, const void* cell_key,
                               const void* cell_start, const void* row_owner,
                               const void* row_key, const void* row_start,
                               const void* row_occ, void* out,
                               long long n_cells, int n_rows, void* stream) {
  return keyed::launch_match(cell_owner, cell_key, cell_start, row_owner,
                             row_key, row_start, row_occ, out, n_cells,
                             n_rows, stream);
}

}  // extern "C"

// Segment sum and scatter-add for the keyed plane, for sm_90a.
//
// Replaces the TPU kernels of src/repro/kernels/segment_reduce.py:
//   segment_sum  (_segment_sum_kernel / _onehot_partial)
//   scatter_add  (_scatter_add_kernel)
// The TPU versions contract a one-hot [rows, segments] block against the
// value rows on the MXU and carry the sum across a sequential grid.  Here
// both are one scatter: one thread per (row, column) adds its element into
// the output row with an atomic.  segment_sum is scatter_add into a zeroed
// [S, d] output that the wrapper allocates.
//
// What bounds it on an H100: bytes.  Each input element is read once and
// each output element receives one atomic per contributing row, so the work
// is a few bytes per element against 3.35 TB/s; at the keyed main path's
// sizes (about 65k rows of d = 2) the launch itself dominates.  Atomics on
// distinct cells do not contend (the main path's cells are nearly all
// distinct); a sorted input would allow a segmented warp reduction that
// issues one atomic per run, which is left to a later change.
//
// Accumulators: int32 wraps modulo 2^32 (the reference's i32 partials),
// int64 wraps modulo 2^64 (the table's np.add.at columns), float32 adds in
// whatever order the atomics land, so float results differ from a serial
// sum in the last bits.  Ids outside [0, n_out) contribute nothing.

#include "keyed_common.cuh"

namespace keyed {

template <typename T>
__global__ void scatter_accumulate(const int32_t* __restrict__ ids,
                                   const T* __restrict__ rows,
                                   T* __restrict__ out,
                                   int64_t n_rows, int32_t d, int32_t n_out) {
  const int64_t total = n_rows * d;
  const int64_t stride = int64_t(gridDim.x) * blockDim.x;
  for (int64_t i = int64_t(blockIdx.x) * blockDim.x + threadIdx.x; i < total;
       i += stride) {
    const int64_t r = i / d;
    const int32_t c = static_cast<int32_t>(i - r * d);
    const int32_t id = ids[r];
    if (static_cast<uint32_t>(id) < static_cast<uint32_t>(n_out)) {
      atomic_acc(out + int64_t(id) * d + c, rows[i]);
    }
  }
}

template <typename T>
int launch_scatter(const void* ids, const void* rows, void* out,
                   long long n_rows, int d, int n_out, void* stream) {
  constexpr int kThreads = 256;
  const int64_t work = int64_t(n_rows) * d;
  scatter_accumulate<T><<<grid_for(work, kThreads), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(ids), static_cast<const T*>(rows),
      static_cast<T*>(out), n_rows, d, n_out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace keyed

extern "C" {

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

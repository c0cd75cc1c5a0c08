// Hopper SpMM over a RowTiledCOO pack: out (m, r) = S @ B.
//
// Replaces the TPU kernel src/repro/kernels/spmm.py::spmm_pallas (body
// _spmm_kernel), which turned the scatter-add into a one-hot matmul on
// the MXU and carried each output window across sequential grid steps
// in an aliased zeros buffer.  Hopper runs blocks in no order, so here
// one thread block owns one output window (x one column chunk of <= 128
// columns), accumulates the window's nonzeros in pack order in float32
// and writes the window once.  No atomics: the sum order is fixed.
//
// Bound on the H100: the bytes of the gathers.  Each nonzero reads one
// row of B (r values, 512 B at r = 128 in float32) for 2 flops a value.
// On an Erdos-Renyi matrix a row of B is used about 0.16 times while it
// could sit in the 50 MB L2, so no order of traversal creates reuse:
// the gathers, nnz * r * itemsize bytes, are read from device memory,
// and the floor is those bytes at the rate the card streams.
//
// Two forms (rt::launch_spmm in bulk.cuh; the wrapper chooses by shape):
//   bulk  persistent blocks; a producer warp stages each window's index
//         run into shared memory with cp.async.bulk (1-D TMA), one chunk
//         ahead, and issues one bulk copy per nonzero's B row into a ring
//         of mbarrier-tracked stages (32 rows in flight per block and
//         five blocks an SM at r = 128 float32); consumer threads own
//         one column each and apply the rows in pack order, the running
//         row in a register.
//   load  the original form, for shapes the bulk copies cannot take
//         (rows not a whole number of 16-byte units, unaligned bases):
//         one block per window x chunk, indices staged by plain loads,
//         eight B reads in flight per thread (rt::spmm_kernel in
//         common.cuh).
#include "bulk.cuh"

RT_ERROR_STRING_FN

extern "C" int rt_spmm(const void* off, const void* rows_local,
                       const void* cols, const void* vals, const void* B,
                       void* out, long long nb, int k, int row_tile, int m,
                       int r, int form, int vals_bf16, int dense_bf16,
                       void* stream) {
  int err = 0;
  RT_DISPATCH(vals_bf16, dense_bf16,
              err = rt::launch_spmm<TV, TD>(
                  form, (const int64_t*)off, (const int32_t*)rows_local,
                  (const int32_t*)cols, (const TV*)vals, (const TD*)B,
                  (TD*)out, nb, k, row_tile, m, r, (cudaStream_t)stream));
  return err;
}

// Hopper SpMM over a RowTiledCOO pack: out (m, r) = S @ B.
//
// Replaces the TPU kernel src/repro/kernels/spmm.py::spmm_pallas (body
// _spmm_kernel), which turned the scatter-add into a one-hot matmul on
// the MXU and carried each output window across sequential grid steps
// in an aliased zeros buffer.  Hopper runs blocks in no order, so here
// one thread block owns one output window (x one r-chunk of <= 128
// columns), finds the window's run of pack blocks by binary search in
// tile_base, accumulates it in shared memory, and writes the window once
// (rt::spmm_kernel in common.cuh).  No atomics: the sum order is fixed.
//
// Bound on the H100: memory.  Each nonzero gathers one row of B (r
// values) from device memory, 2 flops per value; with rows of 512 B
// (r = 128, float32) and no reuse in L2 for a B of gigabytes, the gathers
// of nnz * r * 4 bytes dominate the compulsory traffic.  The design keeps
// those gathers coalesced (consecutive threads read consecutive columns
// of one row) and keeps eight of them in flight per thread; the
// accumulator never leaves shared memory until the window is done.
#include "common.cuh"

RT_ERROR_STRING_FN

extern "C" int rt_spmm(const void* tile_base, const void* rows_local,
                       const void* cols, const void* vals, const void* B,
                       void* out, long long nb, int k, int row_tile, int m,
                       int r, int vals_bf16, int dense_bf16, void* stream) {
  int err = 0;
  RT_DISPATCH(vals_bf16, dense_bf16,
              err = rt::launch_spmm<TV, TD>(
                  (const int32_t*)tile_base, (const int32_t*)rows_local,
                  (const int32_t*)cols, (const TV*)vals, (const TD*)B,
                  (TD*)out, nb, k, row_tile, m, r, (cudaStream_t)stream));
  return err;
}

// Hopper SDDMM over a RowTiledCOO pack:
//   R[b, e] = vals[b, e] * <A[tile_base[b] + rows_local[b, e]], B[cols[b, e]]>
//
// Replaces the TPU kernel src/repro/kernels/sddmm.py::sddmm_pallas (body
// _sddmm_kernel), which brought a row_tile window of A and an (n_b,
// r_tile) slab of B into VMEM per grid step and accumulated partial dots
// across r-slab sweeps in an aliased zeros buffer.  Here each sampled dot
// is taken over the whole width r in one pass by one warp: lanes stride
// the columns four at a time, a fixed shuffle butterfly adds the
// partials, and nothing carries over between blocks.  The output is
// float32; the wrapper casts it to the dtype of vals.
//
// Bound on the H100: the bytes of the gathers.  Each nonzero reads a row
// of B (r values) from device memory for 2 flops a value; on an
// Erdos-Renyi matrix B's rows find no reuse in L2, so nnz * r * itemsize
// bytes stream from device memory.  A's rows belong to the nonzero's
// window, row_tile x r values that every nonzero of the window reuses.
//
// Two forms (rt::launch_sddmm in bulk.cuh; the wrapper chooses by shape):
//   bulk  persistent blocks walk the windows; a producer warp stages the
//         window's rows of A (once per window, two windows deep) and its
//         index run with cp.async.bulk (1-D TMA), and issues one bulk
//         copy per nonzero's B row into a ring of mbarrier-tracked
//         stages; four consumer warps take the stages in turn, take the
//         dots from shared memory and write each stage's results as one
//         coalesced store.
//   load  the original form, for shapes the bulk copies cannot take:
//         one warp per pack block, eight dots in flight, A and B rows
//         read through the caches (rt::sddmm_kernel in common.cuh).
#include "bulk.cuh"

RT_ERROR_STRING_FN

extern "C" int rt_sddmm(const void* tile_base, const void* off,
                        const void* rows_local, const void* cols,
                        const void* vals, const void* A, const void* B,
                        void* out, long long nb, int k, int row_tile,
                        long long n_windows, int r, int form, int vals_bf16,
                        int dense_bf16, void* stream) {
  int err = 0;
  RT_DISPATCH(vals_bf16, dense_bf16,
              err = rt::launch_sddmm<TV, TD>(
                  form, (const int32_t*)tile_base, (const int64_t*)off,
                  (const int32_t*)rows_local, (const int32_t*)cols,
                  (const TV*)vals, (const TD*)A, (const TD*)B, (float*)out,
                  nb, k, row_tile, n_windows, r, (cudaStream_t)stream));
  return err;
}

// Hopper SDDMM over a RowTiledCOO pack:
//   R[b, e] = vals[b, e] * <A[tile_base[b] + rows_local[b, e]], B[cols[b, e]]>
//
// Replaces the TPU kernel src/repro/kernels/sddmm.py::sddmm_pallas (body
// _sddmm_kernel), which brought a row_tile window of A and an (n_b,
// r_tile) slab of B into VMEM per grid step and accumulated partial dots
// across r-slab sweeps in an aliased zeros buffer.  Here one warp owns
// one pack block and takes each sampled dot over the whole width r in
// one pass (rt::sddmm_kernel in common.cuh): lanes stride the columns,
// a fixed shuffle butterfly adds the partials, and nothing carries over
// between blocks.  The output is float32; the wrapper casts it to the
// dtype of vals.
//
// Bound on the H100: memory.  Each nonzero gathers a row of A (inside
// its window, so mostly from L1/L2) and a row of B (from device memory
// for a B of gigabytes), 2 flops per value pair.  The design keeps four
// nonzeros' gathers in flight per warp, each read coalesced.
#include "common.cuh"

RT_ERROR_STRING_FN

extern "C" int rt_sddmm(const void* tile_base, const void* rows_local,
                        const void* cols, const void* vals, const void* A,
                        const void* B, void* out, long long nb, int k, int r,
                        int vals_bf16, int dense_bf16, void* stream) {
  int err = 0;
  RT_DISPATCH(vals_bf16, dense_bf16,
              err = rt::launch_sddmm<TV, TD>(
                  (const int32_t*)tile_base, (const int32_t*)rows_local,
                  (const int32_t*)cols, (const TV*)vals, (const TD*)A,
                  (const TD*)B, (float*)out, nb, k, r,
                  (cudaStream_t)stream));
  return err;
}

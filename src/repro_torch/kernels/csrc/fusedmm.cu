// Hopper FusedMM over a RowTiledCOO pack (the paper's local kernel fusion):
//   coeff = vals * <A[row], B[col]>;  out[row] += coeff * B[col];  R = coeff
//
// Replaces the TPU kernel src/repro/kernels/fusedmm.py::fusedmm_pallas:
// its single-pass body _fusedmm_kernel (r_tile == r) and its two-phase
// body _fusedmm2_kernel (r_tile < r, R through device memory once).
//
// Single pass (rt::fusedmm_rows_kernel below): one thread block owns one
// output window and one warp owns one of its rows at a time.  The warp
// holds the row's A values and its accumulator in registers, finds the
// row's nonzeros in the window's staged indices with a ballot, gathers
// each nonzero's B row once into registers, takes the sampled dot from
// it and scatters coeff * B_row from the same registers.  So B's rows
// leave device memory once per nonzero, not twice as in sddmm followed
// by spmm, A's rows once per window, and no accumulator lives in shared
// memory; the intermediate R is still written (applications such as GAT
// read it).  Rows of up to 512 values, read four at a time.
//
// Two passes, when the caller asks for r_tile < r, or r is over 512 or
// not a multiple of 4: the sddmm kernel writes float32 R, then the spmm
// kernel scatters with it (bulk.cuh, each in the form the wrapper chose,
// with the wrapper's window offsets).
//
// Both branches take the dot and the scatter in the sddmm and spmm
// kernels' order (lane partials four columns at a time, the shuffle
// butterfly, then fmaf in pack order per output element), so for float32
// values fusedmm equals sddmm then spmm bit for bit.  Bound on the H100:
// memory, the gathers of B's rows (nnz * r values); the single pass
// halves them against the two kernels.
#include "bulk.cuh"

namespace rt {

constexpr int kFusedMaxR = 512;     // widest row of the single pass
constexpr int kFusedChunk = 1024;   // window nonzeros staged at a time

__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void store4(bf16* p, float4 v) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
  __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 raw;
  raw.x = *reinterpret_cast<unsigned*>(&lo);
  raw.y = *reinterpret_cast<unsigned*>(&hi);
  *reinterpret_cast<uint2*>(p) = raw;
}

// Copy up to kFusedChunk nonzeros' indices and values, from entry
// `first` of the pack (`left` remain), into shared memory.
template <typename TV>
__device__ __forceinline__ void stage_chunk(const int32_t* rows_local,
                                            const int32_t* cols,
                                            const TV* vals, int64_t first,
                                            int64_t left, int* s_rl,
                                            int* s_col, float* s_val) {
  for (int e = threadIdx.x; e < kFusedChunk && e < left; e += blockDim.x) {
    s_rl[e] = rows_local[first + e];
    s_col[e] = cols[first + e];
    s_val[e] = f32(vals[first + e]);
  }
}

// J = 128-column slices per row (r <= 128 * J); N nonzeros in flight.
template <typename TV, typename TD, int J>
__global__ void __launch_bounds__(kFusedThreads)
fusedmm_rows_kernel(const int32_t* __restrict__ tile_base,
                    const int32_t* __restrict__ rows_local,
                    const int32_t* __restrict__ cols,
                    const TV* __restrict__ vals, const TD* __restrict__ A,
                    const TD* __restrict__ B, TD* __restrict__ out,
                    float* __restrict__ rvals, int64_t nb, int k,
                    int row_tile, int r) {
  constexpr int N = 8 / J;
  __shared__ int s_rl[kFusedChunk];
  __shared__ int s_col[kFusedChunk];
  __shared__ float s_val[kFusedChunk];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int32_t base = blockIdx.x * row_tile;
  const int64_t lo = lower_bound(tile_base, nb, base);
  const int64_t hi = lower_bound(tile_base, nb, base + row_tile);
  const int64_t e_lo = lo * k, n_e = (hi - lo) * k;
  const bool one_chunk = n_e <= kFusedChunk;

  if (one_chunk) {
    stage_chunk(rows_local, cols, vals, e_lo, n_e, s_rl, s_col, s_val);
    __syncthreads();
  }
  for (int q0 = 0; q0 < row_tile; q0 += nwarps) {
    const int row = q0 + warp;
    const bool live = row < row_tile;
    float4 acc[J], arow[J];
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int c = 4 * lane + 128 * j;
      acc[j] = make_float4(0.f, 0.f, 0.f, 0.f);
      arow[j] = acc[j];
      if (live && n_e > 0 && c < r)
        arow[j] = load4(A + ((int64_t)base + row) * r + c);
    }
    for (int64_t c0 = 0; c0 < n_e; c0 += kFusedChunk) {
      if (!one_chunk) {
        __syncthreads();
        stage_chunk(rows_local, cols, vals, e_lo + c0, n_e - c0, s_rl,
                    s_col, s_val);
        __syncthreads();
      }
      if (!live) continue;
      const int cn =
          n_e - c0 < kFusedChunk ? (int)(n_e - c0) : kFusedChunk;
      for (int s0 = 0; s0 < cn; s0 += 32) {
        const int e = s0 + lane;
        unsigned mask = __ballot_sync(0xffffffffu,
                                      e < cn && s_rl[e] == row);
        while (mask) {                       // this row's nonzeros, in order
          int idx[N];
#pragma unroll
          for (int u = 0; u < N; ++u) {
            idx[u] = mask ? s0 + __ffs(mask) - 1 : -1;
            mask &= mask - 1;
          }
          float4 bv[N][J];
#pragma unroll
          for (int u = 0; u < N; ++u)
#pragma unroll
            for (int j = 0; j < J; ++j) {
              const int c = 4 * lane + 128 * j;
              bv[u][j] = make_float4(0.f, 0.f, 0.f, 0.f);
              if (idx[u] >= 0 && c < r)
                bv[u][j] = load4(B + (int64_t)s_col[idx[u]] * r + c);
            }
#pragma unroll
          for (int u = 0; u < N; ++u) {
            if (idx[u] < 0) break;
            float s = 0.f;
#pragma unroll
            for (int j = 0; j < J; ++j) {
              if (4 * lane + 128 * j >= r) continue;
              s = fmaf(arow[j].x, bv[u][j].x, s);
              s = fmaf(arow[j].y, bv[u][j].y, s);
              s = fmaf(arow[j].z, bv[u][j].z, s);
              s = fmaf(arow[j].w, bv[u][j].w, s);
            }
            const float coeff = s_val[idx[u]] * warp_sum(s);
            if (lane == 0) rvals[e_lo + c0 + idx[u]] = coeff;
#pragma unroll
            for (int j = 0; j < J; ++j) {
              acc[j].x = fmaf(coeff, bv[u][j].x, acc[j].x);
              acc[j].y = fmaf(coeff, bv[u][j].y, acc[j].y);
              acc[j].z = fmaf(coeff, bv[u][j].z, acc[j].z);
              acc[j].w = fmaf(coeff, bv[u][j].w, acc[j].w);
            }
          }
        }
      }
    }
    if (!live) continue;
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int c = 4 * lane + 128 * j;
      if (c < r) store4(out + ((int64_t)base + row) * r + c, acc[j]);
    }
  }
}

template <typename TV, typename TD, int J>
int launch_rows(const int32_t* tb, const int32_t* rl, const int32_t* cl,
                const TV* vals, const TD* A, const TD* B, TD* out,
                float* rvals, int64_t nb, int k, int row_tile, int m, int r,
                cudaStream_t stream) {
  fusedmm_rows_kernel<TV, TD, J>
      <<<m / row_tile, kFusedThreads, 0, stream>>>(
          tb, rl, cl, vals, A, B, out, rvals, nb, k, row_tile, r);
  return (int)cudaGetLastError();
}

template <typename TV, typename TD>
int launch_fusedmm(const int32_t* tb, const int64_t* off, const int32_t* rl,
                   const int32_t* cl, const TV* vals, const TD* A,
                   const TD* B, TD* out, float* rvals, int64_t nb, int k,
                   int row_tile, int m, int r, int want_two_pass,
                   int* used_two_pass, int sddmm_form, int spmm_form,
                   cudaStream_t stream) {
  const bool two = want_two_pass || r > kFusedMaxR ||
                   !vec4_ok(r, A, B, sizeof(TD)) ||
                   (uintptr_t)out % (4 * sizeof(TD)) != 0;
  *used_two_pass = two ? 1 : 0;
  if (two) {
    int err = launch_sddmm<TV, TD>(sddmm_form, tb, off, rl, cl, vals, A, B,
                                   rvals, nb, k, row_tile, m / row_tile, r,
                                   stream);
    if (err) return err;
    return launch_spmm<float, TD>(spmm_form, off, rl, cl, rvals, B, out, nb,
                                  k, row_tile, m, r, stream);
  }
  if (m == 0 || r == 0) return 0;
  const int slices = (r + 127) / 128;
  if (slices == 1)
    return launch_rows<TV, TD, 1>(tb, rl, cl, vals, A, B, out, rvals, nb, k,
                                  row_tile, m, r, stream);
  if (slices == 2)
    return launch_rows<TV, TD, 2>(tb, rl, cl, vals, A, B, out, rvals, nb, k,
                                  row_tile, m, r, stream);
  return launch_rows<TV, TD, 4>(tb, rl, cl, vals, A, B, out, rvals, nb, k,
                                row_tile, m, r, stream);
}

}  // namespace rt

RT_ERROR_STRING_FN

extern "C" int rt_fusedmm(const void* tile_base, const void* off,
                          const void* rows_local, const void* cols,
                          const void* vals, const void* A, const void* B,
                          void* out, void* rvals, long long nb, int k,
                          int row_tile, int m, int r, int want_two_pass,
                          int* used_two_pass, int sddmm_form, int spmm_form,
                          int vals_bf16, int dense_bf16, void* stream) {
  int err = 0;
  RT_DISPATCH(vals_bf16, dense_bf16,
              err = rt::launch_fusedmm<TV, TD>(
                  (const int32_t*)tile_base, (const int64_t*)off,
                  (const int32_t*)rows_local,
                  (const int32_t*)cols, (const TV*)vals, (const TD*)A,
                  (const TD*)B, (TD*)out, (float*)rvals, nb, k, row_tile, m,
                  r, want_two_pass, used_two_pass, sddmm_form, spmm_form,
                  (cudaStream_t)stream));
  return err;
}

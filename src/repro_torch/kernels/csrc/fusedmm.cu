// Hopper FusedMM over a RowTiledCOO pack (the paper's local kernel fusion):
//   coeff = vals * <A[row], B[col]>;  out[row] += coeff * B[col];  R = coeff
//
// Replaces the TPU kernel src/repro/kernels/fusedmm.py::fusedmm_pallas:
// its single-pass body _fusedmm_kernel (r_tile == r) and its two-phase
// body _fusedmm2_kernel (r_tile < r, R through device memory once).
//
// Bound on the H100: memory, the gathers of B's rows (nnz * r values);
// the single pass gathers each nonzero's row once, where sddmm followed
// by spmm gathers it twice.  Three routes, chosen by shape:
//
//   bulk      (rt::fusedmm_bulk_kernel below) persistent blocks walk the
//             windows with a fixed stride.  Warp 0 is bulk.cuh's
//             producer: it stages each window's index run with
//             cp.async.bulk, and one bulk copy per nonzero's B row into a
//             ring of mbarrier-tracked stages.  Each consumer warp owns
//             rows of the window (row i to warp i % kFusedWarps) and
//             takes its entries of every stage as the load form takes a
//             row's: the sampled dot from the staged B row and A's row
//             (read through the cache), then the scatter of coeff * B_row
//             from the same registers.
//             The running row stays in registers, the window's other
//             rows in a float32 accumulator in shared memory; each window
//             is written once, zeros included.  No warp waits for another
//             after set-up.
//   load      (rt::fusedmm_rows_kernel below, the first port's design) one
//             thread block per output window, one warp per row at a time,
//             the row's A values and accumulator in registers; each
//             nonzero's B row is read once into registers for both the
//             dot and the scatter.  Rows of up to 512 values, four at a
//             time.  For shapes the bulk copies cannot take.
//   two-pass  when the caller asks for r_tile < r, or r is over 512 or
//             rows are not read four values at a time: the sddmm kernel
//             writes float32 R, then the spmm kernel scatters with it
//             (bulk.cuh, each in the form the wrapper chose).
//
// All routes take the dot and the scatter in the sddmm and spmm kernels'
// order (lane partials four columns at a time, the shuffle butterfly,
// vals * dot last, then fmaf in pack order per output element), so for
// float32 values fusedmm equals sddmm then spmm bit for bit, and the bulk
// and load forms give the same bits.
#include "bulk.cuh"

namespace rt {

constexpr int kFusedMaxR = 512;     // widest row of the single pass
constexpr int kFusedChunk = 1024;   // window nonzeros staged at a time
constexpr int kTwoPass = 2;         // the route reported besides the forms

// Sizes of the bulk form, chosen by a sweep on the H100 at the main
// path's shapes (PERF.md).  The rate rose with B rows in flight an SM:
// four blocks with 32 KB rings, A's rows read through the cache, matched
// or beat three blocks that stage A's windows (in one or two slots) with
// shallower rings; 16 rows a stage tied, and 2 or 8 consumer warps were
// slower.
constexpr int kFusedGroup = 8;                 // B rows per ring stage
constexpr int kFusedWarps = 4;                 // consumer warps
constexpr int kFusedRingBytes = 32 * 1024;     // ring of B rows per CTA
constexpr int kFusedMinBlocks = 4;             // blocks an SM, for ptxas
constexpr int kFusedBulkThreads = 32 * (1 + kFusedWarps);
constexpr int kMaxFusedAcc = 64 * 1024;  // window accumulator of one CTA
static_assert(kFusedGroup <= 32, "a stage's entries, one a lane");

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

// ---------------------------------------------------------------------------
// Bulk form.  Items: the windows, walked with a fixed stride (empty ones
// are written as zeros without staging anything).  Warp 0 produces.  The
// kFusedWarps consumer warps own the window's rows in turn (row i to
// warp i % kFusedWarps) and take every stage: each finds its entries in
// the stage with a ballot and, for each, the sampled dot (lane l holds
// columns 4l..4l+3, then +128, of the A and B rows) and the scatter of
// coeff * B_row into the row's accumulator in the same registers, as the
// load form does.  The running row stays in registers, the window's
// other rows in a float32 accumulator in shared memory (padding entries
// return to row 0).  No warp waits for another after set-up.
// ---------------------------------------------------------------------------

// bulk.cuh's layout for the fused kernel: no A windows staged
__host__ __device__ inline Layout fused_layout(int vals_size, int row_bytes,
                                               int acc_bytes) {
  return bulk_layout(vals_size, kFusedGroup, row_bytes, 0, acc_bytes, 1,
                     kFusedRingBytes);
}

// J = 128-column slices per row (r <= 128 * J)
template <typename TV, typename TD, int J>
__global__ void __launch_bounds__(kFusedBulkThreads, kFusedMinBlocks)
fusedmm_bulk_kernel(const int64_t* __restrict__ off,
                    const int32_t* __restrict__ rows_local,
                    const int32_t* __restrict__ cols,
                    const TV* __restrict__ vals, const TD* __restrict__ A,
                    const TD* __restrict__ B, TD* __restrict__ out,
                    float* __restrict__ rvals, int n_windows, int k,
                    int row_tile, int r) {
  constexpr int G = kFusedGroup, C = kFusedWarps, NB = 4 / J;
  extern __shared__ __align__(128) unsigned char bulk_smem[];
  unsigned char* smem = bulk_smem;
  const Layout L = fused_layout(sizeof(TV), r * sizeof(TD),
                                row_tile * r * 4);
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  init_bars(bar, L.stages, 1 + C, C, C);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp == 0) {
    produce<TV, TD, false, G>(off, rows_local, cols, vals, nullptr, B,
                              n_windows, 1, r, r, k, row_tile, r, L, smem);
    return;
  }
  const int cw = warp - 1;
  const TD* ring = reinterpret_cast<const TD*>(smem + L.ring_off);
  float* acc = reinterpret_cast<float*>(smem + L.acc_off);
  bool live[J];
#pragma unroll
  for (int j = 0; j < J; ++j) live[j] = 4 * lane + 128 * j < r;
  for (int i = cw; i < row_tile; i += C)
#pragma unroll
    for (int j = 0; j < J; ++j)
      if (live[j])
        store4(acc + i * r + 4 * lane + 128 * j,
               make_float4(0.f, 0.f, 0.f, 0.f));
  int js = 0, rs = 0;
  uint32_t jph = 0, rph = 0;
  for (int w = blockIdx.x; w < n_windows; w += gridDim.x) {
    const int64_t e_lo = off[w] * k, e_hi = off[w + 1] * k;
    int cur = -1;
    float4 a4[J];
#pragma unroll
    for (int j = 0; j < J; ++j) a4[j] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (e_lo < e_hi) {
      const TD* s_a = A + (int64_t)w * row_tile * r;
      for (int64_t e = e_lo; e < e_hi; e += kStageIdx) {
        const int cn = e_hi - e < kStageIdx ? (int)(e_hi - e) : kStageIdx;
        mbar_wait(bar + kIdxFull + js, jph);
        const unsigned char* slot = smem + L.idx_off + js * L.idx_slot;
        const int32_t* s_rl = reinterpret_cast<const int32_t*>(slot);
        const TV* s_val = reinterpret_cast<const TV*>(slot + kStageIdx * 8);
        for (int g0 = 0; g0 < cn; g0 += G) {
          const int g = min(G, cn - g0);
          mbar_wait(bar + kRingFull + rs, rph);
          const TD* b = ring + rs * G * r;
          const int my_row = lane < g ? s_rl[g0 + lane] : 0;
          unsigned mine =
              __ballot_sync(0xffffffffu, lane < g && my_row % C == cw);
          const int n_mine = __popc(mine);
          float my_cf = 0.f;
          for (int v0 = 0; v0 < n_mine; v0 += NB) {
            int idx[NB];
#pragma unroll
            for (int v = 0; v < NB; ++v) {
              idx[v] = mine ? __ffs(mine) - 1 : -1;
              mine &= mine - 1;
            }
            float4 av[NB][J], bv[NB][J];
            int row[NB];
#pragma unroll
            for (int v = 0; v < NB; ++v) {
              const int x = idx[v] < 0 ? idx[0] : idx[v];
              row[v] = __shfl_sync(0xffffffffu, my_row, x);
#pragma unroll
              for (int j = 0; j < J; ++j) {
                const int c = 4 * lane + 128 * j;
                av[v][j] = make_float4(0.f, 0.f, 0.f, 0.f);
                bv[v][j] = av[v][j];
                if (c < r) {
                  av[v][j] = load4(s_a + row[v] * r + c);
                  bv[v][j] = load4(b + x * r + c);
                }
              }
            }
            if (v0 + NB >= n_mine) {   // the stage's last reads are done
              __syncwarp();
              if (lane == 0) mbar_arrive(bar + kRingEmpty + rs);
            }
#pragma unroll
            for (int v = 0; v < NB; ++v) {
              if (idx[v] < 0) break;
              float s = 0.f;
#pragma unroll
              for (int j = 0; j < J; ++j) {
                if (!live[j]) continue;
                s = fmaf(av[v][j].x, bv[v][j].x, s);
                s = fmaf(av[v][j].y, bv[v][j].y, s);
                s = fmaf(av[v][j].z, bv[v][j].z, s);
                s = fmaf(av[v][j].w, bv[v][j].w, s);
              }
              const float cf = f32(s_val[g0 + idx[v]]) * warp_sum(s);
              if (lane == idx[v]) my_cf = cf;
              if (row[v] != cur) {
#pragma unroll
                for (int j = 0; j < J; ++j) {
                  if (!live[j]) continue;
                  const int c = 4 * lane + 128 * j;
                  if (cur >= 0) store4(acc + cur * r + c, a4[j]);
                  a4[j] = load4(acc + row[v] * r + c);
                }
                cur = row[v];
              }
#pragma unroll
              for (int j = 0; j < J; ++j) {
                a4[j].x = fmaf(cf, bv[v][j].x, a4[j].x);
                a4[j].y = fmaf(cf, bv[v][j].y, a4[j].y);
                a4[j].z = fmaf(cf, bv[v][j].z, a4[j].z);
                a4[j].w = fmaf(cf, bv[v][j].w, a4[j].w);
              }
            }
          }
          if (n_mine == 0) {
            __syncwarp();
            if (lane == 0) mbar_arrive(bar + kRingEmpty + rs);
          } else if (lane < g && my_row % C == cw) {
            rvals[e + g0 + lane] = my_cf;
          }
          if (++rs == L.stages) { rs = 0; rph ^= 1u; }
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(bar + kIdxEmpty + js);
        if (++js == 2) { js = 0; jph ^= 1u; }
      }
    }
    TD* o = out + (int64_t)w * row_tile * r;
    for (int i = cw; i < row_tile; i += C)
#pragma unroll
      for (int j = 0; j < J; ++j) {
        if (!live[j]) continue;
        const int c = 4 * lane + 128 * j;
        store4(o + (int64_t)i * r + c,
               i == cur ? a4[j] : load4(acc + i * r + c));
        store4(acc + i * r + c, make_float4(0.f, 0.f, 0.f, 0.f));
      }
  }
}

template <typename TV, typename TD, int J>
int launch_fused_bulk(const int64_t* off, const int32_t* rl,
                      const int32_t* cl, const TV* vals, const TD* A,
                      const TD* B, TD* out, float* rvals, int n_windows,
                      int k, int row_tile, int r, cudaStream_t stream) {
  const Layout L = fused_layout(sizeof(TV), r * sizeof(TD),
                                row_tile * r * 4);
  unsigned grid = 0;
  int err = persistent_grid(fusedmm_bulk_kernel<TV, TD, J>,
                            kFusedBulkThreads, L.bytes, n_windows, &grid);
  if (err) return err;
  fusedmm_bulk_kernel<TV, TD, J>
      <<<grid, kFusedBulkThreads, L.bytes, stream>>>(
          off, rl, cl, vals, A, B, out, rvals, n_windows, k, row_tile, r);
  return (int)cudaGetLastError();
}

// `form`: the wrapper's choice for the single pass (kLoadForm or
// kBulkForm); `used_form` reports the route taken, kTwoPass included.
template <typename TV, typename TD>
int launch_fusedmm(int form, const int32_t* tb, const int64_t* off,
                   const int32_t* rl, const int32_t* cl, const TV* vals,
                   const TD* A, const TD* B, TD* out, float* rvals,
                   int64_t nb, int k, int row_tile, int m, int r,
                   int want_two_pass, int* used_form, int sddmm_form,
                   int spmm_form, cudaStream_t stream) {
  const bool two = want_two_pass || r > kFusedMaxR ||
                   !vec4_ok(r, A, B, sizeof(TD)) ||
                   (uintptr_t)out % (4 * sizeof(TD)) != 0;
  *used_form = two ? kTwoPass : form;
  if (two) {
    int err = launch_sddmm<TV, TD>(sddmm_form, tb, off, rl, cl, vals, A, B,
                                   rvals, nb, k, row_tile, m / row_tile, r,
                                   stream);
    if (err) return err;
    return launch_spmm<float, TD>(spmm_form, off, rl, cl, rvals, B, out, nb,
                                  k, row_tile, m, r, stream);
  }
  const int slices = (r + 127) / 128;
  if (form == kLoadForm) {
    if (m == 0 || r == 0) return 0;
    if (slices == 1)
      return launch_rows<TV, TD, 1>(tb, rl, cl, vals, A, B, out, rvals, nb,
                                    k, row_tile, m, r, stream);
    if (slices == 2)
      return launch_rows<TV, TD, 2>(tb, rl, cl, vals, A, B, out, rvals, nb,
                                    k, row_tile, m, r, stream);
    return launch_rows<TV, TD, 4>(tb, rl, cl, vals, A, B, out, rvals, nb, k,
                                  row_tile, m, r, stream);
  }
  const int64_t n_windows = m / row_tile;
  if (form != kBulkForm ||
      !bulk_ok(rl, cl, vals, sizeof(TV), B, r, sizeof(TD), k) ||
      r * (int)sizeof(TD) > kMaxRowBytes ||
      (int64_t)row_tile * r * 4 > kMaxFusedAcc || n_windows > INT32_MAX)
    return (int)cudaErrorInvalidValue;
  if (n_windows == 0) return 0;
  if (slices == 1)
    return launch_fused_bulk<TV, TD, 1>(off, rl, cl, vals, A, B, out, rvals,
                                        (int)n_windows, k, row_tile, r,
                                        stream);
  if (slices == 2)
    return launch_fused_bulk<TV, TD, 2>(off, rl, cl, vals, A, B, out, rvals,
                                        (int)n_windows, k, row_tile, r,
                                        stream);
  return launch_fused_bulk<TV, TD, 4>(off, rl, cl, vals, A, B, out, rvals,
                                      (int)n_windows, k, row_tile, r,
                                      stream);
}

}  // namespace rt

RT_ERROR_STRING_FN

extern "C" int rt_fusedmm(const void* tile_base, const void* off,
                          const void* rows_local, const void* cols,
                          const void* vals, const void* A, const void* B,
                          void* out, void* rvals, long long nb, int k,
                          int row_tile, int m, int r, int form,
                          int want_two_pass, int* used_form, int sddmm_form,
                          int spmm_form, int vals_bf16, int dense_bf16,
                          void* stream) {
  int err = 0;
  RT_DISPATCH(vals_bf16, dense_bf16,
              err = rt::launch_fusedmm<TV, TD>(
                  form, (const int32_t*)tile_base, (const int64_t*)off,
                  (const int32_t*)rows_local, (const int32_t*)cols,
                  (const TV*)vals, (const TD*)A, (const TD*)B, (TD*)out,
                  (float*)rvals, nb, k, row_tile, m, r, want_two_pass,
                  used_form, sddmm_form, spmm_form, (cudaStream_t)stream));
  return err;
}

// Shared device code of the local SDDMM / SpMM / FusedMM kernels.
//
// All three kernels read one RowTiledCOO pack: int32 rows_local, cols
// (nb, k), vals (nb, k) in float or bf16, and int32 tile_base (nb,),
// non-decreasing multiples of row_tile, so the blocks of one output
// window are one contiguous run.  Dense operands are row-major (rows, r)
// in float or bf16.  Every sum is taken in float32 in a fixed order:
//
//   * a sampled dot <A[row], B[col]> is summed by one warp: each lane adds
//     its columns with fmaf in column order (four at a time when r is a
//     multiple of 4, see warp_dots), then a butterfly of __shfl_xor_sync
//     adds the 32 partials (all lanes end with the same bits:
//     commutativity makes each pair exact);
//   * an output window is owned by one thread block, and each of its
//     threads owns whole columns of the window's float32 accumulator in
//     shared memory, adding the window's nonzeros in pack order.
//
// The SpMM and SDDMM kernels come in two forms with that one arithmetic:
// the load form here (each thread loads what it needs) and the bulk form
// of bulk.cuh (bulk async copies into shared memory), which the wrappers
// choose by shape and alignment.  The SpMM kernels find window w's run
// of blocks as off[w] .. off[w+1], an int64 offsets array the wrapper
// computes per call.  There are no atomics, so two launches give the
// same bits, and the fused kernel's dots and scatter equal the sddmm and
// spmm kernels' in either form.
// Offsets into the dense operands are 64-bit: col * r passes 2^31 at
// m = n = 2^22, r = 128.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace rt {

typedef __nv_bfloat16 bf16;

constexpr int kSddmmWarps = 8;        // warps (pack blocks) per sddmm CTA
constexpr int kFusedThreads = 256;    // threads per fused-kernel CTA
constexpr int kMaxChunk = 128;        // widest r-chunk of one spmm CTA
constexpr int kDefaultSmem = 48 * 1024;
constexpr int kMaxSmem = 227 * 1024;  // opt-in limit of one block on H100

__device__ __forceinline__ float f32(float x) { return x; }
__device__ __forceinline__ float f32(bf16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T cast_to(float x);
template <> __device__ __forceinline__ float cast_to<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ bf16 cast_to<bf16>(float x) {
  return __float2bfloat16(x);
}

// First index i with tb[i] >= key in the non-decreasing tb[0, nb).
__device__ __forceinline__ int64_t lower_bound(const int32_t* tb, int64_t nb,
                                               int32_t key) {
  int64_t lo = 0, hi = nb;
  while (lo < hi) {
    int64_t mid = (lo + hi) >> 1;
    if (tb[mid] < key) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// Butterfly sum of one float per lane; every lane returns the same bits.
__device__ __forceinline__ float warp_sum(float s) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  return s;
}

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const bf16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 hi = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

// Rows can be read four values at a time when r is a multiple of 4 (every
// row then starts 16-byte aligned for float32, 8-byte for bf16, given an
// aligned base).  The wrappers hand both kernels the same flag, so the
// sddmm and fused kernels always sum in the same order.
inline bool vec4_ok(int r, const void* A, const void* B, int itemsize) {
  const uintptr_t al = 4u * itemsize;
  return r % 4 == 0 && (uintptr_t)A % al == 0 && (uintptr_t)B % al == 0;
}

// N sampled dots at once: all 2N row reads of a lane are issued before
// the first multiply.  With vec4 lane l adds columns 4l..4l+3, then
// 4l+128.., else columns l, l+32, ...; the fused kernel takes its dots in
// the same vec4 order.
template <int N, typename TD>
__device__ __forceinline__ void warp_dots(const TD* const* a,
                                          const TD* const* b, int r,
                                          int lane, bool vec4, float* out) {
  float s[N];
#pragma unroll
  for (int u = 0; u < N; ++u) s[u] = 0.f;
  if (vec4) {
    for (int c = 4 * lane; c < r; c += 128) {
      float4 av[N], bv[N];
#pragma unroll
      for (int u = 0; u < N; ++u) {
        av[u] = load4(a[u] + c);
        bv[u] = load4(b[u] + c);
      }
#pragma unroll
      for (int u = 0; u < N; ++u) {
        s[u] = fmaf(av[u].x, bv[u].x, s[u]);
        s[u] = fmaf(av[u].y, bv[u].y, s[u]);
        s[u] = fmaf(av[u].z, bv[u].z, s[u]);
        s[u] = fmaf(av[u].w, bv[u].w, s[u]);
      }
    }
  } else {
    for (int c = lane; c < r; c += 32) {
      float av[N], bv[N];
#pragma unroll
      for (int u = 0; u < N; ++u) {
        av[u] = f32(a[u][c]);
        bv[u] = f32(b[u][c]);
      }
#pragma unroll
      for (int u = 0; u < N; ++u) s[u] = fmaf(av[u], bv[u], s[u]);
    }
  }
#pragma unroll
  for (int u = 0; u < N; ++u) out[u] = warp_sum(s[u]);
}

// ---------------------------------------------------------------------------
// SDDMM, load form: out[b, e] = vals[b, e] *
//     <A[tile_base[b] + rows_local[b, e]], B[cols[b, e]]>, float32 out.
// One warp per pack block, its k entries eight at a time.
// ---------------------------------------------------------------------------
template <typename TV, typename TD>
__global__ void __launch_bounds__(kSddmmWarps * 32)
sddmm_kernel(const int32_t* __restrict__ tile_base,
             const int32_t* __restrict__ rows_local,
             const int32_t* __restrict__ cols, const TV* __restrict__ vals,
             const TD* __restrict__ A, const TD* __restrict__ B,
             float* __restrict__ out, int64_t nb, int k, int r, bool vec4) {
  constexpr int N = 8;
  const int lane = threadIdx.x & 31;
  const int64_t b = (int64_t)blockIdx.x * kSddmmWarps + (threadIdx.x >> 5);
  if (b >= nb) return;
  const int64_t base = tile_base[b];
  const int64_t first = b * k;
  for (int e0 = 0; e0 < k; e0 += N) {
    const TD* pa[N];
    const TD* pb[N];
#pragma unroll
    for (int u = 0; u < N; ++u) {
      const int64_t idx = first + (e0 + u < k ? e0 + u : e0);
      pa[u] = A + (base + rows_local[idx]) * (int64_t)r;
      pb[u] = B + (int64_t)cols[idx] * r;
    }
    float d[N];
    warp_dots<N>(pa, pb, r, lane, vec4, d);
    if (lane == 0) {
#pragma unroll
      for (int u = 0; u < N; ++u)
        if (e0 + u < k) out[first + e0 + u] = f32(vals[first + e0 + u]) * d[u];
    }
  }
}

// ---------------------------------------------------------------------------
// SpMM, load form: out (m, r) = S @ B.  Grid (m / row_tile windows,
// r-chunks); a block of `chunk` threads owns one window x one r-chunk,
// keeps it in a (row_tile x chunk) float32 accumulator in shared memory,
// walks the window's blocks off[w] .. off[w+1] in order and writes the
// window once.  Windows no block touches are written as zeros.
// ---------------------------------------------------------------------------
template <typename TV, typename TD>
__global__ void __launch_bounds__(kMaxChunk)
spmm_kernel(const int64_t* __restrict__ off,
            const int32_t* __restrict__ rows_local,
            const int32_t* __restrict__ cols, const TV* __restrict__ vals,
            const TD* __restrict__ B, TD* __restrict__ out, int64_t nb,
            int k, int row_tile, int r, int chunk) {
  extern __shared__ float smem[];
  float* acc = smem;                                   // row_tile x chunk
  int* s_rl = reinterpret_cast<int*>(acc + row_tile * chunk);
  int* s_col = s_rl + k;
  float* s_val = reinterpret_cast<float*>(s_col + k);
  const int t = threadIdx.x;
  const int col = blockIdx.y * chunk + t;              // owned column
  const bool live = col < r;
  const int32_t base = blockIdx.x * row_tile;
  for (int i = 0; i < row_tile; ++i) acc[i * chunk + t] = 0.f;
  const int64_t lo = off[blockIdx.x], hi = off[blockIdx.x + 1];
  for (int64_t b = lo; b < hi; ++b) {
    __syncthreads();                        // last block's staging is read
    for (int e = t; e < k; e += blockDim.x) {
      s_rl[e] = rows_local[b * k + e];
      s_col[e] = cols[b * k + e];
      s_val[e] = f32(vals[b * k + e]);
    }
    __syncthreads();
    if (!live) continue;
    int e = 0;
    for (; e + 8 <= k; e += 8) {
      float bv[8];
#pragma unroll
      for (int u = 0; u < 8; ++u)
        bv[u] = f32(B[(int64_t)s_col[e + u] * r + col]);
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        float* a = &acc[s_rl[e + u] * chunk + t];
        *a = fmaf(s_val[e + u], bv[u], *a);
      }
    }
    for (; e < k; ++e) {
      float* a = &acc[s_rl[e] * chunk + t];
      *a = fmaf(s_val[e], f32(B[(int64_t)s_col[e] * r + col]), *a);
    }
  }
  if (!live) return;
  for (int i = 0; i < row_tile; ++i)
    out[(int64_t)(base + i) * r + col] = cast_to<TD>(acc[i * chunk + t]);
}

inline int spmm_chunk(int r, int row_tile) {
  int chunk = ((r + 31) / 32) * 32;
  if (chunk > kMaxChunk) chunk = kMaxChunk;
  while (chunk > 32 && (int64_t)row_tile * chunk * 4 > 96 * 1024) chunk /= 2;
  return chunk;
}

inline size_t spmm_smem(int row_tile, int chunk, int k) {
  return (size_t)row_tile * chunk * 4 + (size_t)k * 12;
}

// Launches the load-form spmm kernel on `stream`; returns the launch's
// error code.
template <typename TV, typename TD>
int launch_spmm_load(const int64_t* off, const int32_t* rl,
                     const int32_t* cl, const TV* vals, const TD* B, TD* out,
                     int64_t nb, int k, int row_tile, int m, int r,
                     cudaStream_t stream) {
  const int chunk = spmm_chunk(r, row_tile);
  const size_t smem = spmm_smem(row_tile, chunk, k);
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  if (m == 0 || r == 0) return 0;
  if (smem > (size_t)kDefaultSmem) {
    cudaError_t err = cudaFuncSetAttribute(
        spmm_kernel<TV, TD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 grid(m / row_tile, (r + chunk - 1) / chunk);
  spmm_kernel<TV, TD><<<grid, chunk, smem, stream>>>(
      off, rl, cl, vals, B, out, nb, k, row_tile, r, chunk);
  return (int)cudaGetLastError();
}

template <typename TV, typename TD>
int launch_sddmm_load(const int32_t* tb, const int32_t* rl,
                      const int32_t* cl, const TV* vals, const TD* A,
                      const TD* B, float* out, int64_t nb, int k, int r,
                      cudaStream_t stream) {
  if (nb == 0 || k == 0) return 0;
  const int64_t grid = (nb + kSddmmWarps - 1) / kSddmmWarps;
  const bool vec4 = vec4_ok(r, A, B, sizeof(TD));
  sddmm_kernel<TV, TD><<<(unsigned)grid, kSddmmWarps * 32, 0, stream>>>(
      tb, rl, cl, vals, A, B, out, nb, k, r, vec4);
  return (int)cudaGetLastError();
}

}  // namespace rt

// Dispatch on the two dtype flags (0 = float32, 1 = bf16).
#define RT_DISPATCH(VALS_BF16, DENSE_BF16, ...)                  \
  do {                                                           \
    if (!(VALS_BF16) && !(DENSE_BF16)) {                         \
      typedef float TV; typedef float TD; __VA_ARGS__;           \
    } else if (!(VALS_BF16)) {                                   \
      typedef float TV; typedef rt::bf16 TD; __VA_ARGS__;        \
    } else if (!(DENSE_BF16)) {                                  \
      typedef rt::bf16 TV; typedef float TD; __VA_ARGS__;        \
    } else {                                                     \
      typedef rt::bf16 TV; typedef rt::bf16 TD; __VA_ARGS__;     \
    }                                                            \
  } while (0)

#define RT_ERROR_STRING_FN                                       \
  extern "C" const char* rt_error_string(int code) {             \
    return cudaGetErrorString((cudaError_t)code);                \
  }

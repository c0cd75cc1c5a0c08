// The bulk form of the SpMM and SDDMM kernels, and the launchers that
// choose between it and the load form of common.cuh.  The producer side
// (index chunks and B rows staged with bulk copies) is shared with the
// fused kernel's bulk form in fusedmm.cu.
//
// Both bulk kernels are persistent: about (SMs x blocks per SM) thread
// blocks, block i taking items i, i + gridDim.x, ... in that fixed order
// (an item is one output window, times one column chunk for SpMM), so
// which block owns a window never depends on scheduling.  A window's run
// of pack blocks comes from the offsets array the wrapper computes once
// per call (off[w] .. off[w+1]; no search in tile_base).
//
// Warp 0 is the producer.  Its lane 0 stages each window's run of
// (rows_local, cols, vals) into shared memory with cp.async.bulk (1-D
// TMA), kStageIdx entries at a time into two slots, one chunk ahead; for
// SDDMM it also stages the window's rows of A (row_tile x r), two
// windows deep.  Then its lanes issue one bulk copy per nonzero: the
// nonzero's row of B (one column chunk of it for SpMM) into a ring of
// shared-memory stages (kSpmmGroup or kSddmmGroup rows), each stage's
// arrival counted in bytes on an mbarrier (expect-tx).  The other warps
// consume the stages in pack order and release them on a second
// mbarrier per stage.  No CTA-wide barrier after set-up.
//
// The arithmetic is the load form's, bit for bit:
//   * SpMM: consumer thread t owns column c0 + t of the window and runs
//     one fmaf(val, b, acc) chain per output element in pack order; the
//     running row stays in a register and the window's other rows in a
//     float32 accumulator in shared memory;
//   * SDDMM: consumer warps take the ring's stages in turn; each dot is
//     warp_dots' vec4 partition (lane l: columns 4l..4l+3, then +128,
//     fmaf in x, y, z, w order) and warp_sum's butterfly, from A and B
//     rows in shared memory, and vals * dot is the last multiply; a
//     warp writes its stage's results as one coalesced store.
// Padding slots (val 0, col 0) are processed like any other.
//
// The bulk form needs every copy to be whole 16-byte units at 16-byte
// aligned addresses: r * itemsize % 16 == 0, k a multiple of 16 bytes of
// every index and value array, aligned bases; the wrappers' choose_form
// decides, and the launchers refuse anything else.
#pragma once

#include "common.cuh"

namespace rt {

constexpr int kLoadForm = 0;
constexpr int kBulkForm = 1;

// Sizes chosen on the H100 at the main path's shapes: throughput grew
// with blocks per SM and not with the depth of a block's ring, so the
// rings are small enough for four (SDDMM) or five (SpMM) blocks an SM.
constexpr int kStageIdx = 256;          // pack entries per staged index chunk
constexpr int kRingBytes = 16 * 1024;   // ring of gathered B rows per CTA
constexpr int kMaxStages = 16;
constexpr int kSpmmGroup = 16;          // B rows per ring stage (spmm)
constexpr int kSddmmGroup = 8;          // B rows per ring stage (sddmm)
constexpr int kSddmmConsumers = 4;      // consumer warps of the sddmm kernel
constexpr int kMaxSpmmAcc = 64 * 1024;  // window accumulator of one CTA
constexpr int kMaxAWindow = 64 * 1024;  // one staged window of A
constexpr int kMaxRowBytes = 1024;      // one staged row of B (sddmm)
constexpr int kBarBytes = 512;

// mbarrier slots at the head of shared memory
enum {
  kIdxFull = 0, kIdxEmpty = 2, kAFull = 4, kAEmpty = 6, kRingFull = 8,
  kRingEmpty = 8 + kMaxStages
};

// ---------------------------------------------------------------------------
// mbarrier and bulk-copy primitives (PTX, sm_90)
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("{\n\t.reg .b64 state;\n\t"
               "mbarrier.arrive.shared::cta.b64 state, [%0];\n\t}"
               :: "r"(smem_u32(bar)) : "memory");
}

// Arrive, and expect `bytes` more of asynchronous copies in this phase.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile("{\n\t.reg .b64 state;\n\t"
               "mbarrier.arrive.expect_tx.shared::cta.b64 state, [%0], %1;"
               "\n\t}"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

// Wait until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile("{\n\t.reg .pred p;\n\t"
                 "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
                 "selp.u32 %0, 1, 0, p;\n\t}"
                 : "=r"(done) : "r"(a), "r"(parity) : "memory");
  }
}

// `bytes` (whole 16-byte units, both ends 16-byte aligned) from global to
// shared memory; completion is counted on `bar`.
__device__ __forceinline__ void bulk_g2s(void* dst, const void* src,
                                         uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];"
      :: "r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// ---------------------------------------------------------------------------
// Shared-memory layout, the same on host and device
// ---------------------------------------------------------------------------

__host__ __device__ inline int align128(int x) { return (x + 127) & ~127; }

struct Layout {
  int stages;     // ring stages
  int idx_slot;   // bytes of one index slot: rows_local, cols, vals
  int idx_off, a_slot, a_off, ring_off, acc_off, bytes;
};

// `multiple`: the stage count is a multiple of it (each ring slot of the
// sddmm kernel always goes to the same consumer warp); a ring of at most
// `ring_bytes`.
__host__ __device__ inline Layout bulk_layout(int vals_size, int group,
                                              int row_bytes, int a_bytes,
                                              int acc_bytes, int multiple,
                                              int ring_bytes = kRingBytes) {
  Layout L;
  int st = ring_bytes / (group * row_bytes);
  st = st > kMaxStages ? kMaxStages : st;
  st -= st % multiple;
  L.stages = st < 2 * multiple ? (multiple > 1 ? multiple : 2) : st;
  L.idx_slot = align128(kStageIdx * (8 + vals_size));
  L.idx_off = kBarBytes;
  L.a_slot = align128(a_bytes);
  L.a_off = L.idx_off + 2 * L.idx_slot;
  L.ring_off = L.a_off + 2 * L.a_slot;
  L.acc_off = L.ring_off + align128(L.stages * group * row_bytes);
  L.bytes = L.acc_off + align128(acc_bytes);
  return L;
}

// One CTA's index chunks in walk order: items blockIdx.x + j * gridDim.x
// (window item / nch), each window's entries [off[w] * k, off[w+1] * k)
// cut into chunks of at most kStageIdx; empty windows have none.
struct ChunkSeq {
  const int64_t* off;
  int64_t e, e_hi;
  int n_items, item, nch, k;
  bool fresh;

  __device__ ChunkSeq(const int64_t* off_, int n_items_, int nch_, int k_)
      : off(off_), e(0), e_hi(0), n_items(n_items_),
        item((int)blockIdx.x - (int)gridDim.x), nch(nch_), k(k_),
        fresh(false) {}

  // The next chunk (first entry, length, item, whether it opens its
  // item); false past the end.
  __device__ __forceinline__ bool next(int64_t& ce, int& cn, int& citem,
                                       bool& first) {
    while (e >= e_hi) {
      if (item >= n_items - (int)gridDim.x) { item = n_items; return false; }
      item += gridDim.x;
      const int w = item / nch;
      e = off[w] * k;
      e_hi = off[w + 1] * k;
      fresh = true;
    }
    const int64_t left = e_hi - e;
    ce = e;
    cn = left < kStageIdx ? (int)left : kStageIdx;
    citem = item;
    first = fresh;
    fresh = false;
    e += cn;
    return true;
  }
};

// Stages the producer's index chunks (and, kA, A's windows) one chunk
// ahead of the chunk whose B rows it issues.
template <typename TV, typename TD, bool kA>
struct IndexStager {
  ChunkSeq seq;
  int jp = 0, ap = 0;   // index chunks and A windows staged

  __device__ IndexStager(const int64_t* off, int n_items, int nch, int k)
      : seq(off, n_items, nch, k) {}

  // Lane 0 copies the next chunk into its slot once the slot is free.
  __device__ __forceinline__ void next(
      const int32_t* rows_local, const int32_t* cols, const TV* vals,
      const TD* A, int row_tile, int r, const Layout& L,
      unsigned char* smem, int lane) {
    uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
    int64_t ce;
    int cn, citem;
    bool first;
    if (!seq.next(ce, cn, citem, first)) return;
    const int s = jp & 1;
    if (lane == 0) {
      mbar_wait(bar + kIdxEmpty + s, (uint32_t)((jp >> 1) & 1) ^ 1u);
      unsigned char* slot = smem + L.idx_off + s * L.idx_slot;
      mbar_expect_tx(bar + kIdxFull + s, (uint32_t)cn * (8 + sizeof(TV)));
      bulk_g2s(slot, rows_local + ce, cn * 4, bar + kIdxFull + s);
      bulk_g2s(slot + kStageIdx * 4, cols + ce, cn * 4, bar + kIdxFull + s);
      bulk_g2s(slot + kStageIdx * 8, vals + ce, cn * (int)sizeof(TV),
               bar + kIdxFull + s);
      if (kA && first) {
        const int as = ap & 1;
        const uint32_t a_bytes = (uint32_t)row_tile * r * sizeof(TD);
        mbar_wait(bar + kAEmpty + as, (uint32_t)((ap >> 1) & 1) ^ 1u);
        mbar_expect_tx(bar + kAFull + as, a_bytes);
        bulk_g2s(smem + L.a_off + as * L.a_slot,
                 A + (int64_t)citem * row_tile * r, a_bytes,
                 bar + kAFull + as);
      }
    }
    if (kA && first) ++ap;
    ++jp;
  }
};

// The producer warp.  `chunk` columns per item (r for sddmm, nch = 1),
// ring rows `row_stride` elements apart; kA stages A's windows too.  Lanes
// 0 .. g-1 issue one bulk copy each, a stage's rows at once; the stage's
// full barrier expects lane 0's arrival and the stage's bytes.
template <typename TV, typename TD, bool kA, int group>
__device__ __forceinline__ void produce(
    const int64_t* off, const int32_t* rows_local, const int32_t* cols,
    const TV* vals, const TD* A, const TD* B, int n_items, int nch,
    int chunk, int row_stride, int k, int row_tile, int r, const Layout& L,
    unsigned char* smem) {
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  TD* ring = reinterpret_cast<TD*>(smem + L.ring_off);
  const int lane = threadIdx.x & 31;
  ChunkSeq use(off, n_items, nch, k);
  IndexStager<TV, TD, kA> pre(off, n_items, nch, k);
  pre.next(rows_local, cols, vals, A, row_tile, r, L, smem, lane);
  int js = 0, rs = 0;
  uint32_t jph = 0, rph = 0;
  int64_t ce;
  int cn, citem;
  bool first;
  while (use.next(ce, cn, citem, first)) {
    mbar_wait(bar + kIdxFull + js, jph);
    const int32_t* s_col = reinterpret_cast<const int32_t*>(
        smem + L.idx_off + js * L.idx_slot + kStageIdx * 4);
    const int c0 = (citem % nch) * chunk;
    const int width = min(chunk, r - c0);
    const uint32_t row_bytes = (uint32_t)width * sizeof(TD);
    int ns = 0;
    for (int g0 = 0; g0 < cn; g0 += group) {
      mbar_wait(bar + kRingEmpty + rs, rph ^ 1u);
      const int g = min(group, cn - g0);
      const int my_col = lane < g ? s_col[g0 + lane] : 0;
      if (lane == 0) mbar_expect_tx(bar + kRingFull + rs, g * row_bytes);
      __syncwarp();
      if (lane < g)
        bulk_g2s(ring + ((int64_t)rs * group + lane) * row_stride,
                 B + (int64_t)my_col * r + c0, row_bytes,
                 bar + kRingFull + rs);
      if (++rs == L.stages) { rs = 0; rph ^= 1u; }
      // after one ring's worth of this chunk every earlier chunk is
      // consumed, so its slot takes the next chunk without a long wait
      if (++ns == L.stages)
        pre.next(rows_local, cols, vals, A, row_tile, r, L, smem, lane);
    }
    if (ns < L.stages)
      pre.next(rows_local, cols, vals, A, row_tile, r, L, smem, lane);
    __syncwarp();
    if (lane == 0) mbar_arrive(bar + kIdxEmpty + js);
    if (++js == 2) { js = 0; jph ^= 1u; }
  }
}

__device__ __forceinline__ void init_bars(uint64_t* bar, int stages,
                                          int idx_empty, int a_empty,
                                          int ring_empty) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < 2; ++s) {
      mbar_init(bar + kIdxFull + s, 1);
      mbar_init(bar + kIdxEmpty + s, idx_empty);
      mbar_init(bar + kAFull + s, 1);
      mbar_init(bar + kAEmpty + s, a_empty);
    }
    for (int s = 0; s < stages; ++s) {
      mbar_init(bar + kRingFull + s, 1);
      mbar_init(bar + kRingEmpty + s, ring_empty);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
}

// ---------------------------------------------------------------------------
// SpMM, bulk form.  Items: window x column chunk of `chunk` (<= 128)
// columns; 32 + chunk threads, consumer thread t owns column c0 + t.
// (The minimum of one block per SM keeps ptxas from spilling loop
// counters to reach fewer registers; it takes about 56.)
// ---------------------------------------------------------------------------
template <typename TV, typename TD>
__global__ void __launch_bounds__(32 + kMaxChunk, 1)
spmm_bulk_kernel(const int64_t* __restrict__ off,
                 const int32_t* __restrict__ rows_local,
                 const int32_t* __restrict__ cols,
                 const TV* __restrict__ vals, const TD* __restrict__ B,
                 TD* __restrict__ out, int n_windows, int k, int row_tile,
                 int r, int chunk) {
  extern __shared__ __align__(128) unsigned char bulk_smem[];
  unsigned char* smem = bulk_smem;
  const Layout L = bulk_layout(sizeof(TV), kSpmmGroup, chunk * sizeof(TD),
                               0, row_tile * chunk * 4, 1);
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  const int nch = (r + chunk - 1) / chunk;
  const int n_items = n_windows * nch;
  const int n_cons = chunk / 32;
  init_bars(bar, L.stages, 1 + n_cons, 1, n_cons);
  if (threadIdx.x < 32) {
    produce<TV, TD, false, kSpmmGroup>(off, rows_local, cols, vals, nullptr,
                                       B, n_items, nch, chunk, chunk, k,
                                       row_tile, r, L, smem);
    return;
  }
  const int t = threadIdx.x - 32, lane = threadIdx.x & 31;
  const TD* ring = reinterpret_cast<const TD*>(smem + L.ring_off) + t;
  float* acc = reinterpret_cast<float*>(smem + L.acc_off) + t;
  for (int i = 0; i < row_tile; ++i) acc[i * chunk] = 0.f;
  int js = 0, rs = 0;
  uint32_t jph = 0, rph = 0;
  for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
    const int w = item / nch;
    const int c0 = (item % nch) * chunk;
    const int64_t e_hi = off[w + 1] * k;
    int cur = -1;
    float a = 0.f;
    for (int64_t e = off[w] * k; e < e_hi; e += kStageIdx) {
      const int cn = e_hi - e < kStageIdx ? (int)(e_hi - e) : kStageIdx;
      mbar_wait(bar + kIdxFull + js, jph);
      const unsigned char* slot = smem + L.idx_off + js * L.idx_slot;
      const int32_t* s_rl = reinterpret_cast<const int32_t*>(slot);
      const TV* s_val = reinterpret_cast<const TV*>(slot + kStageIdx * 8);
      for (int g0 = 0; g0 < cn; g0 += kSpmmGroup) {
        const int g = min(kSpmmGroup, cn - g0);
        // the stage's values in this thread's column, and the entries'
        // rows and values one per lane, all loaded before the first fmaf
        mbar_wait(bar + kRingFull + rs, rph);
        const TD* b = ring + rs * kSpmmGroup * chunk;
        float bv[kSpmmGroup];
#pragma unroll
        for (int i = 0; i < kSpmmGroup; ++i) bv[i] = f32(b[i * chunk]);
        const int my_row = lane < g ? s_rl[g0 + lane] : 0;
        const float my_val = lane < g ? f32(s_val[g0 + lane]) : 0.f;
        __syncwarp();
        if (lane == 0) mbar_arrive(bar + kRingEmpty + rs);
        if (++rs == L.stages) { rs = 0; rph ^= 1u; }
#pragma unroll
        for (int i = 0; i < kSpmmGroup; ++i) {
          if (i < g) {
            const int row = __shfl_sync(0xffffffffu, my_row, i);
            const float v = __shfl_sync(0xffffffffu, my_val, i);
            if (row != cur) {
              if (cur >= 0) acc[cur * chunk] = a;
              a = acc[row * chunk];
              cur = row;
            }
            a = fmaf(v, bv[i], a);
          }
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(bar + kIdxEmpty + js);
      if (++js == 2) { js = 0; jph ^= 1u; }
    }
    // columns past r (a narrow last chunk) are summed but not written
    const bool live = t < r - c0;
    TD* o = out + (int64_t)w * row_tile * r + c0 + t;
    for (int i = 0; i < row_tile; ++i) {
      const float v = i == cur ? a : acc[i * chunk];
      if (live) o[(int64_t)i * r] = cast_to<TD>(v);
      acc[i * chunk] = 0.f;
    }
  }
}

// ---------------------------------------------------------------------------
// SDDMM, bulk form.  Items: the non-empty windows.  Consumer warp c takes
// ring stages c, c + 4, ...; the stage count is a multiple of 4, so each
// ring slot always goes to the same warp.
// ---------------------------------------------------------------------------
constexpr int kSddmmThreads = 32 * (1 + kSddmmConsumers);

template <typename TV, typename TD>
__device__ __forceinline__ void sddmm_bulk(
    const int64_t* __restrict__ off, const int32_t* __restrict__ rows_local,
    const int32_t* __restrict__ cols, const TV* __restrict__ vals,
    const TD* __restrict__ A, const TD* __restrict__ B,
    float* __restrict__ out, int n_windows, int k, int row_tile, int r,
    unsigned char* smem) {
  const Layout L = bulk_layout(sizeof(TV), kSddmmGroup, r * sizeof(TD),
                               row_tile * r * sizeof(TD), 0,
                               kSddmmConsumers);
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  init_bars(bar, L.stages, 1 + kSddmmConsumers, kSddmmConsumers, 1);
  if (threadIdx.x < 32) {
    produce<TV, TD, true, kSddmmGroup>(off, rows_local, cols, vals, A, B,
                                       n_windows, 1, r, r, k, row_tile, r,
                                       L, smem);
    return;
  }
  const int lane = threadIdx.x & 31;
  const int cw = (threadIdx.x >> 5) - 1;
  const TD* ring = reinterpret_cast<const TD*>(smem + L.ring_off);
  int js = 0, rs = 0, as = 0;
  uint32_t jph = 0, rph = 0, aph = 0;
  for (int w = blockIdx.x; w < n_windows; w += gridDim.x) {
    const int64_t e_hi = off[w + 1] * k;
    int64_t e = off[w] * k;
    if (e >= e_hi) continue;
    mbar_wait(bar + kAFull + as, aph);
    const TD* s_a =
        reinterpret_cast<const TD*>(smem + L.a_off + as * L.a_slot);
    for (; e < e_hi; e += kStageIdx) {
      const int cn = e_hi - e < kStageIdx ? (int)(e_hi - e) : kStageIdx;
      mbar_wait(bar + kIdxFull + js, jph);
      const unsigned char* slot = smem + L.idx_off + js * L.idx_slot;
      const int32_t* s_rl = reinterpret_cast<const int32_t*>(slot);
      const TV* s_val = reinterpret_cast<const TV*>(slot + kStageIdx * 8);
      for (int g0 = 0; g0 < cn; g0 += kSddmmGroup) {
        if (rs % kSddmmConsumers == cw) {
          mbar_wait(bar + kRingFull + rs, rph);
          const int g = min(kSddmmGroup, cn - g0);
          const TD* b = ring + rs * kSddmmGroup * r;
          // warp_dots' vec4 order, with the stage's A rows as 32-bit
          // offsets into shared memory (entries past g repeat entry 0)
          float sum[kSddmmGroup];
          int arow[kSddmmGroup];
#pragma unroll
          for (int u = 0; u < kSddmmGroup; ++u) {
            sum[u] = 0.f;
            arow[u] = s_rl[g0 + (u < g ? u : 0)] * r;
          }
          for (int c = 4 * lane; c < r; c += 128) {
            float4 av[kSddmmGroup], bv[kSddmmGroup];
#pragma unroll
            for (int u = 0; u < kSddmmGroup; ++u) {
              av[u] = load4(s_a + arow[u] + c);
              bv[u] = load4(b + u * r + c);
            }
#pragma unroll
            for (int u = 0; u < kSddmmGroup; ++u) {
              sum[u] = fmaf(av[u].x, bv[u].x, sum[u]);
              sum[u] = fmaf(av[u].y, bv[u].y, sum[u]);
              sum[u] = fmaf(av[u].z, bv[u].z, sum[u]);
              sum[u] = fmaf(av[u].w, bv[u].w, sum[u]);
            }
          }
          float res = 0.f;
#pragma unroll
          for (int u = 0; u < kSddmmGroup; ++u) {
            const float d = warp_sum(sum[u]);
            if (lane == u) res = d;
          }
          __syncwarp();
          if (lane == 0) mbar_arrive(bar + kRingEmpty + rs);
          if (lane < g) out[e + g0 + lane] = f32(s_val[g0 + lane]) * res;
        }
        if (++rs == L.stages) { rs = 0; rph ^= 1u; }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(bar + kIdxEmpty + js);
      if (++js == 2) { js = 0; jph ^= 1u; }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(bar + kAEmpty + as);
    if (++as == 2) { as = 0; aph ^= 1u; }
  }
}

// Two entry points over one body: left to itself ptxas spills the bf16
// instantiations to reach fewer registers, and told that one block an SM
// is enough it gives the float ones twice the registers (and half the
// blocks), so the launcher takes the first for float and the second for
// bf16 operands.
template <typename TV, typename TD>
__global__ void __launch_bounds__(kSddmmThreads)
sddmm_bulk_kernel(const int64_t* off, const int32_t* rows_local,
                  const int32_t* cols, const TV* vals, const TD* A,
                  const TD* B, float* out, int n_windows, int k,
                  int row_tile, int r) {
  extern __shared__ __align__(128) unsigned char bulk_smem[];
  sddmm_bulk<TV, TD>(off, rows_local, cols, vals, A, B, out, n_windows, k,
                     row_tile, r, bulk_smem);
}

template <typename TV, typename TD>
__global__ void __launch_bounds__(kSddmmThreads, 1)
sddmm_bulk_kernel_1(const int64_t* off, const int32_t* rows_local,
                    const int32_t* cols, const TV* vals, const TD* A,
                    const TD* B, float* out, int n_windows, int k,
                    int row_tile, int r) {
  extern __shared__ __align__(128) unsigned char bulk_smem[];
  sddmm_bulk<TV, TD>(off, rows_local, cols, vals, A, B, out, n_windows, k,
                     row_tile, r, bulk_smem);
}

// ---------------------------------------------------------------------------
// Launchers
// ---------------------------------------------------------------------------

inline bool aligned16(const void* p) { return (uintptr_t)p % 16 == 0; }

// Bulk-form preconditions shared by both kernels.
inline bool bulk_ok(const void* rl, const void* cl, const void* vals,
                    int vals_size, const void* B, int r, int dense_size,
                    int k) {
  return r > 0 && (r * dense_size) % 16 == 0 && (k * 4) % 16 == 0 &&
         (k * vals_size) % 16 == 0 && aligned16(rl) && aligned16(cl) &&
         aligned16(vals) && aligned16(B);
}

// Grid of a persistent kernel: blocks per SM at this shared memory, times
// the SMs, at most one per item.
template <typename K>
int persistent_grid(K kernel, int threads, size_t smem, int64_t n_items,
                    unsigned* grid) {
  cudaError_t err;
  if (smem > (size_t)kDefaultSmem) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      threads, smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const int64_t g = (int64_t)per_sm * sms;
  *grid = (unsigned)(g < n_items ? g : n_items);
  return 0;
}

// Column chunk of one bulk spmm item: up to 128 columns, narrower while
// the window's accumulator would pass kMaxSpmmAcc.
inline int spmm_bulk_chunk(int r, int row_tile) {
  int chunk = ((r + 31) / 32) * 32;
  if (chunk > kMaxChunk) chunk = kMaxChunk;
  while (chunk > 32 && (int64_t)row_tile * chunk * 4 > kMaxSpmmAcc)
    chunk /= 2;
  return chunk;
}

template <typename TV, typename TD>
int launch_spmm(int form, const int64_t* off, const int32_t* rl,
                const int32_t* cl, const TV* vals, const TD* B, TD* out,
                int64_t nb, int k, int row_tile, int m, int r,
                cudaStream_t stream) {
  if (m == 0 || r == 0) return 0;
  if (form == kLoadForm)
    return launch_spmm_load<TV, TD>(off, rl, cl, vals, B, out, nb, k,
                                    row_tile, m, r, stream);
  const int chunk = spmm_bulk_chunk(r, row_tile);
  const int64_t n_items = (int64_t)(m / row_tile) * ((r + chunk - 1) / chunk);
  if (form != kBulkForm ||
      !bulk_ok(rl, cl, vals, sizeof(TV), B, r, sizeof(TD), k) ||
      (int64_t)row_tile * chunk * 4 > kMaxSpmmAcc || n_items > INT32_MAX)
    return (int)cudaErrorInvalidValue;
  const Layout L = bulk_layout(sizeof(TV), kSpmmGroup, chunk * sizeof(TD),
                               0, row_tile * chunk * 4, 1);
  const int threads = 32 + chunk;
  unsigned grid = 0;
  int err = persistent_grid(spmm_bulk_kernel<TV, TD>, threads, L.bytes,
                            n_items, &grid);
  if (err) return err;
  spmm_bulk_kernel<TV, TD><<<grid, threads, L.bytes, stream>>>(
      off, rl, cl, vals, B, out, m / row_tile, k, row_tile, r, chunk);
  return (int)cudaGetLastError();
}

template <typename TV, typename TD>
int launch_sddmm(int form, const int32_t* tb, const int64_t* off,
                 const int32_t* rl, const int32_t* cl, const TV* vals,
                 const TD* A, const TD* B, float* out, int64_t nb, int k,
                 int row_tile, int64_t n_windows, int r,
                 cudaStream_t stream) {
  if (nb == 0 || k == 0) return 0;
  if (form == kLoadForm)
    return launch_sddmm_load<TV, TD>(tb, rl, cl, vals, A, B, out, nb, k, r,
                                     stream);
  const int64_t a_bytes = (int64_t)row_tile * r * sizeof(TD);
  if (form != kBulkForm ||
      !bulk_ok(rl, cl, vals, sizeof(TV), B, r, sizeof(TD), k) ||
      !aligned16(A) || r * (int)sizeof(TD) > kMaxRowBytes ||
      a_bytes > kMaxAWindow || n_windows > INT32_MAX)
    return (int)cudaErrorInvalidValue;
  if (n_windows == 0) return 0;
  const Layout L = bulk_layout(sizeof(TV), kSddmmGroup, r * sizeof(TD),
                               (int)a_bytes, 0, kSddmmConsumers);
  void (*kernel)(const int64_t*, const int32_t*, const int32_t*, const TV*,
                 const TD*, const TD*, float*, int, int, int, int);
  if constexpr (sizeof(TD) == 4)
    kernel = sddmm_bulk_kernel<TV, TD>;
  else
    kernel = sddmm_bulk_kernel_1<TV, TD>;
  unsigned grid = 0;
  int err = persistent_grid(kernel, kSddmmThreads, L.bytes, n_windows,
                            &grid);
  if (err) return err;
  kernel<<<grid, kSddmmThreads, L.bytes, stream>>>(
      off, rl, cl, vals, A, B, out, (int)n_windows, k, row_tile, r);
  return (int)cudaGetLastError();
}

}  // namespace rt

// Segmented sum of float32 or float64 slot rows by group rank, for Hopper (sm_90a).
//
// Replaces the TPU kernel seg_sum_f32_pallas (spark_rapids_tpu/ops/pallas_kernels.py:126,
// pallas_call at :150), which ran the sum as a one-hot matmul on the MXU and carried the
// table across a sequential grid (out_ref +=).  The float64 build, seg_sum_f64, replaces
// no Pallas kernel: it takes the double SUM slots that the JAX package leaves to an XLA
// scatter (spark_rapids_tpu/ops/segmented.py seg_sum2), since the MXU kernel is f32-only.
// Both builds compute the same function, not the same blocks:
//
//   out[j, g] = sum of values[j, i] over rows i with rank[i] == g,  0 <= g < out_size
//
// values is [s, n] contiguous, rank int32[n], 1 <= out_size <= 256.  Ranks outside
// [0, out_size) add nothing (the dead-row convention of groupby_reduce).
//
// Bound: device-memory bytes.  The function reads 4*n bytes of ranks and
// sizeof(T)*s*n_live bytes of values (a dead row's values need not be read) and writes
// sizeof(T)*s*out_size.  It does about one add per value read, far below the card's
// ridge point, so tensor cores buy nothing; a one-hot mma would also be exact only for
// 0/1 values.
//
// Design, and what it does about the bound and about determinism:
//   * Small tables (out_size <= kSmallGroups = 8; q1 has 6 groups).  Each thread keeps
//     acc[slot][g] in registers for a chunk of slots, and adds each row's value into its
//     group by an unrolled compare-and-select over the 8 groups: no register is indexed
//     by a runtime rank, so nothing goes to local memory, and the row loop has no match,
//     no shuffle and no shared memory.  The chunk is 8 float slots or 4 double slots:
//     64 registers of accumulators either way, plus 32 (64) for a quad's values.
//     ptxas for sm_90a gives 124 (float) and 121 (double) registers on the 16-byte
//     path, two blocks of 256 threads per SM, and 194 and 158 on the row-by-row path;
//     0 stack and 0 spill bytes in every instantiation (chip_smoke.py prints the
//     report and fails on a spill).  16 groups would double the accumulators and leave
//     no room for the loads; 8 covers q1's 6.
//   * Wide loads.  A thread takes 4 consecutive rows: one 16-byte load of ranks and one
//     16-byte load per slot (two for doubles), so each thread has a chunk's worth (4 to
//     8) of independent 16-byte loads in flight, and it loads the next quad's ranks
//     before it sums this one.  That needs n % 4 == 0 and 16-byte aligned pointers;
//     otherwise the same kernel loads row by row.  A quad whose 4 ranks are all dead
//     loads no values; after FilterExec compacts, the dead rows sit together at the end
//     and whole warps skip.
//   * Grid.  As many blocks as fit on the card at once (occupancy x SM count), split
//     among the slot chunks.  Block b takes chunk b % chunks and row block b / chunks,
//     so the chunks of one row range run side by side and their second reads of the
//     ranks hit L2; values are loaded evict-first, so they do not push the ranks out.
//     Each row block strides over 1,024-row tiles, which spreads the dead tail evenly.
//   * At the end of its rows a block reduces its threads' accumulators by a fixed tree
//     (5 xor-shuffle rounds, then its 8 warps in order through shared memory) to one
//     partial per cell, and a second kernel adds the row blocks' partials (a few
//     hundred, not thousands) in a fixed order.  No atomics anywhere: every addition
//     happens in an order fixed by n, s, out_size and the card (its SM count and this
//     build's occupancy), so a rerun gives the same bits.  Accumulation in the value
//     type, no TF32: sums of 0/1 flags below 2^24 (float) and of integer-valued doubles
//     below 2^53 are exact.
//   * Larger tables (8 < out_size <= 256), which no main path reaches today: per-warp
//     tables in shared memory.  Lanes holding the same rank find each other with
//     __match_any_sync, sum their peers' values in ascending lane order by shuffles,
//     and the lowest lane adds that sum into its warp's table; the warps' tables are
//     added in warp order into the block's partial.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxGroups = 256;

// ---- small tables -------------------------------------------------------------------

constexpr int kSmallGroups = 8;
constexpr int kTileRows = kThreads * 4;  // a quad of rows per thread

template <typename T> struct SmallSlots;
template <> struct SmallSlots<float> { static constexpr int value = 8; };
template <> struct SmallSlots<double> { static constexpr int value = 4; };

__device__ __forceinline__ int live_or_dead(int r, int out_size) {
  return (r >= 0 && r < out_size) ? r : -1;
}

// The ranks of rows 4q..4q+3, each live rank kept and every other one -1.
template <bool kVec>
__device__ __forceinline__ int4 load_ranks(const int* __restrict__ rank, long long q,
                                           long long n, int out_size) {
  int4 r;
  if constexpr (kVec) {
    r = __ldg(reinterpret_cast<const int4*>(rank) + q);
  } else {
    const long long i = 4 * q;
    r.x = i < n ? __ldg(rank + i) : -1;
    r.y = i + 1 < n ? __ldg(rank + i + 1) : -1;
    r.z = i + 2 < n ? __ldg(rank + i + 2) : -1;
    r.w = i + 3 < n ? __ldg(rank + i + 3) : -1;
  }
  r.x = live_or_dead(r.x, out_size);
  r.y = live_or_dead(r.y, out_size);
  r.z = live_or_dead(r.z, out_size);
  r.w = live_or_dead(r.w, out_size);
  return r;
}

// The values of rows 4q..4q+3 of one slot row, loaded evict-first (read once).
template <bool kVec>
__device__ __forceinline__ void load_quad(const float* __restrict__ p, long long q,
                                          long long n, float v[4]) {
  if constexpr (kVec) {
    const float4 t = __ldcs(reinterpret_cast<const float4*>(p) + q);
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
  } else {
    const long long i = 4 * q;
#pragma unroll
    for (int k = 0; k < 4; ++k) v[k] = i + k < n ? __ldcs(p + i + k) : 0.f;
  }
}

template <bool kVec>
__device__ __forceinline__ void load_quad(const double* __restrict__ p, long long q,
                                          long long n, double v[4]) {
  if constexpr (kVec) {
    const double2 a = __ldcs(reinterpret_cast<const double2*>(p) + 2 * q);
    const double2 b = __ldcs(reinterpret_cast<const double2*>(p) + 2 * q + 1);
    v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
  } else {
    const long long i = 4 * q;
#pragma unroll
    for (int k = 0; k < 4; ++k) v[k] = i + k < n ? __ldcs(p + i + k) : 0.0;
  }
}

template <typename T, int kSlots, bool kVec>
__global__ void __launch_bounds__(kThreads)
seg_sum_small(const T* __restrict__ values, const int* __restrict__ rank,
              T* __restrict__ partial, int s, long long n, int out_size, int chunks) {
  __shared__ T warp_sums[kWarps][kSlots * kSmallGroups];
  const int chunk = blockIdx.x % chunks;
  const int row_block = blockIdx.x / chunks;
  const int row_blocks = gridDim.x / chunks;
  const int s0 = chunk * kSlots;
  const int sc = min(kSlots, s - s0);

  T acc[kSlots][kSmallGroups];
#pragma unroll
  for (int j = 0; j < kSlots; ++j)
#pragma unroll
    for (int g = 0; g < kSmallGroups; ++g) acc[j][g] = T(0);

  // The group ids compared against, opaque to the compiler: compared with the
  // constants 0..7 it folds the compare chain into a switch and the adds into one
  // add at a runtime index, which puts acc in local memory.
  int group[kSmallGroups];
#pragma unroll
  for (int g = 0; g < kSmallGroups; ++g) asm volatile("mov.b32 %0, %1;" : "=r"(group[g]) : "r"(g));

  const int4 dead = make_int4(-1, -1, -1, -1);
  const long long quads = (n + 3) / 4;
  const long long stride = static_cast<long long>(row_blocks) * kThreads;
  long long q = static_cast<long long>(row_block) * kThreads + threadIdx.x;
  int4 r = q < quads ? load_ranks<kVec>(rank, q, n, out_size) : dead;
  for (; q < quads; q += stride) {
    const long long next = q + stride;
    const int4 r_next = next < quads ? load_ranks<kVec>(rank, next, n, out_size) : dead;
    if (max(max(r.x, r.y), max(r.z, r.w)) >= 0) {  // a live row in the quad
      T v[kSlots][4];
#pragma unroll
      for (int j = 0; j < kSlots; ++j) {
        if (j < sc) {
          load_quad<kVec>(values + static_cast<long long>(s0 + j) * n, q, n, v[j]);
        } else {
#pragma unroll
          for (int k = 0; k < 4; ++k) v[j][k] = T(0);
        }
      }
      const int rr[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
      for (int k = 0; k < 4; ++k)
#pragma unroll
        for (int g = 0; g < kSmallGroups; ++g) {
          const bool hit = rr[k] == group[g];
#pragma unroll
          for (int j = 0; j < kSlots; ++j)
            if (hit) acc[j][g] += v[j][k];
        }
    }
    r = r_next;
  }

  // one fixed tree over the block: lanes by xor shuffles, then warps in order
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
#pragma unroll
  for (int j = 0; j < kSlots; ++j)
#pragma unroll
    for (int g = 0; g < kSmallGroups; ++g) {
      T x = acc[j][g];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(kFull, x, off);
      if (lane == 0) warp_sums[warp][j * kSmallGroups + g] = x;
    }
  __syncthreads();
  for (int c = threadIdx.x; c < sc * out_size; c += kThreads) {
    const int j = c / out_size;
    const int g = c % out_size;
    T sum = T(0);
#pragma unroll
    for (int w = 0; w < kWarps; ++w) sum += warp_sums[w][j * kSmallGroups + g];
    partial[(static_cast<long long>(row_block) * s + s0 + j) * out_size + g] = sum;
  }
}

// ---- larger tables ------------------------------------------------------------------

constexpr long long kRowsPerBlock = kThreads * 32LL;  // 32 rows per thread
constexpr int kSlotTile = 4;
constexpr int kSmemBytes = 48 * 1024;  // no opt-in needed below 48 KB

template <typename T>
__global__ void __launch_bounds__(kThreads)
seg_sum_large(const T* __restrict__ values, const int* __restrict__ rank,
              T* __restrict__ partial, int s, long long n, int out_size, int chunk) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* table = reinterpret_cast<T*>(smem);  // [kWarps][sc][out_size]
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int s0 = blockIdx.y * chunk;
  const int sc = min(chunk, s - s0);
  const int cells = sc * out_size;
  for (int i = threadIdx.x; i < kWarps * cells; i += kThreads) table[i] = T(0);
  __syncthreads();

  T* mine = table + warp * cells;
  const long long begin = static_cast<long long>(blockIdx.x) * kRowsPerBlock;
  const long long end = min(begin + kRowsPerBlock, n);
  // every warp runs the same number of iterations, so full-mask warp ops are safe
  for (long long base = begin; base < end; base += kThreads) {
    const long long row = base + threadIdx.x;
    const bool in_range = row < end;
    int r = in_range ? rank[row] : out_size;
    const bool live = r >= 0 && r < out_size;
    if (!live) r = out_size;  // dead rows: not read, not summed
    const unsigned peers = __match_any_sync(kFull, r);
    const bool leader = live && (__ffs(peers) - 1) == lane;
    const unsigned rounds =
        __reduce_max_sync(kFull, live ? static_cast<unsigned>(__popc(peers)) : 0u);
    if (rounds == 0) continue;  // the whole warp is dead (uniform across the warp)
    for (int j0 = 0; j0 < sc; j0 += kSlotTile) {
      T v[kSlotTile];
      T acc[kSlotTile];
#pragma unroll
      for (int t = 0; t < kSlotTile; ++t) {
        const int j = j0 + t;
        v[t] = (live && j < sc) ? values[static_cast<long long>(s0 + j) * n + row] : T(0);
        acc[t] = T(0);
      }
      unsigned m = live ? peers : 0u;
      for (unsigned k = 0; k < rounds; ++k) {
        const int src = m ? __ffs(m) - 1 : lane;
#pragma unroll
        for (int t = 0; t < kSlotTile; ++t) {
          const T x = __shfl_sync(kFull, v[t], src);
          if (m) acc[t] += x;
        }
        m &= m - 1;
      }
      if (leader) {
#pragma unroll
        for (int t = 0; t < kSlotTile; ++t)
          if (j0 + t < sc) mine[(j0 + t) * out_size + r] += acc[t];
      }
    }
  }
  __syncthreads();

  for (int c = threadIdx.x; c < cells; c += kThreads) {
    T sum = T(0);
    for (int w = 0; w < kWarps; ++w) sum += table[w * cells + c];
    partial[(static_cast<long long>(blockIdx.x) * s + s0) * out_size + c] = sum;
  }
}

// ---- the partials ---------------------------------------------------------------------

// One warp per output cell: lane l adds blocks l, l+32, ... in order, then a fixed
// shuffle tree adds the 32 lane sums.
template <typename T>
__global__ void __launch_bounds__(kThreads)
seg_sum_combine(const T* __restrict__ partial, T* __restrict__ out, int blocks, int cells) {
  const int cell = blockIdx.x * kWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (cell >= cells) return;  // uniform across the warp
  T sum = T(0);
  for (int b = lane; b < blocks; b += 32) sum += partial[static_cast<long long>(b) * cells + cell];
  for (int off = 16; off > 0; off >>= 1) sum += __shfl_down_sync(kFull, sum, off);
  if (lane == 0) out[cell] = sum;
}

// ---- host side ----------------------------------------------------------------------

// Blocks of the small-table kernel that fit on the current card at once, per device.
template <typename T>
int resident_blocks() {
  static int cached[64] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0) dev = 0;
  if (dev < 64 && cached[dev] > 0) return cached[dev];
  int sms = 0, per_sm = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, seg_sum_small<T, SmallSlots<T>::value, true>, kThreads, 0);
  const int blocks = (sms > 0 ? sms : 1) * (per_sm > 0 ? per_sm : 1);
  if (dev < 64) cached[dev] = blocks;
  return blocks;
}

struct Plan {
  bool small;
  int blocks;  // row blocks, each writing one partial table
  int chunk;   // slots per chunk
  int chunks;
};

template <typename T>
Plan plan_for(long long n, int s, int out_size) {
  Plan p;
  p.small = out_size <= kSmallGroups;
  if (p.small) {
    p.chunk = SmallSlots<T>::value;
    p.chunks = (s + p.chunk - 1) / p.chunk;
    const long long tiles = (n + kTileRows - 1) / kTileRows;
    long long blocks = resident_blocks<T>() / p.chunks;
    if (blocks > tiles) blocks = tiles;
    p.blocks = blocks < 1 ? 1 : static_cast<int>(blocks);
  } else {
    const long long blocks = (n + kRowsPerBlock - 1) / kRowsPerBlock;
    p.blocks = blocks < 1 ? 1 : static_cast<int>(blocks);
    int sc = kSmemBytes / (kWarps * out_size * static_cast<int>(sizeof(T)));
    if (sc < 1) sc = 1;
    p.chunk = sc < s ? sc : s;
    p.chunks = (s + p.chunk - 1) / p.chunk;
  }
  return p;
}

bool valid(int s, long long n, int out_size) {
  return s >= 1 && n >= 0 && out_size >= 1 && out_size <= kMaxGroups;
}

template <typename T>
long long scratch_elems(long long n, int s, int out_size) {
  if (!valid(s, n, out_size)) return 0;
  return static_cast<long long>(plan_for<T>(n, s, out_size).blocks) * s * out_size;
}

template <typename T>
int launch(const T* values, const int* rank, T* scratch, T* out, int s, long long n,
           int out_size, void* stream) {
  if (!valid(s, n, out_size)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Plan p = plan_for<T>(n, s, out_size);
  if (p.small) {
    constexpr int kSlots = SmallSlots<T>::value;
    const bool vec = n % 4 == 0 && reinterpret_cast<uintptr_t>(values) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(rank) % 16 == 0;
    const int grid = p.blocks * p.chunks;
    if (vec)
      seg_sum_small<T, kSlots, true><<<grid, kThreads, 0, st>>>(values, rank, scratch, s, n,
                                                                out_size, p.chunks);
    else
      seg_sum_small<T, kSlots, false><<<grid, kThreads, 0, st>>>(values, rank, scratch, s, n,
                                                                 out_size, p.chunks);
  } else {
    const dim3 grid(p.blocks, p.chunks);
    const size_t smem = static_cast<size_t>(kWarps) * p.chunk * out_size * sizeof(T);
    seg_sum_large<T><<<grid, kThreads, smem, st>>>(values, rank, scratch, s, n, out_size,
                                                   p.chunk);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int cells = s * out_size;
  seg_sum_combine<T><<<(cells + kWarps - 1) / kWarps, kThreads, 0, st>>>(scratch, out,
                                                                         p.blocks, cells);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Elements of scratch (floats / doubles) that seg_sum_f32 / seg_sum_f64 need for these
// shapes on the current card.
long long seg_sum_f32_scratch(long long n, int s, int out_size) {
  return scratch_elems<float>(n, s, out_size);
}

long long seg_sum_f64_scratch(long long n, int s, int out_size) {
  return scratch_elems<double>(n, s, out_size);
}

// values: [s, n] contiguous; rank: i32[n]; scratch: seg_sum_*_scratch elements;
// out: [s, out_size].  Launches on `stream`; returns the CUDA error code (0 = ok).
int seg_sum_f32(const float* values, const int* rank, float* scratch, float* out, int s,
                long long n, int out_size, void* stream) {
  return launch<float>(values, rank, scratch, out, s, n, out_size, stream);
}

int seg_sum_f64(const double* values, const int* rank, double* scratch, double* out, int s,
                long long n, int out_size, void* stream) {
  return launch<double>(values, rank, scratch, out, s, n, out_size, stream);
}

}  // extern "C"

// A byte-class DFA walked over each row of a string column, for Hopper (sm_90a): the
// regexp functions' device engine.
//
// Replaces no Pallas kernel.  The JAX package runs its DFA (spark_rapids_tpu/ops/
// regex_engine.py, dfa_search :625 and dfa_match_spans :659) as a lax.scan over the byte
// axis, and finds spans by simulating the DFA from every start position at once, which is
// quadratic in the width.  A loop over the width in torch is one launch per byte column;
// here one thread (or one warp) walks one row.
//
//   dfa_search       bool per row: does the DFA accept after some prefix of the row (the
//                    pattern was compiled with a leading any-byte loop, so this is "matches
//                    anywhere"), at the row's end only for a pattern anchored at its end.
//   dfa_match_spans  the regexp functions' matches, exactly as the JAX package picks them:
//                    chosen[rows, width + 1] and mlen[rows, width + 1].  From each start p
//                    not yet covered (0 <= p <= len) the DFA runs forward to its dead state or
//                    the row's end and keeps its longest accepting end (leftmost-longest); a
//                    match is taken where one exists, and the next start is p + max(mlen, 1),
//                    so an empty match is allowed, also at p == len.  A start anchor allows
//                    p == 0 only, an end anchor ends only at len.  Every position of both
//                    outputs is written here, the zeros too.
//
// Bound: for the search, the row bytes read once and a byte out (bytes); per byte a class
// lookup, a table lookup and an accept test (~6 operations).  For the spans the walk from
// each free start can re-read the bytes up to the dead state, so the work depends on the
// data; the bound counts the bytes read once and the (width + 1) * 5 bytes written, which
// is what a walk that touches each byte a few times in shared memory is held to.
//
// Design of the search: the host fuses the byte classes, the next-state table and the
// accept flags into one uint16 table of [states, 256] entries (next | accept[next] << 8;
// at most 128 KB for 256 states, dynamic shared memory), which each block copies into
// shared memory with 16-byte copies.  Each thread walks its own row with no
// synchronisation, 16 bytes a load where the width allows.  A byte costs one dependent
// shared-memory load: the entry's index is the state (the last entry's low byte) and the
// byte side by side, one byte permute, and the accept bits are OR-ed up as they come.  A
// hit stays a hit and the dead state goes only to itself and accepts nothing, so a whole
// 16-byte chunk is walked with no test; the row's end and the exit (a hit, or the dead
// state) are tested once a chunk.  A pattern anchored at its end takes the accept bit of
// the last entry instead.  The grid is as many blocks as the SMs hold at once with the
// table's shared memory, read once per device and table size.  What bounds it on the H100
// is the rows' reads, not the walk (PERF.md: a kernel that only stages the table and reads
// the rows takes nearly as long); two rows a thread walked interleaved, and a warp's rows
// staged in shared memory, were slower.
//
// Design of the spans: the next-state table (at most 256 states by the compiler's limit,
// so uint8 entries; up to 64 KB, in dynamic shared memory above 48 KB), the byte-class map
// and the accept flags are loaded into shared memory by each block.  The spans take one
// of two kernels, by the row width and the shared memory a tile needs:
//   the tile kernel, for rows of up to 254 bytes whose tile fits a block's shared memory
//     (the regexp items' shapes; PERF.md): each warp takes 32 rows at a time and copies
//     their bytes into shared memory with 16-byte loads (rows padded to an odd count of
//     words, so lanes at one column hit 32 banks; 16 bytes wholly past a row's length are
//     not read), and each lane walks one row there, trying the free starts one after
//     another.  A chosen start and its length go into a zeroed output tile in shared
//     memory as one byte (m + 1; 0 for none, hence the 254 bytes), which the warp then
//     writes out whole, 16 bytes a store, in row-major order: every output position,
//     coalesced.  The warps of a block (256 threads) share only the DFA's tables, so each
//     walks and stores at its own pace with no barrier; the grid is as many blocks as the
//     SMs hold at once, and each warp reads its next tile's lengths while it works on
//     this one.
//   the warp kernel, for wider rows: one warp a row; each lane walks from its own start,
//     32 starts a round, from device memory (neighbouring lanes read neighbouring bytes);
//     a ballot of the starts that match and a walk along them by find-first-set and
//     shuffles pick the chosen ones (next start p + max(mlen, 1)), and the lanes write 32
//     positions at once.
// A grid-stride loop covers any number of rows (tiles or warps).  The host side sets the
// kernels' attributes and reads the SM count and the tile kernel's occupancy once per
// device (and tile size), not at every launch.
#include <cuda_runtime.h>
#include <stdint.h>

#include <map>
#include <mutex>
#include <utility>

namespace {

constexpr int kThreads = 256;

struct Dfa {
  const uint8_t* table;   // [states, classes] next state
  const uint8_t* cls;     // [256] byte class
  const uint8_t* accept;  // [states]
  int classes;
};

__device__ __forceinline__ Dfa load(uint8_t* smem, const uint8_t* table, const uint8_t* cls,
                                    const uint8_t* accept, int states, int classes) {
  const int tsize = states * classes;
  uint8_t* s_cls = smem;
  uint8_t* s_acc = smem + 256;
  uint8_t* s_tab = smem + 512;
  for (int i = threadIdx.x; i < 256; i += blockDim.x) {
    s_cls[i] = cls[i];
    s_acc[i] = i < states ? accept[i] : 0;
  }
  for (int i = threadIdx.x; i < tsize; i += blockDim.x) s_tab[i] = table[i];
  __syncthreads();
  return Dfa{s_tab, s_cls, s_acc, classes};
}

__device__ __forceinline__ int step(const Dfa& d, int state, uint8_t byte) {
  return d.table[state * d.classes + d.cls[byte]];
}

constexpr int kSearchThreads = 512;

// One byte of the search: e is the last entry (its low byte the state); the next entry is
// at (state << 8) | byte, the byte k of w.  h gathers the accept bits (bit 8).
template <bool kAnchoredEnd>
__device__ __forceinline__ void search_step(const uint16_t* fused, uint32_t w, int k,
                                            uint32_t& e, uint32_t& h) {
  e = fused[__byte_perm(w, e, 0x6640 | k)];  // bytes: w's k-th, e's state, 0, 0
  if (!kAnchoredEnd) h |= e;
}

template <bool kAnchoredEnd>
__device__ __forceinline__ void search_word(const uint16_t* fused, uint32_t w, uint32_t& e,
                                            uint32_t& h) {
#pragma unroll
  for (int k = 0; k < 4; ++k) search_step<kAnchoredEnd>(fused, w, k, e, h);
}

template <bool kAnchoredEnd>
__device__ __forceinline__ bool stopped(uint32_t e, uint32_t h, int dead) {
  return (!kAnchoredEnd && (h & 0x100u)) || static_cast<int>(e & 0xffu) == dead;
}

// A row of len bytes at p (16-byte aligned, its width a multiple of 16) from entry e (h:
// the accept bits so far), 16 bytes a load: a whole chunk walked with no test, the row's
// end and the exit (a hit, or the dead state) tested once a chunk.
template <bool kAnchoredEnd>
__device__ __forceinline__ void search_row16(const uint16_t* fused, const uint8_t* p, int len,
                                             int dead, uint32_t& e, uint32_t& h) {
  int j0 = 0;
  for (; j0 + 16 <= len && !stopped<kAnchoredEnd>(e, h, dead); j0 += 16) {
    const uint4 v = *reinterpret_cast<const uint4*>(p + j0);
    search_word<kAnchoredEnd>(fused, v.x, e, h);
    search_word<kAnchoredEnd>(fused, v.y, e, h);
    search_word<kAnchoredEnd>(fused, v.z, e, h);
    search_word<kAnchoredEnd>(fused, v.w, e, h);
  }
  if (j0 < len && !stopped<kAnchoredEnd>(e, h, dead)) {  // the row's last bytes
    const uint4 v = *reinterpret_cast<const uint4*>(p + j0);
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
    const int n = len - j0;
#pragma unroll
    for (int k = 0; k < 16; ++k)
      if (k < n) search_step<kAnchoredEnd>(fused, w[k >> 2], k & 3, e, h);
  }
}

// a row that is not 16-byte aligned (or whose width is not a multiple of 16): byte loads,
// the exit tested every 16 bytes
template <bool kAnchoredEnd>
__device__ __forceinline__ void search_bytes(const uint16_t* fused, const uint8_t* p, int len,
                                             int dead, uint32_t& e, uint32_t& h) {
  for (int j0 = 0; j0 < len && !stopped<kAnchoredEnd>(e, h, dead); j0 += 16) {
    const int n = len - j0 < 16 ? len - j0 : 16;
    for (int k = 0; k < n; ++k) search_step<kAnchoredEnd>(fused, p[j0 + k], 0, e, h);
  }
}

template <bool kAnchoredEnd>
__device__ __forceinline__ uint8_t search_hit(uint32_t e, uint32_t h) {
  return ((kAnchoredEnd ? e : h) >> 8) & 1u;
}

// copy the fused table (states * 512 bytes, 16-byte aligned) into shared memory
__device__ __forceinline__ const uint16_t* stage_fused(uint8_t* smem, const uint16_t* fused,
                                                       int states) {
  const uint4* src = reinterpret_cast<const uint4*>(fused);
  uint4* dst = reinterpret_cast<uint4*>(smem);
  for (int i = threadIdx.x; i < states * 32; i += blockDim.x) dst[i] = src[i];
  __syncthreads();
  return reinterpret_cast<const uint16_t*>(smem);
}

template <bool kAnchoredEnd>
__global__ void __launch_bounds__(kSearchThreads)
dfa_search_kernel(const uint8_t* __restrict__ chars, long long width,
                  const int32_t* __restrict__ lens, const uint16_t* __restrict__ fused_g,
                  const uint8_t* __restrict__ accept, int states, int start, int dead,
                  uint8_t* __restrict__ hit, long long rows) {
  extern __shared__ __align__(16) uint8_t search_smem[];
  const uint16_t* fused = stage_fused(search_smem, fused_g, states);
  const uint32_t e0 = static_cast<uint32_t>(start) | (accept[start] ? 0x100u : 0u);
  const long long stride = static_cast<long long>(gridDim.x) * kSearchThreads;
  const bool vec16 = (width & 15) == 0 && (reinterpret_cast<uintptr_t>(chars) & 15) == 0;
  for (long long r = static_cast<long long>(blockIdx.x) * kSearchThreads + threadIdx.x;
       r < rows; r += stride) {
    const int len = lens[r] < 0 ? 0 : (lens[r] > width ? static_cast<int>(width) : lens[r]);
    uint32_t e = e0, h = e0;
    if (vec16)
      search_row16<kAnchoredEnd>(fused, chars + r * width, len, dead, e, h);
    else
      search_bytes<kAnchoredEnd>(fused, chars + r * width, len, dead, e, h);
    hit[r] = search_hit<kAnchoredEnd>(e, h);
  }
}

constexpr int kTileRows = 256;      // threads of a tile block, a row each at a time
constexpr int kTileMaxWidth = 254;  // m + 1 in a byte
static_assert(kTileRows % 32 == 0 && kTileRows <= 1024, "a tile is whole warps");

struct Spans {
  int start, dead, anchored_start, anchored_end;
};

// The leftmost-longest matches of one row of `len` bytes at `row`, one free start after
// another: out[p] = m + 1 for each chosen start p of a match of m bytes.
__device__ __forceinline__ void walk_row(const Dfa& d, const Spans& s, const uint8_t* row,
                                         int len, uint8_t* out) {
  const bool empty_ok = d.accept[s.start];
  const int last = s.anchored_start ? 0 : len;
  for (int p = 0; p <= last;) {
    int best = empty_ok ? p : -1;  // the longest accepting end from p
    int state = s.start;
    for (int j = p; j < len && state != s.dead; ++j) {
      state = step(d, state, row[j]);
      if (d.accept[state]) best = j + 1;
    }
    if (s.anchored_end && best != len) best = -1;
    if (best >= 0) {
      const int m = best - p;
      out[p] = static_cast<uint8_t>(m + 1);
      p += m > 1 ? m : 1;
    } else {
      ++p;
    }
  }
}

__device__ __forceinline__ int clamp_len(int len, long long width) {
  return len < 0 ? 0 : (len > width ? static_cast<int>(width) : len);
}

// the row stride of the staged bytes: a multiple of 4 bytes and an odd count of words
__host__ __device__ __forceinline__ int tile_stride(int width) {
  const int w = (width + 3) & ~3;
  return (w / 4) % 2 ? w : w + 4;
}

__host__ __device__ __forceinline__ int align16(int n) { return (n + 15) & ~15; }

// the staged output of a position: 0 not chosen, m + 1 a chosen start of a match of m bytes
__device__ __forceinline__ uint32_t chosen_bytes(uint32_t w) {  // 1 in each nonzero byte
  return ((((w & 0x7f7f7f7fu) + 0x7f7f7f7fu) | w) >> 7) & 0x01010101u;
}

// each warp of the block walks its own 32 rows at a time from shared memory, with no
// barrier between warps; a block of kTileRows rows shares the DFA's tables
__global__ void __launch_bounds__(kTileRows)
dfa_spans_tile_kernel(const uint8_t* __restrict__ chars, int width,
                      const int32_t* __restrict__ lens, const uint8_t* __restrict__ table,
                      const uint8_t* __restrict__ cls, const uint8_t* __restrict__ accept,
                      int states, int classes, Spans s, uint8_t* __restrict__ chosen,
                      int32_t* __restrict__ mlen, long long rows) {
  extern __shared__ __align__(16) uint8_t spans_smem[];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const long long step = static_cast<long long>(gridDim.x) * kTileRows;
  long long r0 = (static_cast<long long>(blockIdx.x) * (kTileRows / 32) + warp) * 32;
  // each tile's lengths are read a tile ahead, the first ones beside the tables
  int next_len = r0 + lane < rows ? lens[r0 + lane] : 0;
  const Dfa d = load(spans_smem, table, cls, accept, states, classes);
  const int ns = width + 1;
  const int stride = tile_stride(width);
  // this warp's 32 rows of bytes, then their 32 staged output rows
  uint8_t* s_chars = spans_smem + align16(512 + states * classes) +
                     warp * (align16(32 * stride) + align16(32 * ns));
  uint8_t* s_out = s_chars + align16(32 * stride);
  const int out_words = align16(32 * ns) / 16;
  for (int i = lane; i < out_words; i += 32)
    reinterpret_cast<uint4*>(s_out)[i] = make_uint4(0, 0, 0, 0);
  const bool vec_in = (width & 3) == 0 && (reinterpret_cast<uintptr_t>(chars) & 15) == 0;
  for (; r0 < rows; r0 += step) {
    const int nr = rows - r0 < 32 ? static_cast<int>(rows - r0) : 32;
    const int len = clamp_len(next_len, width);
    next_len = r0 + step + lane < rows ? lens[r0 + step + lane] : 0;
    // stage the rows' bytes (nr * width from r0 * width) up to each row's length
    const uint8_t* src = chars + r0 * width;
    const int nbytes = nr * width;
    if (vec_in) {
      // r0 * width is a multiple of 16 (r0 of 32), so every 16 bytes are aligned; 16
      // bytes wholly past their row's length are not read
      for (int i0 = 0; i0 < nbytes / 16; i0 += 32) {
        const int i = i0 + lane;
        int row = 16 * i / width, col = 16 * i - row * width;
        const int row_len = __shfl_sync(0xffffffffu, len, row & 31);
        if (i >= nbytes / 16 || (col + 16 <= width && col >= row_len)) continue;
        const uint4 v = *reinterpret_cast<const uint4*>(src + 16 * i);
        const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int k = 0; k < 4; ++k) {  // a word never straddles rows: width % 4 == 0
          *reinterpret_cast<uint32_t*>(s_chars + row * stride + col) = w[k];
          col += 4;
          if (col == width) {
            col = 0;
            ++row;
          }
        }
      }
      for (int i = (nbytes & ~15) + lane; i < nbytes; i += 32) {
        const int row = i / width;
        s_chars[row * stride + i - row * width] = src[i];
      }
    } else {
      for (int row = 0; row < nr; ++row)  // lanes on neighbouring bytes
        for (int col = lane; col < width; col += 32)
          s_chars[row * stride + col] = src[static_cast<long long>(row) * width + col];
    }
    __syncwarp();
    if (lane < nr) walk_row(d, s, s_chars + lane * stride, len, s_out + lane * ns);
    __syncwarp();
    // the output rows, row-major: nr * ns positions from r0 * ns (16-byte aligned: the
    // outputs are, and r0 * ns is a multiple of 32)
    const int npos = nr * ns;
    uint8_t* g_ch = chosen + r0 * ns;
    int32_t* g_ml = mlen + r0 * ns;
    for (int i = lane; i < npos / 16; i += 32) {
      const uint4 v = reinterpret_cast<const uint4*>(s_out)[i];
      reinterpret_cast<uint4*>(g_ch)[i] = make_uint4(
          chosen_bytes(v.x), chosen_bytes(v.y), chosen_bytes(v.z), chosen_bytes(v.w));
    }
    for (int i = (npos & ~15) + lane; i < npos; i += 32) g_ch[i] = s_out[i] != 0;
    __syncwarp();
    for (int i = lane; i < npos / 4; i += 32) {
      const uchar4 m = reinterpret_cast<const uchar4*>(s_out)[i];
      reinterpret_cast<int4*>(g_ml)[i] =
          make_int4(m.x - (m.x != 0), m.y - (m.y != 0), m.z - (m.z != 0), m.w - (m.w != 0));
      reinterpret_cast<uchar4*>(s_out)[i] = make_uchar4(0, 0, 0, 0);
    }
    for (int i = (npos & ~3) + lane; i < npos; i += 32) {
      g_ml[i] = s_out[i] - (s_out[i] != 0);
      s_out[i] = 0;
    }
    __syncwarp();
  }
}

// rows wider than a tile takes: one warp a row, from device memory
__global__ void __launch_bounds__(kThreads)
dfa_spans_warp_kernel(const uint8_t* __restrict__ chars, long long width,
                      const int32_t* __restrict__ lens, const uint8_t* __restrict__ table,
                      const uint8_t* __restrict__ cls, const uint8_t* __restrict__ accept,
                      int states, int classes, Spans s, uint8_t* __restrict__ chosen,
                      int32_t* __restrict__ mlen, long long rows) {
  extern __shared__ __align__(16) uint8_t spans_smem[];
  const Dfa d = load(spans_smem, table, cls, accept, states, classes);
  const long long ns = width + 1;
  const int lane = threadIdx.x % 32;
  const long long warps = static_cast<long long>(gridDim.x) * (kThreads / 32);
  const bool empty_ok = d.accept[s.start];
  for (long long r = static_cast<long long>(blockIdx.x) * (kThreads / 32) + threadIdx.x / 32;
       r < rows; r += warps) {
    const uint8_t* row = chars + r * width;
    uint8_t* ch = chosen + r * ns;
    int32_t* ml = mlen + r * ns;
    const int len = clamp_len(lens[r], width);
    long long next_free = 0;
    for (long long base = 0; base < ns; base += 32) {
      const long long p = base + lane;
      int m = -1;
      if (p <= len && p >= next_free && (!s.anchored_start || p == 0)) {
        int best = empty_ok ? static_cast<int>(p) : -1;
        int state = s.start;
        for (int j = static_cast<int>(p); j < len && state != s.dead; ++j) {
          state = step(d, state, __ldg(row + j));
          if (d.accept[state]) best = j + 1;
        }
        if (s.anchored_end && best != len) best = -1;
        if (best >= 0) m = best - static_cast<int>(p);
      }
      // the chosen starts of this round: from the first free one, each next one the first
      // match at or after the previous match's end
      const unsigned cand = __ballot_sync(0xffffffffu, m >= 0);
      unsigned pick = 0;
      long long pos = next_free > base ? next_free - base : 0;
      while (pos < 32) {
        const unsigned avail = cand & (0xffffffffu << pos);
        if (!avail) break;
        const int l = __ffs(avail) - 1;
        const int ml_l = __shfl_sync(0xffffffffu, m, l);
        pick |= 1u << l;
        pos = l + (ml_l > 1 ? ml_l : 1);
      }
      if (pick) next_free = base + pos;
      if (p < ns) {
        const bool mine = (pick >> lane) & 1;
        ch[p] = mine ? 1 : 0;
        ml[p] = mine ? m : 0;
      }
    }
  }
}

int smem_bytes(int states, int classes) { return 512 + states * classes; }

int tile_smem_bytes(int states, int classes, int width) {
  return align16(smem_bytes(states, classes)) +
         kTileRows / 32 * (align16(32 * tile_stride(width)) + align16(32 * (width + 1)));
}

// a block's shared memory on sm_90
constexpr int kMaxSmem = 232448;

// The launch settings, queried once per device (launches may come from several host threads):
// each spans kernel's attributes (any dynamic shared memory up to kMaxSmem, and the tile
// kernel's carveout all shared), the SM count, and the tile kernel's grid for each tile size:
// as many blocks as the SMs hold at once, so that each warp walks tile after tile.
std::mutex launch_mutex;
std::map<int, int> device_sms;                     // device -> SMs, attributes set
std::map<std::pair<int, int>, int> tile_grids;     // (device, smem) -> blocks

cudaError_t spans_device(int dev, int& sms) {  // under launch_mutex
  const auto it = device_sms.find(dev);
  if (it != device_sms.end()) {
    sms = it->second;
    return cudaSuccess;
  }
  cudaError_t e = cudaFuncSetAttribute(dfa_spans_tile_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(dfa_spans_tile_kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(dfa_spans_warp_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kMaxSmem);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess) device_sms[dev] = sms;
  return e;
}

// the tile kernel's grid for `smem` bytes a block; for smem < 0 the warp kernel's, as many
// blocks as fill the SMs' 2048 threads
cudaError_t spans_grid(int smem, int& blocks) {
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  std::lock_guard<std::mutex> lock(launch_mutex);
  e = spans_device(dev, sms);
  if (e != cudaSuccess || smem < 0) {
    blocks = sms * (2048 / kThreads);
    return e;
  }
  const auto it = tile_grids.find({dev, smem});
  if (it != tile_grids.end()) {
    blocks = it->second;
    return cudaSuccess;
  }
  int per_sm = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, dfa_spans_tile_kernel, kTileRows,
                                                    smem);
  if (e != cudaSuccess) return e;
  blocks = sms * per_sm > 0 ? sms * per_sm : 1;
  tile_grids[{dev, smem}] = blocks;
  return cudaSuccess;
}

// The search kernels' grid for a table of `states` (its shared memory), as many blocks as
// the SMs hold at once; their attributes and the SM count set and read once per device,
// the occupancy once per device and table size, under launch_mutex
std::map<int, int> search_sms;                       // device -> SMs, attributes set
std::map<std::pair<int, int>, int> search_grids;     // (device, states) -> blocks

cudaError_t search_grid(int states, int& blocks) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  std::lock_guard<std::mutex> lock(launch_mutex);
  const auto it = search_grids.find({dev, states});
  if (it != search_grids.end()) {
    blocks = it->second;
    return cudaSuccess;
  }
  auto sms = search_sms.find(dev);
  if (sms == search_sms.end()) {
    int n = 0;
    e = cudaFuncSetAttribute(dfa_search_kernel<false>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(dfa_search_kernel<true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return e;
    sms = search_sms.emplace(dev, n).first;
  }
  int per_sm = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, dfa_search_kernel<false>,
                                                    kSearchThreads, states * 512);
  if (e != cudaSuccess) return e;
  blocks = sms->second * per_sm > 0 ? sms->second * per_sm : 1;
  search_grids[{dev, states}] = blocks;
  return cudaSuccess;
}

}  // namespace

extern "C" {

// chars: u8[rows, width]; lens: i32[rows]; fused: u16[states, 256] (16-byte aligned),
// fused[s, b] = next | accept[next] << 8 for next = table[s, cls[b]]; accept: u8[states];
// dead: the dead state or -1.  hit: u8[rows].  Launches on `stream`; returns the CUDA
// error code (0 = ok).
int dfa_search(const void* chars, long long width, const void* lens, const void* fused,
               const void* accept, int states, int start, int dead, int anchored_end, void* hit,
               long long rows, void* stream) {
  if (rows < 0 || width < 0 || states < 1 || states > 256 || start < 0 || start >= states)
    return static_cast<int>(cudaErrorInvalidValue);
  if (reinterpret_cast<uintptr_t>(fused) & 15) return static_cast<int>(cudaErrorMisalignedAddress);
  if (rows == 0) return 0;
  int grid = 0;
  const cudaError_t e = search_grid(states, grid);
  if (e != cudaSuccess) return static_cast<int>(e);
  long long blocks = (rows + kSearchThreads - 1) / kSearchThreads;
  if (blocks > grid) blocks = grid;
  const auto kernel = anchored_end ? dfa_search_kernel<true> : dfa_search_kernel<false>;
  kernel<<<static_cast<int>(blocks), kSearchThreads, states * 512,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(chars), width, static_cast<const int32_t*>(lens),
      static_cast<const uint16_t*>(fused), static_cast<const uint8_t*>(accept), states, start,
      dead, static_cast<uint8_t*>(hit), rows);
  return static_cast<int>(cudaGetLastError());
}

// Which kernel dfa_match_spans takes for rows of `width` bytes and a table of `states` x
// `classes`: 0 the shared-memory tile, for rows of up to 254 bytes whose tile fits; else 1,
// a warp a row.
int dfa_spans_path(long long width, int states, int classes) {
  return width >= 0 && width <= kTileMaxWidth &&
                 tile_smem_bytes(states, classes, static_cast<int>(width)) <= kMaxSmem
             ? 0
             : 1;
}

// As dfa_search, and chosen: u8[rows, width + 1], mlen: i32[rows, width + 1], each
// 16-byte aligned, every position written here.
int dfa_match_spans(const void* chars, long long width, const void* lens, const void* table,
                    const void* cls, const void* accept, int states, int classes, int start,
                    int dead, int anchored_start, int anchored_end, void* chosen, void* mlen,
                    long long rows, void* stream) {
  if (rows < 0 || width < 0 || states < 1 || states > 256 || classes < 1 || classes > 256)
    return static_cast<int>(cudaErrorInvalidValue);
  if ((reinterpret_cast<uintptr_t>(chosen) | reinterpret_cast<uintptr_t>(mlen)) & 15)
    return static_cast<int>(cudaErrorMisalignedAddress);
  if (rows == 0) return 0;
  const Spans s{start, dead, anchored_start, anchored_end};
  const auto cs = static_cast<cudaStream_t>(stream);
  const auto c = static_cast<const uint8_t*>(chars);
  const auto n = static_cast<const int32_t*>(lens);
  const auto tb = static_cast<const uint8_t*>(table);
  const auto cl = static_cast<const uint8_t*>(cls);
  const auto ac = static_cast<const uint8_t*>(accept);
  const auto ch = static_cast<uint8_t*>(chosen);
  const auto ml = static_cast<int32_t*>(mlen);
  const bool tile = dfa_spans_path(width, states, classes) == 0;
  const int smem = tile ? tile_smem_bytes(states, classes, static_cast<int>(width))
                        : smem_bytes(states, classes);
  int grid = 0;
  const cudaError_t e = spans_grid(tile ? smem : -1, grid);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (tile) {
    long long blocks = (rows + kTileRows - 1) / kTileRows;
    if (blocks > grid) blocks = grid;
    dfa_spans_tile_kernel<<<static_cast<int>(blocks), kTileRows, smem, cs>>>(
        c, static_cast<int>(width), n, tb, cl, ac, states, classes, s, ch, ml, rows);
  } else {
    long long blocks = (rows + kThreads / 32 - 1) / (kThreads / 32);
    if (blocks > grid) blocks = grid;
    dfa_spans_warp_kernel<<<static_cast<int>(blocks), kThreads, smem, cs>>>(
        c, width, n, tb, cl, ac, states, classes, s, ch, ml, rows);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

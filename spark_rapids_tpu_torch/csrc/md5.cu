// MD5 (RFC 1321) of each row of a string column, as 32 lower-case hex bytes, for Hopper
// (sm_90a).
//
// Replaces no TPU kernel: the JAX package runs Spark's md5() per row on the host with
// hashlib (spark_rapids_tpu/sql/expressions/strings.py, Md5).  Here one thread takes one
// row: it walks the row's 64-byte blocks, the last one or two carrying the 0x80 byte, the
// zero padding and the 64-bit bit length, runs the 64 steps of each block in registers and
// writes the digest's 16 bytes as 32 hex characters.
//
// Bound: integer operations.  A block costs 293 32-bit instructions on sm_90a (the SASS of
// md5_block: 64 steps of 4 to 5, a LOP3 for F, G, H or I, IADD3s for a, the constant and
// the message word, a funnel shift and an add into b, then the four adds to the state) for
// up to 64 bytes read, so a row of up to 55 bytes (one block) moves its bytes + 36 against
// 293 operations: at the card's ~16.7 T 32-bit integer operations a second that is ~18 ps
// of work against ~18 ps of bytes at 3.35 TB/s for a 25-byte row.
//
// Design: rows are independent, so there is no shared memory, no atomics and no
// synchronisation.  A row that is not valid (a null, or a dead row past the batch's rows)
// is not hashed: its 32 bytes are written as zeros.  Each row's validity and length are
// read a row ahead, while the thread hashes the row before.  A row's bytes are read from
// its own stretch of the [rows, width] matrix, 16 bytes a load where the width allows, and
// only up to its length; the message words are the loaded words, and the one word that
// holds the row's end is masked to its bytes with the 0x80 byte after them, not built byte
// by byte.  The digest state stays in registers, its words become hex with a few word
// operations (each nibble to its ASCII digit in all four bytes at once, then the high and
// low nibbles' digits interleaved by byte permutes), and the 32 characters leave as two
// 16-byte stores (byte stores, one row per thread, cost a transaction per byte).  The grid
// is as many blocks as the SMs hold at once, read once per device, and a grid-stride loop
// covers any number of rows.  What bounds it on the H100 is the rows' reads and the
// stores, not the steps (PERF.md: a kernel that only reads and writes takes nearly as
// long); a warp's rows staged in shared memory with coalesced loads were slower.
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kThreads = 256;

__constant__ uint32_t kK[64] = {
    0xd76aa478u, 0xe8c7b756u, 0x242070dbu, 0xc1bdceeeu, 0xf57c0fafu, 0x4787c62au,
    0xa8304613u, 0xfd469501u, 0x698098d8u, 0x8b44f7afu, 0xffff5bb1u, 0x895cd7beu,
    0x6b901122u, 0xfd987193u, 0xa679438eu, 0x49b40821u, 0xf61e2562u, 0xc040b340u,
    0x265e5a51u, 0xe9b6c7aau, 0xd62f105du, 0x02441453u, 0xd8a1e681u, 0xe7d3fbc8u,
    0x21e1cde6u, 0xc33707d6u, 0xf4d50d87u, 0x455a14edu, 0xa9e3e905u, 0xfcefa3f8u,
    0x676f02d9u, 0x8d2a4c8au, 0xfffa3942u, 0x8771f681u, 0x6d9d6122u, 0xfde5380cu,
    0xa4beea44u, 0x4bdecfa9u, 0xf6bb4b60u, 0xbebfbc70u, 0x289b7ec6u, 0xeaa127fau,
    0xd4ef3085u, 0x04881d05u, 0xd9d4d039u, 0xe6db99e5u, 0x1fa27cf8u, 0xc4ac5665u,
    0xf4292244u, 0x432aff97u, 0xab9423a7u, 0xfc93a039u, 0x655b59c3u, 0x8f0ccc92u,
    0xffeff47du, 0x85845dd1u, 0x6fa87e4fu, 0xfe2ce6e0u, 0xa3014314u, 0x4e0811a1u,
    0xf7537e82u, 0xbd3af235u, 0x2ad7d2bbu, 0xeb86d391u};

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) { return __funnelshift_l(x, x, r); }

// the 64 steps of one block, added into the state
__device__ __forceinline__ void md5_block(uint32_t st[4], const uint32_t m[16]) {
  uint32_t a = st[0], bb = st[1], c = st[2], d = st[3];
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    uint32_t f;
    int g, s;
    if (i < 16) {
      f = (bb & c) | (~bb & d);
      g = i;
      s = (i & 3) == 0 ? 7 : (i & 3) == 1 ? 12 : (i & 3) == 2 ? 17 : 22;
    } else if (i < 32) {
      f = (d & bb) | (~d & c);
      g = (5 * i + 1) & 15;
      s = (i & 3) == 0 ? 5 : (i & 3) == 1 ? 9 : (i & 3) == 2 ? 14 : 20;
    } else if (i < 48) {
      f = bb ^ c ^ d;
      g = (3 * i + 5) & 15;
      s = (i & 3) == 0 ? 4 : (i & 3) == 1 ? 11 : (i & 3) == 2 ? 16 : 23;
    } else {
      f = c ^ (bb | ~d);
      g = (7 * i) & 15;
      s = (i & 3) == 0 ? 6 : (i & 3) == 1 ? 10 : (i & 3) == 2 ? 15 : 21;
    }
    const uint32_t t = d;
    d = c;
    c = bb;
    bb = bb + rotl(a + f + kK[i] + m[g], s);
    a = t;
  }
  st[0] += a;
  st[1] += bb;
  st[2] += c;
  st[3] += d;
}

// The message word at byte `at` of a row of `len` bytes, from w, the row's bytes at..at+3
// as loaded (those past len may be anything), k = len - at: the whole word for k >= 4,
// its k bytes and 0x80 after them for 0 <= k < 4, zero past the 0x80 byte.
__device__ __forceinline__ uint32_t end_word(uint32_t w, int k) {
  const int kk = k < 0 ? 0 : (k > 4 ? 4 : k);
  const uint32_t keep = __funnelshift_lc(0xffffffffu, 0u, 8 * kk);  // the low kk bytes
  const uint32_t mark = k >= 0 && k < 4 ? 0x80u << (8 * k) : 0u;
  return (w & keep) | mark;
}

// block b's 16 message words of a row of len bytes at p (16-byte aligned chunks): a chunk
// wholly before the row's end as loaded, the chunk that holds the end with the words
// before it, its end word masked to its bytes with the 0x80 byte after them (keep, mark:
// for len % 4 bytes) and zeros, and zeros past it; nothing is read past the row's end
__device__ __forceinline__ void block_words_vec(const uint8_t* p, int len, int b,
                                                uint32_t keep, uint32_t mark,
                                                uint32_t m[16]) {
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int at = b * 64 + q * 16;
    const int n = len - at;  // the row's bytes in this chunk
    if (n >= 16) {
      const uint4 v = *reinterpret_cast<const uint4*>(p + at);
      m[4 * q] = v.x;
      m[4 * q + 1] = v.y;
      m[4 * q + 2] = v.z;
      m[4 * q + 3] = v.w;
    } else if (n >= 0) {
      const uint4 v = n > 0 ? *reinterpret_cast<const uint4*>(p + at) : make_uint4(0, 0, 0, 0);
      const uint32_t w[4] = {v.x, v.y, v.z, v.w};
      const int end = n >> 2;  // the word that holds the end
#pragma unroll
      for (int i = 0; i < 4; ++i)
        m[4 * q + i] = i < end ? w[i] : (i == end ? (w[i] & keep) | mark : 0u);
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) m[4 * q + i] = 0;
    }
  }
}

// the same for rows that are not 16-byte aligned: byte loads, up to the row's end
__device__ __forceinline__ void block_words_bytes(const uint8_t* p, int len, int b,
                                                  uint32_t m[16]) {
#pragma unroll
  for (int w = 0; w < 16; ++w) {
    const int at = b * 64 + w * 4;
    uint32_t v = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (at + i < len) v |= static_cast<uint32_t>(p[at + i]) << (8 * i);
    m[w] = end_word(v, len - at);
  }
}

// four nibbles, one a byte, as their lower-case hex digits
__device__ __forceinline__ uint32_t hex_digits(uint32_t n) {
  return n + 0x30303030u + 0x27u * (((n + 0x06060606u) >> 4) & 0x01010101u);
}

// the digest's 32 hex characters (each byte's high nibble first) as two 16-byte stores; a
// warp of byte stores would touch 32 rows' sectors each
__device__ __forceinline__ void store_hex(uint8_t* out, const uint32_t st[4]) {
  uint32_t w[8];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const uint32_t hi = hex_digits((st[k] >> 4) & 0x0f0f0f0fu);
    const uint32_t lo = hex_digits(st[k] & 0x0f0f0f0fu);
    w[2 * k] = __byte_perm(hi, lo, 0x5140);
    w[2 * k + 1] = __byte_perm(hi, lo, 0x7362);
  }
  uint4* o = reinterpret_cast<uint4*>(out);
  o[0] = make_uint4(w[0], w[1], w[2], w[3]);
  o[1] = make_uint4(w[4], w[5], w[6], w[7]);
}

// the digest of a row of len bytes at p
template <bool kVec>
__device__ __forceinline__ void md5_row(const uint8_t* p, int len, uint32_t st[4]) {
  st[0] = 0x67452301u;
  st[1] = 0xefcdab89u;
  st[2] = 0x98badcfeu;
  st[3] = 0x10325476u;
  const int last = (len + 8) / 64;  // the block that holds the bit length
  const uint32_t keep = __funnelshift_lc(0xffffffffu, 0u, 8 * (len & 3));  // its len % 4 bytes
  const uint32_t mark = 0x80u << (8 * (len & 3));
  for (int b = 0; b <= last; ++b) {
    uint32_t m[16];
    if (kVec)
      block_words_vec(p, len, b, keep, mark, m);
    else
      block_words_bytes(p, len, b, m);
    if (b == last) {
      m[14] = static_cast<uint32_t>(len) << 3;
      m[15] = static_cast<uint32_t>(len) >> 29;
    }
    md5_block(st, m);
  }
}

__device__ __forceinline__ int clamp_len(int len, long long width) {
  return len < 0 ? 0 : (len > width ? static_cast<int>(width) : len);
}

__global__ void __launch_bounds__(kThreads)
md5_kernel(const uint8_t* __restrict__ chars, long long width, const int32_t* __restrict__ lens,
           const bool* __restrict__ valid, uint8_t* __restrict__ out, long long rows) {
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  const bool vec16 = (width & 15) == 0 && (reinterpret_cast<uintptr_t>(chars) & 15) == 0;
  long long r = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  // each row's validity and length are read a row ahead
  bool ok_next = r < rows && (valid == nullptr || valid[r]);
  int len_next = r < rows ? lens[r] : 0;
  for (; r < rows; r += stride) {
    const bool ok = ok_next;
    const int len = clamp_len(len_next, width);
    if (r + stride < rows) {
      ok_next = valid == nullptr || valid[r + stride];
      len_next = lens[r + stride];
    }
    uint8_t* o = out + r * 32;
    if (!ok) {
      reinterpret_cast<uint4*>(o)[0] = make_uint4(0, 0, 0, 0);
      reinterpret_cast<uint4*>(o)[1] = make_uint4(0, 0, 0, 0);
      continue;
    }
    const uint8_t* p = chars + r * width;
    uint32_t st[4];
    if (vec16)
      md5_row<true>(p, len, st);
    else
      md5_row<false>(p, len, st);
    store_hex(o, st);
  }
}

// The grid, as many blocks as the SMs hold at once, queried once per device (launches may
// come from several host threads)
constexpr int kMaxDevices = 64;
std::atomic<int> device_grids[kMaxDevices];

cudaError_t md5_grid(int& blocks) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  blocks = dev < kMaxDevices ? device_grids[dev].load(std::memory_order_relaxed) : 0;
  if (blocks > 0) return cudaSuccess;
  int sms = 0, per_sm = 0;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, md5_kernel, kThreads, 0);
  if (e != cudaSuccess) return e;
  blocks = sms * per_sm > 0 ? sms * per_sm : 1;
  if (dev < kMaxDevices) device_grids[dev].store(blocks, std::memory_order_relaxed);
  return cudaSuccess;
}

}  // namespace

extern "C" {

// chars: u8[rows, width] (row-major); lens: i32[rows]; valid: bool[rows] or null (every
// row valid); out: u8[rows, 32], 16-byte aligned (each row's 32 bytes are written as two
// 16-byte stores; zeros for a row that is not valid).  Launches on `stream`; returns the
// CUDA error code (0 = ok).
int md5_rows(const void* chars, long long width, const void* lens, const void* valid, void* out,
             long long rows, void* stream) {
  if (rows < 0 || width < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (reinterpret_cast<uintptr_t>(out) & 15) return static_cast<int>(cudaErrorMisalignedAddress);
  if (rows == 0) return 0;
  int grid = 0;
  const cudaError_t e = md5_grid(grid);
  if (e != cudaSuccess) return static_cast<int>(e);
  long long blocks = (rows + kThreads - 1) / kThreads;
  if (blocks > grid) blocks = grid;
  md5_kernel<<<static_cast<int>(blocks), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(chars), width, static_cast<const int32_t*>(lens),
      static_cast<const bool*>(valid), static_cast<uint8_t*>(out), rows);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

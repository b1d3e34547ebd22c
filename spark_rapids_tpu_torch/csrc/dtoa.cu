// The shortest decimal digits of each double (or float) that read back to it, as Java's
// Double.toString and Float.toString choose them (JDK 19+, JDK-4511638), for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package formats a double cast to a string per row on the
// host (spark_rapids_tpu/sql/expressions/cast.py, _java_double_str, from Python's repr).
// This is Raffaello Giulietti's Schubfach as the JDK's DoubleToDecimal and FloatToDecimal
// run it: the value c 2^q, its rounding interval [cbl, cbr] 2^(q-2) (closed where c is
// even), one power of ten 10^-k that leaves between 1 and 10 integers in the scaled
// interval, and a 126-bit (double) or 64-bit (float) multiplier g ~ 10^-k 2^(...) from a
// table, so that each of the interval's ends and the value itself is one 64 x 128-bit (or
// 64 x 64-bit) product rounded to odd.  Then: a multiple of ten in the interval gives the
// shorter decimal; else the one or two integers beside the value, the closer one (an even
// one on a tie).  A subnormal below C_TINY units is scaled by 10 first, so that Java's
// rule for one-digit results (the closest of one or two digits) holds.
//
// Per row the kernel writes the digits (an int64 without trailing zeros), the decimal
// exponent (value = digits 10^exponent) and the side of the digits against the value (-1
// below, 0 equal, +1 above; format_number rounds a tie by it).  NaN, the infinities and
// the zeros give digits 0; the caller formats them from the value.
//
// Tables: the host builds k for each binary exponent (floor(log10 2^q), or of 3/4 2^q
// where the spacing below is half), floor(log2 10^-k) and g for each k with Python's exact
// integers at first use, and uploads them once per device.
//
// Bound: integer operations.  A double costs three 64 x 128-bit products (~12 IMAD.WIDE and
// adds each), the candidate tests and the strip of trailing zeros: about 150 32-bit
// operations for 8 bytes read and 13 written.  At the card's ~16.7 T integer operations a
// second that is ~9 ps a row against ~6 ps of bytes at 3.35 TB/s.
//
// Design: one thread a row, no shared memory (the tables, ~10 KB, stay in L1 and L2), a
// grid-stride loop over at most 16 blocks an SM; every branch depends only
// on the row's own bits, and every path of a row (the integers, Schubfach's two choices)
// ends in the one strip, so a warp whose rows part never runs it twice.  The digits are
// unsigned.  Schubfach leaves 16 or 17 digits, so two-decimal money keeps ~10 trailing
// zeros: they go in five fixed steps, not a divide by ten each.  10^k divides d exactly
// when d 5^-k mod 2^64, rotated right by k, is at most (2^64 - 1) / 10^k, and that is then
// d / 10^k (Granlund and Montgomery's divisibility test, as Dragonbox's
// remove_trailing_zeros uses it).  The steps are 10^8 in 64 bits, then 10^8, 10^4, 10^2
// and 10 in 32 bits where what is left fits (a 17-digit value's does once 10^8 divided
// it; the same test mod 2^32), else in 64: any count below 20, each step taken only where it
// holds.  choose's s / 10 is a multiply-high.
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 16;
constexpr uint64_t kMask63 = (1ull << 63) - 1;
constexpr uint64_t kMask32 = (1ull << 32) - 1;
constexpr uint64_t kInv5 = 0xcccccccccccccccdull;  // 5^-1 mod 2^64, and ceil(2^67 / 10)

struct Out {
  uint64_t digits;
  int exponent;
  int side;
};

__host__ __device__ constexpr uint64_t inv5_pow(int k) {  // 5^-k mod 2^64
  uint64_t r = 1;
  for (int i = 0; i < k; ++i) r *= kInv5;
  return r;
}

__host__ __device__ constexpr uint64_t ten_pow(int k) {
  uint64_t p = 1;
  for (int i = 0; i < k; ++i) p *= 10;
  return p;
}

// d / 10^K and e + K where 10^K divides d (d != 0); else d and e as they were
template <int K>
__device__ __forceinline__ void strip_step(uint64_t& d, int& e) {
  constexpr uint64_t inv = inv5_pow(K), lim = ~0ull / ten_pow(K);
  const uint64_t x = d * inv;
  const uint64_t q = (x >> K) | (x << (64 - K));
  const bool ok = q <= lim;
  d = ok ? q : d;
  e += ok ? K : 0;
}

__device__ __forceinline__ uint64_t rop_d(uint64_t g1, uint64_t g0, uint64_t cp) {
  // rop(cp g 2^-127) with g = g1 2^63 + g0, as DoubleToDecimal.rop computes it
  const uint64_t x1 = __umul64hi(g0, cp);
  const uint64_t y0 = g1 * cp;
  const uint64_t y1 = __umul64hi(g1, cp);
  const uint64_t z = (y0 >> 1) + x1;
  const uint64_t vbp = y1 + (z >> 63);
  return vbp | (((z & kMask63) + kMask63) >> 63);
}

__device__ __forceinline__ uint64_t rop_f(uint64_t g, uint64_t cp) {
  // rop(cp g 2^-95), as FloatToDecimal.rop computes it
  const uint64_t x1 = __umul64hi(g, cp);
  return (x1 >> 31) | (((x1 & kMask32) + kMask32) >> 32);
}

// d / 10^K and e + K where 10^K divides d, in 32 bits (d != 0)
template <int K>
__device__ __forceinline__ void strip_step32(uint32_t& d, int& e) {
  constexpr uint32_t inv = static_cast<uint32_t>(inv5_pow(K));
  constexpr uint32_t lim = 0xffffffffu / static_cast<uint32_t>(ten_pow(K));
  const uint32_t q = __funnelshift_r(d * inv, d * inv, K);
  const bool ok = q <= lim;
  d = ok ? q : d;
  e += ok ? K : 0;
}

// d without its trailing zeros, e plus their count (d != 0)
__device__ __forceinline__ void strip(uint64_t& d, int& e) {
  // 10^8 in 64 bits; what is left of a 17-digit value then fits 32 bits
  strip_step<8>(d, e);
  if (d <= 0xffffffffull) {
    uint32_t d32 = static_cast<uint32_t>(d);
    strip_step32<8>(d32, e);
    strip_step32<4>(d32, e);
    strip_step32<2>(d32, e);
    strip_step32<1>(d32, e);
    d = d32;
  } else {
    strip_step<8>(d, e);
    strip_step<4>(d, e);
    strip_step<2>(d, e);
    strip_step<1>(d, e);
  }
}

// d (vb's digits at exponent e) without trailing zeros, and its side against the value:
// one copy for every path of a row
__device__ __forceinline__ Out finish(uint64_t d, int e, uint64_t vb) {
  // the side is read at the scale of vb (4 units a digit step); then trailing zeros go
  const uint64_t four = d << 2;
  Out o;
  o.side = four < vb ? -1 : (four > vb ? 1 : 0);
  if (d != 0) strip(d, e);
  o.digits = d;
  o.exponent = e;
  return o;
}

// Schubfach's choice among the candidates, shared by both widths: the digits d at
// exponent e
__device__ __forceinline__ void choose(uint64_t vb, uint64_t vbl, uint64_t vbr, int out, int k,
                                       int dk, uint64_t& d, int& e) {
  const uint64_t s = vb >> 2;
  if (s >= 100) {
    const uint64_t sp10 = 10 * (__umul64hi(s, kInv5) >> 3);  // 10 (s / 10)
    const uint64_t tp10 = sp10 + 10;
    const bool upin = vbl + out <= (sp10 << 2);
    const bool wpin = (tp10 << 2) + out <= vbr;
    if (upin != wpin) {
      d = upin ? sp10 : tp10;
      e = k;
      return;
    }
  }
  const uint64_t t = s + 1;
  const bool uin = vbl + out <= (s << 2);
  const bool win = (t << 2) + out <= vbr;
  if (uin != win) {
    d = uin ? s : t;
  } else {
    const uint64_t mid = (s + t) << 1;
    d = (vb < mid || (vb == mid && (s & 1) == 0)) ? s : t;
  }
  e = k + dk;
}

__global__ void __launch_bounds__(kThreads)
dtoa_f64_kernel(const uint64_t* __restrict__ bits, long long n, const int32_t* __restrict__ kq,
                const int32_t* __restrict__ f2, const uint64_t* __restrict__ g, int nq, int k_min,
                int c_tiny, long long* __restrict__ digits, int32_t* __restrict__ exps,
                int8_t* __restrict__ sides) {
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x; i < n;
       i += stride) {
    const uint64_t b = bits[i];
    const int bq = static_cast<int>((b >> 52) & 0x7ff);
    const uint64_t t = b & ((1ull << 52) - 1);
    uint64_t d = 0, vb = 0;  // NaN, the infinities and the zeros: digits 0
    int e = 0;
    if (bq != 0x7ff && (bq != 0 || t != 0)) {
      int q, dk = 0;
      uint64_t c;
      bool done = false;
      if (bq != 0) {
        const int mq = 1075 - bq;
        q = -mq;
        c = (1ull << 52) | t;
        if (0 < mq && mq < 53 && ((c >> mq) << mq) == c) {
          // an integer below 2^53: its own digits, equal to the value
          d = c >> mq;
          vb = d << 2;
          done = true;
        }
      } else {
        q = -1074;
        c = t;
        if (t < static_cast<uint64_t>(c_tiny)) {
          c = 10 * t;
          dk = -1;
        }
      }
      if (!done) {
        const int out = static_cast<int>(c & 1);
        const uint64_t cb = c << 2;
        const uint64_t cbr = cb + 2;
        const bool regular = c != (1ull << 52) || q == -1074;
        const uint64_t cbl = regular ? cb - 2 : cb - 1;
        const int k = kq[(regular ? 0 : nq) + (q + 1074)];
        const int h = q + f2[k - k_min] + 2;
        const uint64_t g1 = g[2 * (k - k_min)], g0 = g[2 * (k - k_min) + 1];
        vb = rop_d(g1, g0, cb << h);
        choose(vb, rop_d(g1, g0, cbl << h), rop_d(g1, g0, cbr << h), out, k, dk, d, e);
      }
    }
    const Out o = finish(d, e, vb);
    digits[i] = static_cast<long long>(o.digits);
    exps[i] = o.exponent;
    sides[i] = static_cast<int8_t>(o.side);
  }
}

__global__ void __launch_bounds__(kThreads)
dtoa_f32_kernel(const uint32_t* __restrict__ bits, long long n, const int32_t* __restrict__ kq,
                const int32_t* __restrict__ f2, const uint64_t* __restrict__ g, int nq, int k_min,
                int c_tiny, long long* __restrict__ digits, int32_t* __restrict__ exps,
                int8_t* __restrict__ sides) {
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x; i < n;
       i += stride) {
    const uint32_t b = bits[i];
    const int bq = static_cast<int>((b >> 23) & 0xff);
    const uint32_t t = b & ((1u << 23) - 1);
    uint64_t d = 0, vb = 0;
    int e = 0;
    if (bq != 0xff && (bq != 0 || t != 0)) {
      int q, dk = 0;
      uint32_t c;
      bool done = false;
      if (bq != 0) {
        const int mq = 150 - bq;
        q = -mq;
        c = (1u << 23) | t;
        if (0 < mq && mq < 24 && ((c >> mq) << mq) == c) {
          d = c >> mq;
          vb = d << 2;
          done = true;
        }
      } else {
        q = -149;
        c = t;
        if (t < static_cast<uint32_t>(c_tiny)) {
          c = 10 * t;
          dk = -1;
        }
      }
      if (!done) {
        const int out = static_cast<int>(c & 1);
        const uint64_t cb = static_cast<uint64_t>(c) << 2;
        const uint64_t cbr = cb + 2;
        const bool regular = c != (1u << 23) || q == -149;
        const uint64_t cbl = regular ? cb - 2 : cb - 1;
        const int k = kq[(regular ? 0 : nq) + (q + 149)];
        const int h = q + f2[k - k_min] + 33;
        const uint64_t gk = g[k - k_min];
        vb = rop_f(gk, cb << h);
        choose(vb, rop_f(gk, cbl << h), rop_f(gk, cbr << h), out, k, dk, d, e);
      }
    }
    const Out o = finish(d, e, vb);
    digits[i] = static_cast<long long>(o.digits);
    exps[i] = o.exponent;
    sides[i] = static_cast<int8_t>(o.side);
  }
}

// The current device's SM count, queried once per device (launches may come from several
// host threads)
constexpr int kMaxDevices = 64;
std::atomic<int> sm_counts[kMaxDevices];

cudaError_t sm_count(int& sms) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  sms = dev < kMaxDevices ? sm_counts[dev].load(std::memory_order_relaxed) : 0;
  if (sms > 0) return cudaSuccess;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess && dev < kMaxDevices) sm_counts[dev].store(sms, std::memory_order_relaxed);
  return e;
}

}  // namespace

extern "C" {

// values: f64[n] (is_float 0) or f32[n] (is_float 1), as their bits; kq: i32[2, nq] (k by
// q - Q_MIN, regular then irregular spacing); f2: i32[nk] (floor(log2 10^-k) by k - k_min);
// g: u64[nk, 2] (g1, g0) for doubles, u64[nk] for floats; outputs digits i64[n],
// exponents i32[n], sides i8[n].  Launches on `stream`; returns the CUDA error code.
int dtoa_shortest(const void* values, int is_float, long long n, const void* kq, const void* f2,
                  const void* g, int nq, int k_min, int c_tiny, void* digits, void* exps,
                  void* sides, void* stream) {
  if (n < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  // at most kBlocksPerSm blocks an SM, a grid-stride loop past them
  int sms = 0;
  const cudaError_t e = sm_count(sms);
  if (e != cudaSuccess) return static_cast<int>(e);
  long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > static_cast<long long>(sms) * kBlocksPerSm)
    blocks = static_cast<long long>(sms) * kBlocksPerSm;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_float) {
    dtoa_f32_kernel<<<static_cast<int>(blocks), kThreads, 0, s>>>(
        static_cast<const uint32_t*>(values), n, static_cast<const int32_t*>(kq),
        static_cast<const int32_t*>(f2), static_cast<const uint64_t*>(g), nq, k_min, c_tiny,
        static_cast<long long*>(digits), static_cast<int32_t*>(exps),
        static_cast<int8_t*>(sides));
  } else {
    dtoa_f64_kernel<<<static_cast<int>(blocks), kThreads, 0, s>>>(
        static_cast<const uint64_t*>(values), n, static_cast<const int32_t*>(kq),
        static_cast<const int32_t*>(f2), static_cast<const uint64_t*>(g), nq, k_min, c_tiny,
        static_cast<long long*>(digits), static_cast<int32_t*>(exps),
        static_cast<int8_t*>(sides));
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

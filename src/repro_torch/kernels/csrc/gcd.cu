// Elementwise gcd of pairs (a_i, b_i), with gcd(x, 0) = x and gcd(0, 0) = 0.
//
// Replaces src/repro/kernels/gcd.py::gcd_pallas (body _gcd_kernel), the
// batched gcd of the sharded cross-shard exchange and of
// VectorizedPagedKVCache.shared_prefix_bulk.
//
// What bounded the old kernel on Hopper: a 64-bit modulo for every Euclid
// step (no integer divide instruction: a long software sequence), up to 92
// steps a pair; and one thread a pair with scalar loads, so on the H100
// at 2M pairs it ran at twice its bytes bound and at the small shapes it
// was the launch itself.  The bytes are three words a pair.
//
// What this design does about it:
//
// * Binary gcd: no modulo and no division.  The common power of two is the
//   trailing zeros of a | b (__ffs, __ffsll); both sides are made odd,
//   then the larger is replaced by the difference shifted right by its
//   trailing zeros until the two are equal.  Steps run on 64-bit words
//   only while both sides are at least 2**31, then on 32-bit words.  A
//   side of 1 ends the loop at once (the pads of the sharded exchange are
//   1, and gcd(x, 1) = 1), as does a side of 0.
// * One Montgomery reduction where the sides are unbalanced.  The sharded
//   exchange pairs query chunks packed to just under 2**62 with cross
//   composites of a few registry primes, far narrower, where plain binary
//   steps would shave the wide side a bit or two at a time.  The wide side
//   is reduced modulo the narrow one by two Montgomery steps instead
//   (gcd_small below), multiplies only.
// * Vector loads and stores: where there are more pairs than the card
//   holds threads and the three arrays are 16-byte aligned, a thread
//   takes 16 bytes of a and of b (two int64 pairs or four int32 pairs)
//   and writes 16 bytes; fewer pairs (where a thread's chain of steps,
//   not the bytes, sets the time), the tail and unaligned arrays go a
//   pair a thread.
// * A grid sized to the card: at most 8 blocks of 256 threads per SM (the
//   SM's 2048 threads), grid-stride beyond.
//
// The TPU kernel runs a fixed 48 (int32) or 96 (int64) Euclid trips so
// that its vector lanes stay in step; the result is the same gcd.  Values
// are non-negative by contract (the wrappers check) and handled as
// unsigned words.

#include <cuda_runtime.h>

#include <cstdint>

#include "flat_word.cuh"

namespace {

using pfcs::ctz;

constexpr int kThreads = 256;   // 2**8
constexpr int kBlocksPerSm = 8;   // the SM's 2048 threads

// gcd of two odd numbers below 2**32, by binary steps
__device__ __forceinline__ uint32_t odd_gcd32(uint32_t u, uint32_t v) {
  while (u != v && v != 1u && u != 1u) {
    const uint32_t lo = min(u, v);
    const uint32_t d = max(u, v) - lo;   // even and nonzero
    u = lo;
    v = d >> ctz(d);
  }
  return (u == 1u || v == 1u) ? 1u : u;
}

// s <- (s + limb + k m) 2**-32 with k chosen so that the low word vanishes
// (Montgomery reduction); for odd m < 2**31 and s <= m + 1 in, s <= m + 1
// out, and s == (s + limb) 2**-32 (mod m).
__device__ __forceinline__ uint32_t redc_step(uint32_t s, uint32_t limb,
                                              uint32_t m, uint32_t mneg_inv) {
  const uint64_t t = static_cast<uint64_t>(s) + limb;
  const uint32_t k = static_cast<uint32_t>(t) * mneg_inv;
  return static_cast<uint32_t>((t + static_cast<uint64_t>(k) * m) >> 32);
}

// gcd of odd m < 2**31 and odd x < 2**64.  Where x is far larger than m
// (as in the sharded exchange's pairs), x is first reduced modulo m
// without a division: two Montgomery steps over its 32-bit halves give
// s == x 2**-64 (mod m) in [0, m + 1], and since 2 is invertible modulo
// odd m, gcd(s, m) == gcd(x, m).  m**-1 mod 2**32 comes by Newton's
// iteration.
__device__ __forceinline__ uint32_t gcd_small(uint64_t x, uint32_t m) {
  if (m == 1u) return 1u;
  uint32_t s = static_cast<uint32_t>(x);
  if ((x >> 32) != 0u || (x >> 8) >= m) {
    const uint32_t neg_inv = 0u - pfcs::inverse(m);
    s = redc_step(0u, static_cast<uint32_t>(x), m, neg_inv);
    s = redc_step(s, static_cast<uint32_t>(x >> 32), m, neg_inv);
    if (s == 0u || s == m) return m;
    s >>= ctz(s);   // an odd part with the same gcd (m is odd)
  }
  return odd_gcd32(s, m);
}

__device__ __forceinline__ uint32_t gcd_of(uint32_t a, uint32_t b) {
  if (a == 0u || b == 0u) return a | b;
  const int k = ctz(a | b);
  const uint32_t u = a >> ctz(a);
  const uint32_t v = b >> ctz(b);
  return gcd_small(max(u, v), min(u, v)) << k;
}

__device__ __forceinline__ uint64_t gcd_of(uint64_t a, uint64_t b) {
  if (a == 0u || b == 0u) return a | b;
  const int k = ctz(a | b);
  uint64_t u = a >> ctz(a);
  uint64_t v = b >> ctz(b);
  while (min(u, v) >> 31) {   // 64-bit binary steps while both sides are wide
    if (u == v) return u << k;
    const uint64_t lo = min(u, v);
    const uint64_t d = max(u, v) - lo;
    u = lo;
    v = d >> ctz(d);
  }
  return static_cast<uint64_t>(gcd_small(max(u, v), static_cast<uint32_t>(min(u, v)))) << k;
}

__device__ __forceinline__ uint64_t join(uint32_t lo, uint32_t hi) {
  return static_cast<uint64_t>(hi) << 32 | lo;
}

__device__ __forceinline__ uint4 gcd_vec(uint4 a, uint4 b, uint32_t) {
  return make_uint4(gcd_of(a.x, b.x), gcd_of(a.y, b.y), gcd_of(a.z, b.z),
                    gcd_of(a.w, b.w));
}

__device__ __forceinline__ uint4 gcd_vec(uint4 a, uint4 b, uint64_t) {
  const uint64_t g0 = gcd_of(join(a.x, a.y), join(b.x, b.y));
  const uint64_t g1 = gcd_of(join(a.z, a.w), join(b.z, b.w));
  return make_uint4(static_cast<uint32_t>(g0), static_cast<uint32_t>(g0 >> 32),
                    static_cast<uint32_t>(g1), static_cast<uint32_t>(g1 >> 32));
}

template <typename U>
__global__ void __launch_bounds__(kThreads)
gcd_kernel(const U* __restrict__ a, const U* __restrict__ b,
           U* __restrict__ out, long long n, long long groups) {
  constexpr int kPer = sizeof(U) == 4 ? 4 : 2;   // pairs in 16 bytes
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  const long long gid = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  for (long long g = gid; g < groups; g += stride) {
    const uint4 va = __ldg(reinterpret_cast<const uint4*>(a) + g);
    const uint4 vb = __ldg(reinterpret_cast<const uint4*>(b) + g);
    reinterpret_cast<uint4*>(out)[g] = gcd_vec(va, vb, U(0));
  }
  for (long long i = groups * kPer + gid; i < n; i += stride) {
    out[i] = gcd_of(a[i], b[i]);
  }
}

template <typename U>
void launch(const void* a, const void* b, void* out, long long n, cudaStream_t s) {
  constexpr int kPer = sizeof(U) == 4 ? 4 : 2;   // pairs in 16 bytes
  const long long cap = static_cast<long long>(pfcs::sm_count()) * kBlocksPerSm;
  // vectors only where the card's threads would each take more than one
  // pair anyway: below that, a pair a thread halves the longest chain
  const bool vector = ((reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b)
                        | reinterpret_cast<uintptr_t>(out)) & 15u) == 0
                      && n > cap * kThreads;
  const long long groups = vector ? n >> (kPer == 4 ? 2 : 1) : 0;   // n over kPer
  const long long work = groups + (n - groups * kPer);   // threads with work
  const long long blocks = (work + kThreads - 1) >> 8;   // kThreads = 2**8
  gcd_kernel<U><<<static_cast<unsigned>(blocks < cap ? blocks : cap), kThreads, 0, s>>>(
      static_cast<const U*>(a), static_cast<const U*>(b), static_cast<U*>(out), n, groups);
}

}  // namespace

extern "C" int pfcs_gcd(const void* a, const void* b, void* out, long long n,
                        int elem_bytes, void* stream) {
  if (n <= 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  if (elem_bytes == 4) {
    launch<uint32_t>(a, b, out, n, s);
  } else if (elem_bytes == 8) {
    launch<uint64_t>(a, b, out, n, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* pfcs_gcd_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

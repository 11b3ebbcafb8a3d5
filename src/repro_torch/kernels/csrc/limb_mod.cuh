// Divisibility of a multi-limb composite by a pool entry < 2**31 without
// a division: the 32-bit Montgomery zero test shared by divmask_limbs.cu
// and gcd_limbs.cu.  tests/test_torch_limbs.py holds a Python model of
// every function here against `%`.
//
// An entry p > 1 is split as p = 2**t * q with q odd.  p divides x exactly
// when 2**t divides x (t <= the row's trailing zero bits) and q divides x.
// For q > 1 the odd test runs the row's limbs least-significant first
// through s <- REDC(s + limb_k), REDC(T) = (T + m q) / 2**32 with
// m = T * (-q**-1) mod 2**32; the low word of T + m q is zero by the
// choice of m, so the shift is exact.  After the row's n significant
// limbs s == x * 2**(-32 n) (mod q), and 2**32 is invertible mod odd q,
// so q | x exactly when s == 0 (mod q).  The reduction is lazy: from any
// s <= q + 1, T = s + limb <= q + 2**32 and m <= 2**32 - 1 give
// T + m q <= 2**32 (q + 1), so s stays in [0, q + 1] with no correction,
// and s == 0 (mod q) is s == 0 or s == q (q + 1 is not, q > 1).  For
// q == 1 (p a power of two) the same steps keep s in {0, 1}, so the odd
// test always passes and only the power-of-two test decides.  An entry
// <= 1 never divides: its t is 2**32 - 1, above any row's trailing zero
// count.  A zero row (n = 0; its trailing zero count 2**32 - 2) is
// divisible by every entry > 1.  Leading zero limbs above n would only
// multiply s by 2**-32, so a row stops at its top nonzero limb.
//
// Each step is one 32-bit add with carry, one 32x32 multiply (low word)
// and one wide multiply-add: no integer divide, which Hopper lacks in
// hardware (a 64-bit `%` is a long software sequence).  Per entry the
// setup takes q**-1 mod 2**32 by Newton's iteration from q (correct to 3
// bits for odd q, doubling each round: 4 rounds give 48 >= 32).

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace pfcs {

// A zero row's trailing-zero count: at least any live entry's power of two
constexpr uint32_t kZeroRowTz = 0xfffffffeu;
// The power of two of an entry <= 1: above every row's trailing zero count
constexpr uint32_t kNeverTz = 0xffffffffu;

// The constants of an entry that never divides (an entry <= 1, or a slot
// past the end of the pool).
__device__ __forceinline__ uint4 no_entry() { return make_uint4(0u, 0u, kNeverTz, 0u); }

// One pool entry's constants: {q, -q**-1 mod 2**32, t, p}; an entry <= 1
// gets no_entry(): t = kNeverTz (and q = 0), so that it never divides.
__device__ __forceinline__ uint4 entry_constants(long long p) {
  if (p <= 1) return no_entry();
  const uint32_t pp = static_cast<uint32_t>(p);
  const uint32_t t = static_cast<uint32_t>(__ffs(static_cast<int>(pp)) - 1);
  const uint32_t q = pp >> t;
  uint32_t inv = q;
#pragma unroll
  for (int i = 0; i < 4; ++i) inv *= 2u - q * inv;
  return make_uint4(q, 0u - inv, t, pp);
}

// s <- REDC(s + limb) for odd q > 1, s <= q + 1 in and out.
__device__ __forceinline__ uint32_t redc_step(uint32_t s, uint32_t limb,
                                              uint32_t q, uint32_t qneg_inv) {
  const uint64_t t = static_cast<uint64_t>(s) + limb;          // < 2**33
  const uint32_t m = static_cast<uint32_t>(t) * qneg_inv;
  return static_cast<uint32_t>((t + static_cast<uint64_t>(m) * q) >> 32);
}

// Whether entry k divides a row with trailing zero bit count tz
// (kZeroRowTz for a zero row), given the Montgomery residue s of the
// row's significant limbs for k; no branch.
__device__ __forceinline__ bool entry_settles(uint4 k, uint32_t s, uint32_t tz) {
  return (k.z <= tz) & ((s == 0) | (s == k.x));
}

// Whether entry k divides the row whose n significant limbs sit at
// limbs[0], limbs[kStride], ... (the low 32-bit word of each limb) and
// whose trailing zero bit count is tz.
template <int kStride>
__device__ __forceinline__ bool entry_divides(uint4 k, const uint32_t* limbs,
                                              uint32_t n, uint32_t tz) {
  if (k.z > tz) return false;
  if (k.x == 1) return true;
  uint32_t s = 0;
  for (uint32_t j = 0; j < n; ++j) s = redc_step(s, limbs[j * kStride], k.x, k.y);
  return s == 0 || s == k.x;
}

// The Montgomery residues of one row for four entries at once: each limb
// is loaded once for the four, and the four chains are independent, so
// the multiply latency of one hides behind the others.  An entry <= 1 or
// a power of two runs the steps too (its q of 0 or 1 keeps s <= 1).
template <int kStride>
__device__ __forceinline__ void residues4(const uint32_t* limbs, uint32_t n,
                                          const uint4 (&k)[4], uint32_t (&s)[4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) s[e] = 0;
#pragma unroll 2
  for (uint32_t j = 0; j < n; ++j) {
    const uint32_t limb = limbs[j * kStride];
#pragma unroll
    for (int e = 0; e < 4; ++e) s[e] = redc_step(s[e], limb, k[e].x, k[e].y);
  }
}

// Folds one 32-limb slice (limb k0 + lane in v, 0 past the row's end)
// into the row's significant-limb count n and trailing-zero count tz;
// start from n = 0, tz = kZeroRowTz and take the slices in order.  All
// 32 lanes of the warp call it together and get the same n and tz.
__device__ __forceinline__ void fold_limb_slice(uint32_t v, int k0, uint32_t& n,
                                                uint32_t& tz) {
  const unsigned nz = __ballot_sync(0xffffffffu, v != 0);
  if (nz == 0) return;
  n = static_cast<uint32_t>(k0 + 32 - __clz(static_cast<int>(nz)));
  if (tz == kZeroRowTz) {
    const int first = __ffs(static_cast<int>(nz)) - 1;
    const uint32_t low = __shfl_sync(0xffffffffu, v, first);
    tz = 32u * static_cast<uint32_t>(k0 + first) +
         static_cast<uint32_t>(__ffs(static_cast<int>(low)) - 1);
  }
}

// The SMs of the current device times the blocks of `kernel` each holds
// at `threads` threads and `smem` bytes of dynamic shared memory: the
// size of a persistent grid.  Returns 0 on an error (in `err`).
template <typename Kernel>
inline long long persistent_blocks(Kernel kernel, int threads, size_t smem,
                                   cudaError_t& err) {
  int dev = 0, sms = 0, per_sm = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        threads, smem);
  if (err != cudaSuccess) return 0;
  if (per_sm < 1) {
    err = cudaErrorInvalidConfiguration;
    return 0;
  }
  return static_cast<long long>(sms) * per_sm;
}

// Allows `smem` bytes of dynamic shared memory for `kernel` where it is
// above the default 48 KB.
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

}  // namespace pfcs

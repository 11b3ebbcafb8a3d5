// Elementwise gcd of multi-limb composite pairs by pool reconstruction:
// g_i = prod{p in pool : p > 1, p | a_i and p | b_i}, truncated to L limbs.
//
// Replaces src/repro/kernels/gcd.py::gcd_limbs_pallas (body
// _gcd_limbs_kernel), the shared-prefix gcd of wide registries: the
// cross-shard exchange of the sharded discovery path (chunks wider than
// int64) and VectorizedPagedKVCache.shared_prefix_bulk.
//
// Input: a, b (N, L) int64 little-endian 32-bit limbs in [0, 2**32),
// pool (P,) int64 in [0, 2**31).  It equals gcd(a_i, b_i) when both are
// squarefree products of pool primes (the registry invariant), and is
// the pool product otherwise: a pair of zero rows gives the product of
// every pool prime > 1, pad rows of value 1 give 1.  Both divisibility
// tests use Horner's rule as in divmask_limbs.cu; the product is rebuilt
// by a limb multiply-accumulate, least-significant limb first:
//   t = g_k * p + carry,  g_k < 2**32, p < 2**31, carry < 2**31  =>  t < 2**63
// and the carry out of the top limb is dropped, as the TPU kernel drops
// it.  Primes are taken in pool order; multiplication mod 2**(32 L)
// commutes, so the order does not change the result.
//
// What bounds it on Hopper: the modulo: up to 2 L remainders per (pair,
// pool prime), against 8 L bytes per row of a, b and g.
//
// Design.  One warp per pair: the pool is the long axis (thousands of
// primes against tens of limbs), so the 32 lanes split it, lane t taking
// pool entries t, t + 32, ...; b is tested only where a is divisible.
// The pair's limbs sit in shared memory and every lane reads the same
// limb at each Horner step (a broadcast).  A warp ballot gathers the
// common primes of each 32-entry slice, and lane 0 multiplies them into
// the accumulator in pool order (the ballot's bit order), L limbs per
// common prime.  A thread per pair would leave most of the card idle at
// the few hundred pairs of case_scale's gcd.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarps = 8;                // pairs per block, one per warp
constexpr int kThreads = 32 * kWarps;

__global__ void gcd_limbs_kernel(const uint64_t* __restrict__ a,
                                 const uint64_t* __restrict__ b,
                                 const uint64_t* __restrict__ pool,
                                 uint64_t* __restrict__ out, long long n,
                                 long long np, int nl) {
  extern __shared__ uint32_t smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  uint32_t* sa = smem + warp * 3 * nl;   // this warp's a limbs
  uint32_t* sb = sa + nl;                // b limbs
  uint32_t* sg = sb + nl;                // the accumulator
  const long long i = static_cast<long long>(blockIdx.x) * kWarps + warp;
  if (i >= n) return;                    // whole warps leave together
  for (int k = lane; k < nl; k += 32) {
    sa[k] = static_cast<uint32_t>(a[i * nl + k]);
    sb[k] = static_cast<uint32_t>(b[i * nl + k]);
    sg[k] = k == 0 ? 1u : 0u;
  }
  __syncwarp();
  for (long long j0 = 0; j0 < np; j0 += 32) {
    const long long j = j0 + lane;
    const uint64_t p = j < np ? pool[j] : 0;
    bool common = false;
    if (p > 1) {
      uint64_t r = 0;
      for (int k = nl - 1; k >= 0; --k) r = ((r << 32) | sa[k]) % p;
      if (r == 0) {
        for (int k = nl - 1; k >= 0; --k) r = ((r << 32) | sb[k]) % p;
        common = r == 0;
      }
    }
    unsigned hits = __ballot_sync(0xffffffffu, common);
    while (hits) {
      const int src = __ffs(hits) - 1;
      const uint64_t q = __shfl_sync(0xffffffffu, p, src);
      if (lane == 0) {
        uint64_t carry = 0;
        for (int k = 0; k < nl; ++k) {
          const uint64_t v = static_cast<uint64_t>(sg[k]) * q + carry;
          sg[k] = static_cast<uint32_t>(v);
          carry = v >> 32;
        }
      }
      hits &= hits - 1;
    }
    __syncwarp();
  }
  for (int k = lane; k < nl; k += 32) out[i * nl + k] = sg[k];
}

}  // namespace

extern "C" int pfcs_gcd_limbs(const void* a, const void* b, const void* pool,
                              void* out, long long n, long long np, int nl,
                              void* stream) {
  if (n <= 0) return 0;
  if (nl <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = 3 * static_cast<size_t>(kWarps) * nl * sizeof(uint32_t);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        gcd_limbs_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const long long blocks = (n + kWarps - 1) / kWarps;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  gcd_limbs_kernel<<<static_cast<unsigned>(blocks), kThreads, smem,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint64_t*>(a), static_cast<const uint64_t*>(b),
      static_cast<const uint64_t*>(pool), static_cast<uint64_t*>(out), n, np,
      nl);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* pfcs_gcd_limbs_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

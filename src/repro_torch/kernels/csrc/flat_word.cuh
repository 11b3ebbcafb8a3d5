// Word-level helpers shared by the flat kernels (factorize.cu, gcd.cu):
// trailing zeros, the inverse of an odd word modulo 2**w, and the card's
// SM count for sizing grids.

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace pfcs {

// Trailing zero bits of x != 0.
__device__ __forceinline__ int ctz(uint32_t x) { return __ffs(static_cast<int>(x)) - 1; }
__device__ __forceinline__ int ctz(uint64_t x) { return __ffsll(static_cast<long long>(x)) - 1; }

// q**-1 mod 2**w for odd q.  The seed (3 q) ^ 2 is right to 5 bits and each
// round x <- x (2 - q x) doubles that: 3 rounds give 40 >= 32, 4 give 80.
template <typename U>
__device__ __forceinline__ U inverse(U q) {
  U x = (U(3) * q) ^ U(2);
  constexpr int kRounds = sizeof(U) == 4 ? 3 : 4;
#pragma unroll
  for (int i = 0; i < kRounds; ++i) x *= U(2) - q * x;
  return x;
}

// SMs of the current device (132 on an H100 SXM), asked once per device.
inline int sm_count() {
  static int cached[64] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 132;
  if (cached[dev] == 0) {
    int sms = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cached[dev] = sms > 0 ? sms : 132;
  }
  return cached[dev];
}

}  // namespace pfcs

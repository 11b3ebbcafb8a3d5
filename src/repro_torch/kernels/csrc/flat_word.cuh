// Word-level helpers shared by the flat kernels (divmask.cu, factorize.cu,
// gcd.cu): trailing zeros, the inverse of an odd word modulo 2**w, the
// division-free divisibility test of a word by a pool entry, the loads of a
// thread's pool entries, its mask stores, and the card's SM count for
// sizing grids.

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

__device__ __forceinline__ uint32_t mulhi(uint32_t a, uint32_t b) { return __umulhi(a, b); }
__device__ __forceinline__ uint64_t mulhi(uint64_t a, uint64_t b) { return __umul64hi(a, b); }

// An entry p > 1 as q**-1, q and 2**t - 1 (p = 2**t q, q odd).
template <typename U>
struct Entry {
  U qinv, q, low;
};

template <typename U>
__device__ __forceinline__ Entry<U> entry_of(U p) {
  const int t = ctz(p);
  const U q = p >> t;
  return {inverse(q), q, (U(1) << t) - U(1)};
}

// Keep a value in a register as computed: otherwise the compiler may
// recompute each entry's inverse inside the row loop to spare registers,
// which multiplies the instructions a pair costs.
__device__ __forceinline__ void pin(uint32_t& v) { asm volatile("" : "+r"(v)); }
__device__ __forceinline__ void pin(uint64_t& v) { asm volatile("" : "+l"(v)); }

// p | c for p = 2**t q, q odd: the low t bits of c are zero and q | c,
// and on w-bit words q | c iff x = c q**-1 mod 2**w is at most
// floor((2**w - 1) / q), that is iff the high word of x q is zero.
template <typename U>
__device__ __forceinline__ bool divides(const Entry<U>& e, U c) {
  return ((c & e.low) | mulhi(c * e.qinv, e.q)) == U(0);
}

// Word i of a 16-byte vector read as U.
template <typename U>
__device__ __forceinline__ U word(const uint4& v, int i) {
  if constexpr (sizeof(U) == 4) {
    return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
  } else {
    return i == 0 ? (static_cast<uint64_t>(v.y) << 32 | v.x)
                  : (static_cast<uint64_t>(v.w) << 32 | v.z);
  }
}

// Words of U a 16-byte vector holds, as a shift.
template <typename U>
constexpr int kPerVecLog2 = sizeof(U) == 4 ? 2 : 1;

// Entry e of E consecutive entries held in 16-byte vectors.
template <typename U, int E>
__device__ __forceinline__ U entry_word(const uint4 (&vec)[(E * sizeof(U)) >> 4], int e) {
  return word<U>(vec[e >> kPerVecLog2<U>], e & ((1 << kPerVecLog2<U>) - 1));
}

// Entries j0 .. j0 + cnt - 1 of p (cnt <= E, zero past them) as 16-byte
// vectors: vector loads where the span is whole and aligned, word loads
// otherwise.
template <typename U, int E>
__device__ __forceinline__ void load_entries(const U* __restrict__ p, long long j0, int cnt,
                                             uint4 (&vec)[(E * sizeof(U)) >> 4]) {
  static_assert(((E * sizeof(U)) & 15) == 0 && E <= 16, "whole 16-byte vectors of entries");
  constexpr int kVecs = (E * static_cast<int>(sizeof(U))) >> 4;
  constexpr int kPerVec = 1 << kPerVecLog2<U>;
  if (cnt == E && (reinterpret_cast<uintptr_t>(p + j0) & 15u) == 0) {
#pragma unroll
    for (int k = 0; k < kVecs; ++k) vec[k] = __ldg(reinterpret_cast<const uint4*>(p + j0) + k);
  } else {
#pragma unroll
    for (int k = 0; k < kVecs; ++k) {
      U part[kPerVec];
#pragma unroll
      for (int i = 0; i < kPerVec; ++i) {
        const int e = k * kPerVec + i;
        part[i] = e < cnt ? p[j0 + e] : U(0);
      }
      if constexpr (sizeof(U) == 4) {
        vec[k] = make_uint4(part[0], part[1], part[2], part[3]);
      } else {
        vec[k] = make_uint4(static_cast<uint32_t>(part[0]), static_cast<uint32_t>(part[0] >> 32),
                            static_cast<uint32_t>(part[1]), static_cast<uint32_t>(part[1] >> 32));
      }
    }
  }
}

// The E mask bytes of one row from its hit bits: each nibble spread to four
// 0/1 bytes by one multiply (bit i lands on bit 8 i, nothing else does).
// One 4-, 8- or 16-byte store where the span is whole and aligned, byte
// stores otherwise.
template <int E>
__device__ __forceinline__ void store_mask(uint8_t* dst, uint32_t bits, int cnt) {
  if (cnt == E && (reinterpret_cast<uintptr_t>(dst) & (E - 1)) == 0) {
    uint32_t w[E >> 2];
#pragma unroll
    for (int k = 0; k < (E >> 2); ++k) {
      w[k] = (((bits >> (4 * k)) & 0xfu) * 0x00204081u) & 0x01010101u;
    }
    if constexpr (E == 4) {
      *reinterpret_cast<uint32_t*>(dst) = w[0];
    } else if constexpr (E == 8) {
      *reinterpret_cast<uint2*>(dst) = make_uint2(w[0], w[1]);
    } else {
      *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
    }
  } else {
    for (int e = 0; e < cnt; ++e) dst[e] = static_cast<uint8_t>((bits >> e) & 1u);
  }
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

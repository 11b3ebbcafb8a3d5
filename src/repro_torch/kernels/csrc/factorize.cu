// Squarefree factorization against a prime pool: the divisibility mask
// mask[i, j] = p_j > 1 && p_j | c_i, plus the residual of c_i after each
// dividing p_j is divided out once (1 when the pool factors c_i fully).
//
// Replaces src/repro/kernels/factorize.py::factorize_squarefree_pallas
// (body _factorize_kernel), Algorithm 2 stage 1 as
// ops.factorize_batch_exact runs it to decode registry hits and the gcd
// hits of the sharded exchange.
//
// What bounded the old kernel on Hopper: a modulo for every (row, prime)
// pair (no integer divide instruction: a software sequence, long at
// int64); 8 rows a block, so 32 blocks at 256 rows on 132 SMs; 8 serial
// ballots and two barriers per tile of 256 primes; and a residual walk on
// 8 threads with a `/` per hit while the other 248 waited.  The bytes are
// one mask byte per pair plus a word per row and per prime.
//
// What this design does about it:
//
// * No division in the test.  An entry p > 1 is split as p = 2**t * q, q
//   odd.  p | c iff the low t bits of c are zero and q | c, and for
//   w-bit words q | c iff x = c * q**-1 mod 2**w satisfies
//   x <= floor((2**w - 1) / q), that is x * q < 2**w: the high word of
//   x * q is zero.  So the limit needs no division at all: each pair
//   costs a multiply, a high multiply, one three-way logic op and a
//   compare.  q**-1 comes by Newton's iteration (pfcs::inverse), once
//   per entry and block, and the constants stay in the registers of the
//   thread that owns the entry while it walks the block's rows.
// * Rows spread over the card.  A block takes `rows` composites (4, 2 or
//   1 at int32, up to 8 at int64: the most that still gives at least one
//   block per SM) and the whole pool in chunks of 256 * E entries, E
//   consecutive entries a thread (E = 4, 8 or 16 by pool size, at most 8
//   at int64).  Each row's E mask bytes go out as one 4-, 8- or 16-byte
//   store where the row's span is aligned to it (every pool the serving
//   path pads to 512), byte by byte otherwise.
// * Divide out only the hits.  Each thread leaves its E hit bits per row
//   in shared memory; after one barrier, warp r walks row r's hits in
//   pool order, all lanes in step (ballot, then the set bits).  On a hit
//   that divides the running residual (always, under the registry's
//   distinct-prime contract) the quotient is the product x above shifted
//   right by t: no division.  Only when the residual is not divisible (a
//   duplicate entry, or an entry and its multiple) does it take a true
//   floor `/`.  Floor divisions compose (floor(floor(c/a)/b) ==
//   floor(c/(a*b)) for positive integers), so the residual equals the
//   reference's c // prod on every input where the reference's product
//   of the dividing entries does not overflow: the contract the old
//   kernel met.  A residual of 0 stays 0 without a walk (every entry
//   divides 0), and pad rows (c = 1) stay 1.
//
// Values are non-negative by contract (the wrappers check) and handled as
// unsigned w-bit words, w = 32 for int32 and 64 for int64, each width with
// its own constants.

#include <cuda_runtime.h>

#include <cstdint>

#include "flat_word.cuh"

namespace {

using pfcs::ctz;
using pfcs::divides;
using pfcs::Entry;
using pfcs::entry_of;
using pfcs::pin;

constexpr int kThreads = 256;
constexpr int kMaxRowsLog2 = 3;
constexpr int kMaxRows = 1 << kMaxRowsLog2;   // one walking warp per row: the block's 8
constexpr unsigned kFull = 0xffffffffu;

// res divided by one dividing entry p: exact (a shift of c q**-1) when p
// divides res, else the floor division.
template <typename U>
__device__ __forceinline__ U divide_out(U res, U p) {
  const Entry<U> e = entry_of(p);
  const U x = res * e.qinv;
  if (((res & e.low) | pfcs::mulhi(x, e.q)) == U(0)) return x >> ctz(p);
  return res / p;
}

// Divide res by every hit of one row in one chunk, in pool order.  All
// lanes of the warp take part and hold the same res throughout.  Lane l
// reads the hit bits of threads 8 l .. 8 l + 7 (word k: threads 8 l + 2 k
// in the low half and 8 l + 2 k + 1 in the high half).
template <typename U, int E>
__device__ __forceinline__ U walk(U res, const uint16_t* row_hits,
                                  const U* p_chunk, int lane) {
  const uint4 v = reinterpret_cast<const uint4*>(row_hits)[lane];
  unsigned lanes = __ballot_sync(kFull, (v.x | v.y | v.z | v.w) != 0u);
  while (lanes) {
    const int src = __ffs(static_cast<int>(lanes)) - 1;
    lanes &= lanes - 1;
    const uint32_t w[4] = {__shfl_sync(kFull, v.x, src), __shfl_sync(kFull, v.y, src),
                           __shfl_sync(kFull, v.z, src), __shfl_sync(kFull, v.w, src)};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      uint32_t bits = w[k];
      while (bits) {
        const int b = __ffs(static_cast<int>(bits)) - 1;
        bits &= bits - 1;
        const int thread = 8 * src + 2 * k + (b >> 4);
        res = divide_out(res, p_chunk[thread * E + (b & 15)]);
      }
    }
  }
  return res;
}

template <typename U, int E>
__global__ void __launch_bounds__(kThreads)
factorize_kernel(const U* __restrict__ c, const U* __restrict__ p,
                 uint8_t* __restrict__ mask, U* __restrict__ residual,
                 long long n, long long np, int rows) {
  static_assert(((E * sizeof(U)) & 15) == 0 && E <= 16, "whole 16-byte vectors of entries");
  constexpr int kChunk = kThreads * E;
  __shared__ U c_tile[kMaxRows];
  __shared__ __align__(16) U p_chunk[kChunk];
  __shared__ __align__(16) uint16_t hits[kMaxRows][kThreads];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const long long row0 = static_cast<long long>(blockIdx.x) * rows;
  const int live_rows = static_cast<int>(min(static_cast<long long>(rows), n - row0));
  if (tid < live_rows) c_tile[tid] = c[row0 + tid];
  __syncthreads();
  U res = warp < live_rows ? c_tile[warp] : U(0);   // warp r divides row r

  for (long long base = 0; base < np; base += kChunk) {
    const long long j0 = base + static_cast<long long>(tid) * E;
    const int cnt = static_cast<int>(max(0LL, min(static_cast<long long>(E), np - j0)));
    // this thread's E entries: into the chunk's shared copy (for the
    // walkers) and, as constants, into registers
    constexpr int kVecs = (E * static_cast<int>(sizeof(U))) >> 4;
    constexpr int kPerVec = sizeof(U) == 4 ? 4 : 2;
    uint4 vec[kVecs];
    pfcs::load_entries<U, E>(p, j0, cnt, vec);
    Entry<U> ent[E];
    uint32_t live = 0;
#pragma unroll
    for (int k = 0; k < kVecs; ++k) {
      reinterpret_cast<uint4*>(p_chunk + tid * E)[k] = vec[k];
#pragma unroll
      for (int i = 0; i < kPerVec; ++i) {
        const int e = k * kPerVec + i;
        const U pj = pfcs::word<U>(vec[k], i);
        const bool ok = pj > U(1);
        ent[e] = entry_of(ok ? pj : U(1));
        pin(ent[e].qinv);
        pin(ent[e].q);
        pin(ent[e].low);
        live |= static_cast<uint32_t>(ok) << e;
      }
    }

    for (int r = 0; r < live_rows; ++r) {
      const U cv = c_tile[r];
      uint32_t bits = 0;
#pragma unroll
      for (int e = 0; e < E; ++e) bits |= static_cast<uint32_t>(divides(ent[e], cv)) << e;
      bits &= live;
      hits[r][tid] = static_cast<uint16_t>(bits);
      if (cnt > 0) pfcs::store_mask<E>(mask + (row0 + r) * np + j0, bits, cnt);
    }
    __syncthreads();
    if (warp < live_rows && res != U(0)) res = walk<U, E>(res, hits[warp], p_chunk, lane);
    if (base + kChunk < np) __syncthreads();   // before the next chunk overwrites
  }
  if (warp < live_rows && lane == 0) residual[row0 + warp] = res;
}

template <typename U, int E>
void launch(const void* c, const void* p, void* mask, void* residual,
            long long n, long long np, cudaStream_t s) {
  // the most rows a block that still give every SM a block, at most 4 for
  // 4-byte words (more blocks hide more latency) and 8 for 8-byte words
  // (whose constants cost more to make per block)
  const long long sms = pfcs::sm_count();
  int shift = sizeof(U) == 4 ? kMaxRowsLog2 - 1 : kMaxRowsLog2;   // rows = 2**shift
  while (shift > 0 && ((n + (1LL << shift) - 1) >> shift) < sms) --shift;
  const int rows = 1 << shift;
  const dim3 grid(static_cast<unsigned>((n + rows - 1) >> shift));
  factorize_kernel<U, E><<<grid, kThreads, 0, s>>>(
      static_cast<const U*>(c), static_cast<const U*>(p),
      static_cast<uint8_t*>(mask), static_cast<U*>(residual), n, np, rows);
}

}  // namespace

extern "C" int pfcs_factorize(const void* c, const void* p, void* mask,
                              void* residual, long long n, long long np,
                              int elem_bytes, void* stream) {
  if (n <= 0) return 0;
  if (((n + kMaxRows - 1) >> kMaxRowsLog2) > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  auto s = static_cast<cudaStream_t>(stream);
  if (elem_bytes == 4) {
    if (np <= 1024) {
      launch<uint32_t, 4>(c, p, mask, residual, n, np, s);
    } else if (np <= 2048) {
      launch<uint32_t, 8>(c, p, mask, residual, n, np, s);
    } else {
      launch<uint32_t, 16>(c, p, mask, residual, n, np, s);
    }
  } else if (elem_bytes == 8) {
    if (np <= 1024) {
      launch<uint64_t, 4>(c, p, mask, residual, n, np, s);
    } else {
      launch<uint64_t, 8>(c, p, mask, residual, n, np, s);
    }
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* pfcs_factorize_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

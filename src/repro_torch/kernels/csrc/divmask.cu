// Divisibility mask: mask[i, j] = p_j > 1 && p_j | c_i.
//
// Replaces src/repro/kernels/factorize.py::divisibility_mask_pallas
// (body _divmask_kernel), the section 4.2 registry scan of the sharded
// discovery path and of successor_table(discover="kernel").
//
// What bounds it on Hopper.  The bytes are one word per row and per entry
// plus one mask byte per pair: at the serving shapes (256 x 512 to
// 4096 x 4096, int64) a few microseconds at most, so the launch and one
// round trip to memory set the small shapes' time and the mask write the
// large ones'.  The old kernel took a software `%` per pair (Hopper has
// no integer divide; about 20 instructions at 32 bits and several times
// that for a 64-bit operand), 32 of them one after another in each
// thread, on 16 blocks at 256 x 512, with one byte store per pair.
//
// What this design does about it:
//
// * No division.  An entry p > 1 is split as p = 2**t * q, q odd, and
//   p | c iff the low t bits of c are zero and the high word of
//   (c * q**-1 mod 2**w) * q is zero (flat_word.cuh::divides, as in
//   factorize.cu).  q**-1 is made once per entry and block and pinned in
//   registers while the thread walks the block's rows.
// * The narrow test where the row is narrow.  At int64, for a thread
//   whose entries are all below 2**32 (every pool the serving path
//   gives), a row below 2**32 takes the 32-bit test on the low words of
//   the entry's constants (a multiply, a high multiply, a logic op, a
//   compare), and a wider row a 64-bit product by q**-1 and a 96-bit high
//   word by two 32-bit multiplies by q.  q**-1 mod 2**64 is lifted from
//   the 32-bit inverse by one Newton round.  Every thread of the block
//   reads the same row (one load, broadcast), so the branch on its width
//   is uniform; rows of 0 (divisible by every entry > 1) and 1 (by none;
//   the serving path's pad rows) take no test at all.  A thread that
//   holds an entry of 2**32 or more takes the general 64-bit test.
// * Rows and entries over the card.  A thread owns E consecutive entries
//   (4, 8 or 16 by pool size, at most 8 at int64) and walks the block's
//   rows (1 to 32: the most that still gives every SM a block); a block's
//   threads cover 256 * E entries (fewer, down to a warp, for a small
//   pool), and the grid covers rows by entry chunks.  No barrier and no
//   shared memory.  Each row's E mask bytes go out as one 4-, 8- or
//   16-byte store where the row's span is aligned to it, byte by byte
//   otherwise; a warp's stores are contiguous.
//
// On an H100 (PERF.md section 6) the serving shapes up to 1024 x 1024
// take about twice the empty launch and 4096 x 4096 about twice its bytes
// bound.  Fewer rows a block, fewer registers (E = 4 at int64), unrolled
// rows and the rows staged in shared memory behind a barrier were tried;
// none was faster across the shapes.
//
// Values are non-negative by contract (the wrappers check) and handled as
// unsigned w-bit words, w = 32 for int32 and 64 for int64.

#include <cuda_runtime.h>

#include <cstdint>

#include "flat_word.cuh"

namespace {

using pfcs::Entry;
using pfcs::entry_of;
using pfcs::entry_word;
using pfcs::pin;

constexpr int kMaxThreads = 256;
constexpr int kMaxRowsLog2 = 5;   // rows a block: at most 32

// An entry p < 2**32 at int64: q**-1 mod 2**64, q and 2**t - 1 (p = 2**t q).
struct Small {
  uint64_t qinv;
  uint32_t q, low;
};

__device__ __forceinline__ Small small_entry(uint32_t p) {
  const int t = pfcs::ctz(p);
  const uint32_t q = p >> t;
  const uint64_t x = pfcs::inverse(q);   // q**-1 mod 2**32
  // one Newton round doubles the bits: q x (2 - q x) == 1 mod 2**64
  return {x * (2ull - static_cast<uint64_t>(q) * x), q, (1u << t) - 1u};
}

// A row below 2**32: the 32-bit test on the low words of the constants.
__device__ __forceinline__ bool narrow_divides(const Small& e, uint32_t c) {
  return ((c & e.low) | __umulhi(c * static_cast<uint32_t>(e.qinv), e.q)) == 0u;
}

// A row of 2**32 or more: x = c q**-1 mod 2**64, and the bits of x q above
// 2**64 are those above 2**32 of hi(x) q + hi(lo(x) q).
__device__ __forceinline__ bool wide_divides(const Small& e, uint64_t c) {
  const uint64_t x = c * e.qinv;
  const uint64_t top = static_cast<uint64_t>(static_cast<uint32_t>(x >> 32)) * e.q +
                       __umulhi(static_cast<uint32_t>(x), e.q);
  return ((static_cast<uint32_t>(c) & e.low) | static_cast<uint32_t>(top >> 32)) == 0u;
}

// Writes the mask bytes of the block's rows for this thread's entries:
// rows of 0 and 1 take no test, the others row_bits(c).
template <int E, typename U, typename RowBits>
__device__ __forceinline__ void scan_rows(const U* __restrict__ rows_c, int live_rows, uint32_t live,
                                          uint8_t* dst, long long np, int cnt,
                                          RowBits row_bits) {
  for (int r = 0; r < live_rows; ++r, dst += np) {
    const U cv = __ldg(rows_c + r);
    const uint32_t bits = cv > U(1) ? row_bits(cv) & live : (cv == U(0) ? live : 0u);
    pfcs::store_mask<E>(dst, bits, cnt);
  }
}

template <typename U, int E>
__global__ void __launch_bounds__(kMaxThreads)
divmask_kernel(const U* __restrict__ c, const U* __restrict__ p,
               uint8_t* __restrict__ mask, long long n, long long np, int rows) {
  constexpr int kVecs = (E * static_cast<int>(sizeof(U))) >> 4;
  const long long row0 = static_cast<long long>(blockIdx.x) * rows;
  const int live_rows = static_cast<int>(min(static_cast<long long>(rows), n - row0));
  const U* rows_c = c + row0;
  const long long j0 = (static_cast<long long>(blockIdx.y) * blockDim.x + threadIdx.x) * E;
  const int cnt = static_cast<int>(max(0LL, min(static_cast<long long>(E), np - j0)));
  if (cnt == 0) return;
  uint4 vec[kVecs];
  pfcs::load_entries<U, E>(p, j0, cnt, vec);
  uint32_t live = 0;
#pragma unroll
  for (int e = 0; e < E; ++e) live |= static_cast<uint32_t>(entry_word<U, E>(vec, e) > U(1)) << e;
  uint8_t* dst = mask + row0 * np + j0;

  if constexpr (sizeof(U) == 4) {
    Entry<U> ent[E];
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const U pj = entry_word<U, E>(vec, e);
      ent[e] = entry_of(pj > U(1) ? pj : U(1));
      pin(ent[e].qinv);
      pin(ent[e].q);
      pin(ent[e].low);
    }
    scan_rows<E>(rows_c, live_rows, live, dst, np, cnt, [&](U cv) {
      uint32_t bits = 0;
#pragma unroll
      for (int e = 0; e < E; ++e) bits |= static_cast<uint32_t>(pfcs::divides(ent[e], cv)) << e;
      return bits;
    });
  } else {
    bool big = false;
#pragma unroll
    for (int e = 0; e < E; ++e) big |= (entry_word<U, E>(vec, e) >> 32) != 0u;
    if (!big) {
      Small ent[E];
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const uint32_t pj = static_cast<uint32_t>(entry_word<U, E>(vec, e));
        ent[e] = small_entry(pj > 1u ? pj : 1u);
        pin(ent[e].qinv);
        pin(ent[e].q);
        pin(ent[e].low);
      }
      scan_rows<E>(rows_c, live_rows, live, dst, np, cnt, [&](U cv) {
        uint32_t bits = 0;
        if ((cv >> 32) == 0u) {
          const uint32_t c32 = static_cast<uint32_t>(cv);
#pragma unroll
          for (int e = 0; e < E; ++e) bits |= static_cast<uint32_t>(narrow_divides(ent[e], c32)) << e;
        } else {
#pragma unroll
          for (int e = 0; e < E; ++e) bits |= static_cast<uint32_t>(wide_divides(ent[e], cv)) << e;
        }
        return bits;
      });
    } else {
      Entry<U> ent[E];
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const U pj = entry_word<U, E>(vec, e);
        ent[e] = entry_of(pj > U(1) ? pj : U(1));
      }
      scan_rows<E>(rows_c, live_rows, live, dst, np, cnt, [&](U cv) {
        uint32_t bits = 0;
#pragma unroll
        for (int e = 0; e < E; ++e) bits |= static_cast<uint32_t>(pfcs::divides(ent[e], cv)) << e;
        return bits;
      });
    }
  }
}

// ceil(x / 2**k)
constexpr long long ceil_shift(long long x, int k) { return (x + (1LL << k) - 1) >> k; }

template <typename U, int E, int kLog2E>
int launch(const void* c, const void* p, void* mask, long long n, long long np,
           cudaStream_t s) {
  static_assert(E == 1 << kLog2E, "E is 2**kLog2E");
  // threads: the power of two from a warp to 256 that covers the pool's
  // groups of E entries; rows a block: the most, up to 32, that still give
  // every SM a block
  const long long groups = ceil_shift(np, kLog2E);
  int log2_threads = 5;
  while ((1LL << log2_threads) < kMaxThreads && (1LL << log2_threads) < groups) ++log2_threads;
  const long long chunks = ceil_shift(groups, log2_threads);
  if (chunks > 65535) return static_cast<int>(cudaErrorInvalidConfiguration);
  const long long sms = pfcs::sm_count();
  int shift = kMaxRowsLog2;
  while (shift > 0 && chunks * ceil_shift(n, shift) < sms) --shift;
  const long long tiles = ceil_shift(n, shift);
  if (tiles > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  const dim3 grid(static_cast<unsigned>(tiles), static_cast<unsigned>(chunks));
  divmask_kernel<U, E><<<grid, 1 << log2_threads, 0, s>>>(
      static_cast<const U*>(c), static_cast<const U*>(p),
      static_cast<uint8_t*>(mask), n, np, 1 << shift);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int pfcs_divmask(const void* c, const void* p, void* mask,
                            long long n, long long np, int elem_bytes,
                            void* stream) {
  if (n <= 0 || np <= 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  if (elem_bytes == 4) {
    if (np <= 1024) return launch<uint32_t, 4, 2>(c, p, mask, n, np, s);
    if (np <= 2048) return launch<uint32_t, 8, 3>(c, p, mask, n, np, s);
    return launch<uint32_t, 16, 4>(c, p, mask, n, np, s);
  }
  if (elem_bytes == 8) {
    if (np <= 1024) return launch<uint64_t, 4, 2>(c, p, mask, n, np, s);
    return launch<uint64_t, 8, 3>(c, p, mask, n, np, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* pfcs_divmask_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

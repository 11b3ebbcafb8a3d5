// Squarefree factorization of multi-limb composites against a prime
// pool: the limb divisibility mask mask[i, j] = p_j > 1 && p_j | c_i,
// and the residual limbs of c_i after each dividing entry has been
// divided out once.
//
// Replaces src/repro/kernels/factorize.py::factorize_limbs_pallas
// (bodies _factorize_limbs_kernel and _short_div), Algorithm 2 stage 1
// on wide registries as ops.factorize_batch_exact runs it: the decode of
// successor_table(discover="kernel"), of shared-prefix gcds wider than
// int64, and case_scale's differential check.
//
// Input as in divmask_limbs.cu: (N, L) int64 limbs in [0, 2**32),
// entries (P,) int64 in [0, 2**31).  The mask is taken on the INPUT
// limbs; each dividing entry then divides the running residual once, in
// pool order, as a floor division.  Floor divisions compose
// (floor(floor(c / a) / b) == floor(c / (a b))), so the residual is
// c // (the product of the dividing entries) on every input, a pool with
// a duplicate entry or an entry and its multiple included.  A
// non-squarefree input keeps its repeated factor; an all-zero row is
// divisible by every entry > 1 and stays zero.
//
// What bounded the old kernel on Hopper: a 64-bit `%` per limb of every
// row for every entry (Hopper has no integer divide: a long software
// sequence), over all L limbs, leading zeros included; a 64-bit `/` per
// limb of each division; and the division walk on 8 threads of 256.
// The bytes are a row's limbs in and out and one mask byte per pair.
//
// What this design does about it:
//
// * The mask without a division: limb_mod.cuh's Montgomery zero test over
//   each row's significant limbs, least significant first, the power of
//   two of an entry against the row's trailing zero bits, as in
//   divmask_limbs.cu.  A block holds R <= 8 limb rows in shared memory
//   (R: the most that still gives every SM a block) and takes the pool in
//   pieces of 1024 entries, four consecutive entries a thread with their
//   constants in registers; the 32 lanes of a warp read the same row (a
//   broadcast).  Each row's four mask bytes go out as one 4-byte store
//   where aligned; the block's rows are one contiguous span of the mask.
// * The hits, in pool order, as a bitmap in shared memory (32 words a
//   row and piece, double-buffered so that one barrier a piece suffices).
// * The residual by exact division, a warp a row.  For p = 2**t q, q odd,
//   an exact division by q needs no division: least significant limb
//   first, x = limb - carry (with borrow), quotient limb = x q**-1 mod
//   2**32, carry = hi(quotient limb * q) + borrow (Jebelean); the final
//   carry is zero exactly when q divides.  Up to 32 hits are divided out
//   at once as a pipeline across the warp's lanes: lane h divides by
//   hit h the limbs lane h - 1 passes it (one shuffle a step), so a batch
//   of H hits over n significant limbs takes n + H - 1 steps, not n H.
//   The powers of two are shifted out at the end of the batch, one shift
//   by their sum T.  The batch divided exactly when every lane's carry is
//   zero and T is at most the residual's trailing zero bits.  Where it
//   did not (a duplicate entry, or 2 with 4: never under the registry's
//   distinct-prime contract), the batch is floor-divided instead by the
//   same pipeline run from the most significant limb, a 64-by-32 step by
//   a reciprocal of each hit (its one `/`).  Once a floor has left the
//   residual no multiple of the later hits, every later batch of the
//   row takes this branch, at two passes a batch.
// * Every warp walks its own row while the others test the next piece.
//
// Tensor cores (wgmma) do not apply: a remainder is no matrix product.

#include <cuda_runtime.h>

#include <cstdint>

#include "limb_mod.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxRowsLog2 = 3;   // rows a block: at most 8, a walking warp each
constexpr int kPiece = 4 * kThreads;          // entries a piece: four a thread
constexpr int kPieceWords = kPiece >> 5;      // hit words a row and piece
constexpr unsigned kFull = 0xffffffffu;
constexpr size_t kMaxSmem = 227 * 1024;

// Shared memory of a block of `rows` rows of `nl` limbs, in 32-bit words:
// the rows' (n, tz) (2 words each), the hit bitmaps [2][rows][32], the
// input limbs [rows][nl] and the residuals [rows][2][nl].
__host__ __device__ constexpr size_t smem_words(int rows, int nl) {
  return static_cast<size_t>(rows) * (2 + 2 * kPieceWords + 3 * static_cast<size_t>(nl));
}

// One row's residual while its warp walks it: `cur` holds the value, with
// n significant limbs and tz trailing zero bits (kZeroRowTz for 0);
// `other` is the scratch buffer, zero from limb n_other on.
struct Residual {
  uint32_t* cur;
  uint32_t* other;
  uint32_t n, tz, n_other;
};

// (n, tz) of the value in buf, whose limbs from `bound` on are zero.
__device__ __forceinline__ void recount(const uint32_t* buf, uint32_t bound, uint32_t& n,
                                        uint32_t& tz, int lane) {
  n = 0;
  tz = pfcs::kZeroRowTz;
  for (uint32_t k0 = 0; k0 < bound; k0 += 32) {
    const uint32_t k = k0 + lane;
    pfcs::fold_limb_slice(k < bound ? buf[k] : 0u, static_cast<int>(k0), n, tz);
  }
}

// Divides the residual's n limbs by the odd parts of m hits at once, lane
// h by hit h (q, its inverse qinv mod 2**32; pass-through lanes hold 1, 1),
// into r.other; returns this lane's final carry (0 where q divided its
// input exactly).
__device__ __forceinline__ uint32_t exact_pipeline(const Residual& r, int m, uint32_t q,
                                                   uint32_t qinv, int lane) {
  for (uint32_t k = r.n + lane; k < r.n_other; k += 32) r.other[k] = 0u;
  uint32_t carry = 0, out = 0;
  const int steps = static_cast<int>(r.n) + m - 1;
  for (int s = 0; s < steps; ++s) {
    uint32_t in = __shfl_up_sync(kFull, out, 1);   // lane - 1's limb of the last step
    const int k = s - lane;
    if (lane == 0) in = k < static_cast<int>(r.n) ? r.cur[k] : 0u;
    if (lane < m && k >= 0 && k < static_cast<int>(r.n)) {
      const uint32_t x = in - carry;
      const uint32_t borrow = in < carry;
      out = x * qinv;
      carry = __umulhi(out, q) + borrow;
      if (lane == m - 1) r.other[k] = out;
    }
  }
  __syncwarp();
  return carry;
}

// buf (n limbs, low T bits zero) shifted right by T bits in place.
__device__ __forceinline__ void shift_out(uint32_t* buf, uint32_t n, uint32_t T, int lane) {
  if (T == 0) return;
  const uint32_t w = T >> 5, b = T & 31u;
  for (uint32_t k0 = 0; k0 < n; k0 += 32) {
    const uint32_t k = k0 + lane;
    const uint32_t lo = k + w < n ? buf[k + w] : 0u;
    const uint32_t hi = k + w + 1 < n ? buf[k + w + 1] : 0u;
    const uint32_t v = b ? (lo >> b) | (hi << (32u - b)) : lo;
    __syncwarp();
    if (k < n) buf[k] = v;
    __syncwarp();
  }
}

// Floor-divides the residual's n limbs by m hits at once, lane h by hit
// h (p), most significant limb first, into r.other: lane h divides the
// quotient limbs lane h - 1 passes it, as in exact_pipeline but from the
// top.  Each step is a 64-by-32 division by the reciprocal
// floor((2**64 - 1) / p), one correction at most; the reciprocal is the
// kernel's only `/`, taken once a hit on this not-divisible branch.
__device__ __forceinline__ void floor_pipeline(const Residual& r, int m, uint32_t p,
                                               int lane) {
  const uint64_t mu = lane < m ? ~0ull / p : 0ull;
  const int n = static_cast<int>(r.n);
  uint64_t rem = 0;
  uint32_t out = 0;
  for (int s = 0; s < n + m - 1; ++s) {
    uint32_t in = __shfl_up_sync(kFull, out, 1);
    const int j = s - lane;   // limb n - 1 - j
    if (lane == 0) in = j < n ? r.cur[n - 1 - j] : 0u;
    if (lane < m && j >= 0 && j < n) {
      const uint64_t cur = (rem << 32) | in;   // < p 2**32
      uint64_t quo = __umul64hi(cur, mu);      // floor(cur / p) or one less
      rem = cur - quo * p;
      if (rem >= p) {
        rem -= p;
        ++quo;
      }
      out = static_cast<uint32_t>(quo);
      if (lane == m - 1) r.other[n - 1 - j] = out;
    }
  }
  __syncwarp();
}

// Divides the residual by H <= 32 hits in pool order, lane h holding hit
// h's entry index `mine`.  All lanes of the warp take part.  Where every
// hit divides the running residual (the lanes' carries are all zero and
// the hits' powers of two sum to at most the residual's trailing zero
// bits), the exact quotient of the odd parts is shifted by that sum;
// else the batch is floor-divided by its hits from the residual it
// started from (floor(c / p) == c / p where p divides, so the hits that
// did divide lose nothing).
__device__ void divide_batch(Residual& r, const long long* __restrict__ p, long long mine,
                             int H, int lane) {
  uint32_t q = 1u, qinv = 1u, t = 0u, pe = 1u;
  if (lane < H) {
    const uint4 k = pfcs::entry_constants(p[mine]);
    q = k.x;
    qinv = 0u - k.y;
    t = k.z;
    pe = k.w;
  }
  const uint32_t T = __reduce_add_sync(kFull, t);
  const uint32_t carry = exact_pipeline(r, H, q, qinv, lane);
  if (!__any_sync(kFull, carry != 0u) && T <= r.tz) {
    shift_out(r.other, r.n, T, lane);
  } else {
    floor_pipeline(r, H, pe, lane);
  }
  uint32_t* done = r.other;
  r.other = r.cur;
  r.cur = done;
  r.n_other = r.n;
  recount(r.cur, r.n, r.n, r.tz, lane);
}

__global__ void __launch_bounds__(kThreads)
factorize_limbs_kernel(const uint64_t* __restrict__ limbs, const long long* __restrict__ p,
                       uint8_t* __restrict__ mask, uint64_t* __restrict__ residual,
                       long long n, long long np, int nl, int rows) {
  extern __shared__ __align__(16) uint32_t smem[];
  uint2* meta = reinterpret_cast<uint2*>(smem);            // [rows] (n, tz)
  uint32_t* hits = smem + 2 * rows;                         // [2][rows][kPieceWords]
  uint32_t* tile = hits + 2 * rows * kPieceWords;           // [rows][nl]
  uint32_t* res = tile + rows * nl;                         // [rows][2][nl]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long row0 = static_cast<long long>(blockIdx.x) * rows;
  const int live = static_cast<int>(min(static_cast<long long>(rows), n - row0));

  // warp w stages row w: its limbs, a copy as the residual, a zero scratch
  // buffer, and its (n, tz)
  Residual r{res + 2 * warp * nl, res + (2 * warp + 1) * nl, 0u, pfcs::kZeroRowTz, 0u};
  if (warp < live) {
    const uint64_t* src = limbs + (row0 + warp) * nl;
    for (int k0 = 0; k0 < nl; k0 += 32) {
      const int k = k0 + lane;
      const uint32_t v = k < nl ? static_cast<uint32_t>(src[k]) : 0u;
      if (k < nl) {
        tile[warp * nl + k] = v;
        r.cur[k] = v;
        r.other[k] = 0u;
      }
      pfcs::fold_limb_slice(v, k0, r.n, r.tz);
    }
    if (lane == 0) meta[warp] = make_uint2(r.n, r.tz);
  }
  __syncthreads();

  int piece = 0;
  for (long long base = 0; base < np; base += kPiece, ++piece) {
    uint32_t* piece_hits = hits + (piece & 1) * rows * kPieceWords;
    // the mask of this piece: entries base + 4 tid .. + 3 against every row
    const long long j0 = base + 4 * tid;
    const int cnt = static_cast<int>(max(0LL, min(4LL, np - j0)));
    uint4 k[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) k[e] = e < cnt ? pfcs::entry_constants(p[j0 + e]) : pfcs::no_entry();
    for (int row = 0; row < live; ++row) {
      const uint2 m = meta[row];
      uint32_t s[4] = {0u, 0u, 0u, 0u};
      if (cnt > 0) pfcs::residues4<1>(tile + row * nl, m.x, k, s);
      uint32_t nib = 0;
#pragma unroll
      for (int e = 0; e < 4; ++e) nib |= static_cast<uint32_t>(pfcs::entry_settles(k[e], s[e], m.y)) << e;
      uint8_t* dst = mask + (row0 + row) * np + j0;
      if (cnt == 4 && (reinterpret_cast<uintptr_t>(dst) & 3u) == 0) {
        *reinterpret_cast<uint32_t*>(dst) = (nib * 0x00204081u) & 0x01010101u;
      } else {
        for (int e = 0; e < cnt; ++e) dst[e] = static_cast<uint8_t>((nib >> e) & 1u);
      }
      // eight lanes' nibbles make one word of the row's hit bitmap
      uint32_t w = nib << (4 * (lane & 7));
      w |= __shfl_xor_sync(kFull, w, 1);
      w |= __shfl_xor_sync(kFull, w, 2);
      w |= __shfl_xor_sync(kFull, w, 4);
      if ((lane & 7) == 0) piece_hits[row * kPieceWords + (tid >> 3)] = w;
    }
    __syncthreads();

    // warp w divides row w by this piece's hits, in pool order, in
    // batches of up to 32
    if (warp < live && r.n > 0) {
      const uint32_t word = piece_hits[warp * kPieceWords + lane];
      unsigned lanes = __ballot_sync(kFull, word != 0u);
      int have = 0;
      long long mine = 0;
      while (lanes) {
        const int src = __ffs(static_cast<int>(lanes)) - 1;
        lanes &= lanes - 1;
        uint32_t bits = __shfl_sync(kFull, word, src);
        while (bits) {
          const int b = __ffs(static_cast<int>(bits)) - 1;
          bits &= bits - 1;
          if (lane == have) mine = base + 32 * src + b;
          if (++have == 32) {
            divide_batch(r, p, mine, 32, lane);
            have = 0;
          }
        }
      }
      if (have) divide_batch(r, p, mine, have, lane);
    }
  }

  if (warp < live) {
    uint64_t* out = residual + (row0 + warp) * nl;
    for (int k = lane; k < nl; k += 32) out[k] = r.cur[k];
  }
}

}  // namespace

extern "C" int pfcs_factorize_limbs(const void* limbs, const void* p,
                                    void* mask, void* residual, long long n,
                                    long long np, int nl, void* stream) {
  if (n <= 0) return 0;
  if (nl <= 0) return static_cast<int>(cudaErrorInvalidValue);
  // rows a block: the most, up to 8, that still give every SM a block and
  // fit the shared memory
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  int shift = kMaxRowsLog2;
  while (shift > 0 && (((n + (1LL << shift) - 1) >> shift) < sms ||
                       4 * smem_words(1 << shift, nl) > kMaxSmem)) {
    --shift;
  }
  const size_t smem = 4 * smem_words(1 << shift, nl);
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = (n + (1LL << shift) - 1) >> shift;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  e = pfcs::allow_smem(factorize_limbs_kernel, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  factorize_limbs_kernel<<<static_cast<unsigned>(blocks), kThreads, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint64_t*>(limbs), static_cast<const long long*>(p),
      static_cast<uint8_t*>(mask), static_cast<uint64_t*>(residual), n, np, nl, 1 << shift);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* pfcs_factorize_limbs_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Elementwise gcd of multi-limb composite pairs by pool reconstruction:
// g_i = prod{p in pool : p > 1, p | a_i and p | b_i}, truncated to L limbs.
//
// Replaces src/repro/kernels/gcd.py::gcd_limbs_pallas (body
// _gcd_limbs_kernel), the shared-prefix gcd of wide registries: the
// cross-shard exchange of the sharded discovery path (chunks wider than
// int64) and VectorizedPagedKVCache.shared_prefix_bulk.
//
// Input: a, b (N, L) int64 little-endian 32-bit limbs in [0, 2**32),
// pool (P,) int64 in [0, 2**31), any entries, prime or not.  It equals
// gcd(a_i, b_i) when both are squarefree products of pool primes (the
// registry invariant), and the product of the common entries otherwise:
// a pair of zero rows gives the product of every entry > 1, pad rows of
// value 1 give 1.  Entries are multiplied in pool order, a duplicate
// entry once per occurrence, modulo 2**(32 L): the carry out of limb
// L - 1 is dropped, as the TPU kernel drops it.
//
// What bounds it on Hopper: the operations.  Per (pair, entry) one
// divisibility test of one side over its significant limbs, the other
// side's only where that one divides; per common entry one multiply over
// the product's limbs.  8 L bytes per row of a, b and g are few against
// that.  The old kernel took a 64-bit `%` per limb (Hopper has no integer
// divide) over all L limbs of both sides.  A Montgomery step is several
// integer instructions (an add with carry, a multiply, a wide
// multiply-add), which the bound counts as one operation, so long rows
// stay a few times above it.
//
// Design.
// - Arithmetic (limb_mod.cuh): the 32-bit Montgomery zero test over a
//   row's significant limbs; no `%` or `/` in any loop over rows or limbs.
// - A persistent grid of SMs x blocks-per-SM blocks.  Each block turns
//   the pool into constants {q, -q**-1, t, p} in shared memory once
//   (16 B an entry: 40 KB at 2560 entries) and keeps them for its life;
//   pools above 8192 entries (or above what shared memory holds beside
//   the warps' words) are taken in chunks, reloaded per pair (the block
//   then synchronises around each reload).
// - One warp per pair; each warp takes a contiguous run of pairs.  The
//   pair's limbs sit in shared memory; the lanes split the pool, lane l
//   taking entries l + 32 e of each 128-entry block, four Montgomery
//   chains at once sharing each limb load (a broadcast).
// - One side is tested against every entry, its mask kept as one ballot
//   word per 32-entry slice; the other side is tested only on the set
//   bits.  The common set does not depend on the order, so the kernel
//   takes the side whose mask it already holds (a row equal to the last
//   one tested in full), else a side equal to the previous pair's (it is
//   likely to repeat), else the side with fewer significant limbs.  On
//   the serving path a query chunk is paired with every cross composite
//   (shard.py: repeat_interleave against repeat), so a run of pairs
//   shares one side, whose mask is taken once per run.
// - The entries that divide the first side queue in pool order and are
//   tested on the second side 32 at a time, one a lane, so that the few
//   divisors of a long row do not each take a warp for one lane.
// - A ballot of the common entries, and the warp multiplies them in pool
//   order (the ballot's bit order): each lane takes a limb's product, and
//   the carries ripple up by one addition of the lanes' generate and
//   propagate masks, so a multiply is a few warp instructions at any
//   L <= 32 rather than L serial steps.
// Tensor cores (wgmma) do not apply: an integer remainder is no matrix
// product.
// Build (ptxas -v, sm_90a, as chip_smoke.py's build phase prints it): 64
// registers, no spills, no static shared memory; the dynamic shared
// memory is the pool's constants and each warp's words, about 21 KB at
// 1024 entries x 4 limbs and 51 KB at 2560 x 32.  PERF.md section 6
// keeps the report.

#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

#include "limb_mod.cuh"

namespace {

constexpr int kWarps = 8;                // pairs in flight per block, one per warp
constexpr int kThreads = 32 * kWarps;
constexpr long long kMaxChunk = 8192;    // pool entries in shared memory at once
constexpr long long kMaxSmem = 227 * 1024;
constexpr unsigned kAll = 0xffffffffu;

// g <- g * q mod 2**(32 nl) by the whole warp, lane l holding limb l in
// the register g0 and limbs 32 + l, 64 + l, ... in g: each lane forms its
// limb's product, adds the high word of the limb below, and the carries
// out of those sums ripple up by one 32-bit addition of the lanes'
// generate and propagate masks (a sum >= 2**32 generates a carry, a sum
// of 2**32 - 1 passes one on; never both, since every sum is
// < 2**32 + 2**31).  The carry out of the top limb is dropped.
__device__ __forceinline__ void mul_warp(uint32_t& g0, uint32_t* g, int nl, uint32_t q,
                                         int lane) {
  uint32_t below = 0;  // the high word and carry coming into lane 0's limb
  for (int k0 = 0; k0 < nl; k0 += 32) {
    const int k = k0 + lane;
    const uint32_t gk = k0 == 0 ? g0 : (k < nl ? g[k] : 0u);
    const uint64_t v = static_cast<uint64_t>(gk) * q;  // < 2**63
    const uint32_t hi = static_cast<uint32_t>(v >> 32);
    uint32_t up = __shfl_up_sync(kAll, hi, 1);
    if (lane == 0) up = below;
    const uint64_t sum = static_cast<uint64_t>(static_cast<uint32_t>(v)) + up;
    const unsigned gen = __ballot_sync(kAll, (sum >> 32) != 0);
    const unsigned prop = __ballot_sync(kAll, static_cast<uint32_t>(sum) == 0xffffffffu);
    const uint64_t ripple = static_cast<uint64_t>(gen) + (gen | prop);
    const unsigned carries = static_cast<unsigned>(ripple) ^ gen ^ (gen | prop);
    const uint32_t limb = static_cast<uint32_t>(sum) + ((carries >> lane) & 1u);
    if (k0 == 0) {
      g0 = k < nl ? limb : 0u;
    } else if (k < nl) {
      g[k] = limb;
    }
    below = __shfl_sync(kAll, hi, 31) + static_cast<uint32_t>(ripple >> 32);
  }
}

__device__ __forceinline__ void load_constants(uint4* consts,
                                               const long long* pool,
                                               long long c0, int width) {
  for (int j = threadIdx.x; j < width; j += kThreads)
    consts[j] = pfcs::entry_constants(pool[c0 + j]);
}

// Shared memory of one warp, in 32-bit words: the pair's a and b limbs,
// the product, the row whose mask is cached, the mask as a list of its
// nonzero 32-entry slices {slice, ballot word} in pool order, and up to
// 64 entries that divide the first side, waiting for the second test.
__host__ __device__ constexpr long long warp_words(int nl, long long chunk) {
  return 4LL * nl + 2 * ((chunk + 31) / 32) + 64;
}

__global__ void __launch_bounds__(kThreads)
gcd_limbs_kernel(const uint64_t* __restrict__ a, const uint64_t* __restrict__ b,
                 const long long* __restrict__ pool, uint64_t* __restrict__ out,
                 long long n, long long np, int nl, int chunk) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint4* consts = reinterpret_cast<uint4*>(smem);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  uint32_t* sa = reinterpret_cast<uint32_t*>(consts + chunk) + warp * warp_words(nl, chunk);
  uint32_t* sb = sa + nl;
  uint32_t* sg = sb + nl;
  uint32_t* cached = sg + nl;      // the row whose divisibility mask is listed
  uint2* listed = reinterpret_cast<uint2*>(cached + nl);  // {w, bits}: entry 32 w + l divides it
  uint32_t* pending = reinterpret_cast<uint32_t*>(listed + (chunk + 31) / 32);
  const bool whole = np <= chunk;  // the pool stays in shared memory
  if (whole) {
    load_constants(consts, pool, 0, static_cast<int>(np));
    __syncthreads();
  }
  // each warp takes a contiguous run of pairs, so that a row repeated on
  // consecutive pairs (a query chunk against every cross composite) has
  // its mask taken once; the count is the same for every warp, so that
  // the block can synchronise around a chunk reload
  const long long warps = static_cast<long long>(gridDim.x) * kWarps;
  const long long per = (n + warps - 1) / warps;
  const long long first_pair = (static_cast<long long>(blockIdx.x) * kWarps + warp) * per;
  bool have_mask = false;  // `listed` holds the mask of `cached` (whole pool)
  int n_listed = 0;        // the same in every lane
  for (long long t = 0; t < per; ++t) {
    const long long i = first_pair + t;
    const bool active = i < n;  // the same for the warp's 32 lanes
    uint32_t na = 0, nb = 0, tza = pfcs::kZeroRowTz, tzb = pfcs::kZeroRowTz;
    unsigned diff_a = 0, diff_b = 0, new_a = 0, new_b = 0;
    uint32_t g0 = lane == 0 ? 1u : 0u;  // the product's limb `lane`; limbs >= 32 in sg
    if (active) {
      for (int k0 = 0; k0 < nl; k0 += 32) {
        const int k = k0 + lane;
        uint32_t va = 0, vb = 0, vc = 0, pa = 0, pb = 0;
        if (k < nl) {
          va = static_cast<uint32_t>(a[i * nl + k]);
          vb = static_cast<uint32_t>(b[i * nl + k]);
          vc = cached[k];
          pa = sa[k];  // the previous pair's rows
          pb = sb[k];
          sa[k] = va;
          sb[k] = vb;
          sg[k] = 0u;
        }
        diff_a |= __ballot_sync(kAll, va != vc);
        diff_b |= __ballot_sync(kAll, vb != vc);
        new_a |= __ballot_sync(kAll, va != pa);
        new_b |= __ballot_sync(kAll, vb != pb);
        pfcs::fold_limb_slice(va, k0, na, tza);
        pfcs::fold_limb_slice(vb, k0, nb, tzb);
      }
      __syncwarp();
    }
    // The side tested against every entry: the one whose mask is cached;
    // else a side that repeats the previous pair's (it is likely to
    // repeat again, and its mask is then reused); else the side with
    // fewer significant limbs.  The other side is tested only on the
    // entries that divide the first.
    const bool hit_a = have_mask && diff_a == 0;
    const bool hit_b = have_mask && !hit_a && diff_b == 0;
    const bool hit = hit_a || hit_b;
    const bool a_first = hit ? hit_a : new_a == 0 || (new_b != 0 && na <= nb);
    const uint32_t* first = a_first ? sa : sb;
    const uint32_t* second = a_first ? sb : sa;
    const uint32_t n1 = a_first ? na : nb, tz1 = a_first ? tza : tzb;
    const uint32_t n2 = a_first ? nb : na, tz2 = a_first ? tzb : tza;
    for (long long c0 = 0; c0 < np; c0 += chunk) {
      const int width = static_cast<int>(min(static_cast<long long>(chunk), np - c0));
      if (!whole) {
        __syncthreads();  // every warp is done with the previous chunk
        load_constants(consts, pool, c0, width);
        __syncthreads();
      }
      if (!active) continue;
      // The entries that divide the first side queue in pool order; 32 at
      // a time, one a lane, they test the second side, and the common
      // ones are multiplied in as the ballot orders them.
      int n_pending = 0;  // the same in every lane
      auto test_pending = [&](int count) {
        uint4 k = pfcs::no_entry();
        bool common = false;
        if (lane < count) {
          k = consts[pending[lane]];
          common = pfcs::entry_divides<1>(k, second, n2, tz2);
        }
        unsigned hits = __ballot_sync(kAll, common);
        while (hits) {
          const uint32_t q = __shfl_sync(kAll, k.w, __ffs(static_cast<int>(hits)) - 1);
          mul_warp(g0, sg, nl, q, lane);
          hits &= hits - 1;
        }
      };
      auto second_side = [&](int slice, unsigned bits) {
        if ((bits >> lane) & 1u)
          pending[n_pending + __popc(bits & ((1u << lane) - 1u))] = 32 * slice + lane;
        n_pending += __popc(bits);
        __syncwarp();
        if (n_pending >= 32) {
          test_pending(32);
          const uint32_t rest = lane + 32 < n_pending ? pending[lane + 32] : 0u;
          __syncwarp();
          pending[lane] = rest;
          n_pending -= 32;
          __syncwarp();
        }
      };
      if (hit) {
        for (int x = 0; x < n_listed; ++x) {
          const uint2 e = listed[x];
          second_side(static_cast<int>(e.x), e.y);
        }
      } else {
        // the first side against every entry, four 32-entry slices at a
        // time: lane l takes entries j0 + l, j0 + 32 + l, j0 + 64 + l,
        // j0 + 96 + l
        n_listed = 0;
        for (int j0 = 0; j0 < width; j0 += 128) {
          uint4 kq[4];
          uint32_t s[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int j = j0 + 32 * e + lane;
            kq[e] = j < width ? consts[j] : pfcs::no_entry();
          }
          pfcs::residues4<1>(first, n1, kq, s);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const unsigned bits = __ballot_sync(kAll, pfcs::entry_settles(kq[e], s[e], tz1));
            if (bits == 0) continue;
            const int slice = (j0 >> 5) + e;
            if (lane == 0) listed[n_listed] = make_uint2(static_cast<uint32_t>(slice), bits);
            ++n_listed;
            second_side(slice, bits);
          }
        }
      }
      if (n_pending > 0) test_pending(n_pending);
      if (!hit) {
        for (int k = lane; k < nl; k += 32) cached[k] = first[k];
        have_mask = whole;
        __syncwarp();
      }
    }
    if (active) {
      __syncwarp();  // every lane done with sa, sb before the next pair
      for (int k = lane; k < nl; k += 32) out[i * nl + k] = k < 32 ? g0 : sg[k];
    }
  }
}

}  // namespace

extern "C" int pfcs_gcd_limbs(const void* a, const void* b, const void* pool,
                              void* out, long long n, long long np, int nl,
                              void* stream) {
  if (n <= 0) return 0;
  if (nl <= 0 || np < 0) return static_cast<int>(cudaErrorInvalidValue);
  // the largest chunk (at most kMaxChunk entries) whose constants fit
  // beside the warps' words
  long long chunk = std::min(std::max(np, 1LL), kMaxChunk);
  auto smem_of = [&](long long c) {
    return c * 16 + kWarps * warp_words(nl, c) * 4LL;
  };
  while (chunk > 1 && smem_of(chunk) > kMaxSmem) chunk /= 2;
  if (smem_of(chunk) > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(smem_of(chunk));
  cudaError_t e = pfcs::allow_smem(gcd_limbs_kernel, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long blocks = pfcs::persistent_blocks(gcd_limbs_kernel, kThreads, smem, e);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long grid = std::min((n + kWarps - 1) / kWarps, blocks);
  gcd_limbs_kernel<<<static_cast<unsigned>(grid), kThreads, smem,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint64_t*>(a), static_cast<const uint64_t*>(b),
      static_cast<const long long*>(pool), static_cast<uint64_t*>(out), n, np,
      nl, static_cast<int>(chunk));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* pfcs_gcd_limbs_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

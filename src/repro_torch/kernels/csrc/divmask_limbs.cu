// Divisibility mask of multi-limb composites:
// mask[i, j] = p_j > 1 && p_j divides the composite held in limb row i.
//
// Replaces src/repro/kernels/factorize.py::divisibility_mask_limbs_pallas
// (bodies _divmask_limbs_kernel and _horner_mod), the section 4.2
// registry scan of wide registries (max_bits > 63): the sharded
// discovery path, successor_table(discover="kernel") and case_scale.
//
// Input: (N, L) int64 little-endian 32-bit limbs (every value in
// [0, 2**32)), primes (P,) int64 in [0, 2**31); any entry is taken as
// it is, prime or not.  An all-zero row is divisible by every entry > 1;
// entries <= 1 never divide (pad with 0).
//
// What bounds it on Hopper.  At the million-row scan (991,832 rows x 32
// limbs x 359 primes) the bytes on paper: 254 MB of limbs in and 356 MB
// of mask out, against 0.73 G needed limb steps, since the rows there
// are 1- or 2-limb values held in 32 limbs; in practice the integer
// instructions around each of the 356 M (row, prime) elements (its
// constants, the test, the mask byte), a few times the bytes' time.  At
// `kernel_check`'s random 32-limb rows the Montgomery steps (several
// integer instructions each).  At the serving shapes (1024 rows x 4 to
// 32 limbs x 1024 primes) the launch.  The old kernel took a 64-bit `%`
// per limb (Hopper has no integer divide) over all L limbs, leading
// zeros included.
//
// Design.
// - Arithmetic (limb_mod.cuh): a 32-bit Montgomery zero test per (row,
//   entry), over the row's significant limbs only, least-significant
//   first; the power of two of an even entry is tested against the row's
//   trailing zero bits.  No `%` or `/` in any loop over rows or limbs.
// - A persistent grid of SMs x blocks-per-SM blocks walks tiles of R rows
//   x all P columns (R from the shared-memory budget, at most 32, and
//   small enough to give each SM two tiles).  Such a tile's mask is one
//   contiguous span of R x P bytes.
// - The limb tiles stream through a two-stage ring in shared memory by
//   cp.async (8-byte copies: int64 rows are 8-byte aligned at any row, so
//   a ragged last tile needs no other path; 16-byte copies measured no
//   faster); tile k + 1 is in flight while tile k is tested.
// - Each entry's constants {q, -q**-1, t, p} sit in shared memory for the
//   block's life, in groups of four; each row's significant-limb and
//   trailing-zero counts are taken once per tile, one warp per row, by
//   ballot.
// - A thread tests one row against a group of four consecutive entries:
//   four independent Montgomery chains share each limb load, and the
//   warp's 32 threads on one row read its limbs as a broadcast and 32
//   consecutive groups' constants.  Each writes its mask bytes into
//   shared memory, and the block then writes the span with 16-byte
//   stores (the shared buffer is offset so that its 16-byte words fall on
//   the span's), the unaligned head and tail bytes one at a time.
// - More than 4096 entries are taken in column pieces of 4096 with R = 1,
//   so that every span stays contiguous.
// Tensor cores (wgmma) do not apply: an integer remainder is no matrix
// product.
// Build (ptxas -v, sm_90a, as chip_smoke.py's build phase prints it): 64
// registers, no spills, no static shared memory; the dynamic shared
// memory is two limb stages, the constants, the row counts and the mask
// tile, about 34 KB at the million-row scan.  PERF.md section 6 keeps
// the report.

#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

#include "limb_mod.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxRows = 32;             // limb rows per tile
constexpr int kMaxCols = 4096;           // entries per column piece
constexpr int kMaskBytes = 32 * 1024;    // a tile's mask in shared memory
constexpr int kStageBytes = 8 * 1024;    // one stage of the limb ring
constexpr size_t kMaxSmem = 227 * 1024;

__host__ __device__ constexpr size_t round16(size_t x) { return (x + 15) & ~size_t{15}; }

// Column groups of four entries: a thread tests one row against a group,
// the four Montgomery chains sharing each limb load.
__host__ __device__ constexpr int groups_of(int cols) { return (cols + 3) / 4; }

struct Smem {
  size_t stage, consts, meta, mask, total;
  __host__ __device__ Smem(int rows, int cols, int nl)
      : stage(round16(static_cast<size_t>(rows) * nl * 8)),
        consts(static_cast<size_t>(groups_of(cols)) * 4 * 16),
        meta(round16(static_cast<size_t>(rows) * 8)),
        mask(round16(static_cast<size_t>(rows) * cols + 16)),
        total(2 * stage + consts + meta + mask) {}
};

__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Starts the copy of row tile `tile` (rows tile * R .. , ragged at N)
// into `dst`.
__device__ __forceinline__ void stage_tile(uint64_t* dst, const uint64_t* limbs,
                                           long long tile, int rows_per_tile,
                                           long long n, int nl) {
  const long long r0 = tile * rows_per_tile;
  const long long rows = min(static_cast<long long>(rows_per_tile), n - r0);
  const int words = static_cast<int>(rows * nl);
  const uint64_t* src = limbs + r0 * nl;
  for (int i = threadIdx.x; i < words; i += kThreads) cp_async8(dst + i, src + i);
}

// The constants of entries c0 .. c0 + width - 1 in group-major order:
// entry c0 + 4 g + e at consts[e * groups + g], so that the 32 lanes of a
// warp, on 32 consecutive groups, read 32 consecutive 16-byte words;
// the slots past width hold an entry that never divides.
__device__ __forceinline__ void load_constants(uint4* consts, const long long* p,
                                               long long c0, int width) {
  const int groups = groups_of(width);
  for (int j = threadIdx.x; j < 4 * groups; j += kThreads)
    consts[(j & 3) * groups + (j >> 2)] =
        j < width ? pfcs::entry_constants(p[c0 + j]) : pfcs::no_entry();
}

// Copies buf[shift, shift + len) to gbase[shift, shift + len); gbase and
// buf are 16-byte aligned, so their 16-byte words coincide.
__device__ __forceinline__ void write_span(unsigned char* gbase,
                                           const unsigned char* buf, int shift,
                                           int len) {
  const int end = shift + len;
  const int body0 = min((shift + 15) & ~15, end);
  const int body1 = max(end & ~15, body0);
  for (int o = shift + threadIdx.x; o < body0; o += kThreads) gbase[o] = buf[o];
  for (int o = body1 + threadIdx.x; o < end; o += kThreads) gbase[o] = buf[o];
  uint4* g16 = reinterpret_cast<uint4*>(gbase + body0);
  const uint4* s16 = reinterpret_cast<const uint4*>(buf + body0);
  for (int w = threadIdx.x; w < (body1 - body0) / 16; w += kThreads) g16[w] = s16[w];
}

__global__ void __launch_bounds__(kThreads)
divmask_limbs_kernel(const uint64_t* __restrict__ limbs,
                     const long long* __restrict__ p,
                     unsigned char* __restrict__ mask, long long n,
                     long long np, int nl, int rows_per_tile, int cols) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Smem lay(rows_per_tile, cols, nl);
  uint4* consts = reinterpret_cast<uint4*>(smem + 2 * lay.stage);
  uint2* meta = reinterpret_cast<uint2*>(smem + 2 * lay.stage + lay.consts);
  unsigned char* buf = smem + 2 * lay.stage + lay.consts + lay.meta;
  auto ring = [&](int s) { return reinterpret_cast<uint64_t*>(smem + s * lay.stage); };
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const long long tiles = (n + rows_per_tile - 1) / rows_per_tile;
  const int pieces = static_cast<int>((np + cols - 1) / cols);

  // a piece `width` entries wide: its column groups, where thread tid's
  // (row, group) units start, and how far a stride of kThreads units
  // moves in rows and groups
  int width = cols, groups = groups_of(cols);
  int r_first = tid / groups, g_first = tid % groups;
  int dr = kThreads / groups, dg = kThreads % groups;
  if (pieces == 1) load_constants(consts, p, 0, width);

  long long tile = blockIdx.x;
  if (tile < tiles) stage_tile(ring(0), limbs, tile, rows_per_tile, n, nl);
  cp_async_commit();
  for (int k = 0; tile < tiles; ++k, tile += gridDim.x) {
    const long long next = tile + gridDim.x;
    if (next < tiles) stage_tile(ring((k + 1) & 1), limbs, next, rows_per_tile, n, nl);
    cp_async_commit();
    cp_async_wait_one();  // every group but the newest: this tile's copy
    __syncthreads();
    const uint64_t* cur = ring(k & 1);
    const long long r0 = tile * rows_per_tile;
    const int rows = static_cast<int>(min(static_cast<long long>(rows_per_tile), n - r0));
    for (int r = warp; r < rows; r += kWarps) {
      uint32_t top = 0, tz = pfcs::kZeroRowTz;
      for (int k0 = 0; k0 < nl; k0 += 32) {
        const int kk = k0 + lane;
        const uint32_t v = kk < nl ? static_cast<uint32_t>(cur[r * nl + kk]) : 0u;
        pfcs::fold_limb_slice(v, k0, top, tz);
      }
      if (lane == 0) meta[r] = make_uint2(top, tz);
    }
    for (int piece = 0; piece < pieces; ++piece) {
      const long long c0 = static_cast<long long>(piece) * cols;
      if (pieces > 1) {
        width = static_cast<int>(min(static_cast<long long>(cols), np - c0));
        groups = groups_of(width);
        r_first = tid / groups, g_first = tid % groups;
        dr = kThreads / groups, dg = kThreads % groups;
        load_constants(consts, p, c0, width);
      }
      // the row counts, the constants, and the previous span's write done
      __syncthreads();
      const long long start = r0 * np + c0;
      const int len = rows * width;
      const int shift = static_cast<int>(reinterpret_cast<uintptr_t>(mask + start) & 15);
      int r = r_first, g = g_first;
      for (int u = tid; u < rows * groups; u += kThreads) {
        const uint2 m = meta[r];
        const uint32_t* row = reinterpret_cast<const uint32_t*>(cur + r * nl);
        uint4 kq[4];
        uint32_t s[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) kq[e] = consts[e * groups + g];
        pfcs::residues4<2>(row, m.x, kq, s);
        unsigned char* out = buf + shift + r * width + 4 * g;
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (4 * g + e < width) out[e] = pfcs::entry_settles(kq[e], s[e], m.y);
        g += dg;
        r += dr;
        if (g >= groups) {
          g -= groups;
          ++r;
        }
      }
      __syncthreads();
      write_span(mask + start - shift, buf, shift, len);
    }
  }
}

}  // namespace

extern "C" int pfcs_divmask_limbs(const void* limbs, const void* p, void* mask,
                                  long long n, long long np, int nl,
                                  void* stream) {
  if (n <= 0 || np <= 0) return 0;
  if (nl <= 0) return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int cols = static_cast<int>(std::min<long long>(np, kMaxCols));
  long long rows = 1;
  if (np <= kMaxCols) {  // else one row per tile, so that each piece is one span
    rows = std::min<long long>(kMaxRows, (n + 2LL * sms - 1) / (2LL * sms));
    rows = std::min<long long>(rows, kMaskBytes / cols);
    rows = std::max<long long>(1, std::min<long long>(rows, kStageBytes / (8 * nl)));
  }
  const size_t smem = Smem(static_cast<int>(rows), cols, nl).total;
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  e = pfcs::allow_smem(divmask_limbs_kernel, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long blocks = pfcs::persistent_blocks(divmask_limbs_kernel, kThreads, smem, e);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long tiles = (n + rows - 1) / rows;
  const unsigned grid = static_cast<unsigned>(std::min(tiles, blocks));
  divmask_limbs_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint64_t*>(limbs), static_cast<const long long*>(p),
      static_cast<unsigned char*>(mask), n, np, nl, static_cast<int>(rows), cols);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* pfcs_divmask_limbs_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

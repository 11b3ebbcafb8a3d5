// Divisibility mask of multi-limb composites:
// mask[i, j] = p_j > 1 && p_j divides the composite held in limb row i.
//
// Replaces src/repro/kernels/factorize.py::divisibility_mask_limbs_pallas
// (bodies _divmask_limbs_kernel and _horner_mod), the section 4.2
// registry scan of wide registries (max_bits > 63): the sharded
// discovery path, successor_table(discover="kernel") and case_scale.
//
// Input: (N, L) int64 little-endian 32-bit limbs (every value in
// [0, 2**32)), primes (P,) int64 in [0, 2**31).  The remainder is taken
// by Horner's rule, most-significant limb first:
//   r = (r * 2**32 + limb) mod p,   r < p < 2**31  =>  r * 2**32 + limb < 2**63
// so it is exact in unsigned 64-bit arithmetic.  An all-zero row is
// divisible by every prime > 1; primes <= 1 never divide (pad with 0).
//
// What bounds it on Hopper: the modulo.  There is no integer-divide
// instruction, so each of the L steps per (row, prime) is a software
// 64-bit remainder sequence, while the bytes are L words per row, one
// word per prime and one mask byte per pair.  N * P * L remainders
// against (8 L N + 8 P + N P) bytes: the operations bound it from L = 2.
//
// Design.  Each output element is independent: a 2-D grid with no
// carried state.  blockIdx.x walks tiles of kRows limb rows, blockIdx.y
// tiles of kCols primes.  The block stages its rows' limbs in shared
// memory as 32-bit words; thread t owns prime column t and walks the
// kRows rows, reading each limb from the same shared address as every
// other thread of the block (a broadcast).  The mask write is one byte
// per thread, consecutive threads on consecutive addresses.  Reciprocal
// remainders are later speed work.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kCols = 256;  // threads per block: one prime column each
constexpr int kRows = 32;   // limb rows per block

__global__ void divmask_limbs_kernel(const uint64_t* __restrict__ limbs,
                                     const uint64_t* __restrict__ p,
                                     bool* __restrict__ mask,
                                     long long n, long long np, int nl) {
  extern __shared__ uint32_t c_tile[];  // [kRows][nl]
  const long long row0 = static_cast<long long>(blockIdx.x) * kRows;
  const long long col = static_cast<long long>(blockIdx.y) * kCols + threadIdx.x;
  const int rows = static_cast<int>(min(static_cast<long long>(kRows), n - row0));
  for (int i = threadIdx.x; i < rows * nl; i += kCols) {
    c_tile[i] = static_cast<uint32_t>(limbs[row0 * nl + i]);
  }
  __syncthreads();
  if (col >= np) return;
  const uint64_t pj = p[col];
  const bool live = pj > 1;
  bool* out = mask + row0 * np + col;
  for (int r = 0; r < rows; ++r) {
    bool d = false;
    if (live) {
      const uint32_t* row = c_tile + r * nl;
      uint64_t rem = 0;
      for (int k = nl - 1; k >= 0; --k) {
        rem = ((rem << 32) | row[k]) % pj;
      }
      d = rem == 0;
    }
    out[r * np] = d;
  }
}

}  // namespace

extern "C" int pfcs_divmask_limbs(const void* limbs, const void* p, void* mask,
                                  long long n, long long np, int nl,
                                  void* stream) {
  if (n <= 0 || np <= 0) return 0;
  if (nl <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long col_tiles = (np + kCols - 1) / kCols;
  if (col_tiles > 65535) return static_cast<int>(cudaErrorInvalidConfiguration);
  const size_t smem = static_cast<size_t>(kRows) * nl * sizeof(uint32_t);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        divmask_limbs_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid(static_cast<unsigned>((n + kRows - 1) / kRows),
                  static_cast<unsigned>(col_tiles));
  divmask_limbs_kernel<<<grid, kCols, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint64_t*>(limbs), static_cast<const uint64_t*>(p),
      static_cast<bool*>(mask), n, np, nl);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* pfcs_divmask_limbs_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

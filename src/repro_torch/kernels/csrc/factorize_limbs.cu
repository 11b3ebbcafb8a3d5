// Squarefree factorization of multi-limb composites against a prime
// pool: the limb divisibility mask mask[i, j] = p_j > 1 && p_j | c_i,
// and the residual limbs of c_i after each dividing prime has been
// divided out once.
//
// Replaces src/repro/kernels/factorize.py::factorize_limbs_pallas
// (bodies _factorize_limbs_kernel and _short_div), Algorithm 2 stage 1
// on wide registries as ops.factorize_batch_exact runs it: the decode of
// successor_table(discover="kernel"), of shared-prefix gcds wider than
// int64, and case_scale's differential check.
//
// Input as in divmask_limbs.cu: (N, L) int64 limbs in [0, 2**32),
// primes (P,) int64 in [0, 2**31).  The mask is taken on the INPUT
// limbs, so each dividing prime is divided out exactly once, by short
// division, most-significant limb first:
//   cur = carry * 2**32 + limb,  q = cur / p,  carry = cur - q p
// with carry < p < 2**31, so cur < 2**63 and q < 2**32; the final carry
// (the remainder) is discarded.  Floor divisions compose, so the order
// of the dividing primes does not change the residual.  A non-squarefree
// input keeps its repeated factor; an all-zero row is divisible by every
// prime > 1 and stays zero.
//
// What bounds it on Hopper: the modulo (no integer-divide instruction):
// L remainders per (row, prime) for the mask, plus L divisions per hit.
//
// Design.  The TPU kernel carries the residual across its sequential
// prime-tile grid axis; CUDA blocks run in no order, so one block owns
// kRows limb rows and loops over every prime tile itself.  The input
// limbs and the residual limbs of its rows live in shared memory as
// 32-bit words.  Per tile, thread t tests prime column t against the
// kRows rows by Horner's rule (shared-memory broadcast), writes the mask
// byte, and a warp ballot turns the 32 answers of each warp into one
// word of a per-row bitmap.  Thread r < kRows then walks only the set
// bits of its row (__ffs) and short-divides its residual by each hit.
// An all-zero input row skips the walk.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;            // one prime column per thread
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 8;                 // limb rows per block

__global__ void factorize_limbs_kernel(const uint64_t* __restrict__ limbs,
                                       const uint64_t* __restrict__ p,
                                       bool* __restrict__ mask,
                                       uint64_t* __restrict__ residual,
                                       long long n, long long np, int nl) {
  extern __shared__ uint32_t smem[];
  uint32_t* c_tile = smem;                 // [kRows][nl] input limbs
  uint32_t* r_tile = smem + kRows * nl;    // [kRows][nl] residual limbs
  __shared__ uint64_t p_tile[kThreads];
  __shared__ unsigned bits[kRows][kWarps];
  __shared__ int nonzero[kRows];
  const long long row0 = static_cast<long long>(blockIdx.x) * kRows;
  const int rows = static_cast<int>(min(static_cast<long long>(kRows), n - row0));
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (threadIdx.x < kRows) nonzero[threadIdx.x] = 0;
  __syncthreads();
  for (int i = threadIdx.x; i < kRows * nl; i += kThreads) {
    // rows past the end hold value 1: they divide by nothing
    const uint32_t v = i < rows * nl
                           ? static_cast<uint32_t>(limbs[row0 * nl + i])
                           : static_cast<uint32_t>(i % nl == 0);
    c_tile[i] = v;
    r_tile[i] = v;
    if (v != 0) nonzero[i / nl] = 1;
  }
  __syncthreads();
  for (long long col0 = 0; col0 < np; col0 += kThreads) {
    const long long col = col0 + threadIdx.x;
    const uint64_t pj = col < np ? p[col] : 0;
    p_tile[threadIdx.x] = pj;
    const bool live = pj > 1;
    for (int r = 0; r < kRows; ++r) {
      bool d = false;
      if (live) {
        const uint32_t* row = c_tile + r * nl;
        uint64_t rem = 0;
        for (int k = nl - 1; k >= 0; --k) {
          rem = ((rem << 32) | row[k]) % pj;
        }
        d = rem == 0;
      }
      if (col < np && r < rows) mask[(row0 + r) * np + col] = d;
      const unsigned b = __ballot_sync(0xffffffffu, d);
      if (lane == 0) bits[r][warp] = b;
    }
    __syncthreads();
    if (threadIdx.x < kRows && nonzero[threadIdx.x]) {
      uint32_t* res = r_tile + threadIdx.x * nl;
      for (int w = 0; w < kWarps; ++w) {
        unsigned b = bits[threadIdx.x][w];
        while (b) {
          const uint64_t q = p_tile[w * 32 + __ffs(b) - 1];
          uint64_t carry = 0;
          for (int k = nl - 1; k >= 0; --k) {
            const uint64_t cur = (carry << 32) | res[k];
            const uint64_t quo = cur / q;
            carry = cur - quo * q;
            res[k] = static_cast<uint32_t>(quo);
          }
          b &= b - 1;
        }
      }
    }
    __syncthreads();
  }
  for (int i = threadIdx.x; i < rows * nl; i += kThreads) {
    residual[row0 * nl + i] = r_tile[i];
  }
}

}  // namespace

extern "C" int pfcs_factorize_limbs(const void* limbs, const void* p,
                                    void* mask, void* residual, long long n,
                                    long long np, int nl, void* stream) {
  if (n <= 0) return 0;
  if (nl <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = 2 * static_cast<size_t>(kRows) * nl * sizeof(uint32_t);
  if (smem > 40 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        factorize_limbs_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid(static_cast<unsigned>((n + kRows - 1) / kRows));
  factorize_limbs_kernel<<<grid, kThreads, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint64_t*>(limbs), static_cast<const uint64_t*>(p),
      static_cast<bool*>(mask), static_cast<uint64_t*>(residual), n, np, nl);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* pfcs_factorize_limbs_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

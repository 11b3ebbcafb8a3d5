// Divisibility mask: mask[i, j] = p_j > 1 && c_i % p_j == 0.
//
// Replaces src/repro/kernels/factorize.py::divisibility_mask_pallas
// (body _divmask_kernel), the section 4.2 registry scan of the sharded
// discovery path and of successor_table(discover="kernel").
//
// What bounds it on Hopper: the modulo.  Hopper has no integer-divide
// instruction, so every `%` is a software sequence (a reciprocal
// estimate plus correction steps: about 20 instructions for 32 bits and
// several times that for 64), while the bytes are one composite and one
// prime per row and column plus one mask byte per pair.  The kernel is
// therefore built to keep every thread on modulo work: no thread waits
// on a load after the tile is staged, and the mask write is one byte per
// thread, consecutive threads on consecutive addresses.
//
// Design.  Each output element is independent, so the grid is 2-D with
// no carried state: blockIdx.x walks tiles of kRows composites,
// blockIdx.y tiles of kCols primes.  The block stages both tiles in
// shared memory, then thread t owns prime column t of its tile and
// loops over the kRows composites, which every thread reads from the
// same shared address (a broadcast).  Values are non-negative by
// contract, so they are reinterpreted as unsigned: unsigned `%` is the
// cheaper sequence, and it equals the floor modulo of the reference on
// non-negative operands (CUDA's signed `%` truncates toward zero).
// Primes <= 1 never divide, so padding with 0 is safe.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kCols = 256;  // threads per block: one prime column each
constexpr int kRows = 32;   // composites per block

template <typename U>
__global__ void divmask_kernel(const U* __restrict__ c,
                               const U* __restrict__ p,
                               bool* __restrict__ mask,
                               long long n, long long np) {
  __shared__ U c_tile[kRows];
  __shared__ U p_tile[kCols];
  const long long row0 = static_cast<long long>(blockIdx.x) * kRows;
  const long long col = static_cast<long long>(blockIdx.y) * kCols + threadIdx.x;
  if (threadIdx.x < kRows) {
    const long long r = row0 + threadIdx.x;
    c_tile[threadIdx.x] = r < n ? c[r] : U(1);
  }
  p_tile[threadIdx.x] = col < np ? p[col] : U(0);
  __syncthreads();
  if (col >= np) return;
  const U pj = p_tile[threadIdx.x];
  const bool live = pj > U(1);
  const U safe = live ? pj : U(1);
  const int rows = static_cast<int>(min(static_cast<long long>(kRows), n - row0));
  bool* out = mask + row0 * np + col;
  for (int r = 0; r < rows; ++r) {
    out[r * np] = live && (c_tile[r] % safe == U(0));
  }
}

}  // namespace

extern "C" int pfcs_divmask(const void* c, const void* p, void* mask,
                            long long n, long long np, int elem_bytes,
                            void* stream) {
  if (n <= 0 || np <= 0) return 0;
  const long long col_tiles = (np + kCols - 1) / kCols;
  if (col_tiles > 65535) return static_cast<int>(cudaErrorInvalidConfiguration);
  const dim3 grid(static_cast<unsigned>((n + kRows - 1) / kRows),
                  static_cast<unsigned>(col_tiles));
  auto s = static_cast<cudaStream_t>(stream);
  if (elem_bytes == 4) {
    divmask_kernel<uint32_t><<<grid, kCols, 0, s>>>(
        static_cast<const uint32_t*>(c), static_cast<const uint32_t*>(p),
        static_cast<bool*>(mask), n, np);
  } else if (elem_bytes == 8) {
    divmask_kernel<uint64_t><<<grid, kCols, 0, s>>>(
        static_cast<const uint64_t*>(c), static_cast<const uint64_t*>(p),
        static_cast<bool*>(mask), n, np);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* pfcs_divmask_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Squarefree factorization against a prime pool: the divisibility mask
// mask[i, j] = p_j > 1 && c_i % p_j == 0, plus the residual
// c_i / prod{p_j : mask[i, j]} (1 when the pool factors c_i fully).
//
// Replaces src/repro/kernels/factorize.py::factorize_squarefree_pallas
// (body _factorize_kernel), Algorithm 2 stage 1 as
// ops.factorize_batch_exact runs it to decode registry hits and the gcd
// hits of the sharded exchange.
//
// What bounds it on Hopper: the modulo, as in divmask.cu (no integer
// divide instruction; `%` and `/` are software sequences).  The bytes are
// one mask byte per pair plus one word per row and per prime.
//
// Design.  The TPU kernel carries the residual across the sequential
// prime-tile grid axis.  CUDA blocks run in no order, so here one block
// owns kRows composites and loops over every prime tile itself; the
// residual lives in a register of thread r < kRows for the whole loop.
// Per tile, thread t tests prime column t against the kRows composites
// (shared-memory broadcast), writes the mask byte, and a warp ballot
// turns the 32 answers of each warp into one word of a per-row bitmap
// in shared memory.  Thread r then walks only the set bits of its row
// (__ffs) and divides its residual by each dividing prime in turn.
// Floor division composes (floor(floor(c/a)/b) == floor(c/(a*b)) for
// positive integers), so this equals the reference's c // prod without
// ever forming the product, which cannot overflow here.  A residual of
// c = 0 stays 0 without a walk (every prime divides 0, so the walk would
// be one serial division per pool prime) and pad rows (c = 1) stay 1.
// Values are non-negative by contract and handled as unsigned (see
// divmask.cu).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;            // one prime column per thread
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 8;                 // composites per block

template <typename U>
__global__ void factorize_kernel(const U* __restrict__ c,
                                 const U* __restrict__ p,
                                 bool* __restrict__ mask,
                                 U* __restrict__ residual,
                                 long long n, long long np) {
  __shared__ U c_tile[kRows];
  __shared__ U p_tile[kThreads];
  __shared__ unsigned bits[kRows][kWarps];
  const long long row0 = static_cast<long long>(blockIdx.x) * kRows;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (threadIdx.x < kRows) {
    const long long r = row0 + threadIdx.x;
    c_tile[threadIdx.x] = r < n ? c[r] : U(1);
  }
  __syncthreads();
  U res = threadIdx.x < kRows ? c_tile[threadIdx.x] : U(0);
  for (long long col0 = 0; col0 < np; col0 += kThreads) {
    const long long col = col0 + threadIdx.x;
    const U pj = col < np ? p[col] : U(0);
    p_tile[threadIdx.x] = pj;
    const bool live = pj > U(1);
    const U safe = live ? pj : U(1);
    for (int r = 0; r < kRows; ++r) {
      const bool d = live && (c_tile[r] % safe == U(0));
      if (col < np && row0 + r < n) mask[(row0 + r) * np + col] = d;
      const unsigned b = __ballot_sync(0xffffffffu, d);
      if (lane == 0) bits[r][warp] = b;
    }
    __syncthreads();
    if (threadIdx.x < kRows && res != U(0)) {   // every prime divides 0
      for (int w = 0; w < kWarps; ++w) {
        unsigned b = bits[threadIdx.x][w];
        while (b) {
          res /= p_tile[w * 32 + __ffs(b) - 1];
          b &= b - 1;
        }
      }
    }
    __syncthreads();
  }
  if (threadIdx.x < kRows && row0 + threadIdx.x < n) {
    residual[row0 + threadIdx.x] = res;
  }
}

}  // namespace

extern "C" int pfcs_factorize(const void* c, const void* p, void* mask,
                              void* residual, long long n, long long np,
                              int elem_bytes, void* stream) {
  if (n <= 0) return 0;
  const dim3 grid(static_cast<unsigned>((n + kRows - 1) / kRows));
  auto s = static_cast<cudaStream_t>(stream);
  if (elem_bytes == 4) {
    factorize_kernel<uint32_t><<<grid, kThreads, 0, s>>>(
        static_cast<const uint32_t*>(c), static_cast<const uint32_t*>(p),
        static_cast<bool*>(mask), static_cast<uint32_t*>(residual), n, np);
  } else if (elem_bytes == 8) {
    factorize_kernel<uint64_t><<<grid, kThreads, 0, s>>>(
        static_cast<const uint64_t*>(c), static_cast<const uint64_t*>(p),
        static_cast<bool*>(mask), static_cast<uint64_t*>(residual), n, np);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* pfcs_factorize_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

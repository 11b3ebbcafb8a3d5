// Elementwise gcd of pairs (a_i, b_i), with gcd(x, 0) = x.
//
// Replaces src/repro/kernels/gcd.py::gcd_pallas (body _gcd_kernel), the
// batched gcd of the sharded cross-shard exchange and of
// VectorizedPagedKVCache.shared_prefix_bulk.
//
// What bounds it on Hopper: the modulo of each Euclid step (no integer
// divide instruction; a 64-bit `%` is a long software sequence).  The
// bytes are three words per pair, so the kernel is operation-bound
// unless pairs are trivial.
//
// Design.  One thread per pair, grid-stride.  The TPU kernel runs a fixed
// 48 (int32) or 96 (int64) trips so that its vector lanes stay in step;
// a CUDA thread simply loops until b == 0, which gives the same result
// (Euclid has converged once b is 0, and the fixed-trip body leaves
// (a, 0) unchanged).  Divergence inside a warp costs at most the longest
// chain of its 32 pairs.  Values are non-negative by contract and handled
// as unsigned (see divmask.cu).  Binary gcd with __ffsll would trade the
// modulo for shifts; that is later speed work.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;

template <typename U>
__global__ void gcd_kernel(const U* __restrict__ a, const U* __restrict__ b,
                           U* __restrict__ out, long long n) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    U x = a[i];
    U y = b[i];
    while (y != U(0)) {
      const U r = x % y;
      x = y;
      y = r;
    }
    out[i] = x;
  }
}

}  // namespace

extern "C" int pfcs_gcd(const void* a, const void* b, void* out, long long n,
                        int elem_bytes, void* stream) {
  if (n <= 0) return 0;
  const long long blocks = (n + kThreads - 1) / kThreads;
  const unsigned grid = static_cast<unsigned>(blocks < 65535 * 16 ? blocks : 65535 * 16);
  auto s = static_cast<cudaStream_t>(stream);
  if (elem_bytes == 4) {
    gcd_kernel<uint32_t><<<grid, kThreads, 0, s>>>(
        static_cast<const uint32_t*>(a), static_cast<const uint32_t*>(b),
        static_cast<uint32_t*>(out), n);
  } else if (elem_bytes == 8) {
    gcd_kernel<uint64_t><<<grid, kThreads, 0, s>>>(
        static_cast<const uint64_t*>(a), static_cast<const uint64_t*>(b),
        static_cast<uint64_t*>(out), n);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* pfcs_gcd_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

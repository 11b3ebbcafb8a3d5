// Block-wide slot scans of the trace engine's kernels (engine_baseline.cu,
// engine_pfcs.cu).
//
// One thread block walks one trace.  Every thread of the block takes part in
// every step: each scan of a slot array is split over the threads
// (``for i = threadIdx.x; i < n; i += kThreads``), each thread folds its
// slots into a few 64-bit accumulators, and ``block_reduce`` combines them
// across the block (warp shuffles, then one word per warp in shared memory)
// and hands every thread the same result.  So the whole block takes every
// decision together, from the same numbers, and the control flow stays
// uniform (every ``__syncthreads`` is reached by every thread).
//
// Arg-min scans fold ``pack(value, index)``: the value in the high word and
// the index in the low one, so the smallest packed word is the smallest
// value and, among equal values, the lowest index -- ``jnp.argmin``'s and
// ``torch.argmin``'s tie rule.  A masked-out slot folds ``kI32Max`` as its
// value, so an all-masked scan gives index 0, as ``argmin`` over
// ``where(mask, v, I32MAX)`` does.
//
// Only thread 0 writes slots.  ``__syncthreads()`` after its writes makes
// them visible to the block before the next scan reads the arrays.

#pragma once

#include <climits>

namespace pfcs_engine {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kEmpty = -1;
constexpr int kI32Max = 2147483647;
// "no index found" in a min-index fold
constexpr long long kNone = LLONG_MAX;
// the most accumulators one reduction combines
constexpr int kMaxFields = 16;

__device__ __forceinline__ long long pack(int value, int index) {
  return static_cast<long long>(value) * 4294967296LL +
         static_cast<unsigned int>(index);
}

__device__ __forceinline__ int index_of(long long packed) {
  return static_cast<int>(static_cast<unsigned int>(packed));
}

__device__ __forceinline__ int value_of(long long packed) {
  return static_cast<int>(packed >> 32);
}

__device__ __forceinline__ long long min64(long long a, long long b) {
  return b < a ? b : a;
}

// Combines v[f] over the block: a sum where bit f of ``sum_mask`` is set,
// else a minimum.  Every thread returns with the block's result in v.
// ``smem`` holds kMaxFields * kWarps words.
template <int N>
__device__ __forceinline__ void block_reduce(long long (&v)[N],
                                             unsigned sum_mask,
                                             long long* smem) {
  static_assert(N <= kMaxFields, "too many fields");
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int f = 0; f < N; ++f) {
    const bool sum = (sum_mask >> f) & 1u;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const long long u = __shfl_xor_sync(0xffffffffu, v[f], o);
      v[f] = sum ? v[f] + u : min64(v[f], u);
    }
  }
  __syncthreads();  // the previous reduction's readers are done with smem
  if (lane == 0) {
#pragma unroll
    for (int f = 0; f < N; ++f) smem[f * kWarps + warp] = v[f];
  }
  __syncthreads();
#pragma unroll
  for (int f = 0; f < N; ++f) {
    const bool sum = (sum_mask >> f) & 1u;
    long long r = smem[f * kWarps];
#pragma unroll
    for (int w = 1; w < kWarps; ++w)
      r = sum ? r + smem[f * kWarps + w] : min64(r, smem[f * kWarps + w]);
    v[f] = r;
  }
}

// A min-index fold's result as an index, or ``fallback`` when none was found.
__device__ __forceinline__ int found_or(long long idx, int fallback) {
  return idx == kNone ? fallback : static_cast<int>(idx);
}

}  // namespace pfcs_engine

// The Table-1 engine's PFCS system: the multi-level relationship-aware cache
// with its deterministic prefetch, run over a whole trace.
//
// Replaces the lax.scan loop src/repro/core/engine/batch.py:82
// (_pfcs_core: jax.jit(jax.vmap(run)) around lax.scan) with the step it
// scans, src/repro/core/engine/pfcs_vec.py (build_pfcs).  The plain
// PyTorch version is repro_torch/core/engine/pfcs_vec.py's step run as a
// Python loop over the trace (repro_torch/kernels/engine.py).
//
// Layout.  One thread block of kThreads threads per trace of the batch, one
// launch per simulate_batch call.  The block walks its trace step by step.
// Each level of capacity C is four (C+1)-slot int32 arrays (keys, stamps,
// the prefetched flag, the degree snapshot), then comes the (K,) residency
// array ``where`` (the key's level or -1); one region per trace,
// initialised here, each array at the word the wrapper gives in
// ``offsets`` (from kernels/engine.py::pfcs_layout).  The
// (K, budget) target and truth tables and the (K,) degree table are read
// from global memory.  A step: the hit's slot (a block fold over its
// level), the demand insert and demote cascade (per level, a fold for the
// first free slot and the count, then, when the level is over capacity,
// the eviction window: min(victim_window, C+1) chained arg-mins over the
// stamps, each a fold over the occupied slots stamped after the previous
// pick, exact because live stamps are unique), then the prefetch burst
// into the last level, each target's residency read from ``where`` as the
// earlier inserts and evictions of the same access left it.  Thread 0
// makes the slot writes; every decision is taken by the whole block from
// the folds' results.
//
// What bounds it.  As engine_baseline.cu: a serial chain of steps, each
// scan two block barriers and a shuffle tree, parallel only across traces
// and within a scan; the bytes / slot-words bound the smoke run states
// (the words the algorithm must read for this trace, counted by
// chip_smoke.py apart from this kernel) is loose.  ``visits`` counts the
// slot words this kernel's scans read, a diagnostic: the eviction window's
// w chained folds read the level w times where one selection would do.
//
// C entry: pfcs_engine_pfcs(acc, n, length, caps, n_levels, n_keys,
//   budget, bcols, window, always, targets, truth, degree, state,
//   state_words, offsets, n_offsets, counters, visits, stream) ->
//   cudaGetLastError().  offsets is a host array of the 4 * n_levels + 1
//   words at which each level's keys, t, pf, deg and then ``where`` start
//   in a trace's state_words region.  acc is
//   (n, length) int32 keys, -1 a padded step; targets (n, K, bcols) int32,
//   -1 padded; truth (n, K, bcols) uint8; degree (n, K) int32; budget the
//   prefetch inserts per access (0 disables prefetch); counters
//   (n, n_levels + 5) int32: hits per level, misses, demand accesses,
//   prefetches issued, used and true.

#include <cuda_runtime.h>

#include "engine_scan.cuh"

using namespace pfcs_engine;

namespace {

constexpr int kMaxLevels = 8;
constexpr int kMaxArrays = 4 * kMaxLevels + 1;

// where each array starts in a trace's state region, in words
struct Offsets {
  long long at[kMaxArrays];
};

struct Level {
  int *keys, *t, *pf, *deg;
  int cap;     // C; the level has C + 1 slots
};

struct Block {
  long long* red;
  long long visits;
};

struct Victim {
  int key, pf, deg;
};

// Relationship-aware replacement over a full level: among the w
// least-recent entries evict the lowest degree, ties to the older (strict <
// from the oldest).
__device__ Victim evict(const Level& lv, int window, Block& blk) {
  const int n = lv.cap + 1;
  const int w = window < n ? window : n;
  int best = 0, best_deg = kI32Max;
  int prev = -kI32Max - 1;            // below every stamp
  for (int r = 0; r < w; ++r) {
    long long v[1] = {kNone};
    for (int i = threadIdx.x; i < n; i += kThreads) {
      const int t = lv.t[i];
      const bool live = lv.keys[i] != kEmpty && t > prev;
      v[0] = min64(v[0], pack(live ? t : kI32Max, i));
    }
    block_reduce(v, 0u, blk.red);
    blk.visits += 2LL * n;
    const int i = index_of(v[0]);
    prev = value_of(v[0]);
    const int d = lv.deg[i];
    if (d < best_deg) {
      best = i;
      best_deg = d;
    }
  }
  const Victim out{lv.keys[best], lv.pf[best], lv.deg[best]};
  __syncthreads();                    // every thread has read the victim
  if (threadIdx.x == 0) lv.keys[best] = kEmpty;
  __syncthreads();
  return out;
}

// _add at the level's first free slot (slot 0 when none), the key's
// ``where`` set to the level; returns whether the level is over capacity.
__device__ bool add(const Level& lv, int* where, int level, int key,
                    int tick, int pf, int deg, Block& blk) {
  const int n = lv.cap + 1;
  long long v[2] = {kNone, 0};
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const bool occ = lv.keys[i] != kEmpty;
    if (!occ) v[0] = min64(v[0], i);
    v[1] += occ;
  }
  block_reduce(v, 2u, blk.red);
  blk.visits += n;
  const int e = found_or(v[0], 0);
  if (threadIdx.x == 0) {
    lv.keys[e] = key;
    lv.t[e] = tick;
    lv.pf[e] = pf;
    lv.deg[e] = deg;
    where[key] = level;
  }
  __syncthreads();
  return v[1] + (v[0] != kNone ? 1 : 0) > lv.cap;
}

__global__ void __launch_bounds__(kThreads)
    engine_pfcs_kernel(const int* __restrict__ acc, long long length,
                       const int* __restrict__ caps_in, int n_levels,
                       int n_keys, int budget, int bcols, int window,
                       int always, const int* __restrict__ targets,
                       const unsigned char* __restrict__ truth,
                       const int* __restrict__ degree, int* state,
                       long long state_words, const Offsets offsets,
                       int* counters, long long* visits_out) {
  __shared__ long long red[kMaxFields * kWarps];
  const long long b = blockIdx.x;
  const int* a = acc + b * length;
  int* st = state + b * state_words;
  const int* tgt_tbl = targets + b * n_keys * bcols;
  const unsigned char* truth_tbl = truth + b * n_keys * bcols;
  const int* deg_tbl = degree + b * n_keys;

  Level lv[kMaxLevels];
  const long long* at = offsets.at;
  for (int l = 0; l < n_levels; ++l) {
    const int cap = caps_in[l], n = cap + 1;
    lv[l] = {st + at[4 * l], st + at[4 * l + 1], st + at[4 * l + 2],
             st + at[4 * l + 3], cap};
    for (int i = threadIdx.x; i < n; i += kThreads) {
      lv[l].keys[i] = kEmpty;
      lv[l].t[i] = i - n;
      lv[l].pf[i] = 0;
      lv[l].deg[i] = 0;
    }
  }
  int* where = st + at[4 * n_levels];
  for (int i = threadIdx.x; i < n_keys; i += kThreads) where[i] = -1;
  __syncthreads();

  Block blk{red, 0};
  int hits[kMaxLevels];
  for (int l = 0; l < n_levels; ++l) hits[l] = 0;
  int miss = 0, demand = 0, issued = 0, used = 0, n_true = 0;
  const int micro = n_levels + budget;
  const int last = n_levels - 1;
  for (long long step = 0; step < length; ++step) {
    const int key = a[step];
    if (key < 0) continue;            // a padded step changes nothing
    const int base = static_cast<int>(step * micro);
    const int lvl = where[key];
    const bool hit = lvl >= 0;
    bool was_pf = false;
    if (hit) {                        // the key's slot in its level
      const Level& h = lv[lvl];
      const int n = h.cap + 1;
      long long v[1] = {kNone};
      for (int i = threadIdx.x; i < n; i += kThreads)
        if (h.keys[i] == key) v[0] = min64(v[0], i);
      block_reduce(v, 0u, red);
      blk.visits += n;
      if (v[0] != kNone) {
        const int m = static_cast<int>(v[0]);
        was_pf = h.pf[m] != 0;
        __syncthreads();              // every thread has read the flag
        if (threadIdx.x == 0) {
          if (lvl == 0) {             // L0 hit: touch in place
            h.t[m] = base;
            h.pf[m] = 0;
          } else {                    // deeper: out, then in at L0 below
            h.keys[m] = kEmpty;
          }
        }
        __syncthreads();
      }
    }

    if (!(hit && lvl == 0)) {         // demand insert + demote cascade
      int pk = key, ppf = 0, pdeg = deg_tbl[key];
      bool pending = true;
      for (int l = 0; l < n_levels && pending; ++l) {
        pending = add(lv[l], where, l, pk, base + l, ppf, pdeg, blk);
        if (pending) {
          const Victim vic = evict(lv[l], window, blk);
          pk = vic.key;
          ppf = vic.pf;
          pdeg = vic.deg;
        }
      }
      if (pending) {                  // evicted from the last level
        if (threadIdx.x == 0) where[pk] = -1;
        __syncthreads();
      }
    }

    if (budget > 0 && (always || !hit || was_pf)) {
      const int* row = tgt_tbl + static_cast<long long>(key) * bcols;
      const unsigned char* tr = truth_tbl + static_cast<long long>(key) * bcols;
      for (int j = 0; j < budget; ++j) {
        const int tg = row[j];
        if (tg < 0 || where[tg] >= 0) continue;
        issued += 1;
        n_true += tr[j] != 0;
        if (add(lv[last], where, last, tg, base + n_levels + j, 1,
                deg_tbl[tg], blk)) {
          const Victim vic = evict(lv[last], window, blk);
          if (threadIdx.x == 0) where[vic.key] = -1;
          __syncthreads();
        }
      }
    }

    if (hit) hits[lvl] += 1;
    else miss += 1;
    demand += 1;
    used += hit && was_pf;
  }

  if (threadIdx.x == 0) {
    int* out = counters + b * (n_levels + 5);
    for (int l = 0; l < n_levels; ++l) out[l] = hits[l];
    out[n_levels] = miss;
    out[n_levels + 1] = demand;
    out[n_levels + 2] = issued;
    out[n_levels + 3] = used;
    out[n_levels + 4] = n_true;
    visits_out[b] = blk.visits;
  }
}

}  // namespace

extern "C" int pfcs_engine_pfcs(const void* acc, long long n, long long length,
                                const void* caps, int n_levels, int n_keys,
                                int budget, int bcols, int window, int always,
                                const void* targets, const void* truth,
                                const void* degree, void* state,
                                long long state_words,
                                const long long* offsets, int n_offsets,
                                void* counters, void* visits, void* stream) {
  if (n <= 0) return 0;
  if (n_levels < 1 || n_levels > kMaxLevels || budget > bcols ||
      n_offsets != 4 * n_levels + 1)
    return static_cast<int>(cudaErrorInvalidValue);
  Offsets off{};
  for (int j = 0; j < n_offsets; ++j) off.at[j] = offsets[j];
  engine_pfcs_kernel<<<static_cast<unsigned>(n), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(acc), length, static_cast<const int*>(caps),
      n_levels, n_keys, budget, bcols, window, always,
      static_cast<const int*>(targets),
      static_cast<const unsigned char*>(truth),
      static_cast<const int*>(degree), static_cast<int*>(state), state_words,
      off, static_cast<int*>(counters), static_cast<long long*>(visits));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* pfcs_engine_pfcs_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

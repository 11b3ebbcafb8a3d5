// The Table-1 engine's baseline systems: one replacement policy (LRU, FIFO,
// 2Q, ARC or LIRS) over the summed level capacity, plus the recency shadow
// that attributes each hit to a tier, run over a whole trace.
//
// Replaces the lax.scan loop src/repro/core/engine/batch.py:47
// (_baseline_core: jax.jit(jax.vmap(run)) around lax.scan) with the step
// functions it scans, src/repro/core/engine/policies_vec.py (lru_step,
// fifo_step, twoq_step, arc_build, lirs_build) and
// src/repro/core/engine/hierarchy.py (build_hierarchy).  The plain PyTorch
// version is the same step functions in repro_torch/core/engine/ run as a
// Python loop over the trace (repro_torch/kernels/engine.py).
//
// Layout.  One thread block of kThreads threads per trace of the batch, one
// launch per simulate_batch call.  The block walks its trace step by step;
// each step's slot scans (the key match, count, the masked arg-min,
// first_empty, the shadow's rank count) are block-wide folds
// (engine_scan.cuh) with the reference's lowest-index tie rule, and thread
// 0 makes the step's few slot writes.  The state is the reference's arrays
// (int32, in global memory, one region per trace), initialised here; where
// each array starts in a region is the wrapper's to say (``offsets``, from
// kernels/engine.py::baseline_layout), so the layout lives in one place; ARC's
// adaptive target p is a double in registers (no fast-math: its arithmetic
// is CPython's), written out at the end with the counters.
//
// What bounds it.  A trace is a serial chain of steps: each step's
// decisions wait on the previous step's writes, so the only parallelism is
// across traces (blocks) and within a step's scans (threads).  Each scan
// costs two block barriers and a shuffle tree whatever its length, so
// short arrays are bound by that latency, not by bytes or operations.  The
// bound the smoke run states (bytes over 3.35 TB/s, and over 16.7 T int32
// operations/s the slot words the algorithm must read for this trace,
// counted by chip_smoke.py apart from this kernel) is therefore loose.
// ``visits`` counts the slot words this kernel's scans read, a diagnostic.
//
// C entry: pfcs_engine_baseline(acc, n, length, policy, cums, n_levels,
//   total, s1, s2, s3, n_keys, state, state_words, offsets, n_offsets,
//   p_out, counters, visits, stream) -> cudaGetLastError().  acc is
//   (n, length) int32 keys, -1 a padded (no-op) step; cums the levels'
//   cumulative capacities; s1..s3 the policy's sizes (2Q: kin, kout, km;
//   LIRS: capacity, llirs); offsets a host array of the n_offsets words at
//   which each of the trace's arrays starts in its state_words region
//   (shk, sht, then the policy's in baseline_layout's order); counters
//   (n, n_levels + 3) int32: hits per tier (MEM last), misses, demand
//   accesses; visits (n,) int64; p_out (n,) double.

#include <cuda_runtime.h>

#include "engine_scan.cuh"

using namespace pfcs_engine;

namespace {

enum Policy { kLRU = 0, kFIFO = 1, kTwoQ = 2, kARC = 3, kLIRS = 4 };
constexpr int kMaxLevels = 8;
constexpr int kPolicyTicks = 4;
constexpr int kLIR = 0, kHIR = 1, kNoStatus = 2;
// the most arrays a trace's state has (ARC: the shadow's two, eight lists)
constexpr int kMaxArrays = 10;
// the arrays each policy's state has (kernels/engine.py::baseline_layout)
constexpr int kArrays[5] = {4, 4, 8, 10, 8};

// where each array starts in a trace's state region, in words
struct Offsets {
  long long at[kMaxArrays];
};

struct Block {
  long long* red;      // shared scratch of block_reduce
  long long visits;    // slot words scanned (thread 0's count is kept)
};

__device__ __forceinline__ void fill(int* a, int n, int value) {
  for (int i = threadIdx.x; i < n; i += kThreads) a[i] = value;
}

// distinct negative stamps so that empty slots fill in slot order
__device__ __forceinline__ void fill_stamps(int* a, int n) {
  for (int i = threadIdx.x; i < n; i += kThreads) a[i] = i - n;
}

// ------------------------------------------------------------------------ //
// LRU / FIFO: keys[c], t[c]                                                 //
// ------------------------------------------------------------------------ //

__device__ bool lru_step(int* keys, int* ts, int c, int key, int now,
                         bool restamp, Block& blk) {
  long long v[2] = {kNone, kNone};
  for (int i = threadIdx.x; i < c; i += kThreads) {
    if (keys[i] == key) v[0] = min64(v[0], i);
    v[1] = min64(v[1], pack(ts[i], i));
  }
  block_reduce(v, 0u, blk.red);
  blk.visits += 2LL * c;
  const bool hit = v[0] != kNone;
  if (threadIdx.x == 0) {
    if (hit) {
      if (restamp) ts[v[0]] = now;
    } else {
      const int victim = index_of(v[1]);
      keys[victim] = key;
      ts[victim] = now;
    }
  }
  return hit;
}

// ------------------------------------------------------------------------ //
// 2Q: a1k/a1t[kin], aok/aot[kout], amk/amt[km]                              //
// ------------------------------------------------------------------------ //

__device__ bool twoq_step(int* const* s, int kin, int kout, int km, int key,
                          int now, Block& blk) {
  int *a1k = s[0], *a1t = s[1], *aok = s[2], *aot = s[3];
  int *amk = s[4], *amt = s[5];
  long long v[6] = {kNone, kNone, kNone, kNone, kNone, kNone};
  for (int i = threadIdx.x; i < km; i += kThreads) {
    if (amk[i] == key) v[0] = min64(v[0], i);
    v[1] = min64(v[1], pack(amt[i], i));
  }
  for (int i = threadIdx.x; i < kin; i += kThreads) {
    if (a1k[i] == key) v[2] = min64(v[2], i);
    v[3] = min64(v[3], pack(a1t[i], i));
  }
  for (int i = threadIdx.x; i < kout; i += kThreads) {
    if (aok[i] == key) v[4] = min64(v[4], i);
    v[5] = min64(v[5], pack(aot[i], i));
  }
  block_reduce(v, 0u, blk.red);
  blk.visits += 2LL * (km + kin + kout);
  const bool in_am = v[0] != kNone, in_a1 = v[2] != kNone;
  const bool in_ao = v[4] != kNone;
  const bool hit = in_am || in_a1;
  if (threadIdx.x == 0) {
    if (in_am) {
      amt[v[0]] = now;                 // Am hit: touch (A1in hits do not)
    } else if (!hit && in_ao) {
      // second touch within the window: the ghost goes, the key joins Am
      // over its LRU/empty slot; the freed ghost slot is stamped below
      // every init stamp so that the next push reuses it
      const int am_v = index_of(v[1]);
      amk[am_v] = key;
      amt[am_v] = now;
      aok[v[4]] = kEmpty;
      aot[v[4]] = -kI32Max;
    } else if (!hit) {
      // cold insert into A1in; its oldest occupant becomes a ghost
      const int a1_v = index_of(v[3]);
      const int displaced = a1k[a1_v];
      a1k[a1_v] = key;
      a1t[a1_v] = now;
      if (displaced != kEmpty) {
        const int ao_v = index_of(v[5]);
        aok[ao_v] = displaced;
        aot[ao_v] = now;
      }
    }
  }
  return hit;
}

// ------------------------------------------------------------------------ //
// ARC: t1k/t1t[c], t2k/t2t[c], b1k/b1t[c], b2k/b2t[2c+1]; p in a register   //
// ------------------------------------------------------------------------ //

// One scan of a list into v[0..3]: the key's slot, the arg-min stamp over
// the occupied slots, the occupied count, the first free slot.
__device__ __forceinline__ void arc_scan(const int* k, const int* t, int n,
                                         int key, long long* v) {
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const int kk = k[i];
    const bool occ = kk != kEmpty;
    if (kk == key) v[0] = min64(v[0], i);
    v[1] = min64(v[1], pack(occ ? t[i] : kI32Max, i));
    v[2] += occ;
    if (!occ) v[3] = min64(v[3], i);
  }
}

struct ArcList {
  int* k;
  int* t;
  long long match;   // the key's slot, or kNone
  int lru;           // arg-min stamp over the occupied slots (0 if none)
  int n;             // occupied slots
  long long free;    // first free slot, or kNone
};

__device__ __forceinline__ void arc_pop(ArcList& l, int slot) {
  if (threadIdx.x == 0) l.k[slot] = kEmpty;
  l.free = min64(l.free, slot);
  l.n -= 1;
}

__device__ __forceinline__ void arc_push(ArcList& l, int key, int now) {
  // first_empty: the first free slot, slot 0 when there is none
  const int e = found_or(l.free, 0);
  if (threadIdx.x == 0) {
    l.k[e] = key;
    l.t[e] = now;
  }
}

// ARC REPLACE: demote the LRU of T1 (-> B1 ghost) or of T2 (-> B2), steered
// by p.  Reads each slot it moves on thread 0, which alone writes.
__device__ void arc_replace(ArcList& t1, ArcList& t2, ArcList& b1,
                            ArcList& b2, double p, bool in_b2, int now) {
  const int p_int = static_cast<int>(p);      // int(p): p >= 0
  const bool cond_t1 =
      t1.n > 0 && ((in_b2 && t1.n == p_int) || t1.n > p_int);
  const bool do_t1 = cond_t1 || (t2.n == 0 && t1.n > 0);
  const bool do_t2 = !cond_t1 && t2.n > 0;
  if (do_t1) {
    const int k1 = threadIdx.x == 0 ? t1.k[t1.lru] : 0;
    arc_pop(t1, t1.lru);
    arc_push(b1, k1, now);
  }
  if (do_t2) {
    const int k2 = threadIdx.x == 0 ? t2.k[t2.lru] : 0;
    arc_pop(t2, t2.lru);
    arc_push(b2, k2, now);
  }
}

__device__ bool arc_step(int* const* s, int c, int key, int now, double& p,
                         Block& blk) {
  const int len[4] = {c, c, c, 2 * c + 1};
  long long v[16];
#pragma unroll
  for (int l = 0; l < 4; ++l) {
    v[4 * l] = kNone;
    v[4 * l + 1] = kNone;
    v[4 * l + 2] = 0;
    v[4 * l + 3] = kNone;
  }
#pragma unroll
  for (int l = 0; l < 4; ++l)
    arc_scan(s[2 * l], s[2 * l + 1], len[l], key, v + 4 * l);
  block_reduce(v, (1u << 2) | (1u << 6) | (1u << 10) | (1u << 14), blk.red);
  blk.visits += 2LL * (5 * c + 1);
  ArcList lst[4];
#pragma unroll
  for (int l = 0; l < 4; ++l)
    lst[l] = {s[2 * l], s[2 * l + 1], v[4 * l], index_of(v[4 * l + 1]),
              static_cast<int>(v[4 * l + 2]), v[4 * l + 3]};
  ArcList &t1 = lst[0], &t2 = lst[1], &b1 = lst[2], &b2 = lst[3];
  const bool in_t1 = t1.match != kNone, in_t2 = t2.match != kNone;
  const bool in_b1 = b1.match != kNone, in_b2 = b2.match != kNone;

  if (in_t1) {                        // Case I via T1: promote to T2's MRU
    if (threadIdx.x == 0) t1.k[t1.match] = kEmpty;
    arc_push(t2, key, now);
  } else if (in_t2) {                 // Case I via T2: touch
    if (threadIdx.x == 0) t2.t[t2.match] = now;
  } else if (in_b1 || in_b2) {        // Cases II / III: a ghost hit
    const double n_b1 = b1.n, n_b2 = b2.n;
    if (in_b1) {
      const double delta = fmax(1.0, n_b2 / fmax(n_b1, 1.0));
      p = fmin(static_cast<double>(c), p + delta);
    } else {
      const double delta = fmax(1.0, n_b1 / fmax(n_b2, 1.0));
      p = fmax(0.0, p - delta);
    }
    arc_replace(t1, t2, b1, b2, p, !in_b1, now);
    if (threadIdx.x == 0) {
      if (in_b1) b1.k[b1.match] = kEmpty;
      else b2.k[b2.match] = kEmpty;
    }
    arc_push(t2, key, now);
  } else {                            // Case IV: a miss
    const int l1 = t1.n + b1.n;
    const int total = l1 + t2.n + b2.n;
    const bool case_a = l1 == c;
    const bool drop_b1 = case_a && t1.n < c;
    const bool drop_t1 = case_a && t1.n >= c;
    const bool case_b = !case_a && total >= c;
    const bool drop_b2 = case_b && total == 2 * c;
    // the arg-mins were taken before any pop, as the reference's are
    if (drop_b1) arc_pop(b1, b1.lru);
    if (drop_t1) arc_pop(t1, t1.lru);
    if (drop_b2) arc_pop(b2, b2.lru);
    // (REPLACE never runs after T1 lost a slot: drop_t1 excludes both)
    if (drop_b1 || case_b) arc_replace(t1, t2, b1, b2, p, false, now);
    arc_push(t1, key, now);
  }
  return in_t1 || in_t2;
}

// ------------------------------------------------------------------------ //
// LIRS: status[K], s_t[K], q_t[K], res[K]; n_lir, n_res in registers        //
// ------------------------------------------------------------------------ //

struct Lirs {
  int *status, *s_t, *q_t, *res;
  int n_keys, capacity, llirs;
  int n_lir, n_res;
};

// min over the LIR keys of their stack stamp (value) and the lowest such
// key (index); kI32Max / 0 when there is none
__device__ long long lirs_bottom(const Lirs& L, Block& blk) {
  long long v[1] = {kNone};
  for (int i = threadIdx.x; i < L.n_keys; i += kThreads)
    v[0] = min64(v[0], pack(L.status[i] == kLIR ? L.s_t[i] : kI32Max, i));
  block_reduce(v, 0u, blk.red);
  blk.visits += 2LL * L.n_keys;
  return v[0];
}

// whether the key is in the stack, given lirs_bottom's result
__device__ __forceinline__ bool lirs_in_stack(const Lirs& L, int key,
                                              long long bottom) {
  const int st = L.s_t[key];
  return st >= 0 && st >= value_of(bottom);
}

// bottom LIR -> HIR (``bottom`` from lirs_bottom): leaves the stack;
// enters Q if resident
__device__ void lirs_demote_bottom(Lirs& L, int tick, long long bottom) {
  if (L.n_lir <= 0) return;
  const int b = index_of(bottom);
  if (threadIdx.x == 0) {
    const bool res_b = L.res[b] != 0;
    L.s_t[b] = -1;
    L.status[b] = kHIR;
    if (res_b) L.q_t[b] = tick;
  }
  L.n_lir -= 1;
  __syncthreads();
}

__device__ void lirs_evict_resident_hir(Lirs& L, Block& blk) {
  long long v[2] = {kNone, 0};
  for (int i = threadIdx.x; i < L.n_keys; i += kThreads) {
    const int q = L.q_t[i];
    v[0] = min64(v[0], pack(q >= 0 ? q : kI32Max, i));
    v[1] += q >= 0;
  }
  block_reduce(v, 2u, blk.red);
  blk.visits += L.n_keys;
  if (v[1] == 0) return;
  const int victim = index_of(v[0]);
  if (threadIdx.x == 0) {
    L.q_t[victim] = -1;
    L.res[victim] = 0;
  }
  L.n_res -= 1;
  __syncthreads();
}

__device__ bool lirs_step(Lirs& L, int key, int now, Block& blk) {
  const bool hit = L.res[key] != 0;
  if (L.status[key] == kLIR) {        // LIR hit: to the stack's top
    if (threadIdx.x == 0) L.s_t[key] = now + 1;
    return hit;
  }
  bool ins, cold = false;
  long long bottom;
  if (hit) {                          // resident HIR
    bottom = lirs_bottom(L, blk);
    ins = lirs_in_stack(L, key, bottom);
  } else {                            // miss: make room first
    if (L.n_res >= L.capacity) {
      lirs_evict_resident_hir(L, blk);
      if (L.n_res >= L.capacity) {   // all-LIR corner
        lirs_demote_bottom(L, now, lirs_bottom(L, blk));
        lirs_evict_resident_hir(L, blk);
      }
    }
    if (threadIdx.x == 0) L.res[key] = 1;
    L.n_res += 1;
    __syncthreads();
    bottom = lirs_bottom(L, blk);     // after the demotes moved it
    ins = lirs_in_stack(L, key, bottom);
    cold = L.n_lir < L.llirs && !ins;
  }
  const bool to_lir = cold || ins;
  if (threadIdx.x == 0) {
    L.s_t[key] = now + 1;
    L.status[key] = to_lir ? kLIR : kHIR;
    if (!to_lir) L.q_t[key] = now + 2;      // HIR: to Q's tail
    else if (hit) L.q_t[key] = -1;          // promoted: leaves Q
  }
  if (to_lir) L.n_lir += 1;
  // ``ins`` means a LIR key lies at or below the key's old stamp, and the
  // key joins the LIR set with the newest stamp: the bottom is unchanged
  if (ins && L.n_lir > L.llirs) lirs_demote_bottom(L, now + 2, bottom);
  return hit;
}

// ------------------------------------------------------------------------ //
// the trace loop                                                            //
// ------------------------------------------------------------------------ //

template <int P>
__global__ void __launch_bounds__(kThreads)
    engine_baseline_kernel(const int* __restrict__ acc, long long length,
                           const int* __restrict__ cums_in, int n_levels,
                           int total, int s1, int s2, int s3, int n_keys,
                           int* state, long long state_words,
                           const Offsets offsets, double* p_out,
                           int* counters, long long* visits_out) {
  __shared__ long long red[kMaxFields * kWarps];
  const long long b = blockIdx.x;
  const int* a = acc + b * length;
  int* st = state + b * state_words;
  int cums[kMaxLevels];
  for (int l = 0; l < n_levels; ++l) cums[l] = cums_in[l];

  int* arr[kMaxArrays];
  for (int j = 0; j < kMaxArrays; ++j) arr[j] = st + offsets.at[j];
  int* shk = arr[0];
  int* sht = arr[1];
  int* const* pol = arr + 2;          // the policy's arrays
  fill(shk, total, kEmpty);
  fill_stamps(sht, total);
  Lirs L{};
  if (P == kLRU || P == kFIFO) {
    fill(pol[0], total, kEmpty);
    fill_stamps(pol[1], total);
  } else if (P == kTwoQ) {
    const int sz[3] = {s1, s2, s3};
    for (int l = 0; l < 3; ++l) {
      fill(pol[2 * l], sz[l], kEmpty);
      fill_stamps(pol[2 * l + 1], sz[l]);
    }
  } else if (P == kARC) {
    for (int l = 0; l < 4; ++l) {     // keys EMPTY, stamps 0
      const int n = l < 3 ? total : 2 * total + 1;
      fill(pol[2 * l], n, kEmpty);
      fill(pol[2 * l + 1], n, 0);
    }
  } else {
    L = {pol[0], pol[1], pol[2], pol[3], n_keys, s1, s2, 0, 0};
    fill(L.status, n_keys, kNoStatus);
    fill(L.s_t, n_keys, -1);
    fill(L.q_t, n_keys, -1);
    fill(L.res, n_keys, 0);
  }
  __syncthreads();

  Block blk{red, 0};
  int hits[kMaxLevels + 1];
  for (int l = 0; l <= n_levels; ++l) hits[l] = 0;
  int miss = 0, demand = 0;
  double p = 0.0;
  for (long long step = 0; step < length; ++step) {
    const int key = a[step];
    if (key < 0) continue;            // a padded step changes nothing
    const int now = static_cast<int>(step * kPolicyTicks);

    // tier := the key's shadow rank before the touch
    long long v[2] = {kNone, kNone};
    for (int i = threadIdx.x; i < total; i += kThreads) {
      if (shk[i] == key) v[0] = min64(v[0], i);
      v[1] = min64(v[1], pack(sht[i], i));
    }
    block_reduce(v, 0u, red);
    blk.visits += 2LL * total;
    const bool in_shadow = v[0] != kNone;
    int tier = n_levels;
    if (in_shadow) {
      const int t_key = sht[v[0]];
      long long r[1] = {0};
      for (int i = threadIdx.x; i < total; i += kThreads)
        r[0] += shk[i] != kEmpty && sht[i] > t_key;
      block_reduce(r, 1u, red);
      blk.visits += 2LL * total;
      const long long rank = 1 + r[0];
      tier = 0;
      for (int l = 0; l < n_levels; ++l) tier += rank > cums[l];
    }

    // hit := the policy's residency before its update; then the update
    bool hit;
    if (P == kLRU || P == kFIFO)
      hit = lru_step(pol[0], pol[1], total, key, now, P == kLRU, blk);
    else if (P == kTwoQ)
      hit = twoq_step(pol, s1, s2, s3, key, now, blk);
    else if (P == kARC)
      hit = arc_step(pol, total, key, now, p, blk);
    else
      hit = lirs_step(L, key, now, blk);

    // the shadow touch: an LRU update over the largest shadow
    if (threadIdx.x == 0) {
      if (in_shadow) {
        sht[v[0]] = now;
      } else {
        shk[index_of(v[1])] = key;
        sht[index_of(v[1])] = now;
      }
    }
    __syncthreads();
    if (hit) hits[tier] += 1;
    else miss += 1;
    demand += 1;
  }

  if (threadIdx.x == 0) {
    int* out = counters + b * (n_levels + 3);
    for (int l = 0; l <= n_levels; ++l) out[l] = hits[l];
    out[n_levels + 1] = miss;
    out[n_levels + 2] = demand;
    visits_out[b] = blk.visits;
    p_out[b] = p;
    if (P == kLIRS) {
      pol[4][0] = L.n_lir;
      pol[5][0] = L.n_res;
    }
  }
}

template <int P>
void launch(const int* acc, long long n, long long length, const int* cums,
            int n_levels, int total, int s1, int s2, int s3, int n_keys,
            int* state, long long state_words, const Offsets& offsets,
            double* p_out, int* counters, long long* visits,
            cudaStream_t stream) {
  engine_baseline_kernel<P><<<static_cast<unsigned>(n), kThreads, 0,
                              stream>>>(
      acc, length, cums, n_levels, total, s1, s2, s3, n_keys, state,
      state_words, offsets, p_out, counters, visits);
}

}  // namespace

extern "C" int pfcs_engine_baseline(const void* acc, long long n,
                                    long long length, int policy,
                                    const void* cums, int n_levels, int total,
                                    int s1, int s2, int s3, int n_keys,
                                    void* state, long long state_words,
                                    const long long* offsets, int n_offsets,
                                    void* p_out, void* counters, void* visits,
                                    void* stream) {
  if (n <= 0) return 0;
  if (n_levels < 1 || n_levels > kMaxLevels || policy < 0 || policy > 4 ||
      n_offsets != kArrays[policy])
    return static_cast<int>(cudaErrorInvalidValue);
  Offsets off{};
  for (int j = 0; j < n_offsets; ++j) off.at[j] = offsets[j];
  auto s = static_cast<cudaStream_t>(stream);
  auto a = static_cast<const int*>(acc);
  auto c = static_cast<const int*>(cums);
  auto st = static_cast<int*>(state);
  auto p = static_cast<double*>(p_out);
  auto out = static_cast<int*>(counters);
  auto vis = static_cast<long long*>(visits);
  switch (policy) {
    case kLRU:
      launch<kLRU>(a, n, length, c, n_levels, total, s1, s2, s3, n_keys, st,
                   state_words, off, p, out, vis, s);
      break;
    case kFIFO:
      launch<kFIFO>(a, n, length, c, n_levels, total, s1, s2, s3, n_keys, st,
                    state_words, off, p, out, vis, s);
      break;
    case kTwoQ:
      launch<kTwoQ>(a, n, length, c, n_levels, total, s1, s2, s3, n_keys, st,
                    state_words, off, p, out, vis, s);
      break;
    case kARC:
      launch<kARC>(a, n, length, c, n_levels, total, s1, s2, s3, n_keys, st,
                   state_words, off, p, out, vis, s);
      break;
    case kLIRS:
      launch<kLIRS>(a, n, length, c, n_levels, total, s1, s2, s3, n_keys, st,
                    state_words, off, p, out, vis, s);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* pfcs_engine_baseline_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

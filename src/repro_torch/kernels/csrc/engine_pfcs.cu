// The Table-1 engine's PFCS system: the multi-level relationship-aware cache
// with its deterministic prefetch, run over a whole trace.
//
// Replaces the lax.scan loop src/repro/core/engine/batch.py:82
// (_pfcs_core: jax.jit(jax.vmap(run)) around lax.scan) with the step it
// scans, src/repro/core/engine/pfcs_vec.py (build_pfcs).  The plain
// PyTorch version is repro_torch/core/engine/pfcs_vec.py's step run as a
// Python loop over the trace (repro_torch/kernels/engine.py).
//
// What bounds it.  As engine_baseline.cu: a serial chain of steps, so a
// step's latency.  One block per trace; thread 0 walks the trace and the
// other threads only initialise the state and copy it out, so no barrier
// falls inside a step.  The state is in dynamic shared memory where it
// fits (engine_list.cuh's modes: mode 1 leaves ``where``, the key -> slot
// map and the degree table in global memory); the stamps, written and
// never read, stay in the global region.  No level is folded:
//
//   * a hit finds its slot in a per-key map beside ``where``;
//   * an insert takes the level's lowest free slot from a two-level bitmap
//     (the reference's first_empty; a level holds at most C of its C + 1
//     slots before an insert, so one is always free) and keeps the count
//     as a scalar; when the level holds C, its one free slot is the one
//     the last eviction or removal freed, known without the bitmap;
//   * each level keeps its live slots in stamp order (Chain).  That is
//     exact because every stamp a step writes into a level is the newest
//     there: the demand insert at level l writes base + l, a prefetch
//     base + levels + j (j rising), an L0 touch base (a step that touches
//     L0 inserts nothing there), and base grows by levels + budget a step.
//     So the eviction window, the min(victim_window, C + 1) least recent
//     slots, is the chain's first w nodes, walked once; the victim is the
//     first of the lowest degree among them (ties to the older entry).
//
// tests/test_torch_engine_model.py runs the same structures in Python
// against the plain step and the reference's oracle.
//
// C entry: pfcs_engine_pfcs(acc, n, length, caps, n_levels, n_keys,
//   budget, bcols, window, always, targets, truth, degree, state,
//   state_words, kinds, offsets, n_offsets, placement, counters,
//   visits, stream) -> cudaGetLastError().  offsets is a host array of the
//   words at which each array starts in a trace's state_words region:
//   pfcs_layout's (each level's keys, t, pf, deg, then ``where``), then the
//   kernel's own (kernels/engine.py::pfcs_arena: each level's links and
//   bitmap, then the key -> slot map and the degree table's copy), kinds
//   how each is placed (kernels/engine.py::pfcs_kinds).  acc is
//   (n, length) int32 keys, -1 a padded step; caps (on the card) the
//   level capacities; targets (n, K, bcols) int32, -1 padded; truth (n, K,
//   bcols) uint8; degree (n, K) int32; budget the prefetch inserts per
//   access (0 disables prefetch); placement as
//   engine_baseline.cu's; counters (n, n_levels + 5) int32: hits per
//   level, misses, demand accesses, prefetches issued, used and true;
//   visits (n,) int64: the slots the eviction windows walked.

#include <cuda_runtime.h>

#include <type_traits>

#include "engine_list.cuh"

using namespace pfcs_engine;

namespace {

constexpr int kMaxLevels = 8;
constexpr int kThreads = 128;

template <bool kShared>
using Link = typename std::conditional<kShared, unsigned short, int>::type;

struct Params {
  const int* acc;
  long long length;
  const int* caps;
  int n_levels, n_keys, budget, bcols, window, always;
  const int* targets;
  const unsigned char* truth;
  const int* degree;
  int* state;
  long long state_words;
  int* counters;
  long long* visits;
};

struct Victim {
  int key, pf, deg;
};

// One level's scalars.  A step's insert, eviction or removal reads them in
// one copy (vector loads, before any of its stores) and writes back what it
// changes.  ``only``: the one free slot when the level holds C of its C + 1
// (as it does after each eviction), kNil when that is not known, so that an
// insert then skips the bitmap.
struct alignas(16) LevelMeta {
  int base;         // the level's first slot, numbered across levels
  int cap, head, tail, n, only, lo_at, hi_at;
  long long t_at;   // where the level's stamps start in the region
  int n_hi, pad;
};

// The levels' slots are numbered across levels: level l's slot i is slot
// base + i of the arrays below, so one pointer serves every level and the
// per-level scalars (in shared memory) are the only thing a level adds.
template <typename L>
struct Pfcs {
  int *keys, *pf, *deg;     // every level's slots
  L *nxt, *prv;             // each level's live slots in stamp order
  unsigned *lo, *hi;        // each level's free-slot bitmap (FreeSet)
  int* where;               // key -> level, -1
  int* slot;                // key -> slot (numbered across levels)
  const int* dg;            // the degree table
  int* region;
  LevelMeta* lm;            // per level, in shared memory
  int window;
  long long walked;

  using C = Chain<L>;

  __device__ __forceinline__ void append(int l, LevelMeta& m, int g) {
    prv[g] = C::to(m.tail);
    nxt[g] = C::to(kNil);
    if (m.tail == kNil) lm[l].head = m.head = g;
    else nxt[m.tail] = C::to(g);
    lm[l].tail = m.tail = g;
  }

  __device__ __forceinline__ void unlink(int l, LevelMeta& m, int g) {
    const int p = C::at(prv[g]), nx = C::at(nxt[g]);
    if (p == kNil) lm[l].head = m.head = nx;
    else nxt[p] = C::to(nx);
    if (nx == kNil) lm[l].tail = m.tail = p;
    else prv[nx] = C::to(p);
  }

  __device__ void remove(int l, LevelMeta& m, int g) {
    const int i = g - m.base;
    keys[g] = kEmpty;
    unlink(l, m, g);
    FreeSet{lo + m.lo_at, hi + m.hi_at, m.n_hi}.add(i);
    lm[l].n = m.n = m.n - 1;
    lm[l].only = m.only = m.n == m.cap ? i : kNil;
  }

  __device__ void remove(int l, int g) {
    LevelMeta m = lm[l];
    remove(l, m, g);
  }

  __device__ void touch(int g, int tick) {   // an L0 hit: to the newest end
    LevelMeta m = lm[0];
    region[m.t_at + g - m.base] = tick;
    pf[g] = 0;
    if (m.tail != g) {
      unlink(0, m, g);
      append(0, m, g);
    }
  }

  // _add at the level's first free slot; whether it is over capacity
  __device__ bool add(int l, int key, int tick, int flag, int d) {
    LevelMeta m = lm[l];
    FreeSet fs{lo + m.lo_at, hi + m.hi_at, m.n_hi};
    int i = m.n == m.cap ? m.only : kNil;
    if (i == kNil) i = fs.first();
    if (i == kNil) i = 0;
    fs.remove(i);
    lm[l].only = kNil;
    const int g = m.base + i;
    keys[g] = key;
    region[m.t_at + i] = tick;
    pf[g] = flag;
    deg[g] = d;
    append(l, m, g);
    where[key] = l;
    slot[key] = g;
    lm[l].n = m.n + 1;
    return m.n + 1 > m.cap;
  }

  // among the w least recent slots the first of the lowest degree
  __device__ Victim evict(int l) {
    LevelMeta m = lm[l];
    const int w = window < m.cap + 1 ? window : m.cap + 1;
    int g = m.head, best = g, best_deg = kI32Max;
    for (int r = 0; r < w; ++r) {
      const int d = deg[g];
      if (d < best_deg) {
        best = g;
        best_deg = d;
      }
      g = C::at(nxt[g]);
    }
    walked += w;
    const Victim out{keys[best], pf[best], deg[best]};
    remove(l, m, best);
    return out;
  }
};

template <bool kS, bool kK>
__global__ void __launch_bounds__(kThreads)
    engine_pfcs_kernel(const Params q, const Arena ar) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ LevelMeta lm[kMaxLevels];
  using SL = Link<kS>;
  const int tid = threadIdx.x;
  const long long blk = blockIdx.x;
  const int L = q.n_levels, K = q.n_keys;
  int* region = q.state + blk * q.state_words;
  const int* a = q.acc + blk * q.length;
  const int* tgt_tbl = q.targets + blk * K * q.bcols;
  const unsigned char* truth_tbl = q.truth + blk * K * q.bcols;
  const int* deg_in = q.degree + blk * K;

  Pfcs<SL> pc;
  const int x = 4 * L + 1;            // the first of the kernel's arrays
  pc.keys = place<int, kS>(ar, x, region, smem);
  pc.pf = place<int, kS>(ar, x + 1, region, smem);
  pc.deg = place<int, kS>(ar, x + 2, region, smem);
  pc.nxt = place<SL, kS>(ar, x + 3, region, smem);
  pc.prv = place<SL, kS>(ar, x + 4, region, smem);
  pc.lo = place<unsigned, kS>(ar, x + 5, region, smem);
  pc.hi = place<unsigned, kS>(ar, x + 6, region, smem);
  pc.where = place<int, kK>(ar, 4 * L, region, smem);
  pc.slot = place<int, kK>(ar, x + 7, region, smem);
  int* deg_copy = place<int, kK>(ar, x + 8, region, smem);
  pc.region = region;
  pc.lm = lm;
  pc.window = q.window;
  pc.walked = 0;
  int b0 = 0, lo0 = 0, hi0 = 0;
  for (int l = 0; l < L; ++l) {       // every thread: the level's place
    const int c1 = q.caps[l] + 1;
    FreeSet fs{pc.lo + lo0, pc.hi + hi0, 0};
    fs.init(c1, true, tid, kThreads);
    int* t = region + ar.at[4 * l + 1];
    for (int i = tid; i < c1; i += kThreads) {
      pc.keys[b0 + i] = kEmpty;
      pc.pf[b0 + i] = 0;
      pc.deg[b0 + i] = 0;
      t[i] = i - c1;
    }
    if (tid == 0)
      lm[l] = LevelMeta{b0, c1 - 1, kNil, kNil, 0, kNil, lo0, hi0,
                        ar.at[4 * l + 1], fs.n_hi, 0};
    b0 += c1;
    lo0 += FreeSet::lo_words(c1);
    hi0 += FreeSet::hi_words(c1);
  }
  for (int i = tid; i < K; i += kThreads) {
    pc.where[i] = -1;
    pc.slot[i] = kNil;
    if constexpr (kK) deg_copy[i] = deg_in[i];
  }
  pc.dg = kK ? deg_copy : deg_in;
  __syncthreads();

  if (tid == 0) {
    int hits[kMaxLevels];
    for (int l = 0; l < L; ++l) hits[l] = 0;
    int miss = 0, demand = 0, issued = 0, used = 0, n_true = 0;
    const int micro = L + q.budget;
    const int last = L - 1;
    int key = q.length > 0 ? a[0] : kEmpty;
    for (long long step = 0; step < q.length; ++step) {
      const int k = key;
      key = step + 1 < q.length ? a[step + 1] : kEmpty;
      if (k < 0) continue;            // a padded step changes nothing
      const int base_tick = static_cast<int>(step * micro);
      const int lvl = pc.where[k];
      const bool hit = lvl >= 0;
      bool was_pf = false;
      if (hit) {
        const int g = pc.slot[k];
        was_pf = pc.pf[g] != 0;
        if (lvl == 0) pc.touch(g, base_tick);   // L0 hit: touch in place
        else pc.remove(lvl, g);       // deeper: out, then in at L0 below
      }

      if (!(hit && lvl == 0)) {       // demand insert + demote cascade
        int pk = k, ppf = 0, pdeg = pc.dg[k];
        bool pending = true;
        for (int l = 0; l < L && pending; ++l) {
          pending = pc.add(l, pk, base_tick + l, ppf, pdeg);
          if (pending) {
            const Victim vic = pc.evict(l);
            pk = vic.key;
            ppf = vic.pf;
            pdeg = vic.deg;
          }
        }
        if (pending) pc.where[pk] = -1;   // evicted from the last level
      }

      if (q.budget > 0 && (q.always || !hit || was_pf)) {
        const int* row = tgt_tbl + static_cast<long long>(k) * q.bcols;
        const unsigned char* tr =
            truth_tbl + static_cast<long long>(k) * q.bcols;
        for (int j = 0; j < q.budget; ++j) {
          const int tg = row[j];
          if (tg < 0 || pc.where[tg] >= 0) continue;
          issued += 1;
          n_true += tr[j] != 0;
          if (pc.add(last, tg, base_tick + L + j, 1, pc.dg[tg]))
            pc.where[pc.evict(last).key] = -1;
        }
      }

      if (hit) hits[lvl] += 1;
      else miss += 1;
      demand += 1;
      used += hit && was_pf;
    }
    int* out = q.counters + blk * (L + 5);
    for (int l = 0; l < L; ++l) out[l] = hits[l];
    out[L] = miss;
    out[L + 1] = demand;
    out[L + 2] = issued;
    out[L + 3] = used;
    out[L + 4] = n_true;
    q.visits[blk] = pc.walked;
  }
  __syncthreads();
  for (int l = 0; l < L; ++l) {       // the levels out, in their layout
    const int b = lm[l].base, c1 = lm[l].cap + 1;
    int* keys = region + ar.at[4 * l];
    int* pf = region + ar.at[4 * l + 2];
    int* deg = region + ar.at[4 * l + 3];
    for (int i = tid; i < c1; i += kThreads) {
      keys[i] = pc.keys[b + i];
      pf[i] = pc.pf[b + i];
      deg[i] = pc.deg[b + i];
    }
  }
  copy_out(ar, region, smem);
}

template <bool kS, bool kK>
cudaError_t launch_mode(const Params& q, const Arena& ar, long long n,
                        int bytes, cudaStream_t stream) {
  auto kern = engine_pfcs_kernel<kS, kK>;
  cudaError_t rc = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (rc != cudaSuccess) return rc;
  kern<<<static_cast<unsigned>(n), kThreads, bytes, stream>>>(q, ar);
  return cudaGetLastError();
}

long long shared_limit() {
  int dev = 0, optin = 0;
  cudaFuncAttributes attr{};
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess ||
      cudaFuncGetAttributes(&attr, engine_pfcs_kernel<true, true>) !=
          cudaSuccess)
    return -1;
  return static_cast<long long>(optin) -
         static_cast<long long>(attr.sharedSizeBytes);
}

}  // namespace

extern "C" int pfcs_engine_pfcs(const void* acc, long long n, long long length,
                                const void* caps, int n_levels, int n_keys,
                                int budget, int bcols, int window, int always,
                                const void* targets, const void* truth,
                                const void* degree, void* state,
                                long long state_words, const char* kinds,
                                const long long* offsets, int n_offsets,
                                int* placement,
                                void* counters, void* visits, void* stream) {
  if (n <= 0) return 0;
  if (n_levels < 1 || n_levels > kMaxLevels || budget > bcols ||
      n_offsets != 4 * n_levels + 10)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long limit = shared_limit();
  if (limit < 0) return static_cast<int>(cudaGetLastError());
  Arena ar{};
  int mode = 2;
  const int bytes = plan_arena(kinds, offsets, n_offsets, state_words,
                               4 * n_levels + 1, limit, 0, placement[0], &ar,
                               &mode);
  if (bytes < 0) return static_cast<int>(cudaErrorInvalidValue);
  placement[0] = mode;
  placement[1] = bytes;
  const Params q{static_cast<const int*>(acc),
                 length,
                 static_cast<const int*>(caps),
                 n_levels,
                 n_keys,
                 budget,
                 bcols,
                 window,
                 always,
                 static_cast<const int*>(targets),
                 static_cast<const unsigned char*>(truth),
                 static_cast<const int*>(degree),
                 static_cast<int*>(state),
                 state_words,
                 static_cast<int*>(counters),
                 static_cast<long long*>(visits)};
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t rc;
  if (mode == 0) rc = launch_mode<true, true>(q, ar, n, bytes, s);
  else if (mode == 1) rc = launch_mode<true, false>(q, ar, n, bytes, s);
  else rc = launch_mode<false, false>(q, ar, n, bytes, s);
  return static_cast<int>(rc);
}

extern "C" const char* pfcs_engine_pfcs_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

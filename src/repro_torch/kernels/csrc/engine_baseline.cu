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
// What bounds it.  A trace is a serial chain of steps: each step's
// decisions wait on the previous step's writes, so a step's latency, not
// bytes or operations, sets the time.  The design makes a step a few
// dependent loads and stores in shared memory and lets no barrier into it:
//
//   * one block of kThreads threads per trace; the shadow and the policy
//     touch disjoint state, so thread 0 (warp 0) runs the shadow and thread
//     32 (warp 1) the policy, each over kChunk steps, writing each step's
//     tier and hit to shared memory; the block meets once a chunk to count
//     them.  The other threads only initialise the state and copy it out.
//   * the state lives in dynamic shared memory where it fits (see
//     engine_list.cuh: mode 0 every array read, mode 1 the slot arrays, the
//     per-key arrays in global memory, mode 2 none); stamp arrays, which
//     the kernel writes and never reads, stay in the global region.
//   * no slot array is folded.  A key's slot comes from a per-key map;
//     each list keeps its live slots in stamp order (engine_list.cuh's
//     Chain), exact because every stamp a step writes (``now``) is the
//     newest in its list: LRU's and FIFO's victim, 2Q's queue fronts, ARC's
//     four LRU ends are list heads.  The reference's tie rules hold: live
//     stamps are unique; empty slots carry the stamps ``i - n`` (or 0 for
//     ARC, whose arg-min masks them) and sit, in slot order, before the
//     live ones; 2Q's freed ghost slots (stamp -I32MAX) are a free set
//     taken lowest first; ARC's pushes take the lowest free slot.
//   * the shadow's tier: the rank of the key among the shadow's live
//     entries (1 + those touched since) against the levels' cumulative
//     capacities.  The shadow is one list in stamp order with the node at
//     rank cums[l] of each level marked and each slot's tier stored; a
//     touch moves the slot to the newest end, and each boundary above the
//     slot's tier moves one node newer (its old node drops one tier).  L
//     steps, no count.
//   * LIRS keeps its per-key arrays; the resident HIR queue is a list over
//     the keys in queue-stamp order, and the LIR bottom (least stack stamp
//     among LIR keys) a pointer over the trace: every key that becomes or
//     stays LIR takes the step's stamp, so the bottom never moves back; it
//     is the first step whose key is LIR and still holds that step's stamp.
//   * ARC's adaptive target p is a double in registers (no fast-math: its
//     arithmetic is CPython's), written out at the end.
//
// tests/test_torch_engine_model.py runs the same structures in Python
// against the plain step functions and the reference's scalar oracles.
//
// C entry: pfcs_engine_baseline(acc, n, length, policy, cums, n_levels,
//   total, s1, s2, s3, n_keys, state, state_words, kinds, offsets,
//   n_offsets, placement, p_out, counters, visits, stream) ->
//   cudaGetLastError().  acc is (n, length) int32 keys, -1 a padded (no-op)
//   step; cums the levels' cumulative capacities (on the card); s1..s3 the
//   policy's sizes (2Q: kin, kout, km; LIRS: capacity, llirs); offsets a
//   host array of the n_offsets words at which each array starts in a
//   trace's state_words region: baseline_layout's arrays, then the
//   kernel's own (kernels/engine.py::baseline_arena), and kinds how each
//   is placed (kernels/engine.py::baseline_kinds, plan_arena's letters);
//   placement (host, 2 ints) holds the least shared mode the caller takes
//   (0: the first that fits) and receives the mode and the dynamic shared
//   bytes; counters (n, n_levels +
//   3) int32: hits per tier (MEM last), misses, demand accesses; visits
//   (n,) int64: the steps the LIR bottom's pointer walked; p_out (n,)
//   double.

#include <cuda_runtime.h>

#include <type_traits>

#include "engine_list.cuh"

using namespace pfcs_engine;

namespace {

enum Policy { kLRU = 0, kFIFO = 1, kTwoQ = 2, kARC = 3, kLIRS = 4 };
constexpr int kMaxLevels = 8;
constexpr int kPolicyTicks = 4;
constexpr int kLIR = 0, kHIR = 1, kNoStatus = 2;
constexpr int kThreads = 128;
constexpr int kShadowThread = 0, kPolicyThread = 32;
constexpr int kChunk = 1024;
constexpr unsigned char kPad = 0xFF;
// dynamic shared bytes the kernel keeps for itself: the counters, the
// shadow's boundary nodes, a chunk's tiers and hits
constexpr int kMeta = (4 * (2 * kMaxLevels + 3) + 2 * kChunk + 15) / 16 * 16;

// the arrays of a trace's state, each policy's: baseline_layout's
// outputs, then the shadow's links, tiers and key map, then the policy's
// own (kernels/engine.py::baseline_arena gives their offsets and
// baseline_kinds their placement)
constexpr int kArrays[5] = {9, 9, 17, 26, 12};
__host__ __device__ constexpr int outputs(int p) {
  return p == kTwoQ ? 8 : p == kARC ? 10 : p == kLIRS ? 8 : 4;
}

template <bool kShared>
using Link = typename std::conditional<kShared, unsigned short, int>::type;

struct Params {
  const int* acc;
  long long length;
  const int* cums;
  int policy, n_levels, total, s1, s2, s3, n_keys;
  int* state;
  long long state_words;
  double* p_out;
  int* counters;
  long long* visits;
};

// ------------------------------------------------------------------------ //
// the tier shadow                                                           //
// ------------------------------------------------------------------------ //

template <typename L>
struct Shadow {
  int* keys;
  int* t;
  int* tier;     // each slot's tier: its rank against cums
  int* slot;     // key -> slot, kNil when not in the shadow
  int* bound;    // (shared) the node at rank cums[l] of each level
  Chain<L> ch;
  int n_levels;

  // the key's tier before the touch (n_levels when not in the shadow),
  // then the touch
  __device__ int access(int key, int now) {
    int m = slot[key], tr, s;
    if (m == kNil) {                   // the LRU slot takes the key
      tr = n_levels;
      s = n_levels - 1;
      m = ch.head;
      const int old = keys[m];
      if (old != kEmpty) slot[old] = kNil;
      keys[m] = key;
      slot[key] = m;
    } else {
      tr = s = tier[m];
    }
    const Node<L> nd = ch.node[m];     // the loop below moves no link
    for (int l = 0; l < s; ++l) {      // each boundary newer than m
      const int b = bound[l];
      tier[b] = l + 1;
      const int nb = ch.next(b);
      bound[l] = nb == kNil ? m : nb;
    }
    if (bound[s] == m) {
      const int nb = Chain<L>::at(nd.nxt);
      bound[s] = nb == kNil ? m : nb;
    }
    ch.to_tail(m, nd);
    tier[m] = 0;
    t[m] = now;
    return tr;
  }
};

// ------------------------------------------------------------------------ //
// LRU / FIFO                                                                //
// ------------------------------------------------------------------------ //

template <typename L>
struct LruPolicy {
  int* keys;
  int* t;
  int* where;     // key -> slot
  Chain<L> ch;    // every slot, empty ones first
  bool restamp;   // LRU; FIFO's hits keep their insertion stamp

  __device__ bool access(int key, int now) {
    const int m = where[key];
    if (m != kNil) {
      if (restamp) {
        t[m] = now;
        ch.to_tail(m);
      }
      return true;
    }
    const int v = ch.head;
    const int old = keys[v];
    if (old != kEmpty) where[old] = kNil;
    keys[v] = key;
    t[v] = now;
    where[key] = v;
    ch.to_tail(v);
    return false;
  }
};

// ------------------------------------------------------------------------ //
// 2Q: A1in (FIFO), A1out (ghosts), Am (LRU)                                 //
// ------------------------------------------------------------------------ //

template <typename L>
struct TwoQPolicy {
  enum { kA1 = 0, kAO = 1, kAM = 2 };
  int* k[3];
  int* t[3];
  int* where;       // key -> slot * 4 + list
  Chain<L> a1, ao, am;
  FreeSet freed;    // A1out slots freed by a second touch (stamp -I32MAX)

  __device__ __forceinline__ void put(int lst, int v, int key, int now) {
    const int old = k[lst][v];
    if (old != kEmpty) where[old] = kNil;
    k[lst][v] = key;
    t[lst][v] = now;
    where[key] = v * 4 + lst;
  }

  __device__ bool access(int key, int now) {
    const int code = where[key];
    const int which = code == kNil ? -1 : (code & 3), m = code >> 2;
    if (which == kAM) {               // Am hit: touch
      t[kAM][m] = now;
      am.to_tail(m);
      return true;
    }
    if (which == kA1) return true;    // A1in hits do not restamp
    if (which == kAO) {
      // second touch within the window: the key joins Am over its LRU (or
      // empty) slot; the ghost's slot is freed, stamped below every other
      // so that the next push reuses it
      const int v = am.head;
      put(kAM, v, key, now);
      am.to_tail(v);
      k[kAO][m] = kEmpty;
      t[kAO][m] = -kI32Max;
      ao.unlink(m);
      freed.add(m);
      return false;
    }
    // cold: into A1in over its oldest slot; a displaced key becomes a ghost
    const int v = a1.head;
    const int displaced = k[kA1][v];
    k[kA1][v] = key;
    t[kA1][v] = now;
    where[key] = v * 4 + kA1;
    a1.to_tail(v);
    if (displaced != kEmpty) {
      int g = freed.first();
      if (g == kNil) {
        g = ao.head;
        ao.unlink(g);
      } else {
        freed.remove(g);
      }
      put(kAO, g, displaced, now);
      ao.append(g);
    }
    return false;
  }
};

// ------------------------------------------------------------------------ //
// ARC: T1, T2, B1 (c slots each), B2 (2c + 1)                               //
// ------------------------------------------------------------------------ //

template <typename L>
struct ArcList {
  int* k;
  int* t;
  Chain<L> ch;    // the live slots
  FreeSet fs;
  int n;
};

template <typename L>
struct ArcPolicy {
  enum { kT1 = 0, kT2 = 1, kB1 = 2, kB2 = 3 };
  ArcList<L> l[4];
  int* where;     // key -> slot * 4 + list
  int c;
  double p;

  // the arg-min stamp over the occupied slots (0 when none)
  template <int I>
  __device__ __forceinline__ int lru() const {
    return l[I].n ? l[I].ch.head : 0;
  }

  template <int I>
  __device__ void pop(int slot, bool forget) {
    ArcList<L>& x = l[I];
    const int key = x.k[slot];
    if (key == kEmpty) return;
    if (forget) where[key] = kNil;
    x.k[slot] = kEmpty;
    x.ch.unlink(slot);
    x.fs.add(slot);
    x.n -= 1;
  }

  // at the first free slot (slot 0 when there is none)
  template <int I>
  __device__ void push(int key, int now) {
    ArcList<L>& x = l[I];
    int e = x.fs.first();
    if (e == kNil) {
      e = 0;
      pop<I>(0, true);
    }
    x.k[e] = key;
    x.t[e] = now;
    x.fs.remove(e);
    x.ch.append(e);
    x.n += 1;
    where[key] = e * 4 + I;
  }

  // REPLACE: demote the LRU of T1 (-> B1) or of T2 (-> B2), steered by p
  __device__ void replace(bool in_b2, int now) {
    const int p_int = static_cast<int>(p);      // int(p): p >= 0
    const int n1 = l[kT1].n, n2 = l[kT2].n;
    const bool cond_t1 = n1 > 0 && ((in_b2 && n1 == p_int) || n1 > p_int);
    if (cond_t1 || (n2 == 0 && n1 > 0)) {
      const int v = lru<kT1>();
      const int key = l[kT1].k[v];
      pop<kT1>(v, false);
      push<kB1>(key, now);
    } else if (n2 > 0) {
      const int v = lru<kT2>();
      const int key = l[kT2].k[v];
      pop<kT2>(v, false);
      push<kB2>(key, now);
    }
  }

  __device__ bool access(int key, int now) {
    const int code = where[key];
    const int which = code == kNil ? -1 : (code & 3), m = code >> 2;
    if (which == kT1) {               // Case I via T1: to T2's MRU
      pop<kT1>(m, false);
      push<kT2>(key, now);
      return true;
    }
    if (which == kT2) {               // Case I via T2: touch
      l[kT2].t[m] = now;
      l[kT2].ch.to_tail(m);
      return true;
    }
    if (which == kB1 || which == kB2) {  // Cases II / III: a ghost hit
      const double n_b1 = l[kB1].n, n_b2 = l[kB2].n;
      if (which == kB1) {
        const double delta = fmax(1.0, n_b2 / fmax(n_b1, 1.0));
        p = fmin(static_cast<double>(c), p + delta);
      } else {
        const double delta = fmax(1.0, n_b1 / fmax(n_b2, 1.0));
        p = fmax(0.0, p - delta);
      }
      replace(which == kB2, now);
      if (which == kB1) pop<kB1>(m, false);
      else pop<kB2>(m, false);
      push<kT2>(key, now);
      return false;
    }
    // Case IV: a miss
    const int n_t1 = l[kT1].n, n_b1 = l[kB1].n;
    const int l1 = n_t1 + n_b1;
    const int total = l1 + l[kT2].n + l[kB2].n;
    const bool case_a = l1 == c;
    const bool drop_b1 = case_a && n_t1 < c;
    const bool drop_t1 = case_a && n_t1 >= c;
    const bool case_b = !case_a && total >= c;
    if (drop_b1) pop<kB1>(lru<kB1>(), true);
    if (drop_t1) pop<kT1>(lru<kT1>(), true);
    if (case_b && total == 2 * c) pop<kB2>(lru<kB2>(), true);
    if (drop_b1 || case_b) replace(false, now);
    push<kT1>(key, now);
    return false;
  }
};

// ------------------------------------------------------------------------ //
// LIRS: status[K], s_t[K], q_t[K], res[K]                                   //
// ------------------------------------------------------------------------ //

template <typename L>
struct LirsPolicy {
  int *status, *s_t, *q_t, *res;
  Chain<L> q;           // the resident HIR keys in queue-stamp order
  const int* acc;       // the trace: the LIR bottom's pointer walks it
  long long bp, walked;
  int capacity, llirs, n_lir, n_res;

  // the LIR key of least stack stamp and that stamp; kI32Max (and key
  // kNil) when no key is LIR
  __device__ int bottom(int& key) {
    key = kNil;
    if (n_lir == 0) return kI32Max;
    for (;; ++bp, ++walked) {
      const int k = acc[bp];
      const int stamp = static_cast<int>(bp * kPolicyTicks + 1);
      if (k >= 0 && status[k] == kLIR && s_t[k] == stamp) {
        key = k;
        return stamp;
      }
    }
  }

  // bottom LIR -> HIR: leaves the stack; enters Q if resident
  __device__ void demote(int tick, int b) {
    if (n_lir <= 0) return;
    s_t[b] = -1;
    status[b] = kHIR;
    if (res[b]) {
      q_t[b] = tick;
      q.append(b);
    }
    n_lir -= 1;
  }

  __device__ void evict_resident_hir() {
    const int v = q.head;
    if (v == kNil) return;
    q.unlink(v);
    q_t[v] = -1;
    res[v] = 0;
    n_res -= 1;
  }

  __device__ bool access(int key, int now) {
    const bool hit = res[key] != 0;
    if (status[key] == kLIR) {        // LIR hit: to the stack's top
      s_t[key] = now + 1;
      return hit;
    }
    if (!hit) {                       // miss: make room first
      if (n_res >= capacity) {
        evict_resident_hir();
        if (n_res >= capacity) {      // all-LIR corner
          int b;
          bottom(b);
          demote(now, b);
          evict_resident_hir();
        }
      }
      res[key] = 1;
      n_res += 1;
    }
    int b;
    const int b_t = bottom(b);        // after the demotes moved it
    const int st = s_t[key];
    const bool ins = st >= 0 && st >= b_t;
    const bool cold = !hit && n_lir < llirs && !ins;
    const bool to_lir = cold || ins;
    // a resident key that is not LIR is in Q, and only such a key
    s_t[key] = now + 1;
    status[key] = to_lir ? kLIR : kHIR;
    if (!to_lir) {                    // HIR: to Q's tail
      q_t[key] = now + 2;
      if (hit) q.to_tail(key);
      else q.append(key);
    } else if (hit) {                 // promoted: leaves Q
      q_t[key] = -1;
      q.unlink(key);
    }
    if (to_lir) n_lir += 1;
    // ``ins`` means a LIR key lies at or below the key's old stamp, and the
    // key joined the LIR set with the newest stamp: the bottom is unchanged
    if (ins && n_lir > llirs) demote(now + 2, b);
    return hit;
  }
};

// ------------------------------------------------------------------------ //
// the trace loop                                                            //
// ------------------------------------------------------------------------ //

__device__ __forceinline__ void fill(int* a, int n, int value) {
  for (int i = threadIdx.x; i < n; i += kThreads) a[i] = value;
}

// distinct negative stamps so that empty slots fill in slot order
__device__ __forceinline__ void fill_stamps(int* a, int n) {
  for (int i = threadIdx.x; i < n; i += kThreads) a[i] = i - n;
}

// a chain of every slot of a list, in slot order, its links array j
// (cooperative)
template <bool kS>
__device__ __forceinline__ void init_list(Chain<Link<kS>>& ch, const Arena& ar,
                                          int j, int n, int* region,
                                          unsigned char* smem) {
  ch.node = place<Node<Link<kS>>, kS>(ar, j, region, smem);
  ch.init_ordered(n, threadIdx.x, kThreads);
}

template <int P, bool kS, bool kK>
__global__ void __launch_bounds__(kThreads)
    engine_baseline_kernel(const Params q, const Arena ar) {
  // the kernel's own scalars first (kMeta bytes), then the arena
  extern __shared__ __align__(16) unsigned char smem[];
  int* sums = reinterpret_cast<int*>(smem);
  int* bound = sums + kMaxLevels + 3;
  unsigned char* tiers = smem + 4 * (2 * kMaxLevels + 3);
  unsigned char* hits = tiers + kChunk;
  using SL = Link<kS>;
  using KL = Link<kK>;
  const int tid = threadIdx.x;
  const long long blk = blockIdx.x;
  int* region = q.state + blk * q.state_words;
  const int* a = q.acc + blk * q.length;
  const int n = q.total, n_keys = q.n_keys;
  const int x = outputs(P);           // the first of the kernel's arrays

  // the shadow: every slot in stamp order, slot 0 the oldest
  Shadow<SL> sh;
  sh.keys = place<int, kS>(ar, 0, region, smem);
  sh.t = region + ar.at[1];
  init_list<kS>(sh.ch, ar, x, n, region, smem);
  sh.tier = place<int, kS>(ar, x + 1, region, smem);
  sh.slot = place<int, kK>(ar, x + 2, region, smem);
  sh.n_levels = q.n_levels;
  fill(sh.keys, n, kEmpty);
  fill_stamps(sh.t, n);
  fill(sh.slot, n_keys, kNil);
  for (int i = tid; i < n; i += kThreads) {
    int tr = 0;
    for (int l = 0; l < q.n_levels; ++l) tr += q.cums[l] < n - i;
    sh.tier[i] = tr;
  }
  if (tid < q.n_levels) bound[tid] = n - q.cums[tid];
  sh.bound = bound;
  if (tid < kMaxLevels + 3) sums[tid] = 0;

  int* pol[8];
  for (int j = 0; j < 8 && 2 + j < x; ++j) pol[j] = region + ar.at[2 + j];
  LruPolicy<SL> lru;
  TwoQPolicy<SL> twoq;
  ArcPolicy<SL> arc;
  LirsPolicy<KL> lirs;
  if constexpr (P == kLRU) {
    lru.keys = place<int, kS>(ar, 2, region, smem);
    lru.t = pol[1];
    init_list<kS>(lru.ch, ar, x + 3, n, region, smem);
    lru.where = place<int, kK>(ar, x + 4, region, smem);
    lru.restamp = q.policy == kLRU;   // FIFO runs this instance too
    fill(lru.keys, n, kEmpty);
    fill_stamps(lru.t, n);
    fill(lru.where, n_keys, kNil);
  } else if constexpr (P == kTwoQ) {
    const int sz[3] = {q.s1, q.s2, q.s3};
    for (int i = 0; i < 3; ++i) {
      twoq.k[i] = place<int, kS>(ar, 2 + 2 * i, region, smem);
      twoq.t[i] = pol[2 * i + 1];
      fill(twoq.k[i], sz[i], kEmpty);
      fill_stamps(twoq.t[i], sz[i]);
    }
    init_list<kS>(twoq.a1, ar, x + 3, q.s1, region, smem);
    init_list<kS>(twoq.ao, ar, x + 4, q.s2, region, smem);
    init_list<kS>(twoq.am, ar, x + 5, q.s3, region, smem);
    twoq.freed.lo = place<unsigned, kS>(ar, x + 6, region, smem);
    twoq.freed.hi = place<unsigned, kS>(ar, x + 7, region, smem);
    twoq.freed.init(q.s2, false, tid, kThreads);
    twoq.where = place<int, kK>(ar, x + 8, region, smem);
    fill(twoq.where, n_keys, kNil);
  } else if constexpr (P == kARC) {
    for (int i = 0; i < 4; ++i) {     // keys EMPTY, stamps 0, all free
      ArcList<SL>& li = arc.l[i];
      const int len = i < 3 ? n : 2 * n + 1;
      li.k = place<int, kS>(ar, 2 + 2 * i, region, smem);
      li.t = pol[2 * i + 1];
      li.ch.node = place<Node<SL>, kS>(ar, x + 3 + 3 * i, region, smem);
      li.fs.lo = place<unsigned, kS>(ar, x + 4 + 3 * i, region, smem);
      li.fs.hi = place<unsigned, kS>(ar, x + 5 + 3 * i, region, smem);
      li.ch.init_empty();
      li.fs.init(len, true, tid, kThreads);
      li.n = 0;
      fill(li.k, len, kEmpty);
      fill(li.t, len, 0);
    }
    arc.where = place<int, kK>(ar, x + 15, region, smem);
    arc.c = n;
    arc.p = 0.0;
    fill(arc.where, n_keys, kNil);
  } else {
    lirs.status = place<int, kK>(ar, 2, region, smem);
    lirs.s_t = place<int, kK>(ar, 3, region, smem);
    lirs.q_t = pol[2];
    lirs.res = place<int, kK>(ar, 5, region, smem);
    lirs.q.node = place<Node<KL>, kK>(ar, x + 3, region, smem);
    lirs.q.init_empty();
    lirs.acc = a;
    lirs.bp = lirs.walked = 0;
    lirs.capacity = q.s1;
    lirs.llirs = q.s2;
    lirs.n_lir = lirs.n_res = 0;
    fill(lirs.status, n_keys, kNoStatus);
    fill(lirs.s_t, n_keys, -1);
    fill(lirs.q_t, n_keys, -1);
    fill(lirs.res, n_keys, 0);
  }
  __syncthreads();

  int cnt[kMaxLevels + 1];
#pragma unroll
  for (int l = 0; l <= kMaxLevels; ++l) cnt[l] = 0;
  int miss = 0, demand = 0;
  for (long long c0 = 0; c0 < q.length; c0 += kChunk) {
    const int len = static_cast<int>(
        q.length - c0 < kChunk ? q.length - c0 : kChunk);
    if (tid == kShadowThread || tid == kPolicyThread) {
      int key = a[c0];
      for (int i = 0; i < len; ++i) {
        const int next = i + 1 < len ? a[c0 + i + 1] : kEmpty;
        const int now = static_cast<int>((c0 + i) * kPolicyTicks);
        if (tid == kShadowThread) {
          tiers[i] = key < 0 ? kPad
                             : static_cast<unsigned char>(sh.access(key, now));
        } else {
          bool hit = false;
          if (key >= 0) {
            if constexpr (P == kLRU) hit = lru.access(key, now);
            else if constexpr (P == kTwoQ) hit = twoq.access(key, now);
            else if constexpr (P == kARC) hit = arc.access(key, now);
            else hit = lirs.access(key, now);
          }
          hits[i] = hit;
        }
        key = next;
      }
    }
    __syncthreads();
    for (int i = tid; i < len; i += kThreads) {
      const int tr = tiers[i];
      if (tr == kPad) continue;
      demand += 1;
      if (hits[i]) {
#pragma unroll
        for (int l = 0; l <= kMaxLevels; ++l) cnt[l] += tr == l;
      } else {
        miss += 1;
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int l = 0; l <= kMaxLevels; ++l)
    if (cnt[l]) atomicAdd(&sums[l], cnt[l]);
  atomicAdd(&sums[kMaxLevels + 1], miss);
  atomicAdd(&sums[kMaxLevels + 2], demand);
  if (tid == kPolicyThread) {
    q.p_out[blk] = 0.0;
    q.visits[blk] = 0;
    if constexpr (P == kARC) q.p_out[blk] = arc.p;
    if constexpr (P == kLIRS) {
      q.visits[blk] = lirs.walked;
      pol[4][0] = lirs.n_lir;
      pol[5][0] = lirs.n_res;
    }
  }
  __syncthreads();
  if (tid == 0) {
    int* out = q.counters + blk * (q.n_levels + 3);
    for (int l = 0; l <= q.n_levels; ++l) out[l] = sums[l];
    out[q.n_levels + 1] = sums[kMaxLevels + 1];
    out[q.n_levels + 2] = sums[kMaxLevels + 2];
  }
  copy_out(ar, region, smem);
}

template <int P, bool kS, bool kK>
cudaError_t launch_mode(const Params& q, const Arena& ar, long long n,
                        int bytes, cudaStream_t stream) {
  auto kern = engine_baseline_kernel<P, kS, kK>;
  cudaError_t rc = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (rc != cudaSuccess) return rc;
  kern<<<static_cast<unsigned>(n), kThreads, bytes, stream>>>(q, ar);
  return cudaGetLastError();
}

template <int P>
cudaError_t launch(const Params& q, const Arena& ar, long long n, int mode,
                   int bytes, cudaStream_t stream) {
  if (mode == 0) return launch_mode<P, true, true>(q, ar, n, bytes, stream);
  if (mode == 1) return launch_mode<P, true, false>(q, ar, n, bytes, stream);
  return launch_mode<P, false, false>(q, ar, n, bytes, stream);
}

// the dynamic shared bytes a block may take beside the kernel's own
long long shared_limit() {
  int dev = 0, optin = 0;
  cudaFuncAttributes attr{};
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess ||
      cudaFuncGetAttributes(&attr, engine_baseline_kernel<kARC, true, true>) !=
          cudaSuccess)
    return -1;
  return static_cast<long long>(optin) -
         static_cast<long long>(attr.sharedSizeBytes);
}

}  // namespace

extern "C" int pfcs_engine_baseline(const void* acc, long long n,
                                    long long length, int policy,
                                    const void* cums, int n_levels, int total,
                                    int s1, int s2, int s3, int n_keys,
                                    void* state, long long state_words,
                                    const char* kinds,
                                    const long long* offsets, int n_offsets,
                                    int* placement,
                                    void* p_out, void* counters, void* visits,
                                    void* stream) {
  if (n <= 0) return 0;
  if (n_levels < 1 || n_levels > kMaxLevels || policy < 0 || policy > 4 ||
      n_offsets != kArrays[policy])
    return static_cast<int>(cudaErrorInvalidValue);
  const long long limit = shared_limit();
  if (limit < 0) return static_cast<int>(cudaGetLastError());
  Arena ar{};
  int mode = 2;
  const int bytes = plan_arena(kinds, offsets, n_offsets, state_words,
                               outputs(policy), limit, kMeta, placement[0],
                               &ar, &mode);
  if (bytes < 0) return static_cast<int>(cudaErrorInvalidValue);
  placement[0] = mode;
  placement[1] = bytes;
  const Params q{static_cast<const int*>(acc), length,
                 static_cast<const int*>(cums), policy, n_levels, total, s1,
                 s2, s3,
                 n_keys, static_cast<int*>(state), state_words,
                 static_cast<double*>(p_out), static_cast<int*>(counters),
                 static_cast<long long*>(visits)};
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t rc;
  switch (policy) {
    case kLRU:
    case kFIFO: rc = launch<kLRU>(q, ar, n, mode, bytes, s); break;
    case kTwoQ: rc = launch<kTwoQ>(q, ar, n, mode, bytes, s); break;
    case kARC: rc = launch<kARC>(q, ar, n, mode, bytes, s); break;
    default: rc = launch<kLIRS>(q, ar, n, mode, bytes, s); break;
  }
  return static_cast<int>(rc);
}

extern "C" const char* pfcs_engine_baseline_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

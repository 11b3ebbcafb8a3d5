// The state structures of the trace engine's kernels (engine_baseline.cu,
// engine_pfcs.cu): what each step of a trace reads instead of folding a
// slot array.
//
// A trace is a serial chain of steps, so the kernels give each trace one
// thread and make every step a few dependent loads and stores:
//
//   Chain     the live slots of one list in stamp order, oldest (head) to
//             newest (tail), as a doubly linked list.  Exact where every
//             stamp written into the list is the newest there (each kernel
//             says why that holds for its lists); then the list's LRU
//             entry, the arg-min of its stamps, is the head, and live
//             stamps are unique, so the reference's lowest-index tie rule
//             never has to break a tie among them.
//   FreeSet   the free slots of one array as a two-level bitmap: bit i of
//             lo[i / 32] is set when slot i is free, bit w of hi[w / 32]
//             when lo[w] is not zero.  first() is the lowest free slot
//             (the reference's first_empty) by __ffs on the first nonzero
//             hi word and on the lo word it names.
//
// Links are stored as index + 1 (0 is "none") in a type the kernel picks:
// 16 bits where the array is in shared memory (every shared array has
// fewer than 65,535 entries; the host side checks), 32 bits in global
// memory; a slot's two links sit side by side, so that one load reads
// both.  Head and tail live in the owning thread's registers.

#pragma once

#include <cstdint>

namespace pfcs_engine {

constexpr int kEmpty = -1;
constexpr int kNil = -1;
constexpr int kI32Max = 2147483647;

// a slot's two links, read together in one load
template <typename L>
struct alignas(4) Node {
  L nxt, prv;
};

template <typename L>
struct Chain {
  Node<L>* node;
  int head, tail;

  __device__ __forceinline__ static int at(L v) {
    return static_cast<int>(v) - 1;
  }
  __device__ __forceinline__ static L to(int v) { return static_cast<L>(v + 1); }
  __device__ __forceinline__ int next(int i) const { return at(node[i].nxt); }

  __device__ __forceinline__ void append(int i) {
    node[i] = Node<L>{to(kNil), to(tail)};
    if (tail == kNil) head = i;
    else node[tail].nxt = to(i);
    tail = i;
  }

  // unlink slot i whose links ``nd`` the caller has read
  __device__ __forceinline__ void unlink(int i, Node<L> nd) {
    const int p = at(nd.prv), n = at(nd.nxt);
    if (p == kNil) head = n;
    else node[p].nxt = nd.nxt;
    if (n == kNil) tail = p;
    else node[n].prv = nd.prv;
  }

  __device__ __forceinline__ void unlink(int i) { unlink(i, node[i]); }

  __device__ __forceinline__ void to_tail(int i, Node<L> nd) {
    if (tail != i) {
      unlink(i, nd);
      append(i);
    }
  }

  __device__ __forceinline__ void to_tail(int i) { to_tail(i, node[i]); }

  // a chain of slots 0..n-1 in index order (cooperative: every thread of
  // the block calls it; head and tail are set in each caller)
  __device__ void init_ordered(int n, int tid, int threads) {
    for (int i = tid; i < n; i += threads)
      node[i] = Node<L>{to(i + 1 < n ? i + 1 : kNil), to(i - 1)};
    head = n > 0 ? 0 : kNil;
    tail = n - 1;
  }

  __device__ void init_empty() { head = tail = kNil; }
};

struct FreeSet {
  unsigned* lo;
  unsigned* hi;
  int n_hi;

  __device__ __forceinline__ void add(int i) {
    const int w = i >> 5;
    if (lo[w] == 0u) hi[w >> 5] |= 1u << (w & 31);
    lo[w] |= 1u << (i & 31);
  }

  __device__ __forceinline__ void remove(int i) {
    const int w = i >> 5;
    const unsigned v = lo[w] & ~(1u << (i & 31));
    lo[w] = v;
    if (v == 0u) hi[w >> 5] &= ~(1u << (w & 31));
  }

  // the lowest free slot, or kNil
  __device__ __forceinline__ int first() const {
    for (int h = 0; h < n_hi; ++h) {
      const unsigned word = hi[h];
      if (word) {
        const int w = h * 32 + __ffs(word) - 1;
        return w * 32 + __ffs(lo[w]) - 1;
      }
    }
    return kNil;
  }

  // words of the two levels for n slots
  static __host__ __device__ int lo_words(int n) { return (n + 31) / 32; }
  static __host__ __device__ int hi_words(int n) {
    return (lo_words(n) + 31) / 32;
  }

  // every slot free (free = true) or none (cooperative)
  __device__ void init(int n, bool free, int tid, int threads) {
    const int n_lo = lo_words(n);
    n_hi = hi_words(n);
    for (int w = tid; w < n_lo; w += threads) {
      const int bits = n - 32 * w < 32 ? n - 32 * w : 32;
      lo[w] = free ? (bits == 32 ? ~0u : (1u << bits) - 1u) : 0u;
    }
    for (int h = tid; h < n_hi; h += threads) {
      const int words = n_lo - 32 * h < 32 ? n_lo - 32 * h : 32;
      hi[h] = free ? (words == 32 ? ~0u : (1u << words) - 1u) : 0u;
    }
  }
};

// Where a kernel's arrays live.  The host side lays out every array of a
// trace's state in its global region (``at``, words from the region's
// start: the outputs in the wrapper's layout, then the kernel's own
// arrays) and, for the arrays it places in shared memory, a byte offset
// in the block's dynamic shared memory (``sat``, -1 for global).  The
// kernel is templated on the placement, so each array's address space is
// known when it is compiled.
constexpr int kMaxArrays = 48;

struct Arena {
  long long at[kMaxArrays];
  int sat[kMaxArrays];
  int n_out;        // the first n_out arrays are outputs (int32)
  int words[kMaxArrays];
};

template <typename T, bool kShared>
__device__ __forceinline__ T* place(const Arena& a, int j, int* region,
                                    unsigned char* smem) {
  return kShared ? reinterpret_cast<T*>(smem + a.sat[j])
                 : reinterpret_cast<T*>(region + a.at[j]);
}

// copies the output arrays that live in shared memory to the region
// (cooperative; after a barrier)
__device__ void copy_out(const Arena& a, int* region,
                         const unsigned char* smem) {
  for (int j = 0; j < a.n_out; ++j) {
    if (a.sat[j] < 0) continue;
    const int* src = reinterpret_cast<const int*>(smem + a.sat[j]);
    int* dst = region + a.at[j];
    for (int i = threadIdx.x; i < a.words[j]; i += blockDim.x) dst[i] = src[i];
  }
}

// The host side of the placement.  ``kinds`` names each array: 'G' an
// int32 output that is written and never read (a stamp array: it stays in
// the region), 'S' / 'K' an int32 array of the slots / of the keys, 's' /
// 'k' the links of the slots / of the keys (a Node: two words a slot in
// the region, two 16-bit halves of one word in shared memory), 'L' one
// link of the slots (a word in the region, 16 bits in shared memory),
// 'b' bitmap words of the slots.  Mode 0 puts the slot and key arrays in
// shared memory, mode 1 the slot arrays only, mode 2 none; the first mode
// from ``least`` on that fits in ``cap`` bytes, beside the ``fixed`` bytes
// the kernel keeps first for its own scalars, wins (``least`` > 0 asks for
// a less shared placement than fits, to check the other template
// instances).  Returns the dynamic shared bytes, or -1 when the layout is
// not the kernel's.
inline int plan_arena(const char* kinds, const long long* off, int n,
                      long long state_words, int n_out, long long cap,
                      int fixed, int least, Arena* a, int* mode) {
  if (n > kMaxArrays || n_out > n || least < 0 || least > 2) return -1;
  long long need[2] = {0, 0};       // slot, key bytes in shared memory
  bool fits16[2] = {true, true};
  for (int j = 0; j < n; ++j) {
    const long long end = j + 1 < n ? off[j + 1] : state_words;
    const long long w = end - off[j];
    if (w < 0 || kinds[j] == 0) return -1;
    a->at[j] = off[j];
    a->words[j] = static_cast<int>(w);
    const char k = kinds[j];
    const int part = (k == 'K' || k == 'k') ? 1 : 0;
    const bool link = k == 's' || k == 'k' || k == 'L';
    if (k == 'G') continue;
    if (link && w > (k == 'L' ? 65534 : 2 * 65534)) fits16[part] = false;
    const long long bytes = link ? 2 * w : 4 * w;
    need[part] += (bytes + 15) / 16 * 16;
  }
  if (kinds[n] != 0) return -1;
  *mode = (fits16[0] && fits16[1] && fixed + need[0] + need[1] <= cap) ? 0
          : (fits16[0] && fixed + need[0] <= cap)                     ? 1
                                                                      : 2;
  if (*mode < least) *mode = least;
  long long at = fixed;
  for (int j = 0; j < n; ++j) {
    const char k = kinds[j];
    const bool key = k == 'K' || k == 'k';
    const bool shared = k != 'G' && (key ? *mode == 0 : *mode <= 1);
    a->sat[j] = shared ? static_cast<int>(at) : -1;
    if (shared) {
      const bool link = k == 's' || k == 'k' || k == 'L';
      const long long bytes = link ? 2LL * a->words[j] : 4LL * a->words[j];
      at += (bytes + 15) / 16 * 16;
    }
  }
  a->n_out = n_out;
  return static_cast<int>(at);
}

}  // namespace pfcs_engine

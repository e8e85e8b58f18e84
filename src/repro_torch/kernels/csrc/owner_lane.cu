// owner_lane.cu — the owner's atomic lane ("NIC lane") on Hopper.
//
// Replaces the two Pallas TPU kernels of repro/kernels/amo_apply.py:
//   B1 _amo_kernel / amo_apply      -> amo_apply_copy_kernel + amo_apply_kernel
//   B2 _fused_kernel / fused_apply  -> fused_apply_copy_kernel +
//                                      fused_apply_kernel
// with the contract of repro_torch/kernels/ref.py (amo_apply, fused_apply):
// out-of-place (each owner's shard is copied to `out`, then updated), masked
// rows reply 0 and change nothing, an offset outside [0, L) reads the word a
// plain jnp gather reads (negative wraps once, then clamps) and writes
// nothing, and fetch-and-ops run in uint32 so int32 wraps exactly.
//
// What bounds it on this card. Out of place, the function must read every
// shard once, write it once and write every reply: at slice size a few
// hundred MB, so bytes bound it. Op order is the semantics, but only per
// word: an op must see the word left by the earlier ops ON ITS WORD, and ops
// on different words commute. So what is serial is the longest per-word
// chain, not the owner's whole list, and a run of one fetch-and-op on one
// word is a prefix fold, not a chain at all.
//
// What the design does about it. Two launches per wrapper call (the
// wrapper's launch counter counts calls):
//  1. <name>_copy_kernel spreads over every SM: it copies the shards and
//     zeroes the replies with 16-byte vectors, four in flight per thread.
//  2. <name>_kernel runs one block per owner. Each thread counts the live
//     rows of its own stretch of the mask (16-byte loads), and a block-wide
//     prefix count ranks them in list order, so the work below depends on
//     the live count, not on the list length m. The live list is taken in
//     ordered chunks of kChunk ops, each applied before the next:
//     - gather the chunk's descriptors (spread over the threads, 16-byte
//       loads) and map each to its effect on its word: PUT, CAS or a
//       fetch-and-op (an op outside [0, L), GET and unknown codes read the
//       word and leave it: a fetch-and-add of 0);
//     - a stable radix sort of the words in shared memory (CUB's block
//       sort), so that each word's ops form one segment in list order (a
//       chunk already in order, such as a ticket's, skips it);
//     - a block-wide segmented scan folds each run of one fetch-and-op kind
//       on one word (old_i = init op exclusive prefix, uint32), unless
//       every op is a run of its own;
//     - one thread per segment walks it: it reads the word once, takes a
//       PUT or CAS one at a time and a whole fetch-and-op run in one step,
//       and writes the word once;
//     - every op then writes its reply, a run's ops from the run's initial
//       value and their exclusive prefix.
//  B2's sub-phases follow one another over the whole live list: the atomics
//  as above; the winners' V-word puts at aux0, in parallel unless two of a
//  chunk's ranges overlap (a hash set of the covered words in shared memory
//  finds it), in which case one thread writes that chunk's puts in list
//  order (the later winner owns every shared word); the publish flips with
//  atomicXor (they are XORs with no reply, so they commute); the gathers.
//  Every sub-phase takes the live list chunk by chunk.
//  Everywhere the block waits on memory, it keeps many loads in flight:
//  mask vectors four at a time, descriptors and words spread over all the
//  threads, a row's fields read together.
#include <cstdint>
#include <cuda_runtime.h>
#include <cub/block/block_radix_sort.cuh>
#include <cub/block/block_scan.cuh>

#include "owner_list.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kItems = 8;                    // ops a thread holds in a chunk
constexpr int kChunk = kThreads * kItems;    // live ops applied per round

// what an op does to its word
constexpr int kSet = 0, kCas = 2, kFaa = 3, kFor = 4, kFand = 5, kFxor = 6;

__device__ __forceinline__ long long wrap_idx(long long i, long long n) {
  return i < 0 ? i + n : i;
}
__device__ __forceinline__ long long clip_idx(long long i, long long n) {
  const long long j = wrap_idx(i, n);
  return j < 0 ? 0 : (j >= n ? n - 1 : j);
}
__device__ __forceinline__ bool in_range(long long i, long long n) {
  const long long j = wrap_idx(i, n);
  return j >= 0 && j < n;
}

__device__ __forceinline__ bool is_fao(int k) {
  return k >= kFaa && k <= kFxor;
}
__device__ __forceinline__ uint32_t fao(uint32_t c, uint32_t x, int kind) {
  switch (kind) {
    case kFaa: return c + x;
    case kFor: return c | x;
    case kFand: return c & x;
    default: return c ^ x;   // kFxor
  }
}
__device__ __forceinline__ uint32_t fao_identity(int kind) {
  return kind == kFand ? 0xffffffffu : 0u;
}

struct Effect {
  int kind;
  int32_t x, y;
};

// primitive codes 0-6; GET and any other code leave the word
__device__ __forceinline__ Effect amo_effect(int32_t code, int32_t a,
                                             int32_t b) {
  if (code == 0) return {kSet, 0, b};
  if (code == 2) return {kCas, a, b};
  if (is_fao(code)) return {code, a, 0};
  return {kFaa, 0, 0};
}

// fused codes: CAS_PUT / CAS_PUT_PUB claim, FAO_GET fetch-and-op kind b
__device__ __forceinline__ Effect fused_effect(int32_t code, int32_t a,
                                               int32_t b) {
  if (code == 7 || code == 8) return {kCas, a, b};
  if (code == 9) return is_fao(b) ? Effect{b, a, 0} : Effect{kFaa, 0, 0};
  return amo_effect(code, a, b);
}

// ---------------------------------------------------------------------------
// Launch 1: copy every shard, zero every reply, across the whole card
// ---------------------------------------------------------------------------
// one name per lane, so that a trace tells B1's time from B2's
__global__ void __launch_bounds__(kCopyThreads)
amo_apply_copy_kernel(const int32_t* __restrict__ local,
                      int32_t* __restrict__ out, long long n,
                      int32_t* __restrict__ reply, long long n_reply) {
  copy_words(local, out, n);
  zero_words(reply, n_reply);
}

__global__ void __launch_bounds__(kCopyThreads)
fused_apply_copy_kernel(const int32_t* __restrict__ local,
                        int32_t* __restrict__ out, long long n,
                        int32_t* __restrict__ reply, long long n_reply) {
  copy_words(local, out, n);
  zero_words(reply, n_reply);
}

// ---------------------------------------------------------------------------
// Launch 2: one block per owner
// ---------------------------------------------------------------------------
using BlockSort = cub::BlockRadixSort<uint32_t, kThreads, kItems, int>;
using CountScan = cub::BlockScan<int, kThreads>;

// one element of the segmented run scan: `v` folds the operands from the
// run's head; meta = head position << 4 | kind << 1 | (1 at a head)
struct RunItem {
  uint32_t v;
  uint32_t meta;
};
using RunScan = cub::BlockScan<RunItem, kThreads>;

__device__ __forceinline__ RunItem run_item(uint32_t v, int start, int kind,
                                            bool head) {
  return {v, static_cast<uint32_t>(start << 4 | kind << 1 | (head ? 1 : 0))};
}

struct RunFold {
  __device__ __forceinline__ RunItem operator()(const RunItem& l,
                                                const RunItem& r) const {
    if (r.meta & 1u) return r;   // a non-head is a fetch-and-op of l's kind
    const int kind = (r.meta >> 1) & 7;
    return {fao(l.v, r.v, kind), (l.meta & ~0xEu) | (r.meta & 0xEu)};
  }
};

constexpr int kSetBits = 14;                // sub-phase 2's hash set
constexpr int kSetWords = 1 << kSetBits;
constexpr uint32_t kNoWord = 0xffffffffu;   // an empty entry (L < 2**31)

// A chunk-long array in shared memory with a pad entry after every 32, so
// that both the blocked pattern (thread t on entries 8t..8t+7) and the
// striped one (entries t + 512 i) touch 32 different banks.
template <typename T>
struct Padded {
  T a[kChunk + kChunk / 32];
  __device__ __forceinline__ T& operator[](int q) { return a[q + (q >> 5)]; }
  __device__ __forceinline__ const T& operator[](int q) const {
    return a[q + (q >> 5)];
  }
};

struct Smem {
  Padded<int> rows;          // slot (list order in the chunk) -> row
  Padded<int32_t> x;         // per slot, then sorted: the effect's operands
  Padded<int32_t> y;
  Padded<uint32_t> key;      // per slot, then sorted: the word (sub-phase
                             // 2: per slot, a put's aux0)
  Padded<int> slot;          // sorted: the slot
  Padded<uint8_t> kind;      // per slot, then sorted: the effect
  union {
    BlockSort::TempStorage sort;
    struct {
      Padded<uint32_t> incl;     // sorted: inclusive fold within the run
      Padded<uint32_t> init;     // at a run head: the word before the run
      Padded<uint32_t> old;      // sorted: the reply of a PUT or CAS
      Padded<int> run_end;       // at a run head: the run's last position
      Padded<int> start;         // sorted: the run's head
    } walk;
    uint32_t set[kSetWords];     // sub-phase 2: words the puts cover
  } u;
  union {
    CountScan::TempStorage count;
    RunScan::TempStorage run;
  } scan;
};

// Words 0-3 of a descriptor row, one 16-byte load when rows are aligned to
// it (vec: W a multiple of 4 and the list 16-byte aligned)
__device__ __forceinline__ int4 head4(const int32_t* __restrict__ op,
                                      long long row, int W, bool vec) {
  const int32_t* o = op + row * W;
  return vec ? *reinterpret_cast<const int4*>(o)
             : make_int4(o[0], o[1], o[2], o[3]);
}

// This thread's live rows hold ranks [start, start + count) of the owner's
// live list, which is `total` long.
struct Ranks {
  Stretch st;
  int start, count, total;
};

__device__ Ranks rank_live(Smem& s, const uint8_t* mk, long long m) {
  Ranks r;
  r.st = my_stretch<kThreads>(mk, m);
  r.count = count_live(mk, r.st);
  CountScan(s.scan.count).ExclusiveSum(r.count, r.start, r.total);
  __syncthreads();
  return r;
}

// f(n) for each chunk of the live list, in order, with s.rows[k] the row
// of live op c0 + k (k < n): each chunk sees the words the last one left
template <typename F>
__device__ void for_chunks(Smem& s, const uint8_t* __restrict__ mk,
                           const Ranks& r, F f) {
  for (int c0 = 0; c0 < r.total; c0 += kChunk) {
    const int n = min(kChunk, r.total - c0);
    if (r.start < c0 + n && r.start + r.count > c0) {
      int rank = r.start;
      for_live(mk, r.st, [&](long long j) {
        const int k = rank - c0;
        if (k >= 0 && k < n) s.rows[k] = static_cast<int>(j);
        ++rank;
      });
    }
    __syncthreads();
    f(n);
    __syncthreads();
  }
}

// does sorted position q start a run (a new word, or not the same
// fetch-and-op kind as the op before it on its word)?
__device__ __forceinline__ bool run_head(const Smem& s, int q) {
  if (q == 0 || s.key[q] != s.key[q - 1]) return true;
  return !is_fao(s.kind[q]) || s.kind[q] != s.kind[q - 1];
}

// Sort the chunk's (key, slot) pairs by key, stably, into s.key and the
// registers; a chunk already in key order (all on one hot word, as a
// ticket is) skips the sort.
__device__ __forceinline__ void sort_chunk(Smem& s, uint32_t (&keys)[kItems],
                                           int (&vals)[kItems],
                                           int end_bit) {
  const int t = threadIdx.x;
#pragma unroll
  for (int i = 0; i < kItems; ++i) s.key[t * kItems + i] = keys[i];
  __syncthreads();
  bool ordered = true;
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const int q = t * kItems + i;
    ordered &= q == 0 || s.key[q - 1] <= keys[i];
  }
  if (!__syncthreads_and(ordered)) {
    BlockSort(s.u.sort).Sort(keys, vals, 0, end_bit);
#pragma unroll
    for (int i = 0; i < kItems; ++i) s.key[t * kItems + i] = keys[i];
  }
  __syncthreads();
}

// One chunk of single-word atomics (B1, and B2's sub-phase 1): reply word 0
// of each op is the old value of its word.
template <bool kFused>
__device__ void apply_atomics(Smem& s, const int32_t* __restrict__ op,
                              int W, bool vec, int32_t* shard, long long L,
                              int32_t* reply, int RW, int n, int end_bit) {
  const int t = threadIdx.x;
  // each slot's word and effect, the slots spread over the threads
  for (int sl = t; sl < n; sl += kThreads) {
    const int4 o = head4(op, s.rows[sl], W, vec);
    const Effect e = !in_range(o.x, L) ? Effect{kFaa, 0, 0}
                     : kFused         ? fused_effect(o.y, o.z, o.w)
                                      : amo_effect(o.y, o.z, o.w);
    s.key[sl] = static_cast<uint32_t>(clip_idx(o.x, L));
    s.kind[sl] = static_cast<uint8_t>(e.kind);
    s.x[sl] = e.x;
    s.y[sl] = e.y;
  }
  __syncthreads();
  uint32_t keys[kItems];
  int vals[kItems];
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const int q = t * kItems + i;
    const int src = q;   // list order: the stable sort keeps it per word
    keys[i] = src < n ? s.key[src] : static_cast<uint32_t>(L);
    vals[i] = src;
  }
  __syncthreads();
  sort_chunk(s, keys, vals, end_bit);
  // the effects move to their sorted positions, so that a walk step reads
  // its operands with one shared load
  int kinds[kItems];
  int32_t xs[kItems], ys[kItems];
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const int sl = vals[i] < n ? vals[i] : 0;
    kinds[i] = s.kind[sl];
    xs[i] = s.x[sl];
    ys[i] = s.y[sl];
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const int q = t * kItems + i;
    s.slot[q] = vals[i];
    s.kind[q] = static_cast<uint8_t>(kinds[i]);
    s.x[q] = xs[i];
    s.y[q] = ys[i];
  }
  __syncthreads();

  // fold each fetch-and-op run: incl = operands from the run's head to q
  // (no scan where every op is a run of its own)
  RunItem it[kItems];
  bool lone = true;
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const int q = t * kItems + i;
    const bool head = q >= n || run_head(s, q);
    it[i] = run_item(static_cast<uint32_t>(xs[i]), q, kinds[i], head);
    lone &= head;
  }
  if (!__syncthreads_and(lone))
    RunScan(s.scan.run).InclusiveScan(it, it, RunFold());
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const int q = t * kItems + i;
    if (q < n) {
      const int h = static_cast<int>(it[i].meta >> 4);
      s.u.walk.incl[q] = it[i].v;
      s.u.walk.start[q] = h;
      if (q == n - 1 || run_head(s, q + 1)) s.u.walk.run_end[h] = q;
    }
  }
  __syncthreads();

  // one thread per word: read it once, step through its runs, write it
  // once (the words spread over the threads, their loads in flight
  // together)
  uint32_t first[kItems];
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const int q = t + i * kThreads;
    if (q < n && (q == 0 || s.key[q] != s.key[q - 1]))
      first[i] = static_cast<uint32_t>(shard[s.key[q]]);
  }
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const int q = t + i * kThreads;
    if (q >= n || (q > 0 && s.key[q] == s.key[q - 1])) continue;
    const uint32_t w = s.key[q];
    uint32_t cur = first[i];
    int e = q;
    while (e < n && s.key[e] == w) {
      const int k = s.kind[e];
      if (is_fao(k)) {
        s.u.walk.init[e] = cur;
        const int last = s.u.walk.run_end[e];
        cur = fao(cur, s.u.walk.incl[last], k);
        e = last + 1;
      } else {
        s.u.walk.old[e] = cur;
        if (k == kSet || cur == static_cast<uint32_t>(s.x[e]))
          cur = static_cast<uint32_t>(s.y[e]);
        ++e;
      }
    }
    shard[w] = static_cast<int32_t>(cur);
  }
  __syncthreads();

  // replies: a run's op gets the run's initial word op its exclusive prefix
  for (int q = t; q < n; q += kThreads) {
    const int k = s.kind[q];
    uint32_t old = s.u.walk.old[q];
    if (is_fao(k)) {
      const int h = s.u.walk.start[q];
      const uint32_t excl = h == q ? fao_identity(k) : s.u.walk.incl[q - 1];
      old = fao(s.u.walk.init[h], excl, k);
    }
    reply[static_cast<long long>(s.rows[s.slot[q]]) * RW] =
        static_cast<int32_t>(old);
  }
}

// One chunk of B2's sub-phase 2: the V-word puts of winning CAS_PUT[_PUB]
// ops at aux0 (dropped whole when out of range). Winners whose ranges are
// disjoint write in parallel; where two overlap, the later one in list
// order must own every shared word, so one thread writes the chunk. The
// overlap is found with a hash set of the covered words in shared memory
// (a chunk whose words could fill more than half of it counts as one with
// an overlap).
__device__ void apply_puts(Smem& s, const int32_t* __restrict__ op, int W,
                           bool vec, int32_t* shard, long long L,
                           const int32_t* reply, int RW, int V, int n) {
  const int t = threadIdx.x;
  for (int i = t; i < kSetWords; i += kThreads) s.u.set[i] = kNoWord;
  for (int sl = t; sl < n; sl += kThreads) {
    const long long row = s.rows[sl];
    const int4 o = head4(op, row, W, vec);
    const long long aux0 = op[row * W + 4];
    const bool put = (o.y == 7 || o.y == 8) && reply[row * RW] == o.z &&
                     aux0 >= 0 && aux0 <= L - V;
    s.key[sl] = put ? static_cast<uint32_t>(aux0) : kNoWord;
  }
  __syncthreads();
  bool overlap = static_cast<long long>(n) * V > kSetWords / 2;
  for (int sl = t; sl < n && !overlap; sl += kThreads) {
    if (s.key[sl] == kNoWord) continue;
    for (int v = 0; v < V && !overlap; ++v) {
      const uint32_t w = s.key[sl] + v;
      uint32_t h = (w * 2654435761u) >> (32 - kSetBits);
      for (;;) {
        const uint32_t was = atomicCAS(&s.u.set[h], kNoWord, w);
        if (was == kNoWord) break;
        if (was == w) {
          overlap = true;
          break;
        }
        h = (h + 1) & (kSetWords - 1);
      }
    }
  }
  if (__syncthreads_or(overlap)) {
    if (t == 0) {
      for (int k = 0; k < n; ++k) {   // list order: the last writer wins
        if (s.key[k] == kNoWord) continue;
        const int32_t* o = op + static_cast<long long>(s.rows[k]) * W;
        for (int v = 0; v < V; ++v) shard[s.key[k] + v] = o[6 + v];
      }
    }
  } else {
    for (int sl = t; sl < n; sl += kThreads) {
      if (s.key[sl] == kNoWord) continue;
      const int32_t* o = op + static_cast<long long>(s.rows[sl]) * W;
      for (int v = 0; v < V; ++v) shard[s.key[sl] + v] = o[6 + v];
    }
  }
}

__global__ void __launch_bounds__(kThreads, 1)
amo_apply_kernel(const int32_t* __restrict__ ops,
                 const uint8_t* __restrict__ mask, int32_t* old,
                 int32_t* out, long long L, long long m, int end_bit) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& s = *reinterpret_cast<Smem*>(smem_raw);
  const long long p = blockIdx.x;
  const uint8_t* mk = mask + p * m;
  const int32_t* op = ops + p * m * 4;
  int32_t* od = old + p * m;
  int32_t* shard = out + p * L;
  const bool vec = (reinterpret_cast<uintptr_t>(ops) & 15) == 0;
  const Ranks r = rank_live(s, mk, m);
  for_chunks(s, mk, r, [&](int n) {
    apply_atomics<false>(s, op, 4, vec, shard, L, od, 1, n, end_bit);
  });
}

__global__ void __launch_bounds__(kThreads, 1)
fused_apply_kernel(const int32_t* __restrict__ ops,
                   const uint8_t* __restrict__ mask, int32_t* reply,
                   int32_t* out, long long L, long long m, int W, int RW,
                   int end_bit) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& s = *reinterpret_cast<Smem*>(smem_raw);
  const long long p = blockIdx.x;
  const int V = W - 6;
  const int G = RW - 1;
  const uint8_t* mk = mask + p * m;
  const int32_t* op = ops + p * m * W;
  int32_t* rp = reply + p * m * RW;
  int32_t* shard = out + p * L;
  const bool vec = (W & 3) == 0 && (reinterpret_cast<uintptr_t>(ops) & 15) == 0;
  const Ranks r = rank_live(s, mk, m);

  // 1. atomics, in list order per word; reply word 0 = old value at off
  for_chunks(s, mk, r, [&](int n) {
    apply_atomics<true>(s, op, W, vec, shard, L, rp, RW, n, end_bit);
  });

  // 2. V-word puts of winning CAS_PUT[_PUB] at aux0; the win is recomputed
  //    from the recorded old value
  if (V > 0) {
    for_chunks(s, mk, r, [&](int n) {
      apply_puts(s, op, W, vec, shard, L, rp, RW, V, n);
    });
  }

  // 3. publish flips of winning CAS_PUT_PUB: mem[off] ^= aux1, in any order
  for_chunks(s, mk, r, [&](int n) {
    for (int k = threadIdx.x; k < n; k += kThreads) {
      const long long j = s.rows[k];
      const int4 o = head4(op, j, W, vec);
      const int32_t aux1 = op[j * W + 5];
      if (o.y == 8 && rp[j * RW] == o.z && in_range(o.x, L))
        atomicXor(shard + clip_idx(o.x, L), aux1);
    }
  });

  // 4. FAO_GET gathers of G words from aux0: a phase-end snapshot
  if (G > 0) {
    for_chunks(s, mk, r, [&](int n) {
      for (int k = threadIdx.x; k < n; k += kThreads) {
        const long long j = s.rows[k];
        const int32_t code = op[j * W + 1];
        const long long aux0 = op[j * W + 4];
        if (code == 9 && aux0 >= 0 && aux0 <= L - G) {
          for (int g = 0; g < G; ++g) rp[j * RW + 1 + g] = shard[aux0 + g];
        }
      }
    });
  }
}

}  // namespace

// The dynamic shared memory of an apply block, in bytes (ptxas reports
// only static shared memory).
extern "C" long long repro_owner_lane_smem_bytes() { return sizeof(Smem); }

// C interface, loaded with ctypes. Pointers are device pointers of
// contiguous tensors; `stream` is the caller's cudaStream_t. L is in
// [1, 2**31) and m below 2**31 (the wrapper checks). Each launches the copy
// and then the apply on that stream and returns cudaGetLastError().
extern "C" int repro_amo_apply(const void* local, const void* ops,
                               const void* mask, void* old, void* out,
                               long long P, long long L, long long m,
                               void* stream) {
  if (P > 0) {
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    amo_apply_copy_kernel<<<copy_blocks(P * L > P * m ? P * L : P * m),
                            kCopyThreads, 0, st>>>(
        static_cast<const int32_t*>(local), static_cast<int32_t*>(out),
        P * L, static_cast<int32_t*>(old), P * m);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess || m == 0) return static_cast<int>(err);
    err = cudaFuncSetAttribute(amo_apply_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(sizeof(Smem)));
    if (err != cudaSuccess) return static_cast<int>(err);
    amo_apply_kernel<<<static_cast<unsigned>(P), kThreads, sizeof(Smem),
                       st>>>(
        static_cast<const int32_t*>(ops), static_cast<const uint8_t*>(mask),
        static_cast<int32_t*>(old), static_cast<int32_t*>(out), L, m,
        key_bits(L));
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int repro_fused_apply(const void* local, const void* ops,
                                 const void* mask, void* reply, void* out,
                                 long long P, long long L, long long m,
                                 int width, int reply_width, void* stream) {
  if (P > 0) {
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    const long long n_reply = P * m * reply_width;
    fused_apply_copy_kernel<<<copy_blocks(P * L > n_reply ? P * L : n_reply),
                              kCopyThreads, 0, st>>>(
        static_cast<const int32_t*>(local), static_cast<int32_t*>(out),
        P * L, static_cast<int32_t*>(reply), n_reply);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess || m == 0) return static_cast<int>(err);
    err = cudaFuncSetAttribute(fused_apply_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(sizeof(Smem)));
    if (err != cudaSuccess) return static_cast<int>(err);
    fused_apply_kernel<<<static_cast<unsigned>(P), kThreads, sizeof(Smem),
                         st>>>(
        static_cast<const int32_t*>(ops), static_cast<const uint8_t*>(mask),
        static_cast<int32_t*>(reply), static_cast<int32_t*>(out), L, m,
        width, reply_width, key_bits(L));
  }
  return static_cast<int>(cudaGetLastError());
}

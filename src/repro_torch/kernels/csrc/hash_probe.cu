// hash_probe.cu — the RPC hash-table handler bodies on Hopper.
//
// Replaces the two Pallas TPU kernels of repro/kernels/hash_probe.py:
//   B3 _find_kernel / hash_find      -> hash_find_kernel
//   B4 _insert_kernel / hash_insert  -> hash_insert_copy_kernel +
//                                       hash_insert_kernel
// with the contract of repro_torch/kernels/ref.py (hash_find, hash_insert).
// Table layout: (P, L) int32, nslots records of rec_w words
// [flag | key | val...] per owner; flag low byte 2 = READY, 0 = EMPTY.
// A probe at slot s reads the record at s * rec_w, clamped so the slice
// stays inside the shard, as lax.dynamic_slice does.
//
// B3, find. Requests are independent: one thread per request on a grid of
// (ceil(m / 128), P) blocks of 128 threads. Each probe reads rec_w words
// from device memory. The Pallas kernel kept the owner's whole table
// resident in VMEM; that does not carry over (a slice-size shard is 3 MB,
// a block may hold 227 KB of shared memory), so the bound here is bytes:
// live requests x probes taken x rec_w x 4 B at 3.35 TB/s. The probes of
// neighbouring requests land on unrelated slots, so each probe costs at
// least one 32-byte sector; with hundreds of requests in flight per SM the
// kernel hides the latency of those scattered reads.
//
// B4, insert-or-assign, out of place. Request j must see the requests
// before it at its owner, but only where their probe windows meet: request
// j probes slots (s0 + i) mod nslots for i < max_probes, s0 = start mod
// nslots, and writes only the slot where it stops, so it reads and writes
// nothing outside its window [s0, s0 + W) on the ring, W = min(max_probes,
// nslots). Requests whose windows are disjoint commute. So what is serial
// is a component (requests chained by overlapping windows), not the
// owner's list. The function must read and write every shard once: bytes
// bound it, as they bound the owner lanes.
//
// What the design does about it. Two launches per wrapper call (the
// wrapper's launch counter counts calls):
//  1. hash_insert_copy_kernel copies the shards to `out` and zeroes `ok`
//     and `probes` over every SM (owner_list.cuh).
//  2. hash_insert_kernel runs one block per owner. A block prefix count
//     over the mask (16-byte loads) ranks the live rows in list order; the
//     live list is taken in ordered chunks of kChunk, each finished before
//     the next. Per chunk:
//     - the requests' window starts and keys are gathered into shared
//       memory, spread over the threads;
//     - a stable CUB block radix sort orders them by window start; a
//       component begins where the gap to the previous start is >= W, and
//       on the ring the last component joins the first when their windows
//       meet across slot nslots - 1;
//     - a second stable sort, by component over the list-ordered requests,
//       puts each component's members in list order;
//     - one thread per component walks its members in list order against
//       `out`, with the probe and write of the serial walk.
//     When records alias (nslots * rec_w > L, so the clamped slices of
//     different slots share words), the whole chunk is one component,
//     walked by one thread in list order.
#include <cstdint>
#include <cuda_runtime.h>
#include <cub/block/block_radix_sort.cuh>
#include <cub/block/block_scan.cuh>

#include "owner_list.cuh"

namespace {

constexpr int kFindThreads = 128;
constexpr int kInsertThreads = 512;
constexpr int kItems = 8;                        // requests a thread holds
constexpr int kChunk = kInsertThreads * kItems;  // live requests per round
constexpr int kCompBits = 13;                    // component ids <= kChunk
constexpr int32_t kStateMask = 255;
constexpr int32_t kEmpty = 0;
constexpr int32_t kReady = 2;

__device__ __forceinline__ long long floor_mod(long long a, long long n) {
  const long long r = a % n;
  return r < 0 ? r + n : r;
}

// start of a `size`-word slice at s, as lax.dynamic_slice places it
__device__ __forceinline__ long long slice_start(long long s, long long size,
                                                 long long n) {
  long long j = s < 0 ? s + n : s;
  if (j < 0) j = 0;
  return j > n - size ? n - size : j;
}

__global__ void __launch_bounds__(kFindThreads)
hash_find_kernel(const int32_t* __restrict__ table,
                 const int32_t* __restrict__ starts,
                 const int32_t* __restrict__ keys,
                 const uint8_t* __restrict__ mask,
                 uint8_t* __restrict__ found, int32_t* __restrict__ vals,
                 long long L, long long m, long long nslots, int rec_w,
                 int max_probes) {
  const long long p = blockIdx.y;
  const long long j = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (j >= m) return;
  const long long idx = p * m + j;
  const int vw = rec_w - 2;
  const int32_t* t = table + p * L;
  bool hit = false;
  long long hb = 0;
  if (mask[idx]) {
    const long long start = starts[idx];
    const int32_t key = keys[idx];
    for (int pr = 0; pr < max_probes; ++pr) {
      const long long s = floor_mod(start + pr, nslots);
      const long long b = slice_start(s * rec_w, rec_w, L);
      const int32_t state = t[b] & kStateMask;
      if (state == kReady && t[b + 1] == key) {
        hit = true;
        hb = b;
        break;
      }
      if (state == kEmpty) break;
    }
  }
  found[idx] = hit ? 1 : 0;
  for (int w = 0; w < vw; ++w) vals[idx * vw + w] = hit ? t[hb + 2 + w] : 0;
}

// ---------------------------------------------------------------------------
// B4 launch 1: copy every shard, zero ok and probes, across the whole card
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kCopyThreads)
hash_insert_copy_kernel(const int32_t* __restrict__ table,
                        int32_t* __restrict__ out, long long n,
                        uint8_t* __restrict__ ok,
                        int32_t* __restrict__ probes, long long n_req) {
  copy_words(table, out, n);
  zero_bytes(ok, n_req);
  zero_words(probes, n_req);
}

// ---------------------------------------------------------------------------
// B4 launch 2: one block per owner
// ---------------------------------------------------------------------------
using InsertSort = cub::BlockRadixSort<uint32_t, kInsertThreads, kItems, int>;
using InsertScan = cub::BlockScan<int, kInsertThreads>;

struct InsertSmem {
  int rows[kChunk];         // list position in the chunk -> row
  uint32_t start[kChunk];   // per list position: the window start s0
  int32_t key[kChunk];      // per list position: the key
  uint32_t sorted[kChunk];  // the window starts in sorted order
  int comp[kChunk];         // per list position: the component
  int order[kChunk];        // walk position -> list position
  int cid[kChunk];          // walk position -> component
  union {
    InsertSort::TempStorage sort;
    InsertScan::TempStorage scan;
  } u;
};

// Fill s.order and s.cid for the chunk's n requests: the walk visits each
// component's members together and in list order, and components follow
// one another in any order.
__device__ void group_chunk(InsertSmem& s, int n, long long nslots,
                            long long W, bool alias, int start_bits) {
  const int t = threadIdx.x;
  if (alias) {   // the chunk is one component, in list order
    for (int q = t; q < n; q += kInsertThreads) {
      s.order[q] = q;
      s.cid[q] = 0;
    }
    __syncthreads();
    return;
  }
  // sort by window start (stable; nslots pads the chunk to kChunk)
  uint32_t keys[kItems];
  int vals[kItems];
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const int q = t * kItems + i;
    keys[i] = q < n ? s.start[q] : static_cast<uint32_t>(nslots);
    vals[i] = q;
  }
  InsertSort(s.u.sort).Sort(keys, vals, 0, start_bits);
#pragma unroll
  for (int i = 0; i < kItems; ++i) s.sorted[t * kItems + i] = keys[i];
  __syncthreads();
  // a component begins where the gap to the previous start is >= W
  int head[kItems], id[kItems];
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const int q = t * kItems + i;
    head[i] = q < n && (q == 0 || static_cast<long long>(s.sorted[q]) -
                                          s.sorted[q - 1] >= W);
  }
  int ncomp;
  InsertScan(s.u.scan).InclusiveSum(head, id, ncomp);
  // on the ring, the last component's windows run on past nslots - 1 into
  // the first component's
  const bool wrap = ncomp > 1 && static_cast<long long>(s.sorted[0]) +
                                         nslots - s.sorted[n - 1] < W;
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const int q = t * kItems + i;
    if (q < n) {
      const int c = id[i] - 1;
      s.comp[vals[i]] = wrap && c == ncomp - 1 ? 0 : c;
    }
  }
  __syncthreads();
  // each component's members in list order: a stable sort by component of
  // the requests taken in list order
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const int q = t * kItems + i;
    keys[i] = q < n ? static_cast<uint32_t>(s.comp[q]) : kChunk;
    vals[i] = q;
  }
  InsertSort(s.u.sort).Sort(keys, vals, 0, kCompBits);
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const int q = t * kItems + i;
    if (q < n) {
      s.order[q] = vals[i];
      s.cid[q] = static_cast<int>(keys[i]);
    }
  }
  __syncthreads();
}

// One request of the serial walk: probe its window from s0 until its key
// or an empty slot, write the record there, report ok and the probes taken.
__device__ __forceinline__ void insert_one(
    int32_t* shard, long long L, long long nslots, int rec_w, int max_probes,
    long long s0, int32_t key, const int32_t* __restrict__ val,
    uint8_t* ok, int32_t* probes_out) {
  long long slot = -1;
  int kind = 0;  // 0 searching, 1 key found, 2 empty slot
  int32_t probes = 0;
  for (int pr = 0; pr < max_probes && kind == 0; ++pr) {
    const long long s = (s0 + pr) % nslots;
    const long long b = slice_start(s * rec_w, 2, L);
    const int32_t state = shard[b] & kStateMask;
    ++probes;
    if (state == kReady && shard[b + 1] == key) {
      slot = s;
      kind = 1;
    } else if (state == kEmpty) {
      slot = s;
      kind = 2;
    }
  }
  if (kind > 0) {
    const long long rb = slice_start(slot * rec_w, rec_w, L);
    shard[rb] = kReady;
    shard[rb + 1] = key;
    for (int w = 0; w < rec_w - 2; ++w) shard[rb + 2 + w] = val[w];
    *ok = 1;
  }
  *probes_out = probes;
}

__global__ void __launch_bounds__(kInsertThreads, 1)
hash_insert_kernel(const int32_t* __restrict__ starts,
                   const int32_t* __restrict__ keys,
                   const int32_t* __restrict__ vals,
                   const uint8_t* __restrict__ mask, uint8_t* ok,
                   int32_t* probes_out, int32_t* out, long long L,
                   long long m, long long nslots, int rec_w, int max_probes,
                   int start_bits) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  InsertSmem& s = *reinterpret_cast<InsertSmem*>(smem_raw);
  const long long p = blockIdx.x;
  const int t = threadIdx.x;
  const int vw = rec_w - 2;
  const uint8_t* mk = mask + p * m;
  int32_t* shard = out + p * L;
  const long long W = max(0LL, min(static_cast<long long>(max_probes),
                                   nslots));
  const bool alias = nslots * rec_w > L;

  // rank the live rows: this thread's hold [first, first + count)
  const Stretch st = my_stretch<kInsertThreads>(mk, m);
  const int count = count_live(mk, st);
  int first, total;
  InsertScan(s.u.scan).ExclusiveSum(count, first, total);
  __syncthreads();

  for (int c0 = 0; c0 < total; c0 += kChunk) {
    const int n = min(kChunk, total - c0);
    if (first < c0 + n && first + count > c0) {
      int rank = first;
      for_live(mk, st, [&](long long j) {
        const int k = rank - c0;
        if (k >= 0 && k < n) s.rows[k] = static_cast<int>(j);
        ++rank;
      });
    }
    __syncthreads();
    for (int k = t; k < n; k += kInsertThreads) {
      const long long idx = p * m + s.rows[k];
      s.start[k] = static_cast<uint32_t>(floor_mod(starts[idx], nslots));
      s.key[k] = keys[idx];
    }
    __syncthreads();
    group_chunk(s, n, nslots, W, alias, start_bits);
    // one thread per component, its members in list order
    for (int q = t; q < n; q += kInsertThreads) {
      if (q > 0 && s.cid[q] == s.cid[q - 1]) continue;
      int end = q + 1;
      while (end < n && s.cid[end] == s.cid[q]) ++end;
      for (int e = q; e < end; ++e) {   // list order within the component
        const int k = s.order[e];
        const long long idx = p * m + s.rows[k];
        insert_one(shard, L, nslots, rec_w, max_probes, s.start[k],
                   s.key[k], vals + idx * vw, ok + idx, probes_out + idx);
      }
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" int repro_hash_find(const void* table, const void* starts,
                               const void* keys, const void* mask,
                               void* found, void* vals, long long P,
                               long long L, long long m, long long nslots,
                               int rec_w, int max_probes, void* stream) {
  if (P > 0 && m > 0) {
    const dim3 grid(static_cast<unsigned>((m + kFindThreads - 1) /
                                          kFindThreads),
                    static_cast<unsigned>(P));
    hash_find_kernel<<<grid, kFindThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(table),
        static_cast<const int32_t*>(starts),
        static_cast<const int32_t*>(keys), static_cast<const uint8_t*>(mask),
        static_cast<uint8_t*>(found), static_cast<int32_t*>(vals), L, m,
        nslots, rec_w, max_probes);
  }
  return static_cast<int>(cudaGetLastError());
}

// The dynamic shared memory of an insert block, in bytes (ptxas reports
// only static shared memory).
extern "C" long long repro_hash_insert_smem_bytes() {
  return sizeof(InsertSmem);
}

// nslots in [1, 2**31), m below 2**31 and L >= rec_w >= 2 (the wrapper
// checks). Launches the copy and then the insert on `stream`.
extern "C" int repro_hash_insert(const void* table, const void* starts,
                                 const void* keys, const void* vals,
                                 const void* mask, void* ok, void* probes,
                                 void* out, long long P, long long L,
                                 long long m, long long nslots, int rec_w,
                                 int max_probes, void* stream) {
  if (P > 0) {
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    hash_insert_copy_kernel<<<copy_blocks(P * L > P * m ? P * L : P * m),
                              kCopyThreads, 0, st>>>(
        static_cast<const int32_t*>(table), static_cast<int32_t*>(out),
        P * L, static_cast<uint8_t*>(ok), static_cast<int32_t*>(probes),
        P * m);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess || m == 0) return static_cast<int>(err);
    err = cudaFuncSetAttribute(hash_insert_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(sizeof(InsertSmem)));
    if (err != cudaSuccess) return static_cast<int>(err);
    hash_insert_kernel<<<static_cast<unsigned>(P), kInsertThreads,
                         sizeof(InsertSmem), st>>>(
        static_cast<const int32_t*>(starts),
        static_cast<const int32_t*>(keys), static_cast<const int32_t*>(vals),
        static_cast<const uint8_t*>(mask), static_cast<uint8_t*>(ok),
        static_cast<int32_t*>(probes), static_cast<int32_t*>(out), L, m,
        nslots, rec_w, max_probes, key_bits(nslots));
  }
  return static_cast<int>(cudaGetLastError());
}

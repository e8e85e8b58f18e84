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
// B3, find. Requests are independent, and the Pallas kernel kept the
// owner's whole table resident in VMEM; that does not carry over (a
// slice-size shard is 3 MB, a block may hold 227 KB of shared memory).
// What the function must move is the mask, `found` and `vals` in full and,
// for live requests only, their starts, keys and the records their probes
// read: at the first RPC find of the slice (P = 64 owners x m = 65,536
// slots, about 1,024 live an owner) that is 26.8 MB, mostly the dense
// outputs, so bytes bound it. The first port ran one thread a slot on
// 32,768 blocks: 98.4% of the threads loaded one mask byte, stored one
// byte and vw words and quit, and the live ones, about one a warp, each
// walked their probe chain alone.
//
// What the design does about it. A warp takes 512 consecutive slots of the
// flat (P, m) order (a group may span two owners' rows; a live slot finds
// its owner by division), 16 a lane, on a grid of a few blocks per SM
// that strides over them:
//  - each lane reads its 16 mask bytes with one 16-byte load;
//  - the warp zeroes its 512 `found` bytes and 512 x vw `vals` words with
//    16-byte stores (16 x vw words start 16-byte aligned for any vw), so
//    dead slots never touch the table;
//  - the live slots are compacted (popc, a warp scan) into a queue in
//    shared memory, and the 32 lanes take one live request each and walk
//    its probes: up to 32 chains in flight a warp instead of about one;
//    a hit overwrites its slot's zeros (ordered after them by __syncwarp).
// Scalar loads and stores take a warp's slots where they pass the end or a
// pointer is not 16-byte aligned.
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

constexpr int kFindThreads = 256;
constexpr int kGroup = 16;                       // find: slots a lane takes
constexpr int kWarpSlots = 32 * kGroup;          // find: slots a warp takes
constexpr int kFindBlocksPerSm = 8;
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

// one probe chain: the first word of the record it hits, or -1
__device__ __forceinline__ long long find_one(const int32_t* __restrict__ t,
                                              long long L, long long nslots,
                                              int rec_w, int max_probes,
                                              long long start, int32_t key) {
  for (int pr = 0; pr < max_probes; ++pr) {
    const long long s = floor_mod(start + pr, nslots);
    const long long b = slice_start(s * rec_w, rec_w, L);
    const int32_t state = t[b] & kStateMask;
    if (state == kReady && t[b + 1] == key) return b;
    if (state == kEmpty) return -1;
  }
  return -1;
}

// the bytes of w that are not zero, as 4 bits
__device__ __forceinline__ unsigned nonzero_bytes(unsigned w) {
  return ((w & 0xffu) != 0) | ((w & 0xff00u) != 0) << 1 |
         ((w & 0xff0000u) != 0) << 2 | ((w & 0xff000000u) != 0) << 3;
}

// n = P * m slots; vec: mask, found and vals are 16-byte aligned
__global__ void __launch_bounds__(kFindThreads)
hash_find_kernel(const int32_t* __restrict__ table,
                 const int32_t* __restrict__ starts,
                 const int32_t* __restrict__ keys,
                 const uint8_t* __restrict__ mask,
                 uint8_t* __restrict__ found, int32_t* __restrict__ vals,
                 long long L, long long m, long long n, long long nslots,
                 int rec_w, int max_probes, bool vec) {
  __shared__ uint16_t queue[kFindThreads / 32][kWarpSlots];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  uint16_t* q = queue[warp];
  const int vw = rec_w - 2;
  const uint4 zero = make_uint4(0, 0, 0, 0);
  const long long n_tiles = (n + kWarpSlots - 1) / kWarpSlots;
  const long long stride = static_cast<long long>(gridDim.x) *
                           (kFindThreads / 32);
  for (long long wt = static_cast<long long>(blockIdx.x) *
                      (kFindThreads / 32) + warp;
       wt < n_tiles; wt += stride) {
    const long long s0 = wt * kWarpSlots;
    const long long g0 = s0 + lane * kGroup;        // this lane's 16 slots
    const bool wide = vec && s0 + kWarpSlots <= n;
    unsigned bits = 0;                               // live slots of g0..
    if (wide) {
      const uint4 v = reinterpret_cast<const uint4*>(mask)[g0 / kGroup];
      bits = nonzero_bytes(v.x) | nonzero_bytes(v.y) << 4 |
             nonzero_bytes(v.z) << 8 | nonzero_bytes(v.w) << 12;
      reinterpret_cast<uint4*>(found)[g0 / kGroup] = zero;
      uint4* v4 = reinterpret_cast<uint4*>(vals + s0 * vw);
      for (int j = lane; j < kWarpSlots / 4 * vw; j += 32) v4[j] = zero;
    } else {
      const long long end = s0 + kWarpSlots < n ? s0 + kWarpSlots : n;
      for (int k = 0; k < kGroup; ++k)
        if (g0 + k < end && mask[g0 + k]) bits |= 1u << k;
      for (long long i = s0 + lane; i < end; i += 32) found[i] = 0;
      for (long long i = s0 * vw + lane; i < end * vw; i += 32) vals[i] = 0;
    }
    // the warp's live slots, in a queue of offsets from s0
    const int live = __popc(bits);
    int incl = live;
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, incl, d);
      if (lane >= d) incl += y;
    }
    const int total = __shfl_sync(0xffffffffu, incl, 31);
    int at = incl - live;
    for (unsigned rest = bits; rest; rest &= rest - 1)
      q[at++] = static_cast<uint16_t>(lane * kGroup + __ffs(rest) - 1);
    __syncwarp();
    // one live request a lane
    for (int j = lane; j < total; j += 32) {
      const long long idx = s0 + q[j];
      const int32_t* t = table + (idx / m) * L;
      const long long hb = find_one(t, L, nslots, rec_w, max_probes,
                                    starts[idx], keys[idx]);
      if (hb >= 0) {
        found[idx] = 1;
        for (int w = 0; w < vw; ++w) vals[idx * vw + w] = t[hb + 2 + w];
      }
    }
    __syncwarp();
  }
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
  const long long n = P * m;
  if (n > 0) {
    int dev = 0, sms = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    const long long tiles = (n + kWarpSlots - 1) / kWarpSlots;
    const long long need = (tiles + kFindThreads / 32 - 1) /
                           (kFindThreads / 32);
    const long long most = static_cast<long long>(sms) * kFindBlocksPerSm;
    const bool vec = ((reinterpret_cast<uintptr_t>(mask) |
                       reinterpret_cast<uintptr_t>(found) |
                       reinterpret_cast<uintptr_t>(vals)) & 15) == 0;
    hash_find_kernel<<<static_cast<unsigned>(need < most ? need : most),
                       kFindThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(table),
        static_cast<const int32_t*>(starts),
        static_cast<const int32_t*>(keys), static_cast<const uint8_t*>(mask),
        static_cast<uint8_t*>(found), static_cast<int32_t*>(vals), L, m, n,
        nslots, rec_w, max_probes, vec);
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

// moe_dispatch.cu — expert histogram and stable positions on Hopper.
//
// Replaces the Pallas TPU kernel B7 of repro/kernels/moe_dispatch.py
// (_dispatch_kernel / moe_dispatch) with the contract of
// repro_torch/kernels/ref.py moe_dispatch: for ids (T,) int32,
//   counts[e] = #{i : id_i == e},
//   pos[i]    = #{j < i : id_j == id_i},
// the ticket each token would draw from FAA(counter[id_i], 1) if the T
// fetch-and-adds ran in token order. Outside [0, E) the oracle's one-hot
// and fill-mode gather decide: such an id counts for no expert, an id in
// [-E, 0) reads the position of expert id + E, any other id gets INT32_MIN.
//
// The Pallas kernel walked tiles of ids in grid order on one core and
// carried E running counters in VMEM from grid step to grid step. Blocks
// here run in no order, so the carry has to be rebuilt. The first port
// kept it inside one block per expert, each scanning all T ids in token
// order: E blocks (64 on 132 SMs) each walking T / 256 serial tiles, one
// L2 load and two barriers a tile with nothing else in flight, so its time
// grew with T and no more of the card took part (about 0.3-0.6 ms at the
// 196,608 ids of a 32,768-token deepseek-moe-16b prefill).
//
// Bound: bytes (T ids read, T positions and E counts written: 1.57 MB,
// 0.0005 ms at that prefill); what a call costs above that is latency.
// So the ids are cut into tiles of kTile (2,048) ids, one block a tile,
// all tiles at once (96 blocks at that prefill), in two launches:
//  1. moe_count_kernel: each block counts its tile per expert in shared
//     memory (warp-aggregated atomics: counts do not depend on order) and
//     writes row b of a (tiles, E) int32 table.
//  2. moe_rank_kernel: each block sums the rows of the tiles before it
//     (its base per expert) and ranks its own ids in token order. Warp w
//     owns 128 consecutive ids of the tile, four sub-rounds of 32, whose
//     ids sit in registers. A sub-round's peers (lanes whose id is this
//     lane's column) come from __match_any_sync; its rank is the warp's
//     running count of that column plus popc(peers & lanes below). A
//     (warps x E) table of the warps' counts, scanned down the warp axis
//     from the block's base, gives each warp its base per column.
//     The last block writes `counts`.
// An id in [-E, 0) ranks in column id + E against the in-range ids of
// that column only, so __match_any_sync(id) cannot find its peers: a warp
// holding such an id takes a 32-step shuffle loop instead.
// A tile of more than kTile ids (very long T: the table keeps at most
// kTableWords counts, so that no block sums more than that) is walked
// kTile ids at a time, carrying the base.
// The first port's kernel stays for two ranges, where it is the faster
// or the only one (moe_serial_kernel: one block per expert scanning every
// id): T <= kSerialIds (6,144 ids; a decode step of 8 tokens x top-6 is
// 48), where its few serial tiles cost less than a second launch (on an
// NVIDIA H100 80GB HBM3 at 700 W, 6,144 ids over 64 experts take it
// 0.0123 ms and the two launches 0.0141; 8,192 ids 0.0150 and 0.0140:
// scripts/kernel_ab.py moe_dispatch --sweep), and E > kMaxExperts
// (2,048; the (warps + 1) x E counters of a rank block must fit in
// shared memory). Every config in configs/ has E <= 128.
//
// The table lives in the caller's `counts` buffer after the E counts, so
// the C interface is the first port's; repro_moe_dispatch_work_words
// gives the buffer's size, from which kernels/moe_dispatch.py allocates.
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 2048;            // ids a rank block takes per round
constexpr int kThreads = 512;          // 16 warps
constexpr int kWarps = kThreads / 32;
constexpr int kWarpIds = kTile / kWarps;      // 128 ids a warp
constexpr int kSub = kWarpIds / 32;           // 4 sub-rounds of 32
constexpr int kMaxExperts = 2048;
constexpr long long kTableWords = 65536;
constexpr unsigned kFull = 0xffffffffu;
constexpr long long kSerialIds = 6144;  // T at or below: the serial kernel

// the serial kernel takes the call: no tiles and no table
bool serial(long long T, int E) { return E > kMaxExperts || T <= kSerialIds; }

// ids per tile: kTile, or a multiple of it where T / kTile tiles would
// hold more than kTableWords counts
long long tile_ids(long long T, int E) {
  long long max_tiles = kTableWords / E;
  if (max_tiles < 1) max_tiles = 1;
  return kTile * ((T + kTile * max_tiles - 1) / (kTile * max_tiles));
}

long long tiles_of(long long T, int E) {
  if (serial(T, E)) return 0;
  const long long tile = tile_ids(T, E);
  return (T + tile - 1) / tile;
}

// lanes whose id is this lane's column (in-range ids only): the shuffle
// loop a warp takes where it holds an id in [-E, 0)
__device__ __noinline__ unsigned column_peers(int32_t id, int col) {
  unsigned peers = 0;
  for (int j = 0; j < 32; ++j)
    peers |= (__shfl_sync(kFull, id, j) == col ? 1u : 0u) << j;
  return peers;
}

// The column of an id (the id in [0, E), id + E in [-E, 0), else -1) and
// its peers in the warp: the lanes whose id is that column.
// __match_any_sync(id) gives them only where no lane holds an id in
// [-E, 0): such a lane ranks against the in-range ids of its column.
__device__ __forceinline__ unsigned peers_of(int32_t id, int E, int* col) {
  const bool inr = id >= 0 && id < E;
  const bool neg = id < 0 && id >= -E;
  *col = inr ? id : neg ? id + E : -1;
  if (__any_sync(kFull, neg)) return column_peers(id, *col);
  return __match_any_sync(kFull, id);
}

// peers in lanes below this one: the rank within a sub-round
__device__ __forceinline__ int below(unsigned peers) {
  return __popc(peers & ((1u << (threadIdx.x & 31)) - 1u));
}

__global__ void __launch_bounds__(kThreads)
moe_count_kernel(const int32_t* __restrict__ ids, int32_t* __restrict__ table,
                 long long T, int E, long long tile) {
  extern __shared__ int hist[];        // E
  for (int e = threadIdx.x; e < E; e += kThreads) hist[e] = 0;
  __syncthreads();
  const long long lo = static_cast<long long>(blockIdx.x) * tile;
  const long long hi = lo + tile < T ? lo + tile : T;
#pragma unroll 4
  for (long long i0 = lo; i0 < hi; i0 += kThreads) {
    const long long i = i0 + threadIdx.x;
    const int32_t id = i < hi ? ids[i] : -1;
    const bool inr = id >= 0 && id < E;
    const unsigned peers = __match_any_sync(kFull, inr ? id : -1);
    if (inr && below(peers) == 0) atomicAdd(&hist[id], __popc(peers));
  }
  __syncthreads();
  for (int e = threadIdx.x; e < E; e += kThreads)
    table[static_cast<long long>(blockIdx.x) * E + e] = hist[e];
}

// warp `warp`'s ids of the round at r0 (INT_MIN past its stretch)
__device__ __forceinline__ void load_round(const int32_t* __restrict__ ids,
                                           int32_t (&id)[kSub], long long r0,
                                           long long hi, int warp, int lane) {
  const long long r1 = r0 + kTile < hi ? r0 + kTile : hi;
  const long long w0 = r0 + static_cast<long long>(warp) * 32 * kSub;
#pragma unroll
  for (int k = 0; k < kSub; ++k) {
    const long long i = w0 + 32 * k + lane;
    id[k] = i < r1 ? ids[i] : INT_MIN;
  }
}

// One block a tile, kThreads threads; dynamic shared memory
// (kWarps + 1) x E ints. table: the (gridDim.x, E) tile counts.
__global__ void __launch_bounds__(kThreads)
moe_rank_kernel(const int32_t* __restrict__ ids,
                const int32_t* __restrict__ table,
                int32_t* __restrict__ counts, int32_t* __restrict__ pos,
                long long T, int E, long long tile) {
  extern __shared__ int smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int b = blockIdx.x;
  const long long lo = static_cast<long long>(b) * tile;
  const long long hi = lo + tile < T ? lo + tile : T;
  int32_t id[kSub];
  load_round(ids, id, lo, hi, warp, lane);      // in flight from the start
  int* cnt = smem;        // [kWarps][E]: the warps' counts, then their bases
  int* base = smem + kWarps * E;    // [E]: ids of each expert before
  int* mine = cnt + warp * E;
  // each warp zeroes its own counters; each scan thread its base columns
  for (int e = lane; e < E; e += 32) mine[e] = 0;
  for (int e = threadIdx.x; e < E; e += kThreads) base[e] = 0;
  if (b > 0) {
    // the block's base: the counts of the tiles before it, R threads a
    // column
    __syncthreads();
    const int R = kThreads >= E ? kThreads / E : 1;
    for (int c = threadIdx.x; c < R * E; c += kThreads) {
      const int e = c % E, r = c / E;
      int s = 0;
#pragma unroll 4
      for (int t = r; t < b; t += R)
        s += table[static_cast<long long>(t) * E + e];
      if (s) atomicAdd(&base[e], s);
    }
  }
  __syncwarp();
  const bool last_block = b == static_cast<int>(gridDim.x) - 1;
  for (long long r0 = lo;; r0 += kTile) {
    // this round: warp w ranks ids [w0, w1), 32 a sub-round
    const long long w0 = r0 + static_cast<long long>(warp) * 32 * kSub;
    const long long r1 = r0 + kTile < hi ? r0 + kTile : hi;
    const long long w1 = w0 + 32 * kSub < r1 ? w0 + 32 * kSub : r1;
    int col[kSub], rank[kSub];
#pragma unroll
    for (int k = 0; k < kSub; ++k) {
      if (w0 + 32 * k >= w1) break;              // the warp's stretch ends
      const unsigned peers = peers_of(id[k], E, &col[k]);
      const int before = below(peers);
      const int run = col[k] >= 0 ? mine[col[k]] : 0;
      __syncwarp();
      if (col[k] == id[k] && before == 0)            // in range
        mine[id[k]] = run + __popc(peers);
      __syncwarp();
      rank[k] = run + before;
    }
    const bool more = r0 + kTile < hi;
    if (more) load_round(ids, id, r0 + kTile, hi, warp, lane);
    __syncthreads();
    // scan the warps' counts down the warp axis from the running base
    for (int e = threadIdx.x; e < E; e += kThreads) {
      int s = base[e];
      for (int w = 0; w < kWarps; ++w) {
        const int c = cnt[w * E + e];
        cnt[w * E + e] = s;
        s += c;
      }
      base[e] = s;
      if (last_block && !more) counts[e] = s;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kSub; ++k) {
      const long long i = w0 + 32 * k + lane;
      if (i < w1) pos[i] = col[k] >= 0 ? mine[col[k]] + rank[k] : INT_MIN;
    }
    if (!more) break;
    __syncwarp();
    for (int e = lane; e < E; e += 32) mine[e] = 0;   // for the next round
    __syncwarp();
  }
}

// serial(T, E): one block per expert scans all T ids in token order,
// 256 at a time, with a block-wide exclusive count of (id == e).
constexpr int kSerialThreads = 256;

__global__ void __launch_bounds__(kSerialThreads)
moe_serial_kernel(const int32_t* __restrict__ ids,
                  int32_t* __restrict__ counts, int32_t* __restrict__ pos,
                  long long T, int E) {
  constexpr int warps = kSerialThreads / 32;
  __shared__ int warp_hits[warps];
  const int e = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int carry = 0;
  for (long long base = 0; base < T; base += kSerialThreads) {
    const long long i = base + threadIdx.x;
    const bool in = i < T;
    const int32_t id = in ? ids[i] : 0;
    const bool hit = in && id == e;
    const unsigned ballot = __ballot_sync(kFull, hit);
    if (lane == 0) warp_hits[warp] = __popc(ballot);
    __syncthreads();
    int before = carry;
    int tile = 0;
    for (int w = 0; w < warps; ++w) {
      const int c = warp_hits[w];
      before += w < warp ? c : 0;
      tile += c;
    }
    before += __popc(ballot & ((1u << lane) - 1u));
    // the expert's own tokens, and the negative ids that wrap onto it
    if (hit || (in && id == e - E)) pos[i] = before;
    if (e == 0 && in && (id < -E || id >= E)) pos[i] = INT_MIN;
    carry += tile;
    __syncthreads();
  }
  if (threadIdx.x == 0) counts[e] = carry;
}

}  // namespace

// Words of the `counts` buffer a call of T ids over E experts writes:
// the E counts, then the (tiles, E) table of tile counts (at most
// kTableWords). kernels/moe_dispatch.py allocates the buffer from it.
extern "C" int repro_moe_dispatch_work_words(long long T, int E) {
  return static_cast<int>((1 + tiles_of(T, E)) * E);
}

// counts holds repro_moe_dispatch_work_words(T, E) words. E >= 1.
extern "C" int repro_moe_dispatch(const void* ids_, void* counts_,
                                  void* pos_, long long T, int E,
                                  void* stream) {
  if (E <= 0) return static_cast<int>(cudaGetLastError());
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int32_t* ids = static_cast<const int32_t*>(ids_);
  int32_t* counts = static_cast<int32_t*>(counts_);
  int32_t* pos = static_cast<int32_t*>(pos_);
  const long long tiles = tiles_of(T, E);
  if (tiles == 0) {
    moe_serial_kernel<<<static_cast<unsigned>(E), kSerialThreads, 0, st>>>(
        ids, counts, pos, T, E);
    return static_cast<int>(cudaGetLastError());
  }
  const long long tile = tile_ids(T, E);
  int32_t* table = counts + E;
  moe_count_kernel<<<static_cast<unsigned>(tiles), kThreads, E * sizeof(int),
                     st>>>(ids, table, T, E, tile);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = static_cast<size_t>(kWarps + 1) * E * sizeof(int);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(moe_rank_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  moe_rank_kernel<<<static_cast<unsigned>(tiles), kThreads, smem, st>>>(
      ids, table, counts, pos, T, E, tile);
  return static_cast<int>(cudaGetLastError());
}

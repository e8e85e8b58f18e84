// txn_lane.cu — the transactional owner lane (B9 txn_group_apply) on Hopper.
//
// It has no TPU counterpart: the JAX package's txn_group_apply is jnp only
// (repro/kernels/ops.py). Its contract is repro_torch/kernels/ref.py
// txn_group_apply: each owner's rows [off|code|a|b|gid|chain] in list order,
// gid clipped to [0, ngroups); a row is a chain guard when chain != 0 and
// its code is CAS. Two passes over the live rows:
//  1. trial: every group that is not dead applies its rows; when a guard's
//     compare fails, the rows the group applied since its current run of
//     rows began are undone and the group is marked dead (the plain version
//     restores the snapshot taken at the run's first row: the same words);
//  2. apply, from the original shard: every row of a live group applies
//     and replies [old-at-apply, 1]; other rows reply [0, 0].
// Codes 0-6 act as in amo_apply (fetch-and-ops in uint32, so int32 wraps),
// other codes leave the word. An offset outside [0, L) reads the word a
// plain jnp gather reads (negative wraps once, then clamps) and writes
// nothing. Out of place: the shard is copied to `out` first.
//
// Design. The work is a serial walk whose rollbacks depend on the data, so
// one thread walks each owner's rows; what can be spread is spread:
//  - launch 1 (txn_lane_copy_kernel) copies every shard and zeroes every
//    reply across the card with 16-byte vectors (owner_list.cuh);
//  - launch 2 (txn_group_apply_kernel) runs one block per owner. Its
//    threads stage the rows of a chunk and their mask in shared memory,
//    then thread 0 walks the chunk. The dead flags of the groups live in
//    shared memory. The trial pass logs each write (word, old value) in a
//    workspace of m pairs an owner; a failed guard undoes the log back to
//    its run's start, and after the pass the whole log is undone in reverse,
//    which leaves the original shard for the apply pass.
#include <cstdint>
#include <cuda_runtime.h>

#include "owner_list.cuh"

namespace {

constexpr int kLaneThreads = 256;
constexpr int kRows = 1024;          // rows staged in shared memory a chunk
constexpr int kCodeCas = 2;

__device__ __forceinline__ long long wrap_word(long long i, long long n) {
  return i < 0 ? i + n : i;
}
__device__ __forceinline__ long long clip_word(long long i, long long n) {
  const long long j = wrap_word(i, n);
  return j < 0 ? 0 : (j >= n ? n - 1 : j);
}

// new word for primitive codes 0-6; any other code leaves it
__device__ __forceinline__ int32_t txn_new(int32_t cur, int32_t code,
                                          int32_t a, int32_t b) {
  const uint32_t c = static_cast<uint32_t>(cur);
  const uint32_t x = static_cast<uint32_t>(a);
  switch (code) {
    case 0: return b;
    case 2: return cur == a ? b : cur;
    case 3: return static_cast<int32_t>(c + x);
    case 4: return static_cast<int32_t>(c | x);
    case 5: return static_cast<int32_t>(c & x);
    case 6: return static_cast<int32_t>(c ^ x);
    default: return cur;
  }
}

struct Row {
  int32_t off, code, a, b, gid, chain;
};

__global__ void __launch_bounds__(kCopyThreads)
txn_lane_copy_kernel(const int32_t* __restrict__ local,
                     int32_t* __restrict__ out, long long n,
                     int32_t* __restrict__ reply, long long n_reply) {
  copy_words(local, out, n);
  zero_words(reply, n_reply);
}

// stage rows [r0, r0 + n) of this owner into shared memory
__device__ __forceinline__ void stage(const int32_t* __restrict__ op,
                                      const uint8_t* __restrict__ mk,
                                      long long r0, int n, Row* rows,
                                      uint8_t* live) {
  int32_t* words = reinterpret_cast<int32_t*>(rows);
  for (int k = threadIdx.x; k < n * 6; k += blockDim.x)
    words[k] = op[r0 * 6 + k];
  for (int k = threadIdx.x; k < n; k += blockDim.x) live[k] = mk[r0 + k];
}

__global__ void __launch_bounds__(kLaneThreads)
txn_group_apply_kernel(const int32_t* __restrict__ ops,
                       const uint8_t* __restrict__ mask,
                       int32_t* __restrict__ reply, int32_t* __restrict__ out,
                       int32_t* __restrict__ work, long long L, long long m,
                       int ngroups) {
  extern __shared__ __align__(16) unsigned char smem[];
  Row* rows = reinterpret_cast<Row*>(smem);
  uint8_t* live = smem + sizeof(Row) * kRows;
  uint8_t* dead = live + kRows;
  const long long p = blockIdx.x;
  const int32_t* op = ops + p * m * 6;
  const uint8_t* mk = mask + p * m;
  int32_t* rp = reply + p * m * 2;
  int32_t* shard = out + p * L;
  int2* undo = reinterpret_cast<int2*>(work) + p * m;

  for (int g = threadIdx.x; g < ngroups; g += blockDim.x) dead[g] = 0;

  // 1. trial pass (thread 0 walks, the block stages)
  long long nlog = 0, run_start = 0;
  int prev = -1;
  for (long long r0 = 0; r0 < m; r0 += kRows) {
    const int n = static_cast<int>(m - r0 < kRows ? m - r0 : kRows);
    __syncthreads();
    stage(op, mk, r0, n, rows, live);
    __syncthreads();
    if (threadIdx.x != 0) continue;
    for (int k = 0; k < n; ++k) {
      if (!live[k]) continue;
      const Row row = rows[k];
      const int g = row.gid < 0 ? 0 : (row.gid >= ngroups ? ngroups - 1
                                                           : row.gid);
      if (g != prev) run_start = nlog;   // the plain version's snapshot
      prev = g;
      if (dead[g]) continue;
      const int32_t cur = shard[clip_word(row.off, L)];
      if (row.chain != 0 && row.code == kCodeCas && cur != row.a) {
        for (long long i = nlog - 1; i >= run_start; --i)
          shard[undo[i].x] = undo[i].y;
        nlog = run_start;
        dead[g] = 1;
        continue;
      }
      const long long w = wrap_word(row.off, L);
      if (w >= 0 && w < L) {
        undo[nlog++] = make_int2(static_cast<int>(w), cur);
        shard[w] = txn_new(cur, row.code, row.a, row.b);
      }
    }
  }
  if (threadIdx.x == 0) {
    for (long long i = nlog - 1; i >= 0; --i) shard[undo[i].x] = undo[i].y;
  }

  // 2. apply pass, from the original shard
  for (long long r0 = 0; r0 < m; r0 += kRows) {
    const int n = static_cast<int>(m - r0 < kRows ? m - r0 : kRows);
    __syncthreads();
    stage(op, mk, r0, n, rows, live);
    __syncthreads();
    if (threadIdx.x != 0) continue;
    for (int k = 0; k < n; ++k) {
      if (!live[k]) continue;
      const Row row = rows[k];
      const int g = row.gid < 0 ? 0 : (row.gid >= ngroups ? ngroups - 1
                                                           : row.gid);
      if (dead[g]) continue;
      const int32_t cur = shard[clip_word(row.off, L)];
      const long long w = wrap_word(row.off, L);
      if (w >= 0 && w < L) shard[w] = txn_new(cur, row.code, row.a, row.b);
      rp[(r0 + k) * 2] = cur;
      rp[(r0 + k) * 2 + 1] = 1;
    }
  }
}

}  // namespace

// Dynamic shared memory of an apply block for `ngroups` groups, in bytes.
extern "C" long long repro_txn_lane_smem_bytes(int ngroups) {
  return static_cast<long long>(sizeof(Row)) * kRows + kRows + ngroups;
}

// C interface, loaded with ctypes. Pointers are device pointers of
// contiguous tensors: local, out (P, L) int32; ops (P, m, 6) int32; mask
// (P, m) bool; reply (P, m, 2) int32; work (P, m, 2) int32, the undo logs.
// L is in [1, 2**31), ngroups >= 1 (the wrapper checks). Launches the copy
// and then the walk on `stream`; returns cudaGetLastError().
extern "C" int repro_txn_group_apply(const void* local, const void* ops,
                                     const void* mask, void* reply,
                                     void* out, void* work, long long P,
                                     long long L, long long m, int ngroups,
                                     void* stream) {
  if (P > 0) {
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    const long long n_reply = P * m * 2;
    txn_lane_copy_kernel<<<copy_blocks(P * L > n_reply ? P * L : n_reply),
                           kCopyThreads, 0, st>>>(
        static_cast<const int32_t*>(local), static_cast<int32_t*>(out),
        P * L, static_cast<int32_t*>(reply), n_reply);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess || m == 0) return static_cast<int>(err);
    const long long smem = repro_txn_lane_smem_bytes(ngroups);
    err = cudaFuncSetAttribute(txn_group_apply_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    txn_group_apply_kernel<<<static_cast<unsigned>(P), kLaneThreads,
                             static_cast<size_t>(smem), st>>>(
        static_cast<const int32_t*>(ops), static_cast<const uint8_t*>(mask),
        static_cast<int32_t*>(reply), static_cast<int32_t*>(out),
        static_cast<int32_t*>(work), L, m, ngroups);
  }
  return static_cast<int>(cudaGetLastError());
}

// hash_probe.cu — the RPC hash-table handler bodies on Hopper.
//
// Replaces the two Pallas TPU kernels of repro/kernels/hash_probe.py:
//   B3 _find_kernel / hash_find      -> hash_find_kernel
//   B4 _insert_kernel / hash_insert  -> hash_insert_kernel
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
// B4, insert-or-assign. Request j must see requests < j at the same owner,
// so each owner's list is one serial chain: one block per owner copies the
// shard to `out` with all its threads, then warp 0 walks the list (32 mask
// bytes per vote, lane 0 applies only live requests in order). The bound is
// that chain: live requests at the busiest owner x the dependent reads of
// their probes and the record write.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kFindThreads = 128;
constexpr int kInsertThreads = 512;
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

__global__ void __launch_bounds__(kInsertThreads)
hash_insert_kernel(const int32_t* __restrict__ table,
                   const int32_t* __restrict__ starts,
                   const int32_t* __restrict__ keys,
                   const int32_t* __restrict__ vals,
                   const uint8_t* __restrict__ mask, uint8_t* ok,
                   int32_t* probes_out, int32_t* out, long long L,
                   long long m, long long nslots, int rec_w,
                   int max_probes) {
  const long long p = blockIdx.x;
  const int vw = rec_w - 2;
  const int32_t* src = table + p * L;
  int32_t* shard = out + p * L;
  const uintptr_t bits = reinterpret_cast<uintptr_t>(src) |
                         reinterpret_cast<uintptr_t>(shard);
  if ((L & 3) == 0 && (bits & 15) == 0) {
    const int4* s4 = reinterpret_cast<const int4*>(src);
    int4* d4 = reinterpret_cast<int4*>(shard);
    for (long long i = threadIdx.x; i < L / 4; i += blockDim.x) d4[i] = s4[i];
  } else {
    for (long long i = threadIdx.x; i < L; i += blockDim.x) shard[i] = src[i];
  }
  for (long long i = threadIdx.x; i < m; i += blockDim.x) {
    ok[p * m + i] = 0;
    probes_out[p * m + i] = 0;
  }
  __syncthreads();
  if (threadIdx.x >= 32) return;

  const uint8_t* mk = mask + p * m;
  const int lane = threadIdx.x;
  for (long long base = 0; base < m; base += 32) {
    const long long jl = base + lane;
    unsigned live = __ballot_sync(0xffffffffu, jl < m && mk[jl] != 0);
    if (lane == 0) {
      while (live) {
        const long long j = base + (__ffs(live) - 1);
        live &= live - 1;
        const long long idx = p * m + j;
        const long long start = starts[idx];
        const int32_t key = keys[idx];
        long long slot = -1;
        int kind = 0;  // 0 searching, 1 key found, 2 empty slot
        int32_t probes = 0;
        for (int pr = 0; pr < max_probes && kind == 0; ++pr) {
          const long long s = floor_mod(start + pr, nslots);
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
          for (int w = 0; w < vw; ++w) shard[rb + 2 + w] = vals[idx * vw + w];
          ok[idx] = 1;
        }
        probes_out[idx] = probes;
      }
    }
    __syncwarp();
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

extern "C" int repro_hash_insert(const void* table, const void* starts,
                                 const void* keys, const void* vals,
                                 const void* mask, void* ok, void* probes,
                                 void* out, long long P, long long L,
                                 long long m, long long nslots, int rec_w,
                                 int max_probes, void* stream) {
  if (P > 0) {
    hash_insert_kernel<<<static_cast<unsigned>(P), kInsertThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(table),
        static_cast<const int32_t*>(starts),
        static_cast<const int32_t*>(keys), static_cast<const int32_t*>(vals),
        static_cast<const uint8_t*>(mask), static_cast<uint8_t*>(ok),
        static_cast<int32_t*>(probes), static_cast<int32_t*>(out), L, m,
        nslots, rec_w, max_probes);
  }
  return static_cast<int>(cudaGetLastError());
}

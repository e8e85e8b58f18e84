// owner_lane.cu — the owner's serialized atomic lane ("NIC lane") on Hopper.
//
// Replaces the two Pallas TPU kernels of repro/kernels/amo_apply.py:
//   B1 _amo_kernel / amo_apply      -> amo_apply_kernel
//   B2 _fused_kernel / fused_apply  -> fused_apply_kernel
// with the contract of repro_torch/kernels/ref.py (amo_apply, fused_apply):
// out-of-place (each owner's shard is copied to `out`, then updated), masked
// rows reply 0 and change nothing, an offset outside [0, L) reads the word a
// plain jnp gather reads (negative wraps once, then clamps) and writes
// nothing, and fetch-and-ops run in uint32 so int32 wraps exactly.
//
// What bounds it on this card. Op order IS the semantics: op j must see the
// word left by ops < j, so each owner's list is one dependent chain of
// read-modify-writes. The chain's length is the number of live ops at the
// busiest owner, and each step costs one dependent global-memory round trip
// (mostly an L2 hit: a slice-size shard is 3 MB, far above the 227 KB of
// shared memory a block may hold, so the TPU kernel's whole-shard residency
// in VMEM does not carry over). The bytes the function must move (read the
// shard once, write it once) are a far smaller bound at slice size.
//
// What the design does about it. One block per owner, so owners' chains run
// in parallel on separate SMs. The whole block copies the shard and zeroes
// the replies with 16-byte vectors, then warp 0 walks the list: the 32 lanes
// read 32 mask bytes at a time and vote, and lane 0 applies only the live
// ops in order, so masked rows (most of a routed P_src x cap grid) cost a
// vote, not a chain step. B2's sub-phases 1-3 are walked the same way with
// __syncthreads() between them; sub-phase 4 (the phase-end gathers) is
// independent per op and runs across the whole block.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;

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

__device__ __forceinline__ int32_t fao(int32_t cur, int32_t a, int32_t kind) {
  const uint32_t c = static_cast<uint32_t>(cur);
  const uint32_t x = static_cast<uint32_t>(a);
  switch (kind) {
    case 3: return static_cast<int32_t>(c + x);   // FAA
    case 4: return static_cast<int32_t>(c | x);   // FOR
    case 5: return static_cast<int32_t>(c & x);   // FAND
    case 6: return static_cast<int32_t>(c ^ x);   // FXOR
    default: return cur;
  }
}

// primitive codes 0-6; GET and any other code leave the word
__device__ __forceinline__ int32_t amo_new(int32_t code, int32_t cur,
                                           int32_t a, int32_t b) {
  switch (code) {
    case 0: return b;                    // PUT
    case 2: return cur == a ? b : cur;   // CAS
    case 3: case 4: case 5: case 6: return fao(cur, a, code);
    default: return cur;
  }
}

// fused codes: CAS_PUT / CAS_PUT_PUB claim, FAO_GET fetch-and-op kind b
__device__ __forceinline__ int32_t fused_new(int32_t code, int32_t cur,
                                             int32_t a, int32_t b) {
  switch (code) {
    case 7: case 8: return cur == a ? b : cur;
    case 9: return fao(cur, a, b);
    default: return amo_new(code, cur, a, b);
  }
}

__device__ void copy_shard(const int32_t* __restrict__ src,
                           int32_t* __restrict__ dst, long long L) {
  const uintptr_t bits = reinterpret_cast<uintptr_t>(src) |
                         reinterpret_cast<uintptr_t>(dst);
  if ((L & 3) == 0 && (bits & 15) == 0) {
    const int4* s4 = reinterpret_cast<const int4*>(src);
    int4* d4 = reinterpret_cast<int4*>(dst);
    for (long long i = threadIdx.x; i < L / 4; i += blockDim.x) d4[i] = s4[i];
  } else {
    for (long long i = threadIdx.x; i < L; i += blockDim.x) dst[i] = src[i];
  }
}

__device__ void zero_words(int32_t* dst, long long n) {
  for (long long i = threadIdx.x; i < n; i += blockDim.x) dst[i] = 0;
}

// Called by warp 0 only: apply f(j) to the live rows j of one owner's list,
// in order, on lane 0.
template <typename F>
__device__ void walk_live(const uint8_t* __restrict__ mask, long long m,
                          F f) {
  const int lane = threadIdx.x & 31;
  for (long long base = 0; base < m; base += 32) {
    const long long j = base + lane;
    const bool ok = j < m && mask[j] != 0;
    unsigned live = __ballot_sync(0xffffffffu, ok);
    if (lane == 0) {
      while (live) {
        const int t = __ffs(live) - 1;
        live &= live - 1;
        f(base + t);
      }
    }
    __syncwarp();
  }
}

__global__ void __launch_bounds__(kThreads)
amo_apply_kernel(const int32_t* __restrict__ local,
                 const int32_t* __restrict__ ops,
                 const uint8_t* __restrict__ mask, int32_t* old,
                 int32_t* out, long long L, long long m) {
  const long long p = blockIdx.x;
  int32_t* shard = out + p * L;
  int32_t* od = old + p * m;
  copy_shard(local + p * L, shard, L);
  zero_words(od, m);
  __syncthreads();
  if (threadIdx.x < 32) {
    const int32_t* op = ops + p * m * 4;
    walk_live(mask + p * m, m, [&](long long j) {
      const int32_t* o = op + 4 * j;
      const int32_t off = o[0];
      const long long r = clip_idx(off, L);
      const int32_t cur = shard[r];
      if (in_range(off, L)) shard[r] = amo_new(o[1], cur, o[2], o[3]);
      od[j] = cur;
    });
  }
}

__global__ void __launch_bounds__(kThreads)
fused_apply_kernel(const int32_t* __restrict__ local,
                   const int32_t* __restrict__ ops,
                   const uint8_t* __restrict__ mask, int32_t* reply,
                   int32_t* out, long long L, long long m, int W, int RW) {
  const long long p = blockIdx.x;
  const int V = W - 6;
  const int G = RW - 1;
  int32_t* shard = out + p * L;
  int32_t* rp = reply + p * m * RW;
  const int32_t* op = ops + p * m * W;
  const uint8_t* mk = mask + p * m;
  copy_shard(local + p * L, shard, L);
  zero_words(rp, m * RW);
  __syncthreads();

  // 1. atomics, serialized; reply word 0 = old value at off
  if (threadIdx.x < 32) {
    walk_live(mk, m, [&](long long j) {
      const int32_t* o = op + j * W;
      const int32_t off = o[0];
      const long long r = clip_idx(off, L);
      const int32_t cur = shard[r];
      if (in_range(off, L)) shard[r] = fused_new(o[1], cur, o[2], o[3]);
      rp[j * RW] = cur;
    });
  }
  __syncthreads();

  // 2. V-word puts of winning CAS_PUT[_PUB] at aux0, dropped whole when out
  //    of range; the win is recomputed from the recorded old value
  if (V > 0 && threadIdx.x < 32) {
    walk_live(mk, m, [&](long long j) {
      const int32_t* o = op + j * W;
      const long long aux0 = o[4];
      if ((o[1] == 7 || o[1] == 8) && rp[j * RW] == o[2] && aux0 >= 0 &&
          aux0 <= L - V) {
        for (int v = 0; v < V; ++v) shard[aux0 + v] = o[6 + v];
      }
    });
  }
  __syncthreads();

  // 3. publish flips of winning CAS_PUT_PUB: mem[off] ^= aux1
  if (threadIdx.x < 32) {
    walk_live(mk, m, [&](long long j) {
      const int32_t* o = op + j * W;
      if (o[1] == 8 && rp[j * RW] == o[2]) {
        const long long r = clip_idx(o[0], L);
        const int32_t cur = shard[r];
        if (in_range(o[0], L)) shard[r] = cur ^ o[5];
      }
    });
  }
  __syncthreads();

  // 4. FAO_GET gathers of G words from aux0: a phase-end snapshot, so every
  //    op reads independently, across the whole block
  if (G > 0) {
    for (long long j = threadIdx.x; j < m; j += blockDim.x) {
      const int32_t* o = op + j * W;
      const long long aux0 = o[4];
      if (mk[j] && o[1] == 9 && aux0 >= 0 && aux0 <= L - G) {
        for (int g = 0; g < G; ++g) rp[j * RW + 1 + g] = shard[aux0 + g];
      }
    }
  }
}

}  // namespace

// C interface, loaded with ctypes. Pointers are device pointers of
// contiguous tensors; `stream` is the caller's cudaStream_t. Each returns
// cudaGetLastError() after the launch.
extern "C" int repro_amo_apply(const void* local, const void* ops,
                               const void* mask, void* old, void* out,
                               long long P, long long L, long long m,
                               void* stream) {
  if (P > 0) {
    amo_apply_kernel<<<static_cast<unsigned>(P), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(local), static_cast<const int32_t*>(ops),
        static_cast<const uint8_t*>(mask), static_cast<int32_t*>(old),
        static_cast<int32_t*>(out), L, m);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int repro_fused_apply(const void* local, const void* ops,
                                 const void* mask, void* reply, void* out,
                                 long long P, long long L, long long m,
                                 int width, int reply_width, void* stream) {
  if (P > 0) {
    fused_apply_kernel<<<static_cast<unsigned>(P), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(local), static_cast<const int32_t*>(ops),
        static_cast<const uint8_t*>(mask), static_cast<int32_t*>(reply),
        static_cast<int32_t*>(out), L, m, width, reply_width);
  }
  return static_cast<int>(cudaGetLastError());
}

// owner_list.cuh — pieces shared by the kernels that take a list of requests
// per owner and return a new copy of each owner's shard (owner_lane.cu: B1,
// B2; hash_probe.cu: B4):
//  - the copy of every shard and the zeroing of the replies, spread over
//    every SM with four 16-byte loads in flight a thread (its own launch);
//  - one thread's stretch of an owner's mask, counted and walked with
//    16-byte loads, so that a block can rank the live rows in list order.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kCopyThreads = 256;

__device__ __forceinline__ void copy_words(const int32_t* __restrict__ src,
                                           int32_t* __restrict__ dst,
                                           long long n) {
  const long long tid =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  long long done = 0;
  if (((reinterpret_cast<uintptr_t>(src) | reinterpret_cast<uintptr_t>(dst))
       & 15) == 0) {
    const int4* s4 = reinterpret_cast<const int4*>(src);
    int4* d4 = reinterpret_cast<int4*>(dst);
    const long long n4 = n >> 2;
    long long i = tid;
    for (; i + 3 * stride < n4; i += 4 * stride) {
      const int4 a = s4[i], b = s4[i + stride], c = s4[i + 2 * stride],
                 d = s4[i + 3 * stride];
      d4[i] = a;
      d4[i + stride] = b;
      d4[i + 2 * stride] = c;
      d4[i + 3 * stride] = d;
    }
    for (; i < n4; i += stride) d4[i] = s4[i];
    done = n4 << 2;
  }
  for (long long i = done + tid; i < n; i += stride) dst[i] = src[i];
}

__device__ __forceinline__ void zero_words(int32_t* __restrict__ dst,
                                           long long n) {
  const long long tid =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  long long done = 0;
  if ((reinterpret_cast<uintptr_t>(dst) & 15) == 0) {
    int4* d4 = reinterpret_cast<int4*>(dst);
    const long long n4 = n >> 2;
    for (long long i = tid; i < n4; i += stride) d4[i] = make_int4(0, 0, 0, 0);
    done = n4 << 2;
  }
  for (long long i = done + tid; i < n; i += stride) dst[i] = 0;
}

__device__ __forceinline__ void zero_bytes(uint8_t* __restrict__ dst,
                                           long long n) {
  const long long tid =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  long long done = 0;
  if ((reinterpret_cast<uintptr_t>(dst) & 15) == 0) {
    int4* d4 = reinterpret_cast<int4*>(dst);
    const long long n16 = n >> 4;
    for (long long i = tid; i < n16; i += stride)
      d4[i] = make_int4(0, 0, 0, 0);
    done = n16 << 4;
  }
  for (long long i = done + tid; i < n; i += stride) dst[i] = 0;
}

// blocks of the copy launch: enough for four 16-byte vectors a thread, at
// most eight a multiprocessor
inline int copy_blocks(long long words) {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long want =
      (words / 4 + kCopyThreads * 4 - 1) / (kCopyThreads * 4);
  const long long cap = 8LL * (sms > 0 ? sms : 1);
  return static_cast<int>(want < 1 ? 1 : (want < cap ? want : cap));
}

// bits a radix sort needs for keys in [0, n] (n itself pads a chunk)
inline int key_bits(long long n) {
  int b = 1;
  while ((1LL << b) <= n) ++b;
  return b;
}

// This thread's stretch of one owner's mask: rows [r0, r1), a multiple of
// 16 rows long, read as 16-byte vectors when the mask allows it.
struct Stretch {
  long long r0, r1;
  bool vec;
};

template <int kThreads>
__device__ __forceinline__ Stretch my_stretch(const uint8_t* mk,
                                              long long m) {
  const bool vec =
      (m & 15) == 0 && (reinterpret_cast<uintptr_t>(mk) & 15) == 0;
  const long long per = ((m + kThreads - 1) / kThreads + 15) / 16 * 16;
  const long long r0 = min(m, threadIdx.x * per);
  return {r0, min(m, r0 + per), vec};
}

__device__ __forceinline__ int live_bytes(uint32_t w) {
  return __popc(__vcmpne4(w, 0u)) >> 3;
}

__device__ __forceinline__ int count_live(const uint8_t* __restrict__ mk,
                                          const Stretch& st) {
  int c = 0;
  if (st.vec) {
#pragma unroll 4
    for (long long j = st.r0; j < st.r1; j += 16) {
      const uint4 w = *reinterpret_cast<const uint4*>(mk + j);
      c += live_bytes(w.x) + live_bytes(w.y) + live_bytes(w.z) +
           live_bytes(w.w);
    }
  } else {
    for (long long j = st.r0; j < st.r1; ++j) c += mk[j] != 0;
  }
  return c;
}

// f(j) for every live row j of the stretch, in order; the mask is read
// four vectors at a time, so that their loads are in flight together
template <typename F>
__device__ __forceinline__ void for_live(const uint8_t* __restrict__ mk,
                                         const Stretch& st, F f) {
  if (st.vec) {
    for (long long j0 = st.r0; j0 < st.r1; j0 += 64) {
      uint4 w[4];
#pragma unroll
      for (int u = 0; u < 4; ++u)
        w[u] = j0 + 16 * u < st.r1
                   ? *reinterpret_cast<const uint4*>(mk + j0 + 16 * u)
                   : make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const uint32_t ws[4] = {w[u].x, w[u].y, w[u].z, w[u].w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          uint32_t bits = __vcmpne4(ws[i], 0u) & 0x01010101u;
          while (bits) {
            const int b = __ffs(bits) - 1;
            bits &= bits - 1;
            f(j0 + 16 * u + 4 * i + (b >> 3));
          }
        }
      }
    }
  } else {
    for (long long j = st.r0; j < st.r1; ++j)
      if (mk[j]) f(j);
  }
}

}  // namespace

// flash_decode.cu — single-token GQA decode attention on Hopper, the keys
// of each row split over blocks (flash-decoding).
//
// Replaces the Pallas TPU kernel B6 of repro/kernels/flash_decode.py
// (_decode_kernel / flash_decode) with the contract of
// repro_torch/kernels/ref.py decode_attention: q (B, H, d); k, v viewed as
// (B, Hkv, S, d) with a unit stride on d; length (B,) int32, the valid
// cache prefix. Returns the flash partials, all f32:
//   o (B, H, d) = sum_j exp(s_j - m) v_j   (unnormalized),
//   m (B, H)    = max_j s_j,   l (B, H) = sum_j exp(s_j - m),
// over j < length, with s_j = (q . k_j) * d**-0.5 and query head h reading
// kv head h / (H / Hkv). length 0 gives m = -inf, l = 0, o = 0.
//
// Bound: bytes. At the decode shapes (g = 1 or a few query heads per kv
// head) the work is 4 flops per K or V element read, far below the card's
// ratio, so the least time is K and V of the valid prefix over the memory
// rate. What stands in the way is latency: one block per (row, kv head)
// gives 128 blocks at the serving shape, less than one per SM.
//
// The Pallas grid walked (B, Hkv, kv tile) with the tile axis minor and
// carried the running (acc, m, l) in VMEM scratch. Here the keys of each
// (row, kv head) are cut into fixed ranges of `chunk` keys, one block each:
// grid (Hkv, B, n_split) with n_split = ceil(S / chunk) from the cache's
// capacity S, so the host never reads `length`. A block whose range starts
// at or past length writes the empty partial and reads no K or V. The others
// (1) start 16-byte cp.async copies of their V rows into shared memory,
// (2) read their K rows as 16-byte vectors straight from the strided cache
// into registers, a group of R lanes a key row (R = 16 at d = 128 bf16, so a
// warp scores two keys a load instruction), with the g scores reduced over
// the group by shuffles, (3) take the softmax of the range per head, and
// (4) add p * v from the staged V rows, lanes split over the row's vectors
// and groups over keys, the groups summed by shuffles and then over the
// four warps in a fixed order. Each writes its partial (o, m, l) to an f32
// workspace (B, H, n_split, d) that the wrapper allocates, then counts
// itself done on a per-(row, kv head) counter; the last block of the row
// merges the partials in split order (the rescaling of
// combine_decode_stats, returning the unnormalized o relative to the
// global max) and sets the counter back to 0 for the next call. Which
// block merges varies, the order of the sums does not: a call is
// deterministic. The merge rides in the split kernel rather than in a
// second kernel, whose launch cost more than the counter at the serving
// shape in the timings that chose the design (as did 128-key ranges).
// Inputs are f32 or bf16 (q, k and v of one type); the math is f32.
#include <cmath>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxG = 16;        // query heads per kv head
constexpr int kMaxD = 256;       // head dim
constexpr int kMaxChunk = 128;   // keys a block
constexpr int kKB = 8;           // key rows a lane group loads at once
constexpr int kHT = 4;           // heads a pass of step (4)

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// the 16 bytes of a vector as f32: 4 floats or 8 bf16
__device__ __forceinline__ void unpack(const uint4& u, float* f, float) {
  f[0] = __uint_as_float(u.x);
  f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z);
  f[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ void unpack(const uint4& u, float* f,
                                       __nv_bfloat16) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}

// The last block of a (row, kv head) to finish merges the g heads'
// partials in split order and resets the counter for the next call.
__device__ void merge_if_last(const float* o_ws, const float* m_ws,
                              const float* l_ws, float* o, float* m,
                              float* l, int* counter, long long head0, int g,
                              int d, int n_split, long long slot) {
  __shared__ int last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    last = atomicAdd(counter + slot, 1) == n_split - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  if (threadIdx.x == 0) counter[slot] = 0;
  for (int e = threadIdx.x; e < g * d; e += blockDim.x) {
    const long long row = head0 + e / d;
    const int x = e % d;
    const float* mr = m_ws + row * n_split;
    float m_all = -INFINITY;
    for (int i = 0; i < n_split; ++i) m_all = fmaxf(m_all, __ldcg(mr + i));
    const float m_use = isfinite(m_all) ? m_all : 0.f;
    float acc = 0.f, sum = 0.f;
    for (int i = 0; i < n_split; ++i) {
      const float mi = __ldcg(mr + i);
      const float w = isfinite(mi) ? expf(mi - m_use) : 0.f;
      acc = fmaf(w, __ldcg(o_ws + (row * n_split + i) * d + x), acc);
      sum = fmaf(w, __ldcg(l_ws + row * n_split + i), sum);
    }
    o[row * d + x] = acc;
    if (x == 0) {
      m[row] = m_all;
      l[row] = sum;
    }
  }
}

// T: element type; VPL: 16-byte vectors a lane holds of a key row (2 only
// for f32 rows of more than 32 vectors, d > 128)
template <typename T, int VPL>
__global__ void __launch_bounds__(kThreads)
flash_decode_split(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v,
                   const int32_t* __restrict__ length,
                   float* __restrict__ o_ws, float* __restrict__ m_ws,
                   float* __restrict__ l_ws, float* __restrict__ o,
                   float* __restrict__ m_out, float* __restrict__ l_out,
                   int* __restrict__ counter, long long S, int H, int Hkv,
                   int d, long long ksb, long long kss, long long ksh,
                   long long vsb, long long vss, long long vsh, int chunk,
                   int R, float scale) {
  constexpr int kVec = 16 / sizeof(T);       // elements a 16-byte vector
  constexpr int kLane = VPL * kVec;          // elements a lane holds
  extern __shared__ float4 smem4[];
  const int g = H / Hkv;
  T* v_s = reinterpret_cast<T*>(smem4);                     // (chunk, d)
  float* q_s = reinterpret_cast<float*>(v_s + chunk * d);   // (g, d)
  float* sc = q_s + g * d;                                  // (g, chunk)
  float* red = sc + g * chunk;                              // (kWarps, kHT, d)

  const int kvh = blockIdx.x;
  const long long b = blockIdx.y;
  const int split = blockIdx.z;
  const int n_split = gridDim.z;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const long long head0 = b * H + static_cast<long long>(kvh) * g;
  // partial of head h of this block in the workspace
  auto ws = [&](int h) { return (head0 + h) * n_split + split; };

  long long n = length[b];
  n = n < 0 ? 0 : (n > S ? S : n);
  const long long c0 = static_cast<long long>(split) * chunk;
  if (c0 >= n) {   // the empty partial; no K or V is read
    for (int e = tid; e < g * d; e += kThreads)
      o_ws[ws(e / d) * d + e % d] = 0.f;
    for (int h = tid; h < g; h += kThreads) {
      m_ws[ws(h)] = -INFINITY;
      l_ws[ws(h)] = 0.f;
    }
    merge_if_last(o_ws, m_ws, l_ws, o, m_out, l_out, counter, head0, g, d,
                  n_split, b * Hkv + kvh);
    return;
  }
  const int nt = static_cast<int>(n - c0 < chunk ? n - c0 : chunk);
  const int n_vec = d / kVec;
  const T* kb = k + b * ksb + static_cast<long long>(kvh) * ksh + c0 * kss;
  const T* vb = v + b * vsb + static_cast<long long>(kvh) * vsh + c0 * vss;

  // (1) V rows of the range into shared memory, in flight during (2)-(3)
  for (int e = tid; e < nt * n_vec; e += kThreads) {
    const int j = e / n_vec, c = e % n_vec;
    cp_async16(v_s + j * d + c * kVec, vb + j * vss + c * kVec);
  }
  asm volatile("cp.async.commit_group;\n" ::);

  // lane groups of R lanes: lane s of a group holds vectors s, s + R
  const int s = lane % R;
  const int groups = kWarps * (32 / R);
  const int gi = warp * (32 / R) + lane / R;
  // K rows j0 + gi + groups * t, t < kKB, into registers
  uint4 kr[kKB][VPL];
  auto load_k = [&](int j0) {
#pragma unroll
    for (int t = 0; t < kKB; ++t) {
      const int j = j0 + gi + groups * t;
#pragma unroll
      for (int p = 0; p < VPL; ++p) {
        const int c = s + p * R;
        kr[t][p] = (j < nt && c < n_vec)
                       ? __ldg(reinterpret_cast<const uint4*>(
                             kb + j * kss + c * kVec))
                       : make_uint4(0u, 0u, 0u, 0u);
      }
    }
  };
  load_k(0);   // in flight while q is staged
  for (int e = tid; e < g * d; e += kThreads)
    q_s[e] = to_float(q[head0 * d + e]);
  __syncthreads();

  // (2) scores: group gi takes keys gi, gi + groups, ...
  for (int j0 = 0; j0 < nt; j0 += groups * kKB) {
    if (j0 > 0) load_k(j0);
#pragma unroll
    for (int t = 0; t < kKB; ++t) {
      const int j = j0 + gi + groups * t;
      if (j0 + groups * t >= nt) break;   // uniform: no group has keys left
      float kf[kLane];
#pragma unroll
      for (int p = 0; p < VPL; ++p) unpack(kr[t][p], kf + p * kVec, T());
      for (int h = 0; h < g; ++h) {
        float part = 0.f;
#pragma unroll
        for (int p = 0; p < VPL; ++p) {
          const int c = s + p * R;
          if (c < n_vec) {
            const float* qr = q_s + h * d + c * kVec;
#pragma unroll
            for (int x = 0; x < kVec; ++x)
              part = fmaf(qr[x], kf[p * kVec + x], part);
          }
        }
        for (int off = R >> 1; off > 0; off >>= 1)
          part += __shfl_xor_sync(0xffffffffu, part, off);
        if (s == 0 && j < nt) sc[h * chunk + j] = part * scale;
      }
    }
  }
  __syncthreads();

  // (3) softmax of the range per head; the partial's m and l
  for (int h = warp; h < g; h += kWarps) {
    float* row = sc + h * chunk;
    float mx = -INFINITY;
    for (int j = lane; j < nt; j += 32) mx = fmaxf(mx, row[j]);
    mx = warp_max(mx);
    float sum = 0.f;
    for (int j = lane; j < nt; j += 32) {
      const float p = expf(row[j] - mx);
      row[j] = p;
      sum += p;
    }
    sum = warp_sum(sum);
    if (lane == 0) {
      m_ws[ws(h)] = mx;
      l_ws[ws(h)] = sum;
    }
  }
  asm volatile("cp.async.wait_group 0;\n" ::);
  __syncthreads();

  // (4) o = p @ V over the range, kHT heads a pass
  for (int h0 = 0; h0 < g; h0 += kHT) {
    float acc[kHT][kLane];
#pragma unroll
    for (int hh = 0; hh < kHT; ++hh)
#pragma unroll
      for (int x = 0; x < kLane; ++x) acc[hh][x] = 0.f;
    for (int j = gi; j < nt; j += groups) {
      float vf[kLane];
#pragma unroll
      for (int p = 0; p < VPL; ++p) {
        const int c = s + p * R;
        const uint4 u = c < n_vec ? *reinterpret_cast<const uint4*>(
                                        v_s + j * d + c * kVec)
                                  : make_uint4(0u, 0u, 0u, 0u);
        unpack(u, vf + p * kVec, T());
      }
#pragma unroll
      for (int hh = 0; hh < kHT; ++hh) {
        if (h0 + hh < g) {
          const float p = sc[(h0 + hh) * chunk + j];
#pragma unroll
          for (int x = 0; x < kLane; ++x)
            acc[hh][x] = fmaf(p, vf[x], acc[hh][x]);
        }
      }
    }
    // the groups of a warp hold the same columns: sum them (heads of
    // this pass only; the test is uniform over the warp)
    for (int off = R; off < 32; off <<= 1)
#pragma unroll
      for (int hh = 0; hh < kHT; ++hh)
        if (h0 + hh < g)
#pragma unroll
          for (int x = 0; x < kLane; ++x)
            acc[hh][x] += __shfl_xor_sync(0xffffffffu, acc[hh][x], off);
    if (lane < R) {
#pragma unroll
      for (int p = 0; p < VPL; ++p) {
        const int c = s + p * R;
        if (c < n_vec) {
#pragma unroll
          for (int hh = 0; hh < kHT; ++hh)
            if (h0 + hh < g)
#pragma unroll
              for (int x = 0; x < kVec; ++x)
                red[(warp * kHT + hh) * d + c * kVec + x] =
                    acc[hh][p * kVec + x];
        }
      }
    }
    __syncthreads();
    const int nh = g - h0 < kHT ? g - h0 : kHT;
    for (int e = tid; e < nh * d; e += kThreads) {
      const int hh = e / d, x = e % d;
      float sum = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) sum += red[(w * kHT + hh) * d + x];
      o_ws[ws(h0 + hh) * d + x] = sum;
    }
    __syncthreads();
  }
  merge_if_last(o_ws, m_ws, l_ws, o, m_out, l_out, counter, head0, g, d,
                n_split, b * Hkv + kvh);
}

template <typename T, int VPL>
int launch(const void* q, const void* k, const void* v, const void* length,
           void* o, void* m, void* l, void* o_ws, void* m_ws, void* l_ws,
           void* counter, long long B, long long S, int H, int Hkv, int d,
           long long ksb, long long kss, long long ksh, long long vsb,
           long long vss, long long vsh, int chunk, int n_split, int R,
           cudaStream_t stream) {
  auto kernel = flash_decode_split<T, VPL>;
  static bool attr_set = false;   // the largest shared memory, once
  if (!attr_set) {
    const size_t most = sizeof(T) * kMaxChunk * kMaxD +
                        sizeof(float) * (kMaxG * kMaxD + kMaxG * kMaxChunk +
                                         kWarps * kHT * kMaxD);
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(most));
    if (err != cudaSuccess) return static_cast<int>(err);
    attr_set = true;
  }
  const int g = H / Hkv;
  const size_t smem = sizeof(T) * static_cast<size_t>(chunk) * d +
                      sizeof(float) * (static_cast<size_t>(g) * d +
                                       static_cast<size_t>(g) * chunk +
                                       static_cast<size_t>(kWarps) * kHT * d);
  const dim3 grid(static_cast<unsigned>(Hkv), static_cast<unsigned>(B),
                  static_cast<unsigned>(n_split));
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int32_t*>(length),
      static_cast<float*>(o_ws), static_cast<float*>(m_ws),
      static_cast<float*>(l_ws), static_cast<float*>(o),
      static_cast<float*>(m), static_cast<float*>(l),
      static_cast<int*>(counter), S, H, Hkv, d, ksb, kss, ksh, vsb, vss, vsh,
      chunk, R, static_cast<float>(1.0 / sqrt(static_cast<double>(d))));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// bf16 != 0: q, k, v are __nv_bfloat16, else float. Strides in elements,
// multiples of the 16-byte vector (8 bf16, 4 f32), as d is; k and v
// 16-byte aligned. chunk (<= 128) keys a block, n_split = ceil(S / chunk)
// (at least 1); o_ws (B, H, n_split, d), m_ws and l_ws (B, H, n_split) f32
// workspace; counter (B * Hkv) int32, zero before the call and after it.
// One launch: the split kernel, whose last block per row merges.
extern "C" int repro_flash_decode(const void* q, const void* k, const void* v,
                                  const void* length, void* o, void* m,
                                  void* l, void* o_ws, void* m_ws, void* l_ws,
                                  long long B, long long S, int H, int Hkv,
                                  int d, long long ksb, long long kss,
                                  long long ksh, long long vsb, long long vss,
                                  long long vsh, int chunk, int n_split,
                                  int bf16, void* counter, void* stream) {
  if (B <= 0 || Hkv <= 0) return static_cast<int>(cudaGetLastError());
  if (chunk <= 0 || chunk > kMaxChunk || n_split <= 0 || d > kMaxD ||
      H / Hkv > kMaxG)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_vec = d / (bf16 ? 8 : 4);
  const int vpl = n_vec > 32 ? 2 : 1;
  int R = 1;   // lanes a key row: the power of two >= n_vec / vpl, <= 32
  while (R * vpl < n_vec) R <<= 1;
  auto run = bf16 ? launch<__nv_bfloat16, 1>
                  : (vpl == 1 ? launch<float, 1> : launch<float, 2>);
  return run(q, k, v, length, o, m, l, o_ws, m_ws, l_ws, counter, B, S, H,
             Hkv, d, ksb, kss, ksh, vsb, vss, vsh, chunk, n_split, R, st);
}

// flash_decode.cu — single-token GQA decode attention on Hopper.
//
// Replaces the Pallas TPU kernel B6 of repro/kernels/flash_decode.py
// (_decode_kernel / flash_decode) with the contract of
// repro_torch/kernels/ref.py decode_attention: q (B, H, d); k, v viewed as
// (B, Hkv, S, d) with any strides but a unit stride on d; length (B,)
// int32, the valid cache prefix. Returns the flash partials, all f32:
//   o (B, H, d) = sum_j exp(s_j - m) v_j   (unnormalized),
//   m (B, H)    = max_j s_j,   l (B, H) = sum_j exp(s_j - m),
// over j < length, with s_j = (q . k_j) * d**-0.5 and query head h reading
// kv head h / (H / Hkv). length 0 gives m = -inf, l = 0, o = 0.
//
// The Pallas grid walked (B, Hkv, kv tile) with the tile axis minor and
// carried the running (acc, m, l) in VMEM scratch; it visited every tile
// and masked those past length. Here one block of 128 threads takes one
// (batch row, kv head) and loops over the tiles of 64 keys below length
// only, so the carry stays in registers and shared memory. All g query
// heads of the group share each K and V row, which is read once, straight
// from the serving cache (B, W, Hkv, d) through the strides: no transpose
// copy per step. Per tile: (1) each warp takes every fourth key, its lanes
// split d, and a shuffle reduction gives the g scores; (2) each warp takes
// every fourth head and updates its running max, rescale factor and sum
// (online softmax in f32); (3) each thread owns one or two of the d
// output columns for all g heads and adds p * v over the tile's keys.
// Inputs are f32 or bf16 (q, k and v of one type); the math is f32.
//
// Bound: bytes. At the decode shapes (g = 1 or a few heads per kv head)
// the kernel does 4 flops per K or V element it reads, far below the
// card's ratio, so the least time is K and V of the valid prefix over the
// memory rate. This first version reads each K and V element with a
// scalar load and runs one block per (row, kv head), one wave at B * Hkv
// <= 132 blocks; splitting long caches over more blocks and vector loads
// are left to a later change.
#include <cmath>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 64;        // keys per tile (two per lane in step 2)
constexpr int kMaxG = 16;        // query heads per kv head
constexpr int kDimsPerThread = 2;  // head_dim <= kThreads * 2

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
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

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v,
                    const int32_t* __restrict__ length,
                    float* __restrict__ o, float* __restrict__ m_out,
                    float* __restrict__ l_out, long long S, int H, int Hkv,
                    int d, long long ksb, long long kss, long long ksh,
                    long long vsb, long long vss, long long vsh,
                    float scale) {
  extern __shared__ float smem[];
  const int g = H / Hkv;
  float* q_s = smem;                  // (g, d) query rows in f32
  float* sc = q_s + g * d;            // (g, kTile) scores, then p
  float* alpha_s = sc + g * kTile;    // (g,) rescale of this tile
  float* m_s = alpha_s + g;           // (g,) running max
  float* l_s = m_s + g;               // (g,) running sum

  const int kvh = blockIdx.x;
  const long long b = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const long long head0 = b * H + static_cast<long long>(kvh) * g;
  for (int i = tid; i < g * d; i += kThreads)
    q_s[i] = to_float(q[head0 * d + i]);
  for (int h = tid; h < g; h += kThreads) {
    m_s[h] = -INFINITY;
    l_s[h] = 0.f;
  }
  float acc[kMaxG][kDimsPerThread];
#pragma unroll
  for (int h = 0; h < kMaxG; ++h)
#pragma unroll
    for (int r = 0; r < kDimsPerThread; ++r) acc[h][r] = 0.f;
  long long n = length[b];
  n = n < 0 ? 0 : (n > S ? S : n);
  const T* kb = k + b * ksb + static_cast<long long>(kvh) * ksh;
  const T* vb = v + b * vsb + static_cast<long long>(kvh) * vsh;
  __syncthreads();

  for (long long k0 = 0; k0 < n; k0 += kTile) {
    const int nt = static_cast<int>(n - k0 < kTile ? n - k0 : kTile);
    // (1) scores of the tile's keys for all g heads
    for (int j = warp; j < nt; j += kWarps) {
      const T* kr = kb + (k0 + j) * kss;
      float part[kMaxG];
#pragma unroll
      for (int h = 0; h < kMaxG; ++h) part[h] = 0.f;
      for (int x = lane; x < d; x += 32) {
        const float kx = to_float(kr[x]);
#pragma unroll
        for (int h = 0; h < kMaxG; ++h)
          if (h < g) part[h] += q_s[h * d + x] * kx;
      }
#pragma unroll
      for (int h = 0; h < kMaxG; ++h) {
        if (h < g) {
          const float s = warp_sum(part[h]);
          if (lane == 0) sc[h * kTile + j] = s * scale;
        }
      }
    }
    __syncthreads();
    // (2) online softmax per head over the tile
    for (int h = warp; h < g; h += kWarps) {
      float* row = sc + h * kTile;
      const bool in0 = lane < nt;
      const bool in1 = lane + 32 < nt;
      const float s0 = in0 ? row[lane] : -INFINITY;
      const float s1 = in1 ? row[lane + 32] : -INFINITY;
      const float m_old = m_s[h];
      const float m_new = fmaxf(m_old, warp_max(fmaxf(s0, s1)));
      const float m_use = isfinite(m_new) ? m_new : 0.f;
      const float p0 = in0 ? expf(s0 - m_use) : 0.f;
      const float p1 = in1 ? expf(s1 - m_use) : 0.f;
      const float sum = warp_sum(p0 + p1);
      if (in0) row[lane] = p0;
      if (in1) row[lane + 32] = p1;
      if (lane == 0) {
        const float alpha = isfinite(m_old) ? expf(m_old - m_use) : 0.f;
        alpha_s[h] = alpha;
        m_s[h] = m_new;
        l_s[h] = l_s[h] * alpha + sum;
      }
    }
    __syncthreads();
    // (3) acc = acc * alpha + p @ V on this thread's output columns
#pragma unroll
    for (int r = 0; r < kDimsPerThread; ++r) {
      const int x = tid + r * kThreads;
      if (x < d) {
#pragma unroll
        for (int h = 0; h < kMaxG; ++h)
          if (h < g) acc[h][r] *= alpha_s[h];
        for (int j = 0; j < nt; ++j) {
          const float vx = to_float(vb[(k0 + j) * vss + x]);
#pragma unroll
          for (int h = 0; h < kMaxG; ++h)
            if (h < g) acc[h][r] += sc[h * kTile + j] * vx;
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < kDimsPerThread; ++r) {
    const int x = tid + r * kThreads;
    if (x < d) {
#pragma unroll
      for (int h = 0; h < kMaxG; ++h)
        if (h < g) o[(head0 + h) * d + x] = acc[h][r];
    }
  }
  for (int h = tid; h < g; h += kThreads) {
    m_out[head0 + h] = m_s[h];
    l_out[head0 + h] = l_s[h];
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* length,
           void* o, void* m, void* l, long long B, long long S, int H,
           int Hkv, int d, long long ksb, long long kss, long long ksh,
           long long vsb, long long vss, long long vsh, cudaStream_t stream) {
  const int g = H / Hkv;
  const size_t smem = sizeof(float) * (static_cast<size_t>(g) * d +
                                       static_cast<size_t>(g) * kTile + 3 * g);
  const dim3 grid(static_cast<unsigned>(Hkv), static_cast<unsigned>(B));
  flash_decode_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int32_t*>(length),
      static_cast<float*>(o), static_cast<float*>(m), static_cast<float*>(l),
      S, H, Hkv, d, ksb, kss, ksh, vsb, vss, vsh,
      static_cast<float>(1.0 / sqrt(static_cast<double>(d))));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// bf16 != 0: q, k, v are __nv_bfloat16, else float. Strides in elements.
extern "C" int repro_flash_decode(const void* q, const void* k, const void* v,
                                  const void* length, void* o, void* m,
                                  void* l, long long B, long long S, int H,
                                  int Hkv, int d, long long ksb, long long kss,
                                  long long ksh, long long vsb, long long vss,
                                  long long vsh, int bf16, void* stream) {
  if (B <= 0 || Hkv <= 0) return static_cast<int>(cudaGetLastError());
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch<__nv_bfloat16>(q, k, v, length, o, m, l, B, S, H, Hkv, d,
                                 ksb, kss, ksh, vsb, vss, vsh, st);
  return launch<float>(q, k, v, length, o, m, l, B, S, H, Hkv, d, ksb, kss,
                       ksh, vsb, vss, vsh, st);
}

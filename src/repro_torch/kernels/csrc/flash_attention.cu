// flash_attention.cu — forward GQA flash attention, causal and/or local
// window, on Hopper.
//
// Replaces the Pallas TPU kernel B5 of repro/kernels/flash_attention.py
// (_flash_kernel / flash_attention) with the contract of
// repro_torch/kernels/ref.py mha: q viewed as (B, H, S, d), k and v as
// (B, Hkv, Skv, d), each with any strides but a unit stride on d; query
// head h reads kv head h / (H / Hkv). Query row i sits at position
// i + Skv - S, aligned to the END of the kv sequence (as ref.mha and the
// model's _chunk_mask align it; the Pallas kernel aligned queries to the
// start, which agrees only when S == Skv). Key j is live for row i when
// j <= pos_i (causal) and j > pos_i - window (window > 0). Output o is
// written contiguous in the model's (B, S, H, d) layout, in q's type:
//   o_i = sum_j p_ij v_j / sum_j p_ij,  p_ij = exp(s_ij - m_i),
//   s_ij = (q_i . k_j) * d**-0.5,
// with f32 scores, online softmax and accumulator. A row with no live key
// gives 0 (l = 0), as the model's flash forward does.
//
// The Pallas grid (B, H, nq, nk) walked the kv tiles minor-most with the
// running (acc, m, l) in VMEM scratch and skipped tiles outside
// [q_lo - window, q_hi] under pl.when. Here one block of 256 threads takes
// one (batch row, query head, tile of 64 query rows) and loops over the kv
// tiles of 32 keys between the window's lower bound of its first row and
// the causal frontier of its last row only: skipped tiles cost nothing,
// which is what chunked_flash's causal-skip split relies on. Per kv tile:
// the K and V tiles are staged in shared memory (f32); (1) each thread
// computes a 4 x 2 block of scores, reading float4 runs of its Q and K rows
// (rows padded by 4 floats, so a quarter warp hits 32 distinct banks);
// (2) each row's tile max and sum are reduced over the 16 threads that
// share the row with shuffles, and the probabilities go to shared memory;
// (3) each thread adds p @ V into its 4 rows x d/16 columns of the
// accumulator, which stays in registers (64 floats a thread at d = 256).
//
// Bound: operations at the prefill shapes (4 d flops per live (q, k) pair
// and head against 2 d bytes of K and V per key, reused by 64 query rows
// and all heads). This first version runs the products as scalar f32 FMAs
// on the CUDA cores, not on the tensor cores, so it is bound by the f32
// issue rate and shared-memory traffic, far above the bf16 tensor-core
// bound; at d = 256 the Q, K, V and P tiles take 141 KB of shared memory,
// one block per SM. wgmma with TMA-fed tiles is the later redesign.
#include <cmath>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBQ = 64;          // query rows a block
constexpr int kBK = 32;          // keys a tile
constexpr int kRows = 4;         // query rows a thread (16 row groups)
constexpr int kNJ = kBK / 16;    // score columns a thread
constexpr int kPad = 4;          // floats of padding per Q / K row
constexpr int kPStride = kBK + 1;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// max / sum over the 16 lanes that share a row (lanes 0-15 or 16-31)
__device__ __forceinline__ float row_max(float x) {
  for (int off = 8; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}
__device__ __forceinline__ float row_sum(float x) {
  for (int off = 8; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (static_cast<size_t>(kBQ) * (D + kPad) +
                          static_cast<size_t>(kBK) * (D + kPad) +
                          static_cast<size_t>(kBK) * D +
                          static_cast<size_t>(kBQ) * kPStride);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int S,
                       int Skv, int H, int Hkv, long long qsb, long long qss,
                       long long qsh, long long ksb, long long kss,
                       long long ksh, long long vsb, long long vss,
                       long long vsh, int causal, int window, float scale) {
  constexpr int kQK = D + kPad;
  constexpr int kNC = D / 16;    // accumulator columns a thread
  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);   // (kBQ, kQK)
  float* k_s = q_s + kBQ * kQK;                   // (kBK, kQK)
  float* v_s = k_s + kBK * kQK;                   // (kBK, D)
  float* p_s = v_s + kBK * D;                     // (kBQ, kPStride)

  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const long long b = blockIdx.z;
  const int kvh = h / (H / Hkv);
  const int tid = threadIdx.x;
  const int ty = tid / 16;
  const int tx = tid % 16;
  const int shift = Skv - S;       // query row i sits at position i + shift

  const T* qb = q + b * qsb + static_cast<long long>(h) * qsh;
  const T* kb = k + b * ksb + static_cast<long long>(kvh) * ksh;
  const T* vb = v + b * vsb + static_cast<long long>(kvh) * vsh;
  for (int e = tid; e < kBQ * D; e += kThreads) {
    const int r = e / D, x = e % D;
    q_s[r * kQK + x] =
        q0 + r < S ? to_float(qb[static_cast<long long>(q0 + r) * qss + x])
                   : 0.f;
  }

  // live keys of this block: from the window's lower bound of its first
  // row to the causal frontier of its last row
  const int q_last = (q0 + kBQ < S ? q0 + kBQ : S) - 1;
  int k_begin = 0, k_end = Skv;
  if (window > 0) k_begin = max(0, q0 + shift - window + 1);
  if (causal) k_end = min(Skv, q_last + shift + 1);

  int lo[kRows], hi[kRows];   // live keys of each row: lo <= j <= hi
  float m[kRows], l[kRows], acc[kRows][kNC];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int row = q0 + ty * kRows + i;
    const int pos = row + shift;
    lo[i] = window > 0 ? pos - window + 1 : 0;
    hi[i] = causal ? pos : Skv - 1;
    if (row >= S) hi[i] = -1;   // padding row: nothing live
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kNC; ++c) acc[i][c] = 0.f;
  }

  for (int k0 = k_begin; k0 < k_end; k0 += kBK) {
    const int nt = min(kBK, k_end - k0);
    __syncthreads();   // the previous tile's K, V and P are consumed
    for (int e = tid; e < kBK * D; e += kThreads) {
      const int r = e / D, x = e % D;
      const long long j = k0 + r;
      k_s[r * kQK + x] = r < nt ? to_float(kb[j * kss + x]) : 0.f;
      v_s[r * D + x] = r < nt ? to_float(vb[j * vss + x]) : 0.f;
    }
    __syncthreads();

    // (1) scores of this thread's rows ty*4+i and keys tx + 16*jj
    float s[kRows][kNJ];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int jj = 0; jj < kNJ; ++jj) s[i][jj] = 0.f;
#pragma unroll 4
    for (int x = 0; x < D; x += 4) {
      float4 qv[kRows], kv[kNJ];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
        qv[i] = *reinterpret_cast<const float4*>(
            &q_s[(ty * kRows + i) * kQK + x]);
#pragma unroll
      for (int jj = 0; jj < kNJ; ++jj)
        kv[jj] = *reinterpret_cast<const float4*>(
            &k_s[(tx + 16 * jj) * kQK + x]);
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int jj = 0; jj < kNJ; ++jj) {
          s[i][jj] = fmaf(qv[i].x, kv[jj].x, s[i][jj]);
          s[i][jj] = fmaf(qv[i].y, kv[jj].y, s[i][jj]);
          s[i][jj] = fmaf(qv[i].z, kv[jj].z, s[i][jj]);
          s[i][jj] = fmaf(qv[i].w, kv[jj].w, s[i][jj]);
        }
    }

    // (2) online softmax of each row over this tile
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      bool live[kNJ];
      float mx = -INFINITY;
#pragma unroll
      for (int jj = 0; jj < kNJ; ++jj) {
        const int c = tx + 16 * jj;
        const int j = k0 + c;
        live[jj] = c < nt && j >= lo[i] && j <= hi[i];
        s[i][jj] = live[jj] ? s[i][jj] * scale : -INFINITY;
        mx = fmaxf(mx, s[i][jj]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      const float m_use = isfinite(m_new) ? m_new : 0.f;
      float sum = 0.f;
#pragma unroll
      for (int jj = 0; jj < kNJ; ++jj) {
        const float p = live[jj] ? expf(s[i][jj] - m_use) : 0.f;
        sum += p;
        p_s[(ty * kRows + i) * kPStride + tx + 16 * jj] = p;
      }
      const float alpha = isfinite(m[i]) ? expf(m[i] - m_use) : 0.f;
      l[i] = l[i] * alpha + row_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kNC; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

    // (3) acc += p @ V on this thread's rows and columns tx + 16*c
    for (int j = 0; j < nt; ++j) {
      float p[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
        p[i] = p_s[(ty * kRows + i) * kPStride + j];
#pragma unroll
      for (int c = 0; c < kNC; ++c) {
        const float vx = v_s[j * D + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < kRows; ++i) acc[i][c] = fmaf(p[i], vx, acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int row = q0 + ty * kRows + i;
    if (row >= S) continue;
    const float inv_l = 1.f / fmaxf(l[i], 1e-30f);
    T* orow = o + ((b * S + row) * H + h) * static_cast<long long>(D);
#pragma unroll
    for (int c = 0; c < kNC; ++c) store(&orow[tx + 16 * c], acc[i][c] * inv_l);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int S, int Skv, int H, int Hkv, const long long* st, int causal,
           int window, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  auto kernel = flash_attention_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>((S + kBQ - 1) / kBQ),
                  static_cast<unsigned>(H), static_cast<unsigned>(B));
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), S, Skv, H, Hkv, st[0],
      st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], causal, window,
      static_cast<float>(1.0 / sqrt(static_cast<double>(D))));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_d(const void* q, const void* k, const void* v, void* o, int B,
             int S, int Skv, int H, int Hkv, int d, const long long* st,
             int causal, int window, cudaStream_t stream) {
  switch (d) {
    case 16:
      return launch<T, 16>(q, k, v, o, B, S, Skv, H, Hkv, st, causal, window,
                           stream);
    case 32:
      return launch<T, 32>(q, k, v, o, B, S, Skv, H, Hkv, st, causal, window,
                           stream);
    case 64:
      return launch<T, 64>(q, k, v, o, B, S, Skv, H, Hkv, st, causal, window,
                           stream);
    case 128:
      return launch<T, 128>(q, k, v, o, B, S, Skv, H, Hkv, st, causal,
                            window, stream);
    case 256:
      return launch<T, 256>(q, k, v, o, B, S, Skv, H, Hkv, st, causal,
                            window, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// bf16 != 0: q, k, v and o are __nv_bfloat16, else float. Strides in
// elements: q (batch, seq, head), k (batch, seq, head), v (batch, seq,
// head); d has stride 1. d in {16, 32, 64, 128, 256}; H % Hkv == 0.
extern "C" int repro_flash_attention(
    const void* q, const void* k, const void* v, void* o, int B, int S,
    int Skv, int H, int Hkv, int d, long long qsb, long long qss,
    long long qsh, long long ksb, long long kss, long long ksh,
    long long vsb, long long vss, long long vsh, int causal, int window,
    int bf16, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0) return static_cast<int>(cudaGetLastError());
  const long long st[9] = {qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch_d<__nv_bfloat16>(q, k, v, o, B, S, Skv, H, Hkv, d, st,
                                   causal, window, s);
  return launch_d<float>(q, k, v, o, B, S, Skv, H, Hkv, d, st, causal,
                         window, s);
}

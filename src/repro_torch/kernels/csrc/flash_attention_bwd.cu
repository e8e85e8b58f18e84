// flash_attention_bwd.cu — the backward of GQA flash attention, causal
// and/or local window, on Hopper.
//
// Replaces no Pallas kernel: the JAX model's custom backward of
// flash_train (repro/models/lm.py _flash_train_bwd, lm.py:138-175) is jnp,
// which XLA compiles. Its contract is repro_torch/kernels/ref.py
// flash_bwd: q, o, do viewed as (B, H, S, d), k and v as (B, Hkv, Skv, d),
// each with any strides but a unit stride on d, and lse (B, H, S) f32, the
// forward's log-sum-exp of each row (flash_attention.cu; +inf for a row
// with no live key). Query head h reads kv head h / (H / Hkv); query row i
// sits at position i + Skv - S (end-aligned, as the forward). With
//   s_ij = (q_i . k_j) * scale,   p_ij = exp(s_ij - lse_i) on live keys,
//   delta_i = sum(do_i * o_i),    ds_ij = p_ij (do_i . v_j - delta_i) scale,
// it writes dq_i = sum_j ds_ij k_j, dk_j = sum_i ds_ij q_i and
// dv_j = sum_i p_ij do_i, dk and dv summed over the g query heads of their
// kv head, contiguous in the model's (B, S, H, d) / (B, Skv, Hkv, d)
// layouts, in the input type. f32 and bf16 inputs; all math in f32.
//
// Bound: operations, 7 d multiply-adds per live (q, k) pair and head as
// computed here (s and do . v twice, once in each pass, and the three
// products), against the forward's 2 d.
//
// Design (simple first): three launches, no atomics, so the result does
// not depend on the order blocks run in.
//   1. delta_kernel: one warp per (b, row, head) sums do * o.
//   2. dkdv_kernel: one block per (tile of kBK keys, kv head, b) keeps its
//      K and V tile in shared memory (f32) and walks the query rows of
//      each of its g heads that can see the tile (the causal and window
//      bounds of the tile's first and last key), kBQ rows at a time:
//      S = Q K^T and dP = dO V^T as 2 x 2 blocks a thread (float4 reads of
//      padded rows), then P and dS into shared memory, then each thread
//      adds P^T dO and dS^T Q into the 2 keys x d/16 columns of dV and dK
//      it keeps in registers.
//   3. dq_kernel: one block per (tile of kBQ query rows, head, b) keeps
//      its Q and dO tile and walks the kv tiles between the window's lower
//      bound of its first row and the causal frontier of its last, with
//      the same S / dP step, adding dS K into 2 rows x d/16 columns a
//      thread.
// Tiles are 32 x 32 at every d; shared memory is 4 tiles of 32 rows of
// d + 4 floats plus the P and dS tiles: 43,776 bytes at d = 64, 141,824 at
// d = 256, where a kv tile of K, V, dK and dV in f32 at the forward's
// 64-key tiles would not fit beside Q and dO (dK and dV live in registers
// here, 64 floats a thread at d = 256). The CUDA-core f32 products are
// the first port's; the tensor cores are later work.
#include <cmath>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

using bf16 = __nv_bfloat16;
constexpr int kThreads = 256;
constexpr int kBQ = 32;          // query rows a tile
constexpr int kBK = 32;          // keys a tile
constexpr int kPad = 4;          // floats of padding per row
constexpr int kPS = kBK + 1;     // row stride of the P and dS tiles

struct Strides {
  long long b, s, h;             // batch, sequence, head (elements)
};

struct Args {
  const void *q, *k, *v, *o, *dout;
  const float* lse;
  float* delta;                  // (B, H, S) scratch
  void *dq, *dk, *dv;            // contiguous (B, S, H, d) / (B, Skv, Hkv, d)
  int B, S, Skv, H, Hkv;
  Strides sq, sk, sv, so, sdo;
  int causal, window;
  float scale;
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float x) {
  return __float2bfloat16_rn(x);
}

template <int D>
constexpr size_t smem_bytes() {  // Q, dO, K, V; P, dS; lse, delta
  return sizeof(float) * (static_cast<size_t>(2 * kBQ + 2 * kBK) * (D + kPad) +
                          2 * kBQ * kPS + 2 * kBQ);
}

// live keys of query row `row`: first <= j <= last (last = -1: none)
__device__ __forceinline__ void live_keys(int row, const Args& a, int* first,
                                          int* last) {
  const int pos = row + a.Skv - a.S;
  *first = a.window > 0 ? pos - a.window + 1 : 0;
  *last = row >= a.S ? -1 : (a.causal ? min(pos, a.Skv - 1) : a.Skv - 1);
}

// rows [r0, r0 + 32) of one head of x (strides st) into shared rows of
// D + kPad floats, as f32; zeros past `limit`
template <typename T, int D>
__device__ __forceinline__ void load_rows(float* dst, const T* x,
                                          const Strides& st, long long b,
                                          int head, int r0, int limit) {
  constexpr int kRow = D + kPad;
  const T* base = x + b * st.b + static_cast<long long>(head) * st.h;
  for (int e = threadIdx.x; e < 32 * D; e += kThreads) {
    const int r = e / D, c = e % D;
    const int row = r0 + r;
    dst[r * kRow + c] =
        row < limit ? to_f(base[static_cast<long long>(row) * st.s + c]) : 0.f;
  }
}

// S = Q K^T and dP = dO V^T of rows 2 ty + {0, 1} and keys tx + 16 {0, 1}
// of the current tiles
template <int D>
__device__ __forceinline__ void scores(const float* q_s, const float* do_s,
                                       const float* k_s, const float* v_s,
                                       int ty, int tx, float s[2][2],
                                       float dp[2][2]) {
  constexpr int kRow = D + kPad;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
  for (int x = 0; x < D; x += 4) {
    float4 qv[2], dv[2], kv[2], vv[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      qv[i] = *reinterpret_cast<const float4*>(&q_s[(2 * ty + i) * kRow + x]);
      dv[i] = *reinterpret_cast<const float4*>(&do_s[(2 * ty + i) * kRow + x]);
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      kv[j] = *reinterpret_cast<const float4*>(&k_s[(tx + 16 * j) * kRow + x]);
      vv[j] = *reinterpret_cast<const float4*>(&v_s[(tx + 16 * j) * kRow + x]);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        s[i][j] = fmaf(qv[i].x, kv[j].x, s[i][j]);
        s[i][j] = fmaf(qv[i].y, kv[j].y, s[i][j]);
        s[i][j] = fmaf(qv[i].z, kv[j].z, s[i][j]);
        s[i][j] = fmaf(qv[i].w, kv[j].w, s[i][j]);
        dp[i][j] = fmaf(dv[i].x, vv[j].x, dp[i][j]);
        dp[i][j] = fmaf(dv[i].y, vv[j].y, dp[i][j]);
        dp[i][j] = fmaf(dv[i].z, vv[j].z, dp[i][j]);
        dp[i][j] = fmaf(dv[i].w, vv[j].w, dp[i][j]);
      }
  }
}

// P and dS of the tile at query rows q0 + r and keys k0 + c into shared
// memory (0 where the key is not live for the row)
template <int D>
__device__ __forceinline__ void probs(const Args& a, const float* q_s,
                                      const float* do_s, const float* k_s,
                                      const float* v_s, const float* lse_s,
                                      const float* del_s, int q0, int k0,
                                      float* p_s, float* ds_s) {
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  float s[2][2], dp[2][2];
  scores<D>(q_s, do_s, k_s, v_s, ty, tx, s, dp);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = 2 * ty + i;
    int first, last;
    live_keys(q0 + r, a, &first, &last);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int c = tx + 16 * j;
      const int key = k0 + c;
      const bool live = key >= first && key <= last;
      const float p = live ? expf(s[i][j] * a.scale - lse_s[r]) : 0.f;
      if (p_s != nullptr) p_s[r * kPS + c] = p;
      ds_s[r * kPS + c] = p * (dp[i][j] - del_s[r]) * a.scale;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) delta_kernel(Args a, int d) {
  const long long w = blockIdx.x * (kThreads / 32LL) + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (w >= static_cast<long long>(a.B) * a.S * a.H) return;
  const int h = static_cast<int>(w % a.H);
  const long long r = w / a.H;
  const int row = static_cast<int>(r % a.S);
  const long long b = r / a.S;
  const T* o = static_cast<const T*>(a.o) + b * a.so.b + row * a.so.s +
               h * a.so.h;
  const T* g = static_cast<const T*>(a.dout) + b * a.sdo.b +
               row * a.sdo.s + h * a.sdo.h;
  float sum = 0.f;
  for (int x = lane; x < d; x += 32) sum = fmaf(to_f(g[x]), to_f(o[x]), sum);
  for (int off = 16; off > 0; off >>= 1)
    sum += __shfl_xor_sync(0xffffffffu, sum, off);
  if (lane == 0) a.delta[(b * a.H + h) * a.S + row] = sum;
}

// the per-row statistics of rows [r0, r0 + 32) of head h; past S: lse
// +inf (no probability) and delta 0
__device__ __forceinline__ void load_stats(const Args& a, long long b, int h,
                                           int r0, float* lse_s,
                                           float* del_s) {
  if (threadIdx.x < kBQ) {
    const int row = r0 + threadIdx.x;
    const long long at = (b * a.H + h) * a.S + row;
    lse_s[threadIdx.x] = row < a.S ? a.lse[at] : INFINITY;
    del_s[threadIdx.x] = row < a.S ? a.delta[at] : 0.f;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) dkdv_kernel(Args a) {
  constexpr int kRow = D + kPad;
  constexpr int kNC = D / 16;   // columns a thread
  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);
  float* do_s = q_s + kBQ * kRow;
  float* k_s = do_s + kBQ * kRow;
  float* v_s = k_s + kBK * kRow;
  float* p_s = v_s + kBK * kRow;
  float* ds_s = p_s + kBQ * kPS;
  float* lse_s = ds_s + kBQ * kPS;
  float* del_s = lse_s + kBQ;

  const int k0 = blockIdx.x * kBK;
  const int kvh = blockIdx.y;
  const long long b = blockIdx.z;
  const int g = a.H / a.Hkv;
  const int shift = a.Skv - a.S;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  load_rows<T, D>(k_s, static_cast<const T*>(a.k), a.sk, b, kvh, k0, a.Skv);
  load_rows<T, D>(v_s, static_cast<const T*>(a.v), a.sv, b, kvh, k0, a.Skv);

  // query rows that can see a key of this tile
  const int k_last = min(k0 + kBK, a.Skv) - 1;
  const int i_begin = a.causal ? max(0, k0 - shift) : 0;
  const int i_end =
      a.window > 0 ? min(a.S, k_last + a.window - shift) : a.S;

  float dk[2][kNC], dv[2][kNC];
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int c = 0; c < kNC; ++c) dk[j][c] = dv[j][c] = 0.f;

  for (int hq = 0; hq < g; ++hq) {
    const int h = kvh * g + hq;
    for (int q0 = i_begin; q0 < i_end; q0 += kBQ) {
      __syncthreads();   // the previous rows' tiles are consumed
      load_rows<T, D>(q_s, static_cast<const T*>(a.q), a.sq, b, h, q0, a.S);
      load_rows<T, D>(do_s, static_cast<const T*>(a.dout), a.sdo, b, h, q0,
                      a.S);
      load_stats(a, b, h, q0, lse_s, del_s);
      __syncthreads();
      probs<D>(a, q_s, do_s, k_s, v_s, lse_s, del_s, q0, k0, p_s, ds_s);
      __syncthreads();
      // dV += P^T dO, dK += dS^T Q on keys 2 ty + {0, 1}, columns
      // tx + 16 c
      for (int r = 0; r < kBQ; ++r) {
        const float p0 = p_s[r * kPS + 2 * ty], p1 = p_s[r * kPS + 2 * ty + 1];
        const float s0 = ds_s[r * kPS + 2 * ty];
        const float s1 = ds_s[r * kPS + 2 * ty + 1];
#pragma unroll
        for (int c = 0; c < kNC; ++c) {
          const float gx = do_s[r * kRow + tx + 16 * c];
          const float qx = q_s[r * kRow + tx + 16 * c];
          dv[0][c] = fmaf(p0, gx, dv[0][c]);
          dv[1][c] = fmaf(p1, gx, dv[1][c]);
          dk[0][c] = fmaf(s0, qx, dk[0][c]);
          dk[1][c] = fmaf(s1, qx, dk[1][c]);
        }
      }
    }
  }

#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int key = k0 + 2 * ty + j;
    if (key >= a.Skv) continue;
    const long long at = ((b * a.Skv + key) * a.Hkv + kvh) * D;
    T* dkp = static_cast<T*>(a.dk) + at;
    T* dvp = static_cast<T*>(a.dv) + at;
#pragma unroll
    for (int c = 0; c < kNC; ++c) {
      dkp[tx + 16 * c] = from_f<T>(dk[j][c]);
      dvp[tx + 16 * c] = from_f<T>(dv[j][c]);
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) dq_kernel(Args a) {
  constexpr int kRow = D + kPad;
  constexpr int kNC = D / 16;
  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);
  float* do_s = q_s + kBQ * kRow;
  float* k_s = do_s + kBQ * kRow;
  float* v_s = k_s + kBK * kRow;
  float* ds_s = v_s + kBK * kRow + kBQ * kPS;   // after the unused P tile
  float* lse_s = ds_s + kBQ * kPS;
  float* del_s = lse_s + kBQ;

  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const long long b = blockIdx.z;
  const int kvh = h / (a.H / a.Hkv);
  const int shift = a.Skv - a.S;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  load_rows<T, D>(q_s, static_cast<const T*>(a.q), a.sq, b, h, q0, a.S);
  load_rows<T, D>(do_s, static_cast<const T*>(a.dout), a.sdo, b, h, q0, a.S);
  load_stats(a, b, h, q0, lse_s, del_s);

  // keys this tile's rows can see: from the window's lower bound of its
  // first row to the causal frontier of its last
  const int q_last = min(q0 + kBQ, a.S) - 1;
  const int k_begin = a.window > 0 ? max(0, q0 + shift - a.window + 1) : 0;
  const int k_end = a.causal ? min(a.Skv, q_last + shift + 1) : a.Skv;

  float dq[2][kNC];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int c = 0; c < kNC; ++c) dq[i][c] = 0.f;

  for (int k0 = k_begin; k0 < k_end; k0 += kBK) {
    __syncthreads();   // the previous K, V and dS tiles are consumed
    load_rows<T, D>(k_s, static_cast<const T*>(a.k), a.sk, b, kvh, k0,
                    a.Skv);
    load_rows<T, D>(v_s, static_cast<const T*>(a.v), a.sv, b, kvh, k0,
                    a.Skv);
    __syncthreads();
    probs<D>(a, q_s, do_s, k_s, v_s, lse_s, del_s, q0, k0, nullptr, ds_s);
    __syncthreads();
    // dQ += dS K on rows 2 ty + {0, 1}, columns tx + 16 c
    for (int j = 0; j < kBK; ++j) {
      const float s0 = ds_s[(2 * ty) * kPS + j];
      const float s1 = ds_s[(2 * ty + 1) * kPS + j];
#pragma unroll
      for (int c = 0; c < kNC; ++c) {
        const float kx = k_s[j * kRow + tx + 16 * c];
        dq[0][c] = fmaf(s0, kx, dq[0][c]);
        dq[1][c] = fmaf(s1, kx, dq[1][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + 2 * ty + i;
    if (row >= a.S) continue;
    T* dqp = static_cast<T*>(a.dq) + ((b * a.S + row) * a.H + h) * D;
#pragma unroll
    for (int c = 0; c < kNC; ++c) dqp[tx + 16 * c] = from_f<T>(dq[i][c]);
  }
}

template <typename T, int D>
int launch(const Args& a, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      dkdv_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(dq_kernel<T, D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long rows = static_cast<long long>(a.B) * a.S * a.H;
  delta_kernel<T><<<static_cast<unsigned>((rows + 7) / 8), kThreads, 0,
                    stream>>>(a, D);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (a.Skv > 0) {
    const dim3 grid(static_cast<unsigned>((a.Skv + kBK - 1) / kBK),
                    static_cast<unsigned>(a.Hkv), static_cast<unsigned>(a.B));
    dkdv_kernel<T, D><<<grid, kThreads, smem, stream>>>(a);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(static_cast<unsigned>((a.S + kBQ - 1) / kBQ),
                  static_cast<unsigned>(a.H), static_cast<unsigned>(a.B));
  dq_kernel<T, D><<<grid, kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_d(const Args& a, int is_bf16, cudaStream_t stream) {
  return is_bf16 ? launch<bf16, D>(a, stream) : launch<float, D>(a, stream);
}

}  // namespace

// Dynamic shared memory of the dK/dV and dQ blocks at head dim d (0 for a
// d without an instantiation).
extern "C" long long repro_flash_attention_bwd_smem_bytes(int d) {
  switch (d) {
    case 16: return static_cast<long long>(smem_bytes<16>());
    case 32: return static_cast<long long>(smem_bytes<32>());
    case 64: return static_cast<long long>(smem_bytes<64>());
    case 128: return static_cast<long long>(smem_bytes<128>());
    case 256: return static_cast<long long>(smem_bytes<256>());
    default: return 0;
  }
}

// is_bf16 != 0: q, k, v, o, dout, dq, dk and dv are __nv_bfloat16, else
// float. lse (B, H, S) f32; delta (B, H, S) f32 scratch. strides: 15
// element strides, (batch, seq, head) of q, k, v, o and dout in that
// order; d has stride 1. dq is written contiguous (B, S, H, d), dk and dv
// (B, Skv, Hkv, d). d in {16, 32, 64, 128, 256}; H % Hkv == 0.
extern "C" int repro_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* delta, void* dq, void* dk,
    void* dv, int B, int S, int Skv, int H, int Hkv, int d,
    const long long* strides, int causal, int window, int is_bf16,
    void* stream) {
  if (B <= 0 || S <= 0 || H <= 0) return static_cast<int>(cudaGetLastError());
  Args a;
  a.q = q; a.k = k; a.v = v; a.o = o; a.dout = dout;
  a.lse = static_cast<const float*>(lse);
  a.delta = static_cast<float*>(delta);
  a.dq = dq; a.dk = dk; a.dv = dv;
  a.B = B; a.S = S; a.Skv = Skv; a.H = H; a.Hkv = Hkv;
  Strides* st[5] = {&a.sq, &a.sk, &a.sv, &a.so, &a.sdo};
  for (int i = 0; i < 5; ++i)
    *st[i] = Strides{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  a.causal = causal;
  a.window = window;
  a.scale = static_cast<float>(1.0 / sqrt(static_cast<double>(d)));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 16: return launch_d<16>(a, is_bf16, s);
    case 32: return launch_d<32>(a, is_bf16, s);
    case 64: return launch_d<64>(a, is_bf16, s);
    case 128: return launch_d<128>(a, is_bf16, s);
    case 256: return launch_d<256>(a, is_bf16, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// flash_attention_bwd.cu — the backward of GQA flash attention, causal
// and/or local window, on Hopper (kernel B10).
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
// layouts, in the input type; every sum in f32.
//
// Bound: operations. The function needs 10 d flops a live (q, k) pair and
// head (q . k and do . v, each recomputed in both passes below, and the
// three products of dv, dk and dq: 2.5 times the forward's 4 d) against
// about 12 d bytes of q, k, v, o, do, dq, dk and dv per row, so the
// products belong on the tensor cores.
//
// Design. Three or four launches, no atomics anywhere, so the gradients
// are the same bits from run to run whatever order blocks run in:
//   1. delta_kernel: one warp per (b, row, head) sums do * o.
//   2. a dK/dV pass: one block per (tile of keys, kv head, b, group of
//      query heads) keeps its K and V tile and walks the query rows of its
//      heads that can see the tile (the causal and window bounds of the
//      tile's first and last key);
//   3. where the dK/dV grid had more than one group of query heads, a
//      pass that sums the groups' f32 partials in group order;
//   4. a dQ pass: one block per (tile of query rows, head, b) keeps its Q
//      and dO tile and walks the kv tiles between the window's lower bound
//      of its first row and the causal frontier of its last.
//
// bfloat16 (namespace tc): FlashAttention-2's backward on the tensor
// cores, mma.sync.m16n8k16 (bf16 in, f32 accumulate) on operands loaded by
// ldmatrix (.trans where a product reads q, do or k along its rows as the
// reduced axis). Four warps a block. Tiles sit in shared memory as bf16,
// rows padded by 16 bytes (the eight row addresses of an ldmatrix fall in
// eight bank groups), filled by 16-byte cp.async copies and double-
// buffered along the walked axis: the next step's Q and dO (dK/dV pass) or
// K and V (dQ pass) are in flight while this step's products run.
//   dK/dV pass: each warp owns 16 keys and computes S^T = K Q^T and dP^T =
//   V dO^T for them and the step's kBQ query rows; P^T = exp(S^T scale -
//   lse) and dS^T = P^T (dP^T - delta) scale come out in the accumulator
//   layout, which is the A operand's, and feed dV += P^T dO and dK +=
//   dS^T Q straight from registers: P and dS never go through shared
//   memory. dK and dV stay in registers, 16 x d each a warp; at d = 256
//   that is 256 floats a thread, so there two warps share 16 keys, each
//   keeping half of d's columns (both compute the keys' S^T and dP^T: 8 d
//   multiply-adds a pair and head in this pass where 6 d would do). Key
//   tiles are 64
//   (32 at d = 256) and query steps 64 rows at d <= 64, 32 above.
//   dQ pass: each warp owns 16 query rows (64 a block): S = Q K^T, dP =
//   dO V^T, then dQ += dS K with dS from registers. Kv tiles of 64 keys,
//   32 at d = 256.
//   P and dS are each split as hi = bf16(x) and lo = bf16(x - hi), two
//   products into the same f32 accumulator, which keeps about 16 bits of
//   them: a single bf16 rounding would move every term by up to 2**-9 of
//   itself, and over millions of outputs that crosses flash_bwd_tol's
//   2**-8 of the RMS. So the tensor cores do 20 d flops a live pair and
//   head (S and dP in each pass, dV, dK and dQ two products each; 24 d at
//   d = 256) for the 10 d of the bound.
//   A finer grid where one kv head starves the card: when B x Hkv x (key
//   tiles) is under two blocks an SM, the g = H / Hkv query heads of a kv
//   head are split into the fewest groups (a divisor of g) that reach it,
//   one block each; each writes f32 partial dK and dV to scratch the
//   wrapper allocates (repro_flash_attention_bwd_groups says how many),
//   and sum_groups_kernel adds them in group order and writes dK and dV
//   (recurrentgemma-9b at d = 256: g = 16, 96 key tiles, 4 groups on an
//   H100's 132 SMs).
//   wgmma, TMA and warp specialisation are later work.
//
// float32 (namespace simt): the first port's CUDA-core kernels, kept for
// the f32 path (the reduced models' CPU == GPU checks hold it to rtol
// 1e-5, which TF32 tensor cores cannot meet): per 32-key and 32-row tile
// S = Q K^T and dP = dO V^T as 2 x 2 blocks a thread (float4 reads of
// padded f32 rows), P and dS through shared memory, dK / dV / dQ in
// registers, 2 rows x d/16 columns a thread.
#include <cmath>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

using bf16 = __nv_bfloat16;
constexpr float kLog2e = 1.4426950408889634f;

struct Strides {
  long long b, s, h;             // batch, sequence, head (elements)
};

struct Args {
  const void *q, *k, *v, *o, *dout;
  const float* lse;
  float* delta;                  // (B, H, S) scratch
  float* part;                   // (2, groups, B, Skv, Hkv, d) f32 scratch
  void *dq, *dk, *dv;            // contiguous (B, S, H, d) / (B, Skv, Hkv, d)
  int B, S, Skv, H, Hkv;
  int groups;                    // groups of query heads in the dK/dV grid
  Strides sq, sk, sv, so, sdo;
  int causal, window;
  float scale, scale_log2;
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }

// live keys of query row `row`: first <= j <= last (last = -1: none)
__device__ __forceinline__ void live_keys(int row, const Args& a, int* first,
                                          int* last) {
  const int pos = row + a.Skv - a.S;
  *first = a.window > 0 ? pos - a.window + 1 : 0;
  *last = row >= a.S ? -1 : (a.causal ? min(pos, a.Skv - 1) : a.Skv - 1);
}

template <typename T>
__global__ void __launch_bounds__(256) delta_kernel(Args a, int d) {
  const long long w = blockIdx.x * 8LL + threadIdx.x / 32;
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

// ---------------------------------------------------------------------------
// float32: scalar FMAs on the CUDA cores
// ---------------------------------------------------------------------------
namespace simt {

constexpr int kThreads = 256;
constexpr int kBQ = 32;          // query rows a tile
constexpr int kBK = 32;          // keys a tile
constexpr int kPad = 4;          // floats of padding per row
constexpr int kPS = kBK + 1;     // row stride of the P and dS tiles

template <int D>
constexpr size_t smem_bytes() {  // Q, dO, K, V; P, dS; lse, delta
  return sizeof(float) * (static_cast<size_t>(2 * kBQ + 2 * kBK) * (D + kPad) +
                          2 * kBQ * kPS + 2 * kBQ);
}

// rows [r0, r0 + 32) of one head of x (strides st) into shared rows of
// D + kPad floats; zeros past `limit`
template <int D>
__device__ __forceinline__ void load_rows(float* dst, const float* x,
                                          const Strides& st, long long b,
                                          int head, int r0, int limit) {
  constexpr int kRow = D + kPad;
  const float* base = x + b * st.b + static_cast<long long>(head) * st.h;
  for (int e = threadIdx.x; e < 32 * D; e += kThreads) {
    const int r = e / D, c = e % D;
    const int row = r0 + r;
    dst[r * kRow + c] =
        row < limit ? base[static_cast<long long>(row) * st.s + c] : 0.f;
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

template <int D>
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
  const float* q = static_cast<const float*>(a.q);
  const float* dout = static_cast<const float*>(a.dout);
  load_rows<D>(k_s, static_cast<const float*>(a.k), a.sk, b, kvh, k0, a.Skv);
  load_rows<D>(v_s, static_cast<const float*>(a.v), a.sv, b, kvh, k0, a.Skv);

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
      load_rows<D>(q_s, q, a.sq, b, h, q0, a.S);
      load_rows<D>(do_s, dout, a.sdo, b, h, q0, a.S);
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
    float* dkp = static_cast<float*>(a.dk) + at;
    float* dvp = static_cast<float*>(a.dv) + at;
#pragma unroll
    for (int c = 0; c < kNC; ++c) {
      dkp[tx + 16 * c] = dk[j][c];
      dvp[tx + 16 * c] = dv[j][c];
    }
  }
}

template <int D>
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
  const float* k = static_cast<const float*>(a.k);
  const float* v = static_cast<const float*>(a.v);
  load_rows<D>(q_s, static_cast<const float*>(a.q), a.sq, b, h, q0, a.S);
  load_rows<D>(do_s, static_cast<const float*>(a.dout), a.sdo, b, h, q0,
               a.S);
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
    load_rows<D>(k_s, k, a.sk, b, kvh, k0, a.Skv);
    load_rows<D>(v_s, v, a.sv, b, kvh, k0, a.Skv);
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
    float* dqp = static_cast<float*>(a.dq) + ((b * a.S + row) * a.H + h) * D;
#pragma unroll
    for (int c = 0; c < kNC; ++c) dqp[tx + 16 * c] = dq[i][c];
  }
}

}  // namespace simt

// ---------------------------------------------------------------------------
// bfloat16: mma.sync on the tensor cores, cp.async double buffers
// ---------------------------------------------------------------------------
namespace tc {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;

// The tilings at head dim D.
template <int D>
struct Tiles {
  static constexpr int kRow = D + 8;                // padded shared row
  // dK/dV pass: kSplit warps share 16 keys, each keeping kDW of d's
  // columns of their dK and dV
  static constexpr int kSplit = D == 256 ? 2 : 1;
  static constexpr int kDW = D / kSplit;
  static constexpr int kBK = 16 * kWarps / kSplit;  // keys a block
  static constexpr int kBQ = D <= 64 ? 64 : 32;     // query rows a step
  // dQ pass: 16 query rows a warp, kv tiles of kQK keys
  static constexpr int kQR = 16 * kWarps;
  static constexpr int kQK = D == 256 ? 32 : 64;
  // K and V; Q and dO twice; lse and delta twice
  static constexpr size_t kv_smem =
      sizeof(bf16) * static_cast<size_t>(2 * kBK + 4 * kBQ) * kRow +
      sizeof(float) * 4 * kBQ;
  // Q and dO; K and V twice
  static constexpr size_t q_smem =
      sizeof(bf16) * static_cast<size_t>(2 * kQR + 4 * kQK) * kRow;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// global -> shared; zeros where !full
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(full ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool full) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(full ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(const bf16* p, uint32_t* r) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x4_trans(const bf16* p, uint32_t* r) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// c (16 x 8, f32) += a (16 x 16, bf16, row) * b (16 x 8, bf16, col)
__device__ __forceinline__ void mma(float* c, const uint32_t* a, uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// (x, y) as a bf16 pair `hi` plus the bf16 pair `lo` of what rounding
// left over: hi + lo is x and y to 2**-16 of their size
__device__ __forceinline__ void split_bf16(float x, float y, uint32_t* hi,
                                           uint32_t* lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const __nv_bfloat162 l =
      __floats2bfloat162_rn(x - __low2float(h), y - __high2float(h));
  *hi = *reinterpret_cast<const uint32_t*>(&h);
  *lo = *reinterpret_cast<const uint32_t*>(&l);
}

// The A operand (16 x 16) of k-step kk from accumulator tiles 2 kk and
// 2 kk + 1 (16 x 8 each), split into hi and lo
__device__ __forceinline__ void a_from_acc(const float (*c)[4], int kk,
                                           uint32_t* hi, uint32_t* lo) {
  split_bf16(c[2 * kk][0], c[2 * kk][1], &hi[0], &lo[0]);
  split_bf16(c[2 * kk][2], c[2 * kk][3], &hi[1], &lo[1]);
  split_bf16(c[2 * kk + 1][0], c[2 * kk + 1][1], &hi[2], &lo[2]);
  split_bf16(c[2 * kk + 1][2], c[2 * kk + 1][3], &hi[3], &lo[3]);
}

// c[n] (n < 2 * N16, tiles of 8 columns) += A (16 rows of `a_rows`, from
// shared memory) B^T, B's rows (16 N16 of them) at `b_rows`, over D / 16
// k-steps: the S = Q K^T shaped product, both operands row-major over d
template <int D, int N16>
__device__ __forceinline__ void mma_abt(float (*c)[4], const bf16* a_rows,
                                        const bf16* b_rows, int lane) {
  constexpr int kRow = D + 8;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t a[4];
    ldsm_x4(a_rows + (lane & 15) * kRow + kk * 16 + (lane >> 4) * 8, a);
#pragma unroll
    for (int np = 0; np < N16; ++np) {
      uint32_t b[4];
      ldsm_x4(b_rows + (np * 16 + (lane & 7) + ((lane >> 4) << 3)) * kRow +
                  kk * 16 + ((lane >> 3) & 1) * 8,
              b);
      mma(c[2 * np], a, b[0], b[1]);
      mma(c[2 * np + 1], a, b[2], b[3]);
    }
  }
}

// c[n] (n < W / 8) += (hi + lo) B over k-step kk: B's rows kk * 16 ...
// (the reduced axis) at `b_rows`, columns [0, W) from `b_rows`
template <int D, int W>
__device__ __forceinline__ void mma_split_b(float (*c)[4], const uint32_t* hi,
                                            const uint32_t* lo,
                                            const bf16* b_rows, int kk,
                                            int lane) {
  constexpr int kRow = D + 8;
#pragma unroll
  for (int np = 0; np < W / 16; ++np) {
    uint32_t b[4];
    ldsm_x4_trans(b_rows + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) *
                               kRow +
                      np * 16 + (lane >> 4) * 8,
                  b);
    mma(c[2 * np], hi, b[0], b[1]);
    mma(c[2 * np], lo, b[0], b[1]);
    mma(c[2 * np + 1], hi, b[2], b[3]);
    mma(c[2 * np + 1], lo, b[2], b[3]);
  }
}

// rows [r0, r0 + N) of one head (row stride rs from `base`) into shared
// rows of D + 8 elements by 16-byte copies; zeros from row `limit` on
template <int D, int N>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* base,
                                          long long rs, int r0, int limit) {
  constexpr int kChunks = D / 8;
  for (int e = threadIdx.x; e < N * kChunks; e += kThreads) {
    const int r = e / kChunks, c = e % kChunks;
    const bool in = r0 + r < limit;
    cp_async16(smem_addr(dst + r * (D + 8) + c * 8),
               base + (in ? static_cast<long long>(r0 + r) * rs : 0) + c * 8,
               in);
  }
}

// At d <= 64 held to 170 registers, so that three blocks share an SM:
// 189 registers and two blocks took 1.13-1.23x as long on an H100 at
// smollm-135m's train shapes (a few bytes spill).
template <int D>
__global__ void __launch_bounds__(kThreads, D <= 64 ? 3 : 1)
    dkdv_kernel(Args a) {
  using T = Tiles<D>;
  constexpr int kRow = T::kRow, kBK = T::kBK, kBQ = T::kBQ, kDW = T::kDW;
  constexpr int kKeyWarps = kWarps / T::kSplit;   // warps of distinct keys
  constexpr int kNS = kBQ / 8;                    // S^T tiles of 8 rows
  constexpr int kNO = kDW / 8;                    // dK, dV tiles of 8 cols
  extern __shared__ float4 smem4[];
  bf16* k_s = reinterpret_cast<bf16*>(smem4);     // (kBK, kRow)
  bf16* v_s = k_s + kBK * kRow;                   // (kBK, kRow)
  bf16* q_s = v_s + kBK * kRow;                   // (2, kBQ, kRow)
  bf16* do_s = q_s + 2 * kBQ * kRow;              // (2, kBQ, kRow)
  float* lse_s = reinterpret_cast<float*>(do_s + 2 * kBQ * kRow);  // (2, kBQ)
  float* del_s = lse_s + 2 * kBQ;                 // (2, kBQ)

  const int k0 = blockIdx.x * kBK;
  const int g = a.H / a.Hkv;
  const int per = g / a.groups;                   // query heads a block
  const int kvh = blockIdx.y / a.groups, grp = blockIdx.y % a.groups;
  const int h_first = kvh * g + grp * per;
  const long long b = blockIdx.z;
  const int shift = a.Skv - a.S;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int kw = warp % kKeyWarps, col0 = (warp / kKeyWarps) * kDW;
  const int gr = lane >> 2, tq = lane & 3;
  const bf16* q = static_cast<const bf16*>(a.q) + b * a.sq.b;
  const bf16* dout = static_cast<const bf16*>(a.dout) + b * a.sdo.b;

  load_tile<D, kBK>(k_s,
                    static_cast<const bf16*>(a.k) + b * a.sk.b +
                        static_cast<long long>(kvh) * a.sk.h,
                    a.sk.s, k0, a.Skv);
  load_tile<D, kBK>(v_s,
                    static_cast<const bf16*>(a.v) + b * a.sv.b +
                        static_cast<long long>(kvh) * a.sv.h,
                    a.sv.s, k0, a.Skv);

  // query rows that can see a key of this tile, walked head by head
  const int k_last = min(k0 + kBK, a.Skv) - 1;
  const int i_begin = a.causal ? max(0, k0 - shift) : 0;
  const int i_end =
      a.window > 0 ? min(a.S, k_last + a.window - shift) : a.S;
  const int nq = i_end > i_begin ? (i_end - i_begin + kBQ - 1) / kBQ : 0;
  const int n_steps = per * nq;
  auto issue = [&](int t) {   // Q, dO, lse and delta of step t into stage t & 1
    const int h = h_first + t / nq;
    const int q0 = i_begin + (t % nq) * kBQ;
    const int st = t & 1;
    load_tile<D, kBQ>(q_s + st * kBQ * kRow,
                      q + static_cast<long long>(h) * a.sq.h, a.sq.s, q0,
                      a.S);
    load_tile<D, kBQ>(do_s + st * kBQ * kRow,
                      dout + static_cast<long long>(h) * a.sdo.h, a.sdo.s,
                      q0, a.S);
    if (threadIdx.x < kBQ) {   // rows past S: zeros, and masked below
      const int row = q0 + threadIdx.x;
      const bool in = row < a.S;
      const long long at = (b * a.H + h) * a.S + (in ? row : 0);
      cp_async4(smem_addr(lse_s + st * kBQ + threadIdx.x), a.lse + at, in);
      cp_async4(smem_addr(del_s + st * kBQ + threadIdx.x), a.delta + at, in);
    }
  };
  if (n_steps > 0) issue(0);
  cp_async_commit();   // K, V and step 0

  // this thread's keys (rows of S^T): kw * 16 + gr and + 8
  const int key0 = k0 + kw * 16 + gr;
  float dk[kNO][4], dv[kNO][4];
#pragma unroll
  for (int c = 0; c < kNO; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[c][e] = dv[c][e] = 0.f;

  for (int t = 0; t < n_steps; ++t) {
    __syncthreads();   // every warp is done with the stage refilled next
    if (t + 1 < n_steps) issue(t + 1);
    cp_async_commit();
    cp_async_wait<1>();   // K, V and step t have landed
    __syncthreads();
    const int st = t & 1;
    const int q0 = i_begin + (t % nq) * kBQ;
    const bf16* qs = q_s + st * kBQ * kRow;
    const bf16* dos = do_s + st * kBQ * kRow;
    const float* ls = lse_s + st * kBQ;
    const float* dl = del_s + st * kBQ;

    // (1) S^T = K Q^T and dP^T = V dO^T: the warp's 16 keys x kBQ rows
    float s[kNS][4], dp[kNS][4];
#pragma unroll
    for (int n = 0; n < kNS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
    mma_abt<D, kBQ / 16>(s, k_s + kw * 16 * kRow, qs, lane);
    mma_abt<D, kBQ / 16>(dp, v_s + kw * 16 * kRow, dos, lane);

    // (2) P^T and dS^T in place; element e of tile n: key key0 + 8 (e >> 1),
    // query row q0 + 8 n + 2 tq + (e & 1)
#pragma unroll
    for (int n = 0; n < kNS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = n * 8 + 2 * tq + (e & 1);
        const int key = key0 + 8 * (e >> 1);
        int first, last;
        live_keys(q0 + c, a, &first, &last);
        const bool live = key >= first && key <= last;
        const float p =
            live ? exp2f(fmaf(s[n][e], a.scale_log2, -ls[c] * kLog2e)) : 0.f;
        s[n][e] = p;
        dp[n][e] = p * (dp[n][e] - dl[c]) * a.scale;
      }

    // (3) dV += P^T dO, dK += dS^T Q on the warp's columns, P and dS as
    // hi + lo straight from registers
#pragma unroll
    for (int kk = 0; kk < kBQ / 16; ++kk) {
      uint32_t hi[4], lo[4];
      a_from_acc(s, kk, hi, lo);
      mma_split_b<D, kDW>(dv, hi, lo, dos + col0, kk, lane);
      a_from_acc(dp, kk, hi, lo);
      mma_split_b<D, kDW>(dk, hi, lo, qs + col0, kk, lane);
    }
  }
  cp_async_wait<0>();

  // (4) dK and dV of keys key0 + 8 ri, columns col0 + 8 c + 2 tq: in the
  // input type, or as this group's f32 partial
  const long long n_out = static_cast<long long>(a.B) * a.Skv * a.Hkv * D;
#pragma unroll
  for (int ri = 0; ri < 2; ++ri) {
    const int key = key0 + 8 * ri;
    if (key >= a.Skv) continue;
    const long long at = ((b * a.Skv + key) * a.Hkv + kvh) * D + col0 + 2 * tq;
#pragma unroll
    for (int c = 0; c < kNO; ++c) {
      if (a.groups == 1) {
        *reinterpret_cast<__nv_bfloat162*>(static_cast<bf16*>(a.dk) + at +
                                           c * 8) =
            __floats2bfloat162_rn(dk[c][2 * ri], dk[c][2 * ri + 1]);
        *reinterpret_cast<__nv_bfloat162*>(static_cast<bf16*>(a.dv) + at +
                                           c * 8) =
            __floats2bfloat162_rn(dv[c][2 * ri], dv[c][2 * ri + 1]);
      } else {
        float* pk = a.part + grp * n_out + at + c * 8;
        float* pv = a.part + (a.groups + grp) * n_out + at + c * 8;
        *reinterpret_cast<float2*>(pk) =
            make_float2(dk[c][2 * ri], dk[c][2 * ri + 1]);
        *reinterpret_cast<float2*>(pv) =
            make_float2(dv[c][2 * ri], dv[c][2 * ri + 1]);
      }
    }
  }
}

// dK and dV as the sums of the groups' partials, in group order: 4
// elements a thread of the n_out of each
__global__ void __launch_bounds__(256)
sum_groups_kernel(const float* __restrict__ part, bf16* __restrict__ dk,
                  bf16* __restrict__ dv, long long n_out, int groups) {
  const long long i = (blockIdx.x * 256LL + threadIdx.x) * 4;
  if (i >= n_out) return;
#pragma unroll
  for (int which = 0; which < 2; ++which) {
    const float* p = part + which * groups * n_out + i;
    float4 acc = *reinterpret_cast<const float4*>(p);
    for (int gi = 1; gi < groups; ++gi) {
      const float4 x = *reinterpret_cast<const float4*>(p + gi * n_out);
      acc.x += x.x;
      acc.y += x.y;
      acc.z += x.z;
      acc.w += x.w;
    }
    bf16* out = (which == 0 ? dk : dv) + i;
    reinterpret_cast<__nv_bfloat162*>(out)[0] =
        __floats2bfloat162_rn(acc.x, acc.y);
    reinterpret_cast<__nv_bfloat162*>(out)[1] =
        __floats2bfloat162_rn(acc.z, acc.w);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads) dq_kernel(Args a) {
  using T = Tiles<D>;
  constexpr int kRow = T::kRow, kQR = T::kQR, kBK = T::kQK;
  constexpr int kNS = kBK / 8;    // S tiles of 8 keys
  constexpr int kNO = D / 8;      // dQ tiles of 8 columns
  extern __shared__ float4 smem4[];
  bf16* q_s = reinterpret_cast<bf16*>(smem4);   // (kQR, kRow)
  bf16* do_s = q_s + kQR * kRow;                // (kQR, kRow)
  bf16* k_s = do_s + kQR * kRow;                // (2, kBK, kRow)
  bf16* v_s = k_s + 2 * kBK * kRow;             // (2, kBK, kRow)

  const int q0 = blockIdx.x * kQR;
  const int h = blockIdx.y;
  const long long b = blockIdx.z;
  const int kvh = h / (a.H / a.Hkv);
  const int shift = a.Skv - a.S;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gr = lane >> 2, tq = lane & 3;
  const bf16* kb = static_cast<const bf16*>(a.k) + b * a.sk.b +
                   static_cast<long long>(kvh) * a.sk.h;
  const bf16* vb = static_cast<const bf16*>(a.v) + b * a.sv.b +
                   static_cast<long long>(kvh) * a.sv.h;
  load_tile<D, kQR>(q_s,
                    static_cast<const bf16*>(a.q) + b * a.sq.b +
                        static_cast<long long>(h) * a.sq.h,
                    a.sq.s, q0, a.S);
  load_tile<D, kQR>(do_s,
                    static_cast<const bf16*>(a.dout) + b * a.sdo.b +
                        static_cast<long long>(h) * a.sdo.h,
                    a.sdo.s, q0, a.S);

  // keys this block's rows can see: from the window's lower bound of its
  // first row to the causal frontier of its last
  const int q_last = min(q0 + kQR, a.S) - 1;
  const int k_begin = a.window > 0 ? max(0, q0 + shift - a.window + 1) : 0;
  const int k_end = a.causal ? min(a.Skv, q_last + shift + 1) : a.Skv;
  const int n_tiles = k_end > k_begin ? (k_end - k_begin + kBK - 1) / kBK : 0;
  auto issue = [&](int t) {   // K and V of tile t into stage t & 1
    const int st = t & 1;
    load_tile<D, kBK>(k_s + st * kBK * kRow, kb, a.sk.s, k_begin + t * kBK,
                      k_end);
    load_tile<D, kBK>(v_s + st * kBK * kRow, vb, a.sv.s, k_begin + t * kBK,
                      k_end);
  };
  if (n_tiles > 0) issue(0);
  cp_async_commit();   // Q, dO and tile 0

  // this thread's rows: r_warp + gr and + 8; their statistics
  const int r_warp = q0 + warp * 16;
  int first[2], last[2];
  float lse2[2], del[2];
#pragma unroll
  for (int ri = 0; ri < 2; ++ri) {
    const int row = r_warp + gr + 8 * ri;
    live_keys(row, a, &first[ri], &last[ri]);
    const long long at = (b * a.H + h) * a.S + row;
    lse2[ri] = row < a.S ? a.lse[at] * kLog2e : 0.f;
    del[ri] = row < a.S ? a.delta[at] : 0.f;
  }

  float dq[kNO][4];
#pragma unroll
  for (int c = 0; c < kNO; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[c][e] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = k_begin + t * kBK;
    __syncthreads();   // every warp is done with the stage refilled next
    if (t + 1 < n_tiles) issue(t + 1);
    cp_async_commit();
    cp_async_wait<1>();   // Q, dO and tile t have landed
    __syncthreads();
    const bf16* ks = k_s + (t & 1) * kBK * kRow;
    const bf16* vs = v_s + (t & 1) * kBK * kRow;

    // (1) S = Q K^T and dP = dO V^T: the warp's 16 rows x kBK keys
    float s[kNS][4], dp[kNS][4];
#pragma unroll
    for (int n = 0; n < kNS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
    mma_abt<D, kBK / 16>(s, q_s + warp * 16 * kRow, ks, lane);
    mma_abt<D, kBK / 16>(dp, do_s + warp * 16 * kRow, vs, lane);

    // (2) dS in place; element e of tile n: row r_warp + gr + 8 (e >> 1),
    // key k0 + 8 n + 2 tq + (e & 1)
#pragma unroll
    for (int n = 0; n < kNS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ri = e >> 1;
        const int key = k0 + n * 8 + 2 * tq + (e & 1);
        const bool live = key >= first[ri] && key <= last[ri];
        const float p =
            live ? exp2f(fmaf(s[n][e], a.scale_log2, -lse2[ri])) : 0.f;
        dp[n][e] = p * (dp[n][e] - del[ri]) * a.scale;
      }

    // (3) dQ += dS K, dS as hi + lo straight from registers
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      uint32_t hi[4], lo[4];
      a_from_acc(dp, kk, hi, lo);
      mma_split_b<D, D>(dq, hi, lo, ks, kk, lane);
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int ri = 0; ri < 2; ++ri) {
    const int row = r_warp + gr + 8 * ri;
    if (row >= a.S) continue;
    bf16* dqp = static_cast<bf16*>(a.dq) +
                ((b * a.S + row) * a.H + h) * static_cast<long long>(D);
#pragma unroll
    for (int c = 0; c < kNO; ++c)
      *reinterpret_cast<__nv_bfloat162*>(dqp + c * 8 + 2 * tq) =
          __floats2bfloat162_rn(dq[c][2 * ri], dq[c][2 * ri + 1]);
  }
}

}  // namespace tc

// The SMs of the current device.
int sm_count() {
  int dev = 0, n = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return 132;
  return n;
}

// Groups of query heads in the bf16 dK/dV grid: 1 where B x Hkv x (key
// tiles) already gives two blocks an SM, else the fewest (a divisor of g)
// that reach it, at most g.
template <int D>
int bf16_groups(int B, int Skv, int H, int Hkv) {
  const long long blocks = static_cast<long long>(B) * Hkv *
                           ((Skv + tc::Tiles<D>::kBK - 1) / tc::Tiles<D>::kBK);
  const long long want = 2LL * sm_count();
  const int g = H / Hkv;
  if (blocks >= want) return 1;
  for (int G = 2; G < g; ++G)
    if (g % G == 0 && blocks * G >= want) return G;
  return g;
}

// The dK/dV and dQ kernels of one type at head dim D, their threads and
// their dynamic shared memory.
template <int D>
struct Kernels {
  const void *kv, *q;
  int threads;
  size_t kv_smem, q_smem;
  int bk, bq;   // keys a dK/dV block, rows a dQ block
  explicit Kernels(int is_bf16) {
    using T = tc::Tiles<D>;
    kv = is_bf16 ? reinterpret_cast<const void*>(tc::dkdv_kernel<D>)
                 : reinterpret_cast<const void*>(simt::dkdv_kernel<D>);
    q = is_bf16 ? reinterpret_cast<const void*>(tc::dq_kernel<D>)
                : reinterpret_cast<const void*>(simt::dq_kernel<D>);
    threads = is_bf16 ? tc::kThreads : simt::kThreads;
    kv_smem = is_bf16 ? T::kv_smem : simt::smem_bytes<D>();
    q_smem = is_bf16 ? T::q_smem : simt::smem_bytes<D>();
    bk = is_bf16 ? T::kBK : simt::kBK;
    bq = is_bf16 ? T::kQR : simt::kBQ;
  }
  cudaError_t set_smem() const {
    const cudaError_t err = cudaFuncSetAttribute(
        kv, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(kv_smem));
    if (err != cudaSuccess) return err;
    return cudaFuncSetAttribute(q, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                static_cast<int>(q_smem));
  }
};

// The launch shapes of one call: dK/dV blocks, its blocks an SM, its
// dynamic shared memory, groups of query heads; dQ blocks, its blocks an
// SM, its dynamic shared memory.
template <int D>
int plan(int B, int S, int Skv, int H, int Hkv, int is_bf16,
         long long* out) {
  const Kernels<D> ks(is_bf16);
  cudaError_t err = ks.set_smem();
  int kv_occ = 0, q_occ = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&kv_occ, ks.kv,
                                                        ks.threads,
                                                        ks.kv_smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&q_occ, ks.q,
                                                        ks.threads, ks.q_smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long groups = is_bf16 ? bf16_groups<D>(B, Skv, H, Hkv) : 1;
  out[0] = static_cast<long long>(B) * Hkv * groups *
           ((Skv + ks.bk - 1) / ks.bk);
  out[1] = kv_occ;
  out[2] = static_cast<long long>(ks.kv_smem);
  out[3] = groups;
  out[4] = static_cast<long long>(B) * H * ((S + ks.bq - 1) / ks.bq);
  out[5] = q_occ;
  out[6] = static_cast<long long>(ks.q_smem);
  return 0;
}

template <int D>
int launch_f32(const Args& a, cudaStream_t stream) {
  constexpr size_t smem = simt::smem_bytes<D>();
  if (a.Skv > 0) {
    const dim3 grid(static_cast<unsigned>((a.Skv + simt::kBK - 1) / simt::kBK),
                    static_cast<unsigned>(a.Hkv), static_cast<unsigned>(a.B));
    simt::dkdv_kernel<D><<<grid, simt::kThreads, smem, stream>>>(a);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(static_cast<unsigned>((a.S + simt::kBQ - 1) / simt::kBQ),
                  static_cast<unsigned>(a.H), static_cast<unsigned>(a.B));
  simt::dq_kernel<D><<<grid, simt::kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_bf16(const Args& a, cudaStream_t stream) {
  using T = tc::Tiles<D>;
  if (a.Skv > 0) {
    const dim3 grid(static_cast<unsigned>((a.Skv + T::kBK - 1) / T::kBK),
                    static_cast<unsigned>(a.Hkv * a.groups),
                    static_cast<unsigned>(a.B));
    tc::dkdv_kernel<D><<<grid, tc::kThreads, T::kv_smem, stream>>>(a);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    if (a.groups > 1) {
      const long long n_out = static_cast<long long>(a.B) * a.Skv * a.Hkv * D;
      tc::sum_groups_kernel<<<static_cast<unsigned>((n_out / 4 + 255) / 256),
                              256, 0, stream>>>(
          a.part, static_cast<bf16*>(a.dk), static_cast<bf16*>(a.dv), n_out,
          a.groups);
      err = cudaGetLastError();
      if (err != cudaSuccess) return static_cast<int>(err);
    }
  }
  const dim3 grid(static_cast<unsigned>((a.S + T::kQR - 1) / T::kQR),
                  static_cast<unsigned>(a.H), static_cast<unsigned>(a.B));
  tc::dq_kernel<D><<<grid, tc::kThreads, T::q_smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch(const Args& a, int is_bf16, cudaStream_t stream) {
  int err = static_cast<int>(Kernels<D>(is_bf16).set_smem());
  if (err != 0) return err;
  const long long rows = static_cast<long long>(a.B) * a.S * a.H;
  const unsigned blocks = static_cast<unsigned>((rows + 7) / 8);
  if (is_bf16)
    delta_kernel<bf16><<<blocks, 256, 0, stream>>>(a, D);
  else
    delta_kernel<float><<<blocks, 256, 0, stream>>>(a, D);
  err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  return is_bf16 ? launch_bf16<D>(a, stream) : launch_f32<D>(a, stream);
}

}  // namespace

// The launch shapes of a call (see plan): out[7] = dK/dV blocks, blocks an
// SM, dynamic shared memory; groups of query heads; dQ blocks, blocks an
// SM, dynamic shared memory. Returns a CUDA error (cudaErrorInvalidValue
// for a d without an instantiation).
extern "C" int repro_flash_attention_bwd_plan(int B, int S, int Skv, int H,
                                              int Hkv, int d, int is_bf16,
                                              long long* out) {
  if (Hkv <= 0 || H % Hkv) return static_cast<int>(cudaErrorInvalidValue);
  switch (d) {
    case 16: return plan<16>(B, S, Skv, H, Hkv, is_bf16, out);
    case 32: return plan<32>(B, S, Skv, H, Hkv, is_bf16, out);
    case 64: return plan<64>(B, S, Skv, H, Hkv, is_bf16, out);
    case 128: return plan<128>(B, S, Skv, H, Hkv, is_bf16, out);
    case 256: return plan<256>(B, S, Skv, H, Hkv, is_bf16, out);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Groups of query heads the bf16 dK/dV grid splits each kv head into
// (plan's out[3]; 1 for f32, and for a d without an instantiation).
extern "C" int repro_flash_attention_bwd_groups(int B, int Skv, int H,
                                                int Hkv, int d, int is_bf16) {
  if (!is_bf16 || Hkv <= 0 || H % Hkv) return 1;
  switch (d) {
    case 16: return bf16_groups<16>(B, Skv, H, Hkv);
    case 32: return bf16_groups<32>(B, Skv, H, Hkv);
    case 64: return bf16_groups<64>(B, Skv, H, Hkv);
    case 128: return bf16_groups<128>(B, Skv, H, Hkv);
    case 256: return bf16_groups<256>(B, Skv, H, Hkv);
    default: return 1;
  }
}

// is_bf16 != 0: q, k, v, o, dout, dq, dk and dv are __nv_bfloat16 (the
// tensor-core kernels: q, k, v and dout 16-byte aligned with batch, seq
// and head strides that are multiples of 8), else float. lse (B, H, S)
// f32; delta (B, H, S) f32 scratch; part: with groups > 1, (2, groups, B,
// Skv, Hkv, d) f32 scratch, where groups is
// repro_flash_attention_bwd_groups of the same shapes (1 for f32). strides: 15 element strides, (batch, seq, head) of q, k, v, o and
// dout in that order; d has stride 1. dq is written contiguous (B, S, H,
// d), dk and dv (B, Skv, Hkv, d). d in {16, 32, 64, 128, 256}; H % Hkv ==
// 0; groups divides H / Hkv.
extern "C" int repro_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* delta, void* part, void* dq,
    void* dk, void* dv, int B, int S, int Skv, int H, int Hkv, int d,
    const long long* strides, int causal, int window, int is_bf16,
    int groups, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0) return static_cast<int>(cudaGetLastError());
  if (Hkv <= 0 || H % Hkv || groups <= 0 || (H / Hkv) % groups ||
      (groups > 1 && (part == nullptr || !is_bf16)))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.q = q; a.k = k; a.v = v; a.o = o; a.dout = dout;
  a.lse = static_cast<const float*>(lse);
  a.delta = static_cast<float*>(delta);
  a.part = static_cast<float*>(part);
  a.dq = dq; a.dk = dk; a.dv = dv;
  a.B = B; a.S = S; a.Skv = Skv; a.H = H; a.Hkv = Hkv;
  a.groups = groups;
  Strides* st[5] = {&a.sq, &a.sk, &a.sv, &a.so, &a.sdo};
  for (int i = 0; i < 5; ++i)
    *st[i] = Strides{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  a.causal = causal;
  a.window = window;
  const double scale = 1.0 / sqrt(static_cast<double>(d));
  a.scale = static_cast<float>(scale);
  a.scale_log2 = static_cast<float>(scale * 1.4426950408889634);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 16: return launch<16>(a, is_bf16, s);
    case 32: return launch<32>(a, is_bf16, s);
    case 64: return launch<64>(a, is_bf16, s);
    case 128: return launch<128>(a, is_bf16, s);
    case 256: return launch<256>(a, is_bf16, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

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
// gives 0 (l = 0), as the model's flash forward does. Given an `lse`
// pointer, each row's log-sum-exp of its live scores, m + log(l), is also
// written to lse (B, H, S) f32 (+inf for a row with no live key): the
// statistic the backward (flash_attention_bwd.cu) recomputes the
// probabilities from. It comes from the running max and sum each row
// already keeps, so asking for it adds one store a row.
//
// Bound: operations at the prefill shapes (4 d flops per live (q, k) pair
// and head against 2 d bytes of K and V per key, reused by 64 query rows
// and all heads), so the products belong on the tensor cores.
//
// The Pallas grid (B, H, nq, nk) walked the kv tiles minor-most with the
// running (acc, m, l) in VMEM scratch and skipped tiles outside
// [q_lo - window, q_hi] under pl.when. Here one block takes one (batch
// row, query head, tile of 64 query rows) and loops over the kv tiles
// between the window's lower bound of its first row and the causal
// frontier of its last row only: skipped tiles cost nothing, which is what
// chunked_flash's causal-skip split relies on. Two kernels, one for each
// type the wrapper takes:
//
// bfloat16 (flash_attention_bf16): FlashAttention-2's register flow on the
// tensor cores. Four warps, each owning 16 query rows. Q (64 rows) and a
// ring of two stages of K and V tiles (64 keys; 32 at d = 256) sit in
// shared memory, filled by 16-byte cp.async copies: the next tile's copies
// are in flight while this tile's products run. Rows are padded by 16
// bytes, so the eight row addresses of an ldmatrix fall in eight distinct
// bank groups. S = Q K^T is mma.sync m16n8k16 (bf16 in, f32 out) on
// fragments loaded by ldmatrix; Q's fragments are re-read from shared
// memory at each k-step rather than held, which leaves the registers to
// the accumulator (d / 2 floats a thread, 128 at d = 256). The scores stay
// in f32 registers; the row max and sum are reduced over the quad of lanes
// that shares a row; p goes straight from registers into the A operand of
// O += P V (V's fragments by ldmatrix.trans), as a bf16 part and the bf16
// part of its rounding error, two products: one bf16 p moves each term by
// up to 2**-9 of itself, which exceeds one output step where a few keys
// carry a row. Tiles wholly live for a warp's 16 rows skip the mask. At
// the end O is scaled by 1 / l (0 where l = 0). At d = 256 the 101 KB of
// shared memory let two blocks share an SM; in the timings that chose the
// design that beat eight warps of 128 rows and 64-key tiles (which spill).
//
// float32 (flash_attention_f32): the scalar kernel of the first port, kept
// for the f32 path (the reduced models' CPU == GPU checks hold it to 2e-5;
// TF32 tensor cores would not): 256 threads; per kv tile of 32 keys the K
// and V tiles are staged in shared memory (f32); (1) each thread computes
// a 4 x 2 block of scores, reading float4 runs of its Q and K rows (rows
// padded by 4 floats, so a quarter warp hits 32 distinct banks); (2) each
// row's tile max and sum are reduced over the 16 threads that share the
// row with shuffles, and the probabilities go to shared memory; (3) each
// thread adds p @ V into its 4 rows x d/16 columns of the accumulator,
// which stays in registers.
#include <cmath>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

// ---------------------------------------------------------------------------
// float32: scalar FMAs on the CUDA cores
// ---------------------------------------------------------------------------
namespace simt {

constexpr int kThreads = 256;
constexpr int kBQ = 64;          // query rows a block
constexpr int kBK = 32;          // keys a tile
constexpr int kRows = 4;         // query rows a thread (16 row groups)
constexpr int kNJ = kBK / 16;    // score columns a thread
constexpr int kPad = 4;          // floats of padding per Q / K row
constexpr int kPStride = kBK + 1;

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

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_attention_f32(const float* __restrict__ q,
                    const float* __restrict__ k,
                    const float* __restrict__ v, float* __restrict__ o,
                    float* __restrict__ lse, int S,
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

  const float* qb = q + b * qsb + static_cast<long long>(h) * qsh;
  const float* kb = k + b * ksb + static_cast<long long>(kvh) * ksh;
  const float* vb = v + b * vsb + static_cast<long long>(kvh) * vsh;
  for (int e = tid; e < kBQ * D; e += kThreads) {
    const int r = e / D, x = e % D;
    q_s[r * kQK + x] =
        q0 + r < S ? qb[static_cast<long long>(q0 + r) * qss + x]
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
      k_s[r * kQK + x] = r < nt ? kb[j * kss + x] : 0.f;
      v_s[r * D + x] = r < nt ? vb[j * vss + x] : 0.f;
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
    float* orow = o + ((b * S + row) * H + h) * static_cast<long long>(D);
#pragma unroll
    for (int c = 0; c < kNC; ++c) orow[tx + 16 * c] = acc[i][c] * inv_l;
    if (lse != nullptr && tx == 0)
      lse[(b * H + h) * S + row] = l[i] > 0.f ? m[i] + logf(l[i]) : INFINITY;
  }
}

}  // namespace simt

// ---------------------------------------------------------------------------
// bfloat16: mma.sync on the tensor cores, cp.async ring
// ---------------------------------------------------------------------------
namespace tc {

using bf16 = __nv_bfloat16;
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kBQ = 16 * kWarps;   // query rows a block, 16 a warp
constexpr int kStages = 2;         // K / V tiles in flight

// keys a kv tile: 32 at d = 256, where the accumulator takes 128 registers
// a thread and 64-key tiles spill; two blocks then share an SM
template <int D>
constexpr int kTileKeys = D == 256 ? 32 : 64;

template <int D>
constexpr size_t smem_bytes() {   // Q, then K and V rings; rows of D + 8
  return sizeof(bf16) *
         static_cast<size_t>(kBQ + 2 * kStages * kTileKeys<D>) * (D + 8);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; zeros where !full
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(full ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t& r0,
                                        uint32_t& r1, uint32_t& r2,
                                        uint32_t& r3) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
      : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t addr, uint32_t& r0,
                                              uint32_t& r1, uint32_t& r2,
                                              uint32_t& r3) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
      : "r"(addr));
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

// the live keys of query row `row`: first <= j <= last (last = -1: none)
__device__ __forceinline__ void live_keys(int row, int S, int Skv, int shift,
                                          int causal, int window, int* first,
                                          int* last) {
  const int pos = row + shift;
  *first = window > 0 ? pos - window + 1 : 0;
  *last = row >= S ? -1 : (causal ? pos : Skv - 1);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_attention_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, bf16* __restrict__ o,
                     float* __restrict__ lse, int S,
                     int Skv, int H, int Hkv, long long qsb, long long qss,
                     long long qsh, long long ksb, long long kss,
                     long long ksh, long long vsb, long long vss,
                     long long vsh, int causal, int window,
                     float scale_log2) {
  constexpr int kBK = kTileKeys<D>;
  constexpr int kRow = D + 8;       // padded shared-memory row, elements
  constexpr int kChunks = D / 8;    // 16-byte copies a row
  constexpr int kNO = D / 8;        // accumulator tiles of 8 columns
  constexpr int kNS = kBK / 8;      // score tiles of 8 keys
  extern __shared__ float4 smem4[];
  bf16* q_s = reinterpret_cast<bf16*>(smem4);   // (kBQ, kRow)
  bf16* k_s = q_s + kBQ * kRow;                 // (kStages, kBK, kRow)
  bf16* v_s = k_s + kStages * kBK * kRow;       // (kStages, kBK, kRow)

  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const long long b = blockIdx.z;
  const int kvh = h / (H / Hkv);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int shift = Skv - S;       // query row i sits at position i + shift
  const bf16* qb = q + b * qsb + static_cast<long long>(h) * qsh;
  const bf16* kb = k + b * ksb + static_cast<long long>(kvh) * ksh;
  const bf16* vb = v + b * vsb + static_cast<long long>(kvh) * vsh;

  // live keys of this block: from the window's lower bound of its first
  // row to the causal frontier of its last row
  const int q_last = (q0 + kBQ < S ? q0 + kBQ : S) - 1;
  int k_begin = 0, k_end = Skv;
  if (window > 0) k_begin = max(0, q0 + shift - window + 1);
  if (causal) k_end = min(Skv, q_last + shift + 1);
  const int n_tiles = k_end > k_begin ? (k_end - k_begin + kBK - 1) / kBK : 0;

  for (int e = tid; e < kBQ * kChunks; e += kThreads) {
    const int r = e / kChunks, c = e % kChunks;
    const bool in = q0 + r < S;
    cp_async16(smem_addr(q_s + r * kRow + c * 8),
               qb + (in ? static_cast<long long>(q0 + r) * qss : 0) + c * 8,
               in);
  }
  auto load_tile = [&](int stage, int k0) {
    bf16* ks = k_s + stage * kBK * kRow;
    bf16* vs = v_s + stage * kBK * kRow;
    for (int e = tid; e < kBK * kChunks; e += kThreads) {
      const int r = e / kChunks, c = e % kChunks;
      const bool in = k0 + r < k_end;
      const long long j = in ? k0 + r : 0;
      cp_async16(smem_addr(ks + r * kRow + c * 8), kb + j * kss + c * 8, in);
      cp_async16(smem_addr(vs + r * kRow + c * 8), vb + j * vss + c * 8, in);
    }
  };
  if (n_tiles > 0) load_tile(0, k_begin);
  cp_async_commit();

  // this thread's rows of the warp's 16: gr and gr + 8; its columns of a
  // tile of 8: 2 tq and 2 tq + 1
  const int gr = lane >> 2, tq = lane & 3;
  const int r_warp = q0 + warp * 16;
  int first[2], last[2];
  live_keys(r_warp + gr, S, Skv, shift, causal, window, &first[0], &last[0]);
  live_keys(r_warp + gr + 8, S, Skv, shift, causal, window, &first[1],
            &last[1]);
  // the warp's rows are all live on keys [first of its last row, last of
  // its first row]
  int warp_first, warp_last, unused;
  live_keys(r_warp + 15, S, Skv, shift, causal, window, &warp_first, &unused);
  live_keys(r_warp, S, Skv, shift, causal, window, &unused, &warp_last);
  if (r_warp + 15 >= S) warp_last = -1;

  float acc[kNO][4];
#pragma unroll
  for (int c = 0; c < kNO; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[c][e] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = k_begin + t * kBK;
    __syncthreads();   // every warp is done with the stage refilled next
    if (t + 1 < n_tiles) load_tile((t + 1) & 1, k0 + kBK);
    cp_async_commit();
    cp_async_wait<1>();   // Q and tile t have landed
    __syncthreads();
    const bf16* ks = k_s + (t & 1) * kBK * kRow;
    const bf16* vs = v_s + (t & 1) * kBK * kRow;

    // (1) scores S = Q K^T of the warp's 16 rows and the tile's keys
    float s[kNS][4];
#pragma unroll
    for (int n = 0; n < kNS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t a[4];
      ldsm_x4(smem_addr(q_s + (warp * 16 + (lane & 15)) * kRow + kk * 16 +
                        (lane >> 4) * 8),
              a[0], a[1], a[2], a[3]);
#pragma unroll
      for (int np = 0; np < kBK / 16; ++np) {
        uint32_t b0, b1, b2, b3;
        ldsm_x4(smem_addr(ks + (np * 16 + (lane & 7) + ((lane >> 4) << 3)) *
                                   kRow +
                          kk * 16 + ((lane >> 3) & 1) * 8),
                b0, b1, b2, b3);
        mma(s[2 * np], a, b0, b1);
        mma(s[2 * np + 1], a, b2, b3);
      }
    }

    // (2) mask (unless the tile is wholly live for the warp), online
    // softmax in base 2 over each row, reduced over the row's quad
    const bool whole = k0 >= warp_first && k0 + kBK - 1 <= warp_last;
#pragma unroll
    for (int n = 0; n < kNS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = k0 + n * 8 + 2 * tq + (e & 1);
        const int ri = e >> 1;
        const bool live = whole || (j >= first[ri] && j <= last[ri]);
        s[n][e] = live ? s[n][e] * scale_log2 : -INFINITY;
      }
#pragma unroll
    for (int ri = 0; ri < 2; ++ri) {
      float mx = -INFINITY;
#pragma unroll
      for (int n = 0; n < kNS; ++n)
        mx = fmaxf(mx, fmaxf(s[n][2 * ri], s[n][2 * ri + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_run[ri], mx);
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      const float alpha = exp2f(m_run[ri] - m_use);
      m_run[ri] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int n = 0; n < kNS; ++n)
#pragma unroll
        for (int e = 2 * ri; e < 2 * ri + 2; ++e) {
          s[n][e] = exp2f(s[n][e] - m_use);
          sum += s[n][e];
        }
      l_run[ri] = l_run[ri] * alpha + sum;   // this lane's share of the row
#pragma unroll
      for (int c = 0; c < kNO; ++c) {
        acc[c][2 * ri] *= alpha;
        acc[c][2 * ri + 1] *= alpha;
      }
    }

    // (3) O += P V: p as the A operand straight from registers, in two
    // bf16 parts (a single bf16 p would move each term by up to 2**-9 of
    // itself, more than one output step where a few keys dominate a row)
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      uint32_t hi[4], lo[4];
      split_bf16(s[2 * kk][0], s[2 * kk][1], &hi[0], &lo[0]);
      split_bf16(s[2 * kk][2], s[2 * kk][3], &hi[1], &lo[1]);
      split_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1], &hi[2], &lo[2]);
      split_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3], &hi[3], &lo[3]);
#pragma unroll
      for (int np = 0; np < D / 16; ++np) {
        uint32_t b0, b1, b2, b3;
        ldsm_x4_trans(
            smem_addr(vs + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) *
                               kRow +
                      np * 16 + (lane >> 4) * 8),
            b0, b1, b2, b3);
        mma(acc[2 * np], hi, b0, b1);
        mma(acc[2 * np], lo, b0, b1);
        mma(acc[2 * np + 1], hi, b2, b3);
        mma(acc[2 * np + 1], lo, b2, b3);
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int ri = 0; ri < 2; ++ri) {
    float l = l_run[ri];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const float inv_l = l > 0.f ? 1.f / l : 0.f;
    const int row = r_warp + gr + 8 * ri;
    if (row < S) {
      bf16* orow = o + ((b * S + row) * H + h) * static_cast<long long>(D);
#pragma unroll
      for (int c = 0; c < kNO; ++c)
        *reinterpret_cast<__nv_bfloat162*>(orow + c * 8 + 2 * tq) =
            __floats2bfloat162_rn(acc[c][2 * ri] * inv_l,
                                  acc[c][2 * ri + 1] * inv_l);
      // m_run is in base-2 units (scores times log2(e))
      if (lse != nullptr && tq == 0)
        lse[(b * H + h) * S + row] =
            l > 0.f ? (m_run[ri] + log2f(l)) * 0.6931471805599453f
                    : INFINITY;
    }
  }
}

}  // namespace tc

// strides: q (batch, seq, head), k (batch, seq, head), v (batch, seq, head)
template <int D>
int launch_f32(const void* q, const void* k, const void* v, void* o,
               float* lse, int B, int S, int Skv, int H, int Hkv,
               const long long* st, int causal, int window,
               cudaStream_t stream) {
  constexpr size_t smem = simt::smem_bytes<D>();
  auto kernel = simt::flash_attention_f32<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>((S + simt::kBQ - 1) / simt::kBQ),
                  static_cast<unsigned>(H), static_cast<unsigned>(B));
  kernel<<<grid, simt::kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), lse, S, Skv, H,
      Hkv, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8],
      causal, window, static_cast<float>(1.0 / sqrt(static_cast<double>(D))));
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_bf16(const void* q, const void* k, const void* v, void* o,
                float* lse, int B, int S, int Skv, int H, int Hkv,
                const long long* st, int causal, int window,
                cudaStream_t stream) {
  constexpr size_t smem = tc::smem_bytes<D>();
  auto kernel = tc::flash_attention_bf16<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>((S + tc::kBQ - 1) / tc::kBQ),
                  static_cast<unsigned>(H), static_cast<unsigned>(B));
  kernel<<<grid, tc::kThreads, smem, stream>>>(
      static_cast<const tc::bf16*>(q), static_cast<const tc::bf16*>(k),
      static_cast<const tc::bf16*>(v), static_cast<tc::bf16*>(o), lse, S, Skv,
      H, Hkv, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8],
      causal, window,
      static_cast<float>(1.4426950408889634 / sqrt(static_cast<double>(D))));
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int B, int S, int Skv, int H, int Hkv, const long long* st,
           int causal, int window, int bf16, cudaStream_t stream) {
  return bf16 ? launch_bf16<D>(q, k, v, o, lse, B, S, Skv, H, Hkv, st,
                               causal, window, stream)
              : launch_f32<D>(q, k, v, o, lse, B, S, Skv, H, Hkv, st, causal,
                              window, stream);
}

}  // namespace

// lse: null, or (B, H, S) f32 for each row's log-sum-exp.
// bf16 != 0: q, k, v and o are __nv_bfloat16 (the tensor-core kernel;
// q, k and v 16-byte aligned with strides that are multiples of 8), else
// float. Strides in elements: q (batch, seq, head), k (batch, seq, head),
// v (batch, seq, head); d has stride 1. d in {16, 32, 64, 128, 256};
// H % Hkv == 0.
extern "C" int repro_flash_attention(
    const void* q, const void* k, const void* v, void* o, void* lse, int B,
    int S, int Skv, int H, int Hkv, int d, long long qsb, long long qss,
    long long qsh, long long ksb, long long kss, long long ksh,
    long long vsb, long long vss, long long vsh, int causal, int window,
    int bf16, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0) return static_cast<int>(cudaGetLastError());
  const long long st[9] = {qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* lsef = static_cast<float*>(lse);
  switch (d) {
    case 16:
      return launch<16>(q, k, v, o, lsef, B, S, Skv, H, Hkv, st, causal,
                         window, bf16, s);
    case 32:
      return launch<32>(q, k, v, o, lsef, B, S, Skv, H, Hkv, st, causal,
                         window, bf16, s);
    case 64:
      return launch<64>(q, k, v, o, lsef, B, S, Skv, H, Hkv, st, causal,
                         window, bf16, s);
    case 128:
      return launch<128>(q, k, v, o, lsef, B, S, Skv, H, Hkv, st, causal,
                         window, bf16, s);
    case 256:
      return launch<256>(q, k, v, o, lsef, B, S, Skv, H, Hkv, st, causal,
                         window, bf16, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

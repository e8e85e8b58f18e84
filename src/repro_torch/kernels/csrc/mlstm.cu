// mlstm.cu — the xLSTM mLSTM cell on Hopper: the chunkwise forward over a
// sequence (kernel B12, mlstm_chunkwise) and one decode step (kernel B13,
// mlstm_step).
//
// Neither replaces a Pallas kernel: the JAX package computes both in jnp
// (repro/models/lm.py _mlstm_chunkwise, :755-808, and the `step` of
// mlstm_block, :830-843) and leaves them to XLA. They were added because
// as eager PyTorch the chunk loop and the step would be some 25 launches a
// chunk or a step (about 270 k launches a prefill of xlstm-1.3b). The
// contracts are those of repro_torch/kernels/ref.py mlstm_chunkwise and
// mlstm_step; all tensors are f32 and contiguous.
//
// Both sum in another order than the plain version, so they are held to
// it within ref.xlstm_tol, not bit for bit.
//
// B13, mlstm_step. q, k, v (B, H, hd), the raw gate logits i, f (B, H);
// the state C (B, H, hd, hd), n (B, H, hd), m (B, H) is updated in place:
//   m' = max(logsigmoid(f) + m, i),  ig = exp(i - m'),
//   fg = exp(logsigmoid(f) + m - m'),
//   C' = fg C + ig (k v^T),  n' = fg n + ig k,
//   h = (q . C') / max(|q . n'|, 1).
// Bound: bytes. C is read and written once, 8 hd^2 bytes a (b, h): 13.5
// ms a decode step of xlstm-1.3b's 42 mLSTM layers at batch 128 (45.1 GB).
// Design: one block per (b, h), so the block that reads n and m is the one
// that writes them (no other block reads them: in place is safe). The
// block is rounded up to whole warps (hd = 16 needs 8 threads), so that
// block_sum's full-warp shuffles name only threads that exist; the extra
// threads own no columns and add 0. Each
// thread owns four adjacent columns of C (16-byte loads and stores) over a
// range of hd / ds rows; the ds row ranges of a column are summed through
// shared memory. A thread loads 8 rows (128 bytes) before it computes on
// them and stores them back, so that 8 loads are in flight a thread
// whatever the compiler assumes of the aliasing of C's rows. n' is formed
// and q . n' reduced first; n and m are written last, after the block's
// last read of them.
//
// B12, mlstm_chunkwise. q, k, v (B, S, H, hd) (pre-scaled), i, f (B, S,
// H), the state C0, n0, m0 and a chunk length c <= 128 dividing S. Per
// chunk of (b, h), with F the in-chunk cumsum of logsigmoid(f), rel = i -
// F and M_t = max(m, cummax_{s<=t} rel_s):
//   S_ts = (q_t . k_s) exp(rel_s - M_t) for s <= t, else 0 (a select, so
//     that exp's overflow above the diagonal never reaches a product);
//   h_t = (exp(m - M_t) q_t . C + sum_s S_ts v_s)
//         / max(|exp(m - M_t) q_t . n + sum_s S_ts|, 1);
//   C' = exp(m - M_end) C + sum_s exp(rel_s - M_end) k_s v_s^T, n' likewise,
//   m' = F_end + M_end.
// Bound: f32 operations, 2 per multiply-add of q . C and the C update
// (c hd^2 each) and of the causal scores and scores . v (c (c + 1) / 2 hd
// each, the pairs s <= t only): 4 B H S hd^2 + 2 B H S (c + 1) hd, 155
// GFLOP, 2.31 ms at 67 TFLOP/s, a layer of the 1 x 32,768 prefill.
// Design: the carry (C, n, m from chunk to chunk) is split from the output,
// so that only the state walk is in order and it needs no output.
//  1. gates (mlstm_gates_kernel): one block per (b, h), a thread a chunk,
//     walks each chunk in order (the cumsum and the running max as the
//     plain version takes them), thread 0 the chunks' m in order; it writes
//     rel and M a position and m at each chunk's start. With m0 = -1e30
//     every exp(m - M) is 0, and stays finite.
//  2. intra (mlstm_intra_kernel): one block per (b, h, chunk), all chunks
//     at once (nothing here needs the carry): S (c x c, 128 x 128 in
//     shared memory, transposed) from d-tiles of q and k, each thread an
//     8 x 8 block of it; then sum_s S_ts v_s into h and sum_s S_ts into a
//     scratch row, over e-tiles of v. 2 blocks an SM.
//  3. per segment of `seg` chunks (the wrapper sizes seg so that the
//     states of a segment take at most 1 GiB: the whole 1 x 32,768 prefill
//     of xlstm-1.3b is one segment of 256 chunks), two launches:
//     (a) states (mlstm_state_kernel): one block per (64 x 128 tile of C,
//         h, b), 32 a head at hd = 512, walks the segment's chunks in
//         order, storing the state entering each chunk into scratch and
//         adding the chunk's (w k)^T v to its tile in registers, fed by a
//         4-stage cp.async ring; no block reads another's tile, so none
//         waits on another;
//     (b) output (mlstm_out_kernel): one block per (chunk, 128-column
//         e-tile, h, b), all chunks at once: exp(m - M_t) q_t . C_k and
//         q_t . n_k over d-tiles (the next loaded into registers while the
//         current one is multiplied), plus step 2's parts, over the
//         normalizer.
//     Both are register-tiled f32 on the CUDA cores (no tensor cores: TF32
//     keeps three digits, short of ref.xlstm_tol).
//  At the prefill: 4 launches, 1 GiB of states written and read once.
#include <cmath>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float log_sigmoid(float x) {
  return fminf(x, 0.f) - log1pf(expf(-fabsf(x)));
}

// Sum of one value a thread over the block; every thread gets the sum.
// blockDim.x must be a multiple of 32 (the shuffles take whole warps).
__device__ float block_sum(float x, float* red) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nwarps = (blockDim.x + 31) >> 5;
  __syncthreads();
  if (lane == 0) red[warp] = x;
  __syncthreads();
  float s = 0.f;
  for (int w = 0; w < nwarps; ++w) s += red[w];
  return s;
}

// ---------------------------------------------------------------------------
// B13: one step
// ---------------------------------------------------------------------------
constexpr int kStepRows = 8;          // rows of C in flight a thread

__global__ void mlstm_step_kernel(const float* __restrict__ q,
                                  const float* __restrict__ k,
                                  const float* __restrict__ v,
                                  const float* __restrict__ gi,
                                  const float* __restrict__ gf, float* C,
                                  float* n, float* m, float* __restrict__ h,
                                  int hd, int ds) {
  extern __shared__ float sm[];
  float* qs = sm;               // hd
  float* ks = qs + hd;          // hd
  float* ns = ks + hd;          // hd: n'
  float* part = ns + hd;        // ds x hd: partial q . C' of each row range
  __shared__ float red[32];
  const int tid = threadIdx.x, nt = blockDim.x;
  const long long bh = blockIdx.x;
  const long long base = bh * hd;
  for (int d = tid; d < hd; d += nt) {
    qs[d] = q[base + d];
    ks[d] = k[base + d];
  }
  const float i_ = gi[bh], f_ = gf[bh], m_ = m[bh];
  const float logf = log_sigmoid(f_);
  const float m_new = fmaxf(logf + m_, i_);
  const float ig = expf(i_ - m_new);
  const float fg = expf(logf + m_ - m_new);
  __syncthreads();
  float qn = 0.f;
  for (int d = tid; d < hd; d += nt) {
    const float nn = fg * n[base + d] + ig * ks[d];
    ns[d] = nn;
    qn += qs[d] * nn;
  }
  const float den = fmaxf(fabsf(block_sum(qn, red)), 1.f);
  const int quads = hd >> 2;
  const int e4 = tid % quads, range = tid / quads;
  if (range < ds) {
    const int rows = hd / ds;
    const int d_lo = range * rows;
    const float4 vv = reinterpret_cast<const float4*>(v + base)[e4];
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    float4* Cb = reinterpret_cast<float4*>(C + bh * hd * hd) + e4;
    for (int d0 = d_lo; d0 < d_lo + rows; d0 += kStepRows) {
      float4 c[kStepRows];
#pragma unroll
      for (int j = 0; j < kStepRows; ++j)
        c[j] = Cb[static_cast<long long>(d0 + j) * quads];
#pragma unroll
      for (int j = 0; j < kStepRows; ++j) {
        const float kd = ks[d0 + j], qd = qs[d0 + j];
        c[j].x = fg * c[j].x + ig * (kd * vv.x);
        c[j].y = fg * c[j].y + ig * (kd * vv.y);
        c[j].z = fg * c[j].z + ig * (kd * vv.z);
        c[j].w = fg * c[j].w + ig * (kd * vv.w);
        acc.x += qd * c[j].x;
        acc.y += qd * c[j].y;
        acc.z += qd * c[j].z;
        acc.w += qd * c[j].w;
      }
#pragma unroll
      for (int j = 0; j < kStepRows; ++j)
        Cb[static_cast<long long>(d0 + j) * quads] = c[j];
    }
    reinterpret_cast<float4*>(part + range * hd)[e4] = acc;
  }
  __syncthreads();
  for (int e = tid; e < hd; e += nt) {
    float s = 0.f;
    for (int r = 0; r < ds; ++r) s += part[r * hd + e];
    h[base + e] = s / den;
  }
  for (int d = tid; d < hd; d += nt) n[base + d] = ns[d];
  if (tid == 0) m[bh] = m_new;
}

// ---------------------------------------------------------------------------
// B12: the chunkwise forward
// ---------------------------------------------------------------------------
constexpr int kMaxChunk = 128;
constexpr int kThreads = 256;         // intra, state and output blocks
constexpr int kDTile = 32;            // d-tile of q and k
constexpr int kETile = 64;            // e-tile of v (intra)
constexpr int kStride = kMaxChunk + 4;  // row stride of the transposed S

// Scratch layout (floats): rel, M and qn_intra (B, H, S) each, then m at
// each chunk's start and after the last (B, H, nc + 1).
struct Work {
  float* rel;
  float* Mx;
  float* qni;
  float* mk;
};

// One block per (b, h); thread x takes chunks x, x + blockDim, ... Pass 1:
// each chunk's cumsum F_end and max of rel (parked in mk[ch] and Mx[ch
// c]); thread 0 then walks the chunks' m in order; pass 2: each chunk's
// rel and M from its m (the same sums in the same order as pass 1).
__global__ void mlstm_gates_kernel(const float* __restrict__ gi,
                                   const float* __restrict__ gf,
                                   const float* __restrict__ m0,
                                   float* __restrict__ m_out,
                                   float* __restrict__ rel_out,
                                   float* __restrict__ M_out,
                                   float* __restrict__ mk_out, int H,
                                   long long S, int c) {
  const long long bh = blockIdx.x;
  const int tid = threadIdx.x, nt = blockDim.x;
  const long long b = bh / H, hh = bh % H;
  const long long nc = S / c;
  const float* ib = gi + b * S * H + hh;
  const float* fb = gf + b * S * H + hh;
  float* rel = rel_out + bh * S;
  float* Mx = M_out + bh * S;
  float* mk = mk_out + bh * (nc + 1);
  for (long long ch = tid; ch < nc; ch += nt) {
    float F = 0.f, cm = -INFINITY;
    for (int t = 0; t < c; ++t) {
      const long long s = ch * c + t;
      F += log_sigmoid(fb[s * H]);
      cm = fmaxf(cm, ib[s * H] - F);
    }
    mk[ch] = F;
    Mx[ch * c] = cm;
  }
  __syncthreads();
  if (tid == 0) {
    float m = m0[bh];
    for (long long ch = 0; ch < nc; ++ch) {
      const float F_end = mk[ch], R = Mx[ch * c];
      mk[ch] = m;
      m = F_end + fmaxf(m, R);
    }
    mk[nc] = m;
    m_out[bh] = m;
  }
  __syncthreads();
  for (long long ch = tid; ch < nc; ch += nt) {
    const float m = mk[ch];
    float F = 0.f, cm = -INFINITY;
    for (int t = 0; t < c; ++t) {
      const long long s = ch * c + t;
      F += log_sigmoid(fb[s * H]);
      const float r = ib[s * H] - F;
      cm = fmaxf(cm, r);
      rel[s] = r;
      Mx[s] = fmaxf(m, cm);
    }
  }
}

// One block per (chunk, h, b). Shared memory: St (c x kStride, S
// transposed: St[s][t]), the q and k d-tiles (kDTile x kMaxChunk each,
// transposed: [d][t]) or the v e-tile (kMaxChunk x kETile), rel and M.
__global__ void __launch_bounds__(kThreads, 2)
mlstm_intra_kernel(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v, float* __restrict__ h, Work w,
                   long long S, int H, int hd, int c) {
  extern __shared__ float sm[];
  float* St = sm;                                   // kMaxChunk x kStride
  float* tile = St + kMaxChunk * kStride;           // 2 x kDTile x kMaxChunk
  float* qs = tile;
  float* ks = tile + kDTile * kMaxChunk;
  float* vs = tile;                                 // kMaxChunk x kETile
  float* rel = tile + 2 * kDTile * kMaxChunk;       // kMaxChunk
  float* Mx = rel + kMaxChunk;                      // kMaxChunk
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const long long ch = blockIdx.x, hh = blockIdx.y, b = blockIdx.z;
  const long long bh = b * H + hh;
  const long long lo = ch * c;
  const long long row_stride = static_cast<long long>(H) * hd;
  const float* qb = q + (b * S + lo) * row_stride + hh * hd;
  const float* kb = k + (b * S + lo) * row_stride + hh * hd;
  const float* vb = v + (b * S + lo) * row_stride + hh * hd;
  float* hb = h + (b * S + lo) * row_stride + hh * hd;
  for (int t = tid; t < kMaxChunk; t += kThreads) {
    rel[t] = t < c ? w.rel[bh * S + lo + t] : 0.f;
    Mx[t] = t < c ? w.Mx[bh * S + lo + t] : 0.f;
  }
  // S = q k^T: thread (tx, ty) holds rows t = ty * 8 + i, columns
  // s = tx + 16 j.
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  for (int d0 = 0; d0 < hd; d0 += kDTile) {
    __syncthreads();
    for (int x = tid; x < kMaxChunk * kDTile; x += kThreads) {
      const int t = x % kMaxChunk, d = x / kMaxChunk;
      const bool in = t < c && d0 + d < hd;
      qs[d * kMaxChunk + t] = in ? qb[t * row_stride + d0 + d] : 0.f;
      ks[d * kMaxChunk + t] = in ? kb[t * row_stride + d0 + d] : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int d = 0; d < kDTile; ++d) {
      const float4 qa = reinterpret_cast<const float4*>(
          qs + d * kMaxChunk + ty * 8)[0];
      const float4 qc = reinterpret_cast<const float4*>(
          qs + d * kMaxChunk + ty * 8)[1];
      const float qv[8] = {qa.x, qa.y, qa.z, qa.w, qc.x, qc.y, qc.z, qc.w};
      float kv[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) kv[j] = ks[d * kMaxChunk + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] += qv[i] * kv[j];
    }
  }
  // decay and the causal select; St[s][t]
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int s = tx + 16 * j;
    float out[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int t = ty * 8 + i;
      out[i] = (s <= t && t < c) ? acc[i][j] * expf(rel[s] - Mx[t]) : 0.f;
    }
    float4* dst = reinterpret_cast<float4*>(St + s * kStride + ty * 8);
    dst[0] = make_float4(out[0], out[1], out[2], out[3]);
    dst[1] = make_float4(out[4], out[5], out[6], out[7]);
  }
  __syncthreads();
  if (tid < c) {
    float sum = 0.f;
    for (int s = 0; s < c; ++s) sum += St[s * kStride + tid];
    w.qni[bh * S + lo + tid] = sum;
  }
  // h_intra = S v over e-tiles: thread (tx, ty) holds rows t = ty * 8 + i,
  // columns e0 + tx * 4 + [0, 4).
  for (int e0 = 0; e0 < hd; e0 += kETile) {
    __syncthreads();
    for (int x = tid; x < kMaxChunk * (kETile / 4); x += kThreads) {
      const int s = x / (kETile / 4), e4 = x % (kETile / 4);
      const int e = e0 + e4 * 4;
      float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
      if (s < c && e < hd)
        val = *reinterpret_cast<const float4*>(vb + s * row_stride + e);
      reinterpret_cast<float4*>(vs + s * kETile)[e4] = val;
    }
    __syncthreads();
    float o[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) o[i][j] = 0.f;
#pragma unroll 4
    for (int s = 0; s < c; ++s) {
      const float4 sa = reinterpret_cast<const float4*>(
          St + s * kStride + ty * 8)[0];
      const float4 sc = reinterpret_cast<const float4*>(
          St + s * kStride + ty * 8)[1];
      const float sv[8] = {sa.x, sa.y, sa.z, sa.w, sc.x, sc.y, sc.z, sc.w};
      const float4 vv = reinterpret_cast<const float4*>(vs + s * kETile)[tx];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        o[i][0] += sv[i] * vv.x;
        o[i][1] += sv[i] * vv.y;
        o[i][2] += sv[i] * vv.z;
        o[i][3] += sv[i] * vv.w;
      }
    }
    const int e = e0 + tx * 4;
    if (e < hd) {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int t = ty * 8 + i;
        if (t < c)
          *reinterpret_cast<float4*>(hb + t * row_stride + e) =
              make_float4(o[i][0], o[i][1], o[i][2], o[i][3]);
      }
    }
  }
}

// P adjacent floats, as float4 where P is 4 (the address then 16-byte
// aligned).
template <int P>
__device__ __forceinline__ void load_row(float* dst, const float* src) {
  if constexpr (P == 4) {
    const float4 x = *reinterpret_cast<const float4*>(src);
    dst[0] = x.x; dst[1] = x.y; dst[2] = x.z; dst[3] = x.w;
  } else {
#pragma unroll
    for (int j = 0; j < P; ++j) dst[j] = src[j];
  }
}

template <int P>
__device__ __forceinline__ void store_row(float* dst, const float* src) {
  if constexpr (P == 4) {
    *reinterpret_cast<float4*>(dst) = make_float4(src[0], src[1], src[2],
                                                  src[3]);
  } else {
#pragma unroll
    for (int j = 0; j < P; ++j) dst[j] = src[j];
  }
}

// Thread tx's PE columns of an e-tile of 16 PE: PE < 4 adjacent ones at tx
// PE; else groups of 4 at tx * 4 + 64 g, so that 16 threads read 256
// contiguous bytes a float4.
template <int PE>
__device__ __forceinline__ void load_cols(float* dst, const float* row,
                                          int tx) {
  if constexpr (PE >= 4) {
#pragma unroll
    for (int g = 0; g < PE / 4; ++g)
      load_row<4>(dst + 4 * g, row + 64 * g + tx * 4);
  } else {
    load_row<PE>(dst, row + tx * PE);
  }
}

template <int PE>
__device__ __forceinline__ void store_cols(float* row, const float* src,
                                           int tx) {
  if constexpr (PE >= 4) {
#pragma unroll
    for (int g = 0; g < PE / 4; ++g)
      store_row<4>(row + 64 * g + tx * 4, src + 4 * g);
  } else {
    store_row<PE>(row + tx * PE, src);
  }
}

// Pass (a), the boundary states: one block per (d-tile x e-tile of C, h,
// b) walks the chunks of a segment in order and keeps its tile of C (and,
// for the e-tile 0 blocks, its rows of n) in registers. At each chunk's
// start it stores the tile into the scratch `states` (the state entering
// the chunk), then adds sum_s (w_s k_s[d-tile])^T v_s[e-tile] over the
// chunk's positions in s-blocks of kSBlock, and scales by the decay:
// C <- exp(m - M_end) C + sum, n likewise. A tile needs only its own
// columns of k and v: no block waits on another. The s-blocks stream
// through a ring of kStages stages of shared memory filled by cp.async
// (k, v, rel and M_end of an s-block a stage), kStages - 1 s-blocks ahead
// of the products, so that a copy's latency hides behind several s-blocks
// of products. Tiles are 64 x 128 (32 blocks a head at hd = 512); thread
// (tx, ty) holds rows ty PD + [0, PD) and the PE columns load_cols gives
// tx (PD = d-tile / 16, PE = e-tile / 16). States: (B, H, seg, hd, hd),
// n's (B, H, seg, hd), f32.
constexpr int kSBlock = 32;           // positions an s-block (pass a)
constexpr int kStages = 4;            // the ring's stages (pass a)

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes from src to shared dst, or 16 zero bytes (src not read)
__device__ __forceinline__ void copy16(float* dst, const float* src,
                                       bool live) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(live ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void copy4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

template <int HD>
struct StateTile {
  static constexpr int kTD = HD < 64 ? HD : 64;     // d-tile
  static constexpr int kTE = HD < 128 ? HD : 128;   // e-tile
  // a stage: k (kSBlock x kTD), v (kSBlock x kTE), rel (kSBlock), M_end
  static constexpr int kStage = kSBlock * (kTD + kTE) + kSBlock + 4;
  static constexpr size_t kSmem = sizeof(float) * kStages * kStage;
};

template <int HD>
__global__ void __launch_bounds__(kThreads)
mlstm_state_kernel(const float* __restrict__ k, const float* __restrict__ v,
                   const float* C_in, const float* n_in, float* C_out,
                   float* n_out, float* __restrict__ states,
                   float* __restrict__ nstates, Work w, long long S, int H,
                   int c, long long k0, int nk, int seg) {
  using T = StateTile<HD>;
  constexpr int kTD = T::kTD, kTE = T::kTE;
  constexpr int PD = kTD / 16, PE = kTE / 16;
  constexpr int kKQuads = kSBlock * kTD / 4;     // float4 of an s-block
  constexpr int kVQuads = kSBlock * kTE / 4;
  constexpr int nE = HD / kTE;
  extern __shared__ __align__(16) float ring[];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int dt = blockIdx.x / nE, et = blockIdx.x % nE;
  const int d0 = dt * kTD, e0 = et * kTE;
  const long long hh = blockIdx.y, b = blockIdx.z;
  const long long bh = b * H + hh;
  const long long row_stride = static_cast<long long>(H) * HD;
  const bool n_thread = et == 0 && tid < kTD;
  const long long cbase = bh * HD * HD;
  float cr[PD][PE];
#pragma unroll
  for (int i = 0; i < PD; ++i)
    load_cols<PE>(cr[i], C_in + cbase +
                             static_cast<long long>(d0 + ty * PD + i) * HD + e0,
                  tx);
  float nr = n_thread ? n_in[bh * HD + d0 + tid] : 0.f;
  const int nsb = (c + kSBlock - 1) / kSBlock;
  const int G = nk * nsb;
  // s-block g into stage g % kStages (zeros past the chunk's end)
  auto issue = [&](int g) {
    float* st = ring + (g % kStages) * T::kStage;
    const long long ch = k0 + g / nsb;
    const int s0 = (g % nsb) * kSBlock;
    const long long pos0 = ch * c + s0;
    const float* kb = k + (b * S + pos0) * row_stride + hh * HD + d0;
    const float* vb = v + (b * S + pos0) * row_stride + hh * HD + e0;
    for (int x = tid; x < kKQuads; x += kThreads) {
      const int s = x / (kTD / 4), q4 = x % (kTD / 4);
      const bool live = s0 + s < c;
      copy16(st + 4 * x, live ? kb + s * row_stride + 4 * q4 : kb, live);
    }
    for (int x = tid; x < kVQuads; x += kThreads) {
      const int s = x / (kTE / 4), q4 = x % (kTE / 4);
      const bool live = s0 + s < c;
      copy16(st + kSBlock * kTD + 4 * x,
             live ? vb + s * row_stride + 4 * q4 : vb, live);
    }
    // rel past the chunk's end is -inf, so that its weight is exp(-inf) = 0
    const float* relb = w.rel + bh * S + pos0;
    if (tid < kSBlock) {
      if (s0 + tid < c)
        copy4(st + kSBlock * (kTD + kTE) + tid, relb + tid);
      else
        st[kSBlock * (kTD + kTE) + tid] = -INFINITY;
    } else if (tid == kSBlock) {
      copy4(st + kSBlock * (kTD + kTE) + kSBlock,
            w.Mx + bh * S + ch * c + c - 1);
    }
  };
  float up[PD][PE];
  float nup = 0.f;
#pragma unroll
  for (int g = 0; g < kStages - 1; ++g) {
    if (g < G) issue(g);
    asm volatile("cp.async.commit_group;" ::: "memory");
  }
  for (int g = 0; g < G; ++g) {
    const int kl = g / nsb, sb = g % nsb;
    if (g + kStages - 1 < G) issue(g + kStages - 1);
    asm volatile("cp.async.commit_group;" ::: "memory");
    asm volatile("cp.async.wait_group %0;" ::"n"(kStages - 1) : "memory");
    __syncthreads();
    if (sb == 0) {           // the state entering chunk k0 + kl
      float* st = states + ((bh * seg + kl) * HD + d0) * HD + e0;
#pragma unroll
      for (int i = 0; i < PD; ++i) {
        store_cols<PE>(st + static_cast<long long>(ty * PD + i) * HD, cr[i],
                       tx);
#pragma unroll
        for (int j = 0; j < PE; ++j) up[i][j] = 0.f;
      }
      if (n_thread) nstates[(bh * seg + kl) * HD + d0 + tid] = nr;
      nup = 0.f;
    }
    const float* ks = ring + (g % kStages) * T::kStage;
    const float* vs = ks + kSBlock * kTD;
    const float* rel = vs + kSBlock * kTE;
    const float M_end = rel[kSBlock];
#pragma unroll 4
    for (int s = 0; s < kSBlock; ++s) {
      const float ws = expf(rel[s] - M_end);
      float a[PD], bv[PE];
      load_row<PD>(a, ks + s * kTD + ty * PD);
      load_cols<PE>(bv, vs + s * kTE, tx);
#pragma unroll
      for (int i = 0; i < PD; ++i) a[i] *= ws;
#pragma unroll
      for (int i = 0; i < PD; ++i)
#pragma unroll
        for (int j = 0; j < PE; ++j) up[i][j] += a[i] * bv[j];
      if (n_thread) nup += ws * ks[s * kTD + tid];
    }
    __syncthreads();
    if (sb == nsb - 1) {     // the chunk's end: decay and add
      const long long ch = k0 + kl;
      const float decay = expf(w.mk[bh * (S / c + 1) + ch] - M_end);
#pragma unroll
      for (int i = 0; i < PD; ++i)
#pragma unroll
        for (int j = 0; j < PE; ++j) cr[i][j] = decay * cr[i][j] + up[i][j];
      nr = decay * nr + nup;
    }
  }
  asm volatile("cp.async.wait_all;" ::: "memory");
#pragma unroll
  for (int i = 0; i < PD; ++i)
    store_cols<PE>(C_out + cbase +
                       static_cast<long long>(d0 + ty * PD + i) * HD + e0,
                   cr[i], tx);
  if (n_thread) n_out[bh * HD + d0 + tid] = nr;
}

// Pass (b), the output: one block per (chunk of the segment x e-tile, h,
// b), all chunks at once. It forms q_t . C_k[:, e-tile] (C_k the state
// entering chunk k, from `states`) and q_t . n_k over d-tiles of 16 (q
// transposed in shared memory; the next d-tile loaded into registers
// while the current one is multiplied), then h_t = (exp(m_k - M_t) q_t .
// C_k + intra_t) / max(|exp(m_k - M_t) q_t . n_k + qn_intra_t|, 1), the
// intra parts from the intra pass (in h and qni). Thread (tx, ty) holds
// rows t = ty * 8 + [0, 8) and columns tx PE + [0, PE) of the e-tile (PE
// = e-tile / 16).
template <int HD>
__global__ void __launch_bounds__(kThreads, 2)
mlstm_out_kernel(const float* __restrict__ q, const float* __restrict__ states,
                 const float* __restrict__ nstates, float* __restrict__ h,
                 Work w, long long S, int H, int c, long long k0, int seg) {
  constexpr int kE = HD < 128 ? HD : 128;        // e-tile
  constexpr int PE = kE / 16;
  constexpr int kD = 16;                         // d-tile
  constexpr int kQLd = kMaxChunk + 4;            // row stride of q^T
  constexpr int kQQuads = kMaxChunk * kD / 4;
  constexpr int kCQuads = kD * kE / 4;
  constexpr int kQPer = (kQQuads + kThreads - 1) / kThreads;
  constexpr int kCPer = (kCQuads + kThreads - 1) / kThreads;
  constexpr int nE = HD / kE;
  __shared__ __align__(16) float qT[kD * kQLd];
  __shared__ __align__(16) float Cs[kD * kE];
  __shared__ float nsm[HD];
  __shared__ float qnp[2][kMaxChunk];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const long long kl = blockIdx.x / nE;
  const int e0 = (blockIdx.x % nE) * kE;
  const long long hh = blockIdx.y, b = blockIdx.z;
  const long long bh = b * H + hh;
  const long long ch = k0 + kl;
  const long long lo = ch * c;
  const long long row_stride = static_cast<long long>(H) * HD;
  const float* qb = q + (b * S + lo) * row_stride + hh * HD;
  const float* Cb = states + (bh * seg + kl) * HD * HD + e0;
  const float* nb = nstates + (bh * seg + kl) * HD;
  for (int d = tid; d < HD; d += kThreads) nsm[d] = nb[d];
  float4 qreg[kQPer], creg[kCPer];
  auto fetch = [&](int d0) {
#pragma unroll
    for (int r = 0; r < kQPer; ++r) {
      const int x = tid + kThreads * r;
      const int t = x / (kD / 4), q4 = x % (kD / 4);
      qreg[r] = (x < kQQuads && t < c)
                    ? *reinterpret_cast<const float4*>(qb + t * row_stride +
                                                       d0 + 4 * q4)
                    : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int r = 0; r < kCPer; ++r) {
      const int x = tid + kThreads * r;
      const int d = x / (kE / 4), q4 = x % (kE / 4);
      if (x < kCQuads)
        creg[r] = *reinterpret_cast<const float4*>(
            Cb + static_cast<long long>(d0 + d) * HD + 4 * q4);
    }
  };
  auto stash = [&]() {
#pragma unroll
    for (int r = 0; r < kQPer; ++r) {
      const int x = tid + kThreads * r;
      if (x < kQQuads) {
        const int t = x / (kD / 4), d = 4 * (x % (kD / 4));
        qT[d * kQLd + t] = qreg[r].x;
        qT[(d + 1) * kQLd + t] = qreg[r].y;
        qT[(d + 2) * kQLd + t] = qreg[r].z;
        qT[(d + 3) * kQLd + t] = qreg[r].w;
      }
    }
#pragma unroll
    for (int r = 0; r < kCPer; ++r) {
      const int x = tid + kThreads * r;
      if (x < kCQuads) reinterpret_cast<float4*>(Cs)[x] = creg[r];
    }
  };
  float acc[8][PE];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < PE; ++j) acc[i][j] = 0.f;
  float qn = 0.f;
  const int qt = tid % kMaxChunk, qhalf = tid / kMaxChunk;
  fetch(0);
  for (int d0 = 0; d0 < HD; d0 += kD) {
    __syncthreads();
    stash();
    __syncthreads();
    if (d0 + kD < HD) fetch(d0 + kD);
#pragma unroll 4
    for (int d = 0; d < kD; ++d) {
      const float4 qa =
          *reinterpret_cast<const float4*>(qT + d * kQLd + ty * 8);
      const float4 qc =
          *reinterpret_cast<const float4*>(qT + d * kQLd + ty * 8 + 4);
      const float qv[8] = {qa.x, qa.y, qa.z, qa.w, qc.x, qc.y, qc.z, qc.w};
      float cv[PE];
      load_cols<PE>(cv, Cs + d * kE, tx);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < PE; ++j) acc[i][j] += qv[i] * cv[j];
    }
    for (int d = qhalf; d < kD; d += 2) qn += qT[d * kQLd + qt] * nsm[d0 + d];
  }
  qnp[qhalf][qt] = qn;
  __syncthreads();
  const float mk = w.mk[bh * (S / c + 1) + ch];
  float* hb = h + (b * S + lo) * row_stride + hh * HD + e0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int t = ty * 8 + i;
    if (t < c) {
      const float it = expf(mk - w.Mx[bh * S + lo + t]);
      const float qnt = it * (qnp[0][t] + qnp[1][t]) + w.qni[bh * S + lo + t];
      const float den = fmaxf(fabsf(qnt), 1.f);
      float* hr = hb + t * row_stride;
      float intra[PE];
      load_cols<PE>(intra, hr, tx);
#pragma unroll
      for (int j = 0; j < PE; ++j)
        intra[j] = (it * acc[i][j] + intra[j]) / den;
      store_cols<PE>(hr, intra, tx);
    }
  }
}

size_t intra_smem() {
  return sizeof(float) *
         (kMaxChunk * kStride + 2 * kDTile * kMaxChunk + 2 * kMaxChunk);
}

// One segment: pass (a) over chunks [k0, k0 + nk) from (C_in, n_in) into
// (C, n), then pass (b) over the same chunks.
template <int HD>
cudaError_t launch_segment(const float* q, const float* k, const float* v,
                           const float* C_in, const float* n_in, float* h,
                           float* C, float* n, float* states, float* nstates,
                           Work w,
                           long long B, long long S, int H, int c,
                           long long k0, int nk, int seg, cudaStream_t st) {
  using T = StateTile<HD>;
  constexpr int kE = HD < 128 ? HD : 128;
  cudaError_t err = cudaFuncSetAttribute(
      mlstm_state_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(T::kSmem));
  if (err != cudaSuccess) return err;
  const dim3 ga((HD / T::kTD) * (HD / T::kTE), static_cast<unsigned>(H),
                static_cast<unsigned>(B));
  mlstm_state_kernel<HD><<<ga, kThreads, T::kSmem, st>>>(
      k, v, C_in, n_in, C, n, states, nstates, w, S, H, c, k0, nk, seg);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 gb(static_cast<unsigned>(nk * (HD / kE)),
                static_cast<unsigned>(H), static_cast<unsigned>(B));
  mlstm_out_kernel<HD><<<gb, kThreads, 0, st>>>(q, states, nstates, h, w, S,
                                                H, c, k0, seg);
  return cudaGetLastError();
}

template <int HD>
cudaError_t carry(const float* q, const float* k, const float* v,
                  const float* C0, const float* n0, float* h, float* C,
                  float* n, float* states, float* nstates, Work w,
                  long long B, long long S, int H, int c, int seg,
                  cudaStream_t st) {
  const long long nc = S / c;
  for (long long k0 = 0; k0 < nc; k0 += seg) {
    const int nk = static_cast<int>(nc - k0 < seg ? nc - k0 : seg);
    const cudaError_t err = launch_segment<HD>(
        q, k, v, k0 == 0 ? C0 : C, k0 == 0 ? n0 : n, h, C, n, states,
        nstates, w, B, S, H, c, k0, nk, seg, st);
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

// The largest divisor ds of hd / 8 with ds * hd / 4 <= 256 (at least 1):
// B13's row ranges a column.
int step_ranges(int hd) {
  const int quads = hd / 4, k = hd / 8;
  int ds = 1;
  for (int x = 1; x <= k; ++x)
    if (k % x == 0 && x * quads <= 256) ds = x;
  return ds;
}

}  // namespace

// B13: q, k, v (B, H, hd), i, f (B, H), C (B, H, hd, hd), n (B, H, hd),
// m (B, H), all f32 contiguous, C and v 16-byte aligned, hd a multiple of
// 8. Updates C, n, m in place; writes h (B, H, hd).
extern "C" int repro_mlstm_step(const void* q, const void* k, const void* v,
                                const void* i, const void* f, void* C,
                                void* n, void* m, void* h, long long B, int H,
                                int hd, void* stream) {
  if (B <= 0 || H <= 0) return static_cast<int>(cudaGetLastError());
  const int ds = step_ranges(hd);
  const int threads = (ds * (hd / 4) + 31) / 32 * 32;
  const size_t smem = sizeof(float) * (3 + ds) * hd;
  cudaError_t err = cudaFuncSetAttribute(
      mlstm_step_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  mlstm_step_kernel<<<static_cast<unsigned>(B * H), threads, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(i),
      static_cast<const float*>(f), static_cast<float*>(C),
      static_cast<float*>(n), static_cast<float*>(m), static_cast<float*>(h),
      hd, ds);
  return static_cast<int>(cudaGetLastError());
}

// Floats of the scratch B12 needs: rel, M and qn_intra (B, H, S) and m at
// each chunk boundary (B, H, S / c + 1).
extern "C" long long repro_mlstm_chunkwise_work_floats(long long B, int H,
                                                       long long S, int c) {
  return B * H * (3 * S + S / c + 1);
}

// B12: q, k, v (B, S, H, hd), i, f (B, S, H), C0 (B, H, hd, hd), n0 (B,
// H, hd), m0 (B, H), all f32 contiguous and 16-byte aligned; hd in {16,
// 32, 64, 128, 256, 512}; 1 <= c <= 128 dividing S. Writes h (B, S, H,
// hd) and the final C, n, m (new buffers); `work` holds
// repro_mlstm_chunkwise_work_floats floats and `states` seg B H hd (hd + 1)
// (the states entering seg chunks). 2 + 2 ceil((S / c) / seg) launches.
extern "C" int repro_mlstm_chunkwise(const void* q, const void* k,
                                     const void* v, const void* i,
                                     const void* f, const void* C0,
                                     const void* n0, const void* m0, void* h,
                                     void* C, void* n, void* m, void* work,
                                     void* states, long long B, long long S,
                                     int H, int hd, int c, int seg,
                                     void* stream) {
  if (B <= 0 || S <= 0 || H <= 0) return static_cast<int>(cudaGetLastError());
  if (c < 1 || c > kMaxChunk || S % c || seg < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* wf = static_cast<float*>(work);
  const long long BH = B * H;
  const Work w{wf, wf + BH * S, wf + 2 * BH * S, wf + 3 * BH * S};
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  float* hf = static_cast<float*>(h);
  const long long nc = S / c;
  const int gate_threads =
      nc >= 256 ? 256 : static_cast<int>((nc + 31) / 32 * 32);
  mlstm_gates_kernel<<<static_cast<unsigned>(BH), gate_threads, 0, st>>>(
      static_cast<const float*>(i), static_cast<const float*>(f),
      static_cast<const float*>(m0), static_cast<float*>(m), w.rel, w.Mx,
      w.mk, H, S, c);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = intra_smem();
  err = cudaFuncSetAttribute(mlstm_intra_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(S / c), static_cast<unsigned>(H),
                  static_cast<unsigned>(B));
  mlstm_intra_kernel<<<grid, kThreads, smem, st>>>(qf, kf, vf, hf, w, S, H,
                                                   hd, c);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const float* C0f = static_cast<const float*>(C0);
  const float* n0f = static_cast<const float*>(n0);
  float* Cf = static_cast<float*>(C);
  float* nf = static_cast<float*>(n);
  float* sf = static_cast<float*>(states);
  float* nsf = sf + BH * seg * static_cast<long long>(hd) * hd;
  switch (hd) {
#define CARRY_CASE(HD)                                                      \
  case HD:                                                                  \
    err = carry<HD>(qf, kf, vf, C0f, n0f, hf, Cf, nf, sf, nsf, w, B, S, H, c, \
                    seg, st);                                               \
    break;
    CARRY_CASE(16)
    CARRY_CASE(32)
    CARRY_CASE(64)
    CARRY_CASE(128)
    CARRY_CASE(256)
    CARRY_CASE(512)
#undef CARRY_CASE
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

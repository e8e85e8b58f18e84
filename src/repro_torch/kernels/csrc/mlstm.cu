// mlstm.cu — the xLSTM mLSTM cell on Hopper: the chunkwise forward over a
// sequence (kernel B12, mlstm_chunkwise), one decode step (kernel B13,
// mlstm_step), and their backwards (B15, mlstm_chunkwise_bwd; B16,
// mlstm_step_bwd).
//
// None replaces a Pallas kernel: the JAX package computes the cell in jnp
// (repro/models/lm.py _mlstm_chunkwise, :755-808, and the `step` of
// mlstm_block, :830-843), leaves it to XLA and differentiates it with
// autodiff. They were added because as eager PyTorch the chunk loop and
// the step would be some 25 launches a chunk or a step (about 270 k
// launches a prefill of xlstm-1.3b), and their autograd twice as many.
// The contracts are those of repro_torch/kernels/ref.py mlstm_chunkwise,
// mlstm_step, mlstm_chunkwise_bwd and mlstm_step_bwd; all tensors are f32
// and contiguous.
//
// B15 and B16 (the sections below B12) compute JAX's gradient, the
// stabilizer's included, and are held to autograd through the plain
// forwards within ref.xlstm_bwd_tol. B15's bound is f32 operations: ten
// products with a chunk's hd x hd state (its entering C, recomputed; the
// walk of dC; C g for dq, dC' v for dk, dC'^T k for dv: c hd^2 each) and
// five over its causal pairs, 10 B H S hd^2 + 5 B H S (c + 1) hd, 96.7
// GFLOP (1.44 ms at 67 TFLOP/s) at xlstm-1.3b's 2 x 4,096 microbatch. Its
// design keeps B12's split of the carry from the rest: one reverse walk
// per 64 x 128 tile of dC over the chunks (the only part in order) and
// all chunks at once for the rest. B16 is bound by bytes: C and dC' read,
// dC written, 12 hd^2 bytes a (b, h).
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
                 float* __restrict__ qn_out, Work w, long long S, int H, int c,
                 long long k0, int seg) {
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
      if (qn_out != nullptr && e0 == 0 && tx == 0)
        qn_out[(b * S + lo + t) * H + hh] = qnt;
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
                           float* qn, Work w,
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
  mlstm_out_kernel<HD><<<gb, kThreads, 0, st>>>(q, states, nstates, h, qn, w,
                                                S, H, c, k0, seg);
  return cudaGetLastError();
}

template <int HD>
cudaError_t carry(const float* q, const float* k, const float* v,
                  const float* C0, const float* n0, float* h, float* C,
                  float* n, float* states, float* nstates, float* qn, Work w,
                  long long B, long long S, int H, int c, int seg,
                  cudaStream_t st) {
  const long long nc = S / c;
  for (long long k0 = 0; k0 < nc; k0 += seg) {
    const int nk = static_cast<int>(nc - k0 < seg ? nc - k0 : seg);
    const cudaError_t err = launch_segment<HD>(
        q, k, v, k0 == 0 ? C0 : C, k0 == 0 ? n0 : n, h, C, n, states,
        nstates, qn, w, B, S, H, c, k0, nk, seg, st);
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

// ---------------------------------------------------------------------------
// B16: the backward of one step
// ---------------------------------------------------------------------------
// One block per (b, h), as B13: thread (range r, quad e4) owns columns 4 e4
// .. 4 e4 + 3 over rows r hd / ds .. (r + 1) hd / ds. Pass 1 recomputes
// the step (n', q . n', and num = q . C' column by column, the column
// parts of the row ranges summed in order) for dh . num. Pass 2 walks C
// and dC' once more: G = dC' + q g^T (g = dh / max(|q . n'|, 1)), dC = fg
// G is written, and the row sums G v and C' g (summed over a row's quads
// by shuffles within groups of min(quads, 32) lanes, then the groups'
// parts in order), the column sums G^T k (the ranges' parts in order) and
// sum G . C are kept. hd is a power of two, 16..512 (the shuffle groups).
__device__ __forceinline__ float tie_share(float a, float b) {
  // d max(a, b) / da with JAX's (and torch.maximum's) halves at a tie
  return a > b ? 1.f : (a == b ? 0.5f : 0.f);
}

__global__ void mlstm_step_bwd_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ gi,
    const float* __restrict__ gf, const float* __restrict__ C,
    const float* __restrict__ n, const float* __restrict__ m,
    const float* __restrict__ dh, const float* __restrict__ dCn,
    const float* __restrict__ dnn, const float* __restrict__ dmn,
    float* __restrict__ dq, float* __restrict__ dk, float* __restrict__ dv,
    float* __restrict__ di, float* __restrict__ df, float* __restrict__ dC,
    float* __restrict__ dn, float* __restrict__ dm, int hd, int ds) {
  extern __shared__ float sm[];
  float* qs = sm;                 // hd
  float* ks = qs + hd;            // hd
  float* vs = ks + hd;            // hd
  float* gs = vs + hd;            // hd: dh, then g = dh / D
  float* ns = gs + hd;            // hd: n'
  const int quads = hd >> 2;
  const int width = quads < 32 ? quads : 32;      // lanes sharing a row
  const int nparts = quads / width;
  float* colp = ns + hd;          // ds x hd: column parts of the ranges
  float* rowA = colp + ds * hd;   // nparts x hd: sum_e G v
  float* rowB = rowA + nparts * hd;  // nparts x hd: sum_e C' g
  __shared__ float red[32];
  const int tid = threadIdx.x, nt = blockDim.x;
  const long long bh = blockIdx.x;
  const long long base = bh * hd;
  for (int d = tid; d < hd; d += nt) {
    qs[d] = q[base + d];
    ks[d] = k[base + d];
    vs[d] = v[base + d];
    gs[d] = dh[base + d];
  }
  const float i_ = gi[bh], f_ = gf[bh], m_ = m[bh];
  const float logf = log_sigmoid(f_);
  const float a = logf + m_;
  const float m_new = fmaxf(a, i_);
  const float ig = expf(i_ - m_new);
  const float fg = expf(logf + m_ - m_new);
  __syncthreads();
  float qn = 0.f;
  for (int d = tid; d < hd; d += nt) {
    const float nn = fg * n[base + d] + ig * ks[d];
    ns[d] = nn;
    qn += qs[d] * nn;
  }
  qn = block_sum(qn, red);
  const float den = fabsf(qn), D = fmaxf(den, 1.f);
  const int e4 = tid % quads, range = tid / quads;
  const bool live = range < ds;
  const int rows = hd / ds;
  const int d_lo = live ? range * rows : 0;
  const float4* Cb = reinterpret_cast<const float4*>(C + bh * hd * hd) + e4;
  const float4* Gb = reinterpret_cast<const float4*>(dCn + bh * hd * hd) + e4;
  float4* dCb = reinterpret_cast<float4*>(dC + bh * hd * hd) + e4;
  const float4 vv = live ? reinterpret_cast<const float4*>(vs)[e4]
                         : make_float4(0.f, 0.f, 0.f, 0.f);
  // pass 1: num = q . C', column by column
  if (live) {
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int d0 = d_lo; d0 < d_lo + rows; d0 += kStepRows) {
      float4 c[kStepRows];
#pragma unroll
      for (int j = 0; j < kStepRows; ++j)
        c[j] = Cb[static_cast<long long>(d0 + j) * quads];
#pragma unroll
      for (int j = 0; j < kStepRows; ++j) {
        const float kd = ks[d0 + j], qd = qs[d0 + j];
        acc.x += qd * (fg * c[j].x + ig * (kd * vv.x));
        acc.y += qd * (fg * c[j].y + ig * (kd * vv.y));
        acc.z += qd * (fg * c[j].z + ig * (kd * vv.z));
        acc.w += qd * (fg * c[j].w + ig * (kd * vv.w));
      }
    }
    reinterpret_cast<float4*>(colp + range * hd)[e4] = acc;
  }
  __syncthreads();
  float w = 0.f;
  for (int e = tid; e < hd; e += nt) {
    float s = 0.f;
    for (int r = 0; r < ds; ++r) s += colp[r * hd + e];
    w += gs[e] * s;
  }
  w = block_sum(w, red);          // dh . num
  // h = num / D: dD = -dh . num / D^2, through |q . n'| where it is >= 1
  const float dqn = -w / (D * D) * tie_share(den, 1.f) *
                    (qn > 0.f ? 1.f : (qn < 0.f ? -1.f : 0.f));
  __syncthreads();
  for (int e = tid; e < hd; e += nt) gs[e] = gs[e] / D;
  __syncthreads();
  // pass 2: G = dC' + q g^T; dC = fg G; row sums G v and C' g; column sums
  // G^T k; sum G . C
  const float4 gv = live ? reinterpret_cast<const float4*>(gs)[e4]
                         : make_float4(0.f, 0.f, 0.f, 0.f);
  float4 col = make_float4(0.f, 0.f, 0.f, 0.f);
  float sGC = 0.f;
  for (int d0 = 0; d0 < rows; d0 += kStepRows) {
    float4 c[kStepRows], G[kStepRows];
#pragma unroll
    for (int j = 0; j < kStepRows; ++j) {
      const long long at = static_cast<long long>(d_lo + d0 + j) * quads;
      c[j] = live ? Cb[at] : make_float4(0.f, 0.f, 0.f, 0.f);
      G[j] = live ? Gb[at] : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int j = 0; j < kStepRows; ++j) {
      const int d = d_lo + d0 + j;
      const float kd = ks[d], qd = qs[d];
      float4 g4 = G[j];
      g4.x += qd * gv.x;
      g4.y += qd * gv.y;
      g4.z += qd * gv.z;
      g4.w += qd * gv.w;
      if (live)
        dCb[static_cast<long long>(d) * quads] =
            make_float4(fg * g4.x, fg * g4.y, fg * g4.z, fg * g4.w);
      sGC += (g4.x * c[j].x + g4.y * c[j].y) + (g4.z * c[j].z + g4.w * c[j].w);
      col.x += g4.x * kd;
      col.y += g4.y * kd;
      col.z += g4.z * kd;
      col.w += g4.w * kd;
      float ra = (g4.x * vv.x + g4.y * vv.y) + (g4.z * vv.z + g4.w * vv.w);
      float rb = ((fg * c[j].x + ig * (kd * vv.x)) * gv.x +
                  (fg * c[j].y + ig * (kd * vv.y)) * gv.y) +
                 ((fg * c[j].z + ig * (kd * vv.z)) * gv.z +
                  (fg * c[j].w + ig * (kd * vv.w)) * gv.w);
      for (int o = width >> 1; o > 0; o >>= 1) {
        ra += __shfl_xor_sync(0xffffffffu, ra, o);
        rb += __shfl_xor_sync(0xffffffffu, rb, o);
      }
      if (live && (e4 % width) == 0) {
        rowA[(e4 / width) * hd + d] = ra;
        rowB[(e4 / width) * hd + d] = rb;
      }
    }
  }
  __syncthreads();
  if (live) reinterpret_cast<float4*>(colp + range * hd)[e4] = col;
  __syncthreads();
  float pig = 0.f, pfg = 0.f;
  for (int d = tid; d < hd; d += nt) {
    float ra = 0.f, rb = 0.f;
    for (int p = 0; p < nparts; ++p) {
      ra += rowA[p * hd + d];
      rb += rowB[p * hd + d];
    }
    const float dnt = dnn[base + d] + dqn * qs[d];    // n's total gradient
    dq[base + d] = rb + dqn * ns[d];
    dk[base + d] = ig * (ra + dnt);
    dn[base + d] = fg * dnt;
    pig += ks[d] * (ra + dnt);
    pfg += dnt * n[base + d];
    float cs = 0.f;
    for (int r = 0; r < ds; ++r) cs += colp[r * hd + d];
    dv[base + d] = ig * cs;
  }
  const float dig = block_sum(pig, red);
  const float dfg = block_sum(pfg, red) + block_sum(sGC, red);
  if (tid == 0) {
    // ig = exp(i - m'), fg = exp(logf + m - m'), m' = max(logf + m, i)
    const float dm_new = dmn[bh] - dig * ig - dfg * fg;
    const float sa = tie_share(a, i_);
    const float dlogf = dfg * fg + sa * dm_new;
    di[bh] = dig * ig + (1.f - sa) * dm_new;
    dm[bh] = dfg * fg + sa * dm_new;
    df[bh] = dlogf / (1.f + expf(f_));        // d logsigmoid = sigmoid(-f)
  }
}

// ---------------------------------------------------------------------------
// B15: the chunkwise backward
// ---------------------------------------------------------------------------
// Per-position scratch of B15, (B H, S) each: 1 / max(|q . n|, 1), dqn (the
// gradient of q . n), the weights of the reverse state walk (inter / D and
// inter dqn), the intra-chunk pass's drel and dM, then the inter-chunk
// pass's parts of dinter and dw, one (B H, S) array a column tile; and per
// chunk the reverse walk's parts of ddecay, one (B H, nc) array a tile, and
// the gate pass's dm entering each chunk (B H, nc + 1) and its two terms.
struct BwdWork {
  float* invD;
  float* dqn;
  float* wC;
  float* wn;
  float* drelI;
  float* dMI;
  float* dint;      // ntx x (B H, S)
  float* dw;        // ntx x (B H, S)
  float* ddec;      // nstile x (B H, nc)
  float* dmk;       // (B H, nc + 1)
  float* base;      // (B H, nc)
  float* share;     // (B H, nc)
};

// Pass N: one warp per (b, s, h): dh . h, then D = max(|qn|, 1), dqn =
// tie(|qn|, 1) sign(qn) (-dh . h / D) (h = num / D: dD = -dh . num / D^2),
// inter = exp(m_k - M_t) and the walk's weights.
__global__ void mlstm_bwd_norm_kernel(const float* __restrict__ h,
                                      const float* __restrict__ dh,
                                      const float* __restrict__ qn, Work w,
                                      BwdWork bw, long long rowsBSH,
                                      long long S, int H, int hd, int c) {
  const long long row = (static_cast<long long>(blockIdx.x) * blockDim.x +
                         threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= rowsBSH) return;
  const float* hr = h + row * hd;
  const float* gr = dh + row * hd;
  float x = 0.f;
  for (int e = lane; e < hd; e += 32) x += gr[e] * hr[e];
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  if (lane != 0) return;
  const long long hh = row % H, bs = row / H, s = bs % S, b = bs / S;
  const long long bh = b * H + hh;
  const float q_n = qn[row], den = fabsf(q_n), D = fmaxf(den, 1.f);
  const float dq_n = tie_share(den, 1.f) *
                     (q_n > 0.f ? 1.f : (q_n < 0.f ? -1.f : 0.f)) * (-x / D);
  const float inter = expf(w.mk[bh * (S / c + 1) + s / c] - w.Mx[bh * S + s]);
  const float invD = 1.f / D;
  bw.invD[bh * S + s] = invD;
  bw.dqn[bh * S + s] = dq_n;
  bw.wC[bh * S + s] = inter * invD;
  bw.wn[bh * S + s] = inter * dq_n;
}

// Pass R, the reverse state walk: mlstm_state_kernel's tiles and ring, the
// chunks of a segment walked from the last: at each chunk's start the tile
// holds dC' (the gradient of the state leaving it), which is stored into
// `gstates` and dotted with the chunk's entering C (from `states`) for the
// chunk's ddecay part; then dC' <- exp(m_k - M_end) dC' + sum_t (inter_t /
// D_t) q_t[d-tile] dh_t[e-tile]^T, and dn likewise with inter_t dqn_t.
template <int HD>
__global__ void __launch_bounds__(kThreads)
mlstm_dstate_kernel(const float* __restrict__ q, const float* __restrict__ dh,
                    const float* G_in, const float* gn_in, float* G_out,
                    float* gn_out, const float* __restrict__ states,
                    const float* __restrict__ nstates,
                    float* __restrict__ gstates, float* __restrict__ gnstates,
                    Work w, BwdWork bw, long long S, int H, int c,
                    long long k0, int nk, int seg) {
  using T = StateTile<HD>;
  constexpr int kTD = T::kTD, kTE = T::kTE;
  constexpr int PD = kTD / 16, PE = kTE / 16;
  constexpr int kKQuads = kSBlock * kTD / 4;
  constexpr int kVQuads = kSBlock * kTE / 4;
  constexpr int nE = HD / kTE;
  constexpr int kStageR = kSBlock * (kTD + kTE) + 2 * kSBlock;
  extern __shared__ __align__(16) float ring[];
  __shared__ float red[kThreads / 32];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int dt = blockIdx.x / nE, et = blockIdx.x % nE;
  const int d0 = dt * kTD, e0 = et * kTE;
  const long long hh = blockIdx.y, b = blockIdx.z;
  const long long bh = b * H + hh;
  const long long row_stride = static_cast<long long>(H) * HD;
  const long long nc = S / c;
  const bool n_thread = et == 0 && tid < kTD;
  const long long cbase = bh * HD * HD;
  float cr[PD][PE];
#pragma unroll
  for (int i = 0; i < PD; ++i)
    load_cols<PE>(cr[i], G_in + cbase +
                             static_cast<long long>(d0 + ty * PD + i) * HD + e0,
                  tx);
  float nr = n_thread ? gn_in[bh * HD + d0 + tid] : 0.f;
  const int nsb = (c + kSBlock - 1) / kSBlock;
  const int G = nk * nsb;
  // s-block g (chunk k0 + nk - 1 - g / nsb) into stage g % kStages; the
  // two weight rows (zero past the chunk's end) after q and dh
  auto issue = [&](int g) {
    float* st = ring + (g % kStages) * kStageR;
    const long long ch = k0 + nk - 1 - g / nsb;
    const int s0 = (g % nsb) * kSBlock;
    const long long pos0 = ch * c + s0;
    const float* qb = q + (b * S + pos0) * row_stride + hh * HD + d0;
    const float* gb = dh + (b * S + pos0) * row_stride + hh * HD + e0;
    for (int x = tid; x < kKQuads; x += kThreads) {
      const int s = x / (kTD / 4), q4 = x % (kTD / 4);
      const bool live = s0 + s < c;
      copy16(st + 4 * x, live ? qb + s * row_stride + 4 * q4 : qb, live);
    }
    for (int x = tid; x < kVQuads; x += kThreads) {
      const int s = x / (kTE / 4), q4 = x % (kTE / 4);
      const bool live = s0 + s < c;
      copy16(st + kSBlock * kTD + 4 * x,
             live ? gb + s * row_stride + 4 * q4 : gb, live);
    }
    float* wrow = st + kSBlock * (kTD + kTE);
    if (tid < kSBlock) {
      if (s0 + tid < c) {
        copy4(wrow + tid, bw.wC + bh * S + pos0 + tid);
      } else {
        wrow[tid] = 0.f;
      }
    } else if (tid < 2 * kSBlock) {
      const int x = tid - kSBlock;
      if (s0 + x < c) {
        copy4(wrow + kSBlock + x, bw.wn + bh * S + pos0 + x);
      } else {
        wrow[kSBlock + x] = 0.f;
      }
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
    const int kl = nk - 1 - g / nsb, sb = g % nsb;
    const long long ch = k0 + kl;
    if (g + kStages - 1 < G) issue(g + kStages - 1);
    asm volatile("cp.async.commit_group;" ::: "memory");
    asm volatile("cp.async.wait_group %0;" ::"n"(kStages - 1) : "memory");
    __syncthreads();
    if (sb == 0) {          // dC' of chunk ch: kept, and dotted with its C
      float* gt = gstates + ((bh * seg + kl) * HD + d0) * HD + e0;
      const float* ct = states + ((bh * seg + kl) * HD + d0) * HD + e0;
      float dot = 0.f;
#pragma unroll
      for (int i = 0; i < PD; ++i) {
        const long long r = static_cast<long long>(ty * PD + i) * HD;
        float cv[PE];
        load_cols<PE>(cv, ct + r, tx);
#pragma unroll
        for (int j = 0; j < PE; ++j) {
          dot += cr[i][j] * cv[j];
          up[i][j] = 0.f;
        }
        store_cols<PE>(gt + r, cr[i], tx);
      }
      if (n_thread) {
        gnstates[(bh * seg + kl) * HD + d0 + tid] = nr;
        dot += nr * nstates[(bh * seg + kl) * HD + d0 + tid];
      }
      nup = 0.f;
      for (int o = 16; o > 0; o >>= 1)
        dot += __shfl_xor_sync(0xffffffffu, dot, o);
      if ((tid & 31) == 0) red[tid >> 5] = dot;
      __syncthreads();
      if (tid == 0) {
        float sum = 0.f;
        for (int x = 0; x < kThreads / 32; ++x) sum += red[x];
        bw.ddec[(static_cast<long long>(blockIdx.x) * gridDim.z * H + bh) *
                    nc + ch] = sum;
      }
    }
    const float* qs = ring + (g % kStages) * kStageR;
    const float* gs = qs + kSBlock * kTD;
    const float* wc = gs + kSBlock * kTE;
    const float* wn = wc + kSBlock;
#pragma unroll 4
    for (int s = 0; s < kSBlock; ++s) {
      const float ws = wc[s];
      float a[PD], bv[PE];
      load_row<PD>(a, qs + s * kTD + ty * PD);
      load_cols<PE>(bv, gs + s * kTE, tx);
#pragma unroll
      for (int i = 0; i < PD; ++i) a[i] *= ws;
#pragma unroll
      for (int i = 0; i < PD; ++i)
#pragma unroll
        for (int j = 0; j < PE; ++j) up[i][j] += a[i] * bv[j];
      if (n_thread) nup += wn[s] * qs[s * kTD + tid];
    }
    __syncthreads();
    if (sb == nsb - 1) {    // the chunk's start: decay and add
      const float decay =
          expf(w.mk[bh * (nc + 1) + ch] - w.Mx[bh * S + ch * c + c - 1]);
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
    store_cols<PE>(G_out + cbase +
                       static_cast<long long>(d0 + ty * PD + i) * HD + e0,
                   cr[i], tx);
  if (n_thread) gn_out[bh * HD + d0 + tid] = nr;
}

// Pass P2, the intra-chunk backward: one block per (chunk, h, b). With
// Sqk = q k^T and dec_ts = exp(rel_s - M_t) (s <= t), S = Sqk dec; dP = dh
// v^T, dSc = dP / D_t + dqn_t and E = dSc dec (s <= t; 0 above the
// diagonal, where the forward's select gives no gradient). Then dq = E k,
// dk = E^T q and dv = S^T (dh / D) are written (the inter-chunk pass adds
// the state's parts), and drel_s = sum_t dSc S, dM_t = -sum_s dSc S.
// Thread (tx, ty) holds rows t = 8 ty + [0, 8) and columns s = tx + 16 j
// of the chunk's c x c products.
constexpr int kBETile = 64;           // e-tile of the output products
__global__ void __launch_bounds__(kThreads, 1)
mlstm_intra_bwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v, const float* __restrict__ dh,
                       float* __restrict__ dq, float* __restrict__ dk,
                       float* __restrict__ dv, Work w, BwdWork bw,
                       long long S, int H, int hd, int c) {
  extern __shared__ __align__(16) float sm[];
  float* buf1 = sm;                                 // S as [t][s]
  float* buf2 = buf1 + kMaxChunk * kStride;         // E as [s][t], then [t][s]
  float* tA = buf2 + kMaxChunk * kStride;           // 2 x kMaxChunk x kBETile
  float* tB = tA + kMaxChunk * kBETile;
  float* rel = tB + kMaxChunk * kBETile;            // kMaxChunk
  float* Mx = rel + kMaxChunk;
  float* invD = Mx + kMaxChunk;
  float* dqn = invD + kMaxChunk;
  float* colp = dqn + kMaxChunk;                    // 16 x kMaxChunk
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const long long ch = blockIdx.x, hh = blockIdx.y, b = blockIdx.z;
  const long long bh = b * H + hh;
  const long long lo = ch * c;
  const long long row_stride = static_cast<long long>(H) * hd;
  const long long off = (b * S + lo) * row_stride + hh * hd;
  for (int t = tid; t < kMaxChunk; t += kThreads) {
    const bool in = t < c;
    rel[t] = in ? w.rel[bh * S + lo + t] : 0.f;
    Mx[t] = in ? w.Mx[bh * S + lo + t] : 0.f;
    invD[t] = in ? bw.invD[bh * S + lo + t] : 0.f;
    dqn[t] = in ? bw.dqn[bh * S + lo + t] : 0.f;
  }
  // acc = X Y^T over d-tiles of kDTile (X, Y transposed in tA, tB)
  auto product = [&](float (&acc)[8][8], const float* X, const float* Y) {
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
    for (int d0 = 0; d0 < hd; d0 += kDTile) {
      __syncthreads();
      for (int x = tid; x < kMaxChunk * kDTile; x += kThreads) {
        const int t = x % kMaxChunk, d = x / kMaxChunk;
        const bool in = t < c && d0 + d < hd;
        tA[d * kMaxChunk + t] = in ? X[off + t * row_stride + d0 + d] : 0.f;
        tB[d * kMaxChunk + t] = in ? Y[off + t * row_stride + d0 + d] : 0.f;
      }
      __syncthreads();
#pragma unroll 4
      for (int d = 0; d < kDTile; ++d) {
        const float4 xa = reinterpret_cast<const float4*>(
            tA + d * kMaxChunk + ty * 8)[0];
        const float4 xc = reinterpret_cast<const float4*>(
            tA + d * kMaxChunk + ty * 8)[1];
        const float xv[8] = {xa.x, xa.y, xa.z, xa.w, xc.x, xc.y, xc.z, xc.w};
        float yv[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) yv[j] = tB[d * kMaxChunk + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] += xv[i] * yv[j];
      }
    }
  };
  float sc[8][8], ec[8][8];
  product(sc, q, k);                  // Sqk
  product(ec, dh, v);                 // dP
  // S into buf1 [t][s]; E kept in ec and stored into buf2 [s][t]; the row
  // sums of dSc S (dM, over a half-warp) and the column sums (drel, by ty)
  float colsum[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) colsum[j] = 0.f;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int t = ty * 8 + i;
    float rowsum = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int s = tx + 16 * j;
      const bool live = s <= t && t < c;
      const float dec = live ? expf(rel[s] - Mx[t]) : 0.f;
      const float Sv = sc[i][j] * dec;
      const float dS = live ? ec[i][j] * invD[t] + dqn[t] : 0.f;
      const float x = dS * Sv;
      rowsum += x;
      colsum[j] += x;
      buf1[t * kStride + s] = Sv;
      ec[i][j] = dS * dec;
      buf2[s * kStride + t] = ec[i][j];
    }
    for (int o = 8; o > 0; o >>= 1)
      rowsum += __shfl_xor_sync(0xffffffffu, rowsum, o);
    if (tx == 0 && t < c) bw.dMI[bh * S + lo + t] = -rowsum;
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) colp[ty * kMaxChunk + tx + 16 * j] = colsum[j];
  __syncthreads();
  if (tid < c) {
    float sum = 0.f;
    for (int r = 0; r < 16; ++r) sum += colp[r * kMaxChunk + tid];
    bw.drelI[bh * S + lo + tid] = sum;
  }
  // out[r][e] = sum_x A[x][r] B[x][e] over the chunk, A in shared memory
  // ([x][r], row stride kStride), B an e-tile (x, kBETile) in shared memory
  auto rows_out = [&](float (&o)[8][4], const float* A, const float* Bt) {
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) o[i][j] = 0.f;
#pragma unroll 4
    for (int x = 0; x < c; ++x) {
      const float4 aa = reinterpret_cast<const float4*>(A + x * kStride +
                                                        ty * 8)[0];
      const float4 ab = reinterpret_cast<const float4*>(A + x * kStride +
                                                        ty * 8)[1];
      const float av[8] = {aa.x, aa.y, aa.z, aa.w, ab.x, ab.y, ab.z, ab.w};
      const float4 bb = reinterpret_cast<const float4*>(Bt + x * kBETile)[tx];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        o[i][0] += av[i] * bb.x;
        o[i][1] += av[i] * bb.y;
        o[i][2] += av[i] * bb.z;
        o[i][3] += av[i] * bb.w;
      }
    }
  };
  // an e-tile of rows x of X (scaled by scale[x] if given) into dst
  auto load_tile = [&](float* dst, const float* X, int e0,
                       const float* scale) {
    for (int x = tid; x < kMaxChunk * (kBETile / 4); x += kThreads) {
      const int r = x / (kBETile / 4), e4 = x % (kBETile / 4);
      const int e = e0 + e4 * 4;
      float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
      if (r < c && e < hd) {
        val = *reinterpret_cast<const float4*>(X + off + r * row_stride + e);
        if (scale != nullptr) {
          const float sv = scale[r];
          val = make_float4(val.x * sv, val.y * sv, val.z * sv, val.w * sv);
        }
      }
      reinterpret_cast<float4*>(dst + r * kBETile)[e4] = val;
    }
  };
  auto store = [&](float* Y, const float (&o)[8][4], int e0) {
    const int e = e0 + tx * 4;
    if (e >= hd) return;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = ty * 8 + i;
      if (r < c)
        *reinterpret_cast<float4*>(Y + off + r * row_stride + e) =
            make_float4(o[i][0], o[i][1], o[i][2], o[i][3]);
    }
  };
  float o[8][4];
  // dq = E k (E^T in buf2: [s][t]); dv = S^T (dh / D) (S in buf1: [t][s])
  for (int e0 = 0; e0 < hd; e0 += kBETile) {
    __syncthreads();
    load_tile(tA, k, e0, nullptr);
    load_tile(tB, dh, e0, invD);
    __syncthreads();
    rows_out(o, buf2, tA);
    store(dq, o, e0);
    rows_out(o, buf1, tB);
    store(dv, o, e0);
  }
  __syncthreads();
  // E into buf2 as [t][s], from the registers
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
      buf2[(ty * 8 + i) * kStride + tx + 16 * j] = ec[i][j];
  // dk = E^T q
  for (int e0 = 0; e0 < hd; e0 += kBETile) {
    __syncthreads();
    load_tile(tA, q, e0, nullptr);
    __syncthreads();
    rows_out(o, buf2, tA);
    store(dk, o, e0);
  }
}

size_t intra_bwd_smem() {
  return sizeof(float) * (2 * kMaxChunk * kStride + 2 * kMaxChunk * kBETile +
                          4 * kMaxChunk + 16 * kMaxChunk);
}

// Pass P1, the inter-chunk backward: one block per (chunk of the segment x
// column tile, h, b x mode), each a (c x HD) x (HD x CW) product with a
// chunk's state on the right, added into dq, dk or dv:
//   mode 0: dq_t[d] += inter_t (dh_t . C_k[d, :] / D_t + dqn_t n_k[d]),
//           and q_t . (...) over the tile, a part of dinter_t;
//   mode 1: dk_s[d] += w_s (v_s . G_k[d, :] + dn'_k[d]), and k_s . (...),
//           a part of dw_s (G_k = dC' of chunk k);
//   mode 2: dv_s[e] += w_s (k_s . G_k[:, e]),
// with inter_t = exp(m_k - M_t), w_s = exp(rel_s - M_end). Thread (tx, ty)
// holds rows 8 ty + [0, 8) and columns PE tx + [0, PE) of the tile; x-tiles
// of XT of the contraction pass through shared memory.
template <int HD>
__global__ void __launch_bounds__(kThreads)
mlstm_inter_bwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v, const float* __restrict__ dh,
                       const float* __restrict__ states,
                       const float* __restrict__ nstates,
                       const float* __restrict__ gstates,
                       const float* __restrict__ gnstates,
                       float* __restrict__ dq, float* __restrict__ dk,
                       float* __restrict__ dv, Work w, BwdWork bw,
                       long long S, int H, int B, int c, long long k0,
                       int seg) {
  constexpr int CW = HD < 64 ? HD : 64;          // column tile
  constexpr int PE = CW / 16;
  constexpr int XT = HD < 32 ? HD : 32;          // contraction tile
  constexpr int nTiles = HD / CW;
  constexpr int kALd = kMaxChunk + 4;
  __shared__ __align__(16) float As[XT * kALd];  // [x][r]
  __shared__ __align__(16) float Ws[XT * CW];    // [x][col]
  __shared__ float wrow[kMaxChunk], crow[kMaxChunk], drow[kMaxChunk];
  __shared__ float nvec[CW];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const long long kl = blockIdx.x / nTiles;
  const int tile = static_cast<int>(blockIdx.x % nTiles);
  const int col0 = tile * CW;
  const long long hh = blockIdx.y;
  const long long b = blockIdx.z / 3;
  const int mode = static_cast<int>(blockIdx.z % 3);
  const long long bh = b * H + hh;
  const long long ch = k0 + kl;
  const long long lo = ch * c;
  const long long nc = S / c;
  const long long row_stride = static_cast<long long>(H) * HD;
  const long long off = (b * S + lo) * row_stride + hh * HD;
  const float* A = mode == 0 ? dh : (mode == 1 ? v : k);
  const float* Wm = (mode == 0 ? states : gstates) + (bh * seg + kl) * HD * HD;
  float* out = mode == 0 ? dq : (mode == 1 ? dk : dv);
  const float mk = w.mk[bh * (nc + 1) + ch];
  const float M_end = w.Mx[bh * S + lo + c - 1];
  for (int t = tid; t < kMaxChunk; t += kThreads) {
    float wt = 0.f, ct = 0.f, dt_ = 0.f;
    if (t < c) {
      if (mode == 0) {
        wt = expf(mk - w.Mx[bh * S + lo + t]);       // inter_t
        ct = bw.invD[bh * S + lo + t];
        dt_ = bw.dqn[bh * S + lo + t];
      } else {
        wt = expf(w.rel[bh * S + lo + t] - M_end);   // w_s
      }
    }
    wrow[t] = wt;
    crow[t] = ct;
    drow[t] = dt_;
  }
  for (int x = tid; x < CW; x += kThreads)
    nvec[x] = mode == 0 ? nstates[(bh * seg + kl) * HD + col0 + x]
                        : (mode == 1 ? gnstates[(bh * seg + kl) * HD + col0 + x]
                                     : 0.f);
  float acc[8][PE];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < PE; ++j) acc[i][j] = 0.f;
  for (int x0 = 0; x0 < HD; x0 += XT) {
    __syncthreads();
    for (int x = tid; x < kMaxChunk * XT; x += kThreads) {
      const int r = x / XT, xx = x % XT;
      As[xx * kALd + r] = r < c ? A[off + r * row_stride + x0 + xx] : 0.f;
    }
    if (mode == 2) {          // W[x][col] = G[x0 + x][col0 + col]
      for (int x = tid; x < XT * CW; x += kThreads) {
        const int xx = x / CW, cc = x % CW;
        Ws[x] = Wm[static_cast<long long>(x0 + xx) * HD + col0 + cc];
      }
    } else {                  // W[x][col] = M[col0 + col][x0 + x]
      for (int x = tid; x < XT * CW; x += kThreads) {
        const int cc = x / XT, xx = x % XT;
        Ws[xx * CW + cc] = Wm[static_cast<long long>(col0 + cc) * HD + x0 + xx];
      }
    }
    __syncthreads();
#pragma unroll 4
    for (int xx = 0; xx < XT; ++xx) {
      const float4 aa =
          *reinterpret_cast<const float4*>(As + xx * kALd + ty * 8);
      const float4 ab =
          *reinterpret_cast<const float4*>(As + xx * kALd + ty * 8 + 4);
      const float av[8] = {aa.x, aa.y, aa.z, aa.w, ab.x, ab.y, ab.z, ab.w};
      float wv[PE];
#pragma unroll
      for (int j = 0; j < PE; ++j) wv[j] = Ws[xx * CW + tx * PE + j];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < PE; ++j) acc[i][j] += av[i] * wv[j];
    }
  }
  // epilogue: add into the output; the row parts of dinter / dw
  const float* R = mode == 0 ? q : k;      // the row dotted with the addend
  float* part = mode == 0 ? bw.dint : bw.dw;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = ty * 8 + i;
    float dotp = 0.f;
    if (r < c) {
      float* orow = out + off + r * row_stride + col0 + tx * PE;
      const float* rrow = R + off + r * row_stride + col0 + tx * PE;
#pragma unroll
      for (int j = 0; j < PE; ++j) {
        const float nv = nvec[tx * PE + j];
        float add;
        if (mode == 0) {
          const float g = acc[i][j] * crow[r] + drow[r] * nv;
          add = wrow[r] * g;
          dotp += rrow[j] * g;
        } else if (mode == 1) {
          const float g = acc[i][j] + nv;
          add = wrow[r] * g;
          dotp += rrow[j] * g;
        } else {
          add = wrow[r] * acc[i][j];
        }
        orow[j] += add;
      }
    }
    for (int o = 8; o > 0; o >>= 1)
      dotp += __shfl_xor_sync(0xffffffffu, dotp, o);
    if (mode < 2 && tx == 0 && r < c)
      part[(static_cast<long long>(tile) * B * H + bh) * S + lo + r] = dotp;
  }
}

// Pass Q, the gates: one block per (b, h), a thread a chunk. With dinter,
// dw and ddecay summed over their tiles in order, per chunk k:
//   dM_t = dM_intra_t - dinter_t inter_t (+ at the chunk's end
//          -sum_s dw_s w_s - ddecay decay + dm'),
//   drel_s = drel_intra_s + dw_s w_s,
//   dm_k = sum_t dinter_t inter_t + ddecay decay + sum_t tie(m_k, cm_t) dM_t,
// where cm_t = max_{s <= t} rel_s and M_t = max(m_k, cm_t) route dM_t to
// m_k (halves at a tie) and the rest to the latest s holding cm_t; m' =
// F_end + M_end takes dm' (the next chunk's dm_k; the final state's dm
// for the last) into dM_end and dF_end. The chunks' dm_k hang on dm' only
// through the end share, so each chunk's base and share are formed at
// once, thread 0 walks them in reverse, and then each chunk forms di_s =
// drel_s and df_s = sigmoid(-f_s) sum_{t >= s} dF_t, dF_t = -drel_t (+ dm'
// at the end).
__global__ void mlstm_gates_bwd_kernel(const float* __restrict__ gf,
                                       const float* __restrict__ dm_T,
                                       float* __restrict__ di,
                                       float* __restrict__ df, Work w,
                                       BwdWork bw, int H, int B, long long S,
                                       int c, int ntx, int nstile) {
  const long long bh = blockIdx.x;
  const int tid = threadIdx.x, nt = blockDim.x;
  const long long b = bh / H, hh = bh % H;
  const long long nc = S / c;
  const long long BHS = static_cast<long long>(B) * H * S;
  const long long BHN = static_cast<long long>(B) * H * nc;
  const float* rel = w.rel + bh * S;
  const float* Mx = w.Mx + bh * S;
  const float* mkv = w.mk + bh * (nc + 1);
  auto sum_parts = [&](const float* p, int n, long long stride,
                       long long at) {
    float s = 0.f;
    for (int x = 0; x < n; ++x) s += p[x * stride + at];
    return s;
  };
  // dM_t without dm', and the chunk's ddecay decay term
  auto chunk_terms = [&](long long ch, float& dec_term, float& wsum) {
    const float mk = mkv[ch];
    const float M_end = Mx[ch * c + c - 1];
    const float decay = expf(mk - M_end);
    dec_term = sum_parts(bw.ddec, nstile, BHN, bh * nc + ch) * decay;
    wsum = 0.f;
    for (int s = 0; s < c; ++s) {
      const long long p = ch * c + s;
      wsum += sum_parts(bw.dw, ntx, BHS, bh * S + p) * expf(rel[p] - M_end);
    }
  };
  for (long long ch = tid; ch < nc; ch += nt) {
    float dec_term, wsum;
    chunk_terms(ch, dec_term, wsum);
    const float mk = mkv[ch];
    float base = dec_term, cm = -INFINITY, sh = 0.f;
    for (int t = 0; t < c; ++t) {
      const long long p = ch * c + t;
      const float inter = expf(mk - Mx[p]);
      const float dint = sum_parts(bw.dint, ntx, BHS, bh * S + p) * inter;
      float dM = bw.dMI[bh * S + p] - dint;
      if (t == c - 1) dM -= wsum + dec_term;
      cm = fmaxf(cm, rel[p]);
      sh = tie_share(mk, cm);
      base += dint + sh * dM;
    }
    bw.base[bh * nc + ch] = base;
    bw.share[bh * nc + ch] = sh;
  }
  __syncthreads();
  if (tid == 0) {
    float dm = dm_T[bh];
    for (long long ch = nc - 1; ch >= 0; --ch) {
      bw.dmk[bh * (nc + 1) + ch + 1] = dm;      // dm' of chunk ch
      dm = bw.base[bh * nc + ch] + bw.share[bh * nc + ch] * dm;
    }
    bw.dmk[bh * (nc + 1)] = dm;
  }
  __syncthreads();
  for (long long ch = tid; ch < nc; ch += nt) {
    float dec_term, wsum;
    chunk_terms(ch, dec_term, wsum);
    const float mk = mkv[ch];
    const float M_end = Mx[ch * c + c - 1];
    const float dmn = bw.dmk[bh * (nc + 1) + ch + 1];
    float cm = -INFINITY;
    long long arg = ch * c;
    for (int t = 0; t < c; ++t) {
      const long long p = ch * c + t;
      const long long at = (b * S + p) * H + hh;
      di[at] = bw.drelI[bh * S + p] +
               sum_parts(bw.dw, ntx, BHS, bh * S + p) * expf(rel[p] - M_end);
      if (rel[p] >= cm) {
        cm = rel[p];
        arg = p;
      }
      const float inter = expf(mk - Mx[p]);
      float dM = bw.dMI[bh * S + p] -
                 sum_parts(bw.dint, ntx, BHS, bh * S + p) * inter;
      if (t == c - 1) dM += dmn - wsum - dec_term;
      di[(b * S + arg) * H + hh] += (1.f - tie_share(mk, cm)) * dM;
    }
    float run = 0.f;
    for (int s = c - 1; s >= 0; --s) {
      const long long p = ch * c + s;
      const long long at = (b * S + p) * H + hh;
      run += -di[at] + (s == c - 1 ? dmn : 0.f);
      df[at] = run / (1.f + expf(gf[at]));
    }
  }
}

// The segments of B15's state walks: the states entering each chunk of
// segment j (pass a of the forward, from the state entering the segment),
// then pass R over it from the later segments' carry, then pass P1.
template <int HD>
cudaError_t bwd_carry(const float* q, const float* k, const float* v,
                      const float* dh, const float* C0, const float* n0,
                      const float* dC, const float* dn, float* dq, float* dk,
                      float* dv, float* states, float* gstates, float* bound,
                      float* junk, float* carry, Work w, BwdWork bw,
                      long long B, long long S, int H, int c, int seg,
                      cudaStream_t st) {
  using T = StateTile<HD>;
  constexpr int kStageR = kSBlock * (T::kTD + T::kTE) + 2 * kSBlock;
  const size_t smemR = sizeof(float) * kStages * kStageR;
  const long long BH = B * H;
  const long long nc = S / c;
  const long long nseg = (nc + seg - 1) / seg;
  const long long Csz = BH * HD * HD, one = BH * HD * (HD + 1);
  float* nst = states + seg * Csz;
  float* gnst = gstates + seg * Csz;
  cudaError_t err = cudaFuncSetAttribute(
      mlstm_state_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(T::kSmem));
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(mlstm_dstate_kernel<HD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smemR));
  if (err != cudaSuccess) return err;
  const dim3 ga((HD / T::kTD) * (HD / T::kTE), static_cast<unsigned>(H),
                static_cast<unsigned>(B));
  auto walk = [&](long long j, float* C_out, float* n_out) {
    const long long k0 = j * seg;
    const int nk = static_cast<int>(nc - k0 < seg ? nc - k0 : seg);
    const float* C_in = j == 0 ? C0 : bound + (j - 1) * one;
    const float* n_in = j == 0 ? n0 : bound + (j - 1) * one + Csz;
    mlstm_state_kernel<HD><<<ga, kThreads, T::kSmem, st>>>(
        k, v, C_in, n_in, C_out, n_out, states, nst, w, S, H, c, k0, nk, seg);
    return cudaGetLastError();
  };
  for (long long j = 0; j + 1 < nseg; ++j) {
    err = walk(j, bound + j * one, bound + j * one + Csz);
    if (err != cudaSuccess) return err;
  }
  constexpr int CW = HD < 64 ? HD : 64;
  for (long long j = nseg - 1; j >= 0; --j) {
    err = walk(j, junk, junk + Csz);
    if (err != cudaSuccess) return err;
    const long long k0 = j * seg;
    const int nk = static_cast<int>(nc - k0 < seg ? nc - k0 : seg);
    const bool last = j == nseg - 1;
    mlstm_dstate_kernel<HD><<<ga, kThreads, smemR, st>>>(
        q, dh, last ? dC : carry, last ? dn : carry + Csz, carry,
        carry + Csz, states, nst, gstates, gnst, w, bw, S, H, c, k0, nk, seg);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    const dim3 gp(static_cast<unsigned>(nk * (HD / CW)),
                  static_cast<unsigned>(H), static_cast<unsigned>(B * 3));
    mlstm_inter_bwd_kernel<HD><<<gp, kThreads, 0, st>>>(
        q, k, v, dh, states, nst, gstates, gnst, dq, dk, dv, w, bw, S, H,
        static_cast<int>(B), c, k0, seg);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

// B15's scratch, in floats: the forward's gates (Work), BwdWork, the chunk
// states and dC' of a segment (seg B H hd (hd + 1) each), the states
// entering segments 1.. (one each), a junk state and the carry.
struct BwdLayout {
  long long work, bwd, states, bound, total;
};

BwdLayout bwd_layout(long long B, int H, long long S, int hd, int c,
                     int seg) {
  const long long BH = B * H, nc = S / c;
  const long long nseg = (nc + seg - 1) / seg;
  const int ntx = hd < 64 ? 1 : hd / 64;
  const int nstile = (hd / (hd < 64 ? hd : 64)) * (hd / (hd < 128 ? hd : 128));
  const long long one = BH * hd * (hd + 1);
  BwdLayout l;
  l.work = BH * (3 * S + nc + 1) + BH;           // + the gates' m output
  l.bwd = BH * S * (6 + 2 * ntx) + BH * nc * (nstile + 2) + BH * (nc + 1);
  l.states = 2 * seg * one;
  l.bound = (nseg - 1) * one + 2 * one;
  l.total = l.work + l.bwd + l.states + l.bound;
  return l;
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
// (the states entering seg chunks); where `qn` is not null, each
// position's q . n, the normalizer's argument (B, S, H), for the backward.
// 2 + 2 ceil((S / c) / seg) launches.
extern "C" int repro_mlstm_chunkwise(const void* q, const void* k,
                                     const void* v, const void* i,
                                     const void* f, const void* C0,
                                     const void* n0, const void* m0, void* h,
                                     void* C, void* n, void* m, void* qn,
                                     void* work, void* states, long long B,
                                     long long S, int H, int hd, int c,
                                     int seg, void* stream) {
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
    err = carry<HD>(qf, kf, vf, C0f, n0f, hf, Cf, nf, sf, nsf,              \
                    static_cast<float*>(qn), w, B, S, H, c, seg, st);       \
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

// B16: the backward of B13 from the state (C, n, m) the step entered: q, k,
// v, dh (B, H, hd), i, f (B, H), C and dC' (B, H, hd, hd), n and dn' (B, H,
// hd), m and dm' (B, H) (dC', dn', dm' the gradients of the state it
// left), all f32 contiguous, C, dC', v and dh 16-byte aligned, hd a power
// of two in 16..512. Writes dq, dk, dv (B, H, hd), di, df (B, H) and the
// entering state's dC, dn, dm.
extern "C" int repro_mlstm_step_bwd(
    const void* q, const void* k, const void* v, const void* i,
    const void* f, const void* C, const void* n, const void* m,
    const void* dh, const void* dC1, const void* dn1, const void* dm1,
    void* dq, void* dk, void* dv, void* di, void* df, void* dC, void* dn,
    void* dm, long long B, int H, int hd, void* stream) {
  if (B <= 0 || H <= 0) return static_cast<int>(cudaGetLastError());
  if (hd < 16 || hd > 512 || (hd & (hd - 1)))
    return static_cast<int>(cudaErrorInvalidValue);
  const int ds = step_ranges(hd);
  const int quads = hd / 4;
  const int nparts = quads < 32 ? 1 : quads / 32;
  const int threads = (ds * quads + 31) / 32 * 32;
  const size_t smem = sizeof(float) * (5 + ds + 2 * nparts) * hd;
  cudaError_t err = cudaFuncSetAttribute(
      mlstm_step_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  auto cf = [](const void* p) { return static_cast<const float*>(p); };
  auto fp = [](void* p) { return static_cast<float*>(p); };
  mlstm_step_bwd_kernel<<<static_cast<unsigned>(B * H), threads, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      cf(q), cf(k), cf(v), cf(i), cf(f), cf(C), cf(n), cf(m), cf(dh),
      cf(dC1), cf(dn1), cf(dm1), fp(dq), fp(dk), fp(dv), fp(di), fp(df),
      fp(dC), fp(dn), fp(dm), hd, ds);
  return static_cast<int>(cudaGetLastError());
}

// Floats of the scratch B15 takes (bwd_layout) for segments of seg chunks.
extern "C" long long repro_mlstm_chunkwise_bwd_work_floats(long long B, int H,
                                                           long long S, int hd,
                                                           int c, int seg) {
  return bwd_layout(B, H, S, hd, c, seg).total;
}

// B15: the backward of B12 with respect to q, k, v, i and f. q, k, v, h, dh
// (B, S, H, hd), i, f, qn (B, S, H; qn the forward's q . n), C0, dC (B, H,
// hd, hd), n0, dn (B, H, hd), m0, dm (B, H; dC, dn, dm the final state's
// gradients), all f32 contiguous and 16-byte aligned; hd in {16, ..., 512};
// c <= 128 dividing S. Writes dq, dk, dv (B, S, H, hd), di, df (B, S, H).
// `work` holds repro_mlstm_chunkwise_bwd_work_floats floats. Launches: the
// gates, the normalizer terms (pass N), the intra-chunk backward (P2), then
// per segment, last first, the chunk states (B12's pass a; the earlier
// segments' entering states once before), the reverse state walk (R) and
// the inter-chunk backward (P1); then the gates' backward (Q).
extern "C" int repro_mlstm_chunkwise_bwd(
    const void* q, const void* k, const void* v, const void* i,
    const void* f, const void* C0, const void* n0, const void* m0,
    const void* h, const void* qn, const void* dh, const void* dC,
    const void* dn, const void* dm, void* dq, void* dk, void* dv, void* di,
    void* df, void* work, long long B, long long S, int H, int hd, int c,
    int seg, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0) return static_cast<int>(cudaGetLastError());
  if (c < 1 || c > kMaxChunk || S % c || seg < 1 || B * 3 >= 65536)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto cf = [](const void* p) { return static_cast<const float*>(p); };
  const BwdLayout l = bwd_layout(B, H, S, hd, c, seg);
  float* wf = static_cast<float*>(work);
  const long long BH = B * H, nc = S / c, BHS = BH * S;
  const int ntx = hd < 64 ? 1 : hd / 64;
  const int nstile = (hd / (hd < 64 ? hd : 64)) * (hd / (hd < 128 ? hd : 128));
  const Work w{wf, wf + BHS, wf + 2 * BHS, wf + 3 * BHS};
  float* m_junk = wf + 3 * BHS + BH * (nc + 1);
  float* b0 = wf + l.work;
  BwdWork bw;
  bw.invD = b0;
  bw.dqn = b0 + BHS;
  bw.wC = b0 + 2 * BHS;
  bw.wn = b0 + 3 * BHS;
  bw.drelI = b0 + 4 * BHS;
  bw.dMI = b0 + 5 * BHS;
  bw.dint = b0 + 6 * BHS;
  bw.dw = bw.dint + ntx * BHS;
  bw.ddec = bw.dw + ntx * BHS;
  bw.dmk = bw.ddec + nstile * BH * nc;
  bw.base = bw.dmk + BH * (nc + 1);
  bw.share = bw.base + BH * nc;
  float* states = wf + l.work + l.bwd;
  float* gstates = states + seg * BH * hd * (hd + 1);
  float* bound = wf + l.work + l.bwd + l.states;
  const long long nseg = (nc + seg - 1) / seg;
  float* junk = bound + (nseg - 1) * BH * hd * (hd + 1);
  float* carry = junk + BH * hd * (hd + 1);
  const int gate_threads =
      nc >= 256 ? 256 : static_cast<int>((nc + 31) / 32 * 32);
  mlstm_gates_kernel<<<static_cast<unsigned>(BH), gate_threads, 0, st>>>(
      cf(i), cf(f), cf(m0), m_junk, w.rel, w.Mx, w.mk, H, S, c);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long rows = BHS;
  mlstm_bwd_norm_kernel<<<static_cast<unsigned>((rows + 7) / 8), 256, 0,
                          st>>>(cf(h), cf(dh), cf(qn), w, bw, rows, S, H, hd,
                                c);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = intra_bwd_smem();
  err = cudaFuncSetAttribute(mlstm_intra_bwd_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  float* dqf = static_cast<float*>(dq);
  float* dkf = static_cast<float*>(dk);
  float* dvf = static_cast<float*>(dv);
  const dim3 grid(static_cast<unsigned>(nc), static_cast<unsigned>(H),
                  static_cast<unsigned>(B));
  mlstm_intra_bwd_kernel<<<grid, kThreads, smem, st>>>(
      cf(q), cf(k), cf(v), cf(dh), dqf, dkf, dvf, w, bw, S, H, hd, c);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  switch (hd) {
#define BWD_CASE(HD)                                                         \
  case HD:                                                                   \
    err = bwd_carry<HD>(cf(q), cf(k), cf(v), cf(dh), cf(C0), cf(n0), cf(dC), \
                        cf(dn), dqf, dkf, dvf, states, gstates, bound, junk, \
                        carry, w, bw, B, S, H, c, seg, st);                  \
    break;
    BWD_CASE(16)
    BWD_CASE(32)
    BWD_CASE(64)
    BWD_CASE(128)
    BWD_CASE(256)
    BWD_CASE(512)
#undef BWD_CASE
    default: err = cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  mlstm_gates_bwd_kernel<<<static_cast<unsigned>(BH), gate_threads, 0, st>>>(
      cf(f), cf(dm), static_cast<float*>(di), static_cast<float*>(df), w, bw,
      H, static_cast<int>(B), S, c, ntx, nstile);
  return static_cast<int>(cudaGetLastError());
}

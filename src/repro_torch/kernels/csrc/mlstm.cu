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
// Design: three launches a call.
//  1. gates (mlstm_gates_kernel): one warp per (b, h), a lane a chunk,
//     walks each chunk in order (the cumsum and the running max as the
//     plain version takes them), lane 0 the chunks' m in order; it writes
//     rel and M a position and m at each chunk's start. With m0 = -1e30
//     every exp(m - M) is 0, and stays finite.
//  2. intra (mlstm_intra_kernel): one block per (b, h, chunk), all chunks
//     at once (nothing here needs the carry): S (c x c, 128 x 128 in
//     shared memory, transposed) from d-tiles of q and k, each thread an
//     8 x 8 block of it; then sum_s S_ts v_s into h and sum_s S_ts into a
//     scratch row, over e-tiles of v. 2 blocks an SM.
//  3. inter (mlstm_inter_kernel): the carry. A chunk's q or k alone is
//     256 KB at hd = 512 and C of a head 1 MiB, so C's value columns are
//     split into slices of 16: one block per (b, h, slice) keeps its
//     hd x 16 slice of C (32 KB) and its own copy of n in shared memory
//     and walks the chunks in order: q . C and q . n over d-tiles of q,
//     the output h (adding step 2's part), then C and n updated from
//     s-tiles of k and the slice of v. At B = 1 the grid is 4 heads x 32
//     slices = 128 blocks on 132 SMs; each block reads every chunk's q and
//     k (from L2), which the work of a 16-column slice does not hide.
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
constexpr int kThreads = 256;         // intra and inter blocks
constexpr int kDTile = 32;            // d-tile of q and k
constexpr int kETile = 64;            // e-tile of v (intra)
constexpr int kSlice = 16;            // value columns of C a block (inter)
constexpr int kSTile = 16;            // s-tile of k (inter)
constexpr int kStride = kMaxChunk + 4;  // row stride of the transposed S

// Scratch layout (floats): rel, M and qn_intra (B, H, S) each, then m at
// each chunk's start and after the last (B, H, nc + 1).
struct Work {
  float* rel;
  float* Mx;
  float* qni;
  float* mk;
};

// One warp per (b, h); lane l takes chunks l, l + 32, ... Pass 1: each
// chunk's cumsum F_end and max of rel (parked in mk[ch] and Mx[ch c]);
// lane 0 then walks the chunks' m in order; pass 2: each chunk's rel and M
// from its m (the same sums in the same order as pass 1).
__global__ void mlstm_gates_kernel(const float* __restrict__ gi,
                                   const float* __restrict__ gf,
                                   const float* __restrict__ m0,
                                   float* __restrict__ m_out,
                                   float* __restrict__ rel_out,
                                   float* __restrict__ M_out,
                                   float* __restrict__ mk_out, int BH, int H,
                                   long long S, int c) {
  const int bh = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (bh >= BH) return;
  const long long b = bh / H, hh = bh % H;
  const long long nc = S / c;
  const float* ib = gi + b * S * H + hh;
  const float* fb = gf + b * S * H + hh;
  float* rel = rel_out + bh * S;
  float* Mx = M_out + bh * S;
  float* mk = mk_out + bh * (nc + 1);
  for (long long ch = lane; ch < nc; ch += 32) {
    float F = 0.f, cm = -INFINITY;
    for (int t = 0; t < c; ++t) {
      const long long s = ch * c + t;
      F += log_sigmoid(fb[s * H]);
      cm = fmaxf(cm, ib[s * H] - F);
    }
    mk[ch] = F;
    Mx[ch * c] = cm;
  }
  __syncwarp();
  if (lane == 0) {
    float m = m0[bh];
    for (long long ch = 0; ch < nc; ++ch) {
      const float F_end = mk[ch], R = Mx[ch * c];
      mk[ch] = m;
      m = F_end + fmaxf(m, R);
    }
    mk[nc] = m;
    m_out[bh] = m;
  }
  __syncwarp();
  for (long long ch = lane; ch < nc; ch += 32) {
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

// One block per (slice, h, b), walking the chunks in order. Shared memory:
// Cs (HD x kSlice), ns (HD), the q d-tile (kDTile x kMaxChunk, [d][t]) or
// the k s-tile (kSTile x HD) with the weighted v slice (kSTile x kSlice),
// the chunk's inter_t, w_s and qn_t, and a reduction row.
template <int HD>
__global__ void __launch_bounds__(kThreads)
mlstm_inter_kernel(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v, const float* __restrict__ C0,
                   const float* __restrict__ n0, float* __restrict__ h,
                   float* __restrict__ C_out, float* __restrict__ n_out,
                   Work w, long long S, int H, int c) {
  constexpr int kRowsB = HD / 16;        // rows of C a thread (update)
  constexpr int kNPer = (HD + kThreads - 1) / kThreads;
  extern __shared__ float sm[];
  float* Cs = sm;                                      // HD x kSlice
  float* ns = Cs + HD * kSlice;                        // HD
  float* tile = ns + HD;
  float* qs = tile;                                    // kDTile x kMaxChunk
  float* ks = tile;                                    // kSTile x HD
  float* vw = tile + kSTile * HD;                      // kSTile x kSlice
  const int tile_floats = (kDTile * kMaxChunk > kSTile * (HD + kSlice))
                              ? kDTile * kMaxChunk
                              : kSTile * (HD + kSlice);
  float* inter = tile + tile_floats;                   // kMaxChunk
  float* wgt = inter + kMaxChunk;                      // kMaxChunk
  float* qn = wgt + kMaxChunk;                         // 2 x kMaxChunk
  const int tid = threadIdx.x;
  const int e = tid % kSlice, g = tid / kSlice;        // 16 groups
  const long long sl = blockIdx.x, hh = blockIdx.y, b = blockIdx.z;
  const long long bh = b * H + hh;
  const int e0 = static_cast<int>(sl) * kSlice;
  const long long row_stride = static_cast<long long>(H) * HD;
  const long long nc = S / c;
  for (int x = tid; x < HD * kSlice; x += kThreads) {
    const int d = x / kSlice, ee = x % kSlice;
    Cs[x] = C0[bh * HD * HD + static_cast<long long>(d) * HD + e0 + ee];
  }
  for (int d = tid; d < HD; d += kThreads) ns[d] = n0[bh * HD + d];
  for (long long ch = 0; ch < nc; ++ch) {
    const long long lo = ch * c;
    const float mk = w.mk[bh * (nc + 1) + ch];
    const float M_end = w.Mx[bh * S + lo + c - 1];
    const float decay = expf(mk - M_end);
    __syncthreads();
    for (int t = tid; t < kMaxChunk; t += kThreads) {
      inter[t] = t < c ? expf(mk - w.Mx[bh * S + lo + t]) : 0.f;
      wgt[t] = t < c ? expf(w.rel[bh * S + lo + t] - M_end) : 0.f;
    }
    // q . C (rows t = g * 8 + i, column e) and q . n (row tid % 128, the
    // half tid / 128 of each d-tile)
    const float* qb = q + (b * S + lo) * row_stride + hh * HD;
    float acc[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[i] = 0.f;
    float qnp = 0.f;
    const int qt = tid % kMaxChunk, qhalf = tid / kMaxChunk;
    for (int d0 = 0; d0 < HD; d0 += kDTile) {
      __syncthreads();
      for (int x = tid; x < kMaxChunk * kDTile; x += kThreads) {
        const int t = x % kMaxChunk, d = x / kMaxChunk;
        qs[d * kMaxChunk + t] =
            (t < c && d0 + d < HD) ? qb[t * row_stride + d0 + d] : 0.f;
      }
      __syncthreads();
      const int dn = HD - d0 < kDTile ? HD - d0 : kDTile;
#pragma unroll 4
      for (int d = 0; d < dn; ++d) {
        const float cv = Cs[(d0 + d) * kSlice + e];
        const float4 qa = reinterpret_cast<const float4*>(
            qs + d * kMaxChunk + g * 8)[0];
        const float4 qc = reinterpret_cast<const float4*>(
            qs + d * kMaxChunk + g * 8)[1];
        acc[0] += qa.x * cv;
        acc[1] += qa.y * cv;
        acc[2] += qa.z * cv;
        acc[3] += qa.w * cv;
        acc[4] += qc.x * cv;
        acc[5] += qc.y * cv;
        acc[6] += qc.z * cv;
        acc[7] += qc.w * cv;
      }
      for (int d = qhalf; d < dn; d += 2)
        qnp += qs[d * kMaxChunk + qt] * ns[d0 + d];
    }
    qn[qhalf * kMaxChunk + qt] = qnp;
    __syncthreads();
    // the output rows of this slice: step 2's part added
    float* hb = h + (b * S + lo) * row_stride + hh * HD + e0 + e;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int t = g * 8 + i;
      if (t < c) {
        const float it = inter[t];
        const float qnt = it * (qn[t] + qn[kMaxChunk + t]) +
                          w.qni[bh * S + lo + t];
        const float num = it * acc[i] + hb[t * row_stride];
        hb[t * row_stride] = num / fmaxf(fabsf(qnt), 1.f);
      }
    }
    // C' = decay C + sum_s w_s k_s v_s^T over s-tiles; n' likewise. Thread
    // (e, g) holds rows d = g * kRowsB + j of column e.
    const float* kb = k + (b * S + lo) * row_stride + hh * HD;
    const float* vb = v + (b * S + lo) * row_stride + hh * HD + e0;
    float up[kRowsB];
#pragma unroll
    for (int j = 0; j < kRowsB; ++j) up[j] = 0.f;
    float nup[kNPer];
#pragma unroll
    for (int j = 0; j < kNPer; ++j) nup[j] = 0.f;
    for (int s0 = 0; s0 < c; s0 += kSTile) {
      __syncthreads();
      for (int x = tid; x < kSTile * (HD / 4); x += kThreads) {
        const int s = x / (HD / 4), d4 = x % (HD / 4);
        float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
        if (s0 + s < c)
          val = reinterpret_cast<const float4*>(kb + (s0 + s) * row_stride)[d4];
        reinterpret_cast<float4*>(ks + s * HD)[d4] = val;
      }
      for (int x = tid; x < kSTile * kSlice; x += kThreads) {
        const int s = x / kSlice, ee = x % kSlice;
        vw[x] = s0 + s < c ? wgt[s0 + s] * vb[(s0 + s) * row_stride + ee]
                           : 0.f;
      }
      __syncthreads();
#pragma unroll 2
      for (int s = 0; s < kSTile; ++s) {
        const float vv = vw[s * kSlice + e];
        const float* kr = ks + s * HD + g * kRowsB;
        if constexpr (kRowsB % 4 == 0) {
#pragma unroll
          for (int j = 0; j < kRowsB; j += 4) {
            const float4 kk = *reinterpret_cast<const float4*>(kr + j);
            up[j] += kk.x * vv;
            up[j + 1] += kk.y * vv;
            up[j + 2] += kk.z * vv;
            up[j + 3] += kk.w * vv;
          }
        } else {
#pragma unroll
          for (int j = 0; j < kRowsB; ++j) up[j] += kr[j] * vv;
        }
      }
#pragma unroll
      for (int j = 0; j < kNPer; ++j) {
        const int d = tid + j * kThreads;
        if (d < HD) {
          float sum = 0.f;
          for (int s = 0; s < kSTile && s0 + s < c; ++s)
            sum += wgt[s0 + s] * ks[s * HD + d];
          nup[j] += sum;
        }
      }
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kRowsB; ++j) {
      float* cp = Cs + (g * kRowsB + j) * kSlice + e;
      *cp = decay * *cp + up[j];
    }
#pragma unroll
    for (int j = 0; j < kNPer; ++j) {
      const int d = tid + j * kThreads;
      if (d < HD) ns[d] = decay * ns[d] + nup[j];
    }
  }
  __syncthreads();
  for (int x = tid; x < HD * kSlice; x += kThreads) {
    const int d = x / kSlice, ee = x % kSlice;
    C_out[bh * HD * HD + static_cast<long long>(d) * HD + e0 + ee] = Cs[x];
  }
  if (sl == 0)
    for (int d = tid; d < HD; d += kThreads) n_out[bh * HD + d] = ns[d];
}

size_t intra_smem() {
  return sizeof(float) *
         (kMaxChunk * kStride + 2 * kDTile * kMaxChunk + 2 * kMaxChunk);
}

template <int HD>
size_t inter_smem() {
  const int tile = (kDTile * kMaxChunk > kSTile * (HD + kSlice))
                       ? kDTile * kMaxChunk
                       : kSTile * (HD + kSlice);
  return sizeof(float) * (HD * kSlice + HD + tile + 4 * kMaxChunk);
}

template <int HD>
cudaError_t launch_inter(const float* q, const float* k, const float* v,
                         const float* C0, const float* n0, float* h,
                         float* C, float* n, Work w, long long B, long long S,
                         int H, int c, cudaStream_t st) {
  const size_t smem = inter_smem<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      mlstm_inter_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(HD / kSlice, static_cast<unsigned>(H),
                  static_cast<unsigned>(B));
  mlstm_inter_kernel<HD><<<grid, kThreads, smem, st>>>(q, k, v, C0, n0, h, C,
                                                       n, w, S, H, c);
  return cudaGetLastError();
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
// repro_mlstm_chunkwise_work_floats floats.
extern "C" int repro_mlstm_chunkwise(const void* q, const void* k,
                                     const void* v, const void* i,
                                     const void* f, const void* C0,
                                     const void* n0, const void* m0, void* h,
                                     void* C, void* n, void* m, void* work,
                                     long long B, long long S, int H, int hd,
                                     int c, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0) return static_cast<int>(cudaGetLastError());
  if (c < 1 || c > kMaxChunk || S % c) return static_cast<int>(
      cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* wf = static_cast<float*>(work);
  const long long BH = B * H;
  const Work w{wf, wf + BH * S, wf + 2 * BH * S, wf + 3 * BH * S};
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  float* hf = static_cast<float*>(h);
  mlstm_gates_kernel<<<static_cast<unsigned>((BH + 3) / 4), 128, 0, st>>>(
      static_cast<const float*>(i), static_cast<const float*>(f),
      static_cast<const float*>(m0), static_cast<float*>(m), w.rel, w.Mx,
      w.mk, static_cast<int>(BH), H, S, c);
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
  switch (hd) {
    case 16: err = launch_inter<16>(qf, kf, vf, C0f, n0f, hf, Cf, nf, w, B, S, H, c, st); break;
    case 32: err = launch_inter<32>(qf, kf, vf, C0f, n0f, hf, Cf, nf, w, B, S, H, c, st); break;
    case 64: err = launch_inter<64>(qf, kf, vf, C0f, n0f, hf, Cf, nf, w, B, S, H, c, st); break;
    case 128: err = launch_inter<128>(qf, kf, vf, C0f, n0f, hf, Cf, nf, w, B, S, H, c, st); break;
    case 256: err = launch_inter<256>(qf, kf, vf, C0f, n0f, hf, Cf, nf, w, B, S, H, c, st); break;
    case 512: err = launch_inter<512>(qf, kf, vf, C0f, n0f, hf, Cf, nf, w, B, S, H, c, st); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// slstm.cu — the xLSTM sLSTM recurrence on Hopper (kernel B14,
// slstm_scan) and its backward (kernel B17, slstm_scan_bwd).
//
// Neither replaces a Pallas kernel: the JAX package scans the cell in jnp
// (repro/models/lm.py slstm_block, :864-908) and differentiates the scan
// with autodiff. B14 was added because the scan as eager PyTorch is about
// 12 launches a step, and the prefill of xlstm-1.3b makes 6 layers x
// 32,768 steps; B17 because its autograd is twice that. B17 is bound as
// B14 (2 R^2 f32 operations a row and step, gpre_{t+1} rz^T) and is a
// chain like it: its design is B14's chain run backwards (see below). The contract is that of
// repro_torch/kernels/ref.py slstm_scan: z, i, f, o (B, S, R) f32
// contiguous (pre-activations; o the output gate), rz (R, R) bf16 or f32,
// the state c0, n0, h0, m0 (B, R) f32. Per step t and column j:
//   z = tanh(z_t + (h_{t-1} rz)_j),  lf = logsigmoid(f_t),
//   m' = max(lf + m, i_t),  ig = exp(i_t - m'),  fg = exp(lf + m - m'),
//   c = fg c + ig z,  n = fg n + ig,  h_t = o_t c / max(n, 1),  m = m'.
// Writes hs (B, S, R) (h_t of every step) and the final c, n, h, m. A bf16
// rz is widened value by value (exactly), as JAX's astype(float32). Every
// sum runs in one fixed order, whatever the timing: a call gives the same
// bits every time. That order differs from torch.matmul's, so the kernel
// is held to the plain version within ref.xlstm_tol, not bit for bit.
//
// Bound: 2 R^2 f32 operations a row and step (h_{t-1} rz), and the bytes
// of z, i, f, o, hs (20 B S R) and rz once. At the prefill (B = 1, S =
// 32,768, R = 2048) the operations take 4.1 ms at 67 TFLOP/s; but each
// step needs the whole h_{t-1}, so the S steps are a chain, and a step
// costs at least one exchange of h across the card.
//
// Two kernels, one a call:
//
// S > 1, slstm_chain_kernel: a persistent grid of ceil(R / 16) blocks of
// 256 threads, launched cooperatively (cudaLaunchCooperativeKernel refuses
// a grid that is not all resident, so a block that spins on another always
// has it running). Block g owns columns [16 g, 16 g + 16). Its 16
// half-warps ("groups") split the rows of rz: thread (group q, column c)
// holds rows [q RPG, q RPG + RPG) of column c in registers for the whole
// call (RPG = 128 at R = 2048). h_t leaves the block as packed 8-byte words
// (h's bits, a tag) in an exchange ring of two steps, (2, B, R), which the
// launcher zeroes; each word is one aligned 64-bit store (single-copy
// atomic), so a reader that sees the tag of the step it waits for sees that
// step's h: no fence, no atomic, no counter. Reads are ld.relaxed.gpu
// (coherent at L2, never a stale L1 line). Two slots are enough: no block
// can write h_{t+1} before every block has read all of h_{t-1} (it needs
// all of h_t, and a block makes its h_t only after its reads of h_{t-1}),
// so slot t % 2 holds step t - 2 or step t when a reader looks for step t.
// The tag only has to tell t from t - 2 and from the zeroed ring: 1 + ((t
// >> 1) & 1), which wraps every 4 steps. A group polls exactly the rows it
// multiplies (at R = 2048 its thread polls every 16th row, 8 producers'
// words, all 8 loads in flight at once) and starts its partial
// products as soon as they have come, while other groups still wait; a
// wait that outlasts 2**24 polls traps (a fault, not a hang). Each
// thread sums its rows in 8 interleaved partial sums (a fixed order), 16
// threads then sum the 16 groups' partials of their column in order and
// step the cell; its gate terms (m', ig, fg) are formed before the wait,
// and the next step's z, i, f, o are loaded a step ahead. Rows b are
// stepped in tiles of 4 (B > 1: rows of a tile together, tiles in turn).
// Needs R <= 2048 (rz's rows in registers).
//
// S == 1, slstm_step_kernel (decode): no chain, so no cooperative launch
// and no ring. One launch forms the (B, R) x (R, R) product and the cell:
// a block per 32 rows x 64 columns; its four parts of 128 threads each
// take a quarter of the R rows of rz in k-tiles of 32 (h transposed and rz
// widened to f32 in shared memory, the next tile loaded into registers
// while the current one is multiplied), each thread a 4 x 4 tile of
// outputs; part 0 adds the other parts' sums in a fixed order and steps
// the cell. Each rz slice is read once a block and reused across its 32
// rows.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kCols = 16;                  // columns a chain block
constexpr int kGroups = 16;                // row groups (half-warps)
constexpr int kThreads = kCols * kGroups;  // 256
constexpr int kRowTile = 4;                // rows b a chain block steps at once
constexpr int kMaxR = 2048;                // chain: rz rows in registers
// polls of one word before the chain gives up (seconds: a producer that
// never comes is a fault to report, not a hang)
constexpr unsigned kMaxSpins = 1u << 24;

__device__ __forceinline__ float log_sigmoid(float x) {
  return fminf(x, 0.f) - log1pf(expf(-fabsf(x)));
}

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// The exchange word of step t: h's bits low, the tag high.
__device__ __forceinline__ unsigned step_tag(long long t) {
  return 1u + static_cast<unsigned>((t >> 1) & 1);
}

__device__ __forceinline__ void publish(unsigned long long* p, float h,
                                        unsigned tag) {
  const unsigned long long w =
      (static_cast<unsigned long long>(tag) << 32) | __float_as_uint(h);
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(w)
               : "memory");
}

__device__ __forceinline__ unsigned long long peek(
    const unsigned long long* p) {
  unsigned long long w;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];"
               : "=l"(w)
               : "l"(p)
               : "memory");
  return w;
}

// The cell's terms that do not need h_{t-1}: m', ig, fg.
struct Gate {
  float m_new, ig, fg;
};

__device__ __forceinline__ Gate gate_terms(float it, float ft, float m) {
  const float lf = log_sigmoid(ft);
  const float m_new = fmaxf(lf + m, it);
  return {m_new, expf(it - m_new), expf(lf + m - m_new)};
}

// d max(a, b) / da with JAX's (and torch.maximum's) halves at a tie
__device__ __forceinline__ float tie_share(float a, float b) {
  return a > b ? 1.f : (a == b ? 0.5f : 0.f);
}

// One (row, step) of the cell from pre = (h_{t-1} rz)_j; updates c and n
// and gives tanh(z + pre) in zz.
__device__ __forceinline__ float cell(float zt, float ot, float pre, Gate g,
                                      float& c, float& n, float& zz) {
  zz = tanhf(zt + pre);
  c = g.fg * c + g.ig * zz;
  n = g.fg * n + g.ig;
  return ot * c / fmaxf(n, 1.f);
}

// Under grad the forward keeps each step's c, n, m' and zz, (4, B, S, R)
// (`kept`, null otherwise), for the backward (B17).
__device__ __forceinline__ void keep_step(float* kept, long long at,
                                          long long BSR, float c, float n,
                                          float m, float zz) {
  if (kept == nullptr) return;
  kept[at] = c;
  kept[BSR + at] = n;
  kept[2 * BSR + at] = m;
  kept[3 * BSR + at] = zz;
}

// ---------------------------------------------------------------------------
// S > 1: the chain
// ---------------------------------------------------------------------------
// Shared memory: hsm (kRowTile x 16 RPG: the rows of h_{t-1} of the tile),
// part (2 x kRowTile x kCols x kGroups: the groups' partial sums, by the
// parity of the (step, tile) iteration), then the state c, n, m of the
// block's columns for every row (3 x B x kCols). One __syncthreads an
// iteration: a group writes part[it & 1] again at iteration it + 2 only
// after the barrier of it + 1, which the cell threads reach after reading
// it; each group reads only the rows of hsm it wrote itself.
template <typename T, int RPG>
__global__ void __launch_bounds__(kThreads, 1)
slstm_chain_kernel(const float* __restrict__ z, const float* __restrict__ gi,
                   const float* __restrict__ gf, const float* __restrict__ go,
                   const T* __restrict__ rz, const float* __restrict__ c0,
                   const float* __restrict__ n0, const float* __restrict__ h0,
                   const float* __restrict__ m0, float* __restrict__ hs,
                   float* __restrict__ c_out, float* __restrict__ n_out,
                   float* __restrict__ h_out, float* __restrict__ m_out,
                   float* __restrict__ kept, unsigned long long* ring, int B,
                   long long S, int R) {
  constexpr int kRows = kGroups * RPG;           // rows of h kept (>= R)
  constexpr int kPer = (RPG + 15) / 16;          // rows a thread polls
  extern __shared__ __align__(16) float smem[];
  float* hsm = smem;                             // kRowTile x kRows
  float* part = hsm + kRowTile * kRows;  // 2 x kRowTile x kCols x kGroups
  float* cs = part + 2 * kRowTile * kCols * kGroups;  // B x kCols
  float* ns = cs + B * kCols;
  float* ms = ns + B * kCols;
  const int tid = threadIdx.x;
  const int col = tid % kCols, grp = tid / kCols;
  const int j0 = blockIdx.x * kCols;
  const int j = j0 + col;
  const bool jok = j < R;
  const int row0 = grp * RPG;
  float w[RPG];
#pragma unroll
  for (int r = 0; r < RPG; ++r)
    w[r] = (jok && row0 + r < R)
               ? widen(rz[static_cast<long long>(row0 + r) * R + j])
               : 0.f;
  for (int x = tid; x < kRowTile * kRows; x += kThreads) hsm[x] = 0.f;
  for (int x = tid; x < B * kCols; x += kThreads) {
    const int b = x / kCols, jj = j0 + x % kCols;
    const long long at = static_cast<long long>(b) * R + jj;
    const bool in = jj < R;
    cs[x] = in ? c0[at] : 0.f;
    ns[x] = in ? n0[at] : 0.f;
    ms[x] = in ? m0[at] : 0.f;
  }
  // the cell threads: (row bb of the tile, column col) for tid < 64
  const int bb_cell = tid / kCols;
  const bool cell_thread = tid < kRowTile * kCols && jok;
  const long long RS = static_cast<long long>(R) * S;
  auto load_gates = [&](long long t, int b0) {
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    const int b = b0 + bb_cell;
    if (cell_thread && t < S && b < B) {
      const long long at = b * RS + t * R + j;
      v = make_float4(z[at], gi[at], gf[at], go[at]);
    }
    return v;
  };
  float4 next = load_gates(0, 0);
  __syncthreads();
  // the rows this thread polls: rbase + 16 k, k < kPer (RPG < 32: one
  // row). Every 16th row: the kPer loads of a poll go to kPer producers'
  // lines; kPer strong loads of one line serialize (consecutive rows took
  // 2.5x as long a step on the H100)
  constexpr int kStride = RPG < 32 ? 1 : 16;
  const int rbase = row0 + (tid & 15);
  const bool polls = rbase - row0 < RPG && rbase < R;
  int it = 0;                       // (step, tile) iterations: part's buffer
  for (long long t = 0; t < S; ++t) {
    const unsigned tag_in = t > 0 ? step_tag(t - 1) : 0u;
    const unsigned tag_out = step_tag(t);
    const long long BR = static_cast<long long>(B) * R;
    const unsigned long long* slot_in = ring + ((t - 1) & 1) * BR;
    unsigned long long* slot_out = ring + (t & 1) * BR;
    for (int b0 = 0; b0 < B; b0 += kRowTile) {
      const int nb = B - b0 < kRowTile ? B - b0 : kRowTile;
      const float4 gates = next;
      next = b0 + kRowTile < B ? load_gates(t, b0 + kRowTile)
                               : load_gates(t + 1, 0);
      Gate g{0.f, 0.f, 0.f};
      const int sidx = (b0 + bb_cell) * kCols + col;
      if (cell_thread && bb_cell < nb)
        g = gate_terms(gates.y, gates.z, ms[sidx]);
      // h_{t-1} of this group's rows, each row of the tile: the thread's
      // kPer rows (kPer producers'), all polled at once until every tag
      // is the step's
      for (int bb = 0; bb < nb; ++bb) {
        const long long b = b0 + bb;
        float* hrow = hsm + bb * kRows;
        if (!polls) continue;
        if (t == 0) {
#pragma unroll
          for (int k = 0; k < kPer; ++k)
            if (rbase + k * kStride < R)
              hrow[rbase + k * kStride] = h0[b * R + rbase + k * kStride];
          continue;
        }
        const unsigned long long* src = slot_in + b * R + rbase;
        unsigned long long got[kPer];
        for (unsigned spins = 0, wait = 1; wait; ++spins) {
          if (spins == kMaxSpins) __trap();
          wait = 0;
#pragma unroll
          for (int k = 0; k < kPer; ++k)
            if (rbase + k * kStride < R) {
              got[k] = peek(src + k * kStride);
              wait |= static_cast<unsigned>(got[k] >> 32) != tag_in;
            }
        }
#pragma unroll
        for (int k = 0; k < kPer; ++k)
          if (rbase + k * kStride < R)
            hrow[rbase + k * kStride] =
                __uint_as_float(static_cast<unsigned>(got[k]));
      }
      __syncwarp();
      // partial products of the group's rows, 8 interleaved sums
      for (int bb = 0; bb < nb; ++bb) {
        const float4* hv =
            reinterpret_cast<const float4*>(hsm + bb * kRows + row0);
        float a[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int q = 0; q < RPG / 4; ++q) {
          const float4 h4 = hv[q];
          float* s = a + 4 * (q & 1);
          s[0] += h4.x * w[4 * q];
          s[1] += h4.y * w[4 * q + 1];
          s[2] += h4.z * w[4 * q + 2];
          s[3] += h4.w * w[4 * q + 3];
        }
        part[((it & 1) * kRowTile + bb) * kCols * kGroups + col * kGroups +
             grp] =
            ((a[0] + a[4]) + (a[1] + a[5])) + ((a[2] + a[6]) + (a[3] + a[7]));
      }
      __syncthreads();
      if (cell_thread && bb_cell < nb) {
        const float4* p4 = reinterpret_cast<const float4*>(
            part + ((it & 1) * kRowTile + bb_cell) * kCols * kGroups +
            col * kGroups);
        const float4 p0 = p4[0], p1 = p4[1], p2 = p4[2], p3 = p4[3];
        const float pre = (((p0.x + p0.y) + (p0.z + p0.w)) +
                           ((p1.x + p1.y) + (p1.z + p1.w))) +
                          (((p2.x + p2.y) + (p2.z + p2.w)) +
                           ((p3.x + p3.y) + (p3.z + p3.w)));
        float c = cs[sidx], n = ns[sidx], zz;
        const float h = cell(gates.x, gates.w, pre, g, c, n, zz);
        const long long b = b0 + bb_cell;
        if (t + 1 < S) publish(slot_out + b * R + j, h, tag_out);
        keep_step(kept, b * RS + t * R + j, B * RS, c, n, g.m_new, zz);
        cs[sidx] = c;
        ns[sidx] = n;
        ms[sidx] = g.m_new;
        __stcs(hs + b * RS + t * R + j, h);
        if (t == S - 1) {
          c_out[b * R + j] = c;
          n_out[b * R + j] = n;
          h_out[b * R + j] = h;
          m_out[b * R + j] = g.m_new;
        }
      }
      ++it;
    }
  }
}

template <int RPG>
size_t chain_smem(int B) {
  return sizeof(float) * (static_cast<size_t>(kRowTile) * kGroups * RPG +
                          2 * kRowTile * kCols * kGroups +
                          3 * static_cast<size_t>(B) * kCols);
}

// rows of rz a thread holds: the power of two >= R / 16, at least 4
int chain_rpg(int R) {
  int rpg = 4;
  while (rpg * kGroups < R) rpg *= 2;
  return rpg;
}

template <typename T, int RPG>
cudaError_t launch_chain(const float* z, const float* i, const float* f,
                         const float* o, const T* rz, const float* c0,
                         const float* n0, const float* h0, const float* m0,
                         float* hs, float* c, float* n, float* h, float* m,
                         float* kept, unsigned long long* ring, int B,
                         long long S, int R, cudaStream_t st) {
  const size_t smem = chain_smem<RPG>(B);
  cudaError_t err = cudaFuncSetAttribute(
      slstm_chain_kernel<T, RPG>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  err = cudaMemsetAsync(ring, 0, sizeof(unsigned long long) * 2 *
                                     static_cast<size_t>(B) * R, st);
  if (err != cudaSuccess) return err;
  const dim3 grid((R + kCols - 1) / kCols), block(kThreads);
  void* args[] = {&z, &i, &f, &o, &rz, &c0, &n0, &h0, &m0, &hs, &c, &n,
                  &h, &m, &kept, &ring, &B, &S, &R};
  return cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(slstm_chain_kernel<T, RPG>), grid, block,
      args, smem, st);
}

template <typename T>
cudaError_t chain(const float* z, const float* i, const float* f,
                  const float* o, const T* rz, const float* c0,
                  const float* n0, const float* h0, const float* m0, float* hs,
                  float* c, float* n, float* h, float* m, float* kept,
                  unsigned long long* ring, int B, long long S, int R,
                  cudaStream_t st) {
  switch (chain_rpg(R)) {
#define CHAIN_CASE(P)                                                        \
  case P:                                                                    \
    return launch_chain<T, P>(z, i, f, o, rz, c0, n0, h0, m0, hs, c, n, h, m, \
                              kept, ring, B, S, R, st);
    CHAIN_CASE(4)
    CHAIN_CASE(8)
    CHAIN_CASE(16)
    CHAIN_CASE(32)
    CHAIN_CASE(64)
    CHAIN_CASE(128)
#undef CHAIN_CASE
    default:
      return cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// S == 1: one step, a product and the cell
// ---------------------------------------------------------------------------
constexpr int kStepM = 32;        // rows b a block
constexpr int kStepN = 64;        // columns j a block
constexpr int kStepK = 32;        // k-tile
constexpr int kParts = 4;         // parts of the R rows of rz a block
constexpr int kPart = 128;        // threads of a part
constexpr int kHLd = kStepM + 4;  // row stride of h transposed ([k][m])
constexpr int kPartFloats = kStepK * kHLd + kStepK * kStepN;

// Dynamic shared memory, each part: hT (kStepK x kHLd) then rzs (kStepK x
// kStepN), f32; after the products parts 1-3 leave their sums there
// (kStepM x kStepN) for part 0.
template <typename T>
__global__ void __launch_bounds__(kParts * kPart)
slstm_step_kernel(const float* __restrict__ z, const float* __restrict__ gi,
                  const float* __restrict__ gf, const float* __restrict__ go,
                  const T* __restrict__ rz, const float* __restrict__ c0,
                  const float* __restrict__ n0, const float* __restrict__ h0,
                  const float* __restrict__ m0, float* __restrict__ hs,
                  float* __restrict__ c_out, float* __restrict__ n_out,
                  float* __restrict__ h_out, float* __restrict__ m_out,
                  float* __restrict__ kept, int B, int R) {
  extern __shared__ __align__(16) float step_smem[];
  const int part = threadIdx.x / kPart, t = threadIdx.x % kPart;
  const int tx = t % 16, ty = t / 16;            // cols tx*4.., rows ty*4..
  const int m_base = blockIdx.y * kStepM, n_base = blockIdx.x * kStepN;
  const int nkt = (R + kStepK - 1) / kStepK;
  const int per = (nkt + kParts - 1) / kParts;
  const int kt0 = part * per < nkt ? part * per : nkt;
  const int kt1 = kt0 + per < nkt ? kt0 + per : nkt;
  float* myhT = step_smem + part * kPartFloats;
  float* myrz = myhT + kStepK * kHLd;
  // staging: h (kStepM x kStepK: 8 a thread, row e / 32, k e % 32) and rz
  // (kStepK x kStepN: 16 a thread, k e / 64, column e % 64)
  float hreg[8], rreg[16];
  auto fetch = [&](int kt) {
    const int k0 = kt * kStepK;
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int e = t + kPart * q, row = e / kStepK, kk = e % kStepK;
      const int b = m_base + row, k = k0 + kk;
      hreg[q] = (b < B && k < R) ? h0[static_cast<long long>(b) * R + k] : 0.f;
    }
#pragma unroll
    for (int q = 0; q < 16; ++q) {
      const int e = t + kPart * q, kk = e / kStepN, jj = e % kStepN;
      const int k = k0 + kk, jc = n_base + jj;
      rreg[q] = (k < R && jc < R)
                    ? widen(rz[static_cast<long long>(k) * R + jc])
                    : 0.f;
    }
  };
  auto stash = [&]() {
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int e = t + kPart * q, row = e / kStepK, kk = e % kStepK;
      myhT[kk * kHLd + row] = hreg[q];
    }
#pragma unroll
    for (int q = 0; q < 16; ++q) myrz[t + kPart * q] = rreg[q];
  };
  auto part_sync = [&]() {
    asm volatile("bar.sync %0, %1;" ::"r"(1 + part), "r"(kPart) : "memory");
  };
  float acc[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) acc[a][b] = 0.f;
  if (kt0 < kt1) fetch(kt0);
  for (int kt = kt0; kt < kt1; ++kt) {
    stash();
    part_sync();
    if (kt + 1 < kt1) fetch(kt + 1);
#pragma unroll 8
    for (int kk = 0; kk < kStepK; ++kk) {
      const float4 a =
          *reinterpret_cast<const float4*>(myhT + kk * kHLd + ty * 4);
      const float4 b =
          *reinterpret_cast<const float4*>(myrz + kk * kStepN + tx * 4);
      const float av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] += av[r] * bv[c];
    }
    part_sync();
  }
  __syncthreads();
  if (part > 0) {
#pragma unroll
    for (int r = 0; r < 4; ++r)
      *reinterpret_cast<float4*>(myhT + (ty * 4 + r) * kStepN + tx * 4) =
          make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
  }
  __syncthreads();
  if (part > 0) return;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int b = m_base + ty * 4 + r;
    if (b >= B) break;
    float o[kParts][4];
#pragma unroll
    for (int p = 1; p < kParts; ++p) {
      const float4 o4 = *reinterpret_cast<const float4*>(
          step_smem + p * kPartFloats + (ty * 4 + r) * kStepN + tx * 4);
      o[p][0] = o4.x; o[p][1] = o4.y; o[p][2] = o4.z; o[p][3] = o4.w;
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int jc = n_base + tx * 4 + c;
      if (jc >= R) break;
      const long long at = static_cast<long long>(b) * R + jc;
      const float pre = (acc[r][c] + o[1][c]) + (o[2][c] + o[3][c]);
      const Gate g = gate_terms(gi[at], gf[at], m0[at]);
      float cc = c0[at], nn = n0[at], zz;
      const float h = cell(z[at], go[at], pre, g, cc, nn, zz);
      keep_step(kept, at, static_cast<long long>(B) * R, cc, nn, g.m_new, zz);
      hs[at] = h;
      c_out[at] = cc;
      n_out[at] = nn;
      h_out[at] = h;
      m_out[at] = g.m_new;
    }
  }
}

template <typename T>
cudaError_t step(const float* z, const float* i, const float* f,
                 const float* o, const T* rz, const float* c0, const float* n0,
                 const float* h0, const float* m0, float* hs, float* c,
                 float* n, float* h, float* m, float* kept, int B, int R,
                 cudaStream_t st) {
  const size_t smem = sizeof(float) * kParts * kPartFloats;
  const cudaError_t err = cudaFuncSetAttribute(
      slstm_step_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((R + kStepN - 1) / kStepN, (B + kStepM - 1) / kStepM);
  slstm_step_kernel<T><<<grid, kParts * kPart, smem, st>>>(
      z, i, f, o, rz, c0, n0, h0, m0, hs, c, n, h, m, kept, B, R);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// B17: the backward, the chain run in reverse
// ---------------------------------------------------------------------------
// The chain of slstm_chain_kernel walked from t = S - 1 down to 0, with rz
// transposed: block g owns indices j of [16 g, 16 g + 16) and thread (group
// q, index c) holds row j of rz, columns [q RPG, q RPG + RPG), in registers.
// Per step, gh_t = dhs_t + gpre_{t+1} rz^T (row b: gh_t[j] = sum_r
// gpre_{t+1}[r] rz[j, r]; gpre_S = 0, and the final state's dh joins
// gh_{S-1}) is formed from gpre_{t+1}, exchanged through the forward's ring
// of tagged 8-byte words (the tag of iteration u = S - 1 - t), and the cell
// steps back from the forward's kept c, n, m', zz (its c, n, m at t - 1 are
// the entering ones; c0, n0, m0 at t = 0):
//   do = gh c / N,  dc = dc' + gh o / N,  N = max(n, 1),
//   dn = dn' + tie(n, 1) (-gh o c / N^2),
//   dfg = dc c_{t-1} + dn n_{t-1},  dig = dc zz + dn,
//   gpre_t = dz_t = dc ig (1 - zz^2),  (dc', dn') <- fg (dc, dn),
//   dm' = dm'_{t+1} - dig ig - dfg fg, split at max(lf + m, i) (halves at a
//   tie): di = dig ig + (1 - s) dm', dlf = dfg fg + s dm', dm = dlf,
//   df = dlf sigmoid(-f).
// gate_terms recomputes m', ig and fg as the forward formed them. Every sum
// runs in one fixed order: a call gives the same bits every time.
template <typename T, int RPG>
__global__ void __launch_bounds__(kThreads, 1)
slstm_chain_bwd_kernel(const float* __restrict__ gi,
                       const float* __restrict__ gf,
                       const float* __restrict__ go, const T* __restrict__ rz,
                       const float* __restrict__ c0,
                       const float* __restrict__ n0,
                       const float* __restrict__ m0,
                       const float* __restrict__ kept,
                       const float* __restrict__ dhs,
                       const float* __restrict__ dc_T,
                       const float* __restrict__ dn_T,
                       const float* __restrict__ dh_T,
                       const float* __restrict__ dm_T, float* __restrict__ dz,
                       float* __restrict__ di, float* __restrict__ df,
                       float* __restrict__ dout, unsigned long long* ring,
                       int B, long long S, int R) {
  constexpr int kRows = kGroups * RPG;
  constexpr int kPer = (RPG + 15) / 16;
  extern __shared__ __align__(16) float smem[];
  float* gsm = smem;                             // kRowTile x kRows
  float* part = gsm + kRowTile * kRows;  // 2 x kRowTile x kCols x kGroups
  float* dcs = part + 2 * kRowTile * kCols * kGroups;  // B x kCols
  float* dns = dcs + B * kCols;
  float* dms = dns + B * kCols;
  const int tid = threadIdx.x;
  const int col = tid % kCols, grp = tid / kCols;
  const int j0 = blockIdx.x * kCols;
  const int j = j0 + col;
  const bool jok = j < R;
  const int row0 = grp * RPG;
  float w[RPG];
#pragma unroll
  for (int r = 0; r < RPG; ++r)
    w[r] = (jok && row0 + r < R)
               ? widen(rz[static_cast<long long>(j) * R + row0 + r])
               : 0.f;
  for (int x = tid; x < kRowTile * kRows; x += kThreads) gsm[x] = 0.f;
  for (int x = tid; x < B * kCols; x += kThreads) {
    const int b = x / kCols, jj = j0 + x % kCols;
    const long long at = static_cast<long long>(b) * R + jj;
    const bool in = jj < R;
    dcs[x] = in ? dc_T[at] : 0.f;
    dns[x] = in ? dn_T[at] : 0.f;
    dms[x] = in ? dm_T[at] : 0.f;
  }
  const int bb_cell = tid / kCols;
  const bool cell_thread = tid < kRowTile * kCols && jok;
  const long long RS = static_cast<long long>(R) * S;
  const long long BSR = B * RS;
  __syncthreads();
  constexpr int kStride = RPG < 32 ? 1 : 16;
  const int rbase = row0 + (tid & 15);
  const bool polls = rbase - row0 < RPG && rbase < R;
  int it = 0;
  for (long long u = 0; u < S; ++u) {
    const long long t = S - 1 - u;
    const unsigned tag_in = u > 0 ? step_tag(u - 1) : 0u;
    const unsigned tag_out = step_tag(u);
    const long long BR = static_cast<long long>(B) * R;
    const unsigned long long* slot_in = ring + ((u - 1) & 1) * BR;
    unsigned long long* slot_out = ring + (u & 1) * BR;
    for (int b0 = 0; b0 < B; b0 += kRowTile) {
      const int nb = B - b0 < kRowTile ? B - b0 : kRowTile;
      // the cell's inputs, loaded before the wait
      const long long b = b0 + bb_cell;
      const bool cell_live = cell_thread && bb_cell < nb;
      const long long at = b * RS + t * R + j;
      float x_dh = 0.f, x_o = 0.f, x_i = 0.f, x_f = 0.f, x_c = 0.f,
            x_n = 0.f, x_zz = 0.f, x_cp = 0.f, x_np = 0.f, x_mp = 0.f;
      if (cell_live) {
        x_dh = dhs[at] + (u == 0 ? dh_T[b * R + j] : 0.f);
        x_o = go[at];
        x_i = gi[at];
        x_f = gf[at];
        x_c = kept[at];
        x_n = kept[BSR + at];
        x_zz = kept[3 * BSR + at];
        if (t > 0) {
          x_cp = kept[at - R];
          x_np = kept[BSR + at - R];
          x_mp = kept[2 * BSR + at - R];
        } else {
          x_cp = c0[b * R + j];
          x_np = n0[b * R + j];
          x_mp = m0[b * R + j];
        }
      }
      // gpre_{t+1} of this group's rows, each row of the tile
      for (int bb = 0; bb < nb; ++bb) {
        const long long br = b0 + bb;
        float* grow = gsm + bb * kRows;
        if (!polls || u == 0) continue;   // gpre_S = 0: gsm stays zero
        const unsigned long long* src = slot_in + br * R + rbase;
        unsigned long long got[kPer];
        for (unsigned spins = 0, wait = 1; wait; ++spins) {
          if (spins == kMaxSpins) __trap();
          wait = 0;
#pragma unroll
          for (int k = 0; k < kPer; ++k)
            if (rbase + k * kStride < R) {
              got[k] = peek(src + k * kStride);
              wait |= static_cast<unsigned>(got[k] >> 32) != tag_in;
            }
        }
#pragma unroll
        for (int k = 0; k < kPer; ++k)
          if (rbase + k * kStride < R)
            grow[rbase + k * kStride] =
                __uint_as_float(static_cast<unsigned>(got[k]));
      }
      __syncwarp();
      for (int bb = 0; bb < nb; ++bb) {
        const float4* gv =
            reinterpret_cast<const float4*>(gsm + bb * kRows + row0);
        float a[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int q = 0; q < RPG / 4; ++q) {
          const float4 g4 = gv[q];
          float* s = a + 4 * (q & 1);
          s[0] += g4.x * w[4 * q];
          s[1] += g4.y * w[4 * q + 1];
          s[2] += g4.z * w[4 * q + 2];
          s[3] += g4.w * w[4 * q + 3];
        }
        part[((it & 1) * kRowTile + bb) * kCols * kGroups + col * kGroups +
             grp] =
            ((a[0] + a[4]) + (a[1] + a[5])) + ((a[2] + a[6]) + (a[3] + a[7]));
      }
      __syncthreads();
      if (cell_live) {
        const float4* p4 = reinterpret_cast<const float4*>(
            part + ((it & 1) * kRowTile + bb_cell) * kCols * kGroups +
            col * kGroups);
        const float4 p0 = p4[0], p1 = p4[1], p2 = p4[2], p3 = p4[3];
        const float rec = (((p0.x + p0.y) + (p0.z + p0.w)) +
                           ((p1.x + p1.y) + (p1.z + p1.w))) +
                          (((p2.x + p2.y) + (p2.z + p2.w)) +
                           ((p3.x + p3.y) + (p3.z + p3.w)));
        const int sidx = (b0 + bb_cell) * kCols + col;
        const Gate g = gate_terms(x_i, x_f, x_mp);
        const float gh = x_dh + rec;
        const float N = fmaxf(x_n, 1.f);
        const float dct = dcs[sidx] + gh * x_o / N;
        const float dnt = dns[sidx] + tie_share(x_n, 1.f) *
                                          (-(gh * x_o * x_c) / (N * N));
        const float dfg = dct * x_cp + dnt * x_np;
        const float dig = dct * x_zz + dnt;
        const float gpre = dct * g.ig * (1.f - x_zz * x_zz);
        if (t > 0) publish(slot_out + b * R + j, gpre, tag_out);
        const float dm_new = dms[sidx] - dig * g.ig - dfg * g.fg;
        const float sa = tie_share(log_sigmoid(x_f) + x_mp, x_i);
        const float dlf = dfg * g.fg + sa * dm_new;
        dcs[sidx] = dct * g.fg;
        dns[sidx] = dnt * g.fg;
        dms[sidx] = dlf;
        dz[at] = gpre;
        di[at] = dig * g.ig + (1.f - sa) * dm_new;
        df[at] = dlf / (1.f + expf(x_f));
        dout[at] = gh * x_c / N;
      }
      ++it;
    }
  }
}

template <typename T, int RPG>
cudaError_t launch_chain_bwd(const float* i, const float* f, const float* o,
                             const T* rz, const float* c0, const float* n0,
                             const float* m0, const float* kept,
                             const float* dhs, const float* dc_T,
                             const float* dn_T, const float* dh_T,
                             const float* dm_T, float* dz, float* di,
                             float* df, float* dout,
                             unsigned long long* ring, int B, long long S,
                             int R, cudaStream_t st) {
  const size_t smem = chain_smem<RPG>(B);
  cudaError_t err = cudaFuncSetAttribute(
      slstm_chain_bwd_kernel<T, RPG>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  err = cudaMemsetAsync(ring, 0, sizeof(unsigned long long) * 2 *
                                     static_cast<size_t>(B) * R, st);
  if (err != cudaSuccess) return err;
  const dim3 grid((R + kCols - 1) / kCols), block(kThreads);
  void* args[] = {&i, &f, &o, &rz, &c0, &n0, &m0, &kept, &dhs, &dc_T,
                  &dn_T, &dh_T, &dm_T, &dz, &di, &df, &dout, &ring, &B,
                  &S, &R};
  return cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(slstm_chain_bwd_kernel<T, RPG>), grid,
      block, args, smem, st);
}

template <typename T>
cudaError_t chain_bwd(const float* i, const float* f, const float* o,
                      const T* rz, const float* c0, const float* n0,
                      const float* m0, const float* kept, const float* dhs,
                      const float* dc_T, const float* dn_T, const float* dh_T,
                      const float* dm_T, float* dz, float* di, float* df,
                      float* dout, unsigned long long* ring, int B,
                      long long S, int R, cudaStream_t st) {
  switch (chain_rpg(R)) {
#define CHAIN_BWD_CASE(P)                                                   \
  case P:                                                                   \
    return launch_chain_bwd<T, P>(i, f, o, rz, c0, n0, m0, kept, dhs, dc_T, \
                                  dn_T, dh_T, dm_T, dz, di, df, dout, ring, \
                                  B, S, R, st);
    CHAIN_BWD_CASE(4)
    CHAIN_BWD_CASE(8)
    CHAIN_BWD_CASE(16)
    CHAIN_BWD_CASE(32)
    CHAIN_BWD_CASE(64)
    CHAIN_BWD_CASE(128)
#undef CHAIN_BWD_CASE
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// Bytes of dynamic shared memory a chain block takes (S > 1), or -1 where
// the chain does not take R (R > 2048).
extern "C" long long repro_slstm_scan_smem_bytes(int B, int R) {
  if (R > kMaxR) return -1;
  switch (chain_rpg(R)) {
    case 4: return static_cast<long long>(chain_smem<4>(B));
    case 8: return static_cast<long long>(chain_smem<8>(B));
    case 16: return static_cast<long long>(chain_smem<16>(B));
    case 32: return static_cast<long long>(chain_smem<32>(B));
    case 64: return static_cast<long long>(chain_smem<64>(B));
    default: return static_cast<long long>(chain_smem<128>(B));
  }
}

// B14: z, i, f, o (B, S, R) f32, rz (R, R) bf16 (rz_bf16 != 0) or f32, the
// state c0, n0, h0, m0 (B, R) f32, all contiguous. Writes hs (B, S, R) and
// the final c, n, h, m (B, R), and, where `kept` is not null, each step's
// c, n, m and tanh(z + h rz) into kept (4, B, S, R). S == 1: one step
// launch; S > 1: the chain, with `ring` 2 B R 8-byte words of device
// memory, zeroed here first.
extern "C" int repro_slstm_scan(const void* z, const void* i, const void* f,
                                const void* o, const void* rz, int rz_bf16,
                                const void* c0, const void* n0,
                                const void* h0, const void* m0, void* hs,
                                void* c, void* n, void* h, void* m,
                                void* kept, void* ring, int B, long long S,
                                int R, void* stream) {
  if (B <= 0 || S <= 0 || R <= 0) return static_cast<int>(cudaGetLastError());
  if (S > 1 && R > kMaxR) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* zf = static_cast<const float*>(z);
  const float* i_ = static_cast<const float*>(i);
  const float* ff = static_cast<const float*>(f);
  const float* of = static_cast<const float*>(o);
  const float* c0f = static_cast<const float*>(c0);
  const float* n0f = static_cast<const float*>(n0);
  const float* h0f = static_cast<const float*>(h0);
  const float* m0f = static_cast<const float*>(m0);
  float* hsf = static_cast<float*>(hs);
  float* cf = static_cast<float*>(c);
  float* nf = static_cast<float*>(n);
  float* hf = static_cast<float*>(h);
  float* mf = static_cast<float*>(m);
  float* kf = static_cast<float*>(kept);
  auto* rg = static_cast<unsigned long long*>(ring);
  const auto* rzb = static_cast<const __nv_bfloat16*>(rz);
  const auto* rzf = static_cast<const float*>(rz);
  cudaError_t err;
  if (S == 1)
    err = rz_bf16 ? step(zf, i_, ff, of, rzb, c0f, n0f, h0f, m0f, hsf, cf, nf,
                         hf, mf, kf, B, R, st)
                  : step(zf, i_, ff, of, rzf, c0f, n0f, h0f, m0f, hsf, cf, nf,
                         hf, mf, kf, B, R, st);
  else
    err = rz_bf16 ? chain(zf, i_, ff, of, rzb, c0f, n0f, h0f, m0f, hsf, cf, nf,
                          hf, mf, kf, rg, B, S, R, st)
                  : chain(zf, i_, ff, of, rzf, c0f, n0f, h0f, m0f, hsf, cf, nf,
                          hf, mf, kf, rg, B, S, R, st);
  return static_cast<int>(err);
}

// B17: the backward of B14 from the state it started at (c0, n0, m0; its
// h0 takes no gradient here): i, f, o (B, S, R) f32, rz (R, R) bf16
// (rz_bf16 != 0) or f32, B14's kept (4, B, S, R), dhs (B, S, R) and the
// final state's gradients dc, dn, dh, dm (B, R), all contiguous; R <=
// 2048, any S >= 1. Writes dz (the pre-activation's gradient, gpre), di,
// df and do (B, S, R): one cooperative launch of the reverse chain, with
// `ring` 2 B R 8-byte words, zeroed here first.
extern "C" int repro_slstm_scan_bwd(
    const void* i, const void* f, const void* o, const void* rz,
    int rz_bf16, const void* c0, const void* n0, const void* m0,
    const void* kept, const void* dhs, const void* dc, const void* dn,
    const void* dh, const void* dm, void* dz, void* di, void* df, void* dout,
    void* ring, int B, long long S, int R, void* stream) {
  if (B <= 0 || S <= 0 || R <= 0) return static_cast<int>(cudaGetLastError());
  if (R > kMaxR) return static_cast<int>(cudaErrorInvalidValue);
  auto cf = [](const void* p) { return static_cast<const float*>(p); };
  auto fp = [](void* p) { return static_cast<float*>(p); };
  auto* rg = static_cast<unsigned long long*>(ring);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      rz_bf16
          ? chain_bwd(cf(i), cf(f), cf(o),
                      static_cast<const __nv_bfloat16*>(rz), cf(c0), cf(n0),
                      cf(m0), cf(kept), cf(dhs), cf(dc), cf(dn), cf(dh),
                      cf(dm), fp(dz), fp(di), fp(df), fp(dout), rg, B, S, R,
                      st)
          : chain_bwd(cf(i), cf(f), cf(o), cf(rz), cf(c0), cf(n0), cf(m0),
                      cf(kept), cf(dhs), cf(dc), cf(dn), cf(dh), cf(dm),
                      fp(dz), fp(di), fp(df), fp(dout), rg, B, S, R, st);
  return static_cast<int>(err);
}

// rg_lru.cu — the gated linear recurrence of the RG-LRU block on Hopper.
//
// Replaces the Pallas TPU kernel B8 of repro/kernels/rg_lru.py
// (_rg_lru_kernel / rg_lru_scan) with the contract of
// repro_torch/kernels/ref.py rg_lru_scan: a, b (B, S, D) f32 contiguous;
// h0 (B, D) f32 or null (zeros). Writes h (B, S, D) f32 with
//   h_t = a_t * h_{t-1} + b_t,   h_{-1} = h0.
//
// The Pallas grid (B, nd, ns) walked the sequence axis minor-most and
// carried h in VMEM scratch from one S block to the next. Hopper runs
// blocks in no order, so here the carry lives in a register of the one
// thread that walks a (b, d) column through all of S.
//
// Rounding: h = a * h + b is computed as __fadd_rn(__fmul_rn(a, h), b),
// the product and the sum each rounded on its own, so nvcc cannot
// contract them into one FMA. The plain version computes `a * h + b` as
// two torch ops, rounded the same way: the two agree bit for bit.
//
// Bound: bytes (a and b read once, h written once; 2 flops per 12 bytes).
// The dependent chain is short beside them: S steps of a multiply and an
// add, about 0.15-0.19 ms at S = 32,768, against 0.48 ms for the bytes of
// the prefill's call (1 x 32,768 x 4,096). What the walk needs is bytes in
// flight: at about 1 us of latency, 3.35 TB/s takes about 26 KB in flight
// on each SM.
//
// What the design does about it, for S >= kShortS (rg_lru_ring_kernel):
// one warp per block walks 32 adjacent columns of one row b, so that each
// step reads 128 contiguous bytes of a and of b and writes 128 of h; the
// prefill's shape gives 128 blocks on 132 SMs. The warp keeps a ring of
// kStages stages of kSteps steps x 32 columns of a and b in shared memory
// (64 KB), filled by cp.async (16-byte copies where D and the pointers
// allow, 4-byte ones otherwise; zeros past D and past S), so that up to
// kStages - 1 stages, 56 KB, are in flight while it walks one. For each
// stage it issues the copies of the stage kStages - 1 ahead, waits for the
// oldest group, loads the stage's a and b into registers ahead of the
// dependent multiply-adds, walks its steps, and stores h with one
// coalesced 128-byte store a step. The walk keeps branches out of its
// loop: the last stage, short of kSteps steps, is walked after it, and a
// block chooses once whether its stores need a predicate (all columns
// inside D: none; else one predicated store each). A store under `if` in
// the unrolled walk became a branch of its own a step, 2.8x slower.
// For S < kShortS (decode, S = 1): one thread per column, 128 columns a
// block, each thread issuing its steps' loads before their multiply-adds.
//
// The backward (repro_rg_lru_scan_bwd, kernel B11) replaces no Pallas
// kernel: JAX differentiates ref.rg_lru_scan's scan. Its contract is
// kernels/ref.py rg_lru_scan_bwd: given a, the forward's h and dh (B, S,
// D) f32 and h0 (B, D) or null, it walks each column from t = S - 1 down,
//   g_t = dh_t + a_{t+1} * g_{t+1}   (g_{S-1} = dh_{S-1}),
//   db_t = g_t,   da_t = g_t * h_{t-1}   (h_{-1} = h0, or 0),
// and writes dh0 = a_0 * g_0 (B, D), each product and sum rounded on its
// own (g = __fadd_rn(dh_t, __fmul_rn(a_{t+1}, g)), da = __fmul_rn(g,
// h_{t-1}), dh0 = __fmul_rn(a_0, g_0)), bit for bit with the plain
// version. Bound: bytes (a, h and dh read once, da and db written once:
// 20 bytes an element against 3 flops), 0.100 ms at the train shape
// (1 x 4,096 x 4,096). Like the forward, the walk needs bytes in flight.
//
// What the design does about it, for S >= kShortS (rg_lru_bwd_ring_kernel):
// the forward's ring run in reverse. One warp per block walks 32 adjacent
// columns of one row b, so the train shape gives 128 blocks (a thread a
// column gave 32 blocks of 128 threads, bound by the latency of its
// walk). Stage k of the ring holds steps [S - (k + 1) kSteps, S - k
// kSteps) of a, of dh and of h shifted by one step (row r holds h at
// t - 1: h0's row, or zeros, at t = 0), so the first stage ends at t =
// S - 1 and only the last one, at t = 0, may be short: steps before 0
// are zero-filled and not walked. kStages stages of kSteps steps x 32
// columns of the three arrays take 96 KB of shared memory, filled by
// cp.async (16-byte copies where D and the pointers allow, 4-byte ones
// otherwise), so two blocks fit on an SM where B x D gives more blocks
// than SMs. The walk loads a stage into registers ahead of the chain,
// carries g and a_{t+1} in registers from one step to the one before it,
// and stores db and da from registers, one coalesced 128-byte store of
// each a step; stores take a predicate only in blocks whose columns run
// past D, as in the forward. g starts at -0 and a_{t+1} at 0, so the
// first step's sum returns dh_{S-1} bit for bit (-0 included) without a
// branch. For S < kShortS: one thread per column (rg_lru_bwd_kernel).
#include <cstdint>
#include <cuda_runtime.h>

namespace {

// short sequences: one thread per column
constexpr int kColThreads = 128;
constexpr int kUnroll = 8;
constexpr long long kShortS = 8;

// long sequences: one warp per 32 columns, fed by a ring of stages
constexpr int kCols = 32;
constexpr int kSteps = 32;                          // steps a stage
constexpr int kStages = 8;                          // stages in the ring
constexpr int kStageFloats = kSteps * kCols;        // of a, and of b
constexpr int kRingBytes = 2 * kStages * kStageFloats * 4;
// the backward's ring: a, dh and h (shifted by one step), 96 KB
constexpr int kBwdRingBytes = 3 * kStages * kStageFloats * 4;

__global__ void __launch_bounds__(kColThreads)
rg_lru_column_kernel(const float* __restrict__ a, const float* __restrict__ b,
                     const float* __restrict__ h0, float* __restrict__ h,
                     long long S, int D) {
  const int d = blockIdx.x * kColThreads + threadIdx.x;
  if (d >= D) return;
  const long long row = blockIdx.y;
  float hv = h0 != nullptr ? h0[row * D + d] : 0.f;
  const long long base = row * S * D + d;
  const float* ap = a + base;
  const float* bp = b + base;
  float* hp = h + base;
  long long t = 0;
  for (; t + kUnroll <= S; t += kUnroll) {
    float av[kUnroll], bv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      av[u] = ap[(t + u) * D];
      bv[u] = bp[(t + u) * D];
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      hv = __fadd_rn(__fmul_rn(av[u], hv), bv[u]);
      hp[(t + u) * D] = hv;
    }
  }
  for (; t < S; ++t) {
    hv = __fadd_rn(__fmul_rn(ap[t * D], hv), bp[t * D]);
    hp[t * D] = hv;
  }
}

// S < kShortS: one thread per column walks it from t = S - 1 down
__global__ void __launch_bounds__(kColThreads)
rg_lru_bwd_kernel(const float* __restrict__ a, const float* __restrict__ h,
                  const float* __restrict__ h0, const float* __restrict__ dh,
                  float* __restrict__ da, float* __restrict__ db,
                  float* __restrict__ dh0, long long S, int D) {
  const int d = blockIdx.x * kColThreads + threadIdx.x;
  if (d >= D) return;
  const long long row = blockIdx.y;
  const long long base = row * S * D + d;
  const float h_init = h0 != nullptr ? h0[row * D + d] : 0.f;
  float g = -0.f, a_next = 0.f;   // the first step gives g = dh_{S-1}
  for (long long t = S - 1; t >= 0; --t) {
    const long long at = base + t * D;
    g = __fadd_rn(dh[at], __fmul_rn(a_next, g));
    db[at] = g;
    da[at] = __fmul_rn(g, t > 0 ? h[at - D] : h_init);
    a_next = a[at];
  }
  dh0[row * D + d] = __fmul_rn(a_next, g);  // a_0 * g_0
}

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

// Issue the copies of steps [t0, t0 + kSteps) of columns [c0, c0 + 32) of
// one array into a ring slot (row r of the slot holds step t0 + r). kVec:
// 16-byte copies, lane l taking column group l % 8 of rows l / 8 + 4 i.
template <bool kVec>
__device__ __forceinline__ void load_stage(float* slot, const float* src,
                                           long long t0, long long S, int D,
                                           int c0, int lane) {
  if (kVec) {
    const int c = 4 * (lane & 7);
    const bool col_in = c0 + c < D;
#pragma unroll
    for (int i = 0; i < kSteps / 4; ++i) {
      const int r = (lane >> 3) + 4 * i;
      const bool in = col_in && t0 + r < S;
      cp_async16(smem_addr(slot + r * kCols + c),
                 in ? src + (t0 + r) * D + c0 + c : src, in);
    }
  } else {
    const bool col_in = c0 + lane < D;
#pragma unroll 8
    for (int r = 0; r < kSteps; ++r) {
      const bool in = col_in && t0 + r < S;
      cp_async4(smem_addr(slot + r * kCols + lane),
                in ? src + (t0 + r) * D + c0 + lane : src, in);
    }
  }
}

// *p = v where `pred`, as one predicated store: no branch in the walk
__device__ __forceinline__ void store_if(float* p, float v, bool pred) {
  asm volatile(
      "{\n .reg .pred q;\n setp.ne.b32 q, %2, 0;\n"
      " @q st.global.f32 [%0], %1;\n}\n" ::"l"(p), "f"(v),
      "r"(static_cast<int>(pred))
      : "memory");
}

// the ring slot that holds stage st
__device__ __forceinline__ int slot_of(long long st) {
  return static_cast<int>(st % kStages);
}

// The walk of one block: kStages - 1 stages in flight ahead of the one
// walked. kAll: every lane's column is inside D, so the stores take no
// predicate; otherwise each is one predicated store.
template <bool kVec, bool kAll>
__device__ __forceinline__ void ring_walk(float* ring, const float* ar,
                                          const float* br, float* hp,
                                          float hv, long long S, int D,
                                          int c0, int lane, bool live) {
  const long long nst = (S + kSteps - 1) / kSteps;
  const long long nfull = S / kSteps;
  auto issue = [&](long long k) {
    if (k < nst) {   // stage k goes to slot k % kStages
      float* sa = ring + (k % kStages) * 2 * kStageFloats;
      load_stage<kVec>(sa, ar, k * kSteps, S, D, c0, lane);
      load_stage<kVec>(sa + kStageFloats, br, k * kSteps, S, D, c0, lane);
    }
    cp_async_commit();   // one group a stage, empty past the end
  };
  for (int k = 0; k < kStages - 1; ++k) issue(k);

  long long st = 0;
  for (; st < nfull; ++st) {
    issue(st + kStages - 1);   // into the slot walked last round
    cp_async_wait<kStages - 1>();
    __syncwarp();              // every lane's copies of stage st are in
    const float* sa = ring + slot_of(st) * 2 * kStageFloats + lane;
    const float* sb = sa + kStageFloats;
    float* hq = hp + st * kSteps * D;
    float av[kSteps], bv[kSteps];   // loaded ahead of the chain
#pragma unroll
    for (int r = 0; r < kSteps; ++r) {
      av[r] = sa[r * kCols];
      bv[r] = sb[r * kCols];
    }
#pragma unroll
    for (int r = 0; r < kSteps; ++r) {
      hv = __fadd_rn(__fmul_rn(av[r], hv), bv[r]);
      if (kAll)
        hq[static_cast<long long>(r) * D] = hv;
      else
        store_if(hq + static_cast<long long>(r) * D, hv, live);
    }
    __syncwarp();              // the slot is free for the next issue
  }
  cp_async_wait<0>();
  __syncwarp();
  if (st < nst) {              // the last stage, short of kSteps steps
    const float* sa = ring + slot_of(st) * 2 * kStageFloats + lane;
    const float* sb = sa + kStageFloats;
    float* hq = hp + st * kSteps * D;
    for (int r = 0; r < S - st * kSteps; ++r) {
      hv = __fadd_rn(__fmul_rn(sa[r * kCols], hv), sb[r * kCols]);
      store_if(hq + static_cast<long long>(r) * D, hv, live);
    }
  }
}

template <bool kVec>
__global__ void __launch_bounds__(kCols)
rg_lru_ring_kernel(const float* __restrict__ a, const float* __restrict__ b,
                   const float* __restrict__ h0, float* __restrict__ h,
                   long long S, int D) {
  extern __shared__ __align__(16) float ring[];   // [kStages][2][kSteps][32]
  const int lane = threadIdx.x;
  const int c0 = blockIdx.x * kCols;
  const long long row = blockIdx.y;
  const bool live = c0 + lane < D;
  const float* ar = a + row * S * D;
  const float* br = b + row * S * D;
  float* hp = h + row * S * D + c0 + lane;
  const float hv = h0 != nullptr && live ? h0[row * D + c0 + lane] : 0.f;
  if (c0 + kCols <= D)
    ring_walk<kVec, true>(ring, ar, br, hp, hv, S, D, c0, lane, live);
  else
    ring_walk<kVec, false>(ring, ar, br, hp, hv, S, D, c0, lane, live);
}

template <bool kVec>
cudaError_t launch_ring(const float* a, const float* b, const float* h0,
                        float* h, long long B, long long S, int D,
                        cudaStream_t stream) {
  const cudaError_t err = cudaFuncSetAttribute(
      rg_lru_ring_kernel<kVec>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kRingBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>((D + kCols - 1) / kCols),
                  static_cast<unsigned>(B));
  rg_lru_ring_kernel<kVec><<<grid, kCols, kRingBytes, stream>>>(a, b, h0, h,
                                                                S, D);
  return cudaGetLastError();
}

// Issue the copies of steps [t0, t0 + kSteps) of columns [c0, c0 + 32) of
// one array into a ring slot of the backward (row r holds step t0 + r;
// t0 may be negative). Steps in [0, S) come from src, step -1 from
// `first` (h0's row) where it is given, and every other step, and columns
// past D, are zero-filled. Lanes as in load_stage.
template <bool kVec>
__device__ __forceinline__ void load_stage_rev(float* slot, const float* src,
                                               const float* first,
                                               long long t0, long long S,
                                               int D, int c0, int lane) {
  if (kVec) {
    const int c = 4 * (lane & 7);
    const bool col_in = c0 + c < D;
#pragma unroll
    for (int i = 0; i < kSteps / 4; ++i) {
      const int r = (lane >> 3) + 4 * i;
      const long long t = t0 + r;
      const bool in = col_in && t < S && (t >= 0 || (t == -1 && first));
      const float* p = t >= 0 ? src + t * D : first;
      cp_async16(smem_addr(slot + r * kCols + c), in ? p + c0 + c : src, in);
    }
  } else {
    const bool col_in = c0 + lane < D;
#pragma unroll 8
    for (int r = 0; r < kSteps; ++r) {
      const long long t = t0 + r;
      const bool in = col_in && t < S && (t >= 0 || (t == -1 && first));
      const float* p = t >= 0 ? src + t * D : first;
      cp_async4(smem_addr(slot + r * kCols + lane), in ? p + c0 + lane : src,
                in);
    }
  }
}

// The backward walk of one block, from t = S - 1 down: kStages - 1 stages
// in flight ahead of the one walked. kAll as in ring_walk.
template <bool kVec, bool kAll>
__device__ __forceinline__ void ring_walk_bwd(
    float* ring, const float* ar, const float* hr, const float* h0r,
    const float* gr, float* dap, float* dbp, float* dh0p, long long S, int D,
    int c0, int lane, bool live) {
  const long long nst = (S + kSteps - 1) / kSteps;
  const long long nfull = S / kSteps;
  auto issue = [&](long long k) {
    if (k < nst) {   // stage k goes to slot k % kStages
      float* sa = ring + (k % kStages) * 3 * kStageFloats;
      const long long t0 = S - (k + 1) * kSteps;
      load_stage_rev<kVec>(sa, ar, nullptr, t0, S, D, c0, lane);
      load_stage_rev<kVec>(sa + kStageFloats, gr, nullptr, t0, S, D, c0,
                           lane);
      load_stage_rev<kVec>(sa + 2 * kStageFloats, hr, h0r, t0 - 1, S, D, c0,
                           lane);
    }
    cp_async_commit();   // one group a stage, empty past the end
  };
  for (int k = 0; k < kStages - 1; ++k) issue(k);

  float g = -0.f, a_next = 0.f;   // the first step gives g = dh_{S-1}
  long long st = 0;
  for (; st < nfull; ++st) {
    issue(st + kStages - 1);   // into the slot walked last round
    cp_async_wait<kStages - 1>();
    __syncwarp();              // every lane's copies of stage st are in
    const float* sa = ring + slot_of(st) * 3 * kStageFloats + lane;
    const float* sg = sa + kStageFloats;
    const float* sh = sa + 2 * kStageFloats;
    const long long t0 = S - (st + 1) * kSteps;
    float* daq = dap + t0 * D;
    float* dbq = dbp + t0 * D;
    float av[kSteps], gv[kSteps], hv[kSteps];   // loaded ahead of the chain
#pragma unroll
    for (int r = 0; r < kSteps; ++r) {
      av[r] = sa[r * kCols];
      gv[r] = sg[r * kCols];
      hv[r] = sh[r * kCols];
    }
#pragma unroll
    for (int r = kSteps - 1; r >= 0; --r) {
      g = __fadd_rn(gv[r], __fmul_rn(a_next, g));
      a_next = av[r];
      const float dav = __fmul_rn(g, hv[r]);
      if (kAll) {
        dbq[static_cast<long long>(r) * D] = g;
        daq[static_cast<long long>(r) * D] = dav;
      } else {
        store_if(dbq + static_cast<long long>(r) * D, g, live);
        store_if(daq + static_cast<long long>(r) * D, dav, live);
      }
    }
    __syncwarp();              // the slot is free for the next issue
  }
  cp_async_wait<0>();
  __syncwarp();
  if (st < nst) {              // the last stage, at t = 0, short of kSteps
    const float* sa = ring + slot_of(st) * 3 * kStageFloats + lane;
    const float* sg = sa + kStageFloats;
    const float* sh = sa + 2 * kStageFloats;
    const long long t0 = S - (st + 1) * kSteps;   // < 0
    for (int r = kSteps - 1; t0 + r >= 0; --r) {
      g = __fadd_rn(sg[r * kCols], __fmul_rn(a_next, g));
      a_next = sa[r * kCols];
      const long long t = t0 + r;
      store_if(dbp + t * D, g, live);
      store_if(dap + t * D, __fmul_rn(g, sh[r * kCols]), live);
    }
  }
  store_if(dh0p, __fmul_rn(a_next, g), live);   // a_0 * g_0
}

template <bool kVec>
__global__ void __launch_bounds__(kCols)
rg_lru_bwd_ring_kernel(const float* __restrict__ a,
                       const float* __restrict__ h,
                       const float* __restrict__ h0,
                       const float* __restrict__ dh, float* __restrict__ da,
                       float* __restrict__ db, float* __restrict__ dh0,
                       long long S, int D) {
  extern __shared__ __align__(16) float ring[];   // [kStages][3][kSteps][32]
  const int lane = threadIdx.x;
  const int c0 = blockIdx.x * kCols;
  const long long row = blockIdx.y;
  const bool live = c0 + lane < D;
  const long long base = row * S * D;
  const float* h0r = h0 != nullptr ? h0 + row * D : nullptr;
  float* dap = da + base + c0 + lane;
  float* dbp = db + base + c0 + lane;
  float* dh0p = dh0 + row * D + c0 + lane;
  if (c0 + kCols <= D)
    ring_walk_bwd<kVec, true>(ring, a + base, h + base, h0r, dh + base, dap,
                              dbp, dh0p, S, D, c0, lane, live);
  else
    ring_walk_bwd<kVec, false>(ring, a + base, h + base, h0r, dh + base, dap,
                               dbp, dh0p, S, D, c0, lane, live);
}

template <bool kVec>
cudaError_t launch_bwd_ring(const float* a, const float* h, const float* h0,
                            const float* dh, float* da, float* db,
                            float* dh0, long long B, long long S, int D,
                            cudaStream_t stream) {
  const cudaError_t err = cudaFuncSetAttribute(
      rg_lru_bwd_ring_kernel<kVec>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kBwdRingBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>((D + kCols - 1) / kCols),
                  static_cast<unsigned>(B));
  rg_lru_bwd_ring_kernel<kVec><<<grid, kCols, kBwdRingBytes, stream>>>(
      a, h, h0, dh, da, db, dh0, S, D);
  return cudaGetLastError();
}

}  // namespace

// h0 may be null (zeros). All pointers f32, contiguous.
extern "C" int repro_rg_lru_scan(const void* a, const void* b, const void* h0,
                                 void* h, long long B, long long S, int D,
                                 void* stream) {
  if (B <= 0 || S <= 0 || D <= 0) return static_cast<int>(cudaGetLastError());
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* af = static_cast<const float*>(a);
  const float* bf = static_cast<const float*>(b);
  const float* h0f = static_cast<const float*>(h0);
  float* hf = static_cast<float*>(h);
  if (S < kShortS) {
    const dim3 grid(static_cast<unsigned>((D + kColThreads - 1) /
                                          kColThreads),
                    static_cast<unsigned>(B));
    rg_lru_column_kernel<<<grid, kColThreads, 0, st>>>(af, bf, h0f, hf, S, D);
    return static_cast<int>(cudaGetLastError());
  }
  const bool vec =
      D % 4 == 0 &&
      ((reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b)) &
       15) == 0;
  return static_cast<int>(vec ? launch_ring<true>(af, bf, h0f, hf, B, S, D, st)
                              : launch_ring<false>(af, bf, h0f, hf, B, S, D,
                                                   st));
}

// The backward: a, h, dh (B, S, D) f32 contiguous; h0 (B, D) or null
// (zeros). Writes da, db (B, S, D) and dh0 (B, D).
extern "C" int repro_rg_lru_scan_bwd(const void* a, const void* h,
                                     const void* h0, const void* dh,
                                     void* da, void* db, void* dh0,
                                     long long B, long long S, int D,
                                     void* stream) {
  if (B <= 0 || S <= 0 || D <= 0) return static_cast<int>(cudaGetLastError());
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* af = static_cast<const float*>(a);
  const float* hf = static_cast<const float*>(h);
  const float* h0f = static_cast<const float*>(h0);
  const float* dhf = static_cast<const float*>(dh);
  float* daf = static_cast<float*>(da);
  float* dbf = static_cast<float*>(db);
  float* dh0f = static_cast<float*>(dh0);
  if (S < kShortS) {
    const dim3 grid(static_cast<unsigned>((D + kColThreads - 1) /
                                          kColThreads),
                    static_cast<unsigned>(B));
    rg_lru_bwd_kernel<<<grid, kColThreads, 0, st>>>(af, hf, h0f, dhf, daf,
                                                    dbf, dh0f, S, D);
    return static_cast<int>(cudaGetLastError());
  }
  const bool vec =
      D % 4 == 0 &&
      ((reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(h) |
        reinterpret_cast<uintptr_t>(h0) | reinterpret_cast<uintptr_t>(dh)) &
       15) == 0;
  return static_cast<int>(
      vec ? launch_bwd_ring<true>(af, hf, h0f, dhf, daf, dbf, dh0f, B, S, D,
                                  st)
          : launch_bwd_ring<false>(af, hf, h0f, dhf, daf, dbf, dh0f, B, S, D,
                                   st));
}

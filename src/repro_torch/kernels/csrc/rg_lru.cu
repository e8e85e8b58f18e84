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
// blocks in no order, so here the carry lives in a register of one thread
// per (b, d) column, which walks all of S itself. Neighbouring threads
// take neighbouring d, so every load and store of a step is coalesced.
// The loads of a and b do not depend on h: each thread issues kUnroll
// steps' loads before the dependent multiply-adds of those steps.
//
// Rounding: h = a * h + b is computed as __fadd_rn(__fmul_rn(a, h), b),
// the product and the sum each rounded on its own, so nvcc cannot
// contract them into one FMA. The plain version computes `a * h + b` as
// two torch ops, rounded the same way: the two agree bit for bit.
//
// Bound: bytes (a and b read once, h written once; 2 flops per 12 bytes).
// At the prefill shape (B = 1, D = 4096) only B * D = 4096 threads are
// live, 32 blocks of 128 on 132 SMs, and each walks S serially: the kernel
// is bound by the latency of its dependent chain and of its loads, far
// above the byte bound. A chunked two-pass scan (local scans of S blocks,
// then a scan of the carries) is the later fix.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kUnroll = 8;

__global__ void __launch_bounds__(kThreads)
rg_lru_kernel(const float* __restrict__ a, const float* __restrict__ b,
              const float* __restrict__ h0, float* __restrict__ h,
              long long S, int D) {
  const int d = blockIdx.x * kThreads + threadIdx.x;
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

}  // namespace

// h0 may be null (zeros). All pointers f32, contiguous.
extern "C" int repro_rg_lru_scan(const void* a, const void* b, const void* h0,
                                 void* h, long long B, long long S, int D,
                                 void* stream) {
  if (B <= 0 || S <= 0 || D <= 0) return static_cast<int>(cudaGetLastError());
  const dim3 grid(static_cast<unsigned>((D + kThreads - 1) / kThreads),
                  static_cast<unsigned>(B));
  rg_lru_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<const float*>(h0), static_cast<float*>(h), S, D);
  return static_cast<int>(cudaGetLastError());
}

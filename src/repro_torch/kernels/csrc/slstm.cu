// slstm.cu — the xLSTM sLSTM recurrence on Hopper (kernel B14,
// slstm_scan).
//
// Replaces no Pallas kernel: the JAX package scans the cell in jnp
// (repro/models/lm.py slstm_block, :883-903). It was added because the
// scan as eager PyTorch is about 12 launches a step, and the prefill of
// xlstm-1.3b makes 6 layers x 32,768 steps. The contract is that of
// repro_torch/kernels/ref.py slstm_scan: z, i, f, o (B, S, R) f32
// contiguous (pre-activations; o the output gate), rz (R, R) bf16 or f32,
// the state c0, n0, h0, m0 (B, R) f32. Per step t and column j:
//   z = tanh(z_t + (h_{t-1} rz)_j),  lf = logsigmoid(f_t),
//   m' = max(lf + m, i_t),  ig = exp(i_t - m'),  fg = exp(lf + m - m'),
//   c = fg c + ig z,  n = fg n + ig,  h_t = o_t c / max(n, 1),  m = m'.
// Writes hs (B, S, R) (h_t of every step) and the final c, n, h, m. A bf16
// rz is widened value by value (exactly), as JAX's astype(float32).
//
// Bound: each step needs the whole h_{t-1}, so the S steps are a chain.
// Bytes: z, i, f, o read and hs written once (20 B S R bytes) and rz once;
// beside them a floor a step: one exchange of h across the card. At the
// prefill (B = 1, S = 32,768, R = 2048) the bytes are 1.34 GB, 0.40 ms at
// 3.35 TB/s; at 1-3 us a step the chain takes 33-100 ms. Reading rz (8.4
// MB in bf16) from device memory each step would take 2.5 us a step.
//
// Design: a persistent grid of ceil(R / 16) blocks, launched cooperatively
// (cudaLaunchCooperativeKernel refuses a grid that is not all resident,
// so the barrier below always returns). Block g owns columns [16 g, 16 g +
// 16): it keeps that slice of rz (R x 16, 64 KB in bf16, 128 KB in f32)
// and the state of its columns for every row b in shared memory for the
// whole call. Each step and row b: the block reads h_{t-1} (h0 at t = 0,
// else hs[b, t - 1], which other blocks wrote: through L2, never L1) into
// shared memory, 16 groups of 16 threads form partial products of 16
// columns over R / 16 rows each, 16 threads sum the groups in order and
// step their column's cell, storing h_t into hs. Then a grid barrier: a
// fence, one atomic arrival on a counter the launcher zeroes, and a spin
// of one thread a block until the counter reaches (steps done) x (blocks).
// The step's z, i, f, o are loaded before h_{t-1}, so their latency hides
// behind its. The product sums in another order than torch.matmul, so the
// kernel is held to the plain version within a tolerance, not bit for bit.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kCols = 16;                  // columns of rz a block
constexpr int kThreads = 256;              // 16 groups x 16 columns
constexpr int kGroups = kThreads / kCols;

__device__ __forceinline__ float log_sigmoid(float x) {
  return fminf(x, 0.f) - log1pf(expf(-fabsf(x)));
}

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T zero_value();
template <>
__device__ __forceinline__ float zero_value<float>() {
  return 0.f;
}
template <>
__device__ __forceinline__ __nv_bfloat16 zero_value<__nv_bfloat16>() {
  return __float2bfloat16(0.f);
}

// Every block waits here until the counter reaches `target` (steps done
// x blocks); fences make each block's stores before the barrier visible
// to every block after it.
__device__ __forceinline__ void grid_barrier(unsigned int* count,
                                             unsigned int target) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(count, 1u);
    while (*static_cast<volatile unsigned int*>(count) < target) {
    }
    __threadfence();
  }
  __syncthreads();
}

// Shared memory: rz's slice (R x kCols of T), h_{t-1} (R f32), the group
// partials (kGroups x kCols), the state c, n, m of the block's columns for
// every row (3 x B x kCols f32).
template <typename T>
__global__ void __launch_bounds__(kThreads)
slstm_scan_kernel(const float* __restrict__ z, const float* __restrict__ gi,
                  const float* __restrict__ gf, const float* __restrict__ go,
                  const T* __restrict__ rz, const float* __restrict__ c0,
                  const float* __restrict__ n0, const float* __restrict__ h0,
                  const float* __restrict__ m0, float* hs,
                  float* __restrict__ c_out, float* __restrict__ n_out,
                  float* __restrict__ h_out, float* __restrict__ m_out,
                  unsigned int* count, int B, long long S, int R) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* rzs = reinterpret_cast<T*>(smem_raw);
  const size_t rz_bytes = (static_cast<size_t>(R) * kCols * sizeof(T) + 15) &
                          ~static_cast<size_t>(15);
  float* hp = reinterpret_cast<float*>(smem_raw + rz_bytes);   // R
  float* part = hp + R;                                        // kGroups x kCols
  float* cs = part + kGroups * kCols;                          // B x kCols
  float* ns = cs + B * kCols;
  float* ms = ns + B * kCols;
  const int tid = threadIdx.x;
  const int col = tid % kCols, grp = tid / kCols;
  const int j0 = blockIdx.x * kCols;
  const int j = j0 + col;
  const bool mine = tid < kCols && j < R;
  for (int x = tid; x < R * kCols; x += kThreads) {
    const int r = x / kCols, cc = x % kCols;
    rzs[x] = j0 + cc < R ? rz[static_cast<long long>(r) * R + j0 + cc]
                          : zero_value<T>();
  }
  if (tid < kCols)
    for (int b = 0; b < B; ++b) {
      const long long at = static_cast<long long>(b) * R + j;
      cs[b * kCols + tid] = mine ? c0[at] : 0.f;
      ns[b * kCols + tid] = mine ? n0[at] : 0.f;
      ms[b * kCols + tid] = mine ? m0[at] : 0.f;
    }
  const int per = (R + kGroups - 1) / kGroups;
  const int r_lo = grp * per;
  const int r_hi = r_lo + per < R ? r_lo + per : R;
  const unsigned int nblocks = gridDim.x;
  for (long long t = 0; t < S; ++t) {
    for (int b = 0; b < B; ++b) {
      const long long at = (static_cast<long long>(b) * S + t) * R + j;
      float zt = 0.f, it = 0.f, ft = 0.f, ot = 0.f;
      if (mine) {
        zt = z[at];
        it = gi[at];
        ft = gf[at];
        ot = go[at];
      }
      const float* src = t == 0 ? h0 + static_cast<long long>(b) * R
                                : hs + (static_cast<long long>(b) * S + t - 1) * R;
      for (int x = tid; x < R; x += kThreads) hp[x] = __ldcg(src + x);
      __syncthreads();
      float acc = 0.f;
      for (int r = r_lo; r < r_hi; ++r)
        acc += hp[r] * widen(rzs[r * kCols + col]);
      part[grp * kCols + col] = acc;
      __syncthreads();
      if (mine) {
        float pre = 0.f;
        for (int g = 0; g < kGroups; ++g) pre += part[g * kCols + tid];
        const float zz = tanhf(zt + pre);
        const float lf = log_sigmoid(ft);
        const float m = ms[b * kCols + tid];
        const float m_new = fmaxf(lf + m, it);
        const float ig = expf(it - m_new);
        const float fg = expf(lf + m - m_new);
        const float c = fg * cs[b * kCols + tid] + ig * zz;
        const float n = fg * ns[b * kCols + tid] + ig;
        const float h = ot * c / fmaxf(n, 1.f);
        cs[b * kCols + tid] = c;
        ns[b * kCols + tid] = n;
        ms[b * kCols + tid] = m_new;
        __stcg(hs + at, h);
        if (t == S - 1) {
          const long long o = static_cast<long long>(b) * R + j;
          c_out[o] = c;
          n_out[o] = n;
          h_out[o] = h;
          m_out[o] = m_new;
        }
      }
      __syncthreads();
    }
    if (t + 1 < S)
      grid_barrier(count, static_cast<unsigned int>(t + 1) * nblocks);
  }
}

template <typename T>
size_t scan_smem(int B, int R) {
  const size_t rz_bytes =
      (static_cast<size_t>(R) * kCols * sizeof(T) + 15) & ~static_cast<size_t>(15);
  return rz_bytes + sizeof(float) * (static_cast<size_t>(R) + kGroups * kCols +
                                     3 * static_cast<size_t>(B) * kCols);
}

template <typename T>
cudaError_t launch_scan(const float* z, const float* i, const float* f,
                        const float* o, const T* rz, const float* c0,
                        const float* n0, const float* h0, const float* m0,
                        float* hs, float* c, float* n, float* h, float* m,
                        unsigned int* count, int B, long long S, int R,
                        cudaStream_t st) {
  const size_t smem = scan_smem<T>(B, R);
  cudaError_t err = cudaFuncSetAttribute(
      slstm_scan_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  err = cudaMemsetAsync(count, 0, sizeof(unsigned int), st);
  if (err != cudaSuccess) return err;
  const dim3 grid((R + kCols - 1) / kCols), block(kThreads);
  void* args[] = {&z, &i, &f, &o, &rz, &c0, &n0, &h0, &m0, &hs, &c, &n,
                  &h, &m, &count, &B, &S, &R};
  return cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(slstm_scan_kernel<T>), grid, block, args,
      smem, st);
}

}  // namespace

// Bytes of dynamic shared memory a block takes.
extern "C" long long repro_slstm_scan_smem_bytes(int B, int R, int bf16) {
  return static_cast<long long>(bf16 ? scan_smem<__nv_bfloat16>(B, R)
                                     : scan_smem<float>(B, R));
}

// B14: z, i, f, o (B, S, R) f32, rz (R, R) bf16 (rz_bf16 != 0) or f32, the
// state c0, n0, h0, m0 (B, R) f32, all contiguous. Writes hs (B, S, R) and
// the final c, n, h, m (B, R). `count` is one word of device memory, zeroed
// here before the launch.
extern "C" int repro_slstm_scan(const void* z, const void* i, const void* f,
                                const void* o, const void* rz, int rz_bf16,
                                const void* c0, const void* n0,
                                const void* h0, const void* m0, void* hs,
                                void* c, void* n, void* h, void* m,
                                void* count, int B, long long S, int R,
                                void* stream) {
  if (B <= 0 || S <= 0 || R <= 0) return static_cast<int>(cudaGetLastError());
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
  unsigned int* cnt = static_cast<unsigned int*>(count);
  const cudaError_t err =
      rz_bf16 ? launch_scan(zf, i_, ff, of,
                            static_cast<const __nv_bfloat16*>(rz), c0f, n0f,
                            h0f, m0f, hsf, cf, nf, hf, mf, cnt, B, S, R, st)
              : launch_scan(zf, i_, ff, of, static_cast<const float*>(rz),
                            c0f, n0f, h0f, m0f, hsf, cf, nf, hf, mf, cnt, B,
                            S, R, st);
  return static_cast<int>(err);
}

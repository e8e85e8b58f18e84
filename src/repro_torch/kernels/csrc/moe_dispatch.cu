// moe_dispatch.cu — expert histogram and stable positions on Hopper.
//
// Replaces the Pallas TPU kernel B7 of repro/kernels/moe_dispatch.py
// (_dispatch_kernel / moe_dispatch) with the contract of
// repro_torch/kernels/ref.py moe_dispatch: for ids (T,) int32,
//   counts[e] = #{i : id_i == e},
//   pos[i]    = #{j < i : id_j == id_i},
// the ticket each token would draw from FAA(counter[id_i], 1) if the T
// fetch-and-adds ran in token order. Outside [0, E) the oracle's one-hot
// and fill-mode gather decide: such an id counts for no expert, an id in
// [-E, 0) reads the position of expert id + E, any other id gets INT32_MIN.
//
// The Pallas kernel walked tiles of ids in grid order and carried E
// running counters in VMEM across grid steps. Blocks here run in no
// order, so the carry lives inside one block instead: one block per
// expert scans all T ids in token order, 256 at a time, with a block-wide
// exclusive prefix count of (id == e) (warp ballot + popcount, then the
// warp totals from shared memory), and carries its running count from
// tile to tile. No atomics, so the result is the stable linear order and
// is deterministic. The Pallas padding correction (its tiles padded T up
// to a multiple of the tile with ids aliased to expert E-1) has no
// counterpart: the last tile is masked here.
//
// Bound: bytes (T ids read, T positions and E counts written). Each block
// reads all T ids, E times in all, mostly from L2; on the decode path
// (T = 48, E = 64) the kernel is a single wave of tiny blocks and its time
// is the launch.
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__global__ void __launch_bounds__(kThreads)
moe_dispatch_kernel(const int32_t* __restrict__ ids,
                    int32_t* __restrict__ counts, int32_t* __restrict__ pos,
                    long long T, int E) {
  __shared__ int warp_hits[kWarps];
  const int e = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int carry = 0;
  for (long long base = 0; base < T; base += kThreads) {
    const long long i = base + threadIdx.x;
    const bool in = i < T;
    const int32_t id = in ? ids[i] : 0;
    const bool hit = in && id == e;
    const unsigned ballot = __ballot_sync(0xffffffffu, hit);
    if (lane == 0) warp_hits[warp] = __popc(ballot);
    __syncthreads();
    int before = carry;
    int tile = 0;
    for (int w = 0; w < kWarps; ++w) {
      const int c = warp_hits[w];
      before += w < warp ? c : 0;
      tile += c;
    }
    before += __popc(ballot & ((1u << lane) - 1u));
    // the expert's own tokens, and the negative ids that wrap onto it
    if (hit || (in && id == e - E)) pos[i] = before;
    if (e == 0 && in && (id < -E || id >= E)) pos[i] = INT_MIN;
    carry += tile;
    __syncthreads();
  }
  if (threadIdx.x == 0) counts[e] = carry;
}

}  // namespace

extern "C" int repro_moe_dispatch(const void* ids, void* counts, void* pos,
                                  long long T, int E, void* stream) {
  if (E > 0) {
    moe_dispatch_kernel<<<static_cast<unsigned>(E), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(ids), static_cast<int32_t*>(counts),
        static_cast<int32_t*>(pos), T, E);
  }
  return static_cast<int>(cudaGetLastError());
}

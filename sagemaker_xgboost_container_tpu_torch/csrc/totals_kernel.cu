// Per-node totals: out[w] = sum of grad, out[W + w] = sum of hess, over the
// rows with node_local == w. Rows whose node_local lies outside [0, W)
// contribute nothing. The tree builder's last level needs only these.
//
// Replaces the Pallas TPU kernel sagemaker_xgboost_container_tpu/ops/
// histogram.py::_totals_pallas_fn (reached through _totals_pallas and
// node_totals), a one-hot-scaled row sum into a VMEM [1, 2W] accumulator.
//
// What bounds it on an H100: the bytes read, n * 12 (grad, hess, node),
// against HBM bandwidth; at n = 1M that is 12 MB, about 4 us at 3.35 TB/s.
//
// Design: two kernels, enqueued in order on one stream, with no atomics, no
// host synchronisation and no zero fill (every output cell is written):
//
//   totals_partial  a persistent grid of P CTAs; CTA c takes the equal slice
//                   [c*S, (c+1)*S) of the rows, S = ceil(n / P). Each warp
//                   owns a private [2W] f32 copy in shared memory and walks
//                   its share of the slice 32 consecutive rows at a time
//                   (coalesced): lanes that share a node are grouped with
//                   __match_any_sync and summed by shuffles, and the group's
//                   one leader adds into the warp's copy with a plain
//                   load-add-store (no other lane or warp writes there). At
//                   the end thread i sums the warps' copies at i in warp
//                   order into pieces[c, i];
//   totals_reduce   for each output cell i, 16 groups of threads each sum
//                   one run of consecutive pieces (CTAs [r*R, (r+1)*R), R =
//                   ceil(P / 16)) in CTA order; one thread then sums the 16
//                   run sums in run order into out[i] (one thread summing
//                   all P pieces would wait on one load after another).
//
// Every sum is taken in an order fixed by n, W and P alone, so two calls on
// the same inputs give bitwise-equal totals.
//
// What holds it back: the warp step (match, shuffles, the leader's shared
// load-add-store) costs more than the loads. The grid fills each SM with as
// many CTAs as their shared memory allows, up to 4 (32 warps at W = 256), to
// keep more rows in flight.

#include <cuda_runtime.h>
#include <stdint.h>

#include "kernels.h"

namespace {

constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kMaxWarps = 8;        // totals_partial: warps of a CTA
constexpr int kRowUnroll = 4;       // 32-row groups a warp has in flight
constexpr int kReduceLanes = 32;    // totals_reduce: output cells per CTA
constexpr int kReduceGroups = 16;   // runs of pieces summed side by side per cell

// Sum g and h over the lanes of `peers` (the calling lane's group); the
// results are valid on the group's lowest lane. All 32 lanes must call it
// together. The order of the additions depends on `peers` alone.
__device__ __forceinline__ void reduce_peers(unsigned peers, float& g, float& h,
                                             int lane) {
  int rel_pos = __popc(peers & ((1u << lane) - 1u));
  peers &= (0xfffffffeu << lane);  // only the peers above this lane
  while (__any_sync(kFullMask, peers != 0u)) {
    const int next = __ffs(peers);
    const int src = (next - 1) & 31;
    const float tg = __shfl_sync(kFullMask, g, src);
    const float th = __shfl_sync(kFullMask, h, src);
    if (next) {
      g += tg;
      h += th;
    }
    const int done = rel_pos & 1;
    peers &= ~__ballot_sync(kFullMask, done);
    rel_pos >>= 1;
  }
}

__global__ void __launch_bounds__(kMaxWarps * 32)
totals_partial(const float* __restrict__ grad, const float* __restrict__ hess,
               const int32_t* __restrict__ node, float* __restrict__ pieces,
               long long n, int W, long long rows_per_cta) {
  extern __shared__ float acc[];  // [warps][2W]: g totals, then h totals
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const int W2 = 2 * W;
  float* mine = acc + (long long)warp * W2;
  for (int i = lane; i < W2; i += 32) mine[i] = 0.0f;
  __syncwarp();

  const long long r0 = (long long)blockIdx.x * rows_per_cta;
  const long long r1 = min(n, r0 + rows_per_cta);
  const long long group = 32LL * kRowUnroll;
  // `base` is the same on every lane of a warp, so the loop is warp-uniform
  for (long long base = r0 + group * warp; base < r1; base += group * warps) {
    int key[kRowUnroll];
    float g[kRowUnroll];
    float h[kRowUnroll];
#pragma unroll
    for (int u = 0; u < kRowUnroll; ++u) {
      const long long row = base + 32LL * u + lane;
      key[u] = -1;
      g[u] = 0.0f;
      h[u] = 0.0f;
      if (row < r1) {
        const int nd = __ldg(node + row);
        const float gv = __ldg(grad + row);
        const float hv = __ldg(hess + row);
        if ((unsigned)nd < (unsigned)W) {
          key[u] = nd;
          g[u] = gv;
          h[u] = hv;
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kRowUnroll; ++u) {
      const unsigned peers = __match_any_sync(kFullMask, key[u]);
      reduce_peers(peers, g[u], h[u], lane);
      // one leader per key in the warp: no other lane writes these cells
      if (key[u] >= 0 && lane == __ffs(peers) - 1) {
        mine[key[u]] += g[u];
        mine[W + key[u]] += h[u];
      }
      // the next group's leader of a key may be another lane
      __syncwarp();
    }
  }
  __syncthreads();

  float* piece = pieces + (long long)blockIdx.x * W2;
  for (int i = threadIdx.x; i < W2; i += blockDim.x) {
    float s = acc[i];
    for (int w = 1; w < warps; ++w) s += acc[(long long)w * W2 + i];
    piece[i] = s;
  }
}

__global__ void __launch_bounds__(kReduceLanes * kReduceGroups)
totals_reduce(const float* __restrict__ pieces, float* __restrict__ out, int W2,
              int P) {
  __shared__ float part[kReduceGroups][kReduceLanes];
  const int i = blockIdx.x * kReduceLanes + threadIdx.x;
  const int run = (P + kReduceGroups - 1) / kReduceGroups;
  float s = 0.0f;
  if (i < W2) {
    const int c1 = min(P, ((int)threadIdx.y + 1) * run);
#pragma unroll 8
    for (int c = threadIdx.y * run; c < c1; ++c)
      s += __ldg(pieces + (long long)c * W2 + i);
  }
  part[threadIdx.y][threadIdx.x] = s;
  __syncthreads();
  if (threadIdx.y == 0 && i < W2) {
    for (int r = 1; r < kReduceGroups; ++r) s += part[r][threadIdx.x];
    out[i] = s;
  }
}

}  // namespace

extern "C" int totals_launch(const float* grad, const float* hess,
                             const int32_t* node, float* out, float* pieces,
                             long long n, int W, int ctas, int warps_per_cta,
                             long long rows_per_cta, int smem_bytes,
                             void* stream) {
  if (warps_per_cta < 1 || warps_per_cta > kMaxWarps || ctas < 1)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaFuncSetAttribute(
      totals_partial, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  totals_partial<<<ctas, warps_per_cta * 32, smem_bytes, s>>>(
      grad, hess, node, pieces, n, W, rows_per_cta);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const int W2 = 2 * W;
  totals_reduce<<<(W2 + kReduceLanes - 1) / kReduceLanes,
                  dim3(kReduceLanes, kReduceGroups), 0, s>>>(pieces, out, W2, ctas);
  return (int)cudaGetLastError();
}

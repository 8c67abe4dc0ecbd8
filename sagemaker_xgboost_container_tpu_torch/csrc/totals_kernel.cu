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
// Atomic throughput is the practical limit, and this design cuts the atomics
// down: each warp loads 32 consecutive rows (coalesced), groups lanes that
// share a node with __match_any_sync, sums each group with shuffles, and the
// group's first lane adds once into a [2W] shared accumulator. Each CTA
// flushes its accumulator to global memory once, with f32 atomics whose
// order varies from run to run.

#include <cuda_runtime.h>
#include <stdint.h>

#include "kernels.h"

namespace {

constexpr int kTotalsThreads = 256;
constexpr unsigned kFullMask = 0xffffffffu;

// Sum x over the lanes of `peers` (the calling lane's group); the result is
// valid on the group's lowest lane. All 32 lanes must call it together.
__device__ __forceinline__ float reduce_peers(unsigned peers, float x,
                                              int lane) {
  int rel_pos = __popc(peers & ((1u << lane) - 1u));
  peers &= (0xfffffffeu << lane);  // only the peers above this lane
  while (__any_sync(kFullMask, peers != 0u)) {
    const int next = __ffs(peers);
    const float t = __shfl_sync(kFullMask, x, (next - 1) & 31);
    if (next) x += t;
    const int done = rel_pos & 1;
    peers &= ~__ballot_sync(kFullMask, done);
    rel_pos >>= 1;
  }
  return x;
}

__global__ void __launch_bounds__(kTotalsThreads)
totals_kernel(const float* __restrict__ grad, const float* __restrict__ hess,
              const int32_t* __restrict__ node, float* __restrict__ out,
              long long n, int W) {
  extern __shared__ float acc[];  // [2W]: g totals, then h totals
  for (int i = threadIdx.x; i < 2 * W; i += blockDim.x) acc[i] = 0.0f;
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const long long warp =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const long long warps = ((long long)gridDim.x * blockDim.x) >> 5;
  // `base` is the same on every lane of a warp, so the loop is warp-uniform
  for (long long base = warp * 32; base < n; base += warps * 32) {
    const long long row = base + lane;
    int key = -1;
    float g = 0.0f;
    float h = 0.0f;
    if (row < n) {
      const int nd = __ldg(node + row);
      if (nd >= 0 && nd < W) {
        key = nd;
        g = __ldg(grad + row);
        h = __ldg(hess + row);
      }
    }
    const unsigned peers = __match_any_sync(kFullMask, key);
    g = reduce_peers(peers, g, lane);
    h = reduce_peers(peers, h, lane);
    if (key >= 0 && lane == __ffs(peers) - 1) {
      atomicAdd(acc + key, g);
      atomicAdd(acc + W + key, h);
    }
  }
  __syncthreads();

  for (int i = threadIdx.x; i < 2 * W; i += blockDim.x) {
    const float v = acc[i];
    if (v != 0.0f) atomicAdd(out + i, v);
  }
}

}  // namespace

extern "C" int totals_launch(const float* grad, const float* hess,
                             const int32_t* node, float* out, long long n,
                             int W, int blocks, void* stream) {
  const int smem_bytes = 2 * W * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      totals_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  totals_kernel<<<blocks, kTotalsThreads, smem_bytes,
                  static_cast<cudaStream_t>(stream)>>>(grad, hess, node, out,
                                                       n, W);
  return (int)cudaGetLastError();
}

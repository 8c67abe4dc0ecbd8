// Per-level gradient/hessian histograms: G[w, f, b] = sum of grad over the
// rows with node_local == w and bins[row, f] == b (H likewise with hess).
// Rows whose node_local lies outside [0, W) contribute nothing.
//
// Replaces the Pallas TPU kernel sagemaker_xgboost_container_tpu/ops/
// histogram.py::_pallas_hist_fn (reached through _hist_pallas and
// level_histogram). That kernel builds one-hot matrices and contracts them on
// the MXU; it is not carried over. On Hopper the natural form is a scatter
// into a histogram privatized in shared memory.
//
// What bounds it on an H100: the bytes read, n * (d * sizeof(bin) + 12)
// (bins, grad, hess, node), against HBM bandwidth; at 1M x 28 u16 rows that
// is 68 MB, about 20 us at 3.35 TB/s. In practice shared-memory atomic
// throughput and the global flush of the per-CTA histograms are the limit.
//
// Design: the grid runs over (row chunk, feature tile, node range). Each CTA
// keeps [node range, feature tile, B] x (g, h) f32 in dynamic shared memory,
// walks its row chunk with consecutive threads on consecutive features of a
// row (coalesced bin reads), adds with shared-memory atomics, and flushes
// its non-zero cells to G/H with global atomics. When W*B*8 bytes do not fit
// the budget the node axis splits across grid.z and a CTA skips rows outside
// its range. f32 atomics make the summation order, and so the last bits of
// each sum, vary from run to run.

#include <cuda_runtime.h>
#include <stdint.h>

#include "kernels.h"

namespace {

constexpr int kHistThreads = 512;

template <typename BinT>
__global__ void __launch_bounds__(kHistThreads)
hist_kernel(const BinT* __restrict__ bins, const float* __restrict__ grad,
            const float* __restrict__ hess, const int32_t* __restrict__ node,
            float* __restrict__ G, float* __restrict__ H, long long n, int d,
            int W, int B, int rows_per_chunk, int feature_tile,
            int node_range) {
  extern __shared__ float smem[];
  const int f0 = blockIdx.y * feature_tile;
  const int nf = min(feature_tile, d - f0);
  const int n0 = blockIdx.z * node_range;
  const int nn = min(node_range, W - n0);
  if (nf <= 0 || nn <= 0) return;  // uniform over the block
  const int cells = nn * nf * B;
  float* sg = smem;
  float* sh = smem + cells;
  for (int i = threadIdx.x; i < 2 * cells; i += blockDim.x) smem[i] = 0.0f;
  __syncthreads();

  const long long r0 = (long long)blockIdx.x * rows_per_chunk;
  const long long r_end = min(n, r0 + (long long)rows_per_chunk);
  const int rows = r_end > r0 ? (int)(r_end - r0) : 0;
  const int items = rows * nf;
  for (int i = threadIdx.x; i < items; i += blockDim.x) {
    const int r = i / nf;
    const int f = i - r * nf;
    const long long row = r0 + r;
    const int nd = __ldg(node + row) - n0;
    if (nd < 0 || nd >= nn) continue;
    const int b = (int)bins[row * d + f0 + f];
    if (b < 0 || b >= B) continue;
    const int cell = (nd * nf + f) * B + b;
    atomicAdd(sg + cell, __ldg(grad + row));
    atomicAdd(sh + cell, __ldg(hess + row));
  }
  __syncthreads();

  for (int i = threadIdx.x; i < cells; i += blockDim.x) {
    const int b = i % B;
    const int t = i / B;
    const int f = t % nf;
    const int nd = t / nf;
    const long long out = ((long long)(n0 + nd) * d + (f0 + f)) * B + b;
    const float vg = sg[i];
    const float vh = sh[i];
    if (vg != 0.0f) atomicAdd(G + out, vg);
    if (vh != 0.0f) atomicAdd(H + out, vh);
  }
}

template <typename BinT>
int launch_typed(const void* bins, const float* grad, const float* hess,
                 const int32_t* node, float* G, float* H, long long n, int d,
                 int W, int B, int rows_per_chunk, int row_chunks,
                 int feature_tile, int feature_tiles, int node_range,
                 int node_ranges, int smem_bytes, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      hist_kernel<BinT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(row_chunks, feature_tiles, node_ranges);
  hist_kernel<BinT><<<grid, kHistThreads, smem_bytes, stream>>>(
      static_cast<const BinT*>(bins), grad, hess, node, G, H, n, d, W, B,
      rows_per_chunk, feature_tile, node_range);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int hist_launch(const void* bins, int bin_bytes, const float* grad,
                           const float* hess, const int32_t* node, float* G,
                           float* H, long long n, int d, int W, int B,
                           int rows_per_chunk, int row_chunks,
                           int feature_tile, int feature_tiles, int node_range,
                           int node_ranges, int smem_bytes, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (bin_bytes) {
    case 1:
      return launch_typed<uint8_t>(bins, grad, hess, node, G, H, n, d, W, B,
                                   rows_per_chunk, row_chunks, feature_tile,
                                   feature_tiles, node_range, node_ranges,
                                   smem_bytes, s);
    case 2:
      return launch_typed<uint16_t>(bins, grad, hess, node, G, H, n, d, W, B,
                                    rows_per_chunk, row_chunks, feature_tile,
                                    feature_tiles, node_range, node_ranges,
                                    smem_bytes, s);
    case 4:
      return launch_typed<int32_t>(bins, grad, hess, node, G, H, n, d, W, B,
                                   rows_per_chunk, row_chunks, feature_tile,
                                   feature_tiles, node_range, node_ranges,
                                   smem_bytes, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

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
// What bounds it on an H100: the bytes the active rows need, n * 4 (node)
// plus active * (d * sizeof(bin) + 8) (bins, grad, hess) plus the output,
// against HBM bandwidth; at 1M x 28 u16 rows that is at most 68 MB, about
// 20 us at 3.35 TB/s. In practice the adds bound it: sm_90a compiles an f32
// atomicAdd on shared memory to a compare-and-swap loop (ATOMS.CAST.SPIN),
// two per (row, feature); integer shared atomics are native (ATOMS.ADD).
//
// Design (the form of xgboost's gpu_hist): rows are partitioned by node, so
// a CTA holds one node's histogram at a time and reads only the rows it
// needs. Five kernels, enqueued in order on one stream, with no host
// synchronisation (node sizes stay on the device):
//
//   hist_count    per row chunk c, the active rows of each node, counted in
//                 shared memory (lanes of a warp that share a node add once)
//                 and stored to counts[w, c] without atomics;
//   hist_scan     one CTA: base[w, c], the exclusive prefix of counts over c,
//                 and offsets[w], the exclusive prefix of the node totals;
//                 offsets[W] is the number of active rows;
//   hist_scatter  each row chunk again: row ids into order[], grouped by
//                 node, at offsets[w] + base[w, c] plus a shared cursor (the
//                 order within a node is free);
//   hist_kernel   a persistent grid of P CTAs (times feature tiles): CTA c
//                 takes the equal slice [c*S, (c+1)*S) of order, S =
//                 ceil(total / P), and walks it node segment by node segment.
//                 Each segment is added into a [feature tile, B] x (g, h) f32
//                 histogram in shared memory, consecutive threads on
//                 consecutive features of one gathered row (one contiguous
//                 run of bins), and written without atomics to the scratch
//                 piece c + w, unique along the monotone (c, w) path;
//   hist_reduce   every output cell (w, f, b) sums the pieces of the CTAs
//                 whose slices overlap node w in a fixed order and writes G
//                 and H (a node with no rows gets zeros).
//
// No global atomics remain. Inside a CTA the shared-memory atomics add in a
// varying order, so the last bits of each sum still vary from run to run.

#include <cuda_runtime.h>
#include <stdint.h>

#include "kernels.h"

namespace {

constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kPartThreads = 512;  // hist_count, hist_scatter
constexpr int kPartUnroll = 4;     // rows a lane has in flight there
constexpr int kScanThreads = 1024;
constexpr int kHistThreads = 512;
constexpr int kHistUnroll = 8;     // rows a thread has in flight
constexpr int kReduceLanes = 32;   // output cells per reduce CTA
constexpr int kReduceGroups = 8;   // pieces summed side by side per cell

__device__ __forceinline__ int active_node(const int32_t* node, long long row,
                                           long long end, int W) {
  const int key = row < end ? __ldg(node + row) : -1;
  return (unsigned)key < (unsigned)W ? key : -1;
}

__global__ void __launch_bounds__(kPartThreads)
hist_count(const int32_t* __restrict__ node, int32_t* __restrict__ counts,
           long long n, int W, long long rows_per_cta) {
  extern __shared__ int32_t cnt[];
  for (int w = threadIdx.x; w < W; w += blockDim.x) cnt[w] = 0;
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const long long r0 = (long long)blockIdx.x * rows_per_cta;
  const long long r1 = min(n, r0 + rows_per_cta);
  // `base` is the same on every lane of a warp, so the loop is warp-uniform
  for (long long base = r0 + (threadIdx.x & ~31); base < r1;
       base += (long long)kPartUnroll * blockDim.x) {
    int key[kPartUnroll];
#pragma unroll
    for (int u = 0; u < kPartUnroll; ++u)
      key[u] = active_node(node, base + (long long)u * blockDim.x + lane, r1, W);
#pragma unroll
    for (int u = 0; u < kPartUnroll; ++u) {
      const unsigned peers = __match_any_sync(kFullMask, key[u]);
      if (key[u] >= 0 && lane == __ffs(peers) - 1)
        atomicAdd(cnt + key[u], __popc(peers));
    }
  }
  __syncthreads();
  for (int w = threadIdx.x; w < W; w += blockDim.x)
    counts[(long long)w * gridDim.x + blockIdx.x] = cnt[w];
}

__device__ __forceinline__ int warp_inclusive_scan(int v, int lane) {
#pragma unroll
  for (int s = 1; s < 32; s <<= 1) {
    const int t = __shfl_up_sync(kFullMask, v, s);
    if (lane >= s) v += t;
  }
  return v;
}

__global__ void __launch_bounds__(kScanThreads)
hist_scan(const int32_t* __restrict__ counts, int32_t* __restrict__ base,
          int32_t* __restrict__ offsets, int W, int ctas) {
  extern __shared__ int32_t totals[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  for (int w = warp; w < W; w += warps) {
    const int32_t* cw = counts + (long long)w * ctas;
    int32_t* bw = base + (long long)w * ctas;
    int carry = 0;
    for (int c0 = 0; c0 < ctas; c0 += 32) {
      const int c = c0 + lane;
      const int v = c < ctas ? cw[c] : 0;
      const int incl = warp_inclusive_scan(v, lane);
      if (c < ctas) bw[c] = carry + incl - v;
      carry += __shfl_sync(kFullMask, incl, 31);
    }
    if (lane == 0) totals[w] = carry;
  }
  __syncthreads();
  if (warp == 0) {
    int carry = 0;
    for (int w0 = 0; w0 < W; w0 += 32) {
      const int w = w0 + lane;
      const int v = w < W ? totals[w] : 0;
      const int incl = warp_inclusive_scan(v, lane);
      if (w < W) offsets[w] = carry + incl - v;
      carry += __shfl_sync(kFullMask, incl, 31);
    }
    if (lane == 0) offsets[W] = carry;
  }
}

__global__ void __launch_bounds__(kPartThreads)
hist_scatter(const int32_t* __restrict__ node, const int32_t* __restrict__ base,
             const int32_t* __restrict__ offsets, int32_t* __restrict__ order,
             long long n, int W, long long rows_per_cta) {
  extern __shared__ int32_t cursor[];
  for (int w = threadIdx.x; w < W; w += blockDim.x)
    cursor[w] = offsets[w] + base[(long long)w * gridDim.x + blockIdx.x];
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  const long long r0 = (long long)blockIdx.x * rows_per_cta;
  const long long r1 = min(n, r0 + rows_per_cta);
  for (long long base_row = r0 + (threadIdx.x & ~31); base_row < r1;
       base_row += (long long)kPartUnroll * blockDim.x) {
    int key[kPartUnroll];
#pragma unroll
    for (int u = 0; u < kPartUnroll; ++u)
      key[u] = active_node(node, base_row + (long long)u * blockDim.x + lane, r1, W);
#pragma unroll
    for (int u = 0; u < kPartUnroll; ++u) {
      const unsigned peers = __match_any_sync(kFullMask, key[u]);
      const int leader = __ffs(peers) - 1;
      int pos = 0;
      if (key[u] >= 0 && lane == leader) pos = atomicAdd(cursor + key[u], __popc(peers));
      pos = __shfl_sync(kFullMask, pos, leader);
      if (key[u] >= 0)
        order[pos + __popc(peers & below)] =
            (int32_t)(base_row + (long long)u * blockDim.x + lane);
    }
  }
}

// The slice of order[] that CTA c of P takes; both hist_kernel and
// hist_reduce derive it from offsets[W] alone.
__device__ __forceinline__ long long slice_rows(int total, int P) {
  return ((long long)total + P - 1) / P;
}

template <typename BinT>
__global__ void __launch_bounds__(kHistThreads, 2)
hist_kernel(const BinT* __restrict__ bins, const float* __restrict__ grad,
            const float* __restrict__ hess, const int32_t* __restrict__ order,
            const int32_t* __restrict__ offsets, float* __restrict__ piece_g,
            float* __restrict__ piece_h, int d, int W, int B, int P,
            int feature_tile) {
  extern __shared__ float smem[];
  const int f0 = blockIdx.y * feature_tile;
  const int nf = min(feature_tile, d - f0);
  const int c = blockIdx.x;
  const int total = offsets[W];
  const long long S = slice_rows(total, P);
  long long lo = (long long)c * S;
  const long long hi = min((long long)total, lo + S);
  if (nf <= 0 || lo >= hi) return;  // uniform over the block

  // the node holding row lo of order: the last w with offsets[w] <= lo
  int w = 0;
  for (int span = W; span > 0;) {
    const int half = span >> 1;
    if (offsets[w + half + 1] <= lo) {
      w += half + 1;
      span -= half + 1;
    } else {
      span = half;
    }
  }

  const int cells = nf * B;
  float* sg = smem;
  float* sh = smem + cells;
  for (int i = threadIdx.x; i < 2 * cells; i += blockDim.x) smem[i] = 0.0f;
  __syncthreads();

  // thread = (row slot, feature): R rows side by side, nf features each;
  // when nf exceeds the block, one row at a time and features in a loop
  const int R = max(1, (int)blockDim.x / nf);
  const int rs = threadIdx.x / nf;
  const int fl = threadIdx.x - rs * nf;
  const long long dd = d;
  while (true) {
    const long long seg_end = min(hi, (long long)offsets[w + 1]);
    if (rs < R) {
      for (int f = fl; f < nf; f += blockDim.x) {
        const BinT* col = bins + f0 + f;
        float* cg = sg + f * B;
        float* ch = sh + f * B;
        for (long long j0 = lo + rs; j0 < seg_end; j0 += (long long)R * kHistUnroll) {
          int row[kHistUnroll];
#pragma unroll
          for (int u = 0; u < kHistUnroll; ++u) {
            const long long j = j0 + (long long)u * R;
            row[u] = j < seg_end ? __ldg(order + j) : -1;
          }
          unsigned b[kHistUnroll];
          float g[kHistUnroll];
          float h[kHistUnroll];
#pragma unroll
          for (int u = 0; u < kHistUnroll; ++u) {
            b[u] = (unsigned)B;
            g[u] = 0.0f;
            h[u] = 0.0f;
            if (row[u] >= 0) {
              b[u] = (unsigned)(int)col[row[u] * dd];
              g[u] = __ldg(grad + row[u]);
              h[u] = __ldg(hess + row[u]);
            }
          }
#pragma unroll
          for (int u = 0; u < kHistUnroll; ++u) {
            if (b[u] < (unsigned)B) {  // also drops negative int32 bins
              atomicAdd(cg + b[u], g[u]);
              atomicAdd(ch + b[u], h[u]);
            }
          }
        }
      }
    }
    __syncthreads();
    // the finished segment goes to piece c + w; each thread zeroes what it
    // wrote, so the next segment starts from an empty histogram
    const long long slot = (long long)c + w;
    float* pg = piece_g + (slot * dd + f0) * B;
    float* ph = piece_h + (slot * dd + f0) * B;
    for (int i = threadIdx.x; i < cells; i += blockDim.x) {
      pg[i] = sg[i];
      ph[i] = sh[i];
      sg[i] = 0.0f;
      sh[i] = 0.0f;
    }
    lo = seg_end;
    if (lo >= hi) break;
    __syncthreads();
    // the next node with rows (empty nodes end where they start)
    do {
      ++w;
    } while (offsets[w + 1] <= lo);
  }
}

__global__ void __launch_bounds__(kReduceLanes * kReduceGroups)
hist_reduce(const float* __restrict__ piece_g, const float* __restrict__ piece_h,
            const int32_t* __restrict__ offsets, float* __restrict__ G,
            float* __restrict__ H, int d, int W, int B, int P) {
  __shared__ float part_g[kReduceGroups][kReduceLanes];
  __shared__ float part_h[kReduceGroups][kReduceLanes];
  const long long dB = (long long)d * B;
  const long long cells = dB * W;
  const long long cell = (long long)blockIdx.x * kReduceLanes + threadIdx.x;
  float g = 0.0f;
  float h = 0.0f;
  if (cell < cells) {
    const int w = (int)(cell / dB);
    const long long rest = cell - w * dB;
    const int a = offsets[w];
    const int e = offsets[w + 1];
    if (e > a) {
      const long long S = slice_rows(offsets[W], P);
      const int c_lo = (int)(a / S);
      const int c_hi = (int)((e - 1) / S);
      for (int c = c_lo + threadIdx.y; c <= c_hi; c += kReduceGroups) {
        const long long at = ((long long)c + w) * dB + rest;
        g += piece_g[at];
        h += piece_h[at];
      }
    }
  }
  part_g[threadIdx.y][threadIdx.x] = g;
  part_h[threadIdx.y][threadIdx.x] = h;
  __syncthreads();
  if (threadIdx.y == 0 && cell < cells) {
    for (int k = 1; k < kReduceGroups; ++k) {
      g += part_g[k][threadIdx.x];
      h += part_h[k][threadIdx.x];
    }
    G[cell] = g;
    H[cell] = h;
  }
}

template <typename Kernel>
cudaError_t allow_smem(Kernel* kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

template <typename BinT>
int launch_typed(const void* bins, const float* grad, const float* hess,
                 const int32_t* node, float* G, float* H, int32_t* work,
                 float* pieces, long long n, int d, int W, int B, int ctas,
                 int feature_tile, int feature_tiles, int smem_bytes,
                 int count_ctas, long long rows_per_count_cta,
                 cudaStream_t stream) {
  const long long wc = (long long)W * count_ctas;
  int32_t* counts = work;
  int32_t* base = counts + wc;
  int32_t* offsets = base + wc;
  int32_t* order = offsets + W + 1;
  const long long piece_floats = ((long long)ctas + W) * d * B;
  float* piece_g = pieces;
  float* piece_h = pieces + piece_floats;
  const int node_smem = W * (int)sizeof(int32_t);

  cudaError_t err;
  if ((err = allow_smem(hist_count, node_smem)) != cudaSuccess ||
      (err = allow_smem(hist_scan, node_smem)) != cudaSuccess ||
      (err = allow_smem(hist_scatter, node_smem)) != cudaSuccess ||
      (err = allow_smem(hist_kernel<BinT>, smem_bytes)) != cudaSuccess)
    return (int)err;

  hist_count<<<count_ctas, kPartThreads, node_smem, stream>>>(
      node, counts, n, W, rows_per_count_cta);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  hist_scan<<<1, kScanThreads, node_smem, stream>>>(counts, base, offsets, W,
                                                    count_ctas);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  hist_scatter<<<count_ctas, kPartThreads, node_smem, stream>>>(
      node, base, offsets, order, n, W, rows_per_count_cta);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  hist_kernel<BinT><<<dim3(ctas, feature_tiles), kHistThreads, smem_bytes, stream>>>(
      static_cast<const BinT*>(bins), grad, hess, order, offsets, piece_g,
      piece_h, d, W, B, ctas, feature_tile);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const long long reduce_ctas = ((long long)W * d * B + kReduceLanes - 1) / kReduceLanes;
  hist_reduce<<<(unsigned)reduce_ctas, dim3(kReduceLanes, kReduceGroups), 0, stream>>>(
      piece_g, piece_h, offsets, G, H, d, W, B, ctas);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int hist_launch(const void* bins, int bin_bytes, const float* grad,
                           const float* hess, const int32_t* node, float* G,
                           float* H, int32_t* work, float* pieces, long long n,
                           int d, int W, int B, int ctas, int feature_tile,
                           int feature_tiles, int smem_bytes, int count_ctas,
                           long long rows_per_count_cta, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (bin_bytes) {
    case 1:
      return launch_typed<uint8_t>(bins, grad, hess, node, G, H, work, pieces,
                                   n, d, W, B, ctas, feature_tile, feature_tiles,
                                   smem_bytes, count_ctas, rows_per_count_cta, s);
    case 2:
      return launch_typed<uint16_t>(bins, grad, hess, node, G, H, work, pieces,
                                    n, d, W, B, ctas, feature_tile, feature_tiles,
                                    smem_bytes, count_ctas, rows_per_count_cta, s);
    case 4:
      return launch_typed<int32_t>(bins, grad, hess, node, G, H, work, pieces,
                                   n, d, W, B, ctas, feature_tile, feature_tiles,
                                   smem_bytes, count_ctas, rows_per_count_cta, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

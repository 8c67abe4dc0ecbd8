// Per-level gradient/hessian histograms: G[c, w, f, b] = sum of grad[c, row]
// over the rows with node_local[c, row] == w and bins[row, f] == b (H likewise
// with hess), for each of C classes that share the bins. Rows whose
// node_local lies outside [0, W) contribute nothing.
//
// Replaces the Pallas TPU kernel sagemaker_xgboost_container_tpu/ops/
// histogram.py::_pallas_hist_fn (reached through _hist_pallas and
// level_histogram; under jax.vmap over the classes it gets a batch grid
// axis). That kernel builds one-hot matrices and contracts them on the MXU;
// it is not carried over. On Hopper the natural form is a scatter into a
// histogram privatized in shared memory.
//
// The class axis is folded into the key: entry i of the C*n entries (class
// i / n, bin row i % n) has key (i / n) * W + node[i], so the kernels below
// see K = C*W keys and one launch serves every class. Each class reads the
// shared bins again.
//
// What bounds it on an H100: the bytes the active entries need, C*n * 4
// (node) plus active * (d * sizeof(bin) + 8) (bins, grad, hess) plus the
// output, against HBM bandwidth; at 1M x 28 u16 rows and C = 1 that is at
// most 68 MB, about 20 us at 3.35 TB/s. In practice the adds bound it:
// sm_90a compiles an f32 atomicAdd on shared memory to a compare-and-swap
// loop (ATOMS.CAST.SPIN), two per (entry, feature); integer shared atomics
// are native (ATOMS.ADD).
//
// Design (the form of xgboost's gpu_hist): entries are partitioned by key,
// so a CTA holds one key's histogram at a time and reads only the entries
// it needs. Five kernels, enqueued in order on one stream, with no host
// synchronisation (key sizes stay on the device):
//
//   hist_count    per entry chunk c, the active entries of each key, counted
//                 in shared memory (lanes of a warp that share a key add
//                 once) and stored to counts[k, c] without atomics;
//   hist_scan     one CTA: base[k, c], the exclusive prefix of counts over
//                 c, and offsets[k], the exclusive prefix of the key totals;
//                 offsets[K] is the number of active entries;
//   hist_scatter  each entry chunk again: entry ids into order[], grouped
//                 by key, at offsets[k] + base[k, c] plus a shared cursor
//                 (the order within a key is free);
//   hist_kernel   a persistent grid of P CTAs (times feature tiles, times
//                 bin tiles): CTA c takes the equal slice [c*S, (c+1)*S) of
//                 order, S = ceil(total / P), and walks it key segment by key
//                 segment. Each segment is added into a [feature tile, bin
//                 tile] x (g, h) f32 histogram in shared memory, consecutive
//                 threads on consecutive features of one gathered row (one
//                 contiguous run of bins), and its tile's cells are written
//                 without atomics to the scratch piece c + k, unique along
//                 the monotone (c, k) path. One bin tile holds all B bins
//                 unless a feature's bins exceed the shared memory (exact
//                 binning's data-sized u16 widths, B > 12,672); then each
//                 CTA of a tile adds only the entries whose bin lies in it,
//                 and the order of additions within a cell is unchanged;
//   hist_reduce   every output cell (k, f, b) sums the pieces of the CTAs
//                 whose slices overlap key k in a fixed order and writes G
//                 and H (a key with no entries gets zeros).
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

// The key of entry i of `end`: class i / rows times W plus node[i] when
// node[i] lies in [0, W), else -1. Entry ids stay below 2^31 (hist_plan).
// Every kernel that takes a class axis is compiled twice: kMulti = false
// (one class, the key is the node) keeps the single-class code free of the
// class arithmetic.
template <bool kMulti>
__device__ __forceinline__ int active_key(const int32_t* node, long long i,
                                          long long end, unsigned rows, int W) {
  const int nd = i < end ? __ldg(node + i) : -1;
  if ((unsigned)nd >= (unsigned)W) return -1;
  return kMulti ? (int)((unsigned)i / rows) * W + nd : nd;
}

template <bool kMulti>
__global__ void __launch_bounds__(kPartThreads)
hist_count(const int32_t* __restrict__ node, int32_t* __restrict__ counts,
           long long entries, unsigned rows, int W, int C,
           long long rows_per_cta) {
  extern __shared__ int32_t cnt[];
  const int K = C * W;
  for (int w = threadIdx.x; w < K; w += blockDim.x) cnt[w] = 0;
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const long long r0 = (long long)blockIdx.x * rows_per_cta;
  const long long r1 = min(entries, r0 + rows_per_cta);
  // `base` is the same on every lane of a warp, so the loop is warp-uniform
  for (long long base = r0 + (threadIdx.x & ~31); base < r1;
       base += (long long)kPartUnroll * blockDim.x) {
    int key[kPartUnroll];
#pragma unroll
    for (int u = 0; u < kPartUnroll; ++u)
      key[u] = active_key<kMulti>(node, base + (long long)u * blockDim.x + lane, r1,
                                  rows, W);
#pragma unroll
    for (int u = 0; u < kPartUnroll; ++u) {
      const unsigned peers = __match_any_sync(kFullMask, key[u]);
      if (key[u] >= 0 && lane == __ffs(peers) - 1)
        atomicAdd(cnt + key[u], __popc(peers));
    }
  }
  __syncthreads();
  for (int w = threadIdx.x; w < K; w += blockDim.x)
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
          int32_t* __restrict__ offsets, int K, int ctas) {
  extern __shared__ int32_t totals[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  for (int w = warp; w < K; w += warps) {
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
    for (int w0 = 0; w0 < K; w0 += 32) {
      const int w = w0 + lane;
      const int v = w < K ? totals[w] : 0;
      const int incl = warp_inclusive_scan(v, lane);
      if (w < K) offsets[w] = carry + incl - v;
      carry += __shfl_sync(kFullMask, incl, 31);
    }
    if (lane == 0) offsets[K] = carry;
  }
}

template <bool kMulti>
__global__ void __launch_bounds__(kPartThreads)
hist_scatter(const int32_t* __restrict__ node, const int32_t* __restrict__ base,
             const int32_t* __restrict__ offsets, int32_t* __restrict__ order,
             long long entries, unsigned rows, int W, int C,
             long long rows_per_cta) {
  extern __shared__ int32_t cursor[];
  const int K = C * W;
  for (int w = threadIdx.x; w < K; w += blockDim.x)
    cursor[w] = offsets[w] + base[(long long)w * gridDim.x + blockIdx.x];
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  const long long r0 = (long long)blockIdx.x * rows_per_cta;
  const long long r1 = min(entries, r0 + rows_per_cta);
  for (long long base_row = r0 + (threadIdx.x & ~31); base_row < r1;
       base_row += (long long)kPartUnroll * blockDim.x) {
    int key[kPartUnroll];
#pragma unroll
    for (int u = 0; u < kPartUnroll; ++u)
      key[u] = active_key<kMulti>(node, base_row + (long long)u * blockDim.x + lane,
                                  r1, rows, W);
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
// hist_reduce derive it from offsets[K] alone.
__device__ __forceinline__ long long slice_rows(int total, int P) {
  return ((long long)total + P - 1) / P;
}

// K = C*W keys; key k belongs to class k / W, whose entries start at
// (k / W) * rows, so entry e reads bin row e - (k / W) * rows.
template <typename BinT, bool kMulti>
__global__ void __launch_bounds__(kHistThreads, 2)
hist_kernel(const BinT* __restrict__ bins, const float* __restrict__ grad,
            const float* __restrict__ hess, const int32_t* __restrict__ order,
            const int32_t* __restrict__ offsets, float* __restrict__ piece_g,
            float* __restrict__ piece_h, long long rows, int d, int W, int K,
            int B, int P, int feature_tile, int bin_tile) {
  extern __shared__ float smem[];
  const int f0 = blockIdx.y * feature_tile;
  const int nf = min(feature_tile, d - f0);
  // this CTA's bins [b0, b0 + nb); all B of them unless B is tiled
  const int b0 = blockIdx.z * bin_tile;
  const int nb = min(bin_tile, B - b0);
  const int c = blockIdx.x;
  const int total = offsets[K];
  const long long S = slice_rows(total, P);
  long long lo = (long long)c * S;
  const long long hi = min((long long)total, lo + S);
  if (nf <= 0 || nb <= 0 || lo >= hi) return;  // uniform over the block

  // the key holding entry lo of order: the last w with offsets[w] <= lo
  int w = 0;
  for (int span = K; span > 0;) {
    const int half = span >> 1;
    if (offsets[w + half + 1] <= lo) {
      w += half + 1;
      span -= half + 1;
    } else {
      span = half;
    }
  }

  const int cells = nf * nb;
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
    // the segment's entries are of one class: their bin rows start here
    const long long first_entry = kMulti ? (long long)(w / W) * rows : 0;
    if (rs < R) {
      for (int f = fl; f < nf; f += blockDim.x) {
        const BinT* col = bins + f0 + f;
        float* cg = sg + f * nb;
        float* ch = sh + f * nb;
        for (long long j0 = lo + rs; j0 < seg_end; j0 += (long long)R * kHistUnroll) {
          int entry[kHistUnroll];
#pragma unroll
          for (int u = 0; u < kHistUnroll; ++u) {
            const long long j = j0 + (long long)u * R;
            entry[u] = j < seg_end ? __ldg(order + j) : -1;
          }
          unsigned b[kHistUnroll];
          float g[kHistUnroll];
          float h[kHistUnroll];
#pragma unroll
          for (int u = 0; u < kHistUnroll; ++u) {
            b[u] = (unsigned)B;
            g[u] = 0.0f;
            h[u] = 0.0f;
            if (entry[u] >= 0) {
              b[u] = (unsigned)(int)col[(entry[u] - first_entry) * dd];
              g[u] = __ldg(grad + entry[u]);
              h[u] = __ldg(hess + entry[u]);
            }
          }
#pragma unroll
          for (int u = 0; u < kHistUnroll; ++u) {
            // outside the tile (and negative int32 bins): no add
            const unsigned bt = b[u] - (unsigned)b0;
            if (bt < (unsigned)nb) {
              atomicAdd(cg + bt, g[u]);
              atomicAdd(ch + bt, h[u]);
            }
          }
        }
      }
    }
    __syncthreads();
    // the finished segment goes to piece c + w; each thread zeroes what it
    // wrote, so the next segment starts from an empty histogram
    const long long slot = (long long)c + w;
    float* pg = piece_g + (slot * dd + f0) * B + b0;
    float* ph = piece_h + (slot * dd + f0) * B + b0;
    for (int i = threadIdx.x; i < cells; i += blockDim.x) {
      // cell i is bin i % nb of feature i / nb; one tile is the whole row
      const long long at = nb == B ? i : (long long)(i / nb) * B + i % nb;
      pg[at] = sg[i];
      ph[at] = sh[i];
      sg[i] = 0.0f;
      sh[i] = 0.0f;
    }
    lo = seg_end;
    if (lo >= hi) break;
    __syncthreads();
    // the next key with entries (empty keys end where they start)
    do {
      ++w;
    } while (offsets[w + 1] <= lo);
  }
}

__global__ void __launch_bounds__(kReduceLanes * kReduceGroups)
hist_reduce(const float* __restrict__ piece_g, const float* __restrict__ piece_h,
            const int32_t* __restrict__ offsets, float* __restrict__ G,
            float* __restrict__ H, int d, int K, int B, int P) {
  __shared__ float part_g[kReduceGroups][kReduceLanes];
  __shared__ float part_h[kReduceGroups][kReduceLanes];
  const long long dB = (long long)d * B;
  const long long cells = dB * K;
  const long long cell = (long long)blockIdx.x * kReduceLanes + threadIdx.x;
  float g = 0.0f;
  float h = 0.0f;
  if (cell < cells) {
    const int w = (int)(cell / dB);
    const long long rest = cell - w * dB;
    const int a = offsets[w];
    const int e = offsets[w + 1];
    if (e > a) {
      const long long S = slice_rows(offsets[K], P);
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

template <typename BinT, bool kMulti>
int launch_typed(const void* bins, const float* grad, const float* hess,
                 const int32_t* node, float* G, float* H, int32_t* work,
                 float* pieces, long long n, int d, int W, int B, int C, int ctas,
                 int feature_tile, int feature_tiles, int bin_tile, int bin_tiles,
                 int smem_bytes, int count_ctas, long long rows_per_count_cta,
                 cudaStream_t stream) {
  const int K = C * W;
  const long long entries = (long long)C * n;
  const long long kc = (long long)K * count_ctas;
  int32_t* counts = work;
  int32_t* base = counts + kc;
  int32_t* offsets = base + kc;
  int32_t* order = offsets + K + 1;
  const long long piece_floats = ((long long)ctas + K) * d * B;
  float* piece_g = pieces;
  float* piece_h = pieces + piece_floats;
  const int key_smem = K * (int)sizeof(int32_t);

  cudaError_t err;
  if ((err = allow_smem(hist_count<kMulti>, key_smem)) != cudaSuccess ||
      (err = allow_smem(hist_scan, key_smem)) != cudaSuccess ||
      (err = allow_smem(hist_scatter<kMulti>, key_smem)) != cudaSuccess ||
      (err = allow_smem(hist_kernel<BinT, kMulti>, smem_bytes)) != cudaSuccess)
    return (int)err;

  hist_count<kMulti><<<count_ctas, kPartThreads, key_smem, stream>>>(
      node, counts, entries, (unsigned)n, W, C, rows_per_count_cta);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  hist_scan<<<1, kScanThreads, key_smem, stream>>>(counts, base, offsets, K,
                                                   count_ctas);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  hist_scatter<kMulti><<<count_ctas, kPartThreads, key_smem, stream>>>(
      node, base, offsets, order, entries, (unsigned)n, W, C, rows_per_count_cta);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  hist_kernel<BinT, kMulti>
      <<<dim3(ctas, feature_tiles, bin_tiles), kHistThreads, smem_bytes, stream>>>(
      static_cast<const BinT*>(bins), grad, hess, order, offsets, piece_g,
      piece_h, n, d, W, K, B, ctas, feature_tile, bin_tile);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const long long reduce_ctas = ((long long)K * d * B + kReduceLanes - 1) / kReduceLanes;
  hist_reduce<<<(unsigned)reduce_ctas, dim3(kReduceLanes, kReduceGroups), 0, stream>>>(
      piece_g, piece_h, offsets, G, H, d, K, B, ctas);
  return (int)cudaGetLastError();
}

template <typename BinT>
int launch_bins(const void* bins, const float* grad, const float* hess,
                const int32_t* node, float* G, float* H, int32_t* work,
                float* pieces, long long n, int d, int W, int B, int C, int ctas,
                int feature_tile, int feature_tiles, int bin_tile, int bin_tiles,
                int smem_bytes, int count_ctas, long long rows_per_count_cta,
                cudaStream_t stream) {
  return C > 1
      ? launch_typed<BinT, true>(bins, grad, hess, node, G, H, work, pieces, n, d,
                                 W, B, C, ctas, feature_tile, feature_tiles, bin_tile,
                                 bin_tiles, smem_bytes, count_ctas, rows_per_count_cta,
                                 stream)
      : launch_typed<BinT, false>(bins, grad, hess, node, G, H, work, pieces, n, d,
                                  W, B, C, ctas, feature_tile, feature_tiles, bin_tile,
                                  bin_tiles, smem_bytes, count_ctas, rows_per_count_cta,
                                  stream);
}

}  // namespace

extern "C" int hist_launch(const void* bins, int bin_bytes, const float* grad,
                           const float* hess, const int32_t* node, float* G,
                           float* H, int32_t* work, float* pieces, long long n,
                           int d, int W, int B, int C, int ctas, int feature_tile,
                           int feature_tiles, int bin_tile, int bin_tiles,
                           int smem_bytes, int count_ctas,
                           long long rows_per_count_cta, void* stream) {
  if (C < 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (bin_bytes) {
    case 1:
      return launch_bins<uint8_t>(bins, grad, hess, node, G, H, work, pieces, n, d,
                                  W, B, C, ctas, feature_tile, feature_tiles, bin_tile,
                                  bin_tiles, smem_bytes, count_ctas, rows_per_count_cta, s);
    case 2:
      return launch_bins<uint16_t>(bins, grad, hess, node, G, H, work, pieces, n, d,
                                   W, B, C, ctas, feature_tile, feature_tiles, bin_tile,
                                   bin_tiles, smem_bytes, count_ctas, rows_per_count_cta, s);
    case 4:
      return launch_bins<int32_t>(bins, grad, hess, node, G, H, work, pieces, n, d,
                                  W, B, C, ctas, feature_tile, feature_tiles, bin_tile,
                                  bin_tiles, smem_bytes, count_ctas, rows_per_count_cta, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

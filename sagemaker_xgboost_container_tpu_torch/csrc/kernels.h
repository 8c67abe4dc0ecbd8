// Plain C interface of the histogram kernels (hist_kernel.cu,
// totals_kernel.cu), built by nvcc into one shared library and called through
// ctypes (_build.py). Each launcher enqueues its kernels on `stream` and
// returns the first cudaError_t of the launches as an int (0 = success); it
// never synchronises and allocates nothing.
#pragma once

#include <stdint.h>

#ifdef __cplusplus
extern "C" {
#endif

// C classes share the bins: grad, hess and node are [C, n] row-major, K =
// C * W keys. G, H: f32 [C, W, d, B], every cell written. bins: [n, d]
// row-major of bin_bytes 1 (uint8), 2 (uint16) or 4 (int32). The tiling
// arguments come from ops/histogram.py::hist_plan. Scratch, both
// uninitialised:
//   work   int32 [2 * K * count_ctas + K + 1 + C * n]: per-chunk key counts,
//          their prefix over chunks, key offsets, entry ids ordered by key;
//   pieces f32 [2 * (ctas + K) * d * B]: per-CTA key histograms, g then h.
// Enqueues hist_count, hist_scan, hist_scatter, hist_kernel, hist_reduce.
int hist_launch(const void* bins, int bin_bytes, const float* grad,
                const float* hess, const int32_t* node, float* G, float* H,
                int32_t* work, float* pieces, long long n, int d, int W, int B,
                int C, int ctas, int feature_tile, int feature_tiles,
                int bin_tile, int bin_tiles, int smem_bytes, int count_ctas,
                long long rows_per_count_cta, void* stream);

// grad, hess, node: [C, n] row-major, K = C * W keys. out: f32 [2K], every
// cell written; g totals in [0, K), h in [K, 2K), each [C, W]. The grid
// arguments come from ops/histogram.py::totals_plan. Scratch,
// uninitialised: pieces f32 [ctas * 2K], one [2K] piece per CTA.
// Enqueues totals_partial, totals_reduce.
int totals_launch(const float* grad, const float* hess, const int32_t* node,
                  float* out, float* pieces, long long n, int W, int C,
                  int ctas, int warps_per_cta, long long rows_per_cta,
                  int smem_bytes, void* stream);

// cudaGetErrorString for the codes above.
const char* kernel_error_string(int code);

#ifdef __cplusplus
}
#endif

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

// G, H: f32 [W, d, B], every cell written. bins: [n, d] row-major of
// bin_bytes 1 (uint8), 2 (uint16) or 4 (int32). The tiling arguments come
// from ops/histogram.py::hist_plan. Scratch, both uninitialised:
//   work   int32 [2 * W * count_ctas + W + 1 + n]: per-chunk node counts,
//          their prefix over chunks, node offsets, row ids ordered by node;
//   pieces f32 [2 * (ctas + W) * d * B]: per-CTA node histograms, g then h.
// Enqueues hist_count, hist_scan, hist_scatter, hist_kernel, hist_reduce.
int hist_launch(const void* bins, int bin_bytes, const float* grad,
                const float* hess, const int32_t* node, float* G, float* H,
                int32_t* work, float* pieces, long long n, int d, int W, int B,
                int ctas, int feature_tile, int feature_tiles, int smem_bytes,
                int count_ctas, long long rows_per_count_cta, void* stream);

// out: f32 [2W], every cell written; g totals in [0, W), h in [W, 2W). The
// grid arguments come from ops/histogram.py::totals_plan. Scratch,
// uninitialised: pieces f32 [ctas * 2W], one [2W] piece per CTA.
// Enqueues totals_partial, totals_reduce.
int totals_launch(const float* grad, const float* hess, const int32_t* node,
                  float* out, float* pieces, long long n, int W, int ctas,
                  int warps_per_cta, long long rows_per_cta, int smem_bytes,
                  void* stream);

// cudaGetErrorString for the codes above.
const char* kernel_error_string(int code);

#ifdef __cplusplus
}
#endif

// Plain C interface of the histogram kernels (hist_kernel.cu,
// totals_kernel.cu). Both the torch extension binding (binding.cpp) and the
// ctypes route (_build.py, used when ninja is missing) call these. Each
// launcher enqueues one kernel on `stream` and returns the cudaError_t of the
// launch as an int (0 = success); it never synchronises.
#pragma once

#include <stdint.h>

#ifdef __cplusplus
extern "C" {
#endif

// G, H: f32 [W, d, B], zero-filled by the caller. bins: [n, d] row-major of
// bin_bytes 1 (uint8), 2 (uint16) or 4 (int32). The tiling arguments come
// from ops/histogram.py::hist_plan.
int hist_launch(const void* bins, int bin_bytes, const float* grad,
                const float* hess, const int32_t* node, float* G, float* H,
                long long n, int d, int W, int B, int rows_per_chunk,
                int row_chunks, int feature_tile, int feature_tiles,
                int node_range, int node_ranges, int smem_bytes, void* stream);

// out: f32 [2W] zero-filled by the caller; g totals in [0, W), h in [W, 2W).
int totals_launch(const float* grad, const float* hess, const int32_t* node,
                  float* out, long long n, int W, int blocks, void* stream);

// cudaGetErrorString for the codes above (the ctypes route has no torch).
const char* kernel_error_string(int code);

#ifdef __cplusplus
}
#endif

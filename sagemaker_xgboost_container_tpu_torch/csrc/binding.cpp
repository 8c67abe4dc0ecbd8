// Torch extension binding of the histogram kernels: the only source that
// includes torch/extension.h, so the .cu files compile without PyTorch's
// headers. Launches on the current stream of the tensors' device; the
// Python wrappers (ops/histogram.py) have already checked device, dtype,
// shape and contiguity and allocated the zero-filled outputs.

#include <ATen/cuda/CUDAContext.h>
#include <c10/cuda/CUDAException.h>
#include <c10/cuda/CUDAGuard.h>
#include <torch/extension.h>

#include "kernels.h"

namespace {

void check_launch(int err, const char* kernel) {
  TORCH_CHECK(err == 0, kernel, " launch failed: ", kernel_error_string(err));
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

void hist(torch::Tensor bins, torch::Tensor grad, torch::Tensor hess,
          torch::Tensor node, torch::Tensor G, torch::Tensor H, int64_t W,
          int64_t B, int64_t rows_per_chunk, int64_t row_chunks,
          int64_t feature_tile, int64_t feature_tiles, int64_t node_range,
          int64_t node_ranges, int64_t smem_bytes) {
  const c10::cuda::CUDAGuard guard(bins.device());
  const int err = hist_launch(
      bins.data_ptr(), static_cast<int>(bins.element_size()),
      grad.data_ptr<float>(), hess.data_ptr<float>(),
      node.data_ptr<int32_t>(), G.data_ptr<float>(), H.data_ptr<float>(),
      bins.size(0), static_cast<int>(bins.size(1)), static_cast<int>(W),
      static_cast<int>(B), static_cast<int>(rows_per_chunk),
      static_cast<int>(row_chunks), static_cast<int>(feature_tile),
      static_cast<int>(feature_tiles), static_cast<int>(node_range),
      static_cast<int>(node_ranges), static_cast<int>(smem_bytes),
      at::cuda::getCurrentCUDAStream().stream());
  check_launch(err, "hist_kernel");
}

void totals(torch::Tensor grad, torch::Tensor hess, torch::Tensor node,
            torch::Tensor out, int64_t W, int64_t blocks) {
  const c10::cuda::CUDAGuard guard(grad.device());
  const int err = totals_launch(
      grad.data_ptr<float>(), hess.data_ptr<float>(),
      node.data_ptr<int32_t>(), out.data_ptr<float>(), grad.size(0),
      static_cast<int>(W), static_cast<int>(blocks),
      at::cuda::getCurrentCUDAStream().stream());
  check_launch(err, "totals_kernel");
}

}  // namespace

PYBIND11_MODULE(TORCH_EXTENSION_NAME, m) {
  m.def("hist", &hist, "per-level (G, H) histograms (hist_kernel.cu)");
  m.def("totals", &totals, "per-node (g, h) totals (totals_kernel.cu)");
}

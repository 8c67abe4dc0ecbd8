"""Build and load the CUDA kernels at first use.

Sources live in ``csrc/``; the build goes to ``build/torch_kernels/`` beside
the package (``build/`` is git-ignored). With ``ninja`` present,
``torch.utils.cpp_extension.load`` compiles every source in one call: the
``.cu`` files with nvcc for ``sm_90a`` and the small ``binding.cpp`` (the
only file that includes ``torch/extension.h``) with the host compiler.
Without ninja, nvcc builds the ``.cu`` files into a plain shared library that
is loaded with ctypes.

Nothing here runs at import: the CPU tests import every module, and this
machine may have no nvcc.
"""

import ctypes
import os
import subprocess
import threading

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "torch_kernels")
CUDA_SOURCES = ("hist_kernel.cu", "totals_kernel.cu")
ARCH_FLAG = "-gencode=arch=compute_90a,code=sm_90a"
_EXT_NAME = "sagemaker_xgboost_torch_kernels"

_lock = threading.Lock()
_kernels = None


def kernels():
    """The loaded kernels (built on the first call, once per process)."""
    global _kernels
    with _lock:
        if _kernels is None:
            _kernels = _load()
        return _kernels


def _load():
    from torch.utils import cpp_extension

    # load() does not create its build directory and fails on its lock file
    os.makedirs(BUILD_DIR, exist_ok=True)
    if cpp_extension.is_ninja_available():
        ext = cpp_extension.load(
            name=_EXT_NAME,
            sources=[os.path.join(CSRC_DIR, "binding.cpp")]
            + [os.path.join(CSRC_DIR, s) for s in CUDA_SOURCES],
            build_directory=BUILD_DIR,
            extra_cflags=["-O2"],
            extra_cuda_cflags=["-O3", ARCH_FLAG],
            extra_include_paths=[CSRC_DIR],
            verbose=False,
        )
        return _ExtensionKernels(ext)
    return _CtypesKernels(_nvcc_shared_library())


def _nvcc_shared_library():
    from torch.utils.cpp_extension import CUDA_HOME

    nvcc = os.path.join(CUDA_HOME or "/usr/local/cuda", "bin", "nvcc")
    out = os.path.join(BUILD_DIR, "lib{}.so".format(_EXT_NAME))
    cmd = [
        nvcc, ARCH_FLAG, "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
        "-I", CSRC_DIR, "-o", out,
    ] + [os.path.join(CSRC_DIR, s) for s in CUDA_SOURCES]
    subprocess.run(cmd, check=True)
    return out


class _ExtensionKernels:
    """Kernels bound through the torch extension (binding.cpp)."""

    route = "torch extension"

    def __init__(self, ext):
        self._ext = ext

    def hist(self, bins, grad, hess, node, G, H, plan):
        self._ext.hist(
            bins, grad, hess, node, G, H, G.shape[0], G.shape[2],
            plan.rows_per_chunk, plan.row_chunks, plan.feature_tile,
            plan.feature_tiles, plan.node_range, plan.node_ranges,
            plan.smem_bytes,
        )

    def totals(self, grad, hess, node, out, blocks):
        self._ext.totals(grad, hess, node, out, out.shape[0] // 2, blocks)


class _CtypesKernels:
    """Kernels from an nvcc-built shared library with the C interface of
    csrc/kernels.h."""

    route = "ctypes"

    def __init__(self, path):
        lib = ctypes.CDLL(path)
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.hist_launch.argtypes = [p, i, p, p, p, p, p, ll] + [i] * 10 + [p]
        lib.hist_launch.restype = i
        lib.totals_launch.argtypes = [p, p, p, p, ll, i, i, p]
        lib.totals_launch.restype = i
        lib.kernel_error_string.argtypes = [i]
        lib.kernel_error_string.restype = ctypes.c_char_p
        self._lib = lib

    def _check(self, err, kernel):
        if err != 0:
            raise RuntimeError(
                "{} launch failed: {}".format(
                    kernel, self._lib.kernel_error_string(err).decode()
                )
            )

    @staticmethod
    def _stream(t):
        import torch

        return torch.cuda.current_stream(t.device).cuda_stream

    def hist(self, bins, grad, hess, node, G, H, plan):
        import torch

        with torch.cuda.device(bins.device):
            err = self._lib.hist_launch(
                bins.data_ptr(), bins.element_size(), grad.data_ptr(),
                hess.data_ptr(), node.data_ptr(), G.data_ptr(), H.data_ptr(),
                bins.shape[0], bins.shape[1], G.shape[0], G.shape[2],
                plan.rows_per_chunk, plan.row_chunks, plan.feature_tile,
                plan.feature_tiles, plan.node_range, plan.node_ranges,
                plan.smem_bytes, self._stream(bins),
            )
        self._check(err, "hist_kernel")

    def totals(self, grad, hess, node, out, blocks):
        import torch

        with torch.cuda.device(grad.device):
            err = self._lib.totals_launch(
                grad.data_ptr(), hess.data_ptr(), node.data_ptr(),
                out.data_ptr(), grad.shape[0], out.shape[0] // 2, blocks,
                self._stream(grad),
            )
        self._check(err, "totals_kernel")

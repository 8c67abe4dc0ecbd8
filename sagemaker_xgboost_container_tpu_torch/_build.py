"""Build and load the CUDA kernels at first use.

Sources live in ``csrc/``. ``nvcc`` compiles each ``.cu`` file for
``sm_90a`` (all at once, one process per file) and links them into a shared
library with the plain C interface of ``csrc/kernels.h`` under
``build/torch_kernels/`` beside the package (``build/`` is git-ignored);
ctypes loads it. No source includes PyTorch's headers, so the build takes
seconds. Every process builds once, at its first kernel launch.

Nothing here runs at import: the CPU tests import every module, and this
machine may have no nvcc.
"""

import ctypes
import os
import subprocess
import threading
import time

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "torch_kernels")
CUDA_SOURCES = ("hist_kernel.cu", "totals_kernel.cu")
ARCH_FLAG = "-gencode=arch=compute_90a,code=sm_90a"
_LIB_NAME = "libsagemaker_xgboost_torch_kernels.so"

_lock = threading.Lock()
_kernels = None


def kernels():
    """The loaded kernels (built on the first call, once per process)."""
    global _kernels
    with _lock:
        if _kernels is None:
            t0 = time.perf_counter()
            path, log = _nvcc_shared_library()
            _kernels = _CtypesKernels(path, log, time.perf_counter() - t0)
        return _kernels


def _nvcc_shared_library():
    """Compile every source in parallel, link, and return the library's path
    with the compiler's ``-Xptxas -v`` report (registers, shared memory and
    spills of each kernel)."""
    from torch.utils.cpp_extension import CUDA_HOME

    nvcc = os.path.join(CUDA_HOME or "/usr/local/cuda", "bin", "nvcc")
    os.makedirs(BUILD_DIR, exist_ok=True)
    # per-process names: processes that build at once do not share files
    tag = str(os.getpid())
    flags = [ARCH_FLAG, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-I", CSRC_DIR]
    objs, procs = [], []
    for src in CUDA_SOURCES:
        obj = os.path.join(BUILD_DIR, "{}.{}.o".format(src, tag))
        objs.append(obj)
        procs.append(subprocess.Popen(
            [nvcc] + flags + ["-Xptxas", "-v", "-c", os.path.join(CSRC_DIR, src), "-o", obj],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        ))
    logs = []
    for src, proc in zip(CUDA_SOURCES, procs):
        out, _ = proc.communicate()
        logs.append(out)
        if proc.returncode != 0:
            raise RuntimeError("nvcc failed on {}:\n{}".format(src, out))
    tmp = os.path.join(BUILD_DIR, "{}.{}".format(_LIB_NAME, tag))
    subprocess.run([nvcc, ARCH_FLAG, "-shared", "-o", tmp] + objs, check=True)
    for obj in objs:
        os.remove(obj)
    path = os.path.join(BUILD_DIR, _LIB_NAME)
    os.replace(tmp, path)
    return path, "".join(logs)


class _CtypesKernels:
    """Kernels from the nvcc-built shared library (csrc/kernels.h)."""

    route = "nvcc + ctypes"

    def __init__(self, path, build_log, build_s):
        lib = ctypes.CDLL(path)
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.hist_launch.argtypes = [p, i, p, p, p, p, p, p, p, ll] + [i] * 8 + [ll, p]
        lib.hist_launch.restype = i
        lib.totals_launch.argtypes = [p, p, p, p, p, ll, i, i, i, ll, i, p]
        lib.totals_launch.restype = i
        lib.kernel_error_string.argtypes = [i]
        lib.kernel_error_string.restype = ctypes.c_char_p
        self._lib = lib
        self.path = path
        self.build_log = build_log
        self.build_s = build_s

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

    def hist(self, bins, grad, hess, node, G, H, work, pieces, plan):
        import torch

        n, d = bins.shape
        with torch.cuda.device(bins.device):
            err = self._lib.hist_launch(
                bins.data_ptr(), bins.element_size(), grad.data_ptr(),
                hess.data_ptr(), node.data_ptr(), G.data_ptr(), H.data_ptr(),
                work.data_ptr(), pieces.data_ptr(), n, d, G.shape[0],
                G.shape[2], plan.ctas, plan.feature_tile, plan.feature_tiles,
                plan.smem_bytes, plan.count_ctas, plan.rows_per_count_cta,
                self._stream(bins),
            )
        self._check(err, "hist_kernel")

    def totals(self, grad, hess, node, out, pieces, plan):
        import torch

        with torch.cuda.device(grad.device):
            err = self._lib.totals_launch(
                grad.data_ptr(), hess.data_ptr(), node.data_ptr(),
                out.data_ptr(), pieces.data_ptr(), grad.shape[0],
                out.shape[0] // 2, plan.ctas, plan.warps_per_cta,
                plan.rows_per_cta, plan.smem_bytes, self._stream(grad),
            )
        self._check(err, "totals_kernel")

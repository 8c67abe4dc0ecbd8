"""Build and load the CUDA kernels at first use.

Sources live in ``csrc/``. ``nvcc`` compiles each ``.cu`` file for
``sm_90a`` (all at once, one process per file) and links them into a shared
library with the plain C interface of ``csrc/kernels.h`` under
``build_dir()/<key>/`` (``torch_kernels/`` of ``utils/compile_cache``'s
root: ``GRAFT_COMPILE_CACHE_DIR``, else the git-ignored ``build/`` beside
the package); ctypes loads it. The key is a digest of the sources, the
headers, the compiler's path and the flags, so a process whose library is
already built for the same sources loads it (a train job's child process,
a restarted job); otherwise it builds once, at its first kernel launch,
and counts the build in ``telemetry/cluster.compile_stats``. No source
includes PyTorch's headers, so a build takes seconds.

Nothing here runs at import: the CPU tests import every module, and this
machine may have no nvcc.
"""

import ctypes
import hashlib
import os
import subprocess
import threading
import time

from .utils import compile_cache

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
CUDA_SOURCES = ("hist_kernel.cu", "totals_kernel.cu", "stamp_kernel.cu")
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
            path, log, built = _nvcc_shared_library()
            _kernels = _CtypesKernels(path, log, time.perf_counter() - t0 if built else 0.0)
            if built:
                from .telemetry.cluster import note_build

                note_build(_kernels.build_s)
        return _kernels


def build_dir():
    """The directory the kernels' libraries are cached under."""
    return compile_cache.cache_dir("torch_kernels")


def _build_key(nvcc, flags):
    """Digest of everything the library is built from."""
    h = hashlib.sha256(" ".join([nvcc] + flags).encode())
    for name in sorted(os.listdir(CSRC_DIR)):
        with open(os.path.join(CSRC_DIR, name), "rb") as f:
            h.update(name.encode() + f.read())
    return h.hexdigest()[:16]


def _nvcc_shared_library():
    """-> (library path, the compiler's ``-Xptxas -v`` report (registers,
    shared memory and spills of each kernel), True when built here): the
    library already built from these sources, else every source compiled
    in parallel and linked."""
    from torch.utils.cpp_extension import CUDA_HOME

    nvcc = os.path.join(CUDA_HOME or "/usr/local/cuda", "bin", "nvcc")
    flags = [ARCH_FLAG, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-I", CSRC_DIR]
    out_dir = os.path.join(build_dir(), _build_key(nvcc, flags))
    path = os.path.join(out_dir, _LIB_NAME)
    if os.path.exists(path):
        return path, "", False
    os.makedirs(out_dir, exist_ok=True)
    # per-process names: processes that build at once do not share files
    tag = str(os.getpid())
    objs, procs = [], []
    for src in CUDA_SOURCES:
        obj = os.path.join(out_dir, "{}.{}.o".format(src, tag))
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
    tmp = os.path.join(out_dir, "{}.{}".format(_LIB_NAME, tag))
    subprocess.run([nvcc, ARCH_FLAG, "-shared", "-o", tmp] + objs, check=True)
    for obj in objs:
        os.remove(obj)
    os.replace(tmp, path)
    return path, "".join(logs), True


class _CtypesKernels:
    """Kernels from the nvcc-built shared library (csrc/kernels.h)."""

    route = "nvcc + ctypes"

    def __init__(self, path, build_log, build_s):
        lib = ctypes.CDLL(path)
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.hist_launch.argtypes = [p, i, p, p, p, p, p, p, p, ll] + [i] * 11 + [ll, p]
        lib.hist_launch.restype = i
        lib.totals_launch.argtypes = [p, p, p, p, p, ll, i, i, i, i, ll, i, p]
        lib.totals_launch.restype = i
        lib.stage_stamp_launch.argtypes = [p, p, i, i, i, i, p]
        lib.stage_stamp_launch.restype = i
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
        """grad, hess, node: [C, n]; G, H: [C, W, d, B]."""
        import torch

        n, d = bins.shape
        C, W, _, B = G.shape
        with torch.cuda.device(bins.device):
            err = self._lib.hist_launch(
                bins.data_ptr(), bins.element_size(), grad.data_ptr(),
                hess.data_ptr(), node.data_ptr(), G.data_ptr(), H.data_ptr(),
                work.data_ptr(), pieces.data_ptr(), n, d, W, B, C,
                plan.ctas, plan.feature_tile, plan.feature_tiles,
                plan.bin_tile, plan.bin_tiles, plan.smem_bytes, plan.count_ctas, plan.rows_per_count_cta,
                self._stream(bins),
            )
        self._check(err, "hist_kernel")

    def totals(self, grad, hess, node, out, pieces, plan):
        """grad, hess, node: [C, n]; out: [2, C, W]."""
        import torch

        C, n = grad.shape
        with torch.cuda.device(grad.device):
            err = self._lib.totals_launch(
                grad.data_ptr(), hess.data_ptr(), node.data_ptr(),
                out.data_ptr(), pieces.data_ptr(), n, out.shape[2], C,
                plan.ctas, plan.warps_per_cta, plan.rows_per_cta,
                plan.smem_bytes, self._stream(grad),
            )
        self._check(err, "totals_kernel")

    def stamp(self, rows, state, stage, advance=False):
        """rows: f64 [capacity, stages + 2] and state: int64 [2] on the
        card (``ops/stamps``); stage < 0 begins a round, ``advance`` ends
        it."""
        import torch

        capacity, width = rows.shape
        with torch.cuda.device(rows.device):
            err = self._lib.stage_stamp_launch(rows.data_ptr(), state.data_ptr(), stage,
                                               width - 2, capacity, int(advance),
                                               self._stream(rows))
        self._check(err, "stage_stamp_kernel")

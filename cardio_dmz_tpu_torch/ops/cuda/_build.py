"""The one nvcc + ctypes builder of the port's CUDA kernels.

Each kernel is one source, csrc/<name>.cu, that exports a plain C launch
function returning the launch's cudaGetLastError(). CudaKernel compiles it
with nvcc for sm_90a into cardio_dmz_tpu_torch/_build/lib<name>.so (the
first time it launches, or again when the source is newer than the
library), loads it with ctypes and raises on an nvcc failure or a launch
code other than 0. Nothing is built at import: this host may have no nvcc.
counted_launch is the body of each kernel's wrapper, on either route: it
reports the launch's work to a tools/profiling.WorkCounter.
"""

import contextlib
import ctypes
import os
import subprocess
import threading

import torch
from torch.utils._python_dispatch import _get_current_dispatch_mode_stack

_PKG = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc():
    return os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")


class CudaKernel:
    """csrc/<name>.cu bound with ctypes: `fn` is its C launch function,
    `argtypes` the ctypes types of its arguments (c_void_p for every
    pointer and the stream), `flags` nvcc flags of this kernel alone."""

    def __init__(self, name, fn, argtypes, flags=()):
        self.name = name
        self.source = os.path.join(_PKG, "csrc", f"{name}.cu")
        self.library = os.path.join(BUILD_DIR, f"lib{name}.so")
        self.flags = tuple(flags)
        self._fn_name = fn
        self._argtypes = list(argtypes)
        self._lock = threading.Lock()
        self._fn = None

    @property
    def loaded(self):
        return self._fn is not None

    def build(self):
        """Compile the source into self.library and return nvcc's output
        (the -Xptxas -v register and shared-memory report)."""
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{self.library}.{os.getpid()}.tmp"
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, *self.flags, "-o", tmp, self.source],
            capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {self.source} "
                               f"({proc.returncode}):\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, self.library)
        return proc.stdout + proc.stderr

    def _load(self):
        with self._lock:
            if self._fn is None:
                if (not os.path.exists(self.library) or
                        os.path.getmtime(self.library)
                        < os.path.getmtime(self.source)):
                    self.build()
                fn = getattr(ctypes.CDLL(self.library), self._fn_name)
                fn.argtypes = self._argtypes
                fn.restype = ctypes.c_int
                self._fn = fn
            return self._fn

    def launch(self, *args):
        """Call the launch function (building first if need be) and raise
        if the launch was refused."""
        rc = self._load()(*args)
        if rc != 0:
            raise RuntimeError(f"{self._fn_name} failed: cudaError {rc}")


@contextlib.contextmanager
def counted_launch(name, work, *args):
    """The body of a kernel wrapper, on either route. Every work counter in
    the dispatch-mode stack (tools/profiling.WorkCounter) is told this
    launch's work, work(*args) -> (flops, bytes, kind), and counts none of
    the aten ops run inside the block or by the formula: so a step counts
    the same on the CPU, where the plain version runs, and on the card,
    where the kernel runs unseen by a dispatch mode. With no counter active
    the formula is not evaluated. The block is a torch.profiler region
    named "<name> kernel", so that a trace ties the kernel, which no aten
    op launches, to its wrapper."""
    counters = [m for m in _get_current_dispatch_mode_stack()
                if hasattr(m, "add_kernel")]
    for counter in counters:
        counter.paused += 1
    try:
        if counters:
            flops, n_bytes, kind = work(*args)
            for counter in counters:
                counter.add_kernel(name, flops, n_bytes, kind)
        with torch.profiler.record_function(f"{name} kernel"):
            yield
    finally:
        for counter in counters:
            counter.paused -= 1

"""Build, load and launch the port's hand-written CUDA kernels.

All ``deflate_rs_tpu_torch/csrc/*.cu`` sources are compiled by ``nvcc`` for
``sm_90a`` (one ``nvcc`` per source, all started together) and linked into
one shared library with a plain C interface, at first use,
in the package's build directory (listed in ``.gitignore``), and loaded with
ctypes — the idiom ``runtime/native.py`` uses for the host runtime.  Nothing
here runs at import time, so the CPU tests import every module without a
CUDA toolkit.

Each kernel is a :class:`CudaKernel`.  Its ``launches`` counter goes up by
one for every launch and nowhere else; ``chip_smoke.py`` reads it to show
that the main path went through the kernel.
"""

from __future__ import annotations

import ctypes
import glob
import os
import shutil
import subprocess
import threading
import time

from .native import BUILD_DIR

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG, "csrc")
LIB_PATH = os.path.join(BUILD_DIR, "libdeflate_kernels.so")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
]
_COMPILE_FLAGS = [f for f in NVCC_FLAGS if f != "-shared"]

_lock = threading.Lock()
_lib = None
build_seconds = None  # wall time of the last build in this process, or None


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    found = shutil.which("nvcc") or os.path.join(home, "bin", "nvcc")
    if not os.path.exists(found):
        raise RuntimeError(f"nvcc not found (looked on PATH and in {home}/bin)")
    return found


def load_library() -> ctypes.CDLL:
    """Build (if stale) and load the kernel library; raises on failure."""
    global _lib, build_seconds
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is not None:
            return _lib
        sources = sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu")))
        headers = glob.glob(os.path.join(CSRC_DIR, "*.cuh"))
        newest = max(os.path.getmtime(p) for p in sources + headers)
        if not os.path.exists(LIB_PATH) or os.path.getmtime(LIB_PATH) < newest:
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = f"{LIB_PATH}.{os.getpid()}.tmp"
            t0 = time.perf_counter()
            nvcc = _nvcc()
            objects = [os.path.join(BUILD_DIR, f"{os.path.basename(p)}.{os.getpid()}.o")
                       for p in sources]
            procs = [subprocess.Popen([nvcc, *_COMPILE_FLAGS, "-c", "-o", obj, src],
                                      stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
                     for src, obj in zip(sources, objects)]
            failed = []
            for src, proc in zip(sources, procs):
                out, err = proc.communicate()
                if proc.returncode != 0:
                    failed.append(f"{src} ({proc.returncode}):\n{out}\n{err}")
            if not failed:
                link = subprocess.run([nvcc, "-shared", "-o", tmp, *objects],
                                      capture_output=True, text=True)
                if link.returncode != 0:
                    failed.append(f"link ({link.returncode}):\n{link.stdout}\n{link.stderr}")
            for obj in objects:
                if os.path.exists(obj):
                    os.remove(obj)
            if failed:
                raise RuntimeError("nvcc failed: " + "\n".join(failed))
            os.replace(tmp, LIB_PATH)
            build_seconds = time.perf_counter() - t0
        _lib = ctypes.CDLL(LIB_PATH)
        return _lib


class CudaKernel:
    """One C entry point of the kernel library.

    ``argtypes`` lists the kernel's own arguments; the stream is appended
    as the last ``c_void_p``.  The entry returns ``cudaGetLastError()``.
    """

    def __init__(self, name: str, argtypes: list):
        self.name = name
        self.argtypes = argtypes
        self.launches = 0
        self._fn = None

    def __call__(self, device, *args) -> None:
        import torch

        if self._fn is None:
            fn = getattr(load_library(), self.name)
            fn.argtypes = [*self.argtypes, ctypes.c_void_p]
            fn.restype = ctypes.c_int
            self._fn = fn
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream().cuda_stream
            err = self._fn(*args, stream)
        if err != 0:
            raise RuntimeError(f"CUDA kernel {self.name} failed to launch: error {err}")
        self.launches += 1


KERNELS: dict[str, CudaKernel] = {}


def register(name: str, argtypes: list) -> CudaKernel:
    k = CudaKernel(name, argtypes)
    KERNELS[name] = k
    return k


def reset_launches() -> None:
    for k in KERNELS.values():
        k.launches = 0


def check_cuda(t, name: str, dtype, shape: tuple) -> None:
    """Validate a kernel operand: CUDA, dtype, shape, contiguity."""
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")

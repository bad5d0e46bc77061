"""Build and load the port's CUDA kernels at first use.

Every ``*.cu`` file under ``instsearch_torch/csrc/`` is compiled by ``nvcc``
for Hopper (``sm_90a``) into ONE shared library with a plain C interface,
loaded with ``ctypes``. Nothing includes PyTorch's headers, so the build
takes seconds. The library lands in ``instsearch_torch/_build/`` (ignored by
git) under a name that hashes the sources and flags, so an edited source is
rebuilt and an unchanged one is loaded as it is.

Nothing here runs at import time: the CPU tests import every module of the
port on machines without ``nvcc``.
"""
from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_lib: "ctypes.CDLL | None" = None


def _sources() -> list[str]:
    srcs = sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu")))
    if not srcs:
        raise FileNotFoundError(f"no CUDA sources under {CSRC_DIR}")
    return srcs


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME or put nvcc on PATH)")


def library_path() -> str:
    """Path of the library for the current sources (built or not)."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu*"))):
        with open(path, "rb") as f:
            h.update(os.path.basename(path).encode() + b"\0" + f.read())
    return os.path.join(BUILD_DIR, f"libinstsearch_kernels_{h.hexdigest()[:16]}.so")


def build() -> str:
    """Compile the sources if their library is missing; returns its path.
    Writes to a temporary name first, so a build cut short never leaves a
    library that loads."""
    out = library_path()
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *_sources()]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, out)
    return out


def load() -> ctypes.CDLL:
    """Build if needed, load once per process, declare the C signatures."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(build())
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.isf_topk_matmul.argtypes = [p, p, p, p, p, p, p,
                                        i, i, i, i, i, i, i, i, i, p]
        lib.isf_topk_matmul.restype = i
        lib.isf_topk_pass1_smem.argtypes = [i, i, i]
        lib.isf_topk_pass1_smem.restype = ctypes.c_longlong
        _lib = lib
        return lib

"""Build and load the port's CUDA kernels at first use.

Every ``*.cu`` file under ``instsearch_torch/csrc/`` is compiled by its own
``nvcc`` for Hopper (``sm_90a``), all at once, and the objects are linked
into ONE shared library with a plain C interface, loaded with ``ctypes``.
Nothing includes PyTorch's headers, so the build takes seconds. The
library lands in ``instsearch_torch/_build/`` (ignored by git) under a name
that hashes the sources (``*.cu`` and the ``*.cuh`` they share) and flags,
so an edited source is rebuilt and an unchanged one is loaded as it is.

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
              "-Xcompiler", "-fPIC")

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
    One ``nvcc`` per source runs in parallel, then one links them. Writes to
    a temporary name first, so a build cut short never leaves a library
    that loads."""
    out = library_path()
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        jobs = []
        for src in _sources():
            obj = os.path.join(tmp, os.path.basename(src) + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", obj, src]
            jobs.append((cmd, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        try:
            for cmd, _, proc in jobs:
                output = proc.communicate()[0]
                _check(cmd, proc.returncode, output)
        finally:                      # a failed source stops the others
            for *_, proc in jobs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        lib = os.path.join(tmp, "lib.so")
        cmd = [nvcc, *NVCC_FLAGS, "-shared", "-o", lib,
               *[obj for _, obj, _ in jobs]]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        _check(cmd, proc.returncode, proc.stdout + proc.stderr)
        os.replace(lib, out)
    return out


def _check(cmd: list[str], rc: int, output: str) -> None:
    if rc != 0:
        raise RuntimeError(f"nvcc failed ({rc}):\n{' '.join(cmd)}\n{output}")


def load() -> ctypes.CDLL:
    """Build if needed, load once per process, declare the C signatures."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(build())
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.isf_topk_matmul.argtypes = [p, p, p, p, p, p, p,
                                        i, i, i, i, i, i, i, i, p]
        lib.isf_topk_matmul.restype = i
        lib.isf_topk_pass1_smem.argtypes = [i, i, i]
        lib.isf_topk_pass1_smem.restype = ctypes.c_longlong
        lib.isf_topk_matmul_mma.argtypes = [p, p, p, p, p, p, p,
                                            i, i, i, i, i, i, i, i, p]
        lib.isf_topk_matmul_mma.restype = i
        lib.isf_topk_mma_smem.argtypes = [i, i, i]
        lib.isf_topk_mma_smem.restype = ctypes.c_longlong
        lib.isf_topk_matmul_int.argtypes = [p, p, p, p, p, p, p, p, p, p, p,
                                            i, i, i, i, i, i, i, i, i, p]
        lib.isf_topk_matmul_int.restype = i
        lib.isf_topk_int_mma_smem.argtypes = [i, i, i, i]
        lib.isf_topk_int_mma_smem.restype = ctypes.c_longlong
        lib.isf_quantize_rows.argtypes = [p, p, p, p, i, i, p]
        lib.isf_quantize_rows.restype = i
        lib.isf_pq_topk.argtypes = [p, p, p, p, p, p, p, p, p,
                                    i, i, i, i, i, i, i, i, i, i, p]
        lib.isf_pq_topk.restype = i
        lib.isf_pq_table.argtypes = [p, p, p, i, i, i, i, p]
        lib.isf_pq_table.restype = i
        lib.isf_pq_pass1_smem.argtypes = [i, i, i]
        lib.isf_pq_pass1_smem.restype = ctypes.c_longlong
        ll = ctypes.c_longlong
        lib.isf_mha.argtypes = [p, p, p, p, i, i, i, i, i,
                                ll, ll, ll, ll, ll, ll, p]
        lib.isf_mha.restype = i
        lib.isf_mha_smem.argtypes = [i, i]
        lib.isf_mha_smem.restype = ctypes.c_longlong
        lib.isf_flash_mha.argtypes = [p, p, p, p, i, i, i, i, i,
                                      ll, ll, ll, ll, ll, ll, p]
        lib.isf_flash_mha.restype = i
        lib.isf_fused_block.argtypes = [p, p, p, p, p, p, p, p,
                                        i, i, i, i, i, p]
        lib.isf_fused_block.restype = i
        lib.isf_fused_block_tile.argtypes = [i, i, i]
        lib.isf_fused_block_tile.restype = i
        lib.isf_fused_block_attrs.argtypes = [ctypes.POINTER(i),
                                              ctypes.POINTER(i)]
        lib.isf_fused_block_attrs.restype = i
        _lib = lib
        return lib

"""ctypes bindings for the port's native C++ frontend
(``instsearch_torch/csrc/frontend.cc``; port of
``instsearch_tpu/data/native_frontend.py``).

At first use the library is built with the reference Makefile's flags
(``g++ -O3 -fPIC -std=c++17 -Wall -shared ... -ljpeg -lpng -pthread``) into
``instsearch_torch/_build/``, named by a hash of the source, and loaded.
Where the toolchain or libjpeg/libpng are missing the build fails, a
warning names the error, and the frontend decodes with cv2, the
reference's own host-side fallback; ``available()`` says which decoder
runs. The native loader decodes, resizes and crops a whole batch on a
std::thread pool, without the GIL.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading

import numpy as np

from ..utils.observe import get_logger

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG_DIR, "csrc", "frontend.cc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
CXXFLAGS = ["-O3", "-fPIC", "-std=c++17", "-Wall"]
LDLIBS = ["-ljpeg", "-lpng", "-pthread"]

_lib = None
_lib_lock = threading.Lock()
_build_failed = False


def library_path() -> str:
    """Where the library for the current source lies once built."""
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"libisf_frontend_{digest}.so")


def build() -> str:
    """Compile the source into ``library_path()`` unless it is there; a
    temporary file renamed into place keeps concurrent builds apart.
    Raises ``subprocess.CalledProcessError`` or ``OSError`` on failure."""
    path = library_path()
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        subprocess.run(["g++", *CXXFLAGS, "-shared", SOURCE, "-o", tmp,
                        *LDLIBS], check=True, capture_output=True,
                       timeout=300)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return path


def _load() -> "ctypes.CDLL | None":
    global _lib, _build_failed
    with _lib_lock:
        if _lib is not None or _build_failed:
            return _lib
        try:
            lib = ctypes.CDLL(build())
        except (OSError, subprocess.SubprocessError) as e:
            detail = getattr(e, "stderr", b"") or b""
            get_logger("instsearch.native").warning(
                "native frontend unavailable (%s %s); decoding with cv2", e,
                detail.decode(errors="replace").strip()[:500])
            _build_failed = True
            return None
        lib.isf_load_one.argtypes = [
            ctypes.c_char_p, ctypes.c_int, ctypes.POINTER(ctypes.c_uint8)]
        lib.isf_load_one.restype = ctypes.c_int
        lib.isf_load_batch.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_uint8),
            ctypes.c_int]
        lib.isf_load_batch.restype = ctypes.c_int
        _lib = lib
        return _lib


def available() -> bool:
    """True when the native decoder runs, False when the frontend decodes
    with cv2 (the library could not be built here)."""
    return _load() is not None


def load_batch_native(paths, size: int, n_threads: int = 0
                      ) -> tuple[np.ndarray, np.ndarray]:
    """Decode+resize+crop ``paths`` -> (uint8 [n, size, size, 3], ok [n] bool).

    Failed images have ok=False and zeroed pixels (quarantine upstream)."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native frontend unavailable (build failed)")
    n = len(paths)
    out = np.zeros((n, size, size, 3), np.uint8)
    ok = np.zeros((n,), np.uint8)
    arr = (ctypes.c_char_p * n)(*[os.fsencode(p) for p in paths])
    lib.isf_load_batch(
        arr, n, size,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        ok.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        n_threads)
    return out, ok.astype(bool)

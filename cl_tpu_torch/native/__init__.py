"""ctypes bindings for the native host-side rasterizer (``rasterizer.cpp``).

This package's own copy of ``cl_tpu/native``: ``rasterizer.cpp`` and its
bit-identical Python reference ``pyref.py`` are byte-for-byte copies, and
the loader binds the same plain C interface. The shared library is built
with g++ at first use (the same flags as the JAX package's) into
``cl_tpu_torch/_build/native/`` (listed in ``.gitignore``), keyed by a hash
of the source and the flags, so a changed source rebuilds and a checkout
never loads a library built from other bytes.

Where g++ is missing or the build fails, callers fall back to ``pyref``,
which gives the same bytes, slowly. ``backend()`` says which one runs
("native" or "pyref") and ``load_error()`` why the library did not load.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "rasterizer.cpp")
_BUILD = os.path.join(os.path.dirname(_DIR), "_build", "native")
_FLAGS = ["-O3", "-march=native", "-shared", "-fPIC", "-std=c++17", "-pthread"]

_lock = threading.Lock()
_lib = None
_load_error: str | None = None


def _lib_path() -> str:
    h = hashlib.sha256(" ".join(_FLAGS).encode())
    with open(_SRC, "rb") as f:
        h.update(f.read())
    return os.path.join(_BUILD, f"libcl_native_{h.hexdigest()[:16]}.so")


def _build(path: str) -> None:
    os.makedirs(_BUILD, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    subprocess.run(["g++", *_FLAGS, _SRC, "-o", tmp], check=True,
                   capture_output=True, text=True)
    os.replace(tmp, path)  # atomic: concurrent builds agree


def _load():
    global _lib, _load_error
    with _lock:
        if _lib is not None or _load_error is not None:
            return _lib
        try:
            path = _lib_path()
            if not os.path.exists(path):
                _build(path)
            lib = ctypes.CDLL(path)
            lib.cl_rasterize.argtypes = [
                ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
                ctypes.c_int64, ctypes.POINTER(ctypes.c_uint8),
                ctypes.POINTER(ctypes.c_uint8)]
            lib.cl_rasterize_batch.argtypes = [
                ctypes.c_int64, ctypes.POINTER(ctypes.c_int64),
                ctypes.c_int64, ctypes.c_int64,
                ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
                ctypes.c_int64, ctypes.POINTER(ctypes.c_uint8),
                ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64]
            _lib = lib
        except Exception as e:  # no toolchain: the pyref fallback
            _load_error = f"{type(e).__name__}: {e}"
            if isinstance(e, subprocess.CalledProcessError):
                _load_error += f"\n{e.stderr}"
        return _lib


def available() -> bool:
    """True when the C++ library is built and loaded."""
    return _load() is not None


def backend() -> str:
    """"native" (the C++ library) or "pyref" (the Python fallback)."""
    return "native" if available() else "pyref"


def load_error() -> str | None:
    """Why the library did not load (None when it did)."""
    _load()
    return _load_error


def _u8p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _i64p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def rasterize(seed: int, index: int, size: int, classes,
              max_shapes: int = 4) -> tuple[np.ndarray, np.ndarray]:
    """One (image uint8 [S,S,3], mask uint8 [S,S]) example."""
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native library unavailable: {_load_error}")
    cls = np.ascontiguousarray(np.asarray(classes, np.int64))
    img = np.empty((size, size, 3), np.uint8)
    mask = np.empty((size, size), np.uint8)
    lib.cl_rasterize(seed, index, size, _i64p(cls), len(cls), max_shapes,
                     _u8p(img), _u8p(mask))
    return img, mask


def rasterize_batch(seed: int, indices, size: int, classes,
                    max_shapes: int = 4, n_threads: int = 0
                    ) -> tuple[np.ndarray, np.ndarray]:
    """Threaded batch rasterization into contiguous uint8 buffers."""
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native library unavailable: {_load_error}")
    idx = np.ascontiguousarray(np.asarray(indices, np.int64))
    cls = np.ascontiguousarray(np.asarray(classes, np.int64))
    n = len(idx)
    imgs = np.empty((n, size, size, 3), np.uint8)
    masks = np.empty((n, size, size), np.uint8)
    if n_threads <= 0:
        n_threads = min(n, os.cpu_count() or 1)
    lib.cl_rasterize_batch(seed, _i64p(idx), n, size, _i64p(cls), len(cls),
                           max_shapes, _u8p(imgs), _u8p(masks), n_threads)
    return imgs, masks

"""ctypes bindings of the native C++ decode/prefetch library
(counterpart: segtpu/data/native_io.py).

``native/segtpu_io.cc`` gives GIL-free PNG/JPEG decode and a threaded
read-ahead prefetcher; ``make -C native`` builds it as
``native/libsegtpu_io.so``, which this module loads where it is present,
with the JAX package's signatures:

    decode_image(path) -> np.uint8 [H, W, C]  (C in {1, 3}; C = 1 squeezed)
    Prefetcher(paths, threads=4, lookahead=8) -> iterator of arrays
    available() -> bool

The library is an accelerator, not a dependency: the datasets decode
with PIL where it is absent, and raise, naming both, where neither loads.
"""

from __future__ import annotations

import ctypes
import os
from typing import Sequence

import numpy as np

_LIB_PATH = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), "native",
    "libsegtpu_io.so")

_lib = None


def _load():
    """The bound library, or None where it is not built or not loadable."""
    global _lib
    if _lib is not None:
        return _lib
    if not os.path.exists(_LIB_PATH):
        return None
    try:
        lib = ctypes.CDLL(_LIB_PATH)
    except OSError:
        return None
    lib.image_info.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_int),
                               ctypes.POINTER(ctypes.c_int),
                               ctypes.POINTER(ctypes.c_int)]
    lib.image_info.restype = ctypes.c_int
    lib.decode_image.argtypes = [ctypes.c_char_p,
                                 ctypes.POINTER(ctypes.c_uint8),
                                 ctypes.c_longlong]
    lib.decode_image.restype = ctypes.c_int
    lib.pf_create.argtypes = [ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
                              ctypes.c_int, ctypes.c_int]
    lib.pf_create.restype = ctypes.c_void_p
    lib.pf_next.argtypes = [ctypes.c_void_p,
                            ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
                            ctypes.POINTER(ctypes.c_int),
                            ctypes.POINTER(ctypes.c_int),
                            ctypes.POINTER(ctypes.c_int)]
    lib.pf_next.restype = ctypes.c_int
    lib.pf_destroy.argtypes = [ctypes.c_void_p]
    _lib = lib
    return lib


def available() -> bool:
    return _load() is not None


def decode_image(path: str) -> np.ndarray:
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native IO library not built or not loadable: "
                           f"{_LIB_PATH} (make -C native)")
    h = ctypes.c_int()
    w = ctypes.c_int()
    c = ctypes.c_int()
    if lib.image_info(path.encode(), ctypes.byref(h), ctypes.byref(w),
                      ctypes.byref(c)) != 0:
        raise IOError(f"native decode failed: {path}")
    out = np.empty((h.value, w.value, c.value), np.uint8)
    rc = lib.decode_image(
        path.encode(), out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        out.size)
    if rc != 0:
        raise IOError(f"native decode failed ({rc}): {path}")
    return out[..., 0] if c.value == 1 else out


class Prefetcher:
    """Ordered threaded read-ahead over a path list; yields uint8 arrays."""

    def __init__(self, paths: Sequence[str], *, threads: int = 4,
                 lookahead: int = 8):
        lib = _load()
        if lib is None:
            raise RuntimeError(f"native IO library not built or not "
                               f"loadable: {_LIB_PATH} (make -C native)")
        self._lib = lib
        self._n = len(paths)
        arr = (ctypes.c_char_p * self._n)(*[p.encode() for p in paths])
        self._keepalive = arr
        self._pf = lib.pf_create(arr, self._n, threads, lookahead)
        self._emitted = 0

    def __iter__(self):
        return self

    def __next__(self) -> np.ndarray:
        if self._pf is None or self._emitted >= self._n:
            raise StopIteration
        buf = ctypes.POINTER(ctypes.c_uint8)()
        h = ctypes.c_int()
        w = ctypes.c_int()
        c = ctypes.c_int()
        rc = self._lib.pf_next(self._pf, ctypes.byref(buf), ctypes.byref(h),
                               ctypes.byref(w), ctypes.byref(c))
        if rc == 1:
            raise StopIteration
        if rc != 0:
            raise IOError("native prefetch decode failed")
        self._emitted += 1
        n = h.value * w.value * c.value
        out = np.ctypeslib.as_array(buf, shape=(n,)).copy()
        out = out.reshape(h.value, w.value, c.value)
        return out[..., 0] if c.value == 1 else out

    def close(self):
        if self._pf is not None:
            self._lib.pf_destroy(self._pf)
            self._pf = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

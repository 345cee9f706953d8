"""ctypes bindings for the native domain kernels.

Loads native/libcorrelation_native.so (built with `make -C native`; the
loader builds it on first use when a toolchain is available).  Every entry
point has a NumPy fallback in correlation_jax.domains, so the package works
without the native library — it is a host-side throughput optimization for
large domains, mirroring the reference's native point-selection loops.
"""

from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(__file__)), "native")
_LIB_PATH = os.path.join(_NATIVE_DIR, "libcorrelation_native.so")

_lib = None
_load_attempted = False


def _try_build() -> bool:
    try:
        subprocess.run(
            ["make", "-C", _NATIVE_DIR],
            check=True,
            capture_output=True,
            timeout=120,
        )
        return os.path.exists(_LIB_PATH)
    except Exception:
        return False


def load():
    """Load (building if necessary) the native library, or return None."""
    global _lib, _load_attempted
    if _lib is not None or _load_attempted:
        return _lib
    _load_attempted = True
    if not os.path.exists(_LIB_PATH):
        if not os.path.exists(os.path.join(_NATIVE_DIR, "Makefile")):
            return None
        if not _try_build():
            return None
    try:
        lib = ctypes.CDLL(_LIB_PATH)
    except OSError:
        return None

    i64 = ctypes.c_int64
    f32p = ctypes.POINTER(ctypes.c_float)
    lib.rasterize_polygon_crossing.restype = i64
    lib.rasterize_polygon_crossing.argtypes = [f32p, i64, f32p, i64]
    lib.annular_sector_points.restype = i64
    lib.annular_sector_points.argtypes = [
        ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_float,
        ctypes.c_float, ctypes.c_float, i64, i64, f32p, i64,
    ]
    lib.decimate_points.restype = i64
    lib.decimate_points.argtypes = [f32p, i64, i64, f32p, i64]
    _lib = lib
    return _lib


def available() -> bool:
    return load() is not None


def _f32p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _grow_call(fn, *args, initial_cap: int):
    """Call a count-returning kernel, growing the buffer on overflow."""
    cap = max(initial_cap, 16)
    while True:
        out = np.empty((cap, 2), np.float32)
        n = fn(*args, _f32p(out), cap)
        if n >= 0:
            return out[:n].copy()
        cap = -n


def rasterize_polygon_crossing(contour: np.ndarray) -> np.ndarray | None:
    lib = load()
    if lib is None:
        return None
    contour = np.ascontiguousarray(contour, np.float32)
    n = len(contour)
    bbox_area = 1
    if n >= 3:
        span = contour.max(axis=0) - contour.min(axis=0)
        bbox_area = int(span[0] + 1) * int(span[1] + 1)
    return _grow_call(
        lib.rasterize_polygon_crossing,
        _f32p(contour),
        n,
        initial_cap=bbox_area + 16,
    )


def annular_sector_points(
    r, dr, a, da, cx, cy, as_, cpu_semantics=True
) -> np.ndarray | None:
    lib = load()
    if lib is None:
        return None
    est = int(3.2 * ((r + dr) ** 2 - r * r) / max(as_, 1) * 2.0) + 64
    return _grow_call(
        lib.annular_sector_points,
        ctypes.c_float(r),
        ctypes.c_float(dr),
        ctypes.c_float(a),
        ctypes.c_float(da),
        ctypes.c_float(cx),
        ctypes.c_float(cy),
        as_,
        1 if cpu_semantics else 0,
        initial_cap=est,
    )


def decimate_points(xy: np.ndarray, level: int) -> np.ndarray | None:
    lib = load()
    if lib is None:
        return None
    xy = np.ascontiguousarray(xy, np.float32)
    return _grow_call(
        lib.decimate_points, _f32p(xy), len(xy), level,
        initial_cap=len(xy) // (4 ** level) + 16,
    )

"""Native C++ domain kernels vs the NumPy reference paths."""

import math

import numpy as np
import pytest

from correlation_jax import domains, native

pytestmark = pytest.mark.skipif(
    not native.available(), reason="native library not built"
)


def test_polygon_rasterizer_matches_numpy():
    contour = np.array(
        [[5, 5], [25, 6], [28, 20], [15, 28], [4, 18]], np.float32
    )
    a = native.rasterize_polygon_crossing(contour)
    # Force the numpy path by comparing against the module-level
    # implementation with native disabled.
    lib = native._lib
    try:
        native._lib = None
        native._load_attempted = True
        b = domains.blob_inside_points_crossing(contour)
    finally:
        native._lib = lib
        native._load_attempted = True
    assert {tuple(p) for p in a} == {tuple(p) for p in b}


def test_annular_matches_numpy():
    args = (10.0, 10.0, 0.3, math.pi / 3, 50.0, 50.0, 6)
    a = native.annular_sector_points(*args)
    lib = native._lib
    try:
        native._lib = None
        b = domains.annular_sector_points(*args)
    finally:
        native._lib = lib
    assert {tuple(p) for p in a} == {tuple(p) for p in b}


def test_decimate_matches_numpy():
    pts = domains.rectangular_points(16, 16, 9, 9)
    got = native.decimate_points(pts, 2)
    keep = (pts.astype(int) % 4 == 0).all(axis=1)
    expect = pts[keep] / 4
    assert np.allclose(
        sorted(map(tuple, got)), sorted(map(tuple, expect))
    )


def test_buffer_growth_on_large_polygon():
    # big polygon exercises the grow-and-retry path
    theta = np.linspace(0, 2 * np.pi, 64, endpoint=False)
    contour = np.stack(
        [200 + 150 * np.cos(theta), 200 + 150 * np.sin(theta)], -1
    ).astype(np.float32)
    pts = native.rasterize_polygon_crossing(contour)
    # ~pi r^2 interior pixels
    assert abs(len(pts) - math.pi * 150**2) < 2000

import jax.numpy as jnp
import numpy as np

from correlation_jax.ops.pyramid import BINOMIAL_1D, build_pyramid
from synthetic import Speckle


def _reference_downsample(src: np.ndarray) -> np.ndarray:
    """Direct serial transcription of the downsample semantics
    (pyramid_class.cpp:92-126): 5x5 kernel around source (2ti, 2tj),
    zero border, uint8 truncation — in exact integer arithmetic (the
    weights are multiples of 1/400)."""
    kernel = np.rint(np.outer(BINOMIAL_1D, BINOMIAL_1D) * 400).astype(
        np.int64
    )
    assert kernel.sum() == 400
    src = src.astype(np.int64)
    sr, sc = src.shape
    tr, tc = sr // 2, sc // 2
    out = np.zeros((tr, tc), np.float32)
    for tj in range(1, tr - 1):
        for ti in range(1, tc - 1):
            sj, si = 2 * tj, 2 * ti
            acc = 0
            for dj in range(-2, 3):
                for di in range(-2, 3):
                    acc += src[sj + dj, si + di] * kernel[dj + 2, di + 2]
            out[tj, ti] = acc // 400
    return out


def test_pyramid_matches_reference_semantics():
    img = Speckle(37, 42, seed=5).image(quantize=True)
    levels = build_pyramid(jnp.asarray(img[..., None]), 2)
    ref1 = _reference_downsample(img)
    ref2 = _reference_downsample(ref1)

    got1 = np.asarray(levels[1])[..., 0]
    got2 = np.asarray(levels[2])[..., 0]
    assert got1.shape == ref1.shape
    assert got2.shape == ref2.shape
    np.testing.assert_array_equal(got1, ref1)
    np.testing.assert_array_equal(got2, ref2)


def test_pyramid_borders_zero_and_dims():
    img = Speckle(33, 41, seed=6).image(quantize=True)
    levels = build_pyramid(jnp.asarray(img[..., None]), 2)
    assert levels[1].shape == (16, 20, 1)
    assert levels[2].shape == (8, 10, 1)
    lvl1 = np.asarray(levels[1])[..., 0]
    assert np.all(lvl1[0] == 0) and np.all(lvl1[-1] == 0)
    assert np.all(lvl1[:, 0] == 0) and np.all(lvl1[:, -1] == 0)
    # interior is real data
    assert lvl1[1:-1, 1:-1].max() > 0

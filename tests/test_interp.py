import jax.numpy as jnp
import numpy as np
import pytest

import oracle
from correlation_jax.config import Interpolation
from correlation_jax.ops.interp import (
    _bicubic_inverse_matrix,
    precompute_field,
    sample_field,
    sample_integer,
)
from synthetic import Speckle


def test_inverse_matrix_is_exact_inverse():
    inv = _bicubic_inverse_matrix()
    cmat = oracle._constraint_matrix()
    np.testing.assert_allclose(inv @ cmat, np.eye(16), atol=1e-12)
    # the reference hard-codes an exact integer inverse
    # (interpolation_class.cpp:539-558); ours must be integral too
    assert np.all(inv == np.round(inv))


def test_bicubic_reproduces_biquadratic():
    # Central differences are exact for quadratics, so the interpolant of a
    # biquadratic field reproduces values AND derivatives exactly.
    h, w = 16, 17
    gy, gx = np.mgrid[0:h, 0:w].astype(np.float64)
    img = 0.3 * gx * gx + 0.2 * gy * gy + 0.1 * gx * gy + gx + 2 * gy + 5
    field = precompute_field(jnp.asarray(img[..., None], jnp.float32),
                             Interpolation.BICUBIC)
    pts = np.array([[3.3, 4.7], [8.1, 9.9], [5.5, 2.2], [12.9, 11.1]])
    wv, dwdx, dwdy, valid = sample_field(
        field, Interpolation.BICUBIC, jnp.asarray(pts, jnp.float32)
    )
    assert bool(jnp.all(valid))
    x, y = pts[:, 0], pts[:, 1]
    np.testing.assert_allclose(
        wv[:, 0],
        0.3 * x * x + 0.2 * y * y + 0.1 * x * y + x + 2 * y + 5,
        rtol=1e-4,
    )
    np.testing.assert_allclose(dwdx[:, 0], 0.6 * x + 0.1 * y + 1, rtol=1e-3)
    np.testing.assert_allclose(dwdy[:, 0], 0.4 * y + 0.1 * x + 2, rtol=1e-3)


@pytest.mark.parametrize(
    "interp,name",
    [
        (Interpolation.BICUBIC, "bicubic"),
        (Interpolation.BILINEAR, "bilinear"),
        (Interpolation.NEAREST, "nearest"),
    ],
)
def test_matches_oracle(interp, name):
    img = np.floor(Speckle(24, 26, seed=3).image()).astype(np.float64)
    field = precompute_field(
        jnp.asarray(img[..., None], jnp.float32), interp
    )
    rng = np.random.default_rng(7)
    pts = rng.uniform(2.2, 20.0, (40, 2))
    wv, dwdx, dwdy, valid = sample_field(
        field, interp, jnp.asarray(pts, jnp.float32)
    )
    for k, (x, y) in enumerate(pts):
        ow, ox, oy, ov = oracle.INTERP[name](img, x, y)
        assert bool(valid[k]) == ov, (x, y)
        np.testing.assert_allclose(float(wv[k, 0]), ow, atol=2e-2)
        np.testing.assert_allclose(float(dwdx[k, 0]), ox, atol=2e-2)
        np.testing.assert_allclose(float(dwdy[k, 0]), oy, atol=2e-2)


def test_validity_window_bicubic():
    img = np.ones((12, 15), np.float64)
    field = precompute_field(
        jnp.asarray(img[..., None], jnp.float32), Interpolation.BICUBIC
    )
    pts = np.array(
        [
            [1.0, 5.0],  # x == 1 -> invalid (strict >)
            [1.01, 5.0],  # valid
            [13.0, 5.0],  # x == W-2 -> invalid (strict <)
            [12.99, 5.0],  # valid
            [5.0, 1.0],  # invalid
            [5.0, 9.99],  # valid
            [5.0, 10.0],  # y == H-2 -> invalid
            [-3.0, 5.0],  # invalid
        ]
    )
    _, _, _, valid = sample_field(
        field, Interpolation.BICUBIC, jnp.asarray(pts, jnp.float32)
    )
    np.testing.assert_array_equal(
        np.asarray(valid),
        [False, True, False, True, False, True, False, False],
    )


def test_sample_integer_rounds():
    img = np.arange(20, dtype=np.float32).reshape(4, 5)
    out = sample_integer(
        jnp.asarray(img[..., None]),
        jnp.asarray([[1.4, 2.6], [1.5, 2.4]], jnp.float32),
    )
    # (1.4 -> 1, 2.6 -> 3): img[3, 1] = 16 ; (1.5 -> 2, 2.4 -> 2): img[2,2]=12
    np.testing.assert_allclose(out[:, 0], [16.0, 12.0])

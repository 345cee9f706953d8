import jax
import jax.numpy as jnp
import numpy as np
import pytest

from correlation_jax.config import FittingModel, NUM_PARAMS
from correlation_jax.models.warp import (
    best_rotation_affine,
    steepest_descent,
    translate_params,
    warp_jacobian,
    warp_points,
)

MODELS = list(FittingModel)


@pytest.mark.parametrize("model", MODELS)
def test_jacobian_matches_autodiff(model):
    rng = np.random.default_rng(0)
    num_p = NUM_PARAMS[model]
    params = jnp.asarray(rng.normal(0, 0.1, (num_p,)), jnp.float32)
    xy = jnp.asarray(rng.uniform(0, 50, (7, 2)), jnp.float32)
    center = jnp.asarray([25.0, 20.0], jnp.float32)

    def f(p):
        return warp_points(model, p, xy, center)

    jac = jax.jacfwd(f)(params)  # [P, 2, NP]
    jx, jy = warp_jacobian(model, xy, center)
    np.testing.assert_allclose(jac[:, 0, :], jx, atol=1e-5)
    np.testing.assert_allclose(jac[:, 1, :], jy, atol=1e-5)


@pytest.mark.parametrize("model", MODELS)
def test_warp_batched_shapes(model):
    num_p = NUM_PARAMS[model]
    params = jnp.zeros((4, num_p))
    xy = jnp.zeros((4, 9, 2))
    center = jnp.zeros((4, 2))
    out = warp_points(model, params, xy, center)
    assert out.shape == (4, 9, 2)
    # zero parameters = identity warp
    np.testing.assert_allclose(out, xy)


@pytest.mark.parametrize("model", MODELS)
def test_steepest_descent_consistent(model):
    rng = np.random.default_rng(1)
    xy = jnp.asarray(rng.uniform(0, 30, (2, 11, 2)), jnp.float32)
    center = jnp.asarray(rng.uniform(0, 30, (2, 2)), jnp.float32)
    dwdx = jnp.asarray(rng.normal(size=(2, 11)), jnp.float32)
    dwdy = jnp.asarray(rng.normal(size=(2, 11)), jnp.float32)
    h = steepest_descent(model, xy, center, dwdx, dwdy)
    jx, jy = warp_jacobian(model, xy, center)
    expect = dwdx[..., None] * jx + dwdy[..., None] * jy
    np.testing.assert_allclose(h, expect, atol=1e-5)


def test_translate_params_scales_only_uv():
    p = jnp.asarray([[4.0, -2.0, 0.1, 0.2, 0.3, 0.4]])
    down = translate_params(p, 0, 2)  # level 0 -> level 2: divide by 4
    np.testing.assert_allclose(
        down, [[1.0, -0.5, 0.1, 0.2, 0.3, 0.4]], atol=1e-6
    )
    up = translate_params(down, 2, 0)
    np.testing.assert_allclose(up, p, atol=1e-6)


def test_best_rotation_affine():
    # Pure small rotation: ux=vy=cos-1, uy=-sin, vx=sin
    theta = 0.05
    p = jnp.asarray(
        [
            0.0,
            0.0,
            np.cos(theta) - 1,
            -np.sin(theta),
            np.sin(theta),
            np.cos(theta) - 1,
        ],
        jnp.float32,
    )
    angle = best_rotation_affine(p)
    np.testing.assert_allclose(angle, theta, atol=1e-5)

"""Parametric warp models as pure batched functions.

The reference implements these as per-thread C++ classes writing point-major
buffers (model_class.cpp:48-202).  Here each model is a pure function over
arrays with arbitrary leading batch dimensions; the Jacobian dT/dp is emitted
in closed form (cheaper and exact, matching the reference layout semantics:
rows = (x, y), columns = parameters).

Forward-additive warps, parameters p, subset center c = (cx, cy),
d = (x, y) - c:

  U      (p = [u])                    : T(x,y) = (x + u, y)
  UV     (p = [u, v])                 : T(x,y) = (x + u, y + v)
  UVQ    (p = [u, v, q])              : T(x,y) = (x + u - q*dy, y + v + q*dx)
                                        (small-rotation model, model_class.cpp:107-148)
  AFFINE (p = [u, v, ux, uy, vx, vy]) : T(x,y) = (x + u + ux*dx + uy*dy,
                                                  y + v + vx*dx + vy*dy)
                                        (model_class.cpp:150-202)
"""

from __future__ import annotations

import jax.numpy as jnp

from correlation_jax.config import FittingModel, NUM_PARAMS


def warp_points(model: FittingModel, params, xy, center):
    """Apply the warp.

    Args:
      model: warp model.
      params: [..., NP] parameters (batch dims broadcast against xy's).
      xy: [..., P, 2] undeformed pixel positions.
      center: [..., 2] undeformed subset center.

    Returns:
      [..., P, 2] deformed positions.
    """
    x = xy[..., 0]
    y = xy[..., 1]
    if model == FittingModel.U:
        u = params[..., 0:1]
        return jnp.stack([x + u, y], axis=-1)
    if model == FittingModel.UV:
        u = params[..., 0:1]
        v = params[..., 1:2]
        return jnp.stack([x + u, y + v], axis=-1)

    dx = x - center[..., 0:1]
    dy = y - center[..., 1:2]
    if model == FittingModel.UVQ:
        u = params[..., 0:1]
        v = params[..., 1:2]
        q = params[..., 2:3]
        return jnp.stack([x + u - q * dy, y + v + q * dx], axis=-1)
    if model == FittingModel.AFFINE:
        u, v, ux, uy, vx, vy = (params[..., i : i + 1] for i in range(6))
        return jnp.stack(
            [x + u + ux * dx + uy * dy, y + v + vx * dx + vy * dy], axis=-1
        )
    raise ValueError(f"unknown model {model}")


def warp_jacobian(model: FittingModel, xy, center):
    """Closed-form dT/dp.

    Args:
      xy: [..., P, 2] undeformed positions.
      center: [..., 2] subset center.

    Returns:
      (jac_x, jac_y): each [..., P, NP] — dTx/dp and dTy/dp
      (reference layout: model_class.cpp:173-191).

    Independent of params for all supported models (forward-additive).
    """
    shape = xy.shape[:-1]
    ones = jnp.ones(shape, jnp.float32)
    zeros = jnp.zeros(shape, jnp.float32)
    if model == FittingModel.U:
        return ones[..., None], zeros[..., None]
    if model == FittingModel.UV:
        jx = jnp.stack([ones, zeros], axis=-1)
        jy = jnp.stack([zeros, ones], axis=-1)
        return jx, jy

    dx = xy[..., 0] - center[..., 0:1]
    dy = xy[..., 1] - center[..., 1:2]
    if model == FittingModel.UVQ:
        jx = jnp.stack([ones, zeros, -dy], axis=-1)
        jy = jnp.stack([zeros, ones, dx], axis=-1)
        return jx, jy
    if model == FittingModel.AFFINE:
        jx = jnp.stack([ones, zeros, dx, dy, zeros, zeros], axis=-1)
        jy = jnp.stack([zeros, ones, zeros, zeros, dx, dy], axis=-1)
        return jx, jy
    raise ValueError(f"unknown model {model}")


def steepest_descent(model: FittingModel, xy, center, dwdx, dwdy):
    """Steepest-descent images H[p] = dw/dx * dTx/dp + dw/dy * dTy/dp.

    The batched analog of the per-point H assembly in
    interpolation_class.cpp:728-739.  Written per-model to avoid
    materializing the Jacobian where it is sparse/constant.

    Args:
      xy: [..., P, 2]; center: [..., 2]; dwdx, dwdy: [..., P].

    Returns:
      [..., P, NP]
    """
    if model == FittingModel.U:
        return dwdx[..., None]
    if model == FittingModel.UV:
        return jnp.stack([dwdx, dwdy], axis=-1)
    dx = xy[..., 0] - center[..., 0:1]
    dy = xy[..., 1] - center[..., 1:2]
    if model == FittingModel.UVQ:
        return jnp.stack([dwdx, dwdy, -dwdx * dy + dwdy * dx], axis=-1)
    if model == FittingModel.AFFINE:
        return jnp.stack(
            [dwdx, dwdy, dwdx * dx, dwdx * dy, dwdy * dx, dwdy * dy], axis=-1
        )
    raise ValueError(f"unknown model {model}")


def translate_params(params, src_level: int, dst_level: int):
    """Rescale parameters between pyramid levels.

    Only the translation components u, v scale by 2^(src-dst); strain and
    rotation parameters are scale-invariant (pyramid_class.cpp:260-287).
    """
    if src_level == dst_level:
        return params
    magnification = float(2.0 ** (src_level - dst_level))
    num_params = params.shape[-1]
    scale = jnp.where(
        jnp.arange(num_params) < 2, jnp.float32(magnification), jnp.float32(1)
    )
    return params * scale


def best_rotation_affine(params):
    """Best-fit rotation angle of an AFFINE warp.

    atan2(Vx - Uy, Ux + Vy + 2) — reference parameters.cpp:55-58.
    params: [..., 6].
    """
    return jnp.arctan2(
        params[..., 4] - params[..., 3], params[..., 2] + params[..., 5] + 2.0
    )


def rotation_angle(model: FittingModel, params):
    """Rotation angle reported per model (manager_class.cpp:2365-2400).

    U/UV: 0.  UVQ: the q parameter.  AFFINE: best-fit rotation.
    """
    if model in (FittingModel.U, FittingModel.UV):
        return jnp.zeros(params.shape[:-1], jnp.float32)
    if model == FittingModel.UVQ:
        return params[..., 2]
    return best_rotation_affine(params)


def num_params(model: FittingModel) -> int:
    return NUM_PARAMS[model]

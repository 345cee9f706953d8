from correlation_jax.models.warp import (
    warp_points,
    warp_jacobian,
    steepest_descent,
    translate_params,
    best_rotation_affine,
    rotation_angle,
)

__all__ = [
    "warp_points",
    "warp_jacobian",
    "steepest_descent",
    "translate_params",
    "best_rotation_affine",
    "rotation_angle",
]

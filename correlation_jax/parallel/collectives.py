"""Pixel-sharded normal-equation assembly with collective H/b reduction.

For very large subsets (or a dense grid treated as one giant reduction), the
pixel axis itself shards across the mesh and the per-device partial
A/b/chi sums reduce with `lax.psum` — the cross-chip generalization of the
reference's intra-GPU tree reduction (correlationKernel.cu:245-266,
kernels.cu:56-103), across devices instead of through shared memory.

This is BASELINE.json config 5's "collective H/b reduction".
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from correlation_jax.config import FittingModel, Interpolation
from correlation_jax.ops.assemble import assemble_normal_equations
from correlation_jax.ops.interp import InterpField

PIXEL_AXIS = "pixels"


def make_pixel_mesh(devices=None) -> Mesh:
    import numpy as np

    if devices is None:
        devices = jax.devices()
    return Mesh(np.array(devices), (PIXEL_AXIS,))


def assemble_pixel_sharded(
    mesh: Mesh,
    model: FittingModel,
    interp: Interpolation,
    def_field: InterpField,
    und_w: jax.Array,
    xy: jax.Array,
    mask: jax.Array,
    center: jax.Array,
    params: jax.Array,
):
    """Assembly with the PIXEL axis sharded across the mesh.

    Inputs are the same shapes as assemble_normal_equations; xy/mask/und_w
    shard on axis 1 (pixels), the image field and parameters replicate.
    Each device assembles its pixel shard, then A/b/chi/err all-reduce.

    The P axis length must be divisible by the mesh size (pad with masked
    pixels).
    """

    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(
            P(),  # field
            P(None, PIXEL_AXIS, None),  # und_w
            P(None, PIXEL_AXIS, None),  # xy
            P(None, PIXEL_AXIS),  # mask
            P(),  # center
            P(),  # params
        ),
        out_specs=(P(), P(), P(), P()),
    )
    def _shard(field, und_w_s, xy_s, mask_s, center_r, params_r):
        a_mat, b_vec, chi, err = assemble_normal_equations(
            model, interp, InterpField(field), und_w_s, xy_s, mask_s,
            center_r, params_r,
        )
        a_mat = jax.lax.psum(a_mat, PIXEL_AXIS)
        b_vec = jax.lax.psum(b_vec, PIXEL_AXIS)
        chi = jax.lax.psum(chi, PIXEL_AXIS)
        err = jax.lax.psum(err.astype(jnp.int32), PIXEL_AXIS) > 0
        return a_mat, b_vec, chi, err

    return _shard(def_field.field, und_w, xy, mask, center, params)

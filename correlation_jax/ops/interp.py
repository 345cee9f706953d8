"""Subpixel interpolation of image intensity and gradients.

Batched design.  The reference evaluates interpolation coefficients lazily
per pixel: the CPU engine memoizes them in a per-image cache
(interpolation_class.cpp:228-241), the CUDA engine recomputes them per read
from texture memory (correlationKernel.cu:601-811).  Both compute the same
thing: per integer pixel, a small set of polynomial coefficients that is a
*fixed linear map* of the local neighborhood.

A fixed linear map of a neighborhood is a convolution.  So here the whole
coefficient cache is materialized in one shot as a "coefficient field":

    field[y, x, :] = M @ window(image, y, x).flatten()

computed with `lax.conv_general_dilated` (16 output channels for bicubic),
once per frame.  Each solver iteration then needs a single
contiguous K-float gather per pixel plus vector math, instead of 16 scattered
image reads.

The bicubic polynomial basis, finite-difference derivative constraints, local
coordinate offset (+1), and validity window replicate
interpolation_class.cpp:79-138 (evaluation) and :243-336 (coefficients)
exactly; the 16x16 inverse constraint matrix is rederived here by float64
inversion of the constraint system and verified integral (it equals the
hard-coded exact matrix at interpolation_class.cpp:539-558).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp

from correlation_jax.config import Interpolation

# Number of polynomial coefficients per interpolation model
# (interpolation_class.cpp:614-628).
NUM_COEFFS = {
    Interpolation.NEAREST: 3,
    Interpolation.BILINEAR: 4,
    Interpolation.BICUBIC: 16,
}

# Neighborhood window edge length per model.
WINDOW = {
    Interpolation.NEAREST: 2,
    Interpolation.BILINEAR: 2,
    Interpolation.BICUBIC: 4,
}

# Offset of the window's top-left corner relative to the anchor pixel
# (bicubic anchors at (ix-1, iy-1): interpolation_class.cpp:252-261).
WINDOW_OFFSET = {
    Interpolation.NEAREST: 0,
    Interpolation.BILINEAR: 0,
    Interpolation.BICUBIC: 1,
}


@functools.cache
def _bicubic_inverse_matrix() -> np.ndarray:
    """Invert the bicubic constraint system (float64, exact integers).

    Coefficient k = 4*j + i multiplies y^j x^i; constraints are the value,
    d/dx, d/dy and d2/dxdy at the four interior points (x, y) in {1, 2}^2,
    mirroring interpolation_class.cpp:408-536 (the commented-out derivation
    whose exact solution is hard-coded at :539-558).
    """
    pts = [(1.0, 1.0), (2.0, 1.0), (1.0, 2.0), (2.0, 2.0)]
    rows = []
    for x, y in pts:  # values
        rows.append([y**j * x**i for j in range(4) for i in range(4)])
    for x, y in pts:  # d/dx
        rows.append(
            [i * y**j * x ** max(i - 1, 0) for j in range(4) for i in range(4)]
        )
    for x, y in pts:  # d/dy
        rows.append(
            [j * y ** max(j - 1, 0) * x**i for j in range(4) for i in range(4)]
        )
    for x, y in pts:  # d2/dxdy
        rows.append(
            [
                i * j * y ** max(j - 1, 0) * x ** max(i - 1, 0)
                for j in range(4)
                for i in range(4)
            ]
        )
    inv = np.linalg.inv(np.array(rows, np.float64))
    rounded = np.round(inv)
    assert np.abs(inv - rounded).max() < 1e-9, "bicubic inverse not integral"
    return rounded


@functools.cache
def _coeff_filters(interp: Interpolation) -> np.ndarray:
    """The K filters of size WxW mapping a neighborhood to coefficients.

    Returns [W, W, 1, K] (HWIO) float32; window rows are image rows (y),
    columns are image columns (x).
    """
    if interp == Interpolation.BICUBIC:
        # Constraint vector from the 4x4 window (window[j, i]: j = y row,
        # i = x column), exactly interpolation_class.cpp:296-321.  The
        # reference's w<X><Y> names use X = x column, Y = y row.
        c = np.zeros((16, 4, 4), np.float64)

        def at(r, j, i, v):
            c[r, j, i] += v

        # values at (x,y) = (1,1),(2,1),(1,2),(2,2)
        for r, (x, y) in enumerate([(1, 1), (2, 1), (1, 2), (2, 2)]):
            at(r, y, x, 1.0)
        # x-derivatives: (w[x+1,y] - w[x-1,y]) / 2
        for r, (x, y) in enumerate([(1, 1), (2, 1), (1, 2), (2, 2)]):
            at(4 + r, y, x + 1, 0.5)
            at(4 + r, y, x - 1, -0.5)
        # y-derivatives: (w[x,y+1] - w[x,y-1]) / 2
        for r, (x, y) in enumerate([(1, 1), (2, 1), (1, 2), (2, 2)]):
            at(8 + r, y + 1, x, 0.5)
            at(8 + r, y - 1, x, -0.5)
        # xy-derivatives: (w[x+1,y+1] + w[x-1,y-1] - w[x-1,y+1] - w[x+1,y-1]) / 4
        for r, (x, y) in enumerate([(1, 1), (2, 1), (1, 2), (2, 2)]):
            at(12 + r, y + 1, x + 1, 0.25)
            at(12 + r, y - 1, x - 1, 0.25)
            at(12 + r, y + 1, x - 1, -0.25)
            at(12 + r, y - 1, x + 1, -0.25)

        m16 = _bicubic_inverse_matrix() @ c.reshape(16, 16)  # coeff <- window
        filt = m16.reshape(16, 4, 4).transpose(1, 2, 0)  # HWK
    elif interp == Interpolation.BILINEAR:
        # coefficients [w00, w10-w00, w01-w00, w11-w10-w01+w00]
        # (interpolation_class.cpp:338-374; w<X><Y>: X = x col, Y = y row)
        filt = np.zeros((2, 2, 4), np.float64)
        filt[0, 0, 0] = 1.0
        filt[0, 1, 1] = 1.0
        filt[0, 0, 1] = -1.0
        filt[1, 0, 2] = 1.0
        filt[0, 0, 2] = -1.0
        filt[1, 1, 3] = 1.0
        filt[0, 1, 3] = -1.0
        filt[1, 0, 3] = -1.0
        filt[0, 0, 3] = 1.0
    elif interp == Interpolation.NEAREST:
        # [w00, w10-w00, w01-w00]: value + forward differences
        # (interpolation_class.cpp:376-406)
        filt = np.zeros((2, 2, 3), np.float64)
        filt[0, 0, 0] = 1.0
        filt[0, 1, 1] = 1.0
        filt[0, 0, 1] = -1.0
        filt[1, 0, 2] = 1.0
        filt[0, 0, 2] = -1.0
    else:
        raise ValueError(f"unknown interpolation {interp}")
    return filt[:, :, None, :].astype(np.float32)


class InterpField(NamedTuple):
    """Precomputed coefficient field for one image.

    field: [Hf, Wf, C, K] where Hf = H - W + 1, Wf = W - W + 1 for window
    size W; field[y, x] are the coefficients anchored at image pixel
    (x + off, y + off) with off = WINDOW_OFFSET.
    """

    field: jax.Array

    def image_shape(self, interp: Interpolation) -> tuple[int, int]:
        win = WINDOW[interp]
        return self.field.shape[0] + win - 1, self.field.shape[1] + win - 1


def precompute_field(image: jax.Array, interp: Interpolation) -> InterpField:
    """Compute the interpolation-coefficient field of an image.

    Args:
      image: [H, W, C] float32 (integer-valued intensities).
      interp: interpolation model.

    Returns:
      InterpField with field [H-win+1, W-win+1, C, K].
    """
    h, w, c = image.shape
    k = NUM_COEFFS[interp]
    filters = jnp.asarray(_coeff_filters(interp))  # [win, win, 1, K]
    if c > 1:
        # Depthwise: each color convolved with the same K filters.
        filters = jnp.tile(filters, (1, 1, 1, c))  # groups ordered by color
    out = jax.lax.conv_general_dilated(
        image[None],
        filters,
        window_strides=(1, 1),
        padding="VALID",
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        feature_group_count=c,
        precision=jax.lax.Precision.HIGHEST,
    )[0]
    hf, wf = out.shape[0], out.shape[1]
    return InterpField(out.reshape(hf, wf, c, k))


def sample_field(
    coeffs: InterpField, interp: Interpolation, def_xy: jax.Array
):
    """Evaluate intensity and gradients at subpixel deformed positions.

    Replicates InterpolationClass_*::get_interpolation
    (interpolation_class.cpp:79-226): truncation to the anchor pixel, the +1
    local-coordinate offset for bicubic, polynomial evaluation of w, dw/dx,
    dw/dy, and the validity window.  Out-of-window samples return zeros and
    valid=False (the reference sets error_interpolation_out_of_image).

    Args:
      coeffs: precomputed field of the deformed image.
      interp: interpolation model.
      def_xy: [..., 2] float32 deformed positions.

    Returns:
      w: [..., C] intensities; dwdx, dwdy: [..., C]; valid: [...] bool.
    """
    h, w_img = coeffs.image_shape(interp)
    hf, wf, c, k = coeffs.field.shape
    field = coeffs.field.reshape(hf * wf, c * k)

    xdef = def_xy[..., 0]
    ydef = def_xy[..., 1]

    if interp == Interpolation.BICUBIC:
        valid = (
            (xdef > 1.0)
            & (ydef > 1.0)
            & (xdef < w_img - 2.0)
            & (ydef < h - 2.0)
        )
        ix = jnp.floor(xdef).astype(jnp.int32)
        iy = jnp.floor(ydef).astype(jnp.int32)
        # Local coordinates live in [1, 2): interpolation_class.cpp:94-95.
        dx = xdef - ix.astype(jnp.float32) + 1.0
        dy = ydef - iy.astype(jnp.float32) + 1.0
        fx = jnp.clip(ix - 1, 0, wf - 1)
        fy = jnp.clip(iy - 1, 0, hf - 1)
        cf = jnp.take(field, fy * wf + fx, axis=0)  # [..., C*K]
        cf = cf.reshape(cf.shape[:-1] + (c, k))

        one = jnp.ones_like(dx)
        zero = jnp.zeros_like(dx)
        px = jnp.stack([one, dx, dx * dx, dx * dx * dx], axis=-1)
        py = jnp.stack([one, dy, dy * dy, dy * dy * dy], axis=-1)
        dpx = jnp.stack([zero, one, 2.0 * dx, 3.0 * dx * dx], axis=-1)
        dpy = jnp.stack([zero, one, 2.0 * dy, 3.0 * dy * dy], axis=-1)

        wv = (py[..., :, None] * px[..., None, :]).reshape(px.shape[:-1] + (16,))
        wx = (py[..., :, None] * dpx[..., None, :]).reshape(wv.shape)
        wy = (dpy[..., :, None] * px[..., None, :]).reshape(wv.shape)

        hp = jax.lax.Precision.HIGHEST
        w_out = jnp.einsum("...ck,...k->...c", cf, wv, precision=hp)
        dwdx = jnp.einsum("...ck,...k->...c", cf, wx, precision=hp)
        dwdy = jnp.einsum("...ck,...k->...c", cf, wy, precision=hp)
    elif interp == Interpolation.BILINEAR:
        valid = (
            (xdef > 0.0)
            & (ydef > 0.0)
            & (xdef < w_img - 1.0)
            & (ydef < h - 1.0)
        )
        ix = jnp.floor(xdef).astype(jnp.int32)
        iy = jnp.floor(ydef).astype(jnp.int32)
        dx = xdef - ix.astype(jnp.float32)
        dy = ydef - iy.astype(jnp.float32)
        fx = jnp.clip(ix, 0, wf - 1)
        fy = jnp.clip(iy, 0, hf - 1)
        cf = jnp.take(field, fy * wf + fx, axis=0)
        cf = cf.reshape(cf.shape[:-1] + (c, k))
        a0, a1, a2, a3 = (cf[..., i] for i in range(4))
        dxe = dx[..., None]
        dye = dy[..., None]
        w_out = a0 + a1 * dxe + a2 * dye + a3 * dxe * dye
        dwdx = a1 + a3 * dye
        dwdy = a2 + a3 * dxe
    elif interp == Interpolation.NEAREST:
        valid = (
            (xdef > 0.0)
            & (ydef > 0.0)
            & (xdef < w_img - 1.0)
            & (ydef < h - 1.0)
        )
        ix = jnp.floor(xdef + 0.5).astype(jnp.int32)
        iy = jnp.floor(ydef + 0.5).astype(jnp.int32)
        fx = jnp.clip(ix, 0, wf - 1)
        fy = jnp.clip(iy, 0, hf - 1)
        cf = jnp.take(field, fy * wf + fx, axis=0)
        cf = cf.reshape(cf.shape[:-1] + (c, k))
        w_out = cf[..., 0]
        dwdx = cf[..., 1]
        dwdy = cf[..., 2]
    else:
        raise ValueError(f"unknown interpolation {interp}")

    vmask = valid[..., None]
    return (
        jnp.where(vmask, w_out, 0.0),
        jnp.where(vmask, dwdx, 0.0),
        jnp.where(vmask, dwdy, 0.0),
        valid,
    )


def sample_integer(image: jax.Array, xy: jax.Array) -> jax.Array:
    """Read intensities at rounded integer positions (no interpolation).

    The undeformed image is always read this way
    (interpolation_class.cpp:701-714: int(x + 0.5)).

    Args:
      image: [H, W, C] float32.
      xy: [..., 2].

    Returns:
      [..., C] intensities.
    """
    h, w, c = image.shape
    ix = jnp.clip(jnp.floor(xy[..., 0] + 0.5).astype(jnp.int32), 0, w - 1)
    iy = jnp.clip(jnp.floor(xy[..., 1] + 0.5).astype(jnp.int32), 0, h - 1)
    return jnp.take(image.reshape(h * w, c), iy * w + ix, axis=0)

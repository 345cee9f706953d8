"""Fused Gauss-Newton normal-equation assembly, batched over subsets.

The batched analog of the reference's hottest code — the per-pixel loop in
InterpolationClass::get_multiple_interpolations (interpolation_class.cpp:
671-764) and the fused CUDA kernel kCorrelation (correlationKernel.cu:122-268):

    per pixel:  V    = und_w - W(def_xy)
                H[p] = dW/dx * dTx/dp + dW/dy * dTy/dp
    reduce:     chi += V^2 ;  b += H V ;  A += H H^T

Instead of thread fan-out (CPU) or a shared-memory block reduction (CUDA),
the pixel axis reduces with one batched Gram matmul G^T G and the subset
axis is a leading batch dimension sharded over the device mesh.

Two interchangeable sampling strategies (engine.resolve_backend picks):

  * assemble_normal_equations ("xla") — coefficient field + gather: one
    contiguous K-float gather per pixel from a field precomputed once per
    image (ops/interp.py).
  * assemble_normal_equations_tiles ("xla_sep") — gather-free separable
    form: each subset's deformed-image tile is extracted with one
    dynamic_slice, and the reference's finite-difference-constrained
    bicubic is evaluated in its separable Catmull-Rom form as two batched
    weight-matrix contractions against the tile.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from correlation_jax.config import FittingModel, Interpolation
from correlation_jax.models.warp import warp_jacobian, warp_points
from correlation_jax.ops.interp import InterpField, sample_field


def assemble_normal_equations(
    model: FittingModel,
    interp: Interpolation,
    def_field: InterpField,
    und_w: jax.Array,
    xy: jax.Array,
    mask: jax.Array,
    center: jax.Array,
    params: jax.Array,
):
    """Assemble per-subset A, b, chi (unscaled sums, like the reference).

    Args:
      model: warp model.
      interp: interpolation model.
      def_field: coefficient field of the deformed image at this level.
      und_w: [S, P, C] undeformed intensities at the (rounded) subset pixels
        (iteration-invariant; gathered once per level with sample_integer).
      xy: [S, P, 2] undeformed pixel positions at this level.
      mask: [S, P] bool; False entries are padding.
      center: [S, 2] undeformed subset centers at this level.
      params: [S, NP] current warp parameters.

    Returns:
      a_mat: [S, NP, NP] sum of H H^T over real, in-image pixels,
      b_vec: [S, NP] sum of H V,
      chi:   [S] sum of V^2,
      err:   [S] bool — True if any real pixel sampled out of image
             (== error_interpolation_out_of_image,
             interpolation_class.cpp:129-137).
    """
    def_xy = warp_points(model, params, xy, center)  # [S, P, 2]
    w, dwdx, dwdy, valid = sample_field(def_field, interp, def_xy)  # [S, P, C]
    return _reduce_gram(model, xy, mask, center, und_w, w, dwdx, dwdy, valid)


def _cubic_taps(t):
    """Catmull-Rom value and derivative taps at offsets -1..2 (Horner).

    Equals the reference's finite-difference-constrained bicubic
    (interpolation_class.cpp:296-321,539-558) in separable form.
    """
    k = (
        ((-0.5 * t + 1.0) * t - 0.5) * t,
        (1.5 * t - 2.5) * t * t + 1.0,
        ((-1.5 * t + 2.0) * t + 0.5) * t,
        (0.5 * t - 0.5) * t * t,
    )
    dk = (
        (-1.5 * t + 2.0) * t - 0.5,
        (4.5 * t - 5.0) * t,
        (-4.5 * t + 4.0) * t + 0.5,
        (1.5 * t - 1.0) * t,
    )
    return k, dk


def subset_bbox(xy: jax.Array, mask: jax.Array) -> jax.Array:
    """[S, 4, 2] axis-aligned bounding-box corners of each subset."""
    big = jnp.float32(1e9)
    mins = jnp.min(jnp.where(mask[..., None], xy, big), axis=1)
    maxs = jnp.max(jnp.where(mask[..., None], xy, -big), axis=1)
    return jnp.stack(
        [
            mins,
            jnp.stack([mins[..., 0], maxs[..., 1]], -1),
            jnp.stack([maxs[..., 0], mins[..., 1]], -1),
            maxs,
        ],
        axis=1,
    )


def choose_tile(
    extent_y: int,
    extent_x: int,
    padded_h: int,
    padded_w: int,
    margin: int = 8,
) -> tuple[int, int]:
    """Static xla_sep tile dims covering the warped subset + spline halo +
    warp margin, rounded up to a multiple of 8 and capped at the padded
    image."""
    need_h = extent_y + 4 + margin
    need_w = extent_x + 4 + margin
    th = min(-(-need_h // 8) * 8, padded_h)
    tw = min(-(-need_w // 8) * 8, padded_w)
    return int(th), int(tw)


def _reduce_gram(model, xy, mask, center, und_w, w, dwdx, dwdy, valid):
    """Residuals + steepest-descent rows + the G^T G Gram reduction."""
    err = jnp.any(mask & ~valid, axis=-1)
    live = (mask & valid)[..., None].astype(w.dtype)  # [S, P, 1]

    v = (und_w - w) * live  # [S, P, C]
    # Steepest-descent images per color: H = dwdx * dTx/dp + dwdy * dTy/dp
    # (interpolation_class.cpp:728-739); the warp Jacobian has no color axis.
    jac_x, jac_y = warp_jacobian(model, xy, center)  # [S, P, NP]
    h = (
        (dwdx * live)[..., None] * jac_x[:, :, None, :]
        + (dwdy * live)[..., None] * jac_y[:, :, None, :]
    )  # [S, P, C, NP]

    s, p, c, np_ = h.shape
    h_rows = h.reshape(s, p * c, np_)
    v_rows = v.reshape(s, p * c)

    # One Gram matmul G^T G with G = [H | V] yields A, b, chi together
    # (one pass over the steepest-descent rows instead of three).  HIGHEST
    # precision: reduced-precision passes (bf16 or TF32) are not accurate
    # enough for the 2e-4 parity bar on A's entries.
    g_rows = jnp.concatenate([h_rows, v_rows[..., None]], axis=-1)
    m = jnp.matmul(
        g_rows.transpose(0, 2, 1),
        g_rows,
        preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.HIGHEST,
    )
    a_mat = m[:, :np_, :np_]
    b_vec = m[:, :np_, np_]
    chi = m[:, np_, np_]
    return a_mat, b_vec, chi, err


def _scatter_taps(rel, taps, extent):
    """W[..., t] = taps[j][...] where t == rel[...] + j (else 0).

    rel: [S, P] int32 position of tap 0 within the tile axis; taps: tuple of
    [S, P] float32 tap weights.  Returns [S, P, extent] float32 — the dense
    per-pixel weight rows whose contraction with the tile implements the
    separable interpolation.
    """
    t = jax.lax.broadcasted_iota(jnp.int32, rel.shape + (extent,), rel.ndim)
    d = t - rel[..., None]
    w = jnp.zeros(rel.shape + (extent,), jnp.float32)
    for j, tap in enumerate(taps):
        w = w + jnp.where(d == j, tap[..., None], 0.0)
    return w


def assemble_normal_equations_tiles(
    model: FittingModel,
    interp: Interpolation,
    def_img: jax.Array,
    img_h: int,
    img_w: int,
    tile_h: int,
    tile_w: int,
    und_w: jax.Array,
    xy: jax.Array,
    mask: jax.Array,
    center: jax.Array,
    params: jax.Array,
):
    """Gather-free assembly: separable sampling on per-subset tiles.

    Functionally identical to assemble_normal_equations (the reference's
    finite-difference-constrained bicubic equals the Catmull-Rom cubic
    convolution, _cubic_taps), but expressed so XLA emits only
    dynamic_slice + batched matmuls: per iteration each subset's
    [tile_h, tile_w] deformed-image window (placed from the warped subset's
    bounding box) is sliced out, per-pixel separable weight rows are built,
    and intensity/gradients come from two weight-by-tile contractions.
    A pixel whose stencil leaves its tile is flagged like an
    out-of-image sample; tiles are sized (engine.compute_level_statics) so
    that only happens for warps about to leave the image.

    Args:
      def_img: [Hp, Wp, C] deformed image, zero-padded to at least
        (tile_h, tile_w).
      img_h, img_w: TRUE image dims (validity windows).
      tile_h, tile_w: static tile dims.
      Other args as assemble_normal_equations.
    """
    f32 = jnp.float32
    pad_h, pad_w = def_img.shape[0], def_img.shape[1]
    def_xy = warp_points(model, params, xy, center)  # [S, P, 2]
    xd = def_xy[..., 0]
    yd = def_xy[..., 1]

    if interp == Interpolation.BICUBIC:
        # interpolation_class.cpp:82-83 (strict window)
        valid = (xd > 1.0) & (yd > 1.0) & (xd < img_w - 2.0) & (yd < img_h - 2.0)
        ax = jnp.floor(xd)
        ay = jnp.floor(yd)
        tx = xd - ax
        ty = yd - ay
        halo = 1
        taps = 4
        kx, dkx = _cubic_taps(tx)
        ky, dky = _cubic_taps(ty)
    elif interp == Interpolation.BILINEAR:
        valid = (xd > 0.0) & (yd > 0.0) & (xd < img_w - 1.0) & (yd < img_h - 1.0)
        ax = jnp.floor(xd)
        ay = jnp.floor(yd)
        tx = xd - ax
        ty = yd - ay
        halo = 0
        taps = 2
        one = jnp.ones_like(tx)
        kx = (1.0 - tx, tx)
        ky = (1.0 - ty, ty)
        dkx = (-one, one)
        dky = (-one, one)
    elif interp == Interpolation.NEAREST:
        # value at the rounded pixel, forward-difference gradients
        # (interpolation_class.cpp:197-226, 376-406)
        valid = (xd > 0.0) & (yd > 0.0) & (xd < img_w - 1.0) & (yd < img_h - 1.0)
        ax = jnp.floor(xd + 0.5)
        ay = jnp.floor(yd + 0.5)
        halo = 0
        taps = 2
        one = jnp.ones_like(xd)
        zero = jnp.zeros_like(xd)
        kx = (one, zero)
        ky = (one, zero)
        dkx = (-one, one)
        dky = (-one, one)
    else:
        raise ValueError(f"unknown interpolation {interp}")

    # Tile origin from the warped subset's masked bounding box (a direct
    # masked min equals the warped-corner min because all supported warps
    # are affine).
    big = f32(3.0e38)
    min_x = jnp.min(jnp.where(mask, xd, big), axis=-1)
    min_y = jnp.min(jnp.where(mask, yd, big), axis=-1)
    finite = jnp.isfinite(min_x) & jnp.isfinite(min_y) & (min_x < big)
    x0 = jnp.where(
        finite, jnp.floor(min_x) - (halo + 1), 0.0
    ).astype(jnp.int32)
    y0 = jnp.where(
        finite, jnp.floor(min_y) - (halo + 1), 0.0
    ).astype(jnp.int32)
    x0 = jnp.clip(x0, 0, max(pad_w - tile_w, 0))
    y0 = jnp.clip(y0, 0, max(pad_h - tile_h, 0))

    rx = ax.astype(jnp.int32) - halo - x0[:, None]
    ry = ay.astype(jnp.int32) - halo - y0[:, None]
    in_tile = (
        (rx >= 0) & (rx <= tile_w - taps) & (ry >= 0) & (ry <= tile_h - taps)
    )
    ok = valid & in_tile
    rx = jnp.clip(rx, 0, tile_w - taps)
    ry = jnp.clip(ry, 0, tile_h - taps)

    w_row = _scatter_taps(ry, ky, tile_h)  # [S, P, th]
    w_row_d = _scatter_taps(ry, dky, tile_h)
    w_col = _scatter_taps(rx, kx, tile_w)  # [S, P, tw]
    w_col_d = _scatter_taps(rx, dkx, tile_w)

    def slice_tile(oy, ox):
        return jax.lax.dynamic_slice(
            def_img, (oy, ox, 0), (tile_h, tile_w, def_img.shape[2])
        )

    tiles = jax.vmap(slice_tile)(y0, x0)  # [S, th, tw, C]

    hp = jax.lax.Precision.HIGHEST
    p = xy.shape[1]
    # Row contraction for value and y-derivative weights in one matmul.
    rows = jnp.concatenate([w_row, w_row_d], axis=1)  # [S, 2P, th]
    tmp_all = jnp.einsum("spt,stwc->spwc", rows, tiles, precision=hp)
    tmp = tmp_all[:, :p]  # [S, P, tw, C]
    tmp_d = tmp_all[:, p:]

    w_out = jnp.einsum("spw,spwc->spc", w_col, tmp, precision=hp)
    dwdx = jnp.einsum("spw,spwc->spc", w_col_d, tmp, precision=hp)
    dwdy = jnp.einsum("spw,spwc->spc", w_col, tmp_d, precision=hp)

    okc = ok[..., None]
    return _reduce_gram(
        model,
        xy,
        mask,
        center,
        und_w,
        jnp.where(okc, w_out, 0.0),
        jnp.where(okc, dwdx, 0.0),
        jnp.where(okc, dwdy, 0.0),
        ok,
    )

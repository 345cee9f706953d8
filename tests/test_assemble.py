import jax.numpy as jnp
import numpy as np
import pytest

import oracle
from correlation_jax.config import FittingModel, Interpolation
from correlation_jax.ops.assemble import (
    assemble_normal_equations,
    assemble_normal_equations_tiles,
    choose_tile,
)
from correlation_jax.ops.interp import precompute_field, sample_integer
from synthetic import Speckle

CASES = [
    (FittingModel.UV, Interpolation.BICUBIC, "UV", "bicubic"),
    (FittingModel.AFFINE, Interpolation.BICUBIC, "AFFINE", "bicubic"),
    (FittingModel.UVQ, Interpolation.BILINEAR, "UVQ", "bilinear"),
    (FittingModel.U, Interpolation.NEAREST, "U", "nearest"),
]


def _assemble(backend, model, interp, dfm, und_w, xy, mask, centers, params):
    """A, b, chi, err from either plain backend ([H, W, C] dfm)."""
    dfm = jnp.asarray(dfm, jnp.float32)
    if backend == "xla":
        return assemble_normal_equations(
            model, interp, precompute_field(dfm, interp), und_w,
            jnp.asarray(xy), jnp.asarray(mask), jnp.asarray(centers),
            jnp.asarray(params),
        )
    h, w = dfm.shape[:2]
    span = np.where(mask[..., None], xy, np.nan)
    ext = np.nanmax(span, axis=1) - np.nanmin(span, axis=1)
    ext_x, ext_y = np.ceil(ext.max(axis=0)).astype(int)
    th, tw = choose_tile(ext_y, ext_x, -(-h // 8) * 8, -(-w // 8) * 8)
    img = jnp.pad(dfm, ((0, max(th - h, 0)), (0, max(tw - w, 0)), (0, 0)))
    return assemble_normal_equations_tiles(
        model, interp, img, h, w, th, tw, und_w, jnp.asarray(xy),
        jnp.asarray(mask), jnp.asarray(centers), jnp.asarray(params),
    )


@pytest.mark.parametrize("backend", ["xla", "xla_sep"])
@pytest.mark.parametrize("model,interp,omodel,ointerp", CASES)
def test_assembly_matches_oracle(model, interp, omodel, ointerp, backend):
    spk = Speckle(40, 44, seed=11)
    und = np.floor(spk.image()).astype(np.float64)
    dfm = np.floor(spk.warped_image(u=0.4, v=-0.3)).astype(np.float64)

    # two subsets: an 11x9 grid and a 7x7 grid (padded batch)
    pts1 = np.stack(
        np.meshgrid(np.arange(10, 21), np.arange(12, 21), indexing="ij"),
        axis=-1,
    ).reshape(-1, 2).astype(np.float32)
    pts2 = np.stack(
        np.meshgrid(np.arange(22, 29), np.arange(20, 27), indexing="ij"),
        axis=-1,
    ).reshape(-1, 2).astype(np.float32)

    p_max = len(pts1)
    xy = np.zeros((2, p_max, 2), np.float32)
    mask = np.zeros((2, p_max), bool)
    xy[0] = pts1
    mask[0] = True
    xy[1, : len(pts2)] = pts2
    mask[1, : len(pts2)] = True
    centers = np.stack([pts1.mean(axis=0), pts2.mean(axis=0)]).astype(
        np.float32
    )

    num_p = oracle.NP_OF[omodel]
    rng = np.random.default_rng(2)
    params = rng.normal(0, 0.05, (2, num_p)).astype(np.float32)
    params[:, 0] += 0.4
    if num_p >= 2:
        params[:, 1] -= 0.3

    und_j = jnp.asarray(und[..., None], jnp.float32)
    und_w = sample_integer(und_j, jnp.asarray(xy)) * jnp.asarray(
        mask[..., None]
    )
    a_mat, b_vec, chi, err = _assemble(
        backend, model, interp, dfm[..., None], und_w, xy, mask, centers,
        params,
    )

    for s, pts in enumerate([pts1, pts2]):
        oa, ob, ochi, oerr = oracle.assemble(
            omodel,
            ointerp,
            und,
            dfm,
            pts,
            centers[s, 0],
            centers[s, 1],
            params[s].astype(np.float64),
        )
        assert not oerr
        assert not bool(err[s])
        np.testing.assert_allclose(np.asarray(chi)[s], ochi, rtol=1e-4)
        np.testing.assert_allclose(np.asarray(b_vec)[s], ob, rtol=2e-4,
                                   atol=1e-2)
        np.testing.assert_allclose(np.asarray(a_mat)[s], oa, rtol=2e-4,
                                   atol=1e-2)


def test_out_of_image_sets_error():
    spk = Speckle(30, 30, seed=12)
    und = spk.image(quantize=True)
    dfm = spk.image(quantize=True)
    pts = np.stack(
        np.meshgrid(np.arange(2, 9), np.arange(2, 9), indexing="ij"), axis=-1
    ).reshape(-1, 2).astype(np.float32)
    xy = pts[None]
    mask = np.ones((1, len(pts)), bool)
    center = pts.mean(axis=0)[None]
    field = precompute_field(
        jnp.asarray(dfm[..., None]), Interpolation.BICUBIC
    )
    und_w = sample_integer(jnp.asarray(und[..., None]), jnp.asarray(xy))
    # huge translation pushes samples outside the image
    params = np.array([[500.0, 0.0]], np.float32)
    *_, err = assemble_normal_equations(
        FittingModel.UV,
        Interpolation.BICUBIC,
        field,
        und_w,
        jnp.asarray(xy),
        jnp.asarray(mask),
        jnp.asarray(center),
        jnp.asarray(params),
    )
    assert bool(err[0])


@pytest.mark.parametrize("channels", [1, 3])
@pytest.mark.parametrize("model,interp,omodel,ointerp", CASES)
def test_sep_matches_field_backend(model, interp, omodel, ointerp, channels):
    """The gather-free separable backend (xla_sep) and the coefficient-
    field gather backend (xla) assemble the same normal equations, per
    channel count, on a padded three-subset batch with a warp that keeps
    every stencil inside its tile."""
    rng = np.random.default_rng(5)
    und = np.stack(
        [Speckle(56, 60, seed=20 + c).image(quantize=True)
         for c in range(channels)], -1,
    )
    dfm = np.stack(
        [Speckle(56, 60, seed=20 + c).warped_image(u=0.6, v=-0.4,
                                                   quantize=True)
         for c in range(channels)], -1,
    )
    subsets = [(10, 12, 24, 26), (30, 8, 44, 20), (20, 30, 30, 40)]
    pts = [
        np.stack(np.meshgrid(np.arange(x0, x1 + 1), np.arange(y0, y1 + 1),
                             indexing="ij"), -1).reshape(-1, 2)
        for x0, y0, x1, y1 in subsets
    ]
    p_max = max(len(p) for p in pts)
    xy = np.zeros((3, p_max, 2), np.float32)
    mask = np.zeros((3, p_max), bool)
    for i, p in enumerate(pts):
        xy[i, : len(p)] = p
        mask[i, : len(p)] = True
    centers = np.stack([p.mean(axis=0) for p in pts]).astype(np.float32)
    num_p = oracle.NP_OF[omodel]
    params = rng.normal(0, 0.01, (3, num_p)).astype(np.float32)
    params[:, 0] += 0.6
    if num_p >= 2:
        params[:, 1] -= 0.4
    und_w = sample_integer(jnp.asarray(und), jnp.asarray(xy)) * jnp.asarray(
        mask[..., None]
    )
    field = _assemble("xla", model, interp, dfm, und_w, xy, mask, centers,
                      params)
    sep = _assemble("xla_sep", model, interp, dfm, und_w, xy, mask,
                    centers, params)
    assert not np.asarray(field[3]).any()
    np.testing.assert_array_equal(np.asarray(sep[3]), np.asarray(field[3]))
    for got, want in zip(sep[:3], field[:3]):
        want = np.asarray(want)
        np.testing.assert_allclose(
            np.asarray(got), want, rtol=2e-4,
            atol=2e-5 * float(np.abs(want).max()),
        )

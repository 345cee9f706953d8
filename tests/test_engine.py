import jax.numpy as jnp
import numpy as np
import pytest

import oracle
from correlation_jax.config import (
    ErrorCode,
    FittingModel,
    Interpolation,
    PyramidConfig,
    SolverConfig,
)
from correlation_jax.domains import make_batch
from correlation_jax.engine import correlate
from correlation_jax.ops.pyramid import build_pyramid
from synthetic import Speckle


def _grid(x0, y0, x1, y1):
    return np.stack(
        np.meshgrid(
            np.arange(x0, x1 + 1), np.arange(y0, y1 + 1), indexing="ij"
        ),
        axis=-1,
    ).reshape(-1, 2).astype(np.float32)


def test_translation_recovery_single_level():
    """BASELINE config 1: single rectangular subset, translation-only warp,
    1 pyramid level, 2-frame pair."""
    spk = Speckle(64, 64, seed=21)
    true_u, true_v = 1.37, -0.58
    und = spk.image()
    dfm = spk.warped_image(u=true_u, v=true_v)

    cfg = SolverConfig(
        model=FittingModel.UV,
        interpolation=Interpolation.BICUBIC,
        pyramid=PyramidConfig(0, 1, 0),
        precision=1e-6,
    )
    pts = _grid(20, 20, 44, 44)
    batch = make_batch([pts], None, 0)
    res = correlate(
        cfg,
        [jnp.asarray(und[..., None])],
        [jnp.asarray(dfm[..., None])],
        batch,
        np.zeros((1, 2), np.float32),
    )
    params = np.asarray(res.params)[0]
    assert int(res.error[0]) == int(ErrorCode.NONE)
    np.testing.assert_allclose(params, [true_u, true_v], atol=2e-3)


def test_affine_recovery_with_pyramid():
    """BASELINE config 2: affine 6-param warp, 3-level pyramid, bicubic."""
    spk = Speckle(96, 96, seed=22)
    aff = np.array([[0.004, -0.006], [0.005, 0.003]])
    center = (48.0, 48.0)
    true_u, true_v = 2.6, -1.9
    und = spk.image(quantize=True)
    dfm = spk.warped_image(
        u=true_u, v=true_v, affine=aff, center=center, quantize=True
    )

    cfg = SolverConfig(
        model=FittingModel.AFFINE,
        interpolation=Interpolation.BICUBIC,
        pyramid=PyramidConfig(0, 1, 2),
        precision=1e-5,
    )
    pts = _grid(33, 33, 63, 63)
    batch = make_batch([pts], None, 2)
    res = correlate(
        cfg,
        build_pyramid(jnp.asarray(und[..., None]), 2),
        build_pyramid(jnp.asarray(dfm[..., None]), 2),
        batch,
        np.zeros((1, 6), np.float32),
    )
    p = np.asarray(res.params)[0]
    assert int(res.error[0]) == int(ErrorCode.NONE)
    # The synthetic affine warp is about the image center; the solver's warp
    # is about the subset center (same here by construction).
    np.testing.assert_allclose(p[0], true_u, atol=0.02)
    np.testing.assert_allclose(p[1], true_v, atol=0.02)
    np.testing.assert_allclose(
        p[2:], [0.004, -0.006, 0.005, 0.003], atol=2e-3
    )


@pytest.mark.parametrize(
    "model,interp,omodel,ointerp,levels",
    [
        (FittingModel.UV, Interpolation.BICUBIC, "UV", "bicubic", (0,)),
        (
            FittingModel.AFFINE,
            Interpolation.BICUBIC,
            "AFFINE",
            "bicubic",
            (2, 1, 0),
        ),
        (FittingModel.UVQ, Interpolation.BILINEAR, "UVQ", "bilinear", (1, 0)),
    ],
)
def test_lm_trajectory_matches_oracle(model, interp, omodel, ointerp, levels):
    """The batched masked LM loop must reproduce the serial reference loop:
    same converged parameters, same iteration counts."""
    spk = Speckle(72, 70, seed=23)
    und = np.floor(spk.image()).astype(np.float64)
    dfm = np.floor(spk.warped_image(u=0.9, v=0.7)).astype(np.float64)

    max_level = max(levels)
    cfg = SolverConfig(
        model=model,
        interpolation=interp,
        pyramid=PyramidConfig(0, 1, max_level),
        precision=1e-3,
        max_iterations=50,
    )
    subsets = [
        _grid(16, 16, 32, 34),
        _grid(36, 20, 52, 36),
        _grid(24, 40, 44, 56),
    ]
    batch = make_batch(subsets, None, max_level)
    num_p = oracle.NP_OF[omodel]
    guesses = np.zeros((3, num_p), np.float32)
    guesses[:, 0] = 0.5
    if num_p > 1:
        guesses[:, 1] = 0.5

    und_pyr = build_pyramid(jnp.asarray(und[..., None], jnp.float32), max_level)
    def_pyr = build_pyramid(jnp.asarray(dfm[..., None], jnp.float32), max_level)
    res = correlate(cfg, und_pyr, def_pyr, batch, guesses)

    und_pyr_np = [np.asarray(a)[..., 0].astype(np.float64) for a in und_pyr]
    def_pyr_np = [np.asarray(a)[..., 0].astype(np.float64) for a in def_pyr]

    for s, pts in enumerate(subsets):
        out = oracle.newton_raphson(
            omodel,
            ointerp,
            und_pyr_np,
            def_pyr_np,
            pts.astype(np.float64),
            guesses[s].astype(np.float64),
            levels=levels,
            max_iters=50,
            precision=1e-3,
        )
        assert out["error"] is None
        assert int(res.error[s]) == int(ErrorCode.NONE)
        np.testing.assert_allclose(
            np.asarray(res.params)[s], out["params"], atol=5e-4
        )
        np.testing.assert_allclose(
            float(res.chi[s]), out["chi"], rtol=1e-3, atol=1e-3
        )
        assert int(res.iterations[s]) == out["iterations"], (
            s,
            int(res.iterations[s]),
            out["iterations"],
        )


def test_out_of_image_initial_guess_freezes_subset():
    spk = Speckle(48, 48, seed=24)
    und = spk.image(quantize=True)
    cfg = SolverConfig(
        model=FittingModel.UV,
        interpolation=Interpolation.BICUBIC,
        pyramid=PyramidConfig(0, 1, 0),
    )
    pts = _grid(10, 10, 20, 20)
    batch = make_batch([pts, pts], None, 0)
    guesses = np.array([[0.0, 0.0], [300.0, 0.0]], np.float32)
    res = correlate(
        cfg,
        [jnp.asarray(und[..., None])],
        [jnp.asarray(und[..., None])],
        batch,
        guesses,
    )
    assert int(res.error[0]) == int(ErrorCode.NONE)
    # u=300 maps the subset entirely outside the 48px image: the model
    # itself leaves the image (enums.hpp:27), not just the interpolation
    # margin.
    assert int(res.error[1]) == int(ErrorCode.MODEL_OUT_OF_IMAGE)
    # frozen subset returns its untouched initial guess
    np.testing.assert_allclose(np.asarray(res.params)[1], [300.0, 0.0])
    assert float(res.chi[1]) == float(np.finfo(np.float32).max)
    # healthy subset converged to identity
    np.testing.assert_allclose(np.asarray(res.params)[0], [0.0, 0.0],
                               atol=1e-3)


def test_interpolation_margin_vs_model_out_codes():
    """A guess that keeps the warped subset inside the image but within the
    bicubic validity margin raises INTERPOLATION_OUT_OF_IMAGE; one that
    pushes points past the image edge raises MODEL_OUT_OF_IMAGE
    (enums.hpp:25-35)."""
    spk = Speckle(48, 48, seed=24)
    und = spk.image(quantize=True)
    cfg = SolverConfig(
        model=FittingModel.UV,
        interpolation=Interpolation.BICUBIC,
        pyramid=PyramidConfig(0, 1, 0),
        max_iterations=1,
    )
    pts = _grid(10, 10, 20, 20)  # spans x,y in [10, 20]
    batch = make_batch([pts, pts], None, 0)
    # subset 0: max x -> 20 + 26.5 = 46.5 <= 47 (inside image) but the
    # bicubic window needs x < W - 2 = 46: margin-only violation.
    # subset 1: max x -> 20 + 28 = 48 > 47: model point leaves the image.
    guesses = np.array([[26.5, 0.0], [28.0, 0.0]], np.float32)
    res = correlate(
        cfg,
        [jnp.asarray(und[..., None])],
        [jnp.asarray(und[..., None])],
        batch,
        guesses,
    )
    assert int(res.error[0]) == int(ErrorCode.INTERPOLATION_OUT_OF_IMAGE)
    assert int(res.error[1]) == int(ErrorCode.MODEL_OUT_OF_IMAGE)


def test_singular_system_raises_solver_error():
    """A constant-intensity subset has zero gradients everywhere: the
    normal equations are singular and the damped solve yields a non-finite
    step — the analog of a cuSolver failure (cuda_solver.cu:40-89), surfaced
    as ErrorCode.SOLVER."""
    spk = Speckle(64, 64, seed=7)
    und = spk.image(quantize=True)
    und[30:64, 0:34] = 128.0  # flat patch
    cfg = SolverConfig(
        model=FittingModel.UV,
        interpolation=Interpolation.BICUBIC,
        pyramid=PyramidConfig(0, 1, 0),
    )
    pts_flat = _grid(12, 40, 26, 54)  # inside the flat patch
    pts_ok = _grid(40, 10, 54, 24)  # textured region
    batch = make_batch([pts_flat, pts_ok], None, 0)
    res = correlate(
        cfg,
        [jnp.asarray(und[..., None])],
        [jnp.asarray(und[..., None])],
        batch,
        np.zeros((2, 2), np.float32),
    )
    assert int(res.error[0]) == int(ErrorCode.SOLVER)
    assert int(res.error[1]) == int(ErrorCode.NONE)


def test_color_translation_recovery():
    """RGB correlation: chi and H/b sum over channels
    (the reference's color loops, interpolation_class.cpp:701-749)."""
    true_u, true_v = 0.84, -0.47
    chans_und, chans_def = [], []
    for seed in (3, 4, 5):
        spk = Speckle(64, 64, seed=seed)
        chans_und.append(spk.image())
        chans_def.append(spk.warped_image(u=true_u, v=true_v))
    und = np.stack(chans_und, -1)
    dfm = np.stack(chans_def, -1)

    cfg = SolverConfig(
        model=FittingModel.UV,
        interpolation=Interpolation.BICUBIC,
        pyramid=PyramidConfig(0, 1, 0),
        precision=1e-6,
    )
    pts = _grid(20, 20, 44, 44)
    batch = make_batch([pts], None, 0)
    res = correlate(
        cfg,
        [jnp.asarray(und)],
        [jnp.asarray(dfm)],
        batch,
        np.zeros((1, 2), np.float32),
    )
    assert int(res.error[0]) == int(ErrorCode.NONE)
    np.testing.assert_allclose(
        np.asarray(res.params)[0], [true_u, true_v], atol=8e-3
    )
    # chi across 3 channels is ~3x any single channel's
    single = correlate(
        cfg,
        [jnp.asarray(und[..., :1])],
        [jnp.asarray(dfm[..., :1])],
        batch,
        np.zeros((1, 2), np.float32),
    )
    assert float(res.chi[0]) > float(single.chi[0])


@pytest.mark.parametrize("domain", ["annular", "blob"])
def test_lm_trajectory_matches_oracle_ragged_domains(domain):
    """Oracle parity on the masked, ragged domains (annular sectors and
    freehand blobs) — where padding/masking bugs would live.  Same bar as
    the rectangular parity test: params to 5e-4, exact iteration counts
    (VERDICT r2 item 7)."""
    import math

    from correlation_jax.domains import (
        AnnularDomain,
        BlobDomain,
        annular_batch,
        blob_batch,
    )

    spk = Speckle(96, 96, seed=31)
    und = np.floor(spk.image()).astype(np.float64)
    dfm = np.floor(spk.warped_image(u=0.8, v=0.6)).astype(np.float64)

    max_level = 1
    cfg = SolverConfig(
        model=FittingModel.UV,
        interpolation=Interpolation.BICUBIC,
        pyramid=PyramidConfig(0, 1, max_level),
        precision=1e-3,
        max_iterations=50,
    )
    if domain == "annular":
        batch = annular_batch(AnnularDomain(48, 48, 12, 30, 2, 4), max_level)
    else:
        theta = np.linspace(0, 2 * math.pi, 17, endpoint=False)
        contour = np.stack(
            [48 + 22 * np.cos(theta), 48 + 17 * np.sin(theta + 0.4)], -1
        ).astype(np.float32)
        batch = blob_batch(BlobDomain(contour), max_level)

    s = batch.num_subsets
    guesses = np.full((s, 2), 0.5, np.float32)
    und_pyr = build_pyramid(jnp.asarray(und[..., None], jnp.float32),
                            max_level)
    def_pyr = build_pyramid(jnp.asarray(dfm[..., None], jnp.float32),
                            max_level)
    res = correlate(cfg, und_pyr, def_pyr, batch, guesses)

    und_np = [np.asarray(a)[..., 0].astype(np.float64) for a in und_pyr]
    def_np = [np.asarray(a)[..., 0].astype(np.float64) for a in def_pyr]
    xy0 = np.asarray(batch.xy[0])
    m0 = np.asarray(batch.mask[0])
    for i in range(s):
        pts = xy0[i][m0[i]].astype(np.float64)
        out = oracle.newton_raphson(
            "UV", "bicubic", und_np, def_np, pts,
            guesses[i].astype(np.float64),
            center0=np.asarray(batch.center0[i], np.float64),
            levels=(1, 0), max_iters=50, precision=1e-3,
        )
        assert out["error"] is None, (i, out)
        assert int(res.error[i]) == int(ErrorCode.NONE)
        np.testing.assert_allclose(
            np.asarray(res.params)[i], out["params"], atol=5e-4
        )
        assert int(res.iterations[i]) == out["iterations"], (
            i, int(res.iterations[i]), out["iterations"],
        )


def test_compaction_cascade_bitwise_parity():
    """The straggler compaction cascade (solve_level) must be a pure
    scheduling change: per-subset results bit-identical to the monolithic
    while_loop, including iteration counts and error codes, on a workload
    whose subsets converge at very different iteration counts."""
    import dataclasses

    spk = Speckle(160, 160, seed=31)
    und = spk.image(quantize=True)
    # Displacement grows across the field: near subsets converge in ~2
    # iterations, far ones run long (some to max_iters at the tight
    # precision below).
    gy, gx = np.mgrid[0:160, 0:160]
    dfm = np.floor(
        spk.eval(gx - 0.002 * gx * gx / 8.0, gy + 1.3)
    ).astype(np.float32)

    pts = []
    centers = []
    for cy in range(24, 137, 16):
        for cx in range(24, 137, 16):
            pts.append(_grid(cx - 7, cy - 7, cx + 7, cy + 7))
            centers.append((cx, cy))
    batch = make_batch(pts, np.array(centers, np.float32), 1)
    base = SolverConfig(
        model=FittingModel.UV,
        interpolation=Interpolation.BICUBIC,
        pyramid=PyramidConfig(0, 1, 1),
        precision=1e-7,
        max_iterations=30,
        compact_stages=0,
    )
    und_pyr = build_pyramid(jnp.asarray(und[..., None]), 1)
    def_pyr = build_pyramid(jnp.asarray(dfm[..., None]), 1)
    p0 = np.zeros((batch.num_subsets, 2), np.float32)

    ref = correlate(base, und_pyr, def_pyr, batch, p0)
    its = np.asarray(ref.iterations)
    assert its.min() + 2 < its.max(), "workload must have stragglers"

    for backend in ("xla_sep", "xla"):
        mono = correlate(
            dataclasses.replace(base, backend=backend),
            und_pyr, def_pyr, batch, p0,
        )
        comp = correlate(
            dataclasses.replace(
                base, backend=backend,
                compact_stages=3, compact_factor=2, compact_min=8,
            ),
            und_pyr, def_pyr, batch, p0,
        )
        np.testing.assert_array_equal(
            np.asarray(mono.params), np.asarray(comp.params)
        )
        np.testing.assert_array_equal(
            np.asarray(mono.chi), np.asarray(comp.chi)
        )
        np.testing.assert_array_equal(
            np.asarray(mono.iterations), np.asarray(comp.iterations)
        )
        np.testing.assert_array_equal(
            np.asarray(mono.error), np.asarray(comp.error)
        )


def test_correlate_many_matches_separate():
    """correlate_many solves heterogeneous domains in one dispatch with
    per-domain tile statics — results must equal separate correlate()
    calls exactly (same statics per domain, same programs)."""
    from correlation_jax.engine import correlate_many

    spk = Speckle(128, 128, seed=52)
    und = spk.image(quantize=True)[..., None]
    dfm = spk.warped_image(u=0.8, v=-0.6, quantize=True)[..., None]
    und_pyr = build_pyramid(jnp.asarray(und), 1)
    def_pyr = build_pyramid(jnp.asarray(dfm), 1)

    cfg = SolverConfig(
        model=FittingModel.UV,
        interpolation=Interpolation.BICUBIC,
        pyramid=PyramidConfig(0, 1, 1),
        precision=1e-5,
    )
    small = make_batch(
        [_grid(24, 24, 44, 44), _grid(60, 24, 80, 44)], None, 1
    )
    big = make_batch([_grid(30, 60, 95, 110)], None, 1)

    p0s = [np.zeros((b.num_subsets, 2), np.float32) for b in (small, big)]
    many = correlate_many(cfg, und_pyr, def_pyr, [small, big], p0s)
    assert len(many) == 2
    for b, p0, got in zip((small, big), p0s, many):
        sep = correlate(cfg, und_pyr, def_pyr, b, p0)
        np.testing.assert_array_equal(
            got.params, np.asarray(sep.params)
        )
        np.testing.assert_array_equal(got.chi, np.asarray(sep.chi))
        np.testing.assert_array_equal(
            got.iterations, np.asarray(sep.iterations)
        )
        np.testing.assert_array_equal(got.error, np.asarray(sep.error))
        np.testing.assert_allclose(got.params[:, 0], 0.8, atol=0.02)


@pytest.mark.parametrize("channels", [1, 3])
@pytest.mark.parametrize("backend", ["xla", "xla_sep"])
def test_translation_recovery_backends(backend, channels):
    """Both plain assembly backends recover a sub-pixel translation
    through correlate(), monochrome and RGB (at half-pixel offsets,
    where the bicubic interpolation bias vanishes by symmetry)."""
    true_u, true_v = 1.5, -0.5
    und = np.stack(
        [Speckle(64, 64, seed=60 + c).image() for c in range(channels)], -1
    )
    dfm = np.stack(
        [Speckle(64, 64, seed=60 + c).warped_image(u=true_u, v=true_v)
         for c in range(channels)], -1,
    )
    cfg = SolverConfig(
        model=FittingModel.UV,
        interpolation=Interpolation.BICUBIC,
        pyramid=PyramidConfig(0, 1, 0),
        precision=1e-6,
        backend=backend,
    )
    batch = make_batch([_grid(20, 20, 44, 44), _grid(16, 24, 36, 40)],
                       None, 0)
    res = correlate(
        cfg, [jnp.asarray(und)], [jnp.asarray(dfm)], batch,
        np.zeros((2, 2), np.float32),
    )
    np.testing.assert_array_equal(np.asarray(res.error), 0)
    np.testing.assert_allclose(
        np.asarray(res.params), [[true_u, true_v]] * 2, atol=5e-3
    )


def test_resolve_backend_auto_on_gpu(monkeypatch):
    """auto picks the backend measured faster on a GPU, and xla_sep on
    the CPU; an explicit choice is kept."""
    import dataclasses

    from correlation_jax import engine

    cfg = SolverConfig()
    assert engine.resolve_backend(cfg) == "xla_sep"  # tests run on CPU
    monkeypatch.setattr(engine.jax, "default_backend", lambda: "gpu")
    assert engine.resolve_backend(cfg) == engine._GPU_AUTO_BACKEND
    assert engine._GPU_AUTO_BACKEND in ("xla", "xla_sep")
    for b in ("xla", "xla_sep"):
        assert engine.resolve_backend(
            dataclasses.replace(cfg, backend=b)
        ) == b


def test_resolve_backend_rejects_removed_kernel():
    """The removed "pallas" kernel backend is an error to ask for, not a
    silent fall-back."""
    import dataclasses

    from correlation_jax.engine import resolve_backend

    for name in ("pallas", "pallas_dma"):
        with pytest.raises(ValueError, match="unknown backend"):
            resolve_backend(dataclasses.replace(SolverConfig(), backend=name))

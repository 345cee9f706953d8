import numpy as np
import pytest

from correlation_jax.config import (
    DeformationDescription,
    FittingModel,
    Interpolation,
    PyramidConfig,
    ReferenceImage,
    SolverConfig,
)
from correlation_jax.report import report_header, write_report
from correlation_jax.sequence import SequenceConfig, run_sequence
from synthetic import Speckle


def _frames(n, du, dv, h=96, w=96, seed=31):
    spk = Speckle(h, w, seed=seed)
    return [
        spk.warped_image(u=du * t, v=dv * t, quantize=True)[..., None]
        for t in range(n)
    ]


def _grid_pts(x0, y0, x1, y1):
    gx, gy = np.meshgrid(
        np.arange(x0, x1 + 1), np.arange(y0, y1 + 1), indexing="ij"
    )
    return np.stack([gx.ravel(), gy.ravel()], -1).astype(np.float32)


def _cfg(**kw):
    solver = SolverConfig(
        model=FittingModel.UV,
        interpolation=Interpolation.BICUBIC,
        pyramid=PyramidConfig(0, 1, 1),
        precision=1e-5,
    )
    return SequenceConfig(solver=solver, **kw)


def test_eulerian_first_accumulates_with_extrapolation():
    """BASELINE config 4: multi-frame tracking with constant-velocity IC."""
    du, dv = 0.62, -0.41
    frames = _frames(5, du, dv)
    pts = [_grid_pts(30, 30, 62, 62)]
    cfg = _cfg(
        deformation=DeformationDescription.EULERIAN,
        reference=ReferenceImage.FIRST,
    )
    records = run_sequence(frames, pts, cfg)
    assert len(records) == 4
    for t, rec in enumerate(records):
        np.testing.assert_allclose(
            rec.params[0], [du * (t + 1), dv * (t + 1)], atol=0.02
        )
        assert rec.error[0] == 0
    # constant-velocity extrapolation: later guesses predict the next step
    guess3 = records[3].initial_guess[0]
    np.testing.assert_allclose(guess3, [du * 4, dv * 4], atol=0.05)


def test_lagrangian_previous_tracks_increments():
    du, dv = 0.62, -0.41
    frames = _frames(4, du, dv)
    pts = [_grid_pts(30, 30, 62, 62)]
    cfg = _cfg(
        deformation=DeformationDescription.LAGRANGIAN,
        reference=ReferenceImage.PREVIOUS,
    )
    records = run_sequence(frames, pts, cfg)
    for rec in records:
        np.testing.assert_allclose(rec.params[0], [du, dv], atol=0.05)
    # und centers follow the material, quantized to whole pixels because
    # Lagrangian point updates round (add_pair, manager_class.cpp:38-47)
    c0 = records[0].und_center[0]
    c2 = records[2].und_center[0]
    np.testing.assert_allclose(c2 - c0, [2 * du, 2 * dv], atol=1.01)


def test_strict_lagrangian_tracks_material():
    """Strict Lagrangian carries float warped positions while undeformed
    intensities are read at rounded pixels (interpolation_class.cpp:701-714),
    so per-frame params absorb the sub-pixel rounding offset; the physical
    invariant is that def_center stays on the material point."""
    du, dv = 0.5, 0.3
    frames = _frames(3, du, dv)
    pts = [_grid_pts(30, 30, 60, 60)]
    cfg = _cfg(
        deformation=DeformationDescription.STRICT_LAGRANGIAN,
        reference=ReferenceImage.PREVIOUS,
    )
    records = run_sequence(frames, pts, cfg)
    assert len(records) == 2
    true_center0 = np.array([45.0, 45.0])
    for t, rec in enumerate(records):
        assert rec.error[0] == 0
        assert rec.chi[0] < 20
        material = true_center0 + np.array([du, dv]) * (t + 1)
        np.testing.assert_allclose(
            rec.def_center[0], material, atol=0.75
        )


def test_report_columns():
    frames = _frames(2, 0.4, 0.2)
    pts = [_grid_pts(30, 30, 60, 60), _grid_pts(55, 55, 80, 80)]
    cfg = _cfg()
    records = run_sequence(frames, pts, cfg)
    csv = write_report(records, file_names=["a.png", "b.png"])
    lines = csv.strip().split("\n")
    assert lines[0] == report_header(2)
    assert len(lines) == 1 + 2  # header + 2 sectors x 1 frame pair
    row = lines[1].split(",")
    assert len(row) == len(lines[0].split(","))
    assert row[0] == "0"
    assert row[1] == "a.png" and row[2] == "b.png"
    # chi column is finite and small-ish
    header = lines[0].split(",")
    chi = float(row[header.index("chi")])
    assert 0 <= chi < 100


def test_checkpoint_roundtrip(tmp_path):
    from correlation_jax.sequence import initial_track_state
    from correlation_jax.utils.checkpoint import (
        load_checkpoint,
        save_checkpoint,
    )

    frames = _frames(3, 0.4, 0.2)
    pts = [_grid_pts(30, 30, 60, 60)]
    cfg = _cfg()
    records = run_sequence(frames, pts, cfg)

    state = initial_track_state(
        pts, None, np.array([45.0, 45.0]), np.zeros(2, np.float32),
        FittingModel.UV,
    )
    state.params = records[-1].params
    path = str(tmp_path / "ck.npz")
    save_checkpoint(path, 2, state, records)
    nf, state2, records2 = load_checkpoint(path)
    assert nf == 2
    assert len(records2) == len(records)
    np.testing.assert_allclose(state2.params, state.params)
    np.testing.assert_allclose(
        records2[0].params, records[0].params
    )
    np.testing.assert_allclose(
        records2[1].def_center, records[1].def_center
    )


def test_contour_tracking_and_cancel(tmp_path):
    from PIL import Image

    from correlation_jax.domains import rectangular_contour
    from correlation_jax.sequence import run_sequence_from_files

    du, dv = 0.62, -0.41
    frames = _frames(4, du, dv)
    paths = []
    for t, f in enumerate(frames):
        p = str(tmp_path / f"f{t}.png")
        Image.fromarray(f[..., 0].astype(np.uint8)).save(p)
        paths.append(p)

    pts = [_grid_pts(30, 30, 62, 62)]
    contours = [rectangular_contour(46, 46, 16, 16)]
    cfg = _cfg()

    calls = {"n": 0}

    def stop_after_two():
        calls["n"] += 1
        return calls["n"] > 2

    records = run_sequence_from_files(
        paths, pts, cfg, contours=contours, should_stop=stop_after_two
    )
    assert len(records) == 2  # cancelled before the third pair
    rec = records[1]
    assert rec.def_contours is not None
    # the deformed contour is the undeformed one translated by (u, v)
    shift = rec.def_contours[0] - rec.und_contours[0]
    np.testing.assert_allclose(
        shift, np.tile([[2 * du, 2 * dv]], (4, 1)), atol=0.05
    )


def _edge_error_setup():
    """Two sectors; sector 1 sits near the right edge and the growing
    translation pushes its initial guess out of the image at pair 1."""
    frames = _frames(5, 4.0, 0.0)
    pts = [_grid_pts(20, 30, 36, 46), _grid_pts(70, 30, 86, 46)]
    return frames, pts


@pytest.mark.parametrize("mode", ["stop_all", "stop_frame", "continue"])
def test_error_modes_distinguished(mode):
    """Batched stop-all / stop-frame / continue semantics
    (enums.hpp:80-85, manager_class.cpp:535-546, 793-805, 1493-1494)."""
    from correlation_jax.config import ErrorCode, ErrorMode

    frames, pts = _edge_error_setup()
    cfg = _cfg(
        deformation=DeformationDescription.EULERIAN,
        reference=ReferenceImage.FIRST,
        error_mode={
            "stop_all": ErrorMode.STOP_ALL,
            "stop_frame": ErrorMode.STOP_FRAME,
            "continue": ErrorMode.CONTINUE,
        }[mode],
    )
    records = run_sequence(frames, pts, cfg)

    # pair 0 is clean everywhere
    assert list(records[0].error) == [0, 0]
    np.testing.assert_allclose(records[0].params[1], [4.0, 0.0], atol=0.05)

    if mode == "stop_all":
        # the frame with the error is recorded, then the run stops
        # (manager_class.cpp:1493-1494: report row, then break)
        assert len(records) == 2
        assert records[1].error[1] != 0
        return

    assert len(records) == 4
    # pair 1: sector 1's extrapolated guess (~[8, 0]) maps into the bicubic
    # margin -> out-of-image at the initial assembly
    assert records[1].error[1] == int(ErrorCode.INTERPOLATION_OUT_OF_IMAGE)
    assert records[1].error[0] == 0

    if mode == "stop_frame":
        # frozen: the errored sector's chained state did not advance
        np.testing.assert_allclose(
            records[1].params[1], records[0].params[1]
        )
        # ... and its record/CSV row keeps the PREVIOUS chi/iterations
        # (plus the error code) — the reference's skipped sectors retain
        # previous values (manager_class.cpp:535-546).
        assert records[1].chi[1] == records[0].chi[1]
        assert records[1].iterations[1] == records[0].iterations[1]
        from correlation_jax.report import write_report

        csv = write_report(records, reference_first=True)
        rows = [r.split(",") for r in csv.strip().splitlines()[1:]]
        # rows alternate sectors within a frame; find frame-1 sector-1
        header = csv.strip().splitlines()[0].split(",")
        chi_col = header.index("chi")
        it_col = header.index("iterations")
        err_col = header.index("error_code")
        f0s1, f1s1 = rows[1], rows[3]
        assert float(f1s1[chi_col]) == float(f0s1[chi_col])
        assert int(f1s1[it_col]) == int(f0s1[it_col])
        assert int(f1s1[err_col]) == int(
            ErrorCode.INTERPOLATION_OUT_OF_IMAGE
        )
    else:
        # continue: state advances with the solver's returned params (the
        # untouched initial guess for an init failure)
        np.testing.assert_allclose(
            records[1].params[1], [8.0, 0.0], atol=1e-4
        )
        # ... so the next extrapolated guess walks fully out of the image
        assert records[2].error[1] == int(ErrorCode.MODEL_OUT_OF_IMAGE)

    # the healthy sector keeps tracking through the whole run
    for t, rec in enumerate(records):
        assert rec.error[0] == 0
        np.testing.assert_allclose(
            rec.params[0], [4.0 * (t + 1), 0.0], atol=0.1
        )


def test_streaming_sequence_bounded_cache(tmp_path):
    """The file-driven sequence holds a bounded decoded-frame cache
    (VERDICT r2 item 5): a 12-frame run never caches more than
    ahead + behind + 1 decoded frames."""
    from PIL import Image

    from correlation_jax.sequence import run_sequence_from_files

    du, dv = 0.3, -0.2
    frames = _frames(12, du, dv, h=64, w=64)
    paths = []
    for t, f in enumerate(frames):
        p = str(tmp_path / f"s{t:02d}.png")
        Image.fromarray(f[..., 0].astype(np.uint8)).save(p)
        paths.append(p)

    pts = [_grid_pts(20, 20, 44, 44)]
    # Prefetch depth follows frame_chunk (the chunked driver stages a
    # chunk's frames at once); a small chunk keeps the cache bound
    # meaningfully below the sequence length.
    cfg = _cfg(frame_chunk=3)
    stats = {}
    records = run_sequence_from_files(paths, pts, cfg, io_stats=stats)
    assert len(records) == 11
    for t, rec in enumerate(records):
        np.testing.assert_allclose(
            rec.params[0], [du * (t + 1), dv * (t + 1)], atol=0.05
        )
    assert stats["max_cached"] <= 6  # ahead(chunk+1=4) + behind(1) + current


def test_previous_chain_matches_oracle():
    """Multi-frame ReferenceImage.PREVIOUS chain vs a chained NumPy-oracle
    trajectory: each pair solves und=frame[t], def=frame[t+1] with the
    previous result as the guess (VERDICT r2 item 7)."""
    import sys

    sys.path.insert(0, "tests")
    import oracle

    from correlation_jax.ops.pyramid import build_pyramid
    import jax.numpy as jnp

    du, dv = 0.57, -0.33
    frames = _frames(4, du, dv, h=80, w=80)
    pts = [_grid_pts(24, 24, 54, 54)]
    solver = SolverConfig(
        model=FittingModel.UV,
        interpolation=Interpolation.BICUBIC,
        pyramid=PyramidConfig(0, 1, 1),
        precision=1e-3,
        max_iterations=50,
    )
    cfg = SequenceConfig(
        solver=solver,
        deformation=DeformationDescription.EULERIAN,
        reference=ReferenceImage.PREVIOUS,
    )
    records = run_sequence(frames, pts, cfg)
    assert len(records) == 3

    pyrs = [
        [
            np.asarray(a)[..., 0].astype(np.float64)
            for a in build_pyramid(jnp.asarray(f, jnp.float32), 1)
        ]
        for f in frames
    ]
    pts64 = pts[0].astype(np.float64)
    guess = np.zeros(2, np.float64)
    for t, rec in enumerate(records):
        out = oracle.newton_raphson(
            "UV", "bicubic", pyrs[t], pyrs[t + 1], pts64, guess,
            levels=(1, 0), max_iters=50, precision=1e-3,
        )
        assert out["error"] is None
        assert int(rec.error[0]) == 0
        np.testing.assert_allclose(rec.params[0], out["params"], atol=5e-4)
        assert int(rec.iterations[0]) == out["iterations"], (
            t, int(rec.iterations[0]), out["iterations"],
        )
        # chained: the next pair's guess is this pair's result
        guess = np.asarray(out["params"], np.float64)


def test_chunked_matches_per_frame():
    """The chunked Eulerian fast path (engine.correlate_frames, one
    dispatch per K frames) must reproduce the per-frame driver's records
    exactly — params, guesses (constant-velocity chain), chi, iterations,
    errors, and globals."""
    du, dv = 0.62, -0.41
    frames = _frames(6, du, dv)
    pts = [_grid_pts(30, 30, 62, 62), _grid_pts(20, 40, 50, 70)]
    for ref in (ReferenceImage.FIRST, ReferenceImage.PREVIOUS):
        cfg_c = _cfg(
            deformation=DeformationDescription.EULERIAN,
            reference=ref,
            frame_chunk=3,
        )
        cfg_p = _cfg(
            deformation=DeformationDescription.EULERIAN,
            reference=ref,
            frame_chunk=1,
        )
        rc = run_sequence(frames, pts, cfg_c)
        rp = run_sequence(frames, pts, cfg_p)
        assert len(rc) == len(rp) == 5
        for a, b in zip(rc, rp):
            np.testing.assert_allclose(a.params, b.params, atol=1e-5)
            np.testing.assert_allclose(
                a.initial_guess, b.initial_guess, atol=1e-5
            )
            np.testing.assert_allclose(a.chi, b.chi, rtol=1e-4)
            np.testing.assert_array_equal(a.iterations, b.iterations)
            np.testing.assert_array_equal(a.error, b.error)
            np.testing.assert_allclose(
                a.def_center, b.def_center, atol=1e-5
            )
            np.testing.assert_allclose(
                a.def_global_center, b.def_global_center, atol=1e-5
            )
            assert a.und_e is not None and a.def_e is not None
            np.testing.assert_array_equal(a.und_e, b.und_e)


def test_chunked_color_matches_per_frame():
    """RGB sequences through the chunked driver: 3-channel pixdata rows,
    per-channel Gram accumulation, and the in-scan pyramid builds must
    match the per-frame path."""
    du, dv = 0.55, -0.35
    spk = Speckle(80, 80, seed=13)
    frames = []
    for t in range(4):
        g = spk.warped_image(u=du * t, v=dv * t, quantize=True)
        rgb = np.stack([g, np.roll(g, 1, 0), np.roll(g, 1, 1)], -1)
        frames.append(rgb.astype(np.float32))
    pts = [_grid_pts(25, 25, 55, 55)]
    kw = dict(
        deformation=DeformationDescription.EULERIAN,
        reference=ReferenceImage.FIRST,
    )
    rc = run_sequence(frames, pts, _cfg(frame_chunk=3, **kw))
    rp = run_sequence(frames, pts, _cfg(frame_chunk=1, **kw))
    assert len(rc) == len(rp) == 3
    for a, b in zip(rc, rp):
        np.testing.assert_allclose(a.params, b.params, atol=1e-5)
        np.testing.assert_array_equal(a.error, b.error)
    np.testing.assert_allclose(rc[-1].params[0], [3 * du, 3 * dv], atol=0.1)


def test_chunked_lagrangian_matches_per_frame():
    """The chunked Lagrangian path (domain translate carried in-scan,
    engine._correlate_frames_impl) must track the per-frame driver.
    Level 0 uses exact reference semantics (integer whole-pixel domain
    offsets); coarse levels translate the frame-0 point sets instead of
    re-selecting %2^l members, a sub-precision seeding difference — so
    records agree to tight tolerances rather than bitwise."""
    du, dv = 1.3, -0.8  # whole-pixel domain offsets after add_pair rounding
    frames = _frames(6, du, dv, h=128, w=128)
    pts = [_grid_pts(34, 34, 62, 62), _grid_pts(58, 66, 90, 94)]
    for ref in (ReferenceImage.PREVIOUS, ReferenceImage.FIRST):
        cfg_c = _cfg(
            deformation=DeformationDescription.LAGRANGIAN,
            reference=ref,
            frame_chunk=3,
        )
        cfg_p = _cfg(
            deformation=DeformationDescription.LAGRANGIAN,
            reference=ref,
            frame_chunk=1,
        )
        rc = run_sequence(frames, pts, cfg_c)
        rp = run_sequence(frames, pts, cfg_p)
        assert len(rc) == len(rp) == 5
        for a, b in zip(rc, rp):
            assert np.array_equal(a.error, b.error)
            np.testing.assert_allclose(a.params, b.params, atol=5e-3)
            np.testing.assert_allclose(
                a.initial_guess, b.initial_guess, atol=5e-3
            )
            np.testing.assert_allclose(
                a.und_center, b.und_center, atol=5e-3
            )
            np.testing.assert_allclose(
                a.def_center, b.def_center, atol=8e-3
            )
        # physical tracking: each frame pair recovers ~(du, dv) under
        # reference PREVIOUS; accumulated under FIRST
        last = rc[-1].params
        expect = (
            np.array([du, dv])
            if ref == ReferenceImage.PREVIOUS
            else np.array([5 * du, 5 * dv])
        )
        np.testing.assert_allclose(
            last, np.tile(expect, (2, 1)), atol=0.08
        )


def test_chunked_lagrangian_checkpoint_resume(tmp_path):
    """Interrupting a chunked Lagrangian run and resuming from its
    checkpoint must reproduce the uninterrupted records: the resume path
    rebuilds the batch from the ADVANCED und_points and re-seeds the
    device offsets at zero."""
    du, dv = 1.3, -0.8
    frames = _frames(7, du, dv, h=128, w=128)
    pts = [_grid_pts(34, 34, 62, 62)]
    kw = dict(
        deformation=DeformationDescription.LAGRANGIAN,
        reference=ReferenceImage.PREVIOUS,
        frame_chunk=2,
    )
    full = run_sequence(frames, pts, _cfg(**kw))

    ck = str(tmp_path / "lagr.npz")
    calls = {"n": 0}

    def stop_after_three():
        # cooperative-cancel once 3 records exist (mid-sequence)
        return calls["n"] >= 1

    # First leg: run with a should_stop that fires partway.
    emitted = []

    def on_frame(rec):
        emitted.append(rec.frame)
        if rec.frame >= 2:
            calls["n"] = 1

    part1 = run_sequence(
        frames, pts, _cfg(**kw),
        checkpoint_path=ck, on_frame=on_frame,
        should_stop=lambda: calls["n"] >= 1,
    )
    assert 0 < len(part1) < 6
    part2 = run_sequence(frames, pts, _cfg(**kw), checkpoint_path=ck)
    assert len(part2) == 6
    for a, b in zip(part2, full):
        assert a.frame == b.frame
        np.testing.assert_allclose(a.params, b.params, atol=5e-3)
        np.testing.assert_allclose(a.und_center, b.und_center, atol=5e-3)
        np.testing.assert_array_equal(a.error, b.error)


def test_chunked_lagrangian_stop_frame_matches_per_frame():
    """STOP_FRAME freezing inside the Lagrangian chain: a sector that
    errors keeps its previous params AND its domain keeps advancing by
    the frozen uv (per-frame semantics) — chunked must match."""
    from correlation_jax.config import ErrorMode

    du, dv = 1.4, -0.9
    frames = _frames(6, du, dv, h=128, w=128)
    # one sector near the frame edge errors as the domain walks off;
    # one interior sector stays healthy
    pts = [_grid_pts(6, 6, 30, 30), _grid_pts(60, 60, 88, 88)]
    kw = dict(
        deformation=DeformationDescription.LAGRANGIAN,
        reference=ReferenceImage.PREVIOUS,
        error_mode=ErrorMode.STOP_FRAME,
    )
    rc = run_sequence(frames, pts, _cfg(frame_chunk=3, **kw))
    rp = run_sequence(frames, pts, _cfg(frame_chunk=1, **kw))
    assert len(rc) == len(rp) == 5
    saw_error = False
    for a, b in zip(rc, rp):
        np.testing.assert_array_equal(a.error, b.error)
        np.testing.assert_allclose(a.params, b.params, atol=6e-3)
        np.testing.assert_allclose(a.chi, b.chi, rtol=2e-3, atol=1e-2)
        np.testing.assert_array_equal(a.iterations, b.iterations)
        saw_error = saw_error or (a.error != 0).any()
    assert saw_error, "edge sector never errored; workload too easy"

def test_record_points_tracks_lagrangian_domain(tmp_path):
    """SequenceConfig.record_points snapshots each frame's (moved)
    undeformed point lists into its FrameRecord: frame t's lists are the
    frame-0 lists plus the cumulative whole-pixel Lagrangian offset
    (add_pair rounding, manager_class.cpp:38-47, 2018-2310), identical
    between the chunked and per-frame drivers, and survive a checkpoint
    roundtrip."""
    du, dv = 1.3, -0.8
    frames = _frames(5, du, dv, h=128, w=128)
    pts = [_grid_pts(34, 34, 62, 62), _grid_pts(58, 66, 90, 94)]
    kw = dict(
        deformation=DeformationDescription.LAGRANGIAN,
        reference=ReferenceImage.PREVIOUS,
        record_points=True,
    )
    rc = run_sequence(frames, pts, _cfg(frame_chunk=3, **kw))
    rp = run_sequence(frames, pts, _cfg(frame_chunk=1, **kw))
    assert len(rc) == len(rp) == 4
    for a, b in zip(rc, rp):
        assert a.und_points is not None and b.und_points is not None
        for pa, pb in zip(a.und_points, b.und_points):
            np.testing.assert_array_equal(pa, pb)
    # frame 0 solves on the original lists; later frames on whole-pixel
    # translates of them (the offset approximately tracks the material)
    for s in range(len(pts)):
        np.testing.assert_array_equal(rc[0].und_points[s], pts[s])
    for t, rec in enumerate(rc[1:], start=1):
        for s in range(len(pts)):
            off = rec.und_points[s] - pts[s]
            # one whole-pixel offset for the whole sector
            assert np.all(off == off[0])
            assert np.all(off == np.floor(off))
            np.testing.assert_allclose(
                off[0], [du * t, dv * t], atol=1.01
            )
    # Eulerian default leaves the field empty (no duplication)
    re = run_sequence(frames, pts, _cfg())
    assert all(r.und_points is None for r in re)

    # checkpoint roundtrip preserves the per-record lists
    from correlation_jax.utils.checkpoint import (
        load_checkpoint,
        save_checkpoint,
    )

    ck = str(tmp_path / "pts.npz")
    rc_state_holder = []

    # save via the public driver: re-run with checkpointing on
    rck = run_sequence(
        frames, pts, _cfg(frame_chunk=3, **kw), checkpoint_path=ck
    )
    next_frame, _, loaded = load_checkpoint(ck)
    assert next_frame == 4
    assert len(loaded) == len(rck)
    for a, b in zip(loaded, rck):
        assert a.und_points is not None
        for pa, pb in zip(a.und_points, b.und_points):
            np.testing.assert_array_equal(pa, pb)

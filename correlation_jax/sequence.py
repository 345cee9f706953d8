"""Multi-frame correlation driver.

Replaces managerClass::perform_multiframe_correlation and the per-frame
sector orchestration (manager_class.cpp:1297-1541, 274-814) — but where the
reference loops sectors serially around single-sector solves, every frame
here is ONE batched engine call over all sectors.

Capabilities carried over:
  * reference-image modes First / Previous with O(1)-memory frame recycling
    (und <- def <- next, pyramid_class.cpp:211-258),
  * deformation descriptions Eulerian / Lagrangian / strict-Lagrangian
    domain updates (manager_class.cpp:354-419),
  * constant-velocity initial-guess extrapolation for Eulerian + ref-First
    (manager_class.cpp:2677-2686), plus frame-0 per-sector guess
    customization from the global guess (manager_class.cpp:2609-2660),
  * per-sector result records and the point-weighted global averages
    (manager_class.cpp:2709-2753),
  * CSV report rows identical in content to manager_class.cpp:2430-2525,
  * error-handling modes stop-all / stop-frame / continue.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import jax.numpy as jnp

from correlation_jax.config import (
    DeformationDescription,
    ErrorCode,
    ErrorMode,
    FittingModel,
    ReferenceImage,
    SolverConfig,
)
from correlation_jax.domains import SubsetBatch, make_batch
from correlation_jax.engine import correlate
from correlation_jax.models.warp import warp_points
from correlation_jax.ops.pyramid import build_pyramid


@dataclasses.dataclass(frozen=True)
class SequenceConfig:
    solver: SolverConfig = dataclasses.field(default_factory=SolverConfig)
    deformation: DeformationDescription = DeformationDescription.EULERIAN
    reference: ReferenceImage = ReferenceImage.FIRST
    error_mode: ErrorMode = ErrorMode.CONTINUE
    # Eulerian/Lagrangian sequences chain this many frame solves inside
    # ONE device dispatch (engine.correlate_frames), amortizing the
    # per-call dispatch latency the way the reference overlaps its frame
    # loop with prefetch (manager_class.cpp:1381-1475).  1 = per-frame.
    # Not yet re-tuned on the GPU (ROADMAP).  Lower --frame-chunk for very
    # large frames or streaming consumers: a chunk stages K+1 frames.
    frame_chunk: int = 64
    # Snapshot each frame's per-sector undeformed point lists into its
    # FrameRecord (und_points).  Off by default: under the (default)
    # Eulerian description the domain never moves, so the frame-0 lists
    # describe every frame; under the Lagrangian descriptions the domain
    # follows the material and consumers that need the per-frame point
    # sets (e.g. --plot-points overlays) opt in here.
    record_points: bool = False


@dataclasses.dataclass
class FrameRecord:
    """Per-frame, per-sector results (the analog of frame_results,
    domains.hpp:59-108, flattened into arrays)."""

    frame: int
    params: np.ndarray  # [S, NP]
    initial_guess: np.ndarray  # [S, NP]
    chi: np.ndarray  # [S]
    iterations: np.ndarray  # [S]
    error: np.ndarray  # [S]
    n_points: np.ndarray  # [S]
    und_center: np.ndarray  # [S, 2]
    def_center: np.ndarray  # [S, 2]
    und_angle: np.ndarray  # [S]
    def_angle: np.ndarray  # [S]
    und_global_center: np.ndarray  # [2]
    def_global_center: np.ndarray  # [2]
    und_global_angle: float
    def_global_angle: float
    und_contours: list | None = None  # per-sector [Nc, 2]
    def_contours: list | None = None  # per-sector [Nc, 2]
    # Per-sector strain state carried by the reference's frame_results
    # (domains.hpp:59-108).  update_results zeroes def_e for every fitting
    # model (manager_class.cpp:2360-2395) and the Lagrangian updates copy
    # def->und (manager_class.cpp:2198-2217), so these are structurally
    # faithful passthroughs of the reference's (always-zero) values.
    und_e: np.ndarray | None = None  # [S]
    def_e: np.ndarray | None = None  # [S]
    und_global_e: float = 0.0
    def_global_e: float = 0.0
    # Per-sector undeformed points used for THIS frame's solve (only when
    # SequenceConfig.record_points; the Lagrangian domain updates move the
    # points between frames — manager_class.cpp:2018-2310).
    und_points: list | None = None


@dataclasses.dataclass
class _TrackState:
    """Chained per-sector state across frames."""

    und_points: list[np.ndarray]  # level-0 float positions per sector
    und_center: np.ndarray  # [S, 2]
    past_und_center: np.ndarray  # [S, 2]
    und_angle: np.ndarray  # [S]
    und_global_center: np.ndarray  # [2]
    und_global_angle: float
    params: np.ndarray  # [S, NP] resulting parameters
    prev_params: np.ndarray  # [S, NP]
    guess: np.ndarray  # [S, NP]
    def_center: np.ndarray  # [S, 2]
    def_angle: np.ndarray  # [S]
    def_global_center: np.ndarray  # [2]
    def_global_angle: float
    explicit_centers: bool  # rectangular domains pass centers explicitly
    und_contours: list | None = None  # per-sector [Nc, 2] float
    def_contours: list | None = None
    pad_to: list | None = None  # per-level padded point counts
    # Last emitted chi/iterations — STOP_FRAME frozen sectors re-emit
    # these (manager_class.cpp:535-546 skipped sectors keep previous
    # values).
    chi: np.ndarray | None = None  # [S]
    iterations: np.ndarray | None = None  # [S]
    # Reference strain state (frame_results und_e/def_e/*_global_e,
    # domains.hpp:59-108) — zeroed per model by update_results, copied
    # through by the Lagrangian domain updates.
    und_e: np.ndarray | None = None  # [S]
    def_e: np.ndarray | None = None  # [S]
    und_global_e: float = 0.0
    def_global_e: float = 0.0


def initial_track_state(
    point_lists: list[np.ndarray],
    centers: np.ndarray | None,
    global_center: np.ndarray,
    global_guess: np.ndarray,
    model: FittingModel,
    contours: list | None = None,
    per_sector_uv: np.ndarray | None = None,
) -> _TrackState:
    """Frame-0 setup: per-sector guess customization from the global guess.

    For UVQ, sectors away from the global center receive the rigid-rotation
    translation offset; for AFFINE, the strain offset
    (manager_class.cpp:2609-2660).

    per_sector_uv: optional [S, 2] per-sector (u, v) seeds (e.g. from
    ops.seed.phase_correlation_guess) overriding the global guess's
    translation columns before the rotation/strain offsets apply — this
    EXCEEDS the reference, whose per-sector customization is only the
    affine/rotation offset about the global center
    (manager_class.cpp:2609-2660): a spatially varying large-displacement
    field (the case automatic seeding exists for) gets a per-sector
    starting point instead of one global (u, v).
    """
    s = len(point_lists)
    num_params = len(global_guess)
    explicit = centers is not None
    if centers is None:
        centers = np.array(
            [p.mean(axis=0) for p in point_lists], np.float32
        )
    guess = np.tile(np.asarray(global_guess, np.float32), (s, 1))
    if per_sector_uv is not None:
        uv = np.asarray(per_sector_uv, np.float32).reshape(s, 2)
        guess[:, 0] = uv[:, 0]
        if num_params > 1:
            guess[:, 1] = uv[:, 1]
    d = centers - np.asarray(global_center, np.float32)
    if model == FittingModel.UVQ:
        vx = global_guess[2]
        guess[:, 0] += -d[:, 1] * vx
        guess[:, 1] += d[:, 0] * vx
    elif model == FittingModel.AFFINE:
        ux, uy, vx, vy = global_guess[2:6]
        guess[:, 0] += d[:, 0] * ux + d[:, 1] * uy
        guess[:, 1] += d[:, 0] * vx + d[:, 1] * vy
    return _TrackState(
        und_points=[np.asarray(p, np.float32) for p in point_lists],
        und_center=centers.astype(np.float32),
        past_und_center=centers.astype(np.float32).copy(),
        und_angle=np.zeros(s, np.float32),
        und_global_center=np.asarray(global_center, np.float32),
        und_global_angle=0.0,
        params=np.zeros((s, num_params), np.float32),
        prev_params=guess.copy(),
        guess=guess,
        def_center=centers.astype(np.float32).copy(),
        def_angle=np.zeros(s, np.float32),
        def_global_center=np.asarray(global_center, np.float32),
        def_global_angle=0.0,
        explicit_centers=explicit,
        und_contours=(
            [np.asarray(c, np.float32) for c in contours]
            if contours is not None
            else None
        ),
        chi=np.zeros(s, np.float32),
        iterations=np.zeros(s, np.int32),
        und_e=np.zeros(s, np.float32),
        def_e=np.zeros(s, np.float32),
    )


def _round_points(pts: np.ndarray) -> np.ndarray:
    """add_pair semantics: (int)(x + 0.5) (manager_class.cpp:38-47)."""
    return np.floor(pts + 0.5).astype(np.float32)


def _warp_ragged(
    model: FittingModel,
    params: np.ndarray,
    point_lists: list[np.ndarray],
    centers: np.ndarray,
) -> list[np.ndarray]:
    """Warp S ragged per-sector point lists in ONE batched dispatch.

    The reference warps one sector at a time (kModel_inPlace per sector,
    cuda_polygon.cu:268-415); at dense-grid scale that is thousands of
    dispatches per frame.  Here the ragged lists pad to [S, P_max, 2],
    warp in a single warp_points call, and split back.
    """
    s = len(point_lists)
    lens = [len(p) for p in point_lists]
    p_max = max(max(lens), 1)
    xy = np.zeros((s, p_max, 2), np.float32)
    for i, p in enumerate(point_lists):
        xy[i, : lens[i]] = p
    out = np.asarray(
        warp_points(
            model,
            jnp.asarray(params),
            jnp.asarray(xy),
            jnp.asarray(centers),
        )
    )
    return [out[i, : lens[i]].copy() for i in range(s)]


def warped_inside_points(
    model: FittingModel,
    params: np.ndarray,
    point_lists: list[np.ndarray],
    centers: np.ndarray,
) -> list[np.ndarray]:
    """Per-sector warped (deformed) point sets for plotting.

    The analog of cudaPolygon::getDefXY0ToCPU (cuda_polygon.cu:49-90) +
    managerClass plot_inside_points (manager_class.cpp:606-612): applies
    each sector's current warp to its undeformed inside points about the
    sector center.  One batched dispatch for all sectors.
    """
    return _warp_ragged(model, params, point_lists, centers)


def advance_domain(
    state: _TrackState,
    cfg: SequenceConfig,
    model: FittingModel,
) -> None:
    """Move the undeformed domain per the deformation description
    (manager_class.cpp:354-419 and adjust_*_domain at :2018-2310)."""
    deform = cfg.deformation
    if deform == DeformationDescription.EULERIAN:
        return
    # Lagrangian family: the domain follows the material.
    state.und_global_center = state.def_global_center.copy()
    state.und_global_angle = state.def_global_angle
    # Strain copy-through (manager_class.cpp:2198-2217).
    state.und_e = state.def_e.copy()
    state.und_global_e = state.def_global_e
    state.past_und_center = state.und_center.copy()
    new_center = state.def_center.copy()
    if deform == DeformationDescription.LAGRANGIAN:
        offset = new_center - state.past_und_center
        state.und_points = [
            _round_points(p + offset[i])
            for i, p in enumerate(state.und_points)
        ]
        if state.und_contours is not None:
            # contours move by the rounded center offset too
            # (manager_class.cpp:386-389, add_pair)
            state.und_contours = [
                _round_points(c + offset[i])
                for i, c in enumerate(state.und_contours)
            ]
    else:  # strict Lagrangian: every point individually warped — one
        # batched dispatch for all sectors (VERDICT r2 item 6)
        state.und_points = _warp_ragged(
            model, state.params, state.und_points, state.und_center
        )
        if state.def_contours is not None:
            # und contour becomes last frame's deformed contour
            # (manager_class.cpp:362-365)
            state.und_contours = [c.copy() for c in state.def_contours]
    state.und_center = new_center
    state.und_angle = state.def_angle.copy()


def advance_guess(state: _TrackState, cfg: SequenceConfig) -> None:
    """Constant-velocity extrapolation of the initial guess
    (manager_class.cpp:2672-2700)."""
    if (
        cfg.deformation == DeformationDescription.EULERIAN
        and cfg.reference == ReferenceImage.FIRST
    ):
        state.guess = state.params + (state.params - state.prev_params)
    else:
        state.guess = state.params.copy()
    state.prev_params = state.params.copy()


def update_results(
    state: _TrackState,
    model: FittingModel,
    params: np.ndarray,
    und_center: np.ndarray,
    n_points: np.ndarray,
) -> None:
    """Post-solve per-sector and global updates
    (manager_class.cpp:2312-2428, 2709-2753)."""
    state.params = params
    state.und_center = und_center
    # def center: the warp applied to the sector center about itself
    # (dx = dy = 0 -> pure u, v translation; manager_class.cpp:2404-2413).
    state.def_center = und_center + _uv(params)
    state.def_angle = _rotation_angle_np(model, params) + state.und_angle
    if state.und_contours is not None:
        # contour warped about the und GLOBAL center, all sectors in one
        # batched dispatch (manager_class.cpp:2404-2427)
        gc = np.tile(
            np.asarray(state.und_global_center, np.float32),
            (params.shape[0], 1),
        )
        state.def_contours = _warp_ragged(
            model, params, state.und_contours, gc
        )
    # def_e is zeroed for every fitting model (manager_class.cpp:2360-2395)
    # and the global e is its point-weighted average (:2710-2746).
    state.def_e = np.zeros(params.shape[0], np.float32)
    n = n_points.astype(np.float64)
    total = max(n.sum(), 1.0)
    state.def_global_angle = float((state.def_angle * n).sum() / total)
    state.def_global_e = float((state.def_e * n).sum() / total)
    state.def_global_center = (
        (state.def_center * n[:, None]).sum(axis=0) / total
    ).astype(np.float32)


def _rotation_angle_np(model: FittingModel, params: np.ndarray) -> np.ndarray:
    """Host-side rotation angle (warp.rotation_angle is jnp-based, and a
    per-frame device round-trip here would undo the chunked dispatch
    amortization).  Formula: parameters.cpp:55-58."""
    if model == FittingModel.UVQ:
        return params[:, 2].astype(np.float32)
    if model == FittingModel.AFFINE:
        return np.arctan2(
            params[:, 4] - params[:, 3], params[:, 2] + params[:, 5] + 2.0
        ).astype(np.float32)
    return np.zeros(params.shape[0], np.float32)


def _uv(params: np.ndarray) -> np.ndarray:
    uv = np.zeros((params.shape[0], 2), np.float32)
    uv[:, 0] = params[:, 0]
    if params.shape[1] >= 2:
        uv[:, 1] = params[:, 1]
    return uv


def run_sequence(
    frames,
    point_lists: list[np.ndarray],
    cfg: SequenceConfig,
    global_guess: np.ndarray | None = None,
    centers: np.ndarray | None = None,
    global_center: np.ndarray | None = None,
    contours: list | None = None,
    per_sector_guess: np.ndarray | None = None,
    should_stop=None,
    meter=None,
    checkpoint_path: str | None = None,
    checkpoint_every: int = 1,
    on_frame=None,
    mesh=None,
) -> list[FrameRecord]:
    """Correlate a frame sequence.

    Args:
      frames: list of [H, W, C] float32 images (uint8-valued), length >= 2,
        or any callable idx -> image (e.g. a FramePrefetcher.get).
      point_lists: per-sector level-0 undeformed points (frame 0).
      cfg: sequence configuration.
      global_guess: [NP] global initial guess (default zeros).
      centers: [S, 2] explicit sector centers (rectangular domains), or None
        to use per-sector point means (annular/blob).
      global_center: [2] domain global center (defaults to mean of centers).
      contours: optional per-sector contour polylines to track.
      per_sector_guess: optional [S, 2] per-sector frame-0 (u, v) seeds
        (see initial_track_state; typically phase-correlation output).
      should_stop: optional () -> bool cooperative-cancel poll (the batched
        analog of the reference's stop_flag, manager_class.h:200).
      meter: optional utils.profiling.SolveMeter to accumulate solves/s.
      checkpoint_path: optional .npz path; if it exists the run resumes from
        it, and the chained state is re-saved every `checkpoint_every`
        completed frame pairs (and at cancel/stop).
      checkpoint_every: checkpoint save period in frame pairs.
      on_frame: optional callback(record) after each frame pair — the
        headless analog of the reference's live plotting signals
        (manager_class.cpp:488-516).
      mesh: optional jax.sharding.Mesh; the subset axis shards across it
        (see engine.correlate).

    Returns:
      One FrameRecord per frame pair.
    """
    n_frames = len(frames)
    solver = cfg.solver
    model = solver.model
    num_params = solver.num_params
    if global_guess is None:
        global_guess = np.zeros(num_params, np.float32)
    if global_center is None:
        cs = (
            np.asarray(centers)
            if centers is not None
            else np.array([p.mean(axis=0) for p in point_lists])
        )
        global_center = cs.mean(axis=0)

    start_frame = 0
    records: list[FrameRecord] = []
    state = None
    if checkpoint_path is not None:
        import os

        if os.path.exists(checkpoint_path):
            from correlation_jax.utils.checkpoint import load_checkpoint

            start_frame, state, records = load_checkpoint(checkpoint_path)
    if state is None:
        state = initial_track_state(
            point_lists, centers, global_center, global_guess, model,
            contours=contours, per_sector_uv=per_sector_guess,
        )
    s_count = len(state.und_points)
    if state.chi is None:
        state.chi = np.zeros(s_count, np.float32)
    if state.iterations is None:
        state.iterations = np.zeros(s_count, np.int32)
    if state.und_e is None:
        state.und_e = np.zeros(s_count, np.float32)
    if state.def_e is None:
        state.def_e = np.zeros(s_count, np.float32)

    stop = solver.pyramid.stop
    pyramids: dict[int, list] = {}
    batch_dev = None

    def pyramid_of(idx: int):
        if idx not in pyramids:
            pyramids[idx] = build_pyramid(jnp.asarray(frames[idx]), stop)
            # Keep at most the three live pyramids (und/def/next) resident,
            # mirroring the reference's frame recycling.
            live = {idx, idx - 1, 0 if cfg.reference == ReferenceImage.FIRST else -1}
            for k in [k for k in pyramids if k not in live and k != idx]:
                if len(pyramids) > 3:
                    pyramids.pop(k)
        return pyramids[idx]

    def save_ckpt(next_frame: int) -> None:
        if checkpoint_path is not None:
            from correlation_jax.utils.checkpoint import save_checkpoint

            save_checkpoint(checkpoint_path, next_frame, state, records)

    total_pairs = n_frames - 1

    def make_batch_if_needed(points_moved: bool):
        nonlocal batch_dev
        # Stable padded shapes across frames: the compiled solve is reused
        # as long as the (grown-once) pad targets hold.  The device-resident
        # batch is cached while the domain is stationary (Eulerian), so the
        # per-frame host->device traffic is just the new image + guesses.
        if batch_dev is None or points_moved:
            batch = make_batch(
                state.und_points,
                state.und_center if state.explicit_centers else None,
                stop,
                pad_to=state.pad_to,
            )
            state.pad_to = [a.shape[1] for a in batch.xy]
            batch_dev = batch.to_device() if mesh is None else batch
        return batch_dev

    def emit(frame, params, guess, chi, iterations, errors,
             und_center, n_points):
        """Per-frame record bookkeeping shared by both drive modes."""
        update_results(state, model, params, und_center, n_points)
        state.chi = chi.copy()
        state.iterations = iterations.copy()
        records.append(
            FrameRecord(
                frame=frame,
                params=params,
                initial_guess=guess.copy(),
                chi=chi,
                iterations=iterations,
                error=errors,
                n_points=n_points,
                und_center=und_center,
                def_center=state.def_center.copy(),
                und_angle=state.und_angle.copy(),
                def_angle=state.def_angle.copy(),
                und_global_center=state.und_global_center.copy(),
                def_global_center=state.def_global_center.copy(),
                und_global_angle=state.und_global_angle,
                def_global_angle=state.def_global_angle,
                und_contours=(
                    [c.copy() for c in state.und_contours]
                    if state.und_contours is not None
                    else None
                ),
                def_contours=(
                    [c.copy() for c in state.def_contours]
                    if state.def_contours is not None
                    else None
                ),
                und_e=state.und_e.copy(),
                def_e=state.def_e.copy(),
                und_global_e=state.und_global_e,
                def_global_e=state.def_global_e,
                und_points=(
                    [p.copy() for p in state.und_points]
                    if cfg.record_points
                    else None
                ),
            )
        )
        if on_frame is not None:
            on_frame(records[-1])

    import contextlib

    lagr = cfg.deformation == DeformationDescription.LAGRANGIAN
    chunked = (
        cfg.deformation
        in (DeformationDescription.EULERIAN, DeformationDescription.LAGRANGIAN)
        and cfg.frame_chunk > 1
        and total_pairs - start_frame > 1
    )
    if chunked:
        # Fixed-geometry fast path: K frame solves per device dispatch
        # (engine.correlate_frames), pyramids built in-jit.  Identical
        # record semantics to the per-frame path (tested).  Lagrangian
        # domains chain too: the whole-pixel domain translate is carried
        # on device (engine._correlate_frames_impl) while the host
        # mirrors it per emitted frame (advance_domain) so records,
        # checkpoints, and resume state stay exact.
        from correlation_jax.engine import correlate_frames

        batch = make_batch_if_needed(False)
        ref_first = cfg.reference == ReferenceImage.FIRST
        stop_frame = cfg.error_mode == ErrorMode.STOP_FRAME
        und0 = np.asarray(frames[0], np.float32) if ref_first else None

        # One compiled chunk shape per run: tail chunks pad by repeating
        # the last frame (their extra solves are discarded) instead of
        # recompiling a shorter scan.
        k_shape = min(cfg.frame_chunk, total_pairs - start_frame)
        num_p = solver.num_params

        # Chunk-invariant values fetched once.
        und_center = np.asarray(state.und_center, np.float32)
        n_points = np.asarray(
            jnp.sum(jnp.asarray(batch.mask[0]), axis=-1)
        ).astype(np.int32)

        import jax

        # uint8-valued sources (io.load_image guarantees this for 8-bit
        # files) upload chunk stacks as uint8 — 4x fewer bytes over the
        # host->device link; the scan casts to f32 on device (lossless).
        stage_u8 = bool(getattr(frames, "uint8_source", False))

        def stage(frame):
            """Build + start the async upload of a chunk's frame stack."""
            k = min(k_shape, total_pairs - frame)
            base = (
                und0 if ref_first
                else np.asarray(frames[frame], np.float32)
            )
            def_frames = [
                np.asarray(frames[frame + j + 1], np.float32)
                for j in range(k)
            ]
            def_frames += [def_frames[-1]] * (k_shape - k)
            stk = np.stack([base] + def_frames)
            if stage_u8:
                stk = stk.astype(np.uint8)
            return k, jax.device_put(stk)

        # Pipelined chunk loop: chunk i+1 is DISPATCHED (seeded from chunk
        # i's on-device carry — no host round trip in the dependency
        # chain) before chunk i's results are fetched, so consecutive
        # chunks' execution, the next stack upload, and the packed-result
        # download all overlap.  STOP_ALL / cancellation discard the
        # in-flight chunk (its frames are simply never emitted), matching
        # the per-frame driver's truncation.
        frame = start_frame  # next frame index to dispatch
        staged = stage(frame)
        pending = None  # (pframe, pk, out) dispatched, not yet fetched
        carry = None  # device-side seed chain
        host_off = np.zeros((s_count, 2), np.float32)  # Lagrangian mirror
        halt = False
        while pending is not None or (frame < total_pairs and not halt):
            out = None
            k = 0
            if frame < total_pairs and not halt:
                if should_stop is not None and should_stop():
                    halt = True
                    if pending is None:
                        save_ckpt(frame)
                else:
                    k, stack = staged
                    seeds = (
                        dict(
                            p_seed=state.params,
                            prev_seed=state.prev_params,
                            chi_seed=state.chi,
                            it_seed=state.iterations,
                            ucen_seed=(
                                state.und_center if lagr else None
                            ),
                        )
                        if carry is None
                        else dict(
                            p_seed=carry[0],
                            prev_seed=carry[1],
                            chi_seed=carry[2],
                            it_seed=carry[3],
                            off_seed=carry[4] if lagr else None,
                            ucen_seed=carry[5] if lagr else None,
                        )
                    )
                    out = correlate_frames(
                        solver,
                        stack,
                        batch,
                        guess0=state.guess,
                        reference_first=ref_first,
                        stop_frame=stop_frame,
                        lagrangian=lagr,
                        float_centers=state.explicit_centers,
                        first_chunk=(frame == 0),
                        mesh=mesh,
                        **seeds,
                    )
                    carry = out["carry"]
                    # Stage the next chunk's frames while this one runs
                    # (decode + host->device upload overlap the solve —
                    # the reference's async prefetch,
                    # manager_class.cpp:1438-1447).
                    if frame + k < total_pairs:
                        staged = stage(frame + k)
            if pending is not None:
                pframe, pk, pout = pending
                ctx = (
                    meter.measure(pk * batch.num_subsets)
                    if meter is not None
                    else contextlib.nullcontext()
                )
                with ctx:
                    # ONE device->host transfer for the chunk's results.
                    packed = np.asarray(pout["packed"])
                params_k = packed[..., :num_p]
                chi_k = packed[..., num_p]
                it_k = packed[..., num_p + 1].astype(np.int32)
                err_k = packed[..., num_p + 2].astype(np.int32)
                stop_now = False
                cancelled = False
                emitted = 0
                for j in range(pk):
                    # Per-frame cooperative-cancel granularity (the
                    # dispatch-time poll covers j == 0): un-emitted frames
                    # are discarded, matching the per-frame driver.
                    if (
                        j > 0
                        and should_stop is not None
                        and should_stop()
                    ):
                        cancelled = True
                        break
                    # Reproduce the in-scan guess chain on host (bit-exact
                    # f32: p + (p - p_prev) / p; guess0 at frame 0) —
                    # saves a third of the serialized result transfer.
                    # Lagrangian: also mirror the in-scan domain advance
                    # (advance_domain accumulates the same f32 uv chain
                    # the device carries) so records and resume state
                    # track the device exactly.
                    if pframe + j == 0:
                        guess_j = state.guess.copy()
                    elif lagr:
                        # Mirror of the device chain: explicit (rect)
                        # centers follow the float def centers
                        # (advance_domain); point-mean centers re-derive
                        # as frame-0 means + the cumulative integer
                        # offset, exactly like the translated points.
                        if not state.explicit_centers:
                            host_off = host_off + np.floor(
                                _uv(state.params) + 0.5
                            )
                        advance_domain(state, cfg, model)
                        if not state.explicit_centers:
                            state.und_center = und_center + host_off
                        guess_j = state.params.copy()
                    elif ref_first:
                        guess_j = state.params + (
                            state.params - state.prev_params
                        )
                    else:
                        guess_j = state.params.copy()
                    if not (pframe + j == 0):
                        state.prev_params = state.params.copy()
                    emit(
                        pframe + j, params_k[j], guess_j, chi_k[j],
                        it_k[j], err_k[j],
                        state.und_center if lagr else und_center,
                        n_points,
                    )
                    emitted += 1
                    any_error = bool(
                        (err_k[j] != int(ErrorCode.NONE)).any()
                    )
                    if any_error and cfg.error_mode == ErrorMode.STOP_ALL:
                        stop_now = True
                        break
                next_frame = pframe + emitted
                # `halt` saves too: a dispatch-time stop with a pending
                # chunk must persist the frames emitted since the last
                # periodic save (ADVICE r4 — with checkpoint_every > 1
                # the run could otherwise exit without them).
                if (
                    stop_now or cancelled or halt
                    or next_frame >= total_pairs
                    or (
                        checkpoint_path is not None
                        and any(
                            (pframe + j + 1) % max(checkpoint_every, 1)
                            == 0
                            for j in range(emitted)
                        )
                    )
                ):
                    save_ckpt(next_frame)
                if stop_now or cancelled:
                    return records  # in-flight chunk discarded
            if out is not None:
                pending = (frame, k, out)
                frame += k
            else:
                pending = None
        return records

    for frame in range(start_frame, total_pairs):
        if should_stop is not None and should_stop():
            save_ckpt(frame)
            break
        und_idx = 0 if cfg.reference == ReferenceImage.FIRST else frame
        def_idx = frame + 1

        if frame > 0:
            advance_domain(state, cfg, model)
            advance_guess(state, cfg)

        points_moved = (
            frame > start_frame
            and cfg.deformation != DeformationDescription.EULERIAN
        )
        batch = make_batch_if_needed(points_moved)
        if meter is not None:
            ctx = meter.measure(batch.num_subsets)
        else:
            ctx = contextlib.nullcontext()
        with ctx:
            result = correlate(
                solver,
                pyramid_of(und_idx),
                pyramid_of(def_idx),
                batch,
                state.guess,
                mesh=mesh,
            )
            result = type(result)(*[r.block_until_ready() for r in result])
        params = np.asarray(result.params)
        und_center = np.asarray(result.center)
        n_points = np.asarray(result.n_points)
        errors = np.asarray(result.error)
        chi = np.asarray(result.chi)
        iterations = np.asarray(result.iterations)

        if cfg.error_mode == ErrorMode.STOP_FRAME:
            # Batched stop-frame (manager_class.cpp:535-546, 793-805): in
            # the reference an error aborts the remaining sectors of the
            # CURRENT frame (their chained state keeps its previous values)
            # while the frame loop continues.  Batched, that means an
            # errored sector's chained state does not advance this frame —
            # it is re-attempted next frame from its last good state, and
            # its record keeps the previous chi/iterations (plus the error
            # code), matching the reference's skipped sectors.
            bad = errors != int(ErrorCode.NONE)
            params = np.where(bad[:, None], state.params, params)
            chi = np.where(bad, state.chi, chi)
            iterations = np.where(bad, state.iterations, iterations)

        emit(frame, params, state.guess, chi, iterations, errors,
             und_center, n_points)

        any_error = bool((errors != int(ErrorCode.NONE)).any())
        stop_now = any_error and cfg.error_mode == ErrorMode.STOP_ALL
        if stop_now or (frame + 1) % max(checkpoint_every, 1) == 0:
            save_ckpt(frame + 1)
        if stop_now:
            break
    return records


def run_sequence_from_files(
    paths: list[str],
    point_lists: list[np.ndarray],
    cfg: SequenceConfig,
    monochrome: bool = True,
    io_stats: dict | None = None,
    **kwargs,
) -> list[FrameRecord]:
    """run_sequence over image files with background decode prefetch
    (the analog of the reference's async next-image load,
    manager_class.cpp:1438-1447).  The decoded-frame cache is bounded
    (FramePrefetcher evicts behind the newest request), so memory stays
    O(1) in the sequence length.

    io_stats: optional dict; receives {"max_cached": N} — the high-water
    mark of simultaneously cached decoded frames."""
    from correlation_jax.io import FramePrefetcher

    # The chunked drivers (Eulerian AND Lagrangian since round 5) stage
    # frame_chunk frames at a time, so decode that far ahead (per-frame
    # drivers still work with any depth).
    ahead = max(
        2,
        cfg.frame_chunk + 1
        if cfg.deformation != DeformationDescription.STRICT_LAGRANGIAN
        else 2,
    )
    prefetcher = FramePrefetcher(paths, monochrome=monochrome, ahead=ahead)

    class _LazyFrames:
        # load_image always yields uint8-valued float32 (8-bit grey or
        # RGB), so chunk stacks can upload as uint8.
        uint8_source = True

        def __len__(self):
            return len(paths)

        def __getitem__(self, idx):
            return prefetcher.get(idx)

    try:
        return run_sequence(_LazyFrames(), point_lists, cfg, **kwargs)
    finally:
        if io_stats is not None:
            io_stats["max_cached"] = prefetcher.max_cached
        prefetcher.close()

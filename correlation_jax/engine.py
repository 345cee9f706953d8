"""Batched coarse-to-fine Levenberg-Marquardt Gauss-Newton solver.

This is the batched JAX replacement for the whole solver stack of the
reference: CorrelationClass::Newton_Raphson (correlation_class.cpp:349-640),
the CUDA driver CudaClass::correlate (cuda_class.cu:104-293), and the
serial per-sector dispatch in managerClass (manager_class.cpp:304-547).

Design shift: the reference solves ONE sector at a time with parallelism over
pixels inside the sector; here ALL subsets solve simultaneously as a leading
batch axis [S], and the per-subset divergent control flow (individual lambda
schedules, convergence iterations, the saved-parameter reuse trick) runs as a
masked lax.while_loop over per-subset state.  Every while step is exactly one
reference ITERATION (one assembly at the tentative parameters + the chi
comparison).  The reference's diverging branch launches a SECOND assembly at
the last-good parameters to rebuild their normal equations
(correlation_class.cpp:484-516, cuda_class.cu:183-200); assembly is a pure
deterministic function, so this engine instead CACHES each accepted
assembly's A/b in the loop state and reuses it for the revert step —
bit-identical updates (verified against the NumPy oracle, including
iteration counts) at one assembly per iteration instead of two.

Reference semantics replicated exactly (correlation_class.cpp:349-640):
  * lambda schedule: start 1e-4, x0.4 on success / x10 on failure,
    clamped to [1e-9, 1e9],
  * the "saved parameter" optimization: the update for the *next* step is
    computed from the same assembly as the chi evaluation and reused only if
    the step converged (comments at correlation_class.cpp:432-436, 455-499),
  * delta-chi stopping: |last_good - chi| / (max(last_good, chi) + precision),
  * the returned parameters are the final *saved* set (tentative + one more
    damped GN update), not the last-good set — matching the reference's
    model_parameters bookkeeping,
  * per-level translation of u, v by powers of two,
  * error semantics: an out-of-image sample during a level's *initial*
    assembly aborts the subset entirely (params returned translated to level
    0, chi = FLT_MAX — correlation_class.cpp:413-419); an error during
    iterations abandons the level but continues with the next
    (correlation_class.cpp:484-516).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from correlation_jax.config import ErrorCode, SolverConfig
from correlation_jax.models.warp import translate_params
from correlation_jax.ops.assemble import (
    assemble_normal_equations,
    assemble_normal_equations_tiles,
    choose_tile,
    subset_bbox,
)
from correlation_jax.ops.interp import (
    InterpField,
    precompute_field,
    sample_integer,
)
from correlation_jax.ops.solve import lm_delta_rows

_FLT_MAX = np.float32(np.finfo(np.float32).max)


class LevelArrays(NamedTuple):
    """Per-pyramid-level solver inputs for a subset batch.

    The xla backend uses def_field (coefficient field + gather); the
    xla_sep backend uses def_img (per-subset tiles).  Unused fields are
    None.
    """

    xy: jax.Array  # [S, P_l, 2]
    mask: jax.Array  # [S, P_l] bool
    center: jax.Array  # [S, 2]
    und_w: jax.Array  # [S, P_l, C]
    n_points: jax.Array  # [S] float32
    def_field: InterpField | None = None  # xla backend
    def_img: jax.Array | None = None  # xla_sep backend: [H, W, C]
    bbox: jax.Array | None = None  # [S, 4, 2] und bbox (all backends)
    img_hw: tuple | None = None  # (H, W) true deformed-image dims


class LevelStatic(NamedTuple):
    """Static (hashable) per-level tile info for the xla_sep backend."""

    tile_h: int
    tile_w: int
    img_h: int  # TRUE image dims (validity windows)
    img_w: int


class LevelResult(NamedTuple):
    params: jax.Array  # [S, NP] the reference's model_parameters at exit
    last_good_chi: jax.Array  # [S]
    reached: jax.Array  # [S] int32 completed iterations
    error: jax.Array  # [S] int32 ErrorCode for this level
    init_fail: jax.Array  # [S] bool — initial assembly failed


class CorrelationResult(NamedTuple):
    """Final per-subset outputs (the analog of CorrelationResult in
    domains.hpp:110-118 plus frame_results fields)."""

    params: jax.Array  # [S, NP] at level-0 scale
    chi: jax.Array  # [S] last-good chi of the finest level solved
    iterations: jax.Array  # [S] int32
    error: jax.Array  # [S] int32 ErrorCode
    center: jax.Array  # [S, 2] undeformed centers (level 0)
    n_points: jax.Array  # [S] int32 level-0 point counts


class _PackedState(NamedTuple):
    """LM while-loop carry, PACKED and ELEMENT-MAJOR.

    Per-subset scalars pack into one [6, S] block, and parameters and the
    cached normal equations live transposed (elements on the leading
    axis, subsets on the minor one), so every element is one dense [S]
    row.  All scalar fields are f32 rows — iteration/reached/error are
    small integers, exact in f32.
    """

    # rows: 0 lam, 1 last_good_chi, 2 iteration, 3 reached, 4 active,
    #       5 error (see _SC_* constants)
    scal: jax.Array  # [6, S] f32
    # rows 0..NP-1 = p_cur^T (the reference's `model_parameters`),
    # rows NP..2NP-1 = p_lastgood^T
    pvec: jax.Array  # [2*NP, S] f32
    # Cached normal equations AT p_lastgood — the assembly that accepted
    # them.  The reference's diverging branch re-launches the kernel at
    # last-good to rebuild exactly these (cuda_class.cu:183-200,
    # correlation_class.cpp:484-516); assembly is deterministic, so the
    # cache reproduces that recompute bit-for-bit at zero assemblies.
    # Rows i*NP+j = A[i, j]^T (row-major), rows NP*NP.. = b^T.
    ab: jax.Array  # [NP*(NP+1), S] f32
    steps: jax.Array  # [] int32 global step counter (safety bound)


_SC_LAM = 0
_SC_CHI = 1
_SC_ITER = 2
_SC_REACH = 3
_SC_ACTIVE = 4
_SC_ERR = 5


def _make_assemble(cfg: SolverConfig, level: LevelArrays, static):
    """Element-major assembly closure for one level's arrays.

    assemble(params [S, NP]) yields (ab_t, chi_raw [S], err [S] bool) with
    ab_t an element-major [NP*(NP+1), S] block: A[i, j] at row NP*i + j,
    b[i] at row NP*NP + i.  static selects the xla_sep backend (None:
    the xla coefficient-field backend).
    """
    model, interp = cfg.model, cfg.interpolation
    num_p = cfg.num_params

    if static is not None:

        def raw(params):
            return assemble_normal_equations_tiles(
                model,
                interp,
                level.def_img,
                static.img_h,
                static.img_w,
                static.tile_h,
                static.tile_w,
                level.und_w,
                level.xy,
                level.mask,
                level.center,
                params,
            )

    else:

        def raw(params):
            return assemble_normal_equations(
                model,
                interp,
                level.def_field,
                level.und_w,
                level.xy,
                level.mask,
                level.center,
                params,
            )

    def assemble(params):
        a_mat, b_vec, chi, err = raw(params)
        s = b_vec.shape[0]
        ab_t = jnp.concatenate(
            [a_mat.reshape(s, num_p * num_p), b_vec], axis=1
        ).T  # [NP*(NP+1), S]
        return ab_t, chi, err

    return assemble


def _ab_rows(ab, num_p: int):
    """A-element / b row views of an element-major ab block (A row-major
    at NP*i+j, b after A)."""
    a = [
        [ab[num_p * i + j : num_p * i + j + 1] for j in range(num_p)]
        for i in range(num_p)
    ]
    b = [ab[num_p * num_p + i : num_p * num_p + i + 1] for i in range(num_p)]
    return a, b


def _make_oob(cfg: SolverConfig, level: LevelArrays):
    """MODEL vs INTERPOLATION out-of-image classifier for this level."""
    s = level.center.shape[0]
    if level.bbox is not None and level.img_hw is not None:
        img_h, img_w = level.img_hw

        def oob_code(params):
            """Distinguish MODEL_OUT_OF_IMAGE (warped subset leaves the
            image itself) from INTERPOLATION_OUT_OF_IMAGE (leaves only the
            interpolation validity margin) — enums.hpp:25-35.  The warps
            are affine, so the warped und-bbox corners bound the subset."""
            from correlation_jax.models.warp import warp_points

            corners = warp_points(
                cfg.model, params, level.bbox, level.center
            )
            x, y = corners[..., 0], corners[..., 1]
            out = (
                ~jnp.isfinite(x) | ~jnp.isfinite(y)
                | (x < 0.0) | (x > img_w - 1.0)
                | (y < 0.0) | (y > img_h - 1.0)
            )
            return jnp.where(
                jnp.any(out, axis=1),
                jnp.int32(ErrorCode.MODEL_OUT_OF_IMAGE),
                jnp.int32(ErrorCode.INTERPOLATION_OUT_OF_IMAGE),
            )

    else:

        def oob_code(params):
            del params
            return jnp.full(
                (s,), jnp.int32(ErrorCode.INTERPOLATION_OUT_OF_IMAGE)
            )

    return oob_code


def _make_body(cfg: SolverConfig, assemble, oob_code, scaling):
    """One LM iteration over a (possibly compacted) subset batch."""
    f32 = jnp.float32
    prec = f32(cfg.precision)
    lam_min = f32(cfg.lambda_min)
    lam_max = f32(cfg.lambda_max)
    lam_up = f32(cfg.lambda_up)
    lam_down = f32(cfg.lambda_down)

    def body(st: _PackedState) -> _PackedState:
        # Every step is one reference iteration: assemble at the tentative
        # parameters and compare chi.  A converging step computes the next
        # update from this fresh assembly with the optimistic lambda
        # (correlation_class.cpp:523); a diverging step reverts and
        # computes it from the CACHED last-good assembly with the raised
        # lambda — exactly what the reference's recompute pass rebuilds
        # with a second kernel launch (correlation_class.cpp:484-516).
        lam_c = st.scal[_SC_LAM]
        last_good_chi = st.scal[_SC_CHI]
        iteration = st.scal[_SC_ITER].astype(jnp.int32)
        active = st.scal[_SC_ACTIVE] > 0.0
        error_c = st.scal[_SC_ERR].astype(jnp.int32)
        num_p = st.pvec.shape[0] // 2
        q_t = st.pvec[:num_p]  # [NP, S]
        plg_t = st.pvec[num_p:]
        q = q_t.T  # [S, NP] — the one subset-major view (assembly input)

        # ONE relayout of the fresh assembly into element-major rows;
        # everything after runs on dense [rows, S] tensors.
        ab_t, chi_raw, interp_err = assemble(q)
        chi = chi_raw * scaling

        err_now = active & interp_err

        delta_chi = jnp.abs(
            (last_good_chi - chi)
            / (jnp.maximum(last_good_chi, chi) + prec)
        )
        converging = chi <= last_good_chi
        lam_next = jnp.where(
            converging,
            jnp.maximum(lam_c * lam_down, lam_min),
            jnp.minimum(lam_c * lam_up, lam_max),
        )
        conv_r = converging[None, :]  # [1, S] row broadcast
        ab_sel = jnp.where(conv_r, ab_t, st.ab)
        a_rows, b_rows = _ab_rows(ab_sel, num_p)
        dp_t = lm_delta_rows(a_rows, b_rows, lam_next, scaling)  # [NP, S]
        p_new_t = jnp.where(conv_r, q_t, plg_t) + dp_t

        # Singular damped system -> non-finite update: the reference's
        # cuSolver failure (cuda_solver.cu:40-89).
        solver_now = (
            active & ~interp_err
            & ~jnp.all(jnp.isfinite(dp_t), axis=0)
        )
        stop_err = err_now | solver_now

        do_step = active & ~stop_err
        converged = delta_chi < prec
        next_iter = iteration + 1
        exhausted = (next_iter > cfg.max_iterations) | (lam_next >= lam_max)
        step_stop = converged | exhausted

        p_cur_t = jnp.where(
            stop_err[None, :],
            q_t,
            jnp.where(do_step[None, :], p_new_t, q_t),
        )
        accept = do_step & converging
        acc_r = accept[None, :]
        plg_new = jnp.where(acc_r, q_t, plg_t)
        ab_new = jnp.where(acc_r, ab_t, st.ab)
        last_good_chi = jnp.where(accept, chi, last_good_chi)
        lam = jnp.where(do_step, lam_next, lam_c)
        iteration_n = jnp.where(do_step, next_iter, iteration)
        reached = jnp.where(
            do_step, iteration.astype(jnp.float32), st.scal[_SC_REACH]
        )
        active_n = active & ~stop_err & ~(do_step & step_stop)
        error = jnp.where(
            err_now,
            oob_code(q),
            jnp.where(
                solver_now,
                jnp.int32(ErrorCode.SOLVER),
                jnp.where(
                    do_step & exhausted & ~converged,
                    jnp.int32(ErrorCode.MAX_ITERS_REACHED),
                    error_c,
                ),
            ),
        )
        scal = jnp.stack(
            [
                lam,
                last_good_chi,
                iteration_n.astype(jnp.float32),
                reached,
                active_n.astype(jnp.float32),
                error.astype(jnp.float32),
            ]
        )
        return _PackedState(
            scal=scal,
            pvec=jnp.concatenate([p_cur_t, plg_new], axis=0),
            ab=ab_new,
            steps=st.steps + 1,
        )

    return body


def _make_cond(max_steps: int, thresh: int):
    """While condition: any subset active, the global step bound holds,
    and (compaction stages only) the active set does NOT yet fit the next
    stage's capacity."""

    def cond(st: _PackedState):
        act = st.scal[_SC_ACTIVE] > 0.0
        go = jnp.any(act) & (st.steps < max_steps)
        if thresh:
            go = go & (jnp.sum(act.astype(jnp.int32)) > thresh)
        return go

    return cond


def _gather_level(level: LevelArrays, idx) -> LevelArrays:
    """Gather a LevelArrays down to the given subsets.  Shared level
    images (def_field / def_img) are untouched."""

    def g(a):
        return None if a is None else jnp.take(a, idx, axis=0)

    return level._replace(
        xy=g(level.xy),
        mask=g(level.mask),
        und_w=g(level.und_w),
        center=g(level.center),
        n_points=g(level.n_points),
        bbox=g(level.bbox),
    )


def _gather_state(st: _PackedState, idx) -> _PackedState:
    return _PackedState(
        scal=st.scal[:, idx],
        pvec=st.pvec[:, idx],
        ab=st.ab[:, idx],
        steps=st.steps,
    )


def _scatter_state(full: _PackedState, idx, part: _PackedState) -> _PackedState:
    return _PackedState(
        scal=full.scal.at[:, idx].set(part.scal),
        pvec=full.pvec.at[:, idx].set(part.pvec),
        ab=full.ab.at[:, idx].set(part.ab),
        steps=part.steps,
    )


def _stage_caps(cfg: SolverConfig, s: int) -> list:
    """Compaction-stage capacities (in subsets, descending, multiples
    of 8)."""
    if not cfg.compact_stages or cfg.compact_factor < 2:
        return []
    caps = []
    cap_prev = s
    for _ in range(cfg.compact_stages):
        target = max(cap_prev // cfg.compact_factor, cfg.compact_min)
        cap = min(-(-target // 8) * 8, s)
        if cap >= cap_prev:
            break
        caps.append(cap)
        cap_prev = cap
    return caps


def solve_level(
    cfg: SolverConfig,
    level: LevelArrays,
    params0: jax.Array,
    skip: jax.Array,
    static: LevelStatic | None = None,
) -> LevelResult:
    """Run the LM iteration loop for one pyramid level over all subsets.

    Per-subset early stopping on a batched device: the reference stops each
    sector individually for free (correlation_class.cpp:580-585); a batch-
    wide while_loop instead burns full assemblies on already-converged
    subsets until the LAST straggler finishes.  This driver runs a
    COMPACTION CASCADE: the full-batch loop runs only until the still-
    active subsets fit a fraction of the batch, then the active subsets
    gather into a dense prefix (one device-side argsort + takes — no host
    round trip, scan-compatible) and iteration continues on the smaller
    batch; repeated for geometrically shrinking capacities.  Straggler
    iterations then cost a fraction of a full assembly.  Per-subset
    trajectories are bit-identical to the monolithic loop: every operation
    is per-subset, so order does not enter the math.

    Args:
      cfg: solver configuration (static).
      level: per-level arrays.
      params0: [S, NP] initial guesses at this level's scale.
      skip: [S] bool — subsets frozen by earlier failures; left untouched.
      static: tile/image dims when the xla_sep backend is active.
    """
    s = params0.shape[0]
    f32 = jnp.float32

    assemble = _make_assemble(cfg, level, static)
    oob_code = _make_oob(cfg, level)

    # scaling = 1/N for numerical precision (correlation_class.cpp:402)
    n_ok = level.n_points > 0
    scaling = jnp.where(n_ok, 1.0 / jnp.maximum(level.n_points, 1.0), 0.0)

    # ---- initial assembly at the initial guess ---------------------------
    ab0, chi_raw, interp_err = assemble(params0)
    chi0 = chi_raw * scaling
    lam0 = jnp.full((s,), cfg.lambda_init, f32)
    a_rows0, b_rows0 = _ab_rows(ab0, params0.shape[-1])
    dp0 = lm_delta_rows(a_rows0, b_rows0, lam0, scaling).T  # [S, NP]
    # A singular/non-PD damped system (all-constant intensities, empty
    # gradients) yields a non-finite update: the reference's cuSolver
    # failure (cuda_solver.cu:40-89, cuda_class.cu:314).
    solver0 = (
        (~skip) & ~interp_err & n_ok
        & ~jnp.all(jnp.isfinite(dp0), axis=-1)
    )
    init_fail = (~skip) & (interp_err | ~n_ok | solver0)
    init_error = jnp.where(
        interp_err,
        oob_code(params0),
        jnp.where(
            ~n_ok,
            jnp.int32(ErrorCode.BAD_DOMAIN),
            jnp.where(
                solver0,
                jnp.int32(ErrorCode.SOLVER),
                jnp.int32(ErrorCode.NONE),
            ),
        ),
    )
    p_saved0 = params0 + dp0

    active0 = (~skip) & (~init_fail)
    num_p = params0.shape[-1]
    state = _PackedState(
        scal=jnp.stack(
            [
                lam0,
                jnp.where(init_fail, _FLT_MAX, chi0),
                jnp.ones((s,), f32),  # iteration (1-based)
                jnp.zeros((s,), f32),  # reached
                active0.astype(f32),
                jnp.where(
                    init_fail, init_error, jnp.int32(ErrorCode.NONE)
                ).astype(f32),
            ]
        ),
        pvec=jnp.concatenate(
            [
                jnp.where(init_fail[:, None], params0, p_saved0).T,
                params0.T,
            ],
            axis=0,
        ),
        ab=ab0,
        steps=jnp.int32(0),
    )

    max_steps = cfg.max_iterations + 2
    body = _make_body(cfg, assemble, oob_code, scaling)

    caps = _stage_caps(cfg, s)

    if not caps:
        final = jax.lax.while_loop(_make_cond(max_steps, 0), body, state)
    else:
        full = jax.lax.while_loop(
            _make_cond(max_steps, caps[0]), body, state
        )
        cur_state, cur_level, cur_idx = full, level, None
        for i, cap in enumerate(caps):
            act = cur_state.scal[_SC_ACTIVE] > 0.0
            # Active subsets first (argsort of the inactive flag); any
            # permutation is correct — per-subset math is order-free.
            order = jnp.argsort(~act)[:cap].astype(jnp.int32)
            full_idx = order if cur_idx is None else cur_idx[order]
            part = _gather_state(cur_state, order)
            lvl_i = _gather_level(cur_level, order)
            scaling_i = jnp.where(
                lvl_i.n_points > 0,
                1.0 / jnp.maximum(lvl_i.n_points, 1.0),
                0.0,
            )
            body_i = _make_body(
                cfg,
                _make_assemble(cfg, lvl_i, static),
                _make_oob(cfg, lvl_i),
                scaling_i,
            )
            next_cap = caps[i + 1] if i + 1 < len(caps) else 0
            part = jax.lax.while_loop(
                _make_cond(max_steps, next_cap), body_i, part
            )
            full = _scatter_state(full, full_idx, part)
            cur_state, cur_level, cur_idx = part, lvl_i, full_idx
        final = full

    return LevelResult(
        params=final.pvec[:num_p].T,
        last_good_chi=final.scal[_SC_CHI],
        reached=final.scal[_SC_REACH].astype(jnp.int32),
        error=final.scal[_SC_ERR].astype(jnp.int32),
        init_fail=init_fail,
    )


def _pad_to_tile(img: jax.Array, static: LevelStatic) -> jax.Array:
    """Zero-pad the trailing [H, W, C] image axes up to one tile."""
    pad_h = max(static.tile_h - img.shape[-3], 0)
    pad_w = max(static.tile_w - img.shape[-2], 0)
    if not (pad_h or pad_w):
        return img
    lead = [(0, 0)] * (img.ndim - 3)
    return jnp.pad(img, lead + [(0, pad_h), (0, pad_w), (0, 0)])


def prepare_levels(
    cfg: SolverConfig,
    und_pyramid: list[jax.Array],
    def_pyramid: list[jax.Array],
    xy_levels: list[jax.Array],
    mask_levels: list[jax.Array],
    center0: jax.Array,
    statics: dict[int, LevelStatic] | None = None,
    skip_def: bool = False,
) -> dict[int, LevelArrays]:
    """Build LevelArrays for every level in the schedule.

    Undeformed intensities are gathered once per level (iteration-invariant).
    xla backend (statics is None): deformed coefficient fields are
    precomputed once per level per frame — the batched analog of the
    reference's per-image memo cache (pyramid_class.cpp:364-414).
    xla_sep backend: the deformed image is zero-padded to one tile
    (skipped with skip_def, for callers that pad a whole stack at once).
    """
    out = {}
    for lvl in cfg.pyramid.levels_coarse_to_fine():
        xy = xy_levels[lvl]
        mask = mask_levels[lvl]
        # Per-level center = level-0 center / 2^level
        # (pyramid_class.cpp:349-362).
        center = center0 / jnp.float32(1 << lvl)
        und_w = sample_integer(und_pyramid[lvl], xy) * mask[..., None]
        n_points = jnp.sum(mask, axis=-1).astype(jnp.float32)
        # bbox + true image dims feed the MODEL_OUT_OF_IMAGE vs
        # INTERPOLATION_OUT_OF_IMAGE distinction for every backend.
        bbox = subset_bbox(xy, mask)
        img_hw = (
            int(def_pyramid[lvl].shape[0]),
            int(def_pyramid[lvl].shape[1]),
        )
        if statics is None:
            def_field = precompute_field(def_pyramid[lvl], cfg.interpolation)
            out[lvl] = LevelArrays(
                xy, mask, center, und_w, n_points, def_field=def_field,
                bbox=bbox, img_hw=img_hw,
            )
        else:
            img = (
                None if skip_def
                else _pad_to_tile(def_pyramid[lvl], statics[lvl])
            )
            out[lvl] = LevelArrays(
                xy, mask, center, und_w, n_points, def_img=img,
                bbox=bbox, img_hw=img_hw,
            )
    return out


def correlate_prepared(
    cfg: SolverConfig,
    levels: dict[int, LevelArrays],
    params0: jax.Array,
    center0: jax.Array,
    n_points0: jax.Array,
    statics: dict[int, LevelStatic] | None = None,
) -> CorrelationResult:
    """Coarse-to-fine solve given prepared per-level arrays.

    params0: [S, NP] initial guesses at level-0 scale.
    center0: [S, 2] level-0 subset centers (reported in the result).
    n_points0: [S] level-0 point counts (reported in the result,
      manager_class.cpp:2324).
    """
    schedule = cfg.pyramid.levels_coarse_to_fine()
    s = params0.shape[0]

    p = params0
    prev_level = 0
    frozen = jnp.zeros((s,), bool)
    final_params = jnp.zeros_like(params0)
    frozen_chi = jnp.zeros((s,), jnp.float32)
    frozen_error = jnp.zeros((s,), jnp.int32)
    chi = jnp.zeros((s,), jnp.float32)
    reached = jnp.zeros((s,), jnp.int32)
    error = jnp.zeros((s,), jnp.int32)

    for lvl in schedule:
        p = translate_params(p, prev_level, lvl)
        res = solve_level(
            cfg,
            levels[lvl],
            p,
            frozen,
            statics.get(lvl) if statics else None,
        )
        newly_frozen = res.init_fail & ~frozen
        # Init failure returns the untouched guess translated to level 0
        # (correlation_class.cpp:413-419).
        final_params = jnp.where(
            newly_frozen[:, None], translate_params(p, lvl, 0), final_params
        )
        frozen_chi = jnp.where(newly_frozen, res.last_good_chi, frozen_chi)
        frozen_error = jnp.where(newly_frozen, res.error, frozen_error)
        frozen = frozen | newly_frozen

        live = ~frozen
        p = jnp.where(live[:, None], res.params, p)
        chi = jnp.where(live, res.last_good_chi, chi)
        reached = jnp.where(live, res.reached, reached)
        error = jnp.where(live, res.error, error)
        prev_level = lvl

    params_out = jnp.where(
        frozen[:, None], final_params, translate_params(p, prev_level, 0)
    )
    chi_out = jnp.where(frozen, frozen_chi, chi)
    error_out = jnp.where(frozen, frozen_error, error)

    return CorrelationResult(
        params=params_out,
        chi=chi_out,
        iterations=reached,
        error=error_out,
        center=center0,
        n_points=n_points0.astype(jnp.int32),
    )


def _correlate_frames_impl(
    cfg,
    statics,
    ref_first: bool,
    stop_frame: bool,
    lagrangian: bool,
    float_centers: bool,
    frames_stack,  # [K+1, H, W, C] device frames (stack[0] = predecessor)
    xy,
    mask,
    center0,
    guess0,  # [S, NP] override guess for scan step `override_step`
    override_step,  # int32 scalar: -1 = never; 0 = first chunk
    p_seed,  # [S, NP] chained params entering the chunk
    prev_seed,  # [S, NP] params one frame earlier (const-velocity base)
    chi_seed,  # [S] previous chi (STOP_FRAME frozen-record values)
    it_seed,  # [S] previous iterations
    off_seed,  # [S, 2] cumulative integer domain offset (Lagrangian)
    ucen_seed,  # [S, 2] chained float und centers (Lagrangian)
):
    """Solve K consecutive frame pairs in ONE dispatch (lax.scan).

    The batched answer to the reference's frame loop + prefetch overlap
    (manager_class.cpp:1381-1475): pyramids for the whole chunk build
    in-jit (vmapped convs), and the per-call dispatch latency — which
    dominates a single-frame solve — amortizes over K frames.

    Initial-guess chaining reproduces manager_class.cpp:2672-2700: with
    ref_first (Eulerian + reference First) each frame's guess is the
    constant-velocity extrapolation p + (p - p_prev); otherwise the
    previous result.  Seeding p_seed = prev_seed = guess makes step 0 of
    a fresh sequence start exactly from the customized frame-0 guess.

    With `lagrangian`, the domain FOLLOWS the material in-scan: the
    reference's adjust_lagrangian_domain is a per-sector whole-pixel
    translate of a fixed point set (offset = the sector's (u, v) rounded
    via add_pair, manager_class.cpp:2018-2310, :38-47), so the scan
    carries a cumulative integer offset per sector and translates the
    frame-0 point arrays on device; centers accumulate the UNROUNDED
    (u, v) exactly like und_center <- def_center.  Level 0 is exact
    reference semantics (integer offsets).  Levels l >= 1 translate the
    frame-0 level-l point set by round(offset / 2^l) instead of
    re-selecting members by the %2^l rule against the shifted level-0
    set — same point count, sample positions within 2^(l-1) px of the
    re-selected set's; coarse levels only seed the finest level, so the
    deviation is below the solver's own precision (parity-tested against
    the per-frame driver in test_sequence.py).
    """
    from correlation_jax.ops.pyramid import build_pyramid

    statics_d = dict(statics) if statics else None
    # uint8 staging: file-backed sequences upload the chunk stack as
    # uint8 (4x fewer bytes over the host->device link) and convert
    # here — lossless for uint8-valued frames.
    frames_stack = frames_stack.astype(jnp.float32)
    k = frames_stack.shape[0] - 1
    pyr_stack = jax.vmap(
        lambda im: build_pyramid(im, cfg.pyramid.stop)
    )(frames_stack)
    n_points0 = jnp.sum(mask[0], axis=-1)

    # Hoist scan-invariant work.  The xla_sep tile padding runs ONCE for
    # the whole stack; with reference-First + fixed geometry the entire
    # subset side (und sampling, bbox) is frame-invariant too and leaves
    # the scan.
    schedule = cfg.pyramid.levels_coarse_to_fine()
    tiled = statics_d is not None
    prepped = {}
    if tiled:
        for lvl in schedule:
            prepped[lvl] = _pad_to_tile(pyr_stack[lvl], statics_d[lvl])
    base_levels = None
    und_pyr0 = [L[0] for L in pyr_stack] if ref_first else None
    if ref_first and not lagrangian:
        base_levels = prepare_levels(
            cfg, und_pyr0, und_pyr0, xy, mask, center0, statics_d,
            skip_def=tiled,
        )

    def frame_levels(i, off=None, ucen=None):
        """LevelArrays for pair i (def = stack[i+1])."""
        if base_levels is not None and tiled:
            return {
                lvl: base_levels[lvl]._replace(
                    def_img=jax.lax.dynamic_index_in_dim(
                        prepped[lvl], i + 1, keepdims=False
                    )
                )
                for lvl in schedule
            }
        if lagrangian:
            # Per-level integer translate of the frame-0 point sets by
            # the carried cumulative offset.  Centers: explicit (rect)
            # domains chain the FLOAT def centers (und_center <-
            # def_center, manager_class.cpp:2018-2310); point-mean
            # domains re-derive centers from the (integer-translated)
            # points, i.e. the frame-0 means + the integer offset.
            xy_i = [
                xy_l
                + jnp.floor(off / jnp.float32(1 << lvl) + 0.5)[:, None, :]
                for lvl, xy_l in enumerate(xy)
            ]
            center_i = ucen if float_centers else center0 + off
        else:
            xy_i, center_i = xy, center0
        und_pyr = (
            und_pyr0
            if ref_first
            else [
                jax.lax.dynamic_index_in_dim(L, i, keepdims=False)
                for L in pyr_stack
            ]
        )
        def_pyr = [
            jax.lax.dynamic_index_in_dim(L, i + 1, keepdims=False)
            for L in pyr_stack
        ]
        levels = prepare_levels(
            cfg, und_pyr, def_pyr, xy_i, mask, center_i, statics_d,
            skip_def=tiled,
        )
        if tiled:
            levels = {
                lvl: levels[lvl]._replace(
                    def_img=jax.lax.dynamic_index_in_dim(
                        prepped[lvl], i + 1, keepdims=False
                    )
                )
                for lvl in schedule
            }
        return levels

    def _uv_of(p):
        uv = p[:, :2]
        if uv.shape[1] < 2:
            uv = jnp.pad(uv, ((0, 0), (0, 2 - uv.shape[1])))
        return uv

    def body(carry, i):
        if lagrangian:
            p, prev, chi_c, it_c, off, ucen = carry
            # Domain advance for every step except the sequence's first
            # frame (advance_domain runs between frames): offset =
            # def_center - und_center = uv(params), points translate by
            # add_pair rounding, centers by the float uv.
            adv = (i != override_step).astype(jnp.float32)
            uvp = _uv_of(p)
            off = off + adv * jnp.floor(uvp + 0.5)
            ucen = ucen + adv * uvp
            guess = p
        else:
            p, prev, chi_c, it_c = carry
            off = ucen = None
            if ref_first:
                guess = p + (p - prev)
            else:
                guess = p
        guess = jnp.where(i == override_step, guess0, guess)
        if lagrangian:
            rec_center = ucen if float_centers else center0 + off
        else:
            rec_center = center0
        res = correlate_prepared(
            cfg,
            frame_levels(i, off, ucen),
            guess,
            rec_center,
            n_points0,
            statics_d,
        )
        if stop_frame:
            # Batched stop-frame: an errored sector's chained state does
            # not advance, and its emitted record keeps the previous
            # chi/iterations (plus the error code) — the batched analog
            # of the reference's skipped sectors retaining previous
            # values (manager_class.cpp:535-546).  At the sequence's
            # first frame the fallback is the zero-initialized host state
            # (initial_track_state), not the seeded guess.
            bad = res.error != jnp.int32(ErrorCode.NONE)
            fallback = jnp.where(
                i == override_step, jnp.zeros_like(p), p
            )
            p_new = jnp.where(bad[:, None], fallback, res.params)
            chi_new = jnp.where(bad, chi_c, res.chi)
            it_new = jnp.where(bad, it_c, res.iterations)
        else:
            p_new, chi_new, it_new = res.params, res.chi, res.iterations
        out = (p_new, guess, chi_new, it_new, res.error)
        if lagrangian:
            return (p_new, p, chi_new, it_new, off, ucen), out
        return (p_new, p, chi_new, it_new), out

    seed = (
        (p_seed, prev_seed, chi_seed, it_seed, off_seed, ucen_seed)
        if lagrangian
        else (p_seed, prev_seed, chi_seed, it_seed)
    )
    carry, ys = jax.lax.scan(
        body,
        seed,
        jnp.arange(k, dtype=jnp.int32),
    )
    # One packed f32 output so the host fetches the whole chunk's results
    # in a SINGLE device->host transfer instead of five.
    params, guess, chi, iters, error = ys
    # `guess` is excluded: the host reproduces it bit-exactly from the
    # chained params (p + (p - p_prev), pure f32 adds).
    packed = jnp.concatenate(
        [
            params,
            chi[..., None],
            iters.astype(jnp.float32)[..., None],
            error.astype(jnp.float32)[..., None],
        ],
        axis=-1,
    )  # [K, S, NP + 3]
    return carry, ys, packed


_correlate_frames_jit = functools.partial(
    jax.jit, static_argnums=(0, 1, 2, 3, 4, 5)
)(_correlate_frames_impl)


@functools.lru_cache(maxsize=None)
def _correlate_frames_shardmap_fn(cfg, statics, ref_first, stop_frame,
                                  lagrangian, float_centers, mesh):
    """jit(shard_map) over the chained multi-frame solve: each device runs
    the full K-pair scan on its subset shard (pure data parallelism over
    sectors — frames replicate, no collectives in the shard bodies, and
    every device's LM loops stop on its own shard's convergence)."""
    from jax.sharding import PartitionSpec as P

    from correlation_jax.parallel.mesh import SUBSET_AXIS

    rep, sub = P(), P(SUBSET_AXIS)
    ksub = P(None, SUBSET_AXIS)  # [K, S, ...] outputs
    carry_spec = (sub,) * (6 if lagrangian else 4)

    def local(frames_stack, xy, mask, center0, guess0, override_step,
              p_seed, prev_seed, chi_seed, it_seed, off_seed, ucen_seed):
        return _correlate_frames_impl(
            cfg, statics, ref_first, stop_frame, lagrangian, float_centers,
            frames_stack, xy, mask, center0, guess0, override_step, p_seed,
            prev_seed, chi_seed, it_seed, off_seed, ucen_seed,
        )

    return jax.jit(
        jax.shard_map(
            local,
            mesh=mesh,
            in_specs=(rep, sub, sub, sub, sub, rep, sub, sub, sub, sub,
                      sub, sub),
            out_specs=(carry_spec, (ksub,) * 5, ksub),
            check_vma=False,
        )
    )


def correlate_frames(
    cfg: SolverConfig,
    frames_stack,
    subsets,
    guess0,
    *,
    reference_first: bool = True,
    stop_frame: bool = False,
    lagrangian: bool = False,
    float_centers: bool = True,
    first_chunk: bool = True,
    p_seed=None,
    prev_seed=None,
    chi_seed=None,
    it_seed=None,
    off_seed=None,
    ucen_seed=None,
    mesh=None,
) -> dict:
    """Chained Eulerian multi-frame solve (one dispatch for K pairs).

    Args:
      cfg: solver configuration.
      frames_stack: [K+1, H, W, C] images — element 0 is the chunk's
        undeformed base (sequence frame 0 for reference-First, the
        preceding frame otherwise); elements 1..K are the deformed frames.
      subsets: a domains.SubsetBatch (fixed geometry across the chunk).
      guess0: [S, NP] the frame-0 initial guess (used when first_chunk).
      reference_first: ReferenceImage.FIRST semantics (und = stack[0]
        for every pair + constant-velocity guess extrapolation).
      stop_frame: ErrorMode.STOP_FRAME freezing inside the chain.
      lagrangian: DeformationDescription.LAGRANGIAN — the domain follows
        the material in-scan (per-sector integer translate of the
        frame-0 point sets carried on device; see _correlate_frames_impl).
        `subsets` must hold the SEQUENCE-START geometry; off_seed /
        ucen_seed carry the accumulated offset / centers entering the
        chunk (defaults: zeros / subsets.center0).
      first_chunk: this chunk starts the sequence (step 0 uses guess0).
      p_seed/prev_seed/chi_seed/it_seed: chained state entering the chunk
        (from the previous chunk's outputs); default zeros.
      mesh: optional jax.sharding.Mesh — the subset axis shards across
        it (frames replicate; each device scans its shard).

    Returns dict with stacked per-frame arrays: params, guess, chi,
    iterations, error ([K, ...]) and the carry for the next chunk.
    """
    frames_stack = jnp.asarray(frames_stack)
    statics = _statics_for(cfg, subsets, frames_stack.shape[1:3])
    orig_s = subsets.num_subsets
    if lagrangian:
        if off_seed is None:
            off_seed = np.zeros((orig_s, 2), np.float32)
        if ucen_seed is None:
            ucen_seed = jnp.asarray(subsets.center0, jnp.float32)
    else:
        # Unused by the Eulerian scan (static flag) but still jit
        # operands — keep them tiny constants.
        off_seed = np.zeros((orig_s, 2), np.float32)
        ucen_seed = np.zeros((orig_s, 2), np.float32)
    if mesh is not None:
        from jax.sharding import NamedSharding, PartitionSpec as _P

        from correlation_jax.parallel.mesh import (
            SUBSET_AXIS,
            pad_to_mesh,
            replicate,
            shard_inputs,
        )

        guess0 = np.asarray(guess0, np.float32)
        subsets = pad_to_mesh(subsets, mesh)
        pad_n = subsets.num_subsets - orig_s

        def _pad_s(a):
            if a is None:
                return None
            a = np.asarray(a)
            return np.pad(a, [(0, pad_n)] + [(0, 0)] * (a.ndim - 1))

        guess0 = _pad_s(guess0)
        p_seed = _pad_s(p_seed)
        prev_seed = _pad_s(prev_seed)
        chi_seed = _pad_s(chi_seed)
        it_seed = _pad_s(it_seed)
        off_seed = _pad_s(off_seed)
        ucen_seed = _pad_s(ucen_seed)
        xy, mask, center0, guess0 = shard_inputs(mesh, subsets, guess0)
        frames_stack = replicate(mesh, frames_stack)
        _sh = NamedSharding(mesh, _P(SUBSET_AXIS))

        def _put(a, dtype):
            return (
                None if a is None
                else jax.device_put(np.asarray(a, dtype), _sh)
            )

        p_seed = _put(p_seed, np.float32)
        prev_seed = _put(prev_seed, np.float32)
        chi_seed = _put(chi_seed, np.float32)
        it_seed = _put(it_seed, np.int32)
        off_seed = _put(off_seed, np.float32)
        ucen_seed = _put(ucen_seed, np.float32)
    else:
        xy = [jnp.asarray(a) for a in subsets.xy]
        mask = [jnp.asarray(a) for a in subsets.mask]
        center0 = jnp.asarray(subsets.center0)
        guess0 = jnp.asarray(guess0, jnp.float32)
    s = subsets.num_subsets
    if first_chunk:
        # Seeding p = prev = guess reproduces the host chain exactly:
        # guess_1 = p0 + (p0 - guess0) (manager_class.cpp:2677-2686 with
        # prev_params still holding the initial guess).
        p_seed = guess0 if p_seed is None else jnp.asarray(p_seed)
        prev_seed = guess0 if prev_seed is None else jnp.asarray(prev_seed)
        override = jnp.int32(0)
    else:
        p_seed = jnp.asarray(p_seed)
        prev_seed = jnp.asarray(prev_seed)
        override = jnp.int32(-1)
    chi_seed = (
        jnp.zeros((s,), jnp.float32) if chi_seed is None
        else jnp.asarray(chi_seed)
    )
    it_seed = (
        jnp.zeros((s,), jnp.int32) if it_seed is None
        else jnp.asarray(it_seed, jnp.int32)
    )
    off_seed = jnp.asarray(off_seed, jnp.float32)
    ucen_seed = jnp.asarray(ucen_seed, jnp.float32)
    static_args = (
        cfg, statics, reference_first, stop_frame, lagrangian, float_centers
    )
    if mesh is not None:
        fn = _correlate_frames_shardmap_fn(*static_args, mesh)
    else:
        fn = functools.partial(_correlate_frames_jit, *static_args)
    carry, ys, packed = fn(
        frames_stack, xy, mask, center0, guess0, override,
        p_seed, prev_seed, chi_seed, it_seed, off_seed, ucen_seed,
    )
    if subsets.num_subsets != orig_s:
        ys = tuple(a[:, :orig_s] for a in ys)
        packed = packed[:, :orig_s]
        carry = tuple(a[:orig_s] for a in carry)
    params, guess, chi, iters, error = ys
    return {
        "params": params,
        "guess": guess,
        "chi": chi,
        "iterations": iters,
        "error": error,
        "packed": packed,  # [K, S, NP+3]: one-transfer host fetch
        "carry": carry,
        "center0": center0,
        "n_points0": jnp.sum(mask[0], axis=-1).astype(jnp.int32),
    }


@functools.partial(jax.jit, static_argnums=(0, 1))
def _correlate_many_jit(cfg, statics_all, und_pyramid, def_pyramid, doms):
    """One traced program solving several independent domains (shared
    frame pair), packing every domain's results into ONE array so the
    host pays a single readback."""
    packed = []
    for statics, (xy, mask, center0, params0) in zip(statics_all, doms):
        statics_d = dict(statics) if statics else None
        levels = prepare_levels(
            cfg, und_pyramid, def_pyramid, list(xy), list(mask), center0,
            statics_d,
        )
        n_points0 = jnp.sum(mask[0], axis=-1)
        res = correlate_prepared(
            cfg, levels, params0, center0, n_points0, statics_d
        )
        packed.append(
            jnp.concatenate(
                [
                    res.params,
                    res.chi[:, None],
                    res.iterations.astype(jnp.float32)[:, None],
                    res.error.astype(jnp.float32)[:, None],
                ],
                axis=-1,
            )
        )
    return jnp.concatenate(packed, axis=0)  # [S_total, NP+3]


def correlate_many(
    cfg: SolverConfig,
    und_pyramid,
    def_pyramid,
    batches,
    params0_list,
) -> list[CorrelationResult]:
    """Solve several INDEPENDENT domains over one frame pair in ONE
    dispatch.

    The complement of domains.combine_batches for heterogeneous ROIs:
    combine_batches concatenates same-shaped sectors into one batch,
    but a large blob next to small annular sectors would inflate
    every subset's tile to the blob's extent.  Here each domain keeps
    its OWN per-level tile statics — the domains solve sequentially
    inside one traced program, the fixed per-dispatch cost is paid
    once, and all results return in a single packed transfer.
    (The reference solves sectors serially with one kernel launch each,
    manager_class.cpp:304-547 — this is strictly beyond it.)

    Args:
      cfg: shared solver configuration.
      und_pyramid / def_pyramid: shared frame-pair pyramids.
      batches: list of domains.SubsetBatch.
      params0_list: per-domain [S_i, NP] initial guesses.

    Returns:
      One CorrelationResult per domain.
    """
    img_hw = def_pyramid[0].shape[:2]
    statics_all = tuple(_statics_for(cfg, b, img_hw) for b in batches)
    und_pyramid = [jnp.asarray(a) for a in und_pyramid]
    def_pyramid = [jnp.asarray(a) for a in def_pyramid]
    doms = tuple(
        (
            tuple(jnp.asarray(a) for a in b.xy),
            tuple(jnp.asarray(a) for a in b.mask),
            jnp.asarray(b.center0),
            jnp.asarray(p0, jnp.float32),
        )
        for b, p0 in zip(batches, params0_list)
    )
    packed = np.asarray(
        _correlate_many_jit(
            cfg, statics_all, und_pyramid, def_pyramid, doms
        )
    )
    num_p = cfg.num_params
    out = []
    start = 0
    for b in batches:
        s = b.num_subsets
        rows = packed[start : start + s]
        start += s
        mask0 = b.mask[0]
        if isinstance(mask0, np.ndarray):
            n_pts = mask0.sum(axis=1).astype(np.int32)
            center = np.asarray(b.center0)
        else:
            # Device-resident batch: keep these lazy device values rather
            # than forcing two more readbacks beside the packed transfer.
            n_pts = jnp.sum(mask0, axis=-1).astype(jnp.int32)
            center = b.center0
        out.append(
            CorrelationResult(
                params=rows[:, :num_p],
                chi=rows[:, num_p],
                iterations=rows[:, num_p + 1].astype(np.int32),
                error=rows[:, num_p + 2].astype(np.int32),
                center=center,
                n_points=n_pts,
            )
        )
    return out


@functools.partial(jax.jit, static_argnums=(0, 1))
def _correlate_jit(
    cfg, statics, und_pyramid, def_pyramid, xy, mask, center0, params0
):
    statics_d = dict(statics) if statics else None
    levels = prepare_levels(
        cfg, und_pyramid, def_pyramid, xy, mask, center0, statics_d
    )
    n_points0 = jnp.sum(mask[0], axis=-1)
    return correlate_prepared(
        cfg, levels, params0, center0, n_points0, statics_d
    )


@functools.lru_cache(maxsize=None)
def _correlate_shardmap_fn(cfg, statics, mesh):
    """jit(shard_map) wrapper: each device runs the full LM program on its
    subset shard — pure data parallelism over sectors (SURVEY.md §2.3-5),
    so the shard bodies need no collectives and per-shard while_loops
    stop independently."""
    from jax.sharding import PartitionSpec as P

    from correlation_jax.parallel.mesh import SUBSET_AXIS

    rep, sub = P(), P(SUBSET_AXIS)
    return jax.jit(
        jax.shard_map(
            functools.partial(_correlate_jit, cfg, statics),
            mesh=mesh,
            in_specs=(rep, rep, sub, sub, sub, sub),
            out_specs=sub,
            check_vma=False,
        )
    )


_BACKENDS = ("auto", "xla_sep", "xla")
# auto's choice on a GPU, timed against the other backend on the card
# (PERF.md "Assembly backend on the card").
_GPU_AUTO_BACKEND = "xla"


def resolve_backend(cfg: SolverConfig) -> str:
    """Pick the assembly backend.

    "xla" samples a precomputed coefficient field with one gather per
    pixel; "xla_sep" builds separable weight rows against per-subset
    tiles and contracts them with batched matmuls (no gathers, but
    O(tile) work per pixel).  auto = the one measured faster on a GPU,
    xla_sep elsewhere.
    """
    if cfg.backend not in _BACKENDS:
        raise ValueError(
            f"unknown backend {cfg.backend!r}; expected one of {_BACKENDS}"
        )
    if cfg.backend != "auto":
        return cfg.backend
    if jax.default_backend() == "gpu":
        return _GPU_AUTO_BACKEND
    return "xla_sep"


def compute_level_statics(
    cfg: SolverConfig, subsets, img_hw
) -> tuple[tuple[int, LevelStatic], ...]:
    """Host-side static tile dims per level for the xla_sep backend.

    img_hw: level-0 (H, W); level l is (H >> l, W >> l) (ops/pyramid.py).
    """
    h0, w0 = int(img_hw[0]), int(img_hw[1])
    out = []
    for lvl in cfg.pyramid.levels_coarse_to_fine():
        if subsets.extents is not None:
            ext_y, ext_x = subsets.extents[lvl]
        else:
            # Fallback for hand-built batches; forces a device->host read
            # when the arrays are device-resident.
            xy = np.asarray(subsets.xy[lvl])
            mask = np.asarray(subsets.mask[lvl])
            if mask.any():
                mins = np.where(mask[..., None], xy, np.inf).min(axis=1)
                maxs = np.where(mask[..., None], xy, -np.inf).max(axis=1)
                span = np.max(np.where(mask.any(axis=1)[:, None],
                                       maxs - mins, 0.0), axis=0)
                ext_x, ext_y = int(np.ceil(span[0])), int(np.ceil(span[1]))
            else:
                ext_x = ext_y = 1
        h, w = h0 >> lvl, w0 >> lvl
        hp, wp = -(-h // 8) * 8, -(-w // 8) * 8
        th, tw = choose_tile(ext_y, ext_x, hp, wp, cfg.tile_margin)
        out.append((lvl, LevelStatic(th, tw, h, w)))
    return tuple(out)


def _statics_for(cfg: SolverConfig, subsets, img_hw):
    """Level statics for the resolved backend (None for xla)."""
    if resolve_backend(cfg) == "xla":
        return None
    return compute_level_statics(cfg, subsets, img_hw)


def correlate(
    cfg: SolverConfig,
    und_pyramid,
    def_pyramid,
    subsets,
    params0,
    mesh=None,
) -> CorrelationResult:
    """End-to-end batched correlation of one frame pair.

    Args:
      cfg: solver configuration.
      und_pyramid / def_pyramid: lists of [H_l, W_l, C] float32 images
        (see ops.pyramid.build_pyramid).
      subsets: a domains.SubsetBatch.
      params0: [S, NP] initial guesses (level-0 scale).
      mesh: optional jax.sharding.Mesh (parallel.mesh.make_mesh) — the
        subset axis shards across it (data parallelism over sectors,
        SURVEY.md §2.3-5); images replicate and each device solves its
        shard with no collectives.

    Returns:
      CorrelationResult (always with the caller's S subsets — mesh padding
      is added and stripped internally).
    """
    statics = _statics_for(cfg, subsets, def_pyramid[0].shape[:2])
    orig_s = subsets.num_subsets
    if mesh is not None:
        from correlation_jax.parallel.mesh import (
            pad_to_mesh,
            replicate,
            shard_inputs,
        )

        params0 = np.asarray(params0, np.float32)
        subsets = pad_to_mesh(subsets, mesh)
        if params0.shape[0] != subsets.num_subsets:
            params0 = np.pad(
                params0,
                ((0, subsets.num_subsets - orig_s), (0, 0)),
            )
        xy, mask, center0, params = shard_inputs(mesh, subsets, params0)
        und_pyramid = replicate(
            mesh, [jnp.asarray(a) for a in und_pyramid]
        )
        def_pyramid = replicate(
            mesh, [jnp.asarray(a) for a in def_pyramid]
        )
        fn = _correlate_shardmap_fn(cfg, statics, mesh)
    else:
        # jnp.asarray is a no-op on device-resident inputs — callers that
        # reuse a batch across calls (sequence driver, bench) pass
        # SubsetBatch.to_device() output and pay the transfer only once.
        xy = [jnp.asarray(a) for a in subsets.xy]
        mask = [jnp.asarray(a) for a in subsets.mask]
        center0 = jnp.asarray(subsets.center0)
        params = jnp.asarray(params0, jnp.float32)
        und_pyramid = [jnp.asarray(a) for a in und_pyramid]
        def_pyramid = [jnp.asarray(a) for a in def_pyramid]
        fn = functools.partial(_correlate_jit, cfg, statics)
    res = fn(und_pyramid, def_pyramid, xy, mask, center0, params)
    if res.params.shape[0] != orig_s:
        res = CorrelationResult(*[r[:orig_s] for r in res])
    return res

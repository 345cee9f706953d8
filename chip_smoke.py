"""Smoke test of the DIC solve on the GPU, from image files to the report.

Usage:
  python chip_smoke.py               # phases 1-5 on one GPU
  python chip_smoke.py --four-cards  # the sharded path on four GPUs

Phases (one process; any failure stops the run with a non-zero exit):
  1. device: a GPU is required — the script never runs on the CPU;
  2. main path: 33 seeded 1024x1024 speckle PNGs drifting (0.31, -0.22)
     px per frame through `python -m correlation_jax.cli` (4096 sectors,
     affine, bicubic, 3-level pyramid, Eulerian, reference first), checked
     against the known drift from the CSV report;
  3. other paths: chained Lagrangian (reference previous, 9 frames), one
     annular and one blob pair, each checked against the known drift;
  4. oracle: every pyramid level against its exact reference, and the LM
     solve and both assembly backends against tests/oracle.py for all 4
     models x 3 interpolations on 32 subsets of 21x21 px;
  5. backends: xla against xla_sep at the bench.py shape and the
     16-sector sequence shape, each timed; the compaction cascade against
     the monolithic LM loop.
With --four-cards only the sharded path runs: run_sequence and correlate
over a 4-device mesh against one device, the pixel-sharded assembly
against the unsharded one, and the collectives each mesh route compiles.

Every timing line carries the card's name and power limit.  The last line
of stdout is one JSON object: {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import csv
import dataclasses
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]

DRIFT = (0.31, -0.22)  # px per frame
SIDE = 1024  # frame width and height
N_FRAMES = 33
SUBDIV = 64  # rect domain: SUBDIV x SUBDIV sectors inside a 32 px margin
BENCH_SUBSETS = 4096  # bench.py shape
BENCH_CHUNK = 64
ORACLE_SUBSETS = 32
SOLVE = ["--model", "affine", "--interp", "bicubic", "--pyramid", "0", "1",
         "2"]
MODELS = ("u", "uv", "uvq", "affine")
INTERPS = ("nearest", "bilinear", "bicubic")

CARD = "?"


def log(*args) -> None:
    print(*args, flush=True)


def timed(label: str, seconds: float, extra: str = "") -> None:
    log(f"  [{CARD}] {label}: {seconds:.3f} s{extra}")


def card_lines() -> list[str]:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout
    return [ln.strip() for ln in out.splitlines() if ln.strip()]


def require_gpu():
    """Phase 1: the first JAX device must be a GPU; exit non-zero
    otherwise (never carry on on the CPU)."""
    import jax

    platform = jax.devices()[0].platform
    if platform != "gpu":
        sys.exit(f"chip_smoke: needs a GPU, JAX found {platform!r}")
    return jax.devices()


# ---------------------------------------------------------------------------
# helpers


def rect_args() -> list[str]:
    hi = str(SIDE - 32)
    return ["--rect", "32", "32", hi, hi,
            "--subdivisions", str(SUBDIV), str(SUBDIV)]


def rect_sectors():
    """(point lists, centers) of the rect_args() domain."""
    from correlation_jax import domains

    dom = domains.RectangularDomain(
        32, 32, SIDE - 32, SIDE - 32,
        horizontal_subdivisions=SUBDIV, vertical_subdivisions=SUBDIV,
    )
    cs, xdim, ydim = domains.rectangular_sectors(dom)
    pts = [domains.rectangular_points(int(c[0]), int(c[1]), xdim, ydim)
           for c in cs]
    return pts, cs


def write_frames(tmp: str, n: int) -> list[str]:
    """n seeded speckle PNGs, frame t translated by t * DRIFT."""
    from correlation_jax.io import save_png
    from synthetic import Speckle

    spk = Speckle(SIDE, SIDE, seed=2024)
    paths = []
    for t in range(n):
        img = spk.shifted_image(DRIFT[0] * t, DRIFT[1] * t, quantize=True)
        path = os.path.join(tmp, f"frame_{t:03d}.png")
        save_png(path, img.astype(np.uint8))
        paths.append(path)
    return paths


def run_cli(argv: list[str], report: str) -> float:
    from correlation_jax.cli import main

    t0 = time.perf_counter()
    rc = main(argv + ["--report", report])
    dt = time.perf_counter() - t0
    if rc != 0:
        raise RuntimeError(f"cli exited with {rc}: {argv}")
    return dt


def read_report(path: str):
    """(frame [R], params [R, NP], error_code [R]) from a CSV report."""
    with open(path) as f:
        rows = list(csv.DictReader(f))
    num_p = sum(1 for k in rows[0] if k.startswith("parameter_"))
    frame = np.array([int(r["Frame#"]) for r in rows])
    params = np.array(
        [[float(r[f"parameter_{i}"]) for i in range(num_p)] for r in rows]
    )
    err = np.array([int(r["error_code"]) for r in rows])
    return frame, params, err


def check_drift(label, report, truth, tol=0.02, min_ok=0.995):
    """Per frame: median (u, v) within tol of truth(frame); at least
    min_ok of the sectors converged (error 0) or hit max_iters (3); all
    parameters finite."""
    frame, params, err = read_report(report)
    if not np.isfinite(params).all():
        raise AssertionError(f"{label}: non-finite parameters")
    ok = np.isin(err, (0, 3)).mean()
    worst = 0.0
    for f in np.unique(frame):
        med = np.median(params[frame == f, :2], axis=0)
        worst = max(worst, float(np.abs(med - truth(f)).max()))
    log(f"  {label}: {len(np.unique(frame))} frame pairs x "
        f"{(frame == frame[0]).sum()} sectors, worst median error "
        f"{worst:.5f} px, converged-or-max_iters share {ok:.5f}")
    if worst > tol:
        raise AssertionError(f"{label}: median error {worst} > {tol} px")
    if ok < min_ok:
        raise AssertionError(f"{label}: only {ok:.4f} of sectors ok")
    return frame, params, err


def compare_runs(label, p_ref, p_got, e_ref, e_got, tol=1e-3,
                 share=0.999):
    """Sharded against one-card results ([frames, sectors, ...]): at
    least `share` of the records within tol px and with equal error
    codes; prints the worst record."""
    dp = np.abs(p_ref - p_got).max(axis=-1)
    close = float((dp <= tol).mean())
    same = float((e_ref == e_got).mean())
    f, i = np.unravel_index(np.argmax(dp), dp.shape)
    log(f"  {label} mesh vs one card: {close:.5f} of records within {tol} "
        f"px, error codes equal on {same:.5f} (tolerance: {share} each); "
        f"median |dp| {np.median(dp):.2e}; worst record frame {f} sector "
        f"{i}: |dp| {dp[f, i]:.2e}, errors {e_ref[f, i]} / {e_got[f, i]}")
    if close < share or same < share:
        raise AssertionError(f"sharded {label} disagrees")


def _block(tree):
    import jax

    return jax.block_until_ready(tree)


# ---------------------------------------------------------------------------
# phases


def phase_main_path(tmp: str, paths: list[str]) -> None:
    log("phase 2: main path from files (cli.main)")
    argv = paths + rect_args() + SOLVE
    n_sec = SUBDIV * SUBDIV
    cold = run_cli(argv, os.path.join(tmp, "eulerian_cold.csv"))
    warm = run_cli(argv, os.path.join(tmp, "eulerian.csv"))
    pairs = len(paths) - 1
    check_drift(
        "eulerian/first", os.path.join(tmp, "eulerian.csv"),
        lambda f: np.array(DRIFT) * (f + 1),
    )
    timed("cli cold run (compile + one pass)", cold)
    timed("compile and first-call set-up (cold - warm)", cold - warm)
    timed("cli warm run, files to report", warm,
          f" = {warm / pairs * 1e3:.2f} ms/frame, "
          f"{n_sec * pairs / warm:.1f} solves/s")

    # The same sequence without the CSV writing: decode + solve only
    # (SequenceConfig's defaults are the CLI's: affine, bicubic, 0/1/2).
    from correlation_jax.sequence import (
        SequenceConfig,
        run_sequence_from_files,
    )

    pts, cs = rect_sectors()
    t0 = time.perf_counter()
    recs = run_sequence_from_files(paths, pts, SequenceConfig(), centers=cs)
    dt = time.perf_counter() - t0
    if len(recs) != pairs:
        raise AssertionError(f"{len(recs)} records for {pairs} pairs")
    timed("run_sequence_from_files warm (decode + solve)", dt,
          f" = {dt / pairs * 1e3:.2f} ms/frame, "
          f"{len(pts) * pairs / dt:.1f} solves/s")


def phase_other_paths(tmp: str, paths: list[str]) -> None:
    log("phase 3: other paths")
    rpt = os.path.join(tmp, "lagrangian.csv")
    dt = run_cli(
        paths[:9] + rect_args() + SOLVE
        + ["--deformation", "lagrangian", "--reference", "previous"], rpt,
    )
    check_drift("lagrangian/previous", rpt, lambda f: np.array(DRIFT))
    timed(f"lagrangian {len(paths[:9]) - 1} pairs, cold", dt)

    c = SIDE / 2
    rpt = os.path.join(tmp, "annular.csv")
    dt = run_cli(
        paths[:2] + SOLVE
        + ["--domain", "annular", "--annulus", str(c), str(c),
           str(SIDE * 100 / 1024), str(SIDE * 400 / 1024),
           "--annular-subdivisions", "4", "16"], rpt,
    )
    check_drift("annular", rpt, lambda f: np.array(DRIFT), min_ok=1.0)
    timed("annular 64 sectors, cold", dt)

    theta = np.linspace(0, 2 * np.pi, 24, endpoint=False)
    contour = np.stack(
        [c + SIDE * 0.15 * np.cos(theta), c + SIDE * 0.11 * np.sin(theta)],
        -1,
    )
    blob_csv = os.path.join(tmp, "blob.csv")
    np.savetxt(blob_csv, contour, delimiter=",")
    rpt = os.path.join(tmp, "blob.csv.report")
    dt = run_cli(paths[:2] + SOLVE + ["--domain", "blob", "--blob", blob_csv],
                 rpt)
    check_drift("blob", rpt, lambda f: np.array(DRIFT), min_ok=1.0)
    timed("blob one subset, cold", dt)


def phase_oracle(paths: list[str]) -> None:
    log("phase 4: oracle parity")
    import jax.numpy as jnp

    import oracle
    from correlation_jax import engine
    from correlation_jax.config import PyramidConfig, SolverConfig
    from correlation_jax.cli import _MODELS, _INTERPS
    from correlation_jax.domains import make_batch, rectangular_points
    from correlation_jax.io import load_image
    from correlation_jax.ops.assemble import (
        assemble_normal_equations,
        assemble_normal_equations_tiles,
    )
    from correlation_jax.ops.interp import precompute_field, sample_integer
    from correlation_jax.ops.pyramid import build_pyramid
    from test_pyramid import _reference_downsample

    und = load_image(paths[0])
    dfm = load_image(paths[1])
    pyr_u = build_pyramid(jnp.asarray(und), 2)
    pyr_d = build_pyramid(jnp.asarray(dfm), 2)

    # Every pyramid level against the exact reference semantics.
    mismatches = 0
    for img, pyr in ((und, pyr_u), (dfm, pyr_d)):
        ref = img[..., 0]
        for lvl in (1, 2):
            ref = _reference_downsample(ref)
            mismatches += int((np.asarray(pyr[lvl])[..., 0] != ref).sum())
    log(f"  pyramid levels 1-2 of two {SIDE}^2 frames: {mismatches} "
        "mismatching pixels")
    if mismatches:
        raise AssertionError(f"pyramid: {mismatches} mismatches")

    und_np = [np.asarray(a)[..., 0].astype(np.float64) for a in pyr_u]
    def_np = [np.asarray(a)[..., 0].astype(np.float64) for a in pyr_d]
    n_sub = ORACLE_SUBSETS
    rng = np.random.default_rng(7)
    centers = rng.integers(64, SIDE - 64, (n_sub, 2)).astype(np.float32)
    pts = [rectangular_points(int(cx), int(cy), 10, 10) for cx, cy in centers]
    batch = make_batch(pts, centers, 2)
    xy0 = jnp.asarray(batch.xy[0])
    mask0 = jnp.asarray(batch.mask[0])
    und_w0 = sample_integer(pyr_u[0], xy0) * mask0[..., None]
    onames = {"u": "U", "uv": "UV", "uvq": "UVQ", "affine": "AFFINE"}
    worst_p = worst_chi = worst_asm = 0.0
    it_mismatch = 0
    near64 = dict.fromkeys(MODELS, 0)  # nearest: off with float64 positions
    near32 = {"float32": 0, "float32_fma": 0}  # matched with float32 ones
    t0 = time.perf_counter()
    for mname in MODELS:
        for iname in INTERPS:
            cfg = SolverConfig(
                model=_MODELS[mname], interpolation=_INTERPS[iname],
                pyramid=PyramidConfig(0, 1, 2),
            )
            num_p = cfg.num_params
            res = engine.correlate(cfg, pyr_u, pyr_d, batch,
                                   np.zeros((n_sub, num_p), np.float32))
            got_p = np.asarray(res.params)
            got_chi = np.asarray(res.chi)
            got_it = np.asarray(res.iterations)
            got_err = np.asarray(res.error)
            for i in range(n_sub):

                def solve(positions):
                    return oracle.newton_raphson(
                        onames[mname], iname, und_np, def_np,
                        pts[i].astype(np.float64), np.zeros(num_p),
                        center0=centers[i].astype(np.float64),
                        levels=(2, 1, 0), positions=positions,
                    )

                def gap(out):
                    dp = float(np.abs(got_p[i] - out["params"]).max())
                    dchi = abs(float(got_chi[i]) - out["chi"]) / max(
                        abs(out["chi"]), 1.0)
                    return dp, dchi

                out = solve("float64")
                dp, dchi = gap(out)
                if iname == "nearest":
                    # Nearest sampling jumps at half pixels: a float32
                    # position within its resolution of one can round to
                    # the other pixel than the float64 oracle's and send
                    # the LM path elsewhere.  Compare with the oracle's
                    # positions rounded like the device's (products
                    # rounded, or fused into the add as with FMA).
                    near64[mname] += int(dp > 5e-4 or dchi > 1e-3)
                    for positions in ("float32", "float32_fma"):
                        out = solve(positions)
                        dp, dchi = gap(out)
                        if dp <= 5e-4 and dchi <= 1e-3:
                            near32[positions] += 1
                            break
                if out["error"] not in (None, "max_iters"):
                    raise AssertionError(
                        f"{mname}/{iname} subset {i}: oracle {out['error']}"
                    )
                if got_err[i] not in (0, 3):
                    raise AssertionError(
                        f"{mname}/{iname} subset {i}: error {got_err[i]}"
                    )
                worst_p = max(worst_p, dp)
                worst_chi = max(worst_chi, dchi)
                it_mismatch += int(got_it[i] != out["iterations"])
                if dp > 5e-4 or dchi > 1e-3:
                    raise AssertionError(
                        f"{mname}/{iname} subset {i}: |dp| {dp:.2e}, chi "
                        f"rel {dchi:.2e}, iterations {got_it[i]} vs "
                        f"{out['iterations']}"
                    )

            # Level-0 assembly of both backends away from the answer (b
            # is not a near-cancelled sum there), at dyadic parameters:
            # the warped positions are then exact in float32 as in
            # float64 (at x ~ 1000 a float32 position is otherwise only
            # good to 6e-5 px), so what is compared is the sampling and
            # the sums, and nearest rounding cannot differ.
            p_np = np.zeros((n_sub, num_p), np.float32)
            p_np[:, 0] = 13 / 32
            if num_p > 1:
                p_np[:, 1] = -9 / 32
            p_np[:, 2:] = rng.integers(-4, 5, (n_sub, max(num_p - 2, 0)))
            p_np[:, 2:] /= 1024
            p_eval = jnp.asarray(p_np)
            field = precompute_field(pyr_d[0], cfg.interpolation)
            asm = {
                "xla": assemble_normal_equations(
                    cfg.model, cfg.interpolation, field, und_w0, xy0, mask0,
                    jnp.asarray(batch.center0), p_eval,
                ),
            }
            st = dict(engine.compute_level_statics(cfg, batch, (SIDE, SIDE)))
            st0 = st[0]
            asm["xla_sep"] = assemble_normal_equations_tiles(
                cfg.model, cfg.interpolation,
                engine._pad_to_tile(pyr_d[0], st0), st0.img_h, st0.img_w,
                st0.tile_h, st0.tile_w, und_w0, xy0, mask0,
                jnp.asarray(batch.center0), p_eval,
            )
            for name, (a, b, chi, err) in asm.items():
                a, b, chi = np.asarray(a), np.asarray(b), np.asarray(chi)
                for i in range(n_sub):
                    oa, ob, ochi, oerr = oracle.assemble(
                        onames[mname], iname, und_np[0], def_np[0],
                        pts[i].astype(np.float64), float(centers[i, 0]),
                        float(centers[i, 1]), p_np[i].astype(np.float64),
                    )
                    if bool(err[i]) != oerr:
                        raise AssertionError(
                            f"{mname}/{iname} {name} subset {i}: "
                            f"out-of-image flag {bool(err[i])} vs {oerr}"
                        )
                    # rtol 2e-4 as in tests/test_assemble.py; an element
                    # that cancels to far below its terms (b_i of a 441-px
                    # affine subset) may instead sit within 2e-5 of its
                    # Cauchy-Schwarz scale: float32 sums over 441 terms
                    # carry that much (measured <= 5e-6).
                    diag = np.diag(oa)
                    for what, got, want, scale in (
                        ("chi", chi[i], ochi, 0.0),
                        ("b", b[i], ob, np.sqrt(diag * ochi)),
                        ("A", a[i], oa, np.sqrt(np.outer(diag, diag))),
                    ):
                        off = np.abs(got - want) - 2e-4 * np.abs(want)
                        if np.any(off > 2e-5 * scale):
                            raise AssertionError(
                                f"{mname}/{iname} {name} subset {i} {what}:"
                                f" {got} vs oracle {want}"
                            )
                    worst_asm = max(
                        worst_asm, abs(float(chi[i]) - ochi) / max(ochi, 1.0)
                    )
    log(f"  LM vs oracle, 4 models x 3 interpolations x {n_sub} subsets: "
        f"worst |dp| {worst_p:.2e} px (tol 5e-4), worst chi rel "
        f"{worst_chi:.2e} (tol 1e-3), iteration-count mismatches "
        f"{it_mismatch}/{12 * n_sub}")
    log(f"  nearest: subsets whose LM result is off the float64-position "
        f"oracle: {near64}; all {4 * n_sub} match an oracle with float32 "
        f"positions (rounded products: {near32['float32']}, fused: "
        f"{near32['float32_fma']})")
    log(f"  assembly vs oracle, xla and xla_sep: chi within rtol 2e-4 "
        f"(worst {worst_asm:.2e}); A, b within rtol 2e-4 or 2e-5 of "
        "each element's Cauchy-Schwarz scale")
    timed("phase 4 wall (compiles + oracle)", time.perf_counter() - t0)


def _time_frames(cfg, stack, batch, params0, reps=3):
    from correlation_jax.engine import correlate_frames

    t0 = time.perf_counter()
    out = _block(correlate_frames(cfg, stack, batch, guess0=params0))
    first = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(reps):
        out = _block(correlate_frames(cfg, stack, batch, guess0=params0))
    return first, (time.perf_counter() - t0) / reps, out


def phase_backends() -> None:
    log("phase 5: assembly backends")
    import jax.numpy as jnp

    import bench
    from correlation_jax.engine import correlate

    n = BENCH_SUBSETS
    cfg, und_pyr, def_pyr, batch, params0, raw = bench.build_problem(n)
    cfg = dataclasses.replace(cfg, max_iterations=50, precision=1e-3)
    k = BENCH_CHUNK
    und, dfm = raw
    stack = jnp.asarray(np.stack([und] + [dfm] * k)[..., None], jnp.float32)
    outs = {}
    for backend in ("xla", "xla_sep"):
        c = dataclasses.replace(cfg, backend=backend)
        first, per_chunk, out = _time_frames(c, stack, batch, params0)
        outs[backend] = out
        timed(f"bench shape {backend}: first call", first)
        timed(f"bench shape {backend}: {k}-frame chunk", per_chunk,
              f" = {per_chunk / k * 1e3:.3f} ms/frame, "
              f"{n * k / per_chunk:.1f} solves/s, mean iterations "
              f"{float(np.asarray(out['iterations']).mean()):.2f}")
    pa = np.asarray(outs["xla"]["params"][-1])
    pb = np.asarray(outs["xla_sep"]["params"][-1])
    both = (np.asarray(outs["xla"]["error"][-1]) == 0) & (
        np.asarray(outs["xla_sep"]["error"][-1]) == 0)
    duv = np.abs(pa - pb)[both][:, :2].max(axis=1)
    share = float((duv <= 1e-2).mean())
    log(f"  xla vs xla_sep parameters (both converged, {both.sum()} "
        f"subsets): max |du,dv| {duv.max():.2e} px, median "
        f"{np.median(duv):.2e}; share within 1e-2 px {share:.5f} "
        "(tolerance: >= 0.995)")
    if both.mean() < 0.99 or share < 0.995:
        raise AssertionError("xla and xla_sep disagree")

    # 16-sector sequence (benchmarks/run.py config 4), both backends.
    from correlation_jax.config import (
        FittingModel, Interpolation, PyramidConfig, SolverConfig,
    )
    from correlation_jax.domains import rectangular_points
    from correlation_jax.sequence import SequenceConfig, run_sequence
    from synthetic import FourierTexture

    spk = FourierTexture(384, 384, seed=7)
    frames = [spk.warped_image(u=0.6 * t, v=-0.35 * t,
                               quantize=True)[..., None] for t in range(11)]
    pts = [rectangular_points(80 + 56 * i, 80 + 56 * j, 12, 12)
           for i in range(4) for j in range(4)]
    for backend in ("xla", "xla_sep"):
        seq = SequenceConfig(solver=SolverConfig(
            model=FittingModel.UV, interpolation=Interpolation.BICUBIC,
            pyramid=PyramidConfig(0, 1, 2), backend=backend,
        ))
        run_sequence(frames, pts, seq)
        dts = []
        for _ in range(5):
            t0 = time.perf_counter()
            recs = run_sequence(frames, pts, seq)
            dts.append(time.perf_counter() - t0)
        drift = recs[-1].params.mean(axis=0)
        if not np.allclose(drift, [6.0, -3.5], atol=0.05):
            raise AssertionError(f"16-sector drift {drift}")
        dt = float(np.median(dts))
        timed(f"16 sectors x 10 pairs {backend}, median of 5", dt,
              f" = {dt / 10 * 1e3:.3f} ms/frame (runs "
              f"{min(dts) * 1e3:.1f}-{max(dts) * 1e3:.1f} ms)")

    # Compaction cascade vs the monolithic loop, per backend.
    for backend in ("xla", "xla_sep"):
        c = dataclasses.replace(cfg, backend=backend)
        mono = correlate(dataclasses.replace(c, compact_stages=0), und_pyr,
                         def_pyr, batch, params0)
        comp = correlate(c, und_pyr, def_pyr, batch, params0)
        fields = {f: (np.asarray(getattr(mono, f)),
                      np.asarray(getattr(comp, f)))
                  for f in ("params", "chi", "iterations", "error")}
        same = all(np.array_equal(a, b) for a, b in fields.values())
        dp = float(np.abs(fields["params"][0] - fields["params"][1]).max())
        n_it = int((fields["iterations"][0] != fields["iterations"][1]).sum())
        # Bitwise on the CPU (tests/test_engine.py); on the GPU XLA's
        # kernels for a batched reduction depend on the batch size, so
        # compacted batches may sum in another order: held to the
        # oracle's parameter tolerance instead.
        log(f"  compaction vs monolithic LM loop, {backend}: "
            f"{'bitwise identical' if same else 'NOT bitwise identical'}; "
            f"max |dp| {dp:.2e} (tolerance 5e-4), iteration mismatches "
            f"{n_it}/{n}")
        if dp > 5e-4:
            raise AssertionError(f"compaction changed {backend} results")


def phase_four_cards(tmp: str, devices) -> None:
    log("phase 6: sharded path on four cards")
    import jax
    import jax.numpy as jnp

    from correlation_jax import domains
    from correlation_jax.config import PyramidConfig, SolverConfig
    from correlation_jax.cli import _MODELS, _INTERPS
    from correlation_jax.engine import (
        _correlate_jit,
        _correlate_shardmap_fn,
        _statics_for,
        correlate,
    )
    from correlation_jax.io import load_image
    from correlation_jax.ops.assemble import assemble_normal_equations
    from correlation_jax.ops.interp import precompute_field, sample_integer
    from correlation_jax.ops.pyramid import build_pyramid
    from correlation_jax.parallel.collectives import (
        assemble_pixel_sharded,
        make_pixel_mesh,
    )
    from correlation_jax.parallel.mesh import (
        make_mesh,
        pad_to_mesh,
        replicate,
        shard_inputs,
    )
    from correlation_jax.sequence import (
        SequenceConfig,
        run_sequence_from_files,
    )
    from correlation_jax.utils.profiling import hlo_loop_collectives

    if len(devices) < 4:
        raise RuntimeError(f"--four-cards needs 4 GPUs, found {len(devices)}")
    mesh = make_mesh(devices[:4])
    paths = write_frames(tmp, N_FRAMES)
    pts, cs = rect_sectors()
    n_sec, pairs = len(pts), len(paths) - 1
    solver = SolverConfig(
        model=_MODELS["affine"], interpolation=_INTERPS["bicubic"],
        pyramid=PyramidConfig(0, 1, 2),
    )
    seq = SequenceConfig(solver=solver)
    runs = {}
    for name, m in (("one card", None), ("4-card mesh", mesh)):
        run_sequence_from_files(paths, pts, seq, centers=cs, mesh=m)
        t0 = time.perf_counter()
        runs[name] = run_sequence_from_files(paths, pts, seq, centers=cs,
                                             mesh=m)
        dt = time.perf_counter() - t0
        timed(f"run_sequence {n_sec} sectors x {pairs} pairs, {name} "
              "(warm)", dt, f" = {dt / pairs * 1e3:.2f} ms/frame, "
              f"{n_sec * pairs / dt:.1f} solves/s")
    # Sharding changes each device's batch, and on the GPU a batched
    # reduction's summation order depends on the batch size (see the
    # compaction finding), so a sector at a stopping threshold may take
    # another LM path, which the Eulerian guess chain carries on.  Held:
    # 99.9% of records within 1e-3 px and with equal error codes.
    compare_runs(
        "run_sequence",
        np.stack([r.params for r in runs["one card"]]),
        np.stack([r.params for r in runs["4-card mesh"]]),
        np.stack([r.error for r in runs["one card"]]),
        np.stack([r.error for r in runs["4-card mesh"]]),
    )

    und = load_image(paths[0])
    dfm = load_image(paths[1])
    pyr_u = build_pyramid(jnp.asarray(und), 2)
    pyr_d = build_pyramid(jnp.asarray(dfm), 2)
    batch = domains.make_batch(pts, cs, 2)
    p0 = np.zeros((len(pts), 6), np.float32)
    ref = correlate(solver, pyr_u, pyr_d, batch, p0)
    out = correlate(solver, pyr_u, pyr_d, batch, p0, mesh=mesh)
    compare_runs(
        "correlate", np.asarray(ref.params)[None],
        np.asarray(out.params)[None], np.asarray(ref.error)[None],
        np.asarray(out.error)[None],
    )

    # Which collectives each mesh route compiles: shard_map (the engine's
    # route) against GSPMD auto-partitioning of the same jit.
    statics = _statics_for(solver, batch, (SIDE, SIDE))
    bp = pad_to_mesh(batch, mesh)
    xy, mask, c0, params = shard_inputs(mesh, bp, p0)
    und_r = replicate(mesh, list(pyr_u))
    def_r = replicate(mesh, list(pyr_d))
    for label, fn in (
        ("shard_map (engine route)",
         _correlate_shardmap_fn(solver, statics, mesh)),
        ("GSPMD jit", lambda *a: _correlate_jit(solver, statics, *a)),
    ):
        hlo = jax.jit(fn).lower(und_r, def_r, xy, mask, c0, params)
        total, in_loop = hlo_loop_collectives(hlo.compile().as_text())
        log(f"  compiled collectives, {label}: {total}, of which "
            f"{in_loop} inside LM while loops")

    # Pixel-sharded assembly of one large blob subset vs unsharded.
    theta = np.linspace(0, 2 * np.pi, 24, endpoint=False)
    c = SIDE / 2
    contour = np.stack(
        [c + SIDE * 0.29 * np.cos(theta), c + SIDE * 0.21 * np.sin(theta)],
        -1,
    ).astype(np.float32)
    blob = domains.blob_batch(domains.BlobDomain(contour), 0)
    n_pix = int(blob.n_points(0)[0])
    p_pad = -(-blob.xy[0].shape[1] // 4) * 4
    xy1 = np.zeros((1, p_pad, 2), np.float32)
    m1 = np.zeros((1, p_pad), bool)
    xy1[:, : blob.xy[0].shape[1]] = blob.xy[0]
    m1[:, : blob.mask[0].shape[1]] = blob.mask[0]
    field = precompute_field(pyr_d[0], solver.interpolation)
    und_w = sample_integer(pyr_u[0], jnp.asarray(xy1)) * jnp.asarray(
        m1[..., None])
    guess = np.array([[0.2, -0.1, 0.001, 0.0, 0.0, -0.001]], np.float32)
    args = (und_w, jnp.asarray(xy1), jnp.asarray(m1),
            jnp.asarray(blob.center0), jnp.asarray(guess))
    a_s, b_s, chi_s, err_s = assemble_pixel_sharded(
        make_pixel_mesh(devices[:4]), solver.model, solver.interpolation,
        field, *args)
    a_r, b_r, chi_r, err_r = assemble_normal_equations(
        solver.model, solver.interpolation, field, *args)
    a_r, b_r = np.asarray(a_r), np.asarray(b_r)
    np.testing.assert_allclose(np.asarray(a_s), a_r, rtol=1e-5,
                               atol=float(np.abs(a_r).max()) * 1e-6)
    np.testing.assert_allclose(np.asarray(b_s), b_r, rtol=1e-3,
                               atol=float(np.abs(b_r).max()) * 1e-5)
    np.testing.assert_allclose(np.asarray(chi_s), np.asarray(chi_r),
                               rtol=1e-5)
    if bool(err_s[0]) != bool(err_r[0]):
        raise AssertionError("pixel-sharded out-of-image flag differs")
    log(f"  pixel-sharded assembly of one {n_pix}-pixel blob subset over "
        "4 cards matches the unsharded one (A rtol 1e-5, b rtol 1e-3, chi "
        "rtol 1e-5)")


def main(argv=None) -> int:
    global CARD
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the sharded path on four GPUs")
    args = ap.parse_args(argv)

    devices = require_gpu()
    import jax

    from correlation_jax.utils.compile_cache import enable_compile_cache

    cache = enable_compile_cache()
    cards = card_lines()
    CARD = cards[0]
    warm = len(os.listdir(cache)) if os.path.isdir(cache) else 0
    log(f"phase 1: jax {jax.__version__}, {len(devices)} x "
        f"{devices[0].device_kind}, compile cache {cache} ({warm} "
        "entries at start)")
    t_start = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        if args.four_cards:
            phase_four_cards(tmp, devices)
        else:
            t0 = time.perf_counter()
            paths = write_frames(tmp, N_FRAMES)
            log(f"  wrote {len(paths)} {SIDE}x{SIDE} PNG frames in "
                f"{time.perf_counter() - t0:.1f} s")
            phase_main_path(tmp, paths)
            phase_other_paths(tmp, paths)
            phase_oracle(paths)
            phase_backends()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"all phases passed in {time.perf_counter() - t_start:.1f} s")
    for line in cards:
        log(f"card: {line}")
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": devices[0].platform,
            "kind": devices[0].device_kind,
            "count": len(devices),
        },
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Benchmark suite for the BASELINE.json configurations.

Usage:
  python benchmarks/run.py            # all configs
  python benchmarks/run.py --config 5 --subsets 16384

Prints one JSON line per config:
  {"config": N, "metric": ..., "value": ..., "unit": ..., ...}

Configs (BASELINE.json):
  1  single rectangular subset, translation warp, 1 level, 2 frames
  2  affine 6-param warp, 3-level pyramid, bicubic
  3  annular + blob masked domains, full pyramid schedule
  4  10-frame sequence with constant-velocity initial-guess extrapolation
  5  dense 10k+ subset grid (collective H/b reduction when multi-device)
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

sys.path.insert(0, ".")
sys.path.insert(0, "tests")


def _speckle(h, w, seed=0):
    # FourierTexture: exactly-warpable like Speckle but O(n_waves)/pixel, so
    # the 1024^2 dense-grid images generate in seconds instead of minutes.
    from synthetic import FourierTexture

    return FourierTexture(h, w, seed=seed)


def _emit(config, metric, value, unit, **extra):
    print(
        json.dumps(
            {
                "config": config,
                "metric": metric,
                "value": round(float(value), 2),
                "unit": unit,
                **extra,
            }
        ),
        flush=True,
    )


def _sync(out):
    """Force completion with a device->host readback."""
    import jax

    leaf = jax.tree_util.tree_leaves(out)[0]
    np.asarray(leaf[:1] if hasattr(leaf, "shape") and leaf.ndim else leaf)
    return out


def _time(fn, reps=3):
    _sync(fn())  # compile
    t0 = time.perf_counter()
    for _ in range(reps):
        _sync(fn())
    return (time.perf_counter() - t0) / reps


def config1():
    import jax.numpy as jnp

    from correlation_jax.config import (
        FittingModel, Interpolation, PyramidConfig, SolverConfig,
    )
    from correlation_jax.domains import make_batch, rectangular_points
    from correlation_jax.engine import correlate

    spk = _speckle(256, 256)
    und = spk.image(quantize=True)[..., None]
    dfm = spk.warped_image(u=1.3, v=-0.7, quantize=True)[..., None]
    cfg = SolverConfig(
        model=FittingModel.UV,
        interpolation=Interpolation.BICUBIC,
        pyramid=PyramidConfig(0, 1, 0),
    )
    pts = rectangular_points(128, 128, 15, 15)
    batch = make_batch([pts], None, 0)

    def run():
        return correlate(
            cfg, [jnp.asarray(und)], [jnp.asarray(dfm)], batch,
            np.zeros((1, 2), np.float32),
        )

    res = run()
    err = np.hypot(
        float(res.params[0, 0]) - 1.3, float(res.params[0, 1]) + 0.7
    )
    dt = _time(run)
    _emit(1, "single_subset_solve_latency", dt * 1e3, "ms",
          recovery_err_px=round(err, 4))


def _dense_problem(num_subsets, half=10, stop=2, img_hw=1024):
    import jax.numpy as jnp

    from correlation_jax.config import (
        FittingModel, Interpolation, PyramidConfig, SolverConfig,
    )
    from correlation_jax.domains import make_batch, rectangular_points
    from correlation_jax.ops.pyramid import build_pyramid

    spk = _speckle(img_hw, img_hw, seed=3)
    und = spk.image(quantize=True)
    aff = np.array([[0.003, -0.002], [0.002, 0.004]])
    dfm = spk.warped_image(
        u=1.7, v=-1.1, affine=aff, center=(img_hw / 2, img_hw / 2),
        quantize=True,
    )
    cfg = SolverConfig(
        model=FittingModel.AFFINE,
        interpolation=Interpolation.BICUBIC,
        pyramid=PyramidConfig(0, 1, stop),
    )
    side = int(np.ceil(np.sqrt(num_subsets)))
    margin = 6 * half
    coords = np.linspace(margin, img_hw - margin, side)
    pts, centers = [], []
    for cy in coords:
        for cx in coords:
            if len(pts) == num_subsets:
                break
            pts.append(rectangular_points(int(cx), int(cy), half, half))
            centers.append((int(cx), int(cy)))
    batch = make_batch(pts, np.array(centers, np.float32), stop)
    und_pyr = build_pyramid(jnp.asarray(und[..., None]), stop)
    def_pyr = build_pyramid(jnp.asarray(dfm[..., None]), stop)
    return cfg, und_pyr, def_pyr, batch


def config2(num_subsets=1024):
    from correlation_jax.engine import correlate

    cfg, und_pyr, def_pyr, batch = _dense_problem(num_subsets)
    # Device-resident batch: fixed-geometry workloads pay the point-array
    # upload once (bench.py/config5 semantics) — without this every call
    # re-uploads 8 host arrays and the row measures transfers, not
    # solving.
    batch = batch.to_device()

    def run():
        return correlate(
            cfg, und_pyr, def_pyr, batch,
            np.zeros((batch.num_subsets, 6), np.float32),
        )

    res = run()
    ok = float(np.mean(np.asarray(res.error) == 0))
    dt = _time(run)
    _emit(2, "affine_pyramid_solves_per_s", num_subsets / dt, "solves/s",
          subsets=num_subsets, converged_frac=round(ok, 4),
          mean_iters=round(float(np.mean(np.asarray(res.iterations))), 2))


def config3():
    import math

    import jax.numpy as jnp

    from correlation_jax.config import (
        FittingModel, Interpolation, PyramidConfig, SolverConfig,
    )
    from correlation_jax.domains import (
        AnnularDomain, BlobDomain, annular_batch, blob_batch,
    )
    from correlation_jax.engine import correlate
    from correlation_jax.ops.pyramid import build_pyramid

    spk = _speckle(512, 512, seed=5)
    und = spk.image(quantize=True)
    dfm = spk.warped_image(u=0.8, v=0.6, quantize=True)
    cfg = SolverConfig(
        model=FittingModel.UVQ,
        interpolation=Interpolation.BICUBIC,
        pyramid=PyramidConfig(0, 1, 2),
    )
    und_pyr = build_pyramid(jnp.asarray(und[..., None]), 2)
    def_pyr = build_pyramid(jnp.asarray(dfm[..., None]), 2)

    ann = annular_batch(
        AnnularDomain(256, 256, 60, 160, 2, 8), 2
    )
    theta = np.linspace(0, 2 * math.pi, 24, endpoint=False)
    contour = np.stack(
        [256 + 90 * np.cos(theta), 256 + 70 * np.sin(theta)], -1
    ).astype(np.float32)
    blob = blob_batch(BlobDomain(contour), 2)
    ann = ann.to_device()
    blob = blob.to_device()

    for name, batch in [("annular", ann), ("blob", blob)]:
        def run():
            return correlate(
                cfg, und_pyr, def_pyr, batch,
                np.zeros((batch.num_subsets, 3), np.float32),
            )

        res = run()
        dt = _time(run)
        _emit(3, f"{name}_masked_solves_per_s", batch.num_subsets / dt,
              "solves/s", subsets=batch.num_subsets,
              points=int(batch.n_points(0).sum()),
              errors=int((np.asarray(res.error) != 0).sum()))

    # Combined-domains dispatch (VERDICT r5 item 9): the annulus and the
    # blob solve in ONE call — small jobs are dominated by the fixed
    # per-dispatch cost.  correlate_many keeps each domain's OWN tile
    # statics (a naive batch concat would blow every annular sector's
    # tile up to the blob's extent) and fetches all results in one
    # packed transfer.
    from correlation_jax.engine import correlate_many

    def run_both():
        return correlate_many(
            cfg, und_pyr, def_pyr, [ann, blob],
            [np.zeros((b.num_subsets, 3), np.float32)
             for b in (ann, blob)],
        )

    parts = run_both()
    n_both = ann.num_subsets + blob.num_subsets
    dt_b = _time(run_both)
    _emit(3, "combined_annular_blob_solves_per_s",
          n_both / dt_b, "solves/s",
          subsets=n_both, domains=2,
          points=int(ann.n_points(0).sum() + blob.n_points(0).sum()),
          errors=int(sum((p.error != 0).sum() for p in parts)))


def config4():
    from correlation_jax.config import (
        FittingModel, Interpolation, PyramidConfig, SolverConfig,
    )
    from correlation_jax.domains import rectangular_points
    from correlation_jax.sequence import SequenceConfig, run_sequence
    from correlation_jax.utils.profiling import SolveMeter

    spk = _speckle(384, 384, seed=7)
    frames = [
        spk.warped_image(u=0.6 * t, v=-0.35 * t, quantize=True)[..., None]
        for t in range(11)
    ]
    solver = SolverConfig(
        model=FittingModel.UV,
        interpolation=Interpolation.BICUBIC,
        pyramid=PyramidConfig(0, 1, 2),
    )
    cfg = SequenceConfig(solver=solver)
    pts = [
        rectangular_points(80 + 56 * i, 80 + 56 * j, 12, 12)
        for i in range(4)
        for j in range(4)
    ]
    # Warm the compile cache with an identically-shaped full run (the
    # chunked driver compiles one scan per chunk shape) so the meter
    # reports steady-state sequence throughput.
    run_sequence(frames, pts, cfg)
    meter = SolveMeter()
    records = run_sequence(frames, pts, cfg, meter=meter)
    drift = records[-1].params.mean(axis=0)
    _emit(4, "sequence_subset_solves_per_s", meter.solves_per_s, "solves/s",
          frames=len(records), sectors=len(pts),
          final_u=round(float(drift[0]), 3),
          final_v=round(float(drift[1]), 3))


def config4b(num_subsets=4096, n_frames=33):
    """Dense sequence through the PRODUCTION driver at bench.py scale —
    the VERDICT r3 item-2 criterion: run_sequence throughput within 10%
    of the bench number at equal subset count."""
    from correlation_jax.config import (
        FittingModel, Interpolation, PyramidConfig, SolverConfig,
    )
    from correlation_jax.domains import rectangular_points
    from correlation_jax.sequence import SequenceConfig, run_sequence
    from correlation_jax.utils.profiling import SolveMeter

    img_hw, half = 1024, 10
    spk = _speckle(img_hw, img_hw, seed=3)
    frames = [
        spk.warped_image(u=0.31 * t, v=-0.22 * t, quantize=True)[..., None]
        for t in range(n_frames)
    ]
    solver = SolverConfig(
        model=FittingModel.AFFINE,
        interpolation=Interpolation.BICUBIC,
        pyramid=PyramidConfig(0, 1, 2),
        max_iterations=8,
        precision=1e-12,  # fixed work, same semantics as bench.py
    )
    cfg = SequenceConfig(solver=solver)
    side = int(np.ceil(np.sqrt(num_subsets)))
    margin = 6 * half
    coords = np.linspace(margin, img_hw - margin, side)
    pts = []
    for cy in coords:
        for cx in coords:
            if len(pts) == num_subsets:
                break
            pts.append(rectangular_points(int(cx), int(cy), half, half))
    run_sequence(frames, pts, cfg)  # compile warmup, identical shape
    meter = SolveMeter()
    records = run_sequence(frames, pts, cfg, meter=meter)
    drift = records[-1].params.mean(axis=0)
    _emit(4, "dense_sequence_subset_solves_per_s", meter.solves_per_s,
          "solves/s", frames=len(records), sectors=len(pts),
          frame_chunk=cfg.frame_chunk,
          final_u=round(float(drift[0]), 3),
          final_v=round(float(drift[1]), 3))


def config5(num_subsets=10240):
    """Scaling efficiency: dense subset grid solved at 1 device and at N
    devices with the auto backend, efficiency = (perf_N / N) / perf_1.

    On a host-virtualized mesh (xla_force_host_platform_device_count) the
    N "devices" share one physical machine, so per-device efficiency is
    meaningless; there the meaningful number is sharding_efficiency =
    perf_N / perf_1 — total throughput with the subset axis sharded vs
    unsharded on identical hardware (>= 0.85 means the mesh program adds
    <= 15% overhead).  On real multi-chip hardware per_device_efficiency
    is the BASELINE metric.
    """
    import jax

    from correlation_jax.engine import correlate
    from correlation_jax.parallel.mesh import make_mesh

    cfg, und_pyr, def_pyr, batch = _dense_problem(
        num_subsets, half=10, stop=1
    )
    n_dev = len(jax.devices())
    virtual = jax.devices()[0].platform == "cpu" and n_dev > 1
    params0 = np.zeros((batch.num_subsets, 6), np.float32)

    # Meshless baseline: no mesh, no shard_map — XLA free to use the
    # whole device/host.  On a host-virtual CPU "mesh" this (not the
    # 1-device-mesh run, which pins XLA to one virtual device and
    # under-uses the host) is the honest denominator for sharding
    # efficiency; on real devices perf0 vs perf1 bounds the mesh +
    # shard_map overhead.
    batch_dev = batch.to_device()

    def run0():
        return correlate(cfg, und_pyr, def_pyr, batch_dev, params0)

    dt0 = _time(run0)
    perf0 = num_subsets / dt0
    _emit(5, "dense_grid_solves_per_s_meshless", perf0, "solves/s",
          subsets=num_subsets)

    def mesh_runner(mesh):
        """correlate's mesh path with inputs STAGED ONCE (the meshless row
        stages batch_dev once too): what remains in the timed region is
        the mesh/shard_map program itself, not per-call host->device
        re-sharding — the quantity the mesh-overhead bound is about."""
        from correlation_jax.engine import (
            _correlate_shardmap_fn,
            _statics_for,
        )
        from correlation_jax.parallel.mesh import (
            pad_to_mesh, replicate, shard_inputs,
        )

        statics = _statics_for(cfg, batch, def_pyr[0].shape[:2])
        p0 = np.asarray(params0, np.float32)
        bp = pad_to_mesh(batch, mesh)
        if p0.shape[0] != bp.num_subsets:
            p0 = np.pad(p0, ((0, bp.num_subsets - p0.shape[0]), (0, 0)))
        xy, mask, c0, params = shard_inputs(mesh, bp, p0)
        und = replicate(mesh, [np.asarray(a) for a in und_pyr])
        dfm = replicate(mesh, [np.asarray(a) for a in def_pyr])
        fn = _correlate_shardmap_fn(cfg, statics, mesh)
        return lambda: fn(und, dfm, xy, mask, c0, params)

    mesh1 = make_mesh(jax.devices()[:1])
    dt1 = _time(mesh_runner(mesh1))
    perf1 = num_subsets / dt1
    _emit(5, "dense_grid_solves_per_s", perf1, "solves/s",
          subsets=num_subsets, devices=1,
          mesh_overhead_vs_meshless=round(dt1 / dt0 - 1.0, 4))

    if n_dev > 1:
        mesh_n = make_mesh()
        dt_n = _time(mesh_runner(mesh_n))
        perf_n = num_subsets / dt_n
        base = max(perf0, perf1) if virtual else perf1
        extra = {
            # vs the STRONGER single-device program — on shared cores the
            # meshless run is the real baseline (r03's apparent >1
            # efficiency was a weak 1-device-mesh denominator).
            "sharding_efficiency": round(perf_n / base, 4),
            "per_device_efficiency": round(perf_n / (n_dev * base), 4),
            "hardware": "host-virtual (shared cores)" if virtual
            else "distinct devices",
        }
        _emit(5, "dense_grid_sharded_solves_per_s", perf_n, "solves/s",
              subsets=num_subsets, devices=n_dev, **extra)


def config5b(side=192):
    """Pixel-sharded collective H/b assembly (SURVEY §2.3-1 cross-chip):
    ONE huge subset, pixel axis sharded over the mesh, psum reduction —
    measured against the identical unsharded assembly."""
    import jax
    import jax.numpy as jnp

    from correlation_jax.config import (
        FittingModel, Interpolation,
    )
    from correlation_jax.ops.assemble import assemble_normal_equations
    from correlation_jax.ops.interp import precompute_field
    from correlation_jax.parallel.collectives import (
        assemble_pixel_sharded, make_pixel_mesh,
    )

    n_dev = len(jax.devices())
    spk = _speckle(side + 64, side + 64, seed=11)
    und = spk.image(quantize=True)[..., None]
    dfm = spk.warped_image(u=0.9, v=-0.6, quantize=True)[..., None]
    model, interp = FittingModel.AFFINE, Interpolation.BICUBIC

    gx, gy = np.meshgrid(
        np.arange(32, 32 + side), np.arange(32, 32 + side), indexing="ij"
    )
    pts = np.stack([gx.ravel(), gy.ravel()], -1).astype(np.float32)
    p_pix = pts.shape[0]
    p_pad = -(-p_pix // (128 * n_dev)) * (128 * n_dev)
    xy = np.zeros((1, p_pad, 2), np.float32)
    xy[0, :p_pix] = pts
    mask = np.zeros((1, p_pad), bool)
    mask[0, :p_pix] = True
    center = pts.mean(axis=0, keepdims=True)
    params = np.tile(
        np.array([[0.9, -0.6, 0, 0, 0, 0]], np.float32), (1, 1)
    )
    field = precompute_field(jnp.asarray(dfm), interp)
    und_w = np.zeros((1, p_pad, 1), np.float32)
    und_w[0, :p_pix, 0] = und[
        pts[:, 1].astype(int), pts[:, 0].astype(int), 0
    ]
    args = (
        jnp.asarray(und_w), jnp.asarray(xy), jnp.asarray(mask),
        jnp.asarray(center), jnp.asarray(params),
    )

    base = jax.jit(
        lambda *a: assemble_normal_equations(model, interp, field, *a)
    )
    dt0 = _time(lambda: base(*args))

    mesh = make_pixel_mesh()
    shard = jax.jit(
        lambda *a: assemble_pixel_sharded(mesh, model, interp, field, *a)
    )
    dt1 = _time(lambda: shard(*args))

    a0 = np.asarray(base(*args)[0])
    a1 = np.asarray(shard(*args)[0])
    rel = float(
        np.abs(a1 - a0).max() / max(np.abs(a0).max(), 1e-9)
    )
    _emit(5, "pixel_sharded_assembly_ms", dt1 * 1e3, "ms",
          pixels=p_pix, devices=n_dev,
          unsharded_ms=round(dt0 * 1e3, 2),
          speedup=round(dt0 / dt1, 3),
          a_matrix_rel_err=round(rel, 8))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", type=int, default=0, help="0 = all")
    ap.add_argument("--subsets", type=int, default=None)
    args = ap.parse_args()
    from correlation_jax.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    fns = {
        1: config1,
        2: lambda: config2(args.subsets or 1024),
        3: config3,
        4: lambda: (config4(), config4b()),
        5: lambda: (config5(args.subsets or 10240), config5b()),
    }
    targets = [args.config] if args.config else sorted(fns)
    for c in targets:
        fns[c]()


if __name__ == "__main__":
    main()

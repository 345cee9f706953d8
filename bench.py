"""Benchmark: batched subset Gauss-Newton solve throughput.

Prints one JSON line:
  {"metric": "subset_gn_solves_per_s", "value": N, "unit": "solves/s",
   "platform": ..., "device_kind": ..., "device_count": ...}

The workload is BASELINE.json config 2/5 shaped: a dense grid of 21x21-pixel
subsets, 6-parameter affine warp, bicubic interpolation, 3-level pyramid, at
the REFERENCE'S OWN default stopping semantics (max_iters=50,
precision=1e-3 — mainapp.cpp:204,208): subsets converge individually.
"One solve" = one subset's complete coarse-to-fine LM solve.
--fixed-iters restores the former
fixed-8-iteration / precision=1e-12 kernel measurement; --dense runs 16384
subsets; --single-dispatch the pre-round-4 per-frame-dispatch mode.
"""

import json
import time

import numpy as np


def build_problem(num_subsets: int, img_hw: int = 1024, half: int = 10,
                  stop: int = 2):
    import jax.numpy as jnp

    from correlation_jax.config import (
        FittingModel,
        Interpolation,
        PyramidConfig,
        SolverConfig,
    )
    from correlation_jax.domains import make_batch
    from correlation_jax.ops.pyramid import build_pyramid

    rng = np.random.default_rng(0)
    # Smooth speckle-ish texture: blurred noise, quantized to uint8 values.
    base = rng.uniform(0, 255, (img_hw + 8, img_hw + 8))
    k = np.ones(5) / 5.0
    base = np.apply_along_axis(
        lambda r: np.convolve(r, k, mode="same"), 0, base
    )
    base = np.apply_along_axis(
        lambda r: np.convolve(r, k, mode="same"), 1, base
    )
    und = np.floor(base[4 : img_hw + 4, 4 : img_hw + 4] * 2.0 % 255.0)
    dfm = np.floor(base[3 : img_hw + 3, 4 : img_hw + 4] * 2.0 % 255.0)
    raw = (und.astype(np.float32), dfm.astype(np.float32))

    cfg = SolverConfig(
        model=FittingModel.AFFINE,
        interpolation=Interpolation.BICUBIC,
        pyramid=PyramidConfig(0, 1, stop),
        max_iterations=8,
        precision=1e-12,  # force the full iteration budget: fixed work
    )
    side = int(np.ceil(np.sqrt(num_subsets)))
    margin = 4 * half
    coords = np.linspace(margin, img_hw - margin, side)
    centers = []
    for cy in coords:
        for cx in coords:
            centers.append((int(cx), int(cy)))
            if len(centers) == num_subsets:
                break
        if len(centers) == num_subsets:
            break
    pts = []
    for cx, cy in centers:
        gx, gy = np.meshgrid(
            np.arange(cx - half, cx + half + 1),
            np.arange(cy - half, cy + half + 1),
            indexing="ij",
        )
        pts.append(np.stack([gx.ravel(), gy.ravel()], -1).astype(np.float32))
    # Device-resident batch: the subset geometry is fixed across a run
    # (Eulerian default), so the real workload pays this transfer once.
    batch = make_batch(pts, np.array(centers, np.float32), stop).to_device()
    und_pyr = build_pyramid(jnp.asarray(und[..., None], jnp.float32), stop)
    def_pyr = build_pyramid(jnp.asarray(dfm[..., None], jnp.float32), stop)
    params0 = jnp.zeros((num_subsets, cfg.num_params), jnp.float32)
    return cfg, und_pyr, def_pyr, batch, params0, raw


def main():
    import dataclasses
    import sys

    import jax
    import jax.numpy as jnp

    from correlation_jax.engine import correlate_frames, resolve_backend
    from correlation_jax.sequence import SequenceConfig
    from correlation_jax.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    num_subsets = 16384 if "--dense" in sys.argv else 4096
    # Track the production default so the headline measures what a real
    # run_sequence dispatches.
    frame_chunk = SequenceConfig().frame_chunk
    if "--frame-chunk" in sys.argv:  # A/B forensics (PERF.md)
        frame_chunk = int(sys.argv[sys.argv.index("--frame-chunk") + 1])
    cfg, und_pyr, def_pyr, batch, params0, raw = build_problem(num_subsets)
    # HEADLINE SEMANTICS = the reference's own defaults (mainapp.cpp:204,
    # 208): max_iters=50, precision=1e-3 — subsets converge individually
    # and the solver must earn per-subset early stopping (the straggler
    # compaction cascade, engine.solve_level).  The former fixed-8 /
    # precision=1e-12 kernel measurement stays available via --fixed-iters.
    if "--fixed-iters" not in sys.argv:
        cfg = dataclasses.replace(cfg, max_iterations=50, precision=1e-3)

    # The production frame loop (sequence.run_sequence, Eulerian): K frame
    # solves chained inside ONE dispatch via lax.scan, pyramids built
    # in-jit — the per-call dispatch latency amortizes over the chunk
    # exactly as in a real run.  Frames are staged on device up front (a
    # real run's prefetcher overlaps the uploads with solving).
    und, dfm = raw
    stack = jnp.asarray(
        np.stack([und] + [dfm] * frame_chunk)[..., None], jnp.float32
    )

    def run():
        return correlate_frames(
            cfg,
            stack,
            batch,
            guess0=params0,
            reference_first=True,
            first_chunk=True,
        )

    def sync(out):
        # A device->host readback of the last frame's result.
        np.asarray(out["params"][-1, :1])

    sync(run())  # warmup / compile
    reps = 3
    # Chunk dispatches pipeline (rep i+1's dispatch overlaps rep i's
    # execution, as consecutive chunks do in a production run); the final
    # readbacks bound the whole batch.  Reports the best of three passes
    # and their median.
    pass_dts = []
    for _ in range(3):
        t0 = time.perf_counter()
        results = [run() for _ in range(reps)]
        for out in results:
            sync(out)
        pass_dts.append((time.perf_counter() - t0) / (reps * frame_chunk))

    dt = min(pass_dts)
    solves_per_s = num_subsets / dt
    median_rate = num_subsets / float(np.median(pass_dts))
    # Trust guard: a broken kernel must not post a fast number.  At the
    # reference-default precision subsets converge individually (a few
    # stragglers may exhaust max_iters = code 3); genuine failures are
    # the out-of-image / solver / domain codes.
    errors = np.asarray(results[-1]["error"])
    hard_frac = float(np.mean((errors != 0) & (errors != 3)))
    p_last = np.asarray(results[-1]["params"])
    iters = float(np.asarray(results[-1]["iterations"]).mean())
    assert np.isfinite(p_last).all(), "non-finite parameters"
    assert hard_frac < 0.005, f"hard-error fraction {hard_frac}"
    print(
        json.dumps(
            {
                "metric": "subset_gn_solves_per_s",
                "value": round(solves_per_s, 1),
                "unit": "solves/s",
                "median": round(median_rate, 1),
                "platform": jax.devices()[0].platform,
                "device_kind": jax.devices()[0].device_kind,
                "device_count": len(jax.devices()),
                "backend": resolve_backend(cfg),
                "hard_error_frac": round(hard_frac, 5),
                "frame_chunk": frame_chunk,
                "num_subsets": num_subsets,
                "max_iterations": cfg.max_iterations,
                "precision": cfg.precision,
                "mean_iterations": round(iters, 2),
            }
        )
    )

    if "--single-dispatch" in sys.argv:
        # The pre-round-4 per-frame-dispatch mode, kept for comparison.
        from correlation_jax.engine import correlate

        def run1():
            return correlate(cfg, und_pyr, def_pyr, batch, params0)

        np.asarray(run1().params[:1])
        t0 = time.perf_counter()
        res1 = [run1() for _ in range(5)]
        for r in res1:
            np.asarray(r.params[:1])
        dt1 = (time.perf_counter() - t0) / 5
        print(
            json.dumps(
                {
                    "metric": "subset_gn_solves_per_s_single_dispatch",
                    "value": round(num_subsets / dt1, 1),
                    "unit": "solves/s",
                }
            )
        )


if __name__ == "__main__":
    main()

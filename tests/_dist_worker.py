"""Worker for the 2-process jax.distributed test (test_parallel.py).

Spawned twice by test_init_distributed_two_process_cpu_mesh; each process
owns 4 virtual CPU devices, init_distributed() forms the 8-device cluster
(the REAL codepath of parallel.mesh.init_distributed — everything else in
the suite only covers its single-host no-op), and the sharded solve over
the cross-process mesh must match a locally computed unsharded reference
on every addressable shard.
"""

import os
import sys

proc_id = int(sys.argv[1])
port = sys.argv[2]

os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

from correlation_jax.parallel.mesh import (  # noqa: E402
    init_distributed,
    make_mesh,
)

assert init_distributed(
    coordinator_address=f"127.0.0.1:{port}",
    num_processes=2,
    process_id=proc_id,
)
assert jax.process_count() == 2, jax.process_count()
assert jax.device_count() == 8, jax.device_count()
assert jax.local_device_count() == 4, jax.local_device_count()

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from correlation_jax.config import (  # noqa: E402
    FittingModel,
    Interpolation,
    PyramidConfig,
    SolverConfig,
)
from correlation_jax.domains import make_batch  # noqa: E402
from correlation_jax.engine import correlate  # noqa: E402
from correlation_jax.ops.pyramid import build_pyramid  # noqa: E402
from synthetic import Speckle  # noqa: E402


def _grid(x0, y0, x1, y1):
    gx, gy = np.meshgrid(
        np.arange(x0, x1 + 1), np.arange(y0, y1 + 1), indexing="ij"
    )
    return np.stack([gx.ravel(), gy.ravel()], -1).astype(np.float32)


spk = Speckle(96, 96, seed=17)
und = spk.image(quantize=True)[..., None]
dfm = spk.warped_image(u=0.8, v=-0.6, quantize=True)[..., None]

cfg = SolverConfig(
    model=FittingModel.UV,
    interpolation=Interpolation.BICUBIC,
    pyramid=PyramidConfig(0, 1, 1),
    precision=1e-5,
)
pts = [
    _grid(cx - 7, cy - 7, cx + 7, cy + 7)
    for cy in (24, 40, 56, 72)
    for cx in (24, 40, 56, 72)
]  # 16 sectors: 2 per device across the 8-device cluster
batch = make_batch(pts, None, 1)
und_pyr = build_pyramid(jnp.asarray(und), 1)
def_pyr = build_pyramid(jnp.asarray(dfm), 1)
p0 = np.zeros((batch.num_subsets, 2), np.float32)

# Per-process local reference (no mesh): identical inputs on both
# processes make it a valid global reference.
ref = correlate(cfg, und_pyr, def_pyr, batch, p0)
ref_np = {
    "params": np.asarray(ref.params),
    "chi": np.asarray(ref.chi),
    "error": np.asarray(ref.error),
}

mesh = make_mesh()  # spans BOTH processes
assert mesh.devices.size == 8
res = correlate(cfg, und_pyr, def_pyr, batch, p0, mesh=mesh)

checked = 0
for name, garr in (
    ("params", res.params),
    ("chi", res.chi),
    ("error", res.error),
):
    for sh in garr.addressable_shards:
        got = np.asarray(sh.data)
        want = ref_np[name][sh.index]
        if name == "error":
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, atol=2e-5, rtol=1e-5)
        checked += 1
assert checked >= 6, checked  # each process holds half the shards

print(f"DIST_OK {proc_id} shards={checked}", flush=True)

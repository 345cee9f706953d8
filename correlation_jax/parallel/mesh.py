"""Device-mesh scaling of the subset batch.

The reference is a single-process, single-device app (its multi-GPU support
is vestigial — cuda_class.cu:58-62, kernels.cu:42-53 never launched).  Here
scaling is native: the subset axis [S] shards over a 1-D
`jax.sharding.Mesh`; every per-subset quantity (points, masks, parameters,
LM state) partitions with it, and images and coefficient fields replicate.
The engine runs each device's shard under `shard_map` (engine.correlate,
engine.correlate_frames), so every device drives its own LM loops and no
collective runs per iteration.

Data parallelism over subsets plus optional pixel sharding with psum for
huge single subsets (see correlation_jax.parallel.collectives) are the two
meaningful parallel axes of this workload (SURVEY.md §2.3).
"""

from __future__ import annotations

import numpy as np
import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from correlation_jax.domains import SubsetBatch

SUBSET_AXIS = "subsets"


def init_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    **kwargs,
) -> bool:
    """Initialize jax.distributed for a multi-host run.

    Multi-host is the scaling axis the single-node reference never had
    (SURVEY.md §2.3-4: its multi-GPU path is vestigial).  Call once per
    process before any other jax use; afterwards make_mesh() spans every
    device of every process and the subset axis shards across hosts.

    No-op (returns False) when neither arguments nor the standard cluster
    environment variables announce a multi-process setting, so single-host
    runs need no special casing.
    """
    import os

    import jax

    env_says_cluster = any(
        os.environ.get(k)
        for k in ("JAX_COORDINATOR_ADDRESS", "COORDINATOR_ADDRESS")
    )
    if coordinator_address is None and num_processes is None and not env_says_cluster:
        return False
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
        **kwargs,
    )
    return True


def make_mesh(devices=None) -> Mesh:
    """1-D mesh over all (or the given) devices."""
    if devices is None:
        devices = jax.devices()
    return Mesh(np.array(devices), (SUBSET_AXIS,))


def pad_to_mesh(batch: SubsetBatch, mesh: Mesh) -> SubsetBatch:
    """Pad the subset axis to a multiple of the mesh size.

    Padding subsets are fully masked (n_points == 0) and resolve to
    BAD_DOMAIN frozen lanes in the engine — they cost one lane of wasted
    compute and are dropped by the caller.
    """
    n = mesh.devices.size
    s = batch.num_subsets
    target = -(-s // n) * n
    if target == s:
        return batch
    pad = target - s

    def pad_s(a):
        widths = [(0, pad)] + [(0, 0)] * (a.ndim - 1)
        return np.pad(a, widths)

    return SubsetBatch(
        xy=[pad_s(np.asarray(a)) for a in batch.xy],
        mask=[pad_s(np.asarray(a)) for a in batch.mask],
        center0=pad_s(np.asarray(batch.center0)),
        extents=batch.extents,  # padding rows are fully masked
    )


def shard_inputs(mesh: Mesh, batch: SubsetBatch, params0):
    """device_put the batch with the subset axis partitioned.

    Returns (xy_levels, mask_levels, center0, params0) as sharded jax arrays
    ready for engine.correlate / _correlate_jit — jit then propagates the
    sharding through the whole LM program.
    """
    sharded = NamedSharding(mesh, P(SUBSET_AXIS))
    xy = [jax.device_put(a, sharded) for a in batch.xy]
    mask = [jax.device_put(a, sharded) for a in batch.mask]
    center0 = jax.device_put(batch.center0, sharded)
    params0 = jax.device_put(np.asarray(params0, np.float32), sharded)
    return xy, mask, center0, params0


def replicate(mesh: Mesh, tree):
    """Replicate images / pyramids across the mesh."""
    rep = NamedSharding(mesh, P())
    return jax.tree_util.tree_map(lambda a: jax.device_put(a, rep), tree)

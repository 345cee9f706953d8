from correlation_jax.parallel.mesh import (
    SUBSET_AXIS,
    make_mesh,
    pad_to_mesh,
    shard_inputs,
)

__all__ = ["SUBSET_AXIS", "make_mesh", "pad_to_mesh", "shard_inputs"]

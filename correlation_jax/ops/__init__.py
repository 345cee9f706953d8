from correlation_jax.ops.interp import (
    InterpField,
    precompute_field,
    sample_field,
    sample_integer,
)
from correlation_jax.ops.pyramid import build_pyramid, BINOMIAL_1D
from correlation_jax.ops.assemble import assemble_normal_equations
from correlation_jax.ops.solve import lm_delta

__all__ = [
    "InterpField",
    "precompute_field",
    "sample_field",
    "sample_integer",
    "build_pyramid",
    "BINOMIAL_1D",
    "assemble_normal_equations",
    "lm_delta",
]

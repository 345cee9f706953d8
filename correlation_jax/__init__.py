"""correlation_jax — a batched Digital Image Correlation framework in JAX.

A from-scratch reimplementation of the capabilities of namascar/correlation
(Lucas-Kanade DIC via Levenberg-Marquardt damped Gauss-Newton over parametric
subset warps) redesigned for batched accelerators:

* thousands of subsets are batched as a leading array axis and solved
  simultaneously inside one jit'd program (the reference solves sectors
  serially, see the reference's manager_class.cpp:304-547),
* subpixel interpolation coefficients are precomputed as a coefficient field
  via one convolution (the batched analog of the per-pixel memoization in
  interpolation_class.cpp:228-241),
* Gauss-Newton normal equations are assembled with batched matmuls and solved
  with batched Cholesky factorizations,
* per-subset divergent LM control flow runs as a masked lax.while_loop,
* the subset axis shards over a jax device Mesh for multi-chip scaling.
"""

from correlation_jax.config import (
    FittingModel,
    Interpolation,
    DeformationDescription,
    ErrorMode,
    ReferenceImage,
    ErrorCode,
    SolverConfig,
    PyramidConfig,
)
from correlation_jax.engine import (
    correlate,
    correlate_many,
    CorrelationResult,
)
from correlation_jax.domains import combine_batches, split_result
from correlation_jax.sequence import SequenceConfig, run_sequence

__version__ = "0.1.0"

__all__ = [
    "FittingModel",
    "Interpolation",
    "DeformationDescription",
    "ErrorMode",
    "ReferenceImage",
    "ErrorCode",
    "SolverConfig",
    "PyramidConfig",
    "SequenceConfig",
    "correlate",
    "correlate_many",
    "combine_batches",
    "split_result",
    "CorrelationResult",
    "run_sequence",
]

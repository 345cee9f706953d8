"""Configuration enums and dataclasses.

Replaces the reference's three-tier config system (compile-time defines.hpp,
GUI widgets, runtime setters — see the reference's enums.hpp and
mainapp.cpp:192-210 for the defaults) with plain dataclasses
usable from Python and the CLI.
"""

from __future__ import annotations

import dataclasses
import enum


class FittingModel(enum.IntEnum):
    """Warp models (reference: enums.hpp:17-23).

    U            : 1 parameter  (x translation)
    UV           : 2 parameters (x,y translation)
    UVQ          : 3 parameters (translation + small rotation about the center)
    AFFINE       : 6 parameters (UVUxUyVxVy — affine about the center)
    """

    U = 0
    UV = 1
    UVQ = 2
    AFFINE = 3


NUM_PARAMS = {
    FittingModel.U: 1,
    FittingModel.UV: 2,
    FittingModel.UVQ: 3,
    FittingModel.AFFINE: 6,
}


class Interpolation(enum.IntEnum):
    """Subpixel interpolation models (reference: enums.hpp:10-15)."""

    NEAREST = 0
    BILINEAR = 1
    BICUBIC = 2


class DeformationDescription(enum.IntEnum):
    """How the undeformed domain evolves across frames (enums.hpp:73-78)."""

    STRICT_LAGRANGIAN = 0
    LAGRANGIAN = 1
    EULERIAN = 2


class ErrorMode(enum.IntEnum):
    """Error-handling policy for a multi-frame run (enums.hpp:80-85)."""

    STOP_ALL = 0
    STOP_FRAME = 1
    CONTINUE = 2


class ReferenceImage(enum.IntEnum):
    """Which frame is the undeformed reference (enums.hpp:87-91)."""

    FIRST = 0
    PREVIOUS = 1


class DomainType(enum.IntEnum):
    """Correlation domain shapes (enums.hpp:43-48)."""

    RECTANGULAR = 0
    ANNULAR = 1
    BLOB = 2


class ErrorCode(enum.IntEnum):
    """Per-subset error codes (reference: enums.hpp:25-35)."""

    NONE = 0
    MODEL_OUT_OF_IMAGE = 1
    INTERPOLATION_OUT_OF_IMAGE = 2
    MAX_ITERS_REACHED = 3
    BAD_DOMAIN = 4
    SOLVER = 5
    DEVICE = 6
    MULTITHREAD = 7


@dataclasses.dataclass(frozen=True)
class PyramidConfig:
    """Coarse-to-fine pyramid schedule.

    Levels are visited stop, stop-step, ..., start (coarse to fine), exactly
    like the reference loop (correlation_class.cpp:373-374).  Defaults match
    mainapp.cpp:192-201 (start/step/stop = 0/1/2).
    """

    start: int = 0
    step: int = 1
    stop: int = 2

    def levels_coarse_to_fine(self) -> list[int]:
        return list(range(self.stop, self.start - 1, -self.step))

    def __post_init__(self):
        if self.step <= 0 or self.start < 0 or self.stop < self.start:
            raise ValueError(f"invalid pyramid schedule {self}")


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    """LM/Gauss-Newton solver settings.

    Defaults mirror the reference (mainapp.cpp:204,208 for max_iters/precision;
    correlation_class.cpp:385-387,523,556,570 for the lambda schedule).
    """

    model: FittingModel = FittingModel.AFFINE
    interpolation: Interpolation = Interpolation.BICUBIC
    pyramid: PyramidConfig = dataclasses.field(default_factory=PyramidConfig)
    max_iterations: int = 50
    precision: float = 1e-3
    lambda_init: float = 1e-4
    lambda_min: float = 1e-9
    lambda_max: float = 1e9
    lambda_up: float = 10.0
    lambda_down: float = 0.4
    # Assembly backend (engine.resolve_backend): "xla" = coefficient field
    # + gather (no tile-extent limits on the warp), "xla_sep" = gather-free
    # separable tiles, "auto" = the one measured faster on the GPU.
    backend: str = "auto"
    # Extra pixels of warp headroom in the xla_sep backend's image tiles
    # (beyond the subset extent + spline halo + alignment slack): warps
    # that grow the subset span by more than this flag the subset
    # out-of-image.
    tile_margin: int = 8
    # Straggler compaction (per-subset early stop on a batched device —
    # the analog of the reference's free per-sector stop at
    # correlation_class.cpp:580-585): the full-batch LM loop runs only
    # until the still-active subsets fit 1/compact_factor of the batch,
    # then they gather into a dense prefix and iteration continues on the
    # smaller batch, repeated compact_stages times.  compact_min floors
    # the capacity (compaction overhead beats assembly cost only above
    # it).  compact_stages=0 disables (monolithic while_loop).
    compact_stages: int = 6
    compact_factor: int = 2
    compact_min: int = 128

    @property
    def num_params(self) -> int:
        return NUM_PARAMS[self.model]

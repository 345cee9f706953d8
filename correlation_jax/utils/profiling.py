"""Tracing and throughput metering.

The reference instruments with NVTX ranges for nvvp (cuda_class.cu:133-319)
and compile-time wall-clock accumulators (DEBUG_TIME_* flags,
defines.hpp:57-72).  Equivalents here: jax.profiler trace annotations (viewable
in TensorBoard / Perfetto) and an always-on solves/s meter.
"""

from __future__ import annotations

import contextlib
import re
import time

import jax


@contextlib.contextmanager
def trace_region(name: str):
    """Annotate a host-side region in the jax profiler trace (NVTX analog)."""
    with jax.profiler.TraceAnnotation(name):
        yield


class SolveMeter:
    """Accumulates subsets-solved and wall time; reports solves/s."""

    def __init__(self):
        self.subsets = 0
        self.seconds = 0.0
        self.frames = 0

    @contextlib.contextmanager
    def measure(self, num_subsets: int):
        t0 = time.perf_counter()
        yield
        self.seconds += time.perf_counter() - t0
        self.subsets += num_subsets
        self.frames += 1

    @property
    def solves_per_s(self) -> float:
        return self.subsets / self.seconds if self.seconds else 0.0

    def summary(self) -> str:
        return (
            f"{self.subsets} subset solves over {self.frames} frames in "
            f"{self.seconds:.3f}s = {self.solves_per_s:.1f} solves/s"
        )


def start_trace(logdir: str):
    jax.profiler.start_trace(logdir)


def stop_trace():
    jax.profiler.stop_trace()


_COLLECTIVE = re.compile(
    r" (all-reduce|all-gather|reduce-scatter|collective-permute|"
    r"all-to-all)(-start)?\("
)


def hlo_loop_collectives(hlo: str) -> tuple[int, int]:
    """(collective ops in a compiled HLO module's text, those inside a
    while loop's condition or body — i.e. run once per LM iteration)."""
    loops = set()
    for cond, body in re.findall(
        r"condition=%?([\w.\-]+), body=%?([\w.\-]+)", hlo
    ):
        loops |= {cond, body}
    comp, total, in_loop = None, 0, 0
    for line in hlo.splitlines():
        head = re.match(r"^(?:ENTRY )?%?([\w.\-]+) ", line)
        if head and line.rstrip().endswith("{"):
            comp = head.group(1)
        if _COLLECTIVE.search(line):
            total += 1
            in_loop += comp in loops
    return total, in_loop

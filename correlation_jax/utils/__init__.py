from correlation_jax.utils.profiling import SolveMeter, trace_region

__all__ = ["SolveMeter", "trace_region"]

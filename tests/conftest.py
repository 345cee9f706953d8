"""Test configuration: run everything on a virtual 8-device CPU mesh.

Multi-device sharding is validated without accelerators by faking 8 XLA
host devices; set before any jax import.  The persistent compilation
cache stays off so test runs leave nothing behind.
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["JAX_ENABLE_COMPILATION_CACHE"] = "false"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

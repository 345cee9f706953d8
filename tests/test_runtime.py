"""Where the program keeps its compile cache, and the GPU smoke test's
refusal to run on anything but a GPU."""

import os
import subprocess
import sys

import jax
import pytest

from correlation_jax.utils.compile_cache import (
    DEFAULT_DIR,
    enable_compile_cache,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_compile_cache_defaults_to_ignored_checkout_dir(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    old = jax.config.jax_compilation_cache_dir
    try:
        path = enable_compile_cache()
        assert path == DEFAULT_DIR == os.path.join(REPO, ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == path
    finally:
        jax.config.update("jax_compilation_cache_dir", old)
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


def test_compile_cache_lands_in_env_dir(tmp_path):
    """With JAX_COMPILATION_CACHE_DIR set, the helper configures nothing
    else and a fresh process's compiled programs land in that dir."""
    env = dict(os.environ)
    env["JAX_COMPILATION_CACHE_DIR"] = str(tmp_path)
    env["JAX_ENABLE_COMPILATION_CACHE"] = "true"
    env["JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS"] = "0"
    env["JAX_PLATFORMS"] = "cpu"
    code = (
        "import jax, jax.numpy as jnp\n"
        "from correlation_jax.utils.compile_cache import "
        "enable_compile_cache\n"
        "print(enable_compile_cache())\n"
        "print(jax.config.jax_compilation_cache_dir)\n"
        "jax.jit(lambda x: jnp.sin(x) * 3)(jnp.ones(5)).block_until_ready()\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], env=env, cwd=REPO, text=True,
        capture_output=True, timeout=240,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == [str(tmp_path)] * 2
    assert os.listdir(tmp_path)


def test_chip_smoke_refuses_the_cpu():
    """The smoke test exits non-zero on a CPU backend instead of
    carrying on there."""
    sys.path.insert(0, REPO)
    import chip_smoke

    assert jax.devices()[0].platform == "cpu"
    with pytest.raises(SystemExit) as exc:
        chip_smoke.require_gpu()
    assert exc.value.code not in (0, None)

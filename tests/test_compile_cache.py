"""Compile-cache rule (andix/__init__.py): JAX_COMPILATION_CACHE_DIR wins
with no override in code; otherwise a fixed, git-ignored directory inside
the checkout; none on the CPU platform."""

import os
import subprocess
import sys

import pytest

import andix

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize(
    "environ,want",
    [
        ({}, andix.CACHE_DIR),
        ({"JAX_PLATFORMS": "cuda"}, andix.CACHE_DIR),
        ({"JAX_PLATFORMS": "cpu"}, None),
        ({"JAX_COMPILATION_CACHE_DIR": "/elsewhere"}, None),
        ({"JAX_COMPILATION_CACHE_DIR": "/elsewhere",
          "JAX_PLATFORMS": "cuda"}, None),
    ],
)
def test_cache_dir_rule(environ, want):
    assert andix.compile_cache_dir(environ) == want


def test_default_cache_dir_is_in_checkout_and_ignored():
    assert os.path.dirname(andix.CACHE_DIR) == REPO_ROOT
    with open(os.path.join(REPO_ROOT, ".gitignore")) as f:
        ignored = f.read().split()
    assert os.path.basename(andix.CACHE_DIR) + "/" in ignored


def _run(code, **env):
    full = {k: v for k, v in os.environ.items()
            if k not in ("JAX_COMPILATION_CACHE_DIR", "JAX_PLATFORMS")}
    full.update(env, PYTHONPATH=REPO_ROOT)
    return subprocess.run(
        [sys.executable, "-c", code], env=full, capture_output=True,
        text=True, timeout=300, cwd=REPO_ROOT,
    )


def test_env_dir_receives_compiled_entries(tmp_path):
    out = _run(
        "import andix, jax, jax.numpy as jnp\n"
        "jax.jit(lambda x: x * 2 + 1)(jnp.arange(10)).block_until_ready()\n"
        "print(jax.config.jax_compilation_cache_dir)\n",
        JAX_PLATFORMS="cpu", JAX_COMPILATION_CACHE_DIR=str(tmp_path),
        JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS="0",
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == str(tmp_path)
    assert any(p.name.endswith("-cache") for p in tmp_path.iterdir())


def test_accelerator_run_uses_checkout_dir():
    # importing andix configures the cache without touching a device
    out = _run(
        "import andix, jax; print(jax.config.jax_compilation_cache_dir)",
        JAX_PLATFORMS="cuda",
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == andix.CACHE_DIR

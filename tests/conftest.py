"""Test harness config: CPU JAX with 8 virtual devices so sharding tests
run without an accelerator (SURVEY.md test strategy §4).  Tests marked
``gpu`` need the card: run them there with
``JAX_PLATFORMS=cuda python -m pytest -m gpu tests/``."""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
os.environ.setdefault("ANDIX_MIN_BUCKET", "1024")  # small pads for test sizes
xla_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in xla_flags:
    os.environ["XLA_FLAGS"] = (
        xla_flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import numpy as np
import pytest


@pytest.fixture
def gpu_device():
    """The first GPU, or a skip where JAX sees none (decided here, at test
    time, so every xdist worker collects the same tests)."""
    import jax

    devs = [d for d in jax.devices() if d.platform == "gpu"]
    if not devs:
        pytest.skip("needs an NVIDIA GPU (run with JAX_PLATFORMS=cuda)")
    return devs[0]


@pytest.fixture
def rng():
    return np.random.default_rng(12345)


NUCL = np.frombuffer(b"ACGT", dtype=np.uint8)


def random_dna(rng, n):
    return NUCL[rng.integers(0, 4, n)]


def mutate(rng, seq, rate):
    """Substitute each site with prob ``rate`` to a uniformly different base
    (the reference's test generator semantics, test/test_fasta.cxx:49-55
    with -r raw rate)."""
    codes = np.searchsorted(NUCL, seq)
    hit = rng.random(len(seq)) < rate
    shift = rng.integers(1, 4, len(seq))
    return NUCL[(codes + np.where(hit, shift, 0)) % 4]


@pytest.fixture
def dna():
    return random_dna


@pytest.fixture
def mutator():
    return mutate


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_per_module():
    """Release compiled executables between test modules: the full suite
    accumulates hundreds of XLA:CPU programs across 227 tests and the
    compiler segfaulted (LLVM OOM) in the last module twice; per-module
    cache clearing keeps peak host memory bounded."""
    yield
    import jax

    jax.clear_caches()

"""andix — anchor-distance engine on an accelerator, in JAX.

A JAX/XLA framework with the capabilities of EvolBioInf/andi:
alignment-free estimation of evolutionary distances between closely related
genomes via the anchor-distance method (Haubold, Klötzl & Pfaffelhuber 2015).

Architecture (accelerator-first, not a port):

* Enhanced-suffix-array construction (reference: ``src/esa.c``) is recast as a
  prefix-doubling rank-sort over a *generalized* suffix array of all subject
  strings, built with ``jax.lax.sort`` on device (``andix.esa.doubling``).
* The per-query-position longest-match search (``src/esa.c:441-656``,
  ``get_match_cached``) becomes *matching statistics for every query position
  at once*, computed with segmented min-scans over the joint SA/LCP arrays
  (``andix.esa.matchstats``).  No pointer-chasing tree descent.
* The path-dependent anchor-chaining scan (``src/process.c:141-214``,
  ``dist_anchor``) runs as a lock-step device walk that records anchor
  events; a small native C++ host runtime (``andix.chain``) counts from
  them, preserving reference semantics exactly (lucky anchors, diagonal
  pairing, skip advance).
* Distance estimators and the multinomial bootstrap (``src/model.c``) are
  float64 host math with a seedable PRNG (``andix.model``) — fixing the
  reference's irreproducible ``time(NULL)`` seeding (``src/andi.c:272-279``).
* The N×N pair grid shards across a device mesh by subject blocks
  (``andix.parallel``), the device equivalent of the OpenMP loops in
  ``src/dist_hack.h``.
"""

__version__ = "0.1.0"

import os as _os

# Multi-host init MUST precede everything else: several andix modules
# create jnp constants at import time, which initializes the XLA backend,
# after which jax.distributed.initialize refuses to run.
from ._distributed import maybe_init_distributed as _maybe_init_distributed

_maybe_init_distributed()

import jax

# Estimator math must be float64 to match the reference's C doubles
# (SURVEY.md §7 "Numerics").  Integer sort keys in the doubling kernel use
# multi-key int32 sorts, so x64 is not required on the hot path; enabling it
# globally only affects tiny host-side reductions.
jax.config.update("jax_enable_x64", True)

# Persistent compile cache.  All device entry points use padded shape
# buckets, so a run recompiles only what no earlier run in this checkout
# compiled.  JAX itself honours JAX_COMPILATION_CACHE_DIR; without it the
# cache lives at a fixed path inside the checkout (part of the cache key,
# so it must not move).  CPU runs (the test suite) keep no cache: their
# compiles are fast and must not fill the checkout.
CACHE_DIR = _os.path.join(
    _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))),
    ".jax_cache",
)


def compile_cache_dir(environ=_os.environ) -> str | None:
    """The directory andix sets as JAX's compile cache, or None when it
    sets none (JAX_COMPILATION_CACHE_DIR given, or the CPU platform)."""
    if environ.get("JAX_COMPILATION_CACHE_DIR"):
        return None
    if (environ.get("JAX_PLATFORMS") or "").split(",")[0] == "cpu":
        return None
    return CACHE_DIR


if compile_cache_dir() is not None:
    jax.config.update("jax_compilation_cache_dir", compile_cache_dir())
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)

"""Doubling-sort attack A/B: can a radix-partition round beat lax.sort on
this device?

Measures, at 25M rows (the doubling round's shape):
  1. lax.sort, 1 int32 key                      (the floor)
  2. lax.sort, int64 key + int32 payload        (the actual doubling op)
  3. ONE stable radix-partition round by an 8-bit digit — histogram +
     exclusive scan + scatter — the building block of any LSD radix sort
     (a 50-bit doubling key needs ~7 such rounds)
  4. raw random-scatter throughput (the partition round's binding
     primitive)

If one partition round costs more than ~1/7 of the full lax.sort, radix
is dead on this platform regardless of kernel language — the scatter is
the wall, not the sorting network.
"""
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

import andix  # noqa: F401  (x64 + platform config)
import jax
import jax.numpy as jnp


def sync(a):
    return int(np.asarray(jax.device_get(a)).ravel()[0])


def timed(fn, *args, reps=3):
    out = fn(*args)
    sync(out[0] if isinstance(out, tuple) else out[:1])
    best = 1e9
    for _ in range(reps):
        t0 = time.time()
        out = fn(*args)
        sync(out[0] if isinstance(out, tuple) else out[:1])
        best = min(best, time.time() - t0)
    return best


@jax.jit
def sort1(k):
    return jnp.sort(k)


@jax.jit
def sort_kv(k, v):
    return jax.lax.sort((k, v), num_keys=1)


@jax.jit
def digit_hist(k, shift):
    """The radix COUNTING pass: 256-bin histogram via scatter-add."""
    digit = ((k >> shift) & 255).astype(jnp.int32)
    return jnp.zeros(256, jnp.int32).at[digit].add(1)


@jax.jit
def raw_scatter(k, v, idx):
    """The radix OUTPUT pass (both operands moved to computed slots) —
    a strict lower bound for one partition round even with FREE
    per-digit ranks.  (XLA cannot express the stable rank without a
    256xN one-hot cumsum — 100+ GB at 25M rows — or a sort; a Pallas
    kernel could rank in on-chip memory, but it still ends in this
    scatter.)"""
    return (
        jnp.zeros_like(k).at[idx].set(k),
        jnp.zeros_like(v).at[idx].set(v),
    )


def main():
    n = 25 * 1024 * 1024
    rng = np.random.default_rng(0)
    k32 = jnp.asarray(rng.integers(0, 1 << 31, n).astype(np.int32))
    k64 = jnp.asarray(rng.integers(0, 1 << 50, n).astype(np.int64))
    v = jnp.asarray(np.arange(n, dtype=np.int32))
    perm = jnp.asarray(rng.permutation(n).astype(np.int32))

    out = {}
    out["sort_1key_int32_s"] = round(timed(sort1, k32), 4)
    out["sort_int64key_payload_s"] = round(timed(sort_kv, k64, v), 4)
    out["digit_hist_s"] = round(
        timed(lambda a: digit_hist(a, 0), k32), 4
    )
    out["partition_scatter_s"] = round(
        timed(raw_scatter, k64, v, perm), 4
    )
    out["n"] = n
    out["rounds_needed_50bit_key"] = 7
    lower = out["digit_hist_s"] + out["partition_scatter_s"]
    out["radix_round_lower_bound_s"] = round(lower, 4)
    ratio = 7 * lower / out["sort_int64key_payload_s"]
    out["verdict"] = (
        f"7 rounds x {lower:.3f}s lower bound = {ratio:.1f}x the full "
        f"lax.sort ({out['sort_int64key_payload_s']:.3f}s): "
        + ("radix could win — build the Pallas kernel"
           if ratio < 1 else
           "radix is dead on this platform even with free ranks — the "
           "scatter/hist passes alone exceed lax.sort")
    )
    print(json.dumps(out, indent=1))
    with open("MICROBENCH_SORT.json", "w") as f:
        json.dump(out, f, indent=1)


if __name__ == "__main__":
    main()

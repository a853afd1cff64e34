"""Per-iteration cost anatomy of the replay while_loop on the device.

Times stripped-down while_loops (30k iterations, [8,8] lanes) that each add
one ingredient of the production replay body:

  base        — counter only
  g64         — one [8,8] gather from a [8, QB] table
  g64x10      — ten such gathers (probe-phase scale)
  chunk1      — one [8,8,256] text gather from [N]
  chunk2+hist — two [8,8,256] gathers + the 16-cell one-hot histogram
  lce         — one rmq.range_min probe ([8,8] lanes)
  cond_skip   — a cond whose predicate is always False around chunk2+hist
                (does gating actually skip the work?)

Writes results to MICROBENCH_REPLAY.json.
"""

import json
import os
import sys
import time

out = sys.argv[1] if len(sys.argv) > 1 else "MICROBENCH_REPLAY.json"
N = 25165824
QB = 8388608
ITERS = 30000

import jax
import jax.numpy as jnp
import numpy as np

from andix.esa import rmq

results = {"platform": jax.devices()[0].platform, "iters": ITERS}


def log(msg):
    print(msg, file=sys.stderr, flush=True)
    with open(out + ".log", "a") as f:
        f.write(msg + "\n")


def sync(a):
    return int(np.asarray(jax.device_get(a)).ravel()[0])


key = jax.random.PRNGKey(0)
text = jax.random.randint(key, (N,), 65, 85, dtype=jnp.int32)
table = jax.random.randint(key, (8, QB), 0, QB, dtype=jnp.int32)
lcp = jax.random.randint(key, (N,), 0, 1000, dtype=jnp.int32)
rm = rmq.build(lcp)
offs = jnp.arange(256, dtype=jnp.int32)


def run(label, body_extra, n_iters=ITERS):
    # text/table/rm must be jit ARGUMENTS: closure constants get embedded
    # in the program upload and the remote compile rejects >100MB bodies
    @jax.jit
    def loop(n, text, table, rm):
        def body(st):
            i, x = st
            x = body_extra(i, x, text, table, rm)
            return i + 1, x

        def cond(st):
            return st[0] < n

        z = jnp.zeros((8, 8), jnp.int32)
        i, x = jax.lax.while_loop(cond, body, (jnp.int32(0), z))
        return x[0, :1] + i

    t0 = time.time()
    sync(loop(jnp.int32(100), text, table, rm))
    log(f"  {label} compile+100: {time.time()-t0:.2f}s")
    t0 = time.time()
    sync(loop(jnp.int32(n_iters), text, table, rm))
    dt = time.time() - t0
    us = dt / n_iters * 1e6
    results[label] = {"s": round(dt, 3), "us_per_iter": round(us, 2)}
    log(f"  {label}: {dt:.2f}s = {us:.1f}us/iter")


run("base", lambda i, x, text, table, rm: x + 1)

run("g64", lambda i, x, text, table, rm: x + jnp.take_along_axis(
    table, (x + i) % QB, axis=1)[:, :8])


def g64x10(i, x, text, table, rm):
    for _ in range(10):
        x = (x + jnp.take_along_axis(table, (x + i) % QB, axis=1)[:, :8]) % QB
    return x

run("g64x10", g64x10)


def chunk1(i, x, text, table, rm):
    base_idx = (x[..., None] + i + offs) % N
    s = text[base_idx]
    return x + s.sum(axis=-1, dtype=jnp.int32) % 7

run("chunk1", chunk1)


_DIAG = jnp.arange(16, dtype=jnp.int32)


def chunk2hist(i, x, text, table, rm):
    b = (x[..., None] + i + offs) % N
    s = text[b]
    q = text[(b + 13) % N]
    idx = ((s & 6) >> 1 << 2) | ((q & 6) >> 1)
    onehot = (idx[..., None] == _DIAG) & (offs < 200)[None, None, :, None]
    h = onehot.sum(axis=-2, dtype=jnp.int32)
    return x + h[..., 0]

run("chunk2hist", chunk2hist)


def lce(i, x, text, table, rm):
    lo = (x + i) % (N - 2000)
    hi = lo + (x % 1000)
    return x + rmq.range_min(rm, lo, hi) % 5

run("lce", lce)


def cond_skip(i, x, text, table, rm):
    return jax.lax.cond(
        i < -1, lambda x: chunk2hist(i, x, text, table, rm),
        lambda x: x, x)

run("cond_skip", cond_skip)

with open(out, "w") as f:
    json.dump(results, f, indent=1)
log("DONE")

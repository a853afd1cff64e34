"""Device/host-link microbenchmark: separates transfer cost from device
compute.

Measures, on the default JAX backend:

* link latency  — tiny-scalar dispatch+readback round trips,
* H2D bandwidth — packed-text-sized uploads,
* D2H bandwidth — full-array downloads,
* device primitives at the production bench shape (N = bucket(24M)):
  multi-key sort, random gather/scatter, flag scan, RMQ build,
  level-walk-style gather pass, while_loop iteration overhead.

Every timed op REDUCES ON DEVICE to a tiny array before readback, so the
timing isolates device compute + one link round trip (~latency), not a
100 MB D2H.  Reductions use jnp.sum over the full result to defeat DCE.

Writes one JSON object to MICROBENCH.json (path via argv[1]) and appends
progress lines to MICROBENCH.json.log so a stalled run is visible mid-run.
"""

import json
import os
import sys
import time

out_path = sys.argv[1] if len(sys.argv) > 1 else "MICROBENCH.json"
N = int(os.environ.get("MICROBENCH_N", str(25165824)))  # bucket(24M)

import jax
import jax.numpy as jnp
import numpy as np

results = {"platform": jax.devices()[0].platform, "N": N,
           "device": str(jax.devices()[0])}


def log(msg):
    print(msg, file=sys.stderr, flush=True)
    with open(out_path + ".log", "a") as f:
        f.write(msg + "\n")


def sync(arr):
    """Force completion via a small readback.  arr must already be
    tiny."""
    return int(np.asarray(jax.device_get(arr)).ravel()[0])


def timed(label, fn, reps=3, warm=1):
    """fn() must return a TINY device array (on-device reduced)."""
    for _ in range(warm):
        t0 = time.time()
        sync(fn())
        log(f"  {label} warm: {time.time()-t0:.3f}s")
    ts = []
    for _ in range(reps):
        t0 = time.time()
        sync(fn())
        ts.append(time.time() - t0)
    best = min(ts)
    results[label] = {"best_s": round(best, 4),
                      "all_s": [round(t, 4) for t in ts]}
    log(f"  {label}: best {best:.4f}s of {[round(t,3) for t in ts]}")
    return best


t_start = time.time()

# --- 1. link latency -------------------------------------------------------
lat = []
tiny = jnp.zeros(8, jnp.int32)


@jax.jit
def _tiny_add(x):
    return x + 1


sync(_tiny_add(tiny))
for _ in range(5):
    t0 = time.time()
    sync(_tiny_add(tiny))
    lat.append(time.time() - t0)
results["link_latency_s"] = {"median": round(sorted(lat)[2], 4),
                             "all": [round(t, 4) for t in lat]}
log(f"link latency: {results['link_latency_s']}")

# --- 2. H2D / D2H bandwidth ------------------------------------------------
mb = N // 4  # bytes of a 2-bit packed text for N symbols


@jax.jit
def _first(x):
    return jnp.sum(x.astype(jnp.int32))[None]


payload = np.random.randint(0, 255, mb, dtype=np.uint8)
sync(_first(jnp.asarray(payload)))
ts = []
for k in range(3):
    payload[0] = k
    t0 = time.time()
    sync(_first(jnp.asarray(payload)))
    ts.append(time.time() - t0)
best = min(ts)
results["h2d_upload"] = {"bytes": mb, "best_s": round(best, 4),
                         "MBps": round(mb / best / 1e6, 2)}
log(f"h2d {mb/1e6:.1f}MB: best {best:.3f}s = {mb/best/1e6:.1f} MB/s")

key = jax.random.PRNGKey(0)
sym = jax.random.randint(key, (N,), 0, 1 << 20, dtype=jnp.int32)
t0 = time.time()
_ = np.asarray(jax.device_get(sym))
d2h = time.time() - t0
results["d2h_download"] = {"bytes": N * 4, "s": round(d2h, 3),
                           "MBps": round(N * 4 / d2h / 1e6, 2)}
log(f"d2h {N*4/1e6:.0f}MB: {d2h:.2f}s = {N*4/d2h/1e6:.1f} MB/s")

# --- 3. device primitives at N --------------------------------------------
idx = jax.random.randint(key, (N,), 0, N, dtype=jnp.int32)
rank = jax.random.randint(key, (N,), 0, N, dtype=jnp.int32)


def red(x):
    return jnp.sum(x.astype(jnp.int32))[None]


@jax.jit
def sort2(rank, key2):
    r = jax.lax.sort((rank, key2, jnp.arange(N, dtype=jnp.int32)),
                     num_keys=2)
    return red(r[2])


@jax.jit
def sort1(key2):
    r = jax.lax.sort((key2, jnp.arange(N, dtype=jnp.int32)), num_keys=1)
    return red(r[1])


@jax.jit
def sort4(rank, k2, k3, k4):
    r = jax.lax.sort(
        (rank, k2, k3, k4, jnp.arange(N, dtype=jnp.int32)), num_keys=4)
    return red(r[-1])


@jax.jit
def gather(x, i):
    return red(x[i])


@jax.jit
def scatter(x, i):
    return red(jnp.zeros(N, jnp.int32).at[i].set(x))


@jax.jit
def shift_read(x):
    i = jnp.arange(N, dtype=jnp.int32) + 64
    return red(jnp.where(i < N, x[i % N], -1))


@jax.jit
def elementwise(x):
    return red((x * 3 + 1) ^ (x >> 5))


timed("elementwise_N", lambda: elementwise(sym))
timed("sort_1key_N", lambda: sort1(sym))
timed("sort_2key_N", lambda: sort2(rank, sym))
timed("sort_4key_N", lambda: sort4(rank, sym, idx, rank))
timed("gather_random_N", lambda: gather(sym, idx))
timed("scatter_random_N", lambda: scatter(sym, idx))
timed("shift_read_N", lambda: shift_read(sym))

# bucketed-tail-round scale: gathers/sorts at N/4
M = N // 4
idx_m = jax.random.randint(key, (M,), 0, N, dtype=jnp.int32)


@jax.jit
def sort2_m(x, i):
    r = jax.lax.sort((x[:M], i, jnp.arange(M, dtype=jnp.int32)), num_keys=2)
    return red(r[2])


@jax.jit
def gather_m(x, i):
    return red(x[i])

timed("sort_2key_N4", lambda: sort2_m(rank, idx_m))
timed("gather_random_N4_from_N", lambda: gather_m(sym, idx_m))

from andix.esa.scans import flag_scan


@jax.jit
def fscan(v, f, s):
    k, g, sa_, suf = flag_scan(v, f, s)
    return red(suf) + red(g)

flags = (idx & 7) == 0
timed("flag_scan_N", lambda: fscan(sym, flags, rank))

from andix.esa import rmq


@jax.jit
def rmq_build(v):
    rm = rmq.build(v)
    return red(rm.pref8) + red(rm.tg[0])

timed("rmq_build_N", lambda: rmq_build(sym))


@jax.jit
def level_walk_pass(levels1, a, h):
    ai = jnp.minimum(a + h, N - 1)
    bi = jnp.minimum(a + h + 1, N - 1)
    ra = levels1[ai]
    rb = levels1[bi]
    return red(jnp.where(ra == rb, h + 64, h))

timed("lcp_walk_1level_N", lambda: level_walk_pass(rank, idx, sym & 63))

# --- 4. while_loop overhead ------------------------------------------------


@jax.jit
def wloop(n_iters):
    def body(state):
        i, x = state
        return i + 1, x + 1
    def cond(state):
        return state[0] < n_iters
    z = jnp.zeros((8, 8), jnp.int32)
    i, x = jax.lax.while_loop(cond, body, (jnp.int32(0), z))
    return x[0, :1] + i

t0 = time.time()
sync(wloop(jnp.int32(100)))
log(f"  wloop compile+100: {time.time()-t0:.3f}s")
t0 = time.time()
sync(wloop(jnp.int32(10000)))
t_10k = time.time() - t0
t0 = time.time()
sync(wloop(jnp.int32(100)))
t_100 = time.time() - t0
per_iter = (t_10k - t_100) / 9900
results["while_loop_iter_us"] = round(per_iter * 1e6, 2)
log(f"while_loop per-iter: {per_iter*1e6:.1f}us")

small_idx = jax.random.randint(key, (64,), 0, N, dtype=jnp.int32)


@jax.jit
def wloop_gather(n_iters, table, si):
    def body(state):
        i, acc = state
        g = table[(si + i) % N]
        return i + 1, acc + g
    def cond(state):
        return state[0] < n_iters
    i, acc = jax.lax.while_loop(
        cond, body, (jnp.int32(0), jnp.zeros(64, jnp.int32)))
    return acc[:1] + i

t0 = time.time()
sync(wloop_gather(jnp.int32(100), sym, small_idx))
log(f"  wloop_gather compile+100: {time.time()-t0:.3f}s")
t0 = time.time()
sync(wloop_gather(jnp.int32(10000), sym, small_idx))
t_10k = time.time() - t0
results["while_loop_gather_iter_us"] = round(t_10k / 10000 * 1e6, 2)
log(f"while_loop+gather per-iter: {t_10k/10000*1e6:.1f}us")

results["total_s"] = round(time.time() - t_start, 1)
with open(out_path, "w") as f:
    json.dump(results, f, indent=1)
log(f"DONE in {results['total_s']}s -> {out_path}")

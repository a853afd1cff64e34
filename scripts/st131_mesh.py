"""ST131-shaped scale evidence: n>=100 genomes through the PRODUCTION
sharded pair grid on a virtual 8-device mesh, with query chunking forced
(the pneu3085-class schedule), asserting exact equality with the serial
NumPy schedule.  Writes one JSON line.

Genome length is scaled down (CPU mesh emulation; the planner math for the
full 109 x 1 Mbp shape is asserted separately in tests/test_pipeline.py)."""
import json, os, sys, time

os.environ["JAX_PLATFORMS"] = "cpu"
os.environ.setdefault(
    "XLA_FLAGS",
    "--xla_force_host_platform_device_count=8 "
    # per-shard chain walks have data-dependent durations; the CPU
    # backend kills collectives whose participants arrive >40s apart
    "--xla_cpu_collective_timeout_seconds=86400 "
    "--xla_cpu_collective_call_terminate_timeout_seconds=86400",
)
import numpy as np
import jax
jax.config.update("jax_platforms", "cpu")

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from andix import parallel, pipeline
from andix.esa.backend_jax import JaxBackend
from andix.runtime import Context
from andix.sequence import Seq

N = int(os.environ.get("ST131_N", "109"))
L = int(os.environ.get("ST131_LEN", "100000"))
rng = np.random.default_rng(131)
NUCL = np.frombuffer(b"ACGT", dtype=np.uint8)
base = NUCL[rng.integers(0, 4, L)]
seqs = [Seq(base, "g0")]
rates = [0.004, 0.01, 0.02, 0.04, 0.07]
for k in range(1, N):
    codes = np.searchsorted(NUCL, base)
    hit = rng.random(L) < rates[k % len(rates)]
    seqs.append(Seq(NUCL[(codes + np.where(hit, rng.integers(1, 4, L), 0)) % 4], f"g{k}"))

# force query chunking (several chunks) like a >RAM-scale run
os.environ["ANDIX_MAX_QUERY_SYMS"] = str(30 * (L + 1))

calls = {"events": 0}
orig = parallel._host_counts_from_sharded_events
def spy(*a, **k):
    calls["events"] += 1
    return orig(*a, **k)
parallel._host_counts_from_sharded_events = spy

t0 = time.time()
M = pipeline.calculate_matrix(seqs, Context(), JaxBackend())
sharded_s = time.time() - t0
assert calls["events"] > 0, "sharded events path not taken"

t0 = time.time()
Mn = pipeline.calculate_matrix(seqs, Context())
serial_s = time.time() - t0
bad = sum(
    (M[i][j].counts != Mn[i][j].counts).any()
    for i in range(N) for j in range(N)
)
assert bad == 0, f"{bad} mismatching tiles"
pairs = N * N - N
print(json.dumps({
    "metric": f"ST131-shaped sharded grid ({N}x{L//1000}kbp, 8-dev virtual mesh)",
    "value": round(pairs / sharded_s, 3), "unit": "pairs/s (CPU mesh)",
    "pairs": pairs, "sharded_s": round(sharded_s, 1),
    "serial_numpy_s": round(serial_s, 1),
    "events_dispatches": calls["events"],
    "query_chunks_forced": True, "exact_vs_serial": True,
}))

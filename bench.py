"""andix benchmark: genome pairs/sec/device on an eco29-like synthetic family.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", ...} where
the extra keys make the artifact self-explaining:

* ``device``  — platform, device_kind, device count and (on a GPU) the
  card's name and power limit from nvidia-smi.
* ``phases``  — per-phase seconds from a profiled run (the same pipeline,
  waiting for each phase's arrays before its clock is read).
* ``runs``    — every timed end-to-end run: the profiled run goes first
  (absorbing compile-cache loads), the production run is reported.

The JAX backend is measured only on an accelerator: on the CPU platform
the benchmark fails instead of reporting CPU timings.

Config via env:
  ANDIX_BENCH_GENOMES  (default 8)   number of genomes
  ANDIX_BENCH_LENGTH   (default 1_000_000) genome length in bp
  ANDIX_BENCH_BACKEND  (default jax) jax | numpy
  ANDIX_BENCH_PROFILE  (default 1)   0 skips the profiled phase run

Baseline: the only hard number the reference publishes is 0.613 s wall for a
2x1 Mbp pairwise run on one thread (docs/manual/andi-manual.tex:266-279,
recorded in BASELINE.md), i.e. 2/0.613 = 3.26 ordered pairs/s/thread at
1 Mbp.  The north-star target is beating andi on a 64-core node; the manual
measures 1.69x on 2 threads (84% efficiency), so the baseline here is
3.26 * 64 * 0.84 = 175 ordered 1 Mbp-pairs/s for a full 64-core node.
vs_baseline > 1 means one device beats that node estimate.
"""

import json
import os
import sys
import tempfile
import time

import numpy as np

BASELINE_PAIRS_PER_SEC_64CORE = (2.0 / 0.613) * 64 * 0.84  # ~175.4


def sig(x, digits=6):
    from decimal import Decimal

    if x == 0:
        return 0.0
    return float(f"{x:.{digits}g}")


# substitution rate of genome k (k >= 1) against g0, cycled
FAMILY_RATES = (0.005, 0.01, 0.02, 0.03, 0.05, 0.08, 0.12)


def make_family(n_genomes: int, length: int, seed: int = 2026):
    rng = np.random.default_rng(seed)
    nucl = np.frombuffer(b"ACGT", dtype=np.uint8)
    base = nucl[rng.integers(0, 4, length)]
    from andix.sequence import Seq

    seqs = [Seq(base, "g0")]
    for k in range(1, n_genomes):
        rate = FAMILY_RATES[(k - 1) % len(FAMILY_RATES)]
        codes = np.searchsorted(nucl, base)
        hit = rng.random(length) < rate
        mut = nucl[(codes + np.where(hit, rng.integers(1, 4, length), 0)) % 4]
        seqs.append(Seq(mut, f"g{k}"))
    return seqs


def device_record():
    """The device the JAX backend runs on; fails on the CPU platform."""
    import subprocess

    import jax

    dev = jax.devices()[0]
    if dev.platform == "cpu":
        raise SystemExit(
            "bench: the JAX backend is benchmarked on an accelerator only; "
            "JAX sees no GPU"
        )
    rec = {
        "platform": dev.platform,
        "device_kind": dev.device_kind,
        "count": len(jax.devices()),
    }
    if dev.platform == "gpu":
        rec["card"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            check=True, capture_output=True, text=True, timeout=120,
        ).stdout.strip().splitlines()[0]
    return rec


def parse_profile(path):
    """Aggregate 'label: 1.23s' lines by label (summed across blocks)."""
    phases = {}
    try:
        with open(path) as f:
            for line in f:
                if ": " not in line:
                    continue
                label, val = line.rsplit(": ", 1)
                try:
                    secs = float(val.strip().rstrip("s"))
                except ValueError:
                    continue
                phases[label.strip()] = round(
                    phases.get(label.strip(), 0.0) + secs, 3
                )
    except OSError:
        pass
    return phases


def run_once(seqs, backend_name):
    from andix import pipeline
    from andix.runtime import Context

    ctx = Context()
    if backend_name == "jax":
        from andix.esa.backend_jax import JaxBackend

        backend = JaxBackend()
    else:
        backend = pipeline.NumpyBackend()
    t0 = time.time()
    M = pipeline.calculate_matrix(seqs, ctx, backend=backend)
    return M, time.time() - t0


def main() -> int:
    n_genomes = int(os.environ.get("ANDIX_BENCH_GENOMES", "8"))
    length = int(os.environ.get("ANDIX_BENCH_LENGTH", "1000000"))
    backend_name = os.environ.get("ANDIX_BENCH_BACKEND", "jax")
    do_profile = os.environ.get("ANDIX_BENCH_PROFILE", "1") != "0"

    seqs = make_family(n_genomes, length)
    pairs = n_genomes * n_genomes - n_genomes
    runs = []
    phases = {}
    device = device_record() if backend_name == "jax" else {"platform": "host"}

    if do_profile and backend_name == "jax":
        # cold run first: absorbs compiles / persistent-cache loads so the
        # profiled phases and the production number are pure execution
        M, elapsed = run_once(seqs, backend_name)
        runs.append({"kind": "cold", "s": round(elapsed, 2),
                     "pairs_per_s": sig(pairs / elapsed, 4)})
        # profiled warm run: each phase waits for its arrays so the
        # attribution is real
        prof_path = os.path.join(
            tempfile.mkdtemp(prefix="andix-bench-"), "phases.txt"
        )
        os.environ["ANDIX_PROF_FILE"] = prof_path
        M, elapsed = run_once(seqs, backend_name)
        del os.environ["ANDIX_PROF_FILE"]
        phases = parse_profile(prof_path)
        runs.append({"kind": "profiled", "s": round(elapsed, 2),
                     "pairs_per_s": sig(pairs / elapsed, 4)})

    # production runs: warm, no per-phase syncs.  Two runs are timed and
    # the better one is the reported metric — both stay in ``runs``.
    M, elapsed = run_once(seqs, backend_name)
    runs.append({"kind": "production", "s": round(elapsed, 2),
                 "pairs_per_s": sig(pairs / elapsed, 4)})
    if backend_name == "jax" and do_profile:
        M2, elapsed2 = run_once(seqs, backend_name)
        runs.append({"kind": "production", "s": round(elapsed2, 2),
                     "pairs_per_s": sig(pairs / elapsed2, 4)})
        if elapsed2 < elapsed:
            M, elapsed = M2, elapsed2

    # sanity: the matrix must be non-degenerate
    from andix import model as mm

    d01 = mm.estimate_jc(mm.model_average(M[0][1], M[1][0]))
    assert 0.001 < d01 < 0.02, f"bench sanity failed: d(g0,g1)={d01}"

    pairs_per_sec = pairs / elapsed
    # scale baseline to this genome length (andi's scan is ~linear in length)
    baseline = BASELINE_PAIRS_PER_SEC_64CORE * (1_000_000 / length)

    out = {
        "metric": f"ordered genome pairs/sec/device "
        f"({n_genomes}x{length//1000}kbp, JC)",
        "value": sig(pairs_per_sec, 4),
        "unit": "pairs/s",
        "vs_baseline": sig(pairs_per_sec / baseline, 6),
        "runs": runs,
    }
    out["device"] = device
    if phases:
        out["phases"] = phases
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""eco29-shaped end-to-end run (29 x 5 Mbp, full 812-pair matrix) on the
device, with tile-level checkpointing so an interrupted run loses a group
of rows, not the run.

Usage:  python scripts/eco29_run.py OUT.json [CKPT_DIR]

Re-running with the same CKPT_DIR resumes from the completed subject rows
(pipeline.TileCheckpoint; rows are fingerprinted against the inputs).  The
artifact records the device, per-phase timings, and whether the run was a
resume (resumed runs report wall time for the remaining rows only).
"""
import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402


def main() -> int:
    out_path = sys.argv[1] if len(sys.argv) > 1 else "ECO29_run.json"
    ckpt_dir = (
        sys.argv[2]
        if len(sys.argv) > 2
        else os.path.join(tempfile.gettempdir(), "andix-eco29-ckpt")
    )
    n = int(os.environ.get("ANDIX_BENCH_GENOMES", "29"))
    length = int(os.environ.get("ANDIX_BENCH_LENGTH", "5000000"))

    import bench as benchmod
    from andix import pipeline
    from andix.esa.backend_jax import JaxBackend
    from andix.runtime import Context

    device = benchmod.device_record()
    print(f"device: {device}", flush=True)

    seqs = benchmod.make_family(n, length)
    pairs = n * n - n

    prof_path = os.path.join(
        tempfile.mkdtemp(prefix="andix-eco29-"), "phases.txt"
    )
    os.environ["ANDIX_PROF_FILE"] = prof_path

    ctx = Context()
    ctx.checkpoint_dir = ckpt_dir
    fp = pipeline.checkpoint_fingerprint(seqs, ctx)
    pre_rows = 0
    if os.path.isdir(ckpt_dir):
        pre_rows = sum(
            1 for f in os.listdir(ckpt_dir) if f.endswith(".npz")
        )
    print(
        f"checkpoint dir {ckpt_dir}: {pre_rows} rows present", flush=True
    )

    t0 = time.time()
    M = pipeline.calculate_matrix(seqs, ctx, backend=JaxBackend())
    elapsed = time.time() - t0
    phases = benchmod.parse_profile(prof_path)
    del os.environ["ANDIX_PROF_FILE"]


    from andix import model as mm

    d01 = mm.estimate_jc(mm.model_average(M[0][1], M[1][0]))
    assert 0.001 < d01 < 0.02, f"sanity failed: d(g0,g1)={d01}"

    dump = os.environ.get("ANDIX_ECO29_DUMP")
    if dump:
        # full PHYLIP matrix dump for resume-equivalence checks: a
        # killed-and-resumed run must produce byte-identical output
        from io import StringIO

        from andix import output

        buf = StringIO()
        output.print_distances(M, seqs, n, False, ctx, out=buf)
        with open(dump, "w") as f:
            f.write(buf.getvalue())

    pps = pairs / elapsed
    baseline = benchmod.BASELINE_PAIRS_PER_SEC_64CORE * (1_000_000 / length)
    out = {
        "metric": (
            f"ordered genome pairs/sec/chip ({n}x{length // 1000}kbp "
            f"eco29-shaped, JC, full {pairs}-pair matrix)"
        ),
        "value": benchmod.sig(pps, 4),
        "unit": "pairs/s",
        "vs_baseline": benchmod.sig(pps / baseline, 6),
        "pairs": pairs,
        "wall_s": round(elapsed, 1),
        "resumed_rows": pre_rows,
        "checkpoint_dir": ckpt_dir,
        "device": device,
        "phases": phases,
    }
    with open(out_path, "w") as f:
        f.write(json.dumps(out) + "\n")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

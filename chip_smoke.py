"""Bring-up check: andix end to end on one NVIDIA GPU (four with --four).

Drives the CLI in this process (``andix.cli.main``, stdout captured) at
real bacterial genome sizes and fails unless every output matches its
reference:

* pair    2 x 5 Mbp (andi's ``S1.fasta S2.fasta`` deployment): the auto
          schedule on the GPU against ``--backend numpy`` on the host,
          byte-identical PHYLIP;
* family  8 x 5 Mbp: the auto schedule twice (cold, then warm; identical
          output), then the other schedule forced through ``ANDIX_INDEX``
          (identical output); the JC distance of every (g0, gk) pair
          within ``JC_REL_TOL * d + JC_ABS_TOL`` of its simulated rate;
* sorts   how XLA lowered every sort of the run's index builds and event
          packing: CUB radix sort or XLA's comparator sort kernel.

Each report line carries the card's name and power limit.  The last line
of stdout is ``{"ok": true, "device": {...}}``; no phase failure is
caught, so a failed comparison, a missing GPU or a wrong path exits
non-zero without it.

``--four`` runs only the multi-GPU paths on four cards, each against the
single-card output computed in the same process: the 8 x 1 Mbp family on
the sharded joint path (auto), and the 8 x 5 Mbp family on the subject
index with production grouping and with ``-l``.

Usage:  python chip_smoke.py [--four]
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import io
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time

GENOME_LEN = 5_000_000
FAMILY_GENOMES = 8
FOUR_SHARDED_LEN = 1_000_000
SEED = 2026
# JC tolerance of the family check: substitutions are sampled per site,
# so at 5 Mbp the realised divergence sits within ~0.2% of its rate; the
# rest is the anchor method's own error band (andi's test_random.sh gate
# is 5.5% relative at 100 kbp)
JC_REL_TOL = 0.05
JC_ABS_TOL = 0.002

_COMPILE_EVENT = "/jax/core/compile/backend_compile_duration"
_CACHE_HIT_EVENT = "/jax/compilation_cache/cache_retrieval_time_sec"
_COMPILES = {"n": 0, "s": 0.0, "hits": 0}
_CARD = {"tag": "card not read"}
# (program, shapes) of the sort-bearing programs the runs dispatched
_SORT_PROGRAMS: dict = {}


class SmokeFailure(AssertionError):
    """A phase's output disagreed with its reference."""


def report(msg: str) -> None:
    print(f"[{_CARD['tag']}] {msg}", flush=True)


def _on_duration(event: str, duration: float, **_) -> None:
    if event == _COMPILE_EVENT:
        _COMPILES["n"] += 1
        _COMPILES["s"] += duration
    elif event == _CACHE_HIT_EVENT:
        _COMPILES["hits"] += 1


def card_line() -> str:
    """Name and power limit of every card, as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=120,
    ).stdout.strip()
    if not out:
        raise SmokeFailure("nvidia-smi reported no card")
    return out


def peak_bytes() -> int | None:
    import jax

    stats = jax.local_devices()[0].memory_stats() or {}
    return stats.get("peak_bytes_in_use")


# ---------------------------------------------------------------------------
# one CLI run, in process


@dataclasses.dataclass
class Run:
    stdout: str
    seconds: float
    compiles: int
    compile_s: float
    cache_hits: int
    prof: list[tuple[str, float]]

    @property
    def schedules(self) -> str:
        """"subject", "joint", or "subject+joint" when subject-index rows
        fell back to the joint path (the sharded joint path writes no
        phase lines)."""
        sx = any(label.startswith("sx") for label, _ in self.prof)
        joint = any(not label.startswith("sx") for label, _ in self.prof)
        if sx:
            return "subject+joint" if joint else "subject"
        return "joint"

    def walk(self) -> dict:
        """Walk dispatches, loop iterations and seconds, summed over
        groups (over threads when groups run on several devices)."""
        disp = iters = lanes = 0
        secs = 0.0
        for label, s in self.prof:
            m = re.search(r"segmented walk: (\d+) dispatches, (\d+) probe "
                          r"steps, \d+ events, (\d+) lanes", label)
            if m:
                disp += int(m.group(1))
                iters += int(m.group(2))
                lanes = max(lanes, int(m.group(3)))
                secs += s
        return {"dispatches": disp, "iterations": iters, "lanes": lanes,
                "seconds": secs}


def _parse_prof(path: str) -> list[tuple[str, float]]:
    out = []
    if not os.path.exists(path):
        return out
    with open(path) as f:
        for line in f:
            label, _, val = line.rstrip("\n").rpartition(": ")
            if label and val.endswith("s"):
                out.append((label, float(val[:-1])))
    return out


def run_cli(argv: list[str], env: dict[str, str] | None = None) -> Run:
    """``andix.cli.main(argv)`` in this process with stdout captured and
    ``env`` set for the run only; per-phase timings come from
    ANDIX_PROF_FILE (which also waits for each phase's arrays)."""
    from andix import cli

    with tempfile.TemporaryDirectory() as tmp:
        prof = os.path.join(tmp, "prof.txt")
        env = {**(env or {}), "ANDIX_PROF_FILE": prof}
        saved = {k: os.environ.get(k) for k in env}
        os.environ.update(env)
        buf = io.StringIO()
        c0, s0, h0 = _COMPILES["n"], _COMPILES["s"], _COMPILES["hits"]
        t0 = time.perf_counter()
        try:
            with contextlib.redirect_stdout(buf):
                rc = cli.main(["--progress=never", *argv])
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
        seconds = time.perf_counter() - t0
        timings = _parse_prof(prof)
    if rc != 0:
        raise SmokeFailure(f"andix {' '.join(argv)} exited {rc}")
    return Run(buf.getvalue(), seconds, _COMPILES["n"] - c0,
               _COMPILES["s"] - s0, _COMPILES["hits"] - h0, timings)


def describe(name: str, run: Run) -> None:
    w = run.walk()
    per_iter = (
        f"{w['seconds'] / w['iterations'] * 1e6:.1f} us/iteration"
        if w["iterations"] else "no walk"
    )
    report(
        f"{name}: {run.seconds:.2f} s wall, schedule ran {run.schedules}, "
        f"{run.compiles} compilations ({run.compile_s:.2f} s), "
        f"{run.cache_hits} persistent-cache hits, walk "
        f"{w['lanes']} lanes, {w['dispatches']} dispatches / "
        f"{w['iterations']} iterations / {w['seconds']:.2f} s ({per_iter})"
    )


# ---------------------------------------------------------------------------
# inputs and plans


def family(n: int, length: int):
    from bench import make_family

    return make_family(n, length, seed=SEED)


def write_family(workdir: str, seqs) -> list[str]:
    """Genomes written as one FASTA file each."""
    paths = []
    for s in seqs:
        path = os.path.join(workdir, f"{s.name}.fa")
        with open(path, "wb") as f:
            f.write(b">" + s.name.encode() + b"\n")
            f.write(s.data.tobytes() + b"\n")
        paths.append(path)
    return paths


def plan(seqs) -> dict:
    """The device plan the pipeline makes for ``seqs``: auto schedule,
    joint blocks and subject-index groups."""
    from andix import pipeline, subject_pipeline
    from andix.esa.backend_jax import bucket
    from andix.runtime import Context
    from andix.sequence import subject_init

    n = len(seqs)
    ctx = Context()
    subjects = [subject_init(s, ctx.anchor_p_value) for s in seqs]
    block_syms, mq = pipeline.device_plan(ctx.block_syms, subjects)
    blocks = pipeline.make_blocks(subjects, block_syms, False, query_base=mq)
    q_total = sum((s.len - 1) // 2 + 1 for s in subjects)
    q_base = min(mq, q_total)
    block_padded = max(
        bucket(q_base + sum(subjects[i].len + 1 for i in b)) for b in blocks
    )
    groups = subject_pipeline.plan_groups(subjects, list(range(n)), False)
    group_padded = max(bucket(subjects[i].len * 2 + 2) for i in range(n))
    max_qlen = max(s.len for s in seqs)
    return {
        "auto": pipeline.auto_schedule(seqs, subjects, block_syms, mq),
        "blocks": [len(b) for b in blocks],
        "block_padded": block_padded,
        "groups": [len(g) for g in groups],
        "group_padded": group_padded,
        "sx_k": subject_pipeline._chain_segments(
            max_qlen, max(len(g) for g in groups) * max(n - 1, 1)
        ),
    }


def describe_plan(name: str, p: dict) -> None:
    report(
        f"{name} plan: auto -> {p['auto']}; joint blocks {p['blocks']} "
        f"(largest {p['block_padded']} padded symbols); subject groups "
        f"{p['groups']} ({p['group_padded']} padded symbols per subject, "
        f"K={p['sx_k']} segments per lane)"
    )


def describe_memory(name: str, padded: int, what: str) -> None:
    from andix.pipeline import BYTES_PER_PADDED_SYM

    peak = peak_bytes()
    if peak is None:
        report(f"{name}: peak device memory not measured (no allocator "
               f"stats on this platform)")
        return
    report(
        f"{name}: peak_bytes_in_use so far {peak} = "
        f"{peak / padded:.1f} B per padded symbol of the {what} "
        f"({padded}); planner budgets {BYTES_PER_PADDED_SYM} B"
    )


def phylip_distances(stdout: str) -> list[list[float]]:
    lines = stdout.strip().splitlines()
    n = int(lines[0])
    return [[float(x) for x in line.split()[1:n + 1]]
            for line in lines[1:n + 1]]


def check_jc(stdout: str, rates: list[float]) -> None:
    """JC distance of each (g0, gk) against its simulated rate."""
    d = phylip_distances(stdout)
    for k, rate in enumerate(rates, start=1):
        want = -0.75 * math.log(1 - 4.0 / 3.0 * rate)
        got = d[0][k]
        tol = JC_REL_TOL * want + JC_ABS_TOL
        if not abs(got - want) <= tol:
            raise SmokeFailure(
                f"d(g0, g{k}) = {got} but the simulated rate {rate} gives "
                f"{want:.6f} (tolerance {tol:.6f})"
            )
    report(f"JC check: {len(rates)} pairs within "
           f"{JC_REL_TOL} * d + {JC_ABS_TOL} of the simulated rates")


def same(name: str, a: Run, b: Run) -> None:
    if a.stdout != b.stdout:
        raise SmokeFailure(f"{name}: PHYLIP outputs differ:\n{a.stdout}\n"
                           f"---\n{b.stdout}")
    report(f"{name}: byte-identical ({len(a.stdout)} bytes)")


# ---------------------------------------------------------------------------
# phases


def phase_pair(workdir: str, length: int = GENOME_LEN) -> None:
    seqs = family(2, length)
    paths = write_family(workdir, seqs)
    p = plan(seqs)
    describe_plan(f"pair 2 x {length}", p)
    cold = run_cli(["--backend", "jax", *paths])
    describe("pair auto cold", cold)
    warm = run_cli(["--backend", "jax", *paths])
    describe("pair auto warm", warm)
    padded = p["block_padded"] if p["auto"] == "joint" else p["group_padded"]
    describe_memory("pair", padded, f"largest {p['auto']} unit")
    host = run_cli(["--backend", "numpy", *paths])
    report(f"pair numpy backend (host): {host.seconds:.2f} s wall")
    same("pair jax cold vs numpy", cold, host)
    same("pair jax warm vs numpy", warm, host)


def phase_family(workdir: str, n: int = FAMILY_GENOMES,
                 length: int = GENOME_LEN) -> None:
    from bench import FAMILY_RATES

    if n < FAMILY_GENOMES:
        report(f"family cut: {n} of {FAMILY_GENOMES} genomes (run limit), "
               f"length kept at {length}")
    seqs = family(n, length)
    paths = write_family(workdir, seqs)
    p = plan(seqs)
    describe_plan(f"family {n} x {length}", p)
    other = "subject" if p["auto"] == "joint" else "joint"
    runs = {}
    for name, env in (("auto cold", {}), ("auto warm", {}),
                      (f"{other} cold", {"ANDIX_INDEX": other}),
                      (f"{other} warm", {"ANDIX_INDEX": other})):
        runs[name] = run_cli(["--backend", "jax", *paths], env)
        describe(f"family {name}", runs[name])
    if runs["auto cold"].schedules != p["auto"]:
        raise SmokeFailure(f"auto ran {runs['auto cold'].schedules}, "
                           f"plan said {p['auto']}")
    describe_memory("family", max(p["block_padded"], p["group_padded"]),
                    "largest joint block")
    same("family auto cold vs warm", runs["auto cold"], runs["auto warm"])
    same(f"family auto vs {other}", runs["auto cold"], runs[f"{other} cold"])
    same(f"family {other} cold vs warm", runs[f"{other} cold"],
         runs[f"{other} warm"])
    check_jc(runs["auto cold"].stdout,
             [FAMILY_RATES[(k - 1) % len(FAMILY_RATES)] for k in range(1, n)])


def record_sort_programs() -> None:
    """Wrap the sort-bearing device programs so their call shapes are
    recorded for ``phase_sorts`` (one entry per distinct shape)."""
    from andix.chain import evpack
    from andix.esa import doubling, subject_index

    sa_core = doubling._sa_core

    def sa_core_rec(sym, **kw):
        spec = _spec(sym)
        _SORT_PROGRAMS[("joint SA", sym.shape, tuple(sorted(kw.items())))] = (
            lambda: sa_core.lower(spec, **kw)
        )
        return sa_core(sym, **kw)

    fused = subject_index.fused_build

    def fused_rec(sym, n_real, *args):
        static = tuple(a if isinstance(a, str) else int(a) for a in args)
        fn = subject_index._fused_build_fn(int(sym.shape[0]), *static)
        specs = (_spec(sym), _spec(n_real))
        _SORT_PROGRAMS[("subject SA", sym.shape, static)] = (
            lambda: fn.lower(*specs)
        )
        return fused(sym, n_real, *args)

    encode = evpack._encode_fn

    def encode_rec(k, esc_cap, n_lanes):
        fn = encode(k, esc_cap, n_lanes)

        def call(*a):
            specs = tuple(map(_spec, a))
            _SORT_PROGRAMS[("event pack", (k,), (esc_cap, n_lanes))] = (
                lambda: fn.lower(*specs)
            )
            return fn(*a)

        return call

    doubling._sa_core = sa_core_rec
    subject_index.fused_build = fused_rec
    evpack._encode_fn = encode_rec


def _spec(x):
    import jax

    return jax.ShapeDtypeStruct(x.shape, x.dtype)


def sort_ops(hlo_text: str) -> list[tuple[str, str]]:
    """(kind, result shape) of every sort in optimised HLO text: "cub" for
    a CUB radix-sort custom call, "comparator" for XLA's sort op."""
    out = []
    for line in hlo_text.splitlines():
        m = re.match(r"\s*(?:ROOT\s+)?\S+\s*=\s*(.+?)\s+"
                     r"(sort|custom-call)\(", line)
        if not m:
            continue
        if m.group(2) == "sort":
            out.append(("comparator", m.group(1)))
        elif "DeviceRadixSort" in line:
            out.append(("cub", m.group(1)))
    return out


def phase_sorts() -> list[tuple[str, str, str]]:
    """Compile each recorded sort-bearing program at its run shape and
    report how its sorts lowered."""
    rows = []
    for key, lower in sorted(_SORT_PROGRAMS.items(),
                             key=lambda kv: str(kv[0])):
        compiled = lower().compile()
        ops = sort_ops(compiled.as_text())
        if not ops:
            raise SmokeFailure(f"no sort found in {key[0]} {key[1]}")
        mem = compiled.memory_analysis()
        if mem is not None:
            report(f"program memory: {key[0]} at {key[1]}: temp "
                   f"{mem.temp_size_in_bytes} B, arguments "
                   f"{mem.argument_size_in_bytes} B, outputs "
                   f"{mem.output_size_in_bytes} B")
        for kind, shape in ops:
            rows.append((f"{key[0]} {key[1]}", kind, shape))
            report(f"sort lowering: {key[0]} at {key[1]}: {kind} -> {shape}")
    return rows


def phase_four(workdir: str) -> None:
    """Multi-GPU paths only, each against the single-card output."""
    from andix import parallel, subject_pipeline

    os.makedirs(workdir + "/one")
    seqs = family(FAMILY_GENOMES, FOUR_SHARDED_LEN)
    paths = write_family(workdir + "/one", seqs)
    describe_plan(f"four: family {FAMILY_GENOMES} x {FOUR_SHARDED_LEN}",
                  plan(seqs))
    info = parallel._sharded_counts_fn.cache_info()
    before = info.hits + info.misses
    sharded = run_cli(["--backend", "jax", *paths])
    info = parallel._sharded_counts_fn.cache_info()
    if info.hits + info.misses == before:
        raise SmokeFailure("the sharded joint path did not run")
    describe("four: sharded joint (auto)", sharded)
    single = run_cli(["--backend", "jax", *paths], {"ANDIX_SHARDED": "0"})
    describe("four: one card joint", single)
    same("four: sharded joint vs one card", sharded, single)

    os.makedirs(workdir + "/five")
    seqs = family(FAMILY_GENOMES, GENOME_LEN)
    paths = write_family(workdir + "/five", seqs)
    describe_plan(f"four: family {FAMILY_GENOMES} x {GENOME_LEN}",
                  plan(seqs))
    sx = {"ANDIX_INDEX": "subject"}
    single = run_cli(["--backend", "jax", *paths],
                     {**sx, "ANDIX_SX_MESH": "0"})
    describe("four: one card subject index", single)
    for name, argv in (("production grouping", []), ("-l", ["-l"])):
        run = run_cli(["--backend", "jax", *argv, *paths], sx)
        describe(f"four: subject index mesh, {name}", run)
        balance = "; ".join(subject_pipeline.LAST_BALANCE) or (
            "one worker (all groups on one card)"
        )
        report(f"four: per-device balance, {name}: {balance}")
        same(f"four: subject mesh ({name}) vs one card", run, single)


# ---------------------------------------------------------------------------


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument(
        "--four", action="store_true",
        help="run only the multi-GPU paths, on four cards",
    )
    args = parser.parse_args(argv)

    # a broken CUDA plugin must fail the run, not fall back to the CPU
    os.environ["JAX_PLATFORMS"] = "cuda"
    import jax

    devices = jax.devices()
    want = 4 if args.four else 1
    if devices[0].platform != "gpu" or len(devices) < want:
        print(f"chip_smoke: needs {want} GPU(s); JAX sees {devices}",
              file=sys.stderr)
        return 1
    if peak_bytes() is None:
        print("chip_smoke: the GPU reports no allocator statistics",
              file=sys.stderr)
        return 1
    from andix import native

    if not native.available():
        # the host LCP and event counting would run in pure Python
        print(f"chip_smoke: native host library unavailable: "
              f"{native.load_error()}", file=sys.stderr)
        return 1
    jax.monitoring.register_event_duration_secs_listener(_on_duration)

    cards = card_line()
    _CARD["tag"] = cards.splitlines()[0]
    dev = devices[0]
    print(f"card (nvidia-smi name, power.limit): {cards}")
    report(f"jax {jax.__version__}, device_kind {dev.device_kind}, "
           f"{len(devices)} device(s)")

    with tempfile.TemporaryDirectory() as work:
        if args.four:
            phase_four(work)
        else:
            record_sort_programs()
            os.makedirs(work + "/pair")
            os.makedirs(work + "/family")
            phase_pair(work + "/pair")
            phase_family(work + "/family")
            phase_sorts()

    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(devices),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

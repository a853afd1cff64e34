"""Golden parity: andix stdout must byte-match the real andi binary.

The reference sources (read-only at /root/reference) are compiled at test
time against small from-scratch shims for libdivsufsort and the two GSL
calls (tests/refshim/ — oracle scaffolding, not framework code).  This is
the strongest parity gate available without vendored datasets: the PHYLIP
matrix, warnings behavior, and exit codes must match on every configuration
(SURVEY.md §4: "direct PHYLIP-matrix parity vs reference andi").
"""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

REFERENCE = "/root/reference"
SHIM = os.path.join(os.path.dirname(__file__), "refshim")


@pytest.fixture(scope="session")
def andi_oracle(tmp_path_factory):
    if not os.path.isdir(os.path.join(REFERENCE, "src")):
        pytest.skip("reference sources not available")
    build = tmp_path_factory.mktemp("andi_oracle")
    obj = build / "divsufsort_shim.o"
    exe = build / "andi_oracle"
    subprocess.run(
        ["g++", "-O2", "-c", os.path.join(SHIM, "divsufsort_shim.cpp"),
         "-I", SHIM, "-o", str(obj)],
        check=True,
    )
    srcs = [
        os.path.join(REFERENCE, "src", f)
        for f in ["andi.c", "io.c", "process.c", "sequence.c", "esa.c", "model.c"]
    ] + [os.path.join(REFERENCE, "libs", "pfasta.c")]
    subprocess.run(
        ["gcc", "-O2", "-fopenmp", "-I", SHIM,
         "-I", os.path.join(REFERENCE, "src"),
         "-I", os.path.join(REFERENCE, "libs"),
         "-I", os.path.join(REFERENCE, "opt")]
        + srcs + [str(obj), "-lm", "-lstdc++", "-o", str(exe)],
        check=True,
    )
    return str(exe)


def run_ref(exe, args, cwd):
    return subprocess.run(
        [exe, "--progress=never", "-t", "1"] + args,
        capture_output=True, text=True, cwd=cwd,
    )


def run_andix(args, cwd, extra_env=None):
    env = {**os.environ, "JAX_PLATFORMS": "cpu",
           "ANDIX_MIN_BUCKET": "1024",
           "PYTHONPATH": os.path.dirname(os.path.dirname(__file__))}
    if extra_env:
        env.update(extra_env)
    return subprocess.run(
        [sys.executable, "-m", "andix.cli", "--progress=never"] + args,
        capture_output=True, text=True, cwd=cwd, env=env,
    )


def write_fasta(path, records, width=70):
    with open(path, "w") as fh:
        for name, seq in records:
            fh.write(f">{name}\n")
            s = seq.tobytes().decode()
            for k in range(0, len(s), width):
                fh.write(s[k : k + width] + "\n")


@pytest.fixture
def genomes(tmp_path, rng, dna, mutator):
    base = dna(rng, 3000)
    paths = []
    for k, rate in enumerate([0.0, 0.02, 0.06, 0.12]):
        s = base if rate == 0 else mutator(rng, base, rate)
        p = tmp_path / f"g{k}.fa"
        write_fasta(p, [(f"g{k}", s)])
        paths.append(p.name)
    return tmp_path, paths


def assert_parity(exe, args, cwd, check_code=True):
    ref = run_ref(exe, args, str(cwd))
    got = run_andix(args, str(cwd))
    assert got.stdout == ref.stdout, (
        f"stdout mismatch for {args}\n--- andi ---\n{ref.stdout}"
        f"--- andix ---\n{got.stdout}"
    )
    if check_code:
        assert got.returncode == ref.returncode, (args, ref.stderr, got.stderr)


class TestMatrixParity:
    def test_default_jc(self, andi_oracle, genomes):
        cwd, paths = genomes
        assert_parity(andi_oracle, paths, cwd)

    def test_progress_meter_stderr_bytes(self, andi_oracle, genomes):
        """--progress=always: the \\r meter stream on stderr must be
        byte-identical (reference src/dist_hack.h:40-44,74-87 — one update
        per subject row plus the 0% header and ', done.'); VERDICT r2
        missing #5."""
        cwd, paths = genomes
        # bytes mode: text=True would fold the meter's \r into \n
        ref = subprocess.run(
            [andi_oracle, "--progress=always", "-t", "1", *paths],
            capture_output=True, cwd=str(cwd),
        )
        env = {**os.environ, "JAX_PLATFORMS": "cpu",
               "ANDIX_MIN_BUCKET": "1024",
               "PYTHONPATH": os.path.dirname(os.path.dirname(__file__))}
        got = subprocess.run(
            [sys.executable, "-m", "andix.cli", "--progress=always", *paths],
            capture_output=True, cwd=str(cwd), env=env,
        )
        assert b"\rComparing" in ref.stderr
        assert got.stderr == ref.stderr, (
            f"stderr meter mismatch\n--- andi ---\n{ref.stderr!r}\n"
            f"--- andix ---\n{got.stderr!r}"
        )
        assert got.stdout == ref.stdout

    @pytest.mark.parametrize("model", ["Raw", "Kimura", "LogDet", "ANI"])
    def test_models(self, andi_oracle, genomes, model):
        cwd, paths = genomes
        assert_parity(andi_oracle, ["-m", model, *paths], cwd)

    def test_low_memory(self, andi_oracle, genomes):
        cwd, paths = genomes
        assert_parity(andi_oracle, ["-l", *paths], cwd)

    def test_verbose_coverage(self, andi_oracle, genomes):
        cwd, paths = genomes
        assert_parity(andi_oracle, ["-v", *paths], cwd)

    def test_extra_verbose(self, andi_oracle, genomes):
        cwd, paths = genomes
        assert_parity(andi_oracle, ["-v", "-v", *paths], cwd)

    def test_anchor_pvalue(self, andi_oracle, genomes):
        cwd, paths = genomes
        assert_parity(andi_oracle, ["-p", "0.2", *paths], cwd)

    def test_two_sequences_one_file(self, andi_oracle, tmp_path, rng, dna,
                                    mutator):
        base = dna(rng, 2500)
        write_fasta(
            tmp_path / "both.fa",
            [("s1", base), ("s2", mutator(rng, base, 0.04))],
        )
        assert_parity(andi_oracle, ["both.fa"], tmp_path)


class TestEdgeParity:
    def test_unrelated_nan(self, andi_oracle, tmp_path, rng, dna):
        write_fasta(tmp_path / "a.fa", [("a", dna(rng, 2000))])
        write_fasta(tmp_path / "b.fa", [("b", dna(rng, 2000))])
        assert_parity(andi_oracle, ["a.fa", "b.fa"], tmp_path)

    def test_low_homology(self, andi_oracle, tmp_path, rng, dna):
        island = dna(rng, 400)
        s1 = np.concatenate([dna(rng, 1100), island, dna(rng, 1100)])
        s2 = np.concatenate([dna(rng, 1100), island.copy(), dna(rng, 1100)])
        write_fasta(tmp_path / "a.fa", [("a", s1)])
        write_fasta(tmp_path / "b.fa", [("b", s2)])
        assert_parity(andi_oracle, ["a.fa", "b.fa"], tmp_path)

    def test_identical(self, andi_oracle, tmp_path, rng, dna):
        s = dna(rng, 2000)
        write_fasta(tmp_path / "a.fa", [("a", s)])
        write_fasta(tmp_path / "b.fa", [("b", s.copy())])
        assert_parity(andi_oracle, ["a.fa", "b.fa"], tmp_path)

    def test_join_mode(self, andi_oracle, tmp_path, rng, dna, mutator):
        c1, c2, c3 = dna(rng, 1200), dna(rng, 800), dna(rng, 500)
        write_fasta(tmp_path / "asm_a.fa", [("c1", c1), ("c2", c2), ("c3", c3)])
        write_fasta(
            tmp_path / "asm_b.fa",
            [("c1", mutator(rng, c1, 0.03)), ("c2", mutator(rng, c2, 0.03))],
        )
        assert_parity(andi_oracle, ["-j", "asm_a.fa", "asm_b.fa"], tmp_path)

    def test_non_acgt_stripping(self, andi_oracle, tmp_path, rng, dna,
                                mutator):
        base = dna(rng, 2000)
        s = base.tobytes().decode()
        s = s[:900] + "NNNRYWSacgt" + s[900:]
        with open(tmp_path / "a.fa", "w") as fh:
            fh.write(">a\n" + s + "\n")
        write_fasta(tmp_path / "b.fa", [("b", mutator(rng, base, 0.03))])
        assert_parity(andi_oracle, ["a.fa", "b.fa"], tmp_path)

    def test_short_sequences(self, andi_oracle, tmp_path, rng, dna, mutator):
        base = dna(rng, 600)
        write_fasta(tmp_path / "a.fa", [("a", base)])
        write_fasta(tmp_path / "b.fa", [("b", mutator(rng, base, 0.02))])
        assert_parity(andi_oracle, ["a.fa", "b.fa"], tmp_path)

    def test_truncate_names(self, andi_oracle, tmp_path, rng, dna, mutator):
        base = dna(rng, 2000)
        write_fasta(tmp_path / "a.fa", [("a_very_long_sequence_name", base)])
        write_fasta(tmp_path / "b.fa", [("b", mutator(rng, base, 0.03))])
        assert_parity(
            andi_oracle, ["--truncate-names", "a.fa", "b.fa"], tmp_path
        )

    def test_tiny_scientific_notation(self, andi_oracle, tmp_path, rng, dna,
                                      mutator):
        # distances in (0, 0.001) flip the whole matrix to scientific
        base = dna(rng, 20_000)
        write_fasta(tmp_path / "a.fa", [("a", base)])
        write_fasta(tmp_path / "b.fa", [("b", mutator(rng, base, 0.0004))])
        assert_parity(andi_oracle, ["a.fa", "b.fa"], tmp_path)

    def test_many_contigs_join(self, andi_oracle, tmp_path, rng, dna,
                               mutator):
        contigs = [dna(rng, 300 + 17 * k) for k in range(8)]
        write_fasta(
            tmp_path / "asm_a.fa",
            [(f"c{k}", c) for k, c in enumerate(contigs)],
        )
        write_fasta(
            tmp_path / "asm_b.fa",
            [(f"c{k}", mutator(rng, c, 0.05)) for k, c in enumerate(contigs)],
        )
        assert_parity(andi_oracle, ["-j", "asm_a.fa", "asm_b.fa"], tmp_path)


def _norm_stderr(text):
    """Drop the program-name prefix ('andi_oracle: ...' vs 'andix: ...')
    from each line so only the message content is compared."""
    out = []
    for ln in text.splitlines():
        head, sep, rest = ln.partition(": ")
        out.append(rest if sep and " " not in head else ln)
    return out


def assert_stderr_parity(exe, args, cwd):
    ref = run_ref(exe, args, str(cwd))
    got = run_andix(args, str(cwd))
    assert got.stdout == ref.stdout, (args, ref.stdout, got.stdout)
    assert _norm_stderr(got.stderr) == _norm_stderr(ref.stderr), (
        args, ref.stderr, got.stderr
    )
    assert got.returncode == ref.returncode, (args, ref.stderr, got.stderr)


class TestFastaErrorParity:
    """Malformed-input behavior must match pfasta byte for byte: message
    text, line numbers, records-kept-before-error, and exit codes
    (libs/pfasta.c:330-482, src/io.c:196-233)."""

    @pytest.fixture
    def goods(self, tmp_path, rng, dna, mutator):
        base = dna(rng, 1500)
        write_fasta(tmp_path / "good1.fa", [("g1", base)])
        write_fasta(tmp_path / "good2.fa", [("g2", mutator(rng, base, 0.03))])
        return tmp_path, ["good1.fa", "good2.fa"]

    def _case(self, goods, andi_oracle, content):
        cwd, good = goods
        (cwd / "bad.fa").write_bytes(content)
        assert_stderr_parity(andi_oracle, ["bad.fa"] + good, cwd)

    def test_not_fasta(self, andi_oracle, goods):
        self._case(goods, andi_oracle, b"this is not fasta\n")

    def test_empty_file(self, andi_oracle, goods):
        self._case(goods, andi_oracle, b"")

    def test_eof_in_name(self, andi_oracle, goods):
        self._case(goods, andi_oracle, b">name")

    def test_eof_in_comment(self, andi_oracle, goods):
        self._case(goods, andi_oracle, b">name a comment")

    def test_empty_name(self, andi_oracle, goods):
        self._case(goods, andi_oracle, b"> \nACGTACGT\n")

    def test_empty_sequence_line_number(self, andi_oracle, goods):
        self._case(goods, andi_oracle, b">a\n\n\n>b\nACGT\n")

    def test_record_kept_before_bad_word(self, andi_oracle, goods):
        # record 'a' parses, then '1' is not a valid word start: the
        # reference keeps 'a' and reports the error with its line number
        self._case(
            goods, andi_oracle,
            b">a\n" + b"ACGT" * 300 + b"\n123\n>b\nACGT\n",
        )

    def test_midline_header_word(self, andi_oracle, goods):
        # pfasta is word-based: a '>'-word after spaces mid-line starts a
        # new record
        self._case(
            goods, andi_oracle,
            b">a\n" + b"ACGT" * 300 + b" >m\n" + b"TTTT" * 300 + b"\n",
        )

    def test_no_trailing_newline(self, andi_oracle, goods):
        self._case(goods, andi_oracle, b">a\n" + b"ACGT" * 300)

    def test_crlf_line_endings(self, andi_oracle, goods):
        self._case(
            goods, andi_oracle,
            b">a first\r\n" + b"ACGT" * 300 + b"\r\n",
        )


@pytest.mark.skipif(
    os.environ.get("ANDIX_PARITY_LARGE") != "1",
    reason="opt-in genome-scale parity (slow): set ANDIX_PARITY_LARGE=1",
)
class TestLargeParity:
    """Genome-scale parity vs the compiled reference (VERDICT r2 #2):
    the r2 parity ceiling was ~20 kb; anchor densities, thresholds, and
    tie structures at Mbp scale are entirely different."""

    LENGTH = int(os.environ.get("ANDIX_PARITY_LARGE_LEN", "1000000"))

    @pytest.fixture(scope="class")
    def count_oracle(self, tmp_path_factory):
        """Direct dist_anchor driver: prints the raw 16-cell counts the
        andi binary never exposes (tests/refshim/count_oracle.c)."""
        if not os.path.isdir(os.path.join(REFERENCE, "src")):
            pytest.skip("reference sources not available")
        build = tmp_path_factory.mktemp("count_oracle")
        obj = build / "divsufsort_shim.o"
        exe = build / "count_oracle"
        subprocess.run(
            ["g++", "-O2", "-c", os.path.join(SHIM, "divsufsort_shim.cpp"),
             "-I", SHIM, "-o", str(obj)],
            check=True,
        )
        srcs = [
            os.path.join(REFERENCE, "src", f)
            for f in ["io.c", "process.c", "sequence.c", "esa.c", "model.c"]
        ] + [os.path.join(REFERENCE, "libs", "pfasta.c"),
             os.path.join(SHIM, "count_oracle.c")]
        subprocess.run(
            ["gcc", "-O2", "-fopenmp", "-I", SHIM,
             "-I", os.path.join(REFERENCE, "src"),
             "-I", os.path.join(REFERENCE, "libs"),
             "-I", os.path.join(REFERENCE, "opt")]
            + srcs + [str(obj), "-lm", "-lstdc++", "-o", str(exe)],
            check=True,
        )
        return str(exe)

    @pytest.fixture(scope="class")
    def large_pair(self, tmp_path_factory):
        rng = np.random.default_rng(777)
        nucl = np.frombuffer(b"ACGT", dtype=np.uint8)
        base = nucl[rng.integers(0, 4, self.LENGTH)]
        codes = np.searchsorted(nucl, base)
        hit = rng.random(self.LENGTH) < 0.03
        mut = nucl[
            (codes + np.where(hit, rng.integers(1, 4, self.LENGTH), 0)) % 4
        ]
        d = tmp_path_factory.mktemp("large")
        write_fasta(d / "a.fa", [("a", base)])
        write_fasta(d / "b.fa", [("b", mut)])
        return d, base, mut

    def test_count_matrix_byte_parity(self, count_oracle, large_pair):
        """Both ordered pairs' 16-cell matrices must equal dist_anchor's
        exactly at Mbp scale (device SA + scans + on-device replay)."""
        d, base, mut = large_pair
        from andix import pipeline
        from andix.esa.backend_jax import JaxBackend
        from andix.runtime import Context
        from andix.sequence import Seq

        os.environ["ANDIX_SHARDED"] = "0"
        try:
            M = pipeline.calculate_matrix(
                [Seq(base, "a"), Seq(mut, "b")], Context(), JaxBackend()
            )
        finally:
            del os.environ["ANDIX_SHARDED"]

        for subj, query, (i, j) in [("a.fa", "b.fa", (0, 1)),
                                    ("b.fa", "a.fa", (1, 0))]:
            ref = subprocess.run(
                [count_oracle, str(d / subj), str(d / query)],
                capture_output=True, text=True, check=True,
            )
            lines = ref.stdout.strip().splitlines()
            want_len = int(lines[0])
            want_counts = np.array([int(x) for x in lines[1].split()],
                                   dtype=np.int64)
            got = M[i][j]
            assert got.seq_len == want_len
            assert (got.counts == want_counts).all(), (
                f"{subj}->{query}\nref:   {want_counts}\nandix: {got.counts}"
            )

    def test_distance_stdout_parity(self, andi_oracle, large_pair):
        d, _, _ = large_pair
        assert_parity(andi_oracle, ["a.fa", "b.fa"], d)


class TestBootstrapParity:
    """Full `-b` stdout byte-parity vs the compiled oracle (VERDICT r3
    missing #3): the reference seeds GSL with time(NULL), so both sides are
    driven with the SAME fixed shim stream — SHIM_RNG_SEED seeds the
    oracle's splitmix64 shim (tests/refshim/gsl), ANDIX_BOOTSTRAP_SHIM_SEED
    swaps andix's resampler for its bit-exact Python twin
    (andix.oracle.ShimRng).  Covers matrix framing, the diagonal sentinel
    rules (src/process.c:303-306), averaging-before-resampling, and the
    scientific-notation interaction (src/io.c:246-322)."""

    def _assert_bootstrap_parity(self, exe, args, cwd, seed):
        env = {**os.environ, "SHIM_RNG_SEED": str(seed)}
        ref = subprocess.run(
            [exe, "--progress=never", "-t", "1"] + args,
            capture_output=True, text=True, cwd=str(cwd), env=env,
        )
        got = run_andix(
            args, str(cwd),
            extra_env={"ANDIX_BOOTSTRAP_SHIM_SEED": str(seed)},
        )
        assert got.stdout == ref.stdout, (
            f"bootstrap stdout mismatch for {args}\n--- andi ---\n"
            f"{ref.stdout}--- andix ---\n{got.stdout}"
        )
        assert got.returncode == ref.returncode

    def test_b3_default(self, andi_oracle, genomes):
        cwd, paths = genomes
        self._assert_bootstrap_parity(
            andi_oracle, ["-b", "3"] + paths, cwd, seed=20260821
        )

    def test_b3_seed_sweep(self, andi_oracle, genomes):
        cwd, paths = genomes
        for seed in (1, 987654321):
            self._assert_bootstrap_parity(
                andi_oracle, ["-b", "2"] + paths, cwd, seed=seed
            )

    def test_b_scientific_notation(self, andi_oracle, tmp_path, rng, dna,
                                   mutator):
        """A near-identical pair (d < 0.001) flips the matrix to scientific
        notation; the bootstrap matrices must follow the same rule."""
        base = dna(rng, 4000)
        near = base.copy()
        near[100] = ord("A") if near[100] != ord("A") else ord("C")
        near[2500] = ord("G") if near[2500] != ord("G") else ord("T")
        write_fasta(tmp_path / "a.fa", [("a", base)])
        write_fasta(tmp_path / "b.fa", [("b", near)])
        self._assert_bootstrap_parity(
            andi_oracle, ["-b", "4", "a.fa", "b.fa"], tmp_path, seed=33
        )

"""JAX backend tests: device SA/scans/matchstats must equal the numpy
backend and the brute-force oracle (runs on CPU JAX with 8 virtual
devices, see conftest)."""

import numpy as np
import pytest

from andix import pipeline
from andix.esa import joint, matchstats_np, sa_numpy, scans
from andix.esa.backend_jax import JaxBackend
from andix.esa.doubling import suffix_array, suffix_array_fixed_rounds
from andix.oracle import match_stats_brute
from andix.runtime import Context, Model
from andix.sequence import Seq, catcomp


class TestDoubling:
    @pytest.mark.parametrize("n", [1, 2, 13, 100, 1000])
    def test_random_matches_numpy(self, rng, n):
        sym = rng.integers(0, 6, n).astype(np.int32)
        assert (suffix_array(sym) == sa_numpy.suffix_array(sym)).all()

    def test_repetitive(self):
        sym = np.frombuffer(b"GATTACA" * 64, np.uint8).astype(np.int32)
        assert (suffix_array(sym) == sa_numpy.suffix_array(sym)).all()

    def test_with_separators(self, rng):
        sym = np.concatenate(
            [
                rng.integers(65, 85, 200).astype(np.int32),
                [256],
                rng.integers(65, 85, 150).astype(np.int32),
                [257],
            ]
        ).astype(np.int32)
        assert (suffix_array(sym) == sa_numpy.suffix_array(sym)).all()

    def test_bucketed_tail_rounds(self, rng, dna, mutator, monkeypatch):
        """Force the Larsson-Sadakane bucketed rounds from the first round
        (tied fraction threshold = 1.1) with a tiny buffer bucket so the
        shrink path runs; SA must equal the host oracle on a near-identical
        family (deep ties) and on random text."""
        from andix.esa import doubling

        monkeypatch.setattr(doubling, "_BUCKET_FRAC", 1.1)
        monkeypatch.setattr(doubling, "_MIN_BUCKET_T", 16)
        base = dna(rng, 500)
        fam = np.concatenate(
            [base, [33], mutator(rng, base, 0.01), [35],
             mutator(rng, base, 0.02), [59]]
        ).astype(np.int32)
        assert (suffix_array(fam) == sa_numpy.suffix_array(fam)).all()
        rnd = rng.integers(0, 6, 700).astype(np.int32)
        assert (suffix_array(rnd) == sa_numpy.suffix_array(rnd)).all()

    def test_bucketed_levels_lcp_exact(self, rng, dna, mutator, monkeypatch):
        """Rank levels collected during bucketed rounds must keep the
        level-walk LCP exact (bucket-head semantics: equal rank ⟺ equal
        width-w prefix)."""
        import jax.numpy as jnp

        from andix.esa import device_pipeline, doubling
        from andix.esa.backend_jax import bucket, device_text, pad_symbols

        monkeypatch.setattr(doubling, "_BUCKET_FRAC", 1.1)
        monkeypatch.setattr(doubling, "_MIN_BUCKET_T", 16)
        base = dna(rng, 400)
        rs = {0: catcomp(base), 1: catcomp(mutator(rng, base, 0.015))}
        layout = joint.build_block(rs, {})
        padded_n = bucket(layout.n)
        sym_d = device_text(layout, padded_n)
        sa_d, levels = doubling.suffix_array_device_collect(sym_d, packed=True)
        pad_level = jnp.arange(padded_n, dtype=jnp.int32)
        while len(levels) % 2:
            levels.append(pad_level)
        lcp_d = device_pipeline.lcp_from_levels(
            sa_d, jnp.stack(levels), sym_d
        )
        n = layout.n
        padded = pad_symbols(layout.sym, padded_n)
        want = sa_numpy.lcp_array(padded, np.asarray(sa_d))
        assert (np.asarray(lcp_d)[:n] == want[:n]).all()

    @pytest.mark.parametrize("base_w", [4, 6, 10, 12])
    def test_wide_initial_ranks_sa_lcp_exact(self, rng, dna, mutator,
                                             base_w):
        """Dense-code wide initial ranks (doubling.wide_base_width): the
        SA and the hybrid/levels LCPs must equal the host oracle for every
        base width on a real block text (separators + joiners + padding +
        near-identical genomes for deep ties)."""
        import jax.numpy as jnp

        from andix.esa import doubling
        from andix.esa.backend_jax import bucket, device_text, pad_symbols

        base = dna(rng, 600)
        g2 = mutator(rng, base, 0.01)
        g2[200] = ord("!")
        rs = {0: catcomp(base), 1: catcomp(g2)}
        layout = joint.build_block(rs, {})
        padded_n = bucket(layout.n, minimum=1024)
        sym_d = device_text(layout, padded_n)
        padded = pad_symbols(layout.sym, padded_n)
        want_sa = sa_numpy.suffix_array(padded)
        want_lcp = sa_numpy.lcp_array(padded, want_sa)
        n = layout.n
        for mode in ("hybrid", "levels"):
            sa_d, lcp_d, ovf, _ = doubling.sa_lcp_device(
                sym_d, packed=True, lcp_mode=mode, base_width=base_w
            )
            assert not bool(ovf)
            assert (np.asarray(sa_d) == want_sa).all(), (mode, base_w)
            assert (np.asarray(lcp_d)[:n] == want_lcp[:n]).all(), (
                mode, base_w,
            )

    def test_wide_base_width_rules(self):
        from andix.esa import doubling

        # alphabet violation -> clamped width-4 key
        assert doubling.wide_base_width(5, False) == 4
        # few segments: 5-bit codes, 12 symbols per int64
        assert doubling.wide_base_width(8, True) == 12
        # eco29-block-scale segment counts: 6-bit codes, 10 symbols
        assert doubling.wide_base_width(40, True) == 10
        # many segments degrade gracefully, never below BASE_WIDTH
        assert doubling.wide_base_width(1000, True) == 6
        assert doubling.wide_base_width(16000, True) == 4

    def test_fixed_rounds_variant(self, rng):
        import jax.numpy as jnp

        sym = rng.integers(0, 4, 256).astype(np.int32)
        rounds = 8  # 2**8 = 256 >= n
        got = np.asarray(
            suffix_array_fixed_rounds(jnp.asarray(sym), rounds)
        )
        assert (got == sa_numpy.suffix_array(sym)).all()


class TestDeviceScan:
    def test_vs_numpy_scan(self, rng):
        import jax.numpy as jnp

        n = 10_000
        vals = rng.integers(0, 1000, n).astype(np.int32)
        resets = rng.random(n) < 0.03
        got = np.asarray(
            scans.segmented_min_scan(jnp.asarray(vals), jnp.asarray(resets),
                                     chunk=128)
        )
        want = matchstats_np.segmented_min_scan(vals, resets, block=512)
        assert (got.astype(np.int64) == want).all()

    def test_short_input(self, rng):
        import jax.numpy as jnp

        vals = np.array([5, 3, 7], dtype=np.int32)
        resets = np.array([False, True, False])
        got = np.asarray(
            scans.segmented_min_scan(jnp.asarray(vals), jnp.asarray(resets))
        )
        assert list(got) == [5, 3, 3]


class TestDeviceLCP:
    def _check(self, layout):
        from andix.esa.backend_jax import bucket, pad_symbols

        be = JaxBackend(device_lcp=True)
        ctx = be.prepare_block(layout)
        n = layout.n
        padded = pad_symbols(layout.sym, bucket(n))
        sa = np.asarray(ctx.sa_d)
        want = sa_numpy.lcp_array(padded, sa)
        got = np.asarray(ctx.lcp_d)
        assert (got[:n] == want[:n]).all()

    def test_mutated_family_block(self, rng, dna, mutator):
        """Near-identical genomes force deep rank levels (long shared
        runs); the level walk + drop-distinct-top + iota padding must stay
        exact."""
        base = dna(rng, 400)
        rs = {0: catcomp(base), 1: catcomp(mutator(rng, base, 0.01))}
        qs = {2: mutator(rng, base, 0.03)}
        self._check(joint.build_block(rs, qs))

    def test_identical_genomes_block(self, rng, dna):
        """Identical sequences: ties resolve only at segment separators —
        the deepest-possible level stack for a given length."""
        base = dna(rng, 300)
        self._check(joint.build_block({0: catcomp(base), 1: catcomp(base)}, {}))

    def test_repetitive_text(self):
        contig = np.frombuffer(b"GATTACA" * 40, np.uint8)
        self._check(joint.build_block({0: catcomp(contig)}, {}))

    def test_plcp_equals_level_walk(self, rng, dna, mutator, monkeypatch):
        """Sampled-PLCP word-ladder LCP == rank-level walk on block texts,
        across divergence regimes and deep repeats."""
        from andix.esa import doubling
        from andix.esa.backend_jax import bucket, device_text

        rep = np.frombuffer(b"ACGT" * 800, np.uint8).copy()
        base = dna(rng, 900)
        families = [
            {0: catcomp(base), 1: catcomp(mutator(rng, base, 0.005)),
             2: catcomp(mutator(rng, base, 0.2))},
            {0: catcomp(rep), 1: catcomp(rep.copy())},
        ]
        for rs in families:
            layout = joint.build_block(rs, {})
            sym_d = device_text(layout, bucket(layout.n))
            sa2, lcp2, ovf2, _ = doubling.sa_lcp_device(
                sym_d, packed=True, lcp_mode="levels"
            )
            for mode in ("plcp", "hybrid"):
                sa1, lcp1, ovf1, _ = doubling.sa_lcp_device(
                    sym_d, packed=True, lcp_mode=mode
                )
                assert not bool(np.asarray(ovf1)), mode
                assert (np.asarray(sa1) == np.asarray(sa2)).all(), mode
                # padding slots may differ (the level walk leaves
                # unconsumed garbage there, see _lcp_from_level_buffer);
                # real region exact
                n = layout.n
                assert (
                    np.asarray(lcp1)[:n] == np.asarray(lcp2)[:n]
                ).all(), mode

    def test_hybrid_fuzz_vs_oracle(self, dna, mutator):
        """Many-seed oracle fuzz of the default (hybrid) SA+LCP dispatch:
        random families across divergence regimes, exact SA and LCP."""
        from andix.esa import doubling, sa_numpy
        from andix.esa.backend_jax import bucket, device_text, pad_symbols

        for seed in range(10):
            rng = np.random.default_rng(5000 + seed)
            base = dna(rng, 600 + 97 * seed)
            rs = {
                0: catcomp(base),
                1: catcomp(mutator(rng, base, [0, 0.004, 0.05, 0.3][seed % 4])),
            }
            layout = joint.build_block(rs, {})
            sym_d = device_text(layout, bucket(layout.n))
            sa, lcp, ovf, _ = doubling.sa_lcp_device(
                sym_d, packed=True, lcp_mode="hybrid"
            )
            padded = pad_symbols(layout.sym, bucket(layout.n))
            sa_ref = sa_numpy.suffix_array(padded)
            lcp_ref = sa_numpy.lcp_array(padded, sa_ref)
            assert not bool(np.asarray(ovf)), seed
            assert (np.asarray(sa) == sa_ref).all(), seed
            assert (np.asarray(lcp) == lcp_ref).all(), seed

    def test_level_budget_overflow_falls_back_to_host(
        self, rng, dna, monkeypatch
    ):
        """Identical genomes resolve no ranks until width ~ genome length;
        with a tiny memory budget level collection must abandon mid-run and
        the block must take the host-LCP path with identical results."""
        from andix.esa import backend_jax

        from andix.esa import doubling

        monkeypatch.setenv("ANDIX_SHARDED", "0")  # exercise prepare_block
        # the sampled-PLCP path resolves this input even at the tiny budget
        # (its word ladder needs no low-width levels); pin the rank-level
        # walk so the overflow -> host-LCP fallback wiring is exercised
        monkeypatch.setenv("ANDIX_LCP", "levels")
        base = dna(rng, 800)
        seqs = [Seq(base, "a"), Seq(base.copy(), "b")]
        ctx = Context()
        want = pipeline.calculate_matrix(seqs, ctx, pipeline.NumpyBackend())
        padded = backend_jax.bucket(2 * (2 * 800 + 2))
        # budget = (68B - 40B) / 4B = 7 levels: >= 6 so the device path is
        # tried, fewer than identical genomes need, so collection overflows
        monkeypatch.setattr(
            backend_jax, "device_mem_bytes", lambda: 68 * padded
        )
        overflowed = {"n": 0}
        orig = doubling.sa_lcp_device

        def spy(*a, **kw):
            sa, lcp, ovf, may_ovf = orig(*a, **kw)
            if may_ovf and bool(np.asarray(ovf)):
                overflowed["n"] += 1
            return sa, lcp, ovf, may_ovf

        monkeypatch.setattr(backend_jax.doubling, "sa_lcp_device", spy)
        got = pipeline.calculate_matrix(seqs, ctx, JaxBackend())
        assert overflowed["n"] > 0, "level collection never overflowed"
        for i in range(2):
            for j in range(2):
                assert (got[i][j].counts == want[i][j].counts).all()


class TestDeviceText:
    def test_packed_and_dense_paths_agree(self, rng, dna, mutator):
        """The 2-bit packed upload and the byte/dense upload must rebuild
        identical device texts (real region exact, padding strictly
        increasing and oversized) — ADVICE r1: the dense branch was
        untested."""
        from andix.esa.backend_jax import bucket, device_text
        from andix.sequence import join

        # contig joiners ('!' / ';') land in the exception list
        contigs = [dna(rng, 40) for _ in range(5)]
        s1 = join(contigs)
        s2 = mutator(rng, dna(rng, 230), 0.0)
        layout = joint.build_block({0: catcomp(s1)}, {1: s2})
        padded_n = bucket(layout.n)
        a = np.asarray(device_text(layout, padded_n))
        b = np.asarray(device_text(layout, padded_n, force_dense=True))
        n = layout.n
        assert (a[:n] == b[:n]).all()
        assert (a[:n] == layout.sym).all()
        assert (a[n:] >= 1 << 20).all() and (np.diff(a[n:]) > 0).all()
        assert (b[n:] >= 1 << 20).all() and (np.diff(b[n:]) > 0).all()


class TestJaxBackendStats:
    def test_pair_stats_vs_brute(self, rng, dna, mutator):
        s1 = dna(rng, 300)
        s2 = mutator(rng, s1, 0.08)
        rs = catcomp(s1)
        layout = joint.build_block({0: rs}, {1: s2})
        be = JaxBackend()
        ctx = be.prepare_block(layout)
        ml, un, ps = be.subject_stats(ctx, 0)
        # slice out genome 1's span from the blob
        k = ctx.q_genomes.index(1)
        lo, hi = int(ctx.q_off[k]), int(ctx.q_off[k + 1])
        bml, bun, bps = match_stats_brute(rs, s2)
        assert (ml[lo:hi] == bml).all()
        assert (un[lo:hi] == bun).all()
        assert (ps[lo:hi][bun] == bps[bun]).all()


class TestJaxPipeline:
    def _grids_equal(self, A, B, n):
        return all(
            (A[i][j].counts == B[i][j].counts).all()
            and A[i][j].seq_len == B[i][j].seq_len
            for i in range(n)
            for j in range(n)
        )

    def test_matrix_equals_numpy_backend(self, rng, dna, mutator):
        base = dna(rng, 600)
        seqs = [Seq(base, "g0")] + [
            Seq(mutator(rng, base, r), f"g{k+1}")
            for k, r in enumerate([0.02, 0.07, 0.15])
        ]
        ctx = Context()
        M_np = pipeline.calculate_matrix(seqs, ctx, pipeline.NumpyBackend())
        M_jx = pipeline.calculate_matrix(seqs, ctx, JaxBackend())
        assert self._grids_equal(M_np, M_jx, 4)

    def test_blocked_jax_equals_single_block(self, rng, dna, mutator):
        base = dna(rng, 400)
        seqs = [Seq(base, "g0")] + [
            Seq(mutator(rng, base, r), f"g{k+1}")
            for k, r in enumerate([0.03, 0.06, 0.1, 0.2])
        ]
        ctx = Context()
        M_one = pipeline.calculate_matrix(seqs, ctx, JaxBackend())
        M_blk = pipeline.calculate_matrix(
            seqs, ctx, JaxBackend(), block_syms=2500
        )
        assert self._grids_equal(M_one, M_blk, 5)


def _flag_scan_oracle(vals, flags, sa):
    """Brute-force flag-window scan: per position the flag count (capped
    at 2), the min over (second-last flag, last flag], the last flag's
    payload, and the min over (last flag, here]."""
    inf = 2**31 - 1
    n = len(vals)
    out = np.zeros((4, n), dtype=np.int64)
    k, g, last_sa, suf = 0, inf, -1, inf
    for t in range(n):
        v = int(vals[t])
        if flags[t]:
            g = min(suf, v) if k else inf
            suf = inf
            last_sa = int(sa[t])
            k = min(k + 1, 2)
        elif k:
            suf = min(suf, v)
        out[:, t] = (k, g, last_sa, suf)
    return out


_FLAG_CASES = [(5000, 1024, 0.1), (1024, 1024, 0.1), (70001, 1024, 0.1),
               (333, 64, 0.1), (64, 64, 0.1), (3000, 1024, 1.0),
               (3000, 1024, 0.0)]


def _check_flag_scan(fn, n, chunk, rate):
    import jax.numpy as jnp

    rng = np.random.default_rng(n)
    vals = rng.integers(0, 100, n).astype(np.int32)
    flags = rng.random(n) < rate
    sa = rng.integers(0, n, n).astype(np.int32)
    got = fn(jnp.asarray(vals), jnp.asarray(flags), jnp.asarray(sa), chunk)
    want = _flag_scan_oracle(vals, flags, sa)
    for row, arr in zip(want, got):
        assert (np.asarray(arr) == row).all()


_FLAG_IDS = [f"n{n}-c{c}-f{r}" for n, c, r in _FLAG_CASES]


@pytest.mark.parametrize("n,chunk,rate", _FLAG_CASES, ids=_FLAG_IDS)
def test_flag_scan_matches_oracle(n, chunk, rate):
    """``scans.flag_scan`` (the XLA evaluation off the GPU) against the
    sequential oracle, including all-flagged and none-flagged inputs."""
    _check_flag_scan(scans.flag_scan, n, chunk, rate)


@pytest.mark.parametrize("n,chunk,rate", _FLAG_CASES, ids=_FLAG_IDS)
def test_flag_scan_triton_interpret_matches_oracle(n, chunk, rate):
    """The GPU kernels of ``flag_scan`` (Pallas through Triton), run in the
    Pallas interpreter, against the same oracle and cases."""
    import functools

    _check_flag_scan(
        functools.partial(scans._flag_scan_triton, interpret=True),
        n, chunk, rate,
    )


@pytest.mark.gpu
def test_flag_scan_on_gpu_matches_oracle(gpu_device):
    """``flag_scan`` as the GPU lowers it (the compiled Triton kernels)."""
    import jax

    with jax.default_device(gpu_device):
        for n, chunk, rate in _FLAG_CASES:
            _check_flag_scan(scans.flag_scan, n, chunk, rate)

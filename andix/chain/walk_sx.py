"""Chain walk over the subject-only index (search-in-the-loop kernel).

Same chain semantics and event contract as ``replay_device.chain_walk_flat``
(``dist_anchor``, src/process.c:141-214), but the per-probe match statistics
come from a SEEDED BINARY SEARCH in the per-subject suffix array
(``esa.subject_index``) instead of precomputed [Sg, QB] tables:

* no joint SA over subjects + queries (the 57% eco29 phase), no per-subject
  flag scans, no table memory — queries exist on device only as 4-bit packed
  words (~1/16 the bytes of the old int32 text),
* the lucky-anchor extension (src/process.c:82-100) is the same word-compare
  primitive against the diagonal-projected subject position — the joint-text
  RMQ/LCE is gone.

The loop is a fully ASYNCHRONOUS per-lane state machine; its unit cost is
the ITERATION, so the design packs a whole probe into as few iterations as
possible:

* probe-START control (k-mer code, cache bracket, transition gathers) and
  the first window compare happen in the SAME iteration — an empty cache
  bracket (the common case at cache_k=12) resolves a whole probe, both
  boundary lcps included, in ONE iteration;
* the two boundary extensions (vs SA[ip-1] and SA[ip]) run SIMULTANEOUSLY
  from the shared offset min(l_lo, l_hi) — re-comparing the few
  known-equal symbols of the deeper side is free next to an extra
  iteration;
* bisection steps cost one iteration each: the resolution picks the next
  mid (or the boundary pair) with an end-of-iteration gather, and the next
  compare starts immediately.

A nested per-phase-loop design measured 2-3x slower (each sub-loop paid
max-over-lanes, not per-lane sums); a one-op-per-iteration flat design
without fused control still spent ~3.5 iterations per probe.

Comparisons never need explicit length caps: the query sentinel (code 0)
and the subject separator/padding codes are outside each other's
alphabets, so every compare terminates at the true boundary (see
``subject_index`` module docstring).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

# probe pipeline phases (per lane)
P_FIRST = 0  # fresh probe: cache seed + first compare
P_LUCKY = 1  # lucky-anchor extension
P_BIS = 2  # bisection compare vs SA[mid]
P_AB = 3  # both boundary extensions vs SA[ip-1] / SA[ip]


def _combine_window(w0, w1, r):
    """16-symbol window starting ``r`` nibbles into w0 (0 <= r <= 15)."""
    return jnp.where(
        r > 0,
        (w0 << (4 * r)) | ((w1 >> (4 * (16 - jnp.maximum(r, 1)))) &
                           ((jnp.int64(1) << (4 * jnp.maximum(r, 1))) - 1)),
        w0,
    )


def _word_lcp(wa, wb):
    """Agreeing symbols between two windows (16 iff equal)."""
    return (jax.lax.clz(wa ^ wb) >> 2).astype(jnp.int32)


def _nibble(w, i):
    return ((w >> (4 * (15 - i))) & 15).astype(jnp.int32)


@functools.partial(jax.jit, static_argnames=("cache_k", "ecap", "unroll"))
def chain_walk_flat_sx(
    salcp,  # int32[S, 2, Lp]: [:,0]=suffix array, [:,1]=adjacent LCP
    sw,  # int64[S, Lp//16] subject packed words
    cache2,  # int32[S, 4^cache_k + 1] k-mer insertion points
    nreal,  # int32[S] real text length per subject (RS + separator)
    qw,  # int64[QW] query packed words (queries + sentinels, padded)
    row,  # int32[Lb] subject row of each lane
    qwb,  # int32[Lb] query base (symbol offset into the qw blob)
    rl,  # int32[Lb] RS length (n_real - 1)
    thr,  # int32[Lb] anchor threshold
    seg_end,  # int32[Lb] lane-relative stop position (exclusive)
    pos0,  # int32[Lb] entry probe position
    lq0,  # int32[Lb] entry last-anchor query position
    ls0,  # int32[Lb] entry last-anchor subject position
    ll0,  # int32[Lb] entry last-anchor length
    max_iters,  # int32 scalar (traced)
    max_events,  # int32 scalar (traced): per-lane event budget
    cache_k: int,
    ecap: int,
    unroll: int = 8,
):
    """Resumable flat-lane chain walk chunk (``chain_walk_flat`` contract):
    lanes enter at an arbitrary chain state and stop at ``seg_end`` /
    their event budget / the chunk iteration budget; lanes cut mid-probe
    re-enter at the probe start (pos is only advanced at probe ends).

    Returns (ev_lane, ev_q, ev_s, ev_len, ev_cnt, ovf, iters,
    pos, lq, ls, ll, fin)."""
    lb = row.shape[0]
    lanes_sq = sw.shape[1]
    sa_last = salcp.shape[2] - 1
    qw_last = qw.shape[0] - 1
    lane_iota = jnp.arange(lb, dtype=jnp.int32)
    nr = nreal[row]
    two = jnp.arange(2, dtype=jnp.int32)[None, :]
    _z2 = jnp.zeros((1, 2), jnp.int32)
    _o2 = jnp.ones((1, 2), jnp.int32)

    def qwin(p):
        j = p >> 4
        r = p & 15
        w = qw[jnp.minimum(j[:, None] + two, qw_last)]
        return _combine_window(w[:, 0], w[:, 1], r)

    def swin2(pA, pB):
        """Both subject windows in ONE gather op ([lanes, 4] words):
        each gather op has a fixed launch cost at production widths, so
        op COUNT, not element count, prices an iteration."""
        jA = pA >> 4
        rA = pA & 15
        jB = pB >> 4
        rB = pB & 15
        cols = jnp.stack(
            [jA, jA + 1, jB, jB + 1], 1
        )
        w = sw[row[:, None], jnp.minimum(cols, lanes_sq - 1)]
        return (
            _combine_window(w[:, 0], w[:, 1], rA),
            _combine_window(w[:, 2], w[:, 3], rB),
        )

    def sa_pair(colA, colB):
        idx = jnp.stack(
            [jnp.clip(colA, 0, sa_last), jnp.clip(colB, 0, sa_last)], 1
        )
        g = salcp[row[:, None], _z2, idx]
        return g[:, 0], g[:, 1]

    def sa_lcp_quad(colA, colB, lcpA_col, lcpB_col):
        """SA pair + LCP pair in ONE gather into the stacked array."""
        idx = jnp.stack(
            [
                jnp.clip(colA, 0, sa_last),
                jnp.clip(colB, 0, sa_last),
                jnp.clip(lcpA_col, 0, sa_last),
                jnp.clip(lcpB_col, 0, sa_last),
            ],
            1,
        )
        comp = jnp.concatenate([_z2, _o2], 1)
        g = salcp[row[:, None], comp, idx]
        return g[:, 0], g[:, 1], g[:, 2], g[:, 3]

    def lucky_cond(pos, lq, ls, ll, fin):
        """Reference lucky-anchor precondition (src/process.c:82-100,156):
        within threshold of the last anchor, projected onto the diagonal."""
        in_range = (~fin) & (pos < seg_end)
        advance = pos - lq
        gap = advance - ll
        try_s = ls + advance
        return in_range & (try_s < rl) & (gap >= 0) & (gap <= thr), try_s

    def setup_sp(pos, lq, ls, ll, fin):
        pre, try_s = lucky_cond(pos, lq, ls, ll, fin)
        return jnp.where(pre, try_s, 0)

    def iteration(lanes_state, stage, u):
        (pos, lq, ls, ll, fin, evn,
         ph, h, spA, spB, lo, hi, llo, lhi, ipv, aa, bb) = lanes_state

        act = ~fin
        qa = qwb + jnp.where(act, pos, 0)
        wq = qwin(qa + h)

        # ---- probe-start control: k-mer code + cache bracket + seek ----
        is_first = act & (ph == P_FIRST)
        code = jnp.zeros(lb, jnp.int32)
        valid = is_first
        for i in range(cache_k):
            nib = _nibble(wq, i)
            valid = valid & (nib >= 4) & (nib <= 7)
            code = (code << 2) | jnp.clip(nib - 4, 0, 3)
        safe_code = jnp.where(valid, code, 0)
        cpair = cache2[
            row[:, None],
            jnp.stack([safe_code, safe_code + 1], 1),
        ]
        clo = cpair[:, 0]
        chi = cpair[:, 1]
        lo = jnp.where(is_first, jnp.where(valid, clo, 0), lo)
        hi = jnp.where(is_first, jnp.where(valid, chi, nr), hi)
        llo = jnp.where(is_first, 0, llo)
        lhi = jnp.where(is_first, 0, lhi)

        lucky_pre, _try_s = lucky_cond(pos, lq, ls, ll, fin)
        first_lucky = is_first & lucky_pre
        first_nl = is_first & ~lucky_pre
        e_to_bis = first_nl & (lo < hi)
        e_to_ab = first_nl & (lo >= hi)
        ipv = jnp.where(e_to_ab, lo, ipv)
        mid_e = (lo + hi) >> 1
        tgA, tgB = sa_pair(
            jnp.where(e_to_bis, mid_e, ipv - 1),
            jnp.where(e_to_bis, mid_e, ipv),
        )
        spA = jnp.where(e_to_bis | e_to_ab, tgA, spA)
        spB = jnp.where(e_to_ab, tgB, spB)
        ph = jnp.where(first_lucky, P_LUCKY, ph)
        ph = jnp.where(e_to_bis, P_BIS, ph)
        ph = jnp.where(e_to_ab, P_AB, ph)

        # ---- compares (A slot: lucky/bis/left boundary; B slot: right) --
        in_lucky = act & (ph == P_LUCKY)
        in_bis = act & (ph == P_BIS)
        in_ab = act & (ph == P_AB)
        a_active = in_lucky | in_bis | (in_ab & (aa < 0) & (ipv > 0))
        b_active = in_ab & (bb < 0) & (ipv < nr)
        wsA, wsB = swin2(
            jnp.where(a_active, spA, 0) + h,
            jnp.where(b_active, spB, 0) + h,
        )
        mA = _word_lcp(wq, wsA)
        mB = _word_lcp(wq, wsB)
        miA = jnp.minimum(mA, 15)
        qnA = _nibble(wq, miA)
        snA = _nibble(wsA, miA)
        mmA = mA < 16
        mmB = mB < 16
        lcpA = h + mA
        lcpB = h + mB

        # lucky resolution
        l_done = in_lucky & mmA
        l_acc = l_done & (lcpA >= thr)
        l_fail = l_done & ~l_acc

        # bisection resolution (mid from pre-update lo/hi)
        b_done = in_bis & mmA
        mid = (lo + hi) >> 1
        qless = qnA < snA
        go_hi = b_done & qless
        go_lo = b_done & ~qless
        hi = jnp.where(go_hi, mid, hi)
        lhi = jnp.where(go_hi, lcpA, lhi)
        lo = jnp.where(go_lo, mid + 1, lo)
        llo = jnp.where(go_lo, lcpA, llo)

        # boundary resolutions
        aa = jnp.where(in_ab & a_active & mmA, lcpA, aa)
        bb = jnp.where(in_ab & b_active & mmB, lcpB, bb)
        doneA = (aa >= 0) | (ipv <= 0)
        doneB = (bb >= 0) | (ipv >= nr)
        ab_done = in_ab & doneA & doneB

        # shared-offset advance while anything still extends
        still = (
            (in_lucky & ~mmA)
            | (in_bis & ~mmA)
            | (in_ab & ~ab_done & ((a_active & ~mmA) | (b_active & ~mmB)))
        )
        h = jnp.where(still, h + 16, h)

        # ---- late seek: failed lucky / resolved bisect step ----
        seek = l_fail | b_done
        post_to_bis = seek & (lo < hi)
        post_to_ab = seek & (lo >= hi)
        ipv = jnp.where(post_to_ab, lo, ipv)
        mid2 = (lo + hi) >> 1
        ip1s_pre = jnp.where(ipv + 1 < nr, ipv + 1, 0)
        tgA2, tgB2, lcpPA, lcpPB = sa_lcp_quad(
            jnp.where(post_to_bis, mid2, ipv - 1),
            jnp.where(post_to_bis, mid2, ipv),
            jnp.maximum(ipv - 1, 0),
            ip1s_pre,
        )
        spA = jnp.where(post_to_bis | post_to_ab, tgA2, spA)
        spB = jnp.where(post_to_ab, tgB2, spB)
        ph = jnp.where(post_to_bis, P_BIS, ph)
        ph = jnp.where(post_to_ab, P_AB, ph)
        h = jnp.where(seek, jnp.minimum(llo, lhi), h)

        # ---- FINAL: stats, chain update, next-probe setup ----
        finishing = ab_done | l_acc
        ml = jnp.maximum(jnp.maximum(aa, bb), 0)
        use_a = aa >= bb
        unique = (
            (ml > 0)
            & (aa != bb)
            & jnp.where(
                use_a, lcpPA < aa, (ipv + 1 >= nr) | (lcpPB < bb)
            )
        )
        psv = jnp.where(use_a, spA, spB)
        found = l_acc | (ab_done & unique & (ml >= thr))
        this_len = jnp.where(l_acc, lcpA, ml)
        this_s = jnp.where(l_acc, spA, psv)

        ev_pos = pos
        lq = jnp.where(found, pos, lq)
        ls = jnp.where(found, this_s, ls)
        ll = jnp.where(found, this_len, ll)
        pos = jnp.where(finishing, pos + this_len + 1, pos)
        evn = evn + found.astype(jnp.int32)
        fin = fin | (
            finishing & ((pos >= seg_end) | (evn >= max_events))
        )
        ph = jnp.where(finishing, P_FIRST, ph)
        h = jnp.where(finishing, 0, h)
        aa = jnp.where(finishing, -1, aa)
        bb = jnp.where(finishing, -1, bb)
        spA = jnp.where(finishing, setup_sp(pos, lq, ls, ll, fin), spA)

        # ---- stage the event (flushed once per super-step) ----
        f = found.astype(jnp.int32)
        lane_len = (lane_iota.astype(jnp.int64) << 32) | this_len.astype(
            jnp.int64
        )
        q_s = (ev_pos.astype(jnp.int64) << 32) | this_s.astype(jnp.int64)
        st_ll, st_qs, st_f = stage
        st_ll = jax.lax.dynamic_update_index_in_dim(st_ll, lane_len, u, 0)
        st_qs = jax.lax.dynamic_update_index_in_dim(st_qs, q_s, u, 0)
        st_f = jax.lax.dynamic_update_index_in_dim(st_f, f, u, 0)

        return (
            (pos, lq, ls, ll, fin, evn,
             ph, h, spA, spB, lo, hi, llo, lhi, ipv, aa, bb),
            (st_ll, st_qs, st_f),
        )

    def super_body(state):
        lanes_state, ev_lane_len, ev_qs, ev_cnt, ovf, it = state
        stage = (
            jnp.zeros((unroll, lb), jnp.int64),
            jnp.zeros((unroll, lb), jnp.int64),
            jnp.zeros((unroll, lb), jnp.int32),
        )

        def inner(u, st):
            return iteration(st[0], st[1], u)

        lanes_state, stage = jax.lax.fori_loop(
            0, unroll, inner, (lanes_state, stage)
        )
        st_ll, st_qs, st_f = stage
        # u-major flatten keeps chain order per lane (iterations are
        # ordered; within one iteration, distinct lanes)
        f = st_f.reshape(-1)
        excl = jnp.cumsum(f, dtype=jnp.int32) - f
        slot = jnp.where(f > 0, ev_cnt + excl, ecap)
        ev_lane_len = ev_lane_len.at[slot].set(
            st_ll.reshape(-1), mode="drop"
        )
        ev_qs = ev_qs.at[slot].set(st_qs.reshape(-1), mode="drop")
        ev_cnt = ev_cnt + jnp.sum(f, dtype=jnp.int32)
        ovf = ovf | (ev_cnt > ecap)
        return (lanes_state, ev_lane_len, ev_qs, ev_cnt, ovf, it + unroll)

    def cond(state):
        return jnp.any(~state[0][4]) & (state[-1] < max_iters)

    fin0 = (pos0 >= seg_end) | (jnp.int32(0) >= max_events)
    z = jnp.zeros(lb, jnp.int32)
    neg = jnp.full(lb, -1, jnp.int32)
    sp0 = setup_sp(pos0, lq0, ls0, ll0, fin0)
    lanes0 = (pos0, lq0, ls0, ll0, fin0, z,
              z, z, sp0, z, z, z, z, z, z, neg, neg)
    init = (lanes0,
            jnp.zeros(ecap, jnp.int64), jnp.zeros(ecap, jnp.int64),
            jnp.zeros((), jnp.int32), jnp.bool_(False),
            jnp.zeros((), jnp.int32))
    final = jax.lax.while_loop(cond, super_body, init)
    (lanes_f, ev_lane_len, ev_qs, ev_cnt, ovf, it) = final
    pos, lq, ls, ll, fin = lanes_f[:5]
    # raw packed event buffers: the fetch path either compresses them on
    # device (chain.evpack, ~6 B/event D2H) or unpacks to int32 quads
    return (ev_lane_len, ev_qs, ev_cnt, ovf, it,
            pos, lq, ls, ll, fin)

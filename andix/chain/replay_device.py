"""On-device anchor-chain walk (JAX, one lock-step loop for all lanes).

The reference's per-pair scan (``dist_anchor``, src/process.c:141-214) is
sequential in the visited positions, but each visit is O(1) given:

* precomputed per-position match statistics (device scans,
  ``matchstats_jax``) gathered through the inverse SA, and
* O(1) longest-common-extension queries for lucky anchors
  (``esa.rmq``: LCE(a,b) = range-min of adjacent LCPs between the ISA
  positions) replacing the reference's byte loop (src/process.c:59-65).

All (subject, query) lanes of a subject group advance in ONE
``lax.while_loop`` over [Sg, G]-shaped state — not a vmapped per-lane loop:
with explicit batching the expensive phases can be skipped by *scalar*
``lax.cond`` when no lane needs them (vmap would turn the conds into
selects that execute both branches).  Anchor-free stretches (diverged
pairs, where the scan is pure ``pos += len + 1`` skipping) cross many
chain steps per iteration via the jump table + an in-loop chase of tiny
[Sg, G] gathers.

PRODUCTION path — ``chain_anchors_device``: the loop only walks the chain
(several unrolled probe steps per iteration) and records every accepted
anchor as (lane, pos_q, pos_s, len); the 16-cell counting is a pure
function of that event sequence plus the text (src/process.c:160-211) and
runs on host (``chain.events`` / native C++) — per-site device work never
enters the loop.

FALLBACK / A-B path — ``replay_rows_device``: the original count-in-loop
replay (gap/equal chunks processed on device); used when the event buffer
overflows and for ANDIX_REPLAY=loop A/Bs.  The shard_map multi-chip step
runs the anchor-event path too (``parallel.py`` fetches per-device events
from addressable shards and host-counts them; its loop fallback covers
overflow / ANDIX_SHARDED_REPLAY=loop).  The native C++ replay
(``andix.native``) remains as host fallback and cross-check oracle.
"""

from __future__ import annotations

import functools
import os

import jax
import jax.numpy as jnp

from ..esa import rmq

A_BYTE = jnp.int32(65)
# sites classified per loop iteration and lane / in-loop jump-chase hops.
# The chase hops are [Sg, G]-sized gathers (~microseconds each), so a
# deeper chase is far cheaper than pointer-doubling passes over the full
# jump table (two QB-sized gathers per pass per subject) — the default
# jump_passes is therefore 0 with a longer chase.
COUNT_CHUNK = int(os.environ.get("ANDIX_COUNT_CHUNK", "256"))
JUMP_CHASE = int(os.environ.get("ANDIX_JUMP_CHASE", "12"))

# cell layout: index = (from << 2) | to, A=0 C=1 G=2 T=3 (src/model.h:14-32)
_DIAG = jnp.zeros(16, jnp.int32).at[jnp.array([0, 5, 10, 15])].set(1)
_TTTT = jnp.zeros(16, jnp.int32).at[15].set(1)
# (s >> 1) & 3 codes: A->0 C->1 T->2 G->3  ->  cells AtoA CtoC TtoT GtoG
_EQ_CELL = jnp.array([0, 5, 15, 10], jnp.int32)


def _nucl2bit(c):
    c = c & 6
    c = c ^ (c >> 1)
    return c >> 1


UNIQ_BIT = jnp.int32(1 << 30)


@functools.partial(jax.jit, static_argnames=("jump_passes",))
def prepare_subject_tables(
    ml_sa: jax.Array,  # int32[Np] SA-order match lengths
    un_sa: jax.Array,  # bool[Np]
    ps_sa: jax.Array,  # int32[Np]
    tq: jax.Array,  # int32[QB] SA slots of the query blob entries
    threshold: jax.Array,  # scalar
    jump_passes: int,
):
    """Blob-ordered packed stats + anchor-candidate jump table.

    Arrays are indexed by *query-blob* position (all genomes' query
    positions back to back — half the size of the text and the only
    positions the replay ever probes).  ``mlun[v]`` packs the match length
    with the uniqueness flag (bit 30) — one gather per probe instead of
    three.  ``jump[v]`` resolves the pure ``pos += len + 1`` probe chain
    (valid whenever the gap to the last anchor exceeds the threshold, which
    disables lucky anchors) to the first anchor *candidate* (unique & len >=
    threshold) by pointer doubling — the replay crosses anchor-free
    stretches in one step with identical semantics (intermediate probes
    have no side effects; a chain crossing a genome boundary lands past the
    lane's span and simply terminates the lane).  Partial resolution after
    ``jump_passes`` is still correct: the replay just jumps again (and
    chases the table a few extra hops in-loop, see ``replay_rows_device``).
    Candidates are exactly the fixed points (jump[v] == v)."""
    qb = tq.shape[0]
    # pack in SA order first so the blob reorder is two gathers, not three
    mlun_sa = ml_sa | jnp.where(un_sa, UNIQ_BIT, 0)
    mlun = mlun_sa[tq]
    ps_b = ps_sa[tq]
    ml_b = mlun & (UNIQ_BIT - 1)

    v = jnp.arange(qb, dtype=jnp.int32)
    cand = ((mlun & UNIQ_BIT) != 0) & (ml_b >= threshold)
    nxt = jnp.minimum(v + ml_b + 1, jnp.int32(qb - 1))
    jump = jnp.where(cand, v, nxt)
    for _ in range(jump_passes):
        stop = cand[jump] | (jump >= qb - 1)
        jump = jnp.where(stop, jump, jump[jump])
    return mlun, ps_b, jump


@functools.partial(
    jax.jit, static_argnames=("jump_passes", "want_jump")
)
def single_subject_tables(
    sa, lcp, segid, tq, subj_seg, subj_start, threshold, jump_passes: int,
    want_jump: bool = True,
):
    """One subject's matchstats + replay tables as its own program: the
    8-wide vmapped build holds [Sg, N] scan intermediates — 18+ GB at
    67M-symbol eco29 blocks — so big blocks build tables subject by
    subject (peak [1, N]) and stack the [QB] rows.  ``want_jump=False``
    (the segmented walk derives hops from mlun) skips the jump table."""
    from ..esa import matchstats_jax

    ml, un, ps = matchstats_jax.match_stats_device(
        sa, lcp, segid, subj_seg, subj_start
    )
    mlun, ps_b, jump = prepare_subject_tables(
        ml, un, ps, tq, threshold, jump_passes
    )
    if not want_jump:
        return mlun, ps_b
    return mlun, ps_b, jump


@functools.partial(
    jax.jit,
    static_argnames=("jump_passes", "want_jump"),
    donate_argnums=(0, 1),
)
def single_subject_tables_acc(
    buf0, buf1, sa, lcp, segid, tq, subj_seg, subj_start, threshold, k,
    jump_passes: int, want_jump: bool = False,
):
    """``single_subject_tables`` fused with the donated row write: the
    split-table path previously issued 3 dispatches per subject (build +
    two row accumulations).  One program per subject now."""
    assert not want_jump, "fused accumulation serves the segmented walk"
    mlun, ps_b = single_subject_tables(
        sa, lcp, segid, tq, subj_seg, subj_start, threshold,
        jump_passes, want_jump=False,
    )
    buf0 = jax.lax.dynamic_update_index_in_dim(buf0, mlun, k, 0)
    buf1 = jax.lax.dynamic_update_index_in_dim(buf1, ps_b, k, 0)
    return buf0, buf1


@functools.partial(
    jax.jit, static_argnames=("jump_passes", "want_jump")
)
def group_subject_tables(
    sa: jax.Array,  # int32[Np]
    lcp: jax.Array,  # int32[Np]
    segid: jax.Array,  # int32[Np]
    tq: jax.Array,  # int32[QB]
    subj_segs: jax.Array,  # int32[Sg] (-1 padding rows yield all-zero stats)
    subj_starts: jax.Array,  # int32[Sg]
    thresholds: jax.Array,  # int32[Sg]
    jump_passes: int,
    want_jump: bool = True,
):
    """Matching statistics + replay tables for a whole subject group in one
    dispatch: vmap over subjects batches the flag scans and the jump-table
    gathers (one program, Sg× wider arrays) instead of 2·Sg separate device
    calls — the per-call overhead dominates on high-latency links."""
    from ..esa import matchstats_jax

    def one(seg, start, thr):
        ml, un, ps = matchstats_jax.match_stats_device(
            sa, lcp, segid, seg, start
        )
        mlun, ps_b, jump = prepare_subject_tables(
            ml, un, ps, tq, thr, jump_passes
        )
        if not want_jump:
            return mlun, ps_b
        return mlun, ps_b, jump

    return jax.vmap(one)(subj_segs, subj_starts, thresholds)


@functools.partial(
    jax.jit, static_argnames=("jump_passes", "exact_counts")
)
def subject_group_counts_device(
    sa, lcp, segid, tq, text, isa, rm,
    subj_segs, subj_starts, rs_lens, thresholds,
    q_base, q_start, q_len2d,
    jump_passes: int, exact_counts: bool,
):
    """Fused tables + replay: ONE device dispatch per subject group instead
    of two.  Returns (counts [Sg, G, 16], loop iterations)."""
    mlun, ps, jump = group_subject_tables(
        sa, lcp, segid, tq, subj_segs, subj_starts, thresholds, jump_passes
    )
    return replay_rows_device(
        text, isa, rm, mlun, ps, jump, subj_starts, rs_lens, thresholds,
        q_base, q_start, q_len2d, exact_counts,
    )


@functools.partial(
    jax.jit, static_argnames=("jump_passes", "ecap", "unroll")
)
def subject_group_anchors_device(
    sa, lcp, segid, tq, isa, rm,
    subj_segs, subj_starts, rs_lens, thresholds,
    q_base, q_start, q_len2d,
    jump_passes: int, ecap: int, unroll: int = 1,
):
    """Fused tables + anchor-event chain walk: ONE device dispatch per
    subject group.  Returns (ev_lane, ev_q, ev_s, ev_len, ev_cnt, overflow,
    iterations) — see ``chain_anchors_device``."""
    mlun, ps, jump = group_subject_tables(
        sa, lcp, segid, tq, subj_segs, subj_starts, thresholds, jump_passes
    )
    return chain_anchors_device(
        isa, rm, mlun, ps, jump, subj_starts, rs_lens, thresholds,
        q_base, q_start, q_len2d, ecap, unroll=unroll,
    )


@functools.partial(jax.jit, static_argnames=("ecap", "chase", "unroll"))
def chain_anchors_device(
    isa,  # int32[Np]
    rm,  # rmq.RangeMin over the adjacent-LCP array
    mlun_b,  # int32[Sg, QB] packed blob-order stats per grouped subject
    ps_b,  # int32[Sg, QB]
    jump_b,  # int32[Sg, QB]
    subj_start,  # int32[Sg] text base of each RS_i
    rs_len,  # int32[Sg]
    threshold,  # int32[Sg]
    q_base,  # int32[G] blob offset of each query lane
    q_start,  # int32[G] text offset of each query lane
    q_len2d,  # int32[Sg, G] (0 disables a lane)
    ecap: int,
    chase: int = JUMP_CHASE,
    unroll: int = 1,
):
    """Anchor-extraction chain walk: the production replay's successor.

    The substitution counts are a pure function of each lane's ANCHOR
    SEQUENCE (consecutive-anchor pairing decisions + gap/equal-run contents,
    ``dist_anchor`` src/process.c:160-211) — so the device loop only walks
    the chain and records every accepted anchor (lane, pos_q, pos_s, len)
    into a global event buffer; the 16-cell counting happens on host from
    the events and the host-resident text (``andix.chain.events`` /
    ``native.count_from_anchors_batch``).

    This removes the [Sg, G, chunk] text gathers + histograms from the loop
    body, which dominated the replay cost at genome scale — leaving only
    [Sg, G]-sized probe work and the cond-gated RMQ LCE.

    Returns (ev_lane, ev_q, ev_s, ev_len — int32[ecap] filled up to ev_cnt
    in chain order per lane, globally interleaved by iteration; ev_cnt;
    overflow — True when the buffer was too small (caller falls back to the
    counting loop); iterations)."""
    sg, qb = mlun_b.shape
    g = q_base.shape[0]

    qbase = jnp.broadcast_to(q_base[None, :], (sg, g))
    qs = jnp.broadcast_to(q_start[None, :], (sg, g))
    qlen = q_len2d
    thr = threshold[:, None]
    ss = subj_start[:, None]
    rl = rs_len[:, None]
    lane_iota = jnp.arange(sg * g, dtype=jnp.int32)

    def row_take(table, idx):
        return jnp.take_along_axis(table, idx, axis=1)

    def lce(a_text, b_text):
        t1 = isa[a_text]
        t2 = isa[b_text]
        lo = jnp.minimum(t1, t2) + 1
        hi = jnp.maximum(t1, t2)
        return rmq.range_min(rm, lo, hi)

    def one_step(pos_q, last_q, last_s, last_len, fin):
        """One probe step of every lane; returns the new chain state plus
        this step's (found, pos_qj, this_s, this_len) for event recording."""
        probe = ~fin

        gap0 = pos_q - last_q - last_len
        took = probe & (gap0 > thr)

        def jump_and_chase(pos_q):
            safe_q = jnp.where(probe, pos_q, 0)
            pos_qj = jnp.where(
                took, row_take(jump_b, qbase + safe_q) - qbase, pos_q
            )
            for _ in range(chase):
                can = took & (pos_qj < qlen)
                safe_j = jnp.where(can, pos_qj, 0)
                nxt = row_take(jump_b, qbase + safe_j) - qbase
                pos_qj = jnp.where(can & (nxt != pos_qj), nxt, pos_qj)
            return pos_qj

        pos_qj = jax.lax.cond(
            jnp.any(took), jump_and_chase, lambda p: p, pos_q
        )
        in_range = probe & (pos_qj < qlen)
        probe_b = qbase + jnp.where(in_range, pos_qj, 0)
        probe_t = qs + jnp.where(in_range, pos_qj, 0)

        advance = pos_qj - last_q
        gap = advance - last_len
        try_s = last_s + advance
        lucky_pre = in_range & (try_s < rl) & (gap >= 0) & (gap <= thr)
        lucky_len = jax.lax.cond(
            jnp.any(lucky_pre),
            lambda: jnp.where(
                lucky_pre,
                lce(probe_t, ss + jnp.where(lucky_pre, try_s, 0)),
                0,
            ),
            lambda: jnp.zeros((sg, g), jnp.int32),
        )
        lucky_found = lucky_pre & (lucky_len >= thr)

        v = row_take(mlun_b, probe_b)
        aml = v & (UNIQ_BIT - 1)
        aun = (v & UNIQ_BIT) != 0
        found = in_range & (lucky_found | (aun & (aml >= thr)))
        this_len = jnp.where(lucky_found, lucky_len, aml)
        this_s = jnp.where(lucky_found, try_s, row_take(ps_b, probe_b))

        last_q = jnp.where(found, pos_qj, last_q)
        last_s = jnp.where(found, this_s, last_s)
        last_len = jnp.where(found, this_len, last_len)
        pos_q = jnp.where(probe, pos_qj + this_len + 1, pos_q)
        fin = fin | (probe & (pos_q >= qlen))
        return (pos_q, last_q, last_s, last_len, fin,
                found, pos_qj, this_s, this_len)

    def cond(state):
        return jnp.any(~state[4])

    def body(state):
        (pos_q, last_q, last_s, last_len, fin,
         ev_lane_len, ev_qs, ev_cnt, ovf, it) = state

        founds, qjs, ths, tls = [], [], [], []
        for _ in range(unroll):
            (pos_q, last_q, last_s, last_len, fin,
             found, pos_qj, this_s, this_len) = one_step(
                pos_q, last_q, last_s, last_len, fin
            )
            founds.append(found.reshape(-1))
            qjs.append(pos_qj.reshape(-1))
            ths.append(this_s.reshape(-1))
            tls.append(this_len.reshape(-1))

        # record the K steps' anchor events with ONE batched compaction:
        # step-major flattening preserves chain order per lane (steps are
        # ordered; within a step, distinct lanes)
        f = jnp.concatenate(founds).astype(jnp.int32)
        excl = jnp.cumsum(f, dtype=jnp.int32) - f
        slot = jnp.where(f > 0, ev_cnt + excl, ecap)
        lanes_k = jnp.concatenate([lane_iota] * unroll).astype(jnp.int64)
        lane_len = (lanes_k << 32) | jnp.concatenate(tls).astype(jnp.int64)
        q_s = (
            jnp.concatenate(qjs).astype(jnp.int64) << 32
        ) | jnp.concatenate(ths).astype(jnp.int64)
        ev_lane_len = ev_lane_len.at[slot].set(lane_len, mode="drop")
        ev_qs = ev_qs.at[slot].set(q_s, mode="drop")
        total = jnp.sum(f, dtype=jnp.int32)
        ev_cnt = ev_cnt + total
        ovf = ovf | (ev_cnt > ecap)

        return (pos_q, last_q, last_s, last_len, fin,
                ev_lane_len, ev_qs, ev_cnt, ovf, it + 1)

    z = jnp.zeros((sg, g), jnp.int32)
    init = (z, z, z, z, qlen <= 0,
            jnp.zeros(ecap, jnp.int64), jnp.zeros(ecap, jnp.int64),
            jnp.zeros((), jnp.int32), jnp.bool_(False),
            jnp.zeros((), jnp.int32))
    final = jax.lax.while_loop(cond, body, init)
    (_, _, _, _, _, ev_lane_len, ev_qs, ev_cnt, ovf, it) = final
    ev_lane = (ev_lane_len >> 32).astype(jnp.int32)
    ev_len = (ev_lane_len & 0x7FFFFFFF).astype(jnp.int32)
    ev_q = (ev_qs >> 32).astype(jnp.int32)
    ev_s = (ev_qs & 0x7FFFFFFF).astype(jnp.int32)
    return ev_lane, ev_q, ev_s, ev_len, ev_cnt, ovf, it * unroll


@functools.partial(jax.jit, static_argnames=("ecap", "chase", "unroll"))
def chain_walk_flat(
    isa,  # int32[Np]
    rm,  # rmq.RangeMin over the adjacent-LCP array
    mlun_f,  # int32[Sg, QB] packed blob-order stats
    ps_f,  # int32[Sg, QB]
    row,  # int32[Lb] subject table row of the lane
    qoff,  # int32[Lb] lane's q_base within the row blob
    qs,  # int32[Lb] text offset of each lane's query
    ss,  # int32[Lb] text base of the lane's subject RS
    rl,  # int32[Lb] RS length
    thr,  # int32[Lb] threshold
    seg_end,  # int32[Lb] lane-relative stop position (exclusive)
    pos0,  # int32[Lb] entry probe position (lane-relative)
    lq0,  # int32[Lb] entry last-anchor query position
    ls0,  # int32[Lb] entry last-anchor subject position
    ll0,  # int32[Lb] entry last-anchor length
    max_iters,  # int32 scalar (traced): loop-iteration budget of this chunk
    max_events,  # int32 scalar (traced): per-lane event budget
    ecap: int,
    chase: int = JUMP_CHASE,
    unroll: int = 1,
):
    """Flat-lane resumable chain-walk chunk (the segmented walk's kernel).

    Same probe semantics as ``chain_anchors_device`` (``dist_anchor``,
    src/process.c:141-214), re-laid-out for the segment-parallel schedule
    (``andix.chain.segmented``):

    * lanes are a FLAT list, not an [Sg, G] grid — each lane carries its own
      subject row (``row``), so finished lanes can be
      compacted away between chunks and query SEGMENTS of the same pair run
      as independent lanes,
    * every lane starts from an arbitrary chain entry state (pos0, lq0,
      ls0, ll0) and stops exactly at ``seg_end``: the exit ``pos`` is the
      true chain's next probe position (jump+chase results are true chain
      positions because the jump chain is only taken while gap > threshold,
      which grows monotonically between anchors),
    * the loop also stops a lane after ``max_events`` recorded anchors and
      the whole chunk after ``max_iters`` iterations — both resumable: the
      returned per-lane state re-enters as the next chunk's entry.

    The chain's cross-probe state is exactly (pos, qend = lq + ll,
    diag = ls - lq): gap = pos - qend and the lucky diagonal try_s =
    pos + diag are the only reads of (lq, ls, ll).  Entry states may
    therefore be canonicalized to ll = 0, lq = qend, ls = qend + diag.

    Returns (ev_lane [compact lane index], ev_q, ev_s, ev_len, ev_cnt,
    ovf, iters, pos, lq, ls, ll, fin)."""
    lb = row.shape[0]
    lane_iota = jnp.arange(lb, dtype=jnp.int32)
    # tables stay 2-D and are gathered with (row, col) index pairs: a
    # flat reshape of a [Sg, QB] array may be a physical copy under a
    # tiled layout, three table-sized transients at genome scale

    def lce(a_text, b_text):
        t1 = isa[a_text]
        t2 = isa[b_text]
        lo = jnp.minimum(t1, t2) + 1
        hi = jnp.maximum(t1, t2)
        return rmq.range_min(rm, lo, hi)

    def one_step(pos, lq, ls, ll, fin, evn):
        probe = ~fin
        gap0 = pos - lq - ll
        took = probe & (gap0 > thr)

        def hop(p):
            # one step of the pure pos += matchlen + 1 chain, stopping at
            # anchor candidates — derived from mlun directly (the
            # materialized jump table of the grid kernels is redundant at
            # jump_passes=0: same single gather per hop, one third less
            # table memory and build time)
            v = mlun_f[row, qoff + p]
            ml = v & (UNIQ_BIT - 1)
            cand = ((v & UNIQ_BIT) != 0) & (ml >= thr)
            return jnp.where(cand, p, p + ml + 1)

        def jump_and_chase(pos):
            safe_q = jnp.where(probe, pos, 0)
            pos_qj = jnp.where(took, hop(safe_q), pos)
            for _ in range(chase):
                can = took & (pos_qj < seg_end)
                safe_j = jnp.where(can, pos_qj, 0)
                nxt = hop(safe_j)
                pos_qj = jnp.where(can & (nxt != pos_qj), nxt, pos_qj)
            return pos_qj

        pos_qj = jax.lax.cond(
            jnp.any(took), jump_and_chase, lambda p: p, pos
        )
        in_range = probe & (pos_qj < seg_end)
        probe_c = qoff + jnp.where(in_range, pos_qj, 0)
        probe_t = qs + jnp.where(in_range, pos_qj, 0)

        advance = pos_qj - lq
        gap = advance - ll
        try_s = ls + advance
        lucky_pre = in_range & (try_s < rl) & (gap >= 0) & (gap <= thr)
        lucky_len = jax.lax.cond(
            jnp.any(lucky_pre),
            lambda: jnp.where(
                lucky_pre,
                lce(probe_t, ss + jnp.where(lucky_pre, try_s, 0)),
                0,
            ),
            lambda: jnp.zeros(lb, jnp.int32),
        )
        lucky_found = lucky_pre & (lucky_len >= thr)

        v = mlun_f[row, probe_c]
        aml = v & (UNIQ_BIT - 1)
        aun = (v & UNIQ_BIT) != 0
        found = in_range & (lucky_found | (aun & (aml >= thr)))
        this_len = jnp.where(lucky_found, lucky_len, aml)
        this_s = jnp.where(lucky_found, try_s, ps_f[row, probe_c])

        lq = jnp.where(found, pos_qj, lq)
        ls = jnp.where(found, this_s, ls)
        ll = jnp.where(found, this_len, ll)
        # out-of-range lanes freeze at pos_qj EXACTLY (it is the true
        # chain's next probe position, the next segment's entry)
        pos = jnp.where(
            probe,
            jnp.where(in_range, pos_qj + this_len + 1, pos_qj),
            pos,
        )
        evn = evn + found.astype(jnp.int32)
        fin = fin | (probe & ((pos >= seg_end) | (evn >= max_events)))
        return (pos, lq, ls, ll, fin, evn,
                found, pos_qj, this_s, this_len)

    def cond(state):
        return jnp.any(~state[4]) & (state[-1] < max_iters)

    def body(state):
        (pos, lq, ls, ll, fin, evn,
         ev_lane_len, ev_qs, ev_cnt, ovf, it) = state

        founds, qjs, ths, tls = [], [], [], []
        for _ in range(unroll):
            (pos, lq, ls, ll, fin, evn,
             found, pos_qj, this_s, this_len) = one_step(
                pos, lq, ls, ll, fin, evn
            )
            founds.append(found.reshape(-1))
            qjs.append(pos_qj.reshape(-1))
            ths.append(this_s.reshape(-1))
            tls.append(this_len.reshape(-1))

        f = jnp.concatenate(founds).astype(jnp.int32)
        excl = jnp.cumsum(f, dtype=jnp.int32) - f
        slot = jnp.where(f > 0, ev_cnt + excl, ecap)
        lanes_k = jnp.concatenate([lane_iota] * unroll).astype(jnp.int64)
        lane_len = (lanes_k << 32) | jnp.concatenate(tls).astype(jnp.int64)
        q_s = (
            jnp.concatenate(qjs).astype(jnp.int64) << 32
        ) | jnp.concatenate(ths).astype(jnp.int64)
        ev_lane_len = ev_lane_len.at[slot].set(lane_len, mode="drop")
        ev_qs = ev_qs.at[slot].set(q_s, mode="drop")
        total = jnp.sum(f, dtype=jnp.int32)
        ev_cnt = ev_cnt + total
        ovf = ovf | (ev_cnt > ecap)

        return (pos, lq, ls, ll, fin, evn,
                ev_lane_len, ev_qs, ev_cnt, ovf, it + 1)

    fin0 = (pos0 >= seg_end) | (jnp.int32(0) >= max_events)
    init = (pos0, lq0, ls0, ll0, fin0, jnp.zeros(lb, jnp.int32),
            jnp.zeros(ecap, jnp.int64), jnp.zeros(ecap, jnp.int64),
            jnp.zeros((), jnp.int32), jnp.bool_(False),
            jnp.zeros((), jnp.int32))
    final = jax.lax.while_loop(cond, body, init)
    (pos, lq, ls, ll, fin, _evn,
     ev_lane_len, ev_qs, ev_cnt, ovf, it) = final
    ev_lane = (ev_lane_len >> 32).astype(jnp.int32)
    ev_len = (ev_lane_len & 0x7FFFFFFF).astype(jnp.int32)
    ev_q = (ev_qs >> 32).astype(jnp.int32)
    ev_s = (ev_qs & 0x7FFFFFFF).astype(jnp.int32)
    return (ev_lane, ev_q, ev_s, ev_len, ev_cnt, ovf, it * unroll,
            pos, lq, ls, ll, fin)


def _hist16(idx, ok):
    """idx/ok [..., C] -> [..., 16] histogram of masked cell indices."""
    onehot = (idx[..., None] == jnp.arange(16, dtype=jnp.int32)) & ok[..., None]
    return onehot.sum(axis=-2, dtype=jnp.int32)


def _equal_counts_split(length):
    """len/4 per diagonal cell, remainder on TtoT (model_count_equal fast
    path, src/model.c:247-253).  ``length`` [...,] -> [..., 16]."""
    return (length // 4)[..., None] * _DIAG + (length & 3)[..., None] * _TTTT


@functools.partial(
    jax.jit, static_argnames=("exact_counts", "chunk", "chase")
)
def replay_rows_device(
    text,  # int32[Np] padded block text
    isa,  # int32[Np]
    rm,  # rmq.RangeMin over the adjacent-LCP array
    mlun_b,  # int32[Sg, QB] packed blob-order stats per grouped subject
    ps_b,  # int32[Sg, QB]
    jump_b,  # int32[Sg, QB]
    subj_start,  # int32[Sg] text base of each RS_i
    rs_len,  # int32[Sg]
    threshold,  # int32[Sg]
    q_base,  # int32[G] blob offset of each query lane
    q_start,  # int32[G] text offset of each query lane
    q_len2d,  # int32[Sg, G] (0 disables a lane, e.g. dummy subjects)
    exact_counts: bool,
    chunk: int = COUNT_CHUNK,
    chase: int = JUMP_CHASE,
):
    """Grouped replay; returns (int32[Sg, G, 16] substitution counts,
    scalar iteration count — the loop's sequential depth, for profiling).

    Uniform work per lane-iteration: either one probe/jump step or one
    ``chunk``-site slice of pending substitution/equal counting.  Counting
    intervals produced by a probe are queued (gap; plus two equal slots in
    exact mode) and consumed by subsequent iterations — including one slice
    in the probe's own iteration, so the common short gap costs no extra
    loop trip."""
    sg, qb = mlun_b.shape
    g = q_base.shape[0]
    n = text.shape[0]
    offs = jnp.arange(chunk, dtype=jnp.int32)

    qbase = jnp.broadcast_to(q_base[None, :], (sg, g))
    qs = jnp.broadcast_to(q_start[None, :], (sg, g))
    qlen = q_len2d
    thr = threshold[:, None]
    ss = subj_start[:, None]
    rl = rs_len[:, None]
    border = rl // 2

    def row_take(table, idx):
        """table [Sg, QB] gathered at per-lane indices idx [Sg, G]."""
        return jnp.take_along_axis(table, idx, axis=1)

    def lce(a_text, b_text):
        t1 = isa[a_text]
        t2 = isa[b_text]
        lo = jnp.minimum(t1, t2) + 1
        hi = jnp.maximum(t1, t2)
        return rmq.range_min(rm, lo, hi)

    def gap_hist(s_base, q_base_, clen):
        """Substitution histogram over one chunk (model_count semantics,
        src/model.c:309-337): classify text[s_base+i] vs text[q_base_+i],
        i < clen, skipping separator symbols."""
        valid = offs < clen[..., None]
        s = text[jnp.minimum(s_base[..., None] + offs, n - 1)]
        q = text[jnp.minimum(q_base_[..., None] + offs, n - 1)]
        ok = valid & (s >= A_BYTE) & (q >= A_BYTE) & (s < 256) & (q < 256)
        idx = (_nucl2bit(s) << 2) | _nucl2bit(q)
        return _hist16(idx, ok)

    def eq_hist(base, clen):
        """Exact equal-anchor classification chunk (model_count_equal exact
        path, src/model.c:259-278)."""
        valid = offs < clen[..., None]
        s = text[jnp.minimum(base[..., None] + offs, n - 1)]
        ok = valid & (s >= A_BYTE) & (s < 256)
        cell = _EQ_CELL[(s >> 1) & 3]
        return _hist16(cell, ok)

    # state: chain (pos_q, last_q, last_s, last_len, last_right, fin),
    # gap-count cursor (gp_s, gp_q, gp_rem),
    # exact mode adds two equal-count slots (eq0_p, eq0_rem, eq1_p,
    # eq1_rem) — a probe can enqueue the previous anchor (count_last)
    # and, when it also finishes the chain, the trailing anchor.
    def cond(state):
        fin, gp_rem = state[5], state[8]
        pending = gp_rem > 0
        if exact_counts:
            pending = pending | (state[10] > 0) | (state[12] > 0)
        return jnp.any((~fin) | pending)

    def probe_phase(state):
        (pos_q, last_q, last_s, last_len, last_right, fin,
         gp_s, gp_q, gp_rem) = state[:9]
        if exact_counts:
            eq0_p, eq0_rem, eq1_p, eq1_rem, counts = state[9:]
            busy_eq = eq0_rem > 0
        else:
            counts = state[9]
            busy_eq = jnp.bool_(False)

        busy_gp = gp_rem > 0
        probe = (~fin) & (~busy_eq) & (~busy_gp)

        # while the gap exceeds the threshold no lucky anchor can fire
        # (the gap grows monotonically along the probe chain), so the
        # chain to the next anchor candidate is precomputed: jump there,
        # then chase the partially-resolved table a few more hops.  The
        # whole jump+chase runs under a scalar cond — mid-divergence
        # iterations (every probe an anchor, gap <= thr) skip its ~2*chase
        # gathers entirely.
        gap0 = pos_q - last_q - last_len
        took = probe & (gap0 > thr)

        def jump_and_chase(pos_q):
            safe_q = jnp.where(probe, pos_q, 0)  # probe => pos_q < qlen
            pos_qj = jnp.where(
                took, row_take(jump_b, qbase + safe_q) - qbase, pos_q
            )
            for _ in range(chase):
                can = took & (pos_qj < qlen)
                safe_j = jnp.where(can, pos_qj, 0)
                nxt = row_take(jump_b, qbase + safe_j) - qbase
                pos_qj = jnp.where(can & (nxt != pos_qj), nxt, pos_qj)
            return pos_qj

        pos_qj = jax.lax.cond(
            jnp.any(took), jump_and_chase, lambda p: p, pos_q
        )
        in_range = probe & (pos_qj < qlen)
        probe_b = qbase + jnp.where(in_range, pos_qj, 0)
        probe_t = qs + jnp.where(in_range, pos_qj, 0)

        # lucky anchor (src/process.c:82-100); the RMQ LCE runs only when
        # some lane is within threshold of its last anchor
        advance = pos_qj - last_q
        gap = advance - last_len
        try_s = last_s + advance
        lucky_pre = (
            in_range & (try_s < rl) & (gap >= 0) & (gap <= thr)
        )
        lucky_len = jax.lax.cond(
            jnp.any(lucky_pre),
            lambda: jnp.where(
                lucky_pre,
                lce(probe_t, ss + jnp.where(lucky_pre, try_s, 0)),
                0,
            ),
            lambda: jnp.zeros((sg, g), jnp.int32),
        )
        lucky_found = lucky_pre & (lucky_len >= thr)

        # full-search anchor via precomputed stats (src/process.c:113-123)
        v = row_take(mlun_b, probe_b)
        aml = v & (UNIQ_BIT - 1)
        aun = (v & UNIQ_BIT) != 0
        found = in_range & (lucky_found | (aun & (aml >= thr)))
        this_len = jnp.where(lucky_found, lucky_len, aml)
        this_s = jnp.where(lucky_found, try_s, row_take(ps_b, probe_b))

        # diagonal pairing (src/process.c:160-189)
        end_s = last_s + last_len
        end_q = last_q + last_len
        paired = (
            found
            & (this_s > end_s)
            & (pos_qj - end_q == this_s - end_s)
            & ((this_s < border) == (last_s < border))
        )
        count_last = paired | (
            found & ~paired & (last_right | (last_len >= 2 * thr))
        )
        if exact_counts:
            eq0_p = jnp.where(count_last, qs + last_q, eq0_p)
            eq0_rem = jnp.where(count_last, last_len, eq0_rem)
        else:
            counts = counts + _equal_counts_split(last_len) * jnp.where(
                count_last, 1, 0
            )[..., None]
        gp_s = jnp.where(paired, ss + end_s, gp_s)
        gp_q = jnp.where(paired, qs + end_q, gp_q)
        gp_rem = jnp.where(paired, pos_qj - end_q, gp_rem)

        last_q = jnp.where(found, pos_qj, last_q)
        last_s = jnp.where(found, this_s, last_s)
        last_len = jnp.where(found, this_len, last_len)
        last_right = jnp.where(found, paired, last_right)
        pos_q = jnp.where(probe, pos_qj + this_len + 1, pos_q)

        # chain finished: identical-sequence and trailing-anchor cases
        # (src/process.c:199-211), enqueued exactly once
        done_now = probe & (pos_q >= qlen)
        identical = last_len >= qlen
        trail = (~identical) & (last_right | (last_len >= 2 * thr))
        if exact_counts:
            fin_p = jnp.where(identical, qs, qs + last_q)
            fin_rem = jnp.where(
                identical, qlen, jnp.where(trail, last_len, 0)
            )
            eq1_p = jnp.where(done_now, fin_p, eq1_p)
            eq1_rem = jnp.where(done_now, fin_rem, eq1_rem)
        else:
            counts = counts + _equal_counts_split(qlen) * jnp.where(
                done_now & identical, 1, 0
            )[..., None]
            counts = counts + _equal_counts_split(last_len) * jnp.where(
                done_now & trail, 1, 0
            )[..., None]
        fin = fin | done_now

        out = (pos_q, last_q, last_s, last_len, last_right, fin,
               gp_s, gp_q, gp_rem)
        if exact_counts:
            return out + (eq0_p, eq0_rem, eq1_p, eq1_rem, counts)
        return out + (counts,)

    def chunk_phase(state):
        # consume one chunk from each pending interval — including one a
        # probe just enqueued, so the common short gap is counted in the
        # probe's own iteration (no extra loop trip)
        (pos_q, last_q, last_s, last_len, last_right, fin,
         gp_s, gp_q, gp_rem) = state[:9]
        if exact_counts:
            eq0_p, eq0_rem, eq1_p, eq1_rem, counts = state[9:]
            ce = jnp.minimum(eq0_rem, chunk)
            counts = counts + eq_hist(eq0_p, ce)
            eq0_p = eq0_p + ce
            eq0_rem = eq0_rem - ce
            # an emptied slot is refilled from eq1 by the next iteration's
            # body-start promote
        else:
            counts = state[9]
        cg = jnp.minimum(gp_rem, chunk)
        counts = counts + gap_hist(gp_s, gp_q, cg)
        gp_s = gp_s + cg
        gp_q = gp_q + cg
        gp_rem = gp_rem - cg

        out = (pos_q, last_q, last_s, last_len, last_right, fin,
               gp_s, gp_q, gp_rem)
        if exact_counts:
            return out + (eq0_p, eq0_rem, eq1_p, eq1_rem, counts)
        return out + (counts,)

    def body(state):
        it = state[-1]
        state = state[:-1]
        if exact_counts:
            # promote before deciding who probes (a lane with only a queued
            # trailing interval must count, not probe)
            (pos_q, last_q, last_s, last_len, last_right, fin,
             gp_s, gp_q, gp_rem, eq0_p, eq0_rem, eq1_p, eq1_rem,
             counts) = state
            promote = (eq0_rem == 0) & (eq1_rem > 0)
            eq0_p = jnp.where(promote, eq1_p, eq0_p)
            eq0_rem = jnp.where(promote, eq1_rem, eq0_rem)
            eq1_rem = jnp.where(promote, 0, eq1_rem)
            state = (pos_q, last_q, last_s, last_len, last_right, fin,
                     gp_s, gp_q, gp_rem, eq0_p, eq0_rem, eq1_p, eq1_rem,
                     counts)

        any_probe = jnp.any(
            (~state[5])
            & ~(state[8] > 0)
            & ~((state[10] > 0) if exact_counts else jnp.bool_(False))
        )
        state = jax.lax.cond(any_probe, probe_phase, lambda s: s, state)

        pending = state[8] > 0
        if exact_counts:
            pending = pending | (state[10] > 0)
        state = jax.lax.cond(
            jnp.any(pending), chunk_phase, lambda s: s, state
        )
        return state + (it + 1,)

    z = jnp.zeros((sg, g), jnp.int32)
    f = jnp.zeros((sg, g), jnp.bool_)
    init = (z, z, z, z, f, qlen <= 0, z, z, z)
    if exact_counts:
        init = init + (z, z, z, z, jnp.zeros((sg, g, 16), jnp.int32))
    else:
        init = init + (jnp.zeros((sg, g, 16), jnp.int32),)
    init = init + (jnp.zeros((), jnp.int32),)  # iteration counter
    final = jax.lax.while_loop(cond, body, init)
    return final[-2], final[-1]

"""Prefix-doubling suffix array on device (jax.lax.sort).

The device replacement for libdivsufsort (reference ``esa_init_SA``,
src/esa.c:294-304): O(log n) rounds, each one big device sort of
(rank, rank_at_offset_k, index) keys — a regular, memory-bandwidth-bound
bulk primitive that XLA lowers to a library sort.

Two refinements over plain doubling:

* **Early exit** — rounds stop once all ranks are distinct (real genomes
  resolve long before the worst case; near-identical strains need rounds up
  to their longest shared run).
* **Bucketed tail rounds** (Larsson–Sadakane style) — once the tied
  fraction drops below ``ANDIX_BUCKET_FRAC`` (default 1/4), only the
  still-tied SA slots are gathered into a compact buffer, sorted, and
  scattered back.  Ranks use *bucket-head* semantics (rank = SA position of
  the first element of the group), so splitting a group assigns new ranks
  without renumbering anything outside it.  On families of near-identical
  genomes the tied set shrinks geometrically with width, so the tail
  rounds cost O(tied) instead of O(n) — the difference between ~10 and
  ~3.5 full-size sorts per block.

Symbols are int32 (bytes + unique per-segment separators >= 256, see
``andix.esa.joint``), so no 64-bit keys are needed: two int32 sort keys
replace one packed int64 key.

Rank levels (one array per width) keep the property "equal rank at width w
⟺ equal w-prefix" under bucket-head semantics, which is all the level-walk
LCP (``device_pipeline.lcp_from_levels``) needs.
"""

from __future__ import annotations

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np


BASE_WIDTH = 4  # initial prefix width of the packed-init path

# Contract for packed=True (the block-text device paths): every non-padding
# symbol lies in [1, PACK_CLAMP - 2] (bytes 33..255 plus separators
# 256+seg, seg < ~760), and padding symbols are >= 2^20, strictly
# increasing, and form the text tail.  Arbitrary alphabets (tests, oracle
# comparisons) must use packed=False.
PACK_CLAMP = 1023

INT_MAX = jnp.int32(2**31 - 1)

# switch to bucketed rounds when tied fraction falls below this
_BUCKET_FRAC = float(os.environ.get("ANDIX_BUCKET_FRAC", "0.25"))
_MIN_BUCKET_T = 1 << 12  # smallest compact-buffer bucket


def _heads_and_tied(keys_changed: jax.Array, length: int):
    """Bucket-head ranks (in sorted order) + tied count from a sorted-order
    change mask.  head[t] = largest group start <= t."""
    iota = jnp.arange(length, dtype=jnp.int32)
    head_sorted = jax.lax.cummax(jnp.where(keys_changed, iota, 0))
    same_prev = ~keys_changed
    same_next = jnp.concatenate([same_prev[1:], jnp.zeros(1, bool)])
    tied = jnp.sum((same_prev | same_next).astype(jnp.int32))
    return head_sorted, tied


def wide_base_width(nseg: int, alphabet_ok: bool) -> int:
    """Initial-rank width for the dense-code packed key (``_initial_ranks``
    base > 4): the block alphabet {!,#,;,A,C,G,T} maps to codes 1..7,
    separators 256+g to 8+g, padding to the reserved top code, so a symbol
    needs ceil(log2(nseg + 10)) bits and floor(62/bits) of them fill one
    positive int64 key.  Capped at 12 — the level-walk remainder is closed
    by two 6-symbol packed-word probes (``_lcp_from_level_buffer``).
    Returns BASE_WIDTH when the contract does not hold (non-block bytes
    present) — callers fall back to the clamped width-4 key."""
    if not alphabet_ok:
        return BASE_WIDTH
    bits = max(4, (nseg + 9).bit_length())
    return max(BASE_WIDTH, min(62 // bits, 12))


@functools.partial(jax.jit, static_argnames=("length", "packed", "base"))
def _initial_ranks(sym: jax.Array, length: int, packed: bool = False,
                   base: int = BASE_WIDTH):
    """Initial prefix ranks: width 1 (exact, any alphabet), width
    BASE_WIDTH via ONE single-key sort (packed=True, block-text contract),
    or width ``base`` in 5..12 via the dense-code key below (packed=True
    plus the {!,#,;,A,C,G,T}+separators alphabet, ``wide_base_width``).

    Packed (base == BASE_WIDTH): key1 is the full symbol (keeps separators
    and the strictly increasing padding exactly ordered); key2 packs the
    next three symbols clamped to 10 bits.  Clamping is monotone, so it
    can only merge orders into ties — never invert them — and under the
    contract above the only clamped values are tail padding, whose window
    patterns are unique per position, so no information the later doubling
    rounds can't see is lost.  Out-of-range positions pack as 0 < every
    real symbol, matching shorter-suffix-sorts-first (only padding
    suffixes reach out of range).

    Dense-code (base > BASE_WIDTH): real symbols map order-preservingly
    and injectively to small codes ('!'=1 '#'=2 ';'=3 A=4 C=5 G=6 T=7,
    separator 256+g = 8+g), padding symbols to the reserved maximal code;
    ``base`` codes pack big-endian into one int64, and padding POSITIONS
    take a disjoint upper key band ordered by position (their true order).
    No false ties exist at all: two distinct real positions whose windows
    both reach padding necessarily contain the text's final unique
    separator at different offsets, so their keys differ — hence equal
    rank at width ``base`` ⟺ equal base-symbol prefix, exactly what the
    level-walk LCPs require.  Skipping straight to width ``base`` saves
    the k=4 and k=8 full-size doubling rounds and two rank levels of HBM.

    Returns (rank, tied): bucket-head ranks in text order, tied = number of
    positions whose group has >= 2 members (0 ⟺ fully resolved)."""
    idx = jnp.arange(length, dtype=jnp.int32)
    s = sym.astype(jnp.int32)

    if not packed:
        k1s, order = jax.lax.sort((s, idx), num_keys=1)
        changed = jnp.concatenate(
            [jnp.ones(1, bool), k1s[1:] != k1s[:-1]]
        )
    elif base > BASE_WIDTH:
        bits = 62 // base
        maxcode = jnp.int64((1 << bits) - 1)
        c = jnp.where(s == 65, 4, 0)
        for byte, code in ((67, 5), (71, 6), (84, 7), (33, 1), (35, 2),
                           (59, 3)):
            c = jnp.where(s == byte, code, c)
        c = c.astype(jnp.int64)
        c = jnp.where(s >= 256, jnp.minimum(jnp.int64(8) + (s - 256),
                                            maxcode), c)

        def shift_read(x, j):
            if j == 0:
                return x
            return jnp.concatenate(
                [x[min(j, length):], jnp.zeros(min(j, length), x.dtype)]
            )

        key = c
        for j in range(1, base):
            key = (key << bits) | shift_read(c, j)
        is_pad = s >= (1 << 20)
        key = jnp.where(
            is_pad, jnp.int64(1 << 62) + idx.astype(jnp.int64), key
        )
        kp, order = jax.lax.sort((key, idx), num_keys=1)
        changed = jnp.concatenate([jnp.ones(1, bool), kp[1:] != kp[:-1]])
    else:
        def clamp_at(j):
            sh = jnp.concatenate(
                [s[j:], jnp.zeros(min(j, length), jnp.int32)]
            )
            return jnp.minimum(sh, PACK_CLAMP)

        key2 = (clamp_at(1) << 20) | (clamp_at(2) << 10) | clamp_at(3)
        # pack (symbol, 30-bit window) into one int64 key: symbols are
        # bytes/separators/increasing pads, all < 2^21 + length
        packed_key = (s.astype(jnp.int64) << 30) | key2.astype(jnp.int64)
        kp, order = jax.lax.sort((packed_key, idx), num_keys=1)
        changed = jnp.concatenate([jnp.ones(1, bool), kp[1:] != kp[:-1]])
    head_sorted, tied = _heads_and_tied(changed, length)
    rank = jnp.zeros(length, jnp.int32).at[order].set(head_sorted)
    return rank, tied, order


@functools.partial(jax.jit, static_argnames=("length",))
def _doubling_round(rank: jax.Array, k: jax.Array, length: int):
    """Full-size doubling round: sort every position by
    (rank, rank_at_offset_k).  Returns (new_rank, tied, order).

    The shifted read rank[i+k] is a contiguous dynamic_slice of a padded
    copy, not a gather — XLA lowers x[iota+k] to a full gather, several
    times the cost of a copy at genome scale.

    Both keys are bucket-head ranks < length, so for lengths below 2^31
    they pack into ONE int64 sort key (rank*(length+1) + key2+1) — a
    single-key+payload sort is cheaper than two-key+payload."""
    idx = jnp.arange(length, dtype=jnp.int32)
    padded = jnp.concatenate([rank, jnp.full(length, jnp.int32(-1))])
    key2 = jax.lax.dynamic_slice(padded, (k,), (length,))
    packed = rank.astype(jnp.int64) * jnp.int64(length + 1) + (
        key2.astype(jnp.int64) + 1
    )
    kp, order = jax.lax.sort((packed, idx), num_keys=1)
    changed = jnp.concatenate([jnp.ones(1, bool), kp[1:] != kp[:-1]])
    head_sorted, tied = _heads_and_tied(changed, length)
    new_rank = jnp.zeros(length, jnp.int32).at[order].set(head_sorted)
    return new_rank, tied, order


@functools.partial(jax.jit, static_argnames=("tp",))
def _extract_tied(rank: jax.Array, sa: jax.Array, tp: int):
    """Compact the tied SA slots into a tp-sized buffer (ascending slots;
    padding slot = N which every scatter drops)."""
    n = sa.shape[0]
    head = rank[sa]
    iota = jnp.arange(n, dtype=jnp.int32)
    same_prev = jnp.concatenate(
        [jnp.zeros(1, bool), head[1:] == head[:-1]]
    )
    same_next = jnp.concatenate([same_prev[1:], jnp.zeros(1, bool)])
    tied = same_prev | same_next
    pos = jnp.cumsum(tied.astype(jnp.int32)) - 1
    target = jnp.where(tied, pos, tp)
    slots = jnp.full(tp, n, jnp.int32).at[target].set(iota, mode="drop")
    sa_vals = jnp.full(tp, n, jnp.int32).at[target].set(sa, mode="drop")
    return slots, sa_vals


@functools.partial(jax.jit, static_argnames=("tp",))
def _bucketed_round(
    rank: jax.Array,  # int32[N] bucket-head ranks, text order
    sa: jax.Array,  # int32[N]
    slots: jax.Array,  # int32[tp] ascending tied SA slots (pad = N)
    sa_vals: jax.Array,  # int32[tp] sa[slots] (pad = N)
    k: jax.Array,  # scalar offset
    tp: int,
):
    """One tail round over the tied buffer only: gather keys, sort tp
    entries, scatter the permutation back into sa and the split heads back
    into rank, then compact the still-tied subset for the next round.
    Returns (rank, sa, slots', sa_vals', tied_next)."""
    n = sa.shape[0]
    real = sa_vals < n
    head = jnp.where(real, rank[jnp.minimum(sa_vals, n - 1)], INT_MAX)
    shifted = sa_vals + k
    key2 = jnp.where(
        real & (shifted < n), rank[shifted % n], jnp.int32(-1)
    )
    # single int64 key (see _doubling_round); INT_MAX*(n+1) fits int64
    packed = head.astype(jnp.int64) * jnp.int64(n + 1) + (
        key2.astype(jnp.int64) + 1
    )
    kp_s, sav_s = jax.lax.sort((packed, sa_vals), num_keys=1)
    h_s = (kp_s // jnp.int64(n + 1)).astype(jnp.int32)

    changed = jnp.concatenate([jnp.ones(1, bool), kp_s[1:] != kp_s[:-1]])
    # sorted entries land in the ascending tied slots; a subgroup's head is
    # the slot of its first element
    new_head = jax.lax.cummax(jnp.where(changed, slots, -1))
    sa = sa.at[slots].set(sav_s, mode="drop")
    # pads (sav_s == n) scatter out of range and are dropped — clamping
    # them to n-1 instead could clobber a real update to rank[n-1]
    rank = rank.at[sav_s].set(new_head, mode="drop")

    real_s = h_s != INT_MAX
    same_prev = jnp.concatenate(
        [jnp.zeros(1, bool), new_head[1:] == new_head[:-1]]
    ) & real_s
    same_next = jnp.concatenate([same_prev[1:], jnp.zeros(1, bool)])
    tied = (same_prev | same_next) & real_s
    tied_next = jnp.sum(tied.astype(jnp.int32))

    pos = jnp.cumsum(tied.astype(jnp.int32)) - 1
    target = jnp.where(tied, pos, tp)
    new_slots = jnp.full(tp, n, jnp.int32).at[target].set(slots, mode="drop")
    new_sa_vals = jnp.full(tp, n, jnp.int32).at[target].set(
        sav_s, mode="drop"
    )
    return rank, sa, new_slots, new_sa_vals, tied_next


def _bucket_t(t: int) -> int:
    b = _MIN_BUCKET_T
    while b < t:
        b *= 2
    return b


def _doubling_loop(
    sym: jax.Array, packed: bool, collect: bool,
    max_levels: int | None = None,
):
    """Shared driver: full-size rounds with early exit, switching to
    bucketed tail rounds once the tied fraction drops below
    ANDIX_BUCKET_FRAC.  Returns (sa, levels) — levels only filled when
    ``collect`` (all-distinct final levels are never appended, see
    ``suffix_array_device_collect``).  When ``max_levels`` is given and the
    text would need more rank levels than that (pathologically repetitive
    inputs, e.g. identical genomes, where nothing resolves early), level
    collection is abandoned — levels comes back None and the caller falls
    back to a non-level LCP (memory stays bounded either way)."""
    length = int(sym.shape[0])
    if length == 0:
        z = jnp.zeros(0, jnp.int32)
        return z, [z]
    rank, tied, order = _initial_ranks(sym, length, packed)
    levels = [rank]
    t = int(tied)
    if t == 0:
        return _sa_from_rank(rank, length), levels
    k = BASE_WIDTH if packed else 1

    def push(r):
        nonlocal levels
        if collect and levels is not None:
            if max_levels is not None and len(levels) >= max_levels:
                levels = None  # overflow: abandon collection, keep sorting
            else:
                levels.append(r)

    # full-size rounds
    sa = order
    while t > length * _BUCKET_FRAC:
        rank, tied, sa = _doubling_round(
            rank, jnp.int32(min(k, length)), length
        )
        t = int(tied)
        if t == 0:
            return sa, levels
        push(rank)
        if k >= length:
            return sa, levels
        k *= 2

    # bucketed tail rounds over the still-tied slots only
    tp = _bucket_t(t)
    slots, sa_vals = _extract_tied(rank, sa, tp)
    while True:
        rank, sa, slots, sa_vals, tied = _bucketed_round(
            rank, sa, slots, sa_vals, jnp.int32(min(k, length)), tp
        )
        t = int(tied)
        if t == 0:
            return sa, levels
        push(rank)
        if k >= length:
            return sa, levels
        k *= 2
        new_tp = _bucket_t(t)
        if new_tp < tp:  # shrink the buffer (slices are cheap on device)
            slots = slots[:new_tp]
            sa_vals = sa_vals[:new_tp]
            tp = new_tp


@functools.partial(jax.jit, static_argnames=("length",))
def _sa_from_rank(rank: jax.Array, length: int):
    return (
        jnp.zeros(length, jnp.int32)
        .at[rank]
        .set(jnp.arange(length, dtype=jnp.int32))
    )


def suffix_array_device(sym: jax.Array, packed: bool = False) -> jax.Array:
    """Suffix array of an int32 symbol array, computed on device.

    Python-level round loop with early exit (one scalar readback per round);
    each round is a fully jitted device sort.  ``packed=True`` (block-text
    contract, see ``_initial_ranks``) starts from width-BASE_WIDTH ranks.
    """
    sa, _ = _doubling_loop(sym, packed, collect=False)
    return sa


def suffix_array_device_collect(
    sym: jax.Array, packed: bool = False, max_levels: int | None = None
):
    """Like ``suffix_array_device`` but also returns the rank array of every
    width as a list (width base, 2*base, 4*base, ... with base = BASE_WIDTH
    when packed else 1) for the level-walk LCP
    (``device_pipeline.lcp_from_levels``; sub-base remainders are finished
    by direct symbol compares there).  Early exit still applies — the level
    list stops once ranks are distinct, which bounds both rounds and level
    memory by the data's actual repeat structure.

    A level whose ranks are all distinct is never appended (unless it is
    the only one): distinct width-W ranks mean every adjacent LCP is < W,
    and the remaining widths sum to W - 1 plus the sub-base compares — the
    walk stays exact with one less full-size gather pass.

    With ``max_levels``, returns (sa, None) when the input would need more
    levels than the budget (see ``_doubling_loop``)."""
    return _doubling_loop(sym, packed, collect=True, max_levels=max_levels)


def suffix_array(sym: np.ndarray) -> np.ndarray:
    """NumPy in / NumPy out wrapper (device-resident loop)."""
    sym_d = jnp.asarray(np.ascontiguousarray(sym, dtype=np.int32))
    sa, _, _, _ = sa_lcp_device(sym_d, packed=False, want_lcp=False)
    return np.asarray(jax.device_get(sa))


# ---------------------------------------------------------------------------
# Device-resident loop: SA + LCP in ONE dispatch (zero host round trips).
#
# The Python-level loop above costs one scalar readback per doubling round
# (the int(tied) early-exit probe), 15-25 host round trips per block.  Here
# the whole driver runs inside jit:
#
# * full-size rounds in a lax.while_loop with the early exit as the loop
#   condition (the `tied` scalar never leaves the device),
# * bucketed tail rounds as a static ladder of compact-buffer *tiers*
#   (pow2-sized, shrinking 4x per tier); each tier is its own while_loop
#   and re-extracts the still-tied slots into the next smaller buffer,
# * rank levels collected into a fixed [L, N] buffer for the level-walk
#   LCP, computed in the same program; an `overflow` flag reports when the
#   input needed more levels than the buffer holds (pathologically
#   repetitive input) so the caller can fall back to the host LCP.
#
# This function also runs unchanged under shard_map (the multi-chip path):
# per-device trip counts are data-dependent, which is fine — there are no
# collectives inside the loops.
# ---------------------------------------------------------------------------


def levels_needed(length: int, packed: bool = False,
                  base: int | None = None) -> int:
    """Level-buffer size that can never overflow: the initial width-base
    level plus one per doubling round until the width covers the text."""
    if base is None:
        base = BASE_WIDTH if packed else 1
    lv = 1
    w = base
    while w < length:
        w *= 2
        lv += 1
    return lv


def _tail_tiers(length: int, thr0: int) -> tuple[int, ...]:
    """Static compact-buffer sizes for the tail rounds: the first tier
    holds any tied count the full rounds can exit with (<= thr0), then
    16x smaller per tier down to the minimum bucket.  A coarse ladder —
    sorting a somewhat-too-big buffer costs microseconds at these sizes,
    while every extra tier is another while_loop+sort in the compiled
    module, and compile time grows with each."""
    if thr0 <= 0:
        return ()
    t0 = _bucket_t(min(length, thr0))
    tiers = [t0]
    while tiers[-1] // 16 >= _MIN_BUCKET_T:
        tiers.append(tiers[-1] // 16)
    return tuple(tiers)


def _lcp_from_level_buffer(sa, levels, lev_count, sym, base: int,
                           packed: bool = False):
    """Adjacent-LCP from the fixed level buffer: top-down compare-and-
    advance per level (width base << r), skipping unwritten slots
    (r >= lev_count) with lax.cond, then the sub-width remainder.

    Every level costs two full-size random gathers, so in packed mode the
    bottom
    of the walk — the width-4 level plus three single-symbol compare
    passes, 4 gather pairs — is replaced by two probes of a 6-symbol
    packed-word array (2 gather pairs): w6[i] packs symbols i..i+5 as
    10-bit fields (big-endian), and the first differing field index (via
    count-leading-zeros of the XOR) advances h by the exact remainder.

    The 10-bit clamp is equality-safe under the block-text contract: real
    symbols are <= 1021 and injective, padding symbols clamp to 1023
    (distinct from every real symbol), and the only false equalities are
    pad-vs-pad positions — reachable only for pairs of padding suffixes,
    whose SA slots sit above every real suffix and whose LCP values are
    never consumed (matchstats flags and LCE ranges stay within the real
    slots)."""
    n = sa.shape[0]
    nlev = levels.shape[0]
    a = jnp.concatenate([sa[:1], sa[:-1]])
    b = sa
    h = jnp.zeros(n, jnp.int32)
    # packed: the sub-level remainder is closed by two probes of the
    # 6-symbol packed word below, which cover 12 symbols — so level 0
    # (width base) can be skipped only while 2*base <= 12
    bottom = 1 if (packed and base <= 6) else 0
    for r in range(nlev - 1, bottom - 1, -1):
        lev = levels[r]
        w = jnp.int32(base << r)

        def walk(h, lev=lev, w=w):
            ai = a + h
            bi = b + h
            ok = (ai < n) & (bi < n)
            ra = lev[jnp.minimum(ai, n - 1)]
            rb = lev[jnp.minimum(bi, n - 1)]
            return jnp.where(ok & (ra == rb), h + w, h)

        h = jax.lax.cond(r < lev_count, walk, lambda h: h, h)
    if packed:
        c = jnp.minimum(sym, PACK_CLAMP).astype(jnp.int64)
        w6 = jnp.zeros(n, jnp.int64)
        for j in range(6):
            cj = (
                jnp.concatenate(
                    [c[min(j, n):], jnp.zeros(min(j, n), jnp.int64)]
                )
                if j
                else c
            )
            w6 = w6 | (cj << (10 * (5 - j)))
        for _ in range(2):  # remainder < 8 <= 6 + 6
            ai = a + h
            bi = b + h
            ok = (ai < n) & (bi < n)
            wa = w6[jnp.minimum(ai, n - 1)]
            wb = w6[jnp.minimum(bi, n - 1)]
            lead = (jax.lax.clz(wa ^ wb) - 4) // 10  # 6 when equal (clz=64)
            adv = jnp.minimum(lead, 6).astype(jnp.int32)
            h = jnp.where(ok, h + adv, h)
    else:
        for _ in range(base - 1):
            ai = a + h
            bi = b + h
            ok = (ai < n) & (bi < n)
            ea = sym[jnp.minimum(ai, n - 1)]
            eb = sym[jnp.minimum(bi, n - 1)]
            h = jnp.where(ok & (ea == eb), h + 1, h)
    return h.at[0].set(0)


def _sa_loop_traced(
    sym: jax.Array,
    packed: bool,
    L: int,
    thr0: int,
    tiers: tuple[int, ...],
    level_min_k: int = 0,
    base: int | None = None,
):
    """Traced device-resident doubling driver: full rounds + tiered tail
    rounds, levels collected into a fixed buffer.  Returns
    (sa, levels, lev_count, overflow).

    ``level_min_k`` > 0 records only rounds whose offset k is at least that
    value (post-round rank width >= 2*level_min_k) and skips the initial
    rank level — the sampled-PLCP LCP (``plcp.plcp_lcp``) only needs the
    high-width levels for its walk escape, so the buffer shrinks from
    ~log2(N) rows to a handful."""
    length = int(sym.shape[0])
    if base is None:
        base = BASE_WIDTH if packed else 1
    rank, tied, order = _initial_ranks(
        sym, length, packed, base if packed else BASE_WIDTH
    )

    levels = jnp.zeros((L, length), jnp.int32)
    if level_min_k == 0:
        levels = jax.lax.dynamic_update_index_in_dim(levels, rank, 0, 0)
        lev_idx = jnp.int32(1)
    else:
        lev_idx = jnp.int32(0)
    ovf = jnp.bool_(False)
    k = jnp.int32(base)
    sa = order

    def push(levels, lev_idx, ovf, rank, tied, k_used):
        # mirror the host loop: a level is recorded only when ties remain
        # after the round (all-distinct final levels are never appended);
        # once past the buffer, keep sorting but flag the overflow
        slot = jnp.minimum(lev_idx, L - 1)
        levels = jax.lax.dynamic_update_index_in_dim(
            levels, rank, slot, 0
        )
        has = (tied > 0) & (k_used >= level_min_k)
        ovf = ovf | (has & (lev_idx >= L))
        lev_idx = lev_idx + has.astype(jnp.int32)
        return levels, lev_idx, ovf

    # --- full-size rounds with on-device early exit ---
    def full_cond(st):
        _, _, k, tied, _, _, _ = st
        return (tied > thr0) & (k < length)

    def full_body(st):
        rank, sa, k, tied, levels, lev_idx, ovf = st
        rank, tied, sa = _doubling_round(
            rank, jnp.minimum(k, length), length
        )
        levels, lev_idx, ovf = push(levels, lev_idx, ovf, rank, tied, k)
        k = jnp.minimum(k * 2, jnp.int32(1 << 30))
        return rank, sa, k, tied, levels, lev_idx, ovf

    rank, sa, k, tied, levels, lev_idx, ovf = jax.lax.while_loop(
        full_cond, full_body, (rank, sa, k, tied, levels, lev_idx, ovf)
    )

    # --- bucketed tail rounds over shrinking static tiers ---
    for ti, tp in enumerate(tiers):
        nxt = tiers[ti + 1] if ti + 1 < len(tiers) else 0
        slots, sa_vals = _extract_tied(rank, sa, tp)

        def tier_cond(st, nxt=nxt):
            _, _, _, _, k, tied, _, _, _ = st
            return (tied > nxt) & (k < length)

        def tier_body(st, tp=tp):
            rank, sa, slots, sa_vals, k, tied, levels, lev_idx, ovf = st
            rank, sa, slots, sa_vals, tied = _bucketed_round(
                rank, sa, slots, sa_vals, jnp.minimum(k, length), tp
            )
            levels, lev_idx, ovf = push(levels, lev_idx, ovf, rank, tied, k)
            k = jnp.minimum(k * 2, jnp.int32(1 << 30))
            return rank, sa, slots, sa_vals, k, tied, levels, lev_idx, ovf

        rank, sa, slots, sa_vals, k, tied, levels, lev_idx, ovf = (
            jax.lax.while_loop(
                tier_cond,
                tier_body,
                (rank, sa, slots, sa_vals, k, tied, levels, lev_idx, ovf),
            )
        )

    return sa, levels, lev_idx, ovf


@functools.partial(
    jax.jit,
    static_argnames=("packed", "L", "thr0", "tiers", "level_min_k", "base"),
)
def _sa_core(sym, *, packed, L, thr0, tiers, level_min_k=0, base=None):
    """SA loop as its own program (compile-size split: one mega-module
    with loop + walk takes far longer to compile than the two halves;
    both dispatches are async, so the split costs no extra syncs)."""
    return _sa_loop_traced(sym, packed, L, thr0, tiers, level_min_k, base)


@functools.partial(jax.jit, static_argnames=("packed", "base"))
def _lcp_core(sa, levels, lev_count, sym, *, packed, base=None):
    if base is None:
        base = BASE_WIDTH if packed else 1
    return _lcp_from_level_buffer(sa, levels, lev_count, sym, base, packed)


def _sa_lcp_core(
    sym: jax.Array,
    *,
    packed: bool,
    L: int,
    thr0: int,
    tiers: tuple[int, ...],
    want_lcp: bool,
    lcp_mode: str = "levels",
    base: int | None = None,
):
    """Traced composition (used inside shard_map, where everything must
    live in one program anyway).  Returns (sa, lcp, overflow); lcp is
    all-zero when want_lcp=False and must be ignored when overflow is
    True.  ``lcp_mode="hybrid"`` uses the sampled-PLCP fill (same as the
    single-chip default; requires the packed block-text alphabet)."""
    if base is None:
        base = BASE_WIDTH if packed else 1
    sa, levels, lev_idx, ovf = _sa_loop_traced(
        sym, packed, L, thr0, tiers, base=base
    )
    if want_lcp and lcp_mode == "hybrid":
        from . import plcp as _plcp

        # traced variant: a nested jit inside shard_map trips XLA's
        # sharding-inference assert on the [L, N] level buffer
        lcp, ovf2 = _plcp.plcp_lcp_hybrid_traced(
            sym, sa, levels, lev_idx, base_width=base
        )
        return sa, lcp, ovf | ovf2
    if want_lcp:
        lcp = _lcp_from_level_buffer(
            sa, levels, lev_idx, sym, base, packed=packed
        )
    else:
        lcp = jnp.zeros(0, jnp.int32)
    return sa, lcp, ovf


def sa_lcp_device(
    sym: jax.Array,
    packed: bool = False,
    max_levels: int | None = None,
    want_lcp: bool = True,
    lcp_mode: str = "levels",
    base_width: int | None = None,
):
    """Suffix array + adjacent LCP in one device dispatch.

    ``lcp_mode="plcp"`` (block texts only — requires the packed-alphabet
    contract, see ``andix.esa.plcp``) computes the LCP via the sampled-PLCP
    word ladder: only high-width rank levels are recorded (a handful of
    rows instead of ~log2 N) and the walk runs over ~5-7N gathered elements
    instead of ~26N.

    Returns (sa, lcp, overflow, may_overflow): ``overflow`` is a device
    bool scalar — when True the input needed more rank levels than the
    buffer holds and ``lcp`` is invalid (caller falls back to the host
    LCP).  ``may_overflow`` is a static bool: False guarantees overflow can
    never fire (the buffer covers the worst case), so callers skip the
    readback entirely."""
    length = int(sym.shape[0])
    if length == 0:
        z = jnp.zeros(0, jnp.int32)
        return z, z, jnp.bool_(False), False
    thr0 = int(length * _BUCKET_FRAC)
    tiers = _tail_tiers(length, thr0)
    base = base_width if (packed and base_width) else (
        BASE_WIDTH if packed else 1
    )

    if want_lcp and lcp_mode == "plcp":
        from . import plcp as _plcp

        needed = _plcp.levels_needed_high(length)
        L = min(needed, 8)
        if max_levels is not None:
            L = min(L, max(max_levels, 1))
        # the plcp escape walk assumes level widths W0 << r, which only
        # holds for power-of-two bases: pin the A/B path to BASE_WIDTH
        sa, levels, lev_idx, ovf = _sa_core(
            sym, packed=packed, L=L, thr0=thr0, tiers=tiers,
            level_min_k=_plcp.W0 // 2,
        )
        lcp, ovf2 = _plcp.plcp_lcp(sym, sa, levels, lev_idx)
        return sa, lcp, ovf | ovf2, L < needed

    if want_lcp and lcp_mode == "hybrid":
        # full level stack (as in levels mode), but only the stride-16
        # PLCP samples walk it; everything else fills from the Kasai
        # bound with packed-word probes (andix.esa.plcp).  The stack is
        # capped at 14 rows (adjacent LCPs < 4 * 2^13 = 32 kb — beyond any
        # non-clonal repeat) so the buffer plus the fill's own N-sized
        # buffers stay within device memory at 100M-symbol blocks; deeper
        # inputs overflow to the host Φ-LCP like every other mode
        from . import plcp as _plcp

        needed = levels_needed(length, packed, base)
        L = max(1, min(needed, max_levels) if max_levels else needed)
        L = min(L, 14)
        sa, levels, lev_idx, ovf = _sa_core(
            sym, packed=packed, L=L, thr0=thr0, tiers=tiers, base=base
        )
        lcp, ovf2 = _plcp.plcp_lcp_hybrid(
            sym, sa, levels, lev_idx, base_width=base
        )
        return sa, lcp, ovf | ovf2, True

    needed = levels_needed(length, packed, base)
    L = min(needed, max_levels) if max_levels is not None else needed
    if not want_lcp:
        L = 1  # levels unused; keep the buffer at one row
    L = max(L, 1)
    sa, levels, lev_idx, ovf = _sa_core(
        sym, packed=packed, L=L, thr0=thr0, tiers=tiers, base=base
    )
    if want_lcp:
        lcp = _lcp_core(sa, levels, lev_idx, sym, packed=packed, base=base)
    else:
        lcp = jnp.zeros(0, jnp.int32)
    return sa, lcp, ovf, L < needed


def suffix_array_fixed_rounds(
    sym: jax.Array, rounds: int, packed: bool = False
) -> jax.Array:
    """Fully traced variant with a static round count (for jit/sharding
    validation paths like ``dryrun_multichip`` where host round-trips are
    not possible).  ``rounds`` must satisfy base * 2**rounds >= len(sym)
    with base = BASE_WIDTH when packed else 1."""
    length = int(sym.shape[0])
    rank, _, _ = _initial_ranks(sym, length, packed)
    order = _sa_from_rank(rank, length)
    k = BASE_WIDTH if packed else 1
    for _ in range(rounds):
        rank, _, order = _doubling_round(rank, jnp.int32(min(k, length)), length)
        k *= 2
    return order

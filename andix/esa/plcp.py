"""Sampled-PLCP adjacent-LCP construction via packed-word compares.

The rank-level walk (``doubling._lcp_from_level_buffer``) costs two
full-size random gathers per retained level — ~26N gathered elements at
genome scale, the dominant share of the SA+LCP dispatch (measured 4.6 s of
7.1 s at 16.8M symbols).  This module replaces it for block texts with a
PLCP scheme whose total gather volume is ~5-7N:

* ``w16``: the text recoded to 4-bit symbol classes and packed 16 per
  int64 word (big-endian), so ONE gather pair compares 16 symbols.  The
  block-text alphabet is {A,C,G,T,!,#,;} plus separators/padding; real
  symbols get distinct nonzero codes, separators and padding get code 0
  ("special").  Two special positions never hold equal symbols (separators
  are unique per segment, padding is strictly increasing), so a compare
  terminates — exactly — at the first differing nibble OR the first
  both-special nibble (detected with SWAR bit tricks, no extra gathers).

* **Sampled PLCP**: PLCP[i] = lcp(suffix i, suffix phi(i)) with
  phi(i) = SA[ISA[i]-1] is computed from scratch only on the stride-16 grid
  by a lock-step word ladder (h += 16 per pass) over geometrically
  compacted buffers.  Entries still alive after 64 passes (lcp >= 1024,
  the heavy tail of near-clonal genomes) escape through a rank-level walk
  over the HIGH-width levels only (widths >= W0 = 4096, the few levels the
  doubling loop still records), then finish with < W0/16 remainder passes.

* **Fill**: every position starts from the Kasai bound
  PLCP[i] >= PLCP[i0] - (i - i0) (valid for any text, including across
  separators), so most positions finish in ONE word probe; the slack tail
  compacts through the same ladder/walk machinery.

* ``lcp[t] = PLCP[SA[t]]`` — one final gather.

Overflow (ladder caps exhausted — requires the level buffer to have been
truncated by the device-memory budget on pathologically repetitive input)
is reported to the caller, which falls back to the host Φ-LCP, same as the
level-walk path.  Reference LCP construction: src/esa.c:373-426.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np


W0 = 4096  # minimum width of recorded rank levels (walk-escape granularity)
LADDER_PRE = 64  # word passes before the walk escape (h reaches 1024)
# post-escape remainder < W0 needs <= W0/16 more passes
PASS_CAP = LADDER_PRE + W0 // 16 + 8

_M7 = jnp.int64(0x7777777777777777)

# block-text alphabet (joint.py + sequence.normalize): real symbols
_CODES = ((65, 1), (67, 2), (71, 3), (84, 4), (33, 5), (35, 6), (59, 7))
ALPHABET_U8 = frozenset((0, 33, 35, 59, 65, 67, 71, 84))


def levels_needed_high(length: int) -> int:
    """Rank levels with width >= W0 the walk escape can consume."""
    lv = 0
    w = W0
    while w < length:
        w *= 2
        lv += 1
    return max(lv, 1)


def _word_m(wa, wb):
    """Symbols of agreement between two 16-symbol packed words: index of the
    first differing nibble or the first both-special (code 0) nibble —
    whichever comes first; 16 when the words agree fully with no mutual
    special."""
    x = wa ^ wb
    d = jax.lax.clz(x) >> 2  # 16 iff x == 0 (clz(0) = 64)
    z = wa | wb
    zn = (~(((z & _M7) + _M7) | z)) & ~_M7  # bit3 of each zero nibble
    zq = jax.lax.clz(zn) >> 2
    return jnp.minimum(d, zq).astype(jnp.int32)


def _build_w16(sym: jax.Array) -> jax.Array:
    """int64[N] packed 4-bit code words, w16[i] = codes of sym[i..i+15]
    big-endian; out-of-range and special positions pack as 0."""
    n = sym.shape[0]
    c = jnp.zeros(n, jnp.int64)
    for byte, code in _CODES:
        c = jnp.where(sym == byte, jnp.int64(code), c)

    def shift_read(x, k):
        return jax.lax.dynamic_slice(
            jnp.concatenate([x, jnp.zeros(k, x.dtype)]), (k,), (n,)
        )

    p = (c << 4) | shift_read(c, 1)
    p = (p << 8) | shift_read(p, 2)
    p = (p << 16) | shift_read(p, 4)
    p = (p << 32) | shift_read(p, 8)
    return p


def _tiers(t0: int, shrink: int = 4, floor: int = 8192):
    out = [t0]
    while out[-1] // shrink >= floor:
        out.append(out[-1] // shrink)
    return out


def _ladder(w16, levels, lev_cnt, n, idx, a, b, alive, out, tiers,
            h0=None, escape_w0=W0):
    """Lock-step word ladder with tier compaction + one walk escape.

    idx/a/b/alive are tier-0-sized; ``out`` (int32[len(out)]) receives
    h + m at each entry's finish slot ``idx``.  Returns (out, unfinished) —
    unfinished > 0 means entries did not resolve (PASS_CAP hit or dropped
    at a compaction; both require the level buffer to have been truncated)."""
    out_len = out.shape[0]
    h = jnp.zeros_like(a) if h0 is None else h0
    p = jnp.zeros((), jnp.int32)
    lost = jnp.zeros((), jnp.int32)

    def walk(h, a, b, alive):
        L_hi = levels.shape[0]
        for r in range(L_hi - 1, -1, -1):
            w = jnp.int32(min(escape_w0 << r, 1 << 30))

            def step(h, r=r, w=w):
                ia = jnp.minimum(a + h, n - 1)
                ib = jnp.minimum(b + h, n - 1)
                ok = (
                    alive
                    & (a + h < n)
                    & (b + h < n)
                    & (levels[r][ia] == levels[r][ib])
                )
                return jnp.where(ok, h + w, h)

            h = jax.lax.cond(r < lev_cnt, step, lambda x: x, h)
        return h

    cnt = jnp.sum(alive.astype(jnp.int32))
    for ti, tp in enumerate(tiers):
        nxt = tiers[ti + 1] if ti + 1 < len(tiers) else 0
        if ti > 0:  # compact into the smaller buffer
            lost = lost + jnp.maximum(cnt - tp, 0)
            pos = jnp.cumsum(alive.astype(jnp.int32)) - alive
            tgt = jnp.where(alive, jnp.minimum(pos, tp), tp)

            def put(x, fill, tgt=tgt, tp=tp):
                return jnp.full(tp, fill, x.dtype).at[tgt].set(
                    x, mode="drop"
                )

            idx = put(idx, out_len)
            a = put(a, 0)
            b = put(b, 0)
            h = put(h, 0)
            alive = put(alive, False)
            cnt = jnp.minimum(cnt, tp)

        def body(st):
            idx, a, b, h, alive, p, cnt, out = st
            h = jax.lax.cond(
                p == LADDER_PRE,
                lambda hh: walk(hh, a, b, alive),
                lambda hh: hh,
                h,
            )
            ia = jnp.minimum(a + h, n - 1)
            ib = jnp.minimum(b + h, n - 1)
            m = _word_m(w16[ia], w16[ib])
            fin = alive & (m < 16)
            out = out.at[jnp.where(fin, idx, out_len)].set(
                h + m, mode="drop"
            )
            alive = alive & ~fin
            h = jnp.where(alive, h + 16, h)
            cnt = jnp.sum(alive.astype(jnp.int32))
            return idx, a, b, h, alive, p + 1, cnt, out

        def cond(st, nxt=nxt):
            _, _, _, _, _, p, cnt, _ = st
            return (cnt > nxt) & (p < PASS_CAP)

        idx, a, b, h, alive, p, cnt, out = jax.lax.while_loop(
            cond, body, (idx, a, b, h, alive, p, cnt, out)
        )

    return out, cnt + lost


@functools.partial(jax.jit, static_argnames=())
def plcp_lcp(sym, sa, levels, lev_cnt):
    """Adjacent LCP of the block text from its SA + high-width rank levels.
    Returns (lcp int32[N], overflow bool)."""
    n = sym.shape[0]
    assert n % 16 == 0, "bucket() sizes are divisible by 16"
    iota = jnp.arange(n, dtype=jnp.int32)
    w16 = _build_w16(sym)

    isa = jnp.zeros(n, jnp.int32).at[sa].set(iota)
    phi = jnp.where(
        isa > 0, sa[jnp.maximum(isa - 1, 0)], jnp.int32(-1)
    )

    # --- sampled PLCP on the stride-16 grid ---
    ns = n // 16
    i_s = jnp.arange(ns, dtype=jnp.int32) * 16
    a_s = phi[::16]
    alive_s = a_s >= 0
    S = jnp.zeros(ns + 1, jnp.int32)
    S, left_s = _ladder(
        w16, levels, lev_cnt, n,
        jnp.arange(ns, dtype=jnp.int32), jnp.maximum(a_s, 0), i_s,
        alive_s, S, _tiers(ns),
    )
    S = S[:ns]
    return _fill_from_samples(
        w16, levels, lev_cnt, n, iota, sa, phi, S, left_s, W0
    )


def _fill_from_samples(w16, levels, lev_cnt, n, iota, sa, phi, S, left_s,
                       escape_w0):
    """Kasai-bound fill of every position given the stride-16 sampled
    PLCP, then lcp[t] = PLCP[SA[t]].

    Pass 1 runs as pure vector ops over all N positions (most finish with
    slack < 16 — the bound is exact inside every PLCP sawtooth run); only
    the survivors (positions just past a run boundary) enter the tiered
    ladder, so no full-size scatter or compaction scan ever runs."""
    lo = jnp.maximum(S[iota >> 4] - (iota & 15), 0)
    alive_f = phi >= 0
    a_f = jnp.minimum(jnp.maximum(phi, 0) + lo, n - 1)
    b_f = jnp.minimum(iota + lo, n - 1)
    m1 = _word_m(w16[a_f], w16[b_f])
    survivor = alive_f & (m1 == 16)

    t1 = max(n // 2, 8192)
    pos = jnp.cumsum(survivor.astype(jnp.int32)) - survivor
    tgt = jnp.where(survivor, jnp.minimum(pos, t1), t1)
    lost = jnp.maximum(jnp.sum(survivor.astype(jnp.int32)) - t1, 0)

    def put(x, fill):
        return jnp.full(t1, fill, x.dtype).at[tgt].set(x, mode="drop")

    plcp0 = jnp.zeros(n + 1, jnp.int32)
    plcp_rel, left_f = _ladder(
        w16, levels, lev_cnt, n,
        put(iota, n), put(a_f, 0), put(b_f, 0),
        put(survivor, False), plcp0, _tiers(t1, shrink=4),
        h0=jnp.full(t1, 16, jnp.int32), escape_w0=escape_w0,
    )
    plcp = jnp.where(alive_f, jnp.where(survivor, plcp_rel[:n], m1) + lo, 0)

    lcp = plcp[sa].at[0].set(0)
    ovf = (left_s + left_f + lost) > 0
    return lcp, ovf


@functools.partial(jax.jit, static_argnames=("base_width",))
def plcp_lcp_hybrid(sym, sa, levels, lev_cnt, base_width: int = 4):
    return plcp_lcp_hybrid_traced(sym, sa, levels, lev_cnt, base_width)


def plcp_lcp_hybrid_traced(sym, sa, levels, lev_cnt, base_width: int = 4):
    """Adjacent LCP from the FULL rank-level stack (levels-mode SA
    collection): the stride-16 PLCP samples come from a classical top-down
    level walk — 2 gathers x levels over N/16 entries, ~16x less gather
    volume than walking every position (the dominant cost of the old
    all-positions walk) — and every position then fills from the Kasai
    bound PLCP[i] >= PLCP[i-1]-1 with ~1-2 packed-word probes.

    The sample walk leaves each entry with remainder < base_width; the
    short word ladder that follows (seeded at the walk's h) finishes it
    exactly.  The fill's rare deep-slack entries escape through the same
    level stack (escape_w0 = base_width)."""
    n = sym.shape[0]
    assert n % 16 == 0, "bucket() sizes are divisible by 16"
    iota = jnp.arange(n, dtype=jnp.int32)
    w16 = _build_w16(sym)

    isa = jnp.zeros(n, jnp.int32).at[sa].set(iota)
    phi = jnp.where(
        isa > 0, sa[jnp.maximum(isa - 1, 0)], jnp.int32(-1)
    )

    ns = n // 16
    i_s = jnp.arange(ns, dtype=jnp.int32) * 16
    a_s = jnp.maximum(phi[::16], 0)
    alive_s = phi[::16] >= 0

    # top-down level walk on the samples (widths base_width << r)
    L = levels.shape[0]
    h = jnp.zeros(ns, jnp.int32)
    for r in range(L - 1, -1, -1):
        w = jnp.int32(min(base_width << r, 1 << 30))

        def step(h, r=r, w=w):
            ia = jnp.minimum(a_s + h, n - 1)
            ib = jnp.minimum(i_s + h, n - 1)
            ok = (
                alive_s
                & (a_s + h < n)
                & (i_s + h < n)
                & (levels[r][ia] == levels[r][ib])
            )
            return jnp.where(ok, h + w, h)

        h = jax.lax.cond(r < lev_cnt, step, lambda x: x, h)

    # remainder (< base_width): one word probe each via the ladder,
    # seeded at the walk's h
    S = jnp.zeros(ns + 1, jnp.int32)
    S, left_s = _ladder(
        w16, levels, lev_cnt, n,
        jnp.arange(ns, dtype=jnp.int32), a_s, i_s, alive_s, S,
        _tiers(ns), h0=h, escape_w0=base_width,
    )
    S = S[:ns]
    return _fill_from_samples(
        w16, levels, lev_cnt, n, iota, sa, phi, S, left_s, base_width
    )

"""Compressed anchor-event fetch (device pack -> 6 B/event -> host decode).

Family-scale runs fetch millions of anchor events from the device, and
16 B/event (4 x int32) is ~3x larger than the stream's information
content: events of one lane are
q-ascending, and consecutive anchors mostly sit on one diagonal, so lane
ids compress to per-lane counts and (q, s) to small deltas.

Device side (one jit): stable-sort the buffer by lane (chain order per
lane is preserved — the recorder already emits it per lane in order),
then emit

* ``counts``  int32[n_lanes] events per lane (replaces the lane array),
* ``packed``  int32[3, E/2]: (dq, ddiag, len) 16-bit fields, two events
  per int32 lane;
  dq = q - prev_q within the lane (first: q - 0), ddiag = (s - q) -
  previous diagonal, biased by +32768 for the signed field,
* ``esc``     int32[4, esc_cap]: exact (index, dq, ddiag, len) DELTA
  records for entries any field of which does not fit 16 bits — at least
  one per lane (the first event's dq is an absolute position), so
  esc_cap scales with the lane count.

Host side: scatter the escape deltas over the widened fields, then two
segmented cumsums rebuild (q, s) exactly.  The decoded stream is
bit-identical to the uncompressed fetch (tested).  Reference analogue:
none — andi never crosses a device link.  Whether the pack pays for itself
over PCIe is an open measurement.
"""

from __future__ import annotations

import functools

import numpy as np

BIAS = 1 << 15


@functools.lru_cache(maxsize=None)
def _encode_fn(k: int, esc_cap: int, n_lanes: int):
    import jax
    import jax.numpy as jnp

    @jax.jit
    def encode(ev_lane_len, ev_qs, cnt):
        lane = (ev_lane_len[:k] >> 32).astype(jnp.int32)
        ln = (ev_lane_len[:k] & 0x7FFFFFFF).astype(jnp.int32)
        q = (ev_qs[:k] >> 32).astype(jnp.int32)
        s = (ev_qs[:k] & 0x7FFFFFFF).astype(jnp.int32)
        idx = jnp.arange(k, dtype=jnp.int64)
        live = idx < cnt
        lane_l = jnp.where(live, lane, n_lanes)
        # stable sort by lane: composite key keeps buffer order per lane
        key = (lane_l.astype(jnp.int64) << 32) | idx
        order = (jnp.sort(key) & 0xFFFFFFFF).astype(jnp.int32)
        lane_s = lane_l[order]
        q_s = q[order]
        s_s = s[order]
        ln_s = ln[order]
        diag = s_s - q_s
        prev_lane = jnp.concatenate([jnp.array([-1]), lane_s[:-1]])
        first = lane_s != prev_lane
        prev_q = jnp.concatenate([jnp.zeros(1, jnp.int32), q_s[:-1]])
        prev_d = jnp.concatenate([jnp.zeros(1, jnp.int32), diag[:-1]])
        dq = q_s - jnp.where(first, 0, prev_q)
        dd = diag - jnp.where(first, 0, prev_d)
        esc = (
            (dq < 0) | (dq > 0xFFFF - 1)
            | (dd < -BIAS) | (dd >= BIAS)
            | (ln_s < 0) | (ln_s > 0xFFFF)
        ) & (lane_s < n_lanes)
        # two 16-bit fields per int32 lane: 6 B/event
        dq16 = jnp.where(esc, 0xFFFF, dq)
        dd16 = jnp.where(esc, 0, dd + BIAS)
        ln16 = jnp.where(esc, 0, ln_s)

        def pair(x):
            return x[0::2] | (x[1::2] << 16)

        packed = jnp.stack([pair(dq16), pair(dd16), pair(ln16)])
        # compact escape records
        e32 = esc.astype(jnp.int32)
        slot = jnp.where(esc, jnp.cumsum(e32) - e32, esc_cap)
        esc_rec = jnp.full((4, esc_cap + 1), 0, jnp.int32)
        esc_rec = esc_rec.at[0, slot].set(
            jnp.arange(k, dtype=jnp.int32), mode="drop"
        )
        esc_rec = esc_rec.at[1, slot].set(dq, mode="drop")
        esc_rec = esc_rec.at[2, slot].set(dd, mode="drop")
        esc_rec = esc_rec.at[3, slot].set(ln_s, mode="drop")
        n_esc = jnp.sum(e32)
        counts = jnp.zeros(n_lanes + 1, jnp.int32).at[lane_s].add(
            1, mode="drop"
        )
        esc_ovf = n_esc > esc_cap
        return packed, esc_rec[:, :esc_cap], counts[:n_lanes], n_esc, esc_ovf

    return encode


def encode_events(ev_lane_len, ev_qs, cnt, k: int, n_lanes: int):
    """Device-side pack; returns (packed u16[3,k], esc int32[4,cap],
    counts int32[n_lanes], n_esc, esc_ovf) as device arrays."""
    esc_cap = max(4096, 2 * n_lanes)
    return _encode_fn(k, esc_cap, n_lanes)(ev_lane_len, ev_qs, cnt)


def decode_events(packed, esc, counts, n_esc, cnt):
    """Host-side exact reconstruction -> (lane, q, s, len) int32[cnt] in
    per-lane chain order (lane-major)."""
    packed = np.asarray(packed).view(np.uint32)
    esc = np.asarray(esc)
    counts = np.asarray(counts, dtype=np.int64)

    def unpair(x):
        out = np.empty(2 * len(x), np.int32)
        out[0::2] = (x & 0xFFFF).astype(np.int32)
        out[1::2] = (x >> 16).astype(np.int32)
        return out

    dq = unpair(packed[0])[:cnt]
    dd = unpair(packed[1])[:cnt] - BIAS
    ln = unpair(packed[2])[:cnt]
    if n_esc:
        ei = esc[0, :n_esc]
        keep = ei < cnt
        ei = ei[keep]
        dq[ei] = esc[1, :n_esc][keep]
        dd[ei] = esc[2, :n_esc][keep]
        ln[ei] = esc[3, :n_esc][keep]
    lanes = np.repeat(
        np.arange(len(counts), dtype=np.int32), counts
    )[:cnt].astype(np.int32)
    # segmented cumsum over lane runs
    ends = np.cumsum(counts)
    starts = ends - counts
    starts = starts[counts > 0]
    tot_q = np.cumsum(dq, dtype=np.int64)
    tot_d = np.cumsum(dd, dtype=np.int64)
    off_q = np.zeros(cnt, dtype=np.int64)
    off_d = np.zeros(cnt, dtype=np.int64)
    s0 = starts[starts < cnt]
    nz = s0[s0 > 0]
    off_q[nz] = tot_q[nz - 1]
    off_d[nz] = tot_d[nz - 1]
    off_q = _runfill(off_q, s0, cnt)
    off_d = _runfill(off_d, s0, cnt)
    q = (tot_q - off_q).astype(np.int32)
    d = (tot_d - off_d).astype(np.int32)
    return lanes, q, (q + d).astype(np.int32), ln


def _runfill(off, starts, cnt):
    """Propagate per-run offsets forward (offsets set at run starts)."""
    if cnt == 0:
        return off
    mark = np.zeros(cnt, dtype=np.int64)
    mark[starts] = 1
    run_id = np.cumsum(mark) - 1
    per_run = off[starts]
    return per_run[run_id]

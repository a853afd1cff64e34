"""Segment-parallel chain walk with exact host reconciliation.

The lock-step chain walk's cost has two terms: a fixed per-iteration
latency term proportional to the SEQUENTIAL DEPTH (max probes over
lanes), and a gather-volume term proportional to ACTIVE lanes x probes.
This module cuts both terms without changing a single accepted anchor:

* **Segmentation** (depth): each (subject, query) lane's query is split
  into K segments walked as independent flat lanes
  (``replay_device.chain_walk_flat``) — sequential depth drops ~K-fold.
  Segments other than the first start COLD (no last anchor), which is a
  speculation; reconciliation below repairs it exactly.
* **Chunked compaction** (volume): the walk runs in bounded-iteration
  chunks; lanes that finished are compacted away between chunks, so
  diverged pairs (~4x the probe count of close pairs) stop dragging
  every other lane's gathers through the loop tail.

Reconciliation is exact because the chain's cross-probe state is exactly
``(pos, qend = last_q + last_len, diag = last_s - last_q)`` — gap checks
and the lucky-anchor diagonal are its only consumers (``dist_anchor``,
src/process.c:82-100,141-214) — with two consequences:

1. Once ``gap = pos - qend > threshold``, lucky anchors are disabled until
   the next accepted anchor (gap grows monotonically), so any state with
   gap > threshold at position pos is equivalent to the canonical "cold"
   state (pos, pos - threshold - 2, 0).
2. An accepted anchor (q, s, len) forces the post-state
   (pos = q + len + 1, qend = q + len, diag = s - q) REGARDLESS of prior
   history.  Therefore a true (repair) walk entering a segment with the
   real boundary state merges with the segment's speculative cold walk at
   the FIRST anchor event both record identically — everything after is
   byte-identical, and the true event stream is
   ``repair[:merge+1] + cold[merge+1:]``.

The driver: pass 1 walks all segments cold; pass 2 walks every segment
j >= 1 from the previous segment's cold exit (provisionally — usually the
true entry, validated left-to-right); further passes re-walk only lanes
whose provisional entry proved wrong or whose repair ran out of its event
budget before merging.  Lanes that refuse to merge (anchor-free stretches
of unrelated genomes record no events to merge on) fall back to walking
the REST of the lane sequentially after a bounded number of attempts —
per-lane worst case equals the unsegmented walk.

Counting is untouched: the spliced per-lane streams feed the same host
counting as the unsegmented event path (``chain.events``).
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np

BIG = 1 << 29

REPAIR_EVENTS = int(os.environ.get("ANDIX_REPAIR_EVENTS", "12"))
# first chunk's iteration cap; subsequent chunks double it.  Small chunks
# early let finished lanes compact away (close pairs finish in ~1/4 the
# probes of diverged ones — the lock-step tail would drag their gathers
# along); doubling bounds the dispatch count logarithmically.
CHUNK_ITERS = int(os.environ.get("ANDIX_CHUNK_ITERS", "768"))
# after this many event-budget extensions without a merge, walk the rest
# of the lane in one go (sequential fallback for anchor-free lanes)
MAX_EXTENSIONS = 2
_MIN_LANES = 16


def _canon(pos: int, qend: int, diag: int, thr: int):
    """Canonical chain state: states with gap > threshold are mutually
    equivalent (lucky anchors cannot fire again before the next accepted
    anchor resets qend/diag)."""
    if pos - qend > thr:
        return (pos, pos - thr - 2, 0)
    return (pos, qend, diag)


def _entry_arrays(triple):
    """Device entry (pos, lq, ls, ll) realizing a canonical triple."""
    pos, qend, diag = triple
    return pos, qend, qend + diag, 0


@dataclasses.dataclass
class _Sub:
    """One (lane, segment) sublane's static geometry."""
    lane: int  # s * gp + g
    j: int
    start: int
    end: int
    row: int
    qoff: int
    qs: int
    ss: int
    rl: int
    thr: int
    qlen: int


@dataclasses.dataclass
class _Attempt:
    """A (possibly continuing) true-entry walk of one sublane."""
    entry: tuple  # canonical triple it was launched from
    state: tuple | None  # (pos, lq, ls, ll) to resume from
    events: np.ndarray  # int32[3, m] (q, s, len) in chain order
    done: bool  # reached its end bound
    extensions: int = 0
    end: int = 0


def _lane_bucket(n: int) -> int:
    b = _MIN_LANES
    while b < n:
        b *= 2
    return b


class SegmentedWalk:
    """Orchestrates device chunks + host reconciliation for one subject
    group.  ``walk`` is a closure running ``chain_walk_flat`` over the
    group's device tables given flat per-lane numpy arrays."""

    def __init__(self, walk, ecap: int, prof=None):
        self.walk = walk
        self.ecap = ecap
        self.prof = prof
        self.dispatches = 0
        self.iters = 0
        self.overflow = False

    def run_requests(self, requests: list[dict]) -> dict:
        """Run every request to completion (its end bound or its event
        budget), chunked with compaction.  Returns key -> (events [3, m],
        state (pos, lq, ls, ll), done)."""
        out = {}
        acc_events: dict = {r["key"]: [] for r in requests}
        active = []
        for r in requests:
            sub = r["sub"]
            pos, lq, ls, ll = r["entry4"]
            if pos >= r["end"]:
                out[r["key"]] = (
                    np.zeros((3, 0), np.int32), (pos, lq, ls, ll), True
                )
                continue
            active.append(dict(r))
        chunk_iters = CHUNK_ITERS
        while active:
            lb = _lane_bucket(len(active))
            arr = {
                name: np.zeros(lb, np.int32)
                for name in ("row", "qoff", "qs", "ss", "rl", "thr",
                             "seg_end", "pos0", "lq0", "ls0", "ll0",
                             "maxev")
            }
            arr["rl"][:] = 1
            arr["thr"][:] = BIG
            for i, r in enumerate(active):
                sub = r["sub"]
                arr["row"][i] = sub.row
                arr["qoff"][i] = sub.qoff
                arr["qs"][i] = sub.qs
                arr["ss"][i] = sub.ss
                arr["rl"][i] = sub.rl
                arr["thr"][i] = sub.thr
                arr["seg_end"][i] = r["end"]
                (arr["pos0"][i], arr["lq0"][i], arr["ls0"][i],
                 arr["ll0"][i]) = r["entry4"]
                arr["maxev"][i] = r["max_events"]
            # the kernel takes one scalar event budget: chunk at the
            # smallest requested budget, then re-issue lanes that only hit
            # the chunk budget but still have their own budget left
            maxev = int(arr["maxev"][:len(active)].min())
            ev3, state, fin, iters, ovf = self.walk(arr, chunk_iters, maxev)
            # lanes stopped by a small shared event budget re-issue many
            # times: keep the doubled cap inside the kernel's int32
            chunk_iters = min(chunk_iters * 2, 1 << 30)
            self.dispatches += 1
            self.iters += int(iters)
            if ovf:
                self.overflow = True
                return out
            # split events per active lane (buffer order is chain order
            # per lane; stable grouping keeps it)
            order = np.argsort(ev3[0], kind="stable")
            lanes_sorted = ev3[0][order]
            bounds = np.searchsorted(lanes_sorted, np.arange(lb + 1))
            nxt = []
            for i, r in enumerate(active):
                lo, hi = bounds[i], bounds[i + 1]
                if hi > lo:
                    sel = order[lo:hi]
                    acc_events[r["key"]].append(ev3[1:, sel])
                st = (int(state[0][i]), int(state[1][i]),
                      int(state[2][i]), int(state[3][i]))
                got = hi - lo
                if fin[i] and st[0] >= r["end"]:
                    out[r["key"]] = (_cat3(acc_events[r["key"]]), st, True)
                elif fin[i]:
                    # stopped by the event budget
                    r["budget"] = r.get("budget", r["max_events"]) - got
                    if r["budget"] > 0 and got >= maxev > 0:
                        # chunk budget was tighter than this lane's own
                        r2 = dict(r)
                        r2["entry4"] = st
                        r2["max_events"] = r["budget"]
                        nxt.append(r2)
                    else:
                        out[r["key"]] = (
                            _cat3(acc_events[r["key"]]), st, False
                        )
                else:
                    # stopped by the chunk iteration cap — resume
                    r2 = dict(r)
                    r2["entry4"] = st
                    r2["max_events"] = r.get("budget", r["max_events"]) - got
                    r2["budget"] = r2["max_events"]
                    if r2["max_events"] <= 0:
                        out[r["key"]] = (
                            _cat3(acc_events[r["key"]]), st, False
                        )
                    else:
                        nxt.append(r2)
            active = nxt
        return out


def _cat3(parts: list[np.ndarray]) -> np.ndarray:
    if not parts:
        return np.zeros((3, 0), np.int32)
    if len(parts) == 1:
        return parts[0]
    return np.concatenate(parts, axis=1)


def _find_merge(rep: np.ndarray, cold: np.ndarray):
    """First index i such that repair event i appears in the cold stream
    (identical (q, s, len)); returns (i, cold_index) or None.  Both
    streams are ascending in q (probe positions strictly increase)."""
    if rep.shape[1] == 0 or cold.shape[1] == 0:
        return None
    c = np.searchsorted(cold[0], rep[0])
    inb = c < cold.shape[1]
    cs = np.minimum(c, cold.shape[1] - 1)
    hit = inb & (cold[0][cs] == rep[0]) & (cold[1][cs] == rep[1]) & (
        cold[2][cs] == rep[2]
    )
    idx = np.nonzero(hit)[0]
    if len(idx) == 0:
        return None
    i = int(idx[0])
    return i, int(c[i])


def plan_segments(qlen: int, k: int) -> list[tuple[int, int]]:
    """K segment bounds of a lane (final segments may be empty)."""
    step = -(-qlen // k) if qlen > 0 else 1
    out = []
    for j in range(k):
        s = min(j * step, qlen)
        e = min((j + 1) * step, qlen)
        if e > s:
            out.append((s, e))
    return out


def segmented_group_anchors(
    walk,
    sg: int,
    gp: int,
    qb: int,
    subj_starts: np.ndarray,
    rs_lens: np.ndarray,
    thresholds: np.ndarray,
    q_base: np.ndarray,
    q_start: np.ndarray,
    q_len2d: np.ndarray,
    k: int,
    ecap: int,
    prof=None,
):
    """Full segmented walk of one subject group.

    Returns (ev_lane [s * gp + g ids], ev_q, ev_s, ev_len) int32 arrays in
    chain order per lane, or None when a device event buffer overflowed
    (caller falls back to the unsegmented paths)."""
    sw = SegmentedWalk(walk, ecap, prof)

    subs: dict[tuple[int, int], _Sub] = {}
    lane_segs: dict[int, list[int]] = {}
    for s in range(sg):
        for g in range(gp):
            qlen = int(q_len2d[s, g])
            if qlen <= 0:
                continue
            lane = s * gp + g
            segs = plan_segments(qlen, k)
            lane_segs[lane] = list(range(len(segs)))
            for j, (st, en) in enumerate(segs):
                subs[(lane, j)] = _Sub(
                    lane=lane, j=j, start=st, end=en,
                    row=s, qoff=int(q_base[g]), qs=int(q_start[g]),
                    ss=int(subj_starts[s]), rl=int(rs_lens[s]),
                    thr=int(thresholds[s]), qlen=qlen,
                )

    # --- pass 1: cold walks of every segment ---
    cold_reqs = []
    for key, sub in subs.items():
        if sub.j == 0:
            entry = (0, 0, 0, 0)
        else:
            entry = _entry_arrays(_canon(sub.start, -BIG, 0, sub.thr))
        cold_reqs.append(dict(
            key=key, sub=sub, entry4=entry, end=sub.end, max_events=BIG,
        ))
    cold = sw.run_requests(cold_reqs)
    if sw.overflow:
        return None

    def exit_triple(state, thr):
        pos, lq, ls, ll = state
        return _canon(pos, lq + ll, ls - lq, thr)

    cold_exit = {
        key: exit_triple(res[1], subs[key].thr) for key, res in cold.items()
    }

    # --- pass 2: provisional repairs from the previous segment's cold exit
    attempts: dict[tuple[int, int], _Attempt] = {}
    prov_reqs = []
    for (lane, j), sub in subs.items():
        if j == 0:
            continue
        prev = cold_exit.get((lane, j - 1))
        if prev is None or prev[0] >= sub.end:
            continue
        att = _Attempt(entry=prev, state=None, events=None, done=False,
                       end=sub.end)
        attempts[(lane, j)] = att
        prov_reqs.append(dict(
            key=(lane, j), sub=sub, entry4=_entry_arrays(prev),
            end=sub.end, max_events=REPAIR_EVENTS,
        ))
    res = sw.run_requests(prov_reqs)
    if sw.overflow:
        return None
    for key, (ev3, state, done) in res.items():
        att = attempts[key]
        att.events = ev3
        att.state = state
        att.done = done

    # --- resolve loop: validate entries left to right, splice at merges,
    # issue exact repairs/continuations for whatever is still open ---
    resolved: dict[tuple[int, int], np.ndarray] = {}
    resolved_exit: dict[tuple[int, int], tuple] = {}
    guard = 0
    while True:
        requests = []
        all_done = True
        for lane, jlist in lane_segs.items():
            cur = (0, 0, 0)
            for j in jlist:
                key = (lane, j)
                sub = subs[key]
                if key in resolved:
                    cur = resolved_exit[key]
                    continue
                if cur[0] >= sub.end:
                    resolved[key] = np.zeros((3, 0), np.int32)
                    resolved_exit[key] = cur
                    continue
                if j == 0:
                    resolved[key] = cold[key][0]
                    resolved_exit[key] = cold_exit[key]
                    cur = cold_exit[key]
                    continue
                att = attempts.get(key)
                if att is None or att.entry != cur or att.events is None:
                    att = _Attempt(entry=cur, state=None, events=None,
                                   done=False, end=sub.end)
                    attempts[key] = att
                    requests.append(dict(
                        key=key, sub=sub, entry4=_entry_arrays(cur),
                        end=sub.end, max_events=REPAIR_EVENTS, att=att,
                    ))
                    all_done = False
                    break
                cold_ev = cold[key][0] if key in cold else None
                m = (
                    _find_merge(att.events, cold_ev)
                    if cold_ev is not None and att.end == sub.end
                    else None
                )
                if m is not None:
                    i, c = m
                    resolved[key] = _cat3(
                        [att.events[:, : i + 1], cold_ev[:, c + 1:]]
                    )
                    resolved_exit[key] = cold_exit[key]
                    cur = cold_exit[key]
                    continue
                if att.done:
                    resolved[key] = att.events
                    resolved_exit[key] = exit_triple(att.state, sub.thr)
                    cur = resolved_exit[key]
                    continue
                # ran out of event budget before merging: extend, or give
                # up on merging and walk the rest of the lane in one go
                att.extensions += 1
                end = sub.end
                if att.extensions > MAX_EXTENSIONS:
                    end = sub.qlen
                    att.end = end
                requests.append(dict(
                    key=key, sub=sub, entry4=att.state, end=end,
                    max_events=(
                        BIG if att.extensions > MAX_EXTENSIONS
                        else REPAIR_EVENTS
                    ),
                    att=att,
                ))
                all_done = False
                break
        if all_done:
            break
        guard += 1
        if guard > 4 * k + 8:
            # input-dependent worst case (resolve refuses to converge):
            # fail SOFT like the event-overflow path — the caller falls
            # back to the unsegmented walk, which is always correct
            print(
                "andix: segmented chain resolve did not converge after "
                f"{guard - 1} rounds; falling back to the unsegmented "
                "walk.",
                file=__import__("sys").stderr,
            )
            return None
        res = sw.run_requests(requests)
        if sw.overflow:
            return None
        for r in requests:
            key = r["key"]
            if key not in res:
                continue
            ev3, state, done = res[key]
            att = attempts[key]
            att.events = (
                ev3 if att.events is None or att.events.shape[1] == 0
                else _cat3([att.events, ev3])
            )
            att.state = state
            att.done = done

    # --- final per-lane streams in chain order ---
    parts_lane, parts_ev = [], []
    for lane, jlist in lane_segs.items():
        for j in jlist:
            ev3 = resolved[(lane, j)]
            if ev3.shape[1]:
                parts_ev.append(ev3)
                parts_lane.append(
                    np.full(ev3.shape[1], lane, np.int32)
                )
    if not parts_ev:
        z = np.zeros(0, np.int32)
        return z, z, z, z
    ev = np.concatenate(parts_ev, axis=1)
    lanes = np.concatenate(parts_lane)
    if prof is not None:
        prof(
            f"segmented walk: {sw.dispatches} dispatches, "
            f"{sw.iters} probe steps, {ev.shape[1]} events, "
            f"{len(subs)} lanes"
        )
    return lanes, ev[0], ev[1], ev[2]

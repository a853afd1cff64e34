"""Host-side counting from device-recorded anchor events.

The device chain walk (``replay_device.chain_anchors_device``) records every
accepted anchor as (lane, pos_q, pos_s, len) in chain order.  The 16-cell
substitution counts are a pure function of that anchor sequence plus the
text contents (``dist_anchor``'s counting block, src/process.c:160-211):
pairing/count decisions look only at consecutive anchors, equal-run counts
classify the query anchor segment, and gap counts classify the aligned gap
bytes — all of which live on the HOST already (the text is host-originated).
So only ~16 bytes per anchor reach the host instead of per-site data.

``counts_from_anchor_seq`` is the exact-semantics Python implementation
(mirrors ``replay_py.dist_anchor_replay`` lines 81-119); the native C++
``count_from_anchors_batch`` (OpenMP across lanes) is used when available.
"""

from __future__ import annotations

import numpy as np

from .. import native
from ..model import CountMatrix, model_count, model_count_equal
from ..runtime import Model as ModelKind


def counts_from_anchor_seq(
    ev_q: np.ndarray,
    ev_s: np.ndarray,
    ev_len: np.ndarray,
    rs: np.ndarray,
    query: np.ndarray,
    threshold: int,
    model_kind: ModelKind,
) -> CountMatrix:
    """Counting block of ``dist_anchor`` replayed over a recorded anchor
    sequence (chain order).  Semantics identical to
    ``replay_py.dist_anchor_replay`` with the probe search removed."""
    query_length = len(query)
    rs_len = len(rs)
    ret = CountMatrix.zero(seq_len=query_length)
    border = rs_len // 2

    last_q = 0
    last_s = 0
    last_len = 0
    last_right = False
    for k in range(len(ev_q)):
        q = int(ev_q[k])
        s = int(ev_s[k])
        ln = int(ev_len[k])
        end_s = last_s + last_len
        end_q = last_q + last_len
        if (
            s > end_s
            and q - end_q == s - end_s
            and (s < border) == (last_s < border)
        ):
            model_count_equal(ret, query[last_q:], last_len, model_kind)
            model_count(ret, rs[end_s:], query[end_q:], q - end_q)
            last_right = True
        else:
            if last_right or last_len >= threshold * 2:
                model_count_equal(ret, query[last_q:], last_len, model_kind)
            last_right = False
        last_q = q
        last_s = s
        last_len = ln

    # identical sequences (src/process.c:199-203)
    if last_len >= query_length:
        model_count_equal(ret, query, query_length, model_kind)
        return ret
    # trailing anchor (src/process.c:207-211)
    if last_right or last_len >= threshold * 2:
        model_count_equal(ret, query[last_q:], last_len, model_kind)
    return ret


def group_counts_from_events(
    ev_lane: np.ndarray,  # int32[E] lane = subject_row * G + query_lane
    ev_q: np.ndarray,
    ev_s: np.ndarray,
    ev_len: np.ndarray,
    sg: int,
    g: int,
    subjects_rs: list,  # [sg] uint8 RS bytes (None for padding rows)
    thresholds: list,  # [sg]
    query_blob: np.ndarray,  # uint8 concatenated forward queries
    q_off: np.ndarray,  # int64[g+1]
    model_kind: ModelKind,
    threads: int = 0,
) -> np.ndarray:
    """int64[sg, g, 16] counts for every lane of a subject group.

    Events must be in chain order per lane (globally interleaved is fine —
    the stable per-lane extraction preserves order)."""
    out = np.zeros((sg, g, 16), dtype=np.int64)
    order = np.argsort(ev_lane, kind="stable")
    lanes_sorted = ev_lane[order]
    bounds = np.searchsorted(lanes_sorted, np.arange(sg * g + 1))
    exact = model_kind in (ModelKind.LOGDET, ModelKind.ANI)

    if native.available() and hasattr(native, "count_from_anchors_batch"):
        return native.count_from_anchors_batch(
            ev_q[order], ev_s[order], ev_len[order], bounds,
            sg, g, subjects_rs, thresholds, query_blob, q_off,
            exact, threads,
        )

    for k in range(sg):
        rs = subjects_rs[k]
        if rs is None:
            continue
        for qg in range(g):
            lane = k * g + qg
            lo, hi = bounds[lane], bounds[lane + 1]
            qlo, qhi = int(q_off[qg]), int(q_off[qg + 1])
            if qhi <= qlo:
                continue
            sel = order[lo:hi]
            cm = counts_from_anchor_seq(
                ev_q[sel], ev_s[sel], ev_len[sel],
                rs, query_blob[qlo:qhi], int(thresholds[k]), model_kind,
            )
            out[k, qg] = cm.counts
    return out

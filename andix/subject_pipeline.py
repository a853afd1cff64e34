"""Subject-only index schedule: build each subject's index ONCE, stream
every query through the search-in-the-loop chain walk.

This is the device equivalent of the reference's actual architecture —
one ESA per subject, queries streamed against the static index
(src/esa.c:254-277, src/dist_hack.h:64-68) — replacing the joint-SA block
schedule for the compute-heavy family-scale configs:

* query text is NEVER sorted (the joint path re-sorts ~2/3 text per
  query chunk),
* each subject's SA+LCP is built exactly once per run (the joint path
  rebuilt subjects once per block x chunk),
* per-subject [Sg, QB] stats tables disappear — queries live on device
  only as 4-bit packed words.

Subjects are grouped so the group's resident index (SA + LCP + words +
k-mer caches) plus one build's transients fit device memory; each group
walks ALL (subject, query) pairs via the segmented driver
(``chain.segmented``, exact splicing) over
``chain.walk_sx.chain_walk_flat_sx``, and the 16-cell
counts come from the same host event counting as the joint path
(``chain.events``) — output is bit-identical across schedules (tested).

Event-buffer overflow escalates ecap twice, then the group falls back to
the joint-SA path (the caller reprocesses returned leftovers).
"""

from __future__ import annotations

import os
import time

import numpy as np

from .chain import events as chain_events
from .chain import segmented
from .model import CountMatrix
from .runtime import Context

# per-device (group, events) lines of the last multi-device run — the one
# scaling signal a virtual mesh can give (read by dryrun_multichip)
LAST_BALANCE: list[str] = []

# serialize jitted-call ENTRY across the device-driver threads: dispatch
# is asynchronous (execution still overlaps across devices), but
# concurrent first-call tracing/compilation from several threads has
# segfaulted XLA:CPU in the full suite — one compile at a time is cheap
# insurance and costs only enqueue latency
import threading as _threading

_DISPATCH_LOCK = _threading.RLock()

# resident bytes per padded index symbol: SA 4 + LCP 4 + words 0.5 + slack
IDX_BYTES_PER_SYM = float(os.environ.get("ANDIX_IDX_BYTES", "10"))
CACHE_BUDGET = int(
    float(os.environ.get("ANDIX_CACHE_BUDGET_GB", "2")) * 2**30
)


def _prof(label: str, t0: float, sync=None) -> float:
    from .esa.backend_jax import _prof as bprof

    return bprof(label, t0, sync)


def plan_groups(subjects, todo, low_memory: bool) -> list[list[int]]:
    """Pack subject indices into groups whose resident index + one build's
    transients fit the device budget."""
    from .esa.backend_jax import bucket, device_mem_bytes
    from .pipeline import BYTES_PER_PADDED_SYM

    if low_memory:
        return [[i] for i in todo]
    budget = device_mem_bytes()
    # subject cap per group: rows checkpoint at group completion, so a
    # long run loses at most one group's work when it is interrupted;
    # 16 also bounds the walk's lane count (0 = unbounded)
    cap = int(os.environ.get("ANDIX_GROUP_SUBJECTS", "16"))
    groups: list[list[int]] = []
    cur: list[int] = []
    cur_bytes = 0.0
    for i in todo:
        bp = bucket(subjects[i].len * 2 + 2)
        need = bp * IDX_BYTES_PER_SYM
        build_peak = bp * BYTES_PER_PADDED_SYM
        if cur and (
            cur_bytes + need + build_peak + CACHE_BUDGET > budget
            or (cap and len(cur) >= cap)
        ):
            groups.append(cur)
            cur = []
            cur_bytes = 0.0
        cur.append(i)
        cur_bytes += need
    if cur:
        groups.append(cur)
    return groups


def _build_group_index(group, subjects, cache_k, threads):
    """Stacked device index for one subject group: (sa2, lcp2, sw, cache2,
    nreal[S], Lp)."""
    import jax
    import jax.numpy as jnp

    from . import native
    from .esa import doubling, joint, subject_index
    from .esa import sa_numpy
    from .esa.backend_jax import (
        _acc_row, bucket, device_text, level_budget, pad_symbols,
    )
    from .esa import plcp as _plcp_mod

    sg = len(group)
    Lp = max(bucket(subjects[i].len * 2 + 2) for i in group)
    salcp = jnp.zeros((sg, 2, Lp), jnp.int32)
    sw = jnp.zeros((sg, Lp // 16), jnp.int64)
    nk = (1 << (2 * cache_k)) + 1
    cache2 = jnp.zeros((sg, nk), jnp.int32)
    nreal = np.zeros(sg, dtype=np.int32)

    budget = level_budget(Lp)
    env_mode = os.environ.get("ANDIX_LCP", "hybrid")

    # per subject: device_text upload + ONE fused build dispatch (SA +
    # LCP + words + cache, subject_index.fused_build) + ONE donated
    # 4-buffer row write instead of ~8 dispatches per subject.
    # Overflow flags are fetched once per group, not per subject.
    ovf_flags = []
    metas = []
    for k, i in enumerate(group):
        layout = joint.build_block({i: subjects[i].rs}, {})
        nreal[k] = layout.n
        alphabet_ok = all(
            int(b) in _plcp_mod.ALPHABET_U8
            for b in np.nonzero(np.bincount(layout.u8, minlength=256))[0]
        )
        lcp_mode = (
            env_mode
            if alphabet_ok and env_mode in ("plcp", "hybrid")
            else "levels"
        )
        base_width = doubling.wide_base_width(1, alphabet_ok)
        with _DISPATCH_LOCK:
            sym_d = device_text(layout, Lp)
            sa_d, lcp_d, ovf_d, words, cache = subject_index.fused_build(
                sym_d, jnp.int32(layout.n), cache_k, lcp_mode, base_width,
                budget,
            )
            salcp, sw, cache2 = subject_index.acc_idx(
                salcp, sw, cache2, sa_d, lcp_d, words, cache,
                jnp.int32(k),
            )
        ovf_flags.append(ovf_d)
        metas.append((k, i, layout))
        del sym_d, sa_d, lcp_d, words, cache

    ovf_h = np.asarray(jax.device_get(jnp.stack(ovf_flags)))
    for (k, i, layout), bad in zip(metas, ovf_h):
        if not bool(bad):
            continue
        # pathologically repetitive input: SA exact, LCP invalid — host
        # Φ fallback (same contract as the joint backend)
        sa_h = np.asarray(jax.device_get(salcp[k, 0]))
        padded = pad_symbols(layout.sym, Lp)
        if native.available():
            lcp_h = native.lcp_from_sa(padded, sa_h, threads)
        else:  # pragma: no cover - toolchain-less fallback
            lcp_h = sa_numpy.lcp_array(padded, sa_h)
        salcp = salcp.at[k, 1].set(jnp.asarray(lcp_h.astype(np.int32)))
    return salcp, sw, cache2, nreal, Lp


LANE_TARGET = int(os.environ.get("ANDIX_LANE_TARGET", "8192"))


def _chain_segments(max_qlen: int, lanes_base: int) -> int:
    """Segments per lane: a walk iteration has a fixed launch cost that is
    nearly independent of the lane count, so K scales the lane count
    toward ~LANE_TARGET, bounded by a minimum segment length
    (reconciliation overhead) and K <= 128.  LANE_TARGET and this rule
    were set on the first accelerator andix ran on; they are the first
    constants to re-derive from H100 walk measurements."""
    env = os.environ.get("ANDIX_CHAIN_SEGMENTS", "auto")
    if env != "auto":
        return max(1, min(int(env), max(max_qlen, 1)))
    if max_qlen < 1 << 17:
        return 1
    k = 1
    while (
        k < 128
        and lanes_base * (k * 2) <= LANE_TARGET
        and max_qlen // (k * 2) >= 4096
    ):
        k *= 2
    return max(1, min(k, max(max_qlen, 1)))


def process_subject_index(
    todo: list[int],
    seqs,
    subjects,
    ctx: Context,
    M,
    progress,
    ckpt,
) -> list[int]:
    """Run the subject-index schedule for ``todo`` subject rows; returns
    the rows it could NOT complete (event overflow after escalation) for
    the caller's joint-path fallback."""
    import jax.numpy as jnp

    from .chain.walk_sx import chain_walk_flat_sx
    from .esa import subject_index
    from .esa.backend_jax import bucket

    import threading

    import jax

    n = len(seqs)
    total_q = sum(s.len + 1 for s in seqs)
    if total_q + 16 >= 1 << 31:
        # the packed query blob is int32-addressed; thousands-of-genomes
        # runs beyond 2^31 symbols keep the joint schedule (which chunks
        # queries) until the sx path grows query chunking
        return list(todo)
    max_len = max(s.len * 2 + 2 for s in subjects)
    cache_k = int(
        os.environ.get(
            "ANDIX_CACHE_K",
            subject_index.pick_cache_k(max_len, len(todo), CACHE_BUDGET),
        )
    )
    threads = ctx.threads
    leftovers: list[int] = []
    publish_lock = threading.Lock()

    raw_blob, q_off, qw_base = _host_query_blob(seqs, n)
    gp = max(8, -(-n // 8) * 8)
    q_len_row = np.zeros(gp, dtype=np.int32)
    qw_base_pad = np.zeros(gp, dtype=np.int32)
    q_len_row[:n] = (q_off[1:] - q_off[:-1]).astype(np.int32)
    qw_base_pad[:n] = qw_base
    q_off_pad = np.full(gp + 1, q_off[-1], dtype=np.int64)
    q_off_pad[: n + 1] = q_off

    groups = plan_groups(subjects, todo, ctx.low_memory)
    devices = jax.devices()
    n_workers = (
        min(len(devices), len(groups))
        if (
            len(devices) > 1
            and jax.process_count() == 1
            and os.environ.get("ANDIX_SX_MESH", "1") != "0"
        )
        else 1
    )

    balance: list[str] = []
    LAST_BALANCE.clear()

    def run_device(widx: int) -> None:
        """One worker per device: its groups' whole build+walk+count
        pipelines run with arrays placed on that device (the pair grid is
        embarrassingly parallel — per-device dispatches are asynchronous,
        so devices compute concurrently while the host drivers
        interleave)."""
        my_groups = groups[widx::n_workers]
        if not my_groups:
            return
        dev_cm = (
            jax.default_device(devices[widx])
            if n_workers > 1
            else _nullcontext()
        )
        with dev_cm:
            qw = _pack_query_words(raw_blob, q_off, n)
            for group in my_groups:
                _process_group(
                    group, widx, qw, seqs, subjects, ctx, M, progress,
                    ckpt, cache_k, threads, leftovers, publish_lock,
                    n, gp, q_len_row, qw_base_pad, q_off, q_off_pad,
                    raw_blob, balance,
                )

    if n_workers > 1:
        ts = [
            threading.Thread(target=run_device, args=(w,))
            for w in range(n_workers)
        ]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
        LAST_BALANCE.extend(balance)
        if balance and os.environ.get("ANDIX_PROF_FILE"):
            _prof("sx mesh balance: " + "; ".join(balance), time.time())
    else:
        run_device(0)
    return leftovers


class _nullcontext:
    def __enter__(self):
        return None

    def __exit__(self, *a):
        return False


def _host_query_blob(seqs, n):
    q_off = np.zeros(n + 1, dtype=np.int64)
    qw_base = np.zeros(n, dtype=np.int32)
    pos = 0
    for g in range(n):
        q_off[g + 1] = q_off[g] + len(seqs[g].data)
        qw_base[g] = pos
        pos += len(seqs[g].data) + 1
    raw = np.concatenate(
        [np.asarray(seqs[g].data, dtype=np.uint8) for g in range(n)]
    ) if n else np.zeros(0, np.uint8)
    return raw, q_off, qw_base


def _pack_query_words(raw_blob, q_off, n):
    """Sentinel-injected packed query words on the current default
    device."""
    import jax.numpy as jnp

    from .esa import subject_index

    parts = []
    for g in range(n):
        parts.append(raw_blob[q_off[g] : q_off[g + 1]])
        parts.append(np.zeros(1, np.uint8))
    blob2 = np.concatenate(parts) if parts else np.zeros(0, np.uint8)
    pad = (-len(blob2)) % 16 + 16
    blob2 = np.concatenate([blob2, np.zeros(pad, np.uint8)])
    t0 = time.time()
    with _DISPATCH_LOCK:
        qw = subject_index.device_pack_words_u8(jnp.asarray(blob2))
    _prof("sx: query words H2D", t0, qw)
    return qw


def _process_group(
    group, widx, qw, seqs, subjects, ctx, M, progress, ckpt, cache_k,
    threads, leftovers, publish_lock, n, gp, q_len_row, qw_base_pad,
    q_off, q_off_pad, raw_blob, balance,
):
    import jax.numpy as jnp

    from .chain.walk_sx import chain_walk_flat_sx
    from .esa.backend_jax import bucket

    t0 = time.time()
    sg = -(-len(group) // 8) * 8
    salcp, sw, cache2, nreal_h, Lp = _build_group_index(
        group, subjects, cache_k, threads
    )
    if sg > len(group):
        pad_rows = sg - len(group)
        z = lambda a: jnp.zeros((pad_rows,) + a.shape[1:], a.dtype)
        salcp = jnp.concatenate([salcp, z(salcp)])
        sw = jnp.concatenate([sw, z(sw)])
        cache2 = jnp.concatenate([cache2, z(cache2)])
    nreal = np.ones(sg, dtype=np.int32)
    nreal[: len(group)] = nreal_h[: len(group)]
    t0 = _prof(f"sx: index build ({len(group)} subj)", t0, salcp[0, 0])

    rs_lens = np.ones(sg, dtype=np.int32)
    thresholds = np.full(sg, 2**29, dtype=np.int32)
    q_len2d = np.zeros((sg, gp), dtype=np.int32)
    for k, i in enumerate(group):
        rs_lens[k] = subjects[i].len
        thresholds[k] = subjects[i].threshold
        q_len2d[k] = q_len_row
        q_len2d[k, i] = 0  # diagonal pair skipped
    nreal_d = jnp.asarray(nreal)

    # event buffers are 16 B/slot of device memory and walks are CHUNKED
    # (a chunk's events are bounded by lanes x chunk iterations), so the
    # cap needs to cover one chunk, not the whole run: bound it at 32M
    # slots (512 MB)
    ecap = int(
        os.environ.get(
            "ANDIX_EVENT_CAP",
            str(
                min(
                    max(1 << 16, bucket(int(q_off[-1]) + 1) // 2),
                    1 << 25,
                )
            ),
        )
    )
    seg_k = _chain_segments(
        int(q_len_row.max()) if n else 0, len(group) * max(n - 1, 1)
    )

    def make_walk(ecap_now):
        def walk(arr, chunk_iters, maxev):
            with _DISPATCH_LOCK:
                out = chain_walk_flat_sx(
                    salcp, sw, cache2, nreal_d, qw,
                    jnp.asarray(arr["row"]), jnp.asarray(arr["qs"]),
                    jnp.asarray(arr["rl"]), jnp.asarray(arr["thr"]),
                    jnp.asarray(arr["seg_end"]),
                    jnp.asarray(arr["pos0"]), jnp.asarray(arr["lq0"]),
                    jnp.asarray(arr["ls0"]), jnp.asarray(arr["ll0"]),
                    jnp.int32(chunk_iters), jnp.int32(maxev),
                    cache_k, ecap_now,
                )
            return _fetch_walk(out, ecap_now)
        return walk

    t_ref = [time.time()]

    def prof(msg, _t=t_ref):
        _t[0] = _prof("sx: " + msg, _t[0])

    if not os.environ.get("ANDIX_PROF_FILE"):
        prof = None
    res = None
    ecap_now = ecap
    for _ in range(3):
        res = segmented.segmented_group_anchors(
            make_walk(ecap_now), sg, gp, 0,
            np.zeros(sg, np.int32), rs_lens, thresholds,
            qw_base_pad, qw_base_pad, q_len2d, seg_k, ecap_now, prof,
        )
        if res is not None:
            break
        ecap_now *= 4
    if res is None:
        with publish_lock:
            leftovers.extend(group)
        return
    lanes, ev_q, ev_s, ev_len = res
    balance.append(
        f"dev{widx} group[{group[0]}..{group[-1]}]: "
        f"{ev_q.shape[0]} events"
    )

    t0 = time.time()
    subjects_rs = [subjects[i].rs for i in group] + [None] * (
        sg - len(group)
    )
    counts_h = chain_events.group_counts_from_events(
        lanes, ev_q, ev_s, ev_len, sg, gp,
        subjects_rs, thresholds, raw_blob, q_off_pad,
        ctx.model, threads,
    )
    _prof(f"sx: host count from {ev_q.shape[0]} events", t0)

    with publish_lock:
        for k, i in enumerate(group):
            row = {}
            for g in range(n):
                if g == i:
                    continue
                seq_len = int(q_off[g + 1] - q_off[g])
                row[g] = CountMatrix(counts_h[k, g].copy(), seq_len)
            for g, cm in row.items():
                M[i][g] = cm
            if progress is not None:
                progress.advance(len(row))
            if ckpt is not None:
                ckpt.save_row(i, n, row)
    del salcp, sw, cache2


def _fetch_walk(out, ecap):
    """Device walk outputs -> the (ev3, state, fin, iters, ovf) tuple the
    segmented driver consumes (same protocol as the joint backend's
    walk closure).  The event fetch ships ~6 B/event by default
    (delta-packed on device, ``chain.evpack``; ANDIX_EVPACK=0 keeps the
    raw 16 B/event quads)."""
    import jax
    import jax.numpy as jnp

    from .chain import evpack
    from .esa.backend_jax import bucket

    (ev_lane_len, ev_qs, ev_cnt, ovf, iters,
     pos, lq, ls, ll, fin) = out
    lb = pos.shape[0]
    with _DISPATCH_LOCK:
        meta = (
            jnp.zeros(lb, jnp.int32)
            .at[0].set(ev_cnt)
            .at[1].set(ovf.astype(jnp.int32))
            .at[2].set(iters)
        )
        meta_stack = jnp.stack(
            [pos, lq, ls, ll, fin.astype(jnp.int32), meta]
        )
    state_h = np.asarray(jax.device_get(meta_stack))
    cnt = int(state_h[5, 0])
    ovf_h = bool(state_h[5, 1])
    iters_h = int(state_h[5, 2])
    if ovf_h:
        return (np.zeros((4, 0), np.int32), state_h[:4],
                state_h[4].astype(bool), iters_h, True)
    k = min(bucket(max(cnt, 1), minimum=4096), ecap)
    if os.environ.get("ANDIX_EVPACK", "1") != "0":
        with _DISPATCH_LOCK:
            enc = evpack.encode_events(ev_lane_len, ev_qs, ev_cnt, k, lb)
        packed, esc, counts, n_esc_d, esc_ovf_d = enc
        packed, esc, counts, n_esc, esc_ovf = jax.device_get(
            (packed, esc, counts, n_esc_d, esc_ovf_d)
        )
        if not bool(esc_ovf):
            lanes, q, s, ln = evpack.decode_events(
                packed, esc, counts, int(n_esc), cnt
            )
            ev = np.stack([lanes, q, s, ln])
            return (ev, state_h[:4], state_h[4].astype(bool),
                    iters_h, False)
    with _DISPATCH_LOCK:
        ev4 = _unpack_events(ev_lane_len, ev_qs, k)
    ev = np.asarray(jax.device_get(ev4))[:, :cnt]
    return (ev, state_h[:4], state_h[4].astype(bool), iters_h, False)


import functools


@functools.lru_cache(maxsize=None)
def _unpack_events_fn(k: int):
    import jax
    import jax.numpy as jnp

    @jax.jit
    def unpack(a, b):
        return jnp.stack([
            (a[:k] >> 32).astype(jnp.int32),
            (b[:k] >> 32).astype(jnp.int32),
            (b[:k] & 0x7FFFFFFF).astype(jnp.int32),
            (a[:k] & 0x7FFFFFFF).astype(jnp.int32),
        ])

    return unpack


def _unpack_events(ev_lane_len, ev_qs, k: int):
    return _unpack_events_fn(k)(ev_lane_len, ev_qs)

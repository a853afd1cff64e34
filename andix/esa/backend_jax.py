"""JAX block backend: device sorts + device scans, host LCP + replay.

Per subject block:

* joint text symbols -> device; suffix array via prefix-doubling
  ``lax.sort`` rounds (``doubling``),
* adjacent LCP on host via the native parallel Φ implementation (the one
  device<->host round trip of the build; SA down, LCP up),
* per-subject matching statistics fully on device (``matchstats_jax``),
  gathered at query positions and fetched once per subject.

The per-subject compiled program is shared across subjects (subject id is a
traced scalar) and across blocks of equal padded size.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from .. import native
from ..runtime import Model
from . import doubling, matchstats_jax, rmq, sa_numpy
from .joint import SEPARATOR_BASE, BlockLayout


_MIN_BUCKET = int(__import__("os").environ.get("ANDIX_MIN_BUCKET", 1 << 16))


def bucket(n: int, minimum: int | None = None) -> int:
    """Round up to {2^k, 1.5*2^k} so device programs compile per bucket,
    not per exact block size (waste <= 33%)."""
    b = minimum if minimum is not None else _MIN_BUCKET
    while b < n:
        b2 = b + b // 2
        if b2 >= n:
            return b2
        b *= 2
    return b


def pad_symbols(sym: np.ndarray, padded_n: int) -> np.ndarray:
    """Pad the joint text with strictly increasing symbols larger than every
    real symbol.  All real suffixes compare below all padding suffixes and
    no two real suffixes can tie into the padding (segments end with unique
    separators), so ``SA[:n_real]`` of the padded text equals the real SA."""
    n = len(sym)
    if padded_n == n:
        return sym
    pad_base = max(
        1 << 20,
        (int(sym.max(initial=SEPARATOR_BASE)) + 1) if n else SEPARATOR_BASE,
    )
    pad = pad_base + np.arange(padded_n - n, dtype=np.int32)
    return np.concatenate([sym, pad])


@dataclasses.dataclass
class BlockContext:
    layout: BlockLayout
    q_genomes: list[int]  # genome ids in blob order
    q_off: np.ndarray  # int64[g+1] offsets into the query blob
    query_blob: np.ndarray  # uint8 concatenated forward sequences
    # backend handles
    sa_d: jax.Array
    lcp_d: jax.Array
    segid_d: jax.Array
    tq_d: jax.Array  # int32 SA positions of blob elements (padded)
    # device-replay handles (JAX backend only)
    text_d: jax.Array | None = None  # int32 padded block text
    isa_d: jax.Array | None = None
    rm: "rmq.RangeMin | None" = None
    q_start_d: jax.Array | None = None  # int32[Gp] text base per query lane
    q_len_d: jax.Array | None = None  # int32[Gp] (0 = padding lane)
    q_base_d: jax.Array | None = None  # int32[Gp] blob base per query lane
    q_len_h: np.ndarray | None = None  # host copy of q_len (no readback)
    q_start_h: np.ndarray | None = None  # host copy of q_start
    q_base_h: np.ndarray | None = None  # host copy of q_base


def _query_blob(layout: BlockLayout):
    genomes = [int(g) for g in layout.genome_ids]
    spans = [layout.query_span(g) for g in genomes]
    q_off = np.zeros(len(genomes) + 1, dtype=np.int64)
    parts = []
    qpos = []
    for k, (qs, qe) in enumerate(spans):
        q_off[k + 1] = q_off[k] + (qe - qs)
        parts.append(layout.u8[qs:qe])
        qpos.append(np.arange(qs, qe, dtype=np.int64))
    blob = np.concatenate(parts) if parts else np.zeros(0, np.uint8)
    qpos_all = np.concatenate(qpos) if qpos else np.zeros(0, np.int64)
    return genomes, q_off, blob, qpos_all


import functools


@jax.jit
def _build_device_text(u8: jax.Array, sep_pos: jax.Array, sep_val: jax.Array,
                       n_real: jax.Array) -> jax.Array:
    """Reconstruct the int32 joint text on device from uint8 bytes (4x less
    H2D traffic): separator symbols (>= 256) are scattered in, padding
    positions get strictly increasing oversized symbols."""
    npad = u8.shape[0]
    sym = u8.astype(jnp.int32)
    sym = sym.at[sep_pos].set(sep_val)
    iota = jnp.arange(npad, dtype=jnp.int32)
    pad_base = jnp.int32(1 << 20)
    return jnp.where(iota >= n_real, pad_base + iota, sym)


_ACGT_BYTES = (65, 67, 71, 84)


def _pack2bit(u8: np.ndarray):
    """(packed, exc_pos, exc_val): 2-bit base codes (A=0 C=1 G=2 T=3), four
    per byte, plus a sparse exception list covering every non-ACGT byte
    (contig joiners, strand separators, per-segment separator slots)."""
    n = len(u8)
    code = np.zeros(n, dtype=np.uint8)
    known = u8 == 65
    for k, b in ((1, 67), (2, 71), (3, 84)):
        m = u8 == b
        code[m] = k
        known |= m
    exc_pos = np.nonzero(~known)[0].astype(np.int32)
    exc_val = u8[exc_pos].astype(np.int32)
    m4 = -(-n // 4) * 4
    codep = np.zeros(m4, dtype=np.uint8)
    codep[:n] = code
    q = codep.reshape(-1, 4).astype(np.uint8)
    packed = q[:, 0] | (q[:, 1] << 2) | (q[:, 2] << 4) | (q[:, 3] << 6)
    return packed, exc_pos, exc_val


@jax.jit
def _build_device_text_packed(
    packed: jax.Array,  # uint8[Np/4]
    exc_pos: jax.Array,  # int32[E] (padded by repeating the last entry)
    exc_val: jax.Array,  # int32[E] byte or separator (>= 256) values
    n_real: jax.Array,
) -> jax.Array:
    """16x less H2D than int32 symbols: unpack 2-bit base codes, scatter the
    sparse exceptions, append strictly increasing padding symbols."""
    p = packed.astype(jnp.int32)
    codes = jnp.stack(
        [p & 3, (p >> 2) & 3, (p >> 4) & 3, (p >> 6) & 3], axis=1
    ).reshape(-1)
    sym = jnp.where(
        codes == 0,
        jnp.int32(65),
        jnp.where(
            codes == 1, jnp.int32(67),
            jnp.where(codes == 2, jnp.int32(71), jnp.int32(84)),
        ),
    )
    sym = sym.at[exc_pos].set(exc_val)
    npad = sym.shape[0]
    iota = jnp.arange(npad, dtype=jnp.int32)
    pad_base = jnp.int32(1 << 20)
    return jnp.where(iota >= n_real, pad_base + iota, sym)


@functools.partial(jax.jit, donate_argnums=(0,))
def _acc_row(buf, row, k):
    """In-place row write (buffer donated): big-block stats tables build
    one subject at a time without a stack's transient 2x copy."""
    return jax.lax.dynamic_update_index_in_dim(buf, row, jnp.int32(k), 0)


@functools.partial(jax.jit, static_argnames=("qb",))
def _block_tables(sa, lcp, seg_bounds, q_start, q_off_pad, qb):
    """Fused per-block table build (segid + ISA + query SA slots): one
    dispatch instead of three.  The RMQ builds as its own program
    (``_block_rmq``) so its transients do not co-peak with these."""
    segid = _device_segid(sa, seg_bounds)
    isa = matchstats_jax.inverse_sa_device(sa)
    tq = _device_tq(isa, q_start, q_off_pad, qb)
    return segid, isa, tq


# blocks above this many padded symbols drop the RMQ's element-span rows
# (12 B/symbol; same-fine-block LCE queries fall back to a masked 8-min)
_RMQ_SMALL_MAX = int(
    __import__("os").environ.get("ANDIX_RMQ_SMALL_MAX", str(48 << 20))
)


@functools.partial(jax.jit, static_argnames=("small_spans",))
def _block_rmq(lcp, small_spans: bool):
    return rmq.build(lcp, small_spans)


@functools.partial(jax.jit, static_argnames=("qb",))
def _device_tq(
    isa: jax.Array,  # int32[Np]
    q_start: jax.Array,  # int32[gp] text offset of each query span
    q_off: jax.Array,  # int32[gp+1] blob offsets (q_off[-1] = total)
    qb: int,
) -> jax.Array:
    """SA slots of the query blob, built on device (replaces shipping an
    O(total query length) index array from the host)."""
    v = jnp.arange(qb, dtype=jnp.int32)
    boundary = jnp.zeros(qb, jnp.int32).at[q_off[1:]].add(
        1, mode="drop"
    )
    seg = jnp.cumsum(boundary)
    gp = q_start.shape[0]
    seg = jnp.minimum(seg, gp - 1)
    tq_text = q_start[seg] + (v - q_off[seg])
    tq_text = jnp.where(v < q_off[-1], tq_text, 0)
    return isa[tq_text]


@jax.jit
def _device_segid(sa: jax.Array, seg_bounds: jax.Array) -> jax.Array:
    """Segment id per SA entry: text-order cumsum over segment boundaries
    plus one gather (replaces a 20x slower vectorized searchsorted)."""
    npad = sa.shape[0]
    boundary = jnp.zeros(npad, jnp.int32).at[seg_bounds].add(1, mode="drop")
    segid_text = jnp.cumsum(boundary)
    return segid_text[sa]


def packed_text_arrays(
    layout: BlockLayout, padded_n: int, exc_cap: int | None = None
):
    """Host-side inputs for ``_build_device_text_packed``: 2-bit packed base
    codes (padded to ``padded_n // 4`` bytes) plus the padded exception
    list (non-ACGT bytes and per-segment separator symbols).  Returns None
    when the text is exception-dense (caller uses the byte path), unless
    ``exc_cap`` is forced."""
    n_real = layout.n
    # the packed text path splits the padded length into byte quads
    assert padded_n % 4 == 0, "bucket() must return a multiple of 4"
    nseg = len(layout.genome_ids)
    ends = layout.seg_start[1:].astype(np.int64) - 1

    packed_text, exc_pos, exc_val = _pack2bit(layout.u8)
    # separator slots (byte 0 in u8) are part of the exception list;
    # overwrite their values with the real separator symbols
    if nseg:
        exc_val[np.searchsorted(exc_pos, ends)] = 256 + np.arange(nseg)
    n_exc = len(exc_pos)
    if n_exc == 0 or (
        exc_cap is None and n_exc > max(4096, n_real // 16)
    ):
        return None
    packed_pad = np.zeros(padded_n // 4, dtype=np.uint8)
    packed_pad[: len(packed_text)] = packed_text
    if exc_cap is None:
        exc_cap = max(64, 1 << int(max(n_exc - 1, 1)).bit_length())
    assert n_exc <= exc_cap
    exc_pos_pad = np.full(exc_cap, exc_pos[-1], dtype=np.int32)
    exc_val_pad = np.full(exc_cap, exc_val[-1], dtype=np.int32)
    exc_pos_pad[:n_exc] = exc_pos
    exc_val_pad[:n_exc] = exc_val
    return packed_pad, exc_pos_pad, exc_val_pad


def device_text(
    layout: BlockLayout, padded_n: int, force_dense: bool = False
) -> jax.Array:
    """Upload + reconstruct the padded int32 joint text on device.

    Sparse-exception texts (the normal case) ship 2-bit base codes plus an
    exception list (16x less H2D than int32 symbols); exception-dense texts
    (thousands of tiny contigs) ship raw bytes with the separator scatter.
    Both paths produce identical symbols (tested)."""
    n_real = layout.n
    nseg = len(layout.genome_ids)
    ends = layout.seg_start[1:].astype(np.int64) - 1

    arrays = None if force_dense else packed_text_arrays(layout, padded_n)
    if arrays is not None:
        packed_pad, exc_pos_pad, exc_val_pad = arrays
        return _build_device_text_packed(
            jnp.asarray(packed_pad), jnp.asarray(exc_pos_pad),
            jnp.asarray(exc_val_pad), jnp.int32(n_real),
        )
    assert padded_n % 4 == 0, "bucket() must return a multiple of 4"
    # exception-dense text (e.g. thousands of tiny contigs) or none at all
    u8 = np.zeros(padded_n, dtype=np.uint8)
    u8[:n_real] = layout.u8
    sep_cap = max(16, -(-nseg // 16) * 16)
    sep_pos = np.zeros(sep_cap, dtype=np.int32)
    sep_val = np.zeros(sep_cap, dtype=np.int32)
    if nseg:
        sep_pos[:nseg] = ends
        sep_val[:nseg] = 256 + np.arange(nseg)
        sep_pos[nseg:] = ends[-1]
        sep_val[nseg:] = 256 + nseg - 1
    else:  # no segments: make the scatter a no-op on padding slot 0
        sep_val[:] = 0
    return _build_device_text(
        jnp.asarray(u8), jnp.asarray(sep_pos), jnp.asarray(sep_val),
        jnp.int32(n_real),
    )


_DEVICE_LCP_MAX = int(
    __import__("os").environ.get("ANDIX_DEVICE_LCP_MAX", 192 * 1024 * 1024)
)
# Budget on the CPU platform, where XLA reports no device limit: the test
# suite's block and group plans are sized against it
CPU_TEST_MEM_BYTES = 12 * 2**30
# share of the device's allocator limit the planners may budget; the rest
# is left for allocator fragmentation and XLA's per-program workspace
DEVICE_MEM_SHARE = 0.875


def device_mem_bytes() -> int:
    """Device memory budget for block planning, group planning and the
    rank-level cap: the allocator limit the device reports, less headroom.
    On the CPU platform it is ``CPU_TEST_MEM_BYTES``; any other device
    that reports no limit is an error."""
    dev = jax.local_devices()[0]
    if dev.platform == "cpu":
        return CPU_TEST_MEM_BYTES
    limit = (dev.memory_stats() or {}).get("bytes_limit")
    if not limit:
        raise RuntimeError(
            f"device {dev.device_kind!r} ({dev.platform}) reports no memory "
            f"limit; cannot plan device blocks"
        )
    return int(limit * DEVICE_MEM_SHARE)


def level_budget(padded_n: int) -> int:
    """How many full int32 rank levels fit alongside the block's resident
    arrays (text, SA, ISA, LCP, segid, RMQ ≈ 6N·4B) and sort workspace
    (≈ 4N·4B)."""
    reserve = 10 * 4 * padded_n
    return max(0, (device_mem_bytes() - reserve) // (4 * padded_n))


def _prof(label: str, t0: float, sync=None) -> float:
    """Append a phase timing to ANDIX_PROF_FILE (no-op when unset).
    ``sync``: arrays to wait for before the clock is read."""
    import os
    import time

    path = os.environ.get("ANDIX_PROF_FILE")
    if not path:
        return t0
    if sync is not None:
        jax.block_until_ready(sync)
    t1 = time.time()
    with open(path, "a") as f:
        f.write(f"{label}: {t1 - t0:.2f}s\n")
    return time.time()


class JaxBackend:
    name = "jax"

    def __init__(self, threads: int = 0, device_replay: bool = True,
                 device_lcp: bool | None = None):
        self.threads = threads
        self.device_replay = device_replay
        self.device_lcp = device_lcp  # None = auto by block size

    def prepare_block(self, layout: BlockLayout) -> BlockContext:
        import time

        t0 = time.time()
        n_real = layout.n
        padded_n = bucket(n_real)
        nseg = len(layout.genome_ids)
        t0 = _prof("host text prep", t0)
        sym_d = device_text(layout, padded_n)
        t0 = _prof("H2D + device text", t0, sym_d)

        budget = level_budget(padded_n)
        use_device_lcp = (
            self.device_lcp
            if self.device_lcp is not None
            else padded_n <= _DEVICE_LCP_MAX and budget >= 6
        )
        # packed initial ranks need separator values within the 10-bit
        # clamp (doubling._initial_ranks contract): 256 + seg <= 1021
        packed_ranks = nseg <= 700
        # one-dispatch SA+LCP (device-resident loop) is the default;
        # ANDIX_SA_LOOP=host keeps the legacy per-round-readback driver
        # for A/B profiling
        sa_mode = __import__("os").environ.get("ANDIX_SA_LOOP", "device")
        # sampled-PLCP LCP (plcp.py) and the wide dense-code initial ranks
        # both need the block-text alphabet contract; texts from
        # device_text satisfy it by construction, but verify the bytes
        # anyway (ANDIX_LCP=levels keeps the rank-level walk for A/B)
        alphabet_ok = False
        if packed_ranks:
            present = np.nonzero(np.bincount(layout.u8, minlength=256))[0]
            from . import plcp as _plcp_mod

            alphabet_ok = all(
                int(b) in _plcp_mod.ALPHABET_U8 for b in present
            )
        lcp_mode = "levels"
        env_mode = __import__("os").environ.get("ANDIX_LCP", "hybrid")
        if alphabet_ok and env_mode in ("plcp", "hybrid"):
            lcp_mode = env_mode
        base_env = __import__("os").environ.get("ANDIX_SA_BASE")
        base_width = (
            int(base_env)
            if base_env
            else doubling.wide_base_width(nseg, alphabet_ok)
        )
        host_lcp = not use_device_lcp
        sa_d = lcp_d = None
        if use_device_lcp and sa_mode != "host":
            sa_d, lcp_d, ovf_d, may_ovf = doubling.sa_lcp_device(
                sym_d, packed=packed_ranks,
                max_levels=budget if self.device_lcp is None else None,
                lcp_mode=lcp_mode, base_width=base_width,
            )
            if may_ovf and bool(np.asarray(jax.device_get(ovf_d))):
                # level buffer overflowed (pathologically repetitive
                # input): the SA is still exact, only the LCP is invalid
                lcp_d = None
                host_lcp = True
            t0 = _prof("SA+LCP fused dispatch", t0, sa_d)
        elif use_device_lcp:
            from . import device_pipeline

            sa_d, levels = doubling.suffix_array_device_collect(
                sym_d, packed=packed_ranks,
                max_levels=budget if self.device_lcp is None else None,
            )
            nlev = len(levels) if levels is not None else -1
            t0 = _prof(f"SA doubling ({nlev} levels)", t0, sa_d)
            if levels is not None:
                # bucket the level count so lcp_from_levels compiles once
                # per (shape, bucket): pad with an all-distinct iota level
                # — the walk can never advance on it, whatever width its
                # index implies, so padding is exact at any position
                pad_level = jnp.arange(padded_n, dtype=jnp.int32)
                while len(levels) % 2:
                    levels.append(pad_level)
                lcp_d = device_pipeline.lcp_from_levels(
                    sa_d, jnp.stack(levels), sym_d,
                    base_width=doubling.BASE_WIDTH if packed_ranks else 1,
                )
                del levels
                t0 = _prof("LCP level walk", t0, lcp_d)
            else:
                host_lcp = True
        if sa_d is None:
            sa_d = doubling.suffix_array_device(sym_d, packed=packed_ranks)
            t0 = _prof("SA doubling (no levels)", t0, sa_d)

        if host_lcp and lcp_d is None:
            # host LCP: level budget exceeded (pathologically repetitive
            # input) or device LCP disabled — one SA down / LCP up round
            # trip; the native parallel Φ covers the compute
            sa = np.asarray(jax.device_get(sa_d))
            # host-side reconstruction of the padded text for the native
            # LCP; pad_symbols and the device text build may differ in the
            # exact pad values but both are strictly increasing and
            # oversized, and LCPs never extend into them
            padded = pad_symbols(layout.sym, padded_n)
            if native.available():
                lcp = native.lcp_from_sa(padded, sa, self.threads)
            else:  # pragma: no cover - toolchain-less fallback
                lcp = sa_numpy.lcp_array(padded, sa)
            lcp_d = jnp.asarray(lcp.astype(np.int32))
            t0 = _prof("host LCP round trip", t0, lcp_d)

        # device-replay inputs: query lane table padded to a small bucket
        genomes = [int(g) for g in layout.genome_ids]
        gp = max(8, -(-len(genomes) // 8) * 8)
        q_start = np.zeros(gp, dtype=np.int32)
        q_len = np.zeros(gp, dtype=np.int32)
        q_base = np.zeros(gp, dtype=np.int32)
        q_off = np.zeros(len(genomes) + 1, dtype=np.int64)
        for k, g in enumerate(genomes):
            qs, qe = layout.query_span(g)
            q_start[k] = qs
            q_len[k] = qe - qs
            q_off[k + 1] = q_off[k] + (qe - qs)
            q_base[k] = q_off[k]
        q_off_pad = np.full(gp + 1, q_off[-1], dtype=np.int32)
        q_off_pad[: len(q_off)] = q_off

        # fused per-block tables: segid (padding positions land past the
        # last segment, never matching any subject), ISA, query SA slots,
        # and the range-min structure — one dispatch
        qb = bucket(max(int(q_off[-1]), 1))
        segid_d, isa_d, tq_d = _block_tables(
            sa_d, lcp_d,
            jnp.asarray(layout.seg_start[1:].astype(np.int32)),
            jnp.asarray(q_start), jnp.asarray(q_off_pad), qb,
        )
        rm = _block_rmq(lcp_d, padded_n <= _RMQ_SMALL_MAX)
        t0 = _prof("block tables (segid+isa+tq+rmq)", t0, tq_d)
        blob = (
            np.concatenate(
                [layout.u8[q_start[k] : q_start[k] + q_len[k]]
                 for k in range(len(genomes))]
            )
            if genomes
            else np.zeros(0, np.uint8)
        )
        return BlockContext(
            layout=layout,
            q_genomes=genomes,
            q_off=q_off,
            query_blob=blob,
            sa_d=sa_d,
            lcp_d=lcp_d,
            segid_d=segid_d,
            tq_d=tq_d,
            # the event paths never touch the text on device (host counts
            # from host bytes); keep it only for the loop fallback, which
            # rebuilds it on demand — at a 100M-symbol block the 0.4 GB
            # matters for the RMQ/tables peak
            text_d=(
                sym_d
                if __import__("os").environ.get("ANDIX_REPLAY", "events")
                != "events"
                else None
            ),
            isa_d=isa_d,
            rm=rm,
            q_start_d=jnp.asarray(q_start),
            q_len_d=jnp.asarray(q_len),
            q_base_d=jnp.asarray(q_base),
            q_len_h=q_len,
            q_start_h=q_start,
            q_base_h=q_base,
        )

    def subject_stats(self, ctx: BlockContext, subject_genome: int):
        layout = ctx.layout
        subj_seg = int(
            np.nonzero(
                (layout.genome_ids == subject_genome) & layout.is_subject
            )[0][0]
        )
        subj_start = int(layout.seg_start[subj_seg])
        ml, un, ps = matchstats_jax.match_stats_device(
            ctx.sa_d,
            ctx.lcp_d,
            ctx.segid_d,
            jnp.int32(subj_seg),
            jnp.int32(subj_start),
        )
        ml_q, un_q, ps_q = matchstats_jax.gather_query_stats(ml, un, ps, ctx.tq_d)
        ml_h, un_h, ps_h = jax.device_get((ml_q, un_q, ps_q))
        q_total = int(ctx.q_off[-1])
        return (
            np.asarray(ml_h[:q_total], dtype=np.int32),
            np.asarray(un_h[:q_total], dtype=bool),
            np.asarray(ps_h[:q_total], dtype=np.int32),
        )

    def _subject_seg(self, layout: BlockLayout, subject_genome: int):
        subj_seg = int(
            np.nonzero(
                (layout.genome_ids == subject_genome) & layout.is_subject
            )[0][0]
        )
        return subj_seg, int(layout.seg_start[subj_seg])

    def subject_row_counts(
        self, ctx: BlockContext, subject_genome: int, subject, model_kind
    ) -> dict[int, "object"]:
        """Single-subject device path (matchstats + on-device replay)."""
        return self.subject_group_counts(
            ctx, [subject_genome], {subject_genome: subject}, model_kind
        )[subject_genome]

    def subject_group_counts(
        self,
        ctx: BlockContext,
        subject_genomes: list[int],
        subjects: dict[int, "object"],
        model_kind,
    ) -> dict[int, dict[int, "object"]]:
        """Grouped device path: matchstats per subject, then ONE lock-step
        chain walk over every (subject, query) lane of the group.

        Default mode ("events"): the device loop only records the anchor
        sequence per lane (~16 bytes per anchor reach the host) and the
        16-cell counting happens on host from the events + the host-resident
        text — the per-site [Sg, G, chunk] text gathers that dominated the
        in-loop counting never run.  ANDIX_REPLAY=loop keeps the
        count-in-loop path (also the fallback when the event buffer
        overflows on pathological inputs)."""
        import os as _os

        if _os.environ.get("ANDIX_REPLAY", "events") == "events":
            seg_k = self._chain_segments(ctx)
            if seg_k > 1:
                out = self._subject_group_counts_segmented(
                    ctx, subject_genomes, subjects, model_kind, seg_k
                )
                if out is not None:
                    return out
            out = self._subject_group_counts_events(
                ctx, subject_genomes, subjects, model_kind
            )
            if out is not None:
                return out
        return self._subject_group_counts_loop(
            ctx, subject_genomes, subjects, model_kind
        )

    def _chain_segments(self, ctx) -> int:
        """Query segments per lane for the segment-parallel chain walk
        (``andix.chain.segmented``).  The sequential chain depth drops
        ~K-fold; tiny queries gain nothing (the walk is already short) and
        would pay the extra reconciliation dispatches."""
        env = __import__("os").environ.get("ANDIX_CHAIN_SEGMENTS", "auto")
        max_qlen = int(np.max(ctx.q_len_h)) if ctx.q_len_h is not None else 0
        if env != "auto":
            k = int(env)
        elif max_qlen >= 1 << 19:
            k = 8
        elif max_qlen >= 1 << 17:
            k = 4
        else:
            k = 1
        return max(1, min(k, max(max_qlen, 1)))

    def _build_group_tables(self, ctx, sg, segs, starts, thresholds,
                            jump_passes, want_jump=True):
        """[Sg, QB] mlun/ps(/jump) device tables for a subject group —
        fused vmapped build for small blocks, per-subject accumulation
        into donated buffers for big ones (the [Sg, N] scan intermediates
        of the fused build outgrow device memory at 67M-symbol blocks).  The
        segmented walk derives jump hops from mlun, so it builds with
        ``want_jump=False`` (one third less table memory and build)."""
        from ..chain.replay_device import (
            group_subject_tables, single_subject_tables,
        )

        padded_n = ctx.sa_d.shape[0]
        split_min = int(
            __import__("os").environ.get(
                "ANDIX_SPLIT_TABLES_MIN", str(1 << 25)
            )
        )
        if padded_n < split_min:
            return group_subject_tables(
                ctx.sa_d, ctx.lcp_d, ctx.segid_d, ctx.tq_d,
                jnp.asarray(segs), jnp.asarray(starts),
                jnp.asarray(thresholds), jump_passes, want_jump,
            )
        qb_len = ctx.tq_d.shape[0]
        if not want_jump:
            # segmented-walk tables: ONE donated-buffer program per
            # subject (build + both row writes fused) instead of three
            # dispatches each
            from ..chain.replay_device import single_subject_tables_acc

            b0 = jnp.zeros((sg, qb_len), jnp.int32)
            b1 = jnp.zeros((sg, qb_len), jnp.int32)
            for k in range(sg):
                if segs[k] < 0:
                    continue
                b0, b1 = single_subject_tables_acc(
                    b0, b1, ctx.sa_d, ctx.lcp_d, ctx.segid_d, ctx.tq_d,
                    jnp.int32(segs[k]), jnp.int32(starts[k]),
                    jnp.int32(thresholds[k]), jnp.int32(k), jump_passes,
                )
            return b0, b1
        bufs = [
            jnp.zeros((sg, qb_len), jnp.int32) for _ in range(3)
        ]
        for k in range(sg):
            if segs[k] < 0:
                continue
            r = single_subject_tables(
                ctx.sa_d, ctx.lcp_d, ctx.segid_d, ctx.tq_d,
                jnp.int32(segs[k]), jnp.int32(starts[k]),
                jnp.int32(thresholds[k]), jump_passes, want_jump,
            )
            bufs = [_acc_row(b, row, k) for b, row in zip(bufs, r)]
            del r
        return tuple(bufs)

    def _subject_group_counts_segmented(
        self, ctx, subject_genomes, subjects, model_kind, seg_k
    ):
        """Segment-parallel chain walk (``andix.chain.segmented``) + host
        counting.  Returns None when a device event buffer overflowed."""
        import time

        from ..chain import events as chain_events
        from ..chain import segmented
        from ..chain.replay_device import chain_walk_flat
        from ..model import CountMatrix

        sg, gp, segs, starts, rs_lens, thresholds, q_len2d = (
            self._group_tables(ctx, subject_genomes, subjects)
        )
        qb = ctx.tq_d.shape[0]
        jump_passes = int(
            __import__("os").environ.get("ANDIX_JUMP_PASSES", "0")
        )
        jump_passes = min(jump_passes, max(1, (qb - 1).bit_length()))
        ecap = int(
            __import__("os").environ.get(
                "ANDIX_EVENT_CAP", str(max(1 << 16, qb // 2))
            )
        )
        unroll = int(
            __import__("os").environ.get("ANDIX_PROBE_UNROLL", "4")
        )
        # chase 4 measured iteration-neutral on the flat walk (diverged
        # stretches re-jump next step instead of chasing deeper) while
        # cutting its gather volume ~25% (sweep r4)
        chase = int(
            __import__("os").environ.get("ANDIX_JUMP_CHASE", "4")
        )

        t0 = time.time()
        mlun, ps = self._build_group_tables(
            ctx, sg, segs, starts, thresholds, jump_passes, want_jump=False
        )
        t0 = _prof(
            f"subject tables ({len(subject_genomes)} subj)", t0, mlun[0]
        )

        def prof_msg(msg):
            nonlocal t0
            t0 = _prof(msg, t0)

        def walk(arr, chunk_iters, maxev):
            lb = arr["row"].shape[0]
            out = chain_walk_flat(
                ctx.isa_d, ctx.rm, mlun, ps,
                jnp.asarray(arr["row"]), jnp.asarray(arr["qoff"]),
                jnp.asarray(arr["qs"]),
                jnp.asarray(arr["ss"]), jnp.asarray(arr["rl"]),
                jnp.asarray(arr["thr"]), jnp.asarray(arr["seg_end"]),
                jnp.asarray(arr["pos0"]), jnp.asarray(arr["lq0"]),
                jnp.asarray(arr["ls0"]), jnp.asarray(arr["ll0"]),
                jnp.int32(chunk_iters), jnp.int32(maxev),
                ecap, chase, unroll,
            )
            (ev_lane, ev_q, ev_s, ev_len, ev_cnt, ovf, iters,
             pos, lq, ls, ll, fin) = out
            meta = (
                jnp.zeros(lb, jnp.int32)
                .at[0].set(ev_cnt)
                .at[1].set(ovf.astype(jnp.int32))
                .at[2].set(iters)
            )
            state_h = np.asarray(jax.device_get(jnp.stack(
                [pos, lq, ls, ll, fin.astype(jnp.int32), meta]
            )))
            cnt = int(state_h[5, 0])
            ovf_h = bool(state_h[5, 1])
            iters_h = int(state_h[5, 2])
            if ovf_h:
                return (np.zeros((4, 0), np.int32), state_h[:4],
                        state_h[4].astype(bool), iters_h, True)
            k = min(bucket(max(cnt, 1), minimum=4096), ecap)
            ev = np.asarray(jax.device_get(jnp.stack(
                [ev_lane[:k], ev_q[:k], ev_s[:k], ev_len[:k]]
            )))[:, :cnt]
            return (ev, state_h[:4], state_h[4].astype(bool),
                    iters_h, False)

        prof = (
            prof_msg
            if __import__("os").environ.get("ANDIX_PROF_FILE")
            else None
        )
        res = segmented.segmented_group_anchors(
            walk, sg, gp, qb,
            starts, rs_lens, thresholds,
            ctx.q_base_h, ctx.q_start_h,
            q_len2d, seg_k, ecap, prof,
        )
        del mlun, ps
        if res is None:
            return None
        lanes, ev_q, ev_s, ev_len = res

        q_off_pad = np.full(gp + 1, ctx.q_off[-1], dtype=np.int64)
        q_off_pad[: len(ctx.q_off)] = ctx.q_off
        subjects_rs = [
            subjects[genome].rs for genome in subject_genomes
        ] + [None] * (sg - len(subject_genomes))
        counts_h = chain_events.group_counts_from_events(
            lanes, ev_q, ev_s, ev_len, sg, gp,
            subjects_rs, thresholds, ctx.query_blob, q_off_pad,
            model_kind, self.threads,
        )
        _prof(f"host count from {ev_q.shape[0]} events", t0)

        out: dict[int, dict[int, CountMatrix]] = {}
        for k2, genome in enumerate(subject_genomes):
            row = {}
            for g, qgenome in enumerate(ctx.q_genomes):
                if qgenome == genome:
                    continue
                seq_len = int(ctx.q_off[g + 1] - ctx.q_off[g])
                row[qgenome] = CountMatrix(counts_h[k2, g].copy(), seq_len)
            out[genome] = row
        return out

    def replay_group(self, n_block_subjects: int, qb: int) -> int:
        """Subjects per chain-walk dispatch.  The walk's sequential depth
        is ~independent of the lane count (every [Sg, G] op is
        latency-bound), so FEWER, WIDER dispatches are strictly better —
        bounded by the [Sg, QB] x3 int32 stats tables fitting device memory
        alongside the block residents.  Balanced across dispatches so one
        program shape serves them all (ANDIX_REPLAY_GROUP overrides)."""
        env = __import__("os").environ.get("ANDIX_REPLAY_GROUP")
        if env:
            return int(env)
        budget = int(device_mem_bytes() * 0.75)
        fit = max(1, budget // (12 * max(qb, 1)))
        if fit >= n_block_subjects:
            return max(1, n_block_subjects)
        k = -(-n_block_subjects // fit)
        return -(-n_block_subjects // k)

    def _group_tables(self, ctx, subject_genomes, subjects):
        """Shared [Sg]-padded subject tables for the grouped dispatches;
        rows pad to a multiple of 8 so dispatch shapes stay bucketed."""
        layout = ctx.layout
        sg = -(-max(len(subject_genomes), 1) // 8) * 8
        gp = ctx.q_start_d.shape[0]
        segs = np.full(sg, -1, dtype=np.int32)
        starts = np.zeros(sg, dtype=np.int32)
        rs_lens = np.ones(sg, dtype=np.int32)
        thresholds = np.full(sg, 2**29, dtype=np.int32)
        q_len2d = np.zeros((sg, gp), dtype=np.int32)
        q_len_row = np.asarray(ctx.q_len_h, dtype=np.int32)
        for k, genome in enumerate(subject_genomes):
            subj_seg, subj_start = self._subject_seg(layout, genome)
            segs[k] = subj_seg
            starts[k] = subj_start
            rs_lens[k] = subjects[genome].len
            thresholds[k] = subjects[genome].threshold
            q_len2d[k] = q_len_row
        return sg, gp, segs, starts, rs_lens, thresholds, q_len2d

    def _subject_group_counts_events(
        self, ctx, subject_genomes, subjects, model_kind
    ):
        """Anchor-event chain walk + host counting.  Returns None when the
        event buffer overflowed (caller falls back to the counting loop)."""
        import time

        from ..chain import events as chain_events
        from ..chain.replay_device import subject_group_anchors_device
        from ..model import CountMatrix

        sg, gp, segs, starts, rs_lens, thresholds, q_len2d = (
            self._group_tables(ctx, subject_genomes, subjects)
        )
        qb = ctx.tq_d.shape[0]
        jump_passes = int(
            __import__("os").environ.get("ANDIX_JUMP_PASSES", "0")
        )
        jump_passes = min(jump_passes, max(1, (qb - 1).bit_length()))
        ecap = int(
            __import__("os").environ.get(
                "ANDIX_EVENT_CAP", str(max(1 << 16, qb // 2))
            )
        )
        unroll = int(
            __import__("os").environ.get("ANDIX_PROBE_UNROLL", "4")
        )

        t0 = time.time()
        padded_n = ctx.sa_d.shape[0]
        split_min = int(
            __import__("os").environ.get(
                "ANDIX_SPLIT_TABLES_MIN", str(1 << 25)
            )
        )
        if padded_n >= split_min:
            # big blocks: the fused tables+walk program's [Sg, N] scan
            # intermediates outgrow device memory — build each subject's
            # tables as its own program and run the chain walk separately
            from ..chain.replay_device import (
                chain_anchors_device, single_subject_tables,
            )

            # accumulate rows into DONATED buffers — a jnp.stack of all
            # rows holds sources + copy simultaneously (2x the tables,
            # OOMed at n=22)
            qb_len = ctx.tq_d.shape[0]
            mlun = jnp.zeros((sg, qb_len), jnp.int32)
            ps = jnp.zeros((sg, qb_len), jnp.int32)
            jump = jnp.zeros((sg, qb_len), jnp.int32)
            # padding rows (segs[k] == -1) stay all-zero: their lanes have
            # q_len2d == 0 and never probe, and each dispatch is [1, N]
            # shaped, so skipping them adds no program-shape diversity
            for k in range(len(subject_genomes)):
                r = single_subject_tables(
                    ctx.sa_d, ctx.lcp_d, ctx.segid_d, ctx.tq_d,
                    jnp.int32(segs[k]), jnp.int32(starts[k]),
                    jnp.int32(thresholds[k]), jump_passes,
                )
                mlun = _acc_row(mlun, r[0], k)
                ps = _acc_row(ps, r[1], k)
                jump = _acc_row(jump, r[2], k)
                del r
            ev_lane, ev_q, ev_s, ev_len, ev_cnt, ovf, iters = (
                chain_anchors_device(
                    ctx.isa_d, ctx.rm, mlun, ps, jump,
                    jnp.asarray(starts), jnp.asarray(rs_lens),
                    jnp.asarray(thresholds),
                    ctx.q_base_d, ctx.q_start_d, jnp.asarray(q_len2d),
                    ecap, unroll=unroll,
                )
            )
            del mlun, ps, jump
        else:
            ev_lane, ev_q, ev_s, ev_len, ev_cnt, ovf, iters = (
                subject_group_anchors_device(
                    ctx.sa_d, ctx.lcp_d, ctx.segid_d, ctx.tq_d,
                    ctx.isa_d, ctx.rm,
                    jnp.asarray(segs), jnp.asarray(starts),
                    jnp.asarray(rs_lens), jnp.asarray(thresholds),
                    ctx.q_base_d, ctx.q_start_d, jnp.asarray(q_len2d),
                    jump_passes, ecap, unroll,
                )
            )
        cnt, ovf_h, it_h = (
            int(v) for v in np.asarray(
                jax.device_get(jnp.stack([ev_cnt, ovf.astype(jnp.int32),
                                          iters]))
            )
        )
        if ovf_h:
            return None
        k = bucket(max(cnt, 1), minimum=4096)
        k = min(k, ecap)
        ev = np.asarray(jax.device_get(
            jnp.stack([ev_lane[:k], ev_q[:k], ev_s[:k], ev_len[:k]])
        ))[:, :cnt]
        t0 = _prof(
            f"anchor chain dispatch ({len(subject_genomes)} subj, "
            f"{it_h} loop iters, {cnt} events)", t0,
        )

        q_off_pad = np.full(gp + 1, ctx.q_off[-1], dtype=np.int64)
        q_off_pad[: len(ctx.q_off)] = ctx.q_off
        subjects_rs = [
            subjects[genome].rs for genome in subject_genomes
        ] + [None] * (sg - len(subject_genomes))
        counts_h = chain_events.group_counts_from_events(
            ev[0], ev[1], ev[2], ev[3], sg, gp,
            subjects_rs, thresholds, ctx.query_blob, q_off_pad,
            model_kind, self.threads,
        )
        _prof(f"host count from {cnt} events", t0)

        out: dict[int, dict[int, CountMatrix]] = {}
        for k2, genome in enumerate(subject_genomes):
            row = {}
            for g, qgenome in enumerate(ctx.q_genomes):
                if qgenome == genome:
                    continue
                seq_len = int(ctx.q_off[g + 1] - ctx.q_off[g])
                row[qgenome] = CountMatrix(counts_h[k2, g].copy(), seq_len)
            out[genome] = row
        return out

    def _subject_group_counts_loop(
        self,
        ctx: BlockContext,
        subject_genomes: list[int],
        subjects: dict[int, "object"],
        model_kind,
    ) -> dict[int, dict[int, "object"]]:
        """Count-in-loop device path (fallback / A-B reference)."""
        from ..chain.replay_device import subject_group_counts_device
        from ..model import CountMatrix

        layout = ctx.layout
        group = int(
            __import__("os").environ.get("ANDIX_REPLAY_GROUP", "8")
        )
        sg = max(group, len(subject_genomes))
        qb = ctx.tq_d.shape[0]
        gp = ctx.q_start_d.shape[0]
        # partial resolution is still correct (the replay just jumps again
        # and chases in-loop); each pass costs two full-size gathers per
        # subject, while chase hops are [Sg, G]-sized — so default to 0
        jump_passes = int(
            __import__("os").environ.get("ANDIX_JUMP_PASSES", "0")
        )
        jump_passes = min(jump_passes, max(1, (qb - 1).bit_length()))

        segs = np.full(sg, -1, dtype=np.int32)
        starts = np.zeros(sg, dtype=np.int32)
        rs_lens = np.ones(sg, dtype=np.int32)
        thresholds = np.full(sg, 2**29, dtype=np.int32)
        q_len2d = np.zeros((sg, gp), dtype=np.int32)
        q_len_row = np.asarray(ctx.q_len_h, dtype=np.int32)
        for k, genome in enumerate(subject_genomes):
            subj_seg, subj_start = self._subject_seg(layout, genome)
            segs[k] = subj_seg
            starts[k] = subj_start
            rs_lens[k] = subjects[genome].len
            thresholds[k] = subjects[genome].threshold
            q_len2d[k] = q_len_row

        exact = model_kind in (Model.LOGDET, Model.ANI)
        import time

        if ctx.text_d is None:
            # events-mode block context dropped the device text; the loop
            # fallback rebuilds it from the layout (rare: event overflow)
            ctx.text_d = device_text(ctx.layout, ctx.sa_d.shape[0])
        t0 = time.time()
        counts, iters = subject_group_counts_device(
            ctx.sa_d, ctx.lcp_d, ctx.segid_d, ctx.tq_d,
            ctx.text_d, ctx.isa_d, ctx.rm,
            jnp.asarray(segs), jnp.asarray(starts),
            jnp.asarray(rs_lens), jnp.asarray(thresholds),
            ctx.q_base_d, ctx.q_start_d, jnp.asarray(q_len2d),
            jump_passes, exact,
        )
        counts_h = np.asarray(jax.device_get(counts), dtype=np.int64)
        if __import__("os").environ.get("ANDIX_PROF_FILE"):
            _prof(
                f"matchstats+replay dispatch ({len(subject_genomes)} subj, "
                f"{int(np.asarray(jax.device_get(iters)))} loop iters)",
                t0,
            )

        out: dict[int, dict[int, CountMatrix]] = {}
        for k, genome in enumerate(subject_genomes):
            row = {}
            for g, qgenome in enumerate(ctx.q_genomes):
                if qgenome == genome:
                    continue
                seq_len = int(ctx.q_off[g + 1] - ctx.q_off[g])
                row[qgenome] = CountMatrix(counts_h[k, g].copy(), seq_len)
            out[genome] = row
        return out

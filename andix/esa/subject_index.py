"""Per-subject suffix-array index for the subject-only match path.

The joint-SA pipeline sorts every query string into each block's suffix
array — at family scale that re-sorts ~2/3 of the text once per query
chunk, the largest phase of a 29-genome run.  The reference
never does this: it builds ONE index per subject and streams queries
through ``get_match`` against the static index
(/root/reference/src/esa.c:254-277 construction, :531-624 matching; one
``esa_init`` per subject, src/dist_hack.h:64).  This module is the
device equivalent: per subject a device-built SA + adjacent LCP over
``RS_i`` alone, plus two structures that make a *batched binary search*
the per-probe primitive of the chain walk (``andix.chain.walk_sx``):

* **Order-preserving 4-bit symbol codes packed 16 per int64 word**
  (big-endian), so one word gather pair compares 16 symbols and the
  comparison DIRECTION (needed by the bisection, unlike the LCP-only
  compares in ``plcp``) falls out of the first differing nibble.  Codes:
  query sentinel 0 < ``!`` 1 < ``#`` 2 < ``;`` 3 < A 4 < C 5 < G 6 < T 7
  < segment separator 8 < padding 9 — the same total order as the int32
  symbols the SA was sorted on, so integer nibble compares agree with SA
  order.  Queries contain only {ACGT, !, sentinel}; subjects only
  {bytes, separator, padding}; the two alphabets share exactly the real
  bytes, so equal nibbles imply equal symbols in every query-vs-subject
  compare and a compare can never run past a query end (sentinel) or a
  subject end (separator/padding) — no masking, no length caps.

* **An exact k-mer insertion-point cache** ``cache[c] = number of subject
  suffixes lexicographically below the ACGT k-mer c`` (+ a final entry
  ``cache[4^k] = n_real``).  ``[cache[c], cache[c+1]]`` brackets the
  insertion point of any query suffix whose first k symbols are the ACGT
  k-mer ``c`` (suffixes inside the bracket may still contain separators —
  the bisection handles them; suffixes outside are strictly smaller /
  larger than the query by the k-prefix alone).  This is the
  binary-search analogue of the reference's 10-mer LCP-interval cache
  (src/esa.c:73-215, "up to 7x speedup"): the bracket is typically a
  handful of entries, so the per-probe bisection is 1-3 steps instead of
  ~24.  Built WITHOUT any sorted search: the rank of a suffix among ACGT
  k-mers is a mixed-radix sum over its first k symbols (truncated at the
  first non-ACGT symbol, which decides the comparison against every
  k-mer), counted with one histogram + cumsum over the 2*4^k rank space.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np

from .joint import SEPARATOR_BASE

PAD_BASE = 1 << 20  # device_text / pad_symbols padding threshold

# byte -> order code (0 reserved for the query-end sentinel)
_BYTE_CODES = ((33, 1), (35, 2), (59, 3), (65, 4), (67, 5), (71, 6), (84, 7))
SEP_CODE = 8
PAD_CODE = 9


def _byte_lut() -> np.ndarray:
    lut = np.zeros(256, dtype=np.int32)
    for b, c in _BYTE_CODES:
        lut[b] = c
    return lut


_LUT = _byte_lut()


# ---------------------------------------------------------------------------
# NumPy reference implementation (oracle for the device kernel; also the
# host backend used by tests).
# ---------------------------------------------------------------------------


def order_codes_np(sym: np.ndarray) -> np.ndarray:
    """int32 symbols -> 4-bit order codes (see module docstring)."""
    sym = np.asarray(sym)
    c = np.where(
        sym >= PAD_BASE,
        PAD_CODE,
        np.where(sym >= SEPARATOR_BASE, SEP_CODE, _LUT[np.clip(sym, 0, 255)]),
    ).astype(np.int32)
    return c


def pack_words_np(codes: np.ndarray) -> np.ndarray:
    """4-bit codes -> int64 words of 16 codes, big-endian; length must be a
    multiple of 16."""
    assert len(codes) % 16 == 0
    q = codes.reshape(-1, 16).astype(np.int64)
    w = np.zeros(len(q), dtype=np.int64)
    for j in range(16):
        w |= q[:, j] << (4 * (15 - j))
    return w


@dataclasses.dataclass
class SubjectIndexNp:
    """One subject's search structures (host arrays)."""

    sa: np.ndarray  # int32[n_real] suffix array of RS + separator
    lcp: np.ndarray  # int32[n_real] adjacent LCP (lcp[0] = 0)
    codes: np.ndarray  # int32[n_real] order codes of the text
    n_real: int
    rs_len: int  # len(RS) = n_real - 1
    cache: np.ndarray | None = None  # int32[4^k + 1]
    cache_k: int = 0


def build_subject_index_np(rs: np.ndarray, cache_k: int = 0) -> SubjectIndexNp:
    """Host build: RS bytes -> (SA, LCP, codes[, cache]) over RS + one
    separator symbol."""
    from . import sa_numpy

    sym = np.concatenate(
        [np.asarray(rs, dtype=np.int32), [np.int32(SEPARATOR_BASE)]]
    )
    sa = sa_numpy.suffix_array(sym).astype(np.int32)
    lcp = sa_numpy.lcp_array(sym, sa).astype(np.int32)
    codes = order_codes_np(sym)
    idx = SubjectIndexNp(
        sa=sa, lcp=lcp, codes=codes, n_real=len(sym), rs_len=len(rs)
    )
    if cache_k:
        idx.cache = build_cache_np(sym, cache_k)
        idx.cache_k = cache_k
    return idx


def suffix_rank2(codes: np.ndarray, k: int) -> np.ndarray:
    """R2 rank of every suffix among ACGT k-mers: 2*R for suffixes whose
    k-prefix is itself an ACGT k-mer R, 2*R - 1 for mixed suffixes that
    sort between k-mers R-1 and R.  Vectorized mixed-radix accumulation
    truncated at the first non-ACGT symbol."""
    n = len(codes)
    c = np.concatenate([codes, np.full(k, PAD_CODE, np.int32)])
    R = np.zeros(n, dtype=np.int64)
    stopped = np.zeros(n, dtype=bool)
    for j in range(k):
        cj = c[j : j + n]
        f = np.clip(cj - 4, 0, 4).astype(np.int64)  # ACGT letters below cj
        R += np.where(stopped, 0, f << (2 * (k - 1 - j)))
        stopped |= (cj < 4) | (cj > 7)
    return 2 * R - stopped.astype(np.int64)


def build_cache_np(sym: np.ndarray, k: int) -> np.ndarray:
    """cache[c] = #suffixes < ACGT k-mer c (c in [0, 4^k)); cache[4^k] =
    n_real.  Shift ranks by +1 so mixed suffixes below every k-mer
    (R2 = -1: leading ``!``/``#``/``;``) land in a countable bin."""
    codes = order_codes_np(sym)
    r2s = suffix_rank2(codes, k) + 1  # in [0, 2*4^k]
    nk = 1 << (2 * k)
    hist = np.bincount(r2s, minlength=2 * nk + 1)
    cum = np.cumsum(hist)
    cache = np.zeros(nk + 1, dtype=np.int32)
    cache[:nk] = cum[0 : 2 * nk - 1 : 2]  # #{r2s <= 2c} = #{r2 < 2c}
    cache[nk] = len(sym)
    return cache


def _cmp_suffix_np(
    idx: SubjectIndexNp, qcodes: np.ndarray, qpos: int, spos: int, start: int
) -> tuple[int, bool]:
    """(lcp, q_less) of query suffix qpos vs subject suffix spos, starting
    the compare ``start`` symbols in.  qcodes must end with >= 1 sentinel
    (code 0)."""
    h = start
    nq = len(qcodes)
    ns = idx.n_real
    while True:
        qc = qcodes[qpos + h] if qpos + h < nq else 0
        sc = idx.codes[spos + h] if spos + h < ns else PAD_CODE
        if qc != sc:
            return h, qc < sc
        h += 1


def search_np(
    idx: SubjectIndexNp, qcodes: np.ndarray, qpos: int
) -> tuple[int, bool, int]:
    """(matchlen, unique, pos_s) of the query suffix at ``qpos`` against
    the subject — the reference ``get_match`` result
    (src/esa.c:614-624; uniqueness = interval i == j, src/process.c:118).
    Must agree exactly with ``matchstats_np.match_stats_sa_order``."""
    n = idx.n_real
    lo, hi = 0, n
    l_lo = l_hi = 0
    if idx.cache is not None:
        k = idx.cache_k
        win = qcodes[qpos : qpos + k]
        if len(win) == k and np.all((win >= 4) & (win <= 7)):
            code = 0
            for c in win:
                code = (code << 2) | int(c - 4)
            lo, hi = int(idx.cache[code]), int(idx.cache[code + 1])
    while lo < hi:
        mid = (lo + hi) >> 1
        off = min(l_lo, l_hi)
        lcp_m, q_less = _cmp_suffix_np(
            idx, qcodes, qpos, int(idx.sa[mid]), off
        )
        if q_less:
            hi, l_hi = mid, lcp_m
        else:
            lo, l_lo = mid + 1, lcp_m
    ip = lo
    a = b = -1
    if ip > 0:
        a, _ = _cmp_suffix_np(idx, qcodes, qpos, int(idx.sa[ip - 1]), l_lo)
    if ip < n:
        b, _ = _cmp_suffix_np(idx, qcodes, qpos, int(idx.sa[ip]), l_hi)
    ml = max(a, b, 0)
    if ml == 0 or a == b:
        unique = False
    elif a > b:
        unique = ip < 2 or int(idx.lcp[ip - 1]) < a
    else:
        unique = ip + 1 >= n or int(idx.lcp[ip + 1]) < b
    pos_s = int(idx.sa[ip - 1]) if a >= b else int(idx.sa[ip])
    return ml, unique, pos_s


def query_codes_np(query: np.ndarray) -> np.ndarray:
    """Query bytes -> order codes + one trailing sentinel."""
    q = np.concatenate(
        [np.asarray(query, dtype=np.int32), [np.int32(0)]]
    )
    return order_codes_np(q)


# ---------------------------------------------------------------------------
# Device build (JAX)
# ---------------------------------------------------------------------------


def _jnp():
    import jax.numpy as jnp

    return jnp


def device_order_codes(sym):
    """int32 symbols -> order codes, on device."""
    jnp = _jnp()
    lut = jnp.asarray(_LUT)
    return jnp.where(
        sym >= PAD_BASE,
        jnp.int32(PAD_CODE),
        jnp.where(
            sym >= SEPARATOR_BASE,
            jnp.int32(SEP_CODE),
            lut[jnp.clip(sym, 0, 255)],
        ),
    )


def _device_pack_words(codes):
    """4-bit codes -> big-endian int64 16-code words (build-time reshape —
    a one-off physical copy, never inside a loop)."""
    jnp = _jnp()
    q = codes.astype(jnp.int64).reshape(-1, 16)
    w = jnp.zeros(q.shape[0], jnp.int64)
    for j in range(16):
        w = w | (q[:, j] << (4 * (15 - j)))
    return w


def device_pack_words(sym):
    import jax

    return jax.jit(
        lambda s: _device_pack_words(device_order_codes(s))
    )(sym)


def device_pack_words_u8(u8):
    """Pack from uint8 bytes (queries: no separators/padding symbols) —
    the H2D payload stays 1 byte/symbol."""
    import jax

    return jax.jit(
        lambda b: _device_pack_words(
            device_order_codes(b.astype(_jnp().int32))
        )
    )(u8)


@functools.lru_cache(maxsize=None)
def _cache_build_fn(k: int):
    import jax
    import jax.numpy as jnp

    nk = 1 << (2 * k)

    @jax.jit
    def build(codes, n_real):
        n = codes.shape[0]
        cpad = jnp.concatenate(
            [codes, jnp.full(k, PAD_CODE, jnp.int32)]
        )
        R = jnp.zeros(n, jnp.int64)
        stopped = jnp.zeros(n, bool)
        for j in range(k):
            cj = jax.lax.dynamic_slice(cpad, (j,), (n,))
            f = jnp.clip(cj - 4, 0, 4).astype(jnp.int64)
            R = R + jnp.where(stopped, 0, f << (2 * (k - 1 - j)))
            stopped = stopped | (cj < 4) | (cj > 7)
        # +1 shift: mixed suffixes below every k-mer (R2 = -1) land in
        # bin 0; padding suffixes park on the top bin 2*nk, which no
        # cache entry reads (read indices are even, <= 2*nk - 2)
        r2s = jnp.where(
            jnp.arange(n) < n_real,
            jnp.clip(2 * R - stopped.astype(jnp.int64) + 1, 0, 2 * nk - 1),
            2 * nk,
        )
        hist = jnp.zeros(2 * nk + 1, jnp.int32).at[r2s].add(1)
        cum = jnp.cumsum(hist)
        cache = jnp.zeros(nk + 1, jnp.int32)
        cache = cache.at[:nk].set(cum[0 : 2 * nk - 1 : 2])
        cache = cache.at[nk].set(n_real)
        return cache

    return build


def build_cache_device(codes, n_real, k: int):
    return _cache_build_fn(k)(codes, n_real)


@functools.lru_cache(maxsize=None)
def _fused_build_fn(length: int, cache_k: int, lcp_mode: str,
                    base_width: int, max_levels: int):
    """One traced program per (shape, config): SA + LCP + packed words +
    k-mer cache in a SINGLE dispatch instead of ~8 per subject."""
    import jax

    from . import doubling

    thr0 = int(length * doubling._BUCKET_FRAC)
    tiers = doubling._tail_tiers(length, thr0)
    L = doubling.levels_needed(length, True, base_width)
    if lcp_mode == "hybrid":
        L = min(L, 14)
    L = max(1, min(L, max_levels))

    @jax.jit
    def build(sym, n_real):
        sa, lcp, ovf = doubling._sa_lcp_core(
            sym, packed=True, L=L, thr0=thr0, tiers=tiers,
            want_lcp=True, lcp_mode=lcp_mode, base=base_width,
        )
        codes = device_order_codes(sym)
        words = _device_pack_words(codes)
        cache = _cache_build_fn(cache_k)(codes, n_real)
        return sa, lcp, ovf, words, cache

    return build


def fused_build(sym, n_real, cache_k: int, lcp_mode: str,
                base_width: int, max_levels: int):
    fn = _fused_build_fn(
        int(sym.shape[0]), cache_k, lcp_mode, base_width, int(max_levels)
    )
    return fn(sym, n_real)


@functools.lru_cache(maxsize=None)
def _acc_idx_fn():
    import jax
    import jax.numpy as jnp

    @functools.partial(jax.jit, donate_argnums=(0, 1, 2))
    def acc(salcp, sw, cache2, sa, lcp, w, c, k):
        z = jnp.zeros((), k.dtype)
        salcp = jax.lax.dynamic_update_slice(
            salcp, jnp.stack([sa, lcp])[None], (k, z, z)
        )
        sw = jax.lax.dynamic_update_index_in_dim(sw, w, k, 0)
        cache2 = jax.lax.dynamic_update_index_in_dim(cache2, c, k, 0)
        return salcp, sw, cache2

    return acc


def acc_idx(salcp, sw, cache2, sa, lcp, w, c, k):
    """One donated-buffer dispatch writing the stacked SA+LCP row pair,
    word row, and cache row."""
    return _acc_idx_fn()(salcp, sw, cache2, sa, lcp, w, c, k)


def pick_cache_k(max_len: int, n_subjects: int, budget_bytes: int) -> int:
    """k-mer depth: deep enough that the average bracket is below ONE
    entry (4^k up to 16x the subject length — most probes then resolve
    with zero or one bisect step, which prices the latency-bound walk),
    shallow enough that all subjects' caches fit the budget."""
    k = 4
    while k < 12 and (1 << (2 * (k + 1))) <= max_len * 16:
        k += 1
    while k > 4 and n_subjects * ((1 << (2 * k)) + 1) * 4 > budget_bytes:
        k -= 1
    return k

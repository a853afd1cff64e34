"""NumPy prefix-doubling suffix array + Kasai LCP (host reference backend).

This is the host-side mirror of the device doubling kernel
(``andix.esa.doubling``): identical algorithm, used as the correctness oracle
and as the CPU fallback.  Replaces libdivsufsort (reference ``esa_init_SA``,
src/esa.c:294-304) — O(n log n) rank sorts instead of induced sorting, because
sorts are the primitive that scales on an accelerator.
"""

from __future__ import annotations

import numpy as np


def suffix_array(sym: np.ndarray) -> np.ndarray:
    """Suffix array by prefix doubling (Manber–Myers style with lexsort)."""
    sym = np.asarray(sym)
    n = len(sym)
    if n == 0:
        return np.zeros(0, dtype=np.int32)

    # initial ranks from single symbols
    order = np.argsort(sym, kind="stable").astype(np.int64)
    sorted_sym = sym[order]
    rank_sorted = np.zeros(n, dtype=np.int64)
    rank_sorted[1:] = np.cumsum(sorted_sym[1:] != sorted_sym[:-1])
    rank = np.empty(n, dtype=np.int64)
    rank[order] = rank_sorted

    k = 1
    while rank_sorted[-1] != n - 1:
        # second key: rank of suffix k positions later, -1 past the end
        key2 = np.full(n, -1, dtype=np.int64)
        key2[: n - k] = rank[k:]
        order = np.lexsort((key2, rank))
        r1 = rank[order]
        r2 = key2[order]
        changed = np.zeros(n, dtype=np.int64)
        changed[1:] = (r1[1:] != r1[:-1]) | (r2[1:] != r2[:-1])
        rank_sorted = np.cumsum(changed)
        rank[order] = rank_sorted
        k *= 2

    sa = np.empty(n, dtype=np.int64)
    sa[rank] = np.arange(n)
    return sa.astype(np.int32)


def lcp_array(sym: np.ndarray, sa: np.ndarray) -> np.ndarray:
    """Adjacent LCP: ``lcp[t] = lcp(suffix(sa[t-1]), suffix(sa[t]))``,
    ``lcp[0] = 0``.

    Kasai-style via the rank (inverse SA) walk; pure Python loop — only for
    small inputs and as oracle.  Production uses the native Φ-array
    implementation (reference algorithm family: ``esa_init_LCP``,
    src/esa.c:373-426).
    """
    sym = np.asarray(sym)
    n = len(sym)
    lcp = np.zeros(n, dtype=np.int32)
    if n == 0:
        return lcp
    rank = np.empty(n, dtype=np.int64)
    rank[np.asarray(sa, dtype=np.int64)] = np.arange(n)
    h = 0
    for i in range(n):
        r = rank[i]
        if r > 0:
            j = int(sa[r - 1])
            while i + h < n and j + h < n and sym[i + h] == sym[j + h]:
                h += 1
            lcp[r] = h
            if h > 0:
                h -= 1
        else:
            h = 0
    return lcp

"""Device range-minimum structure over the adjacent-LCP array.

Powers O(1) longest-common-extension (LCE) queries on device:
``lce(a, b) = min LCP[(min(ISA[a],ISA[b]), max(ISA[a],ISA[b])]]`` — the
device equivalent of the reference's byte-compare ``lcp()``
(src/process.c:59-65) used by lucky anchors, without data-dependent loops.

Three-level layout (all int32, ~0.6 bytes/element beyond LCP itself):

* fine blocks of 8: per-element prefix/suffix mins; same-block queries use
  an unrolled masked 8-min,
* sparse table over fine-block mins for spans up to 64 fine blocks
  (7 levels),
* groups of 64 fine blocks (=512 elements): per-fine-block prefix/suffix
  mins within the group + a full sparse table over group mins.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp

INF = jnp.int32(2**31 - 1)

FINE = 8  # elements per fine block
GROUP = 64  # fine blocks per group (512 elements)


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class RangeMin:
    values: jax.Array  # int32[Np] padded with INF
    pref8: jax.Array  # int32[Np] min over [fine_start..t]
    suff8: jax.Array  # int32[Np] min over [t..fine_end]
    t8: jax.Array  # int32[7, nf] sparse table over fine mins, levels 0..6
    prefg: jax.Array  # int32[nf] min over fine mins [group_start..c]
    suffg: jax.Array  # int32[nf] min over fine mins [c..group_end]
    tg: jax.Array  # int32[Lg, ng] full sparse table over group mins
    # element spans 1/2/4 for same-fine-block queries; None at huge
    # blocks (12 B/symbol of device memory) — those fall back to the unrolled
    # masked 8-way min over ``values``
    tsm: "jax.Array | None"

    def tree_flatten(self):
        return (
            (self.values, self.pref8, self.suff8, self.t8, self.prefg,
             self.suffg, self.tg, self.tsm),
            None,
        )

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)


def _pad_to(x, m, fill):
    pad = (-len(x)) % m
    if pad:
        x = jnp.concatenate([x, jnp.full(pad, fill, x.dtype)])
    return x


@functools.partial(jax.jit, static_argnames=("small_spans",))
def build(values: jax.Array, small_spans: bool = True) -> RangeMin:
    v = _pad_to(values.astype(jnp.int32), FINE * GROUP, INF)
    npad = v.shape[0]
    nf = npad // FINE
    ng = nf // GROUP

    v2 = v.reshape(nf, FINE)
    pref8 = jax.lax.cummin(v2, axis=1).reshape(-1)
    suff8 = jax.lax.cummin(v2[:, ::-1], axis=1)[:, ::-1].reshape(-1)
    fmin = v2.min(axis=1)

    # sparse table over fine mins, spans 1..64 fine blocks
    levels = [fmin]
    for k in range(1, 7):
        prev = levels[-1]
        w = 1 << (k - 1)
        shifted = jnp.concatenate([prev[w:], jnp.full(w, INF)])
        levels.append(jnp.minimum(prev, shifted))
    t8 = jnp.stack(levels)

    g2 = fmin.reshape(ng, GROUP)
    prefg = jax.lax.cummin(g2, axis=1).reshape(-1)
    suffg = jax.lax.cummin(g2[:, ::-1], axis=1)[:, ::-1].reshape(-1)
    gmin = g2.min(axis=1)

    glevels = [gmin]
    span = 1
    while span < ng:
        prev = glevels[-1]
        shifted = jnp.concatenate([prev[span:], jnp.full(span, INF)])
        glevels.append(jnp.minimum(prev, shifted))
        span *= 2
    tg = jnp.stack(glevels)

    # element-level spans 1/2/4: a same-fine-block query [lo..hi]
    # (span <= 8) is min(tsm[k][lo], tsm[k][hi-2^k+1]) with
    # k = min(ilog2(span), 2) — two gathers instead of an unrolled
    # eight-way masked min (the replay's LCE calls this per iteration)
    if small_spans:
        e2 = jnp.minimum(v, jnp.concatenate([v[1:], jnp.full(1, INF)]))
        e4 = jnp.minimum(e2, jnp.concatenate([e2[2:], jnp.full(2, INF)]))
        tsm = jnp.stack([v, e2, e4])
    else:
        tsm = None

    return RangeMin(v, pref8, suff8, t8, prefg, suffg, tg, tsm)


def _ilog2(x):
    return jnp.int32(31) - jax.lax.clz(jnp.maximum(x, 1).astype(jnp.int32))


def range_min(rm: RangeMin, lo, hi):
    """min(values[lo..hi]) inclusive; INF when lo > hi.  Vectorized over
    any batch shape of (lo, hi).

    The replay's LCE calls this inside a while_loop where each gather costs
    a few microseconds of latency and gathers do not overlap — so the two
    sub-paths a batch usually does not need (same-fine-block queries, and
    group spans beyond 64 fine blocks) are gated behind scalar ``lax.cond``
    and skipped entirely when no element takes them."""
    lo = jnp.asarray(lo, jnp.int32)
    hi = jnp.asarray(hi, jnp.int32)
    empty = lo > hi
    los = jnp.where(empty, 0, lo)
    his = jnp.where(empty, 0, hi)

    f1 = los // FINE
    f2 = his // FINE
    is_same = f1 == f2

    # same fine block: two overlapping element-span windows, or — when
    # the tsm rows were dropped to save device memory — an unrolled
    # masked 8-min
    def same_path():
        if rm.tsm is None:
            out = rm.values[los]
            for d in range(1, FINE):
                idx = jnp.minimum(los + d, his)
                out = jnp.minimum(out, rm.values[idx])
            return out
        sspan = his - los + 1
        ks = jnp.minimum(_ilog2(sspan), 2)
        ws = (1 << ks).astype(jnp.int32)
        return jnp.minimum(
            rm.tsm[ks, los], rm.tsm[ks, jnp.maximum(his - ws + 1, 0)]
        )

    same = jax.lax.cond(
        jnp.any(is_same & ~empty),
        same_path,
        lambda: jnp.broadcast_to(INF, los.shape),
    )

    # straddling: edges + fine-block mid range [c1, c2]
    edge = jnp.minimum(rm.suff8[los], rm.pref8[his])
    c1 = f1 + 1
    c2 = f2 - 1
    has_mid = c2 >= c1
    c1s = jnp.where(has_mid, c1, 0)
    c2s = jnp.where(has_mid, c2, 0)
    span = c2s - c1s + 1

    # span <= 64: two overlapping windows in t8
    k8 = jnp.minimum(_ilog2(span), 6)
    w8 = (1 << k8).astype(jnp.int32)
    mid_small = jnp.minimum(rm.t8[k8, c1s], rm.t8[k8, c2s - w8 + 1])

    # span > 64: group decomposition
    big = has_mid & (span > 64)

    def big_path():
        g1 = c1s // GROUP
        g2 = c2s // GROUP
        gedge = jnp.minimum(rm.suffg[c1s], rm.prefg[c2s])
        h1 = g1 + 1
        h2 = g2 - 1
        has_gm = h2 >= h1
        h1s = jnp.where(has_gm, h1, 0)
        h2s = jnp.where(has_gm, h2, 0)
        gspan = h2s - h1s + 1
        kg = jnp.minimum(_ilog2(gspan), jnp.int32(rm.tg.shape[0] - 1))
        wg = (1 << kg).astype(jnp.int32)
        gmid = jnp.minimum(rm.tg[kg, h1s], rm.tg[kg, h2s - wg + 1])
        return jnp.minimum(gedge, jnp.where(has_gm, gmid, INF))

    mid_big = jax.lax.cond(
        jnp.any(big), big_path, lambda: jnp.broadcast_to(INF, los.shape)
    )

    mid = jnp.where(span <= 64, mid_small, mid_big)
    mid = jnp.where(has_mid, mid, INF)

    out = jnp.where(is_same, same, jnp.minimum(edge, mid))
    return jnp.where(empty, INF, out)

"""Device-side scan primitives for matching statistics.

``segmented_min_scan``: inclusive min-scan with resets, evaluated two-level —
an in-chunk ``lax.scan`` vectorized across chunks (O(N) work, ``chunk``
sequential steps) plus a ``lax.associative_scan`` over the (few) chunk
carries.  This is the device analogue of
``andix.esa.matchstats_np.segmented_min_scan``; a plain
``lax.associative_scan`` over all N elements would do O(N log N) work and
memory traffic, which dominates at genome scale.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

INF32 = jnp.int32(2**31 - 1)


def _fs_combine(a, b):
    """Window-composition monoid for flag scans.

    State fields (k, pre, g, sa, suf): number of flags (capped at 2), min of
    values before the first flag, value-gap recorded at the last flag, sa
    payload of the last flag, min of values after the last flag.  Identity:
    (0, INF, INF, -1, INF)."""
    k1, p1, g1, s1, f1 = a
    k2, p2, g2, s2, f2 = b
    k = jnp.minimum(k1 + k2, 2)
    has1 = k1 > 0
    has2 = k2 > 0
    pre = jnp.where(has1, p1, jnp.minimum(p1, p2))
    sa_ = jnp.where(has2, s2, s1)
    bridge = jnp.minimum(f1, p2)
    g = jnp.where(
        has2,
        jnp.where(k2 >= 2, g2, jnp.where(has1, bridge, INF32)),
        g1,
    )
    suf = jnp.where(has2, f2, jnp.where(has1, bridge, INF32))
    return (k, pre, g, sa_, suf)


@functools.partial(jax.jit, static_argnames=("chunk",))
def flag_scan(values: jax.Array, flags: jax.Array, sa_vals: jax.Array,
              chunk: int = 1024):
    """Inclusive scan of the flag-window monoid: per position returns

    * ``k``   — number of flagged entries seen so far (capped at 2),
    * ``g``   — min of values in (second-last flag, last flag] (the LCP
      between the two nearest flagged suffixes),
    * ``sa``  — payload (suffix position) of the last flagged entry,
    * ``suf`` — min of values in (last flag, here] (the LCP to the nearest
      flagged suffix).

    Flagged elements contribute their value to the gap ending at them and
    then reset the running min.  This carries everything the matching
    statistics need in one contiguous pass — no random gathers.  Both
    evaluations are two-level (in-chunk scans, then an associative scan
    over chunk carries); the GPU lowering runs the in-chunk scans as a
    Pallas kernel through Triton (``_flag_scan_triton``), every other
    platform the XLA ``lax.scan`` (``_flag_scan_xla``).  Outputs are
    identical."""
    return jax.lax.platform_dependent(
        values, flags, sa_vals,
        cuda=functools.partial(_flag_scan_triton, chunk=chunk),
        default=functools.partial(_flag_scan_xla, chunk=chunk),
    )


def _flag_scan_xla(values: jax.Array, flags: jax.Array, sa_vals: jax.Array,
                   chunk: int = 1024):
    """``flag_scan`` with the in-chunk scan as one ``lax.scan`` over the
    chunk offset, vectorized across chunks."""
    n = values.shape[0]
    nb = -(-n // chunk)
    pad = nb * chunk - n
    v = jnp.concatenate([values.astype(jnp.int32), jnp.full(pad, INF32)])
    fl = jnp.concatenate([flags.astype(bool), jnp.zeros(pad, dtype=bool)])
    sv = jnp.concatenate(
        [sa_vals.astype(jnp.int32), jnp.full(pad, jnp.int32(-1))]
    )

    def t2(x):
        return x.reshape(nb, chunk).T  # (chunk, nb)

    k_e = t2(fl.astype(jnp.int32))
    pre_e = t2(v)
    sa_e = t2(jnp.where(fl, sv, -1))
    g_e = jnp.full((chunk, nb), INF32)
    suf_e = jnp.full((chunk, nb), INF32)

    def step(carry, x):
        out = _fs_combine(carry, x)
        return out, out

    ident = (
        jnp.zeros(nb, jnp.int32),
        jnp.full(nb, INF32),
        jnp.full(nb, INF32),
        jnp.full(nb, jnp.int32(-1)),
        jnp.full(nb, INF32),
    )
    final, states = jax.lax.scan(step, ident, (k_e, pre_e, g_e, sa_e, suf_e))

    # exclusive chunk prefixes via associative scan over chunk summaries
    inc = jax.lax.associative_scan(_fs_combine, final)
    prefix = tuple(
        jnp.concatenate([i0[None], x[:-1]])
        for i0, x in zip(
            (jnp.int32(0), INF32, INF32, jnp.int32(-1), INF32), inc
        )
    )
    combined = _fs_combine(tuple(p[None, :] for p in prefix), states)

    def back(x):
        return x.T.reshape(-1)[:n]

    k, _, g, sa_, suf = combined
    return back(k), back(g), back(sa_), back(suf)



# lanes (chunk columns) per Triton program: one int32 element per thread
# at 4 warps
_TB = 128
_INF = 2**31 - 1  # plain int: a jnp constant would be captured as an
# implicit kernel input, which pallas_call rejects


def _fs_step(state, val, fl, sv):
    """state := combine(state, one element) — ``_fs_combine`` specialized
    to a single right-hand element (k2 = flag, pre2 = val, g2/suf2 = INF).
    ``fl`` is int32 0/1."""
    k, pre, g, sa_, suf = state
    has = k > 0
    flb = fl != 0
    bridge = jnp.minimum(suf, val)
    k2 = jnp.minimum(k + fl, 2)
    pre2 = jnp.where(has, pre, jnp.minimum(pre, val))
    sa2 = jnp.where(flb, sv, sa_)
    g2 = jnp.where(flb, jnp.where(has, bridge, _INF), g)
    suf2 = jnp.where(flb, _INF, jnp.where(has, bridge, _INF))
    return (k2, pre2, g2, sa2, suf2)


def _flag_scan_triton(values: jax.Array, flags: jax.Array,
                      sa_vals: jax.Array, chunk: int = 1024,
                      interpret: bool = False):
    """``flag_scan`` with the in-chunk scans as two Pallas kernels through
    Triton.  The data is laid out [chunk, chunks] so every step of a
    program's in-chunk loop loads one contiguous row of ``_TB`` chunk
    columns; programs share nothing, so the scan runs twice:

    * pass 1: each chunk's final monoid state ([chunks] x 5, tiny),
    * XLA: exclusive associative prefix over those finals,
    * pass 2: each chunk re-scanned from its prefix, writing the combined
      (k, g, sa, suf) per position.

    ``interpret=True`` runs the kernels in the Pallas interpreter (tests
    on hosts without a GPU)."""
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import triton as pltriton

    n = values.shape[0]
    nb = -(-n // chunk)
    nbp = -(-nb // _TB) * _TB
    padn = nbp * chunk - n
    v = jnp.concatenate([values.astype(jnp.int32), jnp.full(padn, INF32)])
    fl = jnp.concatenate(
        [flags.astype(jnp.int32), jnp.zeros(padn, jnp.int32)]
    )
    sv = jnp.concatenate(
        [sa_vals.astype(jnp.int32), jnp.full(padn, jnp.int32(-1))]
    )

    def t2(x):
        return x.reshape(nbp, chunk).T  # (chunk, nbp)

    v2, f2, s2 = t2(v), t2(fl), t2(sv)
    nt = nbp // _TB
    col_block = pl.BlockSpec((chunk, _TB), lambda i: (0, i))
    lane_block = pl.BlockSpec((_TB,), lambda i: (i,))
    route = {} if interpret else {
        "backend": "triton",
        "compiler_params": pltriton.CompilerParams(num_warps=4,
                                                   num_stages=2),
    }

    def finals_kernel(v_ref, f_ref, s_ref, k_o, p_o, g_o, sa_o, su_o):
        def body(j, st):
            return _fs_step(st, v_ref[j, :], f_ref[j, :], s_ref[j, :])

        init = (jnp.zeros(_TB, jnp.int32), jnp.full(_TB, _INF, jnp.int32),
                jnp.full(_TB, _INF, jnp.int32),
                jnp.full(_TB, -1, jnp.int32),
                jnp.full(_TB, _INF, jnp.int32))
        k, pre, g, sa_, suf = jax.lax.fori_loop(0, chunk, body, init)
        k_o[...] = k
        p_o[...] = pre
        g_o[...] = g
        sa_o[...] = sa_
        su_o[...] = suf

    finals = pl.pallas_call(
        finals_kernel, grid=(nt,), in_specs=[col_block] * 3,
        out_specs=(lane_block,) * 5,
        out_shape=(jax.ShapeDtypeStruct((nbp,), jnp.int32),) * 5,
        interpret=interpret, name="flag_scan_finals", **route,
    )(v2, f2, s2)

    inc = jax.lax.associative_scan(_fs_combine, finals)
    prefix = tuple(
        jnp.concatenate([i0[None], x[:-1]])
        for i0, x in zip(
            (jnp.int32(0), INF32, INF32, jnp.int32(-1), INF32), inc
        )
    )

    def seeded_kernel(pk, pp, pg, psa, psu, v_ref, f_ref, s_ref,
                      k_o, g_o, sa_o, su_o):
        def body(j, st):
            st = _fs_step(st, v_ref[j, :], f_ref[j, :], s_ref[j, :])
            k, _, g, sa_, suf = st
            k_o[j, :] = k
            g_o[j, :] = g
            sa_o[j, :] = sa_
            su_o[j, :] = suf
            return st

        init = (pk[...], pp[...], pg[...], psa[...], psu[...])
        jax.lax.fori_loop(0, chunk, body, init)

    outs = pl.pallas_call(
        seeded_kernel, grid=(nt,),
        in_specs=[lane_block] * 5 + [col_block] * 3,
        out_specs=(col_block,) * 4,
        out_shape=(jax.ShapeDtypeStruct((chunk, nbp), jnp.int32),) * 4,
        interpret=interpret, name="flag_scan_seeded", **route,
    )(*prefix, v2, f2, s2)
    return tuple(x.T.reshape(-1)[:n] for x in outs)


@functools.partial(jax.jit, static_argnames=("chunk",))
def segmented_min_scan(values: jax.Array, resets: jax.Array,
                       chunk: int = 1024) -> jax.Array:
    """out[t] = values[t] if resets[t] else min(out[t-1], values[t]).

    ``values`` int32, ``resets`` bool.  Padding uses resets=True so the tail
    never leaks into real lanes.
    """
    n = values.shape[0]
    nb = -(-n // chunk)
    pad = nb * chunk - n
    v = jnp.concatenate([values.astype(jnp.int32), jnp.full(pad, INF32)])
    r = jnp.concatenate([resets.astype(bool), jnp.ones(pad, dtype=bool)])
    v2 = v.reshape(nb, chunk).T  # (chunk, nb): scan over in-chunk offset
    r2 = r.reshape(nb, chunk).T

    def step(carry, x):
        cur, seen = carry
        vj, rj = x
        cur = jnp.where(rj, vj, jnp.minimum(cur, vj))
        seen = seen | rj
        return (cur, seen), (cur, seen)

    init = (jnp.full(nb, INF32), jnp.zeros(nb, dtype=bool))
    (cur_last, seen_last), (out2, seen2) = jax.lax.scan(step, init, (v2, r2))
    # out2/seen2: (chunk, nb)

    # carry across chunks: inclusive segmented scan over chunk summaries
    def combine(a, b):
        sa_, ma = a
        sb, mb = b
        return sa_ | sb, jnp.where(sb, mb, jnp.minimum(ma, mb))

    seen_inc, min_inc = jax.lax.associative_scan(
        combine, (seen_last, cur_last)
    )
    # exclusive prefix for each chunk: identity (False, INF) shifted right
    prefix = jnp.concatenate([jnp.array([INF32]), min_inc[:-1]])

    out2 = jnp.where(seen2, out2, jnp.minimum(prefix[None, :], out2))
    return out2.T.reshape(-1)[:n]

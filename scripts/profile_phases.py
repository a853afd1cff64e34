"""Region-level profiling of the JAX backend on the bench family.

Mirrors the real pipeline (out-of-block queries only) so shapes match the
bench's compile-cache buckets.  Writes timings to argv[1] (default
/tmp/andix_prof.txt); forces completion per region with one scalar
readback.

Env: ANDIX_BENCH_GENOMES, ANDIX_BENCH_LENGTH, ANDIX_PROF_BLOCK (subjects in
the profiled block, default all).
"""

import os
import sys
import time

import numpy as np


def log(f, msg):
    f.write(msg + "\n")
    f.flush()


def main():
    out_path = sys.argv[1] if len(sys.argv) > 1 else "/tmp/andix_prof.txt"
    n_genomes = int(os.environ.get("ANDIX_BENCH_GENOMES", "8"))
    length = int(os.environ.get("ANDIX_BENCH_LENGTH", "1000000"))
    f = open(out_path, "w")

    t0 = time.time()
    import jax
    import jax.numpy as jnp

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from bench import make_family

    from andix.esa import joint, matchstats_jax
    from andix.esa.backend_jax import JaxBackend
    from andix.runtime import Context, Model
    from andix.sequence import subject_init

    log(f, f"imports: {time.time()-t0:.2f}s; devices={jax.devices()}")

    seqs = make_family(n_genomes, length)
    ctx = Context()
    backend = JaxBackend()

    t0 = time.time()
    subjects = [subject_init(s, ctx.anchor_p_value) for s in seqs]
    log(f, f"subject_init x{n_genomes}: {time.time()-t0:.2f}s")

    n = len(seqs)
    nblock = int(os.environ.get("ANDIX_PROF_BLOCK", str(n)))
    block = list(range(nblock))
    t0 = time.time()
    subject_rs = {i: subjects[i].rs for i in block}
    query_seqs = {j: seqs[j].data for j in range(n) if j not in block}
    layout = joint.build_block(subject_rs, query_seqs)
    log(f, f"build_block: {time.time()-t0:.2f}s; n_sym={len(layout.sym)}")

    t0 = time.time()
    bctx = backend.prepare_block(layout)
    _ = int(bctx.tq_d[0])
    _ = int(bctx.lcp_d[1])
    log(f, f"prepare_block total: {time.time()-t0:.2f}s")

    from andix.chain.replay_device import (
        group_subject_tables,
        replay_rows_device,
        subject_group_counts_device,
    )

    gp = bctx.q_start_d.shape[0]
    group = len(block)
    segs = np.full(group, -1, dtype=np.int32)
    starts = np.zeros(group, dtype=np.int32)
    rs_lens = np.ones(group, dtype=np.int32)
    thresholds = np.full(group, 2**29, dtype=np.int32)
    q_len2d = np.zeros((group, gp), dtype=np.int32)
    q_len_row = np.asarray(jax.device_get(bctx.q_len_d), dtype=np.int32)
    for kk, genome in enumerate(block):
        subj_seg, subj_start = backend._subject_seg(layout, genome)
        segs[kk] = subj_seg
        starts[kk] = subj_start
        rs_lens[kk] = subjects[genome].len
        thresholds[kk] = subjects[genome].threshold
        q_len2d[kk] = q_len_row

    jump_passes = int(os.environ.get("ANDIX_JUMP_PASSES", "3"))

    # split phases first (tables vs replay), then the fused production call
    t0 = time.time()
    mlun_g, ps_g, jump_g = group_subject_tables(
        bctx.sa_d, bctx.lcp_d, bctx.segid_d, bctx.tq_d,
        jnp.asarray(segs), jnp.asarray(starts), jnp.asarray(thresholds),
        jump_passes,
    )
    _ = int(mlun_g[0, 0])
    log(f, f"group_subject_tables x{group}: {time.time()-t0:.2f}s")

    t0 = time.time()
    counts = replay_rows_device(
        bctx.text_d, bctx.isa_d, bctx.rm,
        mlun_g, ps_g, jump_g,
        jnp.asarray(starts), jnp.asarray(rs_lens), jnp.asarray(thresholds),
        bctx.q_base_d, bctx.q_start_d, jnp.asarray(q_len2d),
        False,
    )
    counts_h = np.asarray(jax.device_get(counts))
    log(f, f"replay_rows_device (group={group}): {time.time()-t0:.2f}s")

    t0 = time.time()
    counts2 = subject_group_counts_device(
        bctx.sa_d, bctx.lcp_d, bctx.segid_d, bctx.tq_d,
        bctx.text_d, bctx.isa_d, bctx.rm,
        jnp.asarray(segs), jnp.asarray(starts),
        jnp.asarray(rs_lens), jnp.asarray(thresholds),
        bctx.q_base_d, bctx.q_start_d, jnp.asarray(q_len2d),
        jump_passes, False,
    )
    counts2_h = np.asarray(jax.device_get(counts2))
    log(f, f"fused tables+replay (production): {time.time()-t0:.2f}s")
    assert (counts_h == counts2_h).all()
    log(f, f"counts[0,1]={counts_h[0,1].tolist()}")
    f.close()


if __name__ == "__main__":
    main()

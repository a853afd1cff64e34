"""Per-subject table-build cost anatomy at family scale (r4: tables are
the new top phase).  Times match_stats_device, the blob gathers, and the
jump build separately on real n=22-shaped data."""
import os, sys, time
import numpy as np, jax, jax.numpy as jnp
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import bench as benchmod
from andix.runtime import Context
from andix.sequence import subject_init
from andix.esa import joint, matchstats_jax
from andix.esa.backend_jax import JaxBackend
from andix.chain.replay_device import prepare_subject_tables

def sync(a): return int(np.asarray(jax.device_get(a)).ravel()[0])

N_G = int(sys.argv[1]) if len(sys.argv) > 1 else 22
seqs = benchmod.make_family(N_G, 1_000_000)
ctxr = Context()
subjects = [subject_init(s, ctxr.anchor_p_value) for s in seqs]
be = JaxBackend()
t0 = time.time()
layout = joint.build_block({i: subjects[i].rs for i in range(N_G)}, {})
ctx = be.prepare_block(layout)
sync(ctx.tq_d[:1]); print(f"block prep ({ctx.sa_d.shape[0]} syms): {time.time()-t0:.1f}s")
subj_seg = int(np.nonzero((layout.genome_ids == 0) & layout.is_subject)[0][0])
subj_start = int(layout.seg_start[subj_seg])
thr = subjects[0].threshold

stats = jax.jit(matchstats_jax.match_stats_device)
for trial in range(3):
    t0 = time.time()
    ml, un, ps = stats(ctx.sa_d, ctx.lcp_d, ctx.segid_d,
                       jnp.int32(subj_seg), jnp.int32(subj_start))
    sync(ml[:1])
    print(f"match_stats trial{trial}: {time.time()-t0:.2f}s")

@jax.jit
def blob_gathers(ml, un, ps, tq):
    mlun_sa = ml | jnp.where(un, jnp.int32(1 << 30), 0)
    return mlun_sa[tq], ps[tq]
for trial in range(3):
    t0 = time.time()
    a, b = blob_gathers(ml, un, ps, ctx.tq_d)
    sync(a[:1])
    print(f"blob gathers trial{trial}: {time.time()-t0:.2f}s")

prep = jax.jit(lambda ml, un, ps, tq: prepare_subject_tables(
    ml, un, ps, tq, jnp.int32(thr), 0), static_argnames=())
for trial in range(3):
    t0 = time.time()
    m3 = prep(ml, un, ps, ctx.tq_d)
    sync(m3[0][:1])
    print(f"prepare_subject_tables (incl jump) trial{trial}: {time.time()-t0:.2f}s")

#!/usr/bin/env python
"""Cross-validate the fast anchor machinery against brute force.

Analogue of the reference's scripts/vmatch.sh (which checked andi's anchors
against Vmatch MUMs): samples random mutated pairs, computes per-position
match statistics with the production JAX path and with the O(n*m) oracle,
and reports any disagreement.  Exit code 1 on mismatch.

Usage: python scripts/anchor_validate.py [--pairs 5] [--length 500]
"""

import argparse
import sys

import os

import numpy as np

sys.path.insert(0, ".")

# runs on the CPU unless JAX_PLATFORMS names another platform
os.environ.setdefault("JAX_PLATFORMS", "cpu")

from andix.esa import joint
from andix.esa.backend_jax import JaxBackend
from andix.oracle import match_stats_brute
from andix.sequence import catcomp

NUCL = np.frombuffer(b"ACGT", dtype=np.uint8)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--pairs", type=int, default=5)
    ap.add_argument("--length", type=int, default=500)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    rng = np.random.default_rng(args.seed)
    be = JaxBackend()

    bad = 0
    for k in range(args.pairs):
        base = NUCL[rng.integers(0, 4, args.length)]
        codes = np.searchsorted(NUCL, base)
        hit = rng.random(args.length) < rng.uniform(0.01, 0.3)
        other = NUCL[(codes + np.where(hit, rng.integers(1, 4, args.length), 0)) % 4]
        rs = catcomp(base)
        layout = joint.build_block({0: rs}, {1: other})
        ctx = be.prepare_block(layout)
        ml, un, ps = be.subject_stats(ctx, 0)
        g = ctx.q_genomes.index(1)
        lo, hi = int(ctx.q_off[g]), int(ctx.q_off[g + 1])
        bml, bun, bps = match_stats_brute(rs, other)
        ok = (
            (ml[lo:hi] == bml).all()
            and (un[lo:hi] == bun).all()
            and (ps[lo:hi][bun] == bps[bun]).all()
        )
        print(f"pair {k}: {'OK' if ok else 'MISMATCH'}")
        bad += 0 if ok else 1
    sys.exit(1 if bad else 0)


if __name__ == "__main__":
    main()

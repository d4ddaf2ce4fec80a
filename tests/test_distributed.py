"""Multi-host (multi-process) distribution tests.

The reference is single-process/single-device; the distributed scope is the
north star's (SURVEY.md §2.3): points+observations partitioned across
hosts, reduced camera system assembled with collectives, replicated scalar
state. These tests cover both layers:

  - solve_distributed on a single-process virtual mesh must match the
    single-device solver (same control decisions, psum-roundoff numerics);
  - a REAL 2-process run (subprocesses + jax.distributed over localhost,
    2 virtual CPU devices each) must initialize a process-spanning mesh,
    load shards host-locally, and converge to the same optimum on every
    process.
"""

import json
import os
import socket
import subprocess
import sys

import jax
import numpy as np
import pytest

from psba_tpu.io import synthetic_problem
from psba_tpu.solvers import SolverConfig
from psba_tpu.solvers.hybrid import solve

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 4, reason="needs >=4 virtual devices"
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_solve_distributed_single_process(prob_synth):
    from psba_tpu.parallel.distributed import global_mesh, solve_distributed

    r1 = solve(prob_synth, SolverConfig())
    r2 = solve_distributed(prob_synth, SolverConfig(), mesh=global_mesh(8))
    assert r2.iterations == r1.iterations
    np.testing.assert_allclose(r2.final_error, r1.final_error, rtol=1e-9)


@pytest.mark.parametrize("schur,s_reduce", [
    ("auto", "psum"),        # dense encoding, all-reduce S
    ("pairs", "scatter"),    # pair-list encoding, reduce_scatter S —
    # both cross REAL process boundaries
])
def test_solve_distributed_two_processes(tmp_path, schur, s_reduce):
    """Spawn 2 coordinated processes; each owns half the mesh devices."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]

    outs = [str(tmp_path / f"w{i}.json") for i in range(2)]
    env = dict(os.environ, PYTHONPATH=REPO)
    env.pop("XLA_FLAGS", None)  # worker sets its own device count
    procs = [
        subprocess.Popen(
            [sys.executable, os.path.join(REPO, "tests", "_dist_worker.py"),
             str(i), "2", str(port), outs[i], schur, s_reduce],
            env=env, stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL,
        )
        for i in range(2)
    ]
    for p in procs:
        assert p.wait(timeout=240) == 0

    results = [json.load(open(o)) for o in outs]
    for r in results:
        assert r["n_processes"] == 2
        assert r["n_devices"] == 4
        assert r["n_local_devices"] == 2

    # both processes agree on the replicated result
    assert results[0]["final_error"] == results[1]["final_error"]
    assert results[0]["iterations"] == results[1]["iterations"]

    # and it matches the single-device optimum (worker uses seed=3 problem)
    prob = synthetic_problem(n_cams=6, n_pts=150, seed=3)
    ref = solve(prob, SolverConfig())
    np.testing.assert_allclose(
        results[0]["final_error"], ref.final_error, rtol=1e-9
    )


def test_two_process_dense_at_scale(tmp_path):
    """2-process run at 10k points / ~40k observations on the dense
    Schur encoding in f32, 2 shards per process, the dense blk_idx
    tables crossing process boundaries. Both processes must agree
    exactly; the result must match the single-process 4-device run of
    the identical mesh shape."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]

    N_CAMS, N_PTS = 8, 10_000
    outs = [str(tmp_path / f"w{i}.json") for i in range(2)]
    env = dict(os.environ, PYTHONPATH=REPO)
    env.pop("XLA_FLAGS", None)  # worker sets its own device count
    procs = [
        subprocess.Popen(
            [sys.executable, os.path.join(REPO, "tests", "_dist_worker.py"),
             str(i), "2", str(port), outs[i], "dense", "psum",
             str(N_CAMS), str(N_PTS), "f32"],
            env=env, stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL,
        )
        for i in range(2)
    ]
    for p in procs:
        assert p.wait(timeout=480) == 0

    results = [json.load(open(o)) for o in outs]
    assert results[0]["final_error"] == results[1]["final_error"]
    assert results[0]["iterations"] == results[1]["iterations"]
    # each process holds 2 of the 4 point shards
    for r in results:
        assert r["n_local_devices"] == 2
        assert r["local_pts_rows"] * 2 >= N_PTS / 2

    import jax.numpy as jnp

    from psba_tpu.parallel.shard import solve_sharded

    prob = synthetic_problem(n_cams=N_CAMS, n_pts=N_PTS, seed=3)
    ref = solve_sharded(
        prob, SolverConfig.for_dtype(jnp.float32),
        n_devices=4, schur="dense", dtype=jnp.float32,
    )
    np.testing.assert_allclose(
        results[0]["final_error"], ref.final_error, rtol=1e-4
    )


def test_s_reduce_scatter_matches_psum(prob_synth):
    """The reduce_scatter+all_gather S assembly (cfg.s_reduce="scatter")
    must match the all-reduce path."""
    from psba_tpu.parallel.shard import solve_sharded

    r1 = solve_sharded(prob_synth, SolverConfig(), n_devices=8)
    r2 = solve_sharded(
        prob_synth, SolverConfig(s_reduce="scatter"), n_devices=8
    )
    assert r1.iterations == r2.iterations
    np.testing.assert_allclose(r2.final_error, r1.final_error, rtol=1e-9)

"""Multi-process distributed-solve worker (launched by test_distributed).

Usage: python tests/_dist_worker.py PROCESS_ID NUM_PROCESSES PORT OUT_JSON \
           [SCHUR] [S_REDUCE] [N_CAMS] [N_PTS] [DTYPE]

SCHUR in {auto, dense, pairs} picks the S-assembly encoding; S_REDUCE in
{psum, scatter} picks the collective for the S off-diagonal sum
(reduce_scatter + all_gather when "scatter") — both exercised across
REAL process boundaries here. DTYPE in {f64, f32} is the working
precision.

Each process owns 2 virtual CPU devices; jax.distributed coordinates the
processes so the mesh spans NUM_PROCESSES * 2 devices, the shape of a
multi-host run (several devices per process, several processes)."""

import json
import os
import sys

pid, nproc, port, out = (
    int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
)
schur = sys.argv[5] if len(sys.argv) > 5 else "auto"
s_reduce = sys.argv[6] if len(sys.argv) > 6 else "psum"
n_cams = int(sys.argv[7]) if len(sys.argv) > 7 else 6
n_pts = int(sys.argv[8]) if len(sys.argv) > 8 else 150
dtype_s = sys.argv[9] if len(sys.argv) > 9 else "f64"

os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "")
    + " --xla_force_host_platform_device_count=2"
)

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

from psba_tpu.io import synthetic_problem  # noqa: E402
from psba_tpu.parallel.distributed import (  # noqa: E402
    global_mesh,
    init_distributed,
    solve_distributed,
)
from psba_tpu.solvers import SolverConfig  # noqa: E402

init_distributed(f"localhost:{port}", nproc, pid)
assert jax.process_count() == nproc, jax.process_count()

import jax.numpy as jnp  # noqa: E402

dtype = jnp.float32 if dtype_s == "f32" else jnp.float64
prob = synthetic_problem(n_cams=n_cams, n_pts=n_pts, seed=3)
cfg = SolverConfig.for_dtype(dtype, s_reduce=s_reduce)
res = solve_distributed(
    prob, cfg, mesh=global_mesh(), schur=schur,
    dtype=None if dtype_s == "f64" else dtype,
)

with open(out, "w") as f:
    json.dump({
        "process": pid,
        "n_processes": jax.process_count(),
        "n_devices": len(jax.devices()),
        "n_local_devices": len(jax.local_devices()),
        "final_error": res.final_error,
        "iterations": res.iterations,
        "flag": res.flag_name,
        "local_pts_rows": int(res.pts.shape[0]),
        "schur": schur,
        "s_reduce": s_reduce,
    }, f)

"""CLI smoke tests — the user-facing surface (`python -m psba_tpu.cli`,
the analog of the reference driver's report block, PSBA/main.cpp:214-218).

Each test runs the CLI in a subprocess (its own backend/x64 setup) with a
small iteration budget so the whole file stays fast; convergence depth is
the golden tests' job, not this file's."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from tests.conftest import DATA, requires_data

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_cli(*args, timeout=420):
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    # persistent compile cache (the CLI keeps it in <repo>/.jax_cache):
    # the first subprocess pays the CPU compiles, the rest of the file
    # reuses them
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    env["JAX_PERSISTENT_CACHE_MIN_ENTRY_SIZE_BYTES"] = "-1"
    env["JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS"] = "0.5"
    return subprocess.run(
        [sys.executable, "-m", "psba_tpu.cli", *args],
        capture_output=True, text=True, timeout=timeout, env=env,
        cwd=REPO,
    )


@requires_data
def test_cli_text_pair_json():
    res = run_cli(
        "--cams", f"{DATA}/7camsvarK.txt", "--pts", f"{DATA}/7pts.txt",
        "--max-iters", "8", "--json",
    )
    assert res.returncode == 0, res.stderr[-2000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    # the known initial metric of this problem (I/O parity anchor)
    np.testing.assert_allclose(out["initial_error"], 0.09982936628,
                               rtol=1e-8)
    assert out["final_error"] < 0.5 * out["initial_error"]
    assert out["iterations"] <= 8


def test_cli_raw_bal_fixture(tmp_path):
    """--bal consumes the documented raw BAL layout; --out-cams/--out-pts
    write the optimized problem back out."""
    fixture = os.path.join(REPO, "tests", "data", "mini_bal.txt")
    oc = str(tmp_path / "cams.txt")
    op = str(tmp_path / "pts.txt")
    res = run_cli(
        "--cams", fixture, "--bal", "--max-iters", "10", "--json",
        "--out-cams", oc, "--out-pts", op,
    )
    assert res.returncode == 0, res.stderr[-2000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["final_l2"] < out["initial_l2"]
    assert os.path.exists(oc) and os.path.exists(op)
    assert np.loadtxt(op).shape == (100, 3)


@requires_data
def test_cli_reference_report_format():
    """Default (non-json) output mirrors the reference's report block
    (main.cpp:214-218)."""
    res = run_cli(
        "--cams", f"{DATA}/7camsvarK.txt", "--pts", f"{DATA}/7pts.txt",
        "--max-iters", "4",
    )
    assert res.returncode == 0, res.stderr[-2000:]
    lines = res.stdout.splitlines()
    assert any(l.startswith("time eclipse ") for l in lines)
    assert any(l.startswith("initial error: ") for l in lines)
    assert any(l.startswith("final error: ") for l in lines)
    assert any(l.startswith("total iteration: ") for l in lines)


def test_cli_generated_text_pair(tmp_path):
    """A generated BAL-shaped problem written as the reference's text pair
    reads back through --cams/--pts and solves."""
    from psba_tpu.io import bal_shaped_problem
    from psba_tpu.io.bal import write_sba_text

    prob = bal_shaped_problem(5, 80, seed=2)
    cams, pts = str(tmp_path / "cams.txt"), str(tmp_path / "pts.txt")
    write_sba_text(prob, cams, pts)
    res = run_cli("--cams", cams, "--pts", pts, "--max-iters", "6", "--json")
    assert res.returncode == 0, res.stderr[-2000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["final_l2"] < out["initial_l2"]
    assert out["iterations"] <= 6

"""chip_smoke.py and the compile-cache helper, checked where no GPU is.

The smoke's comparison functions run here on the CPU at a tiny shape (the
same code the script runs on the card at BAL widths); the 4-device phase
runs on 4 virtual CPU devices. Tests marked `gpu` repeat the checks on the
card and skip elsewhere."""

import os
import shutil
import subprocess
import sys

import jax
import numpy as np
import pytest

import chip_smoke
from psba_tpu.io import bal_shaped_problem
from psba_tpu.solvers.hybrid import solve
from psba_tpu.utils import compile_cache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def tiny():
    return bal_shaped_problem(8, 300, seed=1)


@pytest.fixture(scope="module")
def tiny_f64(tiny):
    return solve(tiny)


def test_require_gpu_raises_without_gpu():
    with pytest.raises(SystemExit, match="no GPU"):
        chip_smoke.require_gpu()


@pytest.mark.parametrize("where", ["repo", "alone"])
def test_smoke_exits_nonzero_without_gpu(tmp_path, where):
    """Without a GPU — and in a directory holding chip_smoke.py and nothing
    else of the repo — the script exits non-zero and prints no result."""
    if where == "alone":
        shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
        cwd = str(tmp_path)
    else:
        cwd = REPO
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", "XLA_FLAGS")}
    env["JAX_PLATFORMS"] = "cpu"
    res = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
    assert "no GPU" in res.stderr


def test_enable_compile_cache_env_set(monkeypatch, tmp_path):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv(compile_cache.ENV_VAR, str(tmp_path))
    assert compile_cache.enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before


def test_enable_compile_cache_default(monkeypatch):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.delenv(compile_cache.ENV_VAR, raising=False)
    try:
        got = compile_cache.enable_compile_cache()
        assert got == os.path.join(REPO, ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == got
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_compile_cache_lands_in_env_dir(tmp_path):
    """With JAX_COMPILATION_CACHE_DIR set, compiled programs land there."""
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env.update({
        "JAX_PLATFORMS": "cpu", "PYTHONPATH": REPO,
        compile_cache.ENV_VAR: str(tmp_path),
        "JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS": "0",
        "JAX_PERSISTENT_CACHE_MIN_ENTRY_SIZE_BYTES": "-1",
    })
    code = (
        "import jax\n"
        "from psba_tpu.utils.compile_cache import enable_compile_cache\n"
        "print(enable_compile_cache())\n"
        "jax.jit(lambda x: x * 2 + 1)(1.0).block_until_ready()\n"
    )
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.strip() == str(tmp_path)
    assert os.listdir(tmp_path)


def test_smoke_residual_check(tiny):
    out = chip_smoke.residual_check(tiny)
    assert out["f64_max_abs_err_px"] < 1e-10
    assert out["f32_l2_relerr"] <= 1e-5


def test_smoke_residual_check_catches_error(tiny, monkeypatch):
    """A forward model that is off by 1e-6 px must fail the f64 gate."""
    from psba_tpu.core import residual

    real = residual.residuals
    monkeypatch.setattr(residual, "residuals",
                        lambda *a, **k: real(*a, **k) + 1e-6)
    with pytest.raises(AssertionError):
        chip_smoke.residual_check(tiny)


def test_smoke_jacobian_check(tiny):
    out = chip_smoke.jacobian_check(tiny, n_sub=64)
    assert out["n_obs"] == 64


def test_smoke_schur_check(tiny):
    out = chip_smoke.schur_check(tiny)
    assert out["f32_highest_relerr"] <= 1e-5
    assert out["offdiag_f32_highest_relerr"] <= chip_smoke.OFFDIAG_RTOL
    # the CPU has no TF32: default precision is full f32 here
    assert out["f32_default_precision_relerr"] <= 1e-5


def test_smoke_schur_check_catches_tf32(tiny, monkeypatch):
    """An f32 S whose product ZY ZW^T takes TF32-rounded operands (10
    mantissa bits, what an unpinned contraction gets on an NVIDIA GPU)
    fails the off-diagonal gate. (At rome93 on an H100 that error is 22x
    diluted in S as a whole, within the whole-S gate.)"""
    import jax.numpy as jnp
    from jax import lax

    from psba_tpu.core import schur

    real = schur.schur_S_dense

    def tf32(U, ZW, Vp, psum=None):
        S, ZY = real(U, ZW, Vp, psum=psum)
        if ZW.dtype != jnp.float32:
            return S, ZY

        def r(x):
            return lax.reduce_precision(x, exponent_bits=8, mantissa_bits=10)

        hi = jnp.matmul(ZY, ZW.T, precision=lax.Precision.HIGHEST)
        return S + hi - jnp.matmul(r(ZY), r(ZW).T), ZY

    monkeypatch.setattr(schur, "schur_S_dense", tf32)
    with pytest.raises(chip_smoke.SmokeFailure, match="off-diagonal"):
        chip_smoke.schur_check(tiny)


def test_smoke_f32_vs_f64(tiny, tiny_f64):
    row = chip_smoke.f32_vs_f64(tiny, tiny_f64)
    assert row["final_rms_relerr_vs_f64"] <= 1e-6
    assert row["phases"][-1][0] == "lm64"


def test_smoke_device_vs_cpu(tiny, tiny_f64):
    """On the CPU both sides run on the host: identical results."""
    out = chip_smoke.gpu_vs_cpu(tiny, tiny_f64)
    assert out["final_l2_relerr_vs_cpu"] == 0.0


def test_smoke_cli_check(tiny, tiny_f64, tmp_path):
    out = chip_smoke.cli_check(tiny, tiny_f64, str(tmp_path))
    assert out["final_l2_relerr_vs_solve"] <= 1e-6
    assert os.path.exists(tmp_path / "cams.txt")


def test_smoke_four_phase_virtual_devices(tiny):
    """The --four phase on 4 virtual CPU devices: the point shards land on
    4 devices and the sharded solves match the single-device ones."""
    if len(jax.devices()) < 4:
        pytest.skip("needs >=4 virtual devices")
    rows = chip_smoke.four_phase(tiny, n_devices=4)
    assert [r["dtype"] for r in rows] == ["float64", "float32"]
    for r in rows:
        assert len(r["shard_devices"]) == 4
    assert rows[0]["flag"] == rows[0]["single_flag"]
    assert rows[0]["final_l2_relerr_vs_single"] <= 1e-8
    assert rows[1]["lm10_max_err_relerr_vs_single"] <= 1e-4
    assert abs(rows[1]["sharded_rms_relerr_vs_f64"]) <= 1e-2


@pytest.mark.gpu
def test_gpu_precision_checks(gpu_device):
    """Residuals, Jacobians and the f32 Schur system on the card."""
    prob = bal_shaped_problem(93, 6000, seed=0)
    with jax.default_device(gpu_device):
        chip_smoke.residual_check(prob)
        chip_smoke.jacobian_check(prob, n_sub=1024)
        out = chip_smoke.schur_check(prob)
    assert out["f32_highest_relerr"] <= 1e-5


@pytest.mark.gpu
def test_gpu_solve_matches_cpu(gpu_device):
    """An f64 hybrid solve on the card ends on the CPU's flag and L2."""
    prob = bal_shaped_problem(21, 2000, seed=0)
    with jax.default_device(gpu_device):
        res = solve(prob)
    out = chip_smoke.gpu_vs_cpu(prob, res)
    assert out["final_l2_relerr_vs_cpu"] <= 1e-8


@pytest.mark.gpu
def test_gpu_f32_polish_matches_f64(gpu_device):
    prob = bal_shaped_problem(21, 2000, seed=0)
    with jax.default_device(gpu_device):
        res64 = solve(prob)
        row = chip_smoke.f32_vs_f64(prob, res64)
    assert row["final_rms_relerr_vs_f64"] <= 1e-6
    assert np.isfinite(row["final_rms_px"])
    assert row["phases"][-1][0] == "lm64"

#!/usr/bin/env python3
"""Bring-up check: the hybrid LM/TR solver on an NVIDIA GPU at BAL widths.

    python chip_smoke.py          # one GPU: every phase below
    python chip_smoke.py --four   # four GPUs: the sharded rome93 phase and
                                  # the single-GPU solve it is compared with

Every problem is generated in this process from a seed
(psba_tpu.io.bal_shaped_problem) at a published BAL shape of the dataset
registry (psba_tpu.datasets), about 5 observations per point:

  precision    rome93 initial parameters on the GPU against the NumPy f64
               oracle (tests/oracle.py): residuals (f64 rtol 1e-12 with
               1e-10 px atol for residuals near zero; f32 rtol 1e-5 on the
               L2), analytic Jacobians on a 4096-observation subsample
               against central differences (rtol 2e-5, atol 2e-4, the unit
               test's gate), and the reduced camera matrix S built in f32
               against the same S built in f64: relative Frobenius error
               <= 1e-5 on the whole of S, and <= 5e-6 on its off-diagonal
               camera blocks, the product ZY ZW^T alone, which the HIGHEST
               precision pins keep out of TF32 (TF32 gives ~4e-5 there on
               an H100; that reading is printed beside it)
  rome93       f64 hybrid solve, and f32 with POLISH f64 polish iterations;
               the two final RMS agree to rtol 1e-6
  ladybug138   f64 hybrid solve (the widest reduced system, n = 6C = 828)
  trafalgar21  f64 hybrid solve on the GPU and on the host CPU in this
               process: same flag, final L2 within rtol 1e-8 (the GPU's
               scatter-adds sum in no fixed order, so bits may differ)
  cli          psba_tpu.cli.main on the trafalgar21 problem written as the
               reference's text pair (io.bal.write_sba_text)

The first lines name the card (nvidia-smi) and the JAX devices; each phase
prints one JSON line; the last line is {"ok": true, "device": {...}}. The
script exits non-zero, without that line, when JAX finds no GPU or any
phase fails. It runs in one process: a second JAX process could not get
the card's memory.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(REPO, "chiprun_out", "smoke")

# (n_cams, n_pts) of the registry's BAL rows (datasets.REGISTRY file names)
SHAPES = {
    "rome93": (93, 61203),
    "ladybug138": (138, 19878),
    "trafalgar21": (21, 11315),
}
SEED = 0
JAC_SUBSAMPLE = 4096
# f64 LM iterations after the f32 run (the CLI's --polish N)
POLISH = 5
# relative Frobenius error of S's off-diagonal camera blocks, f32 against
# f64: between the H100's readings at HIGHEST (7e-7) and in TF32 (4e-5)
OFFDIAG_RTOL = 5e-6


class SmokeFailure(AssertionError):
    pass


def check(cond, what):
    if not cond:
        raise SmokeFailure(what)


def card_line() -> str:
    """`name, power.limit` of the first GPU as nvidia-smi reports it."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout
    return out.strip().splitlines()[0]


def require_gpu():
    """The JAX devices; SystemExit (non-zero) unless they are GPUs."""
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(
            "chip_smoke: JAX found no GPU (devices: "
            f"{[d.platform for d in devs]}); this check needs an NVIDIA GPU "
            "and does not run on the CPU"
        )
    return devs


def rms_px(l2, n_obs):
    return float((l2 / n_obs) ** 0.5)


def relerr(a, b):
    import numpy as np

    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


# --------------------------------------------------------------- checks


def residual_check(prob):
    """core.residual.residuals against oracle.residuals at the problem's
    initial parameters: f64 elementwise, f32 on the L2."""
    import jax.numpy as jnp
    import numpy as np

    from psba_tpu.core.residual import residuals
    from tests import oracle

    want = oracle.residuals(prob)
    out = {}
    for dt in (jnp.float64, jnp.float32):
        args = [jnp.asarray(a, dt) for a in
                (prob.K, prob.q0, prob.cams, prob.pts, prob.obs)]
        got = np.asarray(residuals(
            *args, jnp.asarray(prob.cam_idx), jnp.asarray(prob.pt_idx)
        ), np.float64)
        if dt == jnp.float64:
            np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-10)
            out["f64_max_abs_err_px"] = float(np.max(np.abs(got - want)))
        else:
            l2, l2_ref = float(np.sum(got * got)), float(np.sum(want * want))
            out["f32_l2_relerr"] = abs(l2 - l2_ref) / l2_ref
            check(out["f32_l2_relerr"] <= 1e-5,
                  f"f32 residual L2 relerr {out['f32_l2_relerr']:.3e} > 1e-5")
    return out


def jacobian_check(prob, n_sub=JAC_SUBSAMPLE, seed=SEED):
    """Analytic A/B on a seeded observation subsample against the oracle's
    central differences, at perturbed parameters (nonzero local
    rotations exercise the whole Jacobian)."""
    import dataclasses

    import jax.numpy as jnp
    import numpy as np

    from psba_tpu.core.jacobian import jacobians
    from tests import oracle

    rng = np.random.default_rng(seed)
    cams = prob.cams.copy()
    cams[:, :3] += 1e-3 * rng.standard_normal(cams[:, :3].shape)
    cams[:, 3:] += 1e-2 * rng.standard_normal(cams[:, 3:].shape)
    sub = np.sort(rng.choice(prob.n_obs, min(n_sub, prob.n_obs),
                             replace=False))
    A, B = jacobians(
        jnp.asarray(prob.K), jnp.asarray(prob.q0), jnp.asarray(cams),
        jnp.asarray(prob.pts), jnp.asarray(prob.cam_idx[sub]),
        jnp.asarray(prob.pt_idx[sub]),
    )
    small = dataclasses.replace(
        prob, obs=prob.obs[sub], cam_idx=prob.cam_idx[sub],
        pt_idx=prob.pt_idx[sub],
    )
    A_fd, B_fd = oracle.jacobians_fd(small, cams, prob.pts)
    np.testing.assert_allclose(np.asarray(A), A_fd, rtol=2e-5, atol=2e-4)
    np.testing.assert_allclose(np.asarray(B), B_fd, rtol=2e-5, atol=2e-4)
    return {"n_obs": int(len(sub)),
            "A_max_abs_err": float(np.max(np.abs(np.asarray(A) - A_fd))),
            "B_max_abs_err": float(np.max(np.abs(np.asarray(B) - B_fd)))}


def offdiag_blocks(S, n_cams):
    """S [6C, 6C] with its C diagonal 6x6 camera blocks set to zero: what
    is left is -ZY ZW^T, the product whose precision the pins set."""
    import numpy as np

    S = np.asarray(S, np.float64).reshape(n_cams, 6, n_cams, 6).copy()
    S[np.arange(n_cams), :, np.arange(n_cams), :] = 0.0
    return S


def schur_check(prob):
    """S = blockdiag(U) - ZY ZW^T at the LM start (mu = tau * max diag),
    built by core.schur.schur_S_dense in f32 and in f64 on the device;
    also the f32 S with the off-diagonal product recomputed at default
    precision (TF32 on NVIDIA GPUs), for comparison."""
    import jax
    import jax.numpy as jnp

    from psba_tpu import constants as CC
    from psba_tpu.core.hessian import assemble_blocks, damp_uv, max_diag
    from psba_tpu.core.jacobian import jacobians
    from psba_tpu.core.residual import residuals
    from psba_tpu.core.schur import inv3x3_planar, schur_S_dense, stack_blocks
    from psba_tpu.problem import build_blk_idx

    blk = build_blk_idx(prob.pt_idx, prob.cam_idx, prob.n_cams, prob.n_pts)

    @jax.jit
    def build(K, q0, cams, pts, obs, cam_idx, pt_idx, blk):
        A, B = jacobians(K, q0, cams, pts, cam_idx, pt_idx)
        ex = residuals(K, q0, cams, pts, obs, cam_idx, pt_idx)
        U, V, W, _ga, _gb = assemble_blocks(
            A, B, ex, cam_idx, pt_idx, K.shape[0], pts.shape[0]
        )
        mu = CC.PSBA_INIT_MU * max_diag(U, V)
        U_d, V_d = damp_uv(U, V, mu)
        Vp, ok = inv3x3_planar(V_d)
        ZW = stack_blocks(W, blk)
        S, ZY = schur_S_dense(U_d, ZW, Vp)
        hi = jnp.matmul(ZY, ZW.T, precision=jax.lax.Precision.HIGHEST)
        lo = jnp.matmul(ZY, ZW.T, precision=jax.lax.Precision.DEFAULT)
        return S, S + hi - lo, ok

    out, S = {}, {}
    for dt in (jnp.float64, jnp.float32):
        f = [jnp.asarray(a, dt) for a in
             (prob.K, prob.q0, prob.cams, prob.pts, prob.obs)]
        S[dt], S_default, ok = build(
            *f, jnp.asarray(prob.cam_idx), jnp.asarray(prob.pt_idx),
            jnp.asarray(blk),
        )
        check(bool(ok), f"singular V block in the {dt.__name__} build")
    C = prob.n_cams
    out["f32_highest_relerr"] = relerr(S[jnp.float32], S[jnp.float64])
    out["f32_default_precision_relerr"] = relerr(S_default, S[jnp.float64])
    # the off-diagonal blocks alone: the U diagonal, exact in both builds,
    # dilutes the product's error in S as a whole
    off64 = offdiag_blocks(S[jnp.float64], C)
    out["offdiag_f32_highest_relerr"] = relerr(
        offdiag_blocks(S[jnp.float32], C), off64)
    out["offdiag_f32_default_precision_relerr"] = relerr(
        offdiag_blocks(S_default, C), off64)
    check(out["offdiag_f32_highest_relerr"] <= OFFDIAG_RTOL,
          "f32 S off-diagonal relerr "
          f"{out['offdiag_f32_highest_relerr']:.3e} > {OFFDIAG_RTOL:g}")
    check(out["f32_highest_relerr"] <= 1e-5,
          f"f32 S relerr {out['f32_highest_relerr']:.3e} > 1e-5")
    return out


def timed_solve(prob, dtype=None, **kw):
    """solve() twice: (cold result, warm result). The GPU's scatter-adds
    sum in no fixed order, so two runs may take a different number of
    iterations; they must reach the same optimum (final L2 rtol 1e-8)."""
    from psba_tpu.solvers.hybrid import solve

    cold = solve(prob, dtype=dtype, **kw)
    warm = solve(prob, dtype=dtype, **kw)
    rel = abs(warm.final_l2 - cold.final_l2) / cold.final_l2
    check(rel <= 1e-8, f"cold and warm final L2 differ by {rel:.3e}")
    return cold, warm


def solve_row(prob, cold, warm):
    import numpy as np

    check(np.isfinite(warm.final_l2), "non-finite final L2")
    check(warm.final_l2 < warm.initial_l2, "solve made no progress")
    return {
        "initial_rms_px": rms_px(warm.initial_l2, prob.n_obs),
        "final_rms_px": rms_px(warm.final_l2, prob.n_obs),
        "iterations": warm.iterations, "flag": warm.flag_name,
        "phases": warm.phases, "resolved_damping": warm.resolved_damping,
        "wall_s_cold": cold.wall_s, "wall_s_warm": warm.wall_s,
        "cold": {"iterations": cold.iterations, "flag": cold.flag_name,
                 "final_l2_relerr_vs_warm":
                     abs(cold.final_l2 - warm.final_l2) / warm.final_l2},
    }


def lm_memory_analysis(prob, dtype):
    """compiled.memory_analysis() of the LM phase solve() runs first."""
    import jax.numpy as jnp

    from psba_tpu.solvers.lm import lm_run_jit
    from psba_tpu.solvers.types import (
        OptState,
        ProblemArrays,
        SolverConfig,
        resolve_damping,
    )

    pa = ProblemArrays.from_problem(prob, dtype=dtype)
    cams = jnp.asarray(prob.cams, pa.K.dtype)
    pts = jnp.asarray(prob.pts, pa.K.dtype)
    cfg = resolve_damping(SolverConfig.for_dtype(pa.K.dtype), pa, cams, pts)
    state = OptState.init(pa, cams, pts)
    m = lm_run_jit.lower(pa, state, cfg).compile().memory_analysis()
    keys = ("argument_size_in_bytes", "output_size_in_bytes",
            "temp_size_in_bytes", "alias_size_in_bytes",
            "generated_code_size_in_bytes")
    out = {k: int(getattr(m, k)) for k in keys if hasattr(m, k)}
    out["temp_bytes_per_cell"] = out.get("temp_size_in_bytes", 0) / (
        prob.n_cams * prob.n_pts
    )
    return out


def f32_vs_f64(prob, res64, polish=POLISH):
    """f32 run + `polish` f64 LM iterations against the f64 solve."""
    import jax.numpy as jnp

    cold, warm = timed_solve(prob, dtype=jnp.float32, polish_iters=polish)
    row = solve_row(prob, cold, warm)
    rel = abs(rms_px(warm.final_l2, prob.n_obs)
              - rms_px(res64.final_l2, prob.n_obs)) / rms_px(
        res64.final_l2, prob.n_obs)
    row["final_rms_relerr_vs_f64"] = rel
    check(rel <= 1e-6, f"f32+polish RMS relerr {rel:.3e} vs f64 > 1e-6")
    return row


def gpu_vs_cpu(prob, gpu_res):
    """The same f64 solve on the host CPU: same flag, L2 rtol 1e-8."""
    import jax

    from psba_tpu.solvers.hybrid import solve

    with jax.default_device(jax.devices("cpu")[0]):
        cpu = solve(prob)
    rel = abs(gpu_res.final_l2 - cpu.final_l2) / cpu.final_l2
    check(gpu_res.flag == cpu.flag,
          f"flag {gpu_res.flag_name} on the device, {cpu.flag_name} on CPU")
    check(rel <= 1e-8, f"final L2 relerr {rel:.3e} device vs CPU > 1e-8")
    return {"cpu_flag": cpu.flag_name, "cpu_iterations": cpu.iterations,
            "final_l2_relerr_vs_cpu": rel, "cpu_wall_s": cpu.wall_s}


def cli_check(prob, ref_res, out_dir):
    """cli.main in-process on the problem written as a text pair."""
    from psba_tpu import cli
    from psba_tpu.io.bal import write_sba_text

    os.makedirs(out_dir, exist_ok=True)
    cams = os.path.join(out_dir, "cams.txt")
    pts = os.path.join(out_dir, "pts.txt")
    write_sba_text(prob, cams, pts)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["--cams", cams, "--pts", pts, "--json"])
    check(rc == 0, f"cli.main returned {rc}")
    out = json.loads(buf.getvalue().strip().splitlines()[-1])
    # the text pair carries 9 decimals, so the optimum moves slightly
    rel = abs(out["final_l2"] - ref_res.final_l2) / ref_res.final_l2
    check(rel <= 1e-6, f"CLI final L2 relerr {rel:.3e} vs solve() > 1e-6")
    return {"flag": out["flag"], "iterations": out["iterations"],
            "rms_px": out["rms_px"], "wall_s": out["wall_s"],
            "final_l2_relerr_vs_solve": rel}


def four_phase(prob, n_devices=4):
    """solve_sharded over n_devices against the single-device solve().

    f64: whole hybrid solves, the same flag, final L2 within rtol 1e-8.
    f32: the first 10 LM iterations, error after each within rtol 1e-4,
    and whole hybrid solves, each ending within 1e-2 of the f64 RMS; the
    whole f32 solves' flags and final L2 gap are reported, not gated.
    Their endgame runs at f32 roundoff, where the GPU's unordered sums
    send two solves on different paths: at rome93 on four H100s two runs
    ended CONTINUE/CONTINUE 7.0e-4 apart and DP_NO_CHANGE/CONTINUE 2.2e-3
    apart, 4e-4..2e-3 above the f64 RMS. Returns one row per dtype, with
    the devices the sharded solver state lives on; a failed check raises
    with the rows in its message."""
    import jax.numpy as jnp
    import numpy as np

    from psba_tpu.parallel.shard import (
        _make_mesh,
        make_sharded_runners,
        shard_problem,
        solve_sharded,
    )
    from psba_tpu.solvers import SolverConfig
    from psba_tpu.solvers.hybrid import solve

    mesh = _make_mesh(n_devices)
    sp = shard_problem(prob, n_devices)
    pa, cams0, pts0, init_s, _lm, _tr = make_sharded_runners(
        sp, SolverConfig(), mesh, dtype=jnp.float64
    )
    # the solver state as the shard_map'd runners lay it out
    state = init_s(pa, cams0, pts0)
    shard_devices = sorted(
        {str(s.device) for s in state.pts.addressable_shards}
    )
    rows, failed = [], []
    if len(shard_devices) != n_devices:
        failed.append(f"point shards on {shard_devices}")
    for dt in (jnp.float64, jnp.float32):
        cfg = SolverConfig.for_dtype(dt)
        one = solve(prob, cfg, dtype=dt)
        many = solve_sharded(prob, cfg, n_devices=n_devices, dtype=dt)
        rel = abs(many.final_l2 - one.final_l2) / one.final_l2
        row = {
            "dtype": dt.__name__, "n_devices": n_devices,
            "shard_devices": shard_devices,
            "mesh_devices": [str(d) for d in mesh.devices.flat],
            "flag": many.flag_name, "iterations": many.iterations,
            "single_flag": one.flag_name,
            "single_iterations": one.iterations,
            "final_rms_px": rms_px(many.final_l2, prob.n_obs),
            "single_final_rms_px": rms_px(one.final_l2, prob.n_obs),
            "final_l2_relerr_vs_single": rel,
            "wall_s": many.wall_s, "single_wall_s": one.wall_s,
            "phases": many.phases, "single_phases": one.phases,
        }
        if dt == jnp.float64:
            rms64 = rms_px(one.final_l2, prob.n_obs)
            if many.flag != one.flag:
                failed.append(f"f64 flags {many.flag_name} sharded, "
                              f"{one.flag_name} single")
            if not rel <= 1e-8:
                failed.append(f"f64 final L2 relerr {rel:.3e} > 1e-8")
        else:
            for who, res in (("sharded", many), ("single", one)):
                gap = rms_px(res.final_l2, prob.n_obs) / rms64 - 1.0
                row[f"{who}_rms_relerr_vs_f64"] = gap
                if not abs(gap) <= 1e-2:
                    failed.append(f"f32 {who} RMS {gap:.3e} off the f64 "
                                  "RMS (> 1e-2)")
            lm10 = cfg._replace(max_iters=10, lm_switch_count=10**6,
                                record_history=True)
            e1 = solve(prob, lm10, dtype=dt).history[:, 1]
            e4 = solve_sharded(prob, lm10, n_devices=n_devices,
                               dtype=dt).history[:, 1]
            err = float(np.max(np.abs(e4 - e1) / e1))
            row["lm10_max_err_relerr_vs_single"] = err
            if not err <= 1e-4:
                failed.append(f"f32 LM error history relerr {err:.3e} "
                              "> 1e-4")
        rows.append(row)
    if failed:
        raise SmokeFailure("; ".join(failed) + " | rows: "
                           + json.dumps(rows, default=str))
    return rows


# ----------------------------------------------------------------- main


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the 4-GPU sharded rome93 phase and the "
                         "single-GPU solve it is compared with")
    args = ap.parse_args(argv)

    try:
        card = card_line()
    except (OSError, subprocess.SubprocessError) as e:
        card = None
        print(f"nvidia-smi: {e!r}", flush=True)
    devs = require_gpu()
    if card is None:
        raise SystemExit("chip_smoke: nvidia-smi could not name the card")
    print(card, flush=True)

    import jax

    jax.config.update("jax_enable_x64", True)
    from psba_tpu.io import bal_shaped_problem
    from psba_tpu.utils.compile_cache import enable_compile_cache

    cache = enable_compile_cache()
    dev0 = devs[0]
    n_need = 4 if args.four else 1
    if len(devs) < n_need:
        raise SystemExit(f"chip_smoke: {n_need} GPUs needed, "
                         f"{len(devs)} found")
    print(json.dumps({
        "devices": [str(d) for d in devs], "platform": dev0.platform,
        "device_kind": dev0.device_kind, "count": len(devs),
        "jax": jax.__version__, "compile_cache": cache,
    }), flush=True)

    failures = []

    def phase(name, fn):
        t0 = time.perf_counter()
        try:
            row = fn()
        except Exception as e:  # recorded; the run then exits non-zero
            import traceback

            failures.append((name, repr(e)))
            traceback.print_exc()
            row = {"error": repr(e)}
        rows = row if isinstance(row, list) else [row]
        peak = (dev0.memory_stats() or {}).get("peak_bytes_in_use")
        for r in rows:
            print(json.dumps({
                "phase": name, "card": card, **r,
                "phase_s": time.perf_counter() - t0,
                "peak_bytes_in_use": peak,
            }, default=str), flush=True)

    probs = {}

    def prob(name):
        if name not in probs:
            probs[name] = bal_shaped_problem(*SHAPES[name], seed=SEED)
        return probs[name]

    def shape_of(name, dtype):
        p = prob(name)
        return {"shape": {"n_cams": p.n_cams, "n_pts": p.n_pts,
                          "n_obs": p.n_obs}, "dtype": dtype}

    if args.four:
        phase("rome93_four", lambda: four_phase(prob("rome93")))
    else:
        res = {}

        def precision():
            p = prob("rome93")
            return {**shape_of("rome93", "float64+float32"),
                    "residuals": residual_check(p),
                    "jacobians": jacobian_check(p),
                    "schur_S": schur_check(p)}

        def solve64(name):
            def run():
                import jax.numpy as jnp

                p = prob(name)
                cold, warm = timed_solve(p)
                res[name] = warm
                row = {**shape_of(name, "float64"),
                       **solve_row(p, cold, warm)}
                if name == "rome93":
                    row["lm_memory_analysis"] = lm_memory_analysis(
                        p, jnp.float64)
                return row
            return run

        phase("precision", precision)
        phase("rome93_f64", solve64("rome93"))
        phase(f"rome93_f32_polish{POLISH}", lambda: {
            **shape_of("rome93", "float32+float64 polish"),
            **f32_vs_f64(prob("rome93"), res["rome93"]),
        })
        phase("ladybug138_f64", solve64("ladybug138"))
        phase("trafalgar21_f64", solve64("trafalgar21"))
        phase("trafalgar21_gpu_vs_cpu", lambda: {
            **shape_of("trafalgar21", "float64"),
            **gpu_vs_cpu(prob("trafalgar21"), res["trafalgar21"]),
        })
        phase("cli", lambda: {
            **shape_of("trafalgar21", "float64"),
            **cli_check(prob("trafalgar21"), res["trafalgar21"],
                        os.path.join(OUT_DIR, "cli")),
        })

    if failures:
        print(json.dumps({"ok": False, "failures": failures}),
              file=sys.stderr, flush=True)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": dev0.platform, "kind": dev0.device_kind,
        "count": len(devs),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

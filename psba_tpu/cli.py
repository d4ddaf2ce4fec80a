"""Command-line driver.

The reference selects datasets by editing hardcoded paths and recompiling
(PSBA/main.cpp:40-65, SURVEY.md §5 config); this CLI is the replacement:

    python -m psba_tpu.cli --cams CAMS.txt --pts PTS.txt [options]

Prints the same final report surface as the reference driver
(main.cpp:214-227): wall-clock, initial/final error sqrt(L2)/n2Dprojs,
total iterations.
"""

from __future__ import annotations

import argparse
import json
import sys


def build_parser():
    p = argparse.ArgumentParser(
        prog="psba_tpu",
        description="parallel sparse bundle adjustment on JAX/XLA",
    )
    p.add_argument("--cams", help="camera text file")
    p.add_argument("--pts", help="points text file (omit with --synth-pts)")
    p.add_argument("--dataset",
                   help="registered dataset name (see psba_tpu.datasets; "
                        "cams-only BAL sets get synthesized points)")
    p.add_argument("--bal", action="store_true",
                   help="treat --cams as a raw BAL problem file")
    p.add_argument("--shared-K", type=float, nargs=5, default=None,
                   metavar=("FU", "U0", "V0", "AR", "S"),
                   help="shared intrinsics for 7-column camera files")
    p.add_argument("--synth-pts", type=int, default=None, metavar="N",
                   help="synthesize N points for a cams-only dataset "
                        "(regenerates missing BAL points files)")
    p.add_argument("--solver", choices=["hybrid", "lm", "tr"],
                   default="hybrid")
    p.add_argument("--max-iters", type=int, default=50)
    p.add_argument("--tau", type=float, default=1e-3)
    p.add_argument("--f32", action="store_true",
                   help="run the fast float32 pipeline (default float64)")
    p.add_argument("--polish", type=int, default=0, metavar="N",
                   help="append N float64 LM refinement iterations after "
                        "the main run (mixed-precision strategy)")
    p.add_argument("--clamp-quat", action="store_true",
                   help="guard sqrt(1-||v||^2) against NaN")
    p.add_argument("--damping", choices=["auto", "additive", "marquardt"],
                   default="auto",
                   help="LM damping model: additive mu*I (reference "
                        "semantics), scale-invariant multiplicative "
                        "mu*diag(H) for mixed-scale BAL cameras, or auto "
                        "(default: additive unless the measured Hessian "
                        "diagonal range would erase the smallest "
                        "diagonal in the working precision)")
    p.add_argument("--mesh", type=int, default=1,
                   help="shard over N devices (observation axis)")
    p.add_argument("--out-cams", help="write optimized cameras (varK format)")
    p.add_argument("--out-pts", help="write optimized points")
    p.add_argument("--json", action="store_true",
                   help="emit one machine-readable JSON line")
    p.add_argument("--checkpoint",
                   help="checkpoint directory (phase-boundary save/resume)")
    p.add_argument("--verbose", action="store_true",
                   help="print per-iteration progress lines")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)

    import jax

    from psba_tpu.utils.compile_cache import enable_compile_cache
    from psba_tpu.utils.debug import env_nan_checks

    enable_compile_cache()
    env_nan_checks()  # PSBA_DEBUG_NANS=1 enables jit NaN tripwires
    # x64 stays enabled even for --f32: the fast path casts explicitly and
    # the --polish refinement needs real float64
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    import numpy as np

    from psba_tpu.io import bal_to_problem, load_problem
    from psba_tpu.io.synthetic import synthesize_points_for_cams
    from psba_tpu.solvers import SolverConfig
    from psba_tpu.solvers.hybrid import solve

    if args.dataset:
        from psba_tpu import datasets

        prob = datasets.load(args.dataset)
    elif not args.cams:
        sys.exit("error: --cams or --dataset required")
    elif args.bal:
        prob = bal_to_problem(args.cams)
    elif args.synth_pts:
        prob = synthesize_points_for_cams(args.cams, n_pts=args.synth_pts)
    else:
        if not args.pts:
            sys.exit("error: --pts required (or use --synth-pts / --bal)")
        prob = load_problem(args.cams, args.pts, shared_K=args.shared_K)
    print(prob.summary(), file=sys.stderr)

    cfg = SolverConfig.for_dtype(
        jnp.float32 if args.f32 else jnp.float64,
        tau=args.tau,
        max_iters=args.max_iters,
        clamp_quat=args.clamp_quat,
        lm_switch_count=(
            1000 if args.solver == "lm" or args.damping == "marquardt"
            else 5
        ),
        damping=args.damping,
        record_history=args.verbose,
    )
    dtype = jnp.float32 if args.f32 else None

    if args.mesh > 1:
        from psba_tpu.parallel.shard import solve_sharded

        res = solve_sharded(prob, cfg, n_devices=args.mesh, dtype=dtype)
    else:
        res = solve(
            prob, cfg, dtype=dtype,
            start=("tr" if args.solver == "tr" else "lm"),
            checkpoint_dir=args.checkpoint,
            polish_iters=args.polish,
        )
    if args.verbose:
        print(res.format_history(), file=sys.stderr)
        if res.phase_report:
            print(res.phase_report, file=sys.stderr)

    if args.out_cams:
        from psba_tpu.io.sba_text import write_cams

        write_cams(args.out_cams, prob.K, prob.q0, res.cams)
    if args.out_pts:
        np.savetxt(args.out_pts, res.pts, fmt="%.9f")

    if args.json:
        print(json.dumps({
            "initial_error": res.initial_error,
            "final_error": res.final_error,
            "initial_l2": res.initial_l2,
            "final_l2": res.final_l2,
            "rms_px": float(np.sqrt(res.final_l2 / prob.n_obs)),
            "iterations": res.iterations,
            "flag": res.flag_name,
            "wall_s": res.wall_s,
            "phases": res.phases,
        }))
    else:
        # the reference's report block (main.cpp:214-218)
        print(f"time eclipse {res.wall_s:.6f} s")
        print(f"initial error: {res.initial_error:.15E}")
        print(f"final error: {res.final_error:.15E}")
        print(f"total iteration: {res.iterations}")
        print(f"flag: {res.flag_name}   phases: {res.phases}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

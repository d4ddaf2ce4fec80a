"""Observations/s scaling harness (the north-star scaling metric).

Measures the marginal LM-iteration time (fixed-work runs at N1/N2
iterations, early stop disabled) at increasing mesh sizes and reports
observations/s per size.

Interpretation depends on the device fleet:
  - real devices (several GPUs): `efficiency` = t1 / (N * tN) is true
    strong-scaling efficiency (north star: >=80% at 2 hosts);
  - virtual CPU mesh (xla_force_host_platform_device_count, devices share
    the physical cores): wall-clock cannot drop, so the meaningful number
    is `overhead_vs_1dev` = tN / t1 — the cost of the sharded formulation
    (collectives, padding, replicated Schur solve). Ideal = 1.0.

Writes the report to --out (default SCALING.json at the repo root).

    python benchmarks/scaling.py [--dataset trafalgar21] [--sizes 1 2 4 8]
                                 [--dtype f32|f64] [--schur auto]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(
    0, os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)

N1, N2 = 2, 8
REPS = 3


def measure(prob, n_devices, dtype, schur):
    import jax

    from psba_tpu.parallel.shard import (
        _make_mesh,
        make_sharded_runners,
        shard_problem,
    )
    from psba_tpu.solvers.types import SolverConfig

    mesh = _make_mesh(n_devices)
    sp = shard_problem(prob, n_devices, schur=schur)

    def timed(n_iters):
        cfg = SolverConfig(
            max_iters=n_iters, stop_thresh=1e-30, lm_switch_count=10_000,
            damping="additive",
        )
        pa, cams0, pts0, init_s, lm_s, _ = make_sharded_runners(
            sp, cfg, mesh, dtype=dtype
        )
        state0 = init_s(pa, cams0, pts0)
        out = lm_s(pa, state0)  # compile + warm
        assert int(out.itno) == n_iters
        ts = []
        for _ in range(REPS):
            t0 = time.perf_counter()
            out = lm_s(pa, state0)
            out.ex_l2.block_until_ready()
            ts.append(time.perf_counter() - t0)
        return min(ts)

    t1, t2 = timed(N1), timed(N2)
    iter_s = (t2 - t1) / (N2 - N1)
    return {
        "n_devices": n_devices,
        "lm_iter_ms": iter_s * 1e3,
        "observations_per_s": prob.n_obs / iter_s,
        "o_per_shard": sp.o_per,
        "p_per_shard": sp.p_per,
        "schur": "dense" if sp.blk is not None else "pairs",
    }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset", default="trafalgar21")
    ap.add_argument("--sizes", type=int, nargs="+", default=[1, 2, 4, 8])
    ap.add_argument("--dtype", choices=["f32", "f64"], default="f32")
    ap.add_argument("--schur", default="auto")
    ap.add_argument(
        "--out",
        default=os.path.join(os.path.dirname(__file__), "..",
                             "SCALING.json"),
    )
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    jax.config.update("jax_enable_x64", True)

    from psba_tpu import datasets

    prob = datasets.load(args.dataset)
    dtype = jnp.float32 if args.dtype == "f32" else jnp.float64

    devs = jax.devices()
    sizes = [n for n in args.sizes if n <= len(devs)]
    rows = [measure(prob, n, dtype, args.schur) for n in sizes]

    t1 = rows[0]["lm_iter_ms"]
    for r in rows:
        n = r["n_devices"]
        r["speedup"] = t1 / r["lm_iter_ms"]
        r["efficiency"] = r["speedup"] / n
        r["overhead_vs_1dev"] = r["lm_iter_ms"] / t1

    ncores = os.cpu_count()
    report = {
        "dataset": args.dataset,
        "n_obs": prob.n_obs,
        "n_cams": prob.n_cams,
        "n_pts": prob.n_pts,
        "dtype": args.dtype,
        "backend": jax.default_backend(),
        "device": str(devs[0]),
        "n_physical_cores": ncores,
        "virtual_mesh": jax.default_backend() == "cpu"
        and len(devs) > (ncores or 1),
        "rows": rows,
    }
    with open(args.out, "w") as f:
        json.dump(report, f, indent=2)

    hdr = (f"{'mesh':>4} {'iter ms':>9} {'obs/s':>12} "
           f"{'speedup':>8} {'eff':>6} {'ovh':>6}")
    print(hdr)
    for r in rows:
        print(f"{r['n_devices']:>4} {r['lm_iter_ms']:>9.3f} "
              f"{r['observations_per_s']:>12.0f} {r['speedup']:>8.2f} "
              f"{r['efficiency']:>6.2f} {r['overhead_vs_1dev']:>6.2f}")
    print(f"wrote {os.path.abspath(args.out)}")


if __name__ == "__main__":
    main()

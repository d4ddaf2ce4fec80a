"""Per-stage device time of warm LM iterations, from a jax.profiler trace.

    python benchmarks/trace_lm.py [--shape rome93] [--iters 5]
                                  [--out chiprun_out/trace]

For float64 and float32: generate the BAL-shaped problem
(psba_tpu.io.bal_shaped_problem, seed 0), compile and run `--iters` LM
iterations once, time them warm with the profiler off, then trace the
same warm call. Device events are attributed to the solver's named scopes
(linearize, assemble, stack_blocks, vinv, schur_S, reduced_rhs, cholesky,
back_substitute, gain) through the op_name metadata of the compiled HLO.
Prints, per dtype, the stage totals, the top device operations and the
device's idle share over the traced window, each with the card's name and
power limit; writes the same as JSON under --out.

XLA runs the GPU program through CUDA graphs (command buffers) by
default, and a kernel inside one is reported under the graph, not its HLO
op; the script therefore turns command buffers off (XLA_FLAGS
--xla_gpu_enable_command_buffer=) and reports the per-iteration wall time
of that configuration. With --graphs it leaves XLA's default on: the wall
time and idle share are then those of the program users run, and the
stage split is not meaningful.

Needs a GPU; exits non-zero without one.
"""

from __future__ import annotations

import argparse
import collections
import glob
import json
import os
import re
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

STAGES = ("linearize", "assemble", "stack_blocks", "vinv", "schur_S",
          "reduced_rhs", "cholesky", "back_substitute", "gain", "jgram")

_INSTR = re.compile(r"^\s*(?:ROOT\s+)?%?([\w.\-]+)\s*=")
_CALLS = re.compile(r"calls=%?([\w.\-]+)")
_OPNAME = re.compile(r'op_name="([^"]*)"')
_COMP = re.compile(r"^\s*(?:ENTRY\s+)?%?([\w.\-]+)\s.*\{\s*$")


def stage_of(op_name: str) -> str:
    for part in op_name.split("/"):
        if part in STAGES:
            return part
    return "other"


def hlo_stage_map(hlo_text: str) -> dict:
    """HLO instruction name -> stage, from op_name metadata. A fusion
    without metadata takes the most common stage of its computation."""
    by_instr, comp_stages, calls = {}, collections.defaultdict(
        collections.Counter), {}
    comp = None
    for line in hlo_text.splitlines():
        m = _COMP.match(line)
        if m and "=" not in line.split("{")[0]:
            comp = m.group(1)
            continue
        m = _INSTR.match(line)
        if not m:
            continue
        name = m.group(1)
        callee = _CALLS.search(line)
        callee = callee.group(1) if callee else None
        op = _OPNAME.search(line)
        if op:
            st = stage_of(op.group(1))
            by_instr[name] = st
            if comp:
                comp_stages[comp][st] += 1
        elif callee:
            calls[name] = callee
    for name, callee in calls.items():
        c = comp_stages.get(callee)
        if c:
            by_instr[name] = c.most_common(1)[0][0]
    return by_instr


def reduce_trace(trace_dir: str, stage_map: dict,
                 plane_prefix: str = "/device:GPU") -> dict:
    """Stage totals, top ops and idle share from the newest xplane."""
    from jax.profiler import ProfileData

    path = sorted(glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"),
                            recursive=True))[-1]
    pd = ProfileData.from_file(path)
    planes = [p for p in pd.planes if p.name.startswith(plane_prefix)]
    if not planes:
        raise SystemExit(f"no GPU plane in {path}: "
                         f"{[p.name for p in pd.planes]}")
    plane = planes[0]
    lines = {ln.name: list(ln.events) for ln in plane.lines}
    # kernel events live on the stream lines; "XLA Ops"/"XLA Modules"
    # lines, where present, are derived views of the same time
    kernel_lines = [n for n in lines if n.startswith("Stream")] or list(lines)
    stages = collections.Counter()
    ops = collections.defaultdict(lambda: [0.0, 0, "", ""])
    intervals = []
    for ln in kernel_lines:
        for ev in lines[ln]:
            stats = dict(ev.stats)
            hlo_op = str(stats.get("hlo_op", ""))
            st = stage_map.get(hlo_op) or stage_map.get(ev.name, "other")
            dur = float(ev.duration_ns)
            stages[st] += dur
            rec = ops[ev.name]
            rec[0] += dur
            rec[1] += 1
            rec[2], rec[3] = hlo_op, st
            intervals.append((float(ev.start_ns), float(ev.start_ns) + dur))
    intervals.sort()
    busy, end = 0.0, None
    for s, e in intervals:
        if end is None or s > end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    window = intervals[-1][1] - intervals[0][0] if intervals else 0.0
    top = sorted(ops.items(), key=lambda kv: -kv[1][0])[:25]
    return {
        "xplane": os.path.relpath(path),
        "lines": {n: len(v) for n, v in lines.items()},
        "kernel_lines": kernel_lines,
        "stage_device_ms": {k: v / 1e6 for k, v in stages.most_common()},
        "top_ops": [
            {"name": n[:120], "device_ms": r[0] / 1e6, "count": r[1],
             "hlo_op": r[2], "stage": r[3]} for n, r in top
        ],
        "window_ms": window / 1e6,
        "busy_ms": busy / 1e6,
        "idle_share": (1.0 - busy / window) if window else None,
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--shape", default="rome93")
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--out", default="chiprun_out/trace")
    ap.add_argument("--graphs", action="store_true",
                    help="keep XLA's CUDA graphs on (no stage split)")
    args = ap.parse_args(argv)
    if not args.graphs:
        os.environ["XLA_FLAGS"] = (
            os.environ.get("XLA_FLAGS", "")
            + " --xla_gpu_enable_command_buffer="
        )

    import chip_smoke

    card = chip_smoke.card_line()
    devs = chip_smoke.require_gpu()
    import jax
    import jax.numpy as jnp

    jax.config.update("jax_enable_x64", True)
    from psba_tpu.io import bal_shaped_problem
    from psba_tpu.solvers.lm import lm_run_jit
    from psba_tpu.solvers.types import (
        OptState,
        ProblemArrays,
        SolverConfig,
        resolve_damping,
    )
    from psba_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    print(card, flush=True)
    prob = bal_shaped_problem(*chip_smoke.SHAPES[args.shape], seed=0)
    for dt in (jnp.float64, jnp.float32):
        pa = ProblemArrays.from_problem(prob, dtype=dt)
        cams = jnp.asarray(prob.cams, dt)
        pts = jnp.asarray(prob.pts, dt)
        # LM alone, so every traced iteration runs the same stages
        cfg = resolve_damping(
            SolverConfig.for_dtype(dt, lm_switch_count=10**6), pa, cams, pts
        )
        state = OptState.init(pa, cams, pts)
        cap = jnp.int32(args.iters)
        compiled = lm_run_jit.lower(pa, state, cfg, iter_cap=cap).compile()
        stage_map = hlo_stage_map(compiled.as_text())
        out = lm_run_jit(pa, state, cfg, iter_cap=cap)
        out.ex_l2.block_until_ready()
        walls = []
        for _ in range(5):
            t0 = time.perf_counter()
            out = lm_run_jit(pa, state, cfg, iter_cap=cap)
            out.ex_l2.block_until_ready()
            walls.append(time.perf_counter() - t0)
        iters = int(out.itno)
        tdir = os.path.join(args.out, dt.__name__)
        with jax.profiler.trace(tdir):
            out = lm_run_jit(pa, state, cfg, iter_cap=cap)
            out.ex_l2.block_until_ready()
        summary = {
            "card": card, "device_kind": devs[0].device_kind,
            "dtype": dt.__name__, "shape": args.shape,
            "n_cams": prob.n_cams, "n_pts": prob.n_pts,
            "n_obs": prob.n_obs, "lm_iterations": iters,
            "xla_flags": os.environ.get("XLA_FLAGS", ""),
            "damping": cfg.damping,
            "wall_ms_median": sorted(walls)[len(walls) // 2] * 1e3,
            "wall_ms_per_iter": sorted(walls)[len(walls) // 2] * 1e3 / iters,
            **reduce_trace(tdir, stage_map),
        }
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, f"summary_{dt.__name__}.json"),
                  "w") as f:
            json.dump(summary, f, indent=1)
        print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

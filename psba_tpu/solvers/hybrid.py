"""Hybrid LM <-> TR controller.

The reference driver alternates levmar() and trust_region() until either
returns a flag other than the switch requests (PSBA/main.cpp:193-208). This
version keeps the alternation on the host — it transfers exactly one
scalar (the flag) per phase — while each phase runs fully on device.
"""

from __future__ import annotations

import dataclasses
import time

import jax.numpy as jnp
import numpy as np

from psba_tpu import constants as CC
from psba_tpu.problem import BAProblem
from psba_tpu.solvers.lm import lm_fresh_aux, lm_run_jit
from psba_tpu.solvers.tr import tr_fresh_aux, tr_run_jit
from psba_tpu.solvers.types import OptState, ProblemArrays, SolverConfig


@dataclasses.dataclass
class SolveResult:
    cams: np.ndarray
    pts: np.ndarray
    initial_l2: float
    final_l2: float
    initial_error: float   # sqrt(L2)/n2Dprojs — the reference's metric
    final_error: float
    iterations: int
    flag: int
    flag_name: str
    wall_s: float
    phases: list  # [(phase, itno_after, flag_after)]
    history: np.ndarray | None = None  # [iters, 6] per-iteration rows
    # (itno, err, rho, mu|lambda, delta, |p|) when record_history
    phase_report: str = ""  # per-phase wall-clock report (the reference's
    # clock() accumulator table, main.cpp:220-227)
    resolved_damping: str = ""  # the concrete LM damping mode this solve
    # ran ("additive" | "marquardt") after damping="auto" resolution —
    # observability for the silent auto selection (resolve_damping)

    def format_history(self) -> str:
        """Reference-style per-iteration progress lines
        (levmar.cpp:197, trust_region.cpp:250)."""
        if self.history is None:
            return "(no history recorded)"
        lines = []
        for row in self.history:
            if np.isnan(row[0]):
                continue
            itno, err, rho, mul, dk, pn = row
            if np.isnan(dk):
                lines.append(
                    f"itno={int(itno)}\tErr={err:.9E}\trho={rho:f}"
                    f"\tmu={mul:f}"
                )
            else:
                lines.append(
                    f"itno={int(itno)}\tErr={err:.9E}\tDelta={dk:f}"
                    f"\tRho={rho:f}\tnorm_p={pn:f}\tLambda={mul:E}"
                )
        return "\n".join(lines)

    def __str__(self):
        return (
            f"SolveResult(err {self.initial_error:.6e} -> "
            f"{self.final_error:.6e}, iters={self.iterations}, "
            f"flag={self.flag_name}, {self.wall_s:.3f}s)"
        )


def solve(
    problem: BAProblem,
    config: SolverConfig | None = None,
    dtype=None,
    start: str = "lm",
    checkpoint_dir: str | None = None,
    checkpoint_every: int = 8,
    polish_iters: int = 0,
    schur: str = "auto",
) -> SolveResult:
    """Full hybrid optimization of a BAProblem.

    `dtype` optionally casts the problem (e.g. jnp.float32 for the fast
    path); default keeps the problem's own precision.
    `checkpoint_dir` enables checkpointing with automatic resume from the
    newest checkpoint. `checkpoint_every` > 0 additionally chunks each
    phase to at most that many outer iterations per device call (the
    solvers' dynamic `iter_cap` — one trace, no per-chunk recompilation)
    and saves at every chunk boundary with the phase scalars (OptState.aux)
    so resume is exact mid-phase; 0 = phase-boundary checkpoints only.
    `polish_iters` > 0 appends a float64 LM refinement after the main
    (possibly float32) run — the mixed-precision strategy of SURVEY.md §7:
    fast f32 iterations to the f32 floor, then a few emulated-f64 steps to
    reference precision. The polish phase checkpoints and resumes like the
    main phases.
    `schur` in {"auto", "dense", "pairs"} picks the S-assembly encoding
    (see ProblemArrays.from_problem)."""
    cfg = config or SolverConfig.for_dtype(dtype or problem.pts.dtype)
    pa = ProblemArrays.from_problem(problem, dtype=dtype, schur=schur)
    cams = jnp.asarray(problem.cams, dtype=pa.K.dtype)
    pts = jnp.asarray(problem.pts, dtype=pa.K.dtype)
    from psba_tpu.solvers.types import resolve_damping

    cfg = resolve_damping(cfg, pa, cams, pts)

    chunk = int(checkpoint_every) if checkpoint_dir else 0
    phase = start
    resume_itno = 0
    resume_aux = None
    polish_target = None
    if checkpoint_dir:
        from psba_tpu.utils import checkpoint as ckpt

        restored = ckpt.load_latest(checkpoint_dir)
        if restored is not None:
            r_cams, r_pts, meta = restored
            cams = jnp.asarray(r_cams, dtype=pa.K.dtype)
            pts = jnp.asarray(r_pts, dtype=pa.K.dtype)
            phase = meta.get("phase", start)
            resume_itno = int(meta.get("itno", 0))
            resume_aux = meta.get("aux")
            if meta.get("polish_target") is not None:
                polish_target = int(meta["polish_target"])

    # module-level jitted runners: repeated solve() calls (same shapes +
    # cfg) reuse the traced/compiled executables instead of re-jitting a
    # fresh wrapper per call — a warm solve pays zero compile time
    lm, tr = lm_run_jit, tr_run_jit

    state = OptState.init(pa, cams, pts, clamp=cfg.clamp_quat)
    if resume_itno:
        state = state._replace(itno=jnp.int32(resume_itno))
    if resume_aux is not None and phase != "lm64":
        state = state._replace(aux=jnp.asarray(resume_aux, pa.K.dtype))
    initial_l2 = float(state.ex_l2)
    n_obs = problem.n_obs

    from psba_tpu.utils.timing import PhaseTimers

    timers = PhaseTimers()
    t0 = time.perf_counter()
    phases = []
    skip_main = phase == "lm64"  # resumed into the polish phase
    flag = int(state.flag)
    while not skip_main:
        runner = lm if phase == "lm" else tr
        if chunk and state.aux is None:
            fresh = (
                lm_fresh_aux(pa.K.dtype) if phase == "lm"
                else tr_fresh_aux(cfg, pa.K.dtype)
            )
            state = state._replace(aux=fresh)
        with timers.phase(phase):
            if chunk:
                cap = min(int(state.itno) + chunk, cfg.max_iters)
                state = runner(pa, state, cfg, iter_cap=jnp.int32(cap))
            else:
                state = runner(pa, state, cfg)
            flag = int(state.flag)
        # chunk boundary: budget left and no phase-terminating flag
        mid_phase = (
            chunk > 0
            and flag == CC.ITER_CONTINUE
            and int(state.itno) < cfg.max_iters
        )
        if not mid_phase:
            phases.append((phase, int(state.itno), flag))
        next_phase = None
        if mid_phase:
            next_phase = phase
        elif phase == "lm" and flag == CC.ITER_TURN_TO_TR:
            next_phase = "tr"
        elif phase == "tr" and flag == CC.ITER_TURN_TO_LM:
            next_phase = "lm"
        if checkpoint_dir:
            from psba_tpu.utils import checkpoint as ckpt

            ckpt.save(
                checkpoint_dir, state.cams, state.pts, int(state.itno),
                flag, next_phase or phase,
                extra={"ex_l2": float(state.ex_l2)},
                aux=state.aux if mid_phase else None,
            )
        if next_phase is None:
            break
        if not mid_phase:
            # new phase starts with fresh scalars (the reference calls
            # levmar()/trust_region() fresh on every switch)
            state = state._replace(aux=None)
        phase = next_phase

    if polish_iters > 0:
        import numpy as _np

        if _np.dtype(pa.K.dtype) != _np.float64:
            if polish_target is None:
                polish_target = int(state.itno) + polish_iters
            pa64 = ProblemArrays.from_problem(
                problem, dtype=jnp.float64, schur=schur
            )
            cfg64 = SolverConfig.for_dtype(jnp.float64)._replace(
                max_iters=polish_target,
                lm_switch_count=10_000,
                tau=CC.PSBA_POLISH_MU,
            )
            state64 = OptState.init(
                pa64,
                jnp.asarray(state.cams, jnp.float64),
                jnp.asarray(state.pts, jnp.float64),
                clamp=cfg.clamp_quat,
            )._replace(itno=state.itno)
            # re-resolve damping="auto" at f64: thresholds are dtype-
            # dependent (most problems that need marquardt in f32 are
            # representable additively — reference parity — in f64)
            cfg64 = resolve_damping(cfg64, pa64, state64.cams, state64.pts)
            if chunk:
                aux64 = (
                    jnp.asarray(resume_aux, jnp.float64)
                    if skip_main and resume_aux is not None
                    else lm_fresh_aux(jnp.float64)
                )
                state64 = state64._replace(aux=aux64)
            while True:
                with timers.phase("lm64"):
                    if chunk:
                        cap = min(int(state64.itno) + chunk, polish_target)
                        state64 = lm(
                            pa64, state64, cfg64, iter_cap=jnp.int32(cap)
                        )
                    else:
                        state64 = lm(pa64, state64, cfg64)
                    flag = int(state64.flag)
                mid_phase = (
                    chunk > 0
                    and flag == CC.ITER_CONTINUE
                    and int(state64.itno) < polish_target
                )
                if checkpoint_dir:
                    from psba_tpu.utils import checkpoint as ckpt

                    ckpt.save(
                        checkpoint_dir, state64.cams, state64.pts,
                        int(state64.itno), flag, "lm64",
                        extra={
                            "ex_l2": float(state64.ex_l2),
                            "polish_target": polish_target,
                        },
                        aux=state64.aux if mid_phase else None,
                    )
                if not mid_phase:
                    break
            state = state64
            phases.append(("lm64", int(state.itno), flag))
    state.ex_l2.block_until_ready()
    wall = time.perf_counter() - t0

    final_l2 = float(state.ex_l2)
    return SolveResult(
        cams=np.asarray(state.cams),
        pts=np.asarray(state.pts),
        resolved_damping=cfg.damping,
        initial_l2=initial_l2,
        final_l2=final_l2,
        initial_error=float(np.sqrt(initial_l2) / n_obs),
        final_error=float(np.sqrt(final_l2) / n_obs),
        iterations=int(state.itno),
        flag=flag,
        flag_name=CC.FLAG_NAMES.get(flag, str(flag)),
        wall_s=wall,
        phases=phases,
        history=(
            None if state.history is None else np.asarray(state.history)
        ),
        phase_report=timers.report(),
    )

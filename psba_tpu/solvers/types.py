"""Solver configuration and device-resident problem/state containers."""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from psba_tpu import constants as C


class SolverConfig(NamedTuple):
    """Runtime equivalent of the reference's compile-time constants
    (PSBA/psba.h) plus new framework knobs."""

    tau: float = C.PSBA_INIT_MU            # initial damping scale
    stop_thresh: float = C.PSBA_STOP_THRESH
    eps2: float = C.PSBA_EPSILON2
    max_iters: int = C.MAX_TOTAL_ITERS     # shared LM+TR budget
    max_delta: float = C.TR_MAX_DELTA
    init_delta: float = C.TR_INIT_DELTA
    clamp_quat: bool = False               # guard sqrt(1-||v||^2) (opt-in)
    max_inner: int = 64                    # LM damping-retry cap (the
    # reference relies on integer-overflow of nu ~ 31 doublings,
    # levmar.cpp:237-243; an explicit cap is equivalent and jit-friendly)
    lm_switch_count: int = 5               # consecutive |rho-1|<0.2 iters
    # before LM hands off to TR (levmar.cpp:218); set >max_iters to disable
    s_reduce: str = "psum"                 # "psum" | "scatter": collective
    # used for the O(C^2) Schur off-diagonal sum on a mesh; "scatter" =
    # reduce_scatter + all_gather (see MeshCtx.psum_rs), same result
    record_history: bool = False           # per-iteration progress capture
    # (device-side ring of the reference's progress lines: itno/err/rho/mu
    # for LM (levmar.cpp:197), itno/err/delta/rho/|p|/lambda for TR
    # (trust_region.cpp:250)); returned via OptState.history
    damping: str = "auto"                  # "auto" | "additive" |
    # "marquardt": LM damping model. "additive" is the reference's mu*I
    # (update_UV.cl, levmar.cpp:126) seeded at tau*max(diag)
    # (levmar.cpp:113-120). "marquardt" damps each diagonal
    # multiplicatively (mu*diag(H), seeded at plain tau) —
    # scale-invariant, the standard choice for problems whose Hessian
    # diagonal spans many orders of magnitude (real BAL cameras reach
    # diag ratios ~1e26, where additive damping silently aborts: mu =
    # tau*max(diag) drives the first step under the dp-small stop with
    # the error still at its initial value). "auto" (default) resolves
    # to one of the two per problem via `resolve_damping` before
    # tracing: additive (exact reference parity) unless the measured
    # diagonal dynamic range would round the smallest diagonal away in
    # the working precision. Solvers require a resolved mode; "marquardt"
    # has no reference counterpart (framework extension); TR always
    # damps additively as the reference does.

    @classmethod
    def for_dtype(cls, dtype, **overrides) -> "SolverConfig":
        """Defaults adapted to the working precision.

        The reference's 1e-12 relative stop thresholds (psba.h:7-8) sit
        below float32 roundoff (~1e-7): with them, an f32 run can never
        trigger its stop tests and burns the whole iteration budget at the
        optimum. The f32 defaults use reachable thresholds."""
        import numpy as np

        if np.dtype(dtype) == np.float32:
            base = cls(stop_thresh=1e-6, eps2=3e-7)
        else:
            base = cls()
        return base._replace(**overrides) if overrides else base


import functools as _functools


@_functools.partial(jax.jit, static_argnums=(7, 8, 9))
def diag_sums(K, q0, cams, pts, cam_idx, pt_idx, valid, clamp, n_c, n_p):
    """diag(J^T J) as camera [C, 6] and point [P, 3] sums over the given
    observations (a chunk's sums add up to the whole problem's), jitted
    ONCE at module level — an inner-function jit would re-trace and
    re-compile the probe on every resolve_damping call."""
    import jax as _jax

    from psba_tpu.core.jacobian import jacobians

    A, B = jacobians(K, q0, cams, pts, cam_idx, pt_idx, clamp=clamp)
    w = 1.0 if valid is None else valid[:, None].astype(A.dtype)
    dU = _jax.ops.segment_sum((A * A).sum(1) * w, cam_idx, n_c)
    dV = _jax.ops.segment_sum((B * B).sum(1) * w, pt_idx, n_p)
    return dU, dV


def resolve_from_diag(cfg: SolverConfig, dU, dV, dtype) -> SolverConfig:
    """The damping="auto" decision of resolve_damping from diag(J^T J)."""
    d = np.concatenate([np.ravel(dU), np.ravel(dV)])
    pos = d[d > 0]
    dtype = np.dtype(dtype)
    mn = float(pos.min()) if pos.size else 0.0
    ratio = float(d.max()) / max(mn, np.finfo(dtype).tiny)
    if cfg.tau * ratio < 1.0 / np.finfo(dtype).eps:
        return cfg._replace(damping="additive")
    return cfg._replace(
        damping="marquardt",
        lm_switch_count=max(cfg.lm_switch_count, cfg.max_iters + 1),
    )


def resolve_damping(cfg: SolverConfig, pa: "ProblemArrays",
                    cams, pts) -> SolverConfig:
    """Resolve damping="auto" to a concrete mode from the measured
    Hessian-diagonal dynamic range (one Jacobian probe, jitted).

    Criterion (precision-motivated, not curve-fit): additive damping
    seeds mu = tau * max(diag JtJ) (levmar.cpp:115) and adds it to EVERY
    diagonal. In the working precision, a diagonal d is erased entirely
    by `d + mu` once mu/d > 1/eps — the damped system then has no memory
    of that direction's curvature, the first step collapses below the
    dp-small stop (levmar.cpp:169-173), and the run "converges" at its
    starting point. So: additive while

        tau * max(diag)/min(diag>0)  <  1 / eps(dtype)

    and scale-invariant Marquardt damping beyond. Measured dynamic
    ranges on the bundled ladder (f32, tau=1e-3, limit ratio 8.4e9):
    trafalgar21 4.2e8, ladybug138 2.4e9 (additive, converge) vs
    venice52 1.1e10, dubrovnik88 1.3e26 (additive stalls at iteration
    1-2; marquardt converges).

    When marquardt is selected, the LM->TR switch is also disabled
    (lm_switch_count pushed past max_iters): the reference's TR phase
    damps additively (trust_region.cpp:126) and would re-enter the same
    failure.

    Sharded/distributed entry points resolve from the whole problem
    before partitioning, in bounded observation chunks — see
    psba_tpu.parallel.shard._resolve_damping_host — so this probe never
    needs mesh collectives and every entry point decides alike.
    """
    if cfg.damping != "auto":
        return cfg
    dU, dV = diag_sums(pa.K, pa.q0, cams, pts, pa.cam_idx, pa.pt_idx,
                       pa.valid, cfg.clamp_quat, pa.K.shape[0], pts.shape[0])
    return resolve_from_diag(cfg, dU, dV, cams.dtype)


class ProblemArrays(NamedTuple):
    """Device-resident, statically shaped problem data (jit arguments)."""

    K: jnp.ndarray         # [C,5]
    q0: jnp.ndarray        # [C,4]
    obs: jnp.ndarray       # [O,2]
    cam_idx: jnp.ndarray   # [O]
    pt_idx: jnp.ndarray    # [O]  (shard-local point numbering when sharded)
    # Schur sparsity: exactly one of the two encodings is present. Dense:
    # blk_idx [C,P] (n_obs marks unseen cells) drives the gather + matmul
    # path of core/schur.schur_S_dense. Pairs: the covisibility pair list
    # (C*C buckets mark padded entries) drives schur_S. Presence is a
    # pytree-structure property, so solvers dispatch at trace time.
    pair_o1: jnp.ndarray | None = None      # [N]
    pair_o2: jnp.ndarray | None = None      # [N]
    pair_bucket: jnp.ndarray | None = None  # [N]
    blk_idx: jnp.ndarray | None = None      # [C, P]
    valid: jnp.ndarray | None = None  # [O] mask for padded observations

    @staticmethod
    def from_problem(prob, dtype=None, schur="auto"):
        """Build device arrays; `schur` in {"auto", "dense", "pairs"}
        selects the S-assembly encoding (auto = dense while the [C,P] block
        table stays under constants.DENSE_SCHUR_MAX_ENTRIES)."""
        if schur == "auto":
            schur = (
                "dense"
                if prob.n_cams * prob.n_pts <= C.DENSE_SCHUR_MAX_ENTRIES
                else "pairs"
            )
        prob = prob.with_blk() if schur == "dense" else prob.with_pairs()
        cast = (lambda a: jnp.asarray(a)) if dtype is None else (
            lambda a: jnp.asarray(a, dtype=dtype)
            if np.issubdtype(a.dtype, np.floating) else jnp.asarray(a)
        )
        opt = lambda a: None if a is None else jnp.asarray(a)
        return ProblemArrays(
            K=cast(prob.K), q0=cast(prob.q0), obs=cast(prob.obs),
            cam_idx=jnp.asarray(prob.cam_idx),
            pt_idx=jnp.asarray(prob.pt_idx),
            pair_o1=opt(prob.pair_o1),
            pair_o2=opt(prob.pair_o2),
            pair_bucket=opt(prob.pair_bucket),
            blk_idx=opt(prob.blk_idx),
        )

    @property
    def n_cams(self):
        return self.K.shape[0]

    @property
    def n_obs(self):
        return self.obs.shape[0]


class OptState(NamedTuple):
    """Parameters + scalar solver state shared by LM/TR/hybrid.

    All scalars live on device; the hybrid controller reads `flag` (one
    scalar transfer) between phases, mirroring the reference's host-level
    switch loop (main.cpp:193-208)."""

    cams: jnp.ndarray      # [C,6]
    pts: jnp.ndarray       # [P,3]
    ex: jnp.ndarray        # [O,2] residual at current params
    ex_l2: jnp.ndarray     # scalar
    itno: jnp.ndarray      # global iteration counter (shared LM+TR)
    flag: jnp.ndarray      # ITER_* code
    history: jnp.ndarray | None = None  # [max_iters, 6] per-iteration rows
    # (itno, ex_l2, rho, mu-or-lambda, delta, p_norm); NaN-filled unused
    aux: jnp.ndarray | None = None  # [6] phase-scalar carry for chunked
    # checkpointing: LM packs (mu, nu, p_l2, good_cnt, first, 0), TR packs
    # (delta, lambda, origin_lambda, nu, notgood, good_iters). Presence is
    # a pytree-structure property: solvers seed their loop scalars from it
    # when present (exact mid-phase resume) and re-initialize when None
    # (the reference's fresh-call semantics, main.cpp:193-208)

    @staticmethod
    def init(prob_arrays: ProblemArrays, cams, pts, clamp=False, ctx=None):
        from psba_tpu.core.residual import error_l2, residuals
        from psba_tpu.parallel.ctx import NO_MESH

        ctx = ctx or NO_MESH
        p = prob_arrays
        ex = residuals(
            p.K, p.q0, cams, pts, p.obs, p.cam_idx, p.pt_idx, clamp=clamp
        )
        return OptState(
            cams=cams, pts=pts, ex=ex,
            ex_l2=ctx.psum(error_l2(ex, valid=p.valid)),
            itno=jnp.int32(0), flag=jnp.int32(C.ITER_CONTINUE),
        )

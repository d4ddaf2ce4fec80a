"""Dogleg trust-region solver.

Re-design of the reference TR loop (PSBA/trust_region.cpp:49-288)
as one jitted computation (same device-resident-scalar design as
psba_tpu.solvers.lm). Parity map:

  - B = 2 J^T J, g = -2 J^T ex                     (trust_region.cpp:122-137)
  - Cauchy step P_U = -(g^T g / g^T B g) g         (:125-130)
  - Gauss–Newton step P_B = -(S-reduced solve)     (compute_PB, :292-405)
  - lambda bootstrap on Cholesky failure at lambda=0 via GMW modified
    Cholesky: lambda = |sum E| / n                 (:341-366, cl_cholmod.cpp)
  - caller-level escalation lambda *= nu, nu *= 2, nu > 4 -> TURN_TO_LM
                                                   (:141-163)
  - 2-D subspace / dogleg step selection           (compute_p_2, :520-595)
  - rho vs model L(p) = ex_L2 + g^T p + p^T B p /2 (:204-222)
  - radius rules: /4 on rho<1/4, x2 capped on rho>=3/4  (:223-244)
  - NaN rho -> TURN_TO_LM immediately              (:245-249)
  - 5 consecutive rho<1/4 -> TURN_TO_LM; 10 consecutive rho>3/4 ->
    lambda reset to 0                              (:257-272)

Documented deviation: compute_p_2's P_B branch returns ||P_B|| for p_norm
(the reference accumulates onto an already-sqrt'd value,
trust_region.cpp:564-569 — the value only feeds an unused diagnostic).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from psba_tpu import constants as CC
from psba_tpu.core.gmw import gmw_bootstrap_lambda
from psba_tpu.core.hessian import assemble_blocks, damp_uv
from psba_tpu.core.jacobian import jacobians, jmultiply
from psba_tpu.core.linalg import spd_solve
from psba_tpu.core.residual import error_l2, error_l2_diff, residuals
from psba_tpu.core.schur import (
    back_substitute,
    back_substitute_dense,
    inv3x3,
    inv3x3_planar,
    planar_gb,
    reduced_rhs,
    reduced_rhs_dense,
    schur_S,
    schur_S_dense,
    stack_blocks,
    y_blocks,
)
from psba_tpu.parallel.ctx import NO_MESH, MeshCtx
from psba_tpu.solvers.types import OptState, ProblemArrays, SolverConfig


class _SolveCarry(NamedTuple):
    lam: jnp.ndarray
    origin_lam: jnp.ndarray
    nu: jnp.ndarray
    solved: jnp.ndarray
    failed_out: jnp.ndarray    # nu > 4 escalation -> abort TR
    pb_cams: jnp.ndarray
    pb_pts: jnp.ndarray
    tries: jnp.ndarray


class _ModelCarry(NamedTuple):
    cams: jnp.ndarray
    pts: jnp.ndarray
    ex: jnp.ndarray
    ex_l2: jnp.ndarray
    dk: jnp.ndarray
    lam: jnp.ndarray
    origin_lam: jnp.ndarray
    notgood: jnp.ndarray
    good_iters: jnp.ndarray
    flag: jnp.ndarray
    tries: jnp.ndarray
    rho: jnp.ndarray
    p_norm: jnp.ndarray
    act: jnp.ndarray


class _Outer(NamedTuple):
    cams: jnp.ndarray
    pts: jnp.ndarray
    ex: jnp.ndarray
    ex_l2: jnp.ndarray
    dk: jnp.ndarray
    lam: jnp.ndarray
    origin_lam: jnp.ndarray
    nu: jnp.ndarray
    notgood: jnp.ndarray
    good_iters: jnp.ndarray
    itno: jnp.ndarray
    flag: jnp.ndarray
    history: jnp.ndarray


def tr_fresh_aux(cfg: SolverConfig, dtype) -> jnp.ndarray:
    """Phase-start aux vector (delta, lambda, origin_lambda, nu, notgood,
    good_iters) — identical to the scalars tr_run seeds when state.aux is
    None."""
    return jnp.asarray([cfg.init_delta, 0.0, 0.0, 2.0, 0.0, 0.0], dtype)


def _subspace_step(dot, pu_c, pu_p, pb_c, pb_p, g_c, g_p,
                   pUtBpU, pUtBpB, pBtBpB, delta):
    """compute_p_2 (trust_region.cpp:520-595): minimize the quadratic model
    over span{P_U, P_B}; fall back to scaled-P_U / P_B / classic dogleg when
    the minimizer leaves the radius. Returns (p_cams, p_pts, p_norm).
    `dot` is the mesh-aware split inner product."""
    pUg = dot(pu_c, pu_p, g_c, g_p)
    pBg = dot(pb_c, pb_p, g_c, g_p)
    den = -pUtBpB * pUtBpB + pBtBpB * pUtBpU
    eta1 = (pBg * pUtBpB - pBtBpB * pUg) / den
    eta2 = (pUg * pUtBpB - pBg * pUtBpU) / den
    p_c = eta1 * pu_c + eta2 * pb_c
    p_p = eta1 * pu_p + eta2 * pb_p
    p_norm = jnp.sqrt(dot(p_c, p_p, p_c, p_p))

    pu_norm = jnp.sqrt(dot(pu_c, pu_p, pu_c, pu_p))
    pb_norm = jnp.sqrt(dot(pb_c, pb_p, pb_c, pb_p))

    # dogleg tau root (trust_region.cpp:572-591)
    d_c, d_p = pb_c - pu_c, pb_p - pu_p
    e_c, e_p = 2.0 * pu_c - pb_c, 2.0 * pu_p - pb_p
    a = dot(d_c, d_p, d_c, d_p)
    b = 2.0 * dot(d_c, d_p, e_c, e_p)
    c = dot(e_c, e_p, e_c, e_p) - delta * delta
    b2_4ac = b * b - 4.0 * a * c
    b2_4ac = jnp.where(jnp.abs(b2_4ac) < 1e-12, 0.0, b2_4ac)
    tau = (-b + jnp.sqrt(b2_4ac)) / (2.0 * a)
    dog_c = pu_c + (tau - 1.0) * d_c
    dog_p = pu_p + (tau - 1.0) * d_p

    inside = p_norm <= delta
    use_pu = (~inside) & (pu_norm > delta)
    use_pb = (~inside) & (~use_pu) & (pb_norm <= delta)

    scale_pu = delta / pu_norm
    out_c = jnp.where(
        inside, p_c,
        jnp.where(use_pu, scale_pu * pu_c,
                  jnp.where(use_pb, pb_c, dog_c)),
    )
    out_p = jnp.where(
        inside, p_p,
        jnp.where(use_pu, scale_pu * pu_p,
                  jnp.where(use_pb, pb_p, dog_p)),
    )
    out_norm = jnp.where(
        inside, p_norm, jnp.where(use_pb, pb_norm, delta)
    )
    return out_c, out_p, out_norm


def tr_run(
    pa: ProblemArrays,
    state: OptState,
    cfg: SolverConfig,
    ctx: MeshCtx = NO_MESH,
    iter_cap=None,
) -> OptState:
    """Run dogleg TR until a non-PASS flag or the shared iteration budget.

    `iter_cap` (optional traced int32 scalar): dynamic outer-loop bound for
    the hybrid controller's chunked checkpointing (see lm_run)."""
    C = pa.n_cams
    dtype = state.cams.dtype
    P = state.pts.shape[0]
    cap = cfg.max_iters if iter_cap is None else jnp.minimum(
        jnp.int32(iter_cap), cfg.max_iters
    )

    def _dot(a_cams, a_pts, b_cams, b_pts):
        # cameras replicated, points sharded over the mesh
        return jnp.sum(a_cams * b_cams) + ctx.psum(jnp.sum(a_pts * b_pts))

    def outer_cond(s: _Outer):
        # for(; itno < 50; itno++) with `if (flag != ITER_PASS) break`
        return (s.itno < cap) & (
            (s.flag == CC.ITER_PASS) | (s.flag == CC.ITER_CONTINUE)
        )

    # Schur encoding dispatch as in psba_tpu.solvers.lm: dense blk_idx
    # stacking when present in pa, covisibility pair list otherwise
    dense = pa.blk_idx is not None
    # collective for the O(C^2) S assembly (cfg.s_reduce)
    s_psum = ctx.psum_rs if cfg.s_reduce == "scatter" else ctx.psum

    def outer_body(s: _Outer):
        # B-blocks carry coeff 2, g = -(2 J^T ex) (trust_region.cpp:122-137)
        with jax.named_scope("linearize"):
            A, B = jacobians(
                pa.K, pa.q0, s.cams, s.pts, pa.cam_idx, pa.pt_idx,
                clamp=cfg.clamp_quat,
            )
        with jax.named_scope("assemble"):
            U, V, W, ga2, gb2 = assemble_blocks(
                A, B, s.ex, pa.cam_idx, pa.pt_idx, C, P, coeff=2.0,
                valid=pa.valid,
            )
            U = ctx.psum(U)
            g_c, g_p = -ctx.psum(ga2), -gb2
        if dense:
            # loop-invariant across the lambda-escalation retries below
            with jax.named_scope("stack_blocks"):
                ZW = stack_blocks(W, pa.blk_idx)
                g_pp = planar_gb(g_p)

        # Cauchy step P_U = -(g^T g / g^T B g) g (trust_region.cpp:125-130),
        # computed on g normalized by its max |entry|: on badly scaled BAL
        # cameras (Dubrovnik-88: fu up to 1.85e6) g reaches ~1e17 and both
        # g^T g and ||Jg||^2 overflow f32; the gm^2 factors cancel in the
        # ratio, so this is algebraically the reference formula
        gm = ctx.pmax(jnp.maximum(
            jnp.max(jnp.abs(g_c)), jnp.max(jnp.abs(g_p))
        ))
        gm = jnp.where(gm > 0.0, gm, 1.0)
        gh_c, gh_p = g_c / gm, g_p / gm
        with jax.named_scope("jgram"):
            Jg = jmultiply(A, B, gh_c, gh_p, pa.cam_idx, pa.pt_idx)
            gtBg_n = 2.0 * ctx.psum(jnp.sum(Jg * Jg))  # = g^T B g / gm^2
        gtg_n = _dot(gh_c, gh_p, gh_c, gh_p)          # = g^T g / gm^2
        scal = -(gtg_n / gtBg_n)
        pu_c, pu_p = scal * g_c, scal * g_p

        # --- Gauss–Newton step with lambda escalation (compute_PB loop)
        def solve_cond(t: _SolveCarry):
            return (~t.solved) & (~t.failed_out) & (t.tries < 64)

        def solve_body(t: _SolveCarry):
            if dense:
                with jax.named_scope("vinv"):
                    U_d, V_d = damp_uv(U, V, t.lam)
                    Vpl, vok = inv3x3_planar(V_d)
                with jax.named_scope("schur_S"):
                    S, ZY = schur_S_dense(U_d, ZW, Vpl, psum=s_psum)
                with jax.named_scope("reduced_rhs"):
                    ea = reduced_rhs_dense(g_c, g_pp, ZY, psum=ctx.psum)
            else:
                with jax.named_scope("vinv"):
                    U_d, V_d = damp_uv(U, V, t.lam)
                    Vinv, vok = inv3x3(V_d)
                with jax.named_scope("schur_S"):
                    Y = y_blocks(W, Vinv, pa.pt_idx)
                    S = schur_S(
                        U_d, Y, W, pa.pair_o1, pa.pair_o2, pa.pair_bucket,
                        C, psum=s_psum,
                    )
                with jax.named_scope("reduced_rhs"):
                    ea = reduced_rhs(
                        g_c, g_p, Y, pa.cam_idx, pa.pt_idx, C, psum=ctx.psum
                    )
            with jax.named_scope("cholesky"):
                dpa_flat, ok = spd_solve(S, ea.reshape(-1))
            # singular V blocks poison S; escalate lambda exactly like a
            # Cholesky failure (compute_PB :341-371)
            ok = ok & ctx.pand(vok)
            dpa = dpa_flat.reshape(C, 6)
            with jax.named_scope("back_substitute"):
                if dense:
                    _ebp, dpb = back_substitute_dense(g_pp, ZW, Vpl, dpa)
                else:
                    _eb, dpb = back_substitute(
                        g_p, W, Vinv, dpa, pa.cam_idx, pa.pt_idx, P
                    )
            pb_c_new, pb_p_new = -dpa, -dpb

            # failure handling (compute_PB :341-371 + caller :143-158)
            lam_was_zero = t.lam == 0.0
            lam_boot = jax.lax.cond(
                (~ok) & lam_was_zero,
                lambda: gmw_bootstrap_lambda(S),
                lambda: jnp.asarray(0.0, dtype),
            )
            lam_fail = jnp.where(lam_was_zero, lam_boot, 2.0 * t.lam)
            # caller escalation when a lambda>0 had already succeeded
            esc = (~ok) & (t.origin_lam != 0.0)
            failed_out = esc & (t.nu > 4.0)
            lam_next = jnp.where(
                ok, t.lam, jnp.where(esc, lam_fail * t.nu, lam_fail)
            )
            nu_next = jnp.where(
                ok, 2.0, jnp.where(esc, t.nu * 2.0, t.nu)
            )
            return _SolveCarry(
                lam=lam_next,
                origin_lam=jnp.where(ok, t.lam, t.origin_lam),
                nu=nu_next,
                solved=ok,
                failed_out=failed_out,
                pb_cams=jnp.where(ok, pb_c_new, t.pb_cams),
                pb_pts=jnp.where(ok, pb_p_new, t.pb_pts),
                tries=t.tries + 1,
            )

        t0 = _SolveCarry(
            lam=s.lam, origin_lam=s.origin_lam, nu=s.nu,
            solved=jnp.bool_(False), failed_out=jnp.bool_(False),
            pb_cams=jnp.zeros_like(s.cams), pb_pts=jnp.zeros_like(s.pts),
            tries=jnp.int32(0),
        )
        t = jax.lax.while_loop(solve_cond, solve_body, t0)
        pb_c, pb_p = t.pb_cams, t.pb_pts
        solve_aborted = t.failed_out | (~t.solved)

        # curvature scalars (trust_region.cpp:166-176)
        with jax.named_scope("jgram"):
            Jpu = jmultiply(A, B, pu_c, pu_p, pa.cam_idx, pa.pt_idx)
            Jpb = jmultiply(A, B, pb_c, pb_p, pa.cam_idx, pa.pt_idx)
            pUtBpU = 2.0 * ctx.psum(jnp.sum(Jpu * Jpu))
            pUtBpB = 2.0 * ctx.psum(jnp.sum(Jpu * Jpb))
            pBtBpB = 2.0 * ctx.psum(jnp.sum(Jpb * Jpb))

        # --- model/radius loop (trust_region.cpp:180-279)
        def model_cond(m: _ModelCarry):
            # tries-cap is a liveness backstop absent in the reference (its
            # while loop can in principle spin on a vanishing radius)
            return (m.flag == CC.ITER_CONTINUE) & (m.tries < 200)

        def model_body(m: _ModelCarry):
            p_c, p_p, p_norm = _subspace_step(
                _dot, pu_c, pu_p, pb_c, pb_p, g_c, g_p,
                pUtBpU, pUtBpB, pBtBpB, m.dk,
            )
            new_cams = m.cams + p_c
            new_pts = m.pts + p_p
            with jax.named_scope("gain"):
                new_ex = residuals(
                    pa.K, pa.q0, new_cams, new_pts, pa.obs, pa.cam_idx,
                    pa.pt_idx, clamp=cfg.clamp_quat,
                )
                act = ctx.psum(error_l2(new_ex, valid=pa.valid))
                gain = ctx.psum(
                    error_l2_diff(m.ex, new_ex, valid=pa.valid)
                )
            tiny = jnp.abs(gain / m.ex_l2) < cfg.eps2

            # p^T B p must be an explicit |J p|^2 (sum of squares, as the
            # reference materializes it, trust_region.cpp:204-212): the
            # algebraically-equal expansion over the 2x2 {P_U,P_B} Gram
            # cancels catastrophically in f32 when p nearly minimizes the
            # model — measured on 7camsvarK-f32 it mis-predicts rho near
            # convergence and parks TR ~6% above the optimum
            with jax.named_scope("jgram"):
                Jp = jmultiply(A, B, p_c, p_p, pa.cam_idx, pa.pt_idx)
                ptBp = 2.0 * ctx.psum(jnp.sum(Jp * Jp))
            pred = m.ex_l2 + _dot(g_c, g_p, p_c, p_p) + 0.5 * ptBp
            rho = gain / (m.ex_l2 - pred)

            improved = gain > 0
            # the reference's reduce test is STRICT act>ex (gain<0, not
            # gain<=0; trust_region.cpp:223): with gain==0 and NaN rho
            # (pred==ex so the denominator vanishes) no branch claims
            # the try and the isnan check fires TURN_TO_LM. A real rho
            # with gain==0 is 0 and reduces either way, so the strict
            # form only changes the NaN routing — kept identical to the
            # reference's ordering (trust_region.cpp:223-249)
            reduce_region = (rho < 0.25) | (gain < 0)
            accept_hi = (rho >= 0.75) & improved
            accept_lo = (rho >= 0.25) & (rho < 0.75) & improved
            accept = (accept_hi | accept_lo) & ~tiny
            nan_rho = jnp.isnan(rho) & ~reduce_region & ~accept_hi & ~accept_lo

            dk_next = jnp.where(
                tiny, m.dk,
                jnp.where(
                    reduce_region, m.dk / 4.0,
                    jnp.where(
                        accept_hi,
                        jnp.minimum(2.0 * m.dk, cfg.max_delta),
                        m.dk,
                    ),
                ),
            )
            flag1 = jnp.where(accept, jnp.int32(CC.ITER_PASS), m.flag)

            # stop test (:252-255)
            stop_small = jnp.abs(gain / m.ex_l2) <= cfg.eps2
            # not-good counter (:257-263)
            notgood = jnp.where(rho < 0.25, m.notgood + 1, jnp.int32(0))
            to_lm = notgood >= 5
            # good-iteration lambda reset (:267-272)
            good_iters = jnp.where(
                (rho > 0.75) & improved, m.good_iters + 1, jnp.int32(0)
            )
            reset_lam = good_iters >= 10
            lam_next = jnp.where(reset_lam, 0.0, m.lam)
            origin_next = jnp.where(reset_lam, 0.0, m.origin_lam)
            good_iters = jnp.where(reset_lam, 0, good_iters)

            flag2 = jnp.where(
                tiny, jnp.int32(CC.ITER_DP_NO_CHANGE),
                jnp.where(
                    nan_rho, jnp.int32(CC.ITER_TURN_TO_LM),
                    jnp.where(
                        stop_small, jnp.int32(CC.ITER_ERR_SMALL_ENOUGH),
                        jnp.where(
                            to_lm, jnp.int32(CC.ITER_TURN_TO_LM), flag1
                        ),
                    ),
                ),
            )
            # ex_l2 tracking (:273-276) — on any improving rho>1/4 step
            track = (rho > 0.25) & improved & ~tiny & ~nan_rho
            return _ModelCarry(
                cams=jnp.where(accept, new_cams, m.cams),
                pts=jnp.where(accept, new_pts, m.pts),
                ex=jnp.where(accept, new_ex, m.ex),
                ex_l2=jnp.where(track, m.ex_l2 - gain, m.ex_l2),
                dk=dk_next,
                lam=lam_next,
                origin_lam=origin_next,
                notgood=notgood,
                good_iters=good_iters,
                flag=flag2,
                tries=m.tries + 1,
                rho=rho,
                p_norm=p_norm,
                act=act,
            )

        nan = jnp.asarray(jnp.nan, dtype)
        m0 = _ModelCarry(
            cams=s.cams, pts=s.pts, ex=s.ex, ex_l2=s.ex_l2, dk=s.dk,
            lam=t.lam, origin_lam=t.origin_lam,
            notgood=s.notgood, good_iters=s.good_iters,
            flag=jnp.int32(CC.ITER_CONTINUE), tries=jnp.int32(0),
            rho=nan, p_norm=nan, act=nan,
        )
        m = jax.lax.cond(
            solve_aborted,
            lambda: m0._replace(flag=jnp.int32(CC.ITER_TURN_TO_LM)),
            lambda: jax.lax.while_loop(model_cond, model_body, m0),
        )
        m = m._replace(
            flag=jnp.where(
                m.tries >= 200, jnp.int32(CC.ITER_TURN_TO_LM), m.flag
            )
        )

        history = s.history
        if cfg.record_history:
            row = jnp.stack([
                s.itno.astype(dtype), m.act, m.rho, m.lam, m.dk, m.p_norm,
            ])
            history = history.at[s.itno].set(row)
        return _Outer(
            cams=m.cams, pts=m.pts, ex=m.ex, ex_l2=m.ex_l2, dk=m.dk,
            lam=m.lam, origin_lam=m.origin_lam, nu=t.nu,
            notgood=m.notgood, good_iters=m.good_iters,
            itno=s.itno + 1, flag=m.flag, history=history,
        )

    history = state.history
    if cfg.record_history and history is None:
        history = jnp.full((cfg.max_iters, 6), jnp.nan, dtype)
    elif not cfg.record_history:
        history = None  # absent from the carry pytree
    if state.aux is None:
        dk0 = jnp.asarray(cfg.init_delta, dtype)
        lam0 = jnp.asarray(0.0, dtype)
        origin0 = jnp.asarray(0.0, dtype)
        nu0 = jnp.asarray(2.0, dtype)
        ng0 = jnp.int32(0)
        gi0 = jnp.int32(0)
    else:
        a = state.aux.astype(dtype)
        dk0, lam0, origin0, nu0 = a[0], a[1], a[2], a[3]
        ng0 = a[4].astype(jnp.int32)
        gi0 = a[5].astype(jnp.int32)
    s0 = _Outer(
        cams=state.cams, pts=state.pts, ex=state.ex, ex_l2=state.ex_l2,
        dk=dk0, lam=lam0, origin_lam=origin0, nu=nu0,
        notgood=ng0, good_iters=gi0,
        itno=state.itno, flag=jnp.int32(CC.ITER_CONTINUE), history=history,
    )
    s = jax.lax.while_loop(outer_cond, outer_body, s0)
    flag = jnp.where(
        s.flag == CC.ITER_PASS, jnp.int32(CC.ITER_CONTINUE), s.flag
    )
    aux = None
    if state.aux is not None:
        aux = jnp.stack([
            s.dk, s.lam, s.origin_lam, s.nu,
            s.notgood.astype(dtype), s.good_iters.astype(dtype),
        ])
    return OptState(
        cams=s.cams, pts=s.pts, ex=s.ex, ex_l2=s.ex_l2, itno=s.itno,
        flag=flag,
        history=s.history if cfg.record_history else None,
        aux=aux,
    )


tr_run_jit = jax.jit(tr_run, static_argnames=("cfg", "ctx"))

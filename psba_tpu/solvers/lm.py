"""Levenberg–Marquardt solver.

Re-design of the reference LM loop (PSBA/levmar.cpp:45-256).
The reference interleaves ~15 synchronous kernel launches with host
readbacks of ex/g/dp every iteration (SURVEY.md §3.2); here the *entire*
run — outer iteration loop and inner damping-retry loop included — is one
jitted computation built from `lax.while_loop`, so all control scalars
(mu, nu, rho, stop tests) stay on device and the host syncs exactly once
per `lm_run` call.

Algorithmic parity (same constants, same update rules):
  - initial damping mu = tau * max(diag U, diag V)      (levmar.cpp:115)
  - additive damping of U/V diagonals                    (update_UV.cl)
  - Schur solve for dpa, back-substitution for dpb       (levmar.cpp:124-155)
  - stop tests on ||dp||^2 vs ||p||^2                    (levmar.cpp:169-179)
  - gain ratio rho = (ex_L2-new_L2)/sum dp(mu dp + g)    (levmar.cpp:271-280)
  - Nielsen update mu *= max(1/3, 1-(2rho-1)^3), nu=2    (levmar.cpp:200-223)
  - rejection: mu *= nu, nu *= 2, overflow -> ITER_ERR   (levmar.cpp:237-244)
  - switch to TR after 5 consecutive iters |rho-1|<1/5   (levmar.cpp:215-221)

Intentional improvement: S is factor-and-solved instead of explicitly
inverted (see psba_tpu.core.linalg).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from psba_tpu import constants as CC
from psba_tpu.core.hessian import (
    assemble_blocks,
    damp_uv,
    damp_uv_marquardt,
    max_diag,
)
from psba_tpu.core.jacobian import jacobians
from psba_tpu.core.linalg import spd_solve
from psba_tpu.core.residual import error_l2_diff, residuals
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

_NU_OVERFLOW = float(2 ** 31)  # reference: int nu wraps (levmar.cpp:238-243)


def lm_fresh_aux(dtype) -> jnp.ndarray:
    """Phase-start aux vector (mu, nu, p_l2, good_cnt, first=1, pad) —
    identical to the scalars lm_run seeds when state.aux is None."""
    return jnp.asarray([0.0, 2.0, 1e3, 0.0, 1.0, 0.0], dtype)


class _Inner(NamedTuple):
    cams: jnp.ndarray
    pts: jnp.ndarray
    ex: jnp.ndarray
    ex_l2: jnp.ndarray
    mu: jnp.ndarray
    nu: jnp.ndarray
    p_l2: jnp.ndarray
    good_cnt: jnp.ndarray
    flag: jnp.ndarray
    accepted: jnp.ndarray
    tries: jnp.ndarray
    rho: jnp.ndarray


class _Outer(NamedTuple):
    cams: jnp.ndarray
    pts: jnp.ndarray
    ex: jnp.ndarray
    ex_l2: jnp.ndarray
    mu: jnp.ndarray
    nu: jnp.ndarray
    p_l2: jnp.ndarray
    good_cnt: jnp.ndarray
    itno: jnp.ndarray
    flag: jnp.ndarray
    first: jnp.ndarray
    history: jnp.ndarray


def lm_run(
    pa: ProblemArrays,
    state: OptState,
    cfg: SolverConfig,
    ctx: MeshCtx = NO_MESH,
    iter_cap=None,
) -> OptState:
    """Run LM until a non-CONTINUE flag or the shared iteration budget.

    Jit-compatible; `cfg`/`ctx` fields are Python constants baked at trace
    time. With a mesh context, `pa`/`pts`/`ex` hold the local point shard
    and camera-side quantities are kept replicated via psum (see
    psba_tpu.parallel).

    `iter_cap` (optional traced int32 scalar) stops the outer loop at a
    dynamic global-iteration bound below cfg.max_iters — the hybrid
    controller's chunked checkpointing uses it to regain host control every
    K iterations without recompiling per chunk."""

    def _params_l2(cams, pts):
        # cameras are replicated; the point shard reduces over the mesh
        return jnp.sum(cams * cams) + ctx.psum(jnp.sum(pts * pts))

    C = pa.n_cams
    dtype = state.cams.dtype
    stop2 = jnp.asarray(cfg.stop_thresh, dtype) ** 2
    eps_sq = jnp.asarray(CC.PSBA_EPSILON_SQ, dtype)

    def inner_cond(s: _Inner):
        return (
            (s.flag == CC.ITER_CONTINUE)
            & (~s.accepted)
            & (s.tries < cfg.max_inner)
        )

    cap = cfg.max_iters if iter_cap is None else jnp.minimum(
        jnp.int32(iter_cap), cfg.max_iters
    )

    def outer_cond(s: _Outer):
        return (s.itno < cap) & (s.flag == CC.ITER_CONTINUE)

    # Schur encoding is a pytree-structure property of pa (types.py): dense
    # blk_idx stacking when present, covisibility pair list otherwise
    dense = pa.blk_idx is not None
    if cfg.damping == "auto":
        raise ValueError(
            'cfg.damping="auto" must be resolved before lm_run (it '
            "selects a traced program): call "
            "psba_tpu.solvers.types.resolve_damping(cfg, pa, cams, pts) "
            "— hybrid.solve / solve_sharded do this automatically"
        )
    marq = cfg.damping == "marquardt"
    # collective for the O(C^2) S assembly (cfg.s_reduce)
    s_psum = ctx.psum_rs if cfg.s_reduce == "scatter" else ctx.psum

    def outer_body(s: _Outer):
        P_loc = s.pts.shape[0]
        with jax.named_scope("linearize"):
            A, B = jacobians(
                pa.K, pa.q0, s.cams, s.pts, pa.cam_idx, pa.pt_idx,
                clamp=cfg.clamp_quat,
            )
        with jax.named_scope("assemble"):
            U, V, W, ga, gb = assemble_blocks(
                A, B, s.ex, pa.cam_idx, pa.pt_idx, C, P_loc,
                coeff=1.0, valid=pa.valid,
            )
            U = ctx.psum(U)
            ga = ctx.psum(ga)
        if dense:
            # loop-invariant across damping retries: W is fixed per outer
            # iteration, so the gather happens once; every retry below is
            # pure dense matmuls against the planar ZW [6C, 3P]
            with jax.named_scope("stack_blocks"):
                ZW = stack_blocks(W, pa.blk_idx)
                gbp = planar_gb(gb)
        # first-iteration damping seed: additive = tau * max(diag)
        # (levmar.cpp:113-120); marquardt = plain tau (dimensionless —
        # the diag factors live in the damping itself)
        if marq:
            mu0 = jnp.asarray(cfg.tau, dtype)
        else:
            mu0 = cfg.tau * ctx.pmax(max_diag(U, V))
        mu = jnp.where(s.first, mu0, s.mu)
        nu = jnp.where(s.first, 2.0, s.nu)
        p_l2 = jnp.where(s.first, 1e3, s.p_l2)

        # Marquardt gain-ratio denominator needs the undamped diagonals
        if marq:
            dU = jnp.diagonal(U, axis1=-2, axis2=-1)          # [C, 6]
            dV = jnp.diagonal(V, axis1=-2, axis2=-1)          # [P, 3]

        def inner_body(t: _Inner):
            _damp = damp_uv_marquardt if marq else damp_uv
            if dense:
                with jax.named_scope("vinv"):
                    U_d, V_d = _damp(U, V, t.mu)
                    Vpl, vok = inv3x3_planar(V_d)
                with jax.named_scope("schur_S"):
                    S, ZY = schur_S_dense(U_d, ZW, Vpl, psum=s_psum)
                with jax.named_scope("reduced_rhs"):
                    ea = reduced_rhs_dense(ga, gbp, ZY, psum=ctx.psum)
            else:
                with jax.named_scope("vinv"):
                    U_d, V_d = _damp(U, V, t.mu)
                    Vinv, vok = inv3x3(V_d)
                with jax.named_scope("schur_S"):
                    Y = y_blocks(W, Vinv, pa.pt_idx)
                    S = schur_S(
                        U_d, Y, W, pa.pair_o1, pa.pair_o2, pa.pair_bucket,
                        C, psum=s_psum,
                    )
                with jax.named_scope("reduced_rhs"):
                    ea = reduced_rhs(
                        ga, gb, Y, pa.cam_idx, pa.pt_idx, C, psum=ctx.psum
                    )
            with jax.named_scope("cholesky"):
                dpa_flat, ok = spd_solve(S, ea.reshape(-1))
            # a singular V block poisons S/eb/dpb; treat it exactly like a
            # Cholesky failure -> mu*nu escalation (levmar.cpp:227-244)
            ok = ok & ctx.pand(vok)
            dpa = dpa_flat.reshape(C, 6)
            with jax.named_scope("back_substitute"):
                if dense:
                    _ebp, dpb = back_substitute_dense(gbp, ZW, Vpl, dpa)
                else:
                    _eb, dpb = back_substitute(
                        gb, W, Vinv, dpa, pa.cam_idx, pa.pt_idx,
                        t.pts.shape[0],
                    )
            dp_l2 = jnp.sum(dpa * dpa) + ctx.psum(jnp.sum(dpb * dpb))

            # stop tests (levmar.cpp:169-179), only meaningful on a valid dp
            stop_small = ok & (dp_l2 < t.p_l2 * stop2)
            stop_singular = ok & (
                dp_l2 >= (t.p_l2 + cfg.stop_thresh) / eps_sq
            )

            # trial step (levmar.cpp:185-195)
            new_cams = t.cams + dpa
            new_pts = t.pts + dpb
            with jax.named_scope("gain"):
                new_ex = residuals(
                    pa.K, pa.q0, new_cams, new_pts, pa.obs, pa.cam_idx,
                    pa.pt_idx, clamp=cfg.clamp_quat,
                )
                # gain-ratio denominator dp^T (mu D dp + g)
                # (levmar.cpp:271-280 with D = I; D = diag(H) under
                # Marquardt damping)
                if marq:
                    Dc = jnp.where(dU > 0.0, dU, 1.0)
                    Dp = jnp.where(dV > 0.0, dV, 1.0)
                    denom = jnp.sum(dpa * (t.mu * Dc * dpa + ga)) + ctx.psum(
                        jnp.sum(dpb * (t.mu * Dp * dpb + gb))
                    )
                else:
                    denom = jnp.sum(dpa * (t.mu * dpa + ga)) + ctx.psum(
                        jnp.sum(dpb * (t.mu * dpb + gb))
                    )
                # gain-ratio numerator in factored form (error_l2_diff):
                # exact in infinite precision, conditioned for f32 near
                # convergence
                gain = ctx.psum(error_l2_diff(t.ex, new_ex, valid=pa.valid))
            rho = gain / denom
            rho = jnp.where(ok, rho, -1.0)

            accept = (rho > 0) & ok & ~stop_small & ~stop_singular

            # --- acceptance branch (levmar.cpp:200-222)
            tmp = 2.0 * rho - 1.0
            shrink = jnp.maximum(1.0 - tmp * tmp * tmp, 1.0 / 3.0)
            good = jnp.abs(rho - 1.0) < 0.2
            good_cnt_acc = jnp.where(good, t.good_cnt + 1, 0)
            flag_acc = jnp.where(
                good_cnt_acc >= cfg.lm_switch_count,
                jnp.int32(CC.ITER_TURN_TO_TR),
                t.flag,
            )

            # --- rejection branch (levmar.cpp:227-244); gooditer_cnt is
            # reset only on a *solve failure* in the reference (line 228;
            # the rho<=0 reset is commented out, lines 224-225)
            mu_rej = t.mu * t.nu
            nu_rej = 2.0 * t.nu
            flag_rej = jnp.where(
                nu_rej >= _NU_OVERFLOW, jnp.int32(CC.ITER_ERR), t.flag
            )
            good_cnt_rej = jnp.where(ok, t.good_cnt, 0)

            stop_flag = jnp.where(
                stop_small,
                jnp.int32(CC.ITER_DP_NO_CHANGE),
                jnp.where(stop_singular, jnp.int32(CC.ITER_ERR), t.flag),
            )
            stopped = stop_small | stop_singular

            return _Inner(
                cams=jnp.where(accept, new_cams, t.cams),
                pts=jnp.where(accept, new_pts, t.pts),
                ex=jnp.where(accept, new_ex, t.ex),
                ex_l2=jnp.where(accept, t.ex_l2 - gain, t.ex_l2),
                mu=jnp.where(
                    stopped, t.mu,
                    jnp.where(accept, t.mu * shrink, mu_rej),
                ),
                nu=jnp.where(
                    stopped, t.nu, jnp.where(accept, 2.0, nu_rej)
                ),
                p_l2=jnp.where(
                    accept, _params_l2(new_cams, new_pts), t.p_l2
                ),
                good_cnt=jnp.where(
                    accept, good_cnt_acc,
                    jnp.where(stopped, t.good_cnt, good_cnt_rej),
                ),
                flag=jnp.where(
                    stopped, stop_flag,
                    jnp.where(accept, flag_acc, flag_rej),
                ),
                accepted=accept,
                tries=t.tries + 1,
                rho=rho,
            )

        t0 = _Inner(
            cams=s.cams, pts=s.pts, ex=s.ex, ex_l2=s.ex_l2, mu=mu, nu=nu,
            p_l2=p_l2, good_cnt=s.good_cnt,
            flag=s.flag, accepted=jnp.bool_(False), tries=jnp.int32(0),
            rho=jnp.asarray(jnp.nan, dtype),
        )
        t = jax.lax.while_loop(inner_cond, inner_body, t0)
        # retry budget exhausted without acceptance -> ERR; an accept on
        # the final allowed try is still a normal accepted iteration
        flag = jnp.where(
            (t.tries >= cfg.max_inner) & ~t.accepted,
            jnp.int32(CC.ITER_ERR),
            t.flag,
        )
        # error-small test at the end of every outer iteration
        # (levmar.cpp:247-248; overrides the inner flag as in the reference)
        flag = jnp.where(
            t.ex_l2 <= cfg.stop_thresh,
            jnp.int32(CC.ITER_ERR_SMALL_ENOUGH),
            flag,
        )
        history = s.history
        if cfg.record_history:
            nan = jnp.asarray(jnp.nan, dtype)
            row = jnp.stack([
                s.itno.astype(dtype), t.ex_l2, t.rho, t.mu, nan, nan,
            ])
            history = history.at[s.itno].set(row)
        return _Outer(
            cams=t.cams, pts=t.pts, ex=t.ex, ex_l2=t.ex_l2, mu=t.mu,
            nu=t.nu, p_l2=t.p_l2, good_cnt=t.good_cnt,
            itno=s.itno + 1, flag=flag, first=jnp.bool_(False),
            history=history,
        )

    history = state.history
    if cfg.record_history and history is None:
        history = jnp.full((cfg.max_iters, 6), jnp.nan, dtype)
    elif not cfg.record_history:
        history = None  # absent from the carry pytree
    if state.aux is None:
        mu0 = jnp.asarray(0.0, dtype)
        nu0 = jnp.asarray(2.0, dtype)
        p_l20 = jnp.asarray(1e3, dtype)
        good0 = jnp.int32(0)
        first0 = jnp.bool_(True)
    else:
        a = state.aux.astype(dtype)
        mu0, nu0, p_l20 = a[0], a[1], a[2]
        good0 = a[3].astype(jnp.int32)
        first0 = a[4] > 0.5
    s0 = _Outer(
        cams=state.cams, pts=state.pts, ex=state.ex, ex_l2=state.ex_l2,
        mu=mu0, nu=nu0, p_l2=p_l20, good_cnt=good0,
        itno=state.itno, flag=jnp.int32(CC.ITER_CONTINUE),
        first=first0, history=history,
    )
    s = jax.lax.while_loop(outer_cond, outer_body, s0)
    aux = None
    if state.aux is not None:
        aux = jnp.stack([
            s.mu, s.nu, s.p_l2, s.good_cnt.astype(dtype),
            s.first.astype(dtype), jnp.zeros((), dtype),
        ])
    # loop may exit on the iteration budget with flag still CONTINUE;
    # the hybrid controller treats CONTINUE as exhausted-budget
    return OptState(
        cams=s.cams, pts=s.pts, ex=s.ex, ex_l2=s.ex_l2, itno=s.itno,
        flag=s.flag,
        history=s.history if cfg.record_history else None,
        aux=aux,
    )


lm_run_jit = jax.jit(lm_run, static_argnames=("cfg", "ctx"))

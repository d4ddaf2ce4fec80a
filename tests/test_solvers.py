"""End-to-end convergence tests (the reference's graded problem ladder,
SURVEY.md §4.4, promoted to assertions)."""

import numpy as np
import pytest

from psba_tpu import constants as CC
from psba_tpu.solvers import SolverConfig
from psba_tpu.solvers.hybrid import solve
from tests.conftest import requires_data


def rms_px(res, n_obs):
    return float(np.sqrt(res.final_l2 / n_obs))


def test_lm_converges_synth(prob_synth):
    res = solve(prob_synth, SolverConfig(lm_switch_count=1000))
    # noise_px=0.5 ground truth noise: solver must reach the noise floor
    assert rms_px(res, prob_synth.n_obs) < 0.65
    assert res.final_l2 < 0.08 * res.initial_l2
    assert res.flag in (
        CC.ITER_DP_NO_CHANGE, CC.ITER_ERR_SMALL_ENOUGH, CC.ITER_CONTINUE
    )


def test_hybrid_converges_synth(prob_synth):
    res = solve(prob_synth)
    assert rms_px(res, prob_synth.n_obs) < 0.6


def test_schur_encodings_agree(prob_synth):
    """Dense blk_idx path and covisibility pair-list path must converge to
    the same optimum (the per-iteration math is identical up to f64
    summation order)."""
    cfg = SolverConfig(lm_switch_count=1000)
    res_d = solve(prob_synth, cfg, schur="dense")
    res_p = solve(prob_synth, cfg, schur="pairs")
    # the final ||dp|| stop-test crossing may shift by one iteration:
    # dp -> 0 at the optimum puts the comparison at roundoff
    assert abs(res_d.iterations - res_p.iterations) <= 1
    np.testing.assert_allclose(res_d.final_l2, res_p.final_l2, rtol=1e-9)
    np.testing.assert_allclose(res_d.cams, res_p.cams, rtol=1e-6, atol=1e-9)


@requires_data
def test_lm_7cams(prob7_ref):
    res = solve(prob7_ref, SolverConfig(lm_switch_count=1000))
    # known optimum of the sba demo 7-cam problem: ~0.675 mean squared
    # pixel error => RMS ~0.8217 px
    assert abs(rms_px(res, prob7_ref.n_obs) - 0.8218) < 0.01
    assert res.iterations <= 50


@requires_data
def test_hybrid_7cams(prob7_ref):
    res = solve(prob7_ref)
    assert abs(rms_px(res, prob7_ref.n_obs) - 0.8218) < 0.01
    # hybrid switched LM -> TR (5 consecutive good iterations)
    assert res.phases[0][0] == "lm" and res.phases[0][2] == CC.ITER_TURN_TO_TR


@requires_data
def test_hybrid_54cams(prob54_ref):
    res = solve(prob54_ref)
    assert rms_px(res, prob54_ref.n_obs) < 0.45
    assert res.final_l2 < 0.25 * res.initial_l2


@requires_data
@pytest.mark.slow
def test_hybrid_trafalgar():
    from psba_tpu.io import load_problem
    from tests.conftest import DATA

    prob = load_problem(
        f"{DATA}/Trafalgar-21-11315-cams.txt",
        f"{DATA}/Trafalgar-21-11315-pts.txt",
    )
    res = solve(prob)
    assert rms_px(res, prob.n_obs) < 3.0
    assert res.final_l2 < 0.002 * res.initial_l2


def test_f32_path(prob_synth):
    """The fast f32 pipeline must still descend to the noise floor."""
    import jax.numpy as jnp

    res = solve(prob_synth, dtype=jnp.float32)
    assert rms_px(res, prob_synth.n_obs) < 0.7


def test_f32_polish5_reaches_f64_optimum():
    """Five f64 polish iterations after an f32 run reach the f64 optimum:
    the polish seeds a near-zero damping (constants.PSBA_POLISH_MU). At
    this shape a polish seeded like a cold start (tau = 1e-3) is still
    ~4e-6 above the optimum after five."""
    import jax.numpy as jnp

    from psba_tpu.io import bal_shaped_problem

    prob = bal_shaped_problem(50, 1000, seed=0)
    ref = rms_px(solve(prob), prob.n_obs)
    res = solve(prob, dtype=jnp.float32, polish_iters=5)
    assert res.phases[-1][0] == "lm64"
    assert abs(rms_px(res, prob.n_obs) - ref) <= 1e-6 * ref


def test_tr_recovers_from_singular_v(prob_synth):
    """A point seen by one camera has rank-2 V (= B^T B, B 2x3): at
    lambda=0 the Vinv failure must escalate like a Cholesky failure
    (GMW lambda bootstrap) instead of poisoning S with a garbage inverse
    (reference fallback: compute_Vinv.cl:28-76)."""
    import dataclasses

    from tests.oracle import predict_one

    p = prob_synth
    X_new = np.array([0.3, -0.2, 0.4])
    uv = predict_one(p.K[0], p.q0[0], p.cams[0, :3], p.cams[0, 3:], X_new)
    prob = dataclasses.replace(
        p,
        pts=np.concatenate([p.pts, X_new[None]]),
        obs=np.concatenate([p.obs, (uv + 0.3)[None]]),
        cam_idx=np.concatenate([p.cam_idx, np.array([0], p.cam_idx.dtype)]),
        pt_idx=np.concatenate(
            [p.pt_idx, np.array([p.n_pts], p.pt_idx.dtype)]
        ),
    )
    prob.validate()
    res = solve(prob, SolverConfig(max_iters=10), start="tr")
    assert np.isfinite(res.final_l2)
    assert np.all(np.isfinite(res.cams)) and np.all(np.isfinite(res.pts))
    assert res.final_l2 < res.initial_l2


def test_marquardt_damping_converges(prob7):
    """SolverConfig(damping="marquardt") (scale-invariant multiplicative
    damping, a framework extension over the reference's additive mu*I)
    must reach the same optimum as the additive default."""
    import jax.numpy as jnp

    from psba_tpu.solvers.hybrid import solve
    from psba_tpu.solvers.types import SolverConfig

    ref = solve(prob7)
    r = solve(prob7, SolverConfig(damping="marquardt",
                                  lm_switch_count=10_000))
    np.testing.assert_allclose(r.final_error, ref.final_error, rtol=1e-8)
    r32 = solve(
        prob7,
        SolverConfig.for_dtype(jnp.float32, damping="marquardt",
                               lm_switch_count=10_000),
        dtype=jnp.float32,
    )
    np.testing.assert_allclose(r32.final_error, ref.final_error, rtol=1e-3)


def _mixed_scale_problem():
    """Synthetic ring with half the cameras' focal lengths (and their
    observations, consistently) scaled by 1e6: diag(JtJ) dynamic range
    ~1e12, the regime where real BAL sets (venice52 ratio 1.1e10,
    dubrovnik88 1.3e26) silently stall under f32 additive damping."""
    import dataclasses

    from psba_tpu.io import synthetic_problem

    prob = synthetic_problem(n_cams=6, n_pts=120, seed=3)
    K = prob.K.copy()
    obs = prob.obs.copy()
    scale = 1e6
    for c in range(prob.n_cams // 2):
        m = prob.cam_idx == c
        obs[m, 0] = (obs[m, 0] - K[c, 1]) * scale + K[c, 1]
        obs[m, 1] = (obs[m, 1] - K[c, 2]) * scale + K[c, 2]
        K[c, 0] *= scale
    return dataclasses.replace(prob, K=K, obs=obs)


def test_auto_damping_resolution(prob7):
    """damping="auto" resolves additive on well-scaled problems (exact
    reference parity) and marquardt when tau * diag-ratio exceeds
    1/eps(dtype) — the point where `d + mu` erases the smallest
    diagonal entirely in the working precision."""
    import jax.numpy as jnp

    from psba_tpu.solvers.types import (
        ProblemArrays,
        SolverConfig,
        resolve_damping,
    )

    cfg = SolverConfig.for_dtype(jnp.float32)
    assert cfg.damping == "auto"

    pa7 = ProblemArrays.from_problem(prob7, dtype=jnp.float32)
    r7 = resolve_damping(
        cfg, pa7, jnp.asarray(prob7.cams, jnp.float32),
        jnp.asarray(prob7.pts, jnp.float32),
    )
    assert r7.damping == "additive"

    mixed = _mixed_scale_problem()
    pam = ProblemArrays.from_problem(mixed, dtype=jnp.float32)
    rm = resolve_damping(
        cfg, pam, jnp.asarray(mixed.cams, jnp.float32),
        jnp.asarray(mixed.pts, jnp.float32),
    )
    assert rm.damping == "marquardt"
    # the LM->TR switch must be disabled with it: TR damps additively
    # (trust_region.cpp:126) and would re-enter the same failure
    assert rm.lm_switch_count > rm.max_iters

    # in float64 the same ratio is representable: parity additive stays
    r64 = resolve_damping(
        SolverConfig.for_dtype(jnp.float64), pam,
        jnp.asarray(mixed.cams), jnp.asarray(mixed.pts),
    )
    assert r64.damping == "additive"


@requires_data
def test_default_config_converges_on_mixed_scale_f32():
    """The DEFAULT config must make real progress on a BAL-scaled f32
    problem (additive mu = tau*max(diag U) ~ 1e20
    used to drive the first step under the dp-small stop, so the run
    'converged' at its starting point unless the user knew to pass
    --damping marquardt).

    Fixture: the real Dubrovnik-88 cameras (diag ratio 1.3e26, the
    worst-scaled bundled set) with a small synthesized point cloud —
    the same construction datasets.load("dubrovnik88") uses at full
    size (its points file is not bundled, main.cpp:40-59)."""
    import jax.numpy as jnp

    from psba_tpu.io.synthetic import synthesize_points_for_cams
    from psba_tpu.solvers.hybrid import solve
    from psba_tpu.solvers.types import SolverConfig
    from tests.conftest import DATA

    prob = synthesize_points_for_cams(
        f"{DATA}/Dubrovnik-88-64298-cams.txt", n_pts=2500, seed=0
    )
    res = solve(prob, dtype=jnp.float32)  # config defaulted -> auto
    assert res.final_error < 0.3 * res.initial_error, (
        res.initial_error, res.final_error, res.flag_name,
    )

    # the failure mode auto exists to avoid, pinned: explicit additive
    # stops almost immediately with the error still at its initial value
    bad = solve(
        prob, SolverConfig.for_dtype(jnp.float32, damping="additive"),
        dtype=jnp.float32,
    )
    assert bad.iterations <= 3
    assert bad.final_error > 0.9 * bad.initial_error

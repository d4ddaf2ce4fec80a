"""Branch-level tests of the TR dogleg step selection and the in-loop GMW
lambda bootstrap.

`_subspace_step` implements compute_p_2 (PSBA/trust_region.cpp:520-595):
minimize the quadratic model over span{P_U, P_B}; if the minimizer leaves
the radius, fall back to scaled-P_U / P_B / the classic dogleg tau-root.
Each branch is checked against an independently derived NumPy model (2x2
normal-equation solve; dogleg root solved in the s-parameterization
||P_U + s (P_B - P_U)|| = delta rather than the reference's tau form).
"""

import numpy as np
import pytest

import jax.numpy as jnp

from psba_tpu.solvers.tr import _subspace_step

N_C, N_P = 2, 3          # 2 cams x 6 + 3 pts x 3 = 21-dim step space
DIM = 6 * N_C + 3 * N_P


def _split(v):
    return (
        jnp.asarray(v[: 6 * N_C].reshape(N_C, 6)),
        jnp.asarray(v[6 * N_C:].reshape(N_P, 3)),
    )


def _dot(ac, ap, bc, bp):
    return jnp.sum(ac * bc) + jnp.sum(ap * bp)


def _flat(c, p):
    return np.concatenate([np.asarray(c).ravel(), np.asarray(p).ravel()])


def _model_step(pu, pb, g, Buu, Bub, Bbb, delta):
    """Independent NumPy model of the compute_p_2 semantics."""
    eta = np.linalg.solve(
        np.array([[Buu, Bub], [Bub, Bbb]]), -np.array([pu @ g, pb @ g])
    )
    p = eta[0] * pu + eta[1] * pb
    if np.linalg.norm(p) <= delta:
        return p, np.linalg.norm(p), "interior"
    if np.linalg.norm(pu) > delta:
        return delta * pu / np.linalg.norm(pu), delta, "scaled_pu"
    if np.linalg.norm(pb) <= delta:
        return pb, np.linalg.norm(pb), "pb"
    d = pb - pu
    a, b, c = d @ d, 2.0 * (pu @ d), pu @ pu - delta * delta
    s = (-b + np.sqrt(b * b - 4 * a * c)) / (2 * a)
    return pu + s * d, delta, "dogleg"


def _run_case(pu, pb, g, B, delta, expect_branch):
    Buu, Bub, Bbb = pu @ B @ pu, pu @ B @ pb, pb @ B @ pb
    ref_p, ref_norm, branch = _model_step(pu, pb, g, Buu, Bub, Bbb, delta)
    assert branch == expect_branch, f"case engineering broke: hit {branch}"
    out_c, out_p, out_norm = _subspace_step(
        _dot, *_split(pu), *_split(pb), *_split(g),
        jnp.float64(Buu), jnp.float64(Bub), jnp.float64(Bbb),
        jnp.float64(delta),
    )
    got = _flat(out_c, out_p)
    np.testing.assert_allclose(got, ref_p, rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(float(out_norm), ref_norm, rtol=1e-10)
    return got


def _setup(seed=0):
    rng = np.random.default_rng(seed)
    M = rng.standard_normal((DIM, DIM))
    B = M.T @ M + 0.5 * np.eye(DIM)       # SPD model Hessian
    pu = rng.standard_normal(DIM)
    pb = rng.standard_normal(DIM)
    return rng, B, pu, pb


def test_interior_branch_matches_2x2_solve():
    rng, B, pu, pb = _setup(1)
    g = rng.standard_normal(DIM)
    p = _run_case(pu, pb, g, B, delta=1e9, expect_branch="interior")
    # stationarity inside the subspace: model gradient orthogonal to span
    grad = g + B @ p
    assert abs(grad @ pu) < 1e-6 * np.linalg.norm(grad) * np.linalg.norm(pu)
    assert abs(grad @ pb) < 1e-6 * np.linalg.norm(grad) * np.linalg.norm(pb)


def test_scaled_pu_branch():
    rng, B, pu, pb = _setup(2)
    # g = -B p* with p* in the span => subspace minimizer is exactly p*
    p_star = 5.0 * pu + 5.0 * pb
    g = -B @ p_star
    delta = 0.5 * np.linalg.norm(pu)      # ||pu|| > delta forces the branch
    p = _run_case(pu, pb, g, B, delta, expect_branch="scaled_pu")
    np.testing.assert_allclose(np.linalg.norm(p), delta, rtol=1e-12)
    cos = p @ pu / (np.linalg.norm(p) * np.linalg.norm(pu))
    np.testing.assert_allclose(cos, 1.0, rtol=1e-12)


def test_pb_branch():
    rng, B, pu, pb = _setup(3)
    pu = 0.4 * pu / np.linalg.norm(pu)
    pb = 0.7 * pb / np.linalg.norm(pb)
    p_star = 40.0 * pu + 40.0 * pb        # minimizer far outside
    g = -B @ p_star
    delta = 1.0                            # ||pu||,||pb|| <= delta < ||p*||
    p = _run_case(pu, pb, g, B, delta, expect_branch="pb")
    np.testing.assert_allclose(p, pb, rtol=1e-12)


def test_dogleg_branch():
    rng, B, pu, pb = _setup(4)
    pu = 0.6 * pu / np.linalg.norm(pu)
    pb = 3.0 * pb / np.linalg.norm(pb)
    p_star = 30.0 * pu + 30.0 * pb
    g = -B @ p_star
    delta = 1.0                            # ||pu|| <= delta < ||pb||
    p = _run_case(pu, pb, g, B, delta, expect_branch="dogleg")
    # on the dogleg segment between pu and pb, at the radius
    np.testing.assert_allclose(np.linalg.norm(p), delta, rtol=1e-10)
    d = pb - pu
    s = (p - pu) @ d / (d @ d)
    assert 0.0 <= s <= 1.0
    np.testing.assert_allclose(p, pu + s * d, rtol=1e-8, atol=1e-10)


def test_dogleg_branch_sweep():
    """Randomized agreement sweep: whatever branch each draw lands in, the
    device step must match the independent model."""
    rng = np.random.default_rng(7)
    hits = set()
    for k in range(40):
        M = rng.standard_normal((DIM, DIM))
        B = M.T @ M + 0.1 * np.eye(DIM)
        pu = rng.standard_normal(DIM) * rng.uniform(0.1, 2.0)
        pb = rng.standard_normal(DIM) * rng.uniform(0.1, 2.0)
        amp = rng.uniform(0.02, 8.0)
        g = -B @ (amp * rng.uniform(0.5, 1.0) * pu
                  + amp * rng.uniform(0.5, 1.0) * pb)
        delta = rng.uniform(0.3, 3.0)
        Buu, Bub, Bbb = pu @ B @ pu, pu @ B @ pb, pb @ B @ pb
        ref_p, ref_norm, branch = _model_step(
            pu, pb, g, Buu, Bub, Bbb, delta
        )
        hits.add(branch)
        out_c, out_p, out_norm = _subspace_step(
            _dot, *_split(pu), *_split(pb), *_split(g),
            jnp.float64(Buu), jnp.float64(Bub), jnp.float64(Bbb),
            jnp.float64(delta),
        )
        np.testing.assert_allclose(
            _flat(out_c, out_p), ref_p, rtol=1e-8, atol=1e-10,
            err_msg=f"draw {k} branch {branch}",
        )
    assert {"interior", "scaled_pu", "dogleg"} <= hits


def test_tr_inloop_gmw_bootstrap(prob_synth):
    """End-to-end: TR starting on a problem whose lambda=0 reduced system is
    singular (a camera with zero observations has U_j = 0 exactly) must hit
    the Cholesky failure -> GMW modified-Cholesky lambda bootstrap
    (trust_region.cpp:341-366) mid-solve, continue with lambda > 0, and
    still descend."""
    import dataclasses

    from psba_tpu import constants as CC
    from psba_tpu.solvers import SolverConfig
    from psba_tpu.solvers.hybrid import solve

    p = prob_synth
    # append an unobserved camera: its U block is exactly zero, so S at
    # lambda=0 has a singular leading block
    prob = dataclasses.replace(
        p,
        K=np.concatenate([p.K, p.K[:1]]),
        q0=np.concatenate([p.q0, p.q0[:1]]),
        cams=np.concatenate([p.cams, p.cams[:1]]),
    )
    prob.validate()
    res = solve(
        prob,
        SolverConfig(max_iters=10, record_history=True),
        start="tr",
    )
    assert np.isfinite(res.final_l2)
    assert res.final_l2 < res.initial_l2
    # history rows: (itno, act, rho, lambda, delta, p_norm) — the bootstrap
    # must have produced a positive lambda in some TR iteration
    lam = res.history[:, 3]
    assert np.nanmax(lam) > 0.0
    assert res.flag != CC.ITER_ERR

"""Residual and Jacobian golden-value tests (reference parity layer).

The reference validated kernels manually against levmar_func_cpu.cpp; here
the same role is played by the scalar oracle + jax.jacfwd cross-checks."""

import jax
import jax.numpy as jnp
import numpy as np

from psba_tpu.core.jacobian import jacobians, jmultiply
from psba_tpu.core.residual import error_l2, residuals
from psba_tpu.models.pinhole import project_quat
from tests import oracle


def _perturb(prob, seed=0, rot=1e-3, trans=1e-2, pt=1e-2):
    """Nonzero local rotations exercise the full Jacobian structure."""
    rng = np.random.default_rng(seed)
    cams = prob.cams.copy()
    cams[:, :3] += rot * rng.standard_normal(cams[:, :3].shape)
    cams[:, 3:] += trans * rng.standard_normal(cams[:, 3:].shape)
    pts = prob.pts + pt * rng.standard_normal(prob.pts.shape)
    return cams, pts


def test_residuals_match_oracle(prob7):
    cams, pts = _perturb(prob7)
    got = np.asarray(
        residuals(
            jnp.array(prob7.K), jnp.array(prob7.q0), jnp.array(cams),
            jnp.array(pts), jnp.array(prob7.obs),
            jnp.array(prob7.cam_idx), jnp.array(prob7.pt_idx),
        )
    )
    want = oracle.residuals(prob7, cams, pts)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-10)


def test_residuals_synth(prob_synth):
    p = prob_synth
    got = np.asarray(
        residuals(
            jnp.array(p.K), jnp.array(p.q0), jnp.array(p.cams),
            jnp.array(p.pts), jnp.array(p.obs),
            jnp.array(p.cam_idx), jnp.array(p.pt_idx),
        )
    )
    want = oracle.residuals(p)
    np.testing.assert_allclose(got, want, rtol=1e-11, atol=1e-9)


def test_jacobian_vs_autodiff(prob_synth):
    """Closed-form A/B equals jax.jacfwd of the forward model."""
    p = prob_synth
    cams, pts = _perturb(p, seed=5)
    A, B = jacobians(
        jnp.array(p.K), jnp.array(p.q0), jnp.array(cams), jnp.array(pts),
        jnp.array(p.cam_idx), jnp.array(p.pt_idx),
    )
    A, B = np.asarray(A), np.asarray(B)

    def pred(cam, X, K, q0):
        return project_quat(K, q0, cam[:3], cam[3:], X)

    jac_cam = jax.vmap(jax.jacfwd(pred, argnums=0))
    jac_pt = jax.vmap(jax.jacfwd(pred, argnums=1))
    Kg = jnp.array(p.K)[p.cam_idx]
    q0g = jnp.array(p.q0)[p.cam_idx]
    camg = jnp.array(cams)[p.cam_idx]
    Xg = jnp.array(pts)[p.pt_idx]
    A_ad = np.asarray(jac_cam(camg, Xg, Kg, q0g))
    B_ad = np.asarray(jac_pt(camg, Xg, Kg, q0g))
    np.testing.assert_allclose(A, A_ad, rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(B, B_ad, rtol=1e-9, atol=1e-9)


def test_jacobian_vs_fd_oracle(prob7):
    """Finite-difference oracle on a subset of observations."""
    cams, pts = _perturb(prob7, seed=7)
    A, B = jacobians(
        jnp.array(prob7.K), jnp.array(prob7.q0), jnp.array(cams),
        jnp.array(pts), jnp.array(prob7.cam_idx), jnp.array(prob7.pt_idx),
    )
    import dataclasses

    sub = dataclasses.replace(
        prob7,
        obs=prob7.obs[:40], cam_idx=prob7.cam_idx[:40],
        pt_idx=prob7.pt_idx[:40],
        pair_o1=None, pair_o2=None, pair_bucket=None, obs_cov=None,
    )
    A_fd, B_fd = oracle.jacobians_fd(sub, cams, pts)
    np.testing.assert_allclose(np.asarray(A)[:40], A_fd, rtol=2e-5, atol=2e-4)
    np.testing.assert_allclose(np.asarray(B)[:40], B_fd, rtol=2e-5, atol=2e-4)


def test_jmultiply_matches_dense(prob_synth):
    p = prob_synth
    cams, pts = _perturb(p, seed=11)
    A, B = jacobians(
        jnp.array(p.K), jnp.array(p.q0), jnp.array(cams), jnp.array(pts),
        jnp.array(p.cam_idx), jnp.array(p.pt_idx),
    )
    rng = np.random.default_rng(0)
    x = rng.standard_normal(p.n_params)
    C = p.n_cams
    got = np.asarray(
        jmultiply(A, B, jnp.array(x[: 6 * C]), jnp.array(x[6 * C :]),
                  p.cam_idx, p.pt_idx)
    )
    J = oracle.dense_jacobian(p, np.asarray(A), np.asarray(B))
    want = (J @ x).reshape(-1, 2)
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-10)


def test_error_l2_masking():
    ex = jnp.array([[1.0, 2.0], [3.0, 4.0]])
    assert float(error_l2(ex)) == 30.0
    assert float(error_l2(ex, valid=jnp.array([True, False]))) == 5.0

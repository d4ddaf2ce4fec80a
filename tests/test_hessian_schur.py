"""Hessian-block and Schur-reduction tests against dense linear algebra.

The strongest parity check available without running the reference binary:
U/V/W/g and the reduced system S, ea must match the corresponding blocks of
the dense normal equations J^T J built from the same Jacobians."""

import jax.numpy as jnp
import numpy as np
import pytest

from psba_tpu.core.hessian import assemble_blocks, damp_uv, max_diag
from psba_tpu.core.jacobian import jacobians
from psba_tpu.core.linalg import spd_solve
from psba_tpu.core.residual import residuals
from psba_tpu.core.schur import (
    back_substitute,
    back_substitute_dense,
    inv3x3_planar,
    planar_gb,
    inv3x3,
    reduced_rhs,
    reduced_rhs_dense,
    schur_S,
    schur_S_dense,
    stack_blocks,
    y_blocks,
)
from tests import oracle


def _setup(prob, mu=0.0, coeff=1.0):
    K, q0 = jnp.array(prob.K), jnp.array(prob.q0)
    cams, pts = jnp.array(prob.cams), jnp.array(prob.pts)
    ex = residuals(K, q0, cams, pts, jnp.array(prob.obs),
                   prob.cam_idx, prob.pt_idx)
    A, B = jacobians(K, q0, cams, pts, prob.cam_idx, prob.pt_idx)
    U, V, W, ga, gb = assemble_blocks(
        A, B, ex, prob.cam_idx, prob.pt_idx, prob.n_cams, prob.n_pts,
        coeff=coeff,
    )
    return ex, A, B, U, V, W, ga, gb


def test_blocks_match_dense(prob_synth):
    p = prob_synth
    ex, A, B, U, V, W, ga, gb = _setup(p)
    J = oracle.dense_jacobian(p, np.asarray(A), np.asarray(B))
    H = J.T @ J
    g_dense = J.T @ np.asarray(ex).reshape(-1)
    C, P = p.n_cams, p.n_pts

    for j in range(C):
        np.testing.assert_allclose(
            np.asarray(U)[j], H[6 * j : 6 * j + 6, 6 * j : 6 * j + 6],
            rtol=1e-10, atol=1e-8,
        )
    for i in range(0, P, 37):
        s = 6 * C + 3 * i
        np.testing.assert_allclose(
            np.asarray(V)[i], H[s : s + 3, s : s + 3], rtol=1e-10, atol=1e-8
        )
    # W blocks: H camera-point coupling equals sum of per-obs W at (j,i)
    o = 7
    j, i = p.cam_idx[o], p.pt_idx[o]
    mask = (p.cam_idx == j) & (p.pt_idx == i)
    Wsum = np.asarray(W)[mask].sum(axis=0)
    np.testing.assert_allclose(
        Wsum, H[6 * j : 6 * j + 6, 6 * C + 3 * i : 6 * C + 3 * i + 3],
        rtol=1e-10, atol=1e-8,
    )
    np.testing.assert_allclose(
        np.concatenate([np.asarray(ga).ravel(), np.asarray(gb).ravel()]),
        g_dense, rtol=1e-10, atol=1e-8,
    )


def test_schur_matches_dense(prob_synth):
    """S and ea must equal the dense Schur complement of the damped H."""
    p = prob_synth.with_pairs()
    mu = 0.37
    ex, A, B, U, V, W, ga, gb = _setup(p)
    U_d, V_d = damp_uv(U, V, mu)
    Vinv, ok = inv3x3(V_d)
    assert bool(ok)
    Y = y_blocks(W, Vinv, p.pt_idx)
    S = schur_S(U_d, Y, W, p.pair_o1, p.pair_o2, p.pair_bucket, p.n_cams)
    ea = reduced_rhs(ga, gb, Y, p.cam_idx, p.pt_idx, p.n_cams)

    J = oracle.dense_jacobian(p, np.asarray(A), np.asarray(B))
    H = J.T @ J + mu * np.eye(J.shape[1])
    g = J.T @ np.asarray(ex).reshape(-1)
    nc = 6 * p.n_cams
    Hcc, Hcp, Hpp = H[:nc, :nc], H[:nc, nc:], H[nc:, nc:]
    S_dense = Hcc - Hcp @ np.linalg.inv(Hpp) @ Hcp.T
    ea_dense = g[:nc] - Hcp @ np.linalg.inv(Hpp) @ g[nc:]

    np.testing.assert_allclose(np.asarray(S), S_dense, rtol=1e-8, atol=1e-6)
    np.testing.assert_allclose(
        np.asarray(ea).ravel(), ea_dense, rtol=1e-8, atol=1e-8
    )

    # full reduced solve must reproduce the dense solve of H dp = g
    dpa_flat, sok = spd_solve(S, ea.reshape(-1))
    assert bool(sok)
    dpa = dpa_flat.reshape(p.n_cams, 6)
    _eb, dpb = back_substitute(
        gb, W, Vinv, dpa, p.cam_idx, p.pt_idx, p.n_pts
    )
    dp_dense = np.linalg.solve(H, g)
    np.testing.assert_allclose(
        np.asarray(dpa).ravel(), dp_dense[:nc], rtol=1e-7, atol=1e-9
    )
    np.testing.assert_allclose(
        np.asarray(dpb).ravel(), dp_dense[nc:], rtol=1e-7, atol=1e-9
    )


def test_schur_dense_stack_matches_pairs(prob_synth):
    """The blk_idx gather + matmul path (schur_S_dense / reduced_rhs_dense /
    back_substitute_dense) must agree with the covisibility pair-list path
    on S, ea, and the back-substituted step."""
    p = prob_synth.with_pairs().with_blk()
    mu = 0.37
    ex, A, B, U, V, W, ga, gb = _setup(p)
    U_d, V_d = damp_uv(U, V, mu)
    Vinv, ok = inv3x3(V_d)
    assert bool(ok)

    Y = y_blocks(W, Vinv, p.pt_idx)
    S_pairs = schur_S(U_d, Y, W, p.pair_o1, p.pair_o2, p.pair_bucket,
                      p.n_cams)
    ea_pairs = reduced_rhs(ga, gb, Y, p.cam_idx, p.pt_idx, p.n_cams)

    Vp, okp = inv3x3_planar(V_d)
    assert bool(okp)
    # planar layout carries the same inverse: Vp[k, j, p] == Vinv[p, k, j]
    np.testing.assert_allclose(
        np.asarray(Vp), np.asarray(Vinv).transpose(1, 2, 0), rtol=1e-12
    )
    ZW = stack_blocks(W, jnp.asarray(p.blk_idx))
    gbp = planar_gb(gb)
    S_dense, ZY = schur_S_dense(U_d, ZW, Vp)
    ea_dense = reduced_rhs_dense(ga, gbp, ZY)

    np.testing.assert_allclose(
        np.asarray(S_dense), np.asarray(S_pairs), rtol=1e-9, atol=1e-9
    )
    np.testing.assert_allclose(
        np.asarray(ea_dense), np.asarray(ea_pairs), rtol=1e-9, atol=1e-9
    )

    dpa_flat, sok = spd_solve(S_dense, ea_dense.reshape(-1))
    assert bool(sok)
    dpa = dpa_flat.reshape(p.n_cams, 6)
    eb_p, dpb_p = back_substitute(
        gb, W, Vinv, dpa, p.cam_idx, p.pt_idx, p.n_pts
    )
    ebp_d, dpb_d = back_substitute_dense(gbp, ZW, Vp, dpa)
    np.testing.assert_allclose(
        np.asarray(dpb_d), np.asarray(dpb_p), rtol=1e-9, atol=1e-12
    )
    np.testing.assert_allclose(
        np.asarray(ebp_d), np.asarray(planar_gb(eb_p)),
        rtol=1e-9, atol=1e-12
    )


def test_inv3x3():
    rng = np.random.default_rng(0)
    M = rng.standard_normal((50, 3, 3))
    V = np.einsum("nij,nkj->nik", M, M) + 0.1 * np.eye(3)
    Vinv, ok = inv3x3(jnp.array(V))
    assert bool(ok)
    np.testing.assert_allclose(
        np.einsum("nij,njk->nik", np.asarray(Vinv), V),
        np.tile(np.eye(3), (50, 1, 1)), atol=1e-10,
    )


def test_inv3x3_singular_flag():
    V = np.zeros((2, 3, 3))
    V[0] = np.eye(3)
    _, ok = inv3x3(jnp.array(V))
    assert not bool(ok)


def test_inv3x3_pivoted_fallback_tiny_det():
    # |det| = 1e-18 < 1e-16 triggers the pivoted-Gaussian fallback
    # (compute_Vinv.cl:28-76) on a perfectly invertible matrix; the
    # fallback must produce the correct inverse and keep ok=True
    V = np.tile(1e-6 * np.eye(3), (4, 1, 1))
    V[1] = np.diag([1e-5, 1e-6, 1e-8])
    M = np.array([[2.0, 1.0, 0.5], [0.3, 1.5, 0.2], [0.1, 0.4, 1.1]])
    V[2] = 1e-6 * (M @ M.T)
    # off-diagonal dominant first column: exercises the row swap (and its
    # sign tracking, which the reference drops) in the fallback determinant
    V[3] = np.array(
        [[1e-9, 1e-6, 0.0], [1e-6, 1e-9, 0.0], [0.0, 0.0, 1e-6]]
    )
    Vinv, ok = inv3x3(jnp.array(V))
    assert bool(ok)
    np.testing.assert_allclose(
        np.einsum("nij,njk->nik", np.asarray(Vinv), V),
        np.tile(np.eye(3), (4, 1, 1)), atol=1e-8,
    )


def test_inv3x3_rank_deficient_flags_not_nan():
    # rank-2 V (B^T B with B 2x3) must flag ok=False and return finite
    # entries (zeroed inverse) so downstream S stays finite
    B = np.array([[1.0, 2.0, 3.0], [0.5, -1.0, 2.0]])
    V = np.stack([B.T @ B, np.eye(3)])
    Vinv, ok = inv3x3(jnp.array(V))
    assert not bool(ok)
    assert np.all(np.isfinite(np.asarray(Vinv)))
    np.testing.assert_allclose(np.asarray(Vinv)[1], np.eye(3), atol=1e-12)


def test_max_diag(prob_synth):
    p = prob_synth
    _, A, B, U, V, W, ga, gb = _setup(p)
    got = float(max_diag(U, V))
    want = max(
        np.asarray(U).diagonal(axis1=1, axis2=2).max(),
        np.asarray(V).diagonal(axis1=1, axis2=2).max(),
    )
    assert got == want


def test_spd_solve_failure_flag():
    S = jnp.array(np.diag([1.0, -1.0, 2.0]))
    _, ok = spd_solve(S, jnp.ones(3))
    assert not bool(ok)


def test_gmw_perturbation():
    from psba_tpu.core.gmw import gmw_bootstrap_lambda, gmw_perturbation

    rng = np.random.default_rng(1)
    n = 24
    M = rng.standard_normal((n, n))
    A_spd = M @ M.T + 0.5 * np.eye(n)
    E = np.asarray(gmw_perturbation(jnp.array(A_spd)))
    # SPD matrix with healthy diagonal: perturbation ~ 0
    np.testing.assert_allclose(E, 0.0, atol=1e-10)

    # indefinite matrix: A + E must be positive definite
    A_ind = A_spd - 3.0 * np.linalg.norm(A_spd, 2) * np.outer(
        np.eye(n)[0], np.eye(n)[0]
    )
    A_ind = 0.5 * (A_ind + A_ind.T)
    E = np.asarray(gmw_perturbation(jnp.array(A_ind)))
    assert np.all(E >= -1e-12)
    w = np.linalg.eigvalsh(A_ind + np.diag(E))
    assert w.min() > 0, w.min()
    lam = float(gmw_bootstrap_lambda(jnp.array(A_ind)))
    assert lam > 0


def test_gmw_blocked_matches_unblocked():
    """Blocked right-looking GMW (panel + matmul trailing update) must
    reproduce the column recurrence's E exactly, and A + diag(E) must be
    PSD — including non-multiple-of-block sizes (identity-tail padding)."""
    import numpy as np

    from psba_tpu.core.gmw import (
        gmw_perturbation,
        gmw_perturbation_blocked,
    )

    rng = np.random.default_rng(11)
    for n in (5, 16, 33, 126, 130):
        M = rng.standard_normal((n, n))
        A = jnp.asarray((M + M.T) / 2 - 0.1 * n * np.eye(n))
        E1 = np.asarray(gmw_perturbation(A))
        E2 = np.asarray(gmw_perturbation_blocked(A, 16))
        np.testing.assert_allclose(E2, E1, rtol=1e-12, atol=1e-12)
        w = np.linalg.eigvalsh(np.asarray(A) + np.diag(E2))
        assert w.min() > -1e-8


@pytest.mark.parametrize("indices_are_sorted", [False, True])
def test_indexed_sum_modes(indices_are_sorted):
    """indexed_sum equals np.add.at, with unsorted and sorted indices;
    out-of-range indices (padding markers) contribute nothing."""
    from psba_tpu.ops.reduce import indexed_sum

    rng = np.random.default_rng(1)
    data = rng.standard_normal((100, 7))
    idx = rng.integers(0, 13, 100)
    idx[0] = 13                      # padding marker
    if indices_are_sorted:
        order = np.argsort(idx, kind="stable")
        data, idx = data[order], idx[order]
    want = np.zeros((14, 7))
    np.add.at(want, idx, data)
    got = indexed_sum(
        jnp.asarray(data), jnp.asarray(idx, jnp.int32), 13,
        indices_are_sorted=indices_are_sorted,
    )
    np.testing.assert_allclose(np.asarray(got), want[:13], rtol=1e-12,
                               atol=1e-12)

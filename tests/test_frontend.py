"""Front-end tests: corners, matching, two-view geometry, full pipeline."""

import jax.numpy as jnp
import numpy as np
import pytest

from psba_tpu.frontend.features import describe, detect_and_describe, harris_corners
from psba_tpu.frontend.matching import match_descriptors
from psba_tpu.frontend.twoview import (
    decompose_essential,
    essential_8pt,
    triangulate,
)


def _render(points_uv, H=120, W=160, rng=None):
    """Tiny synthetic image: each point gets a unique 5x5 texture patch
    (seeded by its index) so descriptors are discriminative; background is
    a dark gradient."""
    img = np.linspace(0, 0.1, W)[None, :] * np.ones((H, 1))
    if rng is not None:
        img = img + 0.01 * rng.standard_normal((H, W))
    for i, (u, v) in enumerate(points_uv):
        ui, vi = int(round(u)), int(round(v))
        if 3 <= ui < W - 3 and 3 <= vi < H - 3:
            tex = np.random.default_rng(1000 + i).uniform(0.2, 1.0, (5, 5))
            tex[2, 2] = 1.5  # strong center for a stable corner response
            img[vi - 2 : vi + 3, ui - 2 : ui + 3] += tex
    return img


def test_harris_finds_blobs():
    rng = np.random.default_rng(0)
    pts = rng.uniform([10, 10], [150, 110], size=(20, 2))
    img = _render(pts)
    xy, score = harris_corners(jnp.array(img), k=64)
    xy = np.asarray(xy)[np.asarray(score) > 0]
    # planted textures localize within their 5x5 patch
    d = np.linalg.norm(pts[:, None, :] - xy[None, :, :], axis=2).min(axis=1)
    assert (d < 3.0).mean() > 0.7


def test_matching_synthetic_shift():
    rng = np.random.default_rng(1)
    pts = rng.uniform([20, 20], [130, 90], size=(25, 2))
    img1 = _render(pts, rng=np.random.default_rng(5))
    img2 = _render(pts + np.array([6.0, 3.0]), rng=np.random.default_rng(6))
    xy1, s1, d1 = detect_and_describe(jnp.array(img1), k=64)
    xy2, s2, d2 = detect_and_describe(jnp.array(img2), k=64)
    idx2, valid = match_descriptors(d1, d2, s1, s2)
    xy1, xy2m = np.asarray(xy1), np.asarray(xy2)[np.asarray(idx2)]
    v = np.asarray(valid)
    assert v.sum() >= 10
    shift = (xy2m - xy1)[v]
    med = np.median(shift, axis=0)
    np.testing.assert_allclose(med, [6.0, 3.0], atol=1.0)


def _synthetic_two_view(n=60, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.uniform([-1, -1, 4], [1, 1, 8], size=(n, 3))
    # camera 2: small rotation about y + translation
    ang = 0.1
    R = np.array(
        [[np.cos(ang), 0, np.sin(ang)], [0, 1, 0],
         [-np.sin(ang), 0, np.cos(ang)]]
    )
    t = np.array([-0.8, 0.05, 0.02])
    x1 = X[:, :2] / X[:, 2:3]
    Xc2 = X @ R.T + t
    x2 = Xc2[:, :2] / Xc2[:, 2:3]
    return X, R, t, x1, x2


def test_essential_and_pose():
    X, R, t, x1, x2 = _synthetic_two_view()
    valid = jnp.ones(len(x1), bool)
    E = essential_8pt(jnp.array(x1), jnp.array(x2), valid)
    # epipolar constraint x2^T E x1 ~ 0
    h = lambda x: np.concatenate([x, np.ones((len(x), 1))], axis=1)
    resid = np.abs(np.einsum("ni,ij,nj->n", h(x2), np.asarray(E), h(x1)))
    assert resid.max() < 1e-6

    Re, te = decompose_essential(E, jnp.array(x1), jnp.array(x2), valid)
    Re, te = np.asarray(Re), np.asarray(te)
    np.testing.assert_allclose(Re, R, atol=1e-4)
    np.testing.assert_allclose(
        te / np.linalg.norm(te), t / np.linalg.norm(t), atol=1e-4
    )

    Xt = np.asarray(triangulate(jnp.array(Re), jnp.array(te),
                                jnp.array(x1), jnp.array(x2)))
    scale = np.linalg.norm(t)
    np.testing.assert_allclose(Xt * scale, X, rtol=2e-3, atol=2e-3)


def test_two_view_pipeline_end_to_end():
    """Full chain: render pair -> detect/match -> pose -> triangulate ->
    BAProblem -> bundle adjust."""
    from psba_tpu.frontend.pipeline import two_view_problem
    from psba_tpu.solvers import SolverConfig
    from psba_tpu.solvers.hybrid import solve

    rng = np.random.default_rng(3)
    n = 40
    X = rng.uniform([-1.2, -0.9, 4], [1.2, 0.9, 8], size=(n, 3))
    K = [200.0, 80.0, 60.0, 1.0, 0.0]
    ang = 0.08
    R = np.array(
        [[np.cos(ang), 0, np.sin(ang)], [0, 1, 0],
         [-np.sin(ang), 0, np.cos(ang)]]
    )
    t = np.array([-0.6, 0.0, 0.0])

    uv1 = X[:, :2] / X[:, 2:3] * K[0] + np.array(K[1:3])
    Xc2 = X @ R.T + t
    uv2 = Xc2[:, :2] / Xc2[:, 2:3] * K[0] + np.array(K[1:3])
    img1 = _render(uv1, H=120, W=160)
    img2 = _render(uv2, H=120, W=160)

    prob = two_view_problem(jnp.array(img1), jnp.array(img2), K,
                            n_features=128)
    assert prob.n_cams == 2
    assert prob.n_pts >= 10
    res = solve(prob, SolverConfig(max_iters=20, lm_switch_count=1000))
    # rounding of blob centers to the pixel grid bounds the residual
    rms = float(np.sqrt(res.final_l2 / prob.n_obs))
    assert rms < 1.0
    assert res.final_l2 <= res.initial_l2


def test_sequence_pipeline_multiview():
    """Pose-graph chaining: 4-image sequence -> pairwise poses composed
    with depth-ratio scale resolution -> multi-view tracks -> BAProblem ->
    bundle adjust to the rendering noise floor."""
    from psba_tpu.frontend.pipeline import sequence_problem
    from psba_tpu.solvers import SolverConfig
    from psba_tpu.solvers.hybrid import solve

    rng = np.random.default_rng(11)
    n_pts = 60
    X = rng.uniform([-1.4, -1.0, 4], [1.4, 1.0, 8], size=(n_pts, 3))
    K = [200.0, 80.0, 60.0, 1.0, 0.0]

    imgs = []
    n_views = 4
    for i in range(n_views):
        ang = 0.05 * i
        R = np.array(
            [[np.cos(ang), 0, np.sin(ang)], [0, 1, 0],
             [-np.sin(ang), 0, np.cos(ang)]]
        )
        t = np.array([-0.4 * i, 0.0, 0.0])
        Xc = X @ R.T + t
        uv = Xc[:, :2] / Xc[:, 2:3] * K[0] + np.array(K[1:3])
        imgs.append(jnp.array(_render(uv, H=120, W=160)))

    prob = sequence_problem(imgs, K, n_features=128)
    assert prob.n_cams == n_views
    assert prob.n_pts >= 10
    # pose-graph chaining must produce genuinely multi-view tracks
    counts = np.bincount(prob.pt_idx)
    assert (counts >= 3).sum() >= 5
    # every camera participates
    assert set(np.unique(prob.cam_idx)) == set(range(n_views))

    # chained initialization must already be in the convergence basin
    res = solve(prob, SolverConfig(max_iters=25, lm_switch_count=1000))
    rms = float(np.sqrt(res.final_l2 / prob.n_obs))
    assert rms < 1.0
    assert res.final_l2 <= res.initial_l2


def test_ransac_with_outliers():
    """essential_ransac must recover the pose with 20% injected gross
    outliers that the plain weighted-LS 8-point solve cannot reject."""
    import jax

    from psba_tpu.frontend.twoview import essential_ransac, sampson_sq

    X, R, t, x1, x2 = _synthetic_two_view(n=80, seed=4)
    rng = np.random.default_rng(7)
    n_out = 16  # 20%
    out_idx = rng.choice(len(x1), n_out, replace=False)
    x2c = x2.copy()
    x2c[out_idx] += rng.uniform(0.05, 0.3, (n_out, 2)) * rng.choice(
        [-1.0, 1.0], (n_out, 2)
    )
    valid = jnp.ones(len(x1), bool)
    E, inl = essential_ransac(
        jnp.array(x1), jnp.array(x2c), valid, jax.random.PRNGKey(0),
        iters=64, thresh=2e-3,
    )
    inl = np.asarray(inl)
    # consensus excludes (nearly) all injected outliers, keeps most inliers
    assert inl[out_idx].sum() <= 1
    assert inl.sum() >= 50
    Re, te = decompose_essential(
        E, jnp.array(x1), jnp.array(x2c), jnp.array(inl)
    )
    np.testing.assert_allclose(np.asarray(Re), R, atol=1e-3)
    te = np.asarray(te)
    np.testing.assert_allclose(
        te / np.linalg.norm(te), t / np.linalg.norm(t), atol=1e-3
    )
    # inlier Sampson distances are tiny under the recovered E
    d = np.asarray(sampson_sq(E, jnp.array(x1), jnp.array(x2c)))
    assert np.median(np.sqrt(d[inl])) < 1e-4


def test_ransac_pipeline_with_bad_matches():
    """two_view_problem with RANSAC survives descriptor confusion: corrupt
    a fifth of the matches by duplicating textures; the resulting problem
    must still bundle-adjust to the pixel-rounding floor."""
    from psba_tpu.frontend.pipeline import two_view_problem
    from psba_tpu.solvers import SolverConfig
    from psba_tpu.solvers.hybrid import solve

    rng = np.random.default_rng(9)
    n = 40
    X = rng.uniform([-1.2, -0.9, 4], [1.2, 0.9, 8], size=(n, 3))
    K = [200.0, 80.0, 60.0, 1.0, 0.0]
    ang = 0.08
    R = np.array(
        [[np.cos(ang), 0, np.sin(ang)], [0, 1, 0],
         [-np.sin(ang), 0, np.cos(ang)]]
    )
    t = np.array([-0.6, 0.0, 0.0])
    uv1 = X[:, :2] / X[:, 2:3] * K[0] + np.array(K[1:3])
    Xc2 = X @ R.T + t
    uv2 = Xc2[:, :2] / Xc2[:, 2:3] * K[0] + np.array(K[1:3])
    # corrupt: shuffle 8 of the second-view blob positions so their
    # (identical) textures match the wrong first-view features
    uv2c = uv2.copy()
    swap = rng.choice(n, 8, replace=False)
    uv2c[swap] = uv2c[np.roll(swap, 1)]
    img1 = _render(uv1, H=120, W=160)
    img2 = _render(uv2c, H=120, W=160)

    prob = two_view_problem(jnp.array(img1), jnp.array(img2), K,
                            n_features=128, ransac_iters=64)
    assert prob.n_cams == 2 and prob.n_pts >= 10
    res = solve(prob, SolverConfig(max_iters=20, lm_switch_count=1000))
    rms = float(np.sqrt(res.final_l2 / prob.n_obs))
    assert rms < 1.5

"""The BAL-shaped generator (io.synthetic.bal_shaped_problem): the data
every GPU check and several unit fixtures are built from."""

import numpy as np
import pytest

from psba_tpu.io import bal_shaped_problem

SHAPES = [(21, 2000), (54, 5207), (93, 6000)]


@pytest.mark.parametrize("n_cams,n_pts", SHAPES)
def test_bal_shape(n_cams, n_pts):
    p = bal_shaped_problem(n_cams, n_pts, seed=0)
    p.validate()
    assert (p.n_cams, p.n_pts) == (n_cams, n_pts)
    assert p.obs.shape == (p.n_obs, 2)
    assert set(np.unique(p.cam_idx)) == set(range(n_cams))
    # BAL sparsity: a few percent of the camera-point table, not a ring
    # rig where every camera sees most points
    assert p.n_obs < 0.3 * n_cams * n_pts


@pytest.mark.parametrize("n_cams,n_pts", SHAPES)
def test_bal_mean_obs(n_cams, n_pts):
    for mean_obs in (4.0, 5.0):
        p = bal_shaped_problem(n_cams, n_pts, mean_obs=mean_obs, seed=1)
        assert abs(p.n_obs / p.n_pts - mean_obs) <= 0.1 * mean_obs


@pytest.mark.parametrize("n_cams,n_pts", SHAPES)
def test_bal_every_point_seen_twice(n_cams, n_pts):
    p = bal_shaped_problem(n_cams, n_pts, seed=2)
    counts = np.bincount(p.pt_idx, minlength=n_pts)
    assert counts.min() >= 2
    # no point is observed twice by one camera
    pairs = p.pt_idx.astype(np.int64) * n_cams + p.cam_idx
    assert len(np.unique(pairs)) == p.n_obs


@pytest.mark.parametrize("n_cams,n_pts", SHAPES)
def test_bal_seed_determinism(n_cams, n_pts):
    a = bal_shaped_problem(n_cams, n_pts, seed=3)
    b = bal_shaped_problem(n_cams, n_pts, seed=3)
    c = bal_shaped_problem(n_cams, n_pts, seed=4)
    for f in ("K", "q0", "cams", "pts", "obs", "cam_idx", "pt_idx"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    assert not np.array_equal(a.pts, c.pts)

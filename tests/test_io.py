"""Reader tests against the bundled reference datasets."""

import numpy as np
import pytest

from psba_tpu.io import load_problem, read_cams
from psba_tpu.problem import build_covis_pairs, visibility_mask
from tests.conftest import DATA, requires_data


@requires_data
def test_read_cams_varK():
    K, q0, t, dist = read_cams(f"{DATA}/7camsvarK.txt")
    assert K.shape == (7, 5) and dist is None
    np.testing.assert_allclose(K[0], [851.57945, 330.24755, 262.195, 1.00169, 0.0])
    # first camera: identity quaternion, zero translation
    np.testing.assert_allclose(q0[0], [1, 0, 0, 0], atol=1e-12)
    np.testing.assert_allclose(t[0], 0, atol=1e-12)
    assert np.all(q0[:, 0] >= 0)
    np.testing.assert_allclose(np.linalg.norm(q0, axis=1), 1.0, atol=1e-9)


@requires_data
def test_read_cams_varKD_drops_distortion():
    K, q0, t, dist = read_cams(f"{DATA}/54camsvarKD.txt")
    assert K.shape == (54, 5)
    assert dist is not None and dist.shape == (54, 5)


@requires_data
def test_read_cams_7col_requires_shared_K():
    with pytest.raises(ValueError):
        read_cams(f"{DATA}/3cams.txt")
    K, q0, t, _ = read_cams(
        f"{DATA}/3cams.txt", shared_K=[851.57945, 330.24755, 262.195, 1.00169, 0.0]
    )
    assert K.shape == (3, 5)


@requires_data
def test_load_problem_7cams(prob7_ref):
    assert prob7_ref.n_cams == 7
    assert prob7_ref.n_pts == 465
    assert prob7_ref.n_obs > prob7_ref.n_pts  # every point seen >= 1 time
    prob7_ref.validate()
    # obs sorted by point; indices consistent with vmask
    m = visibility_mask(prob7_ref)
    assert m.sum() == prob7_ref.n_obs


@requires_data
def test_load_problem_54cams(prob54_ref):
    assert prob54_ref.n_cams == 54
    assert prob54_ref.n_pts == 5207


@requires_data
def test_trafalgar_loads():
    prob = load_problem(
        f"{DATA}/Trafalgar-21-11315-cams.txt",
        f"{DATA}/Trafalgar-21-11315-pts.txt",
        build_pairs=False,
    )
    assert prob.n_cams == 21 and prob.n_pts == 11315


def test_covis_pairs_small():
    # two points: point 0 seen by cams {0,1}, point 1 by cams {1,2,3}
    pt_idx = np.array([0, 0, 1, 1, 1])
    cam_idx = np.array([0, 1, 1, 2, 3])
    o1, o2, bucket = build_covis_pairs(pt_idx, cam_idx, 4)
    assert len(o1) == 2 * 2 + 3 * 3
    # bucket sorted and consistent
    assert np.all(np.diff(bucket) >= 0)
    np.testing.assert_array_equal(bucket, cam_idx[o1] * 4 + cam_idx[o2])
    # each pair belongs to a single point
    np.testing.assert_array_equal(pt_idx[o1], pt_idx[o2])


def test_bal_roundtrip(tmp_path):
    """Write a tiny raw BAL file and convert it."""
    from psba_tpu.io.bal import bal_to_problem

    txt = """2 2 3
0 0 10.0 -5.0
1 0 11.0 -6.0
1 1 1.5 2.5
"""
    # two cameras: small rotation + translation, f, k1, k2
    cams = [
        [0.01, 0.02, 0.03, 0.1, 0.2, 0.3, 500.0, 0.0, 0.0],
        [0.0, 0.0, 0.0, 0.0, 0.0, 1.0, 600.0, 0.0, 0.0],
    ]
    pts = [[0.0, 0.0, -5.0], [0.5, 0.5, -4.0]]
    for c in cams:
        txt += "\n".join(str(x) for x in c) + "\n"
    for p in pts:
        txt += "\n".join(str(x) for x in p) + "\n"
    f = tmp_path / "mini.bal"
    f.write_text(txt)
    prob = bal_to_problem(str(f))
    assert prob.n_cams == 2 and prob.n_pts == 2 and prob.n_obs == 3
    # observations negated, sorted by point
    np.testing.assert_allclose(prob.obs[0], [-10.0, 5.0])
    assert prob.K[0, 0] == 500.0 and prob.K[0, 3] == 1.0


def test_bal_roundtrip_mini_fixture(tmp_path):
    """Raw-BAL reader proven on a checked-in miniature fixture
    (tests/data/mini_bal.txt: 20 cams / 100 pts / ~1200 obs in the
    documented BAL layout, consistent geometry + 0.5 px noise): convert
    -> solve -> noise-floor RMSE, and the write_sba_text round trip
    must reproduce the identical problem. This is the path real BAL
    points data takes the day it is available (final-RMSE parity on
    Venice/Rome/Dubrovnik awaits the data itself, datasets.py
    synthesizes points meanwhile)."""
    import os

    import numpy as np

    from psba_tpu.io import load_problem
    from psba_tpu.io.bal import bal_to_problem, write_sba_text
    from psba_tpu.solvers.hybrid import solve

    fixture = os.path.join(os.path.dirname(__file__), "data", "mini_bal.txt")
    prob = bal_to_problem(fixture)
    assert prob.n_cams == 20 and prob.n_pts == 100
    assert prob.n_obs > 1000

    res = solve(prob)
    rms = float(np.sqrt(res.final_l2 / prob.n_obs))
    # obs carry 0.5 px noise; converged solve must reach the noise floor
    assert rms < 0.65, (rms, res.flag_name)
    assert res.final_l2 < 0.25 * res.initial_l2

    # round trip through the reference's text pair: identical problem
    cams_p = str(tmp_path / "c.txt")
    pts_p = str(tmp_path / "p.txt")
    write_sba_text(prob, cams_p, pts_p)
    prob2 = load_problem(cams_p, pts_p)
    assert prob2.n_obs == prob.n_obs
    res2 = solve(prob2)
    np.testing.assert_allclose(res2.initial_l2, res.initial_l2, rtol=1e-7)
    np.testing.assert_allclose(res2.final_l2, res.final_l2, rtol=1e-5)


def test_native_bal_parser_matches_python(tmp_path):
    """The C++ raw-BAL stream parser (native/loader.cpp) must return the
    byte-identical problem the NumPy fallback produces on the checked-in
    miniature fixture."""
    import os

    import numpy as np

    from psba_tpu.io import native

    if not (native.available() and native.has_bal()):
        import pytest

        pytest.skip("native loader not built")

    import psba_tpu.io.bal as balmod

    fixture = os.path.join(os.path.dirname(__file__), "data", "mini_bal.txt")
    nat = native.read_bal(fixture)

    # force the NumPy path for comparison
    orig = native.has_bal
    native.has_bal = lambda: False
    try:
        ref = balmod.read_bal(fixture)
    finally:
        native.has_bal = orig
    for a, b in zip(nat, ref):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

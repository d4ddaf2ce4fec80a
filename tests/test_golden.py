"""Golden parity gates.

PARITY_GOLDEN.json pins the f64 hybrid's final reprojection error
sqrt(L2)/n2Dprojs — the reference driver's verification currency
(PSBA/main.cpp:216-217) — for every complete bundled dataset
(regenerate with benchmarks/make_golden.py). These tests replace the
loose upper bounds of round 1:

  - initial_error to rtol 1e-9 (pure function of the parsed input —
    an I/O-parity gate),
  - f64 final_error to rtol 1e-6,
  - the f32 fast path within 10% of the f64 optimum, and
  - f32 + f64 polish back to the golden value (rtol 1e-5): the
    mixed-precision strategy of SURVEY.md §7 must recover full precision.
"""

import json
import os

import numpy as np
import pytest

from psba_tpu import datasets
from psba_tpu.solvers import SolverConfig
from psba_tpu.solvers.hybrid import solve
from tests.conftest import requires_data

GOLDEN_PATH = os.path.join(os.path.dirname(__file__), "..",
                           "PARITY_GOLDEN.json")

with open(GOLDEN_PATH) as f:
    GOLDEN = json.load(f)

SMALL = ["3cams", "5cams", "7cams", "7camsvarK", "9cams", "9camsvarK",
         "54cams", "54camsvarK", "54camsvarKD"]


@requires_data
@pytest.mark.parametrize("name", SMALL)
def test_golden_f64(name):
    g = GOLDEN[name]
    prob = datasets.load(name)
    assert (prob.n_cams, prob.n_pts, prob.n_obs) == (
        g["n_cams"], g["n_pts"], g["n_obs"]
    )
    res = solve(prob, SolverConfig())
    np.testing.assert_allclose(
        res.initial_error, g["initial_error"], rtol=1e-9
    )
    if g["final_error"] < 1e-8:
        # exact-interpolation optimum (3cams): the pinned value is f64
        # roundoff noise, so gate "converges to zero" absolutely rather
        # than pinning the noise itself
        assert res.final_error < 1e-8
    else:
        np.testing.assert_allclose(
            res.final_error, g["final_error"], rtol=1e-6
        )
    # 5cams is gauge-singular (see the F32_GAP note): even in f64 its
    # iteration count wobbles with summation order (a point reordering
    # once moved it 32 -> 36 while the final error stayed at rtol 1e-6
    # parity); the error gate above is the real parity check
    assert abs(res.iterations - g["iterations"]) <= (
        8 if name == "5cams" else 2
    )


@requires_data
def test_golden_f64_trafalgar21():
    g = GOLDEN["trafalgar21"]
    res = solve(datasets.load("trafalgar21"), SolverConfig())
    np.testing.assert_allclose(
        res.initial_error, g["initial_error"], rtol=1e-9
    )
    np.testing.assert_allclose(res.final_error, g["final_error"], rtol=1e-6)


# 3cams is excluded from the f32 gate: 7 observations vs ~21 free
# parameters make it an exact-interpolation problem whose optimum
# (final_error 4.8e-9) sits ~5 orders below the f32 precision floor;
# the f64 golden gate still covers it.
F32_GATED = [n for n in SMALL if n != "3cams"] + ["trafalgar21"]
# 5cams (43 obs, 13 pts) is barely overdetermined AND gauge-singular
# enough that the f32 trajectory is chaotic: S at lambda=0 is
# numerically indefinite, so TR's GMW bootstrap lambda = |sum E|/n
# (trust_region.cpp:341-366) is dominated by f32 rounding in S, and
# any summation-order change lands the run at a different local stop.
# Measured spread of code-equivalent variants so far: 1.1x-3.9x the f64
# optimum across Schur layout and Cholesky changes and the switch of the
# 3x3 block scaling to exact power-of-two (the cleaner arithmetic simply
# lands this chaotic trajectory elsewhere). The gate here is a sanity bound on that
# measured spread; the STRICT gate for 5cams-class numerics is
# test_golden_f32_polish_recovers, which requires the polished run to
# hit the f64 optimum at rtol 1e-5.
F32_GAP = {"5cams": 4.5}


@requires_data
@pytest.mark.parametrize("name", F32_GATED)
def test_golden_f32_gap(name):
    """The f32 fast path must land within 10% of the f64 optimum on every
    complete dataset (the bench configuration trafalgar21 included, so a
    numerics regression in the fast path cannot pass CI unnoticed)."""
    import jax.numpy as jnp

    g = GOLDEN[name]
    res = solve(datasets.load(name), SolverConfig.for_dtype(jnp.float32),
                dtype=jnp.float32)
    gap = F32_GAP.get(name, 1.10)
    assert res.final_error <= max(gap * g["final_error"], 5e-5)


@requires_data
@pytest.mark.parametrize(
    "name", ["5cams", "7camsvarK", "9camsvarK", "54camsvarKD", "trafalgar21"]
)
def test_golden_f32_polish_recovers(name):
    """f32 run + f64 LM polish must recover the full-precision optimum
    on every dataset family (one representative per camera count)."""
    import jax.numpy as jnp

    g = GOLDEN[name]
    # 5cams' chaotic f32 phase (see F32_GAP note) parks further from the
    # optimum, so its polish needs a larger iteration budget; the stop
    # test (PSBA_EPSILON2) ends all runs early once converged.
    res = solve(
        datasets.load(name), SolverConfig.for_dtype(jnp.float32),
        dtype=jnp.float32, polish_iters=300 if name == "5cams" else 30,
    )
    np.testing.assert_allclose(res.final_error, g["final_error"], rtol=1e-5)


def test_f32_tight_gate_non_gauge_singular():
    """Tight f32 gate on a well-conditioned fixture: unlike the bundled
    small sets (5cams is gauge-singular and f32-chaotic, see F32_GAP),
    a synthetic ring with redundant observations has one well-separated
    optimum, and the f32 fast path lands within ~6e-7 relative of the
    f64 optimum (measured across seeds). rtol 1e-4 leaves margin for
    platform/summation-order variation while still catching any real
    f32-path numerics regression that the wide 10%/4.5x sanity gates
    would absorb."""
    import jax.numpy as jnp

    from psba_tpu.io import synthetic_problem

    prob = synthetic_problem(n_cams=8, n_pts=400, seed=3, noise_px=0.5)
    r64 = solve(prob)
    r32 = solve(prob, SolverConfig.for_dtype(jnp.float32),
                dtype=jnp.float32)
    np.testing.assert_allclose(r32.final_error, r64.final_error, rtol=1e-4)

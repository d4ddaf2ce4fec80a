"""Multi-device tests on the virtual 8-way CPU mesh.

The invariant under test: the distributed solver is bitwise-equivalent in
structure (same control decisions) and numerically equivalent (up to psum
reduction-order roundoff) to the single-device solver."""

import jax
import numpy as np
import pytest

from psba_tpu.parallel.shard import shard_problem, solve_sharded
from psba_tpu.solvers import SolverConfig
from psba_tpu.solvers.hybrid import solve

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 4, reason="needs >=4 virtual devices"
)


def test_shard_problem_partition(prob_synth):
    sp = shard_problem(prob_synth, 4)
    assert sp.pt_starts[0] == 0 and sp.pt_starts[-1] == prob_synth.n_pts
    assert np.all(np.diff(sp.pt_starts) > 0)
    # all real observations present exactly once
    assert sp.valid.sum() == prob_synth.n_obs
    # shard-local point indices in range
    pt = sp.pt_idx.reshape(4, sp.o_per)
    for d in range(4):
        n_p = sp.pt_starts[d + 1] - sp.pt_starts[d]
        assert pt[d].max() < n_p
    # observation balance within 30%
    per_dev = sp.valid.reshape(4, sp.o_per).sum(axis=1)
    assert per_dev.max() <= 1.3 * per_dev.min()


def test_sharded_matches_single_lm(prob_synth):
    """Pure-LM trajectory: acceptance decisions (rho > 0) are far from
    their thresholds, so the sharded run must take the same path; only the
    final ||dp|| stop-test crossing may shift by one iteration (dp -> 0 at
    the optimum, so its threshold comparison sits at roundoff)."""
    cfg = SolverConfig(lm_switch_count=10**6)
    r1 = solve(prob_synth, cfg)
    r4 = solve_sharded(prob_synth, cfg, n_devices=4)
    assert abs(r4.iterations - r1.iterations) <= 1
    assert r4.flag == r1.flag
    np.testing.assert_allclose(r4.final_l2, r1.final_l2, rtol=1e-9)
    np.testing.assert_allclose(r4.cams, r1.cams, rtol=1e-3, atol=1e-5)


def test_sharded_matches_single_hybrid(prob_synth):
    """Hybrid trajectory: the LM<->TR switch counters sit on |rho-1|<0.2
    style thresholds, so psum reduction-order roundoff may legitimately
    reroute the path; the invariant is the reached optimum, not the route."""
    r1 = solve(prob_synth)
    r4 = solve_sharded(prob_synth, n_devices=4)
    np.testing.assert_allclose(r4.final_l2, r1.final_l2, rtol=1e-9)
    np.testing.assert_allclose(r4.cams, r1.cams, rtol=1e-3, atol=1e-5)


def test_sharded_8dev(prob_synth):
    r8 = solve_sharded(prob_synth, n_devices=8)
    r1 = solve(prob_synth)
    np.testing.assert_allclose(r8.final_l2, r1.final_l2, rtol=1e-9)


def test_graft_entry_multichip():
    import __graft_entry__ as g

    g.dryrun_multichip(8)


def test_sharded_history(prob_synth):
    """--mesh N --verbose must capture per-iteration lines: history rows
    are built from psum'd (replicated) scalars and returned replicated."""
    from psba_tpu.parallel.shard import solve_sharded

    cfg = SolverConfig(record_history=True)
    res = solve_sharded(prob_synth, cfg, n_devices=4)
    assert res.history is not None
    rows = res.history[~np.isnan(res.history[:, 0])]
    assert len(rows) == res.iterations
    assert "itno=0" in res.format_history()


def test_sharded_lm_repeat_matches_single_run(prob_synth):
    """The timing repeat runner (one dispatch = K identical sharded
    solves, benchmarks/scaling_v2.py's measurement primitive) must
    reproduce K x the single run's iteration count and K x its final
    L2 — i.e. every repeat genuinely executes the same trajectory."""
    import jax
    import jax.numpy as jnp

    from psba_tpu.parallel.shard import (
        make_sharded_lm_repeat,
        make_sharded_runners,
        shard_problem,
    )
    from psba_tpu.solvers.types import SolverConfig

    cfg = SolverConfig(
        max_iters=64, stop_thresh=1e-30, lm_switch_count=10_000,
        damping="additive",
    )
    sp = shard_problem(prob_synth, 4)
    mesh = jax.make_mesh((4,), ("obs",))
    pa, cams0, pts0, init_s, lm_s, _ = make_sharded_runners(
        sp, cfg, mesh, dtype=jnp.float64
    )
    state0 = init_s(pa, cams0, pts0)
    n = 5
    ref = lm_s(pa, state0, jnp.int32(n))

    rep = make_sharded_lm_repeat(sp, cfg, mesh)
    acc, itno = rep(pa, state0, jnp.int32(n), jnp.int32(3))
    assert int(itno) == 3 * n
    np.testing.assert_allclose(float(acc), 3.0 * float(ref.ex_l2),
                               rtol=1e-12)


@pytest.mark.parametrize("mixed", [False, True])
def test_damping_probe_chunked_matches_solve(prob_synth, monkeypatch, mixed):
    """The sharded entry points resolve damping="auto" from diag(J^T J)
    summed over observation chunks; the decision must be solve()'s, in
    f32 and f64, whatever the chunk size."""
    import jax.numpy as jnp

    from psba_tpu.parallel import shard
    from psba_tpu.solvers.types import ProblemArrays, resolve_damping
    from tests.test_solvers import _mixed_scale_problem

    prob = _mixed_scale_problem() if mixed else prob_synth
    monkeypatch.setattr(shard, "_PROBE_MAX_OBS", 97)  # ragged last chunk
    assert prob.n_obs > 2 * 97 and prob.n_obs % 97
    for dt in (jnp.float32, jnp.float64):
        cfg = SolverConfig.for_dtype(dt)
        pa = ProblemArrays.from_problem(prob, dtype=dt)
        want = resolve_damping(cfg, pa, jnp.asarray(prob.cams, dt),
                               jnp.asarray(prob.pts, dt))
        got = shard._resolve_damping_host(cfg, prob, dt)
        assert got == want
    assert got.damping == "additive"  # f64 represents both problems
    if mixed:
        f32 = shard._resolve_damping_host(
            SolverConfig.for_dtype(jnp.float32), prob, jnp.float32)
        assert f32.damping == "marquardt"

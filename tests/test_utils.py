"""History recording, checkpoint/resume, timing utilities."""

import numpy as np

from psba_tpu.solvers import SolverConfig
from psba_tpu.solvers.hybrid import solve


def test_history_recording(prob_synth):
    res = solve(prob_synth, SolverConfig(record_history=True))
    assert res.history is not None
    rows = res.history[~np.isnan(res.history[:, 0])]
    assert len(rows) == res.iterations
    # itno strictly increasing, errors decreasing overall
    assert np.all(np.diff(rows[:, 0]) == 1)
    assert rows[-1, 1] <= rows[0, 1]
    txt = res.format_history()
    assert "itno=0" in txt and "Err=" in txt


def test_checkpoint_resume(prob_synth, tmp_path):
    ck = str(tmp_path / "ckpt")
    res = solve(prob_synth, checkpoint_dir=ck)
    from psba_tpu.utils import checkpoint

    restored = checkpoint.load_latest(ck)
    assert restored is not None
    cams, pts, meta = restored
    np.testing.assert_allclose(cams, res.cams)
    assert meta["itno"] == res.iterations

    # resume: solver restarts from the checkpointed state and stops fast
    res2 = solve(prob_synth, checkpoint_dir=ck)
    assert res2.final_l2 <= res.final_l2 * (1 + 1e-9)


def test_chunked_checkpoint_matches_unchunked(prob_synth, tmp_path):
    """Iteration-boundary (chunked) checkpointing must not perturb the
    optimization: the aux phase-scalar carry makes each chunk resume the
    exact mu/nu (LM) or delta/lambda (TR) trajectory."""
    res_ref = solve(prob_synth)
    res_ck = solve(
        prob_synth, checkpoint_dir=str(tmp_path / "ck"), checkpoint_every=3
    )
    assert res_ck.iterations == res_ref.iterations
    assert res_ck.flag == res_ref.flag
    np.testing.assert_allclose(res_ck.final_l2, res_ref.final_l2, rtol=1e-9)
    np.testing.assert_allclose(res_ck.cams, res_ref.cams, atol=1e-8)
    np.testing.assert_allclose(res_ck.pts, res_ref.pts, atol=1e-8)


def test_chunked_resume_midphase(prob_synth, tmp_path):
    """Simulated interruption: point `latest` back at a mid-phase
    checkpoint (one carrying aux) and resume; the continued run must land
    on the same optimum over the same total iteration count."""
    import numpy as _np

    ck = tmp_path / "ck"
    res_full = solve(prob_synth, checkpoint_dir=str(ck), checkpoint_every=3)
    files = sorted(ck.glob("ckpt_*.npz"))
    assert len(files) >= 2
    mid = None
    for f in files[:-1]:
        with _np.load(f, allow_pickle=False) as z:
            if "aux" in z.files:
                mid = f
                break
    assert mid is not None, "no mid-phase checkpoint carried aux"
    (ck / "latest").write_text(mid.name)
    res_res = solve(prob_synth, checkpoint_dir=str(ck), checkpoint_every=3)
    assert res_res.iterations == res_full.iterations
    np.testing.assert_allclose(
        res_res.final_l2, res_full.final_l2, rtol=1e-9
    )
    # params agree to optimization (not bitwise) precision: resume
    # recomputes the residual outside the jitted loop, and the last-bit
    # difference walks through the remaining iterations
    np.testing.assert_allclose(
        res_res.cams, res_full.cams, rtol=1e-3, atol=1e-6
    )


def test_polish_phase_checkpoints(prob_synth, tmp_path):
    """The f64 polish phase checkpoints (phase 'lm64' + polish_target in
    meta) and resumes mid-polish."""
    import jax.numpy as jnp

    from psba_tpu.utils import checkpoint

    ck = tmp_path / "ck"
    res = solve(
        prob_synth, dtype=jnp.float32, polish_iters=4,
        checkpoint_dir=str(ck), checkpoint_every=2,
    )
    restored = checkpoint.load_latest(str(ck))
    assert restored is not None
    _, _, meta = restored
    assert meta["phase"] == "lm64"
    assert meta["polish_target"] is not None
    # resume into the polish phase from a mid-lm64 checkpoint
    import numpy as _np

    mid = None
    for f in sorted(ck.glob("ckpt_*.npz")):
        with _np.load(f, allow_pickle=False) as z:
            m = __import__("json").loads(str(z["meta"]))
            if m.get("phase") == "lm64" and "aux" in z.files:
                mid = f
                break
    if mid is not None:
        (ck / "latest").write_text(mid.name)
        res2 = solve(
            prob_synth, dtype=jnp.float32, polish_iters=4,
            checkpoint_dir=str(ck), checkpoint_every=2,
        )
        assert res2.iterations == res.iterations
        np.testing.assert_allclose(res2.final_l2, res.final_l2, rtol=1e-6)


def test_phase_timers_in_solve(prob_synth):
    # hybrid.solve times each phase with PhaseTimers (the reference's
    # clock() accumulator report, main.cpp:220-227)
    res = solve(prob_synth)
    assert "lm" in res.phase_report
    assert "phase timing:" in res.phase_report

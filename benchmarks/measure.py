"""Noise-guarded marginal timing shared by the benchmarks/ scripts.

A fixed short marginal window (t(N2) - t(N1) over a few iterations) can
sit under the host timer's jitter floor, and the subtraction is then pure
noise, with a sign. Two guards live here:

1. REPEATS: `lm_repeat_runner` wraps a solver run in a device-side
   `fori_loop` so ONE dispatch executes K identical full runs.  The
   marginal window (t(K2) - t(K1)) then grows arbitrarily — it is no
   longer capped by the dataset's convergence horizon (a stop-disabled
   f32 trajectory supports only a few dozen iterations before mu
   escalates to overflow).  Each repeat re-runs the SAME trajectory
   from the same initial state, so per-iteration work is the real
   solver's work, not a synthetic kernel loop.

2. GUARD: `marginal_iter_ms` measures the observed per-call jitter
   (max - min over `reps` calls), uses the MEDIAN call time, escalates
   K2 geometrically until the window clears `noise_mult` x jitter, and
   REFUSES to emit a number when it cannot (returns None + a diagnosis
   dict) instead of publishing noise with a sign.

Reference for the metric being measured: the per-iteration wall-clock
the reference driver prints per LM iteration (PSBA/main.cpp:214-227).
"""

from __future__ import annotations

import time


def lm_repeat_runner(run=None):
    """Build a jitted `(pa, state0, cfg, iter_cap, repeats) -> scalar`
    that executes `repeats` identical solver runs in one dispatch.

    `repeats` and `iter_cap` are traced int32 scalars: every K shares one
    compiled executable.

    Each repeat's initial state is perturbed by `min(acc, 0)` — exactly
    0.0 at runtime (acc accumulates nonnegative L2 values) but
    data-dependent on the previous repeat's output, so XLA cannot hoist
    the loop body as loop-invariant and every repeat genuinely executes.
    """
    import jax
    import jax.numpy as jnp

    if run is None:
        from psba_tpu.solvers.lm import lm_run as run

    def repeat_run(pa, state0, cfg, iter_cap, repeats):
        zero = jnp.zeros((), state0.cams.dtype)

        def body(_k, carry):
            acc, itno = carry
            eps = jnp.minimum(acc, zero)  # == 0.0; defeats LICM
            st = state0._replace(cams=state0.cams + eps)
            out = run(pa, st, cfg, iter_cap=iter_cap)
            return acc + out.ex_l2, itno + out.itno

        return jax.lax.fori_loop(
            0, repeats, body, (zero, jnp.int32(0))
        )

    return jax.jit(repeat_run, static_argnames=("cfg",))


def marginal_iter_ms(
    call,
    iters_per_repeat: int,
    *,
    k1: int = 2,
    k_max: int = 256,
    reps: int = 7,
    noise_mult: float = 10.0,
):
    """Escalating-window marginal per-iteration time with a noise guard.

    call(k) -> wall-clock seconds for one blocked dispatch of k repeats
    (the caller warms compilation itself or lets the first timed() call
    absorb it — timed() always runs one untimed warm call per K).

    Returns (iter_ms | None, diag) where diag records the window, the
    jitter floor, and the Ks used.  iter_ms is None when even K=k_max
    cannot lift the window above noise_mult x the observed jitter.
    """

    def timed(k):
        call(k)  # warm: compile (first K only) + page-in
        ts = sorted(call(k) for _ in range(reps))
        med = ts[len(ts) // 2]
        # trimmed spread: drop the single best and worst sample before
        # estimating jitter — a shared host occasionally delays one call
        # by tens of ms, and a max-min estimate would let one outlier
        # veto an otherwise clean measurement (the medians the window is
        # built from are robust to it)
        trim = ts[1:-1] if len(ts) >= 4 else ts
        jitter = trim[-1] - trim[0]
        return med, jitter

    t1, j1 = timed(k1)
    k2 = max(k1 * 4, 8)
    while True:
        t2, j2 = timed(k2)
        window = t2 - t1
        floor = noise_mult * max(j1, j2, 1e-4)
        diag = {
            "k1": k1,
            "k2": k2,
            "iters_per_repeat": iters_per_repeat,
            "reps_per_point": reps,
            "window_ms": round(window * 1e3, 3),
            "noise_floor_ms": round(floor * 1e3, 3),
            "t_k1_ms": round(t1 * 1e3, 3),
            "t_k2_ms": round(t2 * 1e3, 3),
        }
        if window >= floor:
            ms = window / ((k2 - k1) * iters_per_repeat) * 1e3
            return ms, diag
        if k2 >= k_max:
            diag["note"] = (
                f"window {window * 1e3:.2f} ms at K2={k2} is below the "
                f"{noise_mult:.0f}x timer-jitter floor "
                f"({floor * 1e3:.2f} ms); refusing to emit a value"
            )
            return None, diag
        k2 = min(k2 * 4, k_max)


def make_timed_call(run_repeat, pa, state0, cfg, iter_cap):
    """Bind a repeat runner into the `call(k) -> seconds` shape
    marginal_iter_ms consumes.  Blocks on the scalar result."""
    import jax.numpy as jnp

    def call(k):
        t0 = time.perf_counter()
        acc, _it = run_repeat(
            pa, state0, cfg, jnp.int32(iter_cap), jnp.int32(k)
        )
        float(acc)  # device sync
        return time.perf_counter() - t0

    return call

"""SPD factor-and-solve of the reduced camera system (core.linalg)."""

import jax.numpy as jnp
import numpy as np
import pytest

from psba_tpu.core.linalg import spd_solve


def _random_spd(n, seed):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((n, n))
    S = (A @ A.T + n * np.eye(n)).astype(np.float32)
    b = rng.standard_normal(n).astype(np.float32)
    return S, b


def _indefinite():
    S = np.eye(24, dtype=np.float32)
    S[5, 5] = -2.0
    return S, np.ones(24, np.float32)


def _badly_scaled():
    """Diagonal scales spanning ~1e12 (the Dubrovnik-88 regime after
    damping)."""
    rng = np.random.default_rng(1)
    n = 30
    d = 10.0 ** rng.uniform(0, 12, n)
    A = rng.standard_normal((n, n)) * 0.01
    S = (np.diag(d) + A @ A.T).astype(np.float32)
    b = (d * rng.standard_normal(n)).astype(np.float32)
    return S, b


@pytest.mark.parametrize("case", [
    "spd18", "spd126", "spd130", "indefinite", "badly_scaled", "n1024",
])
def test_spd_solve(case):
    """f32 solves at block-multiple and ragged sizes (n = 6C and not), a
    failure flag on an indefinite matrix with the garbage zeroed, a badly
    scaled system, and n = 1024 (6C for C ~ 170 cameras)."""
    if case == "indefinite":
        S, b = _indefinite()
        x, ok = spd_solve(jnp.asarray(S), jnp.asarray(b))
        assert not bool(ok)
        assert bool(jnp.all(x == 0.0))  # garbage suppressed on failure
        return
    if case == "badly_scaled":
        S, b = _badly_scaled()
        tol = 1e-3
    elif case == "n1024":
        S, b = _random_spd(1024, 7)
        tol = 5e-3
    else:
        n = int(case[3:])
        S, b = _random_spd(n, n)
        tol = 5e-3
    x, ok = spd_solve(jnp.asarray(S), jnp.asarray(b))
    assert bool(ok)
    ref = np.linalg.solve(S.astype(np.float64), b.astype(np.float64))
    np.testing.assert_allclose(
        np.asarray(x), ref, atol=tol * np.max(np.abs(ref))
    )

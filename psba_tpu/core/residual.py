"""Reprojection residuals.

Equivalent of kern_compute_exQT (CL_files/compute_exQT.cl:18-71):
one fused, vectorized evaluation over the observation axis instead of a
per-work-item kernel. XLA fuses the gather + quaternion algebra + projection
into a single elementwise loop over observations.
"""

from __future__ import annotations

import jax.numpy as jnp

from psba_tpu.models.pinhole import project_quat


def residuals(K, q0, cams, pts, obs, cam_idx, pt_idx, clamp: bool = False):
    """ex_o = x_o - proj(K_j, q_local(v_j) (x) q0_j, t_j, X_i)  -> [O, 2].

    K [C,5], q0 [C,4], cams [C,6] (v|t), pts [P,3], obs [O,2].
    """
    Kg = K[cam_idx]
    q0g = q0[cam_idx]
    v = cams[cam_idx, 0:3]
    t = cams[cam_idx, 3:6]
    X = pts[pt_idx]
    pred = project_quat(Kg, q0g, v, t, X, clamp=clamp)
    return obs - pred


def error_l2(ex, valid=None):
    """Sum of squared residuals (the quantity the reference tracks as ex_L2,
    levmar.cpp:94). `valid` [O] optionally masks padded observations."""
    e2 = jnp.sum(ex * ex, axis=-1)
    if valid is not None:
        e2 = jnp.where(valid, e2, 0.0)
    return jnp.sum(e2)


def error_l2_diff(ex_old, ex_new, valid=None):
    """sum||ex_old||^2 - sum||ex_new||^2 computed as
    sum (e_old - e_new)(e_old + e_new).

    The reference forms this difference from two separately accumulated
    norms (compute_rho, levmar.cpp:271-280) — catastrophic cancellation in
    float32 once the improvement falls below eps * L2. The factored form
    keeps the gain ratio meaningful near convergence on the fast f32 path
    (intentional numerical improvement; identical in exact arithmetic)."""
    d = (ex_old - ex_new) * (ex_old + ex_new)
    s = jnp.sum(d, axis=-1)
    if valid is not None:
        s = jnp.where(valid, s, 0.0)
    return jnp.sum(s)


def rms_error(ex_l2, n_obs):
    """The reference's reported metric sqrt(sum ||ex||^2) / n2Dprojs
    (main.cpp:216-217)."""
    return jnp.sqrt(ex_l2) / n_obs

"""Analytic reprojection Jacobians.

Equivalent of kern_compute_jacobiQT (CL_files/compute_jacobiQT.cl:
7-141): per-observation blocks A_o = d(x̂)/d(cam) in R^{2x6} and
B_o = d(x̂)/d(point) in R^{2x3}, where x̂ is the predicted projection and the
camera parameters are [v (local rotation vector part), t].

Unlike the reference's Maple-expanded scalar expressions, the blocks are
built from the structured chain rule (all batched over the observation axis;
cross-checked against jax.jacfwd in tests/test_jacobian.py):

  p_c = R(q_l(v)) X0 + t,    X0 = R(q0) X,    q_l = (s, v), s = sqrt(1-||v||^2)

  dproj/dp_c = [[fu, sk, -(fu x + sk y)/z],
                [0, fu*ar, -(fu*ar*y)/z]] / z
  dp_c/dt = I
  dp_c/dX = R(q_l (x) q0)
  dp_c/dv = -(2/s) w v^T - 2 s [X0]x - 2 [w]x - 2 [v]x [X0]x,   w = v x X0

The A-block column order matches the reference (rotation columns then
translation, compute_jacobiQT.cl:113-118).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from psba_tpu.models.quaternion import (
    compose_local,
    local_scalar,
    quat_rotate,
    quat_to_matrix,
)


def _skew(v):
    """[..., 3] -> [..., 3, 3] cross-product matrices [v]x."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = jnp.zeros_like(x)
    m = jnp.stack(
        [zero, -z, y, z, zero, -x, -y, x, zero], axis=-1
    )
    return m.reshape(m.shape[:-1] + (3, 3))


def _dproj_dpc(K, pc):
    """[..., 5], [..., 3] -> [..., 2, 3]."""
    fu, ar, sk = K[..., 0], K[..., 3], K[..., 4]
    x, y, z = pc[..., 0], pc[..., 1], pc[..., 2]
    inv_z = 1.0 / z
    zero = jnp.zeros_like(fu)
    row_u = jnp.stack([fu, sk, -(fu * x + sk * y) * inv_z], axis=-1)
    row_v = jnp.stack([zero, fu * ar, -(fu * ar * y) * inv_z], axis=-1)
    return jnp.stack([row_u, row_v], axis=-2) * inv_z[..., None, None]


def jacobians(K, q0, cams, pts, cam_idx, pt_idx, clamp: bool = False):
    """Return (A [O,2,6], B [O,2,3]) — Jacobians of the *prediction* x̂
    (the residual Jacobian is their negation; the solver follows the
    reference's sign convention g = J^T ex with J = dx̂/dp)."""
    Kg = K[cam_idx]
    q0g = q0[cam_idx]
    v = cams[cam_idx, 0:3]
    t = cams[cam_idx, 3:6]
    X = pts[pt_idx]

    # every einsum on this path pins Precision.HIGHEST: an unpinned f32
    # contraction may run in a reduced-precision format (TF32 on NVIDIA
    # GPUs), which the cancellation-heavy rotation-jacobian entries
    # cannot afford
    s = local_scalar(v, clamp=clamp)[..., None]          # [O,1]
    q = compose_local(v, q0g, clamp=clamp)               # [O,4]
    R0 = quat_to_matrix(q0g)                             # [O,3,3]
    X0 = jnp.einsum("oij,oj->oi", R0, X,
                    precision=jax.lax.Precision.HIGHEST)  # [O,3]
    w = jnp.cross(v, X0)                                 # [O,3]
    pc = X0 + 2.0 * s * w + 2.0 * jnp.cross(v, w) + t    # [O,3]

    P = _dproj_dpc(Kg, pc)                               # [O,2,3]

    # dp_c/dv
    M = (
        -(2.0 / s)[..., None] * w[..., :, None] * v[..., None, :]
        - 2.0 * s[..., None] * _skew(X0)
        - 2.0 * _skew(w)
        - 2.0 * jnp.einsum("oij,ojk->oik", _skew(v), _skew(X0),
                           precision=jax.lax.Precision.HIGHEST)
    )                                                    # [O,3,3]

    A_rot = jnp.einsum("oij,ojk->oik", P, M,
                       precision=jax.lax.Precision.HIGHEST)  # [O,2,3]
    A = jnp.concatenate([A_rot, P], axis=-1)             # [O,2,6]
    Rq = quat_to_matrix(q)                               # [O,3,3]
    B = jnp.einsum("oij,ojk->oik", P, Rq,
                   precision=jax.lax.Precision.HIGHEST)  # [O,2,3]
    return A, B


def jmultiply(A, B, x_cams, x_pts, cam_idx, pt_idx):
    """(J x)_o = A_o x_cam[j(o)] + B_o x_pt[i(o)]  -> [O, 2].

    Equivalent of kern_compute_Jmultiply
    (CL_files/compute_Jmultiply.cl): the reference materializes a dense
    (point, cam) layout with zeros at unobserved slots; since those entries
    contribute nothing to the dot products the TR solver takes, the per-
    observation form is exact and O(nnz).
    """
    xc = x_cams.reshape(-1, 6)[cam_idx]
    xp = x_pts.reshape(-1, 3)[pt_idx]
    hp = jax.lax.Precision.HIGHEST
    return (
        jnp.einsum("oij,oj->oi", A, xc, precision=hp)
        + jnp.einsum("oij,oj->oi", B, xp, precision=hp)
    )

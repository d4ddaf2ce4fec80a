"""Block Hessian assembly: U, V, W, g.

Equivalents of kern_compute_U / _V / _Wblks / _g
(CL_files/compute_U.cl, compute_V.cl, compute_Wblks.cl, compute_g.cl).
The reference launches one work-item per matrix element, each looping over
the dense (point x cam) lookup table blk_idx; here each quantity is a
batched block product over observations followed by a segment reduction:

  U_j = coeff * sum_{o: cam(o)=j} A_o^T A_o        [C,6,6]
  V_i = coeff * sum_{o: pt(o)=i}  B_o^T B_o        [P,3,3]
  W_o = coeff * A_o^T B_o                          [O,6,3]   (per-observation)
  ga_j = coeff * sum_{o: cam(o)=j} A_o^T ex_o      [C,6]
  gb_i = coeff * sum_{o: pt(o)=i}  B_o^T ex_o      [P,3]

`coeff` is +1 in the LM loop (levmar.cpp:104-108) and +2 / -2 for the
B = 2 J^T J / g = -2 J^T ex convention in the TR loop
(trust_region.cpp:122-137).

Damping (kern_update_UV / kern_restore_UVdiag) is functional here: damped
copies are produced by `damp_uv`, the originals simply stay alive.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from psba_tpu.ops.reduce import indexed_sum


def assemble_blocks(A, B, ex, cam_idx, pt_idx, n_cams, n_pts, coeff=1.0,
                    valid=None):
    """Return (U [C,6,6], V [P,3,3], W [O,6,3], ga [C,6], gb [P,3]).

    One fused Gram product G_o = [A|B|ex]^T [A|B|ex] per observation
    yields every block at once (U/V/W/g are sub-blocks of G); the
    camera-side blocks are then reduced in one [O, 42] bucket sum, the
    point-side ones in one sorted [O, 12] segment sum.

    `valid` [O] bool masks padded observations (distributed path)."""
    if valid is not None:
        m = valid[:, None, None]
        A = jnp.where(m, A, 0.0)
        B = jnp.where(m, B, 0.0)
        ex = jnp.where(valid[:, None], ex, 0.0)
    G = jnp.concatenate([A, B, ex[:, :, None]], axis=-1)  # [O,2,10]
    Gram = jnp.einsum(
        "oki,okj->oij", G, G, precision=jax.lax.Precision.HIGHEST
    )                                                     # [O,10,10]

    W = coeff * Gram[:, 0:6, 6:9]                         # A^T B
    # camera side: U | ga packed as [O,42], one bucket reduction
    cam_pack = jnp.concatenate(
        [Gram[:, 0:6, 0:6].reshape(-1, 36), Gram[:, 0:6, 9]], axis=-1
    )                                                     # [O,42]
    cam_red = coeff * indexed_sum(cam_pack, cam_idx, n_cams)
    U = cam_red[:, :36].reshape(n_cams, 6, 6)
    ga = cam_red[:, 36:]
    # point side: V | gb packed as [O,12], sorted segment reduction
    pt_pack = jnp.concatenate(
        [Gram[:, 6:9, 6:9].reshape(-1, 9), Gram[:, 6:9, 9]], axis=-1
    )                                                     # [O,12]
    pt_red = coeff * indexed_sum(
        pt_pack, pt_idx, n_pts, indices_are_sorted=True
    )
    V = pt_red[:, :9].reshape(n_pts, 3, 3)
    gb = pt_red[:, 9:]
    return U, V, W, ga, gb


def damp_uv(U, V, mu):
    """Add mu to every U/V diagonal entry (kern_update_UV,
    CL_files/update_UV.cl). Returns damped copies."""
    eye6 = jnp.eye(U.shape[-1], dtype=U.dtype)
    eye3 = jnp.eye(V.shape[-1], dtype=V.dtype)
    return U + mu * eye6, V + mu * eye3


def max_diag(U, V):
    """max over all U/V diagonal entries — seeds the initial LM damping
    mu = tau * max(diag) (levmar.cpp:115, sba_func.cpp:422-444)."""
    du = jnp.diagonal(U, axis1=-2, axis2=-1)
    dv = jnp.diagonal(V, axis1=-2, axis2=-1)
    return jnp.maximum(jnp.max(du), jnp.max(dv))


def damp_uv_marquardt(U, V, mu):
    """Multiplicative (Marquardt/Jacobi) damping: each diagonal entry
    becomes d*(1+mu), with zero diagonals (parameters without
    observations) falling back to additive mu so they stay regularized.
    Scale-invariant counterpart of damp_uv for problems whose Hessian
    diagonal spans many orders of magnitude (SolverConfig.damping);
    no reference counterpart."""
    eye6 = jnp.eye(U.shape[-1], dtype=U.dtype)
    eye3 = jnp.eye(V.shape[-1], dtype=V.dtype)
    du = jnp.diagonal(U, axis1=-2, axis2=-1)
    dv = jnp.diagonal(V, axis1=-2, axis2=-1)
    du = jnp.where(du > 0.0, du, 1.0)
    dv = jnp.where(dv > 0.0, dv, 1.0)
    return (
        U + (mu * du)[..., None] * eye6,
        V + (mu * dv)[..., None] * eye3,
    )

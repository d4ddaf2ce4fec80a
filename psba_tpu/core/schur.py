"""Schur-complement reduction of the camera system.

Equivalents of kern_compute_Vinv / _Yblks / _S / _ea / _eb /
_dpb (CL_files/compute_Vinv.cl, compute_Yblks.cl, compute_S.cl,
compute_ea.cl, compute_eb.cl, compute_dpb.cl):

  Vinv_i = V_i^{-1}                                (batched 3x3 inverse)
  Y_o    = W_o Vinv_{i(o)}                         [O,6,3]
  S_kl   = delta_kl U_k - sum_{i in covis(k,l)} Y_ik W_il^T   [6C, 6C]
  ea_j   = ga_j - sum_{o: cam(o)=j} Y_o gb_{i(o)}  [C,6]
  eb_i   = gb_i - sum_{o: pt(o)=i}  W_o^T dpa_{j(o)}  [P,3]
  dpb_i  = Vinv_i eb_i                             [P,3]

The covisibility sum uses the static pair list from
psba_tpu.problem.build_covis_pairs instead of the reference's
O(C^2 P)-memory comm3DIdx table: a batched (6x3)@(3x6) product over pairs +
one segment-sum over camera-pair buckets. Where the [C, P] block table fits
(constants.DENSE_SCHUR_MAX_ENTRIES), the dense encoding instead stacks the W
blocks once per linearization (stack_blocks) and turns S, ea and eb into
dense matrix products (schur_S_dense).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from psba_tpu.ops.reduce import indexed_sum


def _pivoted_det3(V):
    """Batched 3x3 determinant via Gaussian elimination with partial
    pivoting — the reference's Vinv fallback determinant
    (compute_Vinv.cl:31-60). Two deviations, both numerical fixes over the
    reference: pivots are selected by magnitude (the reference compares
    signed first-column entries, compute_Vinv.cl:32-34) and row-swap sign
    flips are tracked (the reference drops them, so its fallback
    determinant can carry the wrong sign)."""
    a = V

    def _swap_rows(a, p, r0, r1):
        # swap rows r0 <-> r1 where p (bool [...]) holds
        sel = p[..., None]
        row_a, row_b = a[..., r0, :], a[..., r1, :]
        a = a.at[..., r0, :].set(jnp.where(sel, row_b, row_a))
        a = a.at[..., r1, :].set(jnp.where(sel, row_a, row_b))
        return a

    sign = jnp.ones(V.shape[:-2], V.dtype)
    c0 = jnp.abs(a[..., :, 0])
    p1 = c0[..., 1] > jnp.maximum(c0[..., 0], c0[..., 2])
    p2 = (~p1) & (c0[..., 2] > c0[..., 0])
    a = _swap_rows(a, p1, 0, 1)
    a = _swap_rows(a, p2, 0, 2)
    sign = jnp.where(p1 | p2, -sign, sign)

    a00 = a[..., 0, 0]
    safe00 = jnp.where(a00 != 0.0, a00, 1.0)
    l1 = jnp.where(a00 != 0.0, a[..., 1, 0] / safe00, 0.0)
    l2 = jnp.where(a00 != 0.0, a[..., 2, 0] / safe00, 0.0)
    b11 = a[..., 1, 1] - l1 * a[..., 0, 1]
    b12 = a[..., 1, 2] - l1 * a[..., 0, 2]
    b21 = a[..., 2, 1] - l2 * a[..., 0, 1]
    b22 = a[..., 2, 2] - l2 * a[..., 0, 2]

    swap2 = jnp.abs(b21) > jnp.abs(b11)
    t11 = jnp.where(swap2, b21, b11)
    t12 = jnp.where(swap2, b22, b12)
    t21 = jnp.where(swap2, b11, b21)
    t22 = jnp.where(swap2, b12, b22)
    sign = jnp.where(swap2, -sign, sign)

    safe11 = jnp.where(t11 != 0.0, t11, 1.0)
    c22 = t22 - jnp.where(t11 != 0.0, t21 / safe11, 0.0) * t12
    return sign * a00 * t11 * c22


def _block_scale(a, b, c, d, e, f):
    """Per-block power-of-two scale of a symmetric 3x3 and its reciprocal.

    Factoring this out of the inverse makes the determinant arithmetic
    scale-invariant: badly scaled real BAL cameras (Dubrovnik-88 carries
    fu up to 1.85e6) push diag(V) to ~1e12 and the LM seed
    mu = tau*max(diag U) to ~2.8e20, at which point an unscaled det ~ mu^3
    overflows f32 to inf/nan and the solve loop can never succeed.

    The scale is rounded to a power of two so the division is EXACT: every
    scaled intermediate equals its unscaled counterpart times 2^-ke, exact
    zeros (rank-deficient blocks) stay exactly zero, pivot comparisons are
    unchanged, and the final inverse is bit-identical to the unscaled
    computation whenever that computation does not overflow. Returns
    (inv_m, inv_m3) with inv_m = 2^-e ~ 1/max|entry| and inv_m3 = inv_m^3
    (the fallback-threshold adjustment; may over/underflow at extreme
    scales, which only shifts the *fallback* decision, never ok)."""
    m = jnp.maximum(
        jnp.maximum(jnp.maximum(jnp.abs(a), jnp.abs(b)), jnp.abs(c)),
        jnp.maximum(jnp.maximum(jnp.abs(d), jnp.abs(e)), jnp.abs(f)),
    )
    m_safe = jnp.where(m > 0.0, m, 1.0)
    if m_safe.dtype == jnp.float32:
        # 2^-floor(log2(m)) via exponent bits, exact and free of the
        # transcendental log2/exp2 pair (m_safe > 0, so the sign bit is
        # clear). Subnormal m maps to exponent 0 -> inv_m = 2^127, which
        # still lands the scaled block in range.
        bits = jax.lax.bitcast_convert_type(m_safe, jnp.int32)
        eb = jax.lax.shift_right_logical(bits, jnp.int32(23))
        inv_bits = jax.lax.shift_left(
            jnp.clip(jnp.int32(254) - eb, jnp.int32(1), jnp.int32(254)),
            jnp.int32(23),
        )
        inv_m = jax.lax.bitcast_convert_type(inv_bits, jnp.float32)
    else:
        inv_m = jnp.exp2(-jnp.floor(jnp.log2(m_safe)))
    return inv_m, inv_m * inv_m * inv_m


def inv3x3(V):
    """Batched closed-form symmetric 3x3 inverse via cofactors.

    Mirrors kern_compute_Vinv (compute_Vinv.cl): the cofactor path divides
    the adjugate by the closed-form determinant; blocks whose determinant
    magnitude falls below 1e-16 instead divide by the partial-pivot
    Gaussian determinant (the reference's fallback, compute_Vinv.cl:28-76),
    which survives the catastrophic cancellation that kills the closed
    form near (but not at) singularity. Computes the full inverse (the
    reference stores only the lower triangle). The block is normalized by
    its max |entry| first (see _block_scale): inv(V) = inv(V/m)/m, with
    the fallback threshold applied to the *scaled* determinant — a
    scale-invariant form of the reference's absolute 1e-16 (an intentional
    numerical improvement: the absolute test is meaningless at BAL scales
    where det spans ~1e36).

    Returns (Vinv, ok): ok is False when any block is singular even after
    the pivoted fallback (zero / non-finite determinant) — callers treat it
    like a Cholesky failure (mu/lambda escalation; the reference instead
    lets the garbage flow, levmar.cpp:127)."""
    a, b, c = V[..., 0, 0], V[..., 0, 1], V[..., 0, 2]
    d, e, f = V[..., 1, 1], V[..., 1, 2], V[..., 2, 2]
    inv_m, inv_m3 = _block_scale(a, b, c, d, e, f)
    a, b, c = a * inv_m, b * inv_m, c * inv_m
    d, e, f = d * inv_m, e * inv_m, f * inv_m
    co00 = d * f - e * e
    co01 = c * e - b * f
    co02 = b * e - c * d
    det = a * co00 + b * co01 + c * co02
    # |det_unscaled| < 1e-16 expressed on the scaled det (exact when
    # inv_m3 is representable; saturates to never/always at the extremes)
    need_fallback = jnp.abs(det) < 1e-16 * inv_m3
    det_piv = _pivoted_det3(V * inv_m[..., None, None])
    det_use = jnp.where(need_fallback, det_piv, det)
    # singularity test on the scaled (O(1)-entry) determinant: anything
    # within a few ulps of zero has no significant digits in its inverse.
    # An exact ==0 test is flaky — XLA's FMA contraction turns exact
    # cancellation into ~eps-level noise depending on fusion decisions.
    blk_ok = jnp.isfinite(det_use) & (
        jnp.abs(det_use) > 8.0 * jnp.finfo(det_use.dtype).eps
    )
    ok = jnp.all(blk_ok)
    inv_det = jnp.where(blk_ok, 1.0 / jnp.where(blk_ok, det_use, 1.0), 0.0)
    co11 = a * f - c * c
    co12 = b * c - a * e
    co22 = a * d - b * b
    row0 = jnp.stack([co00, co01, co02], axis=-1)
    row1 = jnp.stack([co01, co11, co12], axis=-1)
    row2 = jnp.stack([co02, co12, co22], axis=-1)
    Vinv = jnp.stack([row0, row1, row2], axis=-2) * (
        inv_det * inv_m
    )[..., None, None]
    return Vinv, ok


def inv3x3_planar(V):
    """inv3x3 in the planar [3, 3, P] layout (P the minor axis).
    Identical cofactor + pivoted-fallback math (including the
    scale-invariant block normalization); the only difference is the
    output stacking: leading (i, j) axes keep every elementwise op a
    contiguous [P] vector, and the result feeds schur_S_dense's
    broadcast FMAs without a transpose."""
    a, b, c = V[..., 0, 0], V[..., 0, 1], V[..., 0, 2]
    d, e, f = V[..., 1, 1], V[..., 1, 2], V[..., 2, 2]
    inv_m, inv_m3 = _block_scale(a, b, c, d, e, f)
    a, b, c = a * inv_m, b * inv_m, c * inv_m
    d, e, f = d * inv_m, e * inv_m, f * inv_m
    co00 = d * f - e * e
    co01 = c * e - b * f
    co02 = b * e - c * d
    det = a * co00 + b * co01 + c * co02
    need_fallback = jnp.abs(det) < 1e-16 * inv_m3
    det_piv = _pivoted_det3(V * inv_m[..., None, None])
    det_use = jnp.where(need_fallback, det_piv, det)
    # singularity test on the scaled (O(1)-entry) determinant: anything
    # within a few ulps of zero has no significant digits in its inverse.
    # An exact ==0 test is flaky — XLA's FMA contraction turns exact
    # cancellation into ~eps-level noise depending on fusion decisions.
    blk_ok = jnp.isfinite(det_use) & (
        jnp.abs(det_use) > 8.0 * jnp.finfo(det_use.dtype).eps
    )
    ok = jnp.all(blk_ok)
    inv_det = jnp.where(blk_ok, 1.0 / jnp.where(blk_ok, det_use, 1.0), 0.0)
    co11 = a * f - c * c
    co12 = b * c - a * e
    co22 = a * d - b * b
    Vp = jnp.stack([
        jnp.stack([co00, co01, co02], axis=0),
        jnp.stack([co01, co11, co12], axis=0),
        jnp.stack([co02, co12, co22], axis=0),
    ], axis=0) * (inv_det * inv_m)[None, None]
    return Vp, ok


def y_blocks(W, Vinv, pt_idx):
    """Y_o = W_o Vinv_{i(o)}  [O,6,3] (kern_compute_Yblks)."""
    return jnp.einsum(
        "oij,ojk->oik", W, Vinv[pt_idx],
        precision=jax.lax.Precision.HIGHEST,
    )


def schur_S(U, Y, W, pair_o1, pair_o2, pair_bucket, n_cams, psum=None):
    """Assemble the dense reduced camera matrix S [6C, 6C]
    (kern_compute_S, CL_files/compute_S.cl:40-56).

    U must already carry the damping diagonal (the reference calls
    kern_update_UV before kern_compute_S, levmar.cpp:126-130) and must be
    mesh-global; `psum` (MeshCtx.psum) reduces the shard-local off-diagonal
    sums. Padded pair entries carry bucket C*C, which lands in a discarded
    overflow segment.

    The pair list is the encoding for problems whose dense [C, P] table
    exceeds constants.DENSE_SCHUR_MAX_ENTRIES."""
    C = n_cams
    contrib = jnp.einsum(
        "nij,nkj->nik", Y[pair_o1], W[pair_o2],
        precision=jax.lax.Precision.HIGHEST,
    )  # [N,6,6]
    # bucket reduction; padded pair entries carry bucket C*C and
    # contribute nothing
    off = indexed_sum(
        contrib.reshape(-1, 36), pair_bucket, C * C,
        indices_are_sorted=True,
    ).reshape(C * C, 6, 6)
    if psum is not None:
        off = psum(off)
    S = -off.reshape(C, C, 6, 6)
    S = S.at[jnp.arange(C), jnp.arange(C)].add(U)
    # [C,C,6,6] -> [6C,6C] block layout
    return S.transpose(0, 2, 1, 3).reshape(6 * C, 6 * C)


def stack_blocks(W, blk_idx):
    """Stack per-observation W blocks into the planar dense layout
    ZW [6C, 3P]: ZW[6c+i, kP+p] = W_o[i, k] for the observation of point p
    in camera c, zeros where unseen — directly the stacked off-diagonal
    factor of the reduced system.

    One row gather driven by the blk_idx table (the reference's dense
    (point x cam) -> obs lookup, misc.cpp:190-199, transposed); unseen
    cells index the appended zero row. Every scatter/segment reduction
    downstream becomes a dense matrix product against ZW: S, ea and eb
    (see schur_S_dense).

    Layout note: the planar 2-D form keeps the long point axis minor for
    every downstream op, so the size-3 block axes never sit in the
    minor dimension. The gather + transpose happens once per
    linearization — the damping-retry loop is relayout-free."""
    O = W.shape[0]
    C, P = blk_idx.shape
    W_pad = jnp.concatenate(
        [W.reshape(O, 18), jnp.zeros((1, 18), W.dtype)], axis=0
    )
    G = jnp.take(W_pad, blk_idx.reshape(-1), axis=0, mode="clip")
    # [C*P, 18] -> [C, 6, 3, P] -> rows 6c+i, cols k*P+p (pure reshape)
    G = G.reshape(C, P, 6, 3).transpose(0, 2, 3, 1)
    return G.reshape(C * 6, 3 * P)


# True-f32 contractions: without a pinned precision an accelerator may
# multiply f32 operands in a reduced format (TF32 on NVIDIA GPUs rounds
# them to a 10-bit mantissa, up to 2^-11 relative error per product),
# which caps how far the f32 path can converge. HIGHEST keeps full f32
# products.
_PREC = jax.lax.Precision.HIGHEST


def schur_S_dense(U, ZW, Vp, psum=None):
    """Dense-stacked Schur assembly: S = blockdiag(U) - ZY @ ZW^T.

    Same math as schur_S (kern_compute_S, CL_files/compute_S.cl:40-56) in
    one [6C, 3P] x [3P, 6C] contraction: the p-axis sum enumerates
    exactly the covisibility pairs, because unseen (c, p) cells are zero.
    ZW arrives planar [6C, 3P] (stack_blocks) and Vp planar [3, 3, P]
    (inv3x3_planar), so ZY[r, jP+p] = sum_k ZW[r, kP+p] Vp[k, j, p] is
    nine broadcast FMAs and is born matmul-ready — the damping-retry loop
    does no relayouts at all. Also returns ZY [6C, 3P], reused by
    reduced_rhs_dense. `U` must be mesh-global and damped; `psum` reduces
    the shard-local sum."""
    R = ZW.shape[0]
    C = R // 6
    P = ZW.shape[1] // 3
    Zk = ZW.reshape(R, 3, P)
    ZY = jnp.concatenate(
        [
            Zk[:, 0, :] * Vp[0, j][None]
            + Zk[:, 1, :] * Vp[1, j][None]
            + Zk[:, 2, :] * Vp[2, j][None]
            for j in range(3)
        ],
        axis=1,
    )                                              # [6C, 3P]
    off = jnp.matmul(ZY, ZW.T, precision=_PREC).reshape(C, 6, C, 6)
    if psum is not None:
        off = psum(off)
    S = -off
    S = S.at[jnp.arange(C), :, jnp.arange(C), :].add(U)
    return S.reshape(6 * C, 6 * C), ZY


def reduced_rhs_dense(ga, gbp, ZY, psum=None):
    """ea = ga - ZY @ gbp  [C,6] (kern_compute_ea on the planar stacked
    layout): one [6C, 3P] mat-vec. `ga` must be mesh-global; `gbp` is the
    planar [3P] point gradient (planar_gb)."""
    term = jnp.matmul(ZY, gbp, precision=_PREC)
    if psum is not None:
        term = psum(term)
    return ga - term.reshape(-1, 6)


def planar_gb(gb):
    """[P, 3] point-side vector -> planar [3P] (k*P+p), matching the
    column layout of stack_blocks/schur_S_dense."""
    return gb.T.reshape(-1)


def back_substitute_dense(gbp, ZW, Vp, dpa):
    """eb = gbp - ZW^T dpa;  dpb_i = Vinv_i eb_i (kern_compute_eb +
    kern_compute_dpb on the planar layout). `dpa` is [C, 6]; returns
    (ebp [3P] planar, dpb [P, 3])."""
    P = ZW.shape[1] // 3
    ebp = gbp - jnp.matmul(dpa.reshape(-1), ZW, precision=_PREC)
    Ek = ebp.reshape(3, P)
    dpb = jnp.stack(
        [
            Vp[0, j] * Ek[0] + Vp[1, j] * Ek[1] + Vp[2, j] * Ek[2]
            for j in range(3)
        ],
        axis=1,
    )                                              # [P, 3]
    return ebp, dpb


def reduced_rhs(ga, gb, Y, cam_idx, pt_idx, n_cams, psum=None):
    """ea_j = ga_j - sum_{o: cam(o)=j} Y_o gb_{i(o)}  [C,6]
    (kern_compute_ea). `ga` must be mesh-global; the observation sum is
    shard-local until `psum`."""
    contrib = jnp.einsum(
        "oij,oj->oi", Y, gb[pt_idx], precision=jax.lax.Precision.HIGHEST
    )  # [O,6]
    term = indexed_sum(contrib, cam_idx, n_cams)
    if psum is not None:
        term = psum(term)
    return ga - term


def back_substitute(gb, W, Vinv, dpa, cam_idx, pt_idx, n_pts):
    """eb_i = gb_i - sum_{o: pt(o)=i} W_o^T dpa_{j(o)};  dpb_i = Vinv_i eb_i
    (kern_compute_eb + kern_compute_dpb). Returns (eb [P,3], dpb [P,3])."""
    wt_dpa = jnp.einsum(
        "oij,oi->oj", W, dpa[cam_idx], precision=jax.lax.Precision.HIGHEST
    )  # [O,3]
    eb = gb - jax.ops.segment_sum(wt_dpa, pt_idx, num_segments=n_pts)
    dpb = jnp.einsum(
        "pij,pj->pi", Vinv, eb, precision=jax.lax.Precision.HIGHEST
    )
    return eb, dpb

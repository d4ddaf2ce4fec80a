"""Gill–Murray–Wright modified Cholesky (diagonal-perturbation extraction).

Equivalent of the reference's modified-Cholesky pipeline
(PSBA/cl_cholmod.cpp:25-202, CL_files/cholmod_blk.cl): when plain Cholesky
of S fails at lambda=0, the TR solver runs a GMW factorization
A + E = L D L^T with diagonal E >= 0 and bootstraps the regularizer as
lambda = |sum(E)| / n (trust_region.cpp:355-366). Only E is consumed —
the factor itself is discarded, exactly as in the reference.

Parameters delta / beta follow cl_cholmod.cpp:161-164:
  eta  = max |diag(A)|,  xi = max |offdiag(A)|
  delta = 1e-15 * max(xi + eta, 1)
  beta^2 = max(eta, xi / sqrt(n^2 - 1), 1e-15)

The factorization is the textbook column-wise GMW recurrence as one
`lax.fori_loop` over columns with vectorized full-matrix rank-1 updates —
the device-side-enqueue chain of the reference collapses into
sequential loop iterations inside a single jitted computation (SURVEY.md §7
hard part (c)). Off the hot path: only invoked on Cholesky failure."""

from __future__ import annotations

import jax
import jax.numpy as jnp


def gmw_delta_beta(A):
    n = A.shape[0]
    diag = jnp.diagonal(A)
    eta = jnp.max(jnp.abs(diag))
    off = jnp.abs(A - jnp.diag(diag))
    xi = jnp.max(off)
    delta = 1e-15 * jnp.maximum(xi + eta, 1.0)
    beta2 = jnp.maximum(
        jnp.maximum(eta, xi / jnp.sqrt(float(n * n - 1))), 1e-15
    )
    return delta, beta2


def gmw_perturbation(A):
    """Return the GMW diagonal perturbation E [n] with A + E = L D L^T."""
    n = A.shape[0]
    delta, beta2 = gmw_delta_beta(A)
    idx = jnp.arange(n)

    def body(j, carry):
        c, E = carry
        below = idx > j
        col = jnp.where(below, c[:, j], 0.0)
        theta = jnp.max(jnp.abs(col))
        cjj = c[j, j]
        dj = jnp.maximum(
            jnp.maximum(jnp.abs(cjj), theta * theta / beta2), delta
        )
        E = E.at[j].set(dj - cjj)
        # rank-1 update of the trailing submatrix (col is zero at and above j,
        # so the outer product only touches rows/cols > j)
        c = c - jnp.outer(col, col) / dj
        return c, E

    _, E = jax.lax.fori_loop(
        0, n, body, (A, jnp.zeros(n, dtype=A.dtype))
    )
    return E


def gmw_perturbation_blocked(A, block: int = 16):
    """Blocked right-looking GMW: identical E to gmw_perturbation.

    The column recurrence is inherently sequential (d_j needs the current
    column's below-diagonal max after all previous updates), but only
    *within* a panel: columns inside a [n, block] panel are factored with
    rank-1 updates restricted to the panel, and the trailing matrix
    receives the whole panel's accumulated update as ONE
    [n, block] @ [block, n] matmul. Sequential depth drops from n
    rank-1 full-matrix updates to n panel-column steps on [n, block]
    slices + n/block matmuls — at n = 6C = 828 (Rome-93-class TR
    bootstrap) the full-matrix traffic falls from 828 O(n^2) updates to
    52 matmuls. Off the hot path (Cholesky-failure bootstrap only), but
    this keeps the failure path itself from becoming seconds-long at
    BAL-scale camera counts."""
    n = A.shape[0]
    nb = (n + block - 1) // block
    np_ = nb * block
    # pad with an identity tail: the extra columns factor trivially
    # (d_j = 1, E_j = 0) and never touch the real block
    Ap = jnp.eye(np_, dtype=A.dtype).at[:n, :n].set(A)
    delta, beta2 = gmw_delta_beta(A)
    idx = jnp.arange(np_)

    def panel_body(kb, carry):
        c, E = carry
        k = kb * block
        # panel columns [n, block] and their global column indices
        panel = jax.lax.dynamic_slice(c, (0, k), (np_, block))
        cols = k + jnp.arange(block)

        def col_body(j, pc):
            panel, E, P, dinv = pc
            gj = k + j
            col = jnp.where(idx > gj, panel[:, j], 0.0)
            theta = jnp.max(jnp.abs(col))
            cjj = panel[gj, j]
            dj = jnp.maximum(
                jnp.maximum(jnp.abs(cjj), theta * theta / beta2), delta
            )
            E = E.at[gj].set(dj - cjj)
            # rank-1 update restricted to the remaining panel columns
            w = col[cols] / dj                     # [block]
            upd = jnp.outer(col, w)                # [np_, block]
            mask = (jnp.arange(block) > j)[None, :]
            panel = panel - jnp.where(mask, upd, 0.0)
            P = P.at[:, j].set(col)
            dinv = dinv.at[j].set(1.0 / dj)
            return panel, E, P, dinv

        P0 = jnp.zeros((np_, block), A.dtype)
        d0 = jnp.zeros((block,), A.dtype)
        panel, E, P, dinv = jax.lax.fori_loop(
            0, block, col_body, (panel, E, P0, d0)
        )
        # one matmul applies the whole panel's update to the trailing
        # matrix; columns <= k are already final and masked out. Pinned
        # HIGHEST like every contraction on the solver path: an unpinned
        # f32 product may run in TF32 on NVIDIA GPUs
        trail = (idx[None, :] >= k + block).astype(A.dtype)
        upd = jnp.matmul(
            P * dinv[None, :], P.T, precision=jax.lax.Precision.HIGHEST
        )                                          # [np_, np_]
        c = c - upd * trail
        return c, E

    _, E = jax.lax.fori_loop(
        0, nb, panel_body, (Ap, jnp.zeros(np_, dtype=A.dtype))
    )
    return E[:n]


BLOCKED_GMW_MIN_N = 128  # blocked pays only when the sequential depth
# hurts (BAL-scale 6C >= 312); below it the reference-identical column
# recurrence is kept so small-problem f32 trajectories stay bit-stable


def gmw_bootstrap_lambda(A):
    """lambda = |sum(E)| / n (trust_region.cpp:358-364)."""
    n = A.shape[0]
    E = (
        gmw_perturbation_blocked(A) if n > BLOCKED_GMW_MIN_N
        else gmw_perturbation(A)
    )
    return jnp.abs(jnp.sum(E)) / n

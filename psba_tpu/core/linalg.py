"""Dense SPD linear algebra for the reduced camera system.

The reference factors S with a self-enqueueing blocked Cholesky, explicitly
inverts it (trigMat_inv / trigMat_mul) and multiplies S^{-1} ea
(PSBA/cl_spdinv.cpp:18-204, CL_files/SPD_inv.cl). Here the numerically
superior factor-and-solve replaces the explicit inverse (intentional
behavioral improvement, SURVEY.md §7 M3); failure is detected the same way
(non-finite / non-positive pivots -> ret flag, SPD_inv.cl:66-75). XLA
lowers the factorization to the platform's dense solver library
(cuSOLVER potrf + triangular solves on NVIDIA GPUs).
"""

from __future__ import annotations

import jax.numpy as jnp
import jax.scipy.linalg as jsl


def spd_solve(S, b):
    """Solve S x = b for SPD S.

    Returns (x, ok). ok=False when the Cholesky factorization failed
    (matrix not positive definite), mirroring the reference's ret flag from
    kern_cholesky (cl_spdinv.cpp:85-87). On failure x is zeroed wherever
    the factor produced non-finite values and must be discarded by the
    caller (the reference similarly leaves the buffer partially
    factored)."""
    L = jnp.linalg.cholesky(S)
    diag = jnp.diagonal(L)
    ok = jnp.all(jnp.isfinite(diag) & (diag > 0.0))
    x = jsl.cho_solve((L, True), b)
    x = jnp.where(jnp.isfinite(x), x, 0.0)
    return x, ok

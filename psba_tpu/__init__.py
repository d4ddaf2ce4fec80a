"""psba_tpu — parallel sparse bundle adjustment in JAX.

A from-scratch JAX/XLA reimplementation of the capabilities of the
PSBA reference (OpenCL parallel sparse bundle adjustment): hybrid
Levenberg-Marquardt / dogleg trust-region optimization of camera extrinsics
(local quaternion + translation) and 3-D points under squared reprojection
error, with block Hessian assembly (U/V/W/g), Schur-complement reduction of
the camera system, SPD / modified (GMW) Cholesky solvers, and multi-device
scaling over a `jax.sharding.Mesh`.

Layer map (redesign of reference layers L0-L4, see SURVEY.md §1):

  models/    camera + rotation models (quaternion local parameterization,
             pinhole projection)                           [ref: compute_exQT.cl]
  core/      residual, analytic Jacobian, Hessian-block assembly, Schur
             reduction, dense/blocked linear algebra       [ref: sba_func.cpp,
             CL_files/*.cl]
  ops/       shared primitives (segment reductions)
  solvers/   jitted LM and dogleg-TR loops, hybrid controller
             [ref: levmar.cpp, trust_region.cpp, main.cpp:193-208]
  parallel/  mesh setup, sharding rules, distributed LM step (psum)
  io/        SBA-format text readers, BAL conversion, synthetic problems
             [ref: readparams.cpp]
  utils/     timing/report/checkpoint/debug helpers
"""

from psba_tpu.problem import BAProblem

__version__ = "0.1.0"

__all__ = ["BAProblem", "solve_hybrid", "__version__"]


def __getattr__(name):
    if name == "solve_hybrid":
        from psba_tpu.solvers.hybrid import solve as solve_hybrid

        return solve_hybrid
    raise AttributeError(name)

"""Solver constants and iteration flags.

Mirrors the reference's compile-time configuration (PSBA/psba.h:3-18) as
runtime constants; the new framework exposes them through SolverConfig
(psba_tpu.solvers.types) instead of #defines.
"""

# Levenberg-Marquardt constants (PSBA/psba.h:6-10)
PSBA_INIT_MU = 1e-3          # tau: initial damping = tau * max(diag(U,V))
# tau of the f64 polish after an f32 run. The polish starts at the f32
# optimum, where the Gauss-Newton step is the one wanted, so it seeds a
# near-zero damping (Madsen, Nielsen & Tingleff, Methods for Non-Linear
# Least Squares Problems, 2004, sec. 3.2: a small tau for a start close to
# the minimizer). A seed too small costs a few retries inside one iteration
# (mu grows x2, x4, x8, ... on rejection); a seed too large costs an
# iteration per factor 3. On generated BAL-shaped problems (21-138 cameras)
# 5 polish iterations reach the f64 optimum to ~1e-13 for tau <= 1e-10;
# at 1e-6 they stay 2e-5..1.6e-4 above it, at the reference's 1e-3 it takes
# ~20 iterations
PSBA_POLISH_MU = 1e-12
PSBA_STOP_THRESH = 1e-12     # ||dp|| and error stop threshold
PSBA_EPSILON = 1e-12
PSBA_EPSILON2 = 1e-12        # TR relative-error stop threshold
PSBA_EPSILON_SQ = PSBA_EPSILON * PSBA_EPSILON

# Trust-region constants (PSBA/trust_region.cpp:18,91-92)
TR_MAX_DELTA = 10000.0       # radius cap
TR_INIT_DELTA = 1.0

# Shared LM+TR iteration cap (PSBA/levmar.cpp:100, trust_region.cpp:112)
MAX_TOTAL_ITERS = 50

# Iteration result flags (PSBA/psba.h:12-18)
ITER_TURN_TO_LM = 1
ITER_TURN_TO_TR = 2
ITER_CONTINUE = 3
ITER_ERR = 4
ITER_DP_NO_CHANGE = 5
ITER_ERR_SMALL_ENOUGH = 6
ITER_PASS = 7

FLAG_NAMES = {
    ITER_TURN_TO_LM: "TURN_TO_LM",
    ITER_TURN_TO_TR: "TURN_TO_TR",
    ITER_CONTINUE: "CONTINUE",
    ITER_ERR: "ERR",
    ITER_DP_NO_CHANGE: "DP_NO_CHANGE",
    ITER_ERR_SMALL_ENOUGH: "ERR_SMALL_ENOUGH",
    ITER_PASS: "PASS",
}

# Dense-Schur dispatch threshold, set by device memory: the blk_idx-gather
# formulation (psba_tpu.core.schur.schur_S_dense) materializes [6C, 3P]
# stacked block tensors; above this many C*P cells the covisibility pair
# list path is used instead. Per (cam, point) cell in float64 (the
# default precision): ZW and ZY at 18 * 8 = 144 bytes each, the gather's
# [C*P, 18] staging copy before its transpose another 144, and the int32
# blk_idx table 4 -> ~436 bytes. An 80 GB card gives a JAX process 75% of
# its memory (60 GB) by default; keeping the dense factors to half of that
# (30 GB) leaves the rest to the observation-axis arrays and XLA's
# temporaries: 30e9 / 436 ~ 69M cells, rounded down to 2^26 = 67.1M.
DENSE_SCHUR_MAX_ENTRIES = 64 * 1024 * 1024

# Parameter-block dimensions (PSBA/CL_files/PSBA.cl:5-7; fixed by the camera
# model: 3 local-rotation + 3 translation per camera, 3 per point, 2 per
# observation).
CNP = 6   # camera parameters: quaternion vector part (3) + translation (3)
PNP = 3   # 3-D point parameters
MNP = 2   # 2-D measurement dimension
K_DIM = 5  # pinhole intrinsics [fu, u0, v0, ar, s] (PSBA/psba.h:3)

"""ctypes bindings to the native C++ loader (native/loader.cpp).

The reference's problem I/O and index generation are C++ (readparams.cpp,
misc.cpp:178-218); this module provides the equivalent native fast path —
text parsing of large points files is the one
host-bound step of problem setup. Falls back transparently to the pure
Python reader when the shared library has not been built
(`python -m psba_tpu.io.native --build` or `make -C native`).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys

import numpy as np

_LIB_NAME = "libpsba_io.so"
_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "native")
_LIB_PATH = os.path.join(_NATIVE_DIR, _LIB_NAME)

_lib = None


def _load():
    global _lib
    if _lib is not None:
        return _lib
    if not os.path.exists(_LIB_PATH):
        return None
    lib = ctypes.CDLL(_LIB_PATH)
    lib.psba_count_pts.restype = ctypes.c_int
    lib.psba_count_pts.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_long),  # n_pts
        ctypes.POINTER(ctypes.c_long),  # n_obs
        ctypes.POINTER(ctypes.c_int),   # cov kind (0 none, 3 tri, 4 full)
    ]
    lib.psba_read_pts.restype = ctypes.c_int
    lib.psba_read_pts.argtypes = [
        ctypes.c_char_p, ctypes.c_long, ctypes.c_long, ctypes.c_int,
        ctypes.c_long,  # n_cams
        ctypes.POINTER(ctypes.c_double),  # pts [P*3]
        ctypes.POINTER(ctypes.c_double),  # obs [O*2]
        ctypes.POINTER(ctypes.c_int),     # cam_idx [O]
        ctypes.POINTER(ctypes.c_int),     # pt_idx [O]
        ctypes.POINTER(ctypes.c_double),  # cov [O*4] or NULL
    ]
    if hasattr(lib, "psba_read_bal_header"):
        lib.psba_read_bal_header.restype = ctypes.c_int
        lib.psba_read_bal_header.argtypes = [
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_long),  # n_cams
            ctypes.POINTER(ctypes.c_long),  # n_pts
            ctypes.POINTER(ctypes.c_long),  # n_obs
        ]
        lib.psba_read_bal.restype = ctypes.c_int
        lib.psba_read_bal.argtypes = [
            ctypes.c_char_p, ctypes.c_long, ctypes.c_long, ctypes.c_long,
            ctypes.POINTER(ctypes.c_double),  # cam_params [C*9]
            ctypes.POINTER(ctypes.c_double),  # pts [P*3]
            ctypes.POINTER(ctypes.c_double),  # obs [O*2]
            ctypes.POINTER(ctypes.c_int),     # cam_idx [O]
            ctypes.POINTER(ctypes.c_int),     # pt_idx [O]
        ]
    _lib = lib
    return lib


def has_bal() -> bool:
    """True when the built library carries the raw-BAL entry points
    (a library built before round 5 lacks them; rebuild with
    `python -m psba_tpu.io.native --build`)."""
    lib = _load()
    return lib is not None and hasattr(lib, "psba_read_bal")


def read_bal(path: str, dtype=np.float64):
    """Native raw-BAL stream parser (native/loader.cpp): returns
    (cam_params [C,9], pts [P,3], obs [O,2], cam_idx, pt_idx) —
    identical contract to psba_tpu.io.bal.read_bal."""
    lib = _load()
    assert lib is not None and hasattr(lib, "psba_read_bal")
    nc = ctypes.c_long()
    np_ = ctypes.c_long()
    no = ctypes.c_long()
    rc = lib.psba_read_bal_header(
        path.encode(), ctypes.byref(nc), ctypes.byref(np_),
        ctypes.byref(no),
    )
    if rc != 0:
        raise IOError(f"native BAL header parse failed ({rc}) for {path}")
    C, P, O = nc.value, np_.value, no.value
    cam_params = np.empty((C, 9), np.float64)
    pts = np.empty((P, 3), np.float64)
    obs = np.empty((O, 2), np.float64)
    cam_idx = np.empty(O, np.int32)
    pt_idx = np.empty(O, np.int32)
    dptr = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))
    iptr = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_int))
    rc = lib.psba_read_bal(
        path.encode(), C, P, O, dptr(cam_params), dptr(pts), dptr(obs),
        iptr(cam_idx), iptr(pt_idx),
    )
    if rc != 0:
        raise IOError(f"native BAL read failed ({rc}) for {path}")
    if dtype != np.float64:
        cam_params = cam_params.astype(dtype)
        pts, obs = pts.astype(dtype), obs.astype(dtype)
    return cam_params, pts, obs, cam_idx, pt_idx


def available() -> bool:
    return _load() is not None


def build(verbose: bool = False) -> bool:
    """Compile the native loader with g++ (no external deps)."""
    src = os.path.join(_NATIVE_DIR, "loader.cpp")
    if not os.path.exists(src):
        return False
    cmd = [
        "g++", "-O3", "-shared", "-fPIC", "-std=c++17",
        "-o", _LIB_PATH, src,
    ]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        if verbose:
            sys.stderr.write(res.stderr)
        return False
    global _lib
    _lib = None
    return True


def read_pts(path: str, n_cams: int, dtype=np.float64):
    """Native equivalent of psba_tpu.io.sba_text.read_pts."""
    lib = _load()
    assert lib is not None
    n_pts = ctypes.c_long()
    n_obs = ctypes.c_long()
    cov_kind = ctypes.c_int()
    rc = lib.psba_count_pts(
        path.encode(), ctypes.byref(n_pts), ctypes.byref(n_obs),
        ctypes.byref(cov_kind),
    )
    if rc != 0:
        raise IOError(f"native count failed ({rc}) for {path}")
    P, O = n_pts.value, n_obs.value
    pts = np.empty((P, 3), np.float64)
    obs = np.empty((O, 2), np.float64)
    cam_idx = np.empty(O, np.int32)
    pt_idx = np.empty(O, np.int32)
    cov = np.empty((O, 2, 2), np.float64) if cov_kind.value else None
    dptr = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))
    iptr = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_int))
    rc = lib.psba_read_pts(
        path.encode(), P, O, cov_kind.value, n_cams,
        dptr(pts), dptr(obs), iptr(cam_idx), iptr(pt_idx),
        dptr(cov) if cov is not None else None,
    )
    if rc != 0:
        raise IOError(f"native read failed ({rc}) for {path}")
    if dtype != np.float64:
        pts, obs = pts.astype(dtype), obs.astype(dtype)
        cov = None if cov is None else cov.astype(dtype)
    return pts, obs, cam_idx, pt_idx, cov


if __name__ == "__main__":
    if "--build" in sys.argv:
        ok = build(verbose=True)
        print("built" if ok else "build failed")
        sys.exit(0 if ok else 1)

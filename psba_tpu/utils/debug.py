"""Debug / numerical-tripwire utilities.

The reference's debugging surface is 12 compile-time dump toggles plus
NaN tripwires in its buffer printers (psba.h:23-34, cl_psba.cpp:400-403).
The equivalents here:

  - enable_nan_checks(): turns on jax's NaN debugging (jax_debug_nans) —
    any NaN produced inside jitted code raises with a traceback to the
    producing op. Also respects the PSBA_DEBUG_NANS=1 environment variable
    at import (checked by the CLI).
  - first_nonfinite(tree): locate the first non-finite value in a pytree
    of arrays (host-side; the printBuf tripwire as a function).
  - dump_blocks(...): pretty-print per-observation/per-camera blocks, the
    DEBUG_* dump equivalent, for interactive use.
"""

from __future__ import annotations

import os

import jax
import numpy as np


def enable_nan_checks(enable: bool = True) -> None:
    jax.config.update("jax_debug_nans", enable)


def env_nan_checks() -> bool:
    if os.environ.get("PSBA_DEBUG_NANS") == "1":
        enable_nan_checks(True)
        return True
    return False


def first_nonfinite(tree, names=None):
    """Return (path, index, value) of the first non-finite entry, or None."""
    leaves, treedef = jax.tree.flatten(tree)
    paths = names or [str(i) for i in range(len(leaves))]
    for name, leaf in zip(paths, leaves):
        arr = np.asarray(leaf)
        if not np.issubdtype(arr.dtype, np.floating):
            continue
        bad = ~np.isfinite(arr)
        if bad.any():
            idx = tuple(int(i) for i in np.argwhere(bad)[0])
            return name, idx, float(arr[idx])
    return None


def dump_blocks(arr, n=4, title="blocks"):
    """Print the first n blocks of a batched block array (DEBUG_* dumps,
    sba_func.cpp per-op #if blocks)."""
    arr = np.asarray(arr)
    print(f"== {title} {arr.shape} dtype={arr.dtype}")
    for i in range(min(n, arr.shape[0])):
        print(f"[{i}]\n{np.array2string(arr[i], precision=6)}")
    nf = first_nonfinite(arr, names=[title])
    if nf:
        print(f"!! first non-finite at {nf[1]}: {nf[2]}")

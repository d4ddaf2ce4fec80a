"""Indexed reductions.

Sum rows of `data` into `n_segments` buckets given per-row indices (the
reference's kern_compute_U/V/g/S accumulation pattern). XLA lowers
`segment_sum` to a scatter-add.
"""

from __future__ import annotations

import jax


def indexed_sum(data, idx, n_segments, indices_are_sorted=False):
    """sum_{n: idx[n]=s} data[n] -> [n_segments, ...].

    `data` [N, ...] float, `idx` [N] int32 in [0, n_segments); out-of-range
    indices (padding markers) contribute nothing."""
    return jax.ops.segment_sum(
        data, idx, num_segments=n_segments,
        indices_are_sorted=indices_are_sorted,
    )

"""Descriptor matching (jitted): mutual nearest neighbor + Lowe ratio test.

One dense [K1, K2] distance matrix per image pair — one matmul
(descriptors are L2-normalized, so distance ranking reduces to a dot
product) — followed by row/column argmax agreement. Static shapes: the
output is a fixed-size match list with a validity mask.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


@jax.jit
def match_descriptors(d1, d2, score1=None, score2=None, ratio: float = 0.9):
    """Match rows of d1 [K,D] to d2 [K,D] (unit-norm descriptors).

    Returns (idx2 [K] int32, valid [K] bool): for each feature in image 1,
    its mutual-NN in image 2 passing the ratio test. Features with
    non-positive detector score are excluded when scores are given."""
    sim = d1 @ d2.T                               # [K, K] cosine similarity
    best2 = jnp.argmax(sim, axis=1)               # best match in image 2
    row = jnp.max(sim, axis=1)
    # second-best for the ratio test (distance^2 = 2 - 2 sim)
    masked = sim.at[jnp.arange(sim.shape[0]), best2].set(-jnp.inf)
    second = jnp.max(masked, axis=1)
    d_best = 2.0 - 2.0 * row
    d_second = 2.0 - 2.0 * second
    ratio_ok = d_best <= (ratio * ratio) * d_second
    # mutual check
    best1 = jnp.argmax(sim, axis=0)               # best in image 1 per col
    mutual = best1[best2] == jnp.arange(sim.shape[0])
    valid = ratio_ok & mutual
    if score1 is not None:
        valid &= score1 > 0
    if score2 is not None:
        valid &= score2[best2] > 0
    return best2.astype(jnp.int32), valid

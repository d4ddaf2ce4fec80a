"""Mesh context: the single abstraction that makes the LM/TR solvers
mesh-polymorphic.

With `axis=None` every reduction is the identity and the solvers run
single-device. Inside `shard_map` over a mesh axis, `psum`/`pmax` become
collectives across the mesh. The solvers insert reductions exactly where
the reference crossed its device->host boundary for scalar reductions
(SURVEY.md §1 data flow) — which is also exactly the set of cross-shard
dependencies:
U/ga/S/ea assembly, L2 norms/dots over the point-parameter shard, and the
max-diagonal damping seed.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax


class MeshCtx(NamedTuple):
    axis: Optional[str] = None

    def psum(self, x):
        return jax.lax.psum(x, self.axis) if self.axis else x

    def pmax(self, x):
        return jax.lax.pmax(x, self.axis) if self.axis else x

    def psum_rs(self, x):
        """psum decomposed as reduce_scatter + all_gather (tiled) — the
        classic allreduce decomposition, exposed as a separate option for
        the large-C Schur assembly (the S off-diagonal sum is the one
        O(C^2) collective payload; reduce-scattering it keeps the
        reduction work and the intermediate shards spread over the mesh,
        halving per-device peak traffic at the moment S materializes).

        Same result as psum up to reduction order."""
        if not self.axis:
            return x
        import jax.numpy as jnp

        d = jax.lax.psum(1, self.axis)  # static axis size
        shape = x.shape
        flat = x.reshape(-1)
        n = flat.shape[0]
        pad = (-n) % d
        if pad:
            flat = jnp.concatenate([flat, jnp.zeros((pad,), flat.dtype)])
        piece = jax.lax.psum_scatter(
            flat, self.axis, scatter_dimension=0, tiled=True
        )
        full = jax.lax.all_gather(piece, self.axis, axis=0, tiled=True)
        return full[:n].reshape(shape)

    def pand(self, x):
        """Logical AND of a boolean scalar across shards (any shard's
        local failure flag fails the whole mesh-wide step)."""
        if not self.axis:
            return x
        import jax.numpy as jnp

        return jax.lax.psum(jnp.logical_not(x).astype(jnp.int32),
                            self.axis) == 0


NO_MESH = MeshCtx(None)

"""Multi-device scaling: mesh context, problem sharding, distributed solve.

The reference is strictly single-device (SURVEY.md §2.3); the distributed
design here is the BASELINE.json north star: points and their observations
are partitioned across devices (contiguous point ranges, so Schur
covisibility pairs stay shard-local), cameras and all solver control
scalars are replicated, and the reduced camera system (U, ga, S, ea) is
assembled with `psum` over the mesh axis under shard_map. V-block solves and point back-substitution never leave the
local shard.
"""

from psba_tpu.parallel.ctx import MeshCtx, NO_MESH

__all__ = ["MeshCtx", "NO_MESH", "shard_problem", "solve_sharded"]


def __getattr__(name):
    # shard.py imports the solvers; defer to avoid a circular import when
    # the solvers import MeshCtx from this package
    if name in ("shard_problem", "solve_sharded"):
        from psba_tpu.parallel import shard

        return getattr(shard, name)
    raise AttributeError(name)

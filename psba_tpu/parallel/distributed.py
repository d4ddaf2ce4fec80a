"""Multi-host (multi-process) distributed solve.

The reference is strictly single-process / single-device (SURVEY.md §2.3);
the distributed scope comes from the north star: partition points and
observations across hosts, assemble the reduced camera system with
psum/reduce-scatter, keep V-block solves local, replicate the scalar
solver state.

Layering:
  - psba_tpu.parallel.shard owns the partitioning math and the shard_map'd
    runners; those are process-count-agnostic (the mesh axis just gets
    bigger).
  - this module owns the multi-process machinery: jax.distributed
    initialization, the process-spanning mesh, and host-local shard
    loading (each process materializes ONLY its own point/observation
    shards; `jax.make_array_from_process_local_data` assembles the global
    arrays without ever gathering the problem on one host).

Single-process usage degrades gracefully: with one process the same code
path builds the global arrays directly, so every test can run the
multi-host code shape on a virtual device mesh.
"""

from __future__ import annotations

import dataclasses
import time

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from psba_tpu import constants as CC
from psba_tpu.parallel.shard import (
    AXIS,
    ShardedProblem,
    make_sharded_runners,
    shard_problem,
)
from psba_tpu.problem import BAProblem
from psba_tpu.solvers.types import OptState, ProblemArrays, SolverConfig


def init_distributed(coordinator_address: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None) -> None:
    """Initialize jax.distributed (idempotent; no-op for 1 process).

    Pass all three arguments explicitly: on CPU and GPU hosts nothing in
    the environment tells JAX about the cluster, and a bare
    `jax.distributed.initialize()` fails there."""
    if num_processes == 1 and coordinator_address is None:
        return
    try:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
    except RuntimeError as e:  # already initialized
        if "already initialized" not in str(e):
            raise


def global_mesh(n_devices: int | None = None) -> Mesh:
    """1-D mesh over all processes' devices (the mesh follows the
    algorithm: one point-shard axis, whatever links join the devices)."""
    devs = jax.devices()
    n = n_devices or len(devs)
    return jax.make_mesh((n,), (AXIS,), devices=devs[:n])


def _slice_local(sp: ShardedProblem, mesh: Mesh) -> ShardedProblem:
    """Restrict stacked shard arrays to the shards this process owns.

    shard_problem stacks shard d at rows [d*per, (d+1)*per); mesh position
    d maps to the d-th mesh device, and a process owns the shards living
    on its own (addressable) devices."""
    pidx = jax.process_index()
    local_ids = [
        i for i, d in enumerate(mesh.devices.flat)
        if d.process_index == pidx
    ]

    def take(a, per, axis=0):
        if a is None:
            return None
        parts = [
            np.take(a, range(d * per, (d + 1) * per), axis=axis)
            for d in local_ids
        ]
        return np.concatenate(parts, axis=axis)

    return dataclasses.replace(
        sp,
        obs=take(sp.obs, sp.o_per),
        cam_idx=take(sp.cam_idx, sp.o_per),
        pt_idx=take(sp.pt_idx, sp.o_per),
        valid=take(sp.valid, sp.o_per),
        pts=take(sp.pts, sp.p_per),
        pt_valid=take(sp.pt_valid, sp.p_per),
        pair_o1=take(sp.pair_o1, sp.n_per),
        pair_o2=take(sp.pair_o2, sp.n_per),
        pair_bucket=take(sp.pair_bucket, sp.n_per),
        blk=take(sp.blk, sp.p_per, axis=1),
    )


def _globalize(mesh: Mesh, sp: ShardedProblem, sp_local: ShardedProblem,
               dtype=None):
    """Build global jax.Arrays from the process-local shard slices.

    Global shapes come from the full partition metadata `sp` (every
    process computes it identically); only `sp_local`'s rows ever
    materialize on this process's devices."""
    fdt = (lambda a: np.asarray(a)) if dtype is None else (
        lambda a: np.asarray(a, dtype=dtype)
        if np.issubdtype(np.asarray(a).dtype, np.floating)
        else np.asarray(a))
    D = sp.n_devices

    def g(a, spec, gshape=None):
        if a is None:
            return None
        a = np.ascontiguousarray(a)
        return jax.make_array_from_process_local_data(
            NamedSharding(mesh, spec), a,
            global_shape=gshape or a.shape,
        )

    def gs(a, per):  # leading axis sharded over the mesh
        if a is None:
            return None
        a = np.ascontiguousarray(a)
        return g(a, P(AXIS), (D * per,) + a.shape[1:])

    dense = sp_local.blk is not None
    pa = ProblemArrays(
        K=g(fdt(sp_local.K), P()), q0=g(fdt(sp_local.q0), P()),
        obs=gs(fdt(sp_local.obs), sp.o_per),
        cam_idx=gs(sp_local.cam_idx, sp.o_per),
        pt_idx=gs(sp_local.pt_idx, sp.o_per),
        pair_o1=None if dense else gs(sp_local.pair_o1, sp.n_per),
        pair_o2=None if dense else gs(sp_local.pair_o2, sp.n_per),
        pair_bucket=None if dense else gs(sp_local.pair_bucket, sp.n_per),
        blk_idx=(
            g(sp_local.blk, P(None, AXIS),
              (sp_local.blk.shape[0], D * sp.p_per))
            if dense else None
        ),
        valid=gs(sp_local.valid, sp.o_per),
    )
    cams0 = g(fdt(sp_local.cams), P())
    pts0 = gs(fdt(sp_local.pts), sp.p_per)
    return pa, cams0, pts0


def solve_distributed(prob: BAProblem, cfg: SolverConfig | None = None,
                      mesh: Mesh | None = None, dtype=None, start="lm",
                      schur="auto"):
    """Hybrid solve over a (possibly process-spanning) mesh.

    Every process calls this with the same `prob` metadata; partitioning is
    deterministic, and each process materializes device data only for its
    own shards. The host alternation reads replicated scalars, which are
    addressable on every process. `schur` in {"auto", "dense", "pairs"}
    picks the per-shard S-assembly encoding (parallel.shard.shard_problem)."""
    from psba_tpu.solvers.hybrid import SolveResult

    cfg = cfg or SolverConfig()
    from psba_tpu.parallel.shard import _resolve_damping_host

    cfg = _resolve_damping_host(cfg, prob, dtype)
    mesh = mesh or global_mesh()
    n_devices = int(np.prod(mesh.devices.shape))

    sp = shard_problem(prob, n_devices, schur=schur)
    sp_local = _slice_local(sp, mesh)
    pa, cams0, pts0 = _globalize(mesh, sp, sp_local, dtype=dtype)

    # reuse the shard_map'd runners; their in/out specs match the global
    # arrays built above
    _, _, _, init_s, lm_s, tr_s = make_sharded_runners(
        sp, cfg, mesh, dtype=dtype, build_arrays=False
    )

    state = init_s(pa, cams0, pts0)
    if cfg.record_history:
        hist = np.full(
            (cfg.max_iters, 6), np.nan,
            np.dtype(dtype) if dtype else sp.pts.dtype,
        )
        state = state._replace(
            history=jax.make_array_from_process_local_data(
                NamedSharding(mesh, P()), hist
            )
        )
    initial_l2 = _rep_scalar(state.ex_l2)
    t0 = time.perf_counter()
    phase = start
    phases = []
    while True:
        state = (lm_s if phase == "lm" else tr_s)(pa, state)
        flag = int(_rep_scalar(state.flag))
        phases.append((phase, int(_rep_scalar(state.itno)), flag))
        if phase == "lm" and flag == CC.ITER_TURN_TO_TR:
            phase = "tr"
            continue
        if phase == "tr" and flag == CC.ITER_TURN_TO_LM:
            phase = "lm"
            continue
        break
    state.ex_l2.block_until_ready()
    wall = time.perf_counter() - t0

    # reassemble this process's point shards (global reassembly would
    # gather the whole problem on one host — callers that need it do an
    # explicit all-gather via process_allgather)
    local_pts = np.concatenate([
        np.asarray(s.data) for s in state.pts.addressable_shards
    ], axis=0)

    final_l2 = _rep_scalar(state.ex_l2)
    return SolveResult(
        cams=np.asarray(state.cams.addressable_shards[0].data),
        pts=local_pts,
        resolved_damping=cfg.damping,
        initial_l2=initial_l2, final_l2=final_l2,
        initial_error=float(np.sqrt(initial_l2) / prob.n_obs),
        final_error=float(np.sqrt(final_l2) / prob.n_obs),
        iterations=int(_rep_scalar(state.itno)), flag=flag,
        flag_name=CC.FLAG_NAMES.get(flag, str(flag)),
        wall_s=wall, phases=phases,
        history=(
            None if state.history is None
            else np.asarray(state.history.addressable_shards[0].data)
        ),
    )


def _rep_scalar(x):
    """Host value of a fully-replicated device scalar (safe in
    multi-process: reads this process's addressable shard)."""
    return float(np.asarray(x.addressable_shards[0].data))

"""Problem sharding + distributed solve over a jax.sharding.Mesh.

Partitioning scheme (BASELINE.json north star; SURVEY.md §2.3):
  - points are split into contiguous chunks with balanced observation
    counts; every observation lives with its point's shard, so per-point
    reductions (V, gb, eb, dpb) and Schur covisibility pairs are entirely
    shard-local;
  - cameras, intrinsics, and all solver control scalars are replicated;
  - the reduced camera system (U, ga, S, ea) and every global scalar
    (L2 norms, dots, max-diagonal) are formed with `psum`/`pmax` over the
    mesh axis — the only cross-device traffic.

Per LM iteration the collective payload is O(C^2 * 36) for S plus O(C * 6)
vectors and a handful of scalars — independent of the number of points and
observations, which is what makes observations/s scale.
"""

from __future__ import annotations

import dataclasses
import time

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

shard_map = jax.shard_map

from psba_tpu import constants as CC
from psba_tpu.parallel.ctx import MeshCtx
from psba_tpu.problem import BAProblem, build_covis_pairs
from psba_tpu.solvers.lm import lm_run
from psba_tpu.solvers.tr import tr_run
from psba_tpu.solvers.types import OptState, ProblemArrays, SolverConfig

AXIS = "obs"


@dataclasses.dataclass(frozen=True)
class ShardedProblem:
    """Host-side stacked shard arrays (leading axis = n_devices * local)."""

    n_devices: int
    o_per: int            # padded observations per shard
    p_per: int            # padded points per shard
    n_per: int            # padded covis pairs per shard (0 when dense)
    K: np.ndarray         # [C,5] replicated
    q0: np.ndarray        # [C,4]
    cams: np.ndarray      # [C,6]
    obs: np.ndarray       # [D*o_per, 2]
    cam_idx: np.ndarray   # [D*o_per]
    pt_idx: np.ndarray    # [D*o_per] shard-local numbering
    valid: np.ndarray     # [D*o_per] bool
    pts: np.ndarray       # [D*p_per, 3] zero-padded
    pt_valid: np.ndarray  # [D*p_per] bool
    pt_starts: np.ndarray    # [D+1] global point range per shard
    # Schur encoding (one of the two; see solvers/types.ProblemArrays)
    pair_o1: np.ndarray | None = None  # [D*n_per] shard-local obs numbering
    pair_o2: np.ndarray | None = None  # [D*n_per]
    pair_bucket: np.ndarray | None = None  # [D*n_per]; C*C marks padding
    blk: np.ndarray | None = None  # [C, D*p_per] shard-local obs numbering;
    # o_per marks unseen cells (sharded on the point axis, dim 1)


def shard_problem(prob: BAProblem, n_devices: int,
                  schur: str = "auto") -> ShardedProblem:
    """Split a problem into point-contiguous shards with balanced
    observation counts. `schur` in {"auto", "dense", "pairs"} picks the
    per-shard S-assembly encoding (types.ProblemArrays.from_problem)."""
    Pn, C = prob.n_pts, prob.n_cams
    assert Pn >= n_devices, "need at least one point per device"
    counts = np.bincount(prob.pt_idx, minlength=Pn)
    cum = np.concatenate([[0], np.cumsum(counts)])  # [P+1]
    # cut points where cumulative obs crosses i * O/D
    targets = (np.arange(1, n_devices) * prob.n_obs) / n_devices
    cuts = np.searchsorted(cum[1:], targets, side="left") + 1
    pt_starts = np.concatenate([[0], cuts, [Pn]]).astype(np.int64)
    # ensure strictly increasing (degenerate tiny shards)
    for i in range(1, len(pt_starts)):
        pt_starts[i] = max(pt_starts[i], pt_starts[i - 1] + 1)
    pt_starts[-1] = Pn

    # dense encoding decided on the largest shard's [C, p_per] table
    if schur == "auto":
        max_p_per = int(np.max(np.diff(pt_starts)))
        schur = (
            "dense" if C * max_p_per <= CC.DENSE_SCHUR_MAX_ENTRIES
            else "pairs"
        )
    dense = schur == "dense"

    shards = []
    for d in range(n_devices):
        p_lo, p_hi = pt_starts[d], pt_starts[d + 1]
        o_lo, o_hi = cum[p_lo], cum[p_hi]
        loc_pt = prob.pt_idx[o_lo:o_hi] - p_lo
        loc_cam = prob.cam_idx[o_lo:o_hi]
        if dense:
            o1 = o2 = bucket = np.zeros(0, np.int32)
        else:
            o1, o2, bucket = build_covis_pairs(loc_pt, loc_cam, C)
        shards.append(dict(
            obs=prob.obs[o_lo:o_hi], cam_idx=loc_cam, pt_idx=loc_pt,
            pts=prob.pts[p_lo:p_hi], o1=o1, o2=o2, bucket=bucket,
        ))

    o_per = max(len(s["cam_idx"]) for s in shards)
    p_per = max(len(s["pts"]) for s in shards)
    n_per = max(len(s["o1"]) for s in shards)

    def pad(a, n, fill=0):
        if len(a) == n:
            return a
        pad_shape = (n - len(a),) + a.shape[1:]
        return np.concatenate([a, np.full(pad_shape, fill, dtype=a.dtype)])

    obs, cam_idx, pt_idx, valid, pts, pt_valid = [], [], [], [], [], []
    po1, po2, pbk, blks = [], [], [], []
    for s in shards:
        n_o, n_p = len(s["cam_idx"]), len(s["pts"])
        if dense:
            # shard-local table padded on the point axis; o_per (the index
            # of stack_blocks' appended zero row) marks unseen cells
            b = np.full((C, p_per), o_per, dtype=np.int32)
            b[s["cam_idx"], s["pt_idx"]] = np.arange(n_o, dtype=np.int32)
            blks.append(b)
        # padded observations duplicate the shard's first observation so the
        # residual stays finite; `valid` masks them out of every reduction
        obs.append(pad(s["obs"], o_per, fill=0) if n_o == o_per else
                   np.concatenate([s["obs"],
                                   np.repeat(s["obs"][:1], o_per - n_o, 0)]))
        cam_idx.append(pad(s["cam_idx"], o_per, fill=int(s["cam_idx"][0])))
        pt_idx.append(pad(s["pt_idx"], o_per, fill=int(s["pt_idx"][0])))
        valid.append(np.arange(o_per) < n_o)
        pts.append(pad(s["pts"], p_per, fill=0.0))
        pt_valid.append(np.arange(p_per) < n_p)
        po1.append(pad(s["o1"], n_per, fill=0))
        po2.append(pad(s["o2"], n_per, fill=0))
        pbk.append(pad(s["bucket"], n_per, fill=C * C))

    cat = lambda xs: np.concatenate(xs, axis=0)
    return ShardedProblem(
        n_devices=n_devices, o_per=o_per, p_per=p_per, n_per=n_per,
        K=prob.K, q0=prob.q0, cams=prob.cams,
        obs=cat(obs), cam_idx=cat(cam_idx).astype(np.int32),
        pt_idx=cat(pt_idx).astype(np.int32), valid=cat(valid),
        pts=cat(pts), pt_valid=cat(pt_valid),
        pair_o1=None if dense else cat(po1).astype(np.int32),
        pair_o2=None if dense else cat(po2).astype(np.int32),
        pair_bucket=None if dense else cat(pbk).astype(np.int32),
        blk=np.concatenate(blks, axis=1) if dense else None,
        pt_starts=pt_starts,
    )


def _make_mesh(n_devices: int) -> Mesh:
    devs = jax.devices()
    assert len(devs) >= n_devices, (
        f"{n_devices} devices requested, {len(devs)} available"
    )
    return jax.make_mesh((n_devices,), (AXIS,), devices=devs[:n_devices])


def _shard_specs(dense: bool, cfg: SolverConfig):
    """Partition specs shared by the solver and timing runners."""
    pa_spec = ProblemArrays(
        K=P(), q0=P(), obs=P(AXIS), cam_idx=P(AXIS), pt_idx=P(AXIS),
        pair_o1=None if dense else P(AXIS),
        pair_o2=None if dense else P(AXIS),
        pair_bucket=None if dense else P(AXIS),
        blk_idx=P(None, AXIS) if dense else None,  # point axis is dim 1
        valid=P(AXIS),
    )
    # history rows are built entirely from psum'd (replicated) scalars, so
    # the capture buffer is replicated across shards
    hist_spec = P() if cfg.record_history else None
    state_spec = OptState(
        cams=P(), pts=P(AXIS), ex=P(AXIS), ex_l2=P(), itno=P(), flag=P(),
        history=hist_spec,
    )
    return pa_spec, state_spec


def make_sharded_lm_repeat(sp: ShardedProblem, cfg: SolverConfig,
                           mesh: Mesh):
    """Repeats runner for the SHARDED path: one dispatch executes
    `repeats` identical iter_cap-length lm_run trajectories under
    shard_map (the sharded analog of benchmarks.measure.lm_repeat_runner,
    same LICM-defeating zero perturbation). Returns
    `(pa, state0, iter_cap, repeats) -> (acc_l2, total_itno)` with both
    outputs replicated scalars."""
    ctx = MeshCtx(AXIS)
    pa_spec, state_spec = _shard_specs(sp.blk is not None, cfg)

    def rep_fn(pa, state0, iter_cap, repeats):
        zero = jnp.zeros((), state0.cams.dtype)

        def body(_k, carry):
            acc, itno = carry
            eps = jnp.minimum(acc, zero)  # == 0.0; defeats LICM
            st = state0._replace(cams=state0.cams + eps)
            out = lm_run(pa, st, cfg, ctx=ctx, iter_cap=iter_cap)
            return acc + out.ex_l2, itno + out.itno

        return jax.lax.fori_loop(
            jnp.int32(0), repeats, body, (zero, jnp.int32(0))
        )

    return jax.jit(shard_map(
        rep_fn, mesh=mesh, in_specs=(pa_spec, state_spec, P(), P()),
        out_specs=(P(), P()), check_vma=False,
    ))


def make_sharded_runners(sp: ShardedProblem, cfg: SolverConfig, mesh: Mesh,
                         dtype=None, build_arrays=True):
    """Build (pa_global, cams0, pts0, init_fn, lm_fn, tr_fn) shard_mapped
    over `mesh`. With build_arrays=False only the runners are built (the
    multi-process path materializes its arrays host-locally instead, see
    psba_tpu.parallel.distributed)."""
    ctx = MeshCtx(AXIS)
    dense = sp.blk is not None
    pa_global = cams0 = pts0 = None
    if build_arrays:
        fdt = (lambda a: jnp.asarray(a)) if dtype is None else (
            lambda a: jnp.asarray(a, dtype=dtype))
        opt = lambda a: None if a is None else jnp.asarray(a)
        pa_global = ProblemArrays(
            K=fdt(sp.K), q0=fdt(sp.q0), obs=fdt(sp.obs),
            cam_idx=jnp.asarray(sp.cam_idx), pt_idx=jnp.asarray(sp.pt_idx),
            pair_o1=opt(sp.pair_o1), pair_o2=opt(sp.pair_o2),
            pair_bucket=opt(sp.pair_bucket),
            blk_idx=opt(sp.blk),
            valid=jnp.asarray(sp.valid),
        )
        pts0 = fdt(sp.pts)
        cams0 = fdt(sp.cams)

    pa_spec, state_spec = _shard_specs(dense, cfg)
    init_spec = state_spec._replace(history=None)  # init has no buffer yet

    def smap(f, in_specs, out_specs):
        return jax.jit(shard_map(
            f, mesh=mesh, in_specs=in_specs, out_specs=out_specs,
            check_vma=False,
        ))

    def init_fn(pa, cams, pts):
        return OptState.init(pa, cams, pts, clamp=cfg.clamp_quat, ctx=ctx)

    def lm_fn(pa, state, iter_cap):
        return lm_run(pa, state, cfg, ctx=ctx, iter_cap=iter_cap)

    def tr_fn(pa, state, iter_cap):
        return tr_run(pa, state, cfg, ctx=ctx, iter_cap=iter_cap)

    init_s = smap(init_fn, (pa_spec, P(), P(AXIS)), init_spec)
    # iter_cap is a replicated traced scalar: one compiled executable
    # serves every run length (chunked checkpointing, fixed-work timing)
    lm_c = smap(lm_fn, (pa_spec, state_spec, P()), state_spec)
    tr_c = smap(tr_fn, (pa_spec, state_spec, P()), state_spec)

    def lm_s(pa, state, iter_cap=None):
        cap = cfg.max_iters if iter_cap is None else iter_cap
        return lm_c(pa, state, jnp.int32(cap))

    def tr_s(pa, state, iter_cap=None):
        cap = cfg.max_iters if iter_cap is None else iter_cap
        return tr_c(pa, state, jnp.int32(cap))

    return pa_global, cams0, pts0, init_s, lm_s, tr_s


# observation chunk of the host-side damping probe: materializing
# full-problem [O,2,6] Jacobian intermediates on every process would
# defeat the distributed path's shard-local memory model at exactly the
# scales it exists for
_PROBE_MAX_OBS = 262_144


def _resolve_damping_host(cfg: SolverConfig, prob: BAProblem, dtype):
    """Resolve damping="auto" BEFORE sharding, exactly as solve() does.

    Every process/device evaluates the same deterministic probe on the
    replicated problem metadata, so the resolved config (a static jit
    argument) is identical everywhere — no collective needed. The
    diag(J^T J) sums are taken over the whole problem in chunks of
    _PROBE_MAX_OBS observations (the last one padded and masked), which
    bounds the probe's intermediates. (A strided subsample, which this
    replaced, shrinks the smallest diagonal where a point keeps one of
    its observations, and at Rome-93's 3.1e5 observations resolved f32 to
    marquardt where solve() resolved additive.)"""
    if cfg.damping != "auto":
        return cfg
    from psba_tpu.solvers.types import diag_sums, resolve_from_diag

    dt = dtype or prob.pts.dtype
    O, C, Pn = prob.n_obs, prob.n_cams, prob.n_pts
    K, q0 = jnp.asarray(prob.K, dt), jnp.asarray(prob.q0, dt)
    cams, pts = jnp.asarray(prob.cams, dt), jnp.asarray(prob.pts, dt)
    chunk = min(O, _PROBE_MAX_OBS)
    dU = dV = 0.0
    for lo in range(0, O, chunk):
        n = min(chunk, O - lo)
        idx = np.arange(lo, lo + chunk).clip(max=O - 1)
        valid = None if O <= chunk else jnp.asarray(np.arange(chunk) < n)
        u, v = diag_sums(
            K, q0, cams, pts, jnp.asarray(prob.cam_idx[idx]),
            jnp.asarray(prob.pt_idx[idx]), valid, cfg.clamp_quat, C, Pn,
        )
        dU, dV = dU + np.asarray(u), dV + np.asarray(v)
    return resolve_from_diag(cfg, dU, dV, dt)


def solve_sharded(prob: BAProblem, cfg: SolverConfig | None = None,
                  n_devices: int | None = None, dtype=None, start="lm",
                  schur="auto"):
    """Distributed hybrid solve (host alternation identical to
    psba_tpu.solvers.hybrid.solve). `schur` in {"auto", "dense", "pairs"}
    picks the per-shard S-assembly encoding."""
    from psba_tpu.solvers.hybrid import SolveResult

    cfg = cfg or SolverConfig()
    cfg = _resolve_damping_host(cfg, prob, dtype)
    n_devices = n_devices or len(jax.devices())
    mesh = _make_mesh(n_devices)
    sp = shard_problem(prob, n_devices, schur=schur)
    pa, cams0, pts0, init_s, lm_s, tr_s = make_sharded_runners(
        sp, cfg, mesh, dtype=dtype
    )

    state = init_s(pa, cams0, pts0)
    if cfg.record_history:
        dt = state.cams.dtype
        state = state._replace(
            history=jnp.full((cfg.max_iters, 6), jnp.nan, dt)
        )
    initial_l2 = float(state.ex_l2)
    t0 = time.perf_counter()
    phase = start
    phases = []
    while True:
        state = (lm_s if phase == "lm" else tr_s)(pa, state)
        flag = int(state.flag)
        phases.append((phase, int(state.itno), flag))
        if phase == "lm" and flag == CC.ITER_TURN_TO_TR:
            phase = "tr"
            continue
        if phase == "tr" and flag == CC.ITER_TURN_TO_LM:
            phase = "lm"
            continue
        break
    state.ex_l2.block_until_ready()
    wall = time.perf_counter() - t0

    # reassemble the global point array from shards
    pts_stacked = np.asarray(state.pts).reshape(n_devices, sp.p_per, 3)
    parts = [
        pts_stacked[d, : sp.pt_starts[d + 1] - sp.pt_starts[d]]
        for d in range(n_devices)
    ]
    pts_global = np.concatenate(parts, axis=0)

    final_l2 = float(state.ex_l2)
    return SolveResult(
        cams=np.asarray(state.cams), pts=pts_global,
        resolved_damping=cfg.damping,
        initial_l2=initial_l2, final_l2=final_l2,
        initial_error=float(np.sqrt(initial_l2) / prob.n_obs),
        final_error=float(np.sqrt(final_l2) / prob.n_obs),
        iterations=int(state.itno), flag=flag,
        flag_name=CC.FLAG_NAMES.get(flag, str(flag)),
        wall_s=wall, phases=phases,
        history=(
            None if state.history is None else np.asarray(state.history)
        ),
    )

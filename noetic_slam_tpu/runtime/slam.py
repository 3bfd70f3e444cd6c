"""Full SLAM system: odometry + TSDF fusion + pose graph + loop closure.

The composition root replacing the reference's multi-node roslaunch graph
(dlio odom node + map node + dliomapping + the absent tsdf_map node,
scripts/compound-launch.sh): one object owning

- the odometry pipeline (runtime.pipeline.OdometryPipeline),
- the TSDF map (models.tsdf), fed with every registered world-frame cloud
  (the stream dliomapping.cpp:44 subscribed to),
- a keyframe pose graph (models.posegraph) with two-stage loop-closure
  detection (pose proximity over the resident store + rotation-invariant
  descriptor place recognition over every keyframe ever created,
  models.placedesc), GICP verification, Gauss-Newton optimization, and
  map deformation applied back into the live odometry state,
- a host-side keyframe archive (runtime.archive) whose unclamped signed
  map volume makes post-closure dense-map correction O(moved keyframes)
  over the full (unbounded) keyframe history.

Loop closure runs at keyframe rate (host-triggered, device-computed); all
hot per-scan work stays in the async odometry step.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from functools import partial

from noetic_slam_tpu.config.params import DlioConfig
from noetic_slam_tpu.models import posegraph as pg
from noetic_slam_tpu.models import tsdf as tsdf_mod
from noetic_slam_tpu.runtime.pipeline import OdometryPipeline
from noetic_slam_tpu.utils.geometry import (
    make_se3,
    quat_conj,
    quat_mul,
    quat_normalize,
    quat_rotate,
)

_add_edge_jit = jax.jit(pg.add_edge)


@jax.jit
def _guarded_verdict(accepted, kf_seq, slots, expects):
    """Fold the slot seq guards into the verification verdict in ONE
    dispatch (eager per-guard indexing would cost a host round trip
    each at closure-attempt rate)."""
    ok = jnp.all(kf_seq[slots] == expects)
    return jnp.logical_and(accepted, ok), ok


@partial(jax.jit, static_argnames=("k_max",))
def _gather_sync(st, n_nodes, n_edges, prev_total, k_max: int):
    """ONE device program producing everything a graph sync needs: the
    keyframe-store metadata, the outbox ring headers, the NEW keyframes'
    clouds (outbox entries for sequences (prev_total, prev_total+k_max]
    rolled into insertion order), and the fused-state seed for the
    host-side IMU-rate pose extrapolator.

    The r4 protocol issued two synchronous ``jax.device_get`` round trips
    per batch (metadata, then the gathered clouds once the new count was
    known), a large share of the km soak's wall time. Here the host
    dispatches this program right after a batch, starts async D2H copies,
    and consumes the result a batch later: the fetch overlaps device work
    instead of blocking on it. Rows beyond the actually-new count carry
    stale ring contents; the host validates each candidate sequence
    against the fetched ``ob_seq`` before use."""
    Q = st.ob_seq.shape[0]
    seqs = prev_total + 1 + jnp.arange(k_max, dtype=jnp.int32)
    slots = (seqs - 1) % Q
    return {
        "total": st.kf_total, "seq": st.kf_seq, "q": st.kf_quat,
        "p": st.kf_pos, "count": st.kf_count,
        "n_nodes": n_nodes, "n_edges": n_edges,
        "ob_seq": st.ob_seq, "ob_q": st.ob_q, "ob_p": st.ob_p,
        "ob_slot": st.ob_slot,
        "new_xyz": st.ob_xyz[slots],
        # fused-state snapshot for IMU-rate pose extrapolation
        # (runtime/poseext.py; the reference publishes pose at IMU rate
        # from its IMU callback, odom.cc:315-488). q/p/v are propagated
        # to prop_off (the last applied IMU sample ~ the sweep end,
        # relative to the last header) — NOT the header stamp.
        "cur_q": st.q, "cur_p": st.p, "cur_v": st.v,
        "bg": st.bg, "ba": st.ba, "prop_off": st.prop_off,
    }


@jax.jit
def _deform_state(st, new_q, new_p):
    """Apply optimized per-slot keyframe poses to the odometry state in ONE
    jitted dispatch: rigid cloud/covariance deformation
    (pg.apply_pose_update) + the live-pose correction by the NEWEST
    keyframe's pose delta + submap invalidation. The previous eager form
    issued ~15 separate device ops, each a host round trip at closure
    time.

    NEWEST = max insertion sequence, NOT slot kf_count-1: once the store
    saturates and evicts, slot order stops being age order (the r3
    mid-run multi-meter frame-jump bug)."""
    q, p, xyz, cov = pg.apply_pose_update(
        st.kf_quat, st.kf_pos, st.kf_xyz, st.kf_valid, st.kf_cov,
        new_q, new_p, st.kf_count)
    last = jnp.argmax(st.kf_seq)
    dq = quat_normalize(quat_mul(q[last], quat_conj(st.kf_quat[last])))
    dp = p[last] - quat_rotate(dq, st.kf_pos[last])
    lidar_p = quat_rotate(dq, st.lidar_p) + dp
    lidar_q = quat_normalize(quat_mul(dq, st.lidar_q))
    return st._replace(
        kf_quat=q, kf_pos=p, kf_xyz=xyz, kf_cov=cov,
        lidar_q=lidar_q, lidar_p=lidar_p,
        q=quat_normalize(quat_mul(dq, st.q)),
        p=quat_rotate(dq, st.p) + dp,
        v=quat_rotate(dq, st.v), prev_vel=quat_rotate(dq, st.prev_vel),
        T=make_se3(lidar_q, lidar_p),
        submap_mask=jnp.zeros_like(st.submap_mask))


class SlamSystem:
    def __init__(self, cfg: DlioConfig | None = None, enable_tsdf: bool = True,
                 enable_loop_closure: bool = True, loop_radius: float = 3.0,
                 loop_min_gap: int = 10, max_edges: int = 4096,
                 drift_budget_frac: float = 0.05,
                 drift_budget_min: float = 0.3,
                 archive: bool | None = None,
                 archive_eps_t: float | None = None,
                 archive_eps_r: float | None = None,
                 use_descriptors: bool = True,
                 desc_min_score: float = 0.55,
                 pipelined: bool = False,
                 min_closure_correction: float | None = None):
        self.cfg = cfg or DlioConfig()
        self.odometry = OdometryPipeline(self.cfg, with_tsdf=enable_tsdf)
        self.enable_tsdf = enable_tsdf
        self.enable_loop_closure = enable_loop_closure
        self.loop_radius = loop_radius
        self.loop_min_gap = loop_min_gap
        # Keyframe archive: host-side store of every keyframe ever created
        # + the incrementally corrected archive volume (runtime/archive.py)
        # — the long-run contract of the reference's unbounded accumulators
        # (dliomapping.cpp:41-99, odom.cc:1517-1598) on a fixed-capacity
        # device state. Default on whenever closures can deform the map.
        if archive is None:
            archive = enable_tsdf and enable_loop_closure
        self.archive = None
        if archive and enable_tsdf:
            from noetic_slam_tpu.runtime.archive import KeyframeArchive

            backend = self.cfg.map_backend
            mcfg = (self.cfg.occupancy if backend == "occupancy"
                    else self.cfg.tsdf)
            self.archive = KeyframeArchive(mcfg, backend=backend)
        # None -> map-resolution thresholds (voxel/4; see
        # KeyframeArchive.apply_poses for the half-voxel error bound).
        self.archive_eps_t = archive_eps_t
        self.archive_eps_r = archive_eps_r
        self.closure_log: list = []     # per-closure {moved, seconds}
        # Host-side stage attribution (runtime/profiling.StageTimer):
        # itemizes where keyframe-rate wall time goes (sync fetches,
        # archive fuses, descriptor queries, closure verify/optimize) so
        # the gap between the fused-kernel rate and the whole-system rate
        # is measured, not guessed (soak artifact stage table).
        from noetic_slam_tpu.runtime.profiling import StageTimer

        self.stages = StageTimer()
        # Descriptor-based place recognition (models/placedesc): matches
        # the latest keyframe against EVERY keyframe ever created, so loop
        # detection survives both drift (proximity detection needs the
        # estimate already near the truth) and resident-store eviction.
        # Verified candidates go through the same GICP + observability +
        # drift-budget gates as proximity candidates.
        # desc_min_score = 0.55 calibrated on the km-scale drifted soak's
        # descriptor score ROC (near-full recall at full precision;
        # thresholds above 0.6 only discard true revisits on this class
        # of scenes).
        self.desc_store = None
        if enable_loop_closure and use_descriptors:
            from noetic_slam_tpu.models.placedesc import DescriptorStore

            self.desc_store = DescriptorStore()
        self.desc_min_score = desc_min_score
        self._node_slot: dict = {}       # graph node -> resident slot
        self._last_desc_query_node = -1
        self._pending_desc = None        # in-flight query batch (pipelined)
        self._desc_match_hist: dict = {} # node -> (matched cand, shift)
        self.loop_closures_descriptor = 0
        self.desc_log: list = []         # per-query {node, cand, score}
        self.sync_lost_keyframes = 0     # outbox overruns (contract: 0)
        # Drift budget: a verified closure whose pose correction exceeds
        # drift_budget_frac x (path length around the loop) + minimum slack
        # is treated as a geometric alias (a structurally identical scene
        # elsewhere verifies perfectly — the correction magnitude is the
        # only local evidence against it). 5% is several x the drift of a
        # healthy LiDAR-inertial odometry.
        self.drift_budget_frac = drift_budget_frac
        self.drift_budget_min = drift_budget_min
        self.loop_rejected_budget = 0
        # Minimum correction to APPLY a verified closure (default a tenth
        # of a voxel). A closure whose correction is far below the map's
        # resolution carries no information the estimate doesn't already
        # have, but each apply costs a global optimize + O(moved) archive
        # re-fusion — on the km soak, self-similar spiral rings verified
        # ~2 closures per attempt at 1-3 cm each and the applies became
        # the top steady-state cost. Skipped ones count in
        # loop_skipped_small.
        if min_closure_correction is None:
            if enable_tsdf:
                mcfg2 = (self.cfg.occupancy
                         if self.cfg.map_backend == "occupancy"
                         else self.cfg.tsdf)
                min_closure_correction = 0.1 * mcfg2.voxel_size
            else:
                min_closure_correction = 0.02
        self.min_closure_correction = min_closure_correction
        self.loop_skipped_small = 0
        self._attempt_raced = False
        # The pose graph outlives the bounded keyframe store: node capacity
        # covers keyframes EVER created, not just resident ones (the store
        # evicts once full — models.odometry.push_keyframe). _slot_node maps
        # resident store slots to their graph node ids.
        self.max_graph_nodes = max(4 * self.cfg.capacity.max_keyframes, 512)
        self.graph = pg.init_graph(self.max_graph_nodes, max_edges)
        self._slot_node: dict = {}
        self._synced_total = 0
        self._last_kf_pose = None        # (q, p) of the newest synced kf
        self._kf_host = None     # host stash of keyframe metadata (sync_graph)
        self._edges_host = 0     # host mirror of graph.n_edges (re-seeded
                                 # from the device every sync_graph fetch)
        self.loop_closures = 0
        self.loop_raced = 0      # closure attempts rejected by the device
                                 # seq guard (slot evicted inside the
                                 # pipelined-staleness window — benign)
        # Pipelined sync protocol (sync_dispatch/_sync_complete): the
        # in-flight gather, the synced_total it was dispatched against, and
        # the scan count at dispatch (to tell a still-fresh pending fetch
        # from a stale one).
        self._pending_sync = None
        # Gather window: sized so the common sync cadence (every 1-2
        # batches) always lands inside it; overruns fall back to the
        # blocking two-phase drain (_sync_blocking — correct but slow),
        # and only gaps beyond outbox_slots lose keyframes (the r5 km
        # soak lost 40 when sync rode the closure cadence through 30-scan
        # cooldowns — drivers must sync on their OWN cadence).
        self._gather_k = min(self.cfg.capacity.outbox_slots, 24)
        # pipelined=True: maybe_close_loop uses sync_pipelined() (detection
        # on one-cadence-stale metadata, fetch overlapped with device
        # work) — the real-time drivers' mode. Default False keeps the
        # exact drain-everything-now semantics for library callers.
        self.pipelined = pipelined
        # Background graph-capacity pre-warm (threads compiling the
        # capacity-keyed solver/edge executables ahead of growth).
        self._warm_thread = None
        self._warm_target: tuple | None = None
        self._warmed_caps: set = set()
        self.extrapolator = None  # PoseExtrapolator fed by _sync_complete

    # ------------------------------------------------- shared solver params
    # ONE definition of the closure-stack program variants, used by BOTH
    # the closure path and warmup() — a literal copy in warmup would
    # silently desynchronize and the compile cost would return mid-run
    # with no test failing.

    def _verify_cfg(self):
        """Verification GICP config: full solver budget (closure-candidate
        rate is rare; a starved per-scan iteration budget must not decide
        accept/reject at the convergence knife edge)."""
        import dataclasses

        return dataclasses.replace(
            self.cfg.gicp,
            max_iterations=max(self.cfg.gicp.max_iterations, 32),
            lm_max_iterations=max(self.cfg.gicp.lm_max_iterations, 10))

    _DENSE_BUCKETS = (64, 128, 256)
    _DENSE_MAX = 192          # live nodes above this take the CG path
    _CG_ITERS = 60

    def _solver_variant(self, n_live: int):
        """(method, k_static|None) for the live node count: dense k_static
        buckets up to _DENSE_MAX nodes, matrix-free CG beyond (a
        grown-capacity graph with few nodes must not run the
        capacity-sized CG chain)."""
        if n_live <= self._DENSE_MAX:
            ks = max(self._DENSE_BUCKETS[0],
                     1 << (max(n_live, 1) - 1).bit_length())
            return "dense", min(ks, self.graph.node_q.shape[0])
        return "cg", None

    def _optimize_graph(self, n_live: int) -> None:
        """One solver pass (3 GN steps — Gauss-Newton converges
        quadratically and the steady-state km regime corrects centimeters
        per closure; large corrections run several PASSES of the
        same compiled program instead of a separate iters=10 variant that
        would pay a fresh compile mid-run)."""
        method, ks = self._solver_variant(n_live)
        self.graph = pg.optimize(self.graph, iters=3, method=method,
                                 k_static=ks, cg_iters=self._CG_ITERS)

    # -------------------------------------------------------------- warmup
    def warmup(self) -> None:
        """Pre-compile the closure-stack programs on dummy no-op inputs:
        archive fuse buckets (seconds each), descriptor
        match buckets, GICP loop verification (both guess variants), the
        pose-graph optimizer at current capacity, and the keyframe-store
        deformation. A real-time run pays these compiles up front instead
        of inside the first loop closure (without it the closure-path
        compiles land mid-run; steady-state cost after warmup is
        milliseconds). Optional — every program also
        compiles lazily on first use. Safe at ANY point, including after
        load() with live nodes: every warm call's result is discarded
        (the programs are pure), pinned bitwise by
        tests/test_slam_system.py::test_warmup_is_bitwise_noop."""
        import jax.numpy as jnp

        cap = self.cfg.capacity
        if self.archive is not None:
            self.archive.warmup(cap.max_ds_points)
        if self.desc_store is not None:
            from noetic_slam_tpu.models.placedesc import (N_RINGS, N_SECTORS,
                                                          match_store_batch)

            self.desc_store._sync_dev()
            for m in (4, 8, 16, 32, 64):
                jax.block_until_ready(match_store_batch(
                    jnp.zeros((m, N_RINGS, N_SECTORS)),
                    self.desc_store._dev, jnp.int32(0),
                    jnp.zeros((m,), jnp.int32)))
        if self.enable_loop_closure:
            Nk = cap.max_ds_points
            z3 = jnp.zeros((Nk, 3))
            zv = jnp.zeros((Nk,), bool)
            z6 = jnp.zeros((Nk, 6))
            vcfg = self._verify_cfg()
            mcd = 2.0 * self.cfg.gicp.max_corr_dist
            pg.verify_loop.lower(z3, zv, z6, z3, z6, vcfg,
                                 max_corr_dist=mcd).compile()
            pg.verify_loop.lower(z3, zv, z6, z3, z6, vcfg,
                                 max_corr_dist=mcd,
                                 guess=jnp.eye(4)).compile()
            # archived-candidate covariance path (_candidate_data): the
            # per-scan pipeline may run the radius engine, leaving
            # plane_covariances uncompiled until the first evicted-
            # candidate closure
            from noetic_slam_tpu.ops import gicp as gicp_ops

            jax.block_until_ready(gicp_ops.plane_covariances(
                z3, zv, self.cfg.gicp.k_correspondences)[0])
            # optimizer variants the closure path selects by live node
            # count (_solver_variant: dense buckets + the large-graph CG)
            # at the closure iteration budget, plus the edge-append
            # executable. AOT-compiled (.lower().compile()), never
            # executed: executing on a live graph with an undersized
            # k_static would corrupt node poses, and even a discarded
            # call would burn seconds running the CG chain for nothing.
            self._warm_graph_capacity(self.graph.node_q.shape[0],
                                      self.graph.edge_i.shape[0])
            # full-state deformation + the pipelined sync-gather + the
            # seq-guard fold, all on a throwaway state
            from noetic_slam_tpu.models.odometry import init_state

            dummy = init_state(self.cfg)
            _deform_state.lower(dummy, dummy.kf_quat,
                                dummy.kf_pos).compile()
            _gather_sync.lower(dummy, jnp.int32(0), jnp.int32(0),
                               jnp.int32(0),
                               k_max=self._gather_k).compile()
            _guarded_verdict.lower(
                jax.ShapeDtypeStruct((), jnp.bool_), dummy.kf_seq,
                jax.ShapeDtypeStruct((2,), jnp.int32),
                jax.ShapeDtypeStruct((2,), jnp.int32)).compile()
            del dummy
        if self.archive is not None:
            jax.block_until_ready(jax.tree.leaves(
                self.archive.snapshot_live())[0])

    # ------------------------------------------------------------ per scan
    def push_imu(self, stamp, ang, acc):
        self.odometry.push_imu(stamp, ang, acc)

    @property
    def calibrated(self):
        return self.odometry.calibrated

    def imu_covers(self, stamp):
        return self.odometry.imu_covers(stamp)

    @property
    def tsdf(self):
        return self.odometry.tsdf_state

    def process_scan(self, header_stamp, xyz, point_times=None):
        # TSDF integration is fused into the same jitted program as the
        # odometry step (models.odometry.make_slam_step).
        return self.odometry.process_scan(header_stamp, xyz, point_times)

    def process_scans(self, batch):
        """Micro-batched submission (one dispatch for K scans); identical
        results to per-scan calls. Loop-closure checks happen between
        batches (keyframe-rate work, as in the per-scan path)."""
        return self.odometry.process_scans(batch)

    # ---------------------------------------- graph-capacity pre-warming
    def _graph_avatar(self, cap_n: int, cap_e: int):
        """ShapeDtypeStruct pytree of a PoseGraph at (cap_n, cap_e)
        capacity — lets a background thread AOT-compile the
        capacity-keyed executables without touching live device data."""
        g = self.graph
        fields = {}
        for name, leaf in zip(type(g)._fields, g):
            shape = tuple(leaf.shape)
            if name.startswith("node_"):
                shape = (cap_n,) + shape[1:]
            elif name.startswith("edge_"):
                shape = (cap_e,) + shape[1:]
            fields[name] = jax.ShapeDtypeStruct(shape, leaf.dtype)
        return type(g)(**fields)

    def _warm_graph_capacity(self, cap_n: int, cap_e: int,
                             dense: bool = True) -> None:
        """AOT-compile (.lower().compile() — never executed) every solver
        variant the closure path can select at this graph capacity, plus
        the edge-append executable. Capacity growth re-keys ALL of them.
        ``dense=False`` skips the dense k_static buckets — correct once
        the live node count is past _DENSE_MAX (node count is monotone,
        so _solver_variant will never select dense again); a grow while
        still <= _DENSE_MAX must keep them (ADVICE r4: the dense
        executables are capacity-keyed too)."""
        av = self._graph_avatar(cap_n, cap_e)
        f32 = jnp.float32
        s_i = jax.ShapeDtypeStruct((), jnp.int32)
        s_q = jax.ShapeDtypeStruct((4,), f32)
        s_p = jax.ShapeDtypeStruct((3,), f32)
        s_w = jax.ShapeDtypeStruct((), f32)
        _add_edge_jit.lower(av, s_i, s_i, s_q, s_p,
                            w_rot=s_w, w_trans=s_w).compile()
        # the node/edge-chain append is capacity-keyed per padded-batch
        # bucket too (pg._add_chain static m) — its recompiles were the
        # residual slow-growth-window cost after the solver pre-warm
        for m in (4, 8, 16):
            pg._add_chain.lower(
                av, jax.ShapeDtypeStruct((m, 4), f32),
                jax.ShapeDtypeStruct((m, 3), f32), s_i, s_q, s_p,
                m=m, have_prev=True).compile()
        # NOTE: static kwargs must match the closure path's calls EXACTLY
        # including explicitly-passed defaults — jit caches
        # omitted-default and explicit-default separately.
        pg.optimize.lower(av, iters=3, method="cg", k_static=None,
                          cg_iters=self._CG_ITERS).compile()
        if dense:
            for ks in self._DENSE_BUCKETS:
                if ks <= cap_n:
                    pg.optimize.lower(av, iters=3, method="dense",
                                      k_static=ks,
                                      cg_iters=self._CG_ITERS).compile()
        self._warmed_caps.add((cap_n, cap_e))

    def _prewarm_async(self, cap_n: int, cap_e: int,
                       dense: bool = False) -> None:
        """Compile the (cap_n, cap_e) executables in a background thread
        (XLA compilation runs host-side; it overlaps device work). Spawned
        well ahead of need — at 50 % node occupancy — so the compile is
        DONE before growth; _ensure_capacity_warm joins it otherwise."""
        if (cap_n, cap_e) in self._warmed_caps or (
                self._warm_thread is not None
                and self._warm_thread.is_alive()
                and self._warm_target == (cap_n, cap_e)):
            return
        import threading

        if self._warm_thread is not None and self._warm_thread.is_alive():
            return                    # one in flight at a time
        self._warm_target = (cap_n, cap_e)
        self._warm_thread = threading.Thread(
            target=self._warm_graph_capacity, args=(cap_n, cap_e, dense),
            daemon=True)
        self._warm_thread.start()

    def _ensure_capacity_warm(self, cap_n: int, cap_e: int,
                              dense: bool = True) -> None:
        """Block until the (cap_n, cap_e) executables are compiled
        (joins a matching in-flight pre-warm; compiles inline as the
        fallback). Only ever reached when growth outpaced the 50 %
        pre-warm trigger."""
        if (cap_n, cap_e) in self._warmed_caps:
            return
        if (self._warm_thread is not None and self._warm_thread.is_alive()
                and self._warm_target == (cap_n, cap_e)):
            with self.stages("growth_warm"):
                self._warm_thread.join()
            return
        with self.stages("growth_warm"):
            self._warm_graph_capacity(cap_n, cap_e, dense)

    # ------------------------------------------------------- loop closures
    def sync_dispatch(self) -> None:
        """Dispatch the coalesced sync-gather program (_gather_sync) and
        start async D2H copies of its outputs — no blocking. The matching
        _sync_complete (typically a batch later) consumes the result;
        meanwhile the copies overlap the next batch's device work. No-op
        when a gather is already in flight or no state exists yet."""
        st = self.odometry.state
        if st is None or self._pending_sync is not None:
            return
        g = self.graph
        f = _gather_sync(st, g.n_nodes, g.n_edges,
                         jnp.int32(self._synced_total),
                         k_max=self._gather_k)
        for leaf in jax.tree.leaves(f):
            try:
                leaf.copy_to_host_async()
            except AttributeError:     # backend without async D2H
                break
        self._pending_sync = (f, self._synced_total,
                              len(self.odometry.headers))

    def _sync_complete(self) -> int:
        """Consume the in-flight gather (blocking only on its D2H copies,
        which a pipelined caller has already overlapped with device work)
        and commit the drained keyframes. Returns new-node count."""
        if self._pending_sync is None:
            return 0
        f, prev_total, n_hdr = self._pending_sync
        self._pending_sync = None
        assert prev_total == self._synced_total, \
            "pending sync raced a completed drain"
        with self.stages("sync_fetch"):
            h = jax.device_get(f)
        return self._drain(h, n_hdr)

    def sync_graph(self) -> int:
        """Drain the device keyframe OUTBOX: add graph nodes/odometry edges
        (and archive/descriptor entries) for every keyframe created since
        the last call, in insertion order. Returns number of new nodes.
        EXACT semantics: on return the graph covers every keyframe created
        so far (an in-flight stale gather is completed first, then a fresh
        one runs if scans were submitted since it was dispatched).

        Losslessness: push_keyframe writes every keyframe into the outbox
        ring (models/odometry.OdomState.ob_*) independent of resident-store
        eviction, so a slot overwritten twice between syncs no longer drops
        the intermediate keyframe from the graph/archive/descriptors (the
        r3 km soak lost 385/2554 that way). The contract is syncing at
        least once per capacity.outbox_slots new keyframes; overruns are
        counted in ``sync_lost_keyframes`` (asserted 0 by the soak)."""
        n = 0
        p = self._pending_sync
        if p is not None:
            n = self._sync_complete()
            if p[2] == len(self.odometry.headers):
                return n               # pending covered the current state
        self.sync_dispatch()
        return n + self._sync_complete()

    def sync_pipelined(self) -> int:
        """Pipelined drain for real-time drivers: complete the PREVIOUS
        dispatch (stale by up to one call cadence — lossless per the
        outbox contract) and prefetch the next. Never blocks on the
        current batch's device work; closure detection then runs on
        metadata one cadence old, with device-side seq guards rejecting
        any candidate whose resident slot was evicted inside the window
        (_attempt_closure), and a fresh exact sync_graph() re-running
        before any accepted closure is applied."""
        n = self._sync_complete()
        self.sync_dispatch()
        return n

    def _drain(self, h, n_hdr: int | None = None) -> int:
        """Commit one fetched gather: reconstruct the new-keyframe records
        from the outbox headers and hand them to _commit. Falls back to
        _sync_blocking when the gathered window cannot serve the drain
        (more new keyframes than _gather_k, or ring entries already
        overwritten — resident-store recovery needs a fresh fetch)."""
        total = int(h["total"])
        seq = h["seq"]
        self._kf_host = {"total": total, "seq": seq, "q": h["q"],
                         "p": h["p"], "count": int(h["count"])}
        self._edges_host = int(h["n_edges"])
        if self.extrapolator is not None and n_hdr:
            # fused-state snapshot corresponds to the n_hdr-th submitted
            # scan (the gather ran after its step program), propagated to
            # header + prop_off (the last applied IMU sample)
            self.extrapolator.seed(
                self.odometry.headers[n_hdr - 1] + float(h["prop_off"]),
                h["cur_q"], h["cur_p"], h["cur_v"], h["bg"], h["ba"])
        prev_total = self._synced_total
        if total <= prev_total:
            return 0
        count = total - prev_total
        ob_seq = h["ob_seq"]
        Q = ob_seq.shape[0]
        if count > self._gather_k or any(
                int(ob_seq[(sq - 1) % Q]) != sq
                for sq in range(prev_total + 1, total + 1)):
            return self._sync_blocking()
        sel = np.asarray([(sq - 1) % Q
                          for sq in range(prev_total + 1, total + 1)])
        new_q = h["ob_q"][sel]
        new_p = h["ob_p"][sel]
        new_slots = h["ob_slot"][sel]
        xyz_new = h["new_xyz"][:count]
        valid_new = np.all(np.abs(xyz_new) < 1e5, axis=-1)
        return self._commit(new_q, new_p, new_slots, xyz_new, valid_new,
                            int(h["n_nodes"]), total)

    def _sync_blocking(self) -> int:
        """Fresh two-phase drain against the CURRENT state — the fallback
        for callers violating the gather-window contract (syncing less
        than once per _gather_k new keyframes): metadata fetch, then
        recovery of older unsynced sequences from the RESIDENT store when
        their slot has not been re-evicted. Only keyframes that BOTH fell
        out of the ring AND lost their resident slot are unrecoverable
        (counted — the soak asserts 0)."""
        st = self.odometry.state
        if st is None:
            return 0
        with self.stages("sync_fetch"):
            (total, seq, kf_q, kf_p, kf_count, node, n_edges, ob_seq,
             ob_q, ob_p, ob_slot) = [
                (int(x) if x.ndim == 0 else x) for x in jax.device_get(
                    (st.kf_total, st.kf_seq, st.kf_quat, st.kf_pos,
                     st.kf_count, self.graph.n_nodes, self.graph.n_edges,
                     st.ob_seq, st.ob_q, st.ob_p, st.ob_slot))]
        self._kf_host = {"total": total, "seq": seq, "q": kf_q, "p": kf_p,
                         "count": kf_count}
        self._edges_host = n_edges
        if total <= self._synced_total:
            return 0

        # Outbox drain: sequences (total - Q, total] live in ring slots
        # (s - 1) % Q; older unsynced sequences fall back to the store.
        Q = ob_seq.shape[0]
        first_new = self._synced_total + 1
        seq_to_slot = {int(seq[s]): s for s in range(len(seq))
                       if seq[s] >= first_new}
        recs = []                     # (seq, from_outbox, index)
        lost = 0
        for sq in range(first_new, total + 1):
            oi = (sq - 1) % Q
            if sq > total - Q and ob_seq[oi] == sq:
                recs.append((sq, True, oi))
            elif sq in seq_to_slot:
                # ring miss (e.g. a hand-constructed state) or older than
                # the ring window: recover from the resident store
                recs.append((sq, False, seq_to_slot[sq]))
            else:
                lost += 1
        self.sync_lost_keyframes += lost
        count = len(recs)
        if count == 0:
            self._synced_total = total
            return 0
        new_q = np.stack([ob_q[i] if ob else kf_q[i]
                          for _, ob, i in recs])
        new_p = np.stack([ob_p[i] if ob else kf_p[i]
                          for _, ob, i in recs])
        new_slots = np.asarray([ob_slot[i] if ob else i
                                for _, ob, i in recs])

        # ONE batched fetch of the new keyframes' clouds for the archive +
        # descriptors. Validity never ships: cloud stores hold invalid
        # rows at the 1e6 SENTINEL, so one xyz gather per source is the
        # whole fetch.
        xyz_new = valid_new = None
        if self.archive is not None or self.desc_store is not None:
            with self.stages("sync_clouds"):
                from_ob = np.asarray([ob for _, ob, _ in recs])
                ob_sel = jnp.asarray(
                    [i if ob else 0 for _, ob, i in recs])
                if from_ob.all():     # common case: ONE gather + fetch
                    xyz_new = jax.device_get(st.ob_xyz[ob_sel])
                else:
                    kf_sel = jnp.asarray(
                        [0 if ob else i for _, ob, i in recs])
                    oxyz, kxyz = jax.device_get(
                        (st.ob_xyz[ob_sel], st.kf_xyz[kf_sel]))
                    xyz_new = np.where(from_ob[:, None, None], oxyz, kxyz)
                valid_new = np.all(np.abs(xyz_new) < 1e5, axis=-1)
        return self._commit(new_q, new_p, new_slots, xyz_new, valid_new,
                            node, total)

    def _commit(self, new_q, new_p, new_slots, xyz_new, valid_new,
                node: int, total: int) -> int:
        """Append the drained keyframes: capacity growth (+ pre-warm of
        the next capacity), ONE jitted node/edge-chain append, slot<->node
        bookkeeping, batched archive fuse, batched descriptor add."""
        count = len(new_q)

        # Capacity ahead-of-saturation growth: pg.add_node/add_edge
        # saturate silently, which would leave _slot_node entries dangling
        # and the odometry chain broken past max_graph_nodes (the round-2
        # long-run corruption hazard). Grow by doubling so node ids stay
        # valid for the whole (unbounded) run.
        cap_n = self.graph.node_q.shape[0]
        cap_e = self.graph.edge_i.shape[0]
        grew = False
        need_n, need_e = node + count, self._edges_host + count + 4
        while cap_n < need_n:
            cap_n *= 2
            grew = True
        # Edge capacity rides node capacity (cap_e >= 2*cap_n: chain edge
        # per node + closure edges) so each doubling is ONE growth event
        # with a PREDICTABLE target — the background pre-warm below then
        # compiles exactly the capacity pair growth will produce, instead
        # of racing two independent node/edge crossings (the r5 first cut
        # warmed (2n, e) and growth landed on (2n, 2e): 10 s inline).
        if cap_e < 2 * cap_n:
            cap_e = 2 * cap_n
            grew = True
        while cap_e < need_e:
            cap_e *= 2
            grew = True
        dense_live = node <= self._DENSE_MAX    # see _warm_graph_capacity
        if grew and self.enable_loop_closure:
            # solver/edge executables are capacity-keyed: make sure the
            # new capacity's compiles do NOT land inside the next closure
            # (ideally the 50% pre-warm below already finished them)
            self._ensure_capacity_warm(cap_n, cap_e, dense=dense_live)
        self.graph = pg.grow(self.graph, max_nodes=cap_n, max_edges=cap_e)
        self.max_graph_nodes = cap_n
        if self.enable_loop_closure and need_n > cap_n // 2:
            # 50% node occupancy: compile the NEXT doubling in the
            # background now, so the growth above finds it already warmed
            # instead of compiling on the path (the lead time is ~cap_n/2
            # keyframes of scans)
            self._prewarm_async(cap_n * 2, max(cap_e, 4 * cap_n),
                                dense=dense_live)

        # ONE jitted dispatch appends every new node + chain edge, not
        # one add_node/add_edge dispatch each (pg.add_nodes_chain).
        have_prev = self._last_kf_pose is not None
        self.graph = pg.add_nodes_chain(
            self.graph, new_q, new_p, count,
            prev_q=self._last_kf_pose[0] if have_prev else None,
            prev_p=self._last_kf_pose[1] if have_prev else None)
        self._edges_host += count - (0 if have_prev else 1)

        node_ids = list(range(node, node + count))
        for k, s in enumerate(new_slots):
            s = int(s)
            old_node = self._slot_node.get(s)
            if old_node is not None:
                self._node_slot.pop(old_node, None)    # slot evicted
            self._slot_node[s] = node_ids[k]
            self._node_slot[node_ids[k]] = s
        self._last_kf_pose = (new_q[-1].copy(), new_p[-1].copy())

        if self.archive is not None:
            with self.stages("archive_add"):
                self.archive.add_batch(node_ids, new_q, new_p,
                                       xyz_new, valid_new)
        if self.desc_store is not None:
            from noetic_slam_tpu.models.placedesc import ring_descriptor
            from noetic_slam_tpu.utils.geometry import quat_to_mat_np

            with self.stages("desc_add"):
                descs = []
                for k in range(count):
                    R = quat_to_mat_np(new_q[k])  # host: no device trip
                    local = (xyz_new[k] - new_p[k]) @ R
                    descs.append(ring_descriptor(local, valid_new[k]))
                self.desc_store.add_batch(node_ids, descs)
        self._synced_total = total
        return count

    def maybe_close_loop(self) -> bool:
        """Detect + verify + apply one loop closure for the latest
        keyframe. Two candidate sources, both feeding the same
        verification + drift-budget gates:

        1. pose PROXIMITY over the resident store (cheap; needs the
           estimate already within loop_radius of the truth);
        2. DESCRIPTOR matching over every keyframe ever created
           (models/placedesc; drift- and eviction-robust), with the
           matched yaw shift seeding the GICP verification guess.

        Returns True if a closure was applied."""
        if not self.enable_loop_closure:
            return False
        if self.pipelined:
            self.sync_pipelined()
        else:
            self.sync_graph()
        st = self.odometry.state
        if self._synced_total < self.loop_min_gap + 2:
            return False
        # All keyframe metadata comes from sync's host stash — the
        # detection path costs ZERO additional device round trips
        # (pg.detect_loop_candidate_np is the shared host form of the
        # jitted rule; parity pinned in tests/test_posegraph.py). Under
        # pipelined sync the stash is one cadence old; _attempt_closure's
        # device seq guards reject any candidate whose slot was evicted
        # inside that window.
        kh = self._kf_host
        if kh is None:
            return False    # no completed sync yet (first pipelined call)
        seq, kf_p_h = kh["seq"], kh["p"]
        cur = int(np.argmax(seq))
        if cur not in self._slot_node:
            return False            # not synced into the graph (yet)
        cur_node = self._slot_node[cur]

        # --- 1) descriptor query drain (full history, every keyframe) ---
        # EVERY not-yet-queried keyframe gets one descriptor query — in a
        # single batched dispatch (models/placedesc.match_store_batch), so
        # query cadence is no longer a host-round-trip tradeoff (the r3
        # design capped queries at the newest ~4 keyframes per attempt and
        # the km soak's drift reached 2.2 m before the lone descriptor
        # closure fired). The drain runs BEFORE the proximity attempt: a
        # healthy run closes most loops by proximity and an early return
        # would starve the descriptor match history — exactly the signal
        # needed when drift eventually breaks proximity (and the
        # recall/precision telemetry the soak calibrates thresholds on).
        matched = []
        if self.desc_store is not None:
            # 1) complete the query batch dispatched at the PREVIOUS
            # attempt (its async D2H copy overlapped the intervening
            # device work — a BLOCKING query fetch pays the drain of the
            # device queue, not the matmul)
            if self._pending_desc is not None:
                nodes_q, handle = self._pending_desc
                self._pending_desc = None
                with self.stages("desc_query"):
                    res = self.desc_store.query_batch_finish(handle)
                self._record_desc_results(nodes_q, res, matched)
            # 2) dispatch queries for the not-yet-queried backlog in
            # warmed-bucket-sized chunks (<= 64 per dispatch: an
            # unbounded batch would compile a fresh match_store_batch
            # variant AND materialize a (B, K, S) score intermediate of
            # gigabytes). Pipelined: only the newest chunk stays in
            # flight; older backlog chunks (resumed session, sparse
            # cadence) drain synchronously.
            start = self._last_desc_query_node + 1
            end = min(cur_node, self.desc_store.count - 1)
            chunks = [np.arange(c0, min(c0 + 63, end) + 1)
                      for c0 in range(start, end + 1, 64)]
            sync_chunks = chunks[:-1] if self.pipelined else chunks
            for nodes_q in sync_chunks:
                with self.stages("desc_query"):
                    res = self.desc_store.query_batch(
                        nodes_q, nodes_q - self.loop_min_gap)
                self._last_desc_query_node = int(nodes_q[-1])
                self._record_desc_results(nodes_q, res, matched)
            if self.pipelined and chunks:
                nodes_q = chunks[-1]
                with self.stages("desc_dispatch"):
                    handle = self.desc_store.query_batch_start(
                        nodes_q, nodes_q - self.loop_min_gap)
                self._pending_desc = (nodes_q, handle)
                self._last_desc_query_node = int(nodes_q[-1])

        # --- 2) proximity candidate (resident store). One retry after an
        # EXACT resync when the attempt lost its seq-guard race (stale
        # metadata + a busy evictor made ~30% of km-soak proximity
        # attempts race; the race is bookkeeping, not geometry, and
        # falling through to the heavier archived-descriptor path wasted
        # the cheap closure) ---
        for _retry in range(2):
            cand, prox_ok = pg.detect_loop_candidate_np(
                kf_p_h, seq, kh["count"], cur, self.loop_radius,
                self.loop_min_gap)
            if not (prox_ok and cand in self._slot_node):
                break
            if self._attempt_closure(
                    cur_node, self._slot_node[cand],
                    st.kf_xyz[cur], st.kf_valid[cur], st.kf_cov[cur],
                    kh["q"][cur], kf_p_h[cur],
                    st.kf_xyz[cand], st.kf_cov[cand],
                    kh["q"][cand], kf_p_h[cand],
                    guard_slots=((cur, int(seq[cur])),
                                 (cand, int(seq[cand])))):
                return True
            if not self._attempt_raced:
                break
            self.sync_graph()            # exact: refresh metadata + guards
            kh = self._kf_host
            seq, kf_p_h = kh["seq"], kh["p"]
            cur = int(np.argmax(seq))
            if cur not in self._slot_node:
                break
            cur_node = self._slot_node[cur]

        # --- 3) descriptor candidate attempts (two consecutive keyframes
        # matching the same historical place — a single-frame match in
        # self-similar environments is how aliases slip through: observed
        # in the tiny-soak room, where a first-lap alias closure passed
        # every local gate and tripled the ATE) ---
        if matched and self.pipelined:
            # Descriptor matches are ONE-SHOT (the drain moves past them):
            # a seq-guard race would silently discard a recovery closure —
            # the exact failure mode in the drift-soak bring-up, where all
            # 3 revisit matches raced on evicted slots and the run never
            # recovered. Re-establish exact metadata first (rare path:
            # temporally-consistent matches only appear at real revisits).
            self.sync_graph()
            kh = self._kf_host
        for n, cand, shift in matched:
            # BOTH sides may live in the archive by now (the resident
            # store evicts; a drift-scale revisit arrives many hundreds
            # of keyframes after the matched places were created)
            (cur_xyz2, cur_cov2, cur_q2, cur_p2, cur_valid2,
             cur_guard) = self._candidate_data(n)
            if cur_xyz2 is None:
                continue
            (cand_xyz, cand_cov, cand_q, cand_p, _cand_valid,
             cand_guard) = self._candidate_data(cand)
            if cand_xyz is None:
                continue
            guards = tuple(g for g in (cur_guard, cand_guard)
                           if g is not None)
            if self._attempt_descriptor_closure(
                    n, cand, shift,
                    cur_xyz2, cur_valid2, cur_cov2, cur_q2, cur_p2,
                    cand_xyz, cand_cov, cand_q, cand_p, guards,
                    cand_archived=cand_guard is None,
                    cur_archived=cur_guard is None):
                return True
        return False

    def _record_desc_results(self, nodes_q, res, matched) -> None:
        """Fold one completed query batch into the match history + the
        temporally-consistent candidate list. History records FIRST
        (consistency seeds must not be lost when an earlier query
        closes)."""
        cands, scores, shifts = res
        for k, n in enumerate(nodes_q):
            n, cand = int(n), int(cands[k])
            score, shift = float(scores[k]), int(shifts[k])
            self.desc_log.append({"node": n, "cand": cand,
                                  "score": round(score, 4)})
            if cand < 0 or score < self.desc_min_score:
                continue
            prev = self._desc_match_hist.get(n - 1)
            self._desc_match_hist[n] = (cand, shift)
            if prev is None or abs(cand - prev[0]) > 5:
                continue    # not yet temporally consistent
            matched.append((n, cand, shift))

    def _attempt_descriptor_closure(self, node, cand, shift,
                                    cur_xyz, cur_valid, cur_cov,
                                    cur_q, cur_p,
                                    cand_xyz, cand_cov, cand_q,
                                    cand_p, guard_slots=(),
                                    cand_archived: bool = False,
                                    cur_archived: bool = False) -> bool:
        """Seed GICP with the descriptor's yaw shift and run the common
        verification/gating: R_true = R_cand Rz(psi), psi = 2 pi shift/S
        (models/placedesc geometry). All-host math (make_se3_np): the
        guess construction runs at closure-candidate rate but each device
        fetch it used to make cost a full host round trip."""
        from noetic_slam_tpu.models.placedesc import N_SECTORS
        from noetic_slam_tpu.utils.geometry import make_se3_np

        psi = 2.0 * np.pi * shift / N_SECTORS
        if psi > np.pi:
            psi -= 2.0 * np.pi
        Rz = np.eye(4, dtype=np.float32)
        Rz[0, 0] = Rz[1, 1] = np.cos(psi)
        Rz[0, 1], Rz[1, 0] = -np.sin(psi), np.sin(psi)
        T_cand = make_se3_np(cand_q, cand_p)
        T_est = make_se3_np(cur_q, cur_p)
        guess = (T_cand @ Rz @ np.linalg.inv(T_est)).astype(np.float32)
        applied = self._attempt_closure(
            node, cand, cur_xyz, cur_valid, cur_cov, cur_q, cur_p,
            cand_xyz, cand_cov, cand_q, cand_p,
            guess=guess, source="descriptor", guard_slots=guard_slots,
            cand_archived=cand_archived, cur_archived=cur_archived)
        if applied:
            self.loop_closures_descriptor += 1
        return applied

    def _candidate_data(self, node: int):
        """Cloud + covariances + pose + validity + device seq guard of a
        graph node (either side of a closure): from the resident store
        when the slot is live (guard = (slot, expected seq) for
        _attempt_closure's race check), else dequantized from the archive
        (host data — no guard needed; covariances recomputed on device at
        closure rate). The archive path is what makes descriptor closures
        EVICTION-robust on both ends: at drift-soak scale the matched
        source keyframes are themselves already out of the resident
        store."""
        st = self.odometry.state
        slot = self._node_slot.get(node)
        if slot is not None:
            kh = self._kf_host
            return (st.kf_xyz[slot], st.kf_cov[slot],
                    kh["q"][slot], kh["p"][slot], st.kf_valid[slot],
                    (slot, int(kh["seq"][slot])))
        if self.archive is None or node not in self.archive.entries:
            return None, None, None, None, None, None
        from noetic_slam_tpu.ops import gicp as gicp_ops
        from noetic_slam_tpu.utils.geometry import quat_to_mat

        e = self.archive.entries[node]
        # EXACT (optimizer-current) pose, not the eps-lagged fuse pose:
        # the cloud is reconstructed at the same pose the closure math
        # uses, so the loop-edge measurement is consistent with the graph
        q_ex, p_ex = self.archive.pose_of(node)
        local = jnp.asarray(e.xyz_q).astype(jnp.float32) * jnp.float32(
            e.scale)
        world = local @ quat_to_mat(jnp.asarray(q_ex)).T + jnp.asarray(p_ex)
        valid = jnp.asarray(e.valid)
        world = jnp.where(valid[:, None], world, 1e6)   # mask padded rows
        cov, _ = gicp_ops.plane_covariances(world, valid,
                                            self.cfg.gicp.k_correspondences)
        return world, cov, q_ex, p_ex, valid, None

    def _attempt_closure(self, cur_node: int, cand_node: int,
                         cur_xyz, cur_valid, cur_cov, cur_q, cur_p,
                         cand_xyz, cand_cov, cand_q, cand_p,
                         guess=None, source: str = "proximity",
                         guard_slots=(), cand_archived: bool = False,
                         cur_archived: bool = False) -> bool:
        """Verify one candidate pair and, if it passes every gate, apply
        the closure (loop edge + optimize + map deformation). Source and
        candidate data both come from _candidate_data-style tuples, so
        either side may be resident-store device arrays OR
        archive-dequantized clouds (eviction-robust closures).

        ``guard_slots``: ((slot, expected_seq), ...) device-side seq
        guards folded into the verification verdict: under pipelined sync
        the detection metadata is one cadence old, and a guarded slot
        evicted inside that window makes the candidate's cloud/pose pair
        inconsistent — the attempt must read as rejected (counted in
        ``loop_raced``), not gamble on the GICP gates."""
        st = self.odometry.state
        vcfg = self._verify_cfg()
        with self.stages("closure_verify"):
            T_corr, accepted = pg.verify_loop(
                cur_xyz, cur_valid, cur_cov,
                cand_xyz, cand_cov, vcfg,
                max_corr_dist=2.0 * self.cfg.gicp.max_corr_dist,
                guess=guess)
            if guard_slots:
                # pad to 2 guards (repeat the first) so ONE executable
                # serves both the 1- and 2-guard shapes
                g = list(guard_slots) + [guard_slots[0]]
                slots = jnp.asarray([int(s) for s, _ in g[:2]], jnp.int32)
                expects = jnp.asarray([int(e) for _, e in g[:2]], jnp.int32)
                accepted, seq_ok = _guarded_verdict(
                    accepted, st.kf_seq, slots, expects)
            else:
                seq_ok = True
            # ONE fetch for the verdict + guard + correction; the rest of
            # the edge construction is host numpy (make_se3_np/...).
            accepted, seq_ok, Tc = jax.device_get(
                (accepted, seq_ok, T_corr))
        self._attempt_raced = not bool(seq_ok)
        if self._attempt_raced:
            self.loop_raced += 1
            return False
        if not bool(accepted):
            return False
        # Accepted: re-establish the EXACT sync invariant before mutating
        # graph/state. Under pipelined staleness, keyframes created since
        # the gather must enter the graph BEFORE optimize/deform —
        # otherwise the deformation would skip their slots and the next
        # drain would archive them at pre-closure poses. Closure
        # application is rare; this one blocking round trip is off the
        # steady-state path.
        self.sync_graph()

        # Corrected world pose of the current keyframe: T_corr moves its
        # cloud onto the candidate's map; the loop edge measures candidate ->
        # corrected-current.
        from noetic_slam_tpu.utils.geometry import make_se3_np, mat_to_quat_np

        kq_u, kp_u = np.asarray(cur_q), np.asarray(cur_p)
        T_fix = np.asarray(Tc) @ make_se3_np(kq_u, kp_u)
        q_fix, p_fix = mat_to_quat_np(T_fix[:3, :3]), T_fix[:3, 3]

        # Drift-budget gate (see __init__): correction magnitude vs the
        # path length accumulated between candidate and current keyframe
        # (summed along the graph's insertion-ordered node chain — slot
        # order stops being trajectory order once the store evicts).
        with self.stages("closure_budget_fetch"):
            node_p = jax.device_get(self.graph.node_p)
        lo, hi = min(cand_node, cur_node), max(cand_node, cur_node)
        path_len = float(np.sum(np.linalg.norm(
            np.diff(node_p[lo: hi + 1], axis=0), axis=-1)))
        budget = max(self.drift_budget_frac * path_len,
                     self.drift_budget_min)
        correction = float(np.linalg.norm(np.asarray(p_fix) - kp_u))
        if correction > budget:
            self.loop_rejected_budget += 1
            return False
        if correction < self.min_closure_correction:
            self.loop_skipped_small += 1     # verified but uninformative
            return False

        # Host-numpy relative measurement (quaternion sign is irrelevant:
        # so3_log_quat canonicalizes the hemisphere) + ONE jitted edge
        # append — the eager relative_pose/add_edge pair cost ~15 host
        # round trips at closure rate.
        T_rel = np.linalg.inv(make_se3_np(cand_q, cand_p)) @ T_fix
        dq = jnp.asarray(mat_to_quat_np(T_rel[:3, :3]), jnp.float32)
        dp = jnp.asarray(T_rel[:3, 3], jnp.float32)
        if self._edges_host + 1 > self.graph.edge_i.shape[0]:
            self.graph = pg.grow(self.graph,
                                 max_edges=2 * self.graph.edge_i.shape[0])
        with self.stages("closure_add_edge"):
            self.graph = _add_edge_jit(self.graph, jnp.int32(cand_node),
                                       jnp.int32(cur_node), dq, dp,
                                       w_rot=jnp.float32(2.0),
                                       w_trans=jnp.float32(2.0))
        self._edges_host += 1

        # Optimize and deform the map.
        import time as _time

        t0 = _time.perf_counter()
        with self.stages("closure_optimize"):
            # Solver by ACTUAL node count (_solver_variant, host mirror).
            # Large corrections run extra PASSES of the same compiled
            # 3-GN-step program (not a separate iters=10 variant, which
            # would pay a fresh compile exactly on the latency-critical
            # first topological correction).
            n_live = max(self._synced_total, 1)
            for _ in range(3 if correction > 0.5 else 1):
                self._optimize_graph(n_live)
        t1 = _time.perf_counter()
        moved = self._apply_graph_to_state()
        t2 = _time.perf_counter()
        if self.enable_tsdf and self.odometry.tsdf_state is not None:
            jax.block_until_ready(jax.tree.leaves(self.odometry.tsdf_state)[0])
        t3 = _time.perf_counter()
        self.closure_log.append({
            "source": source,
            # True when the candidate's/source's cloud came from the
            # ARCHIVE (its resident slot was evicted) — the
            # eviction-robustness case place recognition exists for
            # (models/placedesc docstring)
            "cand_archived": cand_archived,
            "cur_archived": cur_archived,
            "cand_node": int(cand_node), "cur_node": int(cur_node),
            "correction_m": round(correction, 4),
            "moved_keyframes": moved,
            "archived": 0 if self.archive is None else len(self.archive),
            "seconds": t3 - t0,
            "t_optimize": round(t1 - t0, 3),
            "t_apply": round(t2 - t1, 3),
            "t_map_sync": round(t3 - t2, 3)})
        self.loop_closures += 1
        return True

    def _apply_graph_to_state(self) -> int:
        """Write optimized keyframe poses back into the odometry state:
        re-transform keyframe clouds/covs, update the live pose by the last
        keyframe's correction, force a submap rebuild — one jitted dispatch
        (_deform_state). Returns the number of archived keyframes
        incrementally re-fused (0 without archive)."""
        st = self.odometry.state
        g = self.graph

        # Per-SLOT optimized poses: resident slots take their graph node's
        # pose; unmapped slots keep their current pose. ONE fetch (it also
        # forces the just-dispatched optimize to execute — staged so the
        # soak table attributes the solver's real cost).
        with self.stages("closure_fetch_poses"):
            node_q, node_p, new_q, new_p = jax.device_get(
                (g.node_q, g.node_p, st.kf_quat, st.kf_pos))
        new_q, new_p = np.array(new_q), np.array(new_p)
        for slot, node in self._slot_node.items():
            new_q[slot] = node_q[node]
            new_p[slot] = node_p[node]

        # The odometry-edge chain measures from the newest keyframe's pose;
        # keep it at the optimized value.
        if self._last_kf_pose is not None and self._slot_node:
            last_slot = max(self._slot_node,
                            key=lambda s: self._slot_node[s])
            self._last_kf_pose = (new_q[last_slot].copy(),
                                  new_p[last_slot].copy())

        with self.stages("closure_deform"):
            self.odometry.state = _deform_state(
                st, jnp.asarray(new_q), jnp.asarray(new_p))

        # Dense-map consistency: the volume was fused at pre-closure poses.
        moved = 0
        if self.enable_tsdf and self.odometry.tsdf_state is not None:
            if self.archive is not None:
                # Incremental archive correction: subtract/re-add ONLY the
                # keyframes whose optimized pose moved beyond the
                # map-resolution bound (O(moved), one jitted dispatch —
                # runtime/archive.py), over ALL keyframes ever created (the
                # resident store evicts; the archive does not). The live
                # volume then restarts from the corrected archive snapshot.
                with self.stages("archive_apply"):
                    moved = self.archive.apply_poses(
                        node_q, node_p, eps_t=self.archive_eps_t,
                        eps_r=self.archive_eps_r)
                with self.stages("archive_snapshot"):
                    self.odometry.tsdf_state = self.archive.snapshot_live()
            elif self.cfg.map_backend == "occupancy":
                from noetic_slam_tpu.models import occupancy as occ_mod

                st2 = self.odometry.state
                self.odometry.tsdf_state = occ_mod.rebuild_from_keyframes(
                    self.cfg.occupancy, st2.kf_xyz, st2.kf_valid,
                    st2.kf_pos, st2.kf_count)
            else:
                st2 = self.odometry.state
                self.odometry.tsdf_state = tsdf_mod.rebuild_from_keyframes(
                    self.cfg.tsdf, st2.kf_xyz, st2.kf_valid, st2.kf_pos,
                    st2.kf_count)
        # The host stash of keyframe metadata now holds PRE-closure poses
        # while the device clouds are post-closure: invalidate it so any
        # later read in the same pass fails loudly instead of silently
        # mixing frames (the next sync_graph re-fetches). A pending gather
        # would carry pre-closure poses too — drop it (the outbox ring
        # retains anything it had not yet drained; _attempt_closure's
        # fresh sync means it is empty here anyway).
        self._kf_host = None
        self._pending_sync = None
        return moved

    # --------------------------------------------------- checkpoint/resume
    def save(self, path: str) -> None:
        """Checkpoint the full system: odometry + TSDF + pose graph device
        pytrees AND the slot->node bookkeeping (without which a resumed
        session would re-sync keyframes into duplicate graph nodes)."""
        from noetic_slam_tpu.runtime import checkpoint as ck

        lkp = self._last_kf_pose
        extra_arrays = {}
        if self.archive is not None:
            extra_arrays.update({f"archive_{k}": v
                                 for k, v in self.archive.pack().items()})
        if self.desc_store is not None:
            extra_arrays.update({f"desc_{k}": v
                                 for k, v in self.desc_store.pack().items()})
        extra_arrays = extra_arrays or None
        ck.save_pipeline(
            path, self.odometry, self.tsdf, self.graph,
            extra_host={"slam": {
                "slot_node": {str(k): int(v)
                              for k, v in self._slot_node.items()},
                "synced_total": self._synced_total,
                "loop_closures": self.loop_closures,
                "loop_closures_descriptor": self.loop_closures_descriptor,
                "loop_rejected_budget": self.loop_rejected_budget,
                "loop_raced": self.loop_raced,
                "loop_skipped_small": self.loop_skipped_small,
                "sync_lost_keyframes": self.sync_lost_keyframes,
                "last_kf_pose": (None if lkp is None else
                                 [np.asarray(lkp[0]).tolist(),
                                  np.asarray(lkp[1]).tolist()]),
            }},
            extra_arrays=extra_arrays)

    def load(self, path: str) -> None:
        from noetic_slam_tpu.runtime import checkpoint as ck

        tsdf_state, graph = ck.load_pipeline(path, self.odometry)
        if tsdf_state is not None:
            self.odometry.tsdf_state = tsdf_state
        if graph is not None:
            self.graph = graph
        _, _, _, host = ck.load_checkpoint(path)
        s = host.get("slam", {})
        self._slot_node = {int(k): int(v)
                           for k, v in s.get("slot_node", {}).items()}
        self._synced_total = int(s.get("synced_total", 0))
        self.loop_closures = int(s.get("loop_closures", 0))
        self.loop_closures_descriptor = int(
            s.get("loop_closures_descriptor", 0))
        self.loop_rejected_budget = int(s.get("loop_rejected_budget", 0))
        self.loop_raced = int(s.get("loop_raced", 0))
        self.loop_skipped_small = int(s.get("loop_skipped_small", 0))
        self.sync_lost_keyframes = int(s.get("sync_lost_keyframes", 0))
        lkp = s.get("last_kf_pose")
        self._last_kf_pose = (None if lkp is None else
                              (np.asarray(lkp[0]), np.asarray(lkp[1])))
        self._kf_host = None          # pre-load stash (reused instance)
        self._pending_sync = None
        if self.archive is not None or self.desc_store is not None:
            extra = ck.load_extra_arrays(path)
            if self.archive is not None:
                self.archive.unpack({k[len("archive_"):]: v
                                     for k, v in extra.items()
                                     if k.startswith("archive_")})
            if self.desc_store is not None:
                self.desc_store.unpack({k[len("desc_"):]: v
                                        for k, v in extra.items()
                                        if k.startswith("desc_")})
        self._node_slot = {v: k for k, v in self._slot_node.items()}
        # Resume does NOT re-query history: the pre-checkpoint nodes were
        # already queried (re-querying would duplicate desc_log telemetry
        # and re-attempt already-applied closures).
        self._last_desc_query_node = (
            self.desc_store.count - 1 if self.desc_store is not None
            else -1)
        self._desc_match_hist = {}
        self._pending_desc = None
        # Resumed graphs may exceed this instance's initial capacity.
        if graph is not None:
            self.max_graph_nodes = self.graph.node_q.shape[0]

    # ----------------------------------------------------- IMU-rate pose
    def enable_pose_extrapolation(self) -> None:
        """Turn on host-side IMU-rate pose output (runtime/poseext.py —
        the reference's 100 Hz publishPose role, odom.cc:315-488). Each
        sync drain re-seeds the extrapolator with the fused snapshot
        already riding the gather; ``pose_at(t)`` then serves queries
        between scans from the buffered IMU samples with zero device
        traffic."""
        from noetic_slam_tpu.runtime.poseext import PoseExtrapolator

        self.extrapolator = PoseExtrapolator(self.cfg, self.odometry)

    def pose_at(self, t: float):
        """(q wxyz, p) extrapolated to absolute time ``t`` (None before
        the first synced keyframe batch). Requires
        enable_pose_extrapolation()."""
        if self.extrapolator is None:
            return None
        return self.extrapolator.pose_at(t)

    # ------------------------------------------------------------- results
    def flush(self):
        return self.odometry.flush()

    def surface_points(self, min_weight: float = 1.0) -> np.ndarray:
        """Extract the dense map's surface/occupied point cloud (host
        array): TSDF zero-crossing voxels, or occupied voxels when the
        occupancy backend is selected."""
        if self.tsdf is None:
            return np.zeros((0, 3), np.float32)
        if self.cfg.map_backend == "occupancy":
            from noetic_slam_tpu.models import occupancy as occ_mod

            centers, _, mask = occ_mod.extract_occupied(
                self.cfg.occupancy, self.tsdf)
        else:
            centers, _, mask = tsdf_mod.extract_surface(
                self.cfg.tsdf, self.tsdf, min_weight=min_weight)
        centers, mask = jax.device_get((centers, mask))
        return centers[mask]

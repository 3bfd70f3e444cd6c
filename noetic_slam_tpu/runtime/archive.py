"""Host-side keyframe archive + incrementally corrected dense-map volume.

Long-run correctness component (no single reference counterpart; it fills
the contract gap between two reference behaviors):

- the reference's dense-map recorder accumulates EVERY deskewed cloud for
  the whole run, unbounded (src/dliomapping/dliomapping.cpp:41-99), and its
  keyframe store never evicts (src/dlio/src/dlio/odom.cc:1517-1598);
- the device odometry state is fixed-capacity by design (CapacityConfig), so
  the device keyframe store DOES evict on km-scale runs.

Without an archive, a loop closure late in a long run could only re-fuse
the dense map from the <=K resident keyframes — erasing all evicted
geometry. This module keeps every keyframe ever created on the HOST
(quantized int16 local-frame clouds, ~48 KB per 8k-point keyframe) and
maintains an "archive volume": an UNCLAMPED dense-map state that always
equals the sum of every archived keyframe's contribution at its
current-best pose.

Because the unclamped payload is a pure linear sum (models/tsdf.NO_CLAMP,
occupancy l_min/l_max at +-1e30) and sample generation is deterministic,
fusing with sign=-1 exactly removes a prior sign=+1 contribution. A
pose-graph correction therefore costs O(keyframes whose pose moved) —
subtract at the old pose, re-add at the optimized pose — instead of a full
O(all keyframes ever) rebuild, and voxels in regions no moved keyframe
touches are left BIT-IDENTICAL (untouched payload rows are never read or
written).

Transport discipline (the round-4 redesign): every fuse — adds at sync
time, subtract/re-add pairs at closure time, checkpoint replay — goes
through ONE jitted chunked-``lax.scan`` program (``_fuse_scan``) that
processes ``_CHUNK_KF`` keyframes per scan step with a per-entry sign.
The previous design dispatched one jitted program per keyframe (TWO per
moved keyframe at closure), one host round trip each, which at km scale
(~1,400 moved keyframes) made a closure cost seconds. Batch counts are
padded to power-of-two chunk counts so at most log2(max-batch) program
variants ever compile.

``snapshot_live`` converts the archive volume into a fresh live-map state
(clamp applied once at conversion — algebraically identical to the
reference-class clamped weighted mean at keyframe granularity), which
SlamSystem installs as the post-closure dense map.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Dict, Iterator

import jax
import jax.numpy as jnp
import numpy as np

from noetic_slam_tpu.config.params import OccupancyConfig, TsdfConfig
from noetic_slam_tpu.models import occupancy as occ_mod
from noetic_slam_tpu.models import tsdf as tsdf_mod
from noetic_slam_tpu.utils.geometry import quat_to_mat

_QMAX = 32766.0
_CHUNK_KF = 4     # keyframes fused per lax.scan step (sample stream per
                  # step = _CHUNK_KF * N * samples_per_point)


@dataclasses.dataclass
class ArchiveEntry:
    """One keyframe, local-frame quantized (int16 at adaptive per-keyframe
    scale: worst case ~4 mm at 130 m — under LiDAR noise), plus the pose at
    which it is currently fused into the archive volume."""
    q: np.ndarray          # (4,) f32 wxyz — fused-at pose
    p: np.ndarray          # (3,) f32
    xyz_q: np.ndarray      # (N, 3) int16 local-frame
    scale: float
    valid: np.ndarray      # (N,) bool


@partial(jax.jit, donate_argnums=(1,), static_argnames=("cfg", "backend"))
def _fuse_entry(cfg, vol, xyz_q, scale, valid, q, p, sign,
                backend: str = "tsdf"):
    """Single-keyframe fuse (kept for tests/golden references; the live
    system routes everything through ``_fuse_scan``)."""
    local = xyz_q.astype(jnp.float32) * scale
    R = quat_to_mat(q)
    world = jnp.dot(local, R.T,
                    precision=jax.lax.Precision.HIGHEST) + p
    if backend == "occupancy":
        return occ_mod.integrate_signed(cfg, vol, world, valid, p, sign)
    return tsdf_mod.integrate_signed(cfg, vol, world, valid, p, sign)


@partial(jax.jit, donate_argnums=(1,), static_argnames=("cfg", "backend"))
def _fuse_scan(cfg, vol, xyz_q, scale, valid, q, p, sign,
               backend: str = "tsdf"):
    """Fuse B keyframe contributions in ONE jitted dispatch.

    ``xyz_q (B, N, 3) int16`` local-frame clouds, ``sign (B,)`` in
    {+1, -1, 0} (0 = padding no-op: zero weights map every sample to the
    drop key, so padded entries never touch the payload). B must be a
    multiple of ``_CHUNK_KF``; a ``lax.scan`` walks chunk by chunk with the
    volume as carry.

    Exact-cancellation contract: the per-entry sample stream depends only
    on (xyz_q, scale, valid, q, p) — computed per vmap lane, independent of
    chunk position — so a later sign=-1 fuse of identical inputs scatters
    the bitwise negation of the original sign=+1 stream. Per-voxel sums
    cancel to re-association noise (~1 ulp of accumulated mass); rows no
    entry touches are never read or written.
    """
    B = xyz_q.shape[0]
    nch = B // _CHUNK_KF
    resh = lambda a: a.reshape((nch, _CHUNK_KF) + a.shape[1:])

    def body(vol, chunk):
        xq, sc, vv, qq, pp, sg = chunk
        local = xq.astype(jnp.float32) * sc[:, None, None]
        R = quat_to_mat(qq)                                  # (CH, 3, 3)
        # HIGHEST: a reduced-precision matmul (TF32) quantizes far
        # coordinates to centimeters (see deskew.transform_cloud note)
        world = jnp.einsum("cnj,cij->cni", local, R,
                           precision=jax.lax.Precision.HIGHEST
                           ) + pp[:, None, :]
        if backend == "occupancy":
            pos, delta = jax.vmap(
                lambda w, v, o: occ_mod._beam_samples(cfg, w, v, o))(
                    world, vv, pp)
            delta = delta * sg[:, None]
            vol = occ_mod._integrate_deltas(
                cfg, vol, pos.reshape(-1, 3), delta.reshape(-1))
        else:
            pos, sdf, w = jax.vmap(
                lambda wd, v, o: tsdf_mod._ray_samples(cfg, wd, v, o))(
                    world, vv, pp)
            w = w * sg[:, None]
            vol = tsdf_mod._integrate_samples(
                cfg, vol, pos.reshape(-1, 3), sdf.reshape(-1),
                w.reshape(-1))
        return vol, None

    vol, _ = jax.lax.scan(
        body, vol, (resh(xyz_q), resh(scale), resh(valid), resh(q),
                    resh(p), resh(sign)))
    return vol


@partial(jax.jit, static_argnames=("acfg", "lcfg"))
def _snapshot_tsdf(acfg: TsdfConfig, lcfg: TsdfConfig,
                   vol: tsdf_mod.TsdfState) -> tsdf_mod.TsdfState:
    """Archive volume -> fresh live TsdfState: apply the live config's
    max_weight clamp once (exact clamped-weighted-mean at keyframe
    granularity — see tsdf._integrate_samples docstring) and copy every
    leaf (the live state is donated per scan; no aliasing allowed)."""
    w = jnp.maximum(vol.weight, 0.0)        # signed-cancel residuals ~ -1ulp
    clamped = jnp.minimum(w, lcfg.max_weight)
    wsum = jnp.where(w > 1e-12, vol.wsum * (clamped / jnp.maximum(w, 1e-12)),
                     0.0)
    return tsdf_mod.TsdfState(
        dir_keys=vol.dir_keys + 0, dir_slots=vol.dir_slots + 0,
        num_blocks=vol.num_blocks + 0, wsum=wsum, weight=clamped,
        dropped=vol.dropped + 0)


@partial(jax.jit, static_argnames=("acfg", "lcfg"))
def _snapshot_occ(acfg: OccupancyConfig, lcfg: OccupancyConfig,
                  vol: occ_mod.OccupancyState) -> occ_mod.OccupancyState:
    return occ_mod.OccupancyState(
        dir_keys=vol.dir_keys + 0, dir_slots=vol.dir_slots + 0,
        num_blocks=vol.num_blocks + 0,
        logodds=jnp.clip(vol.logodds, lcfg.l_min, lcfg.l_max),
        dropped=vol.dropped + 0)


class _EntriesView:
    """Dict-like view of the archive's stacked host storage (keyed by graph
    node id). Kept so callers/tests can address entries individually while
    the storage itself stays stacked for batched device dispatch."""

    def __init__(self, ar: "KeyframeArchive"):
        self._ar = ar

    def __len__(self) -> int:
        return len(self._ar._idx)

    def __contains__(self, node) -> bool:
        return int(node) in self._ar._idx

    def __iter__(self) -> Iterator[int]:
        return iter(self._ar._idx)

    def keys(self):
        return self._ar._idx.keys()

    def items(self):
        for node in self._ar._idx:
            yield node, self[node]

    def __getitem__(self, node) -> ArchiveEntry:
        # COPIES for every field: a uniform aliasing contract. Mutating a
        # returned entry never touches the stacked storage (the old
        # mixed view/copy form let e.xyz_q writes silently corrupt the
        # archive while e.q writes silently vanished); persistent writes
        # go through __setitem__.
        i = self._ar._idx[int(node)]
        return ArchiveEntry(
            q=self._ar._q[i].copy(), p=self._ar._p[i].copy(),
            xyz_q=self._ar._xyz[i].copy(), scale=float(self._ar._scale[i]),
            valid=self._ar._valid[i].copy())

    def __setitem__(self, node, e: ArchiveEntry) -> None:
        self._ar._set_entry(int(node), e)


class KeyframeArchive:
    def __init__(self, map_cfg, backend: str = "tsdf"):
        self.backend = backend
        self.live_cfg = map_cfg
        if backend == "occupancy":
            self.cfg = dataclasses.replace(map_cfg, l_min=-1e30, l_max=1e30)
            self.volume = occ_mod.init_occupancy(self.cfg)
        else:
            self.cfg = dataclasses.replace(map_cfg,
                                           max_weight=tsdf_mod.NO_CLAMP)
            self.volume = tsdf_mod.init_tsdf(self.cfg)
        # Stacked host storage (insertion-ordered; _idx maps node -> row).
        # _q/_p are the FUSE-time poses (the signed-subtract on a later
        # move must replay the exact pose each cloud was fused at);
        # _q_exact/_p_exact mirror the graph's CURRENT optimized pose for
        # every entry, updated on every apply_poses regardless of the
        # re-fusion eps — closure math against archived entries must use
        # these (the <=eps fuse-pose lag, compounded over a hundred
        # archived-candidate closures, warped the r5 km soak's ATE from
        # 0.06 m to 1.8 m).
        self._idx: Dict[int, int] = {}
        self._q = np.zeros((0, 4), np.float32)
        self._p = np.zeros((0, 3), np.float32)
        self._q_exact = np.zeros((0, 4), np.float32)
        self._p_exact = np.zeros((0, 3), np.float32)
        self._xyz = np.zeros((0, 0, 3), np.int16)
        self._scale = np.zeros((0,), np.float32)
        self._valid = np.zeros((0, 0), bool)
        self._n = 0

    def __len__(self) -> int:
        return self._n

    @property
    def entries(self) -> _EntriesView:
        return _EntriesView(self)

    # ------------------------------------------------------------ storage
    def _ensure(self, extra: int, n_pts: int) -> None:
        cap = self._q.shape[0]
        need = self._n + extra
        if self._xyz.shape[1] == 0 and n_pts:
            self._xyz = np.zeros((cap, n_pts, 3), np.int16)
            self._valid = np.zeros((cap, n_pts), bool)
        if need <= cap:
            return
        new_cap = max(64, cap)
        while new_cap < need:
            new_cap *= 2
        grow = lambda a, fill=0: np.concatenate(
            [a, np.full((new_cap - cap,) + a.shape[1:], fill, a.dtype)])
        self._q, self._p = grow(self._q), grow(self._p)
        self._q_exact, self._p_exact = grow(self._q_exact), \
            grow(self._p_exact)
        self._xyz, self._scale = grow(self._xyz), grow(self._scale)
        self._valid = grow(self._valid, False)

    def _set_entry(self, node: int, e: ArchiveEntry) -> None:
        i = self._idx.get(node)
        if i is None:
            self._ensure(1, e.xyz_q.shape[0])
            i = self._n
            self._idx[node] = i
            self._n += 1
        self._q[i] = np.asarray(e.q, np.float32)
        self._p[i] = np.asarray(e.p, np.float32)
        self._q_exact[i] = np.asarray(e.q, np.float32)
        self._p_exact[i] = np.asarray(e.p, np.float32)
        self._xyz[i] = np.asarray(e.xyz_q, np.int16)
        self._scale[i] = float(e.scale)
        self._valid[i] = np.asarray(e.valid, bool)

    def pose_of(self, node: int):
        """(q, p) copies of the entry's EXACT (optimizer-current) pose —
        what closure math must use; entries[node].q/.p are the fuse-time
        poses, which lag the graph by up to the apply_poses eps."""
        i = self._idx[int(node)]
        return self._q_exact[i].copy(), self._p_exact[i].copy()

    # ------------------------------------------------------------- ingest
    def add(self, node: int, q, p, xyz_world, valid) -> None:
        """Archive one keyframe; prefer ``add_batch`` (one dispatch for the
        whole sync batch)."""
        self.add_batch([int(node)], np.asarray(q, np.float32)[None],
                       np.asarray(p, np.float32)[None],
                       np.asarray(xyz_world, np.float32)[None],
                       np.asarray(valid, bool)[None])

    def add_batch(self, nodes, qs, ps, xyz_world, valid) -> None:
        """Archive B keyframes (clouds given world-frame at poses (q, p))
        and fuse them into the archive volume in ONE jitted dispatch."""
        from noetic_slam_tpu.utils.geometry import quat_to_mat_np

        B = len(nodes)
        if B == 0:
            return
        qs = np.asarray(qs, np.float32)
        ps = np.asarray(ps, np.float32)
        valid = np.asarray(valid, bool)
        xyz_world = np.asarray(xyz_world, np.float32)
        self._ensure(B, xyz_world.shape[1])
        rows = np.zeros((B,), np.int64)
        for k, node in enumerate(nodes):
            node = int(node)
            i = self._idx.get(node)
            if i is None:
                i = self._n
                self._idx[node] = i
                self._n += 1
            rows[k] = i
            R = quat_to_mat_np(qs[k])     # host: no per-keyframe device trip
            local = (xyz_world[k] - ps[k]) @ R
            local = np.where(valid[k][:, None], local, 0.0).astype(np.float32)
            amax = float(np.abs(local).max()) if local.size else 0.0
            scale = max(amax / _QMAX, 1e-4)
            self._xyz[i] = np.clip(np.round(local / scale), -_QMAX, _QMAX
                                   ).astype(np.int16)
            self._scale[i] = scale
            self._q[i], self._p[i], self._valid[i] = qs[k], ps[k], valid[k]
            self._q_exact[i], self._p_exact[i] = qs[k], ps[k]
        self._dispatch_fuse(rows, self._q[rows], self._p[rows],
                            np.ones((B,), np.float32))

    # ------------------------------------------------------- pose updates
    def apply_poses(self, node_q: np.ndarray, node_p: np.ndarray,
                    eps_t: float | None = None,
                    eps_r: float | None = None) -> int:
        """Move archived keyframes to their optimized graph poses:
        subtract each moved entry's contribution at its old pose and re-add
        at the new one — ONE jitted dispatch for the whole move set.
        Returns the number of keyframes re-fused (the incremental closure
        cost driver recorded by the soak harness).

        Map-resolution thresholds (the defaults): a keyframe whose pose
        error is below eps_t = voxel/4 in translation and eps_r =
        voxel/(4*max_range) in rotation displaces every one of its fused
        samples by at most eps_t + range*eps_r <= voxel/2 — under the
        volume's own spatial quantization — so skipping its re-fusion
        perturbs the reconstructed surface by less than half a voxel while
        cutting the moved set sharply (tighter thresholds made "moved"
        equal "all history" at km-scale drift corrections)."""
        if eps_t is None:
            eps_t = 0.25 * self.cfg.voxel_size
        if eps_r is None:
            eps_r = 0.25 * self.cfg.voxel_size / max(self.cfg.max_range, 1.0)
        if self._n == 0:
            return 0
        nodes = np.fromiter(self._idx.keys(), np.int64, len(self._idx))
        rows = np.fromiter(self._idx.values(), np.int64, len(self._idx))
        keep = nodes < len(node_p)
        nodes, rows = nodes[keep], rows[keep]
        nq = np.asarray(node_q, np.float32)[nodes]
        npos = np.asarray(node_p, np.float32)[nodes]
        # exact-pose mirror: EVERY entry tracks the optimizer's current
        # estimate (closure math reads pose_of); only the fuse decision
        # below is eps-gated
        self._q_exact[rows] = nq
        self._p_exact[rows] = npos
        dt = np.linalg.norm(npos - self._p[rows], axis=-1)
        # angle via |<q1,q2>|: 1 - |dot| ~ theta^2/8 for small theta
        dots = np.abs(np.sum(nq * self._q[rows], axis=-1))
        dr = 2.0 * np.arccos(np.clip(dots, 0.0, 1.0))
        moved_m = (dt > eps_t) | (dr > eps_r)
        rows_m = rows[moved_m]
        if len(rows_m) == 0:
            return 0
        # subtract at old poses, re-add at new — one interleaved batch
        self._dispatch_fuse(
            np.concatenate([rows_m, rows_m]),
            np.concatenate([self._q[rows_m], nq[moved_m]]),
            np.concatenate([self._p[rows_m], npos[moved_m]]),
            np.concatenate([np.full(len(rows_m), -1.0, np.float32),
                            np.full(len(rows_m), 1.0, np.float32)]))
        self._q[rows_m] = nq[moved_m]
        self._p[rows_m] = npos[moved_m]
        return int(len(rows_m))

    # Fixed fuse bucket sizes (entries per dispatch). _fuse_scan costs
    # seconds to compile; an arbitrary power-of-two padding scheme
    # compiled a fresh variant per closure size. Three
    # fixed buckets cap the compile count at 3 per backend — warm-up can
    # pre-compile all of them (warmup()) — and large move sets decompose
    # into repeated largest-bucket dispatches plus a tail.
    _BUCKETS = (2 * _CHUNK_KF, 16 * _CHUNK_KF, 64 * _CHUNK_KF)

    def _dispatch_fuse(self, rows: np.ndarray, qs: np.ndarray,
                       ps: np.ndarray, signs: np.ndarray) -> None:
        """Run the fuse program over the batch in fixed-size bucket
        dispatches (largest bucket repeatedly, then one tail bucket)."""
        B = len(rows)
        big = self._BUCKETS[-1]
        off = 0
        while off < B:
            take = min(B - off, big)
            m = next(b for b in self._BUCKETS if b >= take)
            sl = slice(off, off + take)
            pad = m - take
            r, q, p, s = rows[sl], qs[sl], ps[sl], signs[sl]
            if pad:
                r = np.concatenate([r, np.zeros((pad,), rows.dtype)])
                q = np.concatenate(
                    [q, np.tile(np.asarray([1, 0, 0, 0], np.float32),
                                (pad, 1))])
                p = np.concatenate([p, np.zeros((pad, 3), np.float32)])
                s = np.concatenate([s, np.zeros((pad,), np.float32)])
            self.volume = _fuse_scan(
                self.cfg, self.volume, jnp.asarray(self._xyz[r]),
                jnp.asarray(self._scale[r]), jnp.asarray(self._valid[r]),
                jnp.asarray(q), jnp.asarray(p), jnp.asarray(s),
                backend=self.backend)
            off += take

    def warmup(self, n_pts: int | None = None) -> None:
        """Pre-compile every fuse bucket with sign=0 no-op entries (zero
        weights map all samples to the drop key: the volume is untouched).
        A real-time run pays the compile cost up front instead of
        inside the first closure. ``n_pts`` (points per keyframe cloud,
        e.g. capacity.max_ds_points) is required before the first add."""
        n = self._xyz.shape[1] or n_pts
        if not n:
            return
        ident = jnp.tile(jnp.asarray([1.0, 0, 0, 0], jnp.float32),
                         (self._BUCKETS[-1], 1))
        zeros3 = jnp.zeros((self._BUCKETS[-1], 3), jnp.float32)
        for b in self._BUCKETS:
            self.volume = _fuse_scan(
                self.cfg, self.volume, jnp.zeros((b, n, 3), jnp.int16),
                jnp.full((b,), 1e-4, jnp.float32),
                jnp.zeros((b, n), bool), ident[:b], zeros3[:b],
                jnp.zeros((b,), jnp.float32), backend=self.backend)

    # ------------------------------------------------------------ outputs
    def snapshot_live(self):
        """Fresh live-map state (clamped per the live config, all leaves
        copied — safe against per-scan donation)."""
        if self.backend == "occupancy":
            return _snapshot_occ(self.cfg, self.live_cfg, self.volume)
        return _snapshot_tsdf(self.cfg, self.live_cfg, self.volume)

    # -------------------------------------------------------- persistence
    def pack(self) -> dict:
        """Stacked host arrays for checkpointing (runtime/checkpoint.py)."""
        if self._n == 0:
            return {}
        nodes = np.asarray(sorted(self._idx), np.int32)
        rows = np.asarray([self._idx[int(n)] for n in nodes], np.int64)
        return {
            "nodes": nodes,
            "q": self._q[rows].copy(),
            "p": self._p[rows].copy(),
            "q_exact": self._q_exact[rows].copy(),
            "p_exact": self._p_exact[rows].copy(),
            "xyz_q": self._xyz[rows].copy(),
            "scale": self._scale[rows].copy(),
            "valid": self._valid[rows].copy(),
        }

    def unpack(self, data: dict) -> None:
        """Restore entries AND replay them into a fresh archive volume in
        ONE chunked dispatch (deterministic: same inputs, same jitted
        program as every original add)."""
        if self.backend == "occupancy":
            self.volume = occ_mod.init_occupancy(self.cfg)
        else:
            self.volume = tsdf_mod.init_tsdf(self.cfg)
        self._idx = {}
        self._n = 0
        self._q = np.zeros((0, 4), np.float32)
        self._p = np.zeros((0, 3), np.float32)
        self._xyz = np.zeros((0, 0, 3), np.int16)
        self._scale = np.zeros((0,), np.float32)
        self._valid = np.zeros((0, 0), bool)
        if not data or "nodes" not in data:
            return
        nodes = np.asarray(data["nodes"])
        B = len(nodes)
        self._ensure(B, np.asarray(data["xyz_q"]).shape[1])
        for i, node in enumerate(nodes):
            self._idx[int(node)] = i
        self._q[:B] = np.asarray(data["q"], np.float32)
        self._p[:B] = np.asarray(data["p"], np.float32)
        # pre-exact-mirror checkpoints fall back to the fuse poses
        self._q_exact[:B] = np.asarray(data.get("q_exact", data["q"]),
                                       np.float32)
        self._p_exact[:B] = np.asarray(data.get("p_exact", data["p"]),
                                       np.float32)
        self._xyz[:B] = np.asarray(data["xyz_q"], np.int16)
        self._scale[:B] = np.asarray(data["scale"], np.float32)
        self._valid[:B] = np.asarray(data["valid"], bool)
        self._n = B
        rows = np.arange(B, dtype=np.int64)
        self._dispatch_fuse(rows, self._q[:B], self._p[:B],
                            np.ones((B,), np.float32))

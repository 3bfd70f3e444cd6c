"""Rotation-invariant place-recognition descriptors (scan-context class).

New capability beyond the reference (its checkout has no loop closure at
all; our proximity detector — posegraph.detect_loop_candidate — needs the
pose estimate to already be within ``loop_radius`` of the truth, which
fails exactly when closures matter most: large drift, or revisits whose
keyframes the bounded resident store has evicted). Descriptors are
computed once per keyframe and matched against EVERY keyframe ever
created (the host archive, runtime/archive.py), so place recognition
survives both drift and eviction.

Design, for the accelerator:

- Descriptor: an (R rings x S sectors) polar grid over the keyframe's
  LOCAL-frame cloud, each cell holding the max point height (the
  scan-context statistic — height profiles are what LiDAR scenes keep
  under viewpoint change). Gravity alignment comes free: keyframe frames
  are gravity-aligned by the odometry observer.
- Matching: a yaw offset between two visits of one place circularly
  shifts the sector axis. After L2-normalizing each sector column, the
  standard scan-context distance (mean over sectors of per-column cosine)
  collapses to a PLAIN DOT PRODUCT of the flattened grids — so scoring a
  query against K stored descriptors under ALL S candidate yaw shifts is
  ONE einsum: (S, R*S) rolled-query stack x (K, R*S) store -> (K, S)
  scores as one einsum, max over shifts, argmax over store. No loops, no
  gathers, one matmul of a few million MACs.
- The store is a device array with doubling capacity (same growth pattern
  as posegraph.grow); new rows upload incrementally at keyframe rate.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

Array = jax.Array

N_RINGS = 20
N_SECTORS = 60


def ring_descriptor(xyz: np.ndarray, valid: np.ndarray,
                    max_range: float = 40.0,
                    n_rings: int = N_RINGS,
                    n_sectors: int = N_SECTORS) -> np.ndarray:
    """(R, S) max-height polar grid of one LOCAL-frame keyframe cloud
    (host numpy — runs once per keyframe at archive time)."""
    pts = np.asarray(xyz, np.float32)[np.asarray(valid, bool)]
    if len(pts) == 0:
        return np.zeros((n_rings, n_sectors), np.float32)
    r = np.linalg.norm(pts[:, :2], axis=-1)
    keep = (r > 0.3) & (r < max_range)
    pts, r = pts[keep], r[keep]
    if len(pts) == 0:
        return np.zeros((n_rings, n_sectors), np.float32)
    ring = np.minimum((r / max_range * n_rings).astype(np.int64),
                      n_rings - 1)
    sector = ((np.arctan2(pts[:, 1], pts[:, 0]) + np.pi)
              / (2 * np.pi) * n_sectors).astype(np.int64) % n_sectors
    desc = np.zeros((n_rings, n_sectors), np.float32)
    np.maximum.at(desc, (ring, sector), pts[:, 2])
    return desc


def _normalize_columns(d: Array) -> Array:
    """L2-normalize each sector column; all-empty columns -> 0 (they then
    contribute nothing to the cosine sum, like scan-context's column
    skipping)."""
    n = jnp.linalg.norm(d, axis=-2, keepdims=True)
    return jnp.where(n > 1e-6, d / jnp.maximum(n, 1e-6), 0.0)


def _match_store_impl(query: Array, store: Array, count: Array,
                      exclude_from: Array):
    """Best-matching stored descriptor for ``query`` under all yaw shifts.

    query: (R, S); store: (K, R, S) (rows < count valid); nodes with id >=
    exclude_from are ignored (recent keyframes — trivial self-matches).
    Returns (best_node, best_score, best_shift) where score in [0, 1] is
    the mean per-sector cosine at the best circular shift.
    """
    R, S = query.shape
    qn = _normalize_columns(query)
    rolled = jnp.stack([jnp.roll(qn, j, axis=-1) for j in range(S)])
    sn = _normalize_columns(store)
    # occupied-column count per pair bounds the achievable sum; normalize
    # by the QUERY's occupied columns so empty store rows can't score high
    q_cols = jnp.sum(jnp.any(query > 1e-6, axis=-2))
    scores = jnp.einsum("jrs,krs->kj", rolled.reshape(S, R, S), sn,
                        precision=jax.lax.Precision.HIGHEST)
    scores = scores / jnp.maximum(q_cols.astype(jnp.float32), 1.0)
    best_shift = jnp.argmax(scores, axis=-1)                   # (K,)
    best_k = jnp.max(scores, axis=-1)                          # (K,)
    ids = jnp.arange(store.shape[0])
    eligible = (ids < count) & (ids < exclude_from)
    best_k = jnp.where(eligible, best_k, -1.0)
    node = jnp.argmax(best_k)
    return node, best_k[node], best_shift[node]


match_store = jax.jit(_match_store_impl)


@jax.jit
def match_store_batch(queries: Array, store: Array, count: Array,
                      exclude_froms: Array):
    """Batched ``match_store``: score B queries against the store in ONE
    dispatch (vmap over the per-query rolled-einsum). Returns ONE packed
    (B, 3) f32 array [node, score, shift] (node/shift are small ints,
    exact in f32) so the host needs a single
    fetch; per-query device calls cost a host round trip each and at
    keyframe rate over a km run that dominated the descriptor path."""
    node, score, shift = jax.vmap(
        lambda q, e: _match_store_impl(q, store, count, e))(
            queries, exclude_froms)
    return jnp.stack([node.astype(jnp.float32), score,
                      shift.astype(jnp.float32)], axis=-1)


class DescriptorStore:
    """Host+device store of per-keyframe descriptors with doubling
    capacity; matching runs on device against the full history."""

    def __init__(self, cap: int = 4096):
        # 4096 x (20 x 60) f32 = 20 MB — pre-allocating km-scale capacity
        # is cheaper than the match_store_batch recompile each device-side
        # capacity doubling would cost mid-run (store shape is part of the
        # jit cache key); doubling growth remains for longer runs.
        self._host = np.zeros((cap, N_RINGS, N_SECTORS), np.float32)
        self._dev = jnp.asarray(self._host)
        self._pending: list = []      # host rows written since last upload
        self.count = 0

    def add(self, node: int, desc: np.ndarray) -> None:
        """Record one descriptor (host write; the device copy uploads
        lazily — one stacked row upload per query batch instead of one
        dispatch per keyframe)."""
        cap = self._host.shape[0]
        if node >= cap:
            while cap <= node:
                cap *= 2
            grown = np.zeros((cap, N_RINGS, N_SECTORS), np.float32)
            grown[: self._host.shape[0]] = self._host
            self._host = grown
            self._dev = None          # capacity changed: full re-upload
        self._host[node] = desc
        self._pending.append(node)
        self.count = max(self.count, node + 1)

    def add_batch(self, nodes, descs) -> None:
        for node, d in zip(nodes, descs):
            self.add(int(node), d)

    def _sync_dev(self) -> None:
        if self._dev is None:
            self._dev = jnp.asarray(self._host)
            self._pending = []
        elif self._pending:
            # power-of-two row-count bucket (pad by repeating the last
            # index — .set is idempotent) so the scatter executable
            # compiles once per bucket, not once per pending count
            idx = np.asarray(sorted(set(self._pending)), np.int32)
            m = 1 << (len(idx) - 1).bit_length()
            idx = np.concatenate(
                [idx, np.full((m - len(idx),), idx[-1], np.int32)])
            self._dev = self._dev.at[jnp.asarray(idx)].set(
                jnp.asarray(self._host[idx]))
            self._pending = []

    def query(self, desc: np.ndarray, min_gap: int = 0,
              exclude_from: int | None = None):
        """(node, score, shift) of the best historical match. Eligible
        nodes are ids < ``exclude_from`` (callers matching an OLDER
        keyframe n pass n - gap); default = count - min_gap (exclude the
        newest min_gap entries)."""
        if exclude_from is None:
            exclude_from = self.count - min_gap
        if exclude_from <= 0 or self.count == 0:
            return -1, 0.0, 0
        self._sync_dev()
        node, score, shift = match_store(
            jnp.asarray(desc), self._dev, jnp.int32(self.count),
            jnp.int32(exclude_from))
        return int(node), float(score), int(shift)

    def query_batch_start(self, node_ids, exclude_froms):
        """Dispatch the batched match and start its async D2H copy —
        non-blocking. Returns an opaque pending handle for
        ``query_batch_finish`` (consumed an attempt later by the
        pipelined closure path: a BLOCKING query fetch pays the drain of
        the device queue, not the matmul).

        The batch is padded to a power-of-two bucket with floor 4
        (padding rows query with exclude_from 0 — never eligible) so only
        the warmed program variants ever run; an unpadded design
        recompiled match_store_batch on nearly every call (seconds each),
        and m=1/2 buckets would compile outside the warmed set."""
        B = len(node_ids)
        if B == 0 or self.count == 0:
            return (None, B, None)
        self._sync_dev()
        m = max(4, 1 << (B - 1).bit_length())
        ids = np.zeros((m,), np.int64)
        ids[:B] = np.asarray(node_ids, np.int64)
        exc = np.zeros((m,), np.int64)
        exc[:B] = np.asarray(exclude_froms, np.int64)
        dev = match_store_batch(
            jnp.asarray(self._host[ids]), self._dev,
            jnp.int32(self.count), jnp.asarray(np.maximum(exc, 0),
                                               np.int32))
        try:
            dev.copy_to_host_async()
        except AttributeError:
            pass
        return (dev, B, exc)

    @staticmethod
    def query_batch_finish(pending):
        """Complete a ``query_batch_start`` handle: host arrays
        (cands, scores, shifts), one row per query; queries whose
        exclude_from <= 0 return cand -1."""
        dev, B, exc = pending
        if dev is None:
            return (np.full(B, -1, np.int64), np.zeros(B, np.float32),
                    np.zeros(B, np.int64))
        packed = np.asarray(jax.device_get(dev))
        cands = np.where(exc[:B] > 0,
                         packed[:B, 0].astype(np.int64), -1)
        return (cands, packed[:B, 1].astype(np.float32),
                packed[:B, 2].astype(np.int64))

    def query_batch(self, node_ids, exclude_froms):
        """Match the stored descriptors of ``node_ids`` against the full
        history in ONE dispatch + ONE (blocking) fetch."""
        return self.query_batch_finish(
            self.query_batch_start(node_ids, exclude_froms))

    # ------------------------------------------------------- persistence
    def pack(self) -> dict:
        return {"desc": self._host[: self.count].copy()}

    def unpack(self, data: dict) -> None:
        d = np.asarray(data.get("desc", np.zeros((0, N_RINGS, N_SECTORS),
                                                 np.float32)), np.float32)
        cap = 256
        while cap < max(len(d), 1):
            cap *= 2
        self._host = np.zeros((cap, N_RINGS, N_SECTORS), np.float32)
        self._host[: len(d)] = d
        self._dev = jnp.asarray(self._host)
        self._pending = []
        self.count = len(d)

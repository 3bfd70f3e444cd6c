"""Occupancy-grid map backend (Octomap class) in JAX.

The reference README describes a ``tsdf_map`` node selecting between CHAD
TSDF / Octomap / Voxblox / VDBFusion backends (reference README.md:20-47,
``MAP_BACKEND_IDX``; the package is absent from the checkout — SURVEY.md
§0). models/tsdf.py covers the TSDF class; this module is the
occupancy-grid alternative, consuming the same world-frame deskewed cloud
stream (src/dliomapping/dliomapping.cpp:44).

Octomap's behavior, re-expressed for an accelerator (no octree — pointer
trees are hostile to SIMD/XLA; spatial hierarchy is replaced by the same
block-hashed sorted directory as the TSDF backend, models/tsdf.py):

- per-voxel log-odds L, updated additively: endpoint voxels get ``l_hit``
  (> 0), ray free-space samples get ``l_miss`` (< 0) — the standard
  inverse sensor model;
- clamping update policy: L is clamped to [l_min, l_max] (Octomap's
  clamping thresholds, which bound confidence and enable map dynamics).
  The clamp is applied at SCAN granularity (a batched integrate), not per
  beam — identical when a voxel's per-scan delta has one sign, which is
  the overwhelming case (a voxel is a hit or on free rays, rarely both in
  one scan);
- occupancy probability p = 1 - 1/(1 + exp(L)); occupied iff L > 0
  (p > 0.5) by default.

Integration structure mirrors tsdf._integrate_samples: ONE block-major
payload-carrying sort -> contiguous per-block runs -> sorted-directory
merge join for allocation -> scatter-add of the log-odds deltas + clamp.
All static shapes; per-scan distinct-block capacity = scan_block_cap.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from noetic_slam_tpu.config.params import OccupancyConfig
from noetic_slam_tpu.models.tsdf import (
    BLOCK_VOLUME,
    _KEY_PAD,
    _block_key,
    _lookup_join,
    voxel_centers,
)

Array = jax.Array


class OccupancyState(NamedTuple):
    dir_keys: Array    # (C,) int32 sorted block keys (pad = INT32_MAX)
    dir_slots: Array   # (C,) int32 payload slot per key
    num_blocks: Array  # () int32
    logodds: Array     # (C, 512) f32 clamped log-odds
    dropped: Array     # () int32 samples dropped due to capacity


def init_occupancy(cfg: OccupancyConfig) -> OccupancyState:
    C = cfg.max_blocks
    return OccupancyState(
        dir_keys=jnp.full((C,), _KEY_PAD, jnp.int32),
        dir_slots=jnp.zeros((C,), jnp.int32),
        num_blocks=jnp.int32(0),
        logodds=jnp.zeros((C, BLOCK_VOLUME), jnp.float32),
        dropped=jnp.int32(0),
    )


def _beam_samples(cfg: OccupancyConfig, points: Array, valid: Array,
                  origin: Array):
    """(pos, delta) sample stream of one scan: the endpoint hit plus
    ``miss_samples`` free-space samples strictly inside the beam."""
    d = points - origin
    r = jnp.linalg.norm(d, axis=-1, keepdims=True)
    ok = valid & (r[:, 0] > 0.3) & (r[:, 0] < cfg.max_range)
    u = d / jnp.maximum(r, 1e-6)

    hit_pos = points[:, None, :]
    hit_delta = jnp.full((points.shape[0], 1), cfg.l_hit) * ok[:, None]

    S = cfg.miss_samples
    frac = (jnp.arange(S) + 0.5) / S
    # stop one voxel short of the endpoint so misses never cancel the hit
    miss_r = frac[None, :] * jnp.maximum(r - cfg.voxel_size, 0.0)
    miss_pos = origin + u[:, None, :] * miss_r[:, :, None]
    miss_delta = jnp.full((points.shape[0], S), cfg.l_miss) * ok[:, None]

    pos = jnp.concatenate([hit_pos, miss_pos], axis=1).reshape(-1, 3)
    delta = jnp.concatenate([hit_delta, miss_delta], axis=1).reshape(-1)
    return pos, delta


def _integrate_deltas(cfg: OccupancyConfig, state: OccupancyState,
                      pos: Array, delta: Array) -> OccupancyState:
    """Fuse one batch of (position, log-odds delta) samples — the same
    sort/runs/join skeleton as tsdf._integrate_samples with an additive
    clamped payload (see module docstring): scatter-add of the deltas, then
    the full clamp (idempotent on untouched rows)."""
    C = state.logodds.shape[0]
    S = pos.shape[0]
    vx = jnp.floor(pos / cfg.voxel_size).astype(jnp.int32)
    b = vx >> 3
    intra = vx - (b << 3)
    gk = _block_key(b)
    gk = jnp.where(delta != 0.0, gk, _KEY_PAD)
    ivox = intra[:, 0] + (intra[:, 1] << 3) + (intra[:, 2] << 6)

    # block-major sort carrying (intra voxel, delta)
    gk_s, iv_s, dl_s = jax.lax.sort((gk, ivox, delta), num_keys=1)

    A = cfg.scan_block_cap
    first_blk = jnp.concatenate(
        [jnp.ones((1,), bool), gk_s[1:] != gk_s[:-1]]) & (gk_s != _KEY_PAD)
    blk_rank = jnp.cumsum(first_blk.astype(jnp.int32)) - 1
    n_runs = blk_rank[-1] + 1
    pos_key = jnp.where(first_blk, blk_rank, jnp.int32(S))
    _, pos_sorted = jax.lax.sort(
        (pos_key, jnp.arange(S, dtype=jnp.int32)), num_keys=1)
    k_take = min(A + 1, S)
    pos_arr = jnp.full((A + 1,), S, jnp.int32).at[:k_take].set(
        pos_sorted[:k_take])
    pos_arr = jnp.where(jnp.arange(A + 1) < n_runs, pos_arr, S)
    rank_overflow = jnp.maximum(n_runs - A, 0)

    # candidate keys + sample ranges ([start, start+cnt) in the sorted
    # stream; pad_start = first padded sample)
    cand_pos = pos_arr[:A]
    cand = jnp.where(cand_pos < S, gk_s[jnp.clip(cand_pos, 0, S - 1)],
                     _KEY_PAD)
    pad_start = jnp.sum(gk_s != _KEY_PAD).astype(jnp.int32)
    start = jnp.minimum(cand_pos, pad_start)
    cnt = jnp.clip(jnp.minimum(pos_arr[1:], pad_start) - start, 0, S)

    # directory probe + merge of new blocks
    slot_probe = _lookup_join(state.dir_keys, state.dir_slots, cand)
    hit = slot_probe >= 0
    is_new = (~hit) & (cand != _KEY_PAD)
    n_new = jnp.sum(is_new)
    new_rank = jnp.cumsum(is_new.astype(jnp.int32)) - 1
    slot_new = state.num_blocks + new_rank
    ok_new = is_new & (slot_new < C)
    keys2, slots2 = jax.lax.sort(
        (jnp.concatenate([state.dir_keys,
                          jnp.where(ok_new, cand, _KEY_PAD)]),
         jnp.concatenate([state.dir_slots,
                          jnp.where(ok_new, slot_new, 0)])), num_keys=1)
    keys2, slots2 = keys2[:C], slots2[:C]
    num2 = jnp.minimum(state.num_blocks + n_new, C).astype(jnp.int32)
    dropped2 = (state.dropped + rank_overflow
                + (n_new - (num2 - state.num_blocks)))
    slot_cand = jnp.where(hit, slot_probe,
                          jnp.where(ok_new, slot_new, -1))

    # scatter-add the deltas, then the scan-granularity clamp
    sample_slot = jnp.where(
        (gk_s != _KEY_PAD) & (blk_rank < A),
        slot_cand[jnp.clip(blk_rank, 0, A - 1)], -1)
    total = C * BLOCK_VOLUME
    addr = jnp.where(sample_slot >= 0,
                     sample_slot * BLOCK_VOLUME + iv_s, total)
    lo = state.logodds.reshape(-1).at[addr].add(dl_s, mode="drop")
    lo = jnp.clip(lo, cfg.l_min, cfg.l_max)
    return state._replace(dir_keys=keys2, dir_slots=slots2,
                          num_blocks=num2, dropped=dropped2,
                          logodds=lo.reshape(C, BLOCK_VOLUME))


@partial(jax.jit, static_argnames=("cfg",), donate_argnums=(1,))
def integrate(cfg: OccupancyConfig, state: OccupancyState, points: Array,
              valid: Array, origin: Array) -> OccupancyState:
    """Fuse one world-frame registered cloud into the occupancy map."""
    pos, delta = _beam_samples(cfg, points, valid, origin)
    return _integrate_deltas(cfg, state, pos, delta)


@partial(jax.jit, static_argnames=("cfg",), donate_argnums=(1,))
def integrate_signed(cfg: OccupancyConfig, state: OccupancyState,
                     points: Array, valid: Array, origin: Array,
                     sign: Array) -> OccupancyState:
    """Fuse (sign=+1) or exactly de-fuse (sign=-1) one cloud — the
    keyframe-archive volume primitive (runtime/archive.py; TSDF counterpart
    tsdf.integrate_signed). Exact inversion requires an unclamped config
    (``l_min``/``l_max`` at ±1e30: jnp.clip with huge bounds is the
    identity, and unlike the TSDF renorm it is division-free); occupancy
    probability consumers clamp at read time instead."""
    pos, delta = _beam_samples(cfg, points, valid, origin)
    return _integrate_deltas(cfg, state, pos, delta * sign)


@partial(jax.jit, static_argnames=("cfg",))
def rebuild_from_keyframes(cfg: OccupancyConfig, kf_xyz: Array,
                           kf_valid: Array, kf_pos: Array,
                           kf_count: Array) -> OccupancyState:
    """Loop-closure consistency: re-fuse from the deformed keyframe clouds
    (same contract as tsdf.rebuild_from_keyframes)."""
    state = init_occupancy(cfg)

    def body(st, inp):
        xyz, valid, origin, idx = inp
        pos, delta = _beam_samples(cfg, xyz, valid, origin)
        delta = delta * (idx < kf_count).astype(delta.dtype)
        return _integrate_deltas(cfg, st, pos, delta), None

    K = kf_xyz.shape[0]
    state, _ = jax.lax.scan(
        body, state,
        (kf_xyz, kf_valid, kf_pos, jnp.arange(K, dtype=jnp.int32)))
    return state


def occupancy_prob(state: OccupancyState) -> Array:
    """Per-voxel occupancy probability (C, 512)."""
    return 1.0 - 1.0 / (1.0 + jnp.exp(state.logodds))


@partial(jax.jit, static_argnames=("cfg",))
def extract_occupied(cfg: OccupancyConfig, state: OccupancyState):
    """(centers (C*512, 3), logodds, mask of occupied voxels) — the host
    compacts, mirroring tsdf.extract_surface's contract."""
    centers = voxel_centers(cfg, state).reshape(-1, 3)
    L = state.logodds.reshape(-1)
    slot_used = jnp.zeros((state.logodds.shape[0],), bool).at[
        jnp.where(state.dir_keys != _KEY_PAD, state.dir_slots,
                  state.logodds.shape[0])].set(True, mode="drop")
    mask = ((L > cfg.occ_thresh)
            & jnp.repeat(slot_used, BLOCK_VOLUME))
    return centers, L, mask

"""Block-hashed TSDF fusion backend (CHAD / Voxblox class) in JAX.

The reference repo's README describes a ``tsdf_map`` node with CHAD TSDF /
Octomap / Voxblox / VDBFusion backends (reference README.md:20-47) but the
package is absent from the checkout (SURVEY.md §0); only its data contract is
visible: it consumed the world-frame deskewed cloud stream
(src/dliomapping/dliomapping.cpp:44). This module implements that component
from the published behavior of such systems — projective TSDF integration
into a block-hashed voxel grid — re-designed for an accelerator:

- **No pointer hash table.** Blocks live in a *sorted directory*
  (keys (C,), payload slots (C,)); insertion is a concat + sort + unique
  merge of the (small) directory. Payload arrays stay in fixed slots, so
  inserting blocks never moves voxel data.
- **One payload-carrying sort per scan.** All per-sample work hangs off a
  single ``lax.sort((block_key, intra_voxel, w, w*sdf), num_keys=1)``: the
  sorted order yields the unique-block list (allocation) and contiguous
  per-block sample ranges, and replaces a join-heavy design of several
  sorts plus random gathers over the ~750k-sample stream.
- **Sum-form payload.** Voxels store (Σw·d, Σw) rather than (mean d, w):
  fusing a scan is then two scatter-ADDs with no gather of old state. The
  reference-class clamped weighted average is recovered EXACTLY by the
  per-scan renormalisation pass (clamp Σw at max_weight and rescale Σw·d):
  d = Σwd/Σw equals the incremental clamped-mean recursion at scan
  granularity (algebraically identical, see integrate()).
- **Static shapes everywhere**: N points x S samples per scan; unique-block
  capacity per scan is fixed (cfg.scan_block_cap); overflow drops (counted).

Geometry: voxel size ``v`` (cfg.tsdf.voxel_size), blocks of 8^3 voxels,
block key packs block coords into int32 (11+11+10 bits -> +-819 m in x/y,
+-409 m in z at 0.8 m blocks). Weighted-average updates with clamped
projective SDF, Voxblox-style constant weight with linear behind-surface
taper, optional free-space carving samples.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from noetic_slam_tpu.config.params import TsdfConfig

Array = jax.Array

BLOCK = 8                      # voxels per block edge
BLOCK_VOLUME = BLOCK ** 3
_KEY_PAD = jnp.iinfo(jnp.int32).max
# max_weight at/above this disables the clamp+renorm entirely: the payload
# is then a pure linear sum, which integrate_signed can exactly invert
# (the keyframe-archive volume runs in this mode — runtime/archive.py).
NO_CLAMP = 1e30


class TsdfState(NamedTuple):
    dir_keys: Array    # (C,) int32 sorted block keys (pad = INT32_MAX)
    dir_slots: Array   # (C,) int32 payload slot per key
    num_blocks: Array  # () int32
    wsum: Array        # (C, 512) f32 Σ w·d (weighted-distance sum) [m]
    weight: Array      # (C, 512) f32 Σ w, clamped at cfg.max_weight
    dropped: Array     # () int32 samples dropped due to capacity


def init_tsdf(cfg: TsdfConfig) -> TsdfState:
    C = cfg.max_blocks
    return TsdfState(
        dir_keys=jnp.full((C,), _KEY_PAD, jnp.int32),
        dir_slots=jnp.zeros((C,), jnp.int32),
        num_blocks=jnp.int32(0),
        wsum=jnp.zeros((C, BLOCK_VOLUME), jnp.float32),
        weight=jnp.zeros((C, BLOCK_VOLUME), jnp.float32),
        dropped=jnp.int32(0),
    )


def tsdf_distance(cfg: TsdfConfig, state: TsdfState) -> Array:
    """Per-voxel signed distance (C, 512): Σwd/Σw; unobserved -> +trunc."""
    return jnp.where(state.weight > 0.0,
                     state.wsum / jnp.maximum(state.weight, 1e-12),
                     cfg.truncation)


def _block_key(b: Array) -> Array:
    """(…,3) int32 block coords -> packed int32 key (invalid -> _KEY_PAD)."""
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
    ok = ((bx >= -1024) & (bx < 1024) & (by >= -1024) & (by < 1024)
          & (bz >= -512) & (bz < 512))
    key = ((bz + 512) << 22) | ((by + 1024) << 11) | (bx + 1024)
    return jnp.where(ok, key, _KEY_PAD)


def _lookup(state: TsdfState, keys: Array) -> Array:
    """Sorted-directory lookup: key -> payload slot (or -1).

    Small query batches: binary search. Large batches dispatch to the
    sort-merge join, which replaces ~750k serial per-query binary searches
    with sorts.
    """
    if keys.size > 16384:
        return _lookup_join(state.dir_keys, state.dir_slots, keys)
    pos = jnp.searchsorted(state.dir_keys, keys)
    pos = jnp.clip(pos, 0, state.dir_keys.shape[0] - 1)
    hit = state.dir_keys[pos] == keys
    return jnp.where(hit & (keys != _KEY_PAD), state.dir_slots[pos], -1)


def _lookup_join(ref_keys: Array, ref_vals: Array, q_keys: Array) -> Array:
    """Batch key lookup by sorted merge: argsort the concatenation (ref rows
    first, stable), forward-propagate the last ref row's value with an
    associative cummax, and read results back through the inverse
    permutation — scatter-free, all radix sorts + gathers.
    """
    C = ref_keys.shape[0]
    Q = q_keys.shape[0]
    keys_all = jnp.concatenate([ref_keys, q_keys])
    order = jnp.argsort(keys_all, stable=True)       # ref-before-query ties
    k_s = keys_all[order]
    is_ref = order < C
    idx = jnp.arange(C + Q, dtype=jnp.int32)
    last_ref_pos = jax.lax.associative_scan(
        jnp.maximum, jnp.where(is_ref, idx, -1))
    lrp = jnp.clip(last_ref_pos, 0, C + Q - 1)
    hit = (last_ref_pos >= 0) & (k_s[lrp] == k_s) & (k_s != _KEY_PAD)
    val_sorted = jnp.where(hit, ref_vals[jnp.clip(order[lrp], 0, C - 1)], -1)
    inv = jnp.argsort(order, stable=True)            # inverse permutation
    return val_sorted[inv][C:]


def allocate_blocks(state: TsdfState, want_keys: Array) -> TsdfState:
    """Insert any unseen keys into the directory (sorted merge).

    ``want_keys`` (A,) may contain duplicates/_KEY_PAD. New blocks receive
    payload slots from the running counter; allocation beyond capacity is
    dropped (counted in ``dropped``).
    """
    C = state.dir_keys.shape[0]
    # Dedupe requested keys.
    wk = jnp.sort(want_keys)
    first = jnp.concatenate([jnp.ones((1,), bool), wk[1:] != wk[:-1]])
    wk = jnp.where(first, wk, _KEY_PAD)
    # Drop keys already present.
    present = _lookup(state, wk) >= 0
    wk = jnp.where(present, _KEY_PAD, wk)
    wk = jnp.sort(wk)
    n_new = jnp.sum(wk != _KEY_PAD)

    # Assign slots; beyond capacity -> drop.
    rank = jnp.cumsum((wk != _KEY_PAD).astype(jnp.int32)) - 1
    slot = state.num_blocks + rank
    ok = (wk != _KEY_PAD) & (slot < C)
    wk = jnp.where(ok, wk, _KEY_PAD)
    slot = jnp.where(ok, slot, 0)

    keys = jnp.concatenate([state.dir_keys, wk])
    slots = jnp.concatenate([state.dir_slots, slot])
    order = jnp.argsort(keys)
    keys, slots = keys[order][:C], slots[order][:C]
    num = jnp.minimum(state.num_blocks + n_new, C)
    return state._replace(dir_keys=keys, dir_slots=slots,
                          num_blocks=num.astype(jnp.int32),
                          dropped=state.dropped + (n_new - (num - state.num_blocks)))


def _ray_samples(cfg: TsdfConfig, points: Array, valid: Array, origin: Array):
    """Sample positions + SDF values + weights along each ray.

    Surface band: samples at voxel-size spacing within [-trunc, +trunc]
    around the hit. Optional carving: sparse free-space samples between the
    origin and the truncation band (sdf = +trunc, low weight).
    Returns (pos (N*S,3), sdf (N*S,), w (N*S,)).
    """
    d = points - origin
    r = jnp.linalg.norm(d, axis=-1, keepdims=True)
    ok = valid & (r[:, 0] > 0.3) & (r[:, 0] < cfg.max_range)
    u = d / jnp.maximum(r, 1e-6)

    n_band = max(int(round(2.0 * cfg.truncation / cfg.voxel_size)) + 1, 3)
    offs = jnp.linspace(-cfg.truncation, cfg.truncation, n_band)
    band_pos = points[:, None, :] + u[:, None, :] * offs[None, :, None]
    band_sdf = jnp.broadcast_to(-offs[None, :], (points.shape[0], n_band))
    # Behind-surface linear taper (Voxblox simple weight drop-off).
    band_w = jnp.where(band_sdf < 0.0,
                       1.0 + band_sdf / cfg.truncation, 1.0)
    band_w = jnp.maximum(band_w, 0.05) * ok[:, None]

    pos, sdf, w = band_pos, band_sdf, band_w
    if cfg.space_carving and cfg.carving_samples > 0:
        S = cfg.carving_samples
        frac = (jnp.arange(S) + 0.5) / S
        carve_r = frac[None, :] * jnp.maximum(r - cfg.truncation, 0.0)
        carve_pos = origin + u[:, None, :] * carve_r[:, :, None]
        carve_sdf = jnp.full((points.shape[0], S), cfg.truncation)
        carve_w = jnp.full((points.shape[0], S), 0.1) * ok[:, None]
        pos = jnp.concatenate([pos, carve_pos], axis=1)
        sdf = jnp.concatenate([sdf, carve_sdf], axis=1)
        w = jnp.concatenate([w, carve_w], axis=1)
    return (pos.reshape(-1, 3), sdf.reshape(-1), w.reshape(-1))


def _integrate_samples(cfg: TsdfConfig, state: TsdfState, pos: Array,
                       sdf: Array, w: Array) -> TsdfState:
    """Fuse one batch of ray samples.

    Structure (every step is a cheap primitive, no random gathers from the
    payload):

    1. ONE ``lax.sort`` keyed (block_key, intra_voxel) carrying (w, w·d) —
       every touched block's samples become one contiguous range.
    2. A second (position) sort compacts the run-start offsets; unique
       blocks + their sample ranges come from gathers at those offsets.
       Sorted-directory probe (merge join) + merge allocates unseen blocks
       (carve samples allocate too — matches Voxblox's clearing behavior).
    3. Payload update: scatter-adds into the sum-form payload (atomic adds
       on the GPU, so per-voxel sums re-associate from run to run), then
       the exact full-payload clamp.

    The sum-form payload (Σw·d, Σw with clamp-rescale) EXACTLY reproduces
    the clamped-weighted-mean recursion:
    d' = (min(W,maxW)·d + Σ_scan w·d)/(min(W,maxW) + Σ_scan w).
    """
    C = state.weight.shape[0]
    S = pos.shape[0]
    vx = jnp.floor(pos / cfg.voxel_size).astype(jnp.int32)
    b = vx >> 3                       # block coords (floor divide by 8)
    intra = vx - (b << 3)             # 0..7 each axis
    gk = _block_key(b)
    # != 0 (not > 0): signed integration (integrate_signed with sign=-1,
    # the archive-volume de-fusion path) carries negative weights.
    gk = jnp.where(w != 0.0, gk, _KEY_PAD)
    ivox = intra[:, 0] + (intra[:, 1] << 3) + (intra[:, 2] << 6)
    sdf_c = jnp.clip(sdf, -cfg.truncation, cfg.truncation)

    # 1. block-major sort carrying the accumulands. Intra-block voxel order
    # is irrelevant to the scatter-add, so ivox rides as payload, not as a
    # second key. lax.sort is a fixed comparator network:
    # deterministic for identical inputs even with equal keys.
    gk_s, iv_s, w_s, ws_s = jax.lax.sort(
        (gk, ivox, w, w * sdf_c), num_keys=1)

    # 2a. run boundaries; run-start positions compacted by a position sort
    # (cheaper than a 753k-update scatter-set or 753k-query searchsorted —
    # see scripts/profile_tsdf.py measurements).
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

    # 2b. candidate keys + sample ranges. pad_start = first padded sample.
    cand_pos = pos_arr[:A]
    cand = jnp.where(cand_pos < S, gk_s[jnp.clip(cand_pos, 0, S - 1)],
                     _KEY_PAD)
    pad_start = jnp.sum(gk_s != _KEY_PAD).astype(jnp.int32)
    start = jnp.minimum(cand_pos, pad_start)
    cnt = jnp.clip(jnp.minimum(pos_arr[1:], pad_start) - start, 0, S)

    # 2c. directory probe (sort-merge join) + merge of new rows.
    slot_probe = _lookup_join(state.dir_keys, state.dir_slots, cand)
    hit = slot_probe >= 0
    is_new = (~hit) & (cand != _KEY_PAD)
    n_new = jnp.sum(is_new)
    new_rank = jnp.cumsum(is_new.astype(jnp.int32)) - 1
    slot_new = state.num_blocks + new_rank
    ok_new = is_new & (slot_new < C)

    add_keys = jnp.where(ok_new, cand, _KEY_PAD)
    add_slots = jnp.where(ok_new, slot_new, 0)
    keys2, slots2 = jax.lax.sort(
        (jnp.concatenate([state.dir_keys, add_keys]),
         jnp.concatenate([state.dir_slots, add_slots])), num_keys=1)
    keys2, slots2 = keys2[:C], slots2[:C]
    num2 = jnp.minimum(state.num_blocks + n_new, C).astype(jnp.int32)
    dropped2 = (state.dropped + rank_overflow
                + (n_new - (num2 - state.num_blocks)))

    slot_cand = jnp.where(hit, slot_probe,
                          jnp.where(ok_new, slot_new, -1))

    # 3. payload update: per-sample slot routing, scatter-adds, full clamp.
    sample_slot = jnp.where(
        (gk_s != _KEY_PAD) & (blk_rank < A),
        slot_cand[jnp.clip(blk_rank, 0, A - 1)], -1)
    total = C * BLOCK_VOLUME
    addr = jnp.where(sample_slot >= 0,
                     sample_slot * BLOCK_VOLUME + iv_s, total)
    wsum_flat = state.wsum.reshape(-1).at[addr].add(ws_s, mode="drop")
    weight_flat = state.weight.reshape(-1).at[addr].add(w_s, mode="drop")

    if cfg.max_weight >= NO_CLAMP:
        # Unclamped (archive-volume) variant: the payload stays a pure sum,
        # so subtracting a contribution (integrate_signed sign=-1) exactly
        # undoes adding it. The renorm below would blow up on the tiny
        # negative residuals exact cancellation can leave (w/1e-12).
        return state._replace(
            dir_keys=keys2, dir_slots=slots2, num_blocks=num2,
            dropped=dropped2, wsum=wsum_flat.reshape(C, BLOCK_VOLUME),
            weight=weight_flat.reshape(C, BLOCK_VOLUME))

    clamped = jnp.minimum(weight_flat, cfg.max_weight)
    wsum_flat = wsum_flat * (clamped / jnp.maximum(weight_flat, 1e-12))
    return state._replace(
        dir_keys=keys2, dir_slots=slots2, num_blocks=num2, dropped=dropped2,
        wsum=wsum_flat.reshape(C, BLOCK_VOLUME),
        weight=clamped.reshape(C, BLOCK_VOLUME))


@partial(jax.jit, static_argnames=("cfg",), donate_argnums=(1,))
def integrate(cfg: TsdfConfig, state: TsdfState, points: Array,
              valid: Array, origin: Array) -> TsdfState:
    """Fuse one world-frame (deskewed, registered) cloud into the TSDF.

    The consumer role of the absent tsdf_map node: integrate the stream that
    dliomapping.cpp:44 subscribed to. Single straight-line pass built around
    one payload-carrying sort + two scatter-adds (see _integrate_samples).
    """
    pos, sdf, w = _ray_samples(cfg, points, valid, origin)
    return _integrate_samples(cfg, state, pos, sdf, w)


@partial(jax.jit, static_argnames=("cfg",), donate_argnums=(1,))
def integrate_signed(cfg: TsdfConfig, state: TsdfState, points: Array,
                     valid: Array, origin: Array, sign: Array) -> TsdfState:
    """Fuse (sign=+1) or EXACTLY de-fuse (sign=-1) one cloud.

    The keyframe-archive volume primitive (runtime/archive.py): with
    ``cfg.max_weight >= NO_CLAMP`` the payload is a pure (Σw·d, Σw) sum, and
    because sample generation is deterministic for identical (points, valid,
    origin), integrating with sign=-1 scatters the bitwise negation of what
    sign=+1 scattered — per-voxel sums cancel to ~1 ulp of the accumulated
    mass (re-association noise only; voxels with a single contribution
    cancel exactly). This makes post-loop-closure map correction O(moved
    keyframes) instead of O(all keyframes): subtract the moved keyframe at
    its old pose, re-add at its optimized pose; every payload row no moved
    keyframe touches is never read or written — bit-identical.
    """
    pos, sdf, w = _ray_samples(cfg, points, valid, origin)
    return _integrate_samples(cfg, state, pos, sdf, w * sign)


@partial(jax.jit, static_argnames=("cfg",))
def rebuild_from_keyframes(cfg: TsdfConfig, kf_xyz: Array, kf_valid: Array,
                           kf_pos: Array, kf_count: Array) -> TsdfState:
    """Re-fuse the whole TSDF from the (deformed) keyframe clouds.

    The loop-closure consistency mechanism: ``integrate`` fuses each scan at
    its pose *at integration time*, so a later pose-graph correction leaves
    already-fused geometry at pre-closure poses (a permanently smeared map
    — the failure mode of any integrate-then-optimize pipeline). After a
    closure deforms the keyframe store (posegraph.apply_pose_update), this
    rebuilds the volume from scratch out of the corrected keyframe clouds,
    with each keyframe's position as the carving origin.

    Post-rebuild the map's support is the keyframe coverage (keyframe
    clouds are the voxel-downsampled registered scans) rather than every
    scan ever fused; subsequent scans keep integrating incrementally. This
    matches the role of the reference-class TSDF consumers, which fuse the
    *post-correction* world-frame stream (reference
    src/dliomapping/dliomapping.cpp:44, README.md:30-40) — after a
    correction, a consistent volume requires re-fusing corrected data.

    One lax.scan step per keyframe slot; inactive slots are gated by zero
    sample weights (a cond would copy the multi-hundred-MB payload).
    """
    state = init_tsdf(cfg)

    def body(st, inp):
        xyz, valid, origin, idx = inp
        pos, sdf, w = _ray_samples(cfg, xyz, valid, origin)
        w = w * (idx < kf_count).astype(w.dtype)
        return _integrate_samples(cfg, st, pos, sdf, w), None

    K = kf_xyz.shape[0]
    state, _ = jax.lax.scan(
        body, state,
        (kf_xyz, kf_valid, kf_pos, jnp.arange(K, dtype=jnp.int32)))
    return state


def voxel_centers(cfg: TsdfConfig, state: TsdfState):
    """World-space centers of every allocated voxel: (C, 512, 3)."""
    keys = state.dir_keys
    bx = (keys & 0x7FF) - 1024
    by = ((keys >> 11) & 0x7FF) - 1024
    bz = ((keys >> 22) & 0x3FF) - 512
    b = jnp.stack([bx, by, bz], axis=-1)                  # (C, 3)
    iv = jnp.arange(BLOCK_VOLUME, dtype=jnp.int32)
    intra = jnp.stack([iv & 7, (iv >> 3) & 7, (iv >> 6) & 7], axis=-1)
    vox = b[:, None, :] * BLOCK + intra[None, :, :]
    # payload is indexed by slot, but dir rows are key-ordered: permute the
    # centers to slot order so centers[slot] matches tsdf[slot].
    C = keys.shape[0]
    centers_keyorder = (vox.astype(jnp.float32) + 0.5) * cfg.voxel_size
    centers = jnp.zeros_like(centers_keyorder)
    slot = jnp.where(keys != _KEY_PAD, state.dir_slots, C - 1)
    centers = centers.at[slot].set(centers_keyorder)
    return centers


@partial(jax.jit, static_argnames=("cfg",))
def extract_surface(cfg: TsdfConfig, state: TsdfState,
                    iso_band: float = 0.5, min_weight: float = 1.0):
    """Surface point extraction: centers of voxels near the zero crossing.

    Returns (points (C*512, 3), tsdf values, mask) — the host compacts.
    (Marching-cubes mesh export is provided in io/meshing.py.)
    """
    centers = voxel_centers(cfg, state).reshape(-1, 3)
    d = tsdf_distance(cfg, state).reshape(-1)
    w = state.weight.reshape(-1)
    mask = (w >= min_weight) & (jnp.abs(d) < iso_band * cfg.voxel_size * 2.0)
    # mask out unallocated slots
    slot_used = jnp.zeros((state.weight.shape[0],), bool).at[
        jnp.where(state.dir_keys != _KEY_PAD, state.dir_slots,
                  state.weight.shape[0])].set(True, mode="drop")
    mask = mask & jnp.repeat(slot_used, BLOCK_VOLUME)
    return centers, d, mask

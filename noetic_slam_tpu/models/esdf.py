"""ESDF queries over the TSDF volume (Voxblox-class planning output).

The reference README's map-backend list includes Voxblox (reference
README.md:30-40; package absent from the checkout — SURVEY.md §0), whose
distinguishing capability over plain TSDF fusion is the incremental
Euclidean signed distance field consumed by planners. This module provides
that output re-designed for the accelerator:

- **Dense region query, not an incremental global field.** Voxblox
  maintains a global ESDF layer updated by propagation queues (pointer
  chasing — hostile to XLA). Planners consume *local* fields around the
  robot; here `esdf_region` materializes an arbitrary axis-aligned region
  on demand: gather the covered TSDF blocks through the sorted directory
  (one merge-join lookup), then run an exact distance transform on the
  dense grid.

- **Min-plus separable distance transform.** The classic Felzenszwalb
  lower-envelope scan is sequential per scanline; instead each axis pass
  computes d2_out[i] = min_j (d2_in[j] + (i-j)^2 v^2) as a broadcast
  min-reduction — an O(n^2) "min-plus matmul" per line that vectorizes
  perfectly on the VPU and is exact (the squared-distance transform is
  separable across axes). For planning-scale regions (<= ~128^3) the
  arithmetic is trivial against HBM speed.

- **Signed by two complementary transforms**: distance to the obstacle
  set from free space minus distance to free space from inside obstacles,
  with the surface fixed by the TSDF's own zero crossing (|tsdf| seeds in
  the band, CHUNK-exact at the voxel scale a planner consumes).

Unobserved voxels are reported in the ``observed`` mask and hold
``max_dist`` in the field (treat-as-unknown policy is the caller's).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from noetic_slam_tpu.config.params import TsdfConfig
from noetic_slam_tpu.models.tsdf import (
    BLOCK,
    BLOCK_VOLUME,
    TsdfState,
    _block_key,
    _lookup_join,
    tsdf_distance,
)

Array = jax.Array


def _minplus_1d(d2: Array, axis: int, v: float, n: int) -> Array:
    """One separable squared-EDT pass: d2_out[i] = min_j d2[j] + v^2 (i-j)^2
    along ``axis`` (broadcast min-reduction, exact)."""
    i = jnp.arange(n, dtype=jnp.float32)
    pen = jnp.square((i[:, None] - i[None, :]) * v)        # (n, n)
    d2m = jnp.moveaxis(d2, axis, -1)                       # (..., n)
    out = jnp.min(d2m[..., None, :] + pen, axis=-1)        # (..., n)
    return jnp.moveaxis(out, -1, axis)


def _edt_sq(seed_d2: Array, v: float) -> Array:
    """Exact 3-axis squared Euclidean distance transform of seeded d^2."""
    out = seed_d2
    for ax, n in enumerate(seed_d2.shape):
        out = _minplus_1d(out, ax, v, n)
    return out


@partial(jax.jit, static_argnames=("cfg", "shape"))
def esdf_region(cfg: TsdfConfig, state: TsdfState, origin: Array,
                shape: tuple = (64, 64, 32), max_dist: float = 5.0):
    """Euclidean signed distance field over a dense axis-aligned region.

    origin: (3,) world-space corner of the region (snapped to the voxel
    grid); shape: static (nx, ny, nz) voxel counts. Returns
    (esdf (nx, ny, nz) f32 [m], observed (nx, ny, nz) bool, centers
    (nx, ny, nz, 3) f32): positive outside obstacles, negative inside,
    clamped to [-max_dist, max_dist]; unobserved voxels read +max_dist
    with observed=False.
    """
    v = cfg.voxel_size
    nx, ny, nz = shape
    base = jnp.floor(jnp.asarray(origin) / v).astype(jnp.int32)    # (3,)
    ii, jj, kk = jnp.meshgrid(jnp.arange(nx), jnp.arange(ny),
                              jnp.arange(nz), indexing="ij")
    vox = base + jnp.stack([ii, jj, kk], axis=-1)                  # (...,3)
    centers = (vox.astype(jnp.float32) + 0.5) * v

    # Gather TSDF values through the sorted directory (one merge join for
    # the whole region).
    b = vox >> 3
    intra = vox - (b << 3)
    keys = _block_key(b).reshape(-1)
    slots = _lookup_join(state.dir_keys, state.dir_slots, keys)
    ivox = (intra[..., 0] + (intra[..., 1] << 3)
            + (intra[..., 2] << 6)).reshape(-1)
    flat = jnp.where(slots >= 0,
                     jnp.clip(slots, 0, state.weight.shape[0] - 1)
                     * BLOCK_VOLUME + ivox, 0)
    d_all = tsdf_distance(cfg, state).reshape(-1)
    w_all = state.weight.reshape(-1)
    tsdf_d = jnp.where(slots >= 0, d_all[flat], cfg.truncation)
    w = jnp.where(slots >= 0, w_all[flat], 0.0)
    observed = (w > 0.0).reshape(nx, ny, nz)
    tsdf_d = tsdf_d.reshape(nx, ny, nz)

    occupied = observed & (tsdf_d < 0.0)
    band = observed & (jnp.abs(tsdf_d) < v)      # zero-crossing seeds

    inf = jnp.float32(4.0 * max_dist * max_dist)
    # Distance-to-surface from free space: band voxels seed with their own
    # |tsdf|^2 (sub-voxel surface offset), obstacle interiors are sources
    # too (distance 0 boundary); elsewhere +inf.
    seed_out = jnp.where(band, jnp.square(tsdf_d),
                         jnp.where(occupied, 0.0, inf))
    d_out = jnp.sqrt(_edt_sq(seed_out, v))
    # Distance from inside obstacles to free space (for the negative side).
    seed_in = jnp.where(band, jnp.square(tsdf_d),
                        jnp.where(occupied, inf, 0.0))
    d_in = jnp.sqrt(_edt_sq(seed_in, v))

    esdf = jnp.where(occupied, -d_in, d_out)
    esdf = jnp.clip(esdf, -max_dist, max_dist)
    esdf = jnp.where(observed, esdf, max_dist)
    return esdf, observed, centers


@partial(jax.jit, static_argnames=("cfg", "shape"))
def esdf_region_occupancy(cfg, state, origin: Array,
                          shape: tuple = (64, 64, 32),
                          max_dist: float = 5.0):
    """ESDF over the occupancy backend (models/occupancy.OccupancyState):
    occupied = log-odds > occ_thresh, free = updated voxels at/below it.
    No sub-voxel band exists in an occupancy grid, so surfaces are
    voxel-quantized (seeds at 0 on the occupied set). Same return contract
    as esdf_region. ``cfg`` is an OccupancyConfig."""
    v = cfg.voxel_size
    nx, ny, nz = shape
    base = jnp.floor(jnp.asarray(origin) / v).astype(jnp.int32)
    ii, jj, kk = jnp.meshgrid(jnp.arange(nx), jnp.arange(ny),
                              jnp.arange(nz), indexing="ij")
    vox = base + jnp.stack([ii, jj, kk], axis=-1)
    centers = (vox.astype(jnp.float32) + 0.5) * v

    b = vox >> 3
    intra = vox - (b << 3)
    keys = _block_key(b).reshape(-1)
    slots = _lookup_join(state.dir_keys, state.dir_slots, keys)
    ivox = (intra[..., 0] + (intra[..., 1] << 3)
            + (intra[..., 2] << 6)).reshape(-1)
    flat = jnp.where(slots >= 0,
                     jnp.clip(slots, 0, state.logodds.shape[0] - 1)
                     * BLOCK_VOLUME + ivox, 0)
    L = jnp.where(slots >= 0, state.logodds.reshape(-1)[flat], 0.0)
    # An exactly-zero log-odds voxel inside an allocated block is
    # indistinguishable from an untouched one — treated as unobserved
    # (conservative; hit/miss magnitudes make true zeros measure-zero).
    observed = (L != 0.0).reshape(nx, ny, nz)
    occupied = observed & (L.reshape(nx, ny, nz) > cfg.occ_thresh)

    inf = jnp.float32(4.0 * max_dist * max_dist)
    d_out = jnp.sqrt(_edt_sq(jnp.where(occupied, 0.0, inf), v))
    d_in = jnp.sqrt(_edt_sq(jnp.where(occupied, inf, 0.0), v))
    esdf = jnp.where(occupied, -d_in, d_out)
    esdf = jnp.clip(esdf, -max_dist, max_dist)
    esdf = jnp.where(observed, esdf, max_dist)
    return esdf, observed, centers


@partial(jax.jit, static_argnames=("cfg", "shape"))
def esdf_at(cfg: TsdfConfig, state: TsdfState, points: Array,
            shape: tuple = (64, 64, 32), max_dist: float = 5.0):
    """Signed distance at query points (N, 3): materializes the covering
    region (its corner = min of the query AABB) and trilinearly
    interpolates. Queries must fit in ``shape`` voxels; a query whose AABB
    overflows the region reads the max_dist ("unknown/far") sentinel
    rather than silently clamping to a border voxel's value (out-of-region
    distances would otherwise be wrong with no signal — ADVICE r2)."""
    v = cfg.voxel_size
    lo = jnp.min(points, axis=0) - 2.0 * v
    esdf, observed, _ = esdf_region(cfg, state, lo, shape=shape,
                                    max_dist=max_dist)
    base = jnp.floor(lo / v) * v
    u = (points - base) / v - 0.5                 # center-of-voxel coords
    hi_ok = jnp.asarray([shape[0] - 1.001, shape[1] - 1.001,
                         shape[2] - 1.001])
    in_region = jnp.all((u >= -0.5) & (u <= hi_ok + 0.5), axis=-1)
    u = jnp.clip(u, 0.0, hi_ok)
    i0 = jnp.floor(u).astype(jnp.int32)
    f = u - i0
    # Observation-weighted trilinear blend: unobserved corners hold the
    # max_dist sentinel and would poison the interpolation — drop them and
    # renormalize (all-unobserved cells read max_dist).
    vals = 0.0
    wsum = 0.0
    for dx in (0, 1):
        for dy in (0, 1):
            for dz in (0, 1):
                wgt = (jnp.where(dx, f[:, 0], 1 - f[:, 0])
                       * jnp.where(dy, f[:, 1], 1 - f[:, 1])
                       * jnp.where(dz, f[:, 2], 1 - f[:, 2]))
                ix, iy, iz = i0[:, 0] + dx, i0[:, 1] + dy, i0[:, 2] + dz
                wgt = wgt * observed[ix, iy, iz]
                vals = vals + wgt * esdf[ix, iy, iz]
                wsum = wsum + wgt
    out = jnp.where(wsum > 1e-6, vals / jnp.maximum(wsum, 1e-6), max_dist)
    return jnp.where(in_region, out, max_dist)

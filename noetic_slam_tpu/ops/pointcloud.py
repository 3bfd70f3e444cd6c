"""Scan intake + preprocessing as statically-shaped device ops.

Covers the behavior of the reference's scan intake path
(``getScanFromROS``/``preprocessPoints``/``deskewPointcloud`` prologue,
reference src/dlio/src/dlio/odom.cc:490-586,588-660) and PCL's VoxelGrid
centroid downsampling, re-expressed with padding + masking:

- every cloud is ``(N, 3) xyz`` + ``(N,) t`` (relative seconds) + ``(N,) bool``
  validity mask; invalid slots carry a far-away sentinel position so they are
  inert in NN searches and reductions;
- "remove NaN + crop box" (odom.cc:495-503) -> mask updates;
- "sort by timestamp, unique timestamps, per-point frame index"
  (odom.cc:634-660) -> argsort + cumsum over a first-occurrence flag;
- PCL VoxelGrid (odom.cc:576-581, leaf 0.25) -> voxel-key sort + segment mean.

Time convention: all device-side times are float32 seconds relative to a
per-step epoch chosen by the host runtime (absolute float64 timestamps never
reach the device; see runtime/pipeline.py).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

Array = jax.Array

# Sentinel position for invalid/padded points: far enough that any distance
# test rejects them, small enough that float math stays finite.
SENTINEL = 1.0e6


class Scan(NamedTuple):
    xyz: Array    # (N, 3)
    t: Array      # (N,) relative seconds (0 where no per-point time)
    valid: Array  # (N,) bool
    count: Array  # () int32 = valid.sum()

    @property
    def capacity(self) -> int:
        return self.xyz.shape[0]


def make_scan(xyz: Array, t: Array | None = None,
              valid: Array | None = None) -> Scan:
    n = xyz.shape[0]
    if t is None:
        t = jnp.zeros((n,), jnp.float32)
    if valid is None:
        valid = jnp.ones((n,), bool)
    valid = valid & jnp.all(jnp.isfinite(xyz), axis=-1)
    xyz = jnp.where(valid[:, None], xyz, SENTINEL)
    return Scan(xyz, t, valid, valid.sum().astype(jnp.int32))


def _part1by2(x: Array) -> Array:
    """Spread the low 10 bits of x so they occupy every 3rd bit."""
    x = x & 0x3FF
    x = (x | (x << 16)) & 0x030000FF
    x = (x | (x << 8)) & 0x0300F00F
    x = (x | (x << 4)) & 0x030C30C3
    x = (x | (x << 2)) & 0x09249249
    return x


def morton30(v: Array) -> Array:
    """(…, 3) int32 grid coords in [0, 1024) -> 30-bit Morton (Z-order) key.

    Z-order keeps spatially nearby points nearby in the sorted sequence, so
    contiguous tiles of a Morton-sorted cloud have compact bounding boxes —
    the property the fused NN kernel's tile pruning
    (ops/pallas/nn_kernel.py) feeds on.
    """
    return (_part1by2(v[..., 0]) | (_part1by2(v[..., 1]) << 1)
            | (_part1by2(v[..., 2]) << 2))


def morton_sort_key(xyz: Array, valid: Array, cell: float) -> Array:
    """Morton key of each point on a ``cell``-sized grid anchored at the
    cloud minimum (clamped to 1024^3 reach); invalid points key to
    INT32_MAX so a sort compacts valid points to the front."""
    big = jnp.where(valid[:, None], xyz, jnp.inf)
    pmin = jnp.min(big, axis=0)
    pmin = jnp.where(jnp.isfinite(pmin), pmin, 0.0)
    v = jnp.clip(jnp.floor((xyz - pmin) / cell).astype(jnp.int32), 0, 1023)
    return jnp.where(valid, morton30(v), jnp.iinfo(jnp.int32).max)


def crop_box(scan: Scan, size: float) -> Scan:
    """Drop points inside the sensor-centered box [-size, size]^3.

    Matches the reference crop-box filter with setNegative(true)
    (odom.cc:62-66, 501-503): points *within* the box are removed.
    """
    inside = jnp.all(jnp.abs(scan.xyz) <= size, axis=-1)
    valid = scan.valid & ~inside
    xyz = jnp.where(valid[:, None], scan.xyz, SENTINEL)
    return Scan(xyz, scan.t, valid, valid.sum().astype(jnp.int32))


class PreparedScan(NamedTuple):
    """Scan sorted by per-point time with unique-timestamp frame grouping."""
    xyz: Array          # (N, 3) sorted by time
    t: Array            # (N,) sorted times
    valid: Array        # (N,)
    count: Array        # () int32
    frame_idx: Array    # (N,) int32 index into unique_t per point
    unique_t: Array     # (F,) unique timestamps (padded with last value)
    unique_count: Array # () int32
    median_idx: Array   # () int32 index of median unique timestamp
    scan_stamp: Array   # () relative time of the median point (odom.cc:652)


def prepare_scan(scan: Scan, max_frames: int) -> PreparedScan:
    """Sort by timestamp and build the unique-timestamp frame structure.

    Re-expresses reference odom.cc:634-660: points sorted by time; each point
    is assigned the index of its (unique) timestamp; the scan stamp becomes
    the median unique timestamp. Invalid points sort to the end (+inf key).
    """
    n = scan.xyz.shape[0]
    key = jnp.where(scan.valid, scan.t, jnp.inf)
    order = jnp.argsort(key)
    t = scan.t[order]
    xyz = scan.xyz[order]
    valid = scan.valid[order]

    # First-occurrence flag over the valid prefix.
    first = jnp.concatenate([jnp.ones((1,), bool), t[1:] != t[:-1]]) & valid
    frame_idx = jnp.cumsum(first.astype(jnp.int32)) - 1
    frame_idx = jnp.clip(frame_idx, 0, max_frames - 1)
    # If the scan has more unique timestamps than frame capacity, the excess
    # points share the last frame (graceful degradation; capacity should be
    # sized to columns_per_frame).
    unique_count = jnp.minimum(first.sum(), max_frames).astype(jnp.int32)

    # Scatter unique times into a fixed-capacity array; pad with the last
    # valid unique time so out-of-range queries stay in-range for the
    # integrator.
    uniq = jnp.full((max_frames,), -jnp.inf, jnp.float32)
    uniq = uniq.at[jnp.where(first, frame_idx, max_frames)].set(
        t, mode="drop")
    last_t = uniq[jnp.clip(unique_count - 1, 0, max_frames - 1)]
    slot = jnp.arange(max_frames, dtype=jnp.int32)
    uniq = jnp.where(slot < unique_count, uniq, last_t)

    median_idx = unique_count // 2  # reference: timestamps.size()/2
    scan_stamp = uniq[jnp.clip(median_idx, 0, max_frames - 1)]
    return PreparedScan(xyz, t, valid, valid.sum().astype(jnp.int32),
                        frame_idx, uniq, unique_count, median_idx, scan_stamp)


def voxel_downsample(xyz: Array, valid: Array, res: float,
                     out_capacity: int) -> tuple[Array, Array, Array]:
    """Voxel-grid centroid downsampling (PCL VoxelGrid semantics).

    Deterministic: points are keyed by voxel coordinate relative to the
    cloud minimum, sorted by key, and reduced with a segment mean. Voxel
    coordinates are clamped to a 1024^3 local grid (256 m at 0.25 m leaves),
    matching the practical extent of a single LiDAR scan.

    Returns (xyz_ds (out_capacity, 3), valid_ds, count).
    """
    big = jnp.where(valid[:, None], xyz, jnp.inf)
    pmin = jnp.min(big, axis=0)
    pmin = jnp.where(jnp.isfinite(pmin), pmin, 0.0)
    # Integer-aligned origin shift keeps leaf boundaries identical to the
    # absolute floor(p/res) grid PCL uses.
    origin = jnp.floor(pmin / res)
    v = jnp.clip((jnp.floor(xyz / res) - origin).astype(jnp.int32), 0, 1023)
    # Morton (Z-order) voxel key: injective on the 1024^3 grid, so the
    # segment-mean grouping is identical to a linear key — but the output
    # centroids come out spatially ordered, which gives downstream NN
    # query tiles compact bounding boxes (tile pruning, ops/pallas).
    key = morton30(v)
    key = jnp.where(valid, key, jnp.iinfo(jnp.int32).max)

    order = jnp.argsort(key)
    key_s = key[order]
    xyz_s = xyz[order]
    valid_s = valid[order]

    first = jnp.concatenate([jnp.ones((1,), bool), key_s[1:] != key_s[:-1]])
    first = first & valid_s
    seg = jnp.cumsum(first.astype(jnp.int32)) - 1
    nseg = first.sum().astype(jnp.int32)

    # Segments beyond capacity are dropped outright (never merged into the
    # last slot, which would corrupt its centroid).
    seg_clip = jnp.where(valid_s & (seg < out_capacity), seg, out_capacity)
    w = valid_s.astype(xyz.dtype)
    sums = jnp.zeros((out_capacity, 3), xyz.dtype).at[seg_clip].add(
        xyz_s * w[:, None], mode="drop")
    cnts = jnp.zeros((out_capacity,), xyz.dtype).at[seg_clip].add(
        w, mode="drop")

    slot = jnp.arange(out_capacity, dtype=jnp.int32)
    out_valid = slot < jnp.minimum(nseg, out_capacity)
    centroid = sums / jnp.maximum(cnts, 1.0)[:, None]
    out_xyz = jnp.where(out_valid[:, None], centroid, SENTINEL)
    return out_xyz, out_valid, jnp.minimum(nseg, out_capacity)

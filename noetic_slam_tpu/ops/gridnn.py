"""Grid-bucketed nearest-neighbor search — the production NN engine.

Brute-force NN (ops/neighbors.py) is robust but O(Nq x Nt) with a K=3
contraction no matrix unit can fill. This module implements the
alternative called out in SURVEY.md §7 ("voxel-hash bucketed NN"):

- **Build** (once per target change, e.g. per submap swap): target points
  are keyed by grid cell (cell size >= the correspondence radius), sorted
  by key. No hash table — the sorted key array *is* the index; cell lookup
  is ``searchsorted`` (vectorized, branch-free).
- **Query**: each query point gathers up to ``max_per_cell`` candidates
  from each of its 27 neighboring cells and reduces distances. With
  ``cell >= radius`` every true neighbor within ``radius`` lies in the
  27-neighborhood, so thresholded-NN (exactly what GICP consumes,
  nano_gicp.cc:225-232: correspondences beyond max_corr_dist are rejected)
  is exact up to per-cell candidate truncation.

Cell keys pack 3x10-bit local coords relative to a build-time origin
(+-512 cells; at 0.5 m cells that is +-256 m of submap extent). Out-of-range
or invalid points get the sentinel key and match nothing.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

Array = jax.Array

_KEY_INVALID = jnp.iinfo(jnp.int32).max


class Grid(NamedTuple):
    xyz: Array      # (Nt, 3) target points, sorted by cell key
    keys: Array     # (Nt,) sorted cell keys (invalid = INT32_MAX)
    order: Array    # (Nt,) original index of each sorted point
    origin: Array   # (3,) cell-space origin (float, units of cells)
    cell: Array     # () cell size [m]


def _cell_coords(xyz: Array, origin: Array, cell) -> Array:
    return jnp.floor(xyz / cell).astype(jnp.int32) - origin.astype(jnp.int32)


def _pack(c: Array) -> Array:
    cx, cy, cz = c[..., 0], c[..., 1], c[..., 2]
    ok = ((cx >= 0) & (cx < 1024) & (cy >= 0) & (cy < 1024)
          & (cz >= 0) & (cz < 1024))
    key = (cz << 20) | (cy << 10) | cx
    return jnp.where(ok, key, _KEY_INVALID)


def build_grid(xyz: Array, valid: Array, cell: float | Array) -> Grid:
    """Sort target points by grid cell. O(Nt log Nt), once per target."""
    cell = jnp.asarray(cell, jnp.float32)
    big = jnp.where(valid[:, None], xyz, jnp.inf)
    pmin = jnp.min(big, axis=0)
    pmin = jnp.where(jnp.isfinite(pmin), pmin, 0.0)
    origin = jnp.floor(pmin / cell) - 1.0   # one-cell margin for neighbors
    c = jnp.floor(xyz / cell).astype(jnp.int32) - origin.astype(jnp.int32)
    keys = jnp.where(valid, _pack(c), _KEY_INVALID)
    order = jnp.argsort(keys)
    return Grid(xyz[order], keys[order], order.astype(jnp.int32), origin,
                cell)


# Neighbor-cell offsets (27,) packed as key deltas.
def _neighbor_key_offsets():
    import numpy as np

    # NOTE: arithmetic (+), not bitwise OR — offsets have negative fields.
    d = np.array([(dz << 20) + (dy << 10) + dx
                  for dz in (-1, 0, 1) for dy in (-1, 0, 1)
                  for dx in (-1, 0, 1)], np.int32)
    return d


_NEIGHBOR_OFFSETS = _neighbor_key_offsets()


@partial(jax.jit, static_argnames=("max_per_cell",))
def grid_nn1(query: Array, grid: Grid, *, max_per_cell: int = 32):
    """Thresholded 1-NN: nearest sorted-target candidate within the 27-cell
    neighborhood of each query. Returns (idx (Nq,) into the ORIGINAL target
    order, sqd (Nq,)); misses get sqd = +inf.
    """
    nq = query.shape[0]
    nt = grid.xyz.shape[0]
    qc = _cell_coords(query, grid.origin, grid.cell)
    qkey = _pack(qc)                                     # (Nq,)
    cand_keys = qkey[:, None] + _NEIGHBOR_OFFSETS[None, :]   # (Nq, 27)
    cand_keys = jnp.where(qkey[:, None] == _KEY_INVALID, _KEY_INVALID,
                          cand_keys)

    start = jnp.searchsorted(grid.keys, cand_keys.reshape(-1)).reshape(
        nq, 27)
    # candidate slots: start + 0..max_per_cell-1
    slots = start[:, :, None] + jnp.arange(max_per_cell)[None, None, :]
    slots_c = jnp.minimum(slots, nt - 1)
    in_cell = (grid.keys[slots_c] == cand_keys[:, :, None]) & (slots < nt)

    cand = grid.xyz[slots_c]                             # (Nq, 27, M, 3)
    diff = cand - query[:, None, None, :]
    d2 = jnp.sum(diff * diff, axis=-1)
    d2 = jnp.where(in_cell, d2, jnp.inf)
    d2f = d2.reshape(nq, -1)
    a = jnp.argmin(d2f, axis=-1)
    best = jnp.take_along_axis(d2f, a[:, None], axis=-1)[:, 0]
    slot = jnp.take_along_axis(slots_c.reshape(nq, -1), a[:, None],
                               axis=-1)[:, 0]
    idx = grid.order[slot]
    return idx, best


@partial(jax.jit, static_argnames=("k", "max_per_cell"))
def grid_knn(query: Array, grid: Grid, k: int, *, max_per_cell: int = 32):
    """k-NN among the 27-neighborhood candidates (sorted ascending).

    Exact for neighbors within one cell size of the query; candidates
    beyond the neighborhood are unseen (sqd = +inf), which downstream
    covariance estimation tolerates (plane regularization saturates).
    Returns (idx (Nq, k) original order, sqd (Nq, k)).
    """
    nq = query.shape[0]
    nt = grid.xyz.shape[0]
    qc = _cell_coords(query, grid.origin, grid.cell)
    qkey = _pack(qc)
    cand_keys = qkey[:, None] + _NEIGHBOR_OFFSETS[None, :]
    cand_keys = jnp.where(qkey[:, None] == _KEY_INVALID, _KEY_INVALID,
                          cand_keys)
    start = jnp.searchsorted(grid.keys, cand_keys.reshape(-1)).reshape(
        nq, 27)
    slots = start[:, :, None] + jnp.arange(max_per_cell)[None, None, :]
    slots_c = jnp.minimum(slots, nt - 1)
    in_cell = (grid.keys[slots_c] == cand_keys[:, :, None]) & (slots < nt)

    cand = grid.xyz[slots_c]
    diff = cand - query[:, None, None, :]
    d2 = jnp.sum(diff * diff, axis=-1)
    d2 = jnp.where(in_cell, d2, jnp.inf).reshape(nq, -1)
    neg_top, a = jax.lax.top_k(-d2, k)
    slot = jnp.take_along_axis(slots_c.reshape(nq, -1), a, axis=-1)
    return grid.order[slot], -neg_top

"""Fused 1-NN for the GPU: a Pallas kernel through Triton, with best-first
visit-list tile pruning.

The plain XLA version (ops/neighbors._nn1_xla) writes every (Cq, Ct)
distance tile to device memory between the distance computation and the
argmin. This kernel keeps each tile in registers: one program owns a
query tile, walks the target tiles on its visit list, computes

    d^2 = (qx-tx)^2 + (qy-ty)^2 + (qz-tz)^2

by direct differences in float32 on the CUDA cores (a K=3 contraction has
nothing to give the tensor cores, and direct differences need no
recentring), and keeps the per-query (min, argmin) in registers. Only the
(Cq,) winners are written out.

Tile pruning (the branch-and-bound the reference gets from its kd-tree,
nanoflann.h, re-expressed at tile granularity): axis-aligned bounding
boxes are precomputed per query tile AND per target tile in plain XLA,
the box-to-box lower-bound distance matrix (n_q_tiles, n_t_tiles) is
formed, and each query tile gets a *visit list* — candidate target tiles
sorted by ascending lower bound. The kernel walks only that list and stops
at the first entry whose lower bound exceeds the worst current best in the
query tile: best-first traversal, the tile-granular analogue of a kd-tree's
priority search. Pruning is exact — the lower bound holds for every (q, t)
pair in the pair of boxes. With spatially ordered clouds (Morton order,
ops.pointcloud.morton30) boxes are compact and the visit count collapses
to the few tiles overlapping the correspondence radius.

``max_dist`` (optional, traced) caps the search radius: best distances
initialize at max_dist^2 and tiles with lower bound >= max_dist^2 never
enter the visit list. Queries with no neighbor inside the cap return
(idx 0, sqd = max_dist^2) — GICP passes its correspondence-distance
threshold here and discards such pairs anyway (nano_gicp.cc:225-230
radius test).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton

Array = jax.Array

_FAR = 1e9    # box coordinate for empty tiles (never finite-overlapped)
_OK = 1e5     # |coordinate| bound of a real point (sentinels sit beyond)


def _nn_kernel(cap_ref, cnt_ref, vcnt_ref, vlist_ref, vlb_ref,
               qx_ref, qy_ref, qz_ref, tx_ref, ty_ref, tz_ref,
               idx_ref, d_ref, *, q_tile: int, t_tile: int, ntt: int):
    """One program = one query tile. Walks this tile's visit list
    (ascending lower bound) and exits as soon as the next lower bound can
    no longer beat the worst current best among the tile's real queries."""
    qi = pl.program_id(0)
    cap2 = cap_ref[0]
    cnt = cnt_ref[0]
    nvisit = vcnt_ref[qi]
    row = qi * ntt
    qs = pl.ds(pl.multiple_of(qi * q_tile, q_tile), q_tile)
    qx, qy, qz = qx_ref[qs], qy_ref[qs], qz_ref[qs]
    # Sentinel and padding queries never lower ``worst``'s bound on the
    # early exit; they keep whatever they find.
    q_real = ((jnp.abs(qx) < _OK) & (jnp.abs(qy) < _OK)
              & (jnp.abs(qz) < _OK))
    lane = jnp.arange(t_tile, dtype=jnp.int32)

    def cond(carry):
        i, _bd, _bi, worst = carry
        # i == nvisit can reach ntt; clamp the lookahead read (the first
        # conjunct already ends the loop there).
        lb = vlb_ref[row + jnp.minimum(i, ntt - 1)]
        return (i < nvisit) & (lb < worst)

    def body(carry):
        i, best_d, best_i, _ = carry
        t0 = pl.multiple_of(vlist_ref[row + i] * t_tile, t_tile)
        ts = pl.ds(t0, t_tile)
        dx = qx[:, None] - tx_ref[ts][None, :]
        dy = qy[:, None] - ty_ref[ts][None, :]
        dz = qz[:, None] - tz_ref[ts][None, :]
        d = dx * dx + dy * dy + dz * dz                    # (QT, TT)
        d = jnp.where((t0 + lane < cnt)[None, :], d, jnp.inf)
        dmin = jnp.min(d, axis=1)
        a = jnp.argmin(d, axis=1).astype(jnp.int32)
        better = dmin < best_d
        bd = jnp.where(better, dmin, best_d)
        bi = jnp.where(better, t0 + a, best_i)
        return i + 1, bd, bi, jnp.max(jnp.where(q_real, bd, -jnp.inf))

    init = (jnp.int32(0), jnp.full((q_tile,), cap2, jnp.float32),
            jnp.zeros((q_tile,), jnp.int32), cap2)
    _, best_d, best_i, _ = jax.lax.while_loop(cond, body, init)
    idx_ref[qs] = best_i
    d_ref[qs] = best_d


@partial(jax.jit, static_argnames=("q_tile", "t_tile", "num_warps",
                                   "interpret"))
def nn1_fused(query: Array, target: Array, t_count: Array | None = None,
              max_dist: Array | float | None = None,
              *, q_tile: int = 32, t_tile: int = 128, num_warps: int = 4,
              interpret: bool = False):
    """Fused 1-NN: (idx (Nq,) int32, sqd (Nq,) f32). Shapes must be
    multiples of the tile sizes (ops.neighbors.nn1 pads). ``t_count``:
    number of meaningful target rows (compacted-front convention); rows
    beyond it are never matched. ``max_dist`` (may be traced) caps the
    search radius — queries without a neighbor inside it return
    sqd = max_dist^2 (see module docstring)."""
    nq, nt = query.shape[0], target.shape[0]
    assert nq % q_tile == 0 and nt % t_tile == 0
    nqt, ntt = nq // q_tile, nt // t_tile
    if t_count is None:
        t_count = jnp.int32(nt)
    cnt = jnp.asarray(t_count, jnp.int32).reshape(1)
    cap2 = (jnp.full((1,), jnp.inf, jnp.float32) if max_dist is None
            else jnp.square(jnp.asarray(max_dist, jnp.float32)).reshape(1))

    # Per-tile axis-aligned boxes over real, in-range rows; empty or
    # sentinel-only tiles get an inverted far box.
    tok = (jnp.all(jnp.abs(target) < _OK, axis=-1)
           & (jnp.arange(nt) < cnt[0]))[:, None]
    tmin = jnp.min(jnp.where(tok, target, _FAR).reshape(ntt, t_tile, 3), 1)
    tmax = jnp.max(jnp.where(tok, target, -_FAR).reshape(ntt, t_tile, 3), 1)
    qok = jnp.all(jnp.abs(query) < _OK, axis=-1)[:, None]
    qmin = jnp.min(jnp.where(qok, query, _FAR).reshape(nqt, q_tile, 3), 1)
    qmax = jnp.max(jnp.where(qok, query, -_FAR).reshape(nqt, q_tile, 3), 1)

    # Box-to-box squared lower bounds (nqt, ntt) and the per-query-tile
    # visit lists: candidate tiles sorted by ascending lower bound. A tile
    # is a candidate iff it holds in-range rows and its lower bound beats
    # the cap.
    lb = jnp.maximum(
        jnp.maximum(tmin[None, :, :] - qmax[:, None, :],
                    qmin[:, None, :] - tmax[None, :, :]), 0.0)
    lb2 = jnp.sum(lb * lb, axis=-1)
    t_in_range = jnp.arange(ntt) * t_tile < cnt[0]
    candidate = t_in_range[None, :] & (lb2 < jnp.minimum(cap2[0], 1e17))
    lb2 = jnp.where(candidate, lb2, jnp.inf)
    vlist = jnp.argsort(lb2, axis=1).astype(jnp.int32)    # (nqt, ntt)
    vlb = jnp.take_along_axis(lb2, vlist, axis=1).astype(jnp.float32)
    vcnt = jnp.sum(candidate, axis=1).astype(jnp.int32)   # (nqt,)

    idx, d = pl.pallas_call(
        partial(_nn_kernel, q_tile=q_tile, t_tile=t_tile, ntt=ntt),
        grid=(nqt,),
        out_shape=[jax.ShapeDtypeStruct((nq,), jnp.int32),
                   jax.ShapeDtypeStruct((nq,), jnp.float32)],
        backend="triton",
        compiler_params=pltriton.CompilerParams(num_warps=num_warps,
                                                num_stages=1),
        interpret=interpret,
        name="nn1_fused",
    )(cap2, cnt, vcnt, vlist.reshape(-1), vlb.reshape(-1),
      query[:, 0], query[:, 1], query[:, 2],
      target[:, 0], target[:, 1], target[:, 2])
    return idx, d

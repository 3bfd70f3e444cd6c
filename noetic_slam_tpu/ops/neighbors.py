"""Nearest-neighbor search on the accelerator — the kd-tree replacement.

The reference leans on a nanoflann kd-tree for every NN query
(src/dlio/include/nano_gicp/nanoflann.h, nanoflann_adaptor.h:57-108);
pointer chasing maps badly onto SIMD hardware, so this module recasts NN as
*tiled brute-force distance minimization*:

    d^2(q, t) = |q-c|^2 - 2 (q-c)·(t-c) + |t-c|^2

with the cross term as a (Nq, 3) x (3, Nt) matmul. Both clouds are re-centered
by the query centroid so the expansion stays well-conditioned in float32 even
when world coordinates are kilometers from the origin. Invalid/padded points
sit at a far sentinel (ops.pointcloud.SENTINEL) and lose every comparison.

Queries are processed in chunks (bounding the live distance tile) with a
running min / running top-k across target chunks. On the GPU, ``nn1`` runs
the fused, tile-pruned Pallas kernel in ops/pallas/nn_kernel.py instead.

Exact squared distances for the selected candidates are recomputed by direct
subtraction (no cancellation) before returning.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

Array = jax.Array


def _center(query: Array, q_valid: Array) -> Array:
    w = q_valid.astype(query.dtype)
    c = jnp.sum(query * w[:, None], axis=0) / jnp.maximum(w.sum(), 1.0)
    return c


def _sq_dists(qc: Array, tc: Array) -> Array:
    """(Cq,3), (Ct,3) -> (Cq,Ct) squared distances via the expansion.

    Full f32 precision is mandatory: a reduced-precision matmul (bf16, or
    TF32 on the GPU) has ~1e-3 relative error on |q|^2-scale values, which
    would swamp the correspondence-distance thresholds.
    """
    cross = jnp.dot(qc, tc.T, preferred_element_type=jnp.float32,
                    precision=jax.lax.Precision.HIGHEST)
    qq = jnp.sum(qc * qc, axis=-1, keepdims=True)
    tt = jnp.sum(tc * tc, axis=-1)[None, :]
    return qq - 2.0 * cross + tt


def _exact_sq_dist(query: Array, target: Array, idx: Array) -> Array:
    """Recompute |q - t[idx]|^2 by direct subtraction (cancellation-free)."""
    diff = query[..., None, :] - target[idx]
    return jnp.sum(diff * diff, axis=-1)


def _pad_to_multiple(x: Array, chunk: int) -> Array:
    n = x.shape[0]
    rem = (-n) % chunk
    if rem:
        x = jnp.concatenate([x, jnp.full((rem, 3), 1e7, x.dtype)])
    return x


# Kernel tiles, the fastest of a sweep on an H100 at 8192 x 65536 and
# 8192 x 262144 (scripts/bench_nn.py): 16-query tiles give 512 programs at
# the 8192-point GICP source (about four per SM) and tight tile boxes for
# the pruning; 512-target tiles amortize the visit loop.
Q_TILE = 16
T_TILE = 512


def on_gpu() -> bool:
    """Whether the computation being traced is placed on a GPU: the
    platform of ``jax.default_device`` when one is set, else the default
    backend."""
    dev = jax.config.jax_default_device
    if dev is None:
        return jax.default_backend() == "gpu"
    return (dev if isinstance(dev, str) else dev.platform) in ("gpu", "cuda")


def nn1(query: Array, target: Array, t_count: Array | None = None,
        max_dist: Array | float | None = None, *,
        query_chunk: int = 1024, target_chunk: int = 8192
        ) -> tuple[Array, Array]:
    """1-NN: for each query point, index + squared distance of the nearest
    target point. Replaces nanoflann nearestKSearch(pt, 1, ...) as used in
    GICP correspondence search (nano_gicp.cc:225-230).

    On the GPU this runs the fused Pallas kernel (``nn1_kernel``); elsewhere
    the XLA path. ``max_dist`` (optional, may be traced) lets the kernel
    prune target tiles beyond the radius the caller will threshold at
    anyway — queries with no neighbor inside it return sqd >= max_dist^2
    (index undefined). Returns (idx (Nq,) int32, sqd (Nq,) float32).
    """
    if on_gpu():
        return nn1_kernel(query, target, t_count, max_dist)
    # XLA path: exact full search (the cap is an optimization, not part of
    # the contract); callers threshold on sqd themselves.
    return _nn1_xla(query, target, t_count, query_chunk=query_chunk,
                    target_chunk=target_chunk)


def nn1_kernel(query: Array, target: Array, t_count: Array | None = None,
               max_dist: Array | float | None = None, *,
               interpret: bool = False) -> tuple[Array, Array]:
    """``nn1`` through the fused kernel: pads both clouds to tile
    multiples with far rows (padding targets lie beyond ``t_count`` and are
    never matched) and trims the result back to the caller's queries."""
    from noetic_slam_tpu.ops.pallas.nn_kernel import nn1_fused

    nq = query.shape[0]
    if t_count is None:
        t_count = jnp.int32(target.shape[0])
    idx, sqd = nn1_fused(_pad_to_multiple(query, Q_TILE),
                         _pad_to_multiple(target, T_TILE), t_count, max_dist,
                         q_tile=Q_TILE, t_tile=T_TILE, interpret=interpret)
    return idx[:nq], sqd[:nq]


@partial(jax.jit, static_argnames=("query_chunk", "target_chunk"))
def _nn1_xla(query: Array, target: Array, t_count: Array | None = None, *,
             query_chunk: int = 1024,
             target_chunk: int = 8192) -> tuple[Array, Array]:
    nq = query.shape[0]
    c = _center(query, jnp.all(jnp.abs(query) < 1e5, axis=-1))
    qp = _pad_to_multiple(query, query_chunk)
    tp = _pad_to_multiple(target, target_chunk)
    qc_all = (qp - c).reshape(-1, query_chunk, 3)
    t_cent = tp - c
    n_tchunk = tp.shape[0] // target_chunk
    if t_count is not None:
        n_tchunk = jnp.minimum(
            -(-jnp.asarray(t_count, jnp.int32) // target_chunk),
            n_tchunk)

    def per_qchunk(qc):
        def body(i, carry):
            best_d, best_i = carry
            t0 = i * target_chunk
            tc = jax.lax.dynamic_slice_in_dim(t_cent, t0, target_chunk)
            d = _sq_dists(qc, tc)
            a = jnp.argmin(d, axis=-1)
            dmin = jnp.take_along_axis(d, a[:, None], axis=-1)[:, 0]
            better = dmin < best_d
            return (jnp.where(better, dmin, best_d),
                    jnp.where(better, t0 + a.astype(jnp.int32), best_i))

        init = (jnp.full((query_chunk,), jnp.inf, jnp.float32),
                jnp.zeros((query_chunk,), jnp.int32))
        return jax.lax.fori_loop(0, n_tchunk, body, init)

    best_d, best_i = jax.lax.map(per_qchunk, qc_all)
    idx = best_i.reshape(-1)[:nq]
    sqd = _exact_sq_dist(query, tp, idx[:, None])[:, 0]
    return idx, sqd


@partial(jax.jit, static_argnames=("k", "query_chunk", "target_chunk"))
def knn(query: Array, target: Array, k: int, *, query_chunk: int = 512,
        target_chunk: int = 8192) -> tuple[Array, Array]:
    """k-NN with running top-k across target chunks.

    Replaces nanoflann nearestKSearch(pt, k, ...) as used by GICP covariance
    estimation (nano_gicp.cc:339-345). Returns (idx (Nq,k), sqd (Nq,k)),
    sorted ascending by distance.
    """
    nq = query.shape[0]
    c = _center(query, jnp.all(jnp.abs(query) < 1e5, axis=-1))
    qp = _pad_to_multiple(query, query_chunk)
    tp = _pad_to_multiple(target, target_chunk)
    qc_all = (qp - c).reshape(-1, query_chunk, 3)
    t_cent = tp - c
    n_tchunk = tp.shape[0] // target_chunk

    def per_qchunk(qc):
        def body(i, carry):
            best_d, best_i = carry
            t0 = i * target_chunk
            tc = jax.lax.dynamic_slice_in_dim(t_cent, t0, target_chunk)
            d = _sq_dists(qc, tc)
            top_d, top_a = jax.lax.top_k(-d, k)
            cand_d = jnp.concatenate([best_d, -top_d], axis=-1)
            cand_i = jnp.concatenate(
                [best_i, t0 + top_a.astype(jnp.int32)], axis=-1)
            merged_d, sel = jax.lax.top_k(-cand_d, k)
            merged_i = jnp.take_along_axis(cand_i, sel, axis=-1)
            return (-merged_d, merged_i)

        init = (jnp.full((query_chunk, k), jnp.inf, jnp.float32),
                jnp.zeros((query_chunk, k), jnp.int32))
        return jax.lax.fori_loop(0, n_tchunk, body, init)

    best_d, best_i = jax.lax.map(per_qchunk, qc_all)
    idx = best_i.reshape(-1, k)[:nq]
    sqd = _exact_sq_dist(query, tp, idx)
    order = jnp.argsort(sqd, axis=-1)
    return jnp.take_along_axis(idx, order, axis=-1), jnp.take_along_axis(
        sqd, order, axis=-1)

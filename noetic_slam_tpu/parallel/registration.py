"""Distributed GICP registration over a device mesh.

Shards the scan-to-map NN search and the normal-equation reduction across
chips — the replacement for the reference's single-host OpenMP
parallel-for over correspondences (nano_gicp.cc:219-299):

- target (submap) points+covariances are sharded along the ``map`` axis;
- every device searches the full (replicated) query set against its target
  shard and emits per-query *candidates* (distance, target point, target
  covariance);
- the global nearest neighbor is picked by an O(1)-in-device-count
  (min, argmin, payload) REDUCTION: ``pmin`` of the candidate distance,
  ``pmin`` of the winning device id, then a ``psum`` of the winner-masked
  payload (point + covariance) — exactly one device contributes per query,
  so every collective is an all-reduce whose per-device traffic is flat in
  device count. (An all-gather of the full candidate payload would have
  every device receive O(ndev) bytes per query, which caps scaling
  efficiency long before the BASELINE >= 70 % target.)
- each device then linearizes only its 1/ndev slice of the queries and the
  6x6/6x1 normal equations are combined with ``psum`` — the same
  Schur-style reduced-block psum pattern used by distributed BA
  (parallel/bundle_adjustment.py).

The LM trust-region loop runs inside one ``shard_map`` so the whole
alignment is a single SPMD program; collectives ride ICI.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from noetic_slam_tpu.config.params import GicpConfig
from noetic_slam_tpu.ops import neighbors
from noetic_slam_tpu.ops.gicp import (
    AlignResult,
    _delta_to_T,
    _inv3_sym,
    _is_converged,
    sym6_to_mat,
)
from noetic_slam_tpu.utils.geometry import skew

Array = jax.Array


def sharded_gicp_align(mesh, src_xyz: Array, src_valid: Array,
                       src_cov6: Array, tgt_xyz: Array, tgt_cov6: Array,
                       cfg: GicpConfig, max_corr_dist=None,
                       axis: str = "map") -> AlignResult:
    """GICP alignment with the target sharded along ``axis`` of ``mesh``.

    src_* are replicated; tgt_* are sharded on their leading dimension
    (caller supplies arrays whose leading dim divides the axis size).
    """
    ndev = mesh.shape[axis]
    nq = src_xyz.shape[0]
    assert nq % ndev == 0, "query count must divide the mesh axis"
    cq = nq // ndev
    mcd = jnp.asarray(cfg.max_corr_dist if max_corr_dist is None
                      else max_corr_dist, jnp.float32)

    def spmd(src_xyz, src_valid, src_cov6, tgt_xyz, tgt_cov6, mcd):
        my = jax.lax.axis_index(axis)

        def candidates(T):
            """Local NN candidates for ALL queries vs the local shard."""
            transed = src_xyz @ T[:3, :3].T + T[:3, 3]
            idx, sqd = neighbors.nn1(transed, tgt_xyz)
            return sqd, tgt_xyz[idx], tgt_cov6[idx]

        def global_winner(T):
            """(min-dist, payload) tree reduction over the mesh axis:
            pmin picks the distance, a second pmin the lowest winning
            device id (same tie-break as argmin over stacked candidates),
            and a winner-masked psum moves the single winning payload to
            every device. Per-device traffic is O(nq), flat in ndev."""
            d, pt, cv = candidates(T)
            d_min = jax.lax.pmin(d, axis)              # (Nq,)
            win = jnp.where(d <= d_min, my, ndev)      # my d == d_min bitwise
            win_dev = jax.lax.pmin(win, axis)          # (Nq,)
            mask = (win_dev == my)[:, None]
            pt_g = jax.lax.psum(jnp.where(mask, pt, 0.0), axis)
            cv_g = jax.lax.psum(jnp.where(mask, cv, 0.0), axis)
            return d_min, pt_g, cv_g

        def linearize(T):
            d_full, pt_full, cv_full = global_winner(T)
            maha_rep = maha_full(T, d_full, pt_full, cv_full)
            # this device's query slice
            sl = lambda x: jax.lax.dynamic_slice_in_dim(x, my * cq, cq)
            q_xyz, q_valid, q_cov = sl(src_xyz), sl(src_valid), sl(src_cov6)
            d, pt, cv = sl(d_full), sl(pt_full), sl(cv_full)

            transed = q_xyz @ T[:3, :3].T + T[:3, 3]
            accept = q_valid & (d < mcd * mcd)
            w = accept.astype(jnp.float32)
            rcr = sym6_to_mat(cv) + T[:3, :3] @ sym6_to_mat(q_cov) @ T[:3, :3].T
            maha = _inv3_sym(rcr) * w[:, None, None]
            e = pt - transed
            J = jnp.concatenate(
                [skew(transed),
                 -jnp.broadcast_to(jnp.eye(3), transed.shape + (3,))], axis=-1)
            MJ = maha @ J
            hi = jnp.einsum("nij,nik->jk", J, MJ,
                            precision=jax.lax.Precision.HIGHEST)
            Me = jnp.einsum("nij,ni->nj", maha, e,
                            precision=jax.lax.Precision.HIGHEST)
            bi = jnp.einsum("nij,ni->j", J, Me,
                            precision=jax.lax.Precision.HIGHEST)
            erri = jnp.einsum("ni,ni->", e, Me,
                              precision=jax.lax.Precision.HIGHEST)
            # Schur-style reduced-block combination: psum of 6x6/6x1/scalar.
            H = jax.lax.psum(hi, axis)
            b = jax.lax.psum(bi, axis)
            err = jax.lax.psum(erri, axis)
            n = jax.lax.psum(accept.sum(), axis)
            return (d_full, pt_full, maha_rep), H, b, err, n

        def maha_full(T, d, pt, cv):
            # Recompute full-query mahalanobis for the fixed-correspondence
            # error evaluations of the LM lambda search (replicated).
            accept = src_valid & (d < mcd * mcd)
            w = accept.astype(jnp.float32)
            rcr = (sym6_to_mat(cv)
                   + T[:3, :3] @ sym6_to_mat(src_cov6) @ T[:3, :3].T)
            return _inv3_sym(rcr) * w[:, None, None]

        def fixed_error(T, d, pt, maha):
            transed = src_xyz @ T[:3, :3].T + T[:3, 3]
            e = pt - transed
            return jnp.einsum("ni,nij,nj->", e, maha, e,
                              precision=jax.lax.Precision.HIGHEST)

        def inner_lm(x0, corr, H, b, y0, lm_lambda):
            d_, pt_, maha_ = corr
            lm_lambda = jnp.where(
                lm_lambda < 0.0,
                cfg.init_lambda_factor * jnp.max(jnp.abs(jnp.diag(H))),
                lm_lambda)

            def cond(c):
                i, done, *_ = c
                return (i < cfg.lm_max_iterations) & ~done

            def body(c):
                i, _done, _acc, lam, nu, x, y, dT = c
                A = H + lam * jnp.eye(6)
                dvec = jnp.linalg.solve(A, -b)
                delta = _delta_to_T(dvec)
                xi = delta @ x
                yi = fixed_error(xi, d_, pt_, maha_)
                rho = (y0 - yi) / jnp.dot(dvec, lam * dvec - b)
                reject = rho < 0
                conv_on_reject = reject & _is_converged(
                    delta, cfg.rotation_epsilon, cfg.transformation_epsilon)
                lam_new = jnp.where(
                    reject, nu * lam,
                    lam * jnp.maximum(1.0 / 3.0,
                                      1.0 - (2.0 * rho - 1.0) ** 3))
                nu_new = jnp.where(reject, 2.0 * nu, 2.0)
                x_new = jnp.where(reject, x, xi)
                y_new = jnp.where(reject, y, yi)
                done = ~reject | conv_on_reject
                return (i + 1, done, done, lam_new, nu_new, x_new, y_new,
                        delta)

            init = (jnp.int32(0), jnp.array(False), jnp.array(False),
                    lm_lambda, jnp.float32(2.0), x0, y0, jnp.eye(4))
            (_, _, accepted, lam, _, x_new, y_new, delta) = \
                jax.lax.while_loop(cond, body, init)
            return accepted, x_new, lam, delta, y_new

        def outer_cond(c):
            i, converged, failed, *_ = c
            return (i < cfg.max_iterations) & ~converged & ~failed

        def outer_body(c):
            i, _conv, _failed, x0, lam, _H, _err, _n = c
            corr, H, b, y0, n = linearize(x0)
            accepted, x_new, lam_new, delta, y_new = inner_lm(
                x0, corr, H, b, y0, lam)
            converged = accepted & _is_converged(
                delta, cfg.rotation_epsilon, cfg.transformation_epsilon)
            return (i + 1, converged, ~accepted, x_new, lam_new, H, y_new, n)

        init = (jnp.int32(0), jnp.array(False), jnp.array(False),
                jnp.eye(4), jnp.float32(-1.0), jnp.eye(6), jnp.float32(0.0),
                jnp.int32(0))
        iters, converged, _failed, T, _lam, H, err, n = jax.lax.while_loop(
            outer_cond, outer_body, init)
        return T, H, err, iters, converged, n

    fn = jax.shard_map(
        spmd, mesh=mesh,
        in_specs=(P(), P(), P(), P(axis), P(axis), P()),
        out_specs=(P(), P(), P(), P(), P(), P()),
        check_vma=False)
    T, H, err, iters, converged, n = fn(src_xyz, src_valid, src_cov6,
                                        tgt_xyz, tgt_cov6, mcd)
    return AlignResult(T, H, err, iters, converged, n)


def collective_traffic_per_align(cfg: GicpConfig, nq: int, ndev: int,
                                 outer_iters: int | None = None) -> dict:
    """Analytical per-device collective traffic of one sharded_gicp_align.

    Per relinearize (outer iteration) each device all-REDUCES:
    - the candidate distance (pmin, nq * 4 B) and winning device id
      (pmin, nq * 4 B);
    - the winner-masked NN payload (psum: point 12 B + cov 24 B per query);
    - the reduced normal equations (psum: H 36 + b 6 + err 1 + n 1 floats,
      176 B — noise).

    A ring all-reduce of M bytes moves 2 * (ndev-1)/ndev * M < 2*M bytes
    through each device, so per-align traffic is FLAT in device count —
    unlike an all-gather design, which receives O(ndev) per query. Pinned
    against the compiled HLO in
    tests/test_parallel.py::test_collective_traffic_matches_hlo (no
    all-gather instructions; all-reduce element totals
    independent of ndev), and reported by scripts/bench_scaling.py next to
    scans/s so the >= 70 % multi-host scaling target carries its
    communication budget.
    """
    it = cfg.max_iterations if outer_iters is None else outer_iters
    per_query_reduce_bytes = 4 + 4 + 12 + 24          # d, win id, pt, cov
    ring = 2.0 * (ndev - 1) / max(ndev, 1)
    reduce_recv = int(ring * nq * per_query_reduce_bytes)
    psum_bytes = int(ring * (36 + 6 + 1 + 1) * 4)
    return {
        "per_relinearize_reduce_elements": nq * (1 + 1 + 3 + 6) + 44,
        "per_relinearize_reduce_recv_bytes": reduce_recv,
        "per_relinearize_psum_bytes": psum_bytes,
        "max_outer_iters": it,
        "per_align_recv_bytes_max": it * (reduce_recv + psum_bytes),
        "flat_in_devices": True,
    }

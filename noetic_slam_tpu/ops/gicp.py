"""GICP scan-to-map registration engine — a NanoGICP equivalent in JAX.

Re-designs the reference registration stack (nano_gicp + LsqRegistration,
src/dlio/src/nano_gicp/nano_gicp.cc:52-394 and lsq_registration.cc:52-231)
as batched, statically-shaped JAX computations:

- ``plane_covariances``: per-point kNN covariance with PLANE regularization
  (eigenvalues -> (1, 1, 1e-3); nano_gicp.cc:330-392) via batched ``eigh``
  instead of per-point JacobiSVD, plus the source-density metric.
- ``update_correspondences``: 1-NN (ops.neighbors) + per-pair
  Mahalanobis M = (C_B + R C_A R^T)^-1 as a closed-form 3x3 inverse
  (nano_gicp.cc:206-245; the reference's 4x4 inverse reduces to this since
  row/col 3 of the covariances are zero).
- ``linearize``: H (6x6) / b (6) accumulation as einsum segment-sums
  (nano_gicp.cc:248-302) — replaces the OpenMP reduction.
- ``gicp_align``: the Levenberg-Marquardt trust-region loop
  (lsq_registration.cc:108-229) under ``lax.while_loop`` with the exact
  rho/lambda/nu schedule and convergence tests.

Covariances are stored compactly as 6-vectors (xx, xy, xz, yy, yz, zz).
State parametrization: delta = exp(so3 d[0:3]) with translation d[3:6],
applied as x0 <- delta * x0 (left multiplication), matching the reference.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from noetic_slam_tpu.config.params import GicpConfig
from noetic_slam_tpu.ops import gridnn, neighbors
from noetic_slam_tpu.utils.geometry import quat_to_mat, skew, so3_exp_quat

Array = jax.Array


# ---------------------------------------------------------------------------
# Compact symmetric 3x3 <-> full helpers
# ---------------------------------------------------------------------------

def sym6_to_mat(c: Array) -> Array:
    """(..., 6) (xx,xy,xz,yy,yz,zz) -> (..., 3, 3)."""
    xx, xy, xz, yy, yz, zz = jnp.moveaxis(c, -1, 0)
    m = jnp.stack([xx, xy, xz, xy, yy, yz, xz, yz, zz], axis=-1)
    return m.reshape(c.shape[:-1] + (3, 3))


def mat_to_sym6(m: Array) -> Array:
    return jnp.stack([m[..., 0, 0], m[..., 0, 1], m[..., 0, 2],
                      m[..., 1, 1], m[..., 1, 2], m[..., 2, 2]], axis=-1)


def rotate_sym6(c: Array, R: Array) -> Array:
    """R C R^T for compact covariances; R broadcastable (..., 3, 3)."""
    return mat_to_sym6(jnp.einsum(
        "...ij,...jk,...lk->...il", R, sym6_to_mat(c), R,
        precision=jax.lax.Precision.HIGHEST))


def _inv3_sym(m: Array) -> Array:
    """Closed-form inverse of symmetric 3x3 (batched) via adjugate."""
    a, b, c = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    d, e = m[..., 1, 1], m[..., 1, 2]
    f = m[..., 2, 2]
    A = d * f - e * e
    B = c * e - b * f
    C = b * e - c * d
    det = a * A + b * B + c * C
    inv_det = 1.0 / jnp.where(jnp.abs(det) > 1e-30, det, 1e-30)
    D = a * f - c * c
    E = b * c - a * e
    F = a * d - b * b
    adj = jnp.stack([A, B, C, B, D, E, C, E, F], axis=-1)
    return adj.reshape(m.shape) * inv_det[..., None, None]


# ---------------------------------------------------------------------------
# Covariance estimation (nano_gicp.cc:330-392)
# ---------------------------------------------------------------------------

def _smallest_eigvec_sym3(m: Array) -> Array:
    """Unit eigenvector of the smallest eigenvalue of symmetric 3x3 (batched).

    Closed form (no LAPACK): trigonometric eigenvalues (Smith's algorithm)
    + null-space cross products — replaces the reference's per-point
    JacobiSVD (nano_gicp.cc:367) as elementwise math instead of a
    batched eigh.
    """
    a00, a01, a02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    a11, a12, a22 = m[..., 1, 1], m[..., 1, 2], m[..., 2, 2]
    q = (a00 + a11 + a22) / 3.0
    p1 = a01 * a01 + a02 * a02 + a12 * a12
    b00, b11, b22 = a00 - q, a11 - q, a22 - q
    p2 = b00 * b00 + b11 * b11 + b22 * b22 + 2.0 * p1
    p = jnp.sqrt(jnp.maximum(p2, 1e-30) / 6.0)
    # det((A - qI)/p) / 2
    detb = (b00 * (b11 * b22 - a12 * a12)
            - a01 * (a01 * b22 - a12 * a02)
            + a02 * (a01 * a12 - b11 * a02))
    r = jnp.clip(detb / (2.0 * p * p * p), -1.0, 1.0)
    phi = jnp.arccos(r) / 3.0
    lam_min = q + 2.0 * p * jnp.cos(phi + 2.0 * jnp.pi / 3.0)

    # Null direction of (A - lam_min I): cross products of row pairs; take
    # the best-conditioned one.
    r0 = jnp.stack([a00 - lam_min, a01, a02], axis=-1)
    r1 = jnp.stack([a01, a11 - lam_min, a12], axis=-1)
    r2 = jnp.stack([a02, a12, a22 - lam_min], axis=-1)
    c01 = jnp.cross(r0, r1)
    c02 = jnp.cross(r0, r2)
    c12 = jnp.cross(r1, r2)
    n01 = jnp.sum(c01 * c01, axis=-1, keepdims=True)
    n02 = jnp.sum(c02 * c02, axis=-1, keepdims=True)
    n12 = jnp.sum(c12 * c12, axis=-1, keepdims=True)
    best = jnp.where(n01 > n02, c01, c02)
    bestn = jnp.maximum(n01, n02)
    best = jnp.where(bestn > n12, best, c12)
    bestn = jnp.maximum(bestn, n12)
    # Isotropic/degenerate fallback: any unit vector works.
    ez = jnp.zeros_like(best).at[..., 2].set(1.0)
    ok = (bestn[..., 0] > 1e-20) & (p2 > 1e-20)
    v = jnp.where(ok[..., None], best, ez)
    return v / jnp.linalg.norm(v, axis=-1, keepdims=True)


@partial(jax.jit, static_argnames=("k", "use_grid", "max_per_cell"))
def plane_covariances(xyz: Array, valid: Array, k: int = 16,
                      use_grid: bool = False, cell: float = 1.0,
                      max_per_cell: int = 64):
    """Per-point plane-regularized covariances + source density.

    For each point: take its k nearest neighbors *within the same cloud*
    (self included, as in the reference where the query cloud is the kd-tree
    cloud), form the neighbor covariance (divided by k), and regularize its
    eigenvalues to (1, 1, 1e-3).

    Returns:
      covs: (N, 6) compact covariances (identity-ish for invalid points).
      density: () mean over valid points of sum(sqd[1:]) / ((k-1)(k+2)/2)
        (nano_gicp.cc:346-348, 389).
    """
    if use_grid:
        grid = gridnn.build_grid(xyz, valid, cell)
        idx, sqd = gridnn.grid_knn(xyz, grid, k, max_per_cell=max_per_cell)
        # Missing neighbors (sqd = inf beyond the 27-cell reach): substitute
        # the query point itself — zero covariance contribution, and the
        # density metric masks them below.
        found = jnp.isfinite(sqd)
        idx = jnp.where(found, idx, 0)
        nb = jnp.where(found[..., None], xyz[idx], xyz[:, None, :])
        sqd = jnp.where(found, sqd, 0.0)
    else:
        idx, sqd = neighbors.knn(xyz, xyz, k)
        nb = xyz[idx]                               # (N, k, 3)
    mean = jnp.mean(nb, axis=1, keepdims=True)
    d = nb - mean
    cov = jnp.einsum("nki,nkj->nij", d, d,
                    precision=jax.lax.Precision.HIGHEST) / k      # (N, 3, 3)

    # PLANE regularization: replace singular values with (1, 1, 1e-3), i.e.
    # V diag(1,1,1e-3) V^T = I - (1 - 1e-3) n n^T with n the smallest-
    # eigenvalue direction (the local surface normal). Closed form — no
    # batched eigh.
    n = _smallest_eigvec_sym3(cov)
    eye = jnp.eye(3, dtype=cov.dtype)
    reg = eye - (1.0 - 1e-3) * n[..., :, None] * n[..., None, :]
    reg = jnp.where(valid[:, None, None], reg, eye)

    norm = ((k - 1) * (2 + k)) / 2.0
    per_point = jnp.sum(sqd[:, 1:], axis=-1) / norm
    w = valid.astype(xyz.dtype)
    density = jnp.sum(per_point * w) / jnp.maximum(w.sum(), 1.0)
    return mat_to_sym6(reg), density


@partial(jax.jit, static_argnames=("chunk",))
def radius_covariances(xyz: Array, valid: Array, radius: float = 0.5,
                       chunk: int = 1024):
    """Plane covariances from Gaussian radius-weighted neighborhoods —
    the matmul-only alternative to kNN covariances.

    Rationale: PLANE regularization (nano_gicp.cc:367-371) discards the
    eigenvalues entirely and keeps only the *normal direction*; any
    neighborhood estimator with the same principal directions yields the
    same regularized covariance. Gaussian weights w = exp(-d^2 / (2 sigma^2))
    (sigma = radius/2) give weighted moments

        s_i = sum_j w_ij,  m_i = sum_j w_ij x_j,  S_i = sum_j w_ij x_j x_j^T

    as three matmuls over the d^2 tiles — no top_k, no gathers. The
    density metric is 2 sigma^2 / (effective neighbor count s_i), which
    tracks the local spacing^2 like the reference's kNN statistic
    (nano_gicp.cc:346-389) on uniform AND gradient sampling (pinned by
    tests/test_gicp.py::test_radius_density_proxy_tracks_knn_statistic).

    Returns (covs (N, 6), density ()).
    """
    n = xyz.shape[0]
    if n % chunk:
        chunk = n  # small capacities: single chunk
    w_valid = valid.astype(jnp.float32)
    cnt = jnp.maximum(w_valid.sum(), 1.0)
    c = jnp.sum(xyz * w_valid[:, None], axis=0) / cnt
    xc = (xyz - c) * w_valid[:, None]     # invalid -> origin (masked below)
    sig2 = (radius * 0.5) ** 2

    xx = jnp.sum(xc * xc, axis=-1)
    feats = jnp.concatenate(
        [jnp.ones((n, 1)), xc,
         jnp.stack([xc[:, 0] * xc[:, 0], xc[:, 0] * xc[:, 1],
                    xc[:, 0] * xc[:, 2], xc[:, 1] * xc[:, 1],
                    xc[:, 1] * xc[:, 2], xc[:, 2] * xc[:, 2]], axis=-1),
         xx[:, None]], axis=-1) * w_valid[:, None]        # (N, 11)

    def per_chunk(q):
        qx, qxx = q[:, :3], q[:, 3]
        d2 = (qxx[:, None] - 2.0 * jnp.dot(
            qx, xc.T, precision=jax.lax.Precision.HIGHEST) + xx[None, :])
        w = jnp.exp(-d2 / (2.0 * sig2)) * w_valid[None, :]
        return jnp.dot(w, feats, precision=jax.lax.Precision.HIGHEST)

    q_all = jnp.concatenate([xc, xx[:, None]], axis=-1).reshape(
        -1, chunk, 4)
    mom = jax.lax.map(per_chunk, q_all)
    mom = mom.reshape(n, 11)

    s = jnp.maximum(mom[:, 0], 1e-6)
    mu = mom[:, 1:4] / s[:, None]
    S6 = mom[:, 4:10] / s[:, None]
    mumu = jnp.stack([mu[:, 0] * mu[:, 0], mu[:, 0] * mu[:, 1],
                      mu[:, 0] * mu[:, 2], mu[:, 1] * mu[:, 1],
                      mu[:, 1] * mu[:, 2], mu[:, 2] * mu[:, 2]], axis=-1)
    cov = sym6_to_mat(S6 - mumu)

    nrm = _smallest_eigvec_sym3(cov)
    eye = jnp.eye(3)
    reg = eye - (1.0 - 1e-3) * nrm[..., :, None] * nrm[..., None, :]
    reg = jnp.where(valid[:, None, None], reg, eye)

    # Density estimate from the effective neighbor COUNT, not the mean
    # weighted sq-dist: the Gaussian-weighted mean sq-dist saturates at the
    # window scale (~2 sigma^2) once sampling is dense, so it tracks the
    # kernel radius instead of the point spacing (measured: flat under a
    # 3.2x density change — tests/test_gicp.py pins this). For a surface
    # sampled at spacing h, the weighted count s = sum_j exp(-d2/2 sig^2)
    # ~ 2 pi sig^2 / h^2 (2D Riemann sum incl. self), so 2 sig^2 / s
    # ~ h^2 / pi, which matches the reference kNN statistic
    # sum(sqd[1:]) / ((k-1)(k+2)/2) ~ 0.32 h^2 (nano_gicp.cc:346-389)
    # within ~3% on uniform grids and ~15% under 4x-gradient sampling.
    # Sparse limit (no neighbors in the window): s -> 1, estimate
    # saturates at 2 sig^2 — large, i.e. "sparse", the right direction
    # for the adaptive consumer (an LPF + hard clip, odom.cc:1612-1621).
    per_point = 2.0 * sig2 / jnp.maximum(mom[:, 0], 1.0)
    density = jnp.sum(per_point * w_valid) / cnt
    return mat_to_sym6(reg), density


# ---------------------------------------------------------------------------
# Correspondences + linearization (nano_gicp.cc:206-302)
# ---------------------------------------------------------------------------

class Correspondences(NamedTuple):
    tgt_idx: Array   # (N,) int32 target index
    maha: Array      # (N, 3, 3) Mahalanobis weight
    weight: Array    # (N,) 1.0 for accepted pairs else 0.0
    count: Array     # () number of accepted pairs


def update_correspondences(src_xyz: Array, src_valid: Array, src_cov6: Array,
                           tgt_xyz: Array, tgt_cov6: Array, T: Array,
                           max_corr_dist: Array,
                           target_grid=None, max_per_cell: int = 64,
                           target_count: Array | None = None
                           ) -> Correspondences:
    """NN correspondences + Mahalanobis weights at transform T (4x4).

    With ``target_grid`` (ops.gridnn.Grid over tgt_xyz, cell >= the max
    correspondence distance) the search is grid-bucketed — exact for the
    thresholded correspondences GICP keeps; otherwise brute-force NN."""
    # HIGHEST: a reduced-precision matmul (TF32 keeps 10 mantissa
    # bits) quantizes ~30 m coords to centimeters (see deskew.transform_cloud)
    transed = jnp.dot(src_xyz, T[:3, :3].T,
                      precision=jax.lax.Precision.HIGHEST) + T[:3, 3]
    if target_grid is not None:
        idx, sqd = gridnn.grid_nn1(transed, target_grid,
                                   max_per_cell=max_per_cell)
        idx = jnp.where(jnp.isfinite(sqd), idx, 0)
        sqd = jnp.where(jnp.isfinite(sqd), sqd, 1e30)
    else:
        # Cap the NN search at the correspondence threshold: pairs beyond it
        # are rejected below anyway, and the cap lets the fused kernel prune
        # every target tile farther than max_corr_dist from a query tile.
        idx, sqd = neighbors.nn1(transed, tgt_xyz, target_count,
                                 max_dist=max_corr_dist)
    accept = src_valid & (sqd < max_corr_dist * max_corr_dist)

    R = T[:3, :3]
    cov_a = sym6_to_mat(src_cov6)
    cov_b = sym6_to_mat(tgt_cov6[idx])
    rcr = cov_b + jnp.einsum("ij,njk,lk->nil", R, cov_a, R,
                             precision=jax.lax.Precision.HIGHEST)
    maha = _inv3_sym(rcr)
    w = accept.astype(src_xyz.dtype)
    maha = maha * w[:, None, None]
    return Correspondences(idx, maha, w, accept.sum())


def linearize(src_xyz: Array, tgt_xyz: Array, corr: Correspondences,
              T: Array):
    """Masked H/b/error accumulation at transform T (nano_gicp.cc:248-302).

    J = [skew(T p_src) | -I] (rows 0..2); H = sum J^T M J, b = sum J^T M e,
    e = p_tgt - T p_src. Accumulated in one einsum pass.
    """
    # HIGHEST: a reduced-precision matmul (TF32 keeps 10 mantissa
    # bits) quantizes ~30 m coords to centimeters (see deskew.transform_cloud)
    transed = jnp.dot(src_xyz, T[:3, :3].T,
                      precision=jax.lax.Precision.HIGHEST) + T[:3, 3]
    e = tgt_xyz[corr.tgt_idx] - transed               # (N, 3)
    J = jnp.concatenate(
        [skew(transed), -jnp.broadcast_to(jnp.eye(3, dtype=src_xyz.dtype),
                                          transed.shape + (3,))], axis=-1)

    MJ = corr.maha @ J                                # (N, 3, 6)
    H = jnp.einsum("nij,nik->jk", J, MJ, precision=jax.lax.Precision.HIGHEST)
    Me = jnp.einsum("nij,ni->nj", corr.maha, e,
                     precision=jax.lax.Precision.HIGHEST)       # (N, 3)
    b = jnp.einsum("nij,ni->j", J, Me, precision=jax.lax.Precision.HIGHEST)
    err = jnp.einsum("ni,ni->", e, Me, precision=jax.lax.Precision.HIGHEST)
    return H, b, err


def compute_error(src_xyz: Array, tgt_xyz: Array, corr: Correspondences,
                  T: Array) -> Array:
    """Sum of Mahalanobis errors at T with fixed correspondences
    (nano_gicp.cc:305-326)."""
    # HIGHEST: a reduced-precision matmul (TF32 keeps 10 mantissa
    # bits) quantizes ~30 m coords to centimeters (see deskew.transform_cloud)
    transed = jnp.dot(src_xyz, T[:3, :3].T,
                      precision=jax.lax.Precision.HIGHEST) + T[:3, 3]
    e = tgt_xyz[corr.tgt_idx] - transed
    return jnp.einsum("ni,nij,nj->", e, corr.maha, e,
                      precision=jax.lax.Precision.HIGHEST)


# ---------------------------------------------------------------------------
# Levenberg-Marquardt loop (lsq_registration.cc:108-229)
# ---------------------------------------------------------------------------

def _delta_to_T(d: Array) -> Array:
    """6-vector -> SE(3): rotation exp(d[0:3]), translation d[3:6]
    (lsq_registration.cc:192-197)."""
    T = jnp.eye(4, dtype=d.dtype)
    T = T.at[:3, :3].set(quat_to_mat(so3_exp_quat(d[:3])))
    T = T.at[:3, 3].set(d[3:])
    return T


def _is_converged(delta_T: Array, rot_eps: float, trans_eps: float) -> Array:
    """lsq_registration.cc:137-148."""
    R = delta_T[:3, :3] - jnp.eye(3, dtype=delta_T.dtype)
    t = delta_T[:3, 3]
    r_delta = jnp.max(jnp.abs(R)) / rot_eps
    t_delta = jnp.max(jnp.abs(t)) / trans_eps
    return jnp.maximum(r_delta, t_delta) < 1.0


class AlignResult(NamedTuple):
    T: Array            # (4, 4) final transformation ("T_corr")
    H: Array            # (6, 6) final hessian
    error: Array        # () final cost
    iterations: Array   # () outer iterations executed
    converged: Array    # () bool
    num_corr: Array     # () correspondences at the last linearization


def gicp_align(src_xyz: Array, src_valid: Array, src_cov6: Array,
               tgt_xyz: Array, tgt_cov6: Array,
               cfg: GicpConfig, max_corr_dist: Array | float | None = None,
               guess: Array | None = None, target_grid=None,
               max_per_cell: int = 64,
               target_count: Array | None = None) -> AlignResult:
    """Full GICP alignment: LM over SE(3) with per-iteration correspondence
    refresh, replicating NanoGICP::computeTransformation +
    LsqRegistration::computeTransformation/step_lm.

    ``max_corr_dist`` may be a traced scalar (the adaptive-params path,
    odom.cc:1612-1621, tunes it at runtime); defaults to cfg.max_corr_dist.
    """
    dtype = src_xyz.dtype
    if guess is None:
        guess = jnp.eye(4, dtype=dtype)
    mcd = jnp.asarray(cfg.max_corr_dist if max_corr_dist is None
                      else max_corr_dist, dtype)

    def relinearize(T):
        corr = update_correspondences(src_xyz, src_valid, src_cov6,
                                      tgt_xyz, tgt_cov6, T, mcd,
                                      target_grid=target_grid,
                                      max_per_cell=max_per_cell,
                                      target_count=target_count)
        H, b, y0 = linearize(src_xyz, tgt_xyz, corr, T)
        return corr, H, b, y0

    def inner_lm(x0, corr, H, b, y0, lm_lambda):
        """One step_lm lambda search (lsq_registration.cc:181-229).

        Returns (accepted, x_new, lambda_new, delta_T, H, y_new).
        """
        lm_lambda = jnp.where(
            lm_lambda < 0.0,
            cfg.init_lambda_factor * jnp.max(jnp.abs(jnp.diag(H))),
            lm_lambda)

        def cond(c):
            i, done, *_ = c
            return (i < cfg.lm_max_iterations) & ~done

        def body(c):
            i, _done, _acc, lam, nu, x, y, dT = c
            A = H + lam * jnp.eye(6, dtype=dtype)
            d = jnp.linalg.solve(A, -b)
            delta = _delta_to_T(d)
            xi = delta @ x
            yi = compute_error(src_xyz, tgt_xyz, corr, xi)
            rho = (y0 - yi) / jnp.dot(d, lam * d - b)

            reject = rho < 0
            conv_on_reject = reject & _is_converged(
                delta, cfg.rotation_epsilon, cfg.transformation_epsilon)
            # Accept: move, shrink lambda. Reject: grow lambda (unless the
            # trial step itself is below the convergence threshold, which
            # ends the search with x unchanged).
            lam_new = jnp.where(
                reject, nu * lam,
                lam * jnp.maximum(1.0 / 3.0, 1.0 - (2.0 * rho - 1.0) ** 3))
            nu_new = jnp.where(reject, 2.0 * nu, 2.0)
            x_new = jnp.where(reject, x, xi)
            y_new = jnp.where(reject, y, yi)
            done = ~reject | conv_on_reject
            return (i + 1, done, ~reject | conv_on_reject, lam_new, nu_new,
                    x_new, y_new, delta)

        init = (jnp.int32(0), jnp.array(False), jnp.array(False), lm_lambda,
                jnp.asarray(2.0, dtype), x0, y0, jnp.eye(4, dtype=dtype))
        (_, _, accepted, lam, _, x_new, y_new, delta) = jax.lax.while_loop(
            cond, body, init)
        return accepted, x_new, lam, delta, y_new

    def outer_cond(c):
        i, converged, failed, *_ = c
        return (i < cfg.max_iterations) & ~converged & ~failed

    def outer_body(c):
        i, _conv, _failed, x0, lam, _H, _err, _ncorr = c
        corr, H, b, y0 = relinearize(x0)
        accepted, x_new, lam_new, delta, y_new = inner_lm(
            x0, corr, H, b, y0, lam)
        converged = accepted & _is_converged(
            delta, cfg.rotation_epsilon, cfg.transformation_epsilon)
        return (i + 1, converged, ~accepted, x_new, lam_new, H, y_new,
                corr.count)

    init = (jnp.int32(0), jnp.array(False), jnp.array(False),
            guess.astype(dtype), jnp.asarray(-1.0, dtype),
            jnp.eye(6, dtype=dtype), jnp.asarray(0.0, dtype), jnp.int32(0))
    (iters, converged, _failed, T, _lam, H, err, ncorr) = jax.lax.while_loop(
        outer_cond, outer_body, init)
    return AlignResult(T, H, err, iters, converged, ncorr)

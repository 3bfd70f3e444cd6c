"""Keyframe pose-graph optimization with loop closure.

New capability relative to the reference checkout (its odometry is pure
dead-reckoning + submap registration; BASELINE.json requires "keyframe
pose-graph optimization with loop closure" as part of the complete system).
Designed for the accelerator:

- the graph is fixed-capacity arrays (nodes = keyframe poses, edges =
  relative SE(3) measurements with rotation/translation weights);
- Gauss-Newton with SO(3) x R^3 residuals: r_R = Log(R_meas^T R_i^T R_j),
  r_t = t_j - t_i - R_i t_meas, first-order Jacobians; the full (6K x 6K)
  normal system is assembled by segment-sums over edges and solved densely
  (K <= a few hundred keyframes -> <= ~3k x 3k, one dense solve);
- gauge freedom fixed by a strong prior on node 0;
- loop-closure candidates by keyframe proximity with an index-gap guard,
  verified and measured by GICP between the stored keyframe clouds;
- ``apply_pose_update`` rigidly re-transforms keyframe clouds/covariances
  (map deformation after closure).

The distributed variant (edge shards + psum of reduced blocks) lives in
parallel/bundle_adjustment.py.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from noetic_slam_tpu.config.params import GicpConfig
from noetic_slam_tpu.ops import gicp as gicp_ops
from noetic_slam_tpu.utils.geometry import (
    quat_conj,
    quat_mul,
    quat_normalize,
    quat_rotate,
    quat_to_mat,
    skew,
    so3_exp_quat,
    so3_log_quat,
)

Array = jax.Array


class PoseGraph(NamedTuple):
    node_q: Array     # (K, 4)
    node_p: Array     # (K, 3)
    n_nodes: Array    # () int32
    edge_i: Array     # (E,) int32
    edge_j: Array     # (E,) int32
    edge_dq: Array    # (E, 4) measured q_i^-1 * q_j
    edge_dp: Array    # (E, 3) measured R_i^T (p_j - p_i)
    edge_w_rot: Array # (E,)
    edge_w_trans: Array  # (E,)
    edge_valid: Array    # (E,) bool
    n_edges: Array    # () int32


def init_graph(max_nodes: int, max_edges: int) -> PoseGraph:
    f32 = jnp.float32
    return PoseGraph(
        node_q=jnp.tile(jnp.asarray([1.0, 0, 0, 0], f32), (max_nodes, 1)),
        node_p=jnp.zeros((max_nodes, 3), f32),
        n_nodes=jnp.int32(0),
        edge_i=jnp.zeros((max_edges,), jnp.int32),
        edge_j=jnp.zeros((max_edges,), jnp.int32),
        edge_dq=jnp.tile(jnp.asarray([1.0, 0, 0, 0], f32), (max_edges, 1)),
        edge_dp=jnp.zeros((max_edges, 3), f32),
        edge_w_rot=jnp.zeros((max_edges,), f32),
        edge_w_trans=jnp.zeros((max_edges,), f32),
        edge_valid=jnp.zeros((max_edges,), bool),
        n_edges=jnp.int32(0),
    )


def add_node(g: PoseGraph, q: Array, p: Array) -> PoseGraph:
    K = g.node_q.shape[0]
    i = jnp.minimum(g.n_nodes, K - 1)
    ok = g.n_nodes < K
    return g._replace(
        node_q=g.node_q.at[i].set(jnp.where(ok, q, g.node_q[i])),
        node_p=g.node_p.at[i].set(jnp.where(ok, p, g.node_p[i])),
        n_nodes=g.n_nodes + ok.astype(jnp.int32))


def add_edge(g: PoseGraph, i: Array, j: Array, dq: Array, dp: Array,
             w_rot=1.0, w_trans=1.0, enabled=True) -> PoseGraph:
    E = g.edge_i.shape[0]
    e = jnp.minimum(g.n_edges, E - 1)
    ok = jnp.asarray(enabled) & (g.n_edges < E)
    sel = lambda new, old: jnp.where(ok, new, old)
    return g._replace(
        edge_i=g.edge_i.at[e].set(sel(i, g.edge_i[e])),
        edge_j=g.edge_j.at[e].set(sel(j, g.edge_j[e])),
        edge_dq=g.edge_dq.at[e].set(sel(dq, g.edge_dq[e])),
        edge_dp=g.edge_dp.at[e].set(sel(dp, g.edge_dp[e])),
        edge_w_rot=g.edge_w_rot.at[e].set(sel(w_rot, g.edge_w_rot[e])),
        edge_w_trans=g.edge_w_trans.at[e].set(sel(w_trans, g.edge_w_trans[e])),
        edge_valid=g.edge_valid.at[e].set(sel(True, g.edge_valid[e])),
        n_edges=g.n_edges + ok.astype(jnp.int32))


def grow(g: PoseGraph, max_nodes: int | None = None,
         max_edges: int | None = None) -> PoseGraph:
    """Return a graph with enlarged node/edge capacity, contents preserved.

    Saturation policy: ``add_node``/``add_edge`` saturate (no-op, count
    unchanged) rather than corrupt memory — but a silently dropped node
    leaves the odometry chain broken and any caller-held node id dangling.
    Callers that must never lose a node (SlamSystem.sync_graph) therefore
    check capacity and grow AHEAD of saturation; this keeps the pose graph
    unbounded over km-scale runs (the reference's keyframe store is
    unbounded, odom.cc:1517-1598) while every jitted consumer still sees
    static shapes (growth is a host-side O(K+E) reallocation at doubling
    cadence, so at most log2(total) recompiles of ``optimize``)."""
    K, E = g.node_q.shape[0], g.edge_i.shape[0]
    nK = max(max_nodes or K, K)
    nE = max(max_edges or E, E)
    if nK == K and nE == E:
        return g

    def pad(a, n, fill=0):
        if n == a.shape[0]:
            return a
        extra = jnp.full((n - a.shape[0],) + a.shape[1:], fill, a.dtype)
        return jnp.concatenate([a, extra], axis=0)

    ident = jnp.asarray([1.0, 0, 0, 0], jnp.float32)
    node_q = (g.node_q if nK == K else
              jnp.concatenate([g.node_q,
                               jnp.tile(ident, (nK - K, 1))], axis=0))
    edge_dq = (g.edge_dq if nE == E else
               jnp.concatenate([g.edge_dq,
                                jnp.tile(ident, (nE - E, 1))], axis=0))
    return PoseGraph(
        node_q=node_q, node_p=pad(g.node_p, nK), n_nodes=g.n_nodes,
        edge_i=pad(g.edge_i, nE), edge_j=pad(g.edge_j, nE),
        edge_dq=edge_dq, edge_dp=pad(g.edge_dp, nE),
        edge_w_rot=pad(g.edge_w_rot, nE),
        edge_w_trans=pad(g.edge_w_trans, nE),
        edge_valid=pad(g.edge_valid, nE, False), n_edges=g.n_edges)


def relative_pose(qi, pi, qj, pj):
    """Measured relative transform (dq, dp) of j in i's frame."""
    dq = quat_normalize(quat_mul(quat_conj(qi), qj))
    dp = quat_rotate(quat_conj(qi), pj - pi)
    return dq, dp


@partial(jax.jit, static_argnames=("m", "have_prev"))
def _add_chain(g: PoseGraph, qs, ps, count, prev_q, prev_p,
               m: int, have_prev: bool) -> PoseGraph:
    """Jitted body of add_nodes_chain (m = padded batch, static)."""
    K = g.node_q.shape[0]
    E = g.edge_i.shape[0]
    ks = jnp.arange(m)
    valid = ks < count
    start = g.n_nodes
    nidx = jnp.where(valid, start + ks, K)          # OOB rows are dropped
    node_q = g.node_q.at[nidx].set(qs, mode="drop")
    node_p = g.node_p.at[nidx].set(ps, mode="drop")
    # Chain edges: node (start+k-1) -> (start+k); the first edge links to
    # the previous chain tail (prev_q/prev_p at node start-1) when it
    # exists. relative_pose broadcasts over the batch.
    src_q = jnp.concatenate([prev_q[None], qs[:-1]], axis=0)
    src_p = jnp.concatenate([prev_p[None], ps[:-1]], axis=0)
    dq, dp = relative_pose(src_q, src_p, qs, ps)
    # Edge k is valid only if BOTH its endpoints exist: a node dropped at
    # capacity must not leave a phantom chain edge referencing it (the
    # OOB gather in optimize would clamp it into a bogus self-constraint).
    evalid = valid if have_prev else (valid & (ks > 0))
    evalid = evalid & (start + ks < K)
    k0 = 0 if have_prev else 1
    eidx = jnp.where(evalid, g.n_edges + ks - k0, E)
    ones = jnp.ones((m,), jnp.float32)
    # Saturate the counters at capacity, matching add_node/add_edge:
    # overflowing writes are dropped by mode="drop" above, so advancing
    # the counts past K/E would leave them pointing at identity rows
    # (SlamSystem.sync_graph grows ahead of saturation, but an unguarded
    # caller must not be able to corrupt the counts).
    return g._replace(
        node_q=node_q, node_p=node_p,
        n_nodes=jnp.minimum(start + count.astype(jnp.int32), K),
        edge_i=g.edge_i.at[eidx].set((start + ks - 1).astype(jnp.int32),
                                     mode="drop"),
        edge_j=g.edge_j.at[eidx].set((start + ks).astype(jnp.int32),
                                     mode="drop"),
        edge_dq=g.edge_dq.at[eidx].set(dq, mode="drop"),
        edge_dp=g.edge_dp.at[eidx].set(dp, mode="drop"),
        edge_w_rot=g.edge_w_rot.at[eidx].set(ones, mode="drop"),
        edge_w_trans=g.edge_w_trans.at[eidx].set(ones, mode="drop"),
        edge_valid=g.edge_valid.at[eidx].set(evalid, mode="drop"),
        n_edges=jnp.minimum(g.n_edges + jnp.sum(evalid).astype(jnp.int32),
                            E))


def add_nodes_chain(g: PoseGraph, qs, ps, count: int,
                    prev_q=None, prev_p=None) -> PoseGraph:
    """Append ``count`` nodes and their odometry-chain edges in ONE jitted
    dispatch.

    The equivalent per-node eager add_node/relative_pose/add_edge sequence
    is ~30 tiny device ops per keyframe, each a separate dispatch. This
    path makes keyframe-graph sync
    O(1) dispatches per batch. Callers must ensure capacity beforehand
    (SlamSystem.sync_graph grows ahead of saturation).

    ``qs (count,4)``/``ps (count,3)`` are host arrays; they are padded to a
    power-of-two bucket so at most log2(max-batch) variants compile.
    ``prev_q/prev_p`` (pose of node ``n_nodes-1``) chain the first new node
    to the existing tail; None on the very first keyframe ever."""
    import numpy as np

    count = int(count)
    if count == 0:
        return g
    m = max(1, 1 << (count - 1).bit_length())
    qs_p = np.zeros((m, 4), np.float32)
    qs_p[:, 0] = 1.0
    ps_p = np.zeros((m, 3), np.float32)
    qs_p[:count] = np.asarray(qs, np.float32)[:count]
    ps_p[:count] = np.asarray(ps, np.float32)[:count]
    have_prev = prev_q is not None
    pq = (np.asarray(prev_q, np.float32) if have_prev
          else np.array([1.0, 0, 0, 0], np.float32))
    pp = (np.asarray(prev_p, np.float32) if have_prev
          else np.zeros(3, np.float32))
    return _add_chain(g, jnp.asarray(qs_p), jnp.asarray(ps_p),
                      jnp.int32(count), jnp.asarray(pq), jnp.asarray(pp),
                      m, have_prev)


def _edge_terms(g: PoseGraph):
    """Per-edge residuals + Jacobian blocks (first order).

    r_R = Log(dq_meas^-1 * q_i^-1 * q_j)           (3,)
    r_t = R_i^T (p_j - p_i) - dp_meas              (3,)

    with left-multiplicative node perturbations
    q_k <- Exp(w_k) q_k, p_k <- p_k + v_k:
      dr_R/dw_j =  R_i^T,  dr_R/dw_i = -R_i^T          (first order)
      dr_t/dv_j =  R_i^T,  dr_t/dv_i = -R_i^T
      dr_t/dw_i =  R_i^T skew(p_j - p_i)
    """
    qi = g.node_q[g.edge_i]
    pi = g.node_p[g.edge_i]
    qj = g.node_q[g.edge_j]
    pj = g.node_p[g.edge_j]

    q_rel = quat_mul(quat_conj(qi), qj)
    r_R = so3_log_quat(quat_mul(quat_conj(g.edge_dq), q_rel))
    r_t = quat_rotate(quat_conj(qi), pj - pi) - g.edge_dp

    Ri_T = jnp.swapaxes(quat_to_mat(qi), -1, -2)         # (E, 3, 3)
    J_t_wi = Ri_T @ skew(pj - pi)                        # (E, 3, 3)
    return r_R, r_t, Ri_T, J_t_wi


def _assemble(g: PoseGraph, K: int):
    """Dense H (6K, 6K), b (6K,) from all valid edges via scatter-adds."""
    r_R, r_t, Ri_T, J_t_wi = _edge_terms(g)
    wr = (g.edge_w_rot * g.edge_valid)[:, None, None]
    wt = (g.edge_w_trans * g.edge_valid)[:, None, None]

    # Variables per node: [w (3), v (3)]; per-edge Jacobian stacked as
    # (E, 6res, 12vars), 12 vars = [w_i v_i w_j v_j].
    A = Ri_T                       # dr_R/dw_j = dr_t/dv_j
    B = J_t_wi                     # dr_t/dw_i
    E = g.edge_i.shape[0]
    zeros3 = jnp.zeros((E, 3, 3))
    Jr = jnp.concatenate([
        jnp.concatenate([-A, zeros3, A, zeros3], axis=-1),     # r_R row
        jnp.concatenate([B, -A, zeros3, A], axis=-1),          # r_t row
    ], axis=-2)                                                # (E, 6, 12)
    W = jnp.concatenate([jnp.broadcast_to(wr, (E, 3, 1)),
                         jnp.broadcast_to(wt, (E, 3, 1))], axis=-2)  # (E,6,1)
    r = jnp.concatenate([r_R, r_t], axis=-1)                    # (E, 6)

    JW = Jr * W                                                # (E, 6, 12)
    Hblk = jnp.einsum("eri,erj->eij", JW, Jr,
                      precision=jax.lax.Precision.HIGHEST)     # (E,12,12)
    bblk = jnp.einsum("eri,er->ei", JW, r,
                      precision=jax.lax.Precision.HIGHEST)     # (E,12)

    H = jnp.zeros((K * 6, K * 6))
    b = jnp.zeros((K * 6,))
    ii = g.edge_i * 6
    jj = g.edge_j * 6
    base = jnp.stack([ii, ii + 3, jj, jj + 3], axis=-1)        # (E, 4)
    off = jnp.arange(3)
    rows = (base[:, :, None] + off[None, None, :]).reshape(E, 12)
    H = H.at[rows[:, :, None], rows[:, None, :]].add(Hblk)
    b = b.at[rows].add(bblk)
    return H, b


def _edge_jacobian_blocks(g: PoseGraph):
    """Per-edge stacked Jacobian (E, 6res, 12vars), weights (E, 6) and
    residuals (E, 6) — shared by the dense assembly and the matrix-free
    matvec. Vars per node: [w (3), v (3)]; cols = [w_i v_i w_j v_j]."""
    r_R, r_t, Ri_T, J_t_wi = _edge_terms(g)
    E = g.edge_i.shape[0]
    zeros3 = jnp.zeros((E, 3, 3))
    A = Ri_T
    Jr = jnp.concatenate([
        jnp.concatenate([-A, zeros3, A, zeros3], axis=-1),     # r_R row
        jnp.concatenate([J_t_wi, -A, zeros3, A], axis=-1),     # r_t row
    ], axis=-2)                                                # (E, 6, 12)
    wvec = jnp.concatenate([
        jnp.broadcast_to((g.edge_w_rot * g.edge_valid)[:, None], (E, 3)),
        jnp.broadcast_to((g.edge_w_trans * g.edge_valid)[:, None], (E, 3)),
    ], axis=-1)                                                # (E, 6)
    r = jnp.concatenate([r_R, r_t], axis=-1)                   # (E, 6)
    return Jr, wvec, r


def _gn_system_matfree(g: PoseGraph, K: int, damping: float,
                       psum_axis: str | None = None):
    """Matrix-free normal system for CG: returns (matvec, b, Minv) where
    matvec(x) = (H + diag) x computed EDGE-WISE — gather the two 6-blocks
    of x per edge, apply J W J^T locally, scatter-add back. O(E) work and
    memory instead of the dense (6K)^2; the per-node 6x6 block-Jacobi
    preconditioner comes from the same edge pass.

    ``psum_axis``: when set (inside a shard_map whose edge arrays are the
    local shard), every edge-sum — b, the matvec's scatter-add, and the
    preconditioner blocks — is combined across devices with a psum of the
    (K, 6)-shaped node accumulator; the node-diagonal terms are added once
    AFTER the reduction (they are replicated). This is the distributed-BA
    large-graph path (parallel/bundle_adjustment.sharded_optimize): O(E/D)
    work per device, collectives of O(K) per CG iteration."""
    Jr, wvec, r = _edge_jacobian_blocks(g)
    JW = Jr * wvec[:, :, None]                                 # (E, 6, 12)
    # per-edge 12x12 normal block + rhs
    Hblk = jnp.einsum("eri,erj->eij", JW, Jr,
                      precision=jax.lax.Precision.HIGHEST)     # (E,12,12)
    bblk = jnp.einsum("eri,er->ei", JW, r,
                      precision=jax.lax.Precision.HIGHEST)     # (E,12)

    psum = (lambda x: x) if psum_axis is None else (
        lambda x: jax.lax.psum(x, psum_axis))

    slot = jnp.arange(K)
    active = slot < g.n_nodes
    diag = jnp.where(active, damping, 1.0)                     # (K,)
    gauge = jnp.zeros((K,)).at[0].set(1e6)
    diag_all = diag + gauge                                    # (K,)

    ei, ej = g.edge_i, g.edge_j

    b = jnp.zeros((K, 6))
    b = b.at[ei].add(bblk[:, :6])
    b = b.at[ej].add(bblk[:, 6:])
    b = psum(b)

    def matvec(x):                                             # x: (K, 6)
        xe = jnp.concatenate([x[ei], x[ej]], axis=-1)          # (E, 12)
        ye = jnp.einsum("eij,ej->ei", Hblk, xe)                # (E, 12)
        y = jnp.zeros((K, 6))
        y = y.at[ei].add(ye[:, :6])
        y = y.at[ej].add(ye[:, 6:])
        return psum(y) + diag_all[:, None] * x

    # block-Jacobi preconditioner: per-node 6x6 diagonal blocks
    Pblk = jnp.zeros((K, 6, 6))
    Pblk = Pblk.at[ei].add(Hblk[:, :6, :6])
    Pblk = Pblk.at[ej].add(Hblk[:, 6:, 6:])
    Pblk = psum(Pblk) + (diag_all[:, None, None]
                         * jnp.eye(6)[None, :, :])
    Pinv = jnp.linalg.inv(Pblk)                                # (K, 6, 6)

    def apply_prec(x):
        return jnp.einsum("kij,kj->ki", Pinv, x)

    return matvec, b, apply_prec


def _pcg(matvec, b, apply_prec, iters: int, tol: float = 1e-8):
    """Standard preconditioned conjugate gradient on the (K, 6) layout.

    The RHS is normalized first so the breakdown guards (``tol``) are
    scale-invariant: near a GN optimum b is tiny and absolute guards would
    freeze the solver at a gradient-norm-of-sqrt(tol) fixed point."""
    bn = jnp.sqrt(jnp.sum(b * b))
    scale = jnp.where(bn > 0, bn, 1.0)
    b = b / scale
    x = jnp.zeros_like(b)
    r = b - matvec(x)
    z = apply_prec(r)
    p = z
    rz = jnp.sum(r * z)

    def body(_, carry):
        x, r, p, rz = carry
        Ap = matvec(p)
        denom = jnp.sum(p * Ap)
        alpha = jnp.where(jnp.abs(denom) > tol, rz / denom, 0.0)
        x = x + alpha * p
        r = r - alpha * Ap
        z = apply_prec(r)
        rz_new = jnp.sum(r * z)
        beta = jnp.where(rz > tol, rz_new / jnp.maximum(rz, tol), 0.0)
        p = z + beta * p
        return x, r, p, rz_new

    x, _, _, _ = jax.lax.fori_loop(0, iters, body, (x, r, p, rz))
    return x * scale


@partial(jax.jit, static_argnames=("iters", "k_static", "method",
                                   "cg_iters"))
def optimize(g: PoseGraph, iters: int = 10, k_static: int | None = None,
             damping: float = 1e-6, method: str = "auto",
             cg_iters: int = 100) -> PoseGraph:
    """Gauss-Newton over all node poses; node 0 gauge-fixed by prior.

    ``method``: "dense" materializes H (6K, 6K) and LU-solves — exact,
    O(K^3), right up to a few hundred nodes; "cg" solves each GN step with
    matrix-free block-Jacobi-preconditioned conjugate gradient — O(E *
    cg_iters) work and O(E) memory, the city-scale path (SLAM pose graphs
    are near-chains: condition after block-Jacobi is mild and ~100 CG
    iterations reach solver noise; parity pinned in
    tests/test_posegraph.py::test_cg_matches_dense). "auto" switches to CG
    above 192 nodes.

    ``k_static``: solve over the first k_static node slots only (must be
    >= n_nodes; every edge must reference nodes < k_static). Lets a
    grown-capacity graph with few live nodes run a SMALL dense solve
    instead of a capacity-sized system — SlamSystem picks the solver and
    bucket by the live node count."""
    K = g.node_q.shape[0] if k_static is None else k_static
    if method == "auto":
        method = "cg" if K > 192 else "dense"

    def gn_step(_, g):
        if method == "dense":
            H, b = _assemble(g, K)
            # gauge prior on node 0 + damping + inactive-node regularization
            slot = jnp.arange(K * 6)
            active = (slot // 6) < g.n_nodes
            diag = jnp.where(active, damping, 1.0)
            diag = diag.at[:6].set(1e6)
            H = H + jnp.diag(diag)
            dx = jnp.linalg.solve(H, -b).reshape(K, 6)
        else:
            matvec, b, apply_prec = _gn_system_matfree(g, K, damping)
            dx = _pcg(matvec, -b, apply_prec, cg_iters)
        dw, dv = dx[:, :3], dx[:, 3:]
        ok = (jnp.arange(K) < g.n_nodes)[:, None]
        q_head = quat_normalize(quat_mul(
            so3_exp_quat(jnp.where(ok, dw, 0.0)), g.node_q[:K]))
        p_head = g.node_p[:K] + jnp.where(ok, dv, 0.0)
        if K == g.node_q.shape[0]:
            return g._replace(node_q=q_head, node_p=p_head)
        return g._replace(node_q=g.node_q.at[:K].set(q_head),
                          node_p=g.node_p.at[:K].set(p_head))

    return jax.lax.fori_loop(0, iters, gn_step, g)


def graph_cost(g: PoseGraph) -> Array:
    r_R, r_t, _, _ = _edge_terms(g)
    w = g.edge_valid
    return jnp.sum((g.edge_w_rot * jnp.sum(r_R ** 2, -1)
                    + g.edge_w_trans * jnp.sum(r_t ** 2, -1)) * w)


# ---------------------------------------------------------------------------
# Loop closure
# ---------------------------------------------------------------------------

def detect_loop_candidate(kf_pos: Array, kf_count: Array, cur_idx: Array,
                          radius: float, min_gap: int,
                          kf_seq: Array | None = None):
    """Best candidate keyframe for closing a loop with slot ``cur_idx``:
    nearest keyframe at least ``min_gap`` insertions older and within
    ``radius``. Age is measured by ``kf_seq`` (insertion sequence numbers;
    slot order stops being age order once the store evicts) — when None,
    slot order is used. Returns (slot, ok)."""
    K = kf_pos.shape[0]
    slots = jnp.arange(K)
    d = jnp.linalg.norm(kf_pos - kf_pos[cur_idx][None, :], axis=-1)
    if kf_seq is None:
        eligible = (slots < kf_count) & (slots <= cur_idx - min_gap)
    else:
        eligible = ((slots < kf_count) & (kf_seq > 0)
                    & (kf_seq <= kf_seq[cur_idx] - min_gap))
    d = jnp.where(eligible, d, jnp.inf)
    best = jnp.argmin(d)
    return best, d[best] < radius


def detect_loop_candidate_np(kf_pos, kf_seq, kf_count, cur_idx: int,
                             radius: float, min_gap: int):
    """Host-numpy form of ``detect_loop_candidate`` (kf_seq branch) for
    callers that already hold the keyframe metadata host-side
    (SlamSystem.maybe_close_loop — a device dispatch per check would cost
    a host round trip). One definition, shared; parity with the jitted
    form is pinned in tests/test_posegraph.py."""
    import numpy as np

    K = kf_pos.shape[0]
    slots = np.arange(K)
    d = np.linalg.norm(kf_pos - kf_pos[cur_idx][None, :], axis=-1)
    eligible = ((slots < kf_count) & (kf_seq > 0)
                & (kf_seq <= kf_seq[cur_idx] - min_gap))
    d = np.where(eligible, d, np.inf)
    best = int(np.argmin(d))
    return best, bool(d[best] < radius)


@partial(jax.jit, static_argnames=("cfg", "max_corr_dist", "max_error",
                                   "min_trans_eig"))
def verify_loop(src_xyz, src_valid, src_cov, tgt_xyz, tgt_cov,
                cfg: GicpConfig, max_corr_dist: float = 1.5,
                max_error: float = 1.5, min_trans_eig: float = 5.0,
                guess=None):
    """GICP-verify a candidate: align the two keyframe clouds (both already
    in world frame); accept iff the alignment is converged, well-fitting,
    and OBSERVABLE. Returns (T_corr, accepted).

    Thresholds calibrated from measured metric distributions (synthetic
    structured + outdoor-like scenes, and real pipeline keyframe clouds
    from a drifting closed-loop run — see tests/test_loop_verification.py;
    outdoor rows averaged over 3 structure/sampling seeds):

    | case                           | mean_err  | min_eig(H_t)/corr |
    |--------------------------------|-----------|-------------------|
    | true match, clean corner       |   0.09    |       115         |
    | true match, corner 2/3 overlap |   0.11    |       105         |
    | true loop pair, drifted run    |   0.74    |      10-22        |
    | corridor (degenerate)          |   0.10    |       0.6         |
    | aliased corridor (wrong +4m)   |   0.11    |       0.6         |
    | wrong place, clutter           |   0.25    |       2.0         |
    | vegetation clutter, TRUE pair  | 0.29-0.36 |     2.1-2.4       |
    | vegetation, WRONG place        | 0.47-0.65 |     1.5-1.8       |
    | sloped rough ground, TRUE pair | 0.33-0.39 |       1.1         |
    | sloped ground, WRONG place     | 0.35-0.90 |       0.7         |

    ROC reading of the table: every structured true match sits at
    trans_eig >= 10; every false candidate (aliases, clutter, wrong-place
    vegetation/slope) sits at <= 2.0. ``min_trans_eig = 5.0`` is the
    midpoint with >= 2x margin BOTH ways — any threshold in [2.4, 10]
    yields the same zero-false-positive operating point on this battery.
    Vegetation-only and slope-only TRUE pairs (eig 1.1-2.4) are
    intentionally rejected as unverifiable: their recovered translation
    UNDERSHOOTS the true offset (the slide direction is unconstrained by
    noisy-normal / planar geometry — measured t=[.01,.04,.01] for a true
    [0.1,0.08,0.02] slope offset), so "accepting a true place" would still
    apply a wrong measurement; the conservative direction costs only
    unclosed drift, never map corruption.

    - ``max_error`` (mean Mahalanobis residual per correspondence) rejects
      gross geometry mismatch: true pairs measure <= 0.74, bound 1.5.
    - ``min_trans_eig``: smallest eigenvalue of the translation block of
      the final normal matrix, per correspondence — the information the
      scene provides along its least-constrained translation direction.
      Degenerate geometry (corridors: sliding direction unobservable) and
      normal-noise clutter sit <= 2.0; true structured matches >= 10. A
      degenerate closure is UNVERIFIABLE (GICP can return a confidently
      wrong slide, cf. the aliased-corridor row) and is rejected even when
      the place is actually right.

    A geometrically identical scene elsewhere (perfect alias) is locally
    indistinguishable by construction; that case is rejected by the
    odometry-drift budget gate in SlamSystem.maybe_close_loop.

    ``guess``: optional (4, 4) initial transform — descriptor-detected
    candidates (SlamSystem, models/placedesc) arrive with metres of drift
    and a known yaw offset, far outside the correspondence radius from
    identity."""
    kwargs = {} if guess is None else {"guess": jnp.asarray(guess)}
    res = gicp_ops.gicp_align(src_xyz, src_valid, src_cov, tgt_xyz, tgt_cov,
                              cfg, max_corr_dist=max_corr_dist, **kwargs)
    ncorr = jnp.maximum(res.num_corr.astype(jnp.float32), 1.0)
    mean_err = res.error / ncorr
    trans_eig = jnp.linalg.eigvalsh(res.H[3:, 3:] / ncorr)[0]
    ok = (res.converged & (res.num_corr > 3 * cfg.min_num_points)
          & (mean_err < max_error) & (trans_eig >= min_trans_eig))
    return res.T, ok


@jax.jit
def apply_pose_update(kf_quat, kf_pos, kf_xyz, kf_valid, kf_cov,
                      new_q, new_p, kf_count):
    """Map deformation: rigidly move each keyframe cloud from its old pose
    to its optimized pose (T_new T_old^-1 per keyframe). Jitted: called
    eagerly at closure rate, and an eager whole-store einsum costs
    hundreds of per-op dispatches."""
    K = kf_quat.shape[0]
    ok = jnp.arange(K) < kf_count
    dq = quat_normalize(quat_mul(new_q, quat_conj(kf_quat)))
    R = quat_to_mat(dq)                       # (K, 3, 3)
    # HIGHEST: a reduced-precision matmul (TF32) quantizes far world
    # coordinates to centimeters — a rigid cloud deformation must not
    # resample the geometry
    t = new_p - jnp.einsum("kij,kj->ki", R, kf_pos,
                           precision=jax.lax.Precision.HIGHEST)
    xyz = jnp.einsum("kij,knj->kni", R, kf_xyz,
                     precision=jax.lax.Precision.HIGHEST) + t[:, None, :]
    xyz = jnp.where((ok[:, None] & kf_valid)[..., None], xyz, kf_xyz)
    cov = gicp_ops.rotate_sym6(kf_cov, R[:, None, :, :])
    cov = jnp.where((ok[:, None] & kf_valid)[..., None], cov, kf_cov)
    q_out = jnp.where(ok[:, None], new_q, kf_quat)
    p_out = jnp.where(ok[:, None], new_p, kf_pos)
    return q_out, p_out, xyz, cov

"""Golden tests for hull-based submap keyframe selection.

The reference selects submap keyframes as distance-kNN ∪ convex-hull-kNN ∪
concave-hull-kNN (buildSubmap, reference src/dlio/src/dlio/odom.cc:1654-1705;
computeConvexHull/computeConcaveHull odom.cc:1439-1515, concave alpha =
keyframe_thresh_dist odom.cc:86,1622). This build replaces the PCL hulls
with device-computed membership tests:

- convex: support points over a Fibonacci direction set,
- concave: discretized empty-open-ball alpha-boundary test.

These tests pin both against host-side exact geometry (scipy.spatial) on
realistic keyframe layouts (looping synthetic trajectories + random fields).
"""

import jax.numpy as jnp
import numpy as np
import pytest

from noetic_slam_tpu.config.params import CapacityConfig, DlioConfig, SubmapConfig
from noetic_slam_tpu.models.odometry import (
    alpha_boundary_mask,
    convex_hull_mask,
    init_state,
    select_submap_keyframes,
)
from noetic_slam_tpu.utils.synthetic import loop_pose_of

scipy_spatial = pytest.importorskip("scipy.spatial")


def _layout_loop(n=60, spacing_noise=0.1, seed=0):
    """Keyframe positions along a closed-loop trajectory at ~1 m spacing,
    with z jitter (real keyframes are never exactly coplanar)."""
    rng = np.random.default_rng(seed)
    ts = np.linspace(0.0, 20.0, n, endpoint=False)
    pos = np.stack([loop_pose_of(t)[1] for t in ts])
    pos += rng.normal(scale=spacing_noise, size=pos.shape)
    pos[:, 2] += rng.normal(scale=0.3, size=n)
    return pos.astype(np.float32)


def _layout_walk(n=80, seed=1):
    """Random-walk trajectory at ~1 m keyframe spacing (realistic layout:
    keyframes string along paths, they are not a uniform point field)."""
    rng = np.random.default_rng(seed)
    steps = rng.normal(size=(n, 3))
    steps[:, 2] *= 0.1
    steps /= np.linalg.norm(steps, axis=-1, keepdims=True)
    # correlated headings: vehicle turns gradually
    for i in range(1, n):
        steps[i] = 0.7 * steps[i - 1] + 0.3 * steps[i]
        steps[i] /= np.linalg.norm(steps[i])
    return np.cumsum(steps, axis=0).astype(np.float32)


def _layout_dense_cluster(seed=2):
    """Loop ring + a dense interior cluster (revisit / rotation keyframes):
    the concave term must retain ring keyframes, not cluster interiors."""
    rng = np.random.default_rng(seed)
    ring = _layout_loop(40, seed=seed)
    cluster = np.array([4.0, 8.0, 0.0]) + rng.normal(
        scale=0.4, size=(20, 3)).astype(np.float32)
    return np.concatenate([ring, cluster.astype(np.float32)])


LAYOUTS = [_layout_loop(), _layout_walk(), _layout_dense_cluster()]


def _alpha_boundary_exact(pos, alpha, n_dirs=4096, seed=3):
    """Continuum alpha-boundary reference: same geometric definition
    (empty open ball of radius alpha touching the point) evaluated with a
    dense random direction set in float64."""
    rng = np.random.default_rng(seed)
    dirs = rng.normal(size=(n_dirs, 3))
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    out = np.zeros(len(pos), bool)
    pos64 = pos.astype(np.float64)
    for i, p in enumerate(pos64):
        centers = p + alpha * dirs                       # (D, 3)
        d2 = ((centers[:, None, :] - pos64[None, :, :]) ** 2).sum(-1)
        out[i] = bool(np.any(np.all(d2 >= alpha * alpha * (1 - 1e-9), -1)))
    return out


@pytest.mark.parametrize("pos", LAYOUTS, ids=["loop", "walk", "cluster"])
def test_convex_support_points_subset_of_scipy_hull(pos):
    """Every support point IS a true convex-hull vertex (no false
    positives), and support points recover the hull vertices that matter:
    recall >= 60% overall and 100% of the 10 hull vertices nearest to a
    query pose (the only ones the kcv-kNN can select)."""
    K = len(pos)
    mask = np.asarray(convex_hull_mask(
        jnp.asarray(pos), jnp.ones(K, bool)))
    hull = scipy_spatial.ConvexHull(pos.astype(np.float64))
    true_vertices = np.zeros(K, bool)
    true_vertices[hull.vertices] = True

    assert np.all(~mask | true_vertices), "support point not a hull vertex"
    recall = mask[true_vertices].mean()
    assert recall >= 0.6, f"hull vertex recall {recall:.2f}"


@pytest.mark.parametrize("pos", LAYOUTS, ids=["loop", "walk", "cluster"])
def test_alpha_boundary_matches_dense_direction_reference(pos):
    """The 42-direction device test agrees with the 4096-direction float64
    continuum reference on >= 90% of keyframes, and never misses a point
    that is a convex hull vertex (always alpha-boundary)."""
    alpha = 1.0
    K = len(pos)
    got = np.asarray(alpha_boundary_mask(
        jnp.asarray(pos), jnp.ones(K, bool), jnp.float32(alpha)))
    ref = _alpha_boundary_exact(pos, alpha)

    # The coarse set can only MISS boundary points (fewer candidate ball
    # centers), never invent them beyond float tolerance.
    false_pos = got & ~ref
    assert false_pos.sum() <= max(1, K // 50), f"{false_pos.sum()} false pos"
    agree = (got == ref).mean()
    assert agree >= 0.9, f"agreement {agree:.2f}"

    # A support point in direction d has an empty half-space beyond it, so
    # the alpha-ball along the SAME direction is empty: support points of
    # the alpha test's own direction set must be alpha-boundary.
    from noetic_slam_tpu.models.odometry import _SUPPORT_DIRS

    sup = np.asarray(convex_hull_mask(jnp.asarray(pos), jnp.ones(K, bool),
                                      jnp.asarray(_SUPPORT_DIRS)))
    assert np.all(got[sup])


def test_dense_cluster_interior_excluded():
    """Interior keyframes of a dense revisit cluster are NOT alpha-boundary
    (their every alpha-ball contains neighbors), ring keyframes are."""
    pos = _layout_dense_cluster()
    alpha = 1.0
    got = np.asarray(alpha_boundary_mask(
        jnp.asarray(pos), jnp.ones(len(pos), bool), jnp.float32(alpha)))
    ring, cluster = got[:40], got[40:]
    assert ring.all(), "loop-ring keyframes must stay on the boundary"
    assert not cluster.all(), "dense cluster interiors must drop off"


def _exact_selection(pos, query, knn, kcv, kcc, alpha):
    """Host-side exact reference of buildSubmap (odom.cc:1654-1705):
    distance-kNN ∪ kNN-of-convex-hull-vertices ∪ kNN-of-alpha-boundary."""
    d = np.linalg.norm(pos - query, axis=-1)
    sel = set(np.argsort(d)[:knn].tolist())
    if len(pos) >= 4:
        hull = scipy_spatial.ConvexHull(pos.astype(np.float64))
        cv = np.array(sorted(hull.vertices))
        sel |= set(cv[np.argsort(d[cv])[:kcv]].tolist())
    if len(pos) >= 5 and kcc > 0:
        cc = np.flatnonzero(_alpha_boundary_exact(pos, alpha))
        sel |= set(cc[np.argsort(d[cc])[:kcc]].tolist())
    return sel


@pytest.mark.parametrize("pos,bound", [(LAYOUTS[0], 2), (LAYOUTS[1], 4),
                                       (LAYOUTS[2], 2)],
                         ids=["loop", "walk", "cluster"])
def test_end_to_end_selection_divergence(pos, bound):
    """select_submap_keyframes diverges from the exact hull-based selection
    by <= 2 keyframes on looping/cluster trajectories (<= 4 on the
    adversarial near-collinear walk, where shallow hull vertices have
    vanishing support cones) — AND every divergent pick must still be a
    true hull vertex, so the registration target only swaps boundary
    keyframes for adjacent boundary keyframes."""
    alpha = 1.0
    cfg = DlioConfig(
        submap=SubmapConfig(knn=10, kcv=10, kcc=10),
        capacity=CapacityConfig(
            max_keyframes=max(128, len(pos)), max_ds_points=8,
            max_points=64, max_submap_kf=32))
    st = init_state(cfg)
    K = st.kf_pos.shape[0]
    kf_pos = np.zeros((K, 3), np.float32)
    kf_pos[: len(pos)] = pos
    query = pos[len(pos) // 3] + np.float32([0.5, -0.3, 0.0])
    st = st._replace(kf_pos=jnp.asarray(kf_pos),
                     kf_count=jnp.int32(len(pos)),
                     p=jnp.asarray(query))

    got = set(np.flatnonzero(np.asarray(select_submap_keyframes(
        cfg, st, alpha=jnp.float32(alpha)))).tolist())
    ref = _exact_selection(pos, query, 10, 10, 10, alpha)
    diff = got.symmetric_difference(ref)
    assert len(diff) <= bound, \
        f"selection diverges by {len(diff)}: {sorted(diff)}"
    hull = scipy_spatial.ConvexHull(pos.astype(np.float64))
    boundary = set(hull.vertices.tolist()) | set(
        np.flatnonzero(_alpha_boundary_exact(pos, alpha)).tolist())
    assert diff <= boundary, "divergent picks must be true boundary vertices"


def test_selection_bounded_and_masked():
    """No inactive slots selected; selection size <= knn + kcv + kcc."""
    cfg = DlioConfig(capacity=CapacityConfig(
        max_keyframes=64, max_ds_points=8, max_points=64, max_submap_kf=32))
    st = init_state(cfg)
    pos = _layout_loop(30)
    kf_pos = np.zeros((64, 3), np.float32)
    kf_pos[:30] = pos
    st = st._replace(kf_pos=jnp.asarray(kf_pos), kf_count=jnp.int32(30),
                     p=jnp.asarray(pos[0]))
    mask = np.asarray(select_submap_keyframes(cfg, st))
    assert not mask[30:].any()
    s = cfg.submap
    assert mask.sum() <= s.knn + s.kcv + s.kcc

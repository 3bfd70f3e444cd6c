import numpy as np
import jax.numpy as jnp

from noetic_slam_tpu.ops import neighbors
from noetic_slam_tpu.ops.pointcloud import SENTINEL


def _brute_nn(query, target):
    d = ((query[:, None, :] - target[None, :, :]) ** 2).sum(-1)
    return d.argmin(1), d.min(1)


def test_nn1_matches_bruteforce(rng):
    q = rng.normal(size=(256, 3)).astype(np.float32) * 10
    t = rng.normal(size=(512, 3)).astype(np.float32) * 10
    idx, sqd = neighbors.nn1(jnp.asarray(q), jnp.asarray(t),
                             query_chunk=64, target_chunk=128)
    widx, wsqd = _brute_nn(q, t)
    np.testing.assert_array_equal(np.asarray(idx), widx)
    np.testing.assert_allclose(np.asarray(sqd), wsqd, rtol=1e-5)


def test_nn1_large_offset(rng):
    """World coordinates far from origin must not break f32 conditioning."""
    off = np.array([3000.0, -2000.0, 50.0], np.float32)
    q = rng.normal(size=(128, 3)).astype(np.float32) + off
    t = rng.normal(size=(256, 3)).astype(np.float32) + off
    idx, sqd = neighbors.nn1(jnp.asarray(q), jnp.asarray(t),
                             query_chunk=64, target_chunk=128)
    widx, wsqd = _brute_nn(q, t)
    match = (np.asarray(idx) == widx).mean()
    assert match > 0.99, f"only {match:.2%} NN matched at large offset"
    np.testing.assert_allclose(np.asarray(sqd), wsqd, rtol=1e-3, atol=1e-4)


def test_nn1_ignores_sentinel_targets(rng):
    q = rng.normal(size=(64, 3)).astype(np.float32)
    t = np.full((128, 3), SENTINEL, np.float32)
    t[:32] = rng.normal(size=(32, 3)).astype(np.float32)
    idx, sqd = neighbors.nn1(jnp.asarray(q), jnp.asarray(t),
                             query_chunk=64, target_chunk=64)
    assert np.asarray(idx).max() < 32


def test_knn_matches_bruteforce(rng):
    q = rng.normal(size=(128, 3)).astype(np.float32) * 5
    t = rng.normal(size=(256, 3)).astype(np.float32) * 5
    k = 8
    idx, sqd = neighbors.knn(jnp.asarray(q), jnp.asarray(t), k,
                             query_chunk=64, target_chunk=64)
    d = ((q[:, None, :] - t[None, :, :]) ** 2).sum(-1)
    want_idx = np.argsort(d, axis=1)[:, :k]
    want_d = np.take_along_axis(d, want_idx, axis=1)
    np.testing.assert_allclose(np.asarray(sqd), want_d, rtol=1e-4, atol=1e-5)
    # index sets must match (ordering ties aside)
    for i in range(128):
        assert set(np.asarray(idx)[i]) == set(want_idx[i])


def test_knn_self_query_includes_self(rng):
    pts = rng.normal(size=(64, 3)).astype(np.float32)
    idx, sqd = neighbors.knn(jnp.asarray(pts), jnp.asarray(pts), 4,
                             query_chunk=64, target_chunk=64)
    np.testing.assert_array_equal(np.asarray(idx)[:, 0], np.arange(64))
    np.testing.assert_allclose(np.asarray(sqd)[:, 0], 0.0, atol=1e-6)


def test_nn1_fused_interpret_matches(rng):
    """Triton fused NN kernel (interpret mode) vs the XLA path."""
    import noetic_slam_tpu.ops.pallas.nn_kernel as nk

    q = jnp.asarray(rng.normal(size=(512, 3)).astype(np.float32) * 10)
    t = jnp.asarray(rng.normal(size=(2048, 3)).astype(np.float32) * 10)
    i1, d1 = nk.nn1_fused(q, t, interpret=True)
    i2, d2 = neighbors._nn1_xla(q, t, query_chunk=256, target_chunk=512)
    np.testing.assert_array_equal(np.asarray(i1), np.asarray(i2))
    np.testing.assert_allclose(np.asarray(d1), np.asarray(d2), rtol=1e-5)


def test_nn1_fused_interpret_capped(rng):
    """Radius-capped fused NN (interpret mode): found queries exact,
    not-found queries report sqd >= cap^2."""
    import noetic_slam_tpu.ops.pallas.nn_kernel as nk

    q = jnp.asarray(rng.normal(size=(512, 3)).astype(np.float32) * 10)
    t = jnp.asarray(rng.normal(size=(2048, 3)).astype(np.float32) * 10)
    cap = 0.8
    i1, d1 = nk.nn1_fused(q, t, max_dist=jnp.float32(cap), interpret=True)
    i2, d2 = neighbors._nn1_xla(q, t, query_chunk=256, target_chunk=512)
    d2 = np.asarray(d2)
    found = d2 < cap * cap
    assert found.any() and (~found).any()
    np.testing.assert_array_equal(np.asarray(i1)[found],
                                  np.asarray(i2)[found])
    np.testing.assert_allclose(np.asarray(d1)[found], d2[found], rtol=1e-5)
    assert (np.asarray(d1)[~found] >= cap * cap - 1e-5).all()


def test_nn1_fused_interpret_morton_sorted_with_padding(rng):
    """Pruning path exercised: Morton-sorted clouds + compacted padding +
    dynamic t_count, still exact where neighbors exist inside the cap."""
    import noetic_slam_tpu.ops.pallas.nn_kernel as nk
    from noetic_slam_tpu.ops import pointcloud as pc

    tn = 1500
    t = np.full((2048, 3), pc.SENTINEL, np.float32)
    t[:tn] = rng.uniform(-20, 20, (tn, 3)).astype(np.float32)
    tv = np.zeros((2048,), bool)
    tv[:tn] = True
    key = pc.morton_sort_key(jnp.asarray(t), jnp.asarray(tv), 1.0)
    order = np.argsort(np.asarray(key), kind="stable")
    t = t[order]
    q = np.asarray(t[:512] + rng.normal(0, 0.05, (512, 3))
                   ).astype(np.float32)
    i1, d1 = nk.nn1_fused(jnp.asarray(q), jnp.asarray(t),
                          t_count=jnp.int32(tn), max_dist=jnp.float32(1.0),
                          interpret=True)
    i2, d2 = neighbors._nn1_xla(jnp.asarray(q), jnp.asarray(t),
                                t_count=jnp.int32(tn),
                                query_chunk=256, target_chunk=512)
    d2 = np.asarray(d2)
    found = d2 < 1.0
    assert found.mean() > 0.95
    np.testing.assert_array_equal(np.asarray(i1)[found],
                                  np.asarray(i2)[found])
    np.testing.assert_allclose(np.asarray(d1)[found], d2[found], rtol=1e-5)


def test_nn1_route_follows_platform(rng, monkeypatch):
    """nn1 takes the fused kernel where the traced computation is placed
    on a GPU (default backend, or jax.default_device), the XLA search
    everywhere else."""
    import jax

    calls = []
    monkeypatch.setattr(neighbors, "nn1_kernel",
                        lambda *a, **k: calls.append("kernel") or (0, 0))
    monkeypatch.setattr(neighbors, "_nn1_xla",
                        lambda *a, **k: calls.append("xla") or (0, 0))
    q = jnp.zeros((8, 3))
    neighbors.nn1(q, q)
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    neighbors.nn1(q, q)
    with jax.default_device(jax.devices("cpu")[0]):
        neighbors.nn1(q, q)
    assert calls == ["xla", "kernel", "xla"]


def test_nn1_kernel_pads_non_multiple_shapes(rng):
    """The kernel wrapper pads queries and targets that are not tile
    multiples; padding never wins and the result keeps the caller's
    length."""
    q = rng.normal(size=(100, 3)).astype(np.float32) * 5
    t = rng.normal(size=(333, 3)).astype(np.float32) * 5
    idx, sqd = neighbors.nn1_kernel(jnp.asarray(q), jnp.asarray(t),
                                    interpret=True)
    widx, wsqd = _brute_nn(q, t)
    assert idx.shape == (100,) and sqd.shape == (100,)
    np.testing.assert_array_equal(np.asarray(idx), widx)
    np.testing.assert_allclose(np.asarray(sqd), wsqd, rtol=1e-5)

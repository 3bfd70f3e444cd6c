"""TSDF fusion (models/tsdf._integrate_samples: sort, block gating,
scatter-adds, clamp) against the independent NumPy clamped-weighted-mean
reference in tests/reference_math.py."""

import numpy as np
import jax.numpy as jnp
import pytest

from noetic_slam_tpu.config.params import TsdfConfig
from noetic_slam_tpu.models import tsdf
from reference_math import dense_map_voxels, tsdf_fuse_ref


def _cfg(**kw):
    base = dict(voxel_size=0.1, truncation=0.3, max_blocks=256,
                space_carving=True, carving_samples=4, max_range=30.0,
                scan_block_cap=64)
    base.update(kw)
    return TsdfConfig(**base)


def _surface_clouds():
    rng = np.random.default_rng(3)
    clouds = []
    for i in range(3):
        ang = rng.uniform(0, 2 * np.pi, 128)
        r = 5.0 + rng.normal(scale=0.05, size=128)
        z = rng.uniform(-0.5, 1.5, 128)
        clouds.append(np.stack([r * np.cos(ang), r * np.sin(ang), z],
                               -1).astype(np.float32) + 0.01 * i)
    return clouds


def _line(n):
    # n points along x, one meter apart: one block each
    return (np.arange(n, dtype=np.float32)[:, None]
            * np.array([[1.0, 0, 0]], np.float32))


CASES = {
    "surface": (_cfg(), _surface_clouds()),
    "max_weight_clamp": (
        _cfg(max_weight=3.0, space_carving=False),
        [np.tile(np.array([[2.0, 0.05, 0.05]], np.float32), (64, 1))] * 3),
    "block_cap_overflow": (
        _cfg(scan_block_cap=8, space_carving=False, max_blocks=64),
        [_line(40)]),
    "directory_capacity": (
        _cfg(scan_block_cap=64, space_carving=False, max_blocks=8),
        [_line(30)]),
    # every point inside the 0.3 m minimum range: nothing fused
    "empty_scan": (_cfg(), [np.zeros((16, 3), np.float32)]),
}


@pytest.mark.parametrize("case", list(CASES))
def test_integrate_matches_numpy_reference(case):
    cfg, clouds = CASES[case]
    st = tsdf.init_tsdf(cfg)
    voxels, directory, dropped = {}, {}, 0
    origin = jnp.zeros(3)
    for pts in clouds:
        valid = jnp.ones((pts.shape[0],), bool)
        pos, sdf, w = tsdf._ray_samples(cfg, jnp.asarray(pts), valid, origin)
        st = tsdf._integrate_samples(cfg, st, pos, sdf, w)
        dropped += tsdf_fuse_ref(
            voxels, directory, np.asarray(pos), np.asarray(sdf),
            np.asarray(w), cfg.voxel_size, cfg.truncation, cfg.max_weight,
            cfg.scan_block_cap, cfg.max_blocks)

    assert int(st.num_blocks) == len(directory)
    assert int(st.dropped) == dropped
    got = dense_map_voxels(st.dir_keys, st.dir_slots, (st.weight, st.wsum))
    touched = {k: v for k, v in got.items() if v[0] != 0.0}
    assert touched.keys() == voxels.keys()
    for k, (W, d) in voxels.items():
        gw, gws = touched[k]
        np.testing.assert_allclose(gw, W, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(gws / gw, d, rtol=1e-5, atol=1e-6)
    if case == "max_weight_clamp":
        assert max(W for W, _ in voxels.values()) == cfg.max_weight
    if case in ("block_cap_overflow", "directory_capacity"):
        assert dropped > 0
    if case == "empty_scan":
        assert not voxels and int(st.num_blocks) == 0

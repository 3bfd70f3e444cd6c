"""GPU bring-up support that the CPU can check: the compile-cache
location, the device peak table, chip_smoke's refusal to run without a
GPU, and (marked ``gpu``, run on the card) the NN kernel compiled at its
real width."""

import os
import subprocess
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cache_dir_in_fresh_process(env_extra):
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_COMPILATION_CACHE_DIR", "NOETIC_SLAM_NO_CACHE")}
    env.update(env_extra, JAX_PLATFORMS="cpu")
    code = ("import jax; from noetic_slam_tpu.runtime import compile_cache;"
            "p = compile_cache.enable();"
            "print(p); print(jax.config.jax_compilation_cache_dir)")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, check=True)
    return out.stdout.split()


def test_compile_cache_honours_env(tmp_path):
    """JAX_COMPILATION_CACHE_DIR wins, and nothing else is set in code."""
    want = str(tmp_path / "cache")
    got, jax_dir = _cache_dir_in_fresh_process(
        {"JAX_COMPILATION_CACHE_DIR": want})
    assert got == want and jax_dir == want


def test_compile_cache_default_is_fixed_in_checkout():
    from noetic_slam_tpu.runtime import compile_cache

    got, jax_dir = _cache_dir_in_fresh_process({})
    assert got == jax_dir == compile_cache.DEFAULT_DIR
    assert compile_cache.DEFAULT_DIR == os.path.join(ROOT, ".jax_cache")


def test_peak_table_has_h100(monkeypatch):
    import jax

    from noetic_slam_tpu.runtime import profiling

    class Dev:
        device_kind = "NVIDIA H100 80GB HBM3"

    monkeypatch.setattr(jax, "devices", lambda *a: [Dev()])
    (bf16, f32, hbm), kind = profiling.chip_peaks()
    assert (bf16, f32, hbm) == (989.0, 67.0, 3350.0)
    line = profiling.roofline_report("x", 1e-3, flops=989e12 * 1e-3 * 0.5,
                                     bytes_moved=3350e9 * 1e-3 * 0.25)
    assert "50.0% of 989T bf16 tensor" in line and "25.0% of 3350GB/s" in line


def test_peak_table_unknown_device_raises():
    from noetic_slam_tpu.runtime import profiling

    # the CPU the tests run on has no entry
    with pytest.raises(KeyError):
        profiling.chip_peaks()


def test_chip_smoke_refuses_cpu(capsys):
    sys.path.insert(0, ROOT)
    import chip_smoke

    assert chip_smoke.main([]) != 0
    assert '"ok"' not in capsys.readouterr().out


@pytest.fixture
def gpu():
    import jax

    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs a GPU (run on the card: pytest -m gpu)")


@pytest.mark.gpu
def test_nn_kernel_compiles_at_real_width(gpu):
    """The Triton NN kernel at the GICP shape (8192 x 262144, capped)
    against the XLA search on the same card."""
    import jax.numpy as jnp

    from noetic_slam_tpu.ops import neighbors

    rng = np.random.default_rng(0)
    t = jnp.asarray(rng.uniform(-30, 30, (262144, 3)).astype(np.float32))
    q = t[:8192] + 0.05
    i_k, d_k = neighbors.nn1_kernel(q, t, None, 0.5)
    i_x, d_x = neighbors._nn1_xla(q, t)
    d_k, d_x = np.asarray(d_k), np.asarray(d_x)
    found = d_x < 0.25
    # Both return exact distances; the XLA search picks its winner from
    # the rounded expansion, so the kernel is never worse and differs
    # only on near-ties.
    assert found.mean() > 0.99
    assert np.all(d_k[found] <= d_x[found] * (1 + 1e-6))
    same = np.asarray(i_k) == np.asarray(i_x)
    assert same[found].mean() > 0.99
    np.testing.assert_allclose(d_k[found & same], d_x[found & same],
                               rtol=1e-6)

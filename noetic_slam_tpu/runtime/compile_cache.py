"""Persistent XLA compilation cache.

``SlamSystem.warmup()`` and the first steps compile dozens of programs.
JAX's on-disk compilation cache keys executables by (HLO, compile options,
backend version), so a second process with the same config skips them.

Where the cache lives: ``JAX_COMPILATION_CACHE_DIR`` when it is set (JAX
reads the variable itself, and nothing else is set here); otherwise the
fixed directory ``<checkout>/.jax_cache``. The path must not move between
runs, or the cache never hits.

``NOETIC_SLAM_NO_CACHE=1`` turns the cache off (cold-compile measurements).
"""

from __future__ import annotations

import os

DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), ".jax_cache")

_enabled_path: str | None = None


def enable() -> str | None:
    """Turn on JAX's persistent compilation cache (idempotent). Returns the
    cache directory, or None when ``NOETIC_SLAM_NO_CACHE=1``."""
    global _enabled_path
    if os.environ.get("NOETIC_SLAM_NO_CACHE") == "1":
        return None
    if _enabled_path is not None:
        return _enabled_path
    import jax

    path = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if not path:
        path = DEFAULT_DIR
        os.makedirs(path, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", path)
    # The default thresholds skip sub-second compiles and tiny executables;
    # the closure stack is dozens of medium programs, so cache everything
    # that took measurable compile time.
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.4)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    _enabled_path = path
    return path

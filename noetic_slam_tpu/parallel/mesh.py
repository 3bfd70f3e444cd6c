"""Device-mesh helpers.

The reference's "distribution" is ROS pub/sub between processes on one host
(SURVEY.md §2.6/P4); the replacement is a single SPMD program over
a ``jax.sharding.Mesh``, with map/keyframe state sharded across devices and
XLA collectives carrying what used to be topic traffic.

Axis naming convention used across the framework (the axes follow the
algorithm; every device reaches every other at the same rate):
- ``"map"``  — spatial sharding: submap/target points, TSDF blocks,
  keyframe shards; its collectives run once per registration step.
- ``"batch"`` — replay/data parallelism over independent sequences; it
  needs no collectives in the step.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh


def make_mesh(n_devices: int | None = None, axis: str = "map",
              devices=None) -> Mesh:
    """1-D mesh over the first ``n_devices`` local devices."""
    devices = devices if devices is not None else jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(np.asarray(devices), (axis,))


def make_mesh_2d(n_map: int, n_batch: int, devices=None) -> Mesh:
    """2-D mesh: ("batch", "map"); batch outer, so that the map axis's
    collectives stay within groups of neighbouring device ids."""
    devices = devices if devices is not None else jax.devices()
    grid = np.asarray(devices[: n_map * n_batch]).reshape(n_batch, n_map)
    return Mesh(grid, ("batch", "map"))

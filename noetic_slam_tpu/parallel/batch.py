"""Batched multi-sequence odometry — data parallelism over bags.

BASELINE.json's scaling config 5 ("multi-host pod slice: city-scale
multi-bag mapping") maps onto the device mesh as a *batch axis*: the odometry step is a
pure function of (state, input), so B independent sequences run as one
``vmap``-ed step over stacked state pytrees, and the batch axis shards
across hosts/devices with a ``NamedSharding`` — XLA inserts no collectives
(sequences are independent), so scaling is embarrassingly parallel and
limited only by per-device memory. Trajectories come back through the same
per-sequence device rings.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from noetic_slam_tpu.config.params import DlioConfig
from noetic_slam_tpu.models.odometry import (OdomState, init_state,
                                             make_odometry_step)

Array = jax.Array


def stack_states(states) -> OdomState:
    """Stack per-sequence OdomStates along a new leading batch axis."""
    return jax.tree.map(lambda *xs: jnp.stack(xs), *states)


def unstack_state(batched: OdomState, i: int) -> OdomState:
    return jax.tree.map(lambda x: x[i], batched)


def init_batched_state(cfg: DlioConfig, batch: int, **kw) -> OdomState:
    return stack_states([init_state(cfg, **kw) for _ in range(batch)])


def make_batched_odometry_step(cfg: DlioConfig, mesh=None,
                               batch_axis: str = "batch"):
    """vmapped odometry step; with ``mesh`` the batch dimension of state and
    inputs is sharded along ``batch_axis`` and the step jitted with those
    shardings (donated state)."""
    step = jax.vmap(make_odometry_step(cfg))
    if mesh is None:
        return jax.jit(step, donate_argnums=(0,))

    def shard_spec(_):
        return NamedSharding(mesh, P(batch_axis))

    state_shardings = jax.tree.map(shard_spec, init_state(cfg))
    return jax.jit(step, donate_argnums=(0,)), state_shardings


def shard_batched(mesh, tree, batch_axis: str = "batch"):
    """Place a stacked pytree with its leading axis sharded on the mesh."""
    sh = NamedSharding(mesh, P(batch_axis))
    return jax.device_put(tree, jax.tree.map(lambda _: sh, tree))

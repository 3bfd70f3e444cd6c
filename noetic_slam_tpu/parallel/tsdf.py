"""Spatially sharded TSDF fusion over a device mesh.

BASELINE.json's block-partitioned map: TSDF blocks shard across the ``map``
axis by block-key hash (key mod n_devices), so every device owns a disjoint
subset of space with its OWN directory + payload shard. Integration needs
NO collectives: ray samples are computed replicated (cheap, elementwise)
and each device masks to the samples whose block it owns before running the
standard local integration — the all-to-all exchange is implicit in
replicate-then-filter, which beats a real all-to-all at LiDAR scan sizes.

Extraction re-bases per-shard payload slots into a single global TsdfState
so the existing surface/meshing code applies unchanged.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from noetic_slam_tpu.config.params import TsdfConfig
from noetic_slam_tpu.models.tsdf import (
    _KEY_PAD,
    TsdfState,
    _block_key,
    _integrate_samples,
    _ray_samples,
    init_tsdf,
)

Array = jax.Array


def init_sharded_tsdf(cfg: TsdfConfig, mesh, axis: str = "map") -> TsdfState:
    """TsdfState whose leading dimensions shard across ``axis``.

    cfg.max_blocks is the GLOBAL capacity; each device owns
    max_blocks / n_devices slots.
    """
    ndev = mesh.shape[axis]
    assert cfg.max_blocks % ndev == 0
    state = init_tsdf(cfg)
    sh = NamedSharding(mesh, P(axis))
    rep = NamedSharding(mesh, P())
    return TsdfState(
        dir_keys=jax.device_put(state.dir_keys, sh),
        dir_slots=jax.device_put(state.dir_slots, sh),
        num_blocks=jax.device_put(state.num_blocks, rep),
        wsum=jax.device_put(state.wsum, sh),
        weight=jax.device_put(state.weight, sh),
        dropped=jax.device_put(state.dropped, rep),
    )


def make_sharded_integrate(cfg: TsdfConfig, mesh, axis: str = "map"):
    """Build the jitted sharded integrate: (state, points, valid, origin) ->
    state. Per-device num_blocks/dropped are tracked as psums so the global
    counters stay meaningful."""
    ndev = mesh.shape[axis]

    def spmd(state: TsdfState, points, valid, origin):
        my = jax.lax.axis_index(axis)
        pos, sdf, w = _ray_samples(cfg, points, valid, origin)
        vx = jnp.floor(pos / cfg.voxel_size).astype(jnp.int32)
        keys = _block_key(vx >> 3)
        mine = (keys != _KEY_PAD) & ((keys % ndev) == my)
        w = jnp.where(mine, w, 0.0)
        # Slots are assigned from this shard's own block count (its filled
        # directory rows), not the global counter: the global count
        # overruns a shard's capacity long before the shard is full.
        local_nb = jnp.sum(state.dir_keys != _KEY_PAD).astype(jnp.int32)
        new = _integrate_samples(cfg, state._replace(num_blocks=local_nb),
                                 pos, sdf, w)
        # Global counters: per-device counts summed (each device only ever
        # allocates its own blocks, so the psum is exact).
        nb = jax.lax.psum(new.num_blocks - local_nb, axis)
        dr = jax.lax.psum(new.dropped - state.dropped, axis)
        return new._replace(num_blocks=state.num_blocks + nb,
                            dropped=state.dropped + dr)

    specs = TsdfState(dir_keys=P(axis), dir_slots=P(axis), num_blocks=P(),
                      wsum=P(axis), weight=P(axis), dropped=P())
    fn = jax.shard_map(
        spmd, mesh=mesh,
        in_specs=(specs, P(), P(), P()),
        out_specs=specs, check_vma=False)
    return jax.jit(fn, donate_argnums=(0,))


def gather_sharded_state(cfg: TsdfConfig, state: TsdfState, mesh,
                         axis: str = "map") -> TsdfState:
    """Pull a sharded state to the host as ONE equivalent global TsdfState
    (per-shard payload slots re-based by their shard offset), so
    extract_surface / meshing apply unchanged."""
    import numpy as np

    ndev = mesh.shape[axis]
    keys, slots, wsum, weight, nb, dr = jax.device_get(
        (state.dir_keys, state.dir_slots, state.wsum, state.weight,
         state.num_blocks, state.dropped))
    C = len(keys)
    c_local = C // ndev
    slots = slots.copy()
    for i in range(ndev):
        rows = slice(i * c_local, (i + 1) * c_local)
        valid = keys[rows] != _KEY_PAD
        slots[rows] = np.where(valid, slots[rows] + i * c_local, 0)
    order = np.argsort(keys, kind="stable")
    return TsdfState(
        dir_keys=jnp.asarray(keys[order]),
        dir_slots=jnp.asarray(slots[order]),
        num_blocks=jnp.asarray(nb),
        wsum=jnp.asarray(wsum), weight=jnp.asarray(weight),
        dropped=jnp.asarray(dr))

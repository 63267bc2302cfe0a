"""Device-mesh construction helpers.

The reference is strictly single-GPU (one vkCmdDispatch per frame,
src/rvpt/rvpt.cpp:1035-1036; SURVEY.md §2 parallelism checklist).  The
scale-out story: shard film *tiles* across cards (data parallel —
zero cross-chip traffic during tracing since the scene is replicated), and
optionally shard samples-per-pixel with a psum-mean (the Monte-Carlo analog of
sequence/context parallelism: the long axis is rays x bounces, SURVEY.md §5).
Tensor/pipeline/expert parallelism have no counterpart in a path tracer with
no large matmuls — N/A by design, documented here.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

TILE_AXIS = "tiles"  # data-parallel film tiles
SPP_AXIS = "spp"  # sample-parallel Monte-Carlo axis


def make_mesh(n_tiles: int | None = None, n_spp: int = 1, devices=None) -> Mesh:
    """(tiles, spp) mesh.  Defaults to all devices on the tile axis.

    The shape follows the algorithm alone: every card reaches every other at
    the same rate (NVLink, all to all), so no device order is preferred."""
    devices = list(devices if devices is not None else jax.devices())
    if n_tiles is None:
        n_tiles = len(devices) // n_spp
    assert n_tiles * n_spp == len(devices), (
        f"mesh {n_tiles}x{n_spp} != {len(devices)} devices"
    )
    arr = np.asarray(devices).reshape(n_tiles, n_spp)
    return Mesh(arr, (TILE_AXIS, SPP_AXIS))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def row_sharded(mesh: Mesh) -> NamedSharding:
    """Shard the leading (row/tile) axis across the tile axis of the mesh."""
    return NamedSharding(mesh, P(TILE_AXIS))

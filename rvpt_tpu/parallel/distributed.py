"""Multi-host initialization & film gather.

The reference is a single process (SURVEY.md §2 parallelism checklist: no
distributed backend).  For several processes — one per GPU, each pinned to
its own card — call :func:`initialize_distributed` once per process before
device use with the coordinator address, process count and rank (nothing
on a plain GPU host announces a cluster, so all three are required there),
build a global mesh with `parallel.mesh.make_mesh` (jax.devices() is then the
global device list), and render with `parallel.sharded`.  Tracing needs no
cross-card traffic (the film is tile-sharded, the scene replicated); the
network carries the coordination handshake and, in training, the psum'd
scene-parameter gradients.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np


def initialize_distributed(coordinator: str | None = None,
                           num_processes: int | None = None,
                           process_id: int | None = None) -> None:
    """Wrapper over jax.distributed.initialize; arguments left out come from
    a cluster launcher's environment, if any.  To pin one process per card,
    call jax.distributed.initialize with ``local_device_ids=[rank]``
    (examples/multihost_render.py --pin-device)."""
    kwargs = {}
    if coordinator is not None:
        kwargs["coordinator_address"] = coordinator
    if num_processes is not None:
        kwargs["num_processes"] = num_processes
    if process_id is not None:
        kwargs["process_id"] = process_id
    jax.distributed.initialize(**kwargs)


def gather_film_to_host(film_image: jnp.ndarray) -> np.ndarray | None:
    """Assemble the (possibly sharded) film on process 0 as a NumPy array;
    other processes return None.  The analog of the reference's
    swapchain present — the one host->display hop per frame."""
    from jax.experimental import multihost_utils

    if jax.process_count() == 1:
        return np.asarray(film_image)
    gathered = multihost_utils.process_allgather(film_image, tiled=True)
    return np.asarray(gathered) if jax.process_index() == 0 else None

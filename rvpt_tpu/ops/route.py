"""The one place that picks an implementation by platform.

Every other module calls the XLA renders; the only choice left is how the
triangle closest-hit search runs:

  * ``cpu``: lockstep BVH traversal (``ops.traverse``) when the scene has a
    BVH, the dense XLA search (``ops.intersect.closest_hit_triangles``)
    otherwise;
  * ``gpu``: the Pallas-Triton search kernel (``ops.search_triton``).

Any other platform raises: a measurement that lands on an unknown device
should fail, not fall back.
"""

from __future__ import annotations

import jax

TRAVERSE = "traverse"
DENSE = "dense"
TRITON = "triton"


def platform() -> str:
    """Platform computations are placed on: the ``jax.default_device``
    override when one is active, else ``jax.devices()[0]``."""
    dev = jax.config.jax_default_device
    if dev is None:
        return jax.devices()[0].platform
    return dev if isinstance(dev, str) else dev.platform


def triangle_search(has_bvh: bool, platform_name: str | None = None) -> str:
    """Search route for a scene's triangles on ``platform_name``
    (default: :func:`platform`)."""
    p = platform() if platform_name is None else platform_name
    if p == "cpu":
        return TRAVERSE if has_bvh else DENSE
    if p == "gpu":
        return TRITON
    raise ValueError(f"no triangle-search route for platform {p!r}")

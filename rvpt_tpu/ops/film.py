"""Film state: temporal EMA accumulation as a differentiable op.

The reference accumulates into an rgba8 storage image with
``out = (accum * N + sample) / (N + 1)`` and resets N on any camera/settings
change (compute_pass.comp:146-166, src/rvpt/rvpt.cpp:102-111).  Here the film
is a pytree ``(accum f32[3,H,W], frame u32)``; the EMA update is a pure
differentiable function and the dirty-reset is a traced ``where`` so resets
don't retrace.

The accumulation buffer is channels-FIRST ([3,H,W]): each channel is one
contiguous plane, the layout every render path produces.  Host-side
consumers convert with ``chw_to_hwc``.
"""

from __future__ import annotations

import jax.numpy as jnp

from ..pytree import pytree_dataclass


@pytree_dataclass
class Film:
    accum: jnp.ndarray  # f32[3,H,W] (channels-first, see module docstring)
    frame: jnp.ndarray  # u32 scalar: number of frames accumulated so far

    @staticmethod
    def create(height: int, width: int) -> "Film":
        return Film(
            accum=jnp.zeros((3, height, width), jnp.float32),
            frame=jnp.zeros((), jnp.uint32),
        )


def accumulate(film: Film, sample: jnp.ndarray, dirty) -> Film:
    """EMA update with reset-on-dirty.

    ``dirty`` True restarts accumulation at this sample (the reference zeroes
    the history by multiplying with min(current_frame, 1) after resetting the
    counter — compute_pass.comp:146-149).
    """
    frame = jnp.where(jnp.asarray(dirty), jnp.uint32(0), film.frame)
    n = frame.astype(jnp.float32)
    accum = jnp.where(frame > 0, film.accum, 0.0)
    new_accum = (accum * n + sample) / (n + 1.0)
    return Film(accum=new_accum, frame=frame + jnp.uint32(1))


def to_srgb_u8(img: jnp.ndarray) -> jnp.ndarray:
    """Clamp linear radiance to u8 exactly like an rgba8 UNORM image store
    (the reference's result image is rgba8 with no tonemapping)."""
    return jnp.clip(jnp.round(jnp.clip(img, 0.0, 1.0) * 255.0), 0, 255).astype(jnp.uint8)


def chw_to_hwc(img: jnp.ndarray) -> jnp.ndarray:
    return jnp.moveaxis(img, 0, -1)


def hwc_to_chw(img: jnp.ndarray) -> jnp.ndarray:
    return jnp.moveaxis(img, -1, 0)

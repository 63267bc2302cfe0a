"""Inverse rendering: recover scene parameters by gradient descent through
the path tracer (BASELINE.md config 5 / north star).

The forward model is the same sharded renderer used for display; gradients
w.r.t. the replicated scene parameters are psum'd across the mesh by
shard_map's transpose, and optax applies the update — the reference has no
counterpart (its closest state is the temporal accumulation buffer).

Parameter groups (``PARAM_GROUPS``) select which leaves train: materials
(albedo/emission/ior), geometry (triangle vertices, sphere center/radius,
plane normal/offset) and camera pose (translation/rotation) — every leaf the
hit-record gradient returns cotangents for (ops.fast_grad,
tests/test_fast_grad.py, tests/test_camera_grad.py).
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import optax

from ..config import FilmConfig, RenderSettings
from ..parallel.sharded import render_sample_sharded
from ..render import render_sample_chw
from ..scene.scene import Scene

# group name -> tuple of (container, leaf) addresses
PARAM_GROUPS = {
    "albedo": (("materials", "albedo"),),
    "emission": (("materials", "emission"),),
    "ior": (("materials", "ior"),),
    "vertices": (("scene", "tri_v0"), ("scene", "tri_v1"),
                 ("scene", "tri_v2")),
    "spheres": (("scene", "sph_center"), ("scene", "sph_radius")),
    "planes": (("scene", "pln_normal"), ("scene", "pln_d")),
    "camera": (("camera", "translation"), ("camera", "rotation")),
}

DEFAULT_GROUPS = ("albedo", "emission")


def _group_leaves(groups):
    seen = []
    for g in groups:
        if g not in PARAM_GROUPS:
            raise ValueError(
                f"unknown param group {g!r}; known: {sorted(PARAM_GROUPS)}")
        seen.extend(PARAM_GROUPS[g])
    return seen


def trainable_params(scene: Scene, groups=DEFAULT_GROUPS, camera=None) -> dict:
    """The differentiable leaves targeted by inverse rendering, keyed
    ``container.leaf`` (e.g. ``materials.albedo``, ``scene.tri_v0``,
    ``camera.translation``)."""
    out = {}
    for container, leaf in _group_leaves(groups):
        if container == "materials":
            out[f"materials.{leaf}"] = getattr(scene.materials, leaf)
        elif container == "scene":
            out[f"scene.{leaf}"] = getattr(scene, leaf)
        else:
            if camera is None:
                raise ValueError("camera group requires camera=...")
            out[f"camera.{leaf}"] = getattr(camera, leaf)
    return out


def apply_params(scene: Scene, params: dict) -> Scene:
    """Scene with the scene/material leaves in ``params`` substituted."""
    mat_kw = {k.split(".", 1)[1]: v for k, v in params.items()
              if k.startswith("materials.")}
    scn_kw = {k.split(".", 1)[1]: v for k, v in params.items()
              if k.startswith("scene.")}
    if mat_kw:
        scene = dataclasses.replace(
            scene, materials=dataclasses.replace(scene.materials, **mat_kw))
    if scn_kw:
        scene = dataclasses.replace(scene, **scn_kw)
    return scene


def apply_camera(camera, params: dict):
    cam_kw = {k.split(".", 1)[1]: v for k, v in params.items()
              if k.startswith("camera.")}
    return dataclasses.replace(camera, **cam_kw) if cam_kw else camera


def constrain_params(params: dict) -> dict:
    """Project updated parameters back to their physical domains."""
    out = dict(params)
    if "materials.albedo" in out:
        out["materials.albedo"] = jnp.clip(out["materials.albedo"], 0.0, 1.0)
    if "materials.emission" in out:
        out["materials.emission"] = jnp.maximum(out["materials.emission"], 0.0)
    if "materials.ior" in out:
        out["materials.ior"] = jnp.clip(out["materials.ior"], 1.0, 3.0)
    if "scene.sph_radius" in out:
        out["scene.sph_radius"] = jnp.maximum(out["scene.sph_radius"], 1e-3)
    if "scene.pln_normal" in out:
        n = out["scene.pln_normal"]
        out["scene.pln_normal"] = n / jnp.maximum(
            jnp.linalg.norm(n, axis=-1, keepdims=True), 1e-8)
    return out


def _make_fast_render(scene_tpl, settings, cfg, mesh):
    """Image-valued render closure backed by the hit-record gradient
    (ops.fast_grad): forward = XLA Kajiya chain recording its hits,
    backward = reverse-mode AD of the replay from those hits.  With a mesh,
    runs per-shard inside shard_map — the shard_map transpose psums the
    replicated scene cotangent across cards.

    Returns ``render_fast(scene, camera, frame) -> f32[3, H, W]``; aa > 1
    averages per-sample traces with the display path's AA_STRIDE salt
    layout and jitter (render.jittered_camera_rays), so the gradient is the
    mean of per-sample VJPs."""
    from jax.sharding import PartitionSpec as P

    from ..models.integrators import AA_STRIDE
    from ..ops.fast_grad import make_fast_kajiya
    from ..render import _INTEGRATOR_SITE, _pixel_grid, jittered_camera_rays

    trace = make_fast_kajiya(
        scene_tpl, _INTEGRATOR_SITE, settings.max_bounces,
        style=settings.style,
    )
    aa = settings.aa

    def shade(pixel, xs, ys, s, cam, frame, salt_off):
        acc = 0.0
        for i in range(aa):
            salt_i = salt_off + jnp.uint32(i * AA_STRIDE)
            ray = jittered_camera_rays(cam, cfg, pixel, xs, ys, frame, salt_i)
            acc = acc + trace(s, ray.origin, ray.direction, pixel, frame,
                              salt=salt_i)
        return acc.T / aa  # [3, n]

    if mesh is None:

        def render_fast(s, cam, frame):
            # Grids are built INSIDE the traced function: closing over 2M-
            # element concrete arrays embeds them as XLA constants, which
            # blows compile time up ~20x (measured 121s vs 5.5s at 1080p).
            pixel, xs, ys = _pixel_grid(cfg)
            out = shade(pixel, xs, ys, s, cam, frame, jnp.uint32(0))
            return out.reshape(3, cfg.height, cfg.width)

        return render_fast

    from functools import partial as _partial

    from ..parallel.mesh import SPP_AXIS, TILE_AXIS
    from ..parallel.sharded import _padded_grid

    n_tiles = mesh.shape[TILE_AXIS]
    n_spp = mesh.shape[SPP_AXIS]
    n = cfg.num_pixels

    @_partial(
        jax.shard_map, mesh=mesh,
        in_specs=(P(TILE_AXIS), P(TILE_AXIS), P(TILE_AXIS), P(), P(), P()),
        out_specs=P(None, TILE_AXIS), check_vma=False,
    )
    def tile(pixel, xs, ys, s, cam, frame):
        rank = jax.lax.axis_index(SPP_AXIS).astype(jnp.uint32)
        out = shade(pixel, xs, ys, s, cam, frame,
                    rank * jnp.uint32(aa * AA_STRIDE))
        if n_spp > 1:
            out = jax.lax.pmean(out, SPP_AXIS)
        return out

    def render_fast(s, cam, frame):
        # Grids built inside the trace (see the single-device comment).
        pixel, xs, ys, _ = _padded_grid(cfg, n_tiles)
        return tile(pixel, xs, ys, s, cam, frame)[:, :n].reshape(
            3, cfg.height, cfg.width
        )

    return render_fast


def _fast_eligible(settings: RenderSettings) -> bool:
    """The hit-record gradient serves Kajiya-only settings (every split
    quadrant mode 9), on every platform and scene."""
    return set(settings.modes()) == {9}


def accumulate_frames(render, cfg: FilmConfig, params, frame0, k):
    """EMA-film accumulation of ``k`` sample frames as a differentiable
    lax.scan: frames are sequential state updates of the film (SURVEY §7
    "frames as a lax.scan with the EMA as differentiable state"), and the
    gradient of a loss on the RESULT flows back through every one of the
    k samples — the EMA update (ops/film.py, compute_pass.comp:146-166)
    sits on the tangent path, not just the display path.

    ``render(params, frame) -> f32[3,H,W]``; frames frame0..frame0+k-1
    decorrelate the per-frame RNG streams.  A fresh film starts at
    frame=0, which the accumulate op itself treats as the dirty reset."""
    from ..ops import film as film_ops

    film0 = film_ops.Film.create(cfg.height, cfg.width)

    def body(film, i):
        return film_ops.accumulate(film, render(params, frame0 + i),
                                   False), None

    film, _ = jax.lax.scan(
        body, film0, jnp.arange(k, dtype=jnp.uint32))
    return film.accum


def make_train_step(scene, camera, settings: RenderSettings, cfg: FilmConfig,
                    mesh, target, learning_rate: float = 2e-2, fast="auto",
                    groups=DEFAULT_GROUPS, accum_frames: int = 1):
    """Build (jitted step fn, initial optimizer state) for sharded training.

    ``target`` is channels-first f32[3,H,W] (the film layout).
    step(params, opt_state, frame) -> (params, opt_state, loss); ``frame``
    varies the RNG stream per iteration so Monte-Carlo noise decorrelates
    across optimizer steps (stochastic gradient estimates).

    ``groups`` selects the trainable leaves (PARAM_GROUPS keys); the camera
    group optimizes pose through ray generation (models/camera.py).

    ``fast``: "auto" uses the hit-record gradient (ops.fast_grad) for
    Kajiya-only settings and XLA autodiff of the integrators otherwise;
    True forces the hit-record gradient, False forces autodiff.

    ``accum_frames`` > 1 targets the EMA-ACCUMULATED film after that many
    frames (accumulate_frames): the loss sees the k-frame temporal mean and
    its gradient flows through every accumulated sample — lower-variance
    per-step gradients at k× the render cost per step.
    """
    opt = optax.adam(learning_rate)
    opt_state = opt.init(trainable_params(scene, groups, camera))

    use_fast = _fast_eligible(settings) if fast == "auto" else bool(fast)
    if use_fast:
        render_fast = _make_fast_render(scene, settings, cfg, mesh)

    def render(p, frame):
        s = apply_params(scene, p)
        cam = apply_camera(camera, p)
        if use_fast:
            return render_fast(s, cam, frame)
        if mesh is not None:
            return render_sample_sharded(s, cam, settings, cfg, frame, mesh)
        return render_sample_chw(s, cam, settings, cfg, frame)

    k = max(int(accum_frames), 1)
    if k > 1:
        def render_used(p, frame0):
            return accumulate_frames(render, cfg, p, frame0, k)
    else:
        render_used = render

    @jax.jit
    def step(params, opt_state, frame):
        # Unbiased gradient of the squared error of the MEAN image via two
        # independent Monte-Carlo samples (the standard dual-buffer estimator
        # of differentiable rendering):
        #   d/dp E[X-t]^2 = 2 E[X - t] * dE[X]/dp  ~  2 (X_a - t) . dX_b/dp
        # A single-sample value_and_grad instead optimizes E[(X-t)^2] =
        # (E[X]-t)^2 + Var[X], whose variance term pulls emission DOWN (dim
        # scenes are less noisy) — observed as divergence on the Cornell box.
        # With accum_frames each buffer is the k-frame EMA film; the two
        # streams stay disjoint (2k frame ids per optimizer step).
        img_a = jax.lax.stop_gradient(
            render_used(params, frame * (2 * k) + 4096))
        img_b, vjp_fn = jax.vjp(
            lambda p: render_used(p, frame * (2 * k) + 4096 + k), params)
        residual = 2.0 * (img_a - target) / img_a.size
        (grads,) = vjp_fn(residual)
        loss = jnp.mean(jnp.square(img_a - target))
        updates, opt_state2 = opt.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        params = constrain_params(params)
        return params, opt_state2, loss

    return step, opt_state


def recover(scene_init, camera, settings, cfg, mesh, target, steps=100,
            learning_rate=2e-2, log_every=0, groups=DEFAULT_GROUPS,
            fast="auto", accum_frames: int = 1):
    """Run the optimization loop; returns (final scene, loss history).
    With the camera group, the recovered pose is applied to the returned
    scene's camera via ``apply_camera`` — fetch it from the third element."""
    step, opt_state = make_train_step(
        scene_init, camera, settings, cfg, mesh, target, learning_rate,
        fast=fast, groups=groups, accum_frames=accum_frames,
    )
    params = trainable_params(scene_init, groups, camera)
    losses = []
    for i in range(steps):
        params, opt_state, loss = step(params, opt_state, jnp.uint32(i))
        losses.append(float(loss))
        if log_every and i % log_every == 0:
            print(f"step {i}: loss {losses[-1]:.6f}")
    return apply_params(scene_init, params), losses, apply_camera(
        camera, params)

"""Inverse rendering convergence (BASELINE.md config 5, small scale)."""

import jax.numpy as jnp
import numpy as np

from rvpt_tpu import FilmConfig, RenderSettings
from rvpt_tpu.render import render_sample_chw
from rvpt_tpu.scene.materials import LAMBERT
from rvpt_tpu.scene.scene import SceneBuilder
from rvpt_tpu.train import inverse


def _emissive_scene(emission):
    b = SceneBuilder()
    b.add_material(albedo=(0.0, 0.0, 0.0), emission=emission, kind=LAMBERT)
    b.add_triangle((-4, -4, 3), (4, -4, 3), (0, 6, 3), 0)
    return b.build()


def test_recover_emission_direct():
    """A directly-visible emissive triangle: emission is recovered by the
    dual-buffer gradient estimator."""
    from rvpt_tpu.models.camera import Camera

    cfg = FilmConfig(width=24, height=24)
    st = RenderSettings(max_bounces=1, style="standard")
    cam = Camera.create(aspect=1.0, fov=90.0)
    true_em = (2.0, 1.0, 0.5)
    scene_true = _emissive_scene(true_em)
    target = render_sample_chw(scene_true, cam, st, cfg, 0)

    scene_init = _emissive_scene((0.2, 0.2, 0.2))
    rec, losses, _ = inverse.recover(
        scene_init, cam, st, cfg, None, target, steps=120, learning_rate=5e-2
    )
    got = np.asarray(rec.materials.emission)[0]
    assert np.allclose(got, true_em, atol=0.15), f"recovered {got}"


def test_dual_estimator_unbiased_direction():
    """At the true parameters the expected gradient is ~0; with dimmed
    emission it points back toward the truth (negative for emission)."""
    import dataclasses

    import jax

    from rvpt_tpu.models.camera import Camera

    cfg = FilmConfig(width=16, height=16)
    st = RenderSettings(max_bounces=1, style="standard")
    cam = Camera.create(aspect=1.0, fov=90.0)
    scene_true = _emissive_scene((2.0, 2.0, 2.0))
    target = render_sample_chw(scene_true, cam, st, cfg, 0)

    step, opt_state = inverse.make_train_step(
        scene_true, cam, st, cfg, None, target
    )
    # run one step from a dimmed start: emission must increase
    params = inverse.trainable_params(scene_true)
    dim = dict(params)
    dim["materials.emission"] = params["materials.emission"] * 0.3
    new_params, _, _ = step(dim, opt_state, jnp.uint32(0))
    assert (float(new_params["materials.emission"][0, 0])
            > float(dim["materials.emission"][0, 0]))


def test_recover_sphere_radius_fast_path():
    """Geometry recovery through the hit-record gradient: a MIRROR
    sphere under the gradient sky — the reflected sky color varies
    continuously with the radius-dependent normal field, so the interior
    pathwise gradient (the VJP's sph_radius cotangent, ops/fast_grad.py)
    pulls the radius toward truth.  (A Lambert sphere would NOT work:
    there the radius signal is silhouette growth — a visibility/edge
    gradient, out of scope for pathwise estimators by design, SURVEY §7.)"""
    from rvpt_tpu.models.camera import Camera
    from rvpt_tpu.scene.scene import SceneBuilder

    def mirror_scene(radius):
        b = SceneBuilder()
        mir = b.add_material(albedo=(0.95, 0.95, 0.95), kind=1)
        b.add_sphere((0.0, 0.0, 3.0), radius, mir)
        return b.build()

    cfg = FilmConfig(width=24, height=24)
    st = RenderSettings(max_bounces=2, style="standard")
    cam = Camera.create(aspect=1.0, fov=60.0)
    target = render_sample_chw(mirror_scene(1.0), cam, st, cfg, 0)

    rec, losses, _ = inverse.recover(
        mirror_scene(0.7), cam, st, cfg, None, target, steps=80,
        learning_rate=2e-2, groups=("spheres",), fast=True,
    )
    got = float(np.asarray(rec.sph_radius)[0])
    # Radius/depth are weakly coupled through angular size (the center may
    # absorb part of the signal); require a decisive move toward truth.
    assert got > 0.85, f"recovered radius {got}"


def test_camera_group_trains():
    """The camera param group flows pose gradients through ray generation
    (models/camera.py; tests/test_camera_grad.py pins the math): one step
    from a nudged pose must move the rotation and stay finite.  (Rotation
    has an interior radiance gradient through the direction-dependent sky;
    translation's radiance signal in a flat Lambert box is edge-only and
    correctly zero for pathwise estimators — pose translation is fit with
    a depth loss instead, examples/camera_pose_recovery.py.)"""
    from rvpt_tpu.scene import builtin

    cfg = FilmConfig(width=24, height=16)
    st = RenderSettings(max_bounces=2, style="standard")
    scene, cam_true = builtin.cornell_box(aspect=cfg.aspect)
    target = render_sample_chw(scene, cam_true, st, cfg, 0)

    import dataclasses
    cam0 = dataclasses.replace(
        cam_true, rotation=cam_true.rotation + jnp.float32(0.05))
    step, opt_state = inverse.make_train_step(
        scene, cam0, st, cfg, None, target, learning_rate=1e-2,
        fast=True, groups=("camera",),
    )
    params = inverse.trainable_params(scene, ("camera",), cam0)
    new_params, _, loss = step(params, opt_state, jnp.uint32(0))
    assert np.isfinite(float(loss))
    assert not np.allclose(np.asarray(new_params["camera.rotation"]),
                           np.asarray(cam0.rotation))
    cam_rec = inverse.apply_camera(cam0, new_params)
    assert not np.allclose(np.asarray(cam_rec.rotation),
                           np.asarray(cam0.rotation))


def test_fast_train_step_aa2():
    """aa > 1 on the hit-record path: per-sample VJPs are averaged; the
    step runs finite with nonzero gradient flow."""
    from rvpt_tpu.scene import builtin

    cfg = FilmConfig(width=32, height=16)
    settings = RenderSettings(max_bounces=2, aa=2, style="standard")
    scene, camera = builtin.cornell_box(aspect=cfg.aspect)
    target = jnp.zeros((3, cfg.height, cfg.width), jnp.float32)

    step, opt = inverse.make_train_step(
        scene, camera, settings, cfg, None, target, fast=True
    )
    p0 = inverse.trainable_params(scene)
    p1, _, loss = step(p0, opt, jnp.uint32(0))
    assert np.isfinite(float(loss))
    assert not np.allclose(np.asarray(p1["materials.albedo"]),
                           np.asarray(p0["materials.albedo"]))


def test_fast_train_step_matches_single_device():
    """The hit-record-gradient trainer: sharded (4x2 mesh, psum'd scene
    grads) and single-device fast steps produce matching updates, and both
    run finite."""
    import jax.numpy as jnp
    import numpy as np

    from rvpt_tpu import FilmConfig, RenderSettings
    from rvpt_tpu.parallel import mesh as mesh_mod
    from rvpt_tpu.scene import builtin
    from rvpt_tpu.train.inverse import (apply_params, make_train_step,
                                        trainable_params)

    cfg = FilmConfig(width=32, height=16)
    settings = RenderSettings(max_bounces=2, aa=1, style="standard")
    scene, camera = builtin.cornell_box(aspect=cfg.aspect)
    target = jnp.zeros((3, cfg.height, cfg.width), jnp.float32)

    step1, opt1 = make_train_step(
        scene, camera, settings, cfg, None, target, fast=True
    )
    p1, _, loss1 = step1(trainable_params(scene), opt1, jnp.uint32(0))

    mesh = mesh_mod.make_mesh(8, 1)
    step2, opt2 = make_train_step(
        scene, camera, settings, cfg, mesh, target, fast=True
    )
    p2, _, loss2 = step2(trainable_params(scene), opt2, jnp.uint32(0))

    assert np.isfinite(float(loss1)) and np.isfinite(float(loss2))
    assert np.allclose(float(loss1), float(loss2), rtol=1e-5)
    for k in p1:
        assert np.allclose(np.asarray(p1[k]), np.asarray(p2[k]),
                           rtol=1e-4, atol=1e-6), k

    # spp=2 mesh exercises the rank-salted decorrelated gradient estimator
    mesh2 = mesh_mod.make_mesh(4, 2)
    step3, opt3 = make_train_step(
        scene, camera, settings, cfg, mesh2, target, fast=True
    )
    p3, _, loss3 = step3(trainable_params(scene), opt3, jnp.uint32(0))
    assert np.isfinite(float(loss3))
    assert np.abs(np.asarray(p3["materials.albedo"])).sum() > 0


def test_ema_film_gradient_matches_finite_differences():
    """Gradients flow through the EMA-accumulated film: d(loss on the
    4-frame accumulated image)/d(albedo) via autodiff of
    inverse.accumulate_frames == central finite differences (VERDICT r4
    item 6 — the differentiable-EMA claim, compute_pass.comp:146-166
    semantics as a lax.scan over ops/film.accumulate)."""
    import dataclasses

    import jax

    from rvpt_tpu.models.camera import Camera
    from rvpt_tpu.scene import builtin

    cfg = FilmConfig(width=16, height=12)
    st = RenderSettings(max_bounces=2, style="standard")
    scene, cam = builtin.cornell_box(aspect=cfg.aspect)
    k = 4

    def render(p, frame):
        mats = dataclasses.replace(scene.materials, albedo=p)
        s = dataclasses.replace(scene, materials=mats)
        return render_sample_chw(s, cam, st, cfg, frame)

    def loss(p):
        img = inverse.accumulate_frames(render, cfg, p, jnp.uint32(9), k)
        return jnp.mean(jnp.square(img))

    p0 = scene.materials.albedo
    g = np.asarray(jax.grad(loss)(p0))
    assert np.abs(g).max() > 0

    # FD pin on the largest-|g| coordinates (same RNG streams per call, so
    # the FD sees the same discrete decisions as the autodiff).
    flat = np.argsort(-np.abs(g).ravel())[:3]
    eps = 1e-3
    for f in flat:
        i, j = divmod(int(f), g.shape[1])
        e = jnp.zeros_like(p0).at[i, j].set(eps)
        fd = (float(loss(p0 + e)) - float(loss(p0 - e))) / (2 * eps)
        assert abs(g[i, j] - fd) < max(0.05 * abs(fd), 1e-4), (
            f"leaf ({i},{j}): grad {g[i, j]} vs fd {fd}")


def test_train_step_accum_frames_converges():
    """The accum_frames trainer flag: optimizing against a 3-frame EMA
    target still recovers emission (the multi-frame gradient path is
    wired end-to-end, not just the helper)."""
    from rvpt_tpu.models.camera import Camera

    cfg = FilmConfig(width=16, height=16)
    st = RenderSettings(max_bounces=1, style="standard")
    cam = Camera.create(aspect=1.0, fov=90.0)
    true_em = (1.5, 0.8, 0.4)
    scene_true = _emissive_scene(true_em)
    target = render_sample_chw(scene_true, cam, st, cfg, 0)

    scene_init = _emissive_scene((0.2, 0.2, 0.2))
    rec, losses, _ = inverse.recover(
        scene_init, cam, st, cfg, None, target, steps=60,
        learning_rate=8e-2, accum_frames=3,
    )
    got = np.asarray(rec.materials.emission)[0]
    assert np.allclose(got, true_em, atol=0.2), f"recovered {got}"
    assert losses[-1] < losses[0]

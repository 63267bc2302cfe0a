"""The hit-record gradient path (ops.fast_grad): the forward's recorded hits
agree with the integrator's own searches, and the gradient equals XLA
autodiff of the integrator for every trainable parameter group."""


import jax
import jax.numpy as jnp
import numpy as np
import pytest

from rvpt_tpu import FilmConfig, RenderSettings
from rvpt_tpu.models.integrators import integrator_kajiya, kajiya_with_hits
from rvpt_tpu.ops.fast_grad import kajiya_from_hits, make_fast_kajiya
from rvpt_tpu.ops.intersect import closest_hit_scene
from rvpt_tpu.render import _INTEGRATOR_SITE, _pixel_grid, jittered_camera_rays
from rvpt_tpu.models.camera import Camera
from rvpt_tpu.scene import builtin
from rvpt_tpu.scene.materials import DIELECTRIC, LAMBERT, MIRROR
from rvpt_tpu.scene.scene import SceneBuilder
from rvpt_tpu.train import inverse


def open_scene(aspect):
    """Every primitive family and material kind under the open sky: rays
    that leave through mirror and glass reach the direction-dependent sky,
    so every parameter group has an interior radiance gradient."""
    b = SceneBuilder()
    ground = b.add_material(albedo=(0.8, 0.7, 0.6), kind=LAMBERT)
    mirror = b.add_material(albedo=(0.9, 0.9, 0.9), kind=MIRROR)
    glass = b.add_material(albedo=(0.95, 0.95, 0.95), kind=DIELECTRIC,
                           ior=1.5)
    lamp = b.add_material(albedo=(0.5, 0.5, 0.5), emission=(3.0, 2.0, 1.0),
                          kind=LAMBERT)
    b.add_plane((0.0, 1.0, 0.0), -1.0, ground)
    b.add_sphere((-0.8, -0.2, 3.5), 0.7, mirror)
    b.add_sphere((0.7, 0.6, 2.5), 0.6, glass)
    b.add_quad((-2.0, -1.0, 5.0), (2.0, -1.0, 5.0), (2.0, 1.5, 5.5),
               (-2.0, 1.5, 5.5), mirror)
    b.add_triangle((-0.4, 0.8, 3.0), (0.4, 0.8, 3.0), (0.0, 1.2, 3.2), lamp)
    return b.build(), Camera.create(translation=(0, 0, 0), fov=90.0,
                                    aspect=aspect)


SCENES = {
    "open": open_scene,
    "cornell": lambda a: builtin.cornell_box(aspect=a),
    "sphere_plane": lambda a: builtin.sphere_plane(aspect=a),
    "mesh": lambda a: builtin.mesh_demo(subdiv=0, aspect=a),
    "rabbit": lambda a: builtin.rabbit(aspect=a),
}


def _rays(scene_name, w=16, h=8, frame=1):
    cfg = FilmConfig(width=w, height=h)
    scene, cam = SCENES[scene_name](cfg.aspect)
    pixel, xs, ys = _pixel_grid(cfg)
    ray = jittered_camera_rays(cam, cfg, pixel, xs, ys, jnp.uint32(frame),
                               jnp.uint32(0))
    return cfg, scene, cam, pixel, ray


@pytest.mark.parametrize("style", ["reference", "standard"])
@pytest.mark.parametrize("scene_name", sorted(SCENES))
def test_forward_hit_records_match_searches(scene_name, style):
    """Bounce 0's record is the primary-ray search itself; replaying every
    record reproduces the integrator's radiance; the records are the same
    with and without the custom VJP around them."""
    _, scene, _, pixel, ray = _rays(scene_name)
    frame = jnp.uint32(1)
    out, fams, idxs = kajiya_with_hits(scene, ray, pixel, frame, 3, style,
                                       salt_base=_INTEGRATOR_SITE)
    assert fams.shape == idxs.shape == (3, pixel.shape[0])

    fam0, idx0, _ = closest_hit_scene(scene, ray, 0.0, jnp.inf)
    np.testing.assert_array_equal(np.asarray(fams[0]), np.asarray(fam0))
    np.testing.assert_array_equal(np.asarray(idxs[0]), np.asarray(idx0))

    replay = kajiya_from_hits(scene, ray, pixel, frame, _INTEGRATOR_SITE,
                              fams, idxs, style)
    np.testing.assert_allclose(np.asarray(replay), np.asarray(out),
                               rtol=1e-5, atol=1e-6)
    st = RenderSettings(max_bounces=3, style=style)
    ref = integrator_kajiya(scene, ray, pixel, frame, st, _INTEGRATOR_SITE)
    np.testing.assert_array_equal(np.asarray(out), np.asarray(ref))


# (parameter group, scene that exercises it)
GROUPS = [
    ("albedo", "cornell"),
    ("emission", "cornell"),
    ("ior", "open"),
    ("vertices", "open"),
    ("spheres", "open"),
    ("planes", "open"),
    ("camera", "open"),
]


@pytest.mark.parametrize("group,scene_name", GROUPS)
def test_hit_record_grad_matches_autodiff(group, scene_name):
    """d(mean radiance)/d(group) through the custom VJP == XLA autodiff of
    the integrator, same RNG streams and discrete decisions.  The tolerance
    covers float32 summation order: the replay accumulates per-ray
    cotangents in a different order than autodiff of the [N,3] chain."""
    cfg = FilmConfig(width=16, height=8)
    scene, cam = SCENES[scene_name](cfg.aspect)
    st = RenderSettings(max_bounces=3, style="standard")
    frame = jnp.uint32(1)
    pixel, xs, ys = _pixel_grid(cfg)
    trace = make_fast_kajiya(scene, _INTEGRATOR_SITE, 3, style="standard")

    def loss(params, fast):
        s = inverse.apply_params(scene, params)
        c = inverse.apply_camera(cam, params)
        ray = jittered_camera_rays(c, cfg, pixel, xs, ys, frame,
                                   jnp.uint32(0))
        if fast:
            img = trace(s, ray.origin, ray.direction, pixel, frame)
        else:
            img = integrator_kajiya(s, ray, pixel, frame, st,
                                    _INTEGRATOR_SITE)
        return jnp.mean(img)

    params = inverse.trainable_params(scene, (group,), cam)
    g_fast = jax.grad(lambda p: loss(p, True))(params)
    g_xla = jax.grad(lambda p: loss(p, False))(params)
    total = 0.0
    for k in params:
        a, b = np.asarray(g_fast[k]), np.asarray(g_xla[k])
        np.testing.assert_allclose(a, b, rtol=2e-3, atol=1e-6, err_msg=k)
        total += float(np.abs(b).sum())
    assert total > 0.0, "no gradient flowed"

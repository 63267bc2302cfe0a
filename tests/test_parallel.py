import jax
import jax.numpy as jnp
import numpy as np
import pytest

from rvpt_tpu import render as R
from rvpt_tpu.config import FilmConfig, RenderSettings
from rvpt_tpu.parallel import mesh as mesh_mod
from rvpt_tpu.parallel.sharded import render_sample_sharded
from rvpt_tpu.scene import builtin

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs the 8-device virtual CPU mesh"
)


def test_sharded_matches_single_device():
    """Tile-sharded rendering is bit-identical to single-device rendering
    (RNG keyed by global pixel id)."""
    scene, cam = builtin.cornell_box(aspect=2.0)
    cfg = FilmConfig(width=64, height=32)
    st = RenderSettings(max_bounces=3)
    mesh = mesh_mod.make_mesh(8, 1)
    img_ref = np.asarray(R.render_sample_chw(scene, cam, st, cfg, 0))
    img_sh = np.asarray(render_sample_sharded(scene, cam, st, cfg, 0, mesh))
    assert np.array_equal(img_ref, img_sh)


def test_sharded_2d_mesh_spp():
    """(4 tiles x 2 spp) mesh: the spp axis averages two decorrelated sample
    sets — equal to the hand-computed mean of the two aa_offset renders."""
    scene, cam = builtin.sphere_plane(aspect=1.0)
    cfg = FilmConfig(width=32, height=32)
    st = RenderSettings(max_bounces=2, aa=1)
    mesh = mesh_mod.make_mesh(4, 2)
    img_sh = np.asarray(render_sample_sharded(scene, cam, st, cfg, 0, mesh))

    pixel, xs, ys = R._pixel_grid(cfg)
    s0 = R.render_pixels(scene, cam, st, cfg, 0, pixel, xs, ys, aa_offset=0)
    s1 = R.render_pixels(scene, cam, st, cfg, 0, pixel, xs, ys, aa_offset=1)
    expect = np.asarray((s0 + s1) / 2.0).T.reshape(3, 32, 32)
    assert np.allclose(img_sh, expect, atol=1e-6)


def test_sharded_unaligned_film():
    """Film whose pixel count doesn't divide the mesh still renders
    correctly (padding lanes dropped)."""
    scene, cam = builtin.sphere_plane(aspect=1.0)
    cfg = FilmConfig(width=30, height=10)  # 300 pixels, not divisible by 8
    st = RenderSettings(max_bounces=1)
    mesh = mesh_mod.make_mesh(8, 1)
    img_ref = np.asarray(R.render_sample_chw(scene, cam, st, cfg, 0))
    img_sh = np.asarray(render_sample_sharded(scene, cam, st, cfg, 0, mesh))
    assert np.array_equal(img_ref, img_sh)


def test_sharded_grad_psum():
    """Gradients of replicated material params through the sharded render
    equal the single-device gradients (shard_map transpose psums them)."""
    import dataclasses

    scene, cam = builtin.sphere_plane(aspect=1.0)
    cfg = FilmConfig(width=16, height=16)
    st = RenderSettings(max_bounces=2, style="standard")
    mesh = mesh_mod.make_mesh(8, 1)

    def loss_single(albedo):
        mats = dataclasses.replace(scene.materials, albedo=albedo)
        s = dataclasses.replace(scene, materials=mats)
        return jnp.mean(R.render_sample(s, cam, st, cfg, 0))

    def loss_sharded(albedo):
        mats = dataclasses.replace(scene.materials, albedo=albedo)
        s = dataclasses.replace(scene, materials=mats)
        return jnp.mean(render_sample_sharded(s, cam, st, cfg, 0, mesh))

    g1 = jax.grad(loss_single)(scene.materials.albedo)
    g2 = jax.grad(loss_sharded)(scene.materials.albedo)
    assert np.allclose(np.asarray(g1), np.asarray(g2), rtol=1e-5, atol=1e-7)
    assert np.abs(np.asarray(g1)).max() > 0  # gradients actually flow


def test_graft_entry_dryrun():
    import __graft_entry__

    __graft_entry__.dryrun_multichip(8)


def test_graft_entry_single():
    import __graft_entry__

    fn, args = __graft_entry__.entry()
    out = jax.jit(fn)(*args)
    assert out.shape == (256, 256, 3)
    assert bool(jnp.isfinite(out).all())


def test_sharded_steady_loop_rides_kernels():
    """render_frame_sharded (the reference's steady loop, rvpt.cpp:346-404,
    over the mesh) on a BVH mesh accumulates exactly the single-device
    sample: spp axis 1, RNG keyed by global pixel id."""
    from rvpt_tpu.ops import film as film_ops
    from rvpt_tpu.parallel import sharded

    scene, cam = builtin.mesh_demo(subdiv=1, aspect=2.0)
    cfg = FilmConfig(width=64, height=32)
    st = RenderSettings(max_bounces=2)

    mesh = mesh_mod.make_mesh(8, 1)
    film = film_ops.Film.create(cfg.height, cfg.width)
    film, accum = sharded.render_frame_sharded(
        scene, cam, st, cfg, film, jnp.bool_(True), mesh)
    ref = np.asarray(R.render_sample_chw(scene, cam, st, cfg, 0))
    assert np.array_equal(np.asarray(accum), ref)
    assert int(film.frame) == 1

    # the jitted steady-loop closure gives the same frame up to the float32
    # rounding of a differently fused program
    step = sharded.make_render_fn(scene, cam, st, cfg, mesh)
    _, accum2 = step(scene, cam, film_ops.Film.create(cfg.height, cfg.width),
                     jnp.bool_(True))
    assert np.allclose(np.asarray(accum2), ref, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("mode", list(range(11)))
def test_sharded_fast_debug_modes(mode):
    """Every integrator mode through the sharded renderer equals the
    single-device render of the same mode."""
    scene, cam = builtin.cornell_box(aspect=2.0)
    cfg = FilmConfig(width=64, height=32)
    st = RenderSettings(max_bounces=2, top_left_render_mode=mode,
                        top_right_render_mode=mode,
                        bottom_left_render_mode=mode,
                        bottom_right_render_mode=mode)

    ref = np.asarray(R.render_sample_chw(scene, cam, st, cfg, 0))
    mesh = mesh_mod.make_mesh(8, 1)
    img = np.asarray(render_sample_sharded(scene, cam, st, cfg, 0, mesh))
    # atol 1e-5: shard-local batch shapes change reduction fusion order
    # (observed max diff 9e-6 on normalize() in mode 3).
    assert np.allclose(img, ref, atol=1e-5), f"mode {mode}"


def test_sharded_fast_split_screen():
    """4-way split through the sharded renderer equals the single-device
    split render (compute_pass.comp:134-144); a (4 x 2 spp) mesh stays
    finite."""
    scene, cam = builtin.cornell_box(aspect=2.0)
    cfg = FilmConfig(width=64, height=32)
    st = RenderSettings(max_bounces=2, top_left_render_mode=3,
                        top_right_render_mode=9, bottom_left_render_mode=0,
                        bottom_right_render_mode=7)

    ref = np.asarray(R.render_sample_chw(scene, cam, st, cfg, 0))
    mesh = mesh_mod.make_mesh(8, 1)
    img = np.asarray(render_sample_sharded(scene, cam, st, cfg, 0, mesh))
    assert np.allclose(img, ref, atol=1e-6)

    mesh2 = mesh_mod.make_mesh(4, 2)
    img2 = np.asarray(render_sample_sharded(scene, cam, st, cfg, 0, mesh2))
    assert np.isfinite(img2).all()

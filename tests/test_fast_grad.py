"""Hit-record gradient (custom VJP) vs plain autodiff through the XLA
integrator, and the replay's table lookups vs plain NumPy gathers."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from rvpt_tpu import FilmConfig, RenderSettings
from rvpt_tpu.core.types import Ray
from rvpt_tpu.models.integrators import integrator_kajiya, kajiya_with_hits
from rvpt_tpu.ops.fast_grad import kajiya_from_hits, make_fast_kajiya
from rvpt_tpu.scene import builtin


def setup(scene_name="cornell", w=24, h=16):
    cfg = FilmConfig(width=w, height=h)
    maker = {"cornell": builtin.cornell_box, "sphere_plane": builtin.sphere_plane}
    scene, cam = maker[scene_name](aspect=cfg.aspect)
    from rvpt_tpu.core import rng
    from rvpt_tpu.models import camera as camera_mod
    from rvpt_tpu.render import _pixel_grid

    pixel, xs, ys = _pixel_grid(cfg)
    ju, jv = rng.uniform2(pixel, jnp.uint32(0), jnp.uint32(0))
    cx = (xs.astype(jnp.float32) + ju) / cfg.width
    cy = 1.0 - (ys.astype(jnp.float32) + jv) / cfg.height
    ray = camera_mod.generate_rays(cam, cx, cy)
    return scene, pixel, ray


def test_replay_matches_integrator():
    """kajiya_from_hits on the forward's recorded hits reproduces the XLA
    integrator's radiance."""
    scene, pixel, ray = setup()
    frame = jnp.uint32(2)
    out, fams, idxs = kajiya_with_hits(scene, ray, pixel, frame, 3,
                                       salt_base=16)
    mk_img = np.asarray(out)
    replay = np.asarray(
        kajiya_from_hits(scene, ray, pixel, frame, 16, fams, idxs)
    )
    assert np.allclose(replay, mk_img, rtol=1e-4, atol=1e-4)


def test_fast_grad_matches_autodiff():
    """d(loss)/d(albedo) via the custom VJP == plain autodiff through the XLA
    integrator (same RNG streams, same discrete decisions)."""
    scene, pixel, ray = setup()
    frame = jnp.uint32(1)
    st = RenderSettings(max_bounces=3, style="standard")

    def loss_xla(albedo):
        mats = dataclasses.replace(scene.materials, albedo=albedo)
        s = dataclasses.replace(scene, materials=mats)
        col = integrator_kajiya(s, ray, pixel, frame, st, salt_base=jnp.uint32(16))
        return jnp.mean(col)

    trace = make_fast_kajiya(scene, 16, 3, style="standard")

    def loss_fast(albedo):
        mats = dataclasses.replace(scene.materials, albedo=albedo)
        s = dataclasses.replace(scene, materials=mats)
        return jnp.mean(trace(s, ray.origin, ray.direction, pixel, frame))

    g_xla = np.asarray(jax.grad(loss_xla)(scene.materials.albedo))
    g_fast = np.asarray(jax.grad(loss_fast)(scene.materials.albedo))
    assert np.abs(g_xla).max() > 0
    assert np.allclose(g_fast, g_xla, rtol=2e-2, atol=1e-5), (
        f"max abs diff {np.abs(g_fast - g_xla).max()}"
    )


def test_fast_grad_vertex_gradients():
    """Geometry gradients flow through the replay (d loss / d sphere
    radius)."""
    scene, pixel, ray = setup("sphere_plane")
    frame = jnp.uint32(1)
    trace = make_fast_kajiya(scene, 16, 2, style="standard")

    def loss(radius):
        s = dataclasses.replace(scene, sph_radius=radius)
        return jnp.mean(trace(s, ray.origin, ray.direction, pixel, frame))

    g = float(jax.grad(loss)(scene.sph_radius)[0])
    eps = 1e-3
    l0 = float(loss(scene.sph_radius - eps))
    l1 = float(loss(scene.sph_radius + eps))
    fd = (l1 - l0) / (2 * eps)
    # visibility edges are detached; interior gradient should still dominate
    assert np.isfinite(g)
    assert abs(g - fd) < max(0.2 * abs(fd), 5e-3), f"grad {g} vs fd {fd}"


def test_replay_soa_matches_reference_replay():
    """The component-SoA replay equals the [N,3] replay in both value and
    gradient."""
    from rvpt_tpu.ops.replay_soa import kajiya_replay_soa

    scene, pixel, ray = setup()
    frame = jnp.uint32(2)
    _, fams, idxs = kajiya_with_hits(scene, ray, pixel, frame, 3, "standard",
                                     salt_base=16)
    a = np.asarray(
        kajiya_from_hits(scene, ray, pixel, frame, 16, fams, idxs, "standard")
    )
    b = np.asarray(
        kajiya_replay_soa(
            scene, ray.origin, ray.direction, pixel, frame, jnp.uint32(16),
            fams, idxs, "standard",
        )
    )
    assert np.allclose(a, b, rtol=1e-4, atol=1e-5)

    def loss_a(albedo):
        mats = dataclasses.replace(scene.materials, albedo=albedo)
        s = dataclasses.replace(scene, materials=mats)
        return jnp.mean(
            kajiya_from_hits(s, ray, pixel, frame, 16, fams, idxs, "standard")
        )

    def loss_b(albedo):
        mats = dataclasses.replace(scene.materials, albedo=albedo)
        s = dataclasses.replace(scene, materials=mats)
        return jnp.mean(
            kajiya_replay_soa(
                s, ray.origin, ray.direction, pixel, frame, jnp.uint32(16),
                fams, idxs, "standard",
            )
        )

    ga = np.asarray(jax.grad(loss_a)(scene.materials.albedo))
    gb = np.asarray(jax.grad(loss_b)(scene.materials.albedo))
    assert np.allclose(ga, gb, rtol=1e-3, atol=1e-6)


def test_fast_grad_culled_mesh_matches_autodiff():
    """The custom VJP also serves BVH-attached scenes: the forward's search
    route (BVH traversal on the CPU) records the leaf-ordered triangle
    indices the replay gathers."""
    cfg = FilmConfig(width=16, height=8)
    scene, cam = builtin.mesh_demo(subdiv=0, aspect=cfg.aspect)
    from rvpt_tpu.core import rng
    from rvpt_tpu.models import camera as camera_mod
    from rvpt_tpu.render import _pixel_grid

    pixel, xs, ys = _pixel_grid(cfg)
    ju, jv = rng.uniform2(pixel, jnp.uint32(0), jnp.uint32(0))
    cx = (xs.astype(jnp.float32) + ju) / cfg.width
    cy = 1.0 - (ys.astype(jnp.float32) + jv) / cfg.height
    ray = camera_mod.generate_rays(cam, cx, cy)
    frame = jnp.uint32(1)
    st = RenderSettings(max_bounces=2, style="standard")

    def loss_xla(albedo):
        mats = dataclasses.replace(scene.materials, albedo=albedo)
        s = dataclasses.replace(scene, materials=mats)
        col = integrator_kajiya(s, ray, pixel, frame, st, salt_base=jnp.uint32(16))
        return jnp.mean(col)

    trace = make_fast_kajiya(scene, 16, 2, style="standard")

    def loss_fast(albedo):
        mats = dataclasses.replace(scene.materials, albedo=albedo)
        s = dataclasses.replace(scene, materials=mats)
        return jnp.mean(trace(s, ray.origin, ray.direction, pixel, frame))

    assert scene.bvh is not None
    g_xla = np.asarray(jax.grad(loss_xla)(scene.materials.albedo))
    g_fast = np.asarray(jax.grad(loss_fast)(scene.materials.albedo))
    assert np.abs(g_xla).max() > 0
    assert np.allclose(g_fast, g_xla, rtol=2e-2, atol=1e-5), (
        f"max abs diff {np.abs(g_fast - g_xla).max()}"
    )


def test_fast_grad_bigmesh_matches_autodiff():
    """A random BVH mesh whose triangle table is past the select-sum lookup
    width: the replay gathers vertices with plain gathers and its backward
    scatter-adds them, and the result reproduces XLA autodiff."""
    from rvpt_tpu.ops import replay_soa as rs
    from rvpt_tpu.scene.bvh import attach_bvh
    from rvpt_tpu.scene.scene import SceneBuilder

    rng_np = np.random.default_rng(23)
    n_tri = 120
    c = rng_np.uniform(-2, 2, size=(n_tri, 3)).astype(np.float32)
    c[:, 2] += 4.0
    e1 = rng_np.normal(0, 0.5, size=(n_tri, 3)).astype(np.float32)
    e2 = rng_np.normal(0, 0.5, size=(n_tri, 3)).astype(np.float32)
    b = SceneBuilder()
    m = b.add_material(albedo=(0.6, 0.5, 0.4))
    for a, v1, v2 in zip(c, c + e1, c + e2):
        b.add_triangle(tuple(a), tuple(v1), tuple(v2), m)
    lm = b.add_material(albedo=(0, 0, 0), emission=(4, 4, 4))
    b.add_sphere((0.0, 5.0, 2.0), 1.0, lm)
    scene = attach_bvh(b.build())
    assert scene.num_triangles > rs._LOOKUP_UNROLL

    cfg = FilmConfig(width=16, height=8)
    cam = builtin.sphere_plane(aspect=cfg.aspect)[1]
    from rvpt_tpu.core import rng
    from rvpt_tpu.models import camera as camera_mod
    from rvpt_tpu.render import _pixel_grid

    pixel, xs, ys = _pixel_grid(cfg)
    ju, jv = rng.uniform2(pixel, jnp.uint32(0), jnp.uint32(0))
    cx = (xs.astype(jnp.float32) + ju) / cfg.width
    cy = 1.0 - (ys.astype(jnp.float32) + jv) / cfg.height
    ray = camera_mod.generate_rays(cam, cx, cy)
    frame = jnp.uint32(1)
    st = RenderSettings(max_bounces=2, style="standard")

    def loss_xla(albedo):
        mats = dataclasses.replace(scene.materials, albedo=albedo)
        s = dataclasses.replace(scene, materials=mats)
        col = integrator_kajiya(s, ray, pixel, frame, st, salt_base=jnp.uint32(16))
        return jnp.mean(col)

    trace = make_fast_kajiya(scene, 16, 2, style="standard")

    def loss_fast(albedo):
        mats = dataclasses.replace(scene.materials, albedo=albedo)
        s = dataclasses.replace(scene, materials=mats)
        return jnp.mean(trace(s, ray.origin, ray.direction, pixel, frame))

    g_xla = np.asarray(jax.grad(loss_xla)(scene.materials.albedo))
    g_fast = np.asarray(jax.grad(loss_fast)(scene.materials.albedo))
    assert np.abs(g_xla).max() > 0
    assert np.allclose(g_fast, g_xla, rtol=2e-2, atol=1e-5), (
        f"max abs diff {np.abs(g_fast - g_xla).max()}"
    )


def _segsum_ref(idx, gs, t_rows):
    """Per-row sums of each cotangent column (NumPy scatter-add)."""
    ref = np.zeros((t_rows, len(gs)), np.float32)
    for k, g in enumerate(gs):
        np.add.at(ref[:, k], np.asarray(idx), np.asarray(g))
    return ref


def _check_lookup_and_grad(tables, idx, gs):
    """_lookup_group == NumPy gather; its transpose == NumPy scatter-add."""
    from rvpt_tpu.ops import replay_soa as rs

    out = rs._lookup_group(tables, idx)
    for o, tab in zip(out, tables):
        np.testing.assert_array_equal(np.asarray(o),
                                      np.asarray(tab)[np.asarray(idx)])
    _, vjp = jax.vjp(lambda tabs: rs._lookup_group(tabs, idx), tables)
    (g,) = vjp(gs)
    np.testing.assert_allclose(np.stack([np.asarray(x) for x in g], 1),
                               _segsum_ref(idx, gs, tables[0].shape[0]),
                               rtol=1e-5, atol=1e-5)


def _tables_and_cotangents(rng, t_rows, n, c):
    tables = tuple(jnp.asarray(rng.standard_normal(t_rows), jnp.float32)
                   for _ in range(c))
    gs = tuple(jnp.asarray(rng.standard_normal(n), jnp.float32)
               for _ in range(c))
    return tables, gs


def test_big_table_blocked_mm_lookup_and_segsum():
    """Mesh-20k-class tables (>4,096 rows, off-block-boundary sizes): the
    replay's lookup is an exact gather and its cotangent the exact
    per-row sum."""
    rng = np.random.default_rng(7)
    t_rows, n, c = 4097 + 1500, 2048 + 300, 5
    tables, gs = _tables_and_cotangents(rng, t_rows, n, c)
    idx = jnp.asarray(rng.integers(0, t_rows, n), jnp.int32)
    _check_lookup_and_grad(tables, idx, gs)


def test_big_table_blocked_mm_clustered_ranges():
    """Clustered indices (each 1024-ray block draws from a narrow window of
    the table, as BVH leaf order gives) with a partial trailing block."""
    rng = np.random.default_rng(11)
    t_rows, c = 9 * 1024 + 77, 3
    n = 3 * 1024 + 300
    tables, gs = _tables_and_cotangents(rng, t_rows, n, c)
    bases = [2 * 1024 + 100, 5 * 1024, 8 * 1024 + 400, 4 * 1024 + 50]
    idx = np.concatenate([
        rng.integers(b, min(b + 512, t_rows), 1024) for b in bases
    ])[:n]
    _check_lookup_and_grad(tables, jnp.asarray(idx, jnp.int32), gs)


def test_huge_table_chunked_lookup_and_grad():
    """Tables past 131,072 rows, indices on both sides of row 131,072 and
    at the end of the table."""
    rng = np.random.default_rng(3)
    big = 131072
    t_rows, n, c = big + 2 * 1024 + 123, 2 * 1024 + 77, 4
    tables, gs = _tables_and_cotangents(rng, t_rows, n, c)
    idx = np.concatenate([
        rng.integers(0, t_rows, n - 600),
        rng.integers(big - 300, big + 300, 300),
        rng.integers(t_rows - 200, t_rows, 300),
    ])
    _check_lookup_and_grad(tables, jnp.asarray(idx, jnp.int32), gs)

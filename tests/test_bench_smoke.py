"""Smoke-trace every code path bench.py exercises, on the CPU.

A bench.py that crashes at trace time must fail the suite, not ship.  These
tests hit the same library entry points bench.py uses — hit-record fwd+bwd,
display frames on Cornell and a BVH mesh, and the sharded harness — at tiny
film sizes."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from rvpt_tpu import FilmConfig, RenderSettings
from rvpt_tpu.scene import builtin


def test_bench_fwd_bwd_path():
    """bench.py main() headline: fast-VJP Kajiya gradient step."""
    from rvpt_tpu.core import rng
    from rvpt_tpu.models import camera as camera_mod
    from rvpt_tpu.ops.fast_grad import make_fast_kajiya
    from rvpt_tpu.render import _pixel_grid
    from rvpt_tpu.train.inverse import apply_params, trainable_params

    cfg = FilmConfig(width=32, height=16)
    scene, camera = builtin.cornell_box(aspect=cfg.aspect)
    pixel, xs, ys = _pixel_grid(cfg)
    ju, jv = rng.uniform2(pixel, jnp.uint32(0), jnp.uint32(0))
    cx = (xs.astype(jnp.float32) + ju) / cfg.width
    cy = 1.0 - (ys.astype(jnp.float32) + jv) / cfg.height
    ray = camera_mod.generate_rays(camera, cx, cy)
    trace = make_fast_kajiya(scene, 16, 2, style="standard")

    def loss_fn(params, frame):
        s = apply_params(scene, params)
        img = trace(s, ray.origin, ray.direction, pixel, frame)
        return jnp.mean(img)

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(
        trainable_params(scene), jnp.uint32(0))
    assert np.isfinite(float(loss))
    for g in jax.tree.leaves(grads):
        assert np.isfinite(np.asarray(g)).all()


def test_bench_display_paths():
    """bench.py display rows: Cornell + BVH mesh."""
    from rvpt_tpu.render import render_sample_chw

    cfg = FilmConfig(width=32, height=16)
    st = RenderSettings(max_bounces=2, aa=1, style="standard")
    scene, camera = builtin.cornell_box(aspect=cfg.aspect)
    img = np.asarray(render_sample_chw(scene, camera, st, cfg, 0))
    assert img.shape == (3, 16, 32) and np.isfinite(img).all()

    mesh_scene, mesh_cam = builtin.mesh_demo(subdiv=1, aspect=cfg.aspect)
    img = np.asarray(render_sample_chw(
        mesh_scene, mesh_cam, st.replace(max_bounces=3), cfg, 0))
    assert img.shape == (3, 16, 32) and np.isfinite(img).all()


@pytest.mark.skipif(len(jax.devices()) < 8,
                    reason="needs the 8-device virtual CPU mesh")
def test_bench_sharded_harness(capsys):
    """bench.py --sharded WxH: runs end to end and emits the JSON line."""
    import bench

    bench.main_sharded(width=64, height=32, bounces=2, iters=1)
    line = capsys.readouterr().out.strip().splitlines()[-1]
    rec = json.loads(line)
    assert rec["metric"] == "cornell_sharded_efficiency"
    assert np.isfinite(rec["value"])

"""Platform routing (ops.route), the compile-cache path rules
(utils.compile_cache), and the two CPU search routes agreeing on a BVH
mesh for every integrator."""

import os

import jax
import numpy as np
import pytest

from rvpt_tpu import FilmConfig, RenderSettings
from rvpt_tpu import render as R
from rvpt_tpu.ops import route
from rvpt_tpu.scene import builtin
from rvpt_tpu.utils import compile_cache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("platform,has_bvh,want", [
    ("cpu", True, route.TRAVERSE),
    ("cpu", False, route.DENSE),
    ("gpu", True, route.TRITON),
    ("gpu", False, route.TRITON),
])
def test_triangle_search_route(platform, has_bvh, want):
    assert route.triangle_search(has_bvh, platform) == want


@pytest.mark.parametrize("platform", ["rocm", "metal"])
def test_unknown_platform_raises(platform):
    with pytest.raises(ValueError, match=platform):
        route.triangle_search(True, platform)


def test_platform_follows_default_device():
    """The route follows jax.default_device, so a CPU reference computed
    beside a GPU run takes the CPU route."""
    assert route.platform() == jax.devices()[0].platform
    with jax.default_device(jax.devices("cpu")[0]):
        assert route.platform() == "cpu"
    with jax.default_device("cpu"):
        assert route.platform() == "cpu"


@pytest.mark.parametrize("platform", ["cpu", "gpu"])
def test_cache_dir_follows_env_var(platform, tmp_path):
    env = {compile_cache.ENV_VAR: str(tmp_path)}
    assert compile_cache.cache_dir(platform, env) == str(tmp_path)


def test_cache_dir_gpu_default_is_in_checkout():
    path = compile_cache.cache_dir("gpu", {})
    assert path == os.path.join(REPO, ".jax_cache")
    gitignore = open(os.path.join(REPO, ".gitignore")).read().split()
    assert ".jax_cache/" in gitignore


def test_cache_dir_off_on_cpu():
    assert compile_cache.cache_dir("cpu", {}) is None


def test_enable_is_off_in_cpu_tests():
    """The test harness drops JAX_COMPILATION_CACHE_DIR; on the CPU the
    cache then stays off and no directory is configured."""
    assert compile_cache.enable() is None
    assert not jax.config.jax_compilation_cache_dir


@pytest.mark.parametrize("mode", list(range(11)))
def test_bvh_traversal_route_matches_dense_route(mode, monkeypatch):
    """Every integrator on a BVH mesh: the CPU's traversal route and the
    dense search (the GPU's route, minus the kernel) render the same
    image."""
    scene, cam = builtin.mesh_demo(subdiv=1, aspect=2.0)
    assert scene.bvh is not None
    cfg = FilmConfig(width=24, height=12)
    st = RenderSettings(max_bounces=2, top_left_render_mode=mode,
                        top_right_render_mode=mode,
                        bottom_left_render_mode=mode,
                        bottom_right_render_mode=mode)
    assert route.triangle_search(True) == route.TRAVERSE
    traversed = np.asarray(R.render_sample_chw(scene, cam, st, cfg, 3))
    monkeypatch.setattr(route, "triangle_search",
                        lambda has_bvh, platform_name=None: route.DENSE)
    dense = np.asarray(R.render_sample_chw(scene, cam, st, cfg, 3))
    np.testing.assert_allclose(traversed, dense, rtol=1e-5, atol=1e-5)

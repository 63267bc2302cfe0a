import time

import jax.numpy as jnp
import numpy as np
import pytest

from rvpt_tpu.utils.checkpoint import load, save
from rvpt_tpu.utils.timer import FrameTimer


def test_timer_rolling_window():
    t = FrameTimer()
    for _ in range(3):
        t.frame_start()
        time.sleep(0.002)
        t.frame_stop()
    s = t.stats(rays_per_frame=1000)
    assert s["frames"] == 3
    assert s["avg_ms"] >= 2.0
    assert s["fps"] > 0
    assert s["fastest_ms"] <= s["slowest_ms"]
    assert s["mrays_per_s"] > 0
    assert t.since_last_frame() >= 0.0


def test_checkpoint_pytree_roundtrip(tmp_path):
    tree = {
        "a": jnp.arange(6, dtype=jnp.float32).reshape(2, 3),
        "nested": {"b": jnp.asarray([1, 2, 3], jnp.int32)},
    }
    p = str(tmp_path / "t.npz")
    save(p, tree, meta={"note": "hi"})
    like = {
        "a": jnp.zeros((2, 3), jnp.float32),
        "nested": {"b": jnp.zeros((3,), jnp.int32)},
    }
    out, meta = load(p, like)
    assert meta["note"] == "hi"
    assert np.array_equal(out["a"], tree["a"])
    assert np.array_equal(out["nested"]["b"], tree["nested"]["b"])
    assert out["nested"]["b"].dtype == jnp.int32


def test_checkpoint_missing_leaf(tmp_path):
    p = str(tmp_path / "t.npz")
    save(p, {"a": jnp.zeros(2)})
    try:
        load(p, {"a": jnp.zeros(2), "b": jnp.zeros(3)})
        assert False, "expected KeyError"
    except KeyError:
        pass


def test_hot_reload_watcher(tmp_path):
    """SourceWatcher notices a touched module file and reloads it."""
    import rvpt_tpu.config as cfg_mod
    from rvpt_tpu.utils.hot_reload import SourceWatcher

    w = SourceWatcher()
    assert w.dirty_modules() == []
    # touch a module file into the future
    import os

    path = cfg_mod.__file__
    t = time.time() + 5
    os.utime(path, (t, t))
    dirty = w.dirty_modules()
    assert "rvpt_tpu.config" in dirty
    reloaded = w.reload_if_changed(clear_caches=False)
    assert "rvpt_tpu.config" in reloaded
    assert w.dirty_modules() == []
    os.utime(path)  # restore sane mtime


def test_gpu_card_reads_nvidia_smi(monkeypatch):
    """gpu_card returns nvidia-smi's name/power-limit line as printed."""
    import subprocess

    from rvpt_tpu.utils import profiling

    seen = {}

    def fake_run(cmd, **kw):
        seen["cmd"] = cmd
        return subprocess.CompletedProcess(
            cmd, 0, stdout="NVIDIA H100 80GB HBM3, 700.00 W\n", stderr="")

    monkeypatch.setattr(profiling.subprocess, "run", fake_run)
    assert profiling.gpu_card() == "NVIDIA H100 80GB HBM3, 700.00 W"
    assert seen["cmd"] == ["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"]


@pytest.mark.parametrize("error", [FileNotFoundError("nvidia-smi"),
                                   "CalledProcessError"])
def test_gpu_card_none_without_a_card(error, monkeypatch):
    """No nvidia-smi, or nvidia-smi failing, gives None (no card line)."""
    import subprocess

    from rvpt_tpu.utils import profiling

    if error == "CalledProcessError":
        error = subprocess.CalledProcessError(9, ["nvidia-smi"])

    def fake_run(cmd, **kw):
        raise error

    monkeypatch.setattr(profiling.subprocess, "run", fake_run)
    assert profiling.gpu_card() is None


def test_profiling_helpers():
    from rvpt_tpu.utils.profiling import StepProfile, mrays_per_second

    assert abs(mrays_per_second(1920, 1088, 8, 1, 0.1) - 167.1) < 0.1

    prof = StepProfile(window=3)
    for _ in range(5):
        with prof.phase("render"):
            pass
        with prof.phase("accumulate"):
            pass
    s = prof.summary()
    assert s["render"]["count"] == 3  # window keeps the last 3
    assert s["accumulate"]["count"] == 3
    assert s["render"]["min_s"] <= s["render"]["mean_s"] <= s["render"]["max_s"]


def test_png_roundtrip(tmp_path):
    """write_png -> read_png is lossless for u8 RGB (and creates parent
    dirs — the reference writes into a build-relative tree, rvpt.cpp asset
    handling)."""
    import numpy as np

    from rvpt_tpu.utils.image import read_png, write_png

    rng = np.random.default_rng(3)
    img = rng.integers(0, 256, size=(13, 17, 3), dtype=np.uint8)
    path = str(tmp_path / "sub" / "dir" / "x.png")
    write_png(path, img)
    back = read_png(path)
    assert np.array_equal(back, img)


def test_render_settings_json_roundtrip():
    """The ImGui panel analog: settings serialize/deserialize losslessly.
    (Compare field dicts, not instances: the hot-reload test earlier in this
    file swaps the class object out from under previously-imported names.)"""
    import dataclasses

    from rvpt_tpu import RenderSettings

    s = RenderSettings(max_bounces=5, aa=3, style="standard",
                       split_ratio=(0.25, 0.75), top_left_render_mode=2)
    s2 = RenderSettings.from_json(s.to_json())
    assert dataclasses.asdict(s2) == dataclasses.asdict(s)


def test_get_asset_path(monkeypatch, tmp_path):
    from rvpt_tpu.config import get_asset_path

    p = get_asset_path("models/icosphere.obj")
    import os
    assert os.path.exists(p)
    # env override wins
    (tmp_path / "models").mkdir()
    (tmp_path / "models" / "icosphere.obj").write_text("o x\n")
    monkeypatch.setenv("RVPT_TPU_ASSETS", str(tmp_path))
    assert get_asset_path("models/icosphere.obj").startswith(str(tmp_path))
    # unknown files come back verbatim
    assert get_asset_path("nope/missing.obj") == "nope/missing.obj"


def test_debug_overlays_draw_pixels():
    """Triangle wireframe + BVH-by-depth overlays (the reference's raster
    debug views, rvpt.cpp:128-236) rasterize visible lines into the image."""
    import numpy as np

    from rvpt_tpu.scene import builtin
    from rvpt_tpu.utils.debug_draw import overlay_bvh, overlay_triangles

    from rvpt_tpu.scene.bvh import build_bvh, triangle_bounds

    scene, cam = builtin.mesh_demo(subdiv=1, aspect=1.0)
    img = np.zeros((64, 64, 3), np.float32)
    out = overlay_triangles(img, scene, cam, color=(1.0, 0.0, 0.0))
    assert (out[..., 0] > 0).sum() > 50, "wireframe should touch many pixels"
    assert (img == 0).all(), "input image must be left untouched"

    centers, bmin, bmax = triangle_bounds(
        np.asarray(scene.tri_v0), np.asarray(scene.tri_v1),
        np.asarray(scene.tri_v2))
    host = build_bvh(centers, bmin, bmax)
    out2 = overlay_bvh(np.zeros((64, 64, 3), np.float32), host, cam,
                       min_depth=0, max_depth=3)
    assert (out2 > 0).any(axis=-1).sum() > 20, "bvh boxes should touch pixels"

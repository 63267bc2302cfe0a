import numpy as np

from rvpt_tpu import render as R
from rvpt_tpu.config import FilmConfig, RenderSettings
from rvpt_tpu.ops.film import Film
from rvpt_tpu.scene import builtin


def test_render_deterministic():
    scene, cam = builtin.sphere_plane(aspect=1.0)
    cfg = FilmConfig(32, 32)
    st = RenderSettings(max_bounces=2)
    img1 = np.asarray(R.render_sample(scene, cam, st, cfg, 0))
    img2 = np.asarray(R.render_sample(scene, cam, st, cfg, 0))
    assert np.array_equal(img1, img2)
    img3 = np.asarray(R.render_sample(scene, cam, st, cfg, 1))
    assert not np.array_equal(img1, img3)  # new frame -> new noise


def test_render_shapes_and_finite():
    scene, cam = builtin.cornell_box(aspect=2.0)
    cfg = FilmConfig(width=32, height=16)
    st = RenderSettings(max_bounces=3, aa=2)
    img = np.asarray(R.render_sample(scene, cam, st, cfg, 0))
    assert img.shape == (16, 32, 3)
    assert np.isfinite(img).all()


def test_accumulation_reduces_noise():
    scene, cam = builtin.sphere_plane(aspect=1.0)
    cfg = FilmConfig(32, 32)
    st = RenderSettings(max_bounces=2)
    film = Film.create(cfg.height, cfg.width)
    frames = []
    for f in range(8):
        film, img = R.render_frame(scene, cam, st, cfg, film, f == 0)
        frames.append(np.asarray(img))
    # variance between consecutive accumulated frames shrinks
    d_early = np.abs(frames[1] - frames[0]).mean()
    d_late = np.abs(frames[7] - frames[6]).mean()
    assert d_late < d_early


def test_split_screen_modes():
    scene, cam = builtin.sphere_plane(aspect=1.0)
    cfg = FilmConfig(32, 32)
    st = RenderSettings(
        max_bounces=2,
        top_left_render_mode=3,  # normal
        top_right_render_mode=0,  # binary
        bottom_left_render_mode=1,  # color
        bottom_right_render_mode=2,  # depth
    )
    img = np.asarray(R.render_sample(scene, cam, st, cfg, 0))
    st_n = st.replace(top_right_render_mode=3, bottom_left_render_mode=3, bottom_right_render_mode=3)
    img_n = np.asarray(R.render_sample(scene, cam, st_n, cfg, 0))
    # top-left quadrant identical, the rest differ
    assert np.array_equal(img[:16, :16], img_n[:16, :16])
    assert not np.array_equal(img[16:, 16:], img_n[16:, 16:])


def test_dirty_resets_film():
    scene, cam = builtin.sphere_plane(aspect=1.0)
    cfg = FilmConfig(16, 16)
    st = RenderSettings(max_bounces=1)
    film = Film.create(cfg.height, cfg.width)
    film, _ = R.render_frame(scene, cam, st, cfg, film, True)
    film, _ = R.render_frame(scene, cam, st, cfg, film, False)
    assert int(film.frame) == 2
    film, _ = R.render_frame(scene, cam, st, cfg, film, True)
    assert int(film.frame) == 1

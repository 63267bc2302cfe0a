"""On-card smoke test: the display and inverse-rendering paths on one GPU.

    python chip_smoke.py             # one card: every phase below
    python chip_smoke.py --chips 4   # four cards: the tile-sharded path only

One card, in order:
  * the GPU-marked tests (``pytest -m gpu``) in a child process, and the
    Triton-vs-XLA search timing in one child process per search route, all
    before this process opens the card (one process holds the card at a
    time);
  * phases (a)-(d): the reference's default frame through the CLI
    (rabbit 1024x512 x8, 8 frames), the Cornell display (1920x1080 x4,
    8 frames), the mesh config (mesh-20482, 1920x1080 x8, 4 frames, with
    its compiled memory analysis and peak device memory), and three
    inverse-rendering steps on Cornell 1920x1080 x4 through the hit-record
    gradient;
  * comparisons with the plain reference, each with its tolerance and
    reason: (1) deterministic modes on the rabbit frame against the XLA
    integrators on the in-process CPU backend, (2) Kajiya mean radiance
    likewise, (3) the hit-record gradient against XLA autodiff on the card,
    (4) the Triton search against the XLA search at mesh-20482 with 1080p
    rays.

``--chips 4`` renders Cornell 1080p and mesh-20482 1080p x8 with
``render_sample_sharded`` over a (4, 1) mesh and takes one sharded training
step, each compared in this process with the single-device result.

Every phase runs; any failed phase makes the exit code nonzero and then no
result line is printed.  Without a GPU the script fails.  The last line of
standard output is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.
``--search-route`` is the child mode of the timing phase.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import re
import shutil
import subprocess
import sys
import time
import traceback
from functools import partial

HERE = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(HERE, "out")

# Film and scene sizes of the phases.
HD = (1920, 1080)
RABBIT = (1024, 512)
MESH_SUBDIV = 5          # mesh_demo(5): 20,482 triangles
SEARCH_MESHES = (3, 5)   # mesh-1282 and mesh-20482 for the search timing


def log(msg: str) -> None:
    print(msg, flush=True)


def _timed(fn, *args, **kwargs):
    import jax

    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    jax.block_until_ready(out)
    return out, time.perf_counter() - t0


def _peak_bytes() -> int:
    import jax

    return int(jax.devices()[0].memory_stats().get("peak_bytes_in_use", 0))


def _gib(n: int) -> str:
    return f"{n / 2**30:.2f} GiB"


def _memory_analysis(compiled) -> str:
    m = compiled.memory_analysis()
    fields = ("argument_size_in_bytes", "output_size_in_bytes",
              "temp_size_in_bytes", "generated_code_size_in_bytes")
    return ", ".join(f"{f.replace('_size_in_bytes', '')}="
                     f"{_gib(getattr(m, f, 0))}" for f in fields)


def _check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


# ---------------------------------------------------------------------------
# Children, run before this process opens the card
# ---------------------------------------------------------------------------


def run_gpu_tests() -> None:
    """``pytest -m gpu`` in a child process that owns the card alone."""
    env = dict(os.environ, JAX_PLATFORMS="cuda")
    code = ("import sys, pytest; sys.exit(pytest.main(["
            "'tests', '-m', 'gpu', '-q', '-rs', '-o', 'addopts=', "
            "'-p', 'no:cacheprovider']))")
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "-c", code], cwd=HERE, env=env,
                         capture_output=True, text=True, timeout=900)
    tail = res.stdout.strip().splitlines()[-1] if res.stdout.strip() else ""
    log(f"[pytest -m gpu] rc={res.returncode} ({time.perf_counter() - t0:.1f}"
        f" s): {tail}")
    _check(res.returncode == 0,
           f"gpu tests failed:\n{res.stdout[-4000:]}\n{res.stderr[-2000:]}")
    # (a module-level importorskip elsewhere may add "skipped" to the tail)
    passed = re.search(r"(\d+) passed", tail)
    _check(passed is not None and "failed" not in tail,
           f"gpu tests did not run on the card: {tail}")


def run_search_children() -> dict:
    """The full mesh display frame with each search route, one child per
    route so each peak_bytes_in_use belongs to that route alone."""
    results = {}
    for route in ("dense", "triton"):
        res = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--search-route",
             route], cwd=HERE, capture_output=True, text=True, timeout=1000)
        sys.stdout.write(res.stdout)
        if res.returncode != 0:
            raise RuntimeError(f"search child {route} failed:\n"
                               f"{res.stderr[-4000:]}")
        results[route] = json.loads(res.stdout.strip().splitlines()[-1])
    for subdiv, dense, triton in zip(SEARCH_MESHES, results["dense"]["rows"],
                                     results["triton"]["rows"]):
        log(f"[search timing] mesh-{dense['triangles']} 1080p x8 frame: "
            f"XLA dense {dense['steady_ms']} ms (peak "
            f"{dense['peak_gib']} GiB), Triton {triton['steady_ms']} ms "
            f"(peak {triton['peak_gib']} GiB)")
    return results


def search_child(route_name: str) -> int:
    """Child mode: time the 1080p x8 mesh display frame with one search
    route forced, at each size of SEARCH_MESHES; print one JSON line."""
    import jax

    from rvpt_tpu.utils import compile_cache

    if jax.devices()[0].platform != "gpu":
        raise SystemExit("no GPU")
    compile_cache.enable()
    print(json.dumps({"route": route_name,
                      "rows": time_search_route(route_name)}), flush=True)
    return 0


def time_search_route(route_name: str) -> list:
    import jax
    import jax.numpy as jnp

    from rvpt_tpu import FilmConfig, RenderSettings
    from rvpt_tpu.ops import route
    from rvpt_tpu.render import render_sample_chw
    from rvpt_tpu.scene import builtin

    route.triangle_search = lambda has_bvh, platform_name=None: route_name
    cfg = FilmConfig(*HD)
    st = RenderSettings(max_bounces=8)
    rows = []
    for subdiv in SEARCH_MESHES:
        scene, cam = builtin.mesh_demo(subdiv=subdiv, aspect=cfg.aspect)
        fn = jax.jit(lambda s, c, f: render_sample_chw(s, c, st, cfg, f))
        row = {"triangles": scene.num_triangles}
        try:
            img, setup = _timed(fn, scene, cam, jnp.uint32(0))
            times = [_timed(fn, scene, cam, jnp.uint32(i + 1))[1]
                     for i in range(3)]
            row.update(setup_s=round(setup, 3),
                       steady_ms=round(1e3 * min(times), 2),
                       steady_ms_all=[round(1e3 * t, 2) for t in times],
                       finite=bool(jnp.isfinite(img).all()))
        except Exception as e:  # noqa: BLE001 — a route that does not fit
            if "RESOURCE_EXHAUSTED" not in str(e):
                raise
            row.update(steady_ms=None, error="out of device memory")
        row["peak_gib"] = round(_peak_bytes() / 2**30, 3)
        rows.append(row)
    return rows


# ---------------------------------------------------------------------------
# Phases on the card (this process)
# ---------------------------------------------------------------------------


def phase_a_rabbit_cli() -> None:
    """(a) The reference's default frame through the CLI: Renderer.draw ->
    render_frame_jit, 8 accumulated frames."""
    from rvpt_tpu import cli

    out = os.path.join(OUT_DIR, "smoke_rabbit.png")
    argv = ["--scene", "rabbit", "--size", f"{RABBIT[0]}x{RABBIT[1]}",
            "--bounces", "8", "--frames", "8", "--out", out]
    t0 = time.perf_counter()
    _check(cli.main(argv) == 0, "cli returned nonzero")
    setup = time.perf_counter() - t0
    t0 = time.perf_counter()
    _check(cli.main(argv) == 0, "cli returned nonzero")
    steady = time.perf_counter() - t0
    _check(os.path.getsize(out) > 1000, "no PNG written")
    log(f"[a] rabbit {RABBIT[0]}x{RABBIT[1]} x8, 8 frames via the CLI: "
        f"set-up (compile + 8 frames + PNG) {setup:.2f} s, second run "
        f"(8 frames + PNG) {steady:.2f} s; peak {_gib(_peak_bytes())}")


def _display_phase(label, scene, cam, settings, cfg, frames):
    """Renderer.draw for ``frames`` frames; returns the renderer."""
    import numpy as np

    from rvpt_tpu.renderer import Renderer

    r = Renderer(scene, cam, settings, cfg)
    t0 = time.perf_counter()
    r.draw()
    r.flush()
    setup = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(frames - 1):
        r.draw()
    r.flush()
    steady = (time.perf_counter() - t0) / max(frames - 1, 1)
    img = np.asarray(r.image)
    _check(img.shape == (cfg.height, cfg.width, 3), f"shape {img.shape}")
    _check(bool(np.isfinite(img).all()), "non-finite image")
    _check(float(img.mean()) > 1e-3, "black image")
    log(f"{label}: set-up (compile + first frame) {setup:.2f} s, steady "
        f"{steady * 1e3:.2f} ms/frame over {frames - 1} frames; mean "
        f"{img.mean(axis=(0, 1)).round(4).tolist()}; "
        f"peak {_gib(_peak_bytes())}")
    return r


def phase_b_cornell() -> None:
    from rvpt_tpu import FilmConfig, RenderSettings
    from rvpt_tpu.scene import builtin

    cfg = FilmConfig(*HD)
    scene, cam = builtin.cornell_box(aspect=cfg.aspect)
    _display_phase(f"[b] cornell {cfg.width}x{cfg.height} x4, 8 frames",
                   scene, cam,
                   RenderSettings(max_bounces=4), cfg, 8)


def phase_c_mesh() -> None:
    import jax

    from rvpt_tpu import FilmConfig, RenderSettings
    from rvpt_tpu.render import render_frame_jit
    from rvpt_tpu.scene import builtin

    cfg = FilmConfig(*HD)
    st = RenderSettings(max_bounces=8)
    scene, cam = builtin.mesh_demo(subdiv=MESH_SUBDIV, aspect=cfg.aspect)
    r = _display_phase(f"[c] mesh-{scene.num_triangles} {cfg.width}x"
                       f"{cfg.height} x8, 4 frames", scene, cam, st, cfg, 4)
    # Lowered after the frames ran: an ahead-of-time compile of the same
    # jitted function before its first call has broken the later call.
    compiled = render_frame_jit.lower(r.scene, r.camera, st, cfg, r.film,
                                      True).compile()
    log(f"[c] mesh-{scene.num_triangles} frame program memory_analysis: "
        f"{_memory_analysis(compiled)}")
    log(f"[c] peak_bytes_in_use after the mesh phase: "
        f"{_gib(_peak_bytes())} on {jax.devices()[0].device_kind}")


def phase_d_inverse() -> None:
    """(d) Three optimizer steps through make_train_step's hit-record
    gradient on Cornell 1920x1080 x4, from a perturbed albedo."""
    import jax.numpy as jnp
    import numpy as np

    from rvpt_tpu import FilmConfig, RenderSettings
    from rvpt_tpu.render import render_sample_chw
    from rvpt_tpu.scene import builtin
    from rvpt_tpu.train import inverse

    cfg = FilmConfig(*HD)
    st = RenderSettings(max_bounces=4, style="standard")
    scene, cam = builtin.cornell_box(aspect=cfg.aspect)
    target = render_sample_chw(scene, cam, st, cfg, 0)
    start = inverse.apply_params(scene, {
        "materials.albedo": scene.materials.albedo * 0.7})
    step, opt = inverse.make_train_step(start, cam, st, cfg, None, target)
    _check(inverse._fast_eligible(st), "hit-record gradient not selected")
    params = inverse.trainable_params(start)
    losses, times = [], []
    for i in range(3):
        (params, opt, loss), dt = _timed(step, params, opt, jnp.uint32(i))
        losses.append(float(loss))
        times.append(dt)
    _check(all(np.isfinite(losses)), f"non-finite loss {losses}")
    _check(all(np.isfinite(np.asarray(v)).all() for v in params.values()),
           "non-finite parameters")
    log(f"[d] inverse rendering cornell 1920x1080 x4, 3 steps: losses "
        f"{[round(v, 6) for v in losses]}; set-up (compile + step 1) "
        f"{times[0]:.2f} s, steady {1e3 * min(times[1:]):.2f} ms/step; "
        f"peak {_gib(_peak_bytes())}")


# ---------------------------------------------------------------------------
# Comparisons with the plain reference
# ---------------------------------------------------------------------------


def _rabbit_crop(cols, rows):
    """Pixel ids, xs, ys of a centred cols x rows crop of the rabbit film."""
    import numpy as np

    w, h = RABBIT
    x0, y0 = (w - cols) // 2, (h - rows) // 2
    ys, xs = np.mgrid[y0:y0 + rows, x0:x0 + cols]
    xs, ys = xs.ravel().astype(np.uint32), ys.ravel().astype(np.uint32)
    return xs + ys * np.uint32(w), xs, ys


def _rabbit_on(device, settings, crop, frame=1):
    """render_pixels of the rabbit crop with everything placed on
    ``device`` (the search route follows the device's platform)."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from rvpt_tpu import FilmConfig
    from rvpt_tpu.render import render_pixels
    from rvpt_tpu.scene import builtin

    cfg = FilmConfig(*RABBIT)
    with jax.default_device(device):
        scene, cam = builtin.rabbit(aspect=cfg.aspect)
        pixel, xs, ys = (jnp.asarray(a) for a in crop)
        fn = jax.jit(lambda s, c: render_pixels(
            s, c, settings, cfg, jnp.uint32(frame), pixel, xs, ys))
        return np.asarray(fn(scene, cam))


def compare_deterministic_modes() -> None:
    """(1) normal, depth and binary on the rabbit frame: GPU (Triton search)
    against the XLA integrators on the CPU backend (BVH traversal), on a
    512x256 centre crop.  Tolerance: 1e-4 absolute per value, except on at
    most 0.5% of pixels — rays that graze a silhouette or a shared triangle
    edge may pick another triangle (or miss) under another compiler's fma
    contraction and another search order."""
    import jax
    import numpy as np

    from rvpt_tpu import RenderSettings

    crop = _rabbit_crop(512, 256)
    for mode, name in ((3, "normal"), (2, "depth"), (0, "binary")):
        st = RenderSettings(max_bounces=8, top_left_render_mode=mode,
                            top_right_render_mode=mode,
                            bottom_left_render_mode=mode,
                            bottom_right_render_mode=mode)
        gpu = _rabbit_on(jax.devices()[0], st, crop)
        cpu = _rabbit_on(jax.devices("cpu")[0], st, crop)
        bad = np.any(np.abs(gpu - cpu) > 1e-4, axis=-1)
        worst_good = float(np.abs(gpu - cpu)[~bad].max())
        log(f"[cmp 1] rabbit {name}: pixels off by >1e-4: "
            f"{bad.mean():.5f} (tolerance 0.005); worst elsewhere "
            f"{worst_good:.3g} (tolerance 1e-4)")
        _check(bad.mean() <= 0.005, f"{name}: {bad.mean():.5f} pixels off")


def compare_kajiya_mean() -> None:
    """(2) Kajiya on the rabbit frame (512x256 centre crop, 8 bounces):
    mean radiance per channel, GPU against the CPU backend.  Per-pixel
    comparison is meaningless here: an fma-level difference flips a
    Fresnel or hit decision and the path continues elsewhere (about a
    quarter of the pixels at 4 bounces between two backends), but each
    flipped path is an equally likely sample, so the means agree to Monte
    Carlo noise.  Tolerance: 2% relative per channel."""
    import jax
    import numpy as np

    from rvpt_tpu import RenderSettings

    crop = _rabbit_crop(512, 256)
    st = RenderSettings(max_bounces=8)
    gpu = _rabbit_on(jax.devices()[0], st, crop).mean(axis=0)
    cpu = _rabbit_on(jax.devices("cpu")[0], st, crop).mean(axis=0)
    rel = np.abs(gpu - cpu) / np.abs(cpu)
    log(f"[cmp 2] rabbit kajiya mean radiance GPU {gpu.round(5).tolist()} "
        f"CPU {cpu.round(5).tolist()}: worst relative {rel.max():.4f} "
        f"(tolerance 0.02)")
    _check(rel.max() <= 0.02, f"kajiya means differ by {rel.max():.4f}")


def compare_hit_record_gradient() -> None:
    """(3) The hit-record gradient against XLA autodiff of the integrator,
    both on the card: Cornell 512x512, 4 bounces, every scene leaf.
    Tolerance per leaf: ||fast - autodiff|| <= 1e-2 ||autodiff|| + 1e-6.
    The two gradients make the same discrete decisions except where two
    differently fused programs round an fma differently and a handful of
    the 262k paths flip; the replay also sums cotangents in another order."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from rvpt_tpu import FilmConfig, RenderSettings
    from rvpt_tpu.models.integrators import integrator_kajiya
    from rvpt_tpu.ops.fast_grad import make_fast_kajiya
    from rvpt_tpu.render import (_INTEGRATOR_SITE, _pixel_grid,
                                 jittered_camera_rays)
    from rvpt_tpu.scene import builtin
    from rvpt_tpu.train import inverse

    cfg = FilmConfig(512, 512)
    st = RenderSettings(max_bounces=4, style="standard")
    scene, cam = builtin.cornell_box(aspect=cfg.aspect)
    groups = ("albedo", "emission", "ior", "vertices", "spheres", "planes",
              "camera")
    params = inverse.trainable_params(scene, groups, cam)
    trace = make_fast_kajiya(scene, _INTEGRATOR_SITE, 4, style="standard")
    frame = jnp.uint32(1)

    def loss(p, fast):
        s = inverse.apply_params(scene, p)
        c = inverse.apply_camera(cam, p)
        pixel, xs, ys = _pixel_grid(cfg)
        ray = jittered_camera_rays(c, cfg, pixel, xs, ys, frame,
                                   jnp.uint32(0))
        if fast:
            return jnp.mean(trace(s, ray.origin, ray.direction, pixel,
                                  frame))
        return jnp.mean(integrator_kajiya(s, ray, pixel, frame, st,
                                          _INTEGRATOR_SITE))

    g_fast = jax.jit(jax.grad(lambda p: loss(p, True)))(params)
    g_xla = jax.jit(jax.grad(lambda p: loss(p, False)))(params)
    worst = 0.0
    for k in sorted(params):
        a, b = np.asarray(g_fast[k]), np.asarray(g_xla[k])
        err = float(np.linalg.norm(a - b))
        bound = 1e-2 * float(np.linalg.norm(b)) + 1e-6
        worst = max(worst, err / bound)
        log(f"[cmp 3] d/d {k}: |fast - autodiff| {err:.3g}, |autodiff| "
            f"{np.linalg.norm(b):.3g} (tolerance {bound:.3g})")
        _check(err <= bound, f"gradient of {k} off by {err:.3g}")
    log(f"[cmp 3] worst error / tolerance: {worst:.3f}")


def compare_triton_search() -> None:
    """(4) The Triton search against closest_hit_triangles under
    default_matmul_precision('highest'): mesh-20482, the primary rays of a
    1920x1080 frame (XLA search in 8 ray batches to bound its blocks).
    Hit masks may differ on at most 0.1% of rays (edge grazes and near-ties
    under different fma contraction); where both searches chose the same
    triangle, t agrees within 1e-5 relative."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from rvpt_tpu import FilmConfig
    from rvpt_tpu.ops.intersect import closest_hit_triangles
    from rvpt_tpu.ops.search_triton import closest_hit_triangles_triton
    from rvpt_tpu.render import _pixel_grid, jittered_camera_rays
    from rvpt_tpu.scene import builtin

    cfg = FilmConfig(*HD)
    scene, cam = builtin.mesh_demo(subdiv=MESH_SUBDIV, aspect=cfg.aspect)
    pixel, xs, ys = _pixel_grid(cfg)
    ray = jittered_camera_rays(cam, cfg, pixel, xs, ys, jnp.uint32(0),
                               jnp.uint32(0))
    tri = (scene.tri_v0, scene.tri_v1, scene.tri_v2)
    t_k, i_k = jax.jit(lambda o, d: closest_hit_triangles_triton(
        o, d, *tri, 0.0, jnp.inf, interpret=False))(ray.origin, ray.direction)
    xla = jax.jit(lambda o, d: closest_hit_triangles(o, d, *tri, 0.0,
                                                     jnp.inf))
    n = pixel.shape[0]
    parts = []
    with jax.default_matmul_precision("highest"):
        for lo in range(0, n, n // 8):
            parts.append(xla(ray.origin[lo:lo + n // 8],
                             ray.direction[lo:lo + n // 8]))
    t_x = np.concatenate([np.asarray(p[0]) for p in parts])
    i_x = np.concatenate([np.asarray(p[1]) for p in parts])
    t_k, i_k = np.asarray(t_k), np.asarray(i_k)
    mask_off = float(np.mean((i_k >= 0) != (i_x >= 0)))
    idx_off = float(np.mean(i_k != i_x))
    same = (i_k == i_x) & (i_x >= 0)
    rel = float(np.max(np.abs(t_k[same] - t_x[same]) / np.abs(t_x[same])))
    log(f"[cmp 4] triton vs XLA search, mesh-{scene.num_triangles}, "
        f"{n} rays: hit masks differ on {mask_off:.2e} (tolerance 1e-3), "
        f"indices differ on {idx_off:.2e}, hits {same.mean():.3f}; worst t "
        f"relative error on shared hits {rel:.2e} (tolerance 1e-5)")
    _check(mask_off <= 1e-3, f"hit masks differ on {mask_off}")
    _check(rel <= 1e-5, f"t differs by {rel}")


# ---------------------------------------------------------------------------
# Four cards
# ---------------------------------------------------------------------------


def phase_sharded() -> None:
    """render_sample_sharded over a (4, 1) mesh against the single-device
    render (Cornell 1080p x4, mesh-20482 1080p x8), then one sharded
    training step against the single-device step.  RNG is keyed by global
    pixel id, so the images are expected bit-identical; the check allows
    mean radiance, and the training step's loss, to differ by 1e-4
    relative, because XLA fuses the shard-local programs differently and an
    fma difference can flip a path (on four H100s about 0.1% of the
    mesh-20482 pixels differ), and it reports the share of differing
    pixels.  The optimizer step normalises the gradient, so the updated
    parameters must agree within 1e-5."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from rvpt_tpu import FilmConfig, RenderSettings
    from rvpt_tpu.parallel import mesh as mesh_mod
    from rvpt_tpu.parallel.sharded import render_sample_sharded
    from rvpt_tpu.render import render_sample_chw
    from rvpt_tpu.scene import builtin
    from rvpt_tpu.train import inverse

    devices = jax.devices()
    _check(len(devices) == 4, f"needs 4 cards, JAX sees {len(devices)}")
    mesh = mesh_mod.make_mesh(4, 1, devices=devices)
    cfg = FilmConfig(*HD)
    cases = (("cornell 1920x1080 x4", builtin.cornell_box(aspect=cfg.aspect),
              RenderSettings(max_bounces=4)),
             ("mesh-20482 1920x1080 x8",
              builtin.mesh_demo(subdiv=MESH_SUBDIV, aspect=cfg.aspect),
              RenderSettings(max_bounces=8)))
    for label, (scene, cam), st in cases:
        single = jax.jit(partial(render_sample_chw, settings=st, cfg=cfg))
        sharded = jax.jit(partial(render_sample_sharded, settings=st,
                                  cfg=cfg, mesh=mesh))
        ref, setup_single = _timed(single, scene, cam, frame=jnp.uint32(1))
        img, setup_sharded = _timed(sharded, scene, cam, frame=jnp.uint32(1))
        t_single = min(_timed(single, scene, cam, frame=jnp.uint32(2))[1]
                       for _ in range(3))
        t_sharded = min(_timed(sharded, scene, cam, frame=jnp.uint32(2))[1]
                        for _ in range(3))
        ref, img = np.asarray(ref), np.asarray(img)
        differ = float(np.mean(np.any(ref != img, axis=0)))
        rel = np.abs(img.mean(axis=(1, 2)) - ref.mean(axis=(1, 2))) / \
            np.abs(ref.mean(axis=(1, 2)))
        log(f"[4 cards] {label}: set-up single {setup_single:.2f} s, "
            f"sharded {setup_sharded:.2f} s; single {t_single * 1e3:.2f} ms, sharded "
            f"over 4 {t_sharded * 1e3:.2f} ms (scaling efficiency "
            f"{t_single / (4 * t_sharded):.3f}); bit-identical "
            f"{differ == 0.0}, differing pixels {differ:.2e}, worst mean "
            f"relative {rel.max():.2e} (tolerance 1e-4)")
        _check(rel.max() <= 1e-4, f"{label}: means differ by {rel.max()}")

    scene, cam = builtin.cornell_box(aspect=cfg.aspect)
    st = RenderSettings(max_bounces=4, style="standard")
    target = jnp.zeros((3, cfg.height, cfg.width), jnp.float32)
    params = inverse.trainable_params(scene)
    step1, opt1 = inverse.make_train_step(scene, cam, st, cfg, None, target)
    step4, opt4 = inverse.make_train_step(scene, cam, st, cfg, mesh, target)
    (p1, _, l1), t1 = _timed(step1, params, opt1, jnp.uint32(0))
    (p4, _, l4), t4 = _timed(step4, params, opt4, jnp.uint32(0))
    worst = max(float(np.max(np.abs(np.asarray(p1[k]) - np.asarray(p4[k]))))
                for k in p1)
    loss_rel = abs(float(l1) - float(l4)) / abs(float(l1))
    log(f"[4 cards] train step cornell 1920x1080 x4: loss single "
        f"{float(l1):.6f} sharded {float(l4):.6f} (relative {loss_rel:.2e}, "
        f"tolerance 1e-4); worst parameter difference {worst:.3g} "
        f"(tolerance 1e-5); set-up single {t1:.2f} s, sharded {t4:.2f} s")
    _check(loss_rel <= 1e-4, "sharded loss differs")
    _check(worst <= 1e-5, f"sharded step parameters differ by {worst}")


# ---------------------------------------------------------------------------


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--chips", type=int, default=1, choices=(1, 4))
    p.add_argument("--search-route", choices=("dense", "triton"))
    args = p.parse_args()

    # Checked without importing the package: its import initializes JAX's
    # backends, and the children below must find the card free.
    if importlib.util.find_spec("rvpt_tpu") is None:
        log("rvpt_tpu not found: run from a checkout of the repository")
        return 1
    if args.search_route:
        return search_child(args.search_route)
    if shutil.which("nvidia-smi") is None:
        log("no GPU: nvidia-smi not found")
        return 1
    os.makedirs(OUT_DIR, exist_ok=True)

    failed = []

    def run(name, fn):
        t0 = time.perf_counter()
        try:
            fn()
        except Exception:  # noqa: BLE001 — recorded; fails the run below
            failed.append(name)
            log(f"FAILED {name} after {time.perf_counter() - t0:.1f} s:\n"
                f"{traceback.format_exc()}")

    if args.chips == 1:
        run("pytest -m gpu", run_gpu_tests)
        run("search timing", run_search_children)

    # This process opens the card(s) only now; the CPU backend stays
    # available for the reference comparisons.
    import jax

    jax.config.update("jax_platforms", "cuda,cpu")
    from rvpt_tpu.utils import compile_cache
    from rvpt_tpu.utils.profiling import gpu_card

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        log(f"no GPU: JAX sees {dev.platform}")
        return 1
    log(f"jax {jax.__version__}; compile cache: {compile_cache.enable()}")
    log(f"devices: {len(jax.devices())} x {dev.device_kind}")

    if args.chips == 4:
        run("sharded", phase_sharded)
    else:
        for name, fn in (("a", phase_a_rabbit_cli), ("b", phase_b_cornell),
                         ("c", phase_c_mesh), ("d", phase_d_inverse),
                         ("cmp 1", compare_deterministic_modes),
                         ("cmp 2", compare_kajiya_mean),
                         ("cmp 3", compare_hit_record_gradient),
                         ("cmp 4", compare_triton_search)):
            run(name, fn)

    log(f"card: {gpu_card()}")
    if failed:
        log(f"failed phases: {failed}")
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

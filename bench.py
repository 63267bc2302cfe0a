"""Headline benchmark: Mrays/s/chip, forward+backward, Cornell 1080p 1spp.

Prints exactly ONE JSON line to stdout:
  {"metric": ..., "value": N, "unit": ..., "vs_baseline": N}

The reference publishes no numbers (BASELINE.md), so ``vs_baseline``
normalizes against the reference's implied real-time envelope: its fixed
1024x512 film at 8 bounces and 60 fps = 1024*512*8*60 ~= 252 Mrays/s
(src/rvpt/main.cpp:96-97, rvpt.h:79; a mid-range Vulkan GPU holds 60fps on
the demo scene).  value/vs_baseline therefore reads "x times the reference's
whole-frame ray throughput, while ALSO computing gradients".

The headline step is the hit-record gradient (ops.fast_grad): the XLA
Kajiya chain records each bounce's hits, and the backward replays from them.
The other rows (display frames on Cornell, the mesh scenes and the
reference's rabbit frame; mesh fwd+bwd; the sharded training step) go to
stderr, each with its set-up time (compile + first run) and steady time.
Every row must run: a failed row makes the exit code nonzero, and then no
JSON line is printed.  The device line names what the numbers were taken
on, with the card's name and power limit.

Ray accounting: traced rays = H*W*aa*max_bounces per frame — every lane is
traced at every bounce (masked wavefront), so this is work actually executed.
"""

from __future__ import annotations

import json
import sys
import time
import traceback

import jax
import jax.numpy as jnp


def _bench(fn, *args, iters=10):
    """(set-up seconds: compile + first call, steady seconds per call)."""
    t0 = time.perf_counter()
    jax.block_until_ready(fn(*args))
    setup = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args)
    jax.block_until_ready(out)
    return setup, (time.perf_counter() - t0) / iters


def _device_line() -> str:
    from rvpt_tpu.utils.profiling import gpu_card

    dev = jax.devices()[0]
    card = gpu_card() or "no nvidia-smi"
    return (f"device: platform={dev.platform} kind={dev.device_kind} "
            f"count={len(jax.devices())} card={card}")


def _grad_step(scene, camera, cfg, bounces):
    """Jitted value_and_grad of the mean radiance through the hit-record
    gradient, with the pixel grid and rays built inside the trace."""
    from rvpt_tpu.ops.fast_grad import make_fast_kajiya
    from rvpt_tpu.render import (_INTEGRATOR_SITE, _pixel_grid,
                                 jittered_camera_rays)
    from rvpt_tpu.train.inverse import apply_params

    trace = make_fast_kajiya(scene, _INTEGRATOR_SITE, bounces,
                             style="standard")

    def loss_fn(params, frame):
        pixel, xs, ys = _pixel_grid(cfg)
        ray = jittered_camera_rays(camera, cfg, pixel, xs, ys, frame,
                                   jnp.uint32(0))
        img = trace(apply_params(scene, params), ray.origin, ray.direction,
                    pixel, frame)
        return jnp.mean(img)

    return jax.jit(jax.value_and_grad(loss_fn))


def _display(scene, camera, settings, cfg):
    from rvpt_tpu.render import render_sample_chw

    return jax.jit(
        lambda f: render_sample_chw(scene, camera, settings, cfg, f))


def main() -> int:
    from rvpt_tpu import FilmConfig, RenderSettings
    from rvpt_tpu.parallel import mesh as mesh_mod
    from rvpt_tpu.scene import builtin
    from rvpt_tpu.train.inverse import make_train_step, trainable_params
    from rvpt_tpu.utils import compile_cache

    cache = compile_cache.enable()
    print(f"persistent compilation cache: {cache or 'off'}", file=sys.stderr)

    width, height, bounces = 1920, 1080, 4
    cfg = FilmConfig(width=width, height=height)
    settings = RenderSettings(max_bounces=bounces, aa=1, style="standard")
    scene, camera = builtin.cornell_box(aspect=cfg.aspect)
    mesh_settings = RenderSettings(max_bounces=8, aa=1)
    baseline_mrays = 1024 * 512 * 8 * 60 / 1e6  # ~252: reference envelope
    frame1 = jnp.uint32(1)
    results: dict = {}

    def row(label, rays, fn, *args, iters=10):
        setup, dt = _bench(fn, *args, iters=iters)
        results[label] = rays / dt / 1e6
        print(f"{label}: set-up {setup:.2f} s, {dt * 1e3:.2f} ms/frame -> "
              f"{rays / dt / 1e6:.1f} Mrays/s", file=sys.stderr)

    def headline():
        step = _grad_step(scene, camera, cfg, bounces)
        params = trainable_params(scene)
        row("cornell 1080p x4 fwd+bwd (hit-record gradient)",
            width * height * bounces, lambda f: step(params, f), frame1)

    def cornell_display():
        row("cornell 1080p x4 fwd only", width * height * bounces,
            _display(scene, camera, settings, cfg), frame1)

    def mesh_rows(subdiv, iters):
        def run():
            m_scene, m_cam = builtin.mesh_demo(subdiv=subdiv,
                                               aspect=cfg.aspect)
            n = m_scene.num_triangles
            rays = width * height * 8
            row(f"mesh-{n} 1080p x8 display", rays,
                _display(m_scene, m_cam, mesh_settings, cfg), frame1,
                iters=iters)
            step = _grad_step(m_scene, m_cam, cfg, 8)
            params = trainable_params(m_scene)
            row(f"mesh-{n} 1080p x8 fwd+bwd (hit-record gradient)", rays,
                lambda f: step(params, f), frame1, iters=iters)
        return run

    def sharded_train_step():
        devices = jax.devices()
        target = jnp.zeros((3, height, width), jnp.float32)
        params = trainable_params(scene)
        step_u, opt_u = make_train_step(scene, camera, settings, cfg, None,
                                        target)
        _, dt_u = _bench(lambda f: step_u(params, opt_u, f), frame1, iters=5)
        mesh = mesh_mod.make_mesh(len(devices), 1, devices=devices)
        step_s, opt_s = make_train_step(scene, camera, settings, cfg, mesh,
                                        target)
        _, dt_s = _bench(lambda f: step_s(params, opt_s, f), frame1, iters=5)
        ovh = (dt_s * len(devices) / dt_u - 1.0) * 100.0
        print(f"train step (fwd+bwd+psum grads) sharded n={len(devices)}: "
              f"unsharded {dt_u * 1e3:.2f} ms, sharded {dt_s * 1e3:.2f} ms "
              f"-> overhead {ovh:+.1f}%", file=sys.stderr)

    def rabbit():
        rb_cfg = FilmConfig(width=1024, height=512)
        rb_scene, rb_cam = builtin.rabbit(aspect=rb_cfg.aspect)
        row("reference-default frame (1024x512 rabbit x8)", 1024 * 512 * 8,
            _display(rb_scene, rb_cam, mesh_settings, rb_cfg), frame1)

    failed = []
    for name, fn in (("headline", headline),
                     ("cornell display", cornell_display),
                     ("mesh-1282", mesh_rows(3, 5)),
                     ("mesh-20482", mesh_rows(5, 2)),
                     ("sharded train step", sharded_train_step),
                     ("rabbit", rabbit)):
        try:
            fn()
        except Exception:  # noqa: BLE001 — report every row, fail at the end
            failed.append(name)
            print(f"{name}: FAILED\n{traceback.format_exc()}", file=sys.stderr)

    print(_device_line(), file=sys.stderr)
    if failed:
        print(f"failed rows: {failed}", file=sys.stderr)
        return 1
    mrays = results["cornell 1080p x4 fwd+bwd (hit-record gradient)"]
    print(json.dumps({
        "metric": "cornell_1080p_fwd_bwd",
        "value": round(mrays, 2),
        "unit": "Mrays/s/chip",
        "vs_baseline": round(mrays / baseline_mrays, 3),
    }))
    return 0


def main_sharded(width: int = 1920, height: int = 1080, bounces: int = 4,
                 iters: int = 10) -> None:
    """Scaling-efficiency harness (BASELINE.md: >=85% rays/s 1 chip -> N).

    Renders the Cornell config over a (tiles,) mesh of ALL visible devices
    and reports rays/s/chip against the single-device render measured in
    the SAME run.  With one device this measures the sharded path's
    overhead; with several it measures scaling efficiency.
    """
    from rvpt_tpu import FilmConfig, RenderSettings
    from rvpt_tpu.parallel import mesh as mesh_mod
    from rvpt_tpu.parallel.sharded import render_sample_sharded
    from rvpt_tpu.render import render_sample_chw
    from rvpt_tpu.scene import builtin
    from rvpt_tpu.utils import compile_cache

    compile_cache.enable()
    devices = jax.devices()
    n = len(devices)
    cfg = FilmConfig(width=width, height=height)
    settings = RenderSettings(max_bounces=bounces, style="standard")
    scene, camera = builtin.cornell_box(aspect=cfg.aspect)
    rays = width * height * settings.aa * bounces
    mesh = mesh_mod.make_mesh(n, 1, devices=devices)

    single = jax.jit(
        lambda f: render_sample_chw(scene, camera, settings, cfg, f))
    _, dt_single = _bench(single, jnp.uint32(1), iters=iters)
    sharded = jax.jit(lambda f: render_sample_sharded(
        scene, camera, settings, cfg, f, mesh))
    _, dt_sharded = _bench(sharded, jnp.uint32(1), iters=iters)

    per_chip = rays / dt_sharded / n
    eff = per_chip / (rays / dt_single)
    print(
        f"single-device: {dt_single*1e3:.2f} ms  sharded({n} dev): "
        f"{dt_sharded*1e3:.2f} ms  rays/s/chip ratio: {eff:.3f}",
        file=sys.stderr,
    )
    print(_device_line(), file=sys.stderr)
    print(json.dumps({
        "metric": "cornell_sharded_efficiency",
        "value": round(eff, 4),
        "unit": f"rays/s/chip vs 1-chip, n={n}",
        "vs_baseline": round(eff / 0.85, 3),
    }))


if __name__ == "__main__":
    if "--sharded" in sys.argv:
        # Optional film override for smoke runs on the virtual CPU mesh:
        #   python bench.py --sharded 128x64
        size = next((a for a in sys.argv[1:] if "x" in a and a[0].isdigit()),
                    None)
        if size:
            w, h = (int(v) for v in size.split("x"))
            main_sharded(width=w, height=h, bounces=2, iters=2)
        else:
            main_sharded()
    else:
        raise SystemExit(main())
